"""Readings from which a cell's limits are set: the numbers its check
compares, for the program on many seeds, for the control (the plain
reference in the next lower precision, put in the program's place) and,
for a training cell, for the faults a training cell can have, planted in
the reference put in the program's place. One process, one cell, a
short window each; the benchmark's own runs never run this.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,...
        [--control-seeds 7,8,9] [--faults] [--seconds 2]

Prints one JSON line a reading set.
"""

import argparse
import gc
import json
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

from portbench import harness  # noqa: E402


def seeds(text):
    return [int(s) for s in text.split(",") if s]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=seeds, default=[])
    ap.add_argument("--control-seeds", type=seeds, default=[])
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    spec = harness.cell_spec(args.workload)
    jobs = ([(s, "program") for s in args.seeds]
            + [(s, "control") for s in args.control_seeds])
    for seed, what in jobs:
        run = spec.kind.Run(spec, seed, args.device,
                            harness.Phases(time.perf_counter()), False)
        run.setup()
        run.window(args.seconds)
        run.release()
        if what == "program":
            out = {"program": run.check()}
        else:
            out = {"control": run.control_readings()}
            if args.faults and hasattr(run, "fault_readings"):
                out.update(run.fault_readings())
        print(json.dumps({"workload": args.workload, "seed": seed, **out}),
              flush=True)
        del run
        gc.collect()
        if torch.device(args.device).type == "cuda":
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
