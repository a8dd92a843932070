"""The knee of an open-loop cell: one set-up, then the cell's traffic at
each of a list of rates, the server's cache emptied between them. For
each rate: the latency percentiles, the completed share, and whether
the backlog grew (the median latency of the window's last quarter of
requests against its first quarter). The benchmark's own runs never run
this; the cell's file keeps the rate chosen from it.

    python3 portbench/sweep.py --workload <cell> --seed <n>
        --rates 500,1000,... [--seconds 8]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

from portbench import harness  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    spec = harness.cell_spec(args.workload)
    run = spec.kind.Run(spec, args.seed, args.device,
                        harness.Phases(time.perf_counter()), False)
    run.setup()
    seen = (0, 0)
    try:
        for rate in (float(r) for r in args.rates.split(",")):
            run.rec.cache.invalidate()
            spec.cell["rate_per_s"] = rate
            e2e = run.window(args.seconds)
            r = run.replies
            N = len(r["status"])
            due = np.sort(run.last_due)
            lat = r["done"] - (r["t0"] + due)
            ok = r["status"] == 0
            q = max(1, N // 4)
            first = np.median(np.where(ok, lat, np.inf)[:q])
            last = np.median(np.where(ok, lat, np.inf)[-q:])
            print(json.dumps({
                "rate": rate, "requests": N, "answered": int(ok.sum()),
                "p50_ms": 1e3 * float(np.median(lat[ok])) if ok.any()
                else None,
                "p99_ms": e2e["metrics"]["request_p99_ms"],
                "first_quarter_p50_ms": 1e3 * float(first),
                "last_quarter_p50_ms": 1e3 * float(last),
                "batch": (run.stats["batched_requests"] - seen[1])
                / max(1, run.stats["batches"] - seen[0])}), flush=True)
            seen = (run.stats["batches"], run.stats["batched_requests"])
    finally:
        run.release()


if __name__ == "__main__":
    main()
