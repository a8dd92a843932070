"""Row-gather bench on the card: the port's counterpart of
``tools/bench_pallas_gather.py``.

The gather probe (``probe_gather.probe``) at the TPU bench's sizes:
B = 65,536 rows per step, the epoch's inner access pattern, from the
ML-20M items table (26,744 rows, the TPU bench's VMEM-resident case; keys
``small_*``) and the Netflix users table (480,189 rows, its HBM-only case;
keys ``big_*``), at widths 64 and 128. ``row_gather`` stands for the TPU
bench's ``pallas_vmem_gather`` in both bodies and ``pallas_hbm_dma_gather``;
``--gram`` adds the fused gather -> Gram on the small table. Every kernel
result is first held to its plain version (bit equality; the fused-Gram
bound). Prints one JSON line of ns per gathered row. Needs a CUDA device.

    python -m ycnr_tpu_torch.tools.bench_gather [--dtype bf16] [--steps 100]
"""

from __future__ import annotations

import argparse
import json

from ycnr_tpu_torch import full_precision_matmul
from ycnr_tpu_torch.tools.probe_gather import device_name, probe

B = 1 << 16  # rows gathered per step (one epoch block's order)
TABLES = (("small", 26_744), ("big", 480_189))  # ML-20M items, Netflix users


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", choices=["bf16", "f32"], default="bf16")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--gram", action="store_true",
                    help="also time the fused gather -> Gram kernel")
    args = ap.parse_args(argv)
    out = {"device": device_name(), "dtype": args.dtype, "B": B,
           "steps": args.steps}
    full_precision_matmul()
    for size, n in TABLES:
        res = probe(B, n, args.steps, (args.dtype,),
                    gram=args.gram and size == "small")
        out.update({f"{size}_{k}": v for k, v in res.items()})
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
