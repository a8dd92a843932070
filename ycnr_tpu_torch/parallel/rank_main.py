"""One rank process of ``parallel.mesh.spawn_ranks``.

    python -m ycnr_tpu_torch.parallel.rank_main SPEC_DIR RANK

Reads ``SPEC_DIR/spec.pkl``, joins the process group it names, builds this
rank's ``Mesh``, calls the target with the memory-mapped arrays and, on
rank 0, pickles the result into the spec's result path.
"""

from __future__ import annotations

import datetime
import importlib
import os
import pickle
import sys

import numpy as np
import torch
import torch.distributed as dist


def main(argv=None):
    tmp, rank = (argv or sys.argv[1:])[:2]
    rank = int(rank)
    with open(os.path.join(tmp, "spec.pkl"), "rb") as f:
        spec = pickle.load(f)
    world = spec["world"]
    kw = {}
    if spec["timeout"] is not None:
        kw["timeout"] = datetime.timedelta(seconds=spec["timeout"])
    dist.init_process_group(spec["backend"], init_method=spec["init"],
                            world_size=world, rank=rank, **kw)
    from ycnr_tpu_torch import full_precision_matmul
    from ycnr_tpu_torch.parallel.mesh import make_mesh

    full_precision_matmul()  # as every entry point of the port
    mesh = make_mesh(world, device=spec["device"])
    if mesh.device.type == "cpu":
        # ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    module, name = spec["target"].split(":")
    fn = getattr(importlib.import_module(module), name)
    arrays = {k: np.load(p, mmap_mode="r")
              for k, p in spec["arrays"].items()}
    try:
        out = fn(mesh, **spec["kwargs"], **arrays)
        if rank == 0:
            with open(spec["result"] + ".tmp", "wb") as f:
                pickle.dump(out, f)
            os.replace(spec["result"] + ".tmp", spec["result"])
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
