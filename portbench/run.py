"""Run one cell of the port's benchmark on the card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Prints, as the last line of stdout, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device`` and, traced,
``breakdown``; the numbers compared against the plain reference come
last, there and on stderr. Exits nonzero, printing no result, without
the CUDA devices the cell asks for, or when JAX or the JAX package was
loaded.
"""

import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)
# kernel caches of libraries at fixed paths inside the checkout; the
# port's own kernels build into ycnr_tpu_torch/_build/ there
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[_var] = os.path.join(_ROOT, ".portbench_cache", _sub)

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
