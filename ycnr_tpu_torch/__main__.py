"""``python -m ycnr_tpu_torch ...``: the port's command line (``cli.py``)."""

from ycnr_tpu_torch.cli import main

if __name__ == "__main__":
    main()
