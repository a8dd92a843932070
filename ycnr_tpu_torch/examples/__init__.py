"""The port's runnable examples, each the counterpart of the script of the
same name under ``examples/``, through the port's modules:

    python -m ycnr_tpu_torch.examples.<name> [--device cpu]

Each runs on the card by default and stops without one; ``--device cpu``
runs it on the CPU.
"""
