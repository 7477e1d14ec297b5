"""Runnable examples of the port (counterparts of the repository's
``examples/``): ``python -m repro_torch.examples.<name> [--device cpu]``.
Each ``main(argv=None)`` prints what the reference's prints and returns
those numbers as a dict."""
