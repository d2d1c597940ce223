"""Demos: counterpart of ``demos/tpu-sharing-comparison/`` (the client and
the local harness), as a GPU sharing comparison: time-slicing, MPS, MIG."""
