"""Hand-written Hopper kernels of the port, one folder per TPU kernel of
the reference (``<name>/csrc/*.cu`` + ``ops.py`` wrapper + ``ref.py`` plain
PyTorch version)."""
