"""Matérn-5/2 GP covariance: Hopper kernel (``csrc/``), wrapper (``ops``)
and plain PyTorch version (``ref``)."""
