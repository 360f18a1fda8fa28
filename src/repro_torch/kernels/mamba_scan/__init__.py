"""Mamba-1 selective scan: Hopper kernel (``csrc/``), wrapper (``ops``)
and plain PyTorch version (``ref``)."""
