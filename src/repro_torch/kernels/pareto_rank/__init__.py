"""Pareto dominance counts: Hopper kernel (``csrc/``), wrapper (``ops``)
and plain PyTorch version (``ref``)."""
