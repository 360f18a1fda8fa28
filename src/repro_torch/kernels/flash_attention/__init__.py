"""Flash attention forward: Hopper kernel (``csrc/``), wrapper (``ops``)
and plain PyTorch versions (``ref``)."""
