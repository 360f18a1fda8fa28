"""``repro_torch`` — the PyTorch/CUDA port of the Monad reproduction.

A second package beside the JAX reference ``repro``: the same modules under
the same names, written over tensors with an explicit population dimension,
with the TPU kernels replaced by kernels written for NVIDIA Hopper.  It
imports ``torch`` and numpy, never ``jax`` or ``repro``.  Entry points run on
``device="cuda"`` unless the caller passes ``device="cpu"``.

    from repro_torch.api import Problem, Query, Session
    from repro_torch.core.presets import transformer_block

    r = Session().submit(Query(Problem(transformer_block())))
"""
