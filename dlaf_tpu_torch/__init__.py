"""dlaf_tpu_torch — the PyTorch/CUDA port of ``dlaf_tpu``.

A package of its own beside the JAX reference: it imports ``torch`` and
numpy, never ``jax`` and nothing under ``dlaf_tpu``. The module layout
mirrors the reference so each counterpart is easy to find. It covers the
blocked Cholesky and the triangular solve and multiply, local and on a
2-D block-cyclic grid of ranks that one
controller drives (``comm/``), down to the hand-written Hopper kernels of
``csrc/`` (panel, Ozaki slice and trailing-update kernels).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
