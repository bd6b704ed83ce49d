"""dlaf_tpu_torch — the PyTorch/CUDA port of ``dlaf_tpu``.

A package of its own beside the JAX reference: it imports ``torch`` and
numpy, never ``jax`` and nothing under ``dlaf_tpu``. The module layout
mirrors the reference so each counterpart is easy to find. This slice
covers the local (1x1 grid) blocked Cholesky down to its hand-written
Hopper panel kernels (``tile_ops/panel_kernels.py``, ``csrc/panel.cu``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
