"""dlaf_tpu_torch — the PyTorch/CUDA port of ``dlaf_tpu``.

A package of its own beside the JAX reference: it imports ``torch`` and
numpy, never ``jax`` and nothing under ``dlaf_tpu``. The module layout
mirrors the reference so each counterpart is easy to find. It covers, local
and on a 2-D block-cyclic grid of ranks that one controller drives
(``comm/``): the blocked Cholesky, the triangular solve and multiply, HEGST
and the QR T factor, reduction to band, the band-to-tridiagonal chase (host
C++), the divide-and-conquer tridiagonal solver (host C++ secular solver and
deflation scan), both back-transforms, and the standard and generalized
eigensolvers; down to the hand-written Hopper kernels of ``csrc/`` (panel,
Ozaki slice, trailing-update and Givens-undo kernels).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
