"""The algorithms layer's public API (the reference's free functions:
``factorization::cholesky``, ``solver::triangular``,
``multiplication::triangular``/``general``, ``eigensolver::genToStd``,
``permutations::permute``, ``auxiliary::norm``), with the batched serving
entry points; the same names as ``dlaf_tpu/algorithms/__init__.py``."""

from .batched import cholesky_batched, eigh_batched, solve_batched
from .cholesky import cholesky
from .gen_to_std import gen_to_std
from .general import general_sub_multiply
from .norm import max_norm
from .permutations import permute
from .qr import t_factor
from .triangular import triangular_multiply, triangular_solve

__all__ = [
    "cholesky",
    "cholesky_batched",
    "eigh_batched",
    "solve_batched",
    "t_factor",
    "gen_to_std",
    "general_sub_multiply",
    "max_norm",
    "permute",
    "triangular_multiply",
    "triangular_solve",
]
