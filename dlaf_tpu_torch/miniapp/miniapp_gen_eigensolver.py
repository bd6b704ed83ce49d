"""Generalized eigensolver benchmark driver.

Port of ``dlaf_tpu/miniapp/miniapp_gen_eigensolver.py`` (reference
``miniapp/miniapp_gen_eigensolver.cpp``): the pipeline (cholesky ->
gen_to_std -> eigensolver -> triangular back-substitution) and the timing
protocol are :mod:`.miniapp_eigensolver`'s; this entry point mirrors the
reference's separate executable by appending ``--generalized``.

Run:  python -m dlaf_tpu_torch.miniapp.miniapp_gen_eigensolver -m 4096 -b 256 --check-result last
"""

from __future__ import annotations

from .miniapp_eigensolver import run as _run_eigensolver


def run(argv=None) -> list[dict]:
    import sys

    argv = list(sys.argv[1:]) if argv is None else list(argv)
    if "--generalized" not in argv:
        argv.append("--generalized")
    return _run_eigensolver(argv)


def main(argv=None) -> int:
    from ..comm import multihost

    try:
        run(argv)
    finally:
        multihost.finalize_multihost()
    return 0


if __name__ == "__main__":
    main()
