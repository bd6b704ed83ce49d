"""The eigensolver pipeline's multi-process cases over NCCL, one process a
card, against the single controller whose ranks sit on the same cards.

Run from the repository root on a machine with four cards:

    PYTHONPATH=. python3 -m dlaf_tpu_torch.miniapp.nccl_pipeline_check

It builds the kernels, runs the HEGST, reduction-to-band and eigensolver
cases of ``chip_smoke.py``'s multi-process phase (``MP_CASES``, N=4096) on
a 2x2 single-controller grid over ``cuda:0`` .. ``cuda:3``, then in four
spawned processes (NCCL, ``cuda:i`` for rank i), and prints for each case
whether every process's shard and arrays are bitwise the single
controller's, with the launch counts summed over the processes beside the
single controller's. No rank shares a card, so values that
``cc.per_rank_once`` shares on a shared card are formed per rank on both
sides. Exits 1 on a disagreement or a failed process.
"""

from __future__ import annotations

import os
import sys
import tempfile
import time

KINDS = ("gen_to_std", "red2band", "eigensolver", "gen_eigensolver")


def rank_main(rank: int, rdv: str, out: str) -> None:
    """Spawned process ``rank``: rank ``rank`` of the 2x2 grid on
    ``cuda:rank``; saves each case's shard, counts and arrays."""
    import torch

    import chip_smoke as cs
    from dlaf_tpu_torch.comm import multihost

    multihost.initialize_multihost(f"file://{rdv}", 4, rank, backend="nccl", timeout=600)
    grid = multihost.multihost_grid(2, 2, device=f"cuda:{rank}")
    for name, kind, letter, knobs in cs.MP_CASES:
        if kind in KINDS:
            shards, counts, arrays = cs._mp_case(kind, letter, knobs, grid)
            torch.save({"shards": shards, "counts": counts, "arrays": arrays},
                       os.path.join(out, f"{name}.r{rank}.pt"))
    multihost.finalize_multihost()


def main() -> int:
    import torch

    import chip_smoke as cs
    from dlaf_tpu_torch.comm.grid import Grid
    from dlaf_tpu_torch.tile_ops import cuda_build as cb
    from dlaf_tpu_torch.tile_ops import givens_kernels as gk
    from dlaf_tpu_torch.tile_ops import ozaki_kernels as ok
    from dlaf_tpu_torch.tile_ops import panel_kernels as pk
    from dlaf_tpu_torch.tile_ops import update_kernels as uk

    if torch.cuda.device_count() < 4:
        print(f"needs 4 cards, sees {torch.cuda.device_count()}", flush=True)
        return 2
    print(cs.smi_line(), flush=True)
    libs = (pk.LIBRARY, ok.LIBRARY, uk.LIBRARY, gk.LIBRARY)
    cb.build_all(libs)
    for lib in libs:
        lib.load()
    cases = [c for c in cs.MP_CASES if c[1] in KINDS]
    grid = Grid(2, 2, devices=[f"cuda:{i}" for i in range(4)])
    ref = {name: cs._mp_case(kind, letter, knobs, grid) for name, kind, letter, knobs in cases}
    tmp = tempfile.mkdtemp(prefix="dlaf_nccl_")
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=rank_main, args=(i, os.path.join(tmp, "rdv"), tmp))
             for i in range(4)]
    t = time.perf_counter()
    for p in procs:
        p.start()
    for p in procs:
        p.join(300)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    print(f"exit codes {codes} {time.perf_counter() - t:.1f} s", flush=True)
    if any(codes):
        return 1
    ok_all = True
    for name, _, _, _ in cases:
        got = [torch.load(os.path.join(tmp, f"{name}.r{i}.pt")) for i in range(4)]
        same, worst = cs._mp_compare(torch, got, ref[name][0], ref[name][2])
        counts = {k: sum(g["counts"].get(k, 0) for g in got) for k in ref[name][1]}
        ok_all = ok_all and same and counts == ref[name][1]
        print(f"[nccl] {name:14s} 4 processes on 4 cards (NCCL) bitwise the single controller "
              f"on the 4 cards: {same} (max rel diff {worst:.3e}); launches "
              f"{ {k: v for k, v in counts.items() if v} } single "
              f"{ {k: v for k, v in ref[name][1].items() if v} }", flush=True)
    return 0 if ok_all else 1


if __name__ == "__main__":
    sys.exit(main())
