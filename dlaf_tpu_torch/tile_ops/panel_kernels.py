"""Hand-written Hopper panel kernels of the blocked Cholesky, and their
plain PyTorch versions.

Port of ``dlaf_tpu/tile_ops/pallas_panel.py``. Four wrappers, each over
CUDA kernels in ``csrc/panel.cu`` (built with ``nvcc`` for ``sm_90a`` at
first use into ``_build/``, bound with ``ctypes``; see
:mod:`.cuda_build`):

:func:`potrf`
    Replaces ``pallas_panel._fused_potrf`` (pallas_panel.py:187). Bound on
    this card by latency, not by bytes or flops: a d=256 tile is 256 KiB
    and 5.6 MFLOP, and the ladder is a chain of 256 dependent column
    steps. ONE block of 512 threads keeps the whole lower triangle in
    shared memory (packed rows, 135 KB at d=256) for the factorization,
    with three barriers per 8-wide micro-panel: one warp factors the 8 x 8
    diagonal block in registers, one thread per row below replays its
    eight rsqrt-scaled column steps, and the micro-panels go in pairs, so
    that all threads apply one rank-16 update of the trailing triangle per
    pair, in 8 x 4 register blocks. One launch; the tile is read once and
    ``out`` (and, for the fused entries, the f32 factor) written once.

:func:`panel_solve`
    Replaces ``pallas_panel._fused_solve_rows`` (:296) and
    ``fused_panel_solve`` (:311). Bound by the strip's bytes and the
    product's flops (m x d x d). The TPU kernel builds the inverse at grid
    step 0 and reuses it on later steps of its in-order grid; CUDA blocks
    run in no order, so this is two launches on one stream: one block of
    512 threads inverts the triangle into f32 scratch, the triangle
    resident in shared memory and inverted in place by recursive doubling
    (all 8 x 8 diagonal blocks at once, then ``X21 = -X22 (T21 X11)`` for
    b = 8 .. 128, every loop over the non-zero range only, so that a NaN
    reaches the rows it reaches in the reference's substitution), then the
    strip product ``b @ op(inv)`` over many blocks: f32 FMAs from 8 x 8
    register tiles, A resident in shared memory and B streamed by the TMA,
    each 32-column group running only the K chunks the triangular inverse
    reaches (9 of 16), with the skipped chunks' ``b * 0`` added so that a
    non-finite ``b`` gives the dense product's NaN. Left-side solves map
    onto the right-side kernel by the transpose identity, as in the
    reference.

:func:`factor_solve`
    Replaces ``pallas_panel._fused_factor_solve_rows`` (:442) and
    ``fused_factor_solve`` (:463): potrf of the diagonal tile + the whole
    strip solve ``X fac^H = strip``, the scan builder's step form. Bound by
    the strip product's flops like :func:`panel_solve`, with the factor's
    latency chain in front. Three launches on one stream: the factor (one
    block, which leaves the f32 factor in scratch), its inverse (one
    block), the strip product (many blocks). The strip may have any
    number of rows, or be a stacked ``(R, d, d)`` tile batch.

:func:`step`
    Replaces ``pallas_panel._fused_step_lower`` (:508) and ``fused_step``
    (:533): potrf + strip solve + the adjacent trailing slab
    ``slab - mask(p @ p[:w]^T)``. Four launches on one stream: the factor
    (one block), its inverse (one block), the strip product (which also
    keeps the solved strip in f32 for the slab), then the masked slab
    product (the strip product's kernel body, dense over K, a tile wholly
    above the mask only copying ``slab``), which reads ``p0 = p[:w]`` after
    the strip launch finished.

Nothing is padded: the kernels take d, m, w and leading dimensions and
mask ragged edges themselves. ``uplo='U'`` is mapped onto the lower kernels
by contiguous transposed copies made here.

Each wrapper uses its plain version (``potrf_plain``, ``panel_solve_plain``,
``factor_solve_plain``, ``step_plain``: same math, straightforward tensor
code) only for a tensor on the CPU. For a CUDA tensor it launches the
kernels or raises. Each call that launches adds one to ``LAUNCHES[name]``,
however many CUDA launches the call makes. Each wrapper is a program
telemetry site with the reference's label (``pallas_panel.potrf``,
``.solve``, ``.factor_solve``, ``.step``; :mod:`..obs.telemetry`).
"""

from __future__ import annotations

import ctypes

import torch

from .. import config
from ..obs import telemetry
from ..obs.trace import kernel_node
from . import cuda_build as cb

#: Micro-block width of the potrf ladder and of the triangular inverse.
MICRO = 8

#: Largest diagonal tile the kernels take (``PANEL_MAX`` in panel.cu; the
#: reference's ``PANEL_MB_MAX``).
PANEL_MB_MAX = 256

SUPPORTED = (torch.float32, torch.bfloat16)

#: Calls that launched each kernel family (plain integers).
LAUNCHES = {"potrf": 0, "solve": 0, "factor_solve": 0, "step": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# Build and binding
# ---------------------------------------------------------------------------

def _bind(lib) -> None:
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.dlaf_potrf.argtypes = [I, P, I, P, I, P, I, P]
    lib.dlaf_trinv.argtypes = [I, P, I, I, P, I, P]
    lib.dlaf_strip.argtypes = [I, P, I, P, I, P, I, P, I, I, I, P]
    lib.dlaf_slab.argtypes = [I, P, I, P, I, P, I, I, I, I, P]
    for fn in (lib.dlaf_potrf, lib.dlaf_trinv, lib.dlaf_strip, lib.dlaf_slab):
        fn.restype = I


#: ``csrc/panel.cu``, built at first use into ``_build/``.
LIBRARY = cb.CudaLibrary("panel", (), _bind)
_BUILD = cb.BUILD_DIR


def library_path() -> str:
    """Path of the shared library for the current source (hash-keyed)."""
    return LIBRARY.path()


def build() -> str:
    """Compile ``csrc/panel.cu`` unless its library exists; returns its path."""
    return LIBRARY.build()


def _code(dtype: torch.dtype) -> int:
    return 0 if dtype == torch.float32 else 1


def _rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` with unit column stride (a copy only where needed)."""
    return t if t.stride(-1) == 1 else t.contiguous()


def _require(t: torch.Tensor, d: int) -> None:
    if not t.is_cuda:
        raise ValueError(f"panel kernels: expected a CUDA or CPU tensor, got {t.device}")
    if t.dtype not in SUPPORTED:
        raise TypeError(f"panel kernels take float32/bfloat16, got {t.dtype}")
    if d > PANEL_MB_MAX:
        raise ValueError(f"panel kernels take tiles up to {PANEL_MB_MAX}, got {d}")


# ---------------------------------------------------------------------------
# Plain PyTorch versions (same math, any schedule)
# ---------------------------------------------------------------------------

def _factor_f32(x: torch.Tensor) -> torch.Tensor:
    """f32 lower factor of the lower triangle of ``x`` by the right-looking
    MICRO ladder with rsqrt-scaled columns (strict upper zero). A
    non-positive pivot gives NaN/inf that reaches every later column, and,
    through the zero-multiplier update of the micro-panel's earlier
    columns, turns the failing rows' entries there to NaN, as the
    reference's ladder does (``pallas_panel.py:147-148``)."""
    x = torch.tril(x.float())
    d = x.shape[-1]
    for j0 in range(0, d, MICRO):
        je = min(j0 + MICRO, d)
        for c in range(j0, je):
            x[c:, c] = x[c:, c] * torch.rsqrt(x[c, c])
            if c > j0:
                x[c:, j0:c] -= x[c:, c:c + 1] * 0.0
            if c + 1 < je:
                x[c + 1:, c + 1:je] -= x[c + 1:, c:c + 1] * x[c + 1:je, c][None, :]
        if je < d:
            l21 = x[je:, j0:je]
            x[je:, je:] -= l21 @ l21.mT
    return torch.tril(x)


def _tri_inv_lower(t: torch.Tensor) -> torch.Tensor:
    """Inverse of the f32 lower triangle ``t``: each MICRO diagonal block by
    substitution, its block row as ``-Dinv (R Xprefix)``."""
    d = t.shape[-1]
    x = torch.zeros_like(t)
    for j0 in range(0, d, MICRO):
        je = min(j0 + MICRO, d)
        blk = t[j0:je, j0:je]
        dinv = torch.zeros_like(blk)
        for i in range(je - j0):
            e = torch.zeros(je - j0, dtype=t.dtype, device=t.device)
            e[i] = 1.0
            if i:
                e = e - blk[i, :i] @ dinv[:i]
            dinv[i] = e / blk[i, i]
        if j0:
            x[j0:je, :j0] = -(dinv @ (t[j0:je, :j0] @ x[:j0, :j0]))
        x[j0:je, j0:je] = dinv
    return x


def _factor_with_passthrough(diag: torch.Tensor):
    """(f32 lower factor, factor in ``diag``'s dtype with the strict upper
    triangle of ``diag`` passed through)."""
    f = _factor_f32(diag)
    low = torch.ones(diag.shape, dtype=torch.bool, device=diag.device).tril()
    return f, torch.where(low, f, diag.float()).to(diag.dtype)


def potrf_plain(uplo: str, a: torch.Tensor) -> torch.Tensor:
    """Cholesky factor of one tile stored in ``uplo``; the opposite
    triangle passes through. Computed in f32, returned in ``a``'s dtype."""
    out = _factor_with_passthrough(a if uplo == "L" else a.mT)[1]
    return out if uplo == "L" else out.mT


def panel_solve_plain(side: str, uplo: str, op: str, diag: str, a: torch.Tensor,
                      b: torch.Tensor, *, alpha=1.0) -> torch.Tensor:
    """Solve ``op(A) X = alpha B`` (side 'L') or ``X op(A) = alpha B``
    (side 'R') with the triangle of ``a``; ``b`` 2-D or a stacked tile
    batch. Real dtypes: 'C' is 'T'."""
    out_dtype = b.dtype
    if alpha != 1.0:
        b = (alpha * b).to(out_dtype)
    if side == "L":
        flip = {"N": "T", "T": "N", "C": "N"}
        return panel_solve_plain("R", uplo, flip[op], diag, a, b.mT).mT
    t = a.float()
    t = torch.tril(t) if uplo == "L" else torch.triu(t)
    if diag == "U":
        t.fill_diagonal_(1.0)
    inv = _tri_inv_lower(t) if uplo == "L" else _tri_inv_lower(t.mT).mT
    shape = b.shape
    b2 = b.reshape(-1, shape[-1]).float()
    out = b2 @ (inv if op == "N" else inv.mT)
    return out.to(out_dtype).reshape(shape)


def factor_solve_plain(uplo: str, diag: torch.Tensor, strip: torch.Tensor):
    """Potrf + whole-strip solve: ``(fac, panel)``. uplo 'L': ``fac`` the
    lower factor of ``diag`` (strict upper passes through), ``panel =
    strip fac^-H`` over the rows of ``strip`` ((rows, d) or a stacked
    (R, d, d) batch, flattened to rows). uplo 'U' is the transpose."""
    if uplo == "U":
        fac, pan = factor_solve_plain("L", diag.mT, strip.mT)
        return fac.mT, pan.mT
    f, fac = _factor_with_passthrough(diag)
    shape = strip.shape
    p = strip.reshape(-1, shape[-1]).float() @ _tri_inv_lower(f).mT
    return fac, p.to(strip.dtype).reshape(shape)


def step_plain(uplo: str, diag: torch.Tensor, strip: torch.Tensor, slab: torch.Tensor):
    """One blocked step: ``(fac, panel, new_slab)``. uplo 'L': ``strip``
    (m, d) below the diagonal, ``slab`` (m, w) the first w trailing
    columns; ``panel = strip fac^-H``, ``new_slab = slab - mask(panel
    panel[:w]^H)`` with mask ``row >= col``. uplo 'U' is the transpose."""
    if uplo == "U":
        fac, pan, ns = step_plain("L", diag.mT, strip.mT, slab.mT)
        return fac.mT, pan.mT, ns.mT
    m, w = slab.shape
    f, fac = _factor_with_passthrough(diag)
    p = strip.float() @ _tri_inv_lower(f).mT
    upd = p @ p[:w].mT
    mask = (torch.arange(m, device=p.device)[:, None]
            >= torch.arange(w, device=p.device)[None, :])
    new = slab.float() + torch.where(mask, -upd, 0.0)
    return fac, p.to(strip.dtype), new.to(slab.dtype)


# ---------------------------------------------------------------------------
# Wrappers: kernel on a CUDA tensor, plain version on a CPU tensor
# ---------------------------------------------------------------------------

def potrf(uplo: str, a: torch.Tensor) -> torch.Tensor:
    """Cholesky factor of one tile (see :func:`potrf_plain`); telemetry
    site ``pallas_panel.potrf``."""
    return telemetry.call("pallas_panel.potrf", _potrf, uplo, a)


def panel_solve(side: str, uplo: str, op: str, diag: str, a: torch.Tensor,
                b: torch.Tensor, *, alpha=1.0) -> torch.Tensor:
    """Panel TRSM against one triangular tile (see
    :func:`panel_solve_plain`); telemetry site ``pallas_panel.solve``."""
    return telemetry.call("pallas_panel.solve", _panel_solve, side, uplo, op, diag, a, b,
                          alpha=alpha)


def factor_solve(uplo: str, diag: torch.Tensor, strip: torch.Tensor):
    """Potrf + whole-strip solve (see :func:`factor_solve_plain`);
    telemetry site ``pallas_panel.factor_solve``."""
    return telemetry.call("pallas_panel.factor_solve", _factor_solve, uplo, diag, strip)


def step(uplo: str, diag: torch.Tensor, strip: torch.Tensor, slab: torch.Tensor):
    """One fused blocked step (see :func:`step_plain`); telemetry site
    ``pallas_panel.step``."""
    return telemetry.call("pallas_panel.step", _step, uplo, diag, strip, slab)


@kernel_node(LAUNCHES, "potrf")
@cb.on_device
def _potrf(uplo: str, a: torch.Tensor) -> torch.Tensor:
    """Cholesky factor of one tile.

    Replaces ``pallas_panel._fused_potrf``. Bound by latency (256 dependent
    column steps at d=256), not bytes or flops; one block with the lower
    triangle resident in shared memory, three barriers per micro-panel."""
    if a.device.type == "cpu":
        return potrf_plain(uplo, a)
    d = a.shape[-1]
    _require(a, d)
    x = _rows(a) if uplo == "L" else a.mT.contiguous()
    out = torch.empty((d, d), dtype=a.dtype, device=a.device)
    # no f32 copy of the factor: nothing here reads it
    cb.check(LIBRARY.load().dlaf_potrf(_code(a.dtype), x.data_ptr(), x.stride(0),
                                       out.data_ptr(), d, None, d, cb.stream(a)), "potrf")
    LAUNCHES["potrf"] += 1
    return out if uplo == "L" else out.mT


@kernel_node(LAUNCHES, "solve")
@cb.on_device
def _panel_solve(side: str, uplo: str, op: str, diag: str, a: torch.Tensor,
                 b: torch.Tensor, *, alpha=1.0) -> torch.Tensor:
    """Panel TRSM against one triangular tile.

    Replaces ``pallas_panel._fused_solve_rows``/``fused_panel_solve``. Bound
    by the strip product's FMAs (m d^2 / 2 on the triangle) and the shared
    memory that feeds them; the inverse the TPU kept in VMEM across its
    in-order grid is a one-block launch here, then a many-block f32
    product applies it over the triangle's K chunks only."""
    if a.device.type == "cpu":
        return panel_solve_plain(side, uplo, op, diag, a, b, alpha=alpha)
    out_dtype = b.dtype
    if alpha != 1.0:
        b = (alpha * b).to(out_dtype)
    if side == "L":
        flip = {"N": "T", "T": "N", "C": "N"}
        return _panel_solve("R", uplo, flip[op], diag, a, b.mT).mT
    d = a.shape[-1]
    _require(a, d)
    if b.dtype != a.dtype:
        raise TypeError(f"panel_solve: a is {a.dtype}, b is {b.dtype}")
    shape = b.shape
    b2 = _rows(b.reshape(-1, d))
    f = b2.shape[0]
    t = _rows(a) if uplo == "L" else a.mT.contiguous()
    # out = b @ op(inv(T)); with T stored upper, inv(T) = inv(T^T)^T
    trans = int((op != "N") != (uplo == "U"))
    inv = torch.empty((d, d), dtype=torch.float32, device=a.device)
    out = torch.empty((f, d), dtype=b.dtype, device=b.device)
    lib, s = LIBRARY.load(), cb.stream(a)
    cb.check(lib.dlaf_trinv(_code(a.dtype), t.data_ptr(), t.stride(0), int(diag == "U"),
                            inv.data_ptr(), d, s), "panel_solve inverse")
    if f:
        cb.check(lib.dlaf_strip(_code(b.dtype), b2.data_ptr(), b2.stride(0), inv.data_ptr(),
                                trans, out.data_ptr(), d, None, 0, f, d, s),
                 "panel_solve strip")
    LAUNCHES["solve"] += 1
    return out.reshape(shape)


@kernel_node(LAUNCHES, "factor_solve")
@cb.on_device
def _factor_solve(uplo: str, diag: torch.Tensor, strip: torch.Tensor):
    """Potrf + whole-strip solve.

    Replaces ``pallas_panel._fused_factor_solve_rows``/``fused_factor_solve``.
    The TPU kernel keeps the factor's inverse in VMEM across its in-order
    grid; here the factor and its inverse are one-block launches and a
    many-block tiled f32 product solves the strip, all on one stream."""
    if diag.device.type == "cpu":
        return factor_solve_plain(uplo, diag, strip)
    if uplo == "U":
        fac, pan = _factor_solve("L", diag.mT, strip.mT)
        return fac.mT, pan.mT
    d = diag.shape[-1]
    _require(diag, d)
    if strip.dtype != diag.dtype or strip.shape[-1] != d:
        raise TypeError(f"factor_solve: diag {diag.dtype} {tuple(diag.shape)} does not "
                        f"match strip {strip.dtype} {tuple(strip.shape)}")
    shape = strip.shape
    b2 = _rows(strip.reshape(-1, d))
    f = b2.shape[0]
    diag = _rows(diag)
    dev, dt, code = diag.device, diag.dtype, _code(diag.dtype)
    fac = torch.empty((d, d), dtype=dt, device=dev)
    work = torch.empty((d, d), dtype=torch.float32, device=dev)
    inv = torch.empty((d, d), dtype=torch.float32, device=dev)
    out = torch.empty((f, d), dtype=dt, device=dev)
    lib, s = LIBRARY.load(), cb.stream(diag)
    cb.check(lib.dlaf_potrf(code, diag.data_ptr(), diag.stride(0), fac.data_ptr(), d,
                            work.data_ptr(), d, s), "factor_solve potrf")
    cb.check(lib.dlaf_trinv(2, work.data_ptr(), d, 0, inv.data_ptr(), d, s),
             "factor_solve inverse")
    if f:
        cb.check(lib.dlaf_strip(code, b2.data_ptr(), b2.stride(0), inv.data_ptr(), 1,
                                out.data_ptr(), d, None, 0, f, d, s), "factor_solve strip")
    LAUNCHES["factor_solve"] += 1
    return fac, out.reshape(shape)


@kernel_node(LAUNCHES, "step")
@cb.on_device
def _step(uplo: str, diag: torch.Tensor, strip: torch.Tensor, slab: torch.Tensor):
    """One fused blocked step.

    Replaces ``pallas_panel._fused_step_lower``/``fused_step``. Bound by the
    strip and slab products' flops; the factor, the inverse, the strip
    product and the masked slab are four launches on one stream, the slab
    reading the solved strip (f32) after the strip launch has finished."""
    if diag.device.type == "cpu":
        return step_plain(uplo, diag, strip, slab)
    if uplo == "U":
        fac, pan, ns = _step("L", diag.mT, strip.mT, slab.mT)
        return fac.mT, pan.mT, ns.mT
    d = diag.shape[-1]
    _require(diag, d)
    if not strip.dtype == slab.dtype == diag.dtype:
        raise TypeError("step: diag, strip and slab must share a dtype")
    m, w = slab.shape
    diag, strip, slab = _rows(diag), _rows(strip), _rows(slab)
    dev, dt, code = diag.device, diag.dtype, _code(diag.dtype)
    fac = torch.empty((d, d), dtype=dt, device=dev)
    work = torch.empty((d, d), dtype=torch.float32, device=dev)
    inv = torch.empty((d, d), dtype=torch.float32, device=dev)
    panel = torch.empty((m, d), dtype=dt, device=dev)
    new = torch.empty((m, w), dtype=dt, device=dev)
    # the slab reads the solved strip in f32: the panel itself for f32
    p32 = panel if dt == torch.float32 else torch.empty((m, d), dtype=torch.float32,
                                                        device=dev)
    lib, s = LIBRARY.load(), cb.stream(diag)
    cb.check(lib.dlaf_potrf(code, diag.data_ptr(), diag.stride(0), fac.data_ptr(), d,
                            work.data_ptr(), d, s), "step potrf")
    cb.check(lib.dlaf_trinv(2, work.data_ptr(), d, 0, inv.data_ptr(), d, s), "step inverse")
    if m:
        cb.check(lib.dlaf_strip(code, strip.data_ptr(), strip.stride(0), inv.data_ptr(), 1,
                                panel.data_ptr(), d,
                                None if p32 is panel else p32.data_ptr(), d, m, d, s),
                 "step strip")
        cb.check(lib.dlaf_slab(code, p32.data_ptr(), d, slab.data_ptr(), slab.stride(0),
                               new.data_ptr(), w, m, w, d, s), "step slab")
    LAUNCHES["step"] += 1
    return fac, panel, new


# ---------------------------------------------------------------------------
# Route policy (the reference's panel_uses_fused / step_uses_fused)
# ---------------------------------------------------------------------------

def _route(knob: str, site: str, dtype: torch.dtype, nb: int, device_type: str) -> bool:
    """The fused route's gate (the reference's ``panel_uses_fused`` /
    ``step_uses_fused``): ``knob`` must resolve to "fused" and the dtype
    and block fit. Where they do not, an ``auto`` that resolved to "fused"
    is route policy, announced once; an explicit "fused" is a degradation,
    counted at ``site`` (``DLAF_STRICT`` raises). A fitting route is then
    open unless ``health.inject.disable_pallas`` closed it (counted at
    ``site`` too).

    An autotune route's override (:mod:`..autotune.routes`) is policy,
    never a degradation: it counts no fallback and never raises, and its
    "fused" binds on ``cuda`` only (the ladders stay inert on the CPU),
    where an explicit configured "fused" binds everywhere."""
    from ..health.registry import report_fallback, route_available

    if config.resolve(knob, device_type) != "fused":
        return False
    routed = config.route_override(knob) is not None
    if routed and device_type != "cuda":
        return False
    if not (dtype in SUPPORTED and nb <= PANEL_MB_MAX):
        detail = (f"dtype={dtype} nb={nb} (the fused {site} needs float32/bfloat16, "
                  f"nb<={PANEL_MB_MAX})")
        if not routed and getattr(config.get_configuration(), knob) == "fused":
            report_fallback(site, "unsupported_dtype" if dtype not in SUPPORTED
                            else "block_too_large", detail=detail)
        else:
            config.announce_once((knob, dtype, nb), f"{knob}=fused does not apply to "
                                 f"{detail}; using the composed route")
        return False
    return route_available("pallas", site)


def panel_uses_fused(dtype: torch.dtype, nb: int, device_type: str) -> bool:
    """Do the potrf/solve tiles go through the panel kernels? Resolved
    once per entry (site ``panel``)."""
    return _route("panel_impl", "panel", dtype, nb, device_type)


def step_uses_fused(dtype: torch.dtype, nb: int, device_type: str) -> bool:
    """Does each strip-bearing step go through the fused step kernels?
    (site ``step``)"""
    return _route("step_impl", "step", dtype, nb, device_type)
