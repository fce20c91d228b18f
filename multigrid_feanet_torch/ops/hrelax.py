"""The H-relax step and the fused H-MG V-cycle legs with the learned H-Net
smoother, on compact fields.

Port of ``multigrid_feanet_tpu/ops/pallas_hrelax.py``.
One H-relax step is a weighted-Jacobi sweep corrected by the H-Net's chain
of L interior-masked 3x3 convolutions (``params``: the (L, 3, 3) float32
kernels):

    jac = u + (omega/d)(f - A u) at interior nodes, u elsewhere
    x0 = jac - u at interior nodes;  x_{l+1} = mask . conv3x3(x_l, k_l)
    u_new = jac + x_L

Fields are those of ``ops/sweep.py``: (n+1, n+1) float32 node fields, an
(n, n) int8 element phase map (None = homogeneous) and (n/2+1, n/2+1)
float32 coarse fields.  ``dform`` selects the difference-form apply for the
operator applies; the zero-guess start g0 = (omega/d) f takes no apply.

Five kernels, hand-written in CUDA C++ (``csrc/hrelax.cu``):

====  ================  ============================================  ==================
name  C entry point     replaces                                      computes
====  ================  ============================================  ==================
E1    ``mg_hrelax``     ``pallas_hrelax.py:55 _hrelax_kernel``        u_new = hrelax(u); rsq of u
E2    ``mg_hswrr``      ``pallas_hrelax.py:287 _hswrr_kernel``        u1 = hrelax(u0); f_c = 4 FW(f - A u1); rsq of u0
E3    ``mg_phrelax``    ``pallas_hrelax.py:361 _phrelax_kernel``      u3 = hrelax(u1 + P(uc))
E4    ``mg_zhswrr``     ``pallas_hrelax.py:420 _zhswrr_kernel``       f_c = 4 FW(f - A hrelax(0))
E5    ``mg_zphrelax``   ``pallas_hrelax.py:460 _zphrelax_kernel``     u3 = hrelax(hrelax(0) + P(uc))
====  ================  ============================================  ==================

Each has a wrapper ``<leg>_cuda`` and a plain PyTorch version
``<leg>_plain`` with the same signature, built from :func:`hrelax_plain`,
E1's plain version.  E1 alone takes a boundary value ``bc``: the ring reset
of ``jacobi_step``, so that ``models/hnet.py::h_relax`` runs on it with the
JAX package's arithmetic.  The level-facing functions :func:`hrelax`,
:func:`hswrr`, :func:`phrelax`, :func:`zhswrr` and :func:`zphrelax` take a
:class:`~multigrid_feanet_torch.ops.sweep.SweepLevel`: CPU tensors take the
plain version, CUDA tensors launch the kernel or raise.  Kernels and plain
versions agree to ``TOL`` as those of ``ops/sweep.py`` do.

All five stream rows (``csrc/hrelax.cu``): their wrappers launch them on
the bands and strips of :func:`e1_tiles` .. :func:`e5_tiles`, with the
strip height :func:`row_strip` picks for the level's size and the card's
occupancy, and levels of up to ``E1_ONE_PASS_MAX_N[L]`` ..
``E5_ONE_PASS_MAX_N[L]`` on one-pass tiles (:func:`e1_launch_tiles` ..
:func:`e5_launch_tiles`); E1 and E2 finish their norms in their last
block.  Their u, f, the phase, a boundary field and uc must start on a
16-byte boundary.  The kernels are built for chain depths
``SUPPORTED_DEPTHS``; the wrappers raise ValueError for any other.  The
prolongation-fused legs (E3, E5) need an odd depth, as the TPU wrappers
assert; the plain versions take any depth otherwise.
"""

from __future__ import annotations

import ctypes

import torch

from multigrid_feanet_torch import _build
from multigrid_feanet_torch.ops import sweep as sw

TOL = sw.TOL
SUPPORTED_DEPTHS = (1, 3)  # the chain depths of the repository's checkpoints

# ---------------------------------------------------------------------------
# Plain twins of the in-kernel math (pallas_hrelax.py:203-284).
# ---------------------------------------------------------------------------


def _depth(params, odd: bool = False) -> int:
    """The chain depth L of (L, 3, 3) H-Net kernels; ``odd`` for the
    prolongation-fused legs."""
    if params.dim() != 3 or tuple(params.shape[1:]) != (3, 3) or params.shape[0] < 1:
        raise ValueError(f"params must be (L, 3, 3) H-Net kernels, not {tuple(params.shape)}")
    L = int(params.shape[0])
    if odd and L % 2 == 0:
        raise ValueError(f"the prolongation-fused legs need an odd chain depth, not L={L}")
    return L


def _conv3x3(x, k):
    """Zero-padded 3x3 cross-correlation, summed a-major as ``_hchain``."""
    X = sw._shifts(x)
    y = None
    for a in range(3):
        for b in range(3):
            t = k[a, b] * X(a - 1, b - 1)
            y = t if y is None else y + t
    return y


def _hchain(x, params, mask):
    """The L-layer conv chain, each layer's output masked to the interior."""
    for l in range(params.shape[0]):
        x = torch.where(mask, _conv3x3(x, params[l]), 0.0)
    return x


def _hrelax0(f, ph, params, a0, da, omega):
    """hrelax from u = 0: g0 + H(g0) with g0 = (omega/d) f at interior nodes."""
    mask = sw._interior(f)
    Qp = sw.element_q(ph, a0, da) if ph is not None else None
    g0 = torch.where(mask, (omega / sw._diag(ph, Qp, a0, f)) * f, 0.0)
    return g0 + _hchain(g0, params, mask)


def hrelax_plain(u, f, ph, params, *, a0, da, omega, dform, bc=None, out=None, rsq=None):
    """E1: one H-relax step -> (u_new, interior ||f - A u||^2 of u).

    ``bc`` (a float or an (n+1)^2 field; None: keep u's ring) first sets
    u's boundary ring to the boundary value, as ``jacobi_step`` resets it,
    and the chain's first layer then reads the ring increment bc - u, as
    JAX's ``models/hnet.py::h_relax`` feeds jac - u to it unmasked."""
    _depth(params)
    mask = sw._interior(u)
    u0 = u
    if bc is not None:
        u = torch.where(mask, u, torch.as_tensor(bc, dtype=u.dtype, device=u.device))
    bim = ph is not None
    Qp = sw.element_q(ph, a0, da) if bim else None
    au, C4 = sw._apply_op(u, Qp, a0, bim, dform)
    d = sw._diag_bim(C4) if bim else sw._diag_hom(a0, device=u.device)
    jac = torch.where(mask, u + (omega / d) * (f - au), u)
    x0 = torch.where(mask, jac - u, 0.0) if bc is None else jac - u0
    x = _hchain(x0, params, mask)
    r = torch.where(mask, f - au, 0.0)
    return sw._emit(jac + x, out), sw._emit(torch.sum(r * r), rsq)


def _restrict_residual(u1, f, ph, cfg):
    r1, _ = sw.sweep_plain(u1, f, ph, mode="residual", **cfg)
    return sw._restrict4(r1)


# ---------------------------------------------------------------------------
# Plain PyTorch versions of the four kernels.
# ---------------------------------------------------------------------------


def hswrr_plain(u, f, ph, params, *, a0, da, omega, dform, out=None, fc_out=None,
                rsq=None):
    """E2: u1 = hrelax(u); f_c = 4 FW(f - A u1) -> (u1, f_c, rsq of u)."""
    cfg = dict(a0=a0, da=da, omega=omega, dform=dform)
    u1, rsq0 = hrelax_plain(u, f, ph, params, **cfg)
    fc = _restrict_residual(u1, f, ph, cfg)
    return sw._emit(u1, out), sw._emit(fc, fc_out), sw._emit(rsq0, rsq)


def phrelax_plain(u, f, ph, uc, params, *, a0, da, omega, dform, out=None):
    """E3: u3 = hrelax(u + P(uc)), the correction added at interior nodes."""
    _depth(params, odd=True)
    u2 = u + torch.where(sw._interior(u), sw._prolong(uc), 0.0)
    u3, _ = hrelax_plain(u2, f, ph, params, a0=a0, da=da, omega=omega, dform=dform)
    return sw._emit(u3, out)


def zhswrr_plain(f, ph, params, *, a0, da, omega, dform, out=None):
    """E4: f_c = 4 FW(f - A u1) with u1 = hrelax(0)."""
    _depth(params)
    u1 = _hrelax0(f, ph, params, a0, da, omega)
    fc = _restrict_residual(u1, f, ph, dict(a0=a0, da=da, omega=omega, dform=dform))
    return sw._emit(fc, out)


def zphrelax_plain(f, ph, uc, params, *, a0, da, omega, dform, out=None):
    """E5: u3 = hrelax(hrelax(0) + P(uc))."""
    _depth(params, odd=True)
    u2 = (_hrelax0(f, ph, params, a0, da, omega)
          + torch.where(sw._interior(f), sw._prolong(uc), 0.0))
    u3, _ = hrelax_plain(u2, f, ph, params, a0=a0, da=da, omega=omega, dform=dform)
    return sw._emit(u3, out)


# ---------------------------------------------------------------------------
# CUDA kernels: ctypes bindings, launch counts, wrappers.
# ---------------------------------------------------------------------------

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_SOURCE = "multigrid_feanet_torch/csrc/hrelax.cu"
_REPLACES = "multigrid_feanet_tpu/ops/pallas_hrelax.py:"
_TAIL = [_I, _D, _D, _D, _I, _I, _I]  # n, a0, da, omega, bim, dform, L

KERNELS = {
    # u f ph params bcf out partial done rsq; bcs bcmode; n a0 da omega; bim dform L
    # one_pass strip gx gy; stream
    "E1": sw.CudaKernel("E1_hrelax", "mg_hrelax", [_P] * 9 + [_D, _I, _I, _D, _D, _D] + [_I] * 7
                        + [_P], _REPLACES + "55", _SOURCE),
    # u f ph params u1 fc partial done rsq; n a0 da omega; bim dform L; one_pass strip gx gy;
    # stream
    "E2": sw.CudaKernel("E2_hswrr", "mg_hswrr", [_P] * 9 + [_I, _D, _D, _D] + [_I] * 7 + [_P],
                        _REPLACES + "287", _SOURCE),
    # u1 f ph uc params out; n a0 da omega; bim dform L; one_pass strip gx gy; stream
    "E3": sw.CudaKernel("E3_phrelax", "mg_phrelax", [_P] * 6 + _TAIL + [_I] * 4 + [_P],
                        _REPLACES + "361", _SOURCE),
    # f ph params fc; n a0 da omega; bim dform L; one_pass strip gx gy; stream
    "E4": sw.CudaKernel("E4_zhswrr", "mg_zhswrr", [_P] * 4 + _TAIL + [_I] * 4 + [_P],
                        _REPLACES + "420", _SOURCE),
    # f ph uc params out; n a0 da omega; bim dform L; one_pass strip gx gy; stream
    "E5": sw.CudaKernel("E5_zphrelax", "mg_zphrelax", [_P] * 5 + _TAIL + [_I] * 4 + [_P],
                        _REPLACES + "460", _SOURCE),
}


def _kernel_depth(params, odd: bool = False) -> int:
    """The chain depth, checked against the depths the kernels are built
    for (before any check of the device, so the refusal does not depend on
    where the tensors lie)."""
    L = _depth(params, odd)
    if L not in SUPPORTED_DEPTHS:
        raise ValueError(f"the CUDA kernels are built for chain depths {SUPPORTED_DEPTHS}, "
                         f"not L={L}")
    return L


def _tail(n, L, ph, a0, da, omega, dform):
    return (n, a0, da, omega, int(ph is not None), int(dform), L)


def _bc_operand(bc, n, dev):
    """(bc field or None, bc scalar, mode) of E1's boundary value: mode 0
    keeps u's ring, 1 sets it to a number, 2 to an (n+1)^2 field."""
    if bc is None:
        return None, 0.0, 0
    if torch.is_tensor(bc):
        sw._check(bc, "bc", (n + 1, n + 1), torch.float32, dev)
        return bc, 0.0, 2
    return None, float(bc), 1


# ---------------------------------------------------------------------------
# Launch geometry of E1 (and H1, ops/torus.py): row-streaming bands and
# strips (csrc/common.cuh's row streaming), in A1's block shape
# (ops/sweep.py's A12_THREADS threads of A12_COLUMNS adjacent columns, strips
# of up to A12_STRIP_MAX rows).  A block computes a band of columns and
# marches down a strip of rows; the grid and the strip height are computed
# here and passed to the kernels, which refuse a grid that does not match
# their block shape.
# ---------------------------------------------------------------------------

# levels of up to this many elements per side, by chain depth, run E1 on
# one-pass tiles (csrc/hrelax.cu e1_h_relax_tile, E2's 16 x 32 fine tiles):
# one wave holds the grid there, and a row-streaming block's 3L + 2
# dependent steps take longer than a tile's L + 2 barriers.  The largest
# level at which the tile was the faster on the H100
# (``sweep_vs_parent.py --crossover``, PERF.md)
E1_ONE_PASS_MAX_N = {1: 256, 3: 512}


def e1_tiles(n: int, L: int, strip: int = 32) -> sw.Tiles:
    """E1 with chain depth L: a block computes ``A12_THREADS A12_COLUMNS``
    columns and owns the middle ``A12_THREADS A12_COLUMNS - 2L`` (each
    stage of the chain eats a column of halo on each side)."""
    sw._check_strip(strip)
    H, band = n + 1, sw.A12_THREADS * sw.A12_COLUMNS - 2 * L
    return sw.Tiles("E1", n, band, strip, -(-H // band), -(-H // strip))


def coarse_tiles(leg: str, n: int) -> sw.Tiles:
    """One-pass tiles on the coarse grid (E1, E2, E4, G2, D2): one block per
    CY x CX coarse tile of csrc/common.cuh, whose fine tile is 16 x 32
    nodes."""
    Hc = n // 2 + 1
    return sw.Tiles(leg, n, 32, 16, -(-Hc // 16), -(-Hc // 8))


def e1_one_pass_tiles(n: int) -> sw.Tiles:
    """E1 on one-pass tiles: one block per 16 x 32 tile of fine nodes, the
    fine tiles of csrc/common.cuh's CY x CX coarse tiles (E2's grid)."""
    return coarse_tiles("E1_tile", n)


def e1_halo_steps(L: int) -> int:
    """Steps an E1 block takes beyond its strip's rows: the u rows of the
    chain's halo (2L + 2) and the wavefront's lag (L: each conv layer reads
    rows its input layer finished a step earlier)."""
    return 3 * L + 2


def row_strip(tiles_of, halo: int, slots, sms: int) -> int:
    """The even strip height in [2, A12_STRIP_MAX] that finishes a level
    soonest on a card of ``sms`` SMs that holds ``slots`` blocks at once
    (a number, or ``slots(strip)`` where a strip's height sets the block's
    shared memory), ``tiles_of(strip)`` being the level's geometry and
    ``halo`` the steps a block takes beyond its rows.  The cost is A3/A4's
    (``ops/sweep.py::balanced_strip``): a step costs a block a fixed latency
    plus the issue time it shares with the blocks beside it on its SM, so a
    level takes steps x (``_STEP_LATENCY`` waves + blocks per SM).  On the
    finest levels that is whole waves times steps; on coarse ones (one wave)
    short strips shorten each block's chain of steps until their halo steps
    crowd the SMs."""
    best = None
    for strip in range(2, sw.A12_STRIP_MAX + 1, 2):
        blocks = tiles_of(strip).blocks
        waves = -(-blocks // max(1, slots(strip) if callable(slots) else slots))
        cost = (strip + halo) * (sw._STEP_LATENCY * waves + -(-blocks // sms))
        if best is None or cost < best[0]:
            best = (cost, strip)
    return best[1]


def occupancy(symbol: str, *args) -> int:
    """Blocks per SM that the library's ``symbol`` reports for a kernel
    instance; raises on a CUDA error."""
    fn = getattr(_build.load(), symbol)
    fn.argtypes, fn.restype = [_I] * len(args), _I
    blocks = fn(*args)
    if blocks <= 0:
        raise RuntimeError(f"{symbol}: CUDA error {-blocks}")
    return blocks


def launch_tiles(cache: dict, key: tuple, device, tiles_of, halo: int, symbol: str,
                 *args) -> sw.Tiles:
    """A row-streaming leg's geometry on ``device``: ``tiles_of(strip)`` at
    :func:`row_strip`'s height for the blocks per SM the library's
    ``symbol(*args)`` reports for the instance launched, kept in ``cache``
    under ``key`` (computed once per level shape)."""
    tiles = cache.get(key)
    if tiles is None:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        slots = sms * occupancy(symbol, *args)
        tiles = tiles_of(row_strip(tiles_of, halo, slots, sms))
        cache[key] = tiles
    return tiles


def row_scratch(tiles: sw.Tiles, sums: int, device, workspace) -> tuple:
    """(partials, counter) of one launch that finishes its norms in its last
    block (E1, E2, C1: ``sums`` 1; H1: 2): ``sums`` partial sums per block
    and the zeroed counter whose last block adds them (and resets it), kept
    in ``workspace`` under the whole geometry (E1's and E2's bands, and so
    their grids, depend on the chain depth)."""
    key = ("row_scratch", tiles)
    bufs = None if workspace is None else workspace.get(key)
    if bufs is None:
        bufs = (torch.empty(sums * tiles.blocks, dtype=torch.float32, device=device),
                torch.zeros(1, dtype=torch.int32, device=device))
        if workspace is not None:
            workspace[key] = bufs
    return bufs


_E1_TILES = {}


def e1_launch_tiles(n: int, L: int, bim: bool, dform: bool, bcmode: int, device) -> sw.Tiles:
    """The geometry E1 launches with on ``device``: one-pass tiles up to
    ``E1_ONE_PASS_MAX_N[L]``, else row-streaming strips of :func:`row_strip`'s
    height for the occupancy the card reports for the instance launched
    (computed once per level shape)."""
    if n <= E1_ONE_PASS_MAX_N[L]:
        return e1_one_pass_tiles(n)
    return launch_tiles(_E1_TILES, (n, L, bool(bim), bool(dform), bcmode, device.index), device,
                        lambda s: e1_tiles(n, L, s), e1_halo_steps(L), "mg_hrelax_occupancy",
                        int(bim), int(dform), L, bcmode)


# Launch geometry of E2: row-streaming bands and strips in E1's block shape,
# each block restricting to the coarse nodes under its band and strip.

# levels of up to this many elements per side, by chain depth, run E2 on
# one-pass tiles (csrc/hrelax.cu e2_h_descent, 16 x 32 fine tiles of the
# coarse grid): one wave holds the grid there, and a row-streaming block's
# 3L + 6 halo steps take longer than a tile's barriers.  The largest level
# at which the tile was the faster on the H100
# (``sweep_vs_parent.py --crossover --legs c1e2``, PERF.md)
E2_ONE_PASS_MAX_N = {1: 512, 3: 512}


def descent_tiles(leg: str, n: int, L: int, strip: int) -> sw.Tiles:
    """A descent chain with L conv layers (E2 and E4; G2 and D2 run the
    chain without them, L = 0): a block computes ``A12_THREADS
    A12_COLUMNS`` columns and owns ``A12_THREADS A12_COLUMNS - 2L - 4`` of
    them (E2's Jacobi stage reads a u window one column wider, E4's g0 needs
    none; each conv layer and the residual eat a column of halo on each
    side, the restriction one more, and the band is even) and the coarse
    nodes under its band and strip."""
    sw._check_strip(strip)
    Hc, band = n // 2 + 1, sw.A12_THREADS * sw.A12_COLUMNS - 2 * L - 4
    return sw.Tiles(leg, n, band, strip, -(-Hc // (band // 2)), -(-Hc // (strip // 2)))


def e2_tiles(n: int, L: int, strip: int = 32) -> sw.Tiles:
    """E2 with chain depth L (:func:`descent_tiles`)."""
    return descent_tiles("E2", n, L, strip)


def e2_one_pass_tiles(n: int) -> sw.Tiles:
    """E2 on one-pass tiles (:func:`coarse_tiles`)."""
    return coarse_tiles("E2_tile", n)


def e2_halo_steps(L: int) -> int:
    """Steps a descent chain's block (E2; G2 and D2 with L = 0) takes
    beyond the fine rows its strip restricts: the u rows of the chain's
    halo above (L + 3) and below (L + 2), the wavefront's lag (L: each conv
    layer reads rows its input layer finished a step earlier) and the
    residual's (1)."""
    return 3 * L + 6


_E2_TILES = {}


def e2_launch_tiles(n: int, L: int, bim: bool, dform: bool, device) -> sw.Tiles:
    """The geometry E2 launches with on ``device``: one-pass tiles up to
    ``E2_ONE_PASS_MAX_N[L]``, else row-streaming strips of :func:`row_strip`'s
    height for the occupancy the card reports for the instance launched
    (computed once per level shape)."""
    if n <= E2_ONE_PASS_MAX_N[L]:
        return e2_one_pass_tiles(n)
    return launch_tiles(_E2_TILES, (n, L, bool(bim), bool(dform), device.index), device,
                        lambda s: e2_tiles(n, L, s), e2_halo_steps(L), "mg_hswrr_occupancy",
                        int(bim), int(dform), L)


# Launch geometry of E4: E2's bands and strips (descent_tiles), its chain
# started from g0 instead of a Jacobi stage.

# levels of up to this many elements per side, by chain depth, run E4 on
# one-pass tiles (csrc/hrelax.cu e4_h_zdescent, 16 x 32 fine tiles of the
# coarse grid): the largest level at which the tile was the faster on the
# H100 (``sweep_vs_parent.py --crossover --legs e4c2``, PERF.md)
E4_ONE_PASS_MAX_N = {1: 512, 3: 512}


def e4_tiles(n: int, L: int, strip: int = 32) -> sw.Tiles:
    """E4 with chain depth L (:func:`descent_tiles`)."""
    return descent_tiles("E4", n, L, strip)


def e4_one_pass_tiles(n: int) -> sw.Tiles:
    """E4 on one-pass tiles (:func:`coarse_tiles`)."""
    return coarse_tiles("E4_tile", n)


def e4_halo_steps(L: int) -> int:
    """Steps an E4 block takes beyond the fine rows its strip restricts:
    the g0 rows of the chain's halo above (L + 2) and the element row over
    them (1), and the residual's lag behind g0 (2L + 2: each conv layer two
    rows, the residual two), during which the halo below is staged."""
    return 3 * L + 5


_E4_TILES = {}


def e4_launch_tiles(n: int, L: int, bim: bool, dform: bool, device) -> sw.Tiles:
    """The geometry E4 launches with on ``device``: one-pass tiles up to
    ``E4_ONE_PASS_MAX_N[L]``, else row-streaming strips of :func:`row_strip`'s
    height for the occupancy the card reports for the instance launched
    (computed once per level shape)."""
    if n <= E4_ONE_PASS_MAX_N[L]:
        return e4_one_pass_tiles(n)
    return launch_tiles(_E4_TILES, (n, L, bool(bim), bool(dform), device.index), device,
                        lambda s: e4_tiles(n, L, s), e4_halo_steps(L), "mg_zhswrr_occupancy",
                        int(bim), int(dform), L)


# Launch geometry of E3 and E5: row-streaming bands and strips in E1's block
# shape.  Both stage their strip's coarse rows in dynamic shared memory
# (csrc/common.cuh stage_coarse), so the blocks an SM holds depend on the
# strip's height, and row_strip asks the card at each height.

# levels of up to this many elements per side, by chain depth, run E3 and
# E5 on their one-pass tiles (csrc/hrelax.cu e3_h_ascent, e5_h_zascent, one
# block per 16 x 32 fine nodes): the largest level at which the tile was
# the faster on the H100 (``sweep_vs_parent.py --crossover --legs e3e5``,
# PERF.md; at L = 1 E3's row-streaming kernel was faster from 17^2 up)
E3_ONE_PASS_MAX_N = {1: 8, 3: 512}
E5_ONE_PASS_MAX_N = {1: 512, 3: 512}


def _ascent_one_pass_tiles(leg: str, n: int) -> sw.Tiles:
    H = n + 1
    return sw.Tiles(leg, n, 32, 16, -(-H // 32), -(-H // 16))


def e3_tiles(n: int, L: int, strip: int = 32) -> sw.Tiles:
    """E3 with chain depth L: a block computes ``A12_THREADS A12_COLUMNS``
    columns and owns ``A12_THREADS A12_COLUMNS - 2L - 2`` of them (each
    stage of the chain eats a column of halo on each side, the Jacobi
    stage's window one more; the band is even, so that the threads' columns
    start on an even column and each column's prolongation is fixed)."""
    sw._check_strip(strip)
    H, band = n + 1, sw.A12_THREADS * sw.A12_COLUMNS - 2 * L - 2
    return sw.Tiles("E3", n, band, strip, -(-H // band), -(-H // strip))


def e3_one_pass_tiles(n: int) -> sw.Tiles:
    """E3 on one-pass tiles: one block per 16 x 32 tile of fine nodes."""
    return _ascent_one_pass_tiles("E3_tile", n)


def e3_halo_steps(L: int) -> int:
    """Steps an E3 block takes beyond its strip's rows: E1's 3L + 2 (the
    u1 rows of the chain's halo, 2L + 2, and the wavefront's lag, L).  The
    prolongation adds none: the strip's coarse rows are staged before its
    first step, and each u1 row takes its correction as it is read."""
    return 3 * L + 2


def e5_tiles(n: int, L: int, strip: int = 32) -> sw.Tiles:
    """E5 with chain depth L: a block computes ``A12_THREADS A12_COLUMNS``
    columns and owns ``A12_THREADS A12_COLUMNS - 4L - 2`` of them (both
    chains' layers and the Jacobi stage eat a column of halo on each
    side)."""
    sw._check_strip(strip)
    H, band = n + 1, sw.A12_THREADS * sw.A12_COLUMNS - 4 * L - 2
    return sw.Tiles("E5", n, band, strip, -(-H // band), -(-H // strip))


def e5_one_pass_tiles(n: int) -> sw.Tiles:
    """E5 on one-pass tiles: one block per 16 x 32 tile of fine nodes."""
    return _ascent_one_pass_tiles("E5_tile", n)


def e5_halo_steps(L: int) -> int:
    """Steps an E5 block takes beyond its strip's rows: the rows staged
    above it (2L + 2: the first chain's halo of 2L + 1 and the element row
    under it) and the output row's lag behind g0 (4L + 2: each chain's L
    layers two rows each, and the Jacobi stage two, reading u2 rows a step
    old), during which the halo below is staged.  The prolongation adds
    none (its coarse rows are staged before the first step)."""
    return 6 * L + 4


_ASCENT_TILES = {}


def _ascent_launch_tiles(leg: str, n: int, L: int, bim: bool, dform: bool, device) -> sw.Tiles:
    """The geometry E3 or E5 launches with on ``device``: one-pass tiles up
    to ``E3_ONE_PASS_MAX_N[L]`` / ``E5_ONE_PASS_MAX_N[L]``, else row-streaming
    strips of :func:`row_strip`'s height for the occupancy the card reports
    for the instance launched at each height (computed once per level
    shape)."""
    limit, one_pass, tiles_of, halo, symbol = {
        "E3": (E3_ONE_PASS_MAX_N, e3_one_pass_tiles, e3_tiles, e3_halo_steps,
               "mg_phrelax_occupancy"),
        "E5": (E5_ONE_PASS_MAX_N, e5_one_pass_tiles, e5_tiles, e5_halo_steps,
               "mg_zphrelax_occupancy")}[leg]
    if n <= limit[L]:
        return one_pass(n)
    key = (leg, n, L, bool(bim), bool(dform), device.index)
    tiles = _ASCENT_TILES.get(key)
    if tiles is None:
        sms = torch.cuda.get_device_properties(device).multi_processor_count

        def slots(strip):
            return sms * occupancy(symbol, int(bim), int(dform), L, strip)

        tiles = tiles_of(n, L, row_strip(lambda s: tiles_of(n, L, s), halo(L), slots, sms))
        _ASCENT_TILES[key] = tiles
    return tiles


def e3_launch_tiles(n: int, L: int, bim: bool, dform: bool, device) -> sw.Tiles:
    """The geometry E3 launches with on ``device`` (:func:`_ascent_launch_tiles`)."""
    return _ascent_launch_tiles("E3", n, L, bim, dform, device)


def e5_launch_tiles(n: int, L: int, bim: bool, dform: bool, device) -> sw.Tiles:
    """The geometry E5 launches with on ``device`` (:func:`_ascent_launch_tiles`)."""
    return _ascent_launch_tiles("E5", n, L, bim, dform, device)


def hrelax_cuda(u, f, ph, params, *, a0, da, omega, dform, bc=None, out=None, rsq=None,
                workspace=None):
    """E1 on the card; same contract as :func:`hrelax_plain`, and u, f,
    ``ph`` and a field ``bc`` must start on a 16-byte boundary (whole
    tensors do; an offset view may not, and raises ValueError)."""
    L = _kernel_depth(params)
    n, dev = u.shape[0] - 1, u.device
    sw._operands(n, dev, [("u", u), ("f", f)], ph)
    sw._check(params, "params", (L, 3, 3), torch.float32, dev)
    bcf, bcs, mode = _bc_operand(bc, n, dev)
    out = sw._output(out, "out", (n + 1, n + 1), dev, (u, f, bcf))
    rsq = sw._scalar_out(rsq, dev)
    sw._check_aligned(("u", u), ("f", f), ("phase", ph), ("bc", bcf))
    tiles = e1_launch_tiles(n, L, ph is not None, dform, mode, dev)
    partial, done = row_scratch(tiles, 1, dev, workspace)
    KERNELS["E1"](u.data_ptr(), f.data_ptr(), sw._ptr(ph), params.data_ptr(), sw._ptr(bcf),
                  out.data_ptr(), partial.data_ptr(), done.data_ptr(), rsq.data_ptr(), bcs, mode,
                  n, a0, da, omega, int(ph is not None), int(dform), L,
                  int(tiles.leg == "E1_tile"), tiles.strip, tiles.gx, tiles.gy, sw._stream(dev))
    return out, rsq


def hswrr_cuda(u, f, ph, params, *, a0, da, omega, dform, out=None, fc_out=None, rsq=None,
               workspace=None):
    """E2 on the card; same contract as :func:`hswrr_plain`, and u, f and
    ``ph`` must start on a 16-byte boundary (whole tensors do; an offset
    view may not, and raises ValueError)."""
    L = _kernel_depth(params)
    n, dev = u.shape[0] - 1, u.device
    sw._operands(n, dev, [("u", u), ("f", f)], ph)
    sw._check(params, "params", (L, 3, 3), torch.float32, dev)
    out = sw._output(out, "out", (n + 1, n + 1), dev, (u, f))
    fc_out = sw._output(fc_out, "fc_out", (n // 2 + 1, n // 2 + 1), dev, (u, f, out))
    rsq = sw._scalar_out(rsq, dev)
    sw._check_aligned(("u", u), ("f", f), ("phase", ph))
    tiles = e2_launch_tiles(n, L, ph is not None, dform, dev)
    partial, done = row_scratch(tiles, 1, dev, workspace)
    KERNELS["E2"](u.data_ptr(), f.data_ptr(), sw._ptr(ph), params.data_ptr(), out.data_ptr(),
                  fc_out.data_ptr(), partial.data_ptr(), done.data_ptr(), rsq.data_ptr(), n, a0,
                  da, omega, int(ph is not None), int(dform), L, int(tiles.leg == "E2_tile"),
                  tiles.strip, tiles.gx, tiles.gy, sw._stream(dev))
    return out, fc_out, rsq


def phrelax_cuda(u, f, ph, uc, params, *, a0, da, omega, dform, out=None):
    """E3 on the card; same contract as :func:`phrelax_plain`, and u, f,
    ``ph`` and uc must start on a 16-byte boundary (whole tensors do; an
    offset view may not, and raises ValueError)."""
    L = _kernel_depth(params, odd=True)
    n, dev = u.shape[0] - 1, u.device
    sw._operands(n, dev, [("u", u), ("f", f)], ph, [("uc", uc)])
    sw._check(params, "params", (L, 3, 3), torch.float32, dev)
    out = sw._output(out, "out", (n + 1, n + 1), dev, (u, f, uc))
    sw._check_aligned(("u", u), ("f", f), ("phase", ph), ("uc", uc))
    tiles = e3_launch_tiles(n, L, ph is not None, dform, dev)
    KERNELS["E3"](u.data_ptr(), f.data_ptr(), sw._ptr(ph), uc.data_ptr(), params.data_ptr(),
                  out.data_ptr(), *_tail(n, L, ph, a0, da, omega, dform),
                  int(tiles.leg == "E3_tile"), tiles.strip, tiles.gx, tiles.gy, sw._stream(dev))
    return out


def zhswrr_cuda(f, ph, params, *, a0, da, omega, dform, out=None):
    """E4 on the card; same contract as :func:`zhswrr_plain`, and f and
    ``ph`` must start on a 16-byte boundary (whole tensors do; an offset
    view may not, and raises ValueError)."""
    L = _kernel_depth(params)
    n, dev = f.shape[0] - 1, f.device
    sw._operands(n, dev, [("f", f)], ph)
    sw._check(params, "params", (L, 3, 3), torch.float32, dev)
    out = sw._output(out, "out", (n // 2 + 1, n // 2 + 1), dev, (f,))
    sw._check_aligned(("f", f), ("phase", ph))
    tiles = e4_launch_tiles(n, L, ph is not None, dform, dev)
    KERNELS["E4"](f.data_ptr(), sw._ptr(ph), params.data_ptr(), out.data_ptr(),
                  *_tail(n, L, ph, a0, da, omega, dform),
                  int(tiles.leg == "E4_tile"), tiles.strip, tiles.gx, tiles.gy, sw._stream(dev))
    return out


def zphrelax_cuda(f, ph, uc, params, *, a0, da, omega, dform, out=None):
    """E5 on the card; same contract as :func:`zphrelax_plain`, and f,
    ``ph`` and uc must start on a 16-byte boundary (whole tensors do; an
    offset view may not, and raises ValueError)."""
    L = _kernel_depth(params, odd=True)
    n, dev = f.shape[0] - 1, f.device
    sw._operands(n, dev, [("f", f)], ph, [("uc", uc)])
    sw._check(params, "params", (L, 3, 3), torch.float32, dev)
    out = sw._output(out, "out", (n + 1, n + 1), dev, (f, uc))
    sw._check_aligned(("f", f), ("phase", ph), ("uc", uc))
    tiles = e5_launch_tiles(n, L, ph is not None, dform, dev)
    KERNELS["E5"](f.data_ptr(), sw._ptr(ph), uc.data_ptr(), params.data_ptr(), out.data_ptr(),
                  *_tail(n, L, ph, a0, da, omega, dform),
                  int(tiles.leg == "E5_tile"), tiles.strip, tiles.gx, tiles.gy, sw._stream(dev))
    return out


# ---------------------------------------------------------------------------
# Level-facing legs (the names of the JAX package's PallasLevel functions).
# ---------------------------------------------------------------------------


def hrelax(level: sw.SweepLevel, u, f, params, out=None, rsq=None, dform: bool = False,
           bc=None):
    """One H-relax step -> (u_new, rsq of u); ``bc`` as in
    :func:`hrelax_plain`."""
    return level._call(hrelax_cuda, hrelax_plain, u, f, level.ph, params, dform=dform, bc=bc,
                       out=out, rsq=rsq)


def hswrr(level: sw.SweepLevel, u, f, params, out=None, fc_out=None, rsq=None,
          dform: bool = False):
    """H-MG descent leg -> (u1, f_c, rsq of u)."""
    return level._call(hswrr_cuda, hswrr_plain, u, f, level.ph, params, dform=dform,
                       out=out, fc_out=fc_out, rsq=rsq)


def phrelax(level: sw.SweepLevel, u1, f, uc, params, out=None, dform: bool = False):
    """H-MG ascent leg -> u3 = hrelax(u1 + P(uc))."""
    return level._call(phrelax_cuda, phrelax_plain, u1, f, level.ph, uc, params,
                       dform=dform, out=out)


def zhswrr(level: sw.SweepLevel, f, params, out=None, dform: bool = False):
    """Zero-initial-guess H-MG descent leg -> f_c."""
    return level._call(zhswrr_cuda, zhswrr_plain, f, level.ph, params, dform=dform, out=out)


def zphrelax(level: sw.SweepLevel, f, uc, params, out=None, dform: bool = False):
    """Zero-initial-guess H-MG ascent leg -> u3."""
    return level._call(zphrelax_cuda, zphrelax_plain, f, level.ph, uc, params, dform=dform,
                       out=out)
