"""Fused V-cycle legs of the 2-DOF plane elasticity operator on compact fields.

Port of ``multigrid_feanet_tpu/ops/pallas_elastic.py``.  A displacement
field is a (2, n+1, n+1) float32 tensor with component 0 = x (the column
displacement) and 1 = y (the row displacement) as planes; the element phase
map is (n, n) int8 (None = homogeneous, every element at a0); coarse fields
are (2, n/2+1, n/2+1).  The TPU's two ghost-block stride-lane buffers per
field have no counterpart here.  The smoother is the damped 2x2 block
Jacobi of the element-factored operator
(``ops/elasticity.py::apply_elastic_factored``), its block diagonal
inverted in closed form.

Five kernels, hand-written in CUDA C++ (``csrc/elastic.cu``):

====  ==================  ===============================================  ==========================
name  C entry point       replaces                                         level methods
====  ==================  ===============================================  ==========================
G1    ``mg_el_sweep``     ``pallas_elastic.py:91 _el_sweep_kernel``        sweep, residual
G2    ``mg_el_swrr``      ``pallas_elastic.py:391 _el_swrr_kernel``        sweep_restrict
G3    ``mg_el_psweep``    ``pallas_elastic.py:457 _el_psweep_kernel``      psweep
G4    ``mg_el_zrr``       ``pallas_elastic.py:504 _el_zrr_kernel``         zsweep_restrict
G5    ``mg_el_zpsweep``   ``pallas_elastic.py:555 _el_zpsweep_kernel``     zpsweep
====  ==================  ===============================================  ==========================

Each has a wrapper ``<leg>_cuda`` and a plain PyTorch version
``<leg>_plain`` with the same signature, built from the plain twin of the
in-kernel math below (``_apply_el``, ``_block_update``).  Tensors on the
CPU take the plain version; tensors on a CUDA device launch the kernel or
raise.  Kernels and plain versions agree to ``TOL`` as those of
``ops/sweep.py`` do.  Semantics shared by all legs: only globally interior
nodes are updated, boundary nodes keep their value, residuals and the
prolonged correction are zero on the boundary, the coarse output is zero on
the coarse boundary ring, and ``rsq`` is the interior squared residual norm
of the INCOMING iterate summed over both components.

G1, G2 and G5 stream rows (``csrc/elastic.cu g1_el_relax_rows``,
``g2_el_descent_rows``, ``g5_el_zascent_rows``) above
``G1_ONE_PASS_MAX_N[bim]``, ``G2_ONE_PASS_MAX_N[bim]`` and
``G5_ONE_PASS_MAX_N[bim]``: their wrappers launch them on the bands and
strips of :func:`g1_tiles`, :func:`g2_tiles` and :func:`g5_tiles`, with the
strip height ``ops/hrelax.py::row_strip`` picks for the level's size and
the card's occupancy, and smaller levels on the one-pass tiles
(:func:`g1_launch_tiles`, :func:`g2_launch_tiles`, :func:`g5_launch_tiles`);
G1 and G2 finish their norm in their last block in both designs.  Their
u, f, the phase and uc must start on a 16-byte boundary.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from multigrid_feanet_torch.core.device import resolve_device
from multigrid_feanet_torch.ops import hrelax as hx
from multigrid_feanet_torch.ops import sweep as sw
from multigrid_feanet_torch.ops.elasticity import elastic_factor_constants

TOL = sw.TOL

# ---------------------------------------------------------------------------
# Plain twins of the in-kernel math (pallas_elastic.py:46-88, 365-372), on
# whole fields, in the Pallas kernels' order of operations.
# ---------------------------------------------------------------------------


def _element_q(ph, a0: float, da: float, like: torch.Tensor) -> torch.Tensor:
    """(n+2, n+2) element coefficients in ``like``'s dtype with a ring of
    phase-0 elements (as ``ops/sweep.py::element_q``); a0 everywhere when
    homogeneous."""
    if ph is None:
        n = like.shape[-1] - 1
        return torch.full((n + 2, n + 2), a0, dtype=like.dtype, device=like.device)
    return F.pad(ph.to(like.dtype), (1, 1, 1, 1)) * da + a0


def _block_diag(Qp, consts):
    """(Dxx, Dxy) of every node: the 2x2 block diagonal [[Dxx, Dxy], [Dxy,
    Dxx]] with Dxx = al C4, Dxy = be C4s."""
    al, be = consts[0], consts[1]
    ne, nw, se, sw_ = sw._quadrants(Qp)
    return al * ((ne + nw) + (se + sw_)), be * ((ne + sw_) - (nw + se))


def _apply_el(u, Qp, consts):
    """Element-factored A u of a (2, H, W) field -> (Ax, Ay, Dxx, Dxy)."""
    al, be, ga, ep, de, ze = consts
    ne, nw, se, sw_ = sw._quadrants(Qp)
    C4 = (ne + nw) + (se + sw_)
    C4s = (ne + sw_) - (nw + se)
    Qe, Qw = ne + se, nw + sw_
    Qn, Qs = ne + nw, se + sw_
    dE, dW = ne - se, sw_ - nw
    dN, dS = ne - nw, sw_ - se
    X, Y = sw._shifts(u[0]), sw._shifts(u[1])
    outs = []
    for U, V, sg, g_ew, g_ns in ((X, Y, 1.0, ga, de), (Y, X, -1.0, de, ga)):
        outs.append(al * C4 * U(0, 0)
                    + g_ew * (Qe * U(0, 1) + Qw * U(0, -1))
                    + g_ns * (Qn * U(1, 0) + Qs * U(-1, 0))
                    + ze * (ne * U(1, 1) + nw * U(1, -1) + se * U(-1, 1) + sw_ * U(-1, -1))
                    + be * C4s * V(0, 0)
                    - sg * ep * (dE * V(0, 1) + dW * V(0, -1))
                    + sg * ep * (dN * V(1, 0) + dS * V(-1, 0))
                    - be * (ne * V(1, 1) - nw * V(1, -1) - se * V(-1, 1) + sw_ * V(-1, -1)))
    return outs[0], outs[1], al * C4, be * C4s


def _block_update(u, rx, ry, dxx, dxy, omega):
    """u + omega D^-1 r with D = [[dxx, dxy], [dxy, dxx]]."""
    det = dxx * dxx - dxy * dxy
    w = omega / det
    return torch.stack([u[0] + w * (dxx * rx - dxy * ry), u[1] + w * (dxx * ry - dxy * rx)])


def _zero_guess(f, Qp, consts, omega, mask):
    """omega D^-1 f at interior nodes, 0 elsewhere."""
    dxx, dxy = _block_diag(Qp, consts)
    det = dxx * dxx - dxy * dxy
    w = omega / det
    return torch.stack([torch.where(mask, w * (dxx * f[0] - dxy * f[1]), 0.0),
                        torch.where(mask, w * (dxx * f[1] - dxy * f[0]), 0.0)])


def _prolong(uc):
    """Bilinear prolongation of both components of a coarse field."""
    return torch.stack([sw._prolong(uc[0]), sw._prolong(uc[1])])


def _restrict4(r1):
    """x4 full weighting of both components of a masked residual."""
    return torch.stack([sw._restrict4(r1[0]), sw._restrict4(r1[1])])


# ---------------------------------------------------------------------------
# Plain PyTorch versions of the five kernels.
# ---------------------------------------------------------------------------


def el_sweep_plain(u, f, ph=None, *, a0, da, omega, consts, mode="sweep", out=None, rsq=None):
    """G1: one damped block-Jacobi sweep (``mode="sweep"``) or the masked
    residual (``mode="residual"``) -> (out, rsq of u)."""
    if mode not in ("sweep", "residual"):
        raise ValueError(f"mode must be 'sweep' or 'residual', not {mode!r}")
    mask = sw._interior(u[0])
    ax, ay, dxx, dxy = _apply_el(u, _element_q(ph, a0, da, u), consts)
    rx = torch.where(mask, f[0] - ax, 0.0)
    ry = torch.where(mask, f[1] - ay, 0.0)
    if mode == "residual":
        res = torch.stack([rx, ry])
    else:
        res = _block_update(u, rx, ry, dxx, dxy, omega)
    return sw._emit(res, out), sw._emit(torch.sum(rx * rx) + torch.sum(ry * ry), rsq)


def el_swrr_plain(u, f, ph=None, *, a0, da, omega, consts, out=None, fc_out=None, rsq=None):
    """G2: u1 = BJ(u); f_c = 4 FW(f - A u1) per component -> (u1, f_c, rsq
    of u)."""
    cfg = dict(a0=a0, da=da, omega=omega, consts=consts)
    u1, rsq0 = el_sweep_plain(u, f, ph, **cfg)
    r1, _ = el_sweep_plain(u1, f, ph, mode="residual", **cfg)
    return sw._emit(u1, out), sw._emit(_restrict4(r1), fc_out), sw._emit(rsq0, rsq)


def el_psweep_plain(u, f, ph, uc, *, a0, da, omega, consts, out=None):
    """G3: u3 = BJ(u + P(uc)), the correction added at interior nodes."""
    u2 = u + torch.where(sw._interior(u[0]), _prolong(uc), 0.0)
    u3, _ = el_sweep_plain(u2, f, ph, a0=a0, da=da, omega=omega, consts=consts)
    return sw._emit(u3, out)


def el_zrr_plain(f, ph=None, *, a0, da, omega, consts, out=None):
    """G4: f_c = 4 FW(f - A u1) with u1 = omega D^-1 f at interior nodes."""
    mask = sw._interior(f[0])
    Qp = _element_q(ph, a0, da, f)
    u1 = _zero_guess(f, Qp, consts, omega, mask)
    ax, ay, _, _ = _apply_el(u1, Qp, consts)
    r1 = torch.stack([torch.where(mask, f[0] - ax, 0.0), torch.where(mask, f[1] - ay, 0.0)])
    return sw._emit(_restrict4(r1), out)


def el_zpsweep_plain(f, ph, uc, *, a0, da, omega, consts, out=None):
    """G5: u3 = BJ(omega D^-1 f + P(uc)), both terms at interior nodes."""
    mask = sw._interior(f[0])
    Qp = _element_q(ph, a0, da, f)
    u2 = _zero_guess(f, Qp, consts, omega, mask) + torch.where(mask, _prolong(uc), 0.0)
    u3, _ = el_sweep_plain(u2, f, ph, a0=a0, da=da, omega=omega, consts=consts)
    return sw._emit(u3, out)


# ---------------------------------------------------------------------------
# CUDA kernels: ctypes bindings, launch counts, wrappers.
# ---------------------------------------------------------------------------

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_SOURCE = "multigrid_feanet_torch/csrc/elastic.cu"
_REPLACES = "multigrid_feanet_tpu/ops/pallas_elastic.py:"
_TAIL = [_I] + [_D] * 9 + [_I]  # n, a0, da, omega, al, be, ga, ep, de, ze, bim

KERNELS = {
    # u f ph out partial done rsq; _TAIL; mode one_pass strip gx gy; stream
    "G1": sw.CudaKernel("G1_el_sweep", "mg_el_sweep", [_P] * 7 + _TAIL + [_I] * 5 + [_P],
                        _REPLACES + "91", _SOURCE),
    "G2": sw.CudaKernel("G2_el_swrr", "mg_el_swrr", [_P] * 8 + _TAIL + [_I] * 4 + [_P],
                        _REPLACES + "391", _SOURCE),
    "G3": sw.CudaKernel("G3_el_psweep", "mg_el_psweep", [_P] * 5 + _TAIL + [_P],
                        _REPLACES + "457", _SOURCE),
    "G4": sw.CudaKernel("G4_el_zrr", "mg_el_zrr", [_P] * 3 + _TAIL + [_P],
                        _REPLACES + "504", _SOURCE),
    # f ph uc out; _TAIL; one_pass strip gx gy; stream
    "G5": sw.CudaKernel("G5_el_zpsweep", "mg_el_zpsweep", [_P] * 4 + _TAIL + [_I] * 4 + [_P],
                        _REPLACES + "555", _SOURCE),
}


def _operands(n, device, fields=(), phase=None, coarse=()):
    """Check the (2, n+1, n+1) f32 fields, the int8 phase and the (2, n/2+1,
    n/2+1) f32 coarse fields of one launch."""
    sw._operands(n, device, fields, phase, coarse, lead=(2,))


def _tail(n, ph, a0, da, omega, consts):
    return (n, a0, da, omega, *consts, int(ph is not None))


# ---------------------------------------------------------------------------
# Launch geometry of G1, G2 and G5: row-streaming bands and strips in
# common.cuh's block shape (G2's blocks each restricting to the coarse nodes
# under its band and strip), and the one-pass tiles on the coarse grid below
# a size threshold each.
# ---------------------------------------------------------------------------

# levels of up to this many elements per side, bi-material (True) or
# homogeneous (False), run G1 on its one-pass tiles (csrc/elastic.cu
# g1_el_relax, 16 x 32 fine tiles of the coarse grid): where the tile was
# the faster on the H100 (``sweep_vs_parent.py --crossover --legs g1g5``,
# PERF.md; bi-material streaming won by 4-14% from 33^2 to 257^2 and lost
# by 1% at 513^2, which one threshold leaves to the stream)
G1_ONE_PASS_MAX_N = {True: 16, False: 512}


def g1_tiles(n: int, strip: int = 32) -> sw.Tiles:
    """G1: C1's single-sweep streaming; a block owns the ``A12_THREADS
    A12_COLUMNS`` columns its threads cover and a strip of the (n+1) rows."""
    sw._check_strip(strip)
    H, band = n + 1, sw.A12_THREADS * sw.A12_COLUMNS
    return sw.Tiles("G1", n, band, strip, -(-H // band), -(-H // strip))


def g1_one_pass_tiles(n: int) -> sw.Tiles:
    """G1 on one-pass tiles (``ops/hrelax.py::coarse_tiles``)."""
    return hx.coarse_tiles("G1_tile", n)


def g1_halo_steps() -> int:
    """Steps a G1 block takes beyond its strip's rows: the u rows above and
    below it."""
    return 2


_G1_TILES = {}


def g1_launch_tiles(n: int, bim: bool, mode: int, device) -> sw.Tiles:
    """The geometry G1 launches with on ``device``: one-pass tiles up to
    ``G1_ONE_PASS_MAX_N[bim]``, else row-streaming strips of ``row_strip``'s
    height for the occupancy the card reports for the instance launched
    (``ops/hrelax.py::launch_tiles``)."""
    if n <= G1_ONE_PASS_MAX_N[bool(bim)]:
        return g1_one_pass_tiles(n)
    return hx.launch_tiles(_G1_TILES, (n, bool(bim), mode, device.index), device,
                           lambda s: g1_tiles(n, s), g1_halo_steps(), "mg_el_sweep_occupancy",
                           int(bim), mode)


# levels of up to this many elements per side, bi-material (True) or
# homogeneous (False), run G2 on its one-pass tiles (csrc/elastic.cu
# g2_el_descent, 16 x 32 fine tiles of the coarse grid): one wave of the
# tile holds a level there, while a strip's 6 halo steps are a large share
# of its rows.  The largest level at which the tile was the faster on the
# H100 (``sweep_vs_parent.py --crossover --legs g2d2``, PERF.md)
G2_ONE_PASS_MAX_N = {True: 1024, False: 512}


def g2_tiles(n: int, strip: int = 32) -> sw.Tiles:
    """G2: E2's descent chain without conv layers (``ops/hrelax.py``
    ``descent_tiles`` with L = 0): bands of ``A12_THREADS A12_COLUMNS - 4``
    owned columns, each block restricting to the coarse nodes under it."""
    return hx.descent_tiles("G2", n, 0, strip)


def g2_one_pass_tiles(n: int) -> sw.Tiles:
    """G2 on one-pass tiles (``ops/hrelax.py::coarse_tiles``)."""
    return hx.coarse_tiles("G2_tile", n)


_G2_TILES = {}


def g2_launch_tiles(n: int, bim: bool, device) -> sw.Tiles:
    """The geometry G2 launches with on ``device``: one-pass tiles up to
    ``G2_ONE_PASS_MAX_N[bim]``, else row-streaming strips of ``row_strip``'s
    height (the chain's halo steps ``e2_halo_steps(0)``) for the occupancy
    the card reports for the instance launched (``ops/hrelax.py``
    ``launch_tiles``)."""
    if n <= G2_ONE_PASS_MAX_N[bool(bim)]:
        return g2_one_pass_tiles(n)
    return hx.launch_tiles(_G2_TILES, (n, bool(bim), device.index), device,
                           lambda s: g2_tiles(n, s), hx.e2_halo_steps(0),
                           "mg_el_swrr_occupancy", int(bim))


# levels of up to this many elements per side, bi-material (True) or
# homogeneous (False), run G5 on its one-pass tiles (csrc/elastic.cu
# g5_el_zascent): the largest level at which the tile was the faster on the
# H100 (``sweep_vs_parent.py --crossover --legs g1g5``, PERF.md)
G5_ONE_PASS_MAX_N = {True: 16, False: 8}


def g5_tiles(n: int, strip: int = 32) -> sw.Tiles:
    """G5: A4's zero-guess ascent streaming; a block builds u2 over the
    ``A12_THREADS A12_COLUMNS`` columns its threads cover and owns the
    middle ``A12_THREADS A12_COLUMNS - 2`` (the sweep eats a column of halo
    on each side; the band is even, so that the threads' columns start on
    an odd column and each column's prolongation is fixed)."""
    sw._check_strip(strip)
    H, band = n + 1, sw.A12_THREADS * sw.A12_COLUMNS - 2
    return sw.Tiles("G5", n, band, strip, -(-H // band), -(-H // strip))


def g5_one_pass_tiles(n: int) -> sw.Tiles:
    """G5 on one-pass tiles (``ops/hrelax.py::coarse_tiles``)."""
    return hx.coarse_tiles("G5_tile", n)


def g5_halo_steps() -> int:
    """Steps a G5 block takes beyond its strip's rows: the u2 rows above and
    below it and the sweep's lag of two rows behind u2 (it reads u2 rows
    built at earlier steps), to which the prolongation adds none (its
    coarse rows are staged before the first step)."""
    return 4


_G5_TILES = {}


def g5_launch_tiles(n: int, bim: bool, device) -> sw.Tiles:
    """The geometry G5 launches with on ``device``: one-pass tiles up to
    ``G5_ONE_PASS_MAX_N[bim]``, else row-streaming strips of ``row_strip``'s
    height for the occupancy the card reports at each height (the strip's
    coarse rows lie in dynamic shared memory)."""
    if n <= G5_ONE_PASS_MAX_N[bool(bim)]:
        return g5_one_pass_tiles(n)
    return hx.launch_tiles(_G5_TILES, (n, bool(bim), device.index), device,
                           lambda s: g5_tiles(n, s), g5_halo_steps(), "mg_el_zpsweep_occupancy",
                           int(bim), by_strip=True)


def el_sweep_cuda(u, f, ph=None, *, a0, da, omega, consts, mode="sweep", out=None, rsq=None,
                  workspace=None):
    """G1 on the card; same contract as :func:`el_sweep_plain`, and u, f and
    ``ph`` must start on a 16-byte boundary (whole tensors do; an offset
    view may not, and raises ValueError)."""
    if mode not in ("sweep", "residual"):
        raise ValueError(f"mode must be 'sweep' or 'residual', not {mode!r}")
    n, dev = u.shape[-1] - 1, u.device
    _operands(n, dev, [("u", u), ("f", f)], ph)
    out = sw._output(out, "out", (2, n + 1, n + 1), dev, (u, f))
    rsq = sw._scalar_out(rsq, dev)
    sw._check_aligned(("u", u), ("f", f), ("phase", ph))
    which = 0 if mode == "sweep" else 1
    tiles = g1_launch_tiles(n, ph is not None, which, dev)
    partial, done = hx.row_scratch(tiles, 1, dev, workspace)
    KERNELS["G1"](u.data_ptr(), f.data_ptr(), sw._ptr(ph), out.data_ptr(), partial.data_ptr(),
                  done.data_ptr(), rsq.data_ptr(), *_tail(n, ph, a0, da, omega, consts), which,
                  int(tiles.leg == "G1_tile"), tiles.strip, tiles.gx, tiles.gy, sw._stream(dev))
    return out, rsq


def el_swrr_cuda(u, f, ph=None, *, a0, da, omega, consts, out=None, fc_out=None, rsq=None,
                 workspace=None):
    """G2 on the card; same contract as :func:`el_swrr_plain`, and u, f and
    ``ph`` must start on a 16-byte boundary (whole tensors do; an offset
    view may not, and raises ValueError)."""
    n, dev = u.shape[-1] - 1, u.device
    _operands(n, dev, [("u", u), ("f", f)], ph)
    out = sw._output(out, "out", (2, n + 1, n + 1), dev, (u, f))
    fc_out = sw._output(fc_out, "fc_out", (2, n // 2 + 1, n // 2 + 1), dev, (u, f, out))
    rsq = sw._scalar_out(rsq, dev)
    sw._check_aligned(("u", u), ("f", f), ("phase", ph))
    tiles = g2_launch_tiles(n, ph is not None, dev)
    partial, done = hx.row_scratch(tiles, 1, dev, workspace)
    KERNELS["G2"](u.data_ptr(), f.data_ptr(), sw._ptr(ph), out.data_ptr(), fc_out.data_ptr(),
                  partial.data_ptr(), done.data_ptr(), rsq.data_ptr(),
                  *_tail(n, ph, a0, da, omega, consts), int(tiles.leg == "G2_tile"),
                  tiles.strip, tiles.gx, tiles.gy, sw._stream(dev))
    return out, fc_out, rsq


def el_psweep_cuda(u, f, ph, uc, *, a0, da, omega, consts, out=None):
    """G3 on the card; same contract as :func:`el_psweep_plain`."""
    n, dev = u.shape[-1] - 1, u.device
    _operands(n, dev, [("u", u), ("f", f)], ph, [("uc", uc)])
    out = sw._output(out, "out", (2, n + 1, n + 1), dev, (u, f, uc))
    KERNELS["G3"](u.data_ptr(), f.data_ptr(), sw._ptr(ph), uc.data_ptr(), out.data_ptr(),
                  *_tail(n, ph, a0, da, omega, consts), sw._stream(dev))
    return out


def el_zrr_cuda(f, ph=None, *, a0, da, omega, consts, out=None):
    """G4 on the card; same contract as :func:`el_zrr_plain`."""
    n, dev = f.shape[-1] - 1, f.device
    _operands(n, dev, [("f", f)], ph)
    out = sw._output(out, "out", (2, n // 2 + 1, n // 2 + 1), dev, (f,))
    KERNELS["G4"](f.data_ptr(), sw._ptr(ph), out.data_ptr(),
                  *_tail(n, ph, a0, da, omega, consts), sw._stream(dev))
    return out


def el_zpsweep_cuda(f, ph, uc, *, a0, da, omega, consts, out=None):
    """G5 on the card; same contract as :func:`el_zpsweep_plain`, and f,
    ``ph`` and uc must start on a 16-byte boundary (whole tensors do; an
    offset view may not, and raises ValueError)."""
    n, dev = f.shape[-1] - 1, f.device
    _operands(n, dev, [("f", f)], ph, [("uc", uc)])
    out = sw._output(out, "out", (2, n + 1, n + 1), dev, (f, uc))
    sw._check_aligned(("f", f), ("phase", ph), ("uc", uc))
    tiles = g5_launch_tiles(n, ph is not None, dev)
    KERNELS["G5"](f.data_ptr(), sw._ptr(ph), uc.data_ptr(), out.data_ptr(),
                  *_tail(n, ph, a0, da, omega, consts), int(tiles.leg == "G5_tile"), tiles.strip,
                  tiles.gx, tiles.gy, sw._stream(dev))
    return out


# ---------------------------------------------------------------------------
# Level object.
# ---------------------------------------------------------------------------


class ElasticSweepLevel:
    """The five kernels bound to one elastic level's operator; counterpart
    of ``PallasElasticLevel`` on compact fields.

    ``phase`` is the (n, n) element phase map (None = homogeneous: every
    element at ``coefficients[0]``); ``coefficients`` scale the element
    stiffness per phase.  Every method takes optional ``out`` buffers (and
    ``rsq`` for the legs that emit one) so a solve loop can run without
    allocating; ``device=None`` means CUDA."""

    def __init__(self, n: int, E: float, nu: float, phase=None, coefficients=(1.0, 20.0),
                 plane: str = "stress", omega: float = 2.0 / 3.0, device=None):
        self.device = resolve_device(device)
        self.n = int(n)
        self.a0 = float(coefficients[0])
        self.da = (float(coefficients[1]) - float(coefficients[0])
                   if phase is not None else 0.0)
        self.omega = float(omega)
        self.consts = elastic_factor_constants(E, nu, plane)
        self.ph = (None if phase is None else torch.as_tensor(
            phase, dtype=torch.int8, device=self.device).contiguous())
        self._workspace = {}

    def _call(self, cuda_fn, plain_fn, x, *args, **kw):
        """``plain_fn`` on CPU tensors, ``cuda_fn`` on CUDA ones; the legs
        that emit ``rsq`` (G1, G2) keep their partial-sum scratch in the
        level's workspace."""
        kw.update(a0=self.a0, da=self.da, omega=self.omega, consts=self.consts)
        if not x.is_cuda:
            return plain_fn(x, *args, **kw)
        if "rsq" in kw:
            kw["workspace"] = self._workspace
        return cuda_fn(x, *args, **kw)

    def sweep(self, u, f, out=None, rsq=None):
        """One damped block-Jacobi sweep -> (u_new, rsq of u)."""
        return self._call(el_sweep_cuda, el_sweep_plain, u, f, self.ph, out=out, rsq=rsq)

    def residual(self, u, f, out=None, rsq=None):
        """Interior-masked residual f - A u -> (r, ||r||^2)."""
        return self._call(el_sweep_cuda, el_sweep_plain, u, f, self.ph, mode="residual",
                          out=out, rsq=rsq)

    def sweep_restrict(self, u, f, out=None, fc_out=None, rsq=None):
        """Pre-smoothing sweep + residual + x4 full weighting per component
        -> (u1, f_c, rsq of u)."""
        return self._call(el_swrr_cuda, el_swrr_plain, u, f, self.ph, out=out, fc_out=fc_out,
                          rsq=rsq)

    def psweep(self, u, f, uc, out=None):
        """u += masked bilinear prolongation of ``uc``; one sweep -> u3."""
        return self._call(el_psweep_cuda, el_psweep_plain, u, f, self.ph, uc, out=out)

    def zsweep_restrict(self, f, out=None):
        """Zero-initial-guess descent leg -> f_c."""
        return self._call(el_zrr_cuda, el_zrr_plain, f, self.ph, out=out)

    def zpsweep(self, f, uc, out=None):
        """Zero-initial-guess ascent leg -> u3."""
        return self._call(el_zpsweep_cuda, el_zpsweep_plain, f, self.ph, uc, out=out)
