"""Fused V-cycle legs of the bi-material Q1 operator on compact fields.

Port of ``multigrid_feanet_tpu/ops/pallas_sweep.py``.  Fields are plain
row-major tensors: (n+1, n+1) node fields and an (n, n) int8 element phase
map (element (r, c) spans nodes r..r+1 x c..c+1, Q = a0 + da*phase); the
TPU's ghost-block stride-lane layout has no counterpart here.

Node fields (u, f, the coarse fields and the outputs) are stored as float32
or, as ``PallasLevel(dtype=jnp.bfloat16)`` stores them, as bfloat16: every
leg then widens its operands to float32, computes in float32 and rounds
only what it stores (u, u1, u4 and f_c; the residual of A1's residual
mode), so the values that stay inside a leg (A2's u1 before its residual,
the prolongation-corrected iterate of A1 and A6, A4's pointwise u2) are
never rounded.  The residual norm is float32 either way.

Six kernels, hand-written in CUDA C++ (``csrc/sweep.cu``):

====  ==================  ==========================================  =====================
name  C entry point       replaces                                    level methods
====  ==================  ==========================================  =====================
A1    ``mg_sweep``        ``pallas_sweep.py:284 _sweep_kernel``       sweep, residual, psweep
A2    ``mg_swrr``         ``pallas_sweep.py:374 _swrr_kernel``        sweep_restrict
A3    ``mg_zrr``          ``pallas_sweep.py:629 _zrr_kernel``         zsweep_restrict
A4    ``mg_zpsweep``      ``pallas_sweep.py:686 _zpsweep_kernel``     zpsweep
A5    ``mg_rr``           ``pallas_sweep.py:758 _rr_kernel``          restrict_residual
A6    ``mg_pswrr``        ``pallas_sweep.py:493 _pswrr_kernel``       pswrr
====  ==================  ==========================================  =====================

Each kernel has a wrapper ``<leg>_cuda`` (checks, allocation, launch, launch
count) and a plain PyTorch version ``<leg>_plain`` with the same signature,
built from the plain twins of the shared in-kernel math below.  Tensors on
the CPU take the plain version; tensors on a CUDA device launch the kernel
or raise.  The kernels and their plain versions agree to ``TOL`` relative to
``max(1, max|plain|)`` on fields and ``TOL`` relative on the residual norm:
f32 reassociation and FMA contraction change each term by about one ulp.  A
bf16 field is the rounding of such a float32 value, so two roundings may
fall on neighbouring bf16 values: bf16 fields agree when they differ by at
most one bf16 ulp, ``TOL_BF16 |plain|``, beyond that same ``TOL`` share of
``max(1, max|plain|)`` (:func:`bf16_excess`); the norm is held to ``TOL``.

Every leg takes an optional ``mass`` triple (mp, ms, mo): the plain-form
operator then gains the pattern-independent per-element term
sum_e [mp u_p + ms s_e + mo u_opp] and the diagonal 4 (mp + ms).  With the
coefficients scaled by theta dt and mass = h^2 (1/18, 1/18, -1/36) that is
the heat theta-system M + theta dt K (``ops/heat.py``).  The difference form
needs zero row sums and refuses a mass triple.

Semantics shared by all legs (as in the TPU kernels): only globally interior
nodes are updated, boundary nodes keep their value, residuals and the
prolonged correction are zero on the boundary, the coarse output is zero on
the coarse boundary ring, and ``rsq`` is the interior squared residual norm
of the INCOMING iterate (after the prolongation-add for ``psweep``), except
for ``pswrr``, whose ``rsq`` is that of its middle iterate: the residual of
the V(1,1) cycle it completes.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from multigrid_feanet_torch import _build
from multigrid_feanet_torch.core.device import resolve_device

TOL = 2e-5
# One bf16 ulp relative to the value (2^-7: bf16 keeps 8 significant bits,
# and the ulp above x is at most 2^-7 |x|).
TOL_BF16 = 2.0 ** -7
# The storage types of the node fields, and the kernels' flag for each.
STORAGE = {torch.float32: 0, torch.bfloat16: 1}

# ---------------------------------------------------------------------------
# Plain twins of the shared in-kernel math (pallas_sweep.py:93-265), on whole
# fields.  Each follows its Pallas counterpart's order of operations.
# ---------------------------------------------------------------------------


def _shifts(u):
    """``U(di, dj)``: u at (i + di, j + dj) for every node, zero off-grid."""
    H, W = u.shape
    up = F.pad(u, (1, 1, 1, 1))
    return lambda di, dj: up[1 + di : 1 + di + H, 1 + dj : 1 + dj + W]


def element_q(ph: torch.Tensor, a0: float, da: float) -> torch.Tensor:
    """(n+2, n+2) element coefficients Q = a0 + da * phase, with a ring of
    phase-0 elements around the (n, n) map; entry (r+1, c+1) is element
    (r, c), so the NE element of node (i, j) is entry (i+1, j+1)."""
    return F.pad(ph.to(torch.float32), (1, 1, 1, 1)) * da + a0


def _quadrants(x):
    """(NE, NW, SE, SW) element values of every node from an (n+2, n+2)
    padded element field."""
    return x[1:, 1:], x[1:, :-1], x[:-1, 1:], x[:-1, :-1]


def _c4(Qp):
    """Per-node sum of the 4 surrounding Q (``_c4_from_q``)."""
    ne, nw, se, sw = _quadrants(Qp)
    return (se + sw) + (ne + nw)


def _apply_hom(u, a0, mass=None):
    """Homogeneous A u = a0 (3 u - (1/3) 3x3-window sum), plus the mass
    triple's terms regrouped through the row sums as ``pallas_sweep.py``'s
    ``_apply_hom`` does."""
    U = _shifts(u)
    t3 = {x: (U(x, 0) + U(x, 1)) + U(x, -1) for x in (-1, 0, 1)}
    s9 = (t3[-1] + t3[0]) + t3[1]
    au = (3.0 * a0) * U(0, 0) - (a0 / 3.0) * s9
    if mass is not None:
        mp, ms, mo = mass
        alpha, beta, gamma = 4.0 * (mp + ms), 2.0 * ms, ms + mo
        updn = U(-1, 0) + U(1, 0)
        au = ((((au + (alpha - beta) * U(0, 0)) + beta * t3[0]) + gamma * (t3[-1] + t3[1]))
              + (beta - gamma) * updn)
    return au, None


def _apply_bim(u, Qp, mass=None):
    """Bi-material element-factored A u; ``Qp`` from :func:`element_q`,
    plus the mass triple's terms.  Returns (A u, C4)."""
    U = _shifts(u)
    up = F.pad(u, (1, 1, 1, 1))
    t = up[:, :-1] + up[:, 1:]
    S = t[:-1] + t[1:]  # per-element 4-corner sums on the padded element grid
    P = Qp * S
    Pne, Pnw, Pse, Psw = _quadrants(P)
    sigP = (Pse + Psw) + (Pne + Pnw)
    C4 = _c4(Qp)
    ne, nw, se, sw = _quadrants(Qp)
    sigD = (sw * U(-1, -1) + se * U(-1, 1)) + (nw * U(1, -1) + ne * U(1, 1))
    au = (5.0 / 6.0) * (U(0, 0) * C4) - (1.0 / 6.0) * (sigD + sigP)
    if mass is not None:
        mp, ms, mo = mass
        Sne, Snw, Sse, Ssw = _quadrants(S)
        ssum = (Sse + Ssw) + (Sne + Snw)
        cor = (U(-1, -1) + U(-1, 1)) + (U(1, -1) + U(1, 1))
        au = ((au + (4.0 * mp) * U(0, 0)) + ms * ssum) + mo * cor
    return au, C4


def _differences(u):
    """The eight neighbour differences u_nb - u_p of the difference form."""
    U = _shifts(u)
    u0 = U(0, 0)
    d_E = U(0, 1) - u0
    d_W = -(u0 - U(0, -1))
    d_N = U(1, 0) - u0
    d_S = -(u0 - U(-1, 0))
    d_NE = (U(1, 1) - U(0, 1)) + (U(0, 1) - u0)
    d_NW = (U(1, -1) - U(0, -1)) - (u0 - U(0, -1))
    d_SE = (U(0, 1) - u0) - (U(0, 1) - U(-1, 1))
    d_SW = -(U(0, -1) - U(-1, -1)) - (u0 - U(0, -1))
    return d_E, d_W, d_N, d_S, d_NE, d_NW, d_SE, d_SW


def _apply_hom_d(u, a0):
    """DIFFERENCE-FORM homogeneous A u = -(a0/3) sum_nb (u_nb - u_p): the
    same operator, with f32 rounding that scales with the local variation
    of u instead of its magnitude."""
    d_E, d_W, d_N, d_S, d_NE, d_NW, d_SE, d_SW = _differences(u)
    acc = (d_E + d_W) + (d_N + d_S) + ((d_NE + d_NW) + (d_SE + d_SW))
    return (-a0 / 3.0) * acc, None


def _apply_bim_d(u, Qp):
    """DIFFERENCE-FORM bi-material A u (see :func:`_apply_hom_d`).
    Returns (A u, C4)."""
    d_E, d_W, d_N, d_S, d_NE, d_NW, d_SE, d_SW = _differences(u)
    ne, nw, se, sw = _quadrants(Qp)
    acc = ((ne + se) * d_E + (nw + sw) * d_W
           + (ne + nw) * d_N + (se + sw) * d_S
           + 2.0 * (ne * d_NE + nw * d_NW + se * d_SE + sw * d_SW))
    C4 = (ne + nw) + (se + sw)
    return (-1.0 / 6.0) * acc, C4


def _apply_op(u, Qp, a0, bim, dform, mass=None):
    """Dispatch to the plain (optionally with mass) or difference-form
    apply."""
    if bim:
        return _apply_bim_d(u, Qp) if dform else _apply_bim(u, Qp, mass)
    return _apply_hom_d(u, a0) if dform else _apply_hom(u, a0, mass)


def _diag_bim(C4, mass=None):
    """Jacobi diagonal of the bi-material (+ mass) operator."""
    d = (2.0 / 3.0) * C4
    return d if mass is None else d + 4.0 * (mass[0] + mass[1])


def _diag_hom(a0, device="cpu", mass=None):
    """Jacobi diagonal of the homogeneous (+ mass) operator, as an f32
    scalar tensor (so that omega / d is taken in f32)."""
    d = (8.0 / 3.0) * a0 + (0.0 if mass is None else 4.0 * (mass[0] + mass[1]))
    return torch.tensor(d, dtype=torch.float32, device=device)


def _interior(x):
    """Boolean mask of the interior nodes of an (H, W) field."""
    m = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    m[1:-1, 1:-1] = True
    return m


def _prolong(uc):
    """Bilinear (align-corners) prolongation (nc+1)^2 -> (2nc+1)^2: rows
    first, then columns, as the kernels (``_sweep_kernel`` with_corr)."""
    mid = 0.5 * (uc[:-1] + uc[1:])
    rows = torch.cat([torch.stack([uc[:-1], mid], 1).flatten(0, 1), uc[-1:]], 0)
    mid = 0.5 * (rows[:, :-1] + rows[:, 1:])
    return torch.cat([torch.stack([rows[:, :-1], mid], 2).flatten(1, 2),
                      rows[:, -1:]], 1)


def _restrict4(r1):
    """x4 full weighting of a masked residual onto the coarse interior,
    zero coarse boundary: rows (1, 2, 1) first, then columns, times 4/16."""
    rows = (r1[1:-2:2] + 2.0 * r1[2:-1:2]) + r1[3::2]
    fc = ((2.0 * rows[:, 2:-1:2] + rows[:, 1:-2:2]) + rows[:, 3::2]) * 0.25
    return F.pad(fc, (1, 1, 1, 1))


def _diag(ph, Qp, a0, like, mass=None):
    return (_diag_bim(_c4(Qp), mass) if ph is not None
            else _diag_hom(a0, device=like.device, mass=mass))


def _emit(x, out, dtype=None):
    """``x`` (rounded to ``dtype`` when given) as the result, written into
    ``out`` when one is given."""
    if dtype is not None:
        x = x.to(dtype)
    if out is None:
        return x
    out.copy_(x)
    return out


def _widen(*xs):
    """bf16 fields widened to float32 (the legs compute in float32); any
    other field as it is."""
    return tuple(x.float() if x is not None and x.dtype == torch.bfloat16 else x for x in xs)


def bf16_excess(got, want) -> float:
    """How far ``got`` strays from ``want`` beyond one bf16 ulp of each
    element (``TOL_BF16 |want|``), as a share of ``max(1, max|want|)``: two
    bf16 fields agree when this is at most ``TOL``."""
    got, want = got.float(), want.float()
    excess = (got - want).abs() - TOL_BF16 * want.abs()
    return float(excess.max()) / max(1.0, float(want.abs().max()))


# ---------------------------------------------------------------------------
# Plain PyTorch versions of the four kernels.
# ---------------------------------------------------------------------------


def sweep_plain(u, f, ph=None, uc=None, *, a0, da, omega, dform,
                mode="sweep", mass=None, out=None, rsq=None):
    """A1: one weighted-Jacobi sweep (``mode="sweep"``) or the masked
    residual (``mode="residual"``) -> (out, rsq).  With a coarse field
    ``uc`` it first adds its masked bilinear prolongation and sweeps."""
    _check_mode(mode, uc)
    _check_form(dform, mass)
    store = u.dtype
    u, f, uc = _widen(u, f, uc)
    mask = _interior(u)
    if uc is not None:
        u = u + torch.where(mask, _prolong(uc), 0.0)
    bim = ph is not None
    Qp = element_q(ph, a0, da) if bim else None
    au, C4 = _apply_op(u, Qp, a0, bim, dform, mass)
    r = torch.where(mask, f - au, 0.0)
    if mode == "residual":
        res = r
    else:
        d = _diag_bim(C4, mass) if bim else _diag_hom(a0, device=u.device, mass=mass)
        res = u + (omega / d) * r
    return _emit(res, out, store), _emit(torch.sum(r * r), rsq)


def swrr_plain(u, f, ph=None, *, a0, da, omega, dform, mass=None, out=None, fc_out=None,
               rsq=None):
    """A2: u1 = sweep(u); f_c = 4 FW(f - A u1) -> (u1, f_c, rsq of u).
    The residual is that of the unrounded u1."""
    cfg = dict(a0=a0, da=da, omega=omega, dform=dform, mass=mass)
    store = u.dtype
    u, f = _widen(u, f)
    u1, rsq0 = sweep_plain(u, f, ph, **cfg)
    r1, _ = sweep_plain(u1, f, ph, mode="residual", **cfg)
    return _emit(u1, out, store), _emit(_restrict4(r1), fc_out, store), _emit(rsq0, rsq)


def zrr_plain(f, ph=None, *, a0, da, omega, mass=None, out=None):
    """A3: f_c = 4 FW(f - A u1) with u1 = (omega/d) f at interior nodes,
    plain-form apply."""
    store = f.dtype
    (f,) = _widen(f)
    mask = _interior(f)
    Qp = element_q(ph, a0, da) if ph is not None else None
    u1 = torch.where(mask, (omega / _diag(ph, Qp, a0, f, mass)) * f, 0.0)
    au, _ = _apply_op(u1, Qp, a0, ph is not None, False, mass)
    return _emit(_restrict4(torch.where(mask, f - au, 0.0)), out, store)


def zpsweep_plain(f, ph, uc, *, a0, da, omega, mass=None, out=None):
    """A4: one sweep of u2 = (omega/d) f + P(uc) (interior), plain form."""
    store = f.dtype
    f, uc = _widen(f, uc)
    mask = _interior(f)
    Qp = element_q(ph, a0, da) if ph is not None else None
    d = _diag(ph, Qp, a0, f, mass)
    u2 = (torch.where(mask, (omega / d) * f, 0.0)
          + torch.where(mask, _prolong(uc), 0.0))
    au, _ = _apply_op(u2, Qp, a0, ph is not None, False, mass)
    r = torch.where(mask, f - au, 0.0)
    return _emit(u2 + (omega / d) * r, out, store)


def rr_plain(u, f, ph=None, *, a0, da, dform, mass=None, fc_out=None, rsq=None):
    """A5: f_c = 4 FW(f - A u) -> (f_c, rsq of u)."""
    store = u.dtype
    u, f = _widen(u, f)
    r, rsq0 = sweep_plain(u, f, ph, a0=a0, da=da, omega=0.0, dform=dform, mass=mass,
                          mode="residual")
    return _emit(_restrict4(r), fc_out, store), _emit(rsq0, rsq)


def pswrr_plain(u1, f, ph, uc, *, a0, da, omega, dform, mass=None, out=None, fc_out=None,
                rsq=None):
    """A6: u3 = sweep(u1 + P(uc)), u4 = sweep(u3), f_c = 4 FW(f - A u4)
    -> (u4, f_c, rsq of u3); u3 and u4 stay unrounded until u4 is stored."""
    cfg = dict(a0=a0, da=da, omega=omega, dform=dform, mass=mass)
    store = u1.dtype
    u1, f, uc = _widen(u1, f, uc)
    u3, _ = sweep_plain(u1, f, ph, uc, **cfg)
    u4, rsq3 = sweep_plain(u3, f, ph, **cfg)
    r4, _ = sweep_plain(u4, f, ph, mode="residual", **cfg)
    return _emit(u4, out, store), _emit(_restrict4(r4), fc_out, store), _emit(rsq3, rsq)


def _check_mode(mode, uc):
    if mode not in ("sweep", "residual"):
        raise ValueError(f"mode must be 'sweep' or 'residual', not {mode!r}")
    if uc is not None and mode != "sweep":
        raise ValueError("the prolongation-add (uc) runs in sweep mode only")


def _check_form(dform, mass):
    if dform and mass is not None:
        raise ValueError(
            "dform=True cannot carry a mass triple: the difference form needs "
            "zero row sums (the reference silently drops mass in this pairing)")


def _form(dform, mass):
    """The kernels' operator form: 0 plain, 1 difference, 2 plain with mass,
    and the mass triple as three doubles (zero when absent)."""
    _check_form(dform, mass)
    return (2 if mass is not None else int(bool(dform))), tuple(mass or (0.0, 0.0, 0.0))


# ---------------------------------------------------------------------------
# CUDA kernels: ctypes bindings, launch counts, wrappers.
# ---------------------------------------------------------------------------

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_SOURCE = "multigrid_feanet_torch/csrc/sweep.cu"


class CudaKernel:
    """One C entry point of the kernel library with its launch count;
    ``source`` is the repository path of the file that defines it.

    ``launches`` rises by one for every launch of the kernel, and nowhere
    else; callers may reset it to 0."""

    def __init__(self, name: str, symbol: str, argtypes, replaces: str, source: str):
        self.name = name
        self.symbol = symbol
        self.replaces = replaces
        self.source = source
        self.launches = 0
        self._argtypes = argtypes
        self._fn = None

    def __call__(self, *args):
        if self._fn is None:
            fn = getattr(_build.load(), self.symbol)
            fn.argtypes = self._argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        err = self._fn(*args)
        if err != 0:
            raise RuntimeError(f"{self.symbol}: CUDA error {err} ({_error_string(err)})")
        self.launches += 1


KERNELS = {
    "A1": CudaKernel("A1_sweep", "mg_sweep",
                     [_P] * 8 + [_I] + [_D] * 6 + [_I] * 7 + [_P],
                     "multigrid_feanet_tpu/ops/pallas_sweep.py:284", _SOURCE),
    "A2": CudaKernel("A2_swrr", "mg_swrr",
                     [_P] * 8 + [_I] + [_D] * 6 + [_I] * 6 + [_P],
                     "multigrid_feanet_tpu/ops/pallas_sweep.py:374", _SOURCE),
    "A3": CudaKernel("A3_zrr", "mg_zrr", [_P] * 3 + [_I] + [_D] * 6 + [_I] * 6 + [_P],
                     "multigrid_feanet_tpu/ops/pallas_sweep.py:629", _SOURCE),
    "A4": CudaKernel("A4_zpsweep", "mg_zpsweep", [_P] * 4 + [_I] + [_D] * 6 + [_I] * 6 + [_P],
                     "multigrid_feanet_tpu/ops/pallas_sweep.py:686", _SOURCE),
    "A5": CudaKernel("A5_resid_restrict", "mg_rr",
                     [_P] * 7 + [_I] + [_D] * 5 + [_I] * 7 + [_P],
                     "multigrid_feanet_tpu/ops/pallas_sweep.py:758", _SOURCE),
    "A6": CudaKernel("A6_cross_cycle", "mg_pswrr",
                     [_P] * 9 + [_I] + [_D] * 6 + [_I] * 7 + [_P],
                     "multigrid_feanet_tpu/ops/pallas_sweep.py:493", _SOURCE),
}


def _error_string(err: int) -> str:
    fn = _build.load().mg_error_string
    fn.argtypes, fn.restype = [_I], ctypes.c_char_p
    return fn(err).decode()


def _partials_key(which: int, n: int) -> tuple:
    return ("partials", which, n)


def _partials(which: int, n: int, device, workspace) -> torch.Tensor:
    """Scratch for the per-block partial sums of the kernels of grid
    ``which`` (0: D1, 1: the A6 tile, 2: C2), kept in
    ``workspace`` when one is given."""
    key = _partials_key(which, n)
    buf = None if workspace is None else workspace.get(key)
    if buf is None:
        fn = _build.load().mg_partials
        fn.argtypes, fn.restype = [_I, _I], _I
        buf = torch.empty(fn(which, n), dtype=torch.float32, device=device)
        if workspace is not None:
            workspace[key] = buf
    return buf


# ---------------------------------------------------------------------------
# Launch geometry of A1-A6: row-streaming tiles (csrc/sweep.cu).  A
# block of A12_THREADS threads of A12_COLUMNS adjacent columns each owns a
# band of fine columns and marches down a strip of fine rows; the grid and
# the strip height are computed here and passed to the kernels, which
# refuse a grid that does not match their block shape.  A3 takes A2's
# bands and strips.
# ---------------------------------------------------------------------------

# csrc/sweep.cu's block shape (ST threads of SC columns), the default strip
# height, and the tallest strip the kernels take (A12_STRIP_MAX)
A12_THREADS, A12_COLUMNS = 128, 2
A12_STRIP, A12_STRIP_MAX = 32, 128
# steps a block takes beyond its strip's rows: the staged halo rows
_HALO_STEPS = {"A1": 2, "A2": 6, "A3": 5, "A4": 4, "A5": 3, "A6": 9}
# the shortest strip balanced_strip considers: A3 and A4 run on the coarse
# levels, where one wave holds the whole grid and the strip's step chain
# is the time
_MIN_STRIP = {"A1": 8, "A2": 8, "A3": 2, "A4": 2, "A6": 8}
# A3/A4: a step's latency in units of one block's share of its SM's issue
# time (fitted to the H100's times of A3 and A4 at n = 128 ... 2048 over
# strips of 2 ... 48 rows, PERF.md)
_STEP_LATENCY = 3
_LEG_ID = {"A1": 1, "A2": 2, "A3": 3, "A4": 4, "A6": 6}
# levels of up to this many elements per side run A6 on its one-pass tiles
# (csrc/sweep.cu a6_cross_cycle, one block per 32 x 16 fine nodes): one wave
# holds the grid there, and a row-streaming strip's chain of steps takes
# longer.  The largest size at which the tile was the faster on the H100
# (``sweep_vs_parent.py --crossover``, PERF.md)
A6_ONE_PASS_MAX_N = 512
# levels of up to this many elements per side, bi-material (True) or
# homogeneous (False), run A5 on its one-pass tiles (csrc/sweep.cu
# a5_resid_restrict, one block per 32 x 16 fine nodes, and its norm pass):
# the largest size at which the tile was the faster on the H100
# (``sweep_vs_parent.py --crossover --legs g4a5``, PERF.md; at 9^2 the two
# bi-material designs tied within 2%)
A5_ONE_PASS_MAX_N = {True: 8, False: 16}


class Tiles(NamedTuple):
    """One leg's launch geometry at level n: a ``gx`` x ``gy`` grid of
    blocks, block (bx, by) owning fine columns ``[bx band, (bx+1) band)``
    and rows ``[by strip, (by+1) strip)`` of the (n+1)^2 grid (A2 and A3
    also the coarse nodes under them)."""

    leg: str
    n: int
    band: int
    strip: int
    gx: int
    gy: int

    @property
    def blocks(self) -> int:
        return self.gx * self.gy


def _check_strip(strip):
    if strip < 2 or strip % 2 or strip > A12_STRIP_MAX:
        raise ValueError(f"strips hold an even number of rows in [2, {A12_STRIP_MAX}], "
                         f"not {strip}")


def a1_tiles(n: int, strip: int = A12_STRIP) -> Tiles:
    """A1: a block owns the ``A12_THREADS A12_COLUMNS`` columns its threads
    cover."""
    _check_strip(strip)
    H, band = n + 1, A12_THREADS * A12_COLUMNS
    return Tiles("A1", n, band, strip, -(-H // band), -(-H // strip))


def a2_tiles(n: int, strip: int = A12_STRIP) -> Tiles:
    """A2: a block owns ``A12_THREADS A12_COLUMNS - 4`` columns (its u1 and
    r1 halo is two and one columns on each side) and the coarse nodes under
    its band and strip."""
    _check_strip(strip)
    Hc, band = n // 2 + 1, A12_THREADS * A12_COLUMNS - 4
    return Tiles("A2", n, band, strip, -(-Hc // (band // 2)), -(-Hc // (strip // 2)))


def a3_tiles(n: int, strip: int = A12_STRIP) -> Tiles:
    """A3: A2's bands and strips (the zero-guess descent restricts the same
    coarse nodes)."""
    return a2_tiles(n, strip)._replace(leg="A3")


def a4_tiles(n: int, strip: int = A12_STRIP) -> Tiles:
    """A4: a block owns ``A12_THREADS A12_COLUMNS - 2`` columns (the u2 it
    sweeps reaches one column past each side)."""
    _check_strip(strip)
    H, band = n + 1, A12_THREADS * A12_COLUMNS - 2
    return Tiles("A4", n, band, strip, -(-H // band), -(-H // strip))


def a5_tiles(n: int, strip: int = A12_STRIP) -> Tiles:
    """A5: a block owns ``A12_THREADS A12_COLUMNS - 2`` columns (its
    residual reaches one column past each side, for the restriction's
    column sums) and the coarse nodes under its band and strip."""
    _check_strip(strip)
    Hc, band = n // 2 + 1, A12_THREADS * A12_COLUMNS - 2
    return Tiles("A5", n, band, strip, -(-Hc // (band // 2)), -(-Hc // (strip // 2)))


def a5_one_pass_tiles(n: int) -> Tiles:
    """A5 on one-pass tiles: one block per 32 x 16 tile of fine nodes, the
    fine tiles of csrc/common.cuh's CY x CX coarse tiles."""
    Hc = n // 2 + 1
    return Tiles("A5_tile", n, 32, 16, -(-Hc // 16), -(-Hc // 8))


def a6_tiles(n: int, strip: int = A12_STRIP) -> Tiles:
    """A6: a block owns ``A12_THREADS A12_COLUMNS - 6`` columns (its u3, u4
    and r4 eat a column of halo on each side each, the restriction one
    more) and the coarse nodes under its band and strip."""
    _check_strip(strip)
    Hc, band = n // 2 + 1, A12_THREADS * A12_COLUMNS - 6
    return Tiles("A6", n, band, strip, -(-Hc // (band // 2)), -(-Hc // (strip // 2)))


def a6_one_pass_tiles(n: int) -> Tiles:
    """A6 on one-pass tiles: one block per 32 x 16 tile of fine nodes, the
    fine tiles of csrc/common.cuh's CY x CX coarse tiles (A5's grid)."""
    Hc = n // 2 + 1
    return Tiles("A6_tile", n, 32, 16, -(-Hc // 16), -(-Hc // 8))


TILES = {"A1": a1_tiles, "A2": a2_tiles, "A3": a3_tiles, "A4": a4_tiles, "A6": a6_tiles}


def balanced_strip(leg: str, n: int, slots, sms: int = 132) -> int:
    """The even strip height in [``_MIN_STRIP[leg]``, A12_STRIP_MAX] that
    finishes the level soonest on a card of ``sms`` SMs that holds
    ``slots(strip)`` blocks at once.

    A1, A2 and A6 (the finest level, many waves of blocks): the fewest
    block-steps, whole waves of blocks each taking strip + halo steps.  A
    grid that overfills its last wave by a few blocks pays a whole wave, so
    the height adapts to the level and to the occupancy the card reports.

    A3 and A4 (the coarse levels, at most a few waves): a step costs a block
    a fixed latency plus the issue time it shares with the blocks beside it
    on its SM, so a level takes steps x (_STEP_LATENCY waves + blocks per
    SM): short strips shorten each block's chain of steps, until their halo
    steps crowd the SMs."""
    best = None
    for strip in range(_MIN_STRIP[leg], A12_STRIP_MAX + 1, 2):
        blocks = TILES[leg](n, strip).blocks
        waves, steps = -(-blocks // max(1, slots(strip))), strip + _HALO_STEPS[leg]
        if leg in ("A1", "A2", "A6"):
            cost = waves * steps
        else:
            cost = steps * (_STEP_LATENCY * waves + -(-blocks // sms))
        if best is None or cost < best[0]:
            best = (cost, strip)
    return best[1]


def _tiles_key(tiles: Tiles) -> tuple:
    return ("tiles", tiles.leg, tiles.n, tiles.strip)


def _tile_scratch(tiles: Tiles, device, workspace) -> tuple:
    """(partials, counter) of one A1, A2, A5 or row-streaming A6 launch: one
    partial sum per block and the zeroed counter whose last block adds them
    (and resets it), kept in ``workspace`` under their own key when one is
    given."""
    key = _tiles_key(tiles)
    bufs = None if workspace is None else workspace.get(key)
    if bufs is None:
        bufs = (torch.empty(tiles.blocks, dtype=torch.float32, device=device),
                torch.zeros(1, dtype=torch.int32, device=device))
        if workspace is not None:
            workspace[key] = bufs
    return bufs


_LAUNCH_TILES = {}


def _launch_tiles(leg: str, n: int, bim: bool, form: int, mode: int, device,
                  bf16: int) -> Tiles:
    """The geometry A1 (``mode`` 0-2), A2, A3, A4 or the row-streaming A6
    launches with on ``device``: the balanced strip height for the
    occupancy the card reports for the instance launched (its form and
    storage type: bf16 changes its shared memory and registers); computed
    once per level shape."""
    key = (leg, n, bim, form, mode, bf16, device.index)
    tiles = _LAUNCH_TILES.get(key)
    if tiles is None:
        fn = _build.load().mg_a12_occupancy
        fn.argtypes, fn.restype = [_I] * 6, _I
        sms = torch.cuda.get_device_properties(device).multi_processor_count

        def slots(strip):
            blocks = fn(_LEG_ID[leg], int(bim), form, mode, bf16, strip)
            if blocks <= 0:
                raise RuntimeError(f"mg_a12_occupancy: CUDA error {-blocks}")
            return blocks * sms

        tiles = TILES[leg](n, balanced_strip(leg, n, slots, sms))
        _LAUNCH_TILES[key] = tiles
    return tiles


def _check_aligned(*named):
    """A1-A6 stage u, f and the phases with 16-byte cp.async chunks
    counted from the fields' base pointers, which must therefore start on a
    16-byte boundary (whole tensors do, offset views may not); A4's coarse
    correction is held to the same rule."""
    for name, t in named:
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")


def _check(t, name, shape, dtype, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _operands(n, device, fields=(), phase=None, coarse=(), lead=(), dtype=torch.float32):
    """Check the node fields (of ``dtype``), the int8 phase and the coarse
    fields (of ``dtype``) of one launch on an (n+1)^2 level; fields and
    coarse fields carry the leading dimensions ``lead`` (``(2,)`` for
    displacement fields)."""
    if device.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA tensors, not {device} ones")
    if n < 2 or n % 2:
        raise ValueError(f"levels must have an even n >= 2, got n={n}")
    for name, t in fields:
        _check(t, name, (*lead, n + 1, n + 1), dtype, device)
    if phase is not None:
        _check(phase, "phase", (n, n), torch.int8, device)
    for name, t in coarse:
        _check(t, name, (*lead, n // 2 + 1, n // 2 + 1), dtype, device)


def _storage(t) -> int:
    """The kernels' storage flag for a leg whose first node field is
    ``t`` (0: float32, 1: bfloat16); raises for any other dtype: no leg
    falls back to another type."""
    if t.dtype not in STORAGE:
        raise ValueError(f"the legs store node fields as float32 or bfloat16, not {t.dtype}")
    return STORAGE[t.dtype]


def _output(t, name, shape, device, inputs, dtype=torch.float32):
    if t is None:
        return torch.empty(shape, dtype=dtype, device=device)
    _check(t, name, shape, dtype, device)
    if any(x is not None and x.data_ptr() == t.data_ptr() for x in inputs):
        raise ValueError(f"{name} must not alias an input")
    return t


def _scalar_out(rsq, device):
    if rsq is None:
        return torch.empty((), dtype=torch.float32, device=device)
    _check(rsq, "rsq", tuple(rsq.shape), torch.float32, device)
    if rsq.numel() != 1:
        raise ValueError("rsq must hold one element")
    return rsq


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def sweep_cuda(u, f, ph=None, uc=None, *, a0, da, omega, dform, mode="sweep",
               mass=None, out=None, rsq=None, workspace=None):
    """A1 on the card; same contract as :func:`sweep_plain`, and u, f and
    ``ph`` must start on a 16-byte boundary (whole tensors do; an offset
    view may not, and raises ValueError).  The node fields and ``out`` are
    all float32 or all bfloat16."""
    _check_mode(mode, uc)
    form, m = _form(dform, mass)
    n, dev, bf16 = u.shape[0] - 1, u.device, _storage(u)
    _operands(n, dev, [("u", u), ("f", f)], ph,
              [] if uc is None else [("uc", uc)], dtype=u.dtype)
    out = _output(out, "out", (n + 1, n + 1), dev, (u, f, uc), u.dtype)
    rsq = _scalar_out(rsq, dev)
    mode_id = 2 if uc is not None else (0 if mode == "sweep" else 1)
    _check_aligned(("u", u), ("f", f), ("phase", ph))
    tiles = _launch_tiles("A1", n, ph is not None, form, mode_id, dev, bf16)
    partial, done = _tile_scratch(tiles, dev, workspace)
    KERNELS["A1"](u.data_ptr(), f.data_ptr(), _ptr(ph), _ptr(uc), out.data_ptr(),
                  partial.data_ptr(), done.data_ptr(), rsq.data_ptr(), n, a0, da, omega, *m,
                  int(ph is not None), form, mode_id, bf16, tiles.strip, tiles.gx, tiles.gy,
                  _stream(dev))
    return out, rsq


def swrr_cuda(u, f, ph=None, *, a0, da, omega, dform, mass=None, out=None, fc_out=None,
              rsq=None, workspace=None):
    """A2 on the card; same contract as :func:`swrr_plain`, and u, f and
    ``ph`` must start on a 16-byte boundary (whole tensors do; an offset
    view may not, and raises ValueError)."""
    form, m = _form(dform, mass)
    n, dev, bf16 = u.shape[0] - 1, u.device, _storage(u)
    _operands(n, dev, [("u", u), ("f", f)], ph, dtype=u.dtype)
    out = _output(out, "out", (n + 1, n + 1), dev, (u, f), u.dtype)
    fc_out = _output(fc_out, "fc_out", (n // 2 + 1, n // 2 + 1), dev, (u, f, out), u.dtype)
    rsq = _scalar_out(rsq, dev)
    _check_aligned(("u", u), ("f", f), ("phase", ph))
    tiles = _launch_tiles("A2", n, ph is not None, form, 0, dev, bf16)
    partial, done = _tile_scratch(tiles, dev, workspace)
    KERNELS["A2"](u.data_ptr(), f.data_ptr(), _ptr(ph), out.data_ptr(), fc_out.data_ptr(),
                  partial.data_ptr(), done.data_ptr(), rsq.data_ptr(), n, a0, da, omega, *m,
                  int(ph is not None), form, bf16, tiles.strip, tiles.gx, tiles.gy,
                  _stream(dev))
    return out, fc_out, rsq


_A5_TILES = {}


def a5_launch_tiles(n: int, bim: bool, form: int, device, bf16: int) -> Tiles:
    """The geometry A5 launches with on ``device``: its one-pass tiles up to
    ``A5_ONE_PASS_MAX_N[bim]``, else row-streaming strips of
    ``ops/hrelax.py::row_strip``'s height for the occupancy the card
    reports for the instance launched (``ops/hrelax.py::launch_tiles``;
    computed once per level shape)."""
    if n <= A5_ONE_PASS_MAX_N[bool(bim)]:
        return a5_one_pass_tiles(n)
    from multigrid_feanet_torch.ops import hrelax as hx

    return hx.launch_tiles(_A5_TILES, (n, bool(bim), form, bf16, device.index), device,
                           lambda s: a5_tiles(n, s), _HALO_STEPS["A5"], "mg_rr_occupancy",
                           int(bim), form, bf16)


def rr_cuda(u, f, ph=None, *, a0, da, dform, mass=None, fc_out=None, rsq=None,
            workspace=None):
    """A5 on the card; same contract as :func:`rr_plain`, and u, f and
    ``ph`` must start on a 16-byte boundary (whole tensors do; an offset
    view may not, and raises ValueError).  The row-streaming design
    finishes the norm in its last block (one launch); the one-pass tile
    sums its partials in a second pass."""
    form, m = _form(dform, mass)
    n, dev, bf16 = u.shape[0] - 1, u.device, _storage(u)
    _operands(n, dev, [("u", u), ("f", f)], ph, dtype=u.dtype)
    fc_out = _output(fc_out, "fc_out", (n // 2 + 1, n // 2 + 1), dev, (u, f), u.dtype)
    rsq = _scalar_out(rsq, dev)
    _check_aligned(("u", u), ("f", f), ("phase", ph))
    tiles = a5_launch_tiles(n, ph is not None, form, dev, bf16)
    partial, done = _tile_scratch(tiles, dev, workspace)
    KERNELS["A5"](u.data_ptr(), f.data_ptr(), _ptr(ph), fc_out.data_ptr(), partial.data_ptr(),
                  done.data_ptr(), rsq.data_ptr(), n, a0, da, *m, int(ph is not None), form,
                  bf16, int(tiles.leg == "A5_tile"), tiles.strip, tiles.gx, tiles.gy,
                  _stream(dev))
    return fc_out, rsq


def a6_launch_tiles(n: int, bim: bool, form: int, device, bf16: int) -> Tiles:
    """The geometry A6 launches with: its one-pass tiles up to
    ``A6_ONE_PASS_MAX_N``, else the row-streaming strips of
    :func:`_launch_tiles`."""
    if n <= A6_ONE_PASS_MAX_N:
        return a6_one_pass_tiles(n)
    return _launch_tiles("A6", n, bim, form, 0, device, bf16)


def pswrr_cuda(u1, f, ph, uc, *, a0, da, omega, dform, mass=None, out=None, fc_out=None,
               rsq=None, workspace=None):
    """A6 on the card; same contract as :func:`pswrr_plain`, and u1, f and
    ``ph`` must start on a 16-byte boundary (whole tensors do; an offset
    view may not, and raises ValueError)."""
    form, m = _form(dform, mass)
    n, dev, bf16 = u1.shape[0] - 1, u1.device, _storage(u1)
    _operands(n, dev, [("u1", u1), ("f", f)], ph, [("uc", uc)], dtype=u1.dtype)
    out = _output(out, "out", (n + 1, n + 1), dev, (u1, f, uc), u1.dtype)
    fc_out = _output(fc_out, "fc_out", (n // 2 + 1, n // 2 + 1), dev, (u1, f, uc, out),
                     u1.dtype)
    rsq = _scalar_out(rsq, dev)
    _check_aligned(("u1", u1), ("f", f), ("phase", ph))
    tiles = a6_launch_tiles(n, ph is not None, form, dev, bf16)
    if tiles.leg == "A6_tile":
        partial, done = _partials(1, n, dev, workspace), None
    else:
        partial, done = _tile_scratch(tiles, dev, workspace)
    KERNELS["A6"](u1.data_ptr(), f.data_ptr(), _ptr(ph), uc.data_ptr(), out.data_ptr(),
                  fc_out.data_ptr(), partial.data_ptr(), _ptr(done), rsq.data_ptr(), n, a0, da,
                  omega, *m, int(ph is not None), form, bf16, int(tiles.leg == "A6_tile"),
                  tiles.strip, tiles.gx, tiles.gy, _stream(dev))
    return out, fc_out, rsq


def zrr_cuda(f, ph=None, *, a0, da, omega, mass=None, out=None):
    """A3 on the card; same contract as :func:`zrr_plain`, and f and ``ph``
    must start on a 16-byte boundary (whole tensors do; an offset view may
    not, and raises ValueError)."""
    form, m = _form(False, mass)
    n, dev, bf16 = f.shape[0] - 1, f.device, _storage(f)
    _operands(n, dev, [("f", f)], ph, dtype=f.dtype)
    out = _output(out, "out", (n // 2 + 1, n // 2 + 1), dev, (f,), f.dtype)
    _check_aligned(("f", f), ("phase", ph))
    tiles = _launch_tiles("A3", n, ph is not None, form, 0, dev, bf16)
    KERNELS["A3"](f.data_ptr(), _ptr(ph), out.data_ptr(), n, a0, da, omega, *m,
                  int(ph is not None), int(mass is not None), bf16, tiles.strip, tiles.gx,
                  tiles.gy, _stream(dev))
    return out


def zpsweep_cuda(f, ph, uc, *, a0, da, omega, mass=None, out=None):
    """A4 on the card; same contract as :func:`zpsweep_plain`, and f,
    ``ph`` and ``uc`` must start on a 16-byte boundary (whole tensors do;
    an offset view may not, and raises ValueError)."""
    form, m = _form(False, mass)
    n, dev, bf16 = f.shape[0] - 1, f.device, _storage(f)
    _operands(n, dev, [("f", f)], ph, [("uc", uc)], dtype=f.dtype)
    out = _output(out, "out", (n + 1, n + 1), dev, (f, uc), f.dtype)
    _check_aligned(("f", f), ("phase", ph), ("uc", uc))
    tiles = _launch_tiles("A4", n, ph is not None, form, 0, dev, bf16)
    KERNELS["A4"](f.data_ptr(), _ptr(ph), uc.data_ptr(), out.data_ptr(), n, a0,
                  da, omega, *m, int(ph is not None), int(mass is not None), bf16, tiles.strip,
                  tiles.gx, tiles.gy, _stream(dev))
    return out


# ---------------------------------------------------------------------------
# Level object.
# ---------------------------------------------------------------------------


class SweepLevel:
    """The six kernels bound to one level's operator; counterpart of
    ``PallasLevel`` on compact fields, with its whole interface.

    ``phase`` is the (n, n) element phase map (None = homogeneous).
    ``mass`` = (mp, ms, mo) adds the pattern-independent per-element
    operator (the heat theta-system, ``ops/heat.py``).  ``dform`` selects
    the difference-form apply for A1/A2/A5/A6; it defaults to on for a
    pure-stiffness operator and off with ``mass``, as ``PallasLevel``'s
    default, and is refused with ``mass``.  A3/A4 always use the plain
    form, as their TPU kernels do.  ``dtype`` is the node fields' storage
    type, ``PallasLevel``'s ``dtype``: float32, or bfloat16 (computed in
    float32, rounded where stored); every field and ``out`` buffer handed
    to a method must have it, on the CPU too.  Every method takes optional
    ``out`` buffers (and ``rsq``, always float32, for the legs that emit
    one) so a solve loop can run without allocating; ``device=None`` means
    CUDA."""

    def __init__(self, n: int, phase=None, coefficients=(1.0, 20.0),
                 omega: float = 2.0 / 3.0, dform=None, mass=None, dtype=torch.float32,
                 device=None):
        if dtype not in STORAGE:
            raise ValueError(f"levels store node fields as float32 or bfloat16, not {dtype}")
        self.dtype = dtype
        self.mass = None if mass is None else tuple(float(m) for m in mass)
        self.dform = (self.mass is None) if dform is None else bool(dform)
        _check_form(self.dform, self.mass)
        self.device = resolve_device(device)
        self.n = int(n)
        self.a0 = float(coefficients[0])
        self.da = (float(coefficients[1]) - float(coefficients[0])
                   if phase is not None else 0.0)
        self.omega = float(omega)
        self.ph = (None if phase is None else torch.as_tensor(
            phase, dtype=torch.int8, device=self.device).contiguous())
        self._workspace = {}

    def _check_dtype(self, *fields):
        for t in fields:
            if t is not None and t.dtype != self.dtype:
                raise ValueError(f"a field of dtype {t.dtype} on a level that stores "
                                 f"{self.dtype}")

    def _call(self, cuda_fn, plain_fn, x, *args, **kw):
        """``plain_fn`` on CPU tensors, ``cuda_fn`` on CUDA ones; the legs
        that emit ``rsq`` (A1, A2, A6) keep their partial-sum scratch in the
        level's workspace."""
        self._check_dtype(x, *(a for a in args if a is not self.ph),
                          kw.get("out"), kw.get("fc_out"))
        kw.update(a0=self.a0, da=self.da, omega=self.omega)
        if not x.is_cuda:
            return plain_fn(x, *args, **kw)
        if "rsq" in kw:
            kw["workspace"] = self._workspace
        return cuda_fn(x, *args, **kw)

    def sweep(self, u, f, out=None, rsq=None):
        """One weighted-Jacobi sweep -> (u_new, rsq of u).  On the card u and
        f must start on a 16-byte boundary (:func:`sweep_cuda`)."""
        return self._call(sweep_cuda, sweep_plain, u, f, self.ph, None,
                          dform=self.dform, mass=self.mass, out=out, rsq=rsq)

    def residual(self, u, f, out=None, rsq=None):
        """Interior-masked residual f - A u -> (r, ||r||^2).  On the card u
        and f must start on a 16-byte boundary (:func:`sweep_cuda`)."""
        return self._call(sweep_cuda, sweep_plain, u, f, self.ph, None,
                          dform=self.dform, mode="residual", mass=self.mass, out=out,
                          rsq=rsq)

    def psweep(self, u, f, uc, out=None, rsq=None):
        """u += masked bilinear prolongation of ``uc``; one sweep ->
        (u_new, rsq of the corrected u).  On the card u and f must start
        on a 16-byte boundary (:func:`sweep_cuda`)."""
        return self._call(sweep_cuda, sweep_plain, u, f, self.ph, uc,
                          dform=self.dform, mass=self.mass, out=out, rsq=rsq)

    def sweep_restrict(self, u, f, out=None, fc_out=None, rsq=None):
        """Pre-smoothing sweep + residual + x4 full weighting ->
        (u1, f_c, rsq of u).  On the card u and f must start on a 16-byte
        boundary (:func:`swrr_cuda`)."""
        return self._call(swrr_cuda, swrr_plain, u, f, self.ph, dform=self.dform,
                          mass=self.mass, out=out, fc_out=fc_out, rsq=rsq)

    def restrict_residual(self, u, f, fc_out=None, rsq=None):
        """Residual + x4 full weighting -> (f_c, rsq of u); no solver path
        calls it (``sweep_restrict`` fuses it with the sweep)."""
        self._check_dtype(u, f, fc_out)
        kw = dict(a0=self.a0, da=self.da, dform=self.dform, mass=self.mass, fc_out=fc_out,
                  rsq=rsq)
        if not u.is_cuda:
            return rr_plain(u, f, self.ph, **kw)
        return rr_cuda(u, f, self.ph, workspace=self._workspace, **kw)

    def pswrr(self, u1, f, uc, out=None, fc_out=None, rsq=None):
        """Prolongation-add and post-smoothing sweep of one V(1,1) cycle
        fused with the next cycle's pre-smoothing sweep and restriction ->
        (u4, f_c, rsq of the completed cycle's iterate u3)."""
        return self._call(pswrr_cuda, pswrr_plain, u1, f, self.ph, uc, dform=self.dform,
                          mass=self.mass, out=out, fc_out=fc_out, rsq=rsq)

    def zsweep_restrict(self, f, out=None):
        """Zero-initial-guess descent leg -> f_c.  On the card f must start
        on a 16-byte boundary (:func:`zrr_cuda`)."""
        return self._call(zrr_cuda, zrr_plain, f, self.ph, mass=self.mass, out=out)

    def zpsweep(self, f, uc, out=None):
        """Zero-initial-guess ascent leg -> u3.  On the card f and ``uc``
        must start on a 16-byte boundary (:func:`zpsweep_cuda`)."""
        return self._call(zpsweep_cuda, zpsweep_plain, f, self.ph, uc, mass=self.mass, out=out)
