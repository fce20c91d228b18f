"""Fused V-cycle legs of a general 9-point operator with operator-induced
(BoxMG) transfers, on compact fields.

Port of ``multigrid_feanet_tpu/ops/pallas_general.py``.  A level's operator
is either the exact bi-material element phase (level 0: an (n, n) int8 map,
applied in difference form as by ``ops/sweep.py``) or a per-node 3x3
stencil field stored as contiguous (9, H, W) planes, plane ``3*dr + dc``
coupling a node to its ``(dr-1, dc-1)`` neighbour (the Galerkin coarse
levels).  The transfers are the W4 weights of ``ops/boxmg.py`` stored as
contiguous (4, H, W) planes ``[w00, w01, w10, w11]`` on the FINE level:

    (P uc)[i, j] = sum_{a,b} w_ab[i, j] uc[i//2 + a, j//2 + b]

and the restriction is the exact transpose P^T, with no factor 4 (the
Galerkin coarse operators are P^T A P).  Planes are stored in
``coef_dtype`` (float32 or bfloat16) and read as float32, by the kernels
and by the plain versions alike, so both see the same rounded values.

Five kernels, hand-written in CUDA C++ (``csrc/general.cu``):

====  =================  ==========================================  ==============
name  C entry point      replaces                                    level methods
====  =================  ==========================================  ==============
D1    ``mg_gsweep``      ``pallas_general.py:163 _gsweep_kernel``    sweep, residual
D2    ``mg_gswrr``       ``pallas_general.py:202 _gswrr_kernel``     swrr
D3    ``mg_gpsweep``     ``pallas_general.py:303 _gpsweep_kernel``   psweep
D4    ``mg_zgwrr``       ``pallas_general.py:362 _zgwrr_kernel``     zwrr
D5    ``mg_zgpsweep``    ``pallas_general.py:411 _zgpsweep_kernel``  zpsweep
====  =================  ==========================================  ==============

On a bi-material level, ``sweep`` and ``residual`` run kernel A1 of
``ops/sweep.py`` in difference form, as ``GeneralPallasLevel`` delegates to
the fixed-stencil family.  Each kernel has a wrapper ``<leg>_cuda`` and a
plain PyTorch version ``<leg>_plain`` with the same signature; CPU tensors
take the plain version, CUDA tensors launch the kernel or raise.  Kernel
and plain version agree to ``TOL`` relative to ``max(1, max|plain|)`` on
fields and ``TOL`` relative on the residual norm: f32 reassociation and FMA
contraction of the 9-term sums change each term by about one ulp.

Semantics (as the TPU kernels): only globally interior nodes are updated,
residuals and the prolonged correction are zero on the boundary, the
coarse output is zero on the coarse boundary ring, the Jacobi diagonal of
a general level is its centre coefficient with 0 mapped to 1, and ``rsq``
is the interior squared residual norm of the INCOMING iterate (D1, D2).

D2 streams rows (``csrc/general.cu d2_gen_descent_rows``) above
``D2_ONE_PASS_MAX_N``, in both operator forms and plane types: its wrapper
launches it on the bands and strips of :func:`d2_tiles`, with the strip
height ``ops/hrelax.py::row_strip`` picks for the level's size and the
card's occupancy, and smaller levels on the one-pass tile
(:func:`d2_launch_tiles`); both designs finish the norm in their last
block.  Its u, f, the operator and the W4 planes must start on a 16-byte
boundary.
"""

from __future__ import annotations

import ctypes

import torch

from multigrid_feanet_torch.core.device import resolve_device
from multigrid_feanet_torch.ops import hrelax as hx
from multigrid_feanet_torch.ops import sweep as sw
from multigrid_feanet_torch.ops.boxmg import prolong_planes, restrict_planes

TOL = sw.TOL
COEF_DTYPES = (torch.float32, torch.bfloat16)

# ---------------------------------------------------------------------------
# Plain twins of the in-kernel math (pallas_general.py:92-155).
# ---------------------------------------------------------------------------


def _apply_gen(u, s9):
    """General A u on a whole field; ``s9`` (9, H, W) f32 planes.  Order of
    operations as ``_apply_gen``: per stencil row (W + C) + E, rows summed
    top to bottom."""
    U = sw._shifts(u)
    au = None
    for dr in range(3):
        t = (s9[3 * dr] * U(dr - 1, -1) + s9[3 * dr + 1] * U(dr - 1, 0)
             + s9[3 * dr + 2] * U(dr - 1, 1))
        au = t if au is None else au + t
    return au


def _guard_d(d):
    return torch.where(d.abs() > 0.0, d, 1.0)


def _w4_corr(uc, w4):
    """W4 prolongation of the coarse field ``uc`` masked to the fine
    interior; ``w4`` (4, H, W) f32 planes."""
    return torch.where(sw._interior(w4[0]), prolong_planes(uc, *w4), 0.0)


def _w4_restrict(r, w4):
    """P^T r (``restrict_w4``'s formula) masked to the coarse interior."""
    fc = restrict_planes(r, *w4)
    return torch.where(sw._interior(fc), fc, 0.0)


def _level_apply(u, op, a0, da):
    """(A u, Jacobi diagonal) of a level operator ``op``: an (n, n) int8
    phase (bi-material, difference form) or (9, H, W) planes."""
    if op.dtype == torch.int8:
        au, C4 = sw._apply_bim_d(u, sw.element_q(op, a0, da))
        return au, sw._diag_bim(C4)
    s9 = op.float()
    return _apply_gen(u, s9), _guard_d(s9[4])


# ---------------------------------------------------------------------------
# Plain PyTorch versions of the five kernels.
# ---------------------------------------------------------------------------


def gsweep_plain(u, f, s9, *, omega, mode="sweep", out=None, rsq=None):
    """D1: one weighted-Jacobi sweep (``mode="sweep"``) or the masked
    residual (``mode="residual"``) of the planes ``s9`` -> (out, rsq)."""
    sw._check_mode(mode, None)
    s9 = s9.float()
    r = torch.where(sw._interior(u), f - _apply_gen(u, s9), 0.0)
    res = r if mode == "residual" else u + (omega / _guard_d(s9[4])) * r
    return sw._emit(res, out), sw._emit(torch.sum(r * r), rsq)


def gswrr_plain(u, f, op, w4, *, a0, da, omega, out=None, fc_out=None, rsq=None):
    """D2: u1 = sweep(u); f_c = P^T (f - A u1) -> (u1, f_c, rsq of u).
    ``op`` is the int8 phase or the planes; ``a0``/``da`` serve the phase."""
    mask = sw._interior(u)
    au, d = _level_apply(u, op, a0, da)
    r0 = torch.where(mask, f - au, 0.0)
    u1 = u + (omega / d) * r0
    au1, _ = _level_apply(u1, op, a0, da)
    r1 = torch.where(mask, f - au1, 0.0)
    fc = _w4_restrict(r1, w4.float())
    return sw._emit(u1, out), sw._emit(fc, fc_out), sw._emit(torch.sum(r0 * r0), rsq)


def gpsweep_plain(u, f, op, w4, uc, *, a0, da, omega, out=None):
    """D3: one sweep of u + P(uc) -> u3."""
    u = u + _w4_corr(uc, w4.float())
    au, d = _level_apply(u, op, a0, da)
    r = torch.where(sw._interior(u), f - au, 0.0)
    return sw._emit(u + (omega / d) * r, out)


def zgwrr_plain(f, s9, w4, *, omega, out=None):
    """D4: f_c = P^T (f - A u1) with u1 = (omega/d) f at interior nodes."""
    s9 = s9.float()
    mask = sw._interior(f)
    u1 = torch.where(mask, (omega / _guard_d(s9[4])) * f, 0.0)
    r1 = torch.where(mask, f - _apply_gen(u1, s9), 0.0)
    return sw._emit(_w4_restrict(r1, w4.float()), out)


def zgpsweep_plain(f, s9, w4, uc, *, omega, out=None):
    """D5: one sweep of u2 = (omega/d) f + P(uc) (interior) -> u3."""
    s9 = s9.float()
    mask = sw._interior(f)
    d = _guard_d(s9[4])
    u2 = torch.where(mask, (omega / d) * f, 0.0) + _w4_corr(uc, w4.float())
    r = torch.where(mask, f - _apply_gen(u2, s9), 0.0)
    return sw._emit(u2 + (omega / d) * r, out)


# ---------------------------------------------------------------------------
# CUDA kernels: ctypes bindings, launch counts, wrappers.
# ---------------------------------------------------------------------------

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_SOURCE = "multigrid_feanet_torch/csrc/general.cu"
_REPLACES = "multigrid_feanet_tpu/ops/pallas_general.py:"

KERNELS = {
    "D1": sw.CudaKernel("D1_gsweep", "mg_gsweep",
                        [_P, _P, _P, _P, _P, _P, _I, _D, _I, _I, _P],
                        _REPLACES + "163", _SOURCE),
    "D2": sw.CudaKernel("D2_gswrr", "mg_gswrr",
                        [_P] * 10 + [_I, _D, _D, _D] + [_I] * 6 + [_P],
                        _REPLACES + "202", _SOURCE),
    "D3": sw.CudaKernel("D3_gpsweep", "mg_gpsweep",
                        [_P, _P, _P, _P, _P, _P, _P, _I, _D, _D, _D, _I, _I, _P],
                        _REPLACES + "303", _SOURCE),
    "D4": sw.CudaKernel("D4_zgwrr", "mg_zgwrr", [_P, _P, _P, _P, _I, _D, _I, _P],
                        _REPLACES + "362", _SOURCE),
    "D5": sw.CudaKernel("D5_zgpsweep", "mg_zgpsweep", [_P, _P, _P, _P, _P, _I, _D, _I, _P],
                        _REPLACES + "411", _SOURCE),
}


def _planes(t, name, k, n, device) -> int:
    """Check a (k, n+1, n+1) float32 / bfloat16 plane stack; 1 if bf16."""
    if t.dtype not in COEF_DTYPES:
        raise ValueError(f"{name} has dtype {t.dtype}, expected float32 or bfloat16")
    sw._check(t, name, (k, n + 1, n + 1), t.dtype, device)
    return int(t.dtype == torch.bfloat16)


def _operator(op, w4, n, device):
    """Check a level operator and its W4 planes -> (phase ptr, planes ptr,
    bim, bf16): the int8 phase of a bi-material level, or planes in the
    same dtype as ``w4``."""
    bf16 = _planes(w4, "w4", 4, n, device)
    if op.dtype == torch.int8:
        sw._check(op, "phase", (n, n), torch.int8, device)
        return op.data_ptr(), None, 1, bf16
    if _planes(op, "s9", 9, n, device) != bf16:
        raise ValueError(f"s9 ({op.dtype}) and w4 ({w4.dtype}) must share a dtype")
    return None, op.data_ptr(), 0, bf16


# ---------------------------------------------------------------------------
# Launch geometry of D2: row-streaming bands and strips in common.cuh's block
# shape, each block restricting to the coarse nodes under its band and
# strip.
# ---------------------------------------------------------------------------

# levels of up to this many elements per side run D2 on its one-pass tiles
# (csrc/general.cu d2_gen_descent, 16 x 32 fine tiles of the coarse grid):
# one wave of the tile holds a level there, while a strip's 6 halo steps
# are a large share of its rows.  The largest level at which the tile was
# the faster on the H100 (the general form; the bi-material one ties there)
# (``sweep_vs_parent.py --crossover --legs g2d2``, PERF.md)
D2_ONE_PASS_MAX_N = 1024


def d2_tiles(n: int, strip: int = 32) -> sw.Tiles:
    """D2: E2's descent chain without conv layers (``ops/hrelax.py``
    ``descent_tiles`` with L = 0): bands of ``A12_THREADS A12_COLUMNS - 4``
    owned columns, each block restricting to the coarse nodes under it."""
    return hx.descent_tiles("D2", n, 0, strip)


def d2_one_pass_tiles(n: int) -> sw.Tiles:
    """D2 on one-pass tiles (``ops/hrelax.py::coarse_tiles``)."""
    return hx.coarse_tiles("D2_tile", n)


_D2_TILES = {}


def d2_launch_tiles(n: int, bim: bool, bf16: bool, device) -> sw.Tiles:
    """The geometry D2 launches with on ``device``: one-pass tiles up to
    ``D2_ONE_PASS_MAX_N``, else row-streaming strips of ``row_strip``'s
    height (the chain's halo steps ``e2_halo_steps(0)``) for the occupancy
    the card reports for the instance launched (``ops/hrelax.py``
    ``launch_tiles``)."""
    if n <= D2_ONE_PASS_MAX_N:
        return d2_one_pass_tiles(n)
    return hx.launch_tiles(_D2_TILES, (n, bool(bim), bool(bf16), device.index), device,
                           lambda s: d2_tiles(n, s), hx.e2_halo_steps(0),
                           "mg_gswrr_occupancy", int(bim), int(bf16))


def gsweep_cuda(u, f, s9, *, omega, mode="sweep", out=None, rsq=None, workspace=None):
    """D1 on the card; same contract as :func:`gsweep_plain`."""
    sw._check_mode(mode, None)
    n, dev = u.shape[0] - 1, u.device
    sw._operands(n, dev, [("u", u), ("f", f)])
    bf16 = _planes(s9, "s9", 9, n, dev)
    out = sw._output(out, "out", (n + 1, n + 1), dev, (u, f))
    rsq = sw._scalar_out(rsq, dev)
    KERNELS["D1"](u.data_ptr(), f.data_ptr(), s9.data_ptr(), out.data_ptr(),
                  sw._partials(0, n, dev, workspace).data_ptr(), rsq.data_ptr(), n,
                  omega, bf16, 0 if mode == "sweep" else 1, sw._stream(dev))
    return out, rsq


def gswrr_cuda(u, f, op, w4, *, a0, da, omega, out=None, fc_out=None, rsq=None,
               workspace=None):
    """D2 on the card; same contract as :func:`gswrr_plain`, and u, f, the
    operator and ``w4`` must start on a 16-byte boundary (whole tensors do;
    an offset view may not, and raises ValueError)."""
    n, dev = u.shape[0] - 1, u.device
    sw._operands(n, dev, [("u", u), ("f", f)])
    ph, s9, bim, bf16 = _operator(op, w4, n, dev)
    out = sw._output(out, "out", (n + 1, n + 1), dev, (u, f))
    fc_out = sw._output(fc_out, "fc_out", (n // 2 + 1, n // 2 + 1), dev, (u, f, out))
    rsq = sw._scalar_out(rsq, dev)
    sw._check_aligned(("u", u), ("f", f), ("operator", op), ("w4", w4))
    tiles = d2_launch_tiles(n, bim, bf16, dev)
    partial, done = hx.row_scratch(tiles, 1, dev, workspace)
    KERNELS["D2"](u.data_ptr(), f.data_ptr(), ph, s9, w4.data_ptr(), out.data_ptr(),
                  fc_out.data_ptr(), partial.data_ptr(), done.data_ptr(), rsq.data_ptr(), n, a0,
                  da, omega, bim, bf16, int(tiles.leg == "D2_tile"), tiles.strip, tiles.gx,
                  tiles.gy, sw._stream(dev))
    return out, fc_out, rsq


def gpsweep_cuda(u, f, op, w4, uc, *, a0, da, omega, out=None):
    """D3 on the card; same contract as :func:`gpsweep_plain`."""
    n, dev = u.shape[0] - 1, u.device
    sw._operands(n, dev, [("u", u), ("f", f)], None, [("uc", uc)])
    ph, s9, bim, bf16 = _operator(op, w4, n, dev)
    out = sw._output(out, "out", (n + 1, n + 1), dev, (u, f, uc))
    KERNELS["D3"](u.data_ptr(), f.data_ptr(), ph, s9, w4.data_ptr(), uc.data_ptr(),
                  out.data_ptr(), n, a0, da, omega, bim, bf16, sw._stream(dev))
    return out


def zgwrr_cuda(f, s9, w4, *, omega, out=None):
    """D4 on the card; same contract as :func:`zgwrr_plain`."""
    n, dev = f.shape[0] - 1, f.device
    if s9.dtype == torch.int8:
        raise ValueError("the zero-guess legs take a general (9-plane) operator")
    sw._operands(n, dev, [("f", f)])
    _, _, _, bf16 = _operator(s9, w4, n, dev)
    out = sw._output(out, "out", (n // 2 + 1, n // 2 + 1), dev, (f,))
    KERNELS["D4"](f.data_ptr(), s9.data_ptr(), w4.data_ptr(), out.data_ptr(), n, omega,
                  bf16, sw._stream(dev))
    return out


def zgpsweep_cuda(f, s9, w4, uc, *, omega, out=None):
    """D5 on the card; same contract as :func:`zgpsweep_plain`."""
    n, dev = f.shape[0] - 1, f.device
    if s9.dtype == torch.int8:
        raise ValueError("the zero-guess legs take a general (9-plane) operator")
    sw._operands(n, dev, [("f", f)], None, [("uc", uc)])
    _, _, _, bf16 = _operator(s9, w4, n, dev)
    out = sw._output(out, "out", (n + 1, n + 1), dev, (f, uc))
    KERNELS["D5"](f.data_ptr(), s9.data_ptr(), w4.data_ptr(), uc.data_ptr(), out.data_ptr(),
                  n, omega, bf16, sw._stream(dev))
    return out


# ---------------------------------------------------------------------------
# Level object.
# ---------------------------------------------------------------------------


def _to_planes(x, k, dtype, device):
    """Compact per-node (H, W, ...) field of k entries -> contiguous (k, H, W)
    planes in ``dtype``."""
    x = torch.as_tensor(x, device=device)
    H, W = x.shape[:2]
    return x.reshape(H, W, k).permute(2, 0, 1).to(dtype).contiguous()


class GeneralSweepLevel:
    """The kernels bound to one BoxMG level; counterpart of
    ``GeneralPallasLevel`` on compact fields.

    Operator: the exact bi-material element phase (``phase`` and
    ``coefficients``; ``phase=None`` is the all-zero map, a homogeneous
    operator of coefficient ``coefficients[0]``) or a compact (H, W, 3, 3)
    stencil field ``s9``.  ``w4``: the level's compact (H, W, 2, 2)
    transfer weights to the next coarser level (None at the coarsest).
    Planes are stored in ``coef_dtype``.  Methods take optional ``out``
    buffers (and ``rsq`` for the legs that emit one); ``device=None`` means
    CUDA."""

    def __init__(self, n: int, s9=None, phase=None, coefficients=(1.0, 20.0), w4=None,
                 omega: float = 2.0 / 3.0, coef_dtype=torch.float32, device=None):
        if s9 is not None and phase is not None:
            raise ValueError("pass s9 or phase, not both")
        if coef_dtype not in COEF_DTYPES:
            raise ValueError(f"coef_dtype must be float32 or bfloat16, not {coef_dtype}")
        self.device = resolve_device(device)
        self.n = int(n)
        self.omega = float(omega)
        self.bim = s9 is None
        if self.bim:
            self.a0 = float(coefficients[0])
            self.da = float(coefficients[1]) - float(coefficients[0])
            ph = torch.zeros((n, n), dtype=torch.int8) if phase is None else phase
            self.op = torch.as_tensor(ph, dtype=torch.int8, device=self.device).contiguous()
        else:
            self.a0 = self.da = 0.0
            self.op = _to_planes(s9, 9, coef_dtype, self.device)
        self.w4 = None if w4 is None else _to_planes(w4, 4, coef_dtype, self.device)
        self._workspace = {}

    def _call(self, cuda_fn, plain_fn, x, *args, **kw):
        """``plain_fn`` on CPU tensors, ``cuda_fn`` on CUDA ones; the legs
        that emit ``rsq`` keep their partial-sum scratch in the level's
        workspace."""
        if not x.is_cuda:
            return plain_fn(x, *args, **kw)
        if "rsq" in kw:
            kw["workspace"] = self._workspace
        return cuda_fn(x, *args, **kw)

    def _w4(self):
        if self.w4 is None:
            raise ValueError("this level has no transfer weights (it is the coarsest)")
        return self.w4

    def _cfg(self):
        return dict(a0=self.a0, da=self.da, omega=self.omega)

    def sweep(self, u, f, out=None, rsq=None):
        """One weighted-Jacobi sweep -> (u_new, rsq of u)."""
        if self.bim:
            return self._call(sw.sweep_cuda, sw.sweep_plain, u, f, self.op, None,
                              dform=True, out=out, rsq=rsq, **self._cfg())
        return self._call(gsweep_cuda, gsweep_plain, u, f, self.op, omega=self.omega,
                          out=out, rsq=rsq)

    def residual(self, u, f, out=None, rsq=None):
        """Interior-masked residual f - A u -> (r, ||r||^2)."""
        if self.bim:
            return self._call(sw.sweep_cuda, sw.sweep_plain, u, f, self.op, None,
                              dform=True, mode="residual", out=out, rsq=rsq, **self._cfg())
        return self._call(gsweep_cuda, gsweep_plain, u, f, self.op, omega=self.omega,
                          mode="residual", out=out, rsq=rsq)

    def swrr(self, u, f, out=None, fc_out=None, rsq=None):
        """Pre-smoothing sweep + residual + W4 restriction -> (u1, f_c,
        rsq of u)."""
        return self._call(gswrr_cuda, gswrr_plain, u, f, self.op, self._w4(),
                          out=out, fc_out=fc_out, rsq=rsq, **self._cfg())

    def psweep(self, u, f, uc, out=None):
        """u + W4 prolongation of ``uc``; one sweep -> u_new."""
        return self._call(gpsweep_cuda, gpsweep_plain, u, f, self.op, self._w4(), uc,
                          out=out, **self._cfg())

    def zwrr(self, f, out=None):
        """Zero-initial-guess descent leg (general operator) -> f_c."""
        self._general_only()
        return self._call(zgwrr_cuda, zgwrr_plain, f, self.op, self._w4(),
                          omega=self.omega, out=out)

    def zpsweep(self, f, uc, out=None):
        """Zero-initial-guess ascent leg (general operator) -> u3."""
        self._general_only()
        return self._call(zgpsweep_cuda, zgpsweep_plain, f, self.op, self._w4(), uc,
                          omega=self.omega, out=out)

    def _general_only(self):
        if self.bim:
            raise ValueError("the zero-guess legs take a general (9-plane) operator")
