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

The kernels are built for chain depths ``SUPPORTED_DEPTHS``; the wrappers
raise ValueError for any other.  The prolongation-fused legs (E3, E5) need
an odd depth, as the TPU wrappers assert; the plain versions take any
depth otherwise.
"""

from __future__ import annotations

import ctypes

import torch

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
_TAIL = [_I, _D, _D, _D, _I, _I, _I, _P]  # n, a0, da, omega, bim, dform, L, stream

KERNELS = {
    "E1": sw.CudaKernel("E1_hrelax", "mg_hrelax", [_P] * 8 + [_D, _I] + _TAIL,
                        _REPLACES + "55", _SOURCE),
    "E2": sw.CudaKernel("E2_hswrr", "mg_hswrr", [_P] * 8 + _TAIL, _REPLACES + "287", _SOURCE),
    "E3": sw.CudaKernel("E3_phrelax", "mg_phrelax", [_P] * 6 + _TAIL, _REPLACES + "361",
                        _SOURCE),
    "E4": sw.CudaKernel("E4_zhswrr", "mg_zhswrr", [_P] * 4 + _TAIL, _REPLACES + "420", _SOURCE),
    "E5": sw.CudaKernel("E5_zphrelax", "mg_zphrelax", [_P] * 5 + _TAIL, _REPLACES + "460",
                        _SOURCE),
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


def _tail(n, L, ph, a0, da, omega, dform, dev):
    return (n, a0, da, omega, int(ph is not None), int(dform), L, sw._stream(dev))


def _bc_operand(bc, n, dev):
    """(bc field or None, bc scalar, mode) of E1's boundary value: mode 0
    keeps u's ring, 1 sets it to a number, 2 to an (n+1)^2 field."""
    if bc is None:
        return None, 0.0, 0
    if torch.is_tensor(bc):
        sw._check(bc, "bc", (n + 1, n + 1), torch.float32, dev)
        return bc, 0.0, 2
    return None, float(bc), 1


def hrelax_cuda(u, f, ph, params, *, a0, da, omega, dform, bc=None, out=None, rsq=None,
                workspace=None):
    """E1 on the card; same contract as :func:`hrelax_plain`."""
    L = _kernel_depth(params)
    n, dev = u.shape[0] - 1, u.device
    sw._operands(n, dev, [("u", u), ("f", f)], ph)
    sw._check(params, "params", (L, 3, 3), torch.float32, dev)
    bcf, bcs, mode = _bc_operand(bc, n, dev)
    out = sw._output(out, "out", (n + 1, n + 1), dev, (u, f, bcf))
    rsq = sw._scalar_out(rsq, dev)
    KERNELS["E1"](u.data_ptr(), f.data_ptr(), sw._ptr(ph), params.data_ptr(), sw._ptr(bcf),
                  out.data_ptr(), sw._partials(1, n, dev, workspace).data_ptr(), rsq.data_ptr(),
                  bcs, mode, *_tail(n, L, ph, a0, da, omega, dform, dev))
    return out, rsq


def hswrr_cuda(u, f, ph, params, *, a0, da, omega, dform, out=None, fc_out=None, rsq=None,
               workspace=None):
    """E2 on the card; same contract as :func:`hswrr_plain`."""
    L = _kernel_depth(params)
    n, dev = u.shape[0] - 1, u.device
    sw._operands(n, dev, [("u", u), ("f", f)], ph)
    sw._check(params, "params", (L, 3, 3), torch.float32, dev)
    out = sw._output(out, "out", (n + 1, n + 1), dev, (u, f))
    fc_out = sw._output(fc_out, "fc_out", (n // 2 + 1, n // 2 + 1), dev, (u, f, out))
    rsq = sw._scalar_out(rsq, dev)
    KERNELS["E2"](u.data_ptr(), f.data_ptr(), sw._ptr(ph), params.data_ptr(), out.data_ptr(),
                  fc_out.data_ptr(), sw._partials(1, n, dev, workspace).data_ptr(),
                  rsq.data_ptr(), *_tail(n, L, ph, a0, da, omega, dform, dev))
    return out, fc_out, rsq


def phrelax_cuda(u, f, ph, uc, params, *, a0, da, omega, dform, out=None):
    """E3 on the card; same contract as :func:`phrelax_plain`."""
    L = _kernel_depth(params, odd=True)
    n, dev = u.shape[0] - 1, u.device
    sw._operands(n, dev, [("u", u), ("f", f)], ph, [("uc", uc)])
    sw._check(params, "params", (L, 3, 3), torch.float32, dev)
    out = sw._output(out, "out", (n + 1, n + 1), dev, (u, f, uc))
    KERNELS["E3"](u.data_ptr(), f.data_ptr(), sw._ptr(ph), uc.data_ptr(), params.data_ptr(),
                  out.data_ptr(), *_tail(n, L, ph, a0, da, omega, dform, dev))
    return out


def zhswrr_cuda(f, ph, params, *, a0, da, omega, dform, out=None):
    """E4 on the card; same contract as :func:`zhswrr_plain`."""
    L = _kernel_depth(params)
    n, dev = f.shape[0] - 1, f.device
    sw._operands(n, dev, [("f", f)], ph)
    sw._check(params, "params", (L, 3, 3), torch.float32, dev)
    out = sw._output(out, "out", (n // 2 + 1, n // 2 + 1), dev, (f,))
    KERNELS["E4"](f.data_ptr(), sw._ptr(ph), params.data_ptr(), out.data_ptr(),
                  *_tail(n, L, ph, a0, da, omega, dform, dev))
    return out


def zphrelax_cuda(f, ph, uc, params, *, a0, da, omega, dform, out=None):
    """E5 on the card; same contract as :func:`zphrelax_plain`."""
    L = _kernel_depth(params, odd=True)
    n, dev = f.shape[0] - 1, f.device
    sw._operands(n, dev, [("f", f)], ph, [("uc", uc)])
    sw._check(params, "params", (L, 3, 3), torch.float32, dev)
    out = sw._output(out, "out", (n + 1, n + 1), dev, (f, uc))
    KERNELS["E5"](f.data_ptr(), sw._ptr(ph), uc.data_ptr(), params.data_ptr(), out.data_ptr(),
                  *_tail(n, L, ph, a0, da, omega, dform, dev))
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
