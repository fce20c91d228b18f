"""Periodic multigrid: classical and learned-restriction V-cycles on the
torus, and the reference's R-only training step.

Port of ``multigrid_feanet_tpu/solvers/pbc_mg.py`` (reference:
MM-FEANet-learnP-pbc.ipynb cell 8 ``MultiGrid.iterate``): relax, restrict
the residual with a stride-2 3x3 convolution on the wrap-padded grid (kernel
bilinear/4, so the h^2 factor 4 is in the kernel), recurse from zero, add the
transposed-convolution prolongation, relax; the coarsest level is relaxed
twice.  Coarse torus grids have n/2 nodes per edge.

On the levels with ``n >= kernel_threshold`` the relaxations are launches of
kernel H1 (``ops/torus.py``); the residual and the transfers stay torch ops,
as they are XLA ops in the JAX package.  The convolutions run in full f32
(cuDNN's TF32 is switched off around them).  Training differentiates the
plain ops (``ops/pbc.py::jacobi_step_pbc``) with autograd: no kernel is on
that path.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from multigrid_feanet_torch.core.device import resolve_device
from multigrid_feanet_torch.ops import pbc
from multigrid_feanet_torch.ops.torus import TorusLevel

BILINEAR_4 = np.array([[1, 2, 1], [2, 4, 2], [1, 2, 1]], dtype=np.float32) / 4.0


@contextlib.contextmanager
def _full_f32():
    """cuDNN convolutions in full f32 (TF32 keeps about three digits)."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _kernel(k, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(k, dtype=like.dtype, device=like.device).reshape(1, 1, 3, 3)


def pbc_restrict(r: torch.Tensor, kernel) -> torch.Tensor:
    """(..., n, n) -> (..., n/2, n/2): coarse node I samples fine node 2I
    with a 3x3 kernel and circular wrap."""
    lead, n = r.shape[:-2], r.shape[-1]
    x = pbc.wrap_pad(r.reshape(-1, n, n))[:, None]
    with _full_f32():
        out = F.conv2d(x, _kernel(kernel, r), stride=2)[:, 0]
    return out.reshape(*lead, *out.shape[-2:])


def pbc_prolong(v: torch.Tensor, kernel) -> torch.Tensor:
    """(..., m, m) -> (..., 2m, 2m): the transposed stride-2 convolution of
    torch's ``ConvTranspose2d(k=3, s=2, p=1)``, periodically wrapped.
    ``conv_transpose2d`` flips the kernel itself (the JAX package flips it
    by hand for its dilated correlation)."""
    lead, m = v.shape[:-2], v.shape[-1]
    x = pbc.wrap_pad(v.reshape(-1, m, m))[:, None]
    with _full_f32():
        # padding 2: fine indices [-1, 2m] of the wrapped input's [-2, 2m+1]
        out = F.conv_transpose2d(x, _kernel(kernel, v), stride=2, padding=2)[:, 0]
    # crop one leading row and column: start at fine index 0
    out = out[:, 1 : 1 + 2 * m, 1 : 1 + 2 * m]
    return out.reshape(*lead, 2 * m, 2 * m)


def torus_levels(n: int, num_levels: int, a0: float = 1.0, omega: float = 2.0 / 3.0,
                 kernel_threshold: int = 32, device=None) -> list:
    """Per level of an ``n``-node periodic hierarchy, a ``TorusLevel`` (H1)
    where the level has ``n_l >= kernel_threshold`` nodes per edge, else
    None (plain torch relaxations).  ``device=None`` means CUDA."""
    return [TorusLevel(n >> l, a0, omega, device) if (n >> l) >= kernel_threshold else None
            for l in range(num_levels)]


def v_cycle_pbc(table, u, f, num_levels: int, r_kernel=None, p_kernel=None,
                n_relax: int = 1, omega: float = 2.0 / 3.0, level: int = 0, torus=None):
    """Recursive periodic V-cycle on unique torus grids (homogeneous
    operator), with the reference's unconditional post-relax (the coarsest
    level is relaxed twice).  ``torus`` (from :func:`torus_levels`, for the
    table's a0) runs the relaxations of its non-None levels on H1; their n
    and omega must be the cycle's."""
    rk = BILINEAR_4 if r_kernel is None else r_kernel
    pk = BILINEAR_4 if p_kernel is None else p_kernel
    tl = None if torus is None else torus[level]
    if tl is not None and (tl.n != f.shape[-1] or tl.omega != float(omega)):
        raise ValueError(f"torus level {level} has n={tl.n}, omega={tl.omega}; the cycle "
                         f"has n={f.shape[-1]}, omega={float(omega)}")

    def relax(u):
        for _ in range(n_relax):
            u = (pbc.jacobi_step_pbc(table, u, f, omega) if tl is None
                 else tl.sweep(u.contiguous(), f)[0])
        return u

    u = relax(u)
    if level < num_levels - 1:
        r = f - pbc.apply_stencil_periodic(table, u)
        f_c = pbc_restrict(r, rk)
        u_c = v_cycle_pbc(table, torch.zeros_like(f_c), f_c, num_levels, r_kernel, p_kernel,
                          n_relax, omega, level + 1, torus)
        u = u + pbc_prolong(u_c, pk)
    return relax(u)


def solve_pbc_mg(table, f_conv, num_levels=None, r_kernel=None, p_kernel=None,
                 eps: float = 1e-5, max_cycles: int = 100, kernel_threshold=32, device=None):
    """Periodic V-cycles from u = 0 to the wrapped residual norm ``eps`` ->
    ``(u, history)``, ``history[j]`` the norm after cycle j+1 (one host
    sync per cycle, as the JAX loop).  The levels with
    ``n >= kernel_threshold`` (None: none) relax on H1.  ``device=None``
    means CUDA; on the CPU the relaxations are H1's plain version."""
    device = resolve_device(device)
    f = torch.as_tensor(f_conv, device=device)
    table = torch.as_tensor(table, device=device)
    n = f.shape[-1]
    if num_levels is None:
        num_levels = int(np.log2(n))
    torus = None
    if kernel_threshold is not None:
        torus = torus_levels(n, num_levels, pbc.homogeneous_a0(table),
                             kernel_threshold=kernel_threshold, device=device)
    u = torch.zeros_like(f)
    hist = []
    for _ in range(max_cycles):
        u = v_cycle_pbc(table, u, f, num_levels, r_kernel, p_kernel, torus=torus)
        res = float(pbc.pbc_interior_norm(f - pbc.apply_stencil_periodic(table, u)))
        hist.append(res)
        if res <= eps or not np.isfinite(res):
            break
    return u, np.asarray(hist)


# ---- learned-restriction training (R only, reference cells 8/12-14) ----


@dataclasses.dataclass
class PBCTrainState:
    """The trainable (3, 3) restriction kernel, its Adam optimizer and the
    generator of the random initial iterates."""

    r_kernel: torch.Tensor
    opt: torch.optim.Optimizer
    gen: torch.Generator


def init_pbc_state(seed: int = 0, lr: float = 1e-3, perturb: float = 0.5,
                   device=None) -> PBCTrainState:
    """Reference init: bilinear/4 + 0.5 U(3, 3) (cell 10), drawn from a
    ``torch.Generator`` seeded with ``seed`` (not the JAX key's numbers).
    ``device=None`` means CUDA."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    r0 = (torch.as_tensor(BILINEAR_4, device=device)
          + perturb * torch.rand((3, 3), generator=gen, device=device))
    r0.requires_grad_(True)
    return PBCTrainState(r0, torch.optim.Adam([r0], lr=lr), gen)


def pbc_loss(table, r_kernel, f, u0, num_levels: int, k: int = 4) -> torch.Tensor:
    """mean(|r_k| / |r_{k-1}|) after k V-cycles from ``u0`` with the k-1
    prefix detached (reference cell 8 ``loss`` + ``forward``); ``f`` is
    the mass-convolved (N, n, n) right-hand side."""
    u = u0
    with torch.no_grad():
        for _ in range(k - 1):
            u = v_cycle_pbc(table, u, f, num_levels, r_kernel)
    u_last = u
    u = v_cycle_pbc(table, u, f, num_levels, r_kernel)
    r1 = pbc.pbc_interior_norm(f - pbc.apply_stencil_periodic(table, u))
    with torch.no_grad():
        r0 = pbc.pbc_interior_norm(f - pbc.apply_stencil_periodic(table, u_last))
    return torch.mean(r1 / r0)


def pbc_train_step(table, state: PBCTrainState, f_raw, *, num_levels: int, k: int = 4,
                   u0=None):
    """One Adam step on :func:`pbc_loss` -> ``(state, loss)``; ``f_raw`` is
    the (N, n, n) raw periodic right-hand side.  ``u0`` (standard normal
    from the state's generator when None) is the cycles' initial iterate."""
    f_raw = torch.as_tensor(f_raw, device=state.r_kernel.device)
    n = f_raw.shape[-1]
    f = pbc.apply_mass_periodic(f_raw, 2.0 / n)
    if u0 is None:
        u0 = torch.randn(f_raw.shape, generator=state.gen, dtype=f_raw.dtype,
                         device=f_raw.device)
    table = torch.as_tensor(table, dtype=f_raw.dtype, device=f_raw.device)
    state.opt.zero_grad()
    loss = pbc_loss(table, state.r_kernel, f, torch.as_tensor(u0, device=f_raw.device),
                    num_levels, k)
    loss.backward()
    state.opt.step()
    return state, loss.item()
