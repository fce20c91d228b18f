"""Periodic-boundary operators and the periodic Jacobi solve.

Port of ``multigrid_feanet_tpu/ops/pbc.py`` (reference semantics:
FEANet/jacobi.py:50-97 ``JacobiBlockPBC``).  Fields live on the unique n x n
torus grid; the (n+1)^2 wrapped view, whose last row and column repeat the
first, exists only at the interface with the reference
(:func:`to_wrapped` / :func:`from_wrapped`) and in the residual norm
(:func:`pbc_interior_norm`).

The periodic problem is singular (its nullspace is the constants): shift the
right-hand side into the operator's range with :func:`compatibility_shift`
before solving.  :func:`solve_jacobi_pbc` runs its sweeps on kernel H1
(``ops/torus.py``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from multigrid_feanet_torch.core.device import resolve_device
from multigrid_feanet_torch.ops import stencil
from multigrid_feanet_torch.solvers.common import run_chunks


def wrap_pad(x: torch.Tensor, k: int = 1) -> torch.Tensor:
    """(..., H, W) -> (..., H + 2k, W + 2k) with circular ghosts."""
    lead = x.shape[:-2]
    y = F.pad(x.reshape(-1, 1, *x.shape[-2:]), (k, k, k, k), mode="circular")
    return y.reshape(*lead, *y.shape[-2:])


def from_wrapped(u: torch.Tensor) -> torch.Tensor:
    """(n+1, n+1) wrapped field -> (n, n) unique torus grid."""
    return u[..., :-1, :-1]


def to_wrapped(u_unique: torch.Tensor) -> torch.Tensor:
    """(n, n) unique torus grid -> (n+1, n+1) wrapped field (reference:
    ``JacobiBlockPBC.reset_boundary``, FEANet/jacobi.py:79-85)."""
    return wrap_pad(u_unique)[..., 1:, 1:]


def _taps_periodic(u: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """9-tap stencil with circular wrap on (..., n, n)."""
    H, W = u.shape[-2:]
    up = wrap_pad(u)
    out = None
    for a in range(3):
        for b in range(3):
            t = kernel[a, b] * up[..., a : a + H, b : b + W]
            out = t if out is None else out + t
    return out


def apply_stencil_periodic(table: torch.Tensor, u_unique: torch.Tensor) -> torch.Tensor:
    """A @ u on the torus (homogeneous operator, the reference's scope,
    FEANet/jacobi.py:51)."""
    return _taps_periodic(u_unique, table)


def apply_mass_periodic(f_unique: torch.Tensor, h: float) -> torch.Tensor:
    """Consistent load vector with periodic wrap (reference: FNet on the
    circularly padded field, FEANet-periodic.ipynb cell 2)."""
    k = (h * h) * torch.as_tensor(stencil.MASS_KERNEL, dtype=f_unique.dtype,
                                  device=f_unique.device)
    return _taps_periodic(f_unique, k)


def compatibility_shift(f_unique: torch.Tensor, h: float) -> torch.Tensor:
    """f <- f - h^2 sum(f) over the unique grid: the right-hand side in the
    range of the singular periodic operator (reference:
    MM-FEANet-learnP-pbc.ipynb cell 5)."""
    return f_unique - h * h * torch.sum(f_unique, dim=(-2, -1), keepdim=True)


def pbc_interior_norm(r_unique: torch.Tensor) -> torch.Tensor:
    """The reference's residual norm: over the FULL (n+1)^2 wrapped grid,
    the repeated last row and column included (FEANet-periodic.ipynb
    cell 5)."""
    rw = to_wrapped(r_unique)
    return torch.sqrt(torch.sum(rw * rw, dim=(-2, -1)))


def jacobi_step_pbc(table: torch.Tensor, u_unique: torch.Tensor, f_conv: torch.Tensor,
                    omega: float = 2.0 / 3.0) -> torch.Tensor:
    """u <- u + omega / diag * (f - A u) on the torus (reference:
    ``JacobiBlockPBC.jacobi_convolution``, FEANet/jacobi.py:87-97)."""
    r = f_conv - apply_stencil_periodic(table, u_unique)
    return u_unique + (omega / table[1, 1]) * r


def homogeneous_a0(table) -> float:
    """a0 of a table that is a0 times the homogeneous stencil; raises for
    any other table (kernel H1 runs only that operator)."""
    t = np.asarray(torch.as_tensor(table).detach().cpu(), dtype=np.float64)
    s9 = stencil.make_stencil_table_np((1.0, 1.0))[0]
    a0 = float(t[1, 1] / s9[1, 1])
    if t.shape != (3, 3) or not np.allclose(t, a0 * s9, rtol=1e-6, atol=0.0):
        raise ValueError("the periodic kernel runs a0 times the homogeneous stencil only")
    return a0


def solve_jacobi_pbc(table, f_conv, u0=None, eps=5e-6, max_iters: int = 10_000,
                     chunk: int = 256, omega: float = 2.0 / 3.0, device=None):
    """Weighted-Jacobi solve on the torus to the wrapped residual norm
    ``eps`` (None = never) or ``max_iters`` sweeps, in chunks of ``chunk``
    sweeps with one host sync each.

    Returns ``(u, history)`` in the reference's convention:
    ``history[j]`` is the wrapped (n+1)^2 residual norm after sweep j+1; each
    chunk ends with one explicit norm of its last iterate; the history is
    cut at the first norm ``<= eps`` while ``u`` is the end of that whole
    chunk (up to ``chunk - 1`` sweeps past it), as in the JAX solver.

    Each sweep is one launch of kernel H1 (a
    :class:`~multigrid_feanet_torch.ops.torus.TorusLevel` for ``table``'s a0
    and ``omega``), whose two free pre-update norms make up the history; the
    explicit norm is one more launch into a scratch field.  ``device=None``
    means CUDA; on the CPU the sweeps are H1's plain version, in the dtype
    of ``f_conv``."""
    from multigrid_feanet_torch.ops.torus import TorusLevel  # ops/torus.py imports this module

    device = resolve_device(device)
    f = torch.as_tensor(f_conv, device=device).contiguous()
    level = TorusLevel(f.shape[-1], homogeneous_a0(table), omega, device)
    u = torch.zeros_like(f) if u0 is None else torch.as_tensor(u0, dtype=f.dtype, device=device)
    bufs = [u.clone().contiguous(), torch.empty_like(f)]
    scratch = torch.empty_like(f)

    def run(u, k):
        cur, spare = (bufs if u is bufs[0] else bufs[::-1])
        sq = torch.empty((k + 1, 2), dtype=f.dtype, device=device)
        for j in range(k):
            level.sweep(cur, f, out=spare, rsq=sq[j, 0], rsq_wrap=sq[j, 1])
            cur, spare = spare, cur
        level.sweep(cur, f, out=scratch, rsq=sq[k, 0], rsq_wrap=sq[k, 1])
        return cur, torch.sqrt(sq[1:, 0] + sq[1:, 1])

    return run_chunks(run, bufs[0], max_iters, chunk, eps)
