"""H-Net learned smoother: a chain of masked 3x3 convolutions correcting the
weighted-Jacobi increment.

Port of the scalar H-Net of ``multigrid_feanet_tpu/models/hnet.py``:

    H(x)    = ((x * K1) . geo) * K2) . geo ... * KL) . geo   (no bias, no
              nonlinearity: H is linear)
    HRelax:  jac = Jacobi(u);  u <- jac + H(jac - u)

Parameters are an (L, 3, 3) float32 tensor, the layout of the JAX package
and of the fused kernels (``ops/hrelax.py``).  :class:`HNet` holds the same
kernels as bias-free 1->1 ``Conv2d`` layers named ``convLayers.{i}``, the
names of the reference's ``.pth`` state dicts, which therefore load with
``load_state_dict``.  The convolutions here are shift-and-add sums in the
JAX package's order, never cuDNN (which runs float32 convolutions in TF32
by default).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from multigrid_feanet_torch.core.problem import Level
from multigrid_feanet_torch.ops import hrelax as hx
from multigrid_feanet_torch.solvers.jacobi import DEFAULT_OMEGA, jacobi_step


def init_params(num_layers: int = 3, scale: Optional[float] = None,
                generator: Optional[torch.Generator] = None,
                dtype=torch.float32) -> torch.Tensor:
    """(L, 3, 3) conv kernels, torch Conv2d default init: U(-b, b) with
    b = 1/sqrt(fan_in) = 1/3 for a 1->1 3x3 conv.  Draws from ``generator``
    (a seeded CPU ``torch.Generator``); its numbers are not those of the JAX
    package's ``jax.random`` from the same seed."""
    bound = scale if scale is not None else 1.0 / 3.0
    u = torch.rand((num_layers, 3, 3), generator=generator, dtype=dtype)
    return (2.0 * u - 1.0) * bound


def conv3x3(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Cross-correlation with a single 3x3 kernel, zero padding (torch
    Conv2d semantics): out[i,j] = sum_ab k[a,b] x[i+a-1, j+b-1]."""
    H, W = x.shape[-2:]
    xp = F.pad(x, (1, 1, 1, 1))
    out = None
    for a in range(3):
        for b in range(3):
            t = k[a, b] * xp[..., a : a + H, b : b + W]
            out = t if out is None else out + t
    return out


def apply_hnet(params: torch.Tensor, x: torch.Tensor, geo: torch.Tensor) -> torch.Tensor:
    """H(x): chain of geo-masked 3x3 convs."""
    for i in range(params.shape[0]):
        x = conv3x3(x, params[i]) * geo
    return x


def _records_grad(*xs) -> bool:
    """Whether autograd records through any tensor of ``xs``."""
    return torch.is_grad_enabled() and any(torch.is_tensor(x) and x.requires_grad for x in xs)


def _h_relax_plain(level: Level, params, u, f, num_sweeps: int, bc_value, omega: float):
    """``num_sweeps`` sweeps of the JAX package's form, in torch ops."""
    for _ in range(num_sweeps):
        jac_it = jacobi_step(level, u, f, bc_value, omega)
        u = jac_it + apply_hnet(params, jac_it - u, level.geo)
    return u


def _h_relax_e1(level: Level, params, u, f, num_sweeps: int, bc_value, omega: float):
    """``num_sweeps`` launches of kernel E1 (``ops/hrelax.py``) on the
    level's operator in plain form, each resetting the ring to
    ``bc_value`` first, as ``jacobi_step`` does."""
    if level.base is not None or (level.pid is not None and level.a0 is None):
        raise ValueError("kernel E1 runs the homogeneous or two-phase stiffness operator, "
                         "not a phase-affine or general-table level")
    bim = level.phase is not None
    a0 = float(level.a0) if bim else 1.0  # homogeneous levels are the a = 1 operator
    da = float(level.a1) - a0 if bim else 0.0
    bc = bc_value
    if torch.is_tensor(bc):
        bc = (float(bc) if bc.numel() == 1 else
              torch.broadcast_to(bc.to(u.dtype), u.shape).contiguous())
    workspace = {}
    for _ in range(num_sweeps):
        u, _ = hx.hrelax_cuda(u, f, level.phase, params, a0=a0, da=da, omega=omega, dform=False,
                              bc=bc, workspace=workspace)
    return u


def h_relax(level: Level, params: torch.Tensor, u: torch.Tensor, f: torch.Tensor,
            num_sweeps: int, bc_value=0.0, omega: float = DEFAULT_OMEGA) -> torch.Tensor:
    """``num_sweeps`` H-corrected Jacobi sweeps.

    The form is chosen by the need for a gradient, not by any failure: on
    CUDA tensors through which autograd does not record (no ``requires_grad``
    on ``params``, ``u``, ``f`` or a tensor ``bc_value``, or grad mode off),
    each sweep is one launch of kernel E1 (``ops/hrelax.py``), at every
    level and any even n >= 2, with the (n+1, n+1) float32 fields and
    (L, 3, 3) float32 kernels it takes (L = 1 or 3).  Otherwise (CPU
    tensors, or a graph to differentiate, as
    ``learn/train_hnet.py::make_decay_step`` builds) the JAX package's form
    runs in torch ops; E1 has no backward pass, as the Pallas kernel had
    none.  Both give the JAX package's answer: E1 resets u's
    ring to ``bc_value`` and feeds the ring increment bc - u to the chain."""
    if u.is_cuda and not _records_grad(params, u, f, bc_value):
        return _h_relax_e1(level, params, u, f, num_sweeps, bc_value, omega)
    return _h_relax_plain(level, params, u, f, num_sweeps, bc_value, omega)


def h_relax_dynamic(level: Level, params: torch.Tensor, u: torch.Tensor, f: torch.Tensor,
                    num_sweeps, max_sweeps: int, bc_value=0.0,
                    omega: float = DEFAULT_OMEGA) -> torch.Tensor:
    """The training form of :func:`h_relax`: ``min(num_sweeps, max_sweeps)``
    sweeps in plain torch, always, so that autograd differentiates them.
    The JAX package runs ``max_sweeps`` steps with the updates masked beyond
    ``num_sweeps`` (a traced count); the iterate and its gradient are the
    same."""
    return _h_relax_plain(level, params, u, f, min(int(num_sweeps), int(max_sweeps)), bc_value,
                          omega)


def compose_kernels(params: torch.Tensor) -> torch.Tensor:
    """Compose the L chained 3x3 kernels into one (2L+1)^2 kernel (valid away
    from boundaries): the reference's kernel-composition analysis."""
    L = params.shape[0]
    acc = np.zeros((2 * L + 1, 2 * L + 1))
    acc[L, L] = 1.0
    acc = torch.as_tensor(acc, dtype=params.dtype, device=params.device)
    for i in range(L):
        acc = conv3x3(acc, params[i])
    return acc


class HNet(nn.Module):
    """The H-Net as a module: ``num_layers`` bias-free 1->1 3x3 ``Conv2d``
    layers ``convLayers.{i}`` (state-dict keys ``convLayers.{i}.weight``
    of shape (1, 1, 3, 3), the reference's), initialised as Conv2d does."""

    def __init__(self, num_layers: int = 3):
        super().__init__()
        self.convLayers = nn.ModuleList(
            nn.Conv2d(1, 1, 3, padding=1, bias=False) for _ in range(num_layers))

    def _stacked(self) -> torch.Tensor:
        return torch.stack([conv.weight[0, 0] for conv in self.convLayers])

    def kernels(self) -> torch.Tensor:
        """The (L, 3, 3) float32 kernels the fused legs take, detached and
        contiguous on the module's device."""
        return self._stacked().detach().to(torch.float32).contiguous()

    def forward(self, x: torch.Tensor, geo: torch.Tensor) -> torch.Tensor:
        """H(x) of :func:`apply_hnet`, differentiable in the weights."""
        return apply_hnet(self._stacked(), x, geo)
