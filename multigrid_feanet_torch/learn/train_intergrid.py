"""Learned inter-grid operator training: the reference's q_m minimisation.

Port of ``multigrid_feanet_tpu/learn/train_intergrid.py``.  Reference
protocol (MM-FEANet-interface_multigrid_rhs_kernel_split_res.ipynb cells
7-11; library form FEANet/multigrid.py:138-157):

- forward: f = mass(F) for a batch of RHS fields; v0 = a random
  constant-scaled field (coef = 10 U(2) - 5: coef0 U(H, W) + coef1); m - 1
  = 5 V-cycles without gradient, keeping the iterate after cycle m0 = 2;
  a last cycle with gradient; loss q_m = mean((|r_m| / |r_m0|)^(1/(m-m0+1)));
- optimizer: Adam(lr = 1e-3); the per-kernel curriculum trains one of the
  16 restriction / prolongation channels and freezes the rest; w = [4, 1]
  stays frozen.

The m - 1 early cycles run under ``torch.no_grad()``, which gives the
iterate and gradient of the JAX package's ``stop_gradient``.  The
curriculum is a gradient mask: masked gradients are zeros, not None, so
``torch.optim.Adam`` advances every slot as ``optax.adam`` does.  Random
starts come from the state's CPU ``torch.Generator``, drawn on the host and
moved to the hierarchy's device, so the card and the CPU draw the same
numbers; they are not the JAX package's ``jax.random`` numbers.  The loss
functions take their draws as arguments (:func:`qm_objective`), so that
they can be held against the JAX package's on the same draws.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from multigrid_feanet_torch.core.device import full_f32
from multigrid_feanet_torch.core.problem import GridHierarchy
from multigrid_feanet_torch.data import datasets
from multigrid_feanet_torch.models import intergrid
from multigrid_feanet_torch.models.intergrid import IntergridParams
from multigrid_feanet_torch.ops import stencil
from multigrid_feanet_torch.utils import checkpoint

_PARAMS = ("conv", "deconv", "w")
_SLOTS = ("exp_avg", "exp_avg_sq")


class TrainState(NamedTuple):
    """The parameters, the Adam optimizer that updates them in place, and
    the generator of the random starts."""

    params: IntergridParams
    optimizer: torch.optim.Adam
    generator: torch.Generator


def make_optimizer(params: IntergridParams, lr: float = 1e-3) -> torch.optim.Adam:
    """Adam over conv, deconv and w, in that order, with optax's defaults."""
    return torch.optim.Adam([getattr(params, k) for k in _PARAMS], lr=lr)


def init_state(seed: int = 0, num_patterns: int = 16, lr: float = 1e-3, device=None,
               params: Optional[IntergridParams] = None) -> TrainState:
    """A fresh state on ``device`` (None means CUDA): the init parameters
    (``IntergridParams.init``), or ``params``, a fresh Adam and a generator
    seeded with ``seed``."""
    if params is None:
        params = IntergridParams.init(num_patterns, device=device)
    return TrainState(params, make_optimizer(params, lr), torch.Generator().manual_seed(seed))


def state_tree(state: TrainState) -> dict:
    """The arrays of ``state`` as a tree for ``utils/checkpoint``: the
    parameters, Adam's step count and slots (zeros before its first step)
    and the generator's state."""
    params, opt = {}, {}
    for k in _PARAMS:
        p = getattr(state.params, k)
        params[k] = p.detach()
        slot = state.optimizer.state.get(p, {})
        opt[k] = {s: slot[s].detach() if s in slot else torch.zeros_like(p) for s in _SLOTS}
    first = state.optimizer.state.get(state.params.conv, {})
    step = torch.as_tensor(first.get("step", 0.0), dtype=torch.float32).cpu().reshape(())
    return {"params": params, "slots": opt, "step": step, "rng": state.generator.get_state()}


def load_state_tree(state: TrainState, tree: dict) -> TrainState:
    """``state`` with the arrays of ``tree`` (from :func:`state_tree`)."""
    with torch.no_grad():
        for k in _PARAMS:
            getattr(state.params, k).copy_(tree["params"][k])
    sd = state.optimizer.state_dict()
    sd["state"] = ({} if float(tree["step"]) == 0.0 else
                   {i: {"step": tree["step"].clone(), **tree["slots"][k]}
                    for i, k in enumerate(_PARAMS)})
    state.optimizer.load_state_dict(sd)
    state.generator.set_state(tree["rng"])
    return state


def _uniform(gen: torch.Generator, shape, like: torch.Tensor) -> torch.Tensor:
    return torch.rand(shape, generator=gen).to(device=like.device, dtype=like.dtype)


def _normal(gen: torch.Generator, shape, like: torch.Tensor) -> torch.Tensor:
    return torch.randn(shape, generator=gen).to(device=like.device, dtype=like.dtype)


def random_constant_field(gen: torch.Generator, shape, like: torch.Tensor) -> torch.Tensor:
    """coef0 * U(H, W) + coef1 with coef = 10 U(2) - 5, per sample, drawn
    from ``gen`` on the host and placed like ``like``.
    (reference: MultiGrid.random_sampling, FEANet/multigrid.py:138-143)"""
    coef = 10.0 * _uniform(gen, (shape[0], 2), like) - 5.0
    u = _uniform(gen, shape, like)
    return coef[:, 0, None, None] * u + coef[:, 1, None, None]


def _grad_mask(params: IntergridParams, train_kernel: Optional[int]) -> dict:
    """1-valued masks of the trainable parameters by name; the per-kernel
    curriculum zeroes every conv / deconv channel but ``train_kernel``; w is
    always masked (frozen)."""
    C = params.conv.shape[0]
    ch = torch.ones((C, 1, 1), dtype=params.conv.dtype, device=params.conv.device)
    if train_kernel is not None:
        ch = torch.zeros_like(ch)
        ch[train_kernel] = 1.0
    return {"conv": ch.expand_as(params.conv), "deconv": ch.expand_as(params.deconv),
            "w": torch.zeros_like(params.w)}


def qm_objective(hier: GridHierarchy, params: IntergridParams, f: torch.Tensor,
                 v0: torch.Tensor, m: int, m0: int, n_relax: int = 1) -> torch.Tensor:
    """q_m from the start ``v0``: m - 1 cycles without gradient, the
    iterate after cycle m0 kept, then one cycle with gradient."""
    u = u_m0 = v0
    with torch.no_grad():
        for i in range(m - 1):
            u = intergrid.learned_v_cycle(hier, params, u, f, n_relax)
            if i == m0 - 1:
                u_m0 = u
    u_final = intergrid.learned_v_cycle(hier, params, u, f, n_relax)
    return intergrid.qm_loss(hier, u_final, u_m0, f, m, m0)


def _update(state: TrainState, loss: torch.Tensor, mask: dict, lr: float) -> TrainState:
    """Back-propagate ``loss`` (its convolutions in full f32), mask the
    gradients (zeros, never None) and take one Adam step at ``lr``."""
    state.optimizer.zero_grad()
    with full_f32():
        loss.backward()
    with torch.no_grad():
        for k in _PARAMS:
            p = getattr(state.params, k)
            p.grad = (torch.zeros_like(p) if p.grad is None else p.grad) * mask[k]
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    state.optimizer.step()
    return state


def train_step(hier: GridHierarchy, state: TrainState, F_batch: torch.Tensor, *, m: int = 6,
               m0: int = 2, n_relax: int = 1, train_kernel: Optional[int] = None,
               train_deconv: bool = True, train_w: bool = False, lr: float = 1e-3):
    """One batch step on RHS fields ``F_batch`` (N, H, W) -> (state, loss as
    a 0-d tensor)."""
    f = stencil.apply_mass(F_batch, hier.finest.h)
    v0 = random_constant_field(state.generator, F_batch.shape, F_batch)
    loss = qm_objective(hier, state.params, f, v0, m, m0, n_relax)
    mask = _grad_mask(state.params, train_kernel)
    if not train_deconv:
        mask["deconv"] = torch.zeros_like(mask["deconv"])
    if train_w:
        mask["w"] = torch.ones_like(mask["w"])
    return _update(state, loss, mask, lr), loss.detach()


def train(hier: GridHierarchy, rhs_dataset, *, num_epochs: int = 300, batch_size: int = 64,
          seed: int = 0, m: int = 6, m0: int = 2, train_kernel: Optional[int] = None,
          lr: float = 1e-3, log_every: int = 50, verbose: bool = True,
          ckpt_dir=None, ckpt_every: int = 1, init_params: Optional[IntergridParams] = None):
    """Train the restriction / prolongation kernels on an RHS dataset on the
    hierarchy's device -> (params, per-epoch q_m history).

    ``train_kernel`` selects the reference's one-kernel-at-a-time curriculum
    (None: every channel); ``init_params`` warm-starts from an earlier
    stage (copied, not trained in place).  A homogeneous hierarchy trains
    1-channel parameters.  ``ckpt_dir`` enables per-epoch checkpoints (the
    port's own: parameters, Adam's state and the generator's) with resume
    from ``{ckpt_dir}/latest.npz``."""
    device = hier.device
    C = 16 if hier.finest.pid is not None else 1
    params = None
    if init_params is not None:
        params = IntergridParams(*(getattr(init_params, k).detach().to(device).clone()
                                   for k in _PARAMS))
    state = init_state(seed, C, lr, device, params)
    start, losses = 0, []
    if ckpt_dir is not None:
        tree, start, losses = checkpoint.load_training(ckpt_dir, state_tree(state))
        state = load_state_tree(state, tree)
    for epoch in range(start, num_epochs):
        total, nb = 0.0, 0
        for F in datasets.batches(rhs_dataset, batch_size, shuffle=True, seed=seed + epoch,
                                  device=device):
            state, loss = train_step(hier, state, F, m=m, m0=m0, train_kernel=train_kernel,
                                     lr=lr)
            total += float(loss)
            nb += 1
        losses.append(total / max(nb, 1))
        if ckpt_dir is not None and ((epoch + 1) % ckpt_every == 0
                                     or epoch == num_epochs - 1):
            checkpoint.save_training(ckpt_dir, state_tree(state), epoch + 1, losses)
        if verbose and epoch % log_every == 0:
            print(f"epoch {epoch}: q_m {losses[-1]:.5f}")
    return state.params, np.asarray(losses)


def train_step_error_decay(hier: GridHierarchy, state: TrainState, shape, *, m: int = 10,
                           m0: int = 5, n_relax: int = 1, lr: float = 1e-3):
    """f = 0 error-decay training (the reference's TwoGrid precursor:
    MM-FEANet-homo_kernel_twogrid.ipynb cells 3-8: a standard normal start,
    m = 10, m0 = 5, the q_m loss, Adam(1e-3); no RHS data).  ``shape``:
    the (N, H, W) batch shape.  Every channel trains; w is frozen."""
    f = torch.zeros(shape, device=hier.device)
    v0 = _normal(state.generator, shape, f)
    loss = qm_objective(hier, state.params, f, v0, m, m0, n_relax)
    return _update(state, loss, _grad_mask(state.params, None), lr), loss.detach()


def multisize_objective(hiers, params: IntergridParams, fs, v0s, m: int, m0: int,
                        n_relax: int = 1) -> torch.Tensor:
    """The mean of :func:`qm_objective` over the hierarchies, each with its
    own right-hand side and start."""
    total = 0.0
    for hier, f, v0 in zip(hiers, fs, v0s):
        total = total + qm_objective(hier, params, f, v0, m, m0, n_relax)
    return total / len(hiers)


def train_step_decay_multisize(hiers, state: TrainState, *, shapes, m: int = 10, m0: int = 5,
                               n_relax: int = 1, lr: float = 1e-3):
    """Multi-size f = 0 error-decay step: the q_m decay loss summed over
    several grid sizes in one update, so that modes which amplify only at
    other scales show in the loss (a single-size operator trained at
    n = 16 diverged at n = 64 in the JAX package's runs).  ``hiers`` and
    ``shapes`` (each (N, H, W)) match; every channel trains, w is frozen."""
    fs = [torch.zeros(shape, device=hier.device) for hier, shape in zip(hiers, shapes)]
    v0s = [_normal(state.generator, shape, f) for shape, f in zip(shapes, fs)]
    loss = multisize_objective(hiers, state.params, fs, v0s, m, m0, n_relax)
    return _update(state, loss, _grad_mask(state.params, None), lr), loss.detach()


def train_step_rhs_multisize(hiers, state: TrainState, F_batches, *, shapes, m: int = 10,
                             m0: int = 6, n_relax: int = 1, lr: float = 3e-4):
    """Multi-size RHS-protocol q_m step aimed at the asymptotic regime: the
    reference's step summed over several grid sizes, with the detach point
    moved to m0 = 6 of m = 10, the cycles the reference's own evaluator
    scores.  ``F_batches``: per-size RHS batches matching ``shapes``."""
    fs = [stencil.apply_mass(F, hier.finest.h) for hier, F in zip(hiers, F_batches)]
    v0s = [random_constant_field(state.generator, shape, f) for shape, f in zip(shapes, fs)]
    loss = multisize_objective(hiers, state.params, fs, v0s, m, m0, n_relax)
    return _update(state, loss, _grad_mask(state.params, None), lr), loss.detach()
