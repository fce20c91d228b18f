"""H-Net smoother training: the reference's HJacIterator, and error-decay
training through the H-MG V-cycle.

Port of ``multigrid_feanet_tpu/learn/train_hnet.py``.  Reference protocol
(M-FEANet-mg_test.ipynb cell 5 / learn_iterator cell 8): per batch, reset
Dirichlet data from the dataset, mass-convolve f, draw a random initial
guess u0 ~ N(0, 1), run k H-corrected Jacobi sweeps (k ~ U{1..k_max}), and
minimize the summed MSE against the dataset solution with Adadelta (torch
defaults: lr=1.0, rho=0.9, eps=1e-6).  The elastic learned iterator
(:func:`train_elastic`) follows the same protocol with the 2x2 block-Jacobi
smoother and the 2 -> 2-channel net, against the dense oracle's
displacements (``data/datasets.py::generate_elastic``); the reference
trains only the scalar family.

Training differentiates plain torch ops with autograd, as the JAX package
differentiates XLA ones: ``models/hnet.py::h_relax_dynamic`` and, in
:func:`make_decay_step`, :func:`_hjac_vcycle`, whose ``h_relax`` takes the
plain form whenever autograd records.  The no-gradient paths run kernel
E1: :func:`measure_q` on CUDA levels.  Random numbers (k and the random
starts) come from the state's CPU ``torch.Generator``, drawn on the host and
moved to the level's device, so the card and the CPU draw the same ones;
they are not the JAX package's ``jax.random`` numbers.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from multigrid_feanet_torch.core.convert import (hnet_elastic_params_from_arrays,
                                                 hnet_params_from_arrays)
from multigrid_feanet_torch.core.device import full_f32
from multigrid_feanet_torch.core.problem import Level
from multigrid_feanet_torch.data import datasets
from multigrid_feanet_torch.models import hnet
from multigrid_feanet_torch.ops import stencil
from multigrid_feanet_torch.ops.transfer import prolong_bilinear, restrict_full_weighting
from multigrid_feanet_torch.solvers.jacobi import interior_norm, jacobi_step
from multigrid_feanet_torch.solvers.multigrid import v_cycle
from multigrid_feanet_torch.utils import checkpoint


class TrainState(NamedTuple):
    """The (L, 3, 3) kernels (a leaf that requires grad), the optimizer
    that updates them in place, and the generator of the random draws."""

    params: torch.Tensor
    optimizer: torch.optim.Optimizer
    generator: torch.Generator


# the per-parameter state of each optimizer, beside its step count
_SLOTS = {torch.optim.Adadelta: ("square_avg", "acc_delta"),
          torch.optim.Adam: ("exp_avg", "exp_avg_sq")}


def make_optimizer(params: torch.Tensor) -> torch.optim.Optimizer:
    """Adadelta with the torch defaults the reference trains with."""
    return torch.optim.Adadelta([params], lr=1.0, rho=0.9, eps=1e-6)


def _state(params, optimizer_fn, seed: int, num_layers: int, device, init=hnet.init_params,
           convert=hnet_params_from_arrays) -> TrainState:
    gen = torch.Generator().manual_seed(seed)
    if params is None:
        params = init(num_layers, generator=gen)
    params = convert(params.detach().cpu() if torch.is_tensor(params) else params, device=device)
    params.requires_grad_(True)
    return TrainState(params, optimizer_fn(params), gen)


def init_state(level: Level, seed: int = 0, num_layers: int = 3, params=None) -> TrainState:
    """A fresh state on the level's device with a fresh Adadelta: kernels
    drawn from the seeded generator (``hnet.init_params``), or ``params``,
    for example a JAX ``TrainState``'s kernels as numpy.  An optax optimizer
    state does not map onto ``torch.optim``, so a JAX state carries over by
    its weights only; the port's own checkpoints (:func:`train`'s
    ``ckpt_dir``) carry its optimizer."""
    return _state(params, make_optimizer, seed, num_layers, level.device)


def state_tree(state: TrainState) -> dict:
    """The arrays of ``state`` as a tree for ``utils/checkpoint``: the
    kernels, the optimizer's step count and slots (zeros before its first
    step, which is what the optimizer starts from) and the generator's
    state."""
    opt = state.optimizer.state.get(state.params, {})
    slots = {name: opt[name].detach() if name in opt else torch.zeros_like(state.params)
             for name in _SLOTS[type(state.optimizer)]}
    step = opt.get("step", torch.tensor(0.0))
    return {"params": state.params.detach(), "slots": slots,
            "step": torch.as_tensor(step, dtype=torch.float32).cpu().reshape(()),
            "rng": state.generator.get_state()}


def load_state_tree(state: TrainState, tree: dict) -> TrainState:
    """``state`` with the arrays of ``tree`` (from :func:`state_tree`)."""
    with torch.no_grad():
        state.params.copy_(tree["params"])
    sd = state.optimizer.state_dict()
    sd["state"] = ({} if float(tree["step"]) == 0.0 else
                   {0: {"step": tree["step"].clone(), **tree["slots"]}})
    state.optimizer.load_state_dict(sd)
    state.generator.set_state(tree["rng"])
    return state


def _normal(gen: torch.Generator, shape, like: torch.Tensor) -> torch.Tensor:
    """Standard normal draws from ``gen`` (on the host) on ``like``'s device."""
    return torch.randn(shape, generator=gen).to(device=like.device, dtype=like.dtype)


def draw_start(state: TrainState, u_star, k_max: int):
    """A step's draws from the state's generator: the sweep count k ~
    U{1..k_max} and the standard normal start u0 of ``u_star``'s shape."""
    k = int(torch.randint(1, k_max + 1, (), generator=state.generator))
    return k, _normal(state.generator, u_star.shape, u_star)


def batch_loss(level: Level, params, u_star, f, bc_value, u0, k: int, k_max: int):
    """sum((u_k - u*)^2) of k H-relax sweeps from ``u0`` on the
    mass-convolved ``f``: the training loss, a sum over the batch."""
    ff = stencil.apply_mass(f, level.h)
    u_out = hnet.h_relax_dynamic(level, params, u0, ff, k, k_max, bc_value)
    return torch.sum((u_out - u_star) ** 2)


def train_step(level: Level, state: TrainState, u_star, f, bc_value, bc_index,
               k_max: int = 20):
    """One batch step -> (state, loss as a 0-d tensor).  Batch fields:
    (N, H, W).  ``bc_index`` is the reference's interior mask (1 interior /
    0 boundary); bc enters the sweeps directly, as in the JAX package."""
    del bc_index
    k, u0 = draw_start(state, u_star, k_max)
    state.optimizer.zero_grad()
    loss = batch_loss(level, state.params, u_star, f, bc_value, u0, k, k_max)
    loss.backward()
    state.optimizer.step()
    return state, loss.detach()


def init_state_elastic(level, seed: int = 0, num_layers: int = 3, params=None) -> TrainState:
    """A fresh elastic state on the ``ElasticLevel``'s device with a fresh
    Adadelta: (L, 2, 2, 3, 3) kernels drawn from the seeded generator
    (``hnet.init_params_elastic``), or ``params``."""
    return _state(params, make_optimizer, seed, num_layers, level.device,
                  hnet.init_params_elastic, hnet_elastic_params_from_arrays)


def elastic_loss(level, params, u_star, f, u0, k: int, k_max: int) -> torch.Tensor:
    """The elastic step's loss from the start ``u0`` and ``k`` sweeps:
    sum((u_k - u*)^2), the body forces ``f`` (N, 2, H, W) mass-convolved
    per component."""
    ff = stencil.apply_mass(f, level.h)
    u_out = hnet.h_relax_elastic_dynamic(level, params, u0, ff, k, k_max)
    return torch.sum((u_out - u_star) ** 2)


def train_step_elastic(level, state: TrainState, u_star, f, k_max: int = 20):
    """One batch step on an ``ElasticLevel`` -> (state, loss as a 0-d
    tensor).  ``u_star`` / ``f``: (N, 2, H, W) oracle displacements and raw
    body forces (zero Dirichlet ring); k ~ U{1..k_max} and u0 ~ N(0, 1)
    from the state's generator."""
    k = int(torch.randint(1, k_max + 1, (), generator=state.generator))
    u0 = _normal(state.generator, u_star.shape, u_star)
    state.optimizer.zero_grad()
    loss = elastic_loss(level, state.params, u_star, f, u0, k, k_max)
    with full_f32():  # the convolutions' backward
        loss.backward()
    state.optimizer.step()
    return state, loss.detach()


def elastic_eval_loss(level, params, dataset, k_max: int, seed: int = 99) -> float:
    """A fixed evaluation of elastic kernels: the sum over k = 1..k_max of
    :func:`elastic_loss` on the whole dataset, each k from its own standard
    normal start drawn from a generator seeded with ``seed``.  The training
    losses are samples (one random k and start per batch); this reads the
    learning on the same draws before and after."""
    gen = torch.Generator().manual_seed(seed)
    u_star, f = (torch.as_tensor(x, device=level.device) for x in (dataset.u, dataset.f))
    total = 0.0
    with torch.no_grad():
        for k in range(1, k_max + 1):
            u0 = _normal(gen, u_star.shape, u_star)
            total += float(elastic_loss(level, params, u_star, f, u0, k, k_max))
    return total


def _hjac_vcycle(hier, params, u, f, omega=2.0 / 3.0, h_levels=None):
    """One V(1,1) cycle with the H-relax smoother on levels < ``h_levels``
    (None = every level) and plain weighted Jacobi below: the cycle of
    ``solvers/hmg.py`` (interior-masked residual transfers, relax-only
    coarsest).  Fields may carry a leading batch dimension on the plain
    path."""
    hl = hier.num_levels if h_levels is None else h_levels

    def rel(level, u, ff):
        if level < hl:
            return hnet.h_relax(hier.levels[level], params, u, ff, 1, 0.0, omega)
        return jacobi_step(hier.levels[level], u, ff, 0.0, omega)

    def cycle(level, u, ff):
        lv = hier.levels[level]
        u = rel(level, u, ff)
        if level < hier.num_levels - 1:
            r = (ff - lv.apply(u)) * lv.geo
            f_c = 4.0 * restrict_full_weighting(r)
            u_c = cycle(level + 1, torch.zeros_like(f_c), f_c)
            u = u + prolong_bilinear(u_c, lv.geo)
        return rel(level, u, ff)

    return cycle(0, u, f)


def make_decay_step(hiers, *, m: int = 5, batch: int = 2, learning_rate: float = 3e-3,
                    warm: int = 2, h_levels=None):
    """Build (init_fn, step) for multi-size error-decay training.

    ``hiers``: GridHierarchy's of different finest n, sharing the kernels.
    Per step and size: draw ``batch`` random errors, run ``m`` V(1,1) H-MG
    cycles, loss = the mean over the last ``m - warm`` cycles of
    log(r_k / r_{k-1}) (the asymptotic-q surrogate; the first ``warm``
    cycles absorb the transient).  The step differentiates the cycles in
    plain torch with Adam; it launches no kernel.
    """

    def init_fn(seed: int = 0, num_layers: int = 3, params=None) -> TrainState:
        return _state(params, lambda p: torch.optim.Adam([p], lr=learning_rate), seed,
                      num_layers, hiers[0].device)

    def loss_fn(params, gen):
        total = 0.0
        for hier in hiers:
            lv0 = hier.finest
            H = lv0.n_nodes
            u = _normal(gen, (batch, H, H), lv0.geo) * lv0.geo
            f = torch.zeros((H, H), device=lv0.device)
            rs = [interior_norm(lv0.apply(u))]
            for _ in range(m):
                u = _hjac_vcycle(hier, params, u, f, h_levels=h_levels)
                rs.append(interior_norm(lv0.apply(u)))
            logs = torch.log(torch.stack(rs) + 1e-30)
            ratios = logs[1:] - logs[:-1]  # (m, batch) per-cycle log q
            total = total + torch.mean(ratios[warm:])
        return total / len(hiers)

    def step(state: TrainState):
        state.optimizer.zero_grad()
        loss = loss_fn(state.params, state.generator)
        loss.backward()
        state.optimizer.step()
        return state, loss.detach()

    return init_fn, step


def measure_q(hier, params, *, m: int = 10, seed: int = 0, mode="hjac",
              omega=2.0 / 3.0, h_levels=None, u0=None):
    """Asymptotic per-cycle convergence factor of the (H-)MG V(1,1) cycle on
    the f = 0 decay protocol: the geometric mean of the last 3 ratios ->
    (q, residual norms).  The start is ``u0`` (masked to the interior) or a
    standard normal draw of a generator seeded with ``seed``.  Runs without
    gradients, so on a CUDA hierarchy every H-relax (``mode="hjac"``) is one
    launch of kernel E1; ``mode="jac"`` runs the plain V(1,1) cycle."""
    lv0 = hier.finest
    H = lv0.n_nodes
    if u0 is None:
        u = _normal(torch.Generator().manual_seed(seed), (H, H), lv0.geo) * lv0.geo
    else:
        u0 = u0 if torch.is_tensor(u0) else np.array(u0, np.float32)
        u = torch.as_tensor(u0, dtype=torch.float32, device=lv0.device) * lv0.geo
    f = torch.zeros((H, H), device=lv0.device)
    rs = []
    with torch.no_grad():
        for _ in range(m):
            if mode == "hjac":
                u = _hjac_vcycle(hier, params, u, f, omega, h_levels)
            else:
                u = v_cycle(hier, u, f, 1, 1)
            rs.append(interior_norm(lv0.apply(u)))
    rs = torch.stack(rs).cpu().numpy()
    return float(np.exp(np.mean(np.diff(np.log(rs + 1e-30))[-3:]))), rs


def train(level: Level, dataset, *, num_epochs: int = 100, batch_size: int = 5,
          seed: int = 0, k_max: int = 20, log_every: int = 50, verbose: bool = True,
          ckpt_dir=None, ckpt_every: int = 1):
    """Full training loop on the level's device -> (params, per-epoch mean
    loss history).  ``ckpt_dir`` enables per-epoch checkpointing with
    automatic resume from ``{ckpt_dir}/latest.npz`` (the port's own
    checkpoints: kernels, optimizer state and generator state)."""

    def step(state, batch):
        u_star, f, bc_value, bc_index = batch
        return train_step(level, state, u_star, f, bc_value, bc_index, k_max=k_max)

    return _train_loop(level, init_state(level, seed), step, dataset, num_epochs, batch_size,
                       seed, log_every, verbose, ckpt_dir, ckpt_every)


def train_elastic(level, dataset, *, num_epochs: int = 100, batch_size: int = 5,
                  seed: int = 0, k_max: int = 20, log_every: int = 50, verbose: bool = True,
                  ckpt_dir=None, ckpt_every: int = 1):
    """The elastic training loop on the ``ElasticLevel``'s device over an
    ``ElasticDataset`` -> (params (L, 2, 2, 3, 3), per-epoch mean loss
    history), with :func:`train`'s checkpoints and resume."""

    def step(state, batch):
        u_star, f = batch
        return train_step_elastic(level, state, u_star, f, k_max=k_max)

    return _train_loop(level, init_state_elastic(level, seed), step, dataset, num_epochs,
                       batch_size, seed, log_every, verbose, ckpt_dir, ckpt_every)


def _train_loop(level, state: TrainState, step, dataset, num_epochs: int, batch_size: int,
                seed: int, log_every: int, verbose: bool, ckpt_dir, ckpt_every: int):
    """Epochs of ``step(state, batch) -> (state, loss)`` over shuffled
    batches on the level's device, with per-epoch checkpoints and resume."""
    start, losses = 0, []
    if ckpt_dir is not None:
        tree, start, losses = checkpoint.load_training(ckpt_dir, state_tree(state))
        state = load_state_tree(state, tree)
    for epoch in range(start, num_epochs):
        total, nb = 0.0, 0
        for batch in datasets.batches(dataset, batch_size, shuffle=True, seed=seed + epoch,
                                      device=level.device):
            state, loss = step(state, batch)
            total += float(loss)
            nb += 1
        losses.append(total / max(nb, 1))
        if ckpt_dir is not None and ((epoch + 1) % ckpt_every == 0
                                     or epoch == num_epochs - 1):
            checkpoint.save_training(ckpt_dir, state_tree(state), epoch + 1, losses)
        if verbose and epoch % log_every == 0:
            print(f"epoch {epoch}: loss {losses[-1]:.6f}")
    return state.params.detach(), np.asarray(losses)
