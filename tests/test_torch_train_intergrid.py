"""The port's inter-grid training loop (multigrid_feanet_torch/learn/
train_intergrid.py::train) against the JAX package's train, on the CPU, at
the reference's protocol (experiments/config.py IntergridTrainConfig): the
64^2 interface problem with its default hierarchy, m = 6, m0 = 2, batch
64, Adam 1e-3, 120 right-hand sides, 10 epochs (20 steps).

The JAX run's own right-hand sides, batch order and random starts
(replayed from its keys) go through the port's objective and update; the
per-epoch q_m must be the JAX run's within 1e-4 relative.  Over these 10
epochs the q_m of both rises (the first steps of Adam from the classical
transfers raise the early-window q_m at this configuration), so the test
holds the port to JAX's trajectory and not to a falling loss.
"""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from multigrid_feanet_tpu.core.problem import GridHierarchy as JHierarchy, Problem as JProblem
from multigrid_feanet_tpu.data import rhs as jrhs
from multigrid_feanet_tpu.learn import train_intergrid as jti

from multigrid_feanet_torch.core.problem import GridHierarchy, Problem
from multigrid_feanet_torch.data import datasets
from multigrid_feanet_torch.learn import train_intergrid as ti
from multigrid_feanet_torch.ops import stencil

CIRCLE = ("circle", (0.0, 0.0), 0.5)


def test_train_matches_jax_on_its_draws():
    n, epochs, batch = 64, 10, 64
    jh = JHierarchy.create(JProblem(n=n, inclusion=CIRCLE, dtype=jnp.float32))
    th = GridHierarchy.create(Problem(n=n, inclusion=CIRCLE), device="cpu")
    F = np.asarray(jrhs.make_dataset(jax.random.PRNGKey(0), n + 1, 120), np.float32)
    jparams, jlosses = jti.train(jh, F, num_epochs=epochs, batch_size=batch, seed=0,
                                 verbose=False)
    state = ti.init_state(0, device="cpu")
    key = jti.init_state(0).key
    losses = []
    for epoch in range(epochs):
        total = []
        for Fb in datasets.batches(F, batch, shuffle=True, seed=epoch, device="cpu"):
            key, k_v = jax.random.split(key)
            v0 = torch.from_numpy(np.array(jti.random_constant_field(k_v, Fb.shape,
                                                                     jnp.float32)))
            loss = ti.qm_objective(th, state.params, stencil.apply_mass(Fb, th.finest.h), v0,
                                   6, 2)
            state = ti._update(state, loss, ti._grad_mask(state.params, None), 1e-3)
            total.append(float(loss.detach()))
        losses.append(np.mean(total))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    for k in ("conv", "deconv", "w"):
        np.testing.assert_allclose(getattr(state.params, k).detach().numpy(),
                                   np.asarray(getattr(jparams, k)), rtol=1e-4, atol=1e-6)
