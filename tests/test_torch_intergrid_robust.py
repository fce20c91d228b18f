"""The multi-size trained inter-grid operators of results/intergrid_robust/
intergrid_robust.npz on a grid far above their training sizes (16-64):
the port's learned V-cycle against the JAX package's at 1025^2 (the
evaluator of experiments/learn_intergrid.py: f = mass(1), u0 = 0, 12
cycles), on the CPU.

Both cycles carry a growing mode at this size: the residual falls for about
six cycles and then rises.  The cycle amplifies rounding differences from
the second cycle on: the JAX package's own jitted cycle departs from its
eager one by 2% there (XLA's fusion sums in another order).  So the port
is held to the eager JAX cycle for 3 cycles (1e-4), and the tails of the
port's and the jitted JAX cycle's 12-cycle histories to the rise.
"""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from multigrid_feanet_tpu.core.problem import GridHierarchy as JHierarchy, Problem as JProblem
from multigrid_feanet_tpu.models import intergrid as ji
from multigrid_feanet_tpu.ops import stencil as jst
from multigrid_feanet_tpu.solvers.jacobi import interior_norm as j_interior_norm
from multigrid_feanet_tpu.utils import checkpoint as jckpt

from multigrid_feanet_torch.core.convert import intergrid_params_from_npz
from multigrid_feanet_torch.core.problem import GridHierarchy, Problem
from multigrid_feanet_torch.models import intergrid
from multigrid_feanet_torch.ops import stencil
from multigrid_feanet_torch.solvers.jacobi import interior_norm

CIRCLE = ("circle", (0.0, 0.0), 0.5)
ROBUST = "results/intergrid_robust/intergrid_robust.npz"


def test_robust_checkpoint_rises_at_1025_like_jax():
    n, cycles = 1024, 12
    jh = JHierarchy.create(JProblem(n=n, inclusion=CIRCLE, dtype=jnp.float32))
    jp = jckpt.load(ROBUST, like=ji.IntergridParams.init())
    jf = jst.apply_mass(jnp.ones((1, n + 1, n + 1), jnp.float32), jh.finest.h)
    jcycle = jax.jit(lambda u: ji.learned_v_cycle(jh, jp, u, jf))
    th = GridHierarchy.create(Problem(n=n, inclusion=CIRCLE), device="cpu")
    tp = intergrid_params_from_npz(ROBUST, device="cpu")
    tf = stencil.apply_mass(torch.ones((1, n + 1, n + 1)), th.finest.h)
    ju, eu, tu = jnp.zeros_like(jf), jnp.zeros_like(jf), torch.zeros_like(tf)
    jhist, ehist, thist = [], [], []
    with torch.no_grad():
        for i in range(cycles):
            ju = jcycle(ju)
            tu = intergrid.learned_v_cycle(th, tp, tu, tf)
            jhist.append(float(j_interior_norm(jf - jh.finest.apply(ju))[0]))
            thist.append(float(interior_norm(tf - th.finest.apply(tu))[0]))
            if i < 3:
                eu = ji.learned_v_cycle(jh, jp, eu, jf)
                ehist.append(float(j_interior_norm(jf - jh.finest.apply(eu))[0]))
    np.testing.assert_allclose(thist[:3], ehist, rtol=1e-4)
    for hist in (jhist, thist):
        assert np.isfinite(hist).all()
        assert hist[-1] > 2.0 * min(hist), hist
