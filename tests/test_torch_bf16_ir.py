"""``solve_ir`` with bf16 corrections takes the JAX solver's outer steps at
n = 128, 256 and 512, on the CPU: the port's ``HierarchyV2(dtype=torch.bfloat16)`` (plain
versions of A1-A6) beside the JAX ``PallasHierarchyV2(dtype=jnp.bfloat16)``
(Pallas kernels in interpret mode), and both in f32.

The configuration is the ``ir_4097`` cell's cut in size: the homogeneous
operator, the coarsest level at n = 16, kernel threshold 32,
f = apply_mass(1, h), V(1,1), 6 cycles per correction, eps 1e-6.  bf16
storage needs more corrections than f32 in both packages (4, 4 and 5
against 2 at n = 128, 256 and 512): its first correction lifts the f64
residual above the starting one, by more as n grows, so the many
corrections of ``ir_4097_bf16`` are the reference's behaviour, not the
port's.  Tolerances: the outer steps equal; the starting residual to 1e-6;
the first bf16 correction's within 1e-3, as ``test_torch_bf16.py`` holds
it at n = 64 (later ones part by bf16 rounding flips, 1-2% at n = 256 and
512); the first f32 correction's, at the f32 floor, within 1%; the final
f64 residual <= eps.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from multigrid_feanet_tpu.core.problem import Problem as JProblem
from multigrid_feanet_tpu.ops import stencil as jst
from multigrid_feanet_tpu.solvers import pallas_mg as jmg
from multigrid_feanet_tpu.solvers.pallas_mg2 import PallasHierarchyV2

from multigrid_feanet_torch.core.convert import hierarchy_from_arrays
from multigrid_feanet_torch.core.problem import Problem
from multigrid_feanet_torch.solvers.mg import solve_ir
from multigrid_feanet_torch.solvers.mg2 import HierarchyV2

R = 32  # PallasLevel row block


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _solver_pair(n, dtype):
    """PallasHierarchyV2 and HierarchyV2 on the same homogeneous hierarchy:
    levels down to n = 16, kernel threshold 32, direct coarse solve, level
    storage ``dtype``."""
    jp = JProblem(n=n)
    jh = PallasHierarchyV2(jp, num_levels=int(np.log2(n)) - 3, pallas_threshold=32, rows=R,
                           rows_coarse=R, interpret=True,
                           dtype=jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    arrays = [dict(n=lv.n, h=lv.h, a0=lv.a0, a1=lv.a1, table=np.asarray(lv.table),
                   pid=None if lv.pid is None else np.asarray(lv.pid),
                   geo=np.asarray(lv.geo), diag=np.asarray(lv.diag), phase=jp.phase(lv.n))
              for lv in jh.hier.levels]
    th = HierarchyV2(Problem(n=n), kernel_threshold=32,
                     hier=hierarchy_from_arrays(arrays, np.asarray(jh.coarse_inv), device="cpu"),
                     dtype=dtype, device="cpu")
    return jh, th


# the corrections (outer steps - 1) both packages take: bf16 storage's grow
# with n, f32's stay at 2
CORRECTIONS = {(128, "bf16"): 4, (256, "bf16"): 4, (512, "bf16"): 5,
               (128, "f32"): 2, (256, "f32"): 2, (512, "f32"): 2}


@pytest.mark.parametrize("n", [128, 256, 512])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_solve_ir_takes_the_jax_outer_steps(n, dtype):
    eps = 1e-6
    jh, th = _solver_pair(n, dtype)
    assert th.K == jh.K == int(np.log2(n)) - 4  # levels n ... 32 fused, 16 the direct solve
    f = np.array(jst.apply_mass(jnp.ones((n + 1, n + 1), jnp.float32), 2.0 / n))
    kw = dict(eps=eps, cycles_per_correction=6, max_outer=20)
    uj, hj = jmg.solve_ir(jh, jnp.asarray(f), **kw)
    ut, ht = solve_ir(th, f, **kw)
    hj = np.asarray(hj)
    assert len(ht) == len(hj) and ht[-1] <= eps and hj[-1] <= eps
    name = "bf16" if dtype == torch.bfloat16 else "f32"
    assert len(ht) - 1 == CORRECTIONS[(n, name)]
    np.testing.assert_allclose(ht[0], hj[0], rtol=1e-6)
    if dtype == torch.bfloat16:
        # the first bf16 correction lifts the residual in both packages
        assert ht[1] > ht[0] and hj[1] > hj[0]
        np.testing.assert_allclose(ht[1], hj[1], rtol=1e-3)
    else:
        # one f32 correction reaches the f32 residual floor (~1e-4 of the
        # start), where the two packages' sums part by up to ~0.5%
        np.testing.assert_allclose(ht[1], hj[1], rtol=1e-2)
