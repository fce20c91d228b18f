"""The port's fused V-cycle solve (multigrid_feanet_torch/solvers/mg2.py)
against the JAX PallasHierarchyV2 in interpret mode, on the CPU.

Both sides run on the identical operator: the port's hierarchy is built
with hierarchy_from_arrays from the JAX GridHierarchy's fields and its
coarse inverse.  The bands are those of tests/test_pallas_mg2.py, for the
same reason: the element-factored plain twins and the Pallas kernels sum in
different f32 orders, which amplifies once the residual is small, so the
contract is the same cycle count (+-1 near eps), the first residual to
1e-4 relative, every history ratio within [0.8, 1.25], and the solution to
1e-3 of its scale.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from multigrid_feanet_tpu.core.problem import Problem as JProblem
from multigrid_feanet_tpu.solvers.pallas_mg2 import PallasHierarchyV2

from multigrid_feanet_torch.core.convert import hierarchy_from_arrays
from multigrid_feanet_torch.core.problem import Problem
from multigrid_feanet_torch.solvers.mg2 import HierarchyV2

CIRCLE = ("circle", (0.0, 0.0), 0.5)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _pair(n, inclusion, num_levels, direct):
    """The JAX solver and the port's, on the same hierarchy (port on CPU)."""
    jp = JProblem(n=n, inclusion=inclusion)
    jh = PallasHierarchyV2(jp, num_levels=num_levels, pallas_threshold=16,
                           rows=32, interpret=True, direct_coarse=direct)
    arrays = [dict(n=lv.n, h=lv.h, a0=lv.a0, a1=lv.a1,
                   table=np.asarray(lv.table),
                   pid=None if lv.pid is None else np.asarray(lv.pid),
                   geo=np.asarray(lv.geo), diag=np.asarray(lv.diag),
                   phase=jp.phase(lv.n))
              for lv in jh.hier.levels]
    inv = None if jh.coarse_inv is None else np.asarray(jh.coarse_inv)
    th = HierarchyV2(Problem(n=n, inclusion=inclusion), kernel_threshold=16,
                     direct_coarse=direct,
                     hier=hierarchy_from_arrays(arrays, inv, device="cpu"),
                     device="cpu")
    assert th.K == jh.K
    return jh, th


def _assert_same_solve(jres, tres, max_cycles):
    (uj, hj), (ut, ht) = jres, tres
    hj, ht = np.asarray(hj), np.asarray(ht)
    assert ut.device == torch.device("cpu") and ut.dtype == torch.float32
    assert abs(len(hj) - len(ht)) <= 1
    assert len(hj) < max_cycles and len(ht) < max_cycles  # converged, not capped
    assert abs(ht[0] - hj[0]) / hj[0] < 1e-4
    m = min(len(hj), len(ht))
    ratio = ht[:m] / hj[:m]
    assert np.all(ratio > 0.8) and np.all(ratio < 1.25), ratio
    uj = np.asarray(uj)
    scale = float(np.max(np.abs(uj)))
    assert float(np.max(np.abs(ut.numpy() - uj))) / scale < 1e-3


CASES = {
    # name: (inclusion, num_levels, direct_coarse, solve kwargs)
    "bim_rhs": (CIRCLE, 4, True, dict(eps=1e-3, max_cycles=40)),
    "bim_decay": (CIRCLE, 4, True, dict(eps=1e-5, max_cycles=60, chunk=2, decay=True)),
    "hom_decay": (None, 4, True, dict(eps=1e-5, max_cycles=60, chunk=2, decay=True)),
    "bim_bc": (CIRCLE, 4, True, dict(eps=1e-3, max_cycles=40, bc_value=0.7)),
    "bim_plain_subtree": (CIRCLE, None, False, dict(eps=1e-3, max_cycles=40)),
    "bim_v21": (CIRCLE, 4, True, dict(eps=1e-3, max_cycles=40, nu1=2, nu2=1)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_solve_matches_pallas_v2(case):
    inclusion, num_levels, direct, kw = CASES[case]
    kw = dict(kw)
    n = 64
    jh, th = _pair(n, inclusion, num_levels, direct)
    rng = np.random.default_rng(0)
    if kw.pop("decay", False):
        # the f = 0 decay protocol from a seeded random iterate
        f = np.zeros((n + 1, n + 1), np.float32)
        kw["u0"] = (150000.0 * rng.uniform(size=(n + 1, n + 1))).astype(np.float32)
    else:
        f = rng.standard_normal((n + 1, n + 1)).astype(np.float32)
    jkw = {k: jnp.asarray(v) if k == "u0" else v for k, v in kw.items()}
    jres = jh.solve(jnp.asarray(f), **jkw)
    tres = th.solve(f, **kw)
    _assert_same_solve(jres, tres, kw["max_cycles"])
    if "bc_value" in kw:
        np.testing.assert_allclose(tres[0].numpy()[0, :], kw["bc_value"], atol=1e-6)


def test_history_convention_and_one_sync_per_chunk():
    """history[j] is the residual after cycle j+1, read back once per chunk:
    chunk only changes how many extra cycles the returned u carries."""
    n = 32
    prob = Problem(n=n, inclusion=CIRCLE)
    th = HierarchyV2(prob, num_levels=3, kernel_threshold=16, device="cpu")
    f = np.random.default_rng(5).standard_normal((n + 1, n + 1)).astype(np.float32)
    u1, h1 = th.solve(f, eps=1e-3, max_cycles=40, chunk=1)
    u3, h3 = th.solve(f, eps=1e-3, max_cycles=40, chunk=3)
    np.testing.assert_array_equal(h1, h3)
    assert h1[-1] <= 1e-3 < h1[-2]
    # capped: max_cycles cycles applied, max_cycles - 1 recorded
    _, hc = th.solve(f, eps=0.0, max_cycles=5)
    assert len(hc) == 4


def test_later_slices_raise():
    """What the port refuses on purpose: solve_pcg on bf16 level storage
    (the JAX solver's bf16 PCG stalls, tests/test_torch_bf16.py); bf16
    storage itself, the cross-cycle leg and solve_pcg in f32, once refused
    here, now run (held to the JAX solver in tests/test_torch_bf16.py,
    test_torch_pswrr.py and test_torch_pcg.py)."""
    prob = Problem(n=32, inclusion=CIRCLE)
    th = HierarchyV2(prob, num_levels=3, kernel_threshold=16, device="cpu")
    f = np.random.default_rng(6).standard_normal((33, 33)).astype(np.float32)
    u, hist = th.solve(f, use_pswrr=True, eps=1e-3, max_cycles=40)
    assert hist[-1] <= 1e-3 and bool(torch.isfinite(u).all())
    u, hist = th.solve_pcg(f, eps=1e-3, max_iters=40)
    assert hist[-1] <= 1e-3 and bool(torch.isfinite(u).all())
    tb = HierarchyV2(prob, num_levels=3, kernel_threshold=16, device="cpu",
                     dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="bfloat16"):
        tb.solve_pcg(f, eps=1e-3, max_iters=40)
    with pytest.raises(ValueError, match="float16"):
        HierarchyV2(prob, num_levels=3, kernel_threshold=16, device="cpu",
                    dtype=torch.float16)
    with pytest.raises(ValueError, match="kernel_threshold"):
        HierarchyV2(prob, num_levels=3, kernel_threshold=64, device="cpu")
