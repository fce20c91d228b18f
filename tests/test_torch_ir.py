"""Mixed-precision iterative refinement (multigrid_feanet_torch/solvers/mg.py
``solve_ir``) against the JAX ``solve_ir`` and the f64 FEM oracle, on the
CPU, on both hierarchies it takes: the round-1 ``Hierarchy`` (JAX
``PallasHierarchy``, as tests/test_pallas_mg.py runs it) and ``HierarchyV2``
(JAX ``PallasHierarchyV2``, as bench.py runs it).

Bands: the same number of outer steps, histories within 6e-2 relative (the
f32 corrections sum in other orders), u within 1e-9 of the oracle and of
the JAX iterate.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from multigrid_feanet_tpu.core.problem import GridHierarchy as JGrid
from multigrid_feanet_tpu.core.problem import Problem as JProblem
from multigrid_feanet_tpu.data import fem
from multigrid_feanet_tpu.ops import stencil as jst
from multigrid_feanet_tpu.solvers import pallas_mg as jmg

from multigrid_feanet_torch.core.convert import hierarchy_from_arrays
from multigrid_feanet_torch.solvers import mg as tmg
from multigrid_feanet_torch.solvers.mg import Hierarchy, solve_ir

from test_torch_mg2 import _pair as _v2_pair
from test_torch_mg import _arrays

CIRCLE = ("circle", (0.0, 0.0), 0.5)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _v1_pair(n, inclusion, threshold=32):
    jp = JProblem(n=n, inclusion=inclusion, dtype=jnp.float32)
    jh = JGrid.create(jp)
    ph = jmg.PallasHierarchy(jh, pallas_threshold=threshold, interpret=True)
    th = Hierarchy(hierarchy_from_arrays(_arrays(jh, jp), device="cpu"),
                   kernel_threshold=threshold, device="cpu")
    return ph, th


def _rhs(n):
    """The mass-convolved f = 1 of tests/test_pallas_mg.py and bench.py."""
    h = 2.0 / n
    return np.array(jst.apply_mass(jnp.ones((n + 1, n + 1), jnp.float32), h))


def _same_ir(jres, tres, u_ref=None):
    (uj, hj), (ut, ht) = jres, tres
    assert ut.dtype == torch.float64 and ht.dtype == np.float64
    assert len(ht) == len(hj)
    np.testing.assert_allclose(ht, np.asarray(hj), rtol=6e-2)
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), atol=1e-9)
    if u_ref is not None:
        np.testing.assert_allclose(ut.numpy(), u_ref, atol=1e-9)


def test_ir_round1_breaks_the_f32_floor():
    """On the round-1 hierarchy (tests/test_pallas_mg.py's case): far below
    the f32 V-cycle floor, at the f64 oracle."""
    n = 64
    ph, th = _v1_pair(n, None)
    f = _rhs(n)
    _, hist32 = th.solve(f, nu1=2, nu2=2, eps=1e-12, max_cycles=60)
    kw = dict(nu1=2, nu2=2, eps=1e-11, max_outer=30)
    jres = jmg.solve_ir(ph, jnp.asarray(f), **kw)
    tres = solve_ir(th, f, **kw)
    u_ref = fem.solve_dirichlet(n, np.ones((n + 1, n + 1)), coefficients=(1.0,))
    _same_ir(jres, tres, u_ref)
    assert tres[1][-1] <= 1e-11 and tres[1][-1] < hist32[-1] / 10.0


def test_ir_v2_matches_jax():
    """On HierarchyV2 with bench.py's V(1,1) and 6 cycles per correction."""
    n = 64
    jh, th = _v2_pair(n, None, None, True)
    f = _rhs(n)
    kw = dict(eps=1e-10, cycles_per_correction=6, max_outer=12)
    jres = jmg.solve_ir(jh, jnp.asarray(f), **kw)
    tres = solve_ir(th, f, **kw)
    u_ref = fem.solve_dirichlet(n, np.ones((n + 1, n + 1)), coefficients=(1.0,))
    _same_ir(jres, tres, u_ref)
    assert tres[1][-1] <= 1e-10


def test_ir_bc_value():
    """A boundary value of 0.7: the f64 iterate keeps it, and the solution
    is the oracle's partition solve with that Dirichlet data."""
    n = 64
    jh, th = _v2_pair(n, None, None, True)
    f = _rhs(n)
    kw = dict(bc_value=0.7, eps=1e-10, cycles_per_correction=6, max_outer=12)
    jres = jmg.solve_ir(jh, jnp.asarray(f), **kw)
    tres = solve_ir(th, f, **kw)
    u_ref = fem.solve_dirichlet(n, np.ones((n + 1, n + 1)), bc_value=0.7, coefficients=(1.0,))
    _same_ir(jres, tres, u_ref)
    np.testing.assert_array_equal(tres[0].numpy()[0], 0.7)


def test_ir_bimaterial_matches_jax():
    """The bi-material interface problem on the round-1 hierarchy: the f64
    twin is the f32 level's fields cast to f64, on both sides."""
    n = 32
    ph, th = _v1_pair(n, CIRCLE, threshold=16)
    f = _rhs(n)
    kw = dict(eps=1e-10, cycles_per_correction=4, max_outer=15)
    jres = jmg.solve_ir(ph, jnp.asarray(f), **kw)
    tres = solve_ir(th, f, **kw)
    _same_ir(jres, tres)
    assert tres[1][-1] <= 1e-10
    assert th._ir_lv64.pid is th.hier.finest.pid  # the twin shares the pattern ids


def test_ir_max_outer_cap_skips_the_wasted_correction(monkeypatch):
    """At max_outer the JAX loop solves one more correction and throws it
    away; the port returns the same u and history after max_outer - 1
    correction solves, and builds the f64 twin once per hierarchy."""
    n = 64
    jh, th = _v2_pair(n, None, None, True)
    f = _rhs(n)
    kw = dict(eps=0.0, cycles_per_correction=2, max_outer=3)
    uj, hj = jmg.solve_ir(jh, jnp.asarray(f), **kw)
    calls = []
    solve = th.solve
    monkeypatch.setattr(th, "solve", lambda *a, **k: calls.append(k) or solve(*a, **k))
    ut, ht = solve_ir(th, f, **kw)
    assert len(calls) == 2 and len(ht) == len(hj) == 3
    assert all(c["max_cycles"] == 2 and c["eps"] == 0.0 for c in calls)
    np.testing.assert_allclose(ht, np.asarray(hj), rtol=6e-2)
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), atol=1e-9)
    twin = th._ir_lv64
    solve_ir(th, f, eps=0.0, max_outer=1)
    assert th._ir_lv64 is twin and len(calls) == 2
    assert tmg._f64_twin(th) is twin
