"""The port's elasticity operator, plain elastic multigrid pieces and elastic
coarse solve against the JAX package, on the CPU, in f64.

Covers multigrid_feanet_torch/ops/elasticity.py, the elastic half of
solvers/coarse.py, the plain forms of solvers/elastic.py (levels, relax,
v_cycle) and core/convert.py::elastic_hierarchy_from_arrays.  Inputs are
made with numpy from a seed and handed to both sides.  Everything here is
the same arithmetic in f64 on both sides, so the tolerance is 1e-12
relative to the reference's scale (1e-10 where a dense inverse enters).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from multigrid_feanet_tpu.ops import elasticity as jel
from multigrid_feanet_tpu.ops import stencil as jst
from multigrid_feanet_tpu.solvers import coarse as jco
from multigrid_feanet_tpu.solvers import elastic as jes

from multigrid_feanet_torch.core.convert import elastic_hierarchy_from_arrays
from multigrid_feanet_torch.ops import elasticity as tel
from multigrid_feanet_torch.solvers import coarse as tco
from multigrid_feanet_torch.solvers import elastic as tes

E, NU = 212e3, 0.288  # Plane_Stress_modify.m:11-12
COEF = (1.0, 20.0)
CIRCLE = ("circle", (0.0, 0.0), 0.5)
PLANES = ["stress", "strain"]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rel(got, want):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    return float(np.max(np.abs(got - want))) / max(1e-300, float(np.max(np.abs(want))))


def _inputs(n, bim, seed=0):
    """A random asymmetric phase map (or None), its pattern ids, and two
    displacement fields whose components differ."""
    rng = np.random.default_rng(seed)
    phase = (rng.random((n, n)) < 0.4).astype(np.int8) if bim else None
    pid = None if phase is None else jst.pattern_ids_np(phase)
    u = rng.standard_normal((2, n + 1, n + 1)) * np.array([1.0, 3.0])[:, None, None]
    f = rng.standard_normal((2, n + 1, n + 1))
    return phase, pid, u, f


def _t(x, dtype=torch.float64):
    return None if x is None else torch.tensor(np.array(x), dtype=dtype)


@pytest.mark.parametrize("plane", PLANES)
def test_element_stiffness_and_constants(plane):
    np.testing.assert_array_equal(tel.elasticity_d_matrix(E, NU, plane),
                                  jel.elasticity_d_matrix(E, NU, plane))
    np.testing.assert_array_equal(tel.element_stiffness_elastic(E, NU, 0.25, plane),
                                  jel.element_stiffness_elastic(E, NU, 0.25, plane))
    np.testing.assert_array_equal(tel.elastic_factor_constants(E, NU, plane),
                                  [float(c) for c in jel.elastic_factor_constants(E, NU, plane)])
    for got, want in zip(tel.unit_block_taps(E, NU, plane), jel.unit_block_taps(E, NU, plane)):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        tel.elasticity_d_matrix(E, NU, "shell")


@pytest.mark.parametrize("plane", PLANES)
def test_stencil_table(plane):
    got = tel.make_elastic_stencil_table(E, NU, 1.0 / 16, COEF, plane, dtype=torch.float64)
    want = jel.make_elastic_stencil_table(E, NU, 1.0 / 16, COEF, plane, dtype=jnp.float64)
    assert got.shape == (16, 3, 3, 2, 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # f32 tables round identically
    np.testing.assert_array_equal(
        tel.make_elastic_stencil_table(E, NU, 0.5, COEF, plane).numpy(),
        np.asarray(jel.make_elastic_stencil_table(E, NU, 0.5, COEF, plane)))


@pytest.mark.parametrize("bim", [False, True], ids=["hom", "bim"])
def test_blocks_and_inverse(bim):
    n = 24
    _, pid, _, _ = _inputs(n, bim)
    jt = jel.make_elastic_stencil_table(E, NU, 0.1, COEF, dtype=jnp.float64)
    tt = _t(jt)
    jpid, tpid = (None, None) if pid is None else (jnp.asarray(pid), _t(pid, torch.int8))
    assert _rel(tel.pattern_block_table(tt, tpid), jel.pattern_block_table(jt, jpid)) == 0.0
    shape = (n + 1, n + 1)
    db_t = tel.block_diagonal(tt, tpid, shape)
    db_j = jel.block_diagonal(jt, jpid, shape)
    assert _rel(db_t, db_j) == 0.0
    assert _rel(tel.invert_2x2(db_t), jel.invert_2x2(db_j)) < 1e-12


@pytest.mark.parametrize("plane", PLANES)
@pytest.mark.parametrize("bim", [False, True], ids=["hom", "bim"])
def test_applies_match_jax(bim, plane):
    """The general, factored and bitplane applies against JAX's, and against
    each other."""
    n = 32
    phase, pid, u, _ = _inputs(n, bim, seed=1)
    jt = jel.make_elastic_stencil_table(E, NU, 2.0 / n, COEF, plane, dtype=jnp.float64)
    jpid = None if pid is None else jnp.asarray(pid)
    want = jel.apply_elastic_stencil(jt, jpid, jnp.asarray(u))
    got = tel.apply_elastic_stencil(_t(jt), _t(pid, torch.int8), _t(u))
    assert _rel(got, want) < 1e-12
    fac = tel.apply_elastic_factored(phase, _t(u), E, NU, *COEF, plane)
    assert _rel(fac, jel.apply_elastic_factored(phase, jnp.asarray(u), E, NU, *COEF, plane)) < 1e-12
    assert _rel(fac, want) < 1e-12
    if bim:
        bit = tel.apply_elastic_bitplane(_t(pid, torch.int8), _t(u), E, NU, *COEF, plane)
        assert _rel(bit, jel.apply_elastic_bitplane(jpid, jnp.asarray(u), E, NU, *COEF,
                                                    plane)) < 1e-12
        assert _rel(bit, want) < 1e-12


def test_q_corners():
    n = 24
    phase, _, _, _ = _inputs(n, True, seed=2)
    for ph in (None, phase):
        got = tel.elastic_q_corners(ph, (n + 1, n + 1), 1.0, 20.0, torch.float64)
        want = jel.elastic_q_corners(ph, (n + 1, n + 1), 1.0, 20.0, jnp.float64)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("bim", [False, True], ids=["hom", "bim"])
def test_jacobi_step_and_norm(bim):
    n = 32
    _, pid, u, f = _inputs(n, bim, seed=3)
    jt = jel.make_elastic_stencil_table(E, NU, 2.0 / n, COEF, dtype=jnp.float64)
    jpid = None if pid is None else jnp.asarray(pid)
    dinv = jel.invert_2x2(jel.block_diagonal(jt, jpid, (n + 1, n + 1)))
    geo = np.zeros((n + 1, n + 1))
    geo[1:-1, 1:-1] = 1.0
    want = jel.jacobi_step_elastic(jt, jpid, dinv, jnp.asarray(geo), jnp.asarray(u),
                                   jnp.asarray(f), bc_value=0.7)
    got = tel.jacobi_step_elastic(_t(jt), _t(pid, torch.int8), _t(dinv), _t(geo), _t(u), _t(f),
                                  bc_value=0.7)
    assert _rel(got, want) < 1e-12
    np.testing.assert_allclose(float(tel.elastic_interior_norm(_t(f))),
                               float(jel.elastic_interior_norm(jnp.asarray(f))), rtol=1e-14)


def _jax_fields(lv, size=2.0, inclusion=None):
    """The mapping elastic_hierarchy_from_arrays takes, from a JAX level."""
    phase = None
    if inclusion is not None:
        from multigrid_feanet_tpu.core import geometry
        phase = geometry.circle_phase(size, lv.n, inclusion[1], inclusion[2])
    return dict(n=lv.n, h=lv.h, E=lv.E, nu=lv.nu, plane=lv.plane, a0=lv.a0, a1=lv.a1,
                table=np.asarray(lv.table), pid=None if lv.pid is None else np.asarray(lv.pid),
                geo=np.asarray(lv.geo), dinv=np.asarray(lv.dinv), phase=phase)


@pytest.mark.parametrize("plane", PLANES)
@pytest.mark.parametrize("inclusion", [None, CIRCLE], ids=["hom", "circle"])
def test_build_hierarchy_and_from_arrays(inclusion, plane):
    """build_elastic_hierarchy gives JAX's level fields; the fields carried
    over by elastic_hierarchy_from_arrays are the same levels."""
    n = 32
    jl = jes.build_elastic_hierarchy(n, E, NU, 2.0, inclusion, COEF, plane, dtype=jnp.float32)
    tl = tes.build_elastic_hierarchy(n, E, NU, 2.0, inclusion, COEF, plane, device="cpu")
    carried = elastic_hierarchy_from_arrays([_jax_fields(lv, 2.0, inclusion) for lv in jl],
                                            device="cpu")
    assert len(jl) == len(tl) == len(carried.levels) == 5
    for j, t, c in zip(jl, tl, carried.levels):
        assert (t.n, t.h, t.E, t.nu, t.plane, t.a0, t.a1) == (j.n, j.h, j.E, j.nu, j.plane,
                                                              j.a0, j.a1)
        for name in ("table", "geo", "dinv"):
            want = np.asarray(getattr(j, name))
            np.testing.assert_array_equal(getattr(t, name).numpy(), want)
            np.testing.assert_array_equal(getattr(c, name).numpy(), want)
            assert getattr(t, name).dtype == getattr(c, name).dtype == torch.float32
        if inclusion is None:
            assert t.pid is None and t.phase is None and c.pid is None and c.phase is None
        else:
            np.testing.assert_array_equal(t.pid.numpy(), np.asarray(j.pid))
            np.testing.assert_array_equal(c.phase.numpy(), t.phase.numpy())
            assert t.phase.shape == (t.n, t.n) and t.phase.dtype == torch.int8
        assert c.device == torch.device("cpu")


@pytest.mark.parametrize("inclusion", [None, CIRCLE], ids=["hom", "circle"])
def test_relax_and_v_cycle(inclusion):
    n = 32
    jl = jes.build_elastic_hierarchy(n, E, NU, 2.0, inclusion, COEF, dtype=jnp.float64)
    tl = tes.build_elastic_hierarchy(n, E, NU, 2.0, inclusion, COEF, dtype=torch.float64,
                                     device="cpu")
    _, _, u, f = _inputs(n, False, seed=4)
    want = jes.relax(jl[0], jnp.asarray(u), jnp.asarray(f), 2, bc_value=0.3)
    assert _rel(tes.relax(tl[0], _t(u), _t(f), 2, bc_value=0.3), want) < 1e-12
    want = jes.v_cycle(jl, jnp.asarray(u), jnp.asarray(f), 2, 1, bc_value=0.3)
    assert _rel(tes.v_cycle(tl, _t(u), _t(f), 2, 1, bc_value=0.3), want) < 1e-12


@pytest.mark.parametrize("inclusion", [None, CIRCLE], ids=["hom", "circle"])
def test_coarse_inverse_and_solve(inclusion):
    """The dense interior operator, its inverse and the direct solve at the
    n = 8 truncation point of the 2049^2 cells (98 unknowns)."""
    jl = jes.build_elastic_hierarchy(8, E, NU, 2.0 / 256, inclusion, COEF, dtype=jnp.float64)
    tl = tes.build_elastic_hierarchy(8, E, NU, 2.0 / 256, inclusion, COEF, dtype=torch.float64,
                                     device="cpu")
    A = tco.dense_interior_matrix_elastic(tl[0])
    np.testing.assert_array_equal(A, jco.dense_interior_matrix_elastic(jl[0]))
    assert A.shape == (98, 98)
    inv_j = jco.coarse_inverse_elastic(jl[0], dtype=jnp.float64)
    inv_t = tco.coarse_inverse_elastic(tl[0])
    assert inv_t.dtype == torch.float64
    assert _rel(inv_t, inv_j) < 1e-10
    _, _, _, f = _inputs(8, False, seed=5)
    u = tco.coarse_solve_elastic(inv_t, _t(f))
    assert _rel(u, jco.coarse_solve_elastic(inv_j, jnp.asarray(f))) < 1e-10
    # u solves the interior equations and is zero on the boundary
    r = (_t(f) - tl[0].apply(u))[:, 1:-1, 1:-1]
    assert float(r.abs().max()) < 1e-8 * float(_t(f).abs().max())
    assert float(u[:, 0].abs().max()) == 0.0
    with pytest.raises(ValueError, match="n=8"):
        tco.coarse_solve_elastic(inv_t, torch.zeros(2, 17, 17, dtype=torch.float64))


def test_coarse_inverse_warns_like_jax():
    """Above 4096 interior unknowns the inverse warns, as the JAX one does."""
    tl = tes.build_elastic_hierarchy(48, E, NU, 2.0, None, COEF, num_levels=1, device="cpu")
    with pytest.warns(UserWarning, match="small truncation"):
        tco.coarse_inverse_elastic(tl[0], dtype=torch.float64)
