"""The port's block-BoxMG setup for the elastic system
(multigrid_feanet_torch/ops/boxmg_elastic.py and the coarse inverse of
solvers/elastic_boxmg.py) against the JAX package, on the CPU, in f64.

Both sides are plain tensor code in f64, so every function agrees with its
JAX counterpart within 1e-10 of the JAX result's largest magnitude (only
the order in which XLA and PyTorch round the same sums differs).  Each
function gets the same inputs on both sides: the JAX stencils and weights,
and fields made with numpy from a seed.  The setup's defining identities
(R = P^T, the variational identity, the block apply against the level's)
are checked on the port's own output, as tests/test_boxmg_elastic.py checks
the JAX one.  JAX's levels are computed with its own functions, each jitted
once per shape.
"""

import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from multigrid_feanet_tpu.ops import boxmg_elastic as jbe
from multigrid_feanet_tpu.solvers import elastic as jes
from multigrid_feanet_tpu.solvers import elastic_boxmg as jeb

from multigrid_feanet_torch.ops import boxmg_elastic as tbe
from multigrid_feanet_torch.ops import elasticity as tel
from multigrid_feanet_torch.solvers import elastic as tes
from multigrid_feanet_torch.solvers import elastic_boxmg as teb

E, NU = 212e3, 0.288  # Plane_Stress_modify.m:11-12
COEF = (1.0, 20.0)
INCLUSIONS = {"bim": ("circle", (0.0, 0.0), 0.5), "hom": None}
TOL = 1e-10
CASES = [(n, inc) for n in (16, 32) for inc in INCLUSIONS]

J_WEIGHTS = jax.jit(jbe.elastic_transfer_weights)
J_RAP = jax.jit(jbe.galerkin_rap_e)
J_PROLONG = jax.jit(jbe.prolong_w4_e)
J_RESTRICT = jax.jit(jbe.restrict_w4_e)
J_APPLY = jax.jit(jbe.apply_block_s9)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rel(got, want) -> float:
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want))) / max(1e-300, float(np.max(np.abs(want))))


def _t(x):
    return torch.tensor(np.asarray(x), dtype=torch.float64)


@functools.lru_cache(maxsize=None)
def _levels(n, inc):
    """The JAX and the port's f64 elastic hierarchies of one problem."""
    kw = dict(inclusion=INCLUSIONS[inc], coefficients=COEF)
    return (jes.build_elastic_hierarchy(n, E, NU, dtype=jnp.float64, **kw),
            tes.build_elastic_hierarchy(n, E, NU, dtype=torch.float64, device="cpu", **kw))


@functools.lru_cache(maxsize=None)
def _jax_setup(n, inc):
    """JAX's setup level by level, from its own jitted functions and the
    ring guard of its ``_setup_jit_e``: [(W4E_l, Sc_l+1), ...] as numpy."""
    jl, _ = _levels(n, inc)
    S = jbe.elastic_node_stencils(jl[0], jnp.float64)
    outs = []
    for l in range(len(jl) - 1):
        W4 = J_WEIGHTS(S, jl[l].geo, jl[l + 1].geo)
        Sc = J_RAP(S, W4)
        d = Sc[..., 1, 1, :, :]
        zero_ring = (jnp.abs(d).sum((-1, -2)) == 0.0)[..., None, None]
        Sc = Sc.at[..., 1, 1, :, :].set(jnp.where(zero_ring, jnp.eye(2, dtype=Sc.dtype), d))
        outs.append((np.asarray(W4), np.asarray(Sc)))
        S = Sc
    return outs


@pytest.mark.parametrize("n,inc", CASES)
def test_node_stencils_match_jax(n, inc):
    jl, tl = _levels(n, inc)
    S = tbe.elastic_node_stencils(tl[0], torch.float64)
    assert _rel(S, jbe.elastic_node_stencils(jl[0], jnp.float64)) <= TOL
    # the bitplane form is the gathered table (pattern 0's blocks if homogeneous)
    gathered = tel.pattern_block_table(tl[0].table, tl[0].pid)
    assert _rel(S, gathered.expand(S.shape)) <= 1e-12


@pytest.mark.parametrize("n,inc", CASES)
def test_transfer_weights_match_jax(n, inc):
    jl, tl = _levels(n, inc)
    S = jbe.elastic_node_stencils(jl[0], jnp.float64)
    W4 = tbe.elastic_transfer_weights(_t(S), tl[0].geo, tl[1].geo)
    assert _rel(W4, J_WEIGHTS(S, jl[0].geo, jl[1].geo)) <= TOL


@pytest.mark.parametrize("n,inc", CASES)
def test_transfers_and_apply_match_jax(n, inc):
    """prolong_w4_e, restrict_w4_e and apply_block_s9 on the same weights,
    stencils and random fields; a batch over a leading dim equals its
    members one by one."""
    W4, Sc = _jax_setup(n, inc)[0]
    S = np.asarray(jbe.elastic_node_stencils(_levels(n, inc)[0][0], jnp.float64))
    m = n // 2 + 1
    rng = np.random.default_rng(n)
    uc = rng.standard_normal((3, 2, m, m))
    r = rng.standard_normal((3, 2, n + 1, n + 1))
    P = tbe.prolong_w4_e(_t(uc), _t(W4))
    R = tbe.restrict_w4_e(_t(r), _t(W4))
    A = tbe.apply_block_s9(_t(S), _t(r))
    Ac = tbe.apply_block_s9(_t(Sc), _t(uc))
    for k in range(3):
        assert _rel(P[k], J_PROLONG(uc[k], W4)) <= TOL
        assert _rel(R[k], J_RESTRICT(r[k], W4)) <= TOL
        assert _rel(A[k], J_APPLY(S, r[k])) <= TOL
        assert _rel(Ac[k], J_APPLY(Sc, uc[k])) <= TOL
        assert torch.equal(P[k], tbe.prolong_w4_e(_t(uc[k]), _t(W4)))
        assert torch.equal(R[k], tbe.restrict_w4_e(_t(r[k]), _t(W4)))


@pytest.mark.parametrize("n,inc", CASES)
def test_galerkin_rap_matches_jax(n, inc):
    """The 18 probes as one batch, on JAX's fine stencils and weights."""
    jl, _ = _levels(n, inc)
    S = jbe.elastic_node_stencils(jl[0], jnp.float64)
    W4 = _jax_setup(n, inc)[0][0]
    Sc = tbe.galerkin_rap_e(_t(S), _t(W4))
    assert _rel(Sc, J_RAP(S, W4)) <= TOL


@pytest.mark.parametrize("n,inc", CASES)
def test_setup_matches_jax(n, inc):
    """Every level of boxmg_elastic_setup: W4E_l and the guarded Sc_l+1."""
    _, tl = _levels(n, inc)
    touts = tbe.boxmg_elastic_setup(tl)
    jouts = _jax_setup(n, inc)
    assert len(touts) == len(jouts) == len(tl) - 1
    for (tw, ts), (jw, js) in zip(touts, jouts):
        assert tw.dtype == ts.dtype == torch.float64
        assert _rel(tw, jw) <= TOL
        assert _rel(ts, js) <= TOL
    # three levels of the same hierarchy give its first two pairs
    short = tbe.boxmg_elastic_setup(tl, 3)
    assert len(short) == 2 and all(torch.equal(a, b) for p, q in zip(short, touts)
                                   for a, b in zip(p, q))


def test_inv2x2_guarded_matches_jax_on_singular_blocks():
    rng = np.random.default_rng(5)
    M = rng.standard_normal((6, 5, 2, 2))
    M[0, 0] = 0.0  # a zero ring block
    M[1, 2] = [[1.0, 2.0], [2.0, 4.0]]  # singular, nonzero
    M[3, 4] = [[1e-20, 0.0], [0.0, 1e-20]]  # det 1e-40, under the guard
    got = tbe.inv2x2_guarded(_t(M))
    assert _rel(got, jbe.inv2x2_guarded(jnp.asarray(M))) <= 1e-14
    for i, j in ((0, 0), (1, 2), (3, 4)):
        assert torch.equal(got[i, j], torch.eye(2, dtype=torch.float64))
    ok = np.ones((6, 5), bool)
    ok[0, 0] = ok[1, 2] = ok[3, 4] = False
    prod = M[ok] @ got.numpy()[ok]
    np.testing.assert_allclose(prod, np.broadcast_to(np.eye(2), prod.shape), atol=1e-9)


@pytest.mark.parametrize("inc", list(INCLUSIONS))
def test_elastic_coarse_inverse_matches_jax(inc):
    """The dense inverse of a Galerkin level (n = 8 of the n = 32
    hierarchy): f32 by default as in JAX, f64 on request."""
    Sc = _jax_setup(32, inc)[1][1]  # (9, 9, 3, 3, 2, 2)
    got = teb.elastic_coarse_inverse(Sc, 8)
    want = np.asarray(jeb.elastic_coarse_inverse(Sc, 8))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    assert _rel(got, want) <= 1e-6
    inv64 = teb.elastic_coarse_inverse(torch.tensor(Sc), 8, dtype=torch.float64)
    assert inv64.dtype == torch.float64
    assert _rel(inv64, jeb.elastic_coarse_inverse(Sc, 8, jnp.float64)) <= 1e-12


def test_block_restrict_is_exact_transpose():
    _, tl = _levels(32, "bim")
    S = tbe.elastic_node_stencils(tl[0], torch.float64)
    W4 = tbe.elastic_transfer_weights(S, tl[0].geo, tl[1].geo)
    rng = np.random.default_rng(0)
    uc, r = _t(rng.standard_normal((2, 17, 17))), _t(rng.standard_normal((2, 33, 33)))
    lhs = float(torch.sum(tbe.prolong_w4_e(uc, W4) * r))
    rhs = float(torch.sum(uc * tbe.restrict_w4_e(r, W4)))
    np.testing.assert_allclose(lhs, rhs, rtol=1e-12)


@pytest.mark.parametrize("inc", list(INCLUSIONS))
def test_block_galerkin_variational_identity(inc):
    """<A_c u_c, v_c> = <A P u_c, P v_c> at every coarse level of the setup."""
    _, tl = _levels(32, inc)
    setup = tbe.boxmg_elastic_setup(tl)
    S = tbe.elastic_node_stencils(tl[0], torch.float64)
    rng = np.random.default_rng(1)
    for W4, Sc in setup:
        m = Sc.shape[0]
        g = torch.zeros(m, m, dtype=torch.float64)
        g[1:-1, 1:-1] = 1.0  # the guarded ring rows are not R A P's
        uc, vc = (_t(rng.standard_normal((2, m, m))) * g for _ in range(2))
        lhs = float(torch.sum(tbe.apply_block_s9(Sc, uc) * vc))
        Pu, Pv = tbe.prolong_w4_e(uc, W4), tbe.prolong_w4_e(vc, W4)
        rhs = float(torch.sum(tbe.apply_block_s9(S, Pu) * Pv))
        np.testing.assert_allclose(lhs, rhs, rtol=1e-11)
        S = Sc


def test_block_apply_matches_level_apply():
    """apply_block_s9 of the bitplane stencil field equals ElasticLevel.apply
    at interior nodes."""
    _, tl = _levels(16, "bim")
    lv = tl[0]
    S = tbe.elastic_node_stencils(lv, torch.float64)
    u = _t(np.random.default_rng(2).standard_normal((2, 17, 17)))
    y1 = tbe.apply_block_s9(S, u)[:, 1:-1, 1:-1]
    y2 = lv.apply(u)[:, 1:-1, 1:-1]
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), rtol=1e-9, atol=1e-9)
