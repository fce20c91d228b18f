"""The port's data modules (multigrid_feanet_torch/data/{fem,rhs,datasets}.py)
and C++ FEM oracle (multigrid_feanet_torch/oracle/) against the JAX
package's, on the CPU.

The numpy FEM and both oracles compute the same f64 arithmetic (1e-12 and
1e-10); batching and the h5 readers move the same arrays (exact).  The
right-hand sides draw from a torch.Generator where the JAX package draws
from jax.random, so their bits differ: the GRF filter is compared on the
same fed noise, and the six families by their statistics over 200 draws.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from multigrid_feanet_tpu import oracle as joracle
from multigrid_feanet_tpu.core import geometry
from multigrid_feanet_tpu.data import datasets as jds, fem as jfem, rhs as jrhs

from multigrid_feanet_torch import oracle
from multigrid_feanet_torch.core.problem import Problem, build_level
from multigrid_feanet_torch.data import datasets, fem, rhs
from multigrid_feanet_torch.ops.stencil import apply_mass
from multigrid_feanet_torch.solvers.jacobi import interior_norm

H5 = "results/isopoisson_129x129.h5"


@pytest.mark.parametrize("bim", [False, True], ids=["hom", "bim"])
def test_fem_assembly_and_solve_match_jax(bim):
    n = 8
    phase = geometry.circle_phase(2.0, n) if bim else None
    for a, b in zip(fem.assemble(n, phase=phase), jfem.assemble(n, phase=phase)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    rng = np.random.default_rng(0)
    f = rng.standard_normal((n + 1, n + 1))
    bc = rng.standard_normal((n + 1, n + 1))
    np.testing.assert_allclose(fem.solve_dirichlet(n, f, bc_value=bc, phase=phase),
                               jfem.solve_dirichlet(n, f, bc_value=bc, phase=phase),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(fem.solve_dirichlet(n, f, bc_value=0.3),
                               jfem.solve_dirichlet(n, f, bc_value=0.3), rtol=0, atol=1e-12)


def test_fem_elastic_matches_jax():
    n = 4
    phase = geometry.circle_phase(2.0, n)
    kw = dict(E=212e3, nu=0.288, phase=phase, coefficients=(1.0, 20.0))
    np.testing.assert_allclose(fem.assemble_elastic(n, **kw), jfem.assemble_elastic(n, **kw),
                               rtol=1e-12, atol=1e-9)
    f = np.random.default_rng(1).standard_normal((2, n + 1, n + 1))
    np.testing.assert_allclose(fem.solve_dirichlet_elastic(n, f, **kw),
                               jfem.solve_dirichlet_elastic(n, f, **kw), rtol=0, atol=1e-12)


def test_oracle_matches_jax_oracle():
    """The port's own build of fem_oracle.cc against the JAX package's, at
    n = 32 bi-material with a Dirichlet field."""
    n = 32
    rng = np.random.default_rng(1)
    f = rng.standard_normal((n + 1, n + 1))
    phase = geometry.circle_phase(2.0, n)
    bc = np.zeros((n + 1, n + 1))
    bc[0, :] = rng.standard_normal(n + 1)
    bc[:, -1] = rng.standard_normal(n + 1)
    u, iters, res = oracle.solve(n, f, phase=phase, bc=bc)
    ju, jiters, _ = joracle.solve(n, f, phase=phase, bc=bc)
    assert iters == jiters > 0 and res <= 1e-12
    np.testing.assert_allclose(u, ju, rtol=0, atol=1e-10)
    assert oracle.library_path().parent.name == "oracle"
    assert oracle.library_path().exists()


def test_batches_order_matches_jax():
    n = 10
    ds = datasets.IsoPoissonDataset(*(np.arange(n * 9, dtype=np.float32).reshape(n, 3, 3) + k
                                      for k in range(4)))
    jd = jds.IsoPoissonDataset(ds.u, ds.f, ds.bc_value, ds.bc_index)
    for kw in (dict(seed=3), dict(seed=4, drop_remainder=True), dict(shuffle=False)):
        got = list(datasets.batches(ds, 4, device="cpu", **kw))
        want = list(jds.batches(jd, 4, **kw))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    rd = datasets.RHSDataset(ds.u)
    for g, w in zip(datasets.batches(rd, 3, seed=1, device="cpu"),
                    jds.batches(jds.RHSDataset(ds.u), 3, seed=1)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_from_h5_matches_jax():
    got, want = datasets.IsoPoissonDataset.from_h5(H5), jds.IsoPoissonDataset.from_h5(H5)
    assert len(got) == len(want) and got.f.shape[-1] == 129
    for name in ("u", "f", "bc_value", "bc_index"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))


def test_h5_writers_round_trip_through_jax(tmp_path):
    """Files the port writes read back the same in both packages."""
    ds = datasets.generate_isopoisson(8, 2, seed=1)
    datasets.save_isopoisson(ds, tmp_path / "iso.h5")
    for back in (datasets.IsoPoissonDataset.from_h5(tmp_path / "iso.h5"),
                 jds.IsoPoissonDataset.from_h5(str(tmp_path / "iso.h5"))):
        np.testing.assert_array_equal(back.u, ds.u)
        np.testing.assert_array_equal(back.bc_value, ds.bc_value)
    train, test = np.ones((3, 5, 5), np.float32), np.zeros((2, 5, 5), np.float32)
    datasets.save_rhs(tmp_path / "rhs.h5", train, test)
    np.testing.assert_array_equal(datasets.RHSDataset.from_h5(tmp_path / "rhs.h5", "test").data,
                                  jds.RHSDataset.from_h5(str(tmp_path / "rhs.h5"), "test").data)
    pbc = datasets.generate_isopoisson_pbc(8, 2, seed=0)
    np.testing.assert_array_equal(pbc.f[:, -1], pbc.f[:, 0])  # wrapped
    np.testing.assert_array_equal(pbc.f[:, :, -1], pbc.f[:, :, 0])
    datasets.save_isopoisson_pbc(pbc, tmp_path / "pbc.h5")
    np.testing.assert_array_equal(jds.IsoPoissonPBCDataset.from_h5(str(tmp_path / "pbc.h5")).f,
                                  datasets.IsoPoissonPBCDataset.from_h5(tmp_path / "pbc.h5").f)


def test_test_poisson_dataset_reads_like_jax(tmp_path):
    import h5py

    rng = np.random.default_rng(2)
    names = ("dirich_idx", "dirich_value", "neumann_idx", "neumann_value", "material",
             "source", "solution")
    with h5py.File(tmp_path / "t.h5", "w") as h5:
        for name in names:
            h5[name] = rng.standard_normal((3, 5, 5, 1))
    got = datasets.TestPoissonDataset.from_h5(tmp_path / "t.h5")
    want = jds.TestPoissonDataset.from_h5(str(tmp_path / "t.h5"))
    assert len(got) == 3
    for name in names:
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    for a, b in zip(got[1], want[1]):
        np.testing.assert_array_equal(a, b)


def test_generate_isopoisson_solves_the_problem():
    """Dense path (n <= 64): u is the f64 partition solve of the sample's f
    and boundary field; the layout is the JAX generator's."""
    ds = datasets.generate_isopoisson(16, 3, seed=0)
    jd = jds.generate_isopoisson(16, 1, seed=0)
    for name in ("u", "f", "bc_value", "bc_index"):
        assert getattr(ds, name).shape[1:] == getattr(jd, name).shape[1:]
        assert getattr(ds, name).dtype == getattr(jd, name).dtype
    np.testing.assert_array_equal(ds.bc_index[0], jd.bc_index[0])
    assert np.all(ds.bc_value[:, 1:-1, 1:-1] == 0.0)
    np.testing.assert_allclose(np.std(ds.f, axis=(1, 2)), 1.0, rtol=1e-5)
    u = fem.solve_dirichlet(16, ds.f[1].astype(np.float64), bc_value=ds.bc_value[1])
    np.testing.assert_allclose(ds.u[1], u.astype(np.float32), rtol=0, atol=1e-6)


def test_generate_isopoisson_cg_path():
    """n > 64 takes the C++ CG oracle: the sample's u is the oracle's f64
    solve of its f and boundary ring, and that solve satisfies A u = M f at
    interior nodes (the port's f64 operator)."""
    n = 80
    ds = datasets.generate_isopoisson(n, 1, seed=2)
    f, bc = ds.f[0].astype(np.float64), ds.bc_value[0].astype(np.float64)
    u, iters, _ = oracle.solve(n, f, coefficients=(1.0, 1.0), bc=bc, tol=1e-11)
    assert iters > 0
    np.testing.assert_allclose(ds.u[0], u, rtol=0, atol=1e-5)
    lv = build_level(Problem(n=n, dtype=torch.float64), n, device="cpu")
    mf = apply_mass(torch.from_numpy(f), lv.h)
    res = float(interior_norm(mf - lv.apply(torch.from_numpy(u))))
    assert res < 1e-8 * float(interior_norm(mf))
    np.testing.assert_array_equal(ds.u[0][0], ds.bc_value[0][0])


@pytest.mark.parametrize("alpha", [3.0, 10.6])
def test_grf_filter_matches_jax_on_fed_noise(alpha):
    n = 33
    key = jax.random.PRNGKey(5)
    k1, k2 = jax.random.split(key)
    noise = np.asarray(jax.random.normal(k1, (n, n)) + 1j * jax.random.normal(k2, (n, n)))
    want = np.asarray(jrhs.gaussian_random_field(key, n, alpha))
    got = rhs.gaussian_random_field(None, n, alpha, noise=noise).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_rhs_family_statistics_match_jax():
    """Over 200 draws of each family (n = 16), the mean of the per-draw
    means and of the per-draw standard deviations agree with the JAX
    package's within 5 standard errors (+1e-5 for the normalized GRF)."""
    n, per = 16, 200
    got = rhs.make_dataset(n, per * 6, seed=0).numpy().reshape(6, per, n, n)
    want = np.asarray(jrhs.make_dataset(jax.random.PRNGKey(0), n, per * 6)).reshape(6, per, n, n)
    assert got.shape == want.shape
    for fam in range(6):
        for stat in (np.mean, np.std):
            a, b = stat(got[fam], axis=(1, 2)), stat(want[fam], axis=(1, 2))
            se = np.sqrt(a.var() / per + b.var() / per)
            assert abs(a.mean() - b.mean()) <= 5 * se + 1e-5, (fam, stat.__name__, a.mean(), b.mean())
