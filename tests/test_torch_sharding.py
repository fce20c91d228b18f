"""``parallel/sharding.py`` on 4 gloo ranks on the CPU: the six tests of
tests/test_sharding.py, each against the JAX function on the same numpy
inputs (JAX on the conftest's virtual CPU devices).

Two spawns of 4 ranks, one thread each: the ("dp", "x", "y") meshes (1, 2, 2)
and (2, 1, 2).  The first runs the block-partitioned apply, the
``DistributedHierarchy`` solve and both explicit-halo Jacobi steps; the
second the data-parallel H-Net step.  Tolerances are the JAX tests': the
apply 1e-5 on the interior, the solve the same cycle count and u within
1e-3 / 1e-5, the explicit-halo step 1e-5, the overlapped step within
1e-6 / 5e-7 of the synchronous one; the H-Net step's new parameters within
1e-6 of ``train_step`` on the whole batch (a sum over the batch: the shares'
gradients add up to the whole batch's).  JAX is imported only where the
references are built.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from multigrid_feanet_torch.core.problem import GridHierarchy, Problem, build_level
from multigrid_feanet_torch.learn import train_hnet
from multigrid_feanet_torch.ops.stencil import apply_mass
from multigrid_feanet_torch.parallel import sharding
from test_torch_shard_solve import spawn_ranks

N = 64
CIRCLE = ("circle", (0.0, 0.0), 0.5)
HP = 66  # the padded level-0 buffer of the explicit-halo steps: 2 x 2 blocks of 33
B = 4  # the H-Net batch


def _fields(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(2)]


def _padded(seed, pid):
    """(u, f, pid) on the (HP, HP) zero-padded layout."""
    u, f = (np.zeros((HP, HP), np.float32) for _ in range(2))
    u[: N + 1, : N + 1], f[: N + 1, : N + 1] = _fields(seed, (N + 1, N + 1))
    p = np.zeros((HP, HP), np.int8)
    if pid is not None:
        p[: N + 1, : N + 1] = pid
    return u, f, p


def _rank(rank, world, rdv, out_dir, dp, pid):
    torch.set_num_threads(1)
    sharding.init_distributed(f"file://{rdv}", world, rank, device="cpu")
    try:
        mesh = sharding.make_mesh(dp=dp, device="cpu")
        res = dict(shape=tuple(mesh.mesh.shape), names=mesh.mesh_dim_names)
        bim_level = build_level(Problem(n=N, inclusion=CIRCLE), N, device="cpu")
        if dp == 1:
            hier = GridHierarchy.create(Problem(n=N, inclusion=CIRCLE), device="cpu")
            dh = sharding.DistributedHierarchy(hier, mesh, replicate_below=17)
            u = torch.as_tensor(_fields(0, (N + 1, N + 1))[0])
            res["apply"] = dh.unblock(0, dh.apply(0, dh.block(0, u)))
            dh = sharding.DistributedHierarchy(hier, mesh, replicate_below=33)
            f = apply_mass(torch.ones((N + 1, N + 1)), hier.finest.h)
            res["solve"] = dh.solve(f, nu1=1, nu2=1, eps=5e-5)
            res["S"] = dh.S
            gx, gy = rank // 2, rank % 2  # this rank's block of the (1, 2, 2) mesh
            blk = (slice(gx * HP // 2, (gx + 1) * HP // 2), slice(gy * HP // 2, (gy + 1) * HP // 2))
            for bim in (False, True):
                a0, a1 = (bim_level.a0, bim_level.a1) if bim else (1.0, None)
                u, f, p = (torch.as_tensor(x[blk]) for x in _padded(1 if bim else 0,
                                                                    pid if bim else None))
                for name, make in (("sync", sharding.shardmap_jacobi_step),
                                   ("overlap", sharding.shardmap_jacobi_step_overlap)):
                    step = make(mesh, N + 1, N + 1, a0, a1)
                    res[name, bim] = sharding.gather_blocks(step(u, f, p), mesh)
        else:
            level = build_level(Problem(n=32), 32, device="cpu")
            u_star, f = (torch.as_tensor(x) for x in _fields(5, (B, 33, 33)))
            state, loss = sharding.sharded_hnet_train_step(mesh)(
                level, train_hnet.init_state(level, seed=0), u_star, f,
                torch.zeros_like(u_star), torch.ones_like(u_star))
            res["hnet"] = (state.params.detach().clone(), float(loss))
        torch.save(res, f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def jax_pid():
    from multigrid_feanet_tpu.core.problem import GridHierarchy as JHier
    from multigrid_feanet_tpu.core.problem import Problem as JProblem

    return np.asarray(JHier.create(JProblem(n=N, inclusion=CIRCLE)).finest.pid)


@pytest.fixture(scope="module")
def spatial(tmp_path_factory, jax_pid):
    return spawn_ranks(_rank, 4, tmp_path_factory.mktemp("mesh122"), 1, jax_pid)


@pytest.fixture(scope="module")
def data_parallel(tmp_path_factory):
    return spawn_ranks(_rank, 4, tmp_path_factory.mktemp("mesh212"), 2, None)


def test_mesh_factorization(spatial, data_parallel):
    """mesh_shape is JAX make_mesh's factorization (one host: dp 1 and the
    most square split; several: dp over hosts); the ranks' meshes."""
    import jax
    from multigrid_feanet_tpu.parallel import sharding as jsharding

    for n in (1, 2, 4, 8):
        assert sharding.mesh_shape(n) == jsharding.make_mesh(n).devices.shape
    assert sharding.mesh_shape(8, dp=2) == jsharding.make_mesh(8, dp=2).devices.shape
    assert len(jax.devices()) == 8
    # several hosts (JAX: dp spans the processes, x <= y over the rest)
    assert sharding.mesh_shape(16, hosts=2) == (2, 2, 4)
    assert sharding.mesh_shape(16, dp=4, hosts=2) == (4, 2, 2)
    with pytest.raises(ValueError):
        sharding.mesh_shape(16, dp=3, hosts=2)
    assert spatial[0]["shape"] == (1, 2, 2) and data_parallel[0]["shape"] == (2, 1, 2)
    assert spatial[0]["names"] == ("dp", "x", "y")


def test_sharded_apply_matches_single_device(spatial):
    import jax.numpy as jnp
    from multigrid_feanet_tpu.core.problem import GridHierarchy as JHier
    from multigrid_feanet_tpu.core.problem import Problem as JProblem

    u = _fields(0, (N + 1, N + 1))[0]
    ref = np.asarray(JHier.create(JProblem(n=N, inclusion=CIRCLE, dtype=jnp.float32))
                     .finest.apply(jnp.asarray(u)))
    for res in spatial:
        out = res["apply"].numpy()
        np.testing.assert_allclose(out[1:-1, 1:-1], ref[1:-1, 1:-1], rtol=1e-5, atol=1e-5)


def test_distributed_vcycle_solve_matches_jax(spatial):
    import jax.numpy as jnp
    from multigrid_feanet_tpu.core.problem import GridHierarchy as JHier
    from multigrid_feanet_tpu.core.problem import Problem as JProblem
    from multigrid_feanet_tpu.ops import stencil as jst
    from multigrid_feanet_tpu.parallel import sharding as jsharding

    hier = JHier.create(JProblem(n=N, inclusion=CIRCLE, dtype=jnp.float32))
    dh = jsharding.DistributedHierarchy(hier, jsharding.make_mesh(8), replicate_below=33)
    f = jst.apply_mass(jnp.ones((N + 1, N + 1), jnp.float32), hier.finest.h)
    u_j, k_j, res_j = dh.solve(f, nu1=1, nu2=1, eps=5e-5)
    for res in spatial:
        u, k, r = res["solve"]
        assert res["S"] == 2 and k == k_j and r <= 5e-5
        np.testing.assert_allclose(u.numpy(), np.asarray(u_j), rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("bim", [False, True], ids=["hom", "bim"])
def test_shardmap_explicit_halo_jacobi_matches_jax(spatial, jax_pid, bim):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from multigrid_feanet_tpu.core.problem import GridHierarchy as JHier
    from multigrid_feanet_tpu.core.problem import Problem as JProblem
    from multigrid_feanet_tpu.parallel import sharding as jsharding

    lv = JHier.create(JProblem(n=N, inclusion=CIRCLE)).finest
    a0, a1 = (lv.a0, lv.a1) if bim else (1.0, None)
    mesh2d = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("x", "y"))
    step = jsharding.shardmap_jacobi_step(mesh2d, N + 1, N + 1, a0, a1)
    u, f, p = _padded(1 if bim else 0, jax_pid if bim else None)
    want = np.asarray(step(jnp.asarray(u), jnp.asarray(f), jnp.asarray(p)))
    for res in spatial:
        np.testing.assert_allclose(res["sync", bim].numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bim", [False, True], ids=["hom", "bim"])
def test_shardmap_overlap_matches_sync(spatial, bim):
    for res in spatial:
        np.testing.assert_allclose(res["overlap", bim].numpy(), res["sync", bim].numpy(),
                                   rtol=1e-6, atol=5e-7)


def test_sharded_hnet_train_step_matches_whole_batch(data_parallel):
    level = build_level(Problem(n=32), 32, device="cpu")
    u_star, f = (torch.as_tensor(x) for x in _fields(5, (B, 33, 33)))
    state, loss = train_hnet.train_step(level, train_hnet.init_state(level, seed=0), u_star, f,
                                        torch.zeros_like(u_star), torch.ones_like(u_star))
    for res in data_parallel:
        params, dp_loss = res["hnet"]
        assert float((params - state.params.detach()).abs().max()) <= 1e-6
        assert dp_loss == pytest.approx(float(loss), rel=1e-6)
