"""``parallel/shard.py::ShardedHMG`` on gloo ranks on the CPU.

The setup of JAX's anchor (``tests/test_pallas_shard.py:163``): n = 256, 4
levels, kernel threshold 64, ``shard_below=100`` (S = 2: levels 256 and 128
sharded, 64 agglomerated), direct coarse solve, the L = 1 kernels
``0.1 * default_rng(7).standard_normal((1, 3, 3))``, f = 0, eps 0, 4 cycles,
homogeneous and bi-material; u0 from a numpy seed.  2 and 4 ranks are
spawned once per world size, each with one thread; they run the plain slab
forms of E2 and E3.  Their results are held against

(a) the port's ``HMGHierarchy(coarse_zero_legs=False)`` on the CPU from the
    same u0, on one thread: the iterate bitwise, the history to 1e-6
    relative (the ranks' partial norms are added in another order);
(b) JAX's ``ShardedPallasHMG`` on the virtual CPU mesh of as many devices
    (interpret mode): u within 1e-5 of its largest magnitude, the history
    within 1e-5 relative (the plain forms against the Pallas kernels: f32
    reassociation of the applies and the chain, carried through 4 cycles
    from a start ~30 times larger; 1e-7 and 1.1e-6 against 0.022 and 0.14
    were measured, homogeneous and bi-material);

and the communication of one H-MG cycle, counted by wrappers around the
process-group calls: 2 + 3 (S - 1) exchanges (level 0: u and u1; every
other sharded level: its right-hand side, u1 and u3), one all_gather, one
all_reduce, with the bytes of ``comm_bytes_per_cycle``.  Params of depth 3
and a gloo group on CUDA are refused on the ranks.  JAX is imported only
where the reference is built.
"""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from multigrid_feanet_torch.core.problem import Problem
from multigrid_feanet_torch.parallel.shard import ShardedHMG
from multigrid_feanet_torch.parallel.sharding import init_distributed
from multigrid_feanet_torch.solvers.hmg import HMGHierarchy
from test_torch_shard_solve import _Counter, spawn_ranks

N, CYCLES = 256, 4
CIRCLE = ("circle", (0.0, 0.0), 0.5)
CFG = dict(num_levels=4, kernel_threshold=64, direct_coarse=True)


def _problem(bim):
    return Problem(n=N, inclusion=CIRCLE if bim else None)


def _params():
    return (0.1 * np.random.default_rng(7).standard_normal((1, 3, 3))).astype(np.float32)


def _u0():
    return np.random.default_rng(3).standard_normal((N + 1, N + 1)).astype(np.float32)


def _rank(rank, world, rdv, out_dir):
    torch.set_num_threads(1)
    init_distributed(f"file://{rdv}", world, rank, device="cpu")
    try:
        f0 = np.zeros((N + 1, N + 1), np.float32)
        res = {}
        for bim in (False, True):
            sh = ShardedHMG(_problem(bim), shard_below=100, device="cpu", **CFG)
            res[bim] = sh.solve(_params(), f0, u0=_u0(), eps=0.0, max_cycles=CYCLES)
        res["S"] = sh.S
        # the base's whole-field buffers of the sharded levels are released
        res["base_buffers"] = (sorted(sh.base._fc), sorted(sh.base._u), sorted(sh.base._zero),
                               sh.base.K)
        # one H-MG cycle's communication: the counts of 3 cycles less 2
        counts = []
        for cycles in (2, 3):
            with _Counter() as c:
                sh.solve(_params(), f0, u0=_u0(), eps=0.0, max_cycles=cycles)
            counts.append(c)
        res["comm"] = dict({k: counts[1].calls[k] - counts[0].calls[k] for k in counts[0].calls},
                           bytes=counts[1].bytes - counts[0].bytes,
                           model=sh.comm_bytes_per_cycle(), S=sh.S)
        # an L = 3 chain reads past the ghost rows: refused
        with pytest.raises(ValueError, match="L = 1"):
            sh.solve(np.zeros((3, 3, 3), np.float32), f0, u0=_u0(), eps=0.0, max_cycles=1)
        # the group must run the backend its device takes
        with pytest.raises(ValueError, match="nccl"):
            ShardedHMG(_problem(False), shard_below=100, device=torch.device("cuda", 0), **CFG)
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def ranks(request, tmp_path_factory):
    world = request.param
    return world, spawn_ranks(_rank, world, tmp_path_factory.mktemp(f"shard_hmg{world}"))


def _single(bim):
    """The single-device solve, on one thread as the ranks run (the direct
    coarse solve's matrix product rounds by its thread blocking)."""
    hm = HMGHierarchy(_problem(bim), coarse_zero_legs=False, device="cpu", **CFG)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return hm.solve(_params(), np.zeros((N + 1, N + 1), np.float32), u0=_u0(), eps=0.0,
                        max_cycles=CYCLES)
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("bim", [False, True], ids=["hom", "bim"])
def test_iterate_bitwise_single_device(ranks, bim):
    """(a): the sharded iterate is HMGHierarchy(coarse_zero_legs=False)'s
    bit for bit, on every rank."""
    world, res = ranks
    u, hist = res[0][bim]
    u_s, h_s = _single(bim)
    assert res[0]["S"] == 2 and len(hist) == len(h_s) == CYCLES - 1
    assert torch.equal(u, u_s)
    np.testing.assert_allclose(hist, h_s, rtol=1e-6)
    for r in range(1, world):  # every rank returns the gathered field
        assert torch.equal(res[r][bim][0], u)


def test_sharded_levels_whole_buffers_released(ranks):
    """Levels 1 .. S keep no whole-field right-hand side and levels 1 .. S-1
    no whole-field iterate or zero iterate on a rank."""
    world, res = ranks
    for r in range(world):
        fc, u, zero, K = res[r]["base_buffers"]
        S = res[r]["S"]
        assert fc == list(range(S + 1, K + 1)) and u == list(range(S, K))
        assert zero == list(range(S, K))


@pytest.mark.parametrize("bim", [False, True], ids=["hom", "bim"])
def test_matches_jax_sharded_hmg(ranks, bim):
    """(b): JAX's ShardedPallasHMG on as many virtual devices."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from multigrid_feanet_tpu.core.problem import Problem as JProblem
    from multigrid_feanet_tpu.parallel.pallas_shard import ShardedPallasHMG

    world, res = ranks
    mesh = Mesh(np.array(jax.devices()[:world]), ("x",))
    jsh = ShardedPallasHMG(JProblem(n=N, inclusion=CIRCLE if bim else None), mesh, axis="x",
                           shard_below=100, num_levels=4, pallas_threshold=64, rows=32,
                           rows_coarse=32, direct_coarse=True)
    u_j, h_j = jsh.solve(jnp.asarray(_params()), jnp.zeros((N + 1, N + 1), jnp.float32),
                         u0=jnp.asarray(_u0()), eps=0.0, max_cycles=CYCLES)
    u, hist = res[0][bim]
    assert jsh.S == res[0]["S"]
    err = float(np.max(np.abs(u.numpy() - np.asarray(u_j))))
    assert err <= 1e-5 * float(np.max(np.abs(np.asarray(u_j)))), err
    np.testing.assert_allclose(hist, h_j, rtol=1e-5)


def test_comm_budget_per_cycle(ranks):
    """One H-MG cycle: 2 + 3 (S - 1) exchanges, one all_gather, one
    all_reduce on every rank, and the bytes of comm_bytes_per_cycle."""
    world, res = ranks
    for r in range(world):
        c = res[r]["comm"]
        assert c["exchange"] == 2 + 3 * (c["S"] - 1)
        assert c["all_gather"] == 1 and c["all_reduce"] == 1
        assert c["bytes"] == c["model"]
    # an edge rank sends its ghost rows to one neighbour, an inner rank to two
    sent = [res[r]["comm"]["model"] for r in range(world)]
    assert sent[0] == sent[-1] and (world < 3 or sent[1] > sent[0])


def test_entry_point_needs_a_device_and_a_group():
    """No CUDA and no device: the resolver raises; no process group: the
    solver refuses to run unsharded."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ShardedHMG(_problem(False), shard_below=100, **CFG)
    if not dist.is_initialized():
        with pytest.raises(RuntimeError, match="no process group"):
            ShardedHMG(_problem(False), shard_below=100, device="cpu", **CFG)
