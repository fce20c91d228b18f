"""The distributed solvers' one-dispatch solves on gloo ranks on the CPU,
against their eager loops, bit for bit.

On the card ``ShardedHierarchyV2.solve`` and ``ShardedHMG.solve`` replay one
CUDA graph per chunk of cycles, ``DistributedHierarchy.solve`` one per
cycle, each with its NCCL collectives inside; on the CPU the eager loop
runs.  Here every rank puts an eager stand-in in the graph's place
(``test_torch_solve_graph.EagerGraphs``: every "replay" runs the chunk body
again, with the tensor methods that read the device from the host patched
to raise), so the replay path -- the static slabs, the per-chunk norms, the
buffer parity, the static H-Net kernels, the collectives issued from inside
a body -- runs here and is held bit for bit to ``graph=False`` on every
rank:

- ``ShardedHierarchyV2`` (the setup of ``test_torch_shard_solve.py``: n =
  256, 4 levels, threshold 64, ``shard_below=100``, S = 2; the bi-material
  plain form) at chunk 1, 2 and 3, stopped on eps inside a chunk and at the
  cycle cap, V(1,1) and V(2,2): iterate and history;
- ``ShardedHMG`` at chunk 2, then a re-solve from another u0 with other
  H-Net kernels, which replays the same graph;
- ``DistributedHierarchy`` (n = 64, ``replicate_below=33``, S = 2) on a
  (1, 2, 1) mesh at world 2 and a (1, 2, 2) mesh at world 4: ``(u, cycles,
  res)``, twice from different starts;

and the process-group calls inside one replayed cycle (chunk 1) are the
per-cycle budget of ``comm_bytes_per_cycle``.  2 and 4 ranks are spawned
once per world size, one thread each; no JAX function is called.
"""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from multigrid_feanet_torch.core.problem import GridHierarchy, Problem
from multigrid_feanet_torch.ops.stencil import apply_mass
from multigrid_feanet_torch.parallel import sharding
from multigrid_feanet_torch.parallel.shard import ShardedHierarchyV2, ShardedHMG
from test_torch_shard_solve import _Counter, spawn_ranks
from test_torch_solve_graph import EagerGraphs

N, N_MESH = 256, 64
CIRCLE = ("circle", (0.0, 0.0), 0.5)
CFG = dict(num_levels=4, kernel_threshold=64, direct_coarse=True, shard_below=100,
           device="cpu")
# the V2 solves: stop -> (eps, max_cycles); the eps-terminated decay's
# history ends after 7 cycles at V(1,1) and 4 at V(2,2), the cap runs 4
STOPS = {"eps": (0.1, 40), "cap": (0.0, 4)}
CHUNKS = (1, 2, 3)
NUS = (1, 2)
MESHES = {2: (1, 2, 1), 4: (1, 2, 2)}


def _u0(seed, n=N):
    return np.random.default_rng(seed).standard_normal((n + 1, n + 1)).astype(np.float32)


def _params(seed):
    return (0.1 * np.random.default_rng(seed).standard_normal((1, 3, 3))).astype(np.float32)


class CountedGraphs(EagerGraphs):
    """``EagerGraphs`` that counts the process-group calls of every body."""

    def __init__(self):
        super().__init__()
        self.comm = []

    def _strict(self, body):
        with _Counter() as c:
            super()._strict(body)
        self.comm.append(dict(c.calls, bytes=c.bytes))


def _both(solve, solver):
    """(eager, replayed) results of ``solve(graph)`` on ``solver``, with the
    bodies and captures the replayed one added."""
    want = solve(False)
    before = (solver.graphs.bodies, solver.graphs.captures)
    got = solve(True)
    return want, got, (solver.graphs.bodies - before[0], solver.graphs.captures - before[1])


def _rank(rank, world, rdv, out_dir):
    torch.set_num_threads(1)
    sharding.init_distributed(f"file://{rdv}", world, rank, device="cpu")
    try:
        res = {}
        f0 = np.zeros((N + 1, N + 1), np.float32)
        sh = ShardedHierarchyV2(Problem(n=N, inclusion=CIRCLE), dform=False, **CFG)
        sh.graphs = EagerGraphs()
        res["S"] = sh.S
        for nu in NUS:
            for chunk in CHUNKS:
                for stop, (eps, cap) in STOPS.items():
                    res["v2", nu, chunk, stop] = _both(
                        lambda graph: sh.solve(f0, u0=_u0(1), nu1=nu, nu2=nu, eps=eps,
                                               max_cycles=cap, chunk=chunk, graph=graph), sh)
        # one replayed V(nu, nu) cycle's process-group calls
        for nu in NUS:
            sh.graphs = CountedGraphs()
            sh.solve(f0, u0=_u0(1), nu1=nu, nu2=nu, eps=0.0, max_cycles=3)
            res["v2_comm", nu] = (sh.graphs.comm, sh.comm_bytes_per_cycle(nu, nu))

        hm = ShardedHMG(Problem(n=N, inclusion=CIRCLE), **CFG)
        hm.graphs = EagerGraphs()
        for name, params, seed in (("first", _params(7), 3), ("again", _params(8), 4)):
            res["hmg", name] = _both(
                lambda graph: hm.solve(params, f0, u0=_u0(seed), eps=0.0, max_cycles=5, chunk=2,
                                       graph=graph), hm)
        hm.graphs = CountedGraphs()
        hm.solve(_params(7), f0, u0=_u0(3), eps=0.0, max_cycles=3)
        res["hmg_comm"] = (hm.graphs.comm, hm.comm_bytes_per_cycle())

        mesh = init_device_mesh("cpu", MESHES[world], mesh_dim_names=sharding.MESH_DIMS)
        hier = GridHierarchy.create(Problem(n=N_MESH, inclusion=CIRCLE), device="cpu")
        dh = sharding.DistributedHierarchy(hier, mesh, replicate_below=33)
        dh.graphs = EagerGraphs()
        f = apply_mass(torch.ones((N_MESH + 1, N_MESH + 1)), hier.finest.h)
        res["dist_S"] = dh.S
        for name, u0 in (("zero", None), ("random", _u0(5, N_MESH))):
            res["dist", name] = _both(
                lambda graph: dh.solve(f, u0=u0, nu1=1, nu2=1, eps=5e-5, graph=graph), dh)
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def ranks(request, tmp_path_factory):
    world = request.param
    return world, spawn_ranks(_rank, world, tmp_path_factory.mktemp(f"shard_graph{world}"))


def _assert_bitwise(got, want):
    (ug, hg), (uw, hw) = got, want
    assert ug.dtype == uw.dtype and torch.equal(ug, uw)
    assert hg.dtype == hw.dtype and len(hg) == len(hw) and np.array_equal(hg, hw)


@pytest.mark.parametrize("stop", STOPS)
@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("nu", NUS, ids=["v11", "v22"])
def test_sharded_v2_replay_matches_eager(ranks, nu, chunk, stop):
    """Every rank's replayed ShardedHierarchyV2 solve is its eager loop bit
    for bit (the gathered iterate and the history), with no host read in
    any chunk body: one body per chunk run, one capture per (nu, chunk),
    the eps-terminated solve replaying the cap solve's graph or the other
    way round."""
    world, res = ranks
    eps, cap = STOPS[stop]
    for r in range(world):
        want, got, (bodies, captures) = res[r]["v2", nu, chunk, stop]
        _assert_bitwise(got, want)
        assert bodies == (-(-(len(want[1]) + 1) // chunk) if stop == "eps" else -(-cap // chunk))
        assert captures == (1 if stop == "eps" and bodies > 1 else 0)
        assert torch.equal(got[0], res[0]["v2", nu, chunk, stop][1][0])
    hist = res[0]["v2", nu, chunk, stop][0][1]
    if stop == "eps":  # stopped on eps, inside a chunk for chunk 2 and 3
        assert 1 < len(hist) < cap and hist[-1] <= eps < hist[-2]
    else:
        assert len(hist) >= cap - 1 and hist.min() > 0.0
    assert res[0]["S"] == 2


@pytest.mark.parametrize("name", ["first", "again"])
def test_sharded_hmg_replay_matches_eager(ranks, name):
    """ShardedHMG at chunk 2, bit for bit its eager loop on every rank; the
    re-solve from another u0 with other H-Net kernels replays the graph
    captured by the first solve on the new kernels' static copy."""
    world, res = ranks
    for r in range(world):
        want, got, (bodies, captures) = res[r]["hmg", name]
        _assert_bitwise(got, want)
        assert bodies == 3 and captures == (1 if name == "first" else 0)
    first, again = res[0]["hmg", "first"][1], res[0]["hmg", "again"][1]
    assert not np.array_equal(first[1], again[1])


@pytest.mark.parametrize("name", ["zero", "random"])
def test_distributed_replay_matches_eager(ranks, name):
    """DistributedHierarchy.solve, one replay per cycle: ``(u, cycles,
    res)`` bit for bit the eager loop's on every rank of the (1, 2, 1) and
    (1, 2, 2) meshes; the second solve replays the first one's graph."""
    world, res = ranks
    for r in range(world):
        (uw, kw, rw), (ug, kg, rg), (bodies, captures) = res[r]["dist", name]
        assert torch.equal(ug, uw) and kg == kw and rg == rw
        assert bodies == kw and captures == (1 if name == "zero" else 0)
        assert 1 < kw < 100 and rw <= 5e-5
    assert res[0]["dist_S"] == 2


@pytest.mark.parametrize("solver", ["v11", "v22", "hmg"])
def test_comm_budget_per_replayed_cycle(ranks, solver):
    """The process-group calls inside each replayed cycle (chunk 1, the
    warm cycle included) on every rank: V(1,1) 2 + 2 (S - 1) exchanges and
    H-MG 2 + 3 (S - 1), V(2,2) 4 + 5 (S - 1); one all_gather and one
    all_reduce; the bytes of comm_bytes_per_cycle."""
    world, res = ranks
    exchanges = {"v11": lambda S: 2 + 2 * (S - 1), "v22": lambda S: 4 + 5 * (S - 1),
                 "hmg": lambda S: 2 + 3 * (S - 1)}[solver]
    key = {"v11": ("v2_comm", 1), "v22": ("v2_comm", 2), "hmg": "hmg_comm"}[solver]
    for r in range(world):
        comm, model = res[r][key]
        assert len(comm) == 3
        for c in comm:
            assert c["exchange"] == exchanges(res[r]["S"])
            assert c["all_gather"] == 1 and c["all_reduce"] == 1 and c["bytes"] == model
