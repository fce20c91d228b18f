"""``parallel/shard.py::ShardedHierarchyV2`` on gloo ranks on the CPU.

n = 256, 4 levels, kernel threshold 64, ``shard_below=100`` (S = 2: levels
256 and 128 sharded, 64 agglomerated), 2 and 4 ranks spawned once per world
size, each with one thread.  The ranks run the plain slab forms; their
results are held against

(a) the port's ``HierarchyV2`` on the CPU from the same u0 (numpy): bitwise
    iterates in the plain form (5 V(1,1) cycles at eps 0, 3 V(2,2)), the
    history to 1e-6 relative (the partial norms are summed in another
    order); the difference form to 1e-5; an eps-terminated solve in the same
    cycles; a repeated solve on the same ranks bitwise;
(b) JAX's ``ShardedPallasHierarchyV2`` on the virtual CPU mesh of as many
    devices (interpret mode), the same problem and u0: u within 1e-5 / 1e-6,
    the history within 1e-5;

and the communication of one V(1,1) cycle, counted by wrappers around the
process-group calls, is JAX's budget (``tests/test_comm_budget.py:74-76``):
2 + 2 (S - 1) exchanges, one all_gather, one all_reduce, with the bytes of
``comm_bytes_per_cycle``.  JAX is imported only where the references are
built: the spawned ranks import this module and load torch and the port.
"""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from multigrid_feanet_torch.core.problem import Problem
from multigrid_feanet_torch.parallel import shard
from multigrid_feanet_torch.parallel.shard import ShardedHierarchyV2, check_group
from multigrid_feanet_torch.parallel.sharding import init_distributed
from multigrid_feanet_torch.solvers.mg2 import HierarchyV2

N = 256
CIRCLE = ("circle", (0.0, 0.0), 0.5)
CFG = dict(num_levels=4, kernel_threshold=64, direct_coarse=True)
# name -> (bi-material, dform, nu, eps, max_cycles)
CASES = {"hom_plain": (False, False, 1, 0.0, 5), "bim_plain": (True, False, 1, 0.0, 5),
         "hom_v22": (False, False, 2, 0.0, 3), "bim_dform": (True, None, 1, 0.0, 5),
         "bim_eps": (True, False, 1, 1e-4, 40)}


def _problem(bim):
    return Problem(n=N, inclusion=CIRCLE if bim else None)


def _u0():
    return np.random.default_rng(1).standard_normal((N + 1, N + 1)).astype(np.float32)


class _Counter:
    """Counts the process-group calls of the sharded cycle and the bytes
    this rank sends with them."""

    def __init__(self):
        self.calls = {"exchange": 0, "all_gather": 0, "all_reduce": 0}
        self.bytes = 0
        self._orig = {}

    def __enter__(self):
        def wrap(name, key, nbytes):
            orig = getattr(dist, name)
            self._orig[name] = orig

            def counted(*args, **kw):
                self.calls[key] += 1
                self.bytes += nbytes(*args)
                return orig(*args, **kw)

            setattr(dist, name, counted)

        wrap("batch_isend_irecv", "exchange",
             lambda ops: sum(op.tensor.numel() * op.tensor.element_size() for op in ops
                             if op.op is dist.isend))
        wrap("all_gather", "all_gather", lambda out, t, **kw: t.numel() * t.element_size())
        wrap("all_reduce", "all_reduce", lambda t, **kw: t.numel() * t.element_size())
        return self

    def __exit__(self, *exc):
        for name, orig in self._orig.items():
            setattr(dist, name, orig)


def _rank(rank, world, rdv, out_dir):
    torch.set_num_threads(1)
    init_distributed(f"file://{rdv}", world, rank, device="cpu")
    try:
        u0, f0 = _u0(), np.zeros((N + 1, N + 1), np.float32)
        res, built = {}, {}
        for name, (bim, dform, nu, eps, cycles) in CASES.items():
            if (bim, dform) not in built:
                built[bim, dform] = ShardedHierarchyV2(_problem(bim), shard_below=100,
                                                       dform=dform, device="cpu", **CFG)
            sh = built[bim, dform]
            res[name] = sh.solve(f0, u0=u0, nu1=nu, nu2=nu, eps=eps, max_cycles=cycles)
            if name == "bim_plain":
                res["bim_plain_again"] = sh.solve(f0, u0=u0, eps=eps, max_cycles=cycles)
        res["S"] = sh.S
        # the base's whole-field buffers of the sharded levels are released
        res["base_buffers"] = (sorted(sh.base._fc), sorted(sh.base._u), sh.base.K)
        # one V(1,1) cycle's communication: the counts of 3 cycles less 2
        sh = built[False, False]
        counts = []
        for cycles in (2, 3):
            with _Counter() as c:
                sh.solve(f0, u0=u0, eps=0.0, max_cycles=cycles)
            counts.append(c)
        res["comm"] = dict({k: counts[1].calls[k] - counts[0].calls[k] for k in counts[0].calls},
                           bytes=counts[1].bytes - counts[0].bytes,
                           model=sh.comm_bytes_per_cycle(), S=sh.S)
        # the group must run the backend its device takes
        with pytest.raises(ValueError, match="nccl"):
            check_group(None, torch.device("cuda", 0))
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, world: int, out, *args) -> list:
    """Run ``fn(rank, world, rendezvous file, out, *args)`` on ``world``
    spawned processes with one BLAS thread each (numpy's dense inverse of
    the coarse level would otherwise oversubscribe the cores); returns what
    each rank saved as ``rank<r>.pt`` in ``out``."""
    keys = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")
    saved = {k: os.environ.get(k) for k in keys}
    os.environ.update({k: "1" for k in keys})
    try:
        mp.spawn(fn, args=(world, str(out / "rdv"), str(out), *args), nprocs=world, join=True)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(world)]


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def ranks(request, tmp_path_factory):
    world = request.param
    return world, spawn_ranks(_rank, world, tmp_path_factory.mktemp(f"shard{world}"))


def _single(name):
    """The single-device solve, on one thread as the ranks run (the direct
    coarse solve's matrix product rounds by its thread blocking)."""
    bim, dform, nu, eps, cycles = CASES[name]
    hv = HierarchyV2(_problem(bim), dform=dform, device="cpu", **CFG)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return hv.solve(np.zeros((N + 1, N + 1), np.float32), u0=_u0(), nu1=nu, nu2=nu,
                        eps=eps, max_cycles=cycles)
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("name", ["hom_plain", "bim_plain", "hom_v22"])
def test_plain_form_bitwise_single_device(ranks, name):
    world, res = ranks
    u, hist = res[0][name]
    u_s, h_s = _single(name)
    assert res[0]["S"] == 2
    assert torch.equal(u, u_s)
    np.testing.assert_allclose(hist, h_s, rtol=1e-6)
    for r in range(1, world):  # every rank returns the gathered field
        assert torch.equal(res[r][name][0], u)


def test_sharded_levels_whole_buffers_released(ranks):
    """Levels 1 .. S keep no whole-field right-hand side and levels 1 .. S-1
    no whole-field iterate on a rank: only the agglomerated levels' remain
    (the solves above ran without them)."""
    world, res = ranks
    for r in range(world):
        fc, u, K = res[r]["base_buffers"]
        S = res[r]["S"]
        assert fc == list(range(S + 1, K + 1)) and u == list(range(S, K))


def test_difference_form_single_device(ranks):
    _, res = ranks
    u, hist = res[0]["bim_dform"]
    u_s, h_s = _single("bim_dform")
    np.testing.assert_allclose(u.numpy(), u_s.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(hist, h_s, rtol=1e-5)


def test_eps_terminated_same_cycles(ranks):
    _, res = ranks
    _, hist = res[0]["bim_eps"]
    _, h_s = _single("bim_eps")
    assert len(hist) == len(h_s) and hist[-1] <= 1e-4
    np.testing.assert_allclose(hist, h_s, rtol=1e-6)


def test_repeated_solve_bitwise(ranks):
    _, res = ranks
    (u1, h1), (u2, h2) = res[0]["bim_plain"], res[0]["bim_plain_again"]
    assert torch.equal(u1, u2)
    np.testing.assert_array_equal(h1, h2)


def test_matches_jax_sharded_solver(ranks):
    """(b): JAX's ShardedPallasHierarchyV2 on as many virtual devices."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from multigrid_feanet_tpu.core.problem import Problem as JProblem
    from multigrid_feanet_tpu.parallel.pallas_shard import ShardedPallasHierarchyV2

    world, res = ranks
    mesh = Mesh(np.array(jax.devices()[:world]), ("x",))
    jsh = ShardedPallasHierarchyV2(JProblem(n=N, inclusion=CIRCLE), mesh, axis="x",
                                   shard_below=100, num_levels=4, pallas_threshold=64, rows=32,
                                   rows_coarse=32, direct_coarse=True)
    u_j, h_j = jsh.solve(jnp.zeros((N + 1, N + 1), jnp.float32), u0=jnp.asarray(_u0()),
                         eps=0.0, max_cycles=5)
    u, hist = res[0]["bim_dform"]
    assert jsh.S == res[0]["S"]
    np.testing.assert_allclose(u.numpy(), np.asarray(u_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(hist, h_j, rtol=1e-5)


def test_comm_budget_per_cycle(ranks):
    """One V(1,1) cycle: 2 + 2 (S - 1) exchanges, one all_gather, one
    all_reduce on every rank, and the bytes of comm_bytes_per_cycle."""
    world, res = ranks
    for r in range(world):
        c = res[r]["comm"]
        assert c["exchange"] == 2 + 2 * (c["S"] - 1)
        assert c["all_gather"] == 1 and c["all_reduce"] == 1
        assert c["bytes"] == c["model"]
    # an edge rank sends its ghost rows to one neighbour, an inner rank to two
    ghost = [res[r]["comm"]["model"] for r in range(world)]
    assert ghost[0] == ghost[-1] and (world < 3 or ghost[1] > ghost[0])


def test_entry_point_needs_a_device_and_a_group():
    """No CUDA and no device: the resolver raises; no process group: the
    solver refuses to run unsharded."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ShardedHierarchyV2(_problem(False), shard_below=100, **CFG)
    if not dist.is_initialized():
        with pytest.raises(RuntimeError, match="no process group"):
            ShardedHierarchyV2(_problem(False), shard_below=100, device="cpu", **CFG)
    assert shard.group_backend(torch.device("cpu")) == "gloo"
