"""The fused solvers' chunk replays (``solvers/common.py::ChunkGraphs``) on
the CPU, against their eager loops, bit for bit.

On the card each fused entry point captures one chunk of its cycles as a
CUDA graph and replays it; on the CPU the eager loop runs.  Here an eager
stand-in takes the graph's place (``EagerGraphs``: every "replay" runs the
chunk body again), so the replay path's bookkeeping -- static buffers, the
per-chunk norm buffer, the buffer parity, the A6 chunk between its peeled
descent and closing ascent, CG's two parity graphs, the returned copy, the
heat march's step with its (f^n, f^{n+1}) pair -- runs here and is held bit
for bit to the eager loop (``graph=False``).  The
stand-in also runs every body with the tensor methods that read the device
from the host patched to raise: a body that syncs could not be captured.

The solvers run at n = 64 (65^2 nodes) on the plain versions of the
kernels; no JAX function is called.
"""

import contextlib
from pathlib import Path

import numpy as np
import pytest
import torch

from multigrid_feanet_torch.core.problem import GridHierarchy, Problem
from multigrid_feanet_torch.ops.heat import HeatSolver
from multigrid_feanet_torch.solvers.boxmg import BoxMGHierarchy
from multigrid_feanet_torch.solvers.common import ChunkGraphs
from multigrid_feanet_torch.solvers.elastic import ElasticHierarchy
from multigrid_feanet_torch.solvers.hmg import HMGHierarchy
from multigrid_feanet_torch.solvers.mg import Hierarchy, solve_ir
from multigrid_feanet_torch.solvers.mg2 import HierarchyV2
from multigrid_feanet_torch.utils import checkpoint

CKPT_DIR = Path(__file__).resolve().parent.parent / "results" / "learn_iterator"
CIRCLE = ("circle", (0.0, 0.0), 0.5)
N = 64

# the tensor methods through which host code reads a device tensor
HOST_READS = ("item", "__float__", "__int__", "__bool__", "tolist", "numpy", "__array__",
              "cpu")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def no_host_reads():
    """Every method of HOST_READS raises inside the block."""
    own = {name: torch.Tensor.__dict__.get(name) for name in HOST_READS}

    def refuse(name):
        def method(self, *args, **kwargs):
            raise AssertionError(f"a chunk body read the device: Tensor.{name}")
        return method

    for name in HOST_READS:
        setattr(torch.Tensor, name, refuse(name))
    try:
        yield
    finally:
        for name, method in own.items():
            if method is None:
                delattr(torch.Tensor, name)
            else:
                setattr(torch.Tensor, name, method)


class EagerGraphs(ChunkGraphs):
    """``ChunkGraphs`` with an eager stand-in for the CUDA graph: the warm
    chunk and every replay run the body eagerly, with host reads refused."""

    def __init__(self):
        super().__init__("cpu")
        self.enabled = True
        self.bodies = 0

    def _warm(self, body):
        self._strict(body)

    def _capture(self, body):
        return lambda: self._strict(body)

    def _strict(self, body):
        self.bodies += 1
        with no_host_reads():
            body()


def test_no_host_reads_refuses_and_restores():
    x = torch.ones(2)
    with no_host_reads():
        with pytest.raises(AssertionError, match="Tensor.item"):
            x.sum().item()
        with pytest.raises(AssertionError, match="Tensor.__float__"):
            float(x[0])
        with pytest.raises(AssertionError, match="Tensor.cpu"):
            x.cpu()
    assert float(x.sum()) == 2.0 and x.tolist() == [1.0, 1.0]
    assert not any(name in torch.Tensor.__dict__ for name in ("item", "__float__", "cpu"))


def _net(name):
    return checkpoint.load(CKPT_DIR / name)[0]


def _decay_u0(seed, shape=(N + 1, N + 1)):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _v2(dtype=torch.float32):
    return HierarchyV2(Problem(n=N, inclusion=CIRCLE), num_levels=4, kernel_threshold=16,
                       dtype=dtype, dform=True, device="cpu")


def _hmg():
    return HMGHierarchy(Problem(n=N, inclusion=CIRCLE), num_levels=4, kernel_threshold=16,
                        direct_coarse=True, dform=True, device="cpu")


def _boxmg():
    return BoxMGHierarchy(Problem(n=N, inclusion=CIRCLE), num_levels=4, kernel_threshold=16,
                          direct_coarse=True, device="cpu")


def _elastic():
    return ElasticHierarchy(N, 212e3, 0.288, inclusion=CIRCLE, coefficients=(1.0, 20.0),
                            num_levels=4, kernel_threshold=16, direct_coarse=True,
                            device="cpu")


def _r1():
    hier = GridHierarchy.create(Problem(n=N, inclusion=CIRCLE), 4, device="cpu")
    return Hierarchy(hier, kernel_threshold=16, direct_coarse=True, device="cpu")


def _scalar(h, seed):
    """(f, u0) of the f = 0 decay protocol on a scalar solver."""
    return np.zeros((N + 1, N + 1), np.float32), _decay_u0(seed)


def _vector(h, seed):
    """(f, u0) of the decay protocol on the elastic solver."""
    return np.zeros((2, N + 1, N + 1), np.float32), _decay_u0(seed, (2, N + 1, N + 1))


def _hmg_solve(h, seed, **kw):
    f, u0 = _scalar(h, seed)
    return h.solve(_net("hnet_decay_L1_hlNone.npz"), f, u0=u0, **kw)


# entry point: (solver, solve(solver, seed, **kw), cycles the test runs)
ENTRIES = {
    "v2_f32": (_v2, lambda h, s, **kw: h.solve(_scalar(h, s)[0], u0=_scalar(h, s)[1], **kw), 4),
    "v2_bf16": (lambda: _v2(torch.bfloat16),
                lambda h, s, **kw: h.solve(_scalar(h, s)[0], u0=_scalar(h, s)[1], **kw), 4),
    "v2_pswrr": (_v2, lambda h, s, **kw: h.solve(_scalar(h, s)[0], u0=_scalar(h, s)[1],
                                                 use_pswrr=True, **kw), 6),
    "hmg": (_hmg, _hmg_solve, 4),
    "boxmg": (_boxmg, lambda h, s, **kw: h.solve(_scalar(h, s)[0], u0=_scalar(h, s)[1], **kw),
              4),
    "elastic": (_elastic, lambda h, s, **kw: h.solve(_vector(h, s)[0], u0=_vector(h, s)[1],
                                                     **kw), 4),
    "r1": (_r1, lambda h, s, **kw: h.solve(_scalar(h, s)[0], u0=_scalar(h, s)[1], **kw), 4),
}

PCG_ENTRIES = {
    "v2_pcg": (_v2, _scalar),
    "boxmg_pcg": (_boxmg, _scalar),
    "elastic_pcg": (_elastic, _vector),
}


def _assert_bitwise(got, want):
    (ug, hg), (uw, hw) = got, want
    assert ug.dtype == uw.dtype and torch.equal(ug, uw)
    assert hg.dtype == hw.dtype and np.array_equal(hg, hw) and len(hg) == len(hw)


@pytest.mark.parametrize("entry", ENTRIES)
def test_cycle_bodies_read_nothing_back(entry):
    """Four cycles of each fused entry point through the replay path (the
    first chunk eager, the second captured, then replays), every body with
    host reads refused: bit for bit the eager loop, one capture."""
    build, solve, cycles = ENTRIES[entry]
    h = build()
    want = solve(h, 1, eps=0.0, max_cycles=cycles, graph=False)
    h.graphs = EagerGraphs()
    got = solve(h, 1, eps=0.0, max_cycles=cycles)
    _assert_bitwise(got, want)
    # A6 runs max_cycles - 2 steps between its peeled descent and closing
    # ascent, in chunks of 2
    assert h.graphs.captures == 1 and h.graphs.bodies == (2 if entry == "v2_pswrr" else 4)


@pytest.mark.parametrize("entry", PCG_ENTRIES)
def test_pcg_iterations_read_nothing_back(entry):
    """Four CG iterations through the replay path, host reads refused in
    each iteration: bit for bit the eager loop, one capture per parity.  A
    second solve from another u0, five iterations (its last on the other
    parity), equals its eager twin and leaves the first u unchanged."""
    build, fields = PCG_ENTRIES[entry]
    h = build()
    (f, u0), (_, u1) = fields(h, 2), fields(h, 3)
    want = [h.solve_pcg(f, u0=u, eps=0.0, max_iters=k, graph=False)
            for u, k in ((u0, 4), (u1, 5))]
    h.graphs = EagerGraphs()
    got = h.solve_pcg(f, u0=u0, eps=0.0, max_iters=4)
    kept = got[0].clone()
    again = h.solve_pcg(f, u0=u1, eps=0.0, max_iters=5)
    _assert_bitwise(got, want[0])
    _assert_bitwise(again, want[1])
    assert torch.equal(got[0], kept)
    assert len(got[1]) == 4 and h.graphs.captures == 2 and h.graphs.bodies == 9


@pytest.mark.parametrize("chunk", [1, 2, 3])
@pytest.mark.parametrize("case", ["eps_cut", "cap", "odd_nu", "pswrr"])
def test_replay_loop_matches_eager(case, chunk):
    """The shared replay loop against the eager ``solve_cycles``: stopping
    on eps inside a chunk, at the max_cycles cap, with V(2,1) (odd nu1 +
    nu2: the chunk ends with a copy back), and on A6's chunks.  A second
    solve with another f and u0 equals its eager twin and leaves the first
    solve's returned u unchanged."""
    h = _v2()
    kw = dict(eps=0.0, max_cycles=7, chunk=chunk)
    if case == "eps_cut":
        kw.update(eps=1.0, max_cycles=60)
    elif case == "odd_nu":
        kw.update(nu1=2, nu2=1)
    elif case == "pswrr":
        kw.update(use_pswrr=True)
    rng = np.random.default_rng(chunk)
    inputs = [(rng.standard_normal((N + 1, N + 1)).astype(np.float32) * s,
               _decay_u0(10 + k)) for k, s in enumerate((0.0, 1e-3))]
    want = [h.solve(f, u0=u0, graph=False, **kw) for f, u0 in inputs]
    h.graphs = EagerGraphs()
    first = h.solve(*inputs[0][:1], u0=inputs[0][1], **kw)
    kept = first[0].clone()
    second = h.solve(inputs[1][0], u0=inputs[1][1], **kw)
    _assert_bitwise(first, want[0])
    _assert_bitwise(second, want[1])
    assert torch.equal(first[0], kept)
    if case == "eps_cut":  # stopped on eps, inside a chunk for chunk > 1
        assert 1 < len(want[0][1]) < 60 and want[0][1][-1] <= 1.0
    else:  # stopped at the cap: eps = 0 is never met
        assert len(want[0][1]) >= kw["max_cycles"] - 3 and want[0][1].min() > 0.0
    assert h.graphs.captures == 1


def test_hmg_resolve_with_other_params():
    """A second H-MG solve with other u0 and other H-Net kernels (same
    depth) replays the captured chunk on the new kernels' static copy."""
    h = _hmg()
    p1, p2 = _net("hnet_decay_L1_hlNone.npz"), _net("hnet_decay_L1_hl2.npz")
    f = _scalar(h, 0)[0]
    kw = dict(eps=0.0, max_cycles=5, chunk=2)
    want = [h.solve(p, f, u0=_decay_u0(s), graph=False, **kw) for p, s in ((p1, 3), (p2, 4))]
    h.graphs = EagerGraphs()
    first = h.solve(p1, f, u0=_decay_u0(3), **kw)
    kept = first[0].clone()
    second = h.solve(p2, f, u0=_decay_u0(4), **kw)
    _assert_bitwise(first, want[0])
    _assert_bitwise(second, want[1])
    assert torch.equal(first[0], kept) and h.graphs.captures == 1
    assert not np.array_equal(first[1], second[1])


@pytest.mark.parametrize("build", [_v2, _r1], ids=["v2", "r1"])
def test_solve_ir_replays_its_corrections(build):
    """solve_ir's corrections go through the hierarchy's replayed solve;
    its f64 outer steps stay eager: bit for bit the eager solve."""
    h = build()
    f = np.random.default_rng(5).standard_normal((N + 1, N + 1)).astype(np.float32)
    kw = dict(eps=1e-9, cycles_per_correction=3, max_outer=4)
    want = solve_ir(h, f, graph=False, **kw)
    h.graphs = EagerGraphs()
    got = solve_ir(h, f, **kw)
    assert torch.equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    assert h.graphs.captures == 1


@pytest.mark.parametrize("timedep", [False, True], ids=["f_const", "f_knots"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_march_steps_read_nothing_back(dtype, timedep):
    """HeatSolver.march through the replay path, one step a body (the right-
    hand side, then the step's cycles), host reads refused in each: bit for
    bit the eager march, one capture per key; a second march from another
    u0 equals its eager twin and leaves the first u unchanged."""
    hs = HeatSolver(Problem(n=N, inclusion=CIRCLE), 0.01, theta=0.5, backend="fused",
                    kernel_kw=dict(num_levels=4, kernel_threshold=16, dtype=dtype),
                    device="cpu")
    steps = 3
    f = np.random.default_rng(7).standard_normal((N + 1, N + 1)).astype(np.float32)
    if timedep:
        f = np.stack([f * (1.0 + 0.1 * k) for k in range(steps + 1)])
    u0, u1 = _decay_u0(8), _decay_u0(9)
    want = [hs.march(u, f, steps, graph=False) for u in (u0, u1)]
    hs.graphs = EagerGraphs()
    first = hs.march(u0, f, steps)
    kept = first.clone()
    second = hs.march(u1, f, steps)
    assert first.dtype == dtype and torch.equal(first, want[0])
    assert torch.equal(second, want[1]) and torch.equal(first, kept)
    assert hs.graphs.captures == 1 and hs.graphs.bodies == 2 * steps


def test_cpu_runs_the_eager_loop():
    """Off the card ``ChunkGraphs`` is disabled and every entry point runs
    its eager loop, whatever ``graph`` says."""
    h = _v2()
    assert not h.graphs.enabled
    f, u0 = _scalar(h, 6)
    _assert_bitwise(h.solve(f, u0=u0, eps=0.0, max_cycles=3),
                    h.solve(f, u0=u0, eps=0.0, max_cycles=3, graph=False))
    assert h.graphs.captures == 0 and not h.graphs._statics
