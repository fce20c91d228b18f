"""Shared convention of the fused solvers.

Each cycle's first fused sweep emits the squared interior residual norm of
its INCOMING iterate, so the solve loop needs no extra residual pass; the
cost is a one-cycle lag.  :func:`trim_history` turns the raw device history
into the shared convention, as in ``multigrid_feanet_tpu/solvers/common.py``:

- ``history[j]`` = interior residual norm after cycle ``j + 1``;
- ``len(history)`` = cycles to reach ``eps`` (or the recorded cap);
- the returned ``u`` includes at least one extra cycle beyond
  ``history[-1]`` (plus up to ``chunk - 1`` more when chunked).

:func:`solve_cycles` is the solve loop the fused solvers run on it, and
:func:`solve_pcg` the MG-preconditioned flexible CG they share, whose
history is post-iteration (no lag: ``history[-1]`` is the residual of the
returned ``u``).  :func:`run_chunks` is the chunked loop of the plain
solvers, which record post-iteration residuals too.

On the card the fused solvers' loops replay their chunks (:class:`ChunkGraphs`):
each chunk of cycles (one cycle of the round-1 solver, one CG iteration) is
captured once as a CUDA graph and then launched as one graph, with one read
of its norms per chunk -- the port's form of the JAX solvers' one compiled
``while_loop`` per solve.  A replay launches the same kernels on the same
buffers in the same order as the eager loop, so both give the same history
and iterate bit for bit; ``graph=False`` on an entry point runs the eager
loop on the card, and on the CPU the eager loop always runs.

The distributed solvers replay theirs with their NCCL collectives inside
the graph: ``parallel/shard.py``'s ``ShardedHierarchyV2.solve`` and
``ShardedHMG.solve`` run :func:`run_cycles` on their level-0 slabs (one
replay and one read per chunk, the ghost exchanges, the ``all_gather`` and
the ``all_reduce`` captured), and ``parallel/sharding.py``'s
``DistributedHierarchy.solve`` replays one cycle and its all-reduced norm
(one read per cycle).
"""

from __future__ import annotations

import functools
from types import SimpleNamespace

import numpy as np
import torch

from multigrid_feanet_torch.core.geometry import reset_boundary
from multigrid_feanet_torch.ops.sweep import CudaKernel

__all__ = ["ChunkGraphs", "chunk_graphs", "pcg_buffers", "run_chunks", "run_cycles",
           "solve_cycles", "solve_pcg", "start_fields", "trim_history"]


def trim_history(hist, eps: float) -> np.ndarray:
    """Trim a raw residual history to the shared convention.

    ``hist[i]`` = interior residual norm after ``i`` cycles (``hist[0]`` =
    the initial residual), with -1.0 sentinels marking never-written
    entries.  Returns ``history[j]`` = residual after cycle ``j + 1``, cut at
    the first entry ``<= eps``."""
    vals = np.asarray(hist)
    k = int(np.sum(vals >= 0.0))
    below = np.nonzero(vals[:k] <= eps)[0]
    c = int(below[0]) if below.size else k - 1
    return vals[1 : c + 1]


class ChunkGraphs:
    """The chunks a hierarchy's solves replay, one CUDA graph per key, and
    the static buffers each key's chunk reads and writes.  A key names the
    entry point and every argument the chunk's launches depend on (the
    schedule, the chunk, the storage type and the shapes); a graph reads the
    addresses it was captured with and every Python value it baked in.

    ``run(key, body)`` runs ``body`` once.  ``body`` reads and writes only
    the key's static buffers (and the hierarchy's own level buffers), binds
    every value it depends on when it is made (a replay repeats the first
    body's launches, whatever a later body would do) and never reads the
    device from the host.  At the key's first call it runs eagerly, as real
    work of the caller's solve, on the capture stream: it loads the
    kernels, sets their attributes, fills their scratch, strips and
    workspaces and creates the cuBLAS handle of the coarse product, so that
    the capture records launches only.  At the second call it is
    captured (the TF32 settings then in force are the ones the graph keeps)
    and replayed; after that it is replayed.  A capture or replay that fails
    raises.  The launches recorded at capture are taken off the kernels'
    counts again, and each replay adds them to ``launches`` and
    ``replayed`` (``ops/sweep.py::CudaKernel``).

    ``enabled`` is False off the card: solvers then run their eager loops
    (:func:`chunk_graphs`)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.enabled = self.device.type == "cuda"
        self.captures = 0
        self._statics = {}
        self._replays = {}
        self._stream = None

    def statics(self, key, make):
        """The static buffers of ``key``, made by ``make()`` at its first use."""
        st = self._statics.get(key)
        if st is None:
            st = self._statics[key] = make()
        return st

    def run(self, key, body) -> None:
        if key not in self._replays:
            self._warm(body)
            self._replays[key] = None
            return
        replay = self._replays[key]
        if replay is None:
            replay = self._replays[key] = self._capture(body)
            self.captures += 1
        replay()

    def _capture_stream(self):
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return self._stream

    def _warm(self, body) -> None:
        stream, main = self._capture_stream(), torch.cuda.current_stream(self.device)
        stream.wait_stream(main)
        with torch.cuda.stream(stream):
            body()
        main.wait_stream(stream)

    def _capture(self, body):
        kernels = CudaKernel.instances
        before = [k.launches for k in kernels]
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, stream=self._capture_stream()):
                body()
        finally:
            counts = [(k, k.launches - n) for k, n in zip(kernels, before) if k.launches != n]
            for k, n in zip(kernels, before):
                k.launches = n

        def replay():
            graph.replay()
            for k, n in counts:
                k.launches += n
                k.replayed += n

        return replay


def chunk_graphs(solver, graph: bool):
    """``solver.graphs`` when the solve replays its chunks (``graph`` and a
    :class:`ChunkGraphs` that captures: on the card), else None (the eager
    loop)."""
    return solver.graphs if graph and solver.graphs.enabled else None


def run_chunks(run, u, max_iters: int, chunk: int, eps):
    """``run(u, k) -> (u, norms)`` (k iterations and their post-iteration
    residual norms on the device) in chunks until a norm reaches ``eps``
    (None = never), ``max_iters`` or a non-finite norm: one host sync per
    chunk.  Returns ``(u, history)`` with the history cut at the first norm
    ``<= eps``; ``u`` carries that whole chunk, as in the JAX solvers."""
    history, done = [], 0
    while done < max_iters:
        k = min(chunk, max_iters - done)
        u, norms = run(u, k)
        norms = norms.cpu().numpy()
        history.append(norms)
        done += k
        if eps is not None and (norms <= eps).any():
            history[-1] = norms[: int(np.argmax(norms <= eps)) + 1]
            break
        if not np.isfinite(norms[-1]):
            break
    return u, np.concatenate(history)


def start_fields(finest, f, u0=None, bc_value=None, dtype=torch.float32):
    """``(f, u)`` as contiguous tensors of the storage type ``dtype`` on the
    finest level's device: ``u`` is ``u0`` (zero if None) with its boundary
    set to ``bc_value``, in f32, then rounded to ``dtype`` as the JAX
    solvers' ``pad`` rounds it."""
    dev = finest.device
    f = torch.as_tensor(f, dtype=torch.float32, device=dev)
    u = torch.zeros_like(f) if u0 is None else torch.as_tensor(
        u0, dtype=torch.float32, device=dev)
    u = reset_boundary(u, finest.geo, 0.0 if bc_value is None else bc_value)
    return f.to(dtype).contiguous(), u.to(dtype).contiguous()


def solve_cycles(cycle, finest, f, u0=None, bc_value=None, eps: float = 1e-6,
                 max_cycles: int = 100, chunk: int = 1, dtype=torch.float32, extra=(),
                 graphs=None, key=()):
    """Run ``cycle(u, spare, f, rsq, *extra) -> (u_new, spare_new)`` on the
    finest level until the residual norm reaches ``eps``.

    ``cycle`` writes into ``rsq`` the squared interior residual norm of the
    iterate ENTERING it.  ``f`` is the (..., n+1, n+1) RHS (tensor or
    array; a scalar field, or the (2, n+1, n+1) displacement RHS of the
    elastic solver) and ``u0`` the initial iterate of the same shape (zero
    if None), whose boundary is set to ``bc_value``; both are stored as
    ``dtype`` (the fused levels' storage type), the history in f32.
    ``extra`` are further tensors the cycle reads (the H-Net kernels).  The
    loop is :func:`run_cycles`; with ``graphs`` the returned ``u`` is a copy
    of the static iterate.
    Returns ``(u, history)`` in the convention of :func:`trim_history`."""
    f, u = start_fields(finest, f, u0, bc_value, dtype)
    u, history = run_cycles(cycle, f, u, eps, max_cycles, chunk, extra, graphs, key)
    return (u if graphs is None else u.clone()), history


def run_cycles(cycle, f, u, eps: float, max_cycles: int, chunk: int, extra=(), graphs=None,
               key=()):
    """:func:`solve_cycles`' loop on the started fields ``f`` and ``u`` (the
    sharded solvers pass their level-0 slabs).  The history stays on the
    device, with -1 sentinels, and is read back once per ``chunk`` cycles:
    one host sync per chunk.

    With ``graphs`` (a :class:`ChunkGraphs`) each chunk is one replay of the
    graph of ``key`` (extended by the chunk, the storage type and the
    shapes) on static copies of ``f``, ``u`` and ``extra``, and the chunk's
    norms are read back once per replay; the returned ``u`` is then the
    key's static iterate, which the next solve overwrites: the caller
    copies it.  Returns ``(u, history)`` as :func:`solve_cycles`."""
    eps32 = float(np.float32(eps))  # the f32 comparison of the JAX loop
    if graphs is not None:
        return _replay_cycles(graphs, key, cycle, f, u, tuple(extra), eps, eps32, max_cycles,
                              chunk)
    sp = torch.empty_like(u)
    rsq = torch.empty((), dtype=torch.float32, device=u.device)
    hist = torch.full((max_cycles + chunk,), -1.0, dtype=torch.float32, device=u.device)
    k, res = 0, float("inf")
    while res > eps32 and k < max_cycles:
        for _ in range(chunk):
            u, sp = cycle(u, sp, f, rsq, *extra)
            # rsq is the residual of the state ENTERING this cycle, i.e.
            # after k completed cycles
            torch.sqrt(rsq, out=hist[k])
            k += 1
        res = float(hist[k - 1])
    return u, trim_history(hist.cpu().numpy(), eps)


def _replay_cycles(graphs, key, cycle, f, u, extra, eps, eps32, max_cycles, chunk):
    """:func:`run_cycles`' loop on replayed chunks; returns the static
    iterate."""
    key = (key, chunk, u.dtype, tuple(u.shape)) + tuple(tuple(x.shape) for x in extra)
    st = graphs.statics(key, lambda: SimpleNamespace(
        f=torch.empty_like(f), u=(torch.empty_like(u), torch.empty_like(u)),
        extra=tuple(torch.empty_like(x) for x in extra),
        rsq=torch.empty((), dtype=torch.float32, device=f.device),
        norms=torch.empty(chunk, dtype=torch.float32, device=f.device)))
    st.f.copy_(f)
    st.u[0].copy_(u)
    for s, x in zip(st.extra, extra):
        s.copy_(x.detach())

    def body():
        u, sp = st.u
        for i in range(chunk):
            u, sp = cycle(u, sp, st.f, st.rsq, *st.extra)
            torch.sqrt(st.rsq, out=st.norms[i])
        if u is not st.u[0]:  # an odd number of swaps: back to the pair's first buffer
            st.u[0].copy_(u)

    hist = np.full(max_cycles + chunk, -1.0, dtype=np.float32)
    k, res = 0, float("inf")
    while res > eps32 and k < max_cycles:
        graphs.run(key, body)
        hist[k : k + chunk] = st.norms.cpu().numpy()  # the one host sync per chunk
        k += chunk
        res = float(hist[k - 1])
    return st.u[0], trim_history(hist, eps)


def pcg_buffers(like: torch.Tensor) -> dict:
    """The vectors of :func:`solve_pcg`, shaped like ``like``, the zero
    right-hand side its operator apply runs the residual leg against, and
    its scalars: the squared norms, r.z and the (norm, r.z) pair it reads
    back once per iteration."""
    def field():
        return torch.empty_like(like)

    def scalar():
        return torch.empty((), dtype=torch.float32, device=like.device)

    return dict(r=(field(), field()), p=field(), ap=field(), tmp=field(),
                zero=field().zero_(), rsq=scalar(), rsq_ap=scalar(), rz=scalar(),
                read=torch.empty(2, dtype=torch.float32, device=like.device))


def solve_pcg(level0, precond, f, u, bufs: dict, eps: float, max_iters: int,
              graphs=None, key=()):
    """Flexible CG from ``u`` on the finest level.

    ``level0.residual(u, f, out=, rsq=)`` writes the interior-masked
    f - A u and its squared norm; ``A p`` is the negated residual of ``p``
    against a zero right-hand side, on the same kernel.  ``precond(r)``
    returns the preconditioned residual (a buffer it may overwrite at its
    next call, the same buffer at every call).  ``bufs`` comes from
    :func:`pcg_buffers`.  Each iteration replaces the residual by the true
    one (the f32 recurrence drifts), takes the Polak-Ribiere beta clipped
    at 0 (PR+: restart with p = z when conjugacy is lost under the varying
    preconditioner), and stops on ``eps``, ``max_iters`` or the breakdown
    guards ``rz > 0`` and ``res < 4 best`` (at the f32 floor the recurrences
    turn to noise and CG would diverge).  The loop reads two scalars back
    once per iteration and tests the guards on the host.

    Without ``graphs`` ``u`` is updated in place and returned.  With
    ``graphs`` (a :class:`ChunkGraphs`) ``f`` and ``u`` are copied to static
    buffers, each iteration after the start is one replay of one of two
    graphs (``key`` and the parity of the iteration: the two residual
    buffers trade places each iteration) and the returned ``u`` is a copy.

    Returns ``(u, history)``: ``history[j]`` is the interior residual norm
    after iteration j+1 (post-iteration, no lag)."""
    r_a, r_b = bufs["r"]
    pb, ap, tmp, rsq, rz, read = (bufs[k] for k in ("p", "ap", "tmp", "rsq", "rz", "read"))
    if graphs is not None:
        key = (key, u.dtype, tuple(u.shape))
        st = graphs.statics(key, lambda: SimpleNamespace(f=torch.empty_like(f),
                                                         u=torch.empty_like(u)))
        st.f.copy_(f)
        st.u.copy_(u)
        f, u = st.f, st.u

    def dot(a, b):
        return torch.dot(a.view(-1), b.view(-1))

    def load():  # the (norm, r.z) pair the loop reads back
        torch.sqrt(rsq, out=read[0])
        read[1].copy_(rz)

    def step(r_cur, r_old):
        """One iteration from the residual in ``r_cur``; the new one goes to
        ``r_old``."""
        level0.residual(pb, bufs["zero"], out=ap, rsq=bufs["rsq_ap"])
        ap.neg_()
        alpha = rz / dot(pb, ap)
        torch.mul(pb, alpha, out=tmp)
        u.add_(tmp)
        level0.residual(u, f, out=r_old, rsq=rsq)
        z = precond(r_old)
        rz_new = dot(z, r_old)
        beta = torch.clamp_min((rz_new - dot(z, r_cur)) / rz, 0.0)
        torch.mul(pb, beta, out=tmp)
        torch.add(z, tmp, out=pb)
        rz.copy_(rz_new)
        load()

    level0.residual(u, f, out=r_a, rsq=rsq)
    z = precond(r_a)
    pb.copy_(z)
    rz.copy_(dot(z, r_a))
    load()
    res_h, rz_h = read.cpu().numpy()
    eps32, best = np.float32(eps), np.float32(np.inf)
    hist = []
    while (res_h > eps32 and len(hist) < max_iters and rz_h > 0.0
           and res_h < np.float32(4.0) * best):
        pair = (r_a, r_b) if len(hist) % 2 == 0 else (r_b, r_a)
        if graphs is None:
            step(*pair)
        else:
            graphs.run(key + (len(hist) % 2,), functools.partial(step, *pair))
        res_h, rz_h = read.cpu().numpy()  # the one host sync per iteration
        best = min(best, res_h)
        hist.append(res_h)
    return (u if graphs is None else u.clone()), np.asarray(hist, dtype=np.float32)
