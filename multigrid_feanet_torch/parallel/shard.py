"""The fused V-cycle and the H-MG cycle distributed over a process group by
node rows.

Port of ``multigrid_feanet_tpu/parallel/pallas_shard.py``:
``ShardedHierarchyV2`` of ``ShardedPallasHierarchyV2`` (A1-A4 in slab form)
and ``ShardedHMG`` of ``ShardedPallasHMG`` (E2 and E3 in slab form, the
learned H-Net smoother).  The communication is explicit, as in the JAX
module:

- **Row slabs.**  Rank r owns node rows [r Hloc_l, (r + 1) Hloc_l) of every
  sharded level l < S, with ``Hloc_0 = ceil(H_0 / world)`` rounded up to a
  multiple of 2^S and ``Hloc_l = Hloc_0 / 2^l``, so every coarse slab lies
  under its fine slab.  A slab tensor holds its own rows plus ``GHOST`` = 4
  rows of each neighbour above and below, at full width: the rows the legs'
  stencils reach past the slab (A2 reads u 3 rows up, f and the phases 2;
  E2 with an L = 1 chain u L + 3 = 4 rows up and L + 2 = 3 down) land where
  the slab's ghost rows are, and the row-streaming kernels read one
  contiguous field (``ops/sweep.py::SlabLevel``,
  ``ops/hrelax.py::HSlabLevel``).  The JAX module's
  stride-lane layout and its (8, Wp) halo strips are TPU layout; there is no
  counterpart here.
- **Exchange.**  Before a leg reads a field's ghost rows, the rank sends its
  first and last 4 own rows to its neighbours and receives theirs
  (``torch.distributed.batch_isend_irecv`` on contiguous row blocks); the
  global edges get zeros.  The psweep's exchange is issued before the coarse
  subtree and waited for after it, so on NCCL it overlaps the subtree.
- **Exact norms.**  Each slab leg sums its residual norm over the rank's own
  rows; one ``all_reduce`` per cycle adds the ranks' partial norms.  They
  match the single-device norm up to summation order.
- **Agglomeration.**  Levels with fewer than ``shard_below`` elements a side
  are not sharded: one ``all_gather`` rebuilds the coarse right-hand side,
  the base solver's ``_coarse_correction`` solves it redundantly on every
  rank (its fused whole-field levels, the plain subtree, the direct coarse
  solve), and each rank re-slices its rows with no communication.

Per V(1,1) cycle: 2 + 2 (S - 1) exchanges, one all_gather, one all_reduce;
per H-MG cycle 2 + 3 (S - 1) exchanges (``comm_bytes_per_cycle`` counts
their bytes).  On a CUDA device the group must be NCCL, on the CPU gloo;
nothing falls back to the other or to the unsharded solver.

- **One dispatch.**  On the card a solve replays one CUDA graph per chunk
  of cycles (``solvers/common.py::run_cycles`` on the level-0 slabs, the
  solver's own ``ChunkGraphs``): the graph holds the slab kernels, the
  agglomerated subtree and the NCCL collectives of the chunk (the ghost
  exchanges, the ``all_gather``, the ``all_reduce``), and the host reads
  the chunk's norms once per replay -- the port of the JAX classes' one
  jitted ``shard_map`` of a ``while_loop``.  The last ``all_gather`` of u
  runs after the loop, outside the graph.  ``graph=False`` runs the same
  cycles from the host, one collective call at a time; on the CPU (gloo)
  that eager loop always runs.  The capture needs the communicator to
  exist: the first chunk runs eagerly and creates it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from multigrid_feanet_torch.core.device import resolve_device
from multigrid_feanet_torch.core.problem import Problem
from multigrid_feanet_torch.ops.hrelax import SLAB_DEPTH, HSlabLevel
from multigrid_feanet_torch.ops.sweep import Slab
from multigrid_feanet_torch.solvers.common import (ChunkGraphs, chunk_graphs, run_cycles,
                                                   start_fields)
from multigrid_feanet_torch.solvers.hmg import HMGHierarchy
from multigrid_feanet_torch.solvers.jacobi import DEFAULT_OMEGA
from multigrid_feanet_torch.solvers.mg2 import HierarchyV2

# ghost rows above and below a slab: A2 reads u rows -3 .. Hloc + 1 and f and
# the phases rows -2 .. Hloc, E2 with an L = 1 chain u rows -4 .. Hloc + 2;
# an even depth keeps coarse rows under even fine rows
GHOST = 4


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def slab_for(rank: int, hloc: int, hloc_c: int) -> Slab:
    """Rank ``rank``'s :class:`Slab` of a level whose ranks own ``hloc``
    node rows each, over a coarse level whose ranks own ``hloc_c``: its own
    rows and GHOST rows each side, the norm over the own rows, and the
    coarse slab of the own coarse rows and GHOST rows each side."""
    g = rank * hloc - GHOST
    return Slab(g, GHOST, GHOST + hloc, hloc_c + 2 * GHOST, g // 2 - (rank * hloc_c - GHOST))


def slab_window(slab: Slab, coarse: bool = False) -> tuple:
    """(global first row, rows) of a slab, or of the coarse slab under it."""
    if coarse:
        return slab.g // 2 - slab.cro, slab.crows
    return slab.g, slab.hi + GHOST


def start_ops(ops: list) -> list:
    """Issue point-to-point ops together; returns the works to wait for."""
    return dist.batch_isend_irecv(ops) if ops else []


def wait_all(works: list) -> None:
    for w in works:
        w.wait()


def group_backend(device: torch.device) -> str:
    """The process-group backend the sharded solvers take on ``device``."""
    return "nccl" if device.type == "cuda" else "gloo"


def check_group(group, device: torch.device):
    """``group`` (None: the default group) after checking that it exists
    and runs the backend ``device`` takes; raises otherwise."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call parallel.sharding.init_distributed first")
    group = group if group is not None else dist.group.WORLD
    backend, want = dist.get_backend(group), group_backend(device)
    if backend != want:
        raise ValueError(f"a process group on {device} must be {want}, not {backend}")
    return group


def put_rows(out, x, g: int):
    """``out`` (an array or tensor) holding rows [g, g + len(out)) of ``x``,
    zero where they fall off it."""
    out[:] = 0
    lo, hi = max(g, 0), min(g + out.shape[0], x.shape[0])
    if hi > lo:
        out[lo - g : hi - g] = x[lo:hi]
    return out


def cut_rows(x, g: int, rows: int):
    """Rows [g, g + rows) of the array or tensor ``x``, zero off it."""
    shape = (rows,) + tuple(x.shape[1:])
    out = x.new_empty(shape) if torch.is_tensor(x) else np.empty(shape, x.dtype)
    return put_rows(out, x, g)


class ShardedHierarchyV2:
    """:class:`HierarchyV2` distributed over the ranks of ``group`` by node
    rows (the port of ``ShardedPallasHierarchyV2``).

    Levels 0 .. S-1, the fused levels with at least ``shard_below`` elements
    a side (default ``64 * world``), run the slab forms of A1-A4 on each
    rank's rows; the rest is agglomerated.  The fused levels store float32.
    ``device=None`` means CUDA and raises when there is none; the group
    must be NCCL on CUDA and gloo on the CPU.  ``base`` injects a prebuilt
    single-device solver on ``device`` with the V2 layout contract
    (``.hier``, ``.K``, ``.sweep_levels``, ``._fc``, ``._u``,
    ``._coarse_correction``; :class:`ShardedHMG` passes its
    ``HMGHierarchy``); the options that build one are then not used.
    ``graphs`` holds the solves' captured chunks (the base's own
    ``graphs`` are not used)."""

    def __init__(self, problem: Problem, num_levels: Optional[int] = None,
                 omega: float = DEFAULT_OMEGA, kernel_threshold: int = 256,
                 direct_coarse: bool = True, shard_below: Optional[int] = None,
                 dform: Optional[bool] = None, group=None, device=None, base=None):
        device = resolve_device(device)
        self.group = check_group(group, device)
        self.world = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)
        self.device = device
        self.base = base if base is not None else HierarchyV2(
            problem, num_levels=num_levels, omega=omega, kernel_threshold=kernel_threshold,
            direct_coarse=direct_coarse, dform=dform, device=device)
        if self.base.device != device:
            raise ValueError(f"base lives on {self.base.device}, not {device}")
        levels = self.base.hier.levels
        if shard_below is None:
            shard_below = 64 * self.world
        S = 0
        while S < self.base.K and levels[S].n >= shard_below:
            S += 1
        if S < 1:
            raise ValueError(f"the finest level (n={levels[0].n}) is below shard_below="
                             f"{shard_below}: use HierarchyV2 on one device")
        self.S = S
        self.Hloc = [round_up(-(-levels[0].n_nodes // self.world), 1 << S) >> l
                     for l in range(S + 1)]
        # the sharded levels run on the slab buffers below: the base's
        # whole-field right-hand sides and iterates there are never read
        # (its agglomerated subtree keeps its own)
        for l in range(1, S + 1):
            del self.base._fc[l]
        for l in range(1, S):
            del self.base._u[l]
        self.slabs = []
        for l in range(S):
            slab = slab_for(self.rank, self.Hloc[l], self.Hloc[l + 1])
            phase = problem.phase(levels[l].n)
            self.slabs.append(HSlabLevel(
                self.base.sweep_levels[l],
                None if phase is None else cut_rows(phase, *slab_window(slab)), slab))
        # the slab buffers: the right-hand sides of levels 1 .. S (level S's
        # is the agglomerated level's, before the gather), the iterate pairs
        # of levels 1 .. S-1, level S's correction re-sliced for level S-1,
        # the gathered right-hand side of level S and a scratch norm
        self._fc = {l: self._slab(l) for l in range(1, S + 1)}
        self._u = {l: (self._slab(l), self._slab(l)) for l in range(1, S)}
        self._uc = self._slab(S)
        self._gathered = torch.empty((self.world * self.Hloc[S], levels[S].n_nodes),
                                     dtype=torch.float32, device=device)
        self._rsq_scratch = torch.empty((), dtype=torch.float32, device=device)
        self.graphs = ChunkGraphs(device)

    def _rows(self, l: int) -> int:
        return self.Hloc[l] + 2 * GHOST

    def _slab(self, l: int) -> torch.Tensor:
        W = self.base.hier.levels[l].n_nodes
        return torch.zeros((self._rows(l), W), dtype=torch.float32, device=self.device)

    def to_slab(self, l: int, x) -> torch.Tensor:
        """This rank's slab (own rows and ghosts, zero off the grid) of a
        whole field of a sharded level l."""
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        return put_rows(self._slab(l), x, self.slabs[l].slab.g)

    # ---- communication ----

    def _exchange(self, buf: torch.Tensor, l: int) -> list:
        """Start the exchange of a level-l slab's ghost rows: its first and
        last GHOST own rows go to the neighbours, theirs land in its ghost
        rows (zero at the global edges).  Returns the works to wait for."""
        Hl, G = self.Hloc[l], GHOST
        ops = []
        if self.rank > 0:
            up = dist.get_global_rank(self.group, self.rank - 1)
            ops += [dist.P2POp(dist.isend, buf[G : 2 * G], up, self.group, tag=l),
                    dist.P2POp(dist.irecv, buf[:G], up, self.group, tag=l)]
        else:
            buf[:G].zero_()
        if self.rank < self.world - 1:
            down = dist.get_global_rank(self.group, self.rank + 1)
            ops += [dist.P2POp(dist.isend, buf[Hl : Hl + G], down, self.group, tag=l),
                    dist.P2POp(dist.irecv, buf[G + Hl :], down, self.group, tag=l)]
        else:
            buf[G + Hl :].zero_()
        return start_ops(ops)

    def _exchanged(self, buf: torch.Tensor, l: int) -> torch.Tensor:
        wait_all(self._exchange(buf, l))
        return buf

    def _comm_bytes(self, exchanges) -> int:
        """Bytes this rank sends in one cycle that exchanges the ghost rows
        of level l ``exchanges(l)`` times: 4-row ghost blocks to each
        neighbour per exchange, its rows of the agglomerated right-hand
        side, one norm."""
        neighbours = int(self.rank > 0) + int(self.rank < self.world - 1)
        levels = self.base.hier.levels
        ghost = sum(exchanges(l) * neighbours * GHOST * levels[l].n_nodes * 4
                    for l in range(self.S))
        return ghost + self.Hloc[self.S] * levels[self.S].n_nodes * 4 + 4

    def comm_bytes_per_cycle(self, nu1: int = 1, nu2: int = 1) -> int:
        """Bytes this rank sends in one V(nu1, nu2) cycle (:meth:`_comm_bytes`)."""
        return self._comm_bytes(lambda l: nu1 + nu2 if l == 0
                                else 2 + (nu2 - 1 if nu1 == 1 else nu1 - 1 + nu2))

    # ---- the cycle ----

    def _agglomerate(self, fcb: torch.Tensor, solve) -> torch.Tensor:
        """Gather level S's right-hand side, solve its error equation on
        every rank with ``solve(rhs) -> correction`` (the base's subtree),
        return this rank's slab of the correction."""
        S, G = self.S, GHOST
        HS = self.base.hier.levels[S].n_nodes
        dist.all_gather(list(self._gathered.chunk(self.world)), fcb[G : G + self.Hloc[S]],
                        group=self.group)
        uc = solve(self._gathered[:HS])
        return put_rows(self._uc, uc, slab_window(self.slabs[S - 1].slab, coarse=True)[0])

    def _coarse_correction(self, l: int, fcb: torch.Tensor, nu1: int, nu2: int):
        """The distributed ``HierarchyV2._coarse_correction``: the level-l
        correction from a zero guess, on this rank's slab with its ghost
        rows exchanged, for the parent's psweep."""
        if l >= self.S:
            return self._agglomerate(
                fcb, lambda rhs: self.base._coarse_correction(self.S, rhs, nu1, nu2))
        p = self.slabs[l]
        cur, spare = self._u[l]
        rsq = self._rsq_scratch
        self._exchanged(fcb, l)
        if nu1 == 1:
            # the zero-guess legs: u1 lives only inside A3 and A4, so no u
            # exchange on this level
            fcc = p.zsweep_restrict(fcb, out=self._fc[l + 1])
            uc = self._coarse_correction(l + 1, fcc, nu1, nu2)
            p.zpsweep(fcb, uc, out=cur)
        else:
            cur.zero_()  # zero iterate: its ghost rows are zeros already
            for k in range(nu1 - 1):
                p.sweep(self._exchanged(cur, l) if k else cur, fcb, out=spare, rsq=rsq)
                cur, spare = spare, cur
            p.sweep_restrict(self._exchanged(cur, l) if nu1 > 1 else cur, fcb, out=spare,
                             fc_out=self._fc[l + 1], rsq=rsq)
            cur, spare = spare, cur
            works = self._exchange(cur, l)  # rides under the coarse subtree
            uc = self._coarse_correction(l + 1, self._fc[l + 1], nu1, nu2)
            wait_all(works)
            p.psweep(cur, fcb, uc, out=spare, rsq=rsq)
            cur, spare = spare, cur
        for _ in range(nu2 - 1):
            p.sweep(self._exchanged(cur, l), fcb, out=spare, rsq=rsq)
            cur, spare = spare, cur
        return self._exchanged(cur, l)

    def _cycle0(self, u, sp, fb, nu1: int, nu2: int, rsq_pre):
        """One V(nu1, nu2) cycle on this rank's level-0 slab -> (u, spare);
        ``rsq_pre`` gets the summed residual norm^2 of the incoming u."""
        p = self.slabs[0]
        cur, spare, rsq = u, sp, rsq_pre
        for _ in range(nu1 - 1):
            p.sweep(self._exchanged(cur, 0), fb, out=spare, rsq=rsq)
            rsq = self._rsq_scratch
            cur, spare = spare, cur
        p.sweep_restrict(self._exchanged(cur, 0), fb, out=spare, fc_out=self._fc[1], rsq=rsq)
        cur, spare = spare, cur
        works = self._exchange(cur, 0)  # rides under the coarse subtree
        uc = self._coarse_correction(1, self._fc[1], nu1, nu2)
        wait_all(works)
        p.psweep(cur, fb, uc, out=spare, rsq=self._rsq_scratch)
        cur, spare = spare, cur
        for _ in range(nu2 - 1):
            p.sweep(self._exchanged(cur, 0), fb, out=spare, rsq=self._rsq_scratch)
            cur, spare = spare, cur
        dist.all_reduce(rsq_pre, group=self.group)
        return cur, spare

    def _solve(self, cycle, f, u0, bc_value, eps: float, max_cycles: int, chunk: int,
               extra=(), graph: bool = True, key=()):
        """Run ``cycle(u, spare, f, rsq, *extra) -> (u, spare)`` on this
        rank's level-0 slabs (``rsq`` gets the summed residual norm^2 of the
        incoming u) in ``solvers/common.py::run_cycles``; every rank stops
        at the same cycle, the norms being all-reduced.  On the card with
        ``graph`` each chunk is one replay of the graph of ``key``.
        Returns the gathered u (a fresh tensor) and the history."""
        f, u = start_fields(self.base.hier.finest, f, u0, bc_value)
        u, history = run_cycles(cycle, self.to_slab(0, f), self.to_slab(0, u), eps, max_cycles,
                                chunk, extra, chunk_graphs(self, graph), key)
        return self.gather(u), history

    def solve(self, f, u0=None, bc_value=None, nu1: int = 1, nu2: int = 1,
              eps: float = 1e-6, max_cycles: int = 100, chunk: int = 1, graph: bool = True):
        """Distributed V-cycle solve; ``HierarchyV2.solve``'s protocol: every
        rank passes the whole (n+1)^2 ``f`` (and ``u0``), the history stays
        on the device with one host sync per ``chunk`` cycles,
        ``history[j]`` is the residual after cycle j + 1, and ``u`` is one
        cycle (plus up to ``chunk - 1``) ahead.  Returns ``(u, history)``
        with the gathered (n+1)^2 ``u`` on every rank.

        On the card each chunk is one replay of a CUDA graph captured once
        per (nu1, nu2) and chunk, its collectives inside, with one read of
        its norms; ``graph=False`` runs the eager loop, bit for bit the
        same."""
        return self._solve(lambda u, sp, fb, rsq: self._cycle0(u, sp, fb, nu1, nu2, rsq),
                           f, u0, bc_value, eps, max_cycles, chunk, graph=graph,
                           key=("solve", nu1, nu2))

    def gather(self, u: torch.Tensor) -> torch.Tensor:
        """The whole (n+1)^2 level-0 field from every rank's own rows."""
        H = self.base.hier.finest.n_nodes
        full = torch.empty((self.world * self.Hloc[0], H), dtype=torch.float32,
                           device=self.device)
        dist.all_gather(list(full.chunk(self.world)), u[GHOST : GHOST + self.Hloc[0]],
                        group=self.group)
        return full[:H].clone()


class ShardedHMG(ShardedHierarchyV2):
    """:class:`HMGHierarchy` (the learned H-Net smoother) distributed over
    the ranks of ``group`` by node rows (the port of ``ShardedPallasHMG``).

    The base is ``HMGHierarchy(coarse_zero_legs=False)``: per cycle, level 0
    runs E2 (u1 = hrelax(u), the restricted residual, the norm of u) and E3
    (u3 = hrelax(u1 + P(uc))); the coarse levels E2 from a zero iterate and
    E3.  The sharded levels 0 .. S-1 (at least ``shard_below`` elements a
    side, default ``64 * world``) run their slab forms
    (``ops/hrelax.py::HSlabLevel``), the rest is agglomerated into
    ``HMGHierarchy._coarse_correction``.  The slab kernels mask by global
    interior over every slab row, ghost rows too: the chain at a seam reads
    the neighbours' increments, so it is computed past the own rows, and
    the GHOST = 4 ghost rows hold what an L = 1 chain reads there (E2 reads
    u L + 3 rows above and L + 2 below); only the outermost ghost rows are
    wrong, and the exchanges overwrite them before any own row reads them.
    Params of another depth raise ValueError, as the JAX class supports L = 1
    only.  ``device=None`` means CUDA and raises when there is none; the
    group must be NCCL on CUDA and gloo on the CPU."""


    def __init__(self, problem: Problem, num_levels: Optional[int] = None,
                 omega: float = DEFAULT_OMEGA, kernel_threshold: int = 256,
                 direct_coarse: bool = False, shard_below: Optional[int] = None, group=None,
                 device=None):
        device = resolve_device(device)
        check_group(group, device)
        base = HMGHierarchy(problem, num_levels=num_levels, omega=omega,
                            kernel_threshold=kernel_threshold, direct_coarse=direct_coarse,
                            coarse_zero_legs=False, device=device)
        super().__init__(problem, shard_below=shard_below, group=group, device=device, base=base)
        # E2 starts the coarse sharded levels from one zero buffer (never
        # written), viewed at each level's slab shape; the base's whole-field
        # zero iterates there are released
        for l in range(1, self.S):
            del self.base._zero[l]
        self._zeros = self._slab(1).flatten() if self.S > 1 else None

    def _zero_slab(self, l: int) -> torch.Tensor:
        W = self.base.hier.levels[l].n_nodes
        return self._zeros[: self._rows(l) * W].view(self._rows(l), W)

    def comm_bytes_per_cycle(self) -> int:
        """Bytes this rank sends in one H-MG cycle (:meth:`_comm_bytes`):
        level 0 exchanges u and u1, every other sharded level its right-hand
        side, u1 and u3."""
        return self._comm_bytes(lambda l: 2 if l == 0 else 3)

    def _params(self, params) -> torch.Tensor:
        p = self.base._params(params)
        if p.shape[0] != SLAB_DEPTH:
            raise ValueError(f"the sharded H-MG runs an L = {SLAB_DEPTH} chain (its ghost rows "
                             f"hold what that chain reads past a slab), not L = {p.shape[0]}")
        return p

    def _h_coarse_correction(self, l: int, fcb: torch.Tensor, params) -> torch.Tensor:
        """The distributed ``HMGHierarchy._coarse_correction`` with E2 from a
        zero iterate and E3: the level-l correction on this rank's slab with
        its ghost rows exchanged, for the parent's E3."""
        if l >= self.S:
            return self._agglomerate(
                fcb, lambda rhs: self.base._coarse_correction(self.S, rhs, params))
        p = self.slabs[l]
        cur, spare = self._u[l]
        self._exchanged(fcb, l)
        # the zero iterate's ghost rows are zeros: no u exchange
        p.hswrr(self._zero_slab(l), fcb, params, out=spare, fc_out=self._fc[l + 1],
                rsq=self._rsq_scratch)
        works = self._exchange(spare, l)  # u1's ghost rows ride under the coarse subtree
        uc = self._h_coarse_correction(l + 1, self._fc[l + 1], params)
        wait_all(works)
        p.phrelax(spare, fcb, uc, params, out=cur)
        return self._exchanged(cur, l)

    def _h_cycle0(self, u, sp, fb, params, rsq_pre):
        """One H-MG cycle on this rank's level-0 slab -> (u, spare): E2 into
        ``sp``, E3 back into ``u``'s buffer; ``rsq_pre`` gets the summed
        residual norm^2 of the incoming u."""
        p = self.slabs[0]
        p.hswrr(self._exchanged(u, 0), fb, params, out=sp, fc_out=self._fc[1], rsq=rsq_pre)
        works = self._exchange(sp, 0)  # rides under the coarse subtree
        uc = self._h_coarse_correction(1, self._fc[1], params)
        wait_all(works)
        p.phrelax(sp, fb, uc, params, out=u)
        dist.all_reduce(rsq_pre, group=self.group)
        return u, sp

    def solve(self, params, f, u0=None, bc_value=0.0, eps: float = 5e-5,
              max_cycles: int = 100, chunk: int = 1, graph: bool = True):
        """Distributed H-MG solve with the (1, 3, 3) H-Net kernels ``params``
        (tensor or array); ``HMGHierarchy.solve``'s protocol: every rank
        passes the whole (n+1)^2 ``f`` (and ``u0``), ``history[j]`` is the
        residual after cycle j + 1, ``u`` is one cycle (plus up to ``chunk -
        1``) ahead, one host sync per ``chunk`` cycles.  Returns ``(u,
        history)`` with the gathered (n+1)^2 ``u`` on every rank.

        On the card each chunk is one replay of a CUDA graph, its
        collectives inside, which reads a static copy of ``params`` (a
        re-solve with other kernels replays the same graph); ``graph=False``
        runs the eager loop, bit for bit the same."""
        return self._solve(lambda u, sp, fb, rsq, params: self._h_cycle0(u, sp, fb, params, rsq),
                           f, u0, bc_value, eps, max_cycles, chunk, extra=(self._params(params),),
                           graph=graph, key=("hsolve",))
