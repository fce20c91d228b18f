"""Distributed execution: the process group, the ("dp", "x", "y") device
mesh, the 2-D block-partitioned V-cycle, explicit halo exchanges and the
data-parallel H-Net training step.

Port of ``multigrid_feanet_tpu/parallel/sharding.py``, in plain torch ops
(XLA in JAX; no kernel).  JAX lets GSPMD insert the halo exchanges of its
sharded V-cycle and the psums of its norms; here every communication is an
explicit ``torch.distributed`` call on the mesh's groups:

- mesh dims ``("dp", "x", "y")``: data-parallel batch x 2-D spatial
  partition (:func:`make_mesh`; the factorization is the pure
  :func:`mesh_shape`);
- :class:`DistributedHierarchy` partitions each level with at least
  ``replicate_below`` nodes a side into ``x`` x ``y`` blocks of a zero-padded
  buffer; a 1-deep :func:`halo_exchange` precedes every stencil apply,
  restriction and prolongation, an all-gather rebuilds the first level too
  small to shard, and the smaller levels are replicated (the agglomeration
  policy: no communication rides the coarse solve).  Block heights and
  widths halve with the level, so every coarse block lies under its fine
  block and both transfers are block-local.  On the card its solve replays
  one CUDA graph per cycle, the collectives inside (the port of JAX's
  whole-solve jit);
- :func:`shardmap_jacobi_step` and :func:`shardmap_jacobi_step_overlap`, the
  explicit-halo Jacobi sweep and its overlapped form;
- :func:`sharded_hnet_train_step`, the H-Net step with the batch split over
  ``dp`` and the gradients added by ``all_reduce``.

On a CUDA device the process group is NCCL, on the CPU gloo
(:func:`init_distributed`); the CPU tests run gloo ranks.
"""

from __future__ import annotations

import dataclasses
import os
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from multigrid_feanet_torch.core.device import resolve_device
from multigrid_feanet_torch.core.geometry import reset_boundary
from multigrid_feanet_torch.core.problem import GridHierarchy
from multigrid_feanet_torch.ops.stencil import UNIT_S4, UNIT_S9
from multigrid_feanet_torch.parallel.shard import (cut_rows, group_backend, round_up,
                                                   start_ops, wait_all)
from multigrid_feanet_torch.solvers import multigrid
from multigrid_feanet_torch.solvers.common import ChunkGraphs, chunk_graphs
from multigrid_feanet_torch.solvers.jacobi import DEFAULT_OMEGA

MESH_DIMS = ("dp", "x", "y")


def init_distributed(init_method: Optional[str] = None, world_size: Optional[int] = None,
                     rank: Optional[int] = None, device=None) -> int:
    """Bring up the default process group; returns the world size.

    NCCL on a CUDA device (the rank's ``LOCAL_RANK`` one under ``torchrun``),
    gloo on the CPU.  With no arguments and no ``torchrun`` environment a
    single process is a no-op (world 1, no group); an existing group is
    kept.  ``init_method`` is a ``tcp://`` or ``file://`` address; without
    one the ``env://`` variables of ``torchrun`` are read."""
    if dist.is_initialized():
        return dist.get_world_size()
    launched = "WORLD_SIZE" in os.environ and "RANK" in os.environ
    if init_method is None and world_size in (None, 1) and not launched:
        return 1
    if device is None and "LOCAL_RANK" in os.environ and torch.cuda.is_available():
        device = f"cuda:{os.environ['LOCAL_RANK']}"
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(group_backend(device), init_method=init_method or "env://",
                            world_size=-1 if world_size is None else world_size,
                            rank=-1 if rank is None else rank)
    return dist.get_world_size()


def mesh_shape(devices: int, dp: Optional[int] = None, hosts: int = 1) -> tuple:
    """The (dp, x, y) factorization of ``devices``: ``dp`` data-parallel
    replicas (default 1 on one host, one per host on several, so that the
    spatial halo exchanges stay inside a host), and the most square x <= y
    split of the rest."""
    if dp is None:
        dp = hosts if hosts > 1 else 1
    if dp % hosts or devices % dp:
        raise ValueError(f"dp={dp} must divide {devices} devices and be a multiple of "
                         f"{hosts} hosts")
    spatial = devices // dp
    sx = int(np.sqrt(spatial))
    while spatial % sx:
        sx -= 1
    return dp, sx, spatial // sx


def make_mesh(dp: Optional[int] = None, device=None) -> DeviceMesh:
    """A ("dp", "x", "y") mesh over every rank of the default group, ranks
    in order: under ``torchrun`` a host's ranks are consecutive, so dp, the
    outer dim, spans hosts (``LOCAL_WORLD_SIZE`` ranks a host)."""
    device = resolve_device(device)
    world = dist.get_world_size()
    hosts = max(1, world // int(os.environ.get("LOCAL_WORLD_SIZE", world)))
    return init_device_mesh(device.type, mesh_shape(world, dp, hosts),
                            mesh_dim_names=MESH_DIMS)


def _axis(mesh: DeviceMesh, name: str) -> tuple:
    """(group, size, this rank's index) of one mesh dim."""
    return (mesh.get_group(name), mesh.mesh.shape[MESH_DIMS.index(name)],
            mesh.get_local_rank(name))


def _swap_ops(to_next, to_prev, axis) -> tuple:
    """The point-to-point ops that send ``to_next`` to the next rank along
    a mesh dim and ``to_prev`` to the previous one -> (ops, the previous
    rank's ``to_next``, the next rank's ``to_prev``); zeros at the dim's
    ends."""
    group, size, idx = axis
    from_prev, from_next = torch.zeros_like(to_next), torch.zeros_like(to_prev)
    ops = []
    if idx > 0:
        peer = dist.get_global_rank(group, idx - 1)
        ops += [dist.P2POp(dist.isend, to_prev, peer, group),
                dist.P2POp(dist.irecv, from_prev, peer, group)]
    if idx < size - 1:
        peer = dist.get_global_rank(group, idx + 1)
        ops += [dist.P2POp(dist.isend, to_next, peer, group),
                dist.P2POp(dist.irecv, from_next, peer, group)]
    return ops, from_prev, from_next


def _add_columns(body, axis_y) -> torch.Tensor:
    """``body`` with its west and east neighbours' edge columns added."""
    ops, left, right = _swap_ops(body[:, -1:].contiguous(), body[:, :1].contiguous(), axis_y)
    wait_all(start_ops(ops))
    return torch.cat([left, body, right], dim=1)


def halo_exchange(local: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """This rank's (h, w) block with its 1-deep halo from the 4 neighbours
    of the ("x", "y") partition -> (h + 2, w + 2); zeros at the global edge
    (the single-device operator's zero ghosts), corners by the second hop."""
    ops, top, bot = _swap_ops(local[-1:].contiguous(), local[:1].contiguous(),
                              _axis(mesh, "x"))
    wait_all(start_ops(ops))
    return _add_columns(torch.cat([top, local, bot], dim=0), _axis(mesh, "y"))


def _cut(x: torch.Tensor, r0: int, c0: int, h: int, w: int) -> torch.Tensor:
    """The (h, w) window of ``x`` from (r0, c0), zero where it falls off."""
    return cut_rows(cut_rows(x, r0, h).transpose(0, 1), c0, w).transpose(0, 1).contiguous()


def gather_blocks(block: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """Every rank's block of one dp replica, assembled (x blocks down, y
    blocks across)."""
    out = block
    for name, dim in (("x", 0), ("y", 1)):
        group, size, _ = _axis(mesh, name)
        parts = [torch.empty_like(out) for _ in range(size)]
        dist.all_gather(parts, out.contiguous(), group=group)
        out = torch.cat(parts, dim=dim)
    return out


def _all_sum(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """Sum over the ranks of one dp replica's spatial partition."""
    for name in ("x", "y"):
        dist.all_reduce(x, group=_axis(mesh, name)[0])
    return x


class DistributedHierarchy:
    """A :class:`GridHierarchy` (the same on every rank) with a per-level
    partition: levels with at least ``replicate_below`` nodes a side are cut
    into ``x`` x ``y`` blocks of zero-padded buffers, block heights and
    widths halving with the level; smaller levels are replicated and
    unpadded (coarse agglomeration).  Every rank of a dp replica runs the
    same solve on its blocks.  ``graphs`` holds the solve's captured
    cycles."""

    def __init__(self, hier: GridHierarchy, mesh: DeviceMesh, replicate_below: int = 257):
        self.hier = hier
        self.mesh = mesh
        self.replicate_below = replicate_below
        self.graphs = ChunkGraphs(hier.device)
        _, sx, ix = _axis(mesh, "x")
        _, sy, iy = _axis(mesh, "y")
        levels = hier.levels
        S = 0
        while S < len(levels) and self.is_sharded(levels[S].n):
            S += 1
        self.S = S
        H0 = levels[0].n_nodes
        bh, bw = round_up(-(-H0 // sx), 1 << S), round_up(-(-H0 // sy), 1 << S)
        # per sharded level: block shape and origin, and the level with the
        # block's geo and diag and its pattern ids over the block and halo
        self.blocks, self.levels = [], []
        for l in range(S):
            lv, h, w = levels[l], bh >> l, bw >> l
            r0, c0 = ix * h, iy * w
            self.blocks.append((h, w, r0, c0))
            self.levels.append(dataclasses.replace(
                lv, geo=_cut(lv.geo, r0, c0, h, w),
                diag=_cut(lv.diag, r0, c0, h, w) + (1.0 - _cut(
                    torch.ones_like(lv.diag), r0, c0, h, w)),
                pid=None if lv.pid is None else _cut(lv.pid, r0 - 1, c0 - 1, h + 2, w + 2)))
        if S < len(levels):
            self.coarse_block = (bh >> S, bw >> S, ix * (bh >> S), iy * (bw >> S))

    def is_sharded(self, n: int) -> bool:
        return n + 1 >= self.replicate_below

    def block(self, level: int, x) -> torch.Tensor:
        """This rank's block of a whole level field (zero-padded)."""
        h, w, r0, c0 = self.blocks[level]
        return _cut(torch.as_tensor(x, device=self.hier.device), r0, c0, h, w)

    def unblock(self, level: int, x: torch.Tensor) -> torch.Tensor:
        """The whole level field from every rank's block."""
        H = self.hier.levels[level].n_nodes
        return gather_blocks(x, self.mesh)[:H, :H]

    def apply(self, level: int, u: torch.Tensor) -> torch.Tensor:
        """A u on this rank's block (a halo exchange, then the level's
        operator on the haloed block)."""
        return self.levels[level].apply(halo_exchange(u, self.mesh))[1:-1, 1:-1]

    def _jacobi(self, level: int, u, f, bc_value, omega):
        lv = self.levels[level]
        u = reset_boundary(u, lv.geo, bc_value)
        r = f - self.apply(level, u)
        u = u + (omega / lv.diag) * r
        return reset_boundary(u, lv.geo, bc_value)

    def _restrict(self, level: int, r: torch.Tensor) -> torch.Tensor:
        """4 FW(r) on the coarse block under this block (zero off the
        coarse interior): ``restrict_full_weighting``'s columns, then rows."""
        rh = halo_exchange(r, self.mesh)
        c = (rh[:, 0:-2:2] + 2.0 * rh[:, 1:-1:2] + rh[:, 2::2]) * 0.25
        fc = 4.0 * ((c[0:-2:2] + 2.0 * c[1:-1:2] + c[2::2]) * 0.25)
        _, _, r0, c0 = self.blocks[level]
        Hc = self.hier.levels[level + 1].n_nodes
        gi = torch.arange(r0 // 2, r0 // 2 + fc.shape[0], device=fc.device)[:, None]
        gj = torch.arange(c0 // 2, c0 // 2 + fc.shape[1], device=fc.device)[None, :]
        inside = (gi >= 1) & (gi <= Hc - 2) & (gj >= 1) & (gj <= Hc - 2)
        return torch.where(inside, fc, 0.0)

    def _prolong(self, level: int, uc: torch.Tensor) -> torch.Tensor:
        """The masked bilinear prolongation of the coarse block (or of the
        replicated coarse field) onto this block: ``prolong_bilinear``'s
        columns, then rows."""
        h, w, r0, c0 = self.blocks[level]
        if level + 1 < self.S:
            uch = halo_exchange(uc, self.mesh)
        else:
            uch = _cut(uc, r0 // 2 - 1, c0 // 2 - 1, h // 2 + 2, w // 2 + 2)
        cols = torch.stack([uch[:, 1:-1], 0.5 * (uch[:, 1:-1] + uch[:, 2:])], -1).flatten(-2)
        rows = torch.stack([cols[1:-1], 0.5 * (cols[1:-1] + cols[2:])], 1).flatten(0, 1)
        return rows * self.levels[level].geo

    def v_cycle(self, u, f, nu1: int = 1, nu2: int = 1, bc_value=0.0,
                omega: float = DEFAULT_OMEGA, level: int = 0):
        """Recursive V-cycle on blocks down to the replicated levels, which
        run ``solvers/multigrid.py::v_cycle`` on every rank."""
        if level >= self.S:
            return multigrid.v_cycle(self.hier, u, f, nu1, nu2, bc_value, omega, level)
        bc = bc_value if level == 0 else 0.0
        for _ in range(nu1):
            u = self._jacobi(level, u, f, bc, omega)
        if level < len(self.hier.levels) - 1:
            fc = self._restrict(level, f - self.apply(level, u))
            if level + 1 >= self.S:  # the agglomeration: one gather
                Hc = self.hier.levels[level + 1].n_nodes
                fc = gather_blocks(fc, self.mesh)[:Hc, :Hc]
            uc = self.v_cycle(torch.zeros_like(fc), fc, nu1, nu2, 0.0, omega, level + 1)
            u = u + self._prolong(level, uc)
        for _ in range(nu2):
            u = self._jacobi(level, u, f, bc, omega)
        return u

    def res_norm(self, r: torch.Tensor) -> torch.Tensor:
        """The interior residual norm of the level-0 blocks, summed over the
        partition."""
        rr = torch.sum(torch.where(self.levels[0].geo > 0, r * r, 0.0)).reshape(1)
        return torch.sqrt(_all_sum(rr, self.mesh))[0]

    def solve(self, f, u0=None, nu1: int = 1, nu2: int = 1, eps: float = 1e-6,
              max_cycles: int = 100, graph: bool = True):
        """V-cycles to the interior residual ``eps``: ``f`` is the whole
        mass-convolved right-hand side.  Returns ``(u, cycles, res)``, the
        whole u on every rank and the residual after the last cycle; one
        host sync per cycle.

        On the card each cycle is one replay of a CUDA graph captured once
        per (nu1, nu2) and block shape: the V-cycle, its halo exchanges and
        gather, and the all-reduced norm of the new residual into a static
        scalar, which the host reads once per cycle.  The graph runs on
        static copies of the blocks of ``f`` and ``u0`` and allocates its
        temporaries from its own pool.  ``graph=False`` runs the eager loop,
        bit for bit the same."""
        if self.S == 0:
            raise ValueError("no level is sharded: use solvers/multigrid.py::solve")
        f = self.block(0, f)
        u = torch.zeros_like(f) if u0 is None else self.block(0, u0)
        graphs = chunk_graphs(self, graph)
        if graphs is not None:
            key = ("solve", nu1, nu2, f.dtype, u.dtype, tuple(f.shape))
            st = graphs.statics(key, lambda: SimpleNamespace(
                f=torch.empty_like(f), u=torch.empty_like(u),
                res=torch.empty((), dtype=torch.promote_types(f.dtype, u.dtype),
                                device=f.device)))
            st.f.copy_(f)
            st.u.copy_(u)
            f, u = st.f, st.u

            def body():
                new = self.v_cycle(st.u, st.f, nu1, nu2)
                st.res.copy_(self.res_norm(st.f - self.apply(0, new)))
                st.u.copy_(new)

        k, res = 0, float("inf")
        while res > eps and k < max_cycles:
            if graphs is None:
                u = self.v_cycle(u, f, nu1, nu2)
                res = float(self.res_norm(f - self.apply(0, u)))
            else:
                graphs.run(key, body)
                res = float(st.res)  # the one host read per cycle
            k += 1
        return self.unblock(0, u), k, res


# ---- the data-parallel H-Net training step ----


def sharded_hnet_train_step(mesh: DeviceMesh):
    """The H-Net step of ``learn/train_hnet.py::train_step`` with the batch
    split over ``dp``: every rank draws the whole batch's k and start from
    its (identically seeded) state, takes its share of the batch, and
    ``all_reduce`` adds the shares' gradients (the loss is a sum over the
    batch, so their sum is the whole batch's) before the optimizer step.
    Returns ``step(level, state, u_star, f, bc_value, bc_index, k_max=20)
    -> (state, loss)`` with the whole batch's loss."""
    from multigrid_feanet_torch.learn import train_hnet

    group, dp, r = _axis(mesh, "dp")

    def step(level, state, u_star, f, bc_value, bc_index, k_max: int = 20):
        del bc_index
        B = u_star.shape[0]
        if B % dp:
            raise ValueError(f"a batch of {B} does not split over dp={dp}")
        share = slice(r * B // dp, (r + 1) * B // dp)
        k, u0 = train_hnet.draw_start(state, u_star, k_max)
        bc = bc_value[share] if torch.is_tensor(bc_value) and bc_value.dim() == 3 else bc_value
        state.optimizer.zero_grad()
        loss = train_hnet.batch_loss(level, state.params, u_star[share], f[share], bc,
                                     u0[share], k, k_max)
        loss.backward()
        dist.all_reduce(state.params.grad, group=group)
        state.optimizer.step()
        loss = loss.detach().reshape(1)
        dist.all_reduce(loss, group=group)
        return state, loss[0]

    return step


# ---- the explicit-halo Jacobi steps ----


def _bitplane_update(uh, f, pid, row0, col0, H, W, a0, da, omega, bimaterial, r_off=0,
                     c_off=0):
    """One masked omega-Jacobi update of an (h, w) region whose haloed
    window is ``uh`` ((h + 2, w + 2)); ``f`` / ``pid`` are the region's
    tiles and (row0 + r_off, col0 + c_off) its global origin.  The taps of
    the JAX function, in its order."""
    h, w = f.shape
    u = uh[1 : 1 + h, 1 : 1 + w]
    acc = None
    for (dr, dc), wgt in UNIT_S9.items():
        t = (a0 * wgt) * uh[1 + dr : 1 + dr + h, 1 + dc : 1 + dc + w]
        acc = t if acc is None else acc + t
    if bimaterial:
        p = pid.to(torch.int32)
        for e, taps in enumerate(UNIT_S4):
            bit = ((p >> e) & 1).to(u.dtype)
            t4 = None
            for (dr, dc), wgt in taps.items():
                t = wgt * uh[1 + dr : 1 + dr + h, 1 + dc : 1 + dc + w]
                t4 = t if t4 is None else t4 + t
            acc = acc + (da * bit) * t4
        nbits = (p & 1) + ((p >> 1) & 1) + ((p >> 2) & 1) + ((p >> 3) & 1)
        d = (2.0 / 3.0) * (4.0 * a0 + da * nbits.to(u.dtype))
    else:
        d = torch.tensor((8.0 / 3.0) * a0, dtype=u.dtype, device=u.device)
    r = f - acc
    gr = row0 + r_off + torch.arange(h, device=u.device)[:, None]
    gc = col0 + c_off + torch.arange(w, device=u.device)[None, :]
    interior = (gr >= 1) & (gr <= H - 2) & (gc >= 1) & (gc <= W - 2)
    return torch.where(interior, u + (omega / d) * r, u)


def _origin(mesh: DeviceMesh, u: torch.Tensor) -> tuple:
    return _axis(mesh, "x")[2] * u.shape[0], _axis(mesh, "y")[2] * u.shape[1]


def shardmap_jacobi_step(mesh: DeviceMesh, H: int, W: int, a0: float, a1: Optional[float],
                         omega: float = 2.0 / 3.0):
    """The explicit-halo Jacobi sweep over the ("x", "y") partition:
    ``step(u, f, pid) -> u_new`` on this rank's blocks of mesh-divisible
    padded buffers (``DistributedHierarchy``'s level-0 layout without the
    block rounding): a 1-deep :func:`halo_exchange`, the bitplane operator
    on the haloed block, the masked omega/D update."""
    bimaterial = a1 is not None
    da = (a1 - a0) if bimaterial else 0.0

    def step(u, f, pid):
        row0, col0 = _origin(mesh, u)
        return _bitplane_update(halo_exchange(u, mesh), f, pid, row0, col0, H, W, a0, da,
                                omega, bimaterial)

    return step


def shardmap_jacobi_step_overlap(mesh: DeviceMesh, H: int, W: int, a0: float,
                                 a1: Optional[float], omega: float = 2.0 / 3.0):
    """:func:`shardmap_jacobi_step` with the halo exchange overlapped: the
    row halos' sends and receives are issued first, the block's interior
    (rows and columns 1 .. h-2, which need no halo) is computed while they
    are in flight, then the columns are exchanged and the 1-node rim
    updated.  Every node sees the taps of the synchronous step in the same
    order."""
    bimaterial = a1 is not None
    da = (a1 - a0) if bimaterial else 0.0

    def step(u, f, pid):
        h, w = u.shape
        row0, col0 = _origin(mesh, u)
        ops, top, bot = _swap_ops(u[-1:].contiguous(), u[:1].contiguous(), _axis(mesh, "x"))
        works = start_ops(ops)
        out = u.clone()
        out[1 : h - 1, 1 : w - 1] = _bitplane_update(
            u, f[1 : h - 1, 1 : w - 1], None if pid is None else pid[1 : h - 1, 1 : w - 1],
            row0, col0, H, W, a0, da, omega, bimaterial, r_off=1, c_off=1)
        wait_all(works)
        uh = _add_columns(torch.cat([top, u, bot], dim=0), _axis(mesh, "y"))

        def rim(rs, re, cs, ce):
            return _bitplane_update(uh[rs : re + 2, cs : ce + 2], f[rs:re, cs:ce],
                                    None if pid is None else pid[rs:re, cs:ce], row0, col0, H,
                                    W, a0, da, omega, bimaterial, r_off=rs, c_off=cs)

        out[0:1] = rim(0, 1, 0, w)
        out[h - 1 : h] = rim(h - 1, h, 0, w)
        out[1 : h - 1, 0:1] = rim(1, h - 1, 0, 1)
        out[1 : h - 1, w - 1 : w] = rim(1, h - 1, w - 1, w)
        return out

    return step
