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
"""

from __future__ import annotations

import numpy as np
import torch

from multigrid_feanet_torch.core.geometry import reset_boundary

__all__ = ["pcg_buffers", "run_chunks", "solve_cycles", "solve_pcg", "start_fields",
           "trim_history"]


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
                 max_cycles: int = 100, chunk: int = 1, dtype=torch.float32):
    """Run ``cycle(u, spare, f, rsq) -> (u_new, spare_new)`` on the finest
    level until the residual norm reaches ``eps``.

    ``cycle`` writes into ``rsq`` the squared interior residual norm of the
    iterate ENTERING it.  ``f`` is the (..., n+1, n+1) RHS (tensor or
    array; a scalar field, or the (2, n+1, n+1) displacement RHS of the
    elastic solver) and ``u0`` the initial iterate of the same shape (zero
    if None), whose boundary is set to ``bc_value``; both are stored as
    ``dtype`` (the fused levels' storage type), the history in f32.  The
    history stays on the device, with -1 sentinels, and is read back once
    per ``chunk`` cycles: one host sync per chunk.
    Returns ``(u, history)`` in the convention of :func:`trim_history`."""
    dev = finest.device
    f, u = start_fields(finest, f, u0, bc_value, dtype)
    sp = torch.empty_like(u)
    rsq = torch.empty((), dtype=torch.float32, device=dev)
    hist = torch.full((max_cycles + chunk,), -1.0, dtype=torch.float32, device=dev)
    eps32 = float(np.float32(eps))  # the f32 comparison of the JAX loop
    k, res = 0, float("inf")
    while res > eps32 and k < max_cycles:
        for _ in range(chunk):
            u, sp = cycle(u, sp, f, rsq)
            # rsq is the residual of the state ENTERING this cycle, i.e.
            # after k completed cycles
            torch.sqrt(rsq, out=hist[k])
            k += 1
        res = float(hist[k - 1])
    return u, trim_history(hist.cpu().numpy(), eps)


def pcg_buffers(like: torch.Tensor) -> dict:
    """The vectors of :func:`solve_pcg`, shaped like ``like``, and the zero
    right-hand side its operator apply runs the residual leg against."""
    def field():
        return torch.empty_like(like)

    def scalar():
        return torch.empty((), dtype=torch.float32, device=like.device)

    return dict(r=(field(), field()), p=field(), ap=field(), tmp=field(),
                zero=field().zero_(), rsq=scalar(), rsq_ap=scalar())


def solve_pcg(level0, precond, f, u, bufs: dict, eps: float, max_iters: int):
    """Flexible CG from ``u`` (updated in place) on the finest level.

    ``level0.residual(u, f, out=, rsq=)`` writes the interior-masked
    f - A u and its squared norm; ``A p`` is the negated residual of ``p``
    against a zero right-hand side, on the same kernel.  ``precond(r)``
    returns the preconditioned residual (a buffer it may overwrite at its
    next call).  ``bufs`` comes from :func:`pcg_buffers`.  Each iteration
    replaces the residual by the true one (the f32 recurrence drifts),
    takes the Polak-Ribiere beta clipped at 0 (PR+: restart with p = z when
    conjugacy is lost under the varying preconditioner), and stops on
    ``eps``, ``max_iters`` or the breakdown guards ``rz > 0`` and
    ``res < 4 best`` (at the f32 floor the recurrences turn to noise and CG
    would diverge).

    Returns ``(u, history)``: ``history[j]`` is the interior residual norm
    after iteration j+1 (post-iteration, no lag).  The loop reads two
    scalars back once per iteration."""
    r_cur, r_old = bufs["r"]
    pb, ap, tmp, rsq = bufs["p"], bufs["ap"], bufs["tmp"], bufs["rsq"]

    def dot(a, b):
        return torch.dot(a.view(-1), b.view(-1))

    def read(res, rz):
        return torch.stack([res, rz]).cpu().numpy()

    level0.residual(u, f, out=r_cur, rsq=rsq)
    z = precond(r_cur)
    pb.copy_(z)
    rz = dot(z, r_cur)
    res_h, rz_h = read(torch.sqrt(rsq), rz)
    eps32, best = np.float32(eps), np.float32(np.inf)
    hist = []
    while (res_h > eps32 and len(hist) < max_iters and rz_h > 0.0
           and res_h < np.float32(4.0) * best):
        level0.residual(pb, bufs["zero"], out=ap, rsq=bufs["rsq_ap"])
        ap.neg_()
        alpha = rz / dot(pb, ap)
        torch.mul(pb, alpha, out=tmp)
        u.add_(tmp)
        r_cur, r_old = r_old, r_cur
        level0.residual(u, f, out=r_cur, rsq=rsq)
        z = precond(r_cur)
        rz_new = dot(z, r_cur)
        beta = torch.clamp_min((rz_new - dot(z, r_old)) / rz, 0.0)
        torch.mul(pb, beta, out=tmp)
        torch.add(z, tmp, out=pb)
        rz = rz_new
        res_h, rz_h = read(torch.sqrt(rsq), rz)
        best = min(best, res_h)
        hist.append(res_h)
    return u, np.asarray(hist, dtype=np.float32)
