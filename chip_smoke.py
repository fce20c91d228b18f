#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. Print the card's name and power limit; build the CUDA kernels from
   ``multigrid_feanet_torch/csrc`` (one nvcc per source, all at once) and
   print the build time.
2. Hold each kernel of ``ops/sweep.py`` (A1 in its sweep, residual and
   psweep modes, A2, A3, A4) against its plain PyTorch version on the card,
   at ``ops.sweep.TOL``: at the shapes of both solves below (4097^2 and
   2049^2, bi-material and homogeneous), on a 4097^2 bi-material level in
   plain form, and on n = 512 levels.  Time both with CUDA events around a
   run of launches (the kernel's captured in a CUDA graph), on inputs
   rotated to exceed the L2 cache.
3. The main path of ``solvers/mg2.py``: the 4097^2 bi-material interface
   solve (circle r = 0.5, coefficients (1, 20), 9 levels, kernel threshold
   32, direct coarse solve, f = 0, u0 = 150000 * uniform(rng 0) * geo, eps
   1e-6, at most 120 cycles, chunk 2), then the homogeneous 4097^2 Poisson
   solve from the same u0.  Each solve must converge, leave a true residual
   below 2 eps and launch each of A1-A4; the launch counts are zeroed just
   before each solve and read just after.  A 129^2 interface solve on the
   card is held against the same solve on the CPU's plain path.
4. BoxMG setup on the card: the 4097^2 interface hierarchy (9 levels) and
   ``ops.boxmg.boxmg_setup`` in f32, with its seconds and peak memory.
5. Hold each kernel of ``ops/general.py`` against its plain version, at
   ``ops.general.TOL``, on the real operator from phase 4, in bf16 and f32
   planes: D2 and D3 on the bi-material level 0 at 4097^2; D4, D5 and D1
   (sweep and residual) on level 1 at 2049^2; D2 and D3 on the planes of
   the n = 512 level.  Timed as in phase 2.
6. The BoxMG path of ``solvers/boxmg.py``, ``boxmg_4097``: the same problem
   and u0 as ``interface_4097``, the phase-4 setup, bf16 coefficient
   planes, at most 60 cycles; it must converge, leave a true residual below
   2 eps, repeat its history, and launch each of D2-D5.  Then a 129^2 BoxMG
   V(2,1) solve (bc 0.7) on the card against the CPU's plain path, with the
   card's and the CPU's setup compared; it must launch D1.
7. Hold each kernel of ``ops/hrelax.py`` (E2-E5) against its plain version,
   at ``ops.hrelax.TOL``, with the repository's H-Net checkpoints: E2 and E3
   at 4097^2, E4 and E5 at 2049^2 (homogeneous in plain form and
   bi-material in difference form, the L = 1 net), and all four at n = 512
   (bi-material and homogeneous, the L = 3 net).  Timed as in phase 2.
8. The H-MG path of ``solvers/hmg.py``: ``hmg_4097``, the homogeneous
   4097^2 decay solve (same u0, 9 levels, threshold 32, direct coarse,
   plain form) with the L = 1 net of
   ``results/learn_iterator/hnet_decay_L1_hlNone.npz``, at most 40 cycles;
   then ``hmg_interface_4097``, the interface problem with the same net in
   difference form, at most 60 cycles.  Each must converge, leave a true
   residual below 2 eps, repeat its history and launch each of E2-E5.  Then
   three 129^2 bi-material H-MG solves on the card against the CPU's plain
   path: the L = 3 net with ``h_levels=1`` (launching A3/A4 below level 0),
   the L = 3 net with ``coarse_zero_legs=False`` (E2/E3 on every kernel
   level), and the L = 1 net with a boundary value of 0.7.
9. Hold each kernel of ``ops/elastic.py`` (G1 in its sweep and residual
   modes, G2-G5) against its plain version, at ``ops.elastic.TOL``, on the
   plane-stress operator of ``Plane_Stress_modify.m`` (E = 212e3, nu =
   0.288, coefficients (1, 20)): at 2049^2 bi-material (circle) and
   homogeneous, at 1025^2 (level 1) and at n = 128.  Timed as in phase 2.
10. The elastic path of ``solvers/elastic.py`` at 2049^2 (circle r = 0.5,
   9 levels, kernel threshold 16, direct coarse solve at n = 8, f = 0,
   u0 standard normal from rng 1, eps 0): ``elastic_2049``, V(2,2) for 4,
   12 and 60 cycles (ms/cycle = (t12 - t4) / 8, tail q of the last 4
   ratios, asymptotic q of the last 8); ``elastic_pcg_2049``, the
   MG-preconditioned flexible CG for 16 iterations (contraction, drop,
   history against the true residual); ``elastic_v11_2049``, V(1,1) for 12
   cycles.  Each must launch its kernels the expected number of times,
   stay finite and repeat its history over 3 runs.  Then ``elastic_2049``
   once more with the bench's kernel threshold of 512.
11. Three 129^2 bi-material elastic solves on the card against the CPU's
   plain path: V(2,2), V(1,1) and the PCG, to eps 1e-2.
12. Print the kernel summary line (one row per kernel and path, with the
   path's launch counts), then the device line as the last line.

Each 4097^2 solve and each elastic cell also reports its device time per
kernel from torch.profiler and the busy share of its wall time.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
L2_BYTES = 50 * 2**20  # H100 SXM L2 cache
FP32_FLOP_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
# f32 operations per fine node of each kernel, counted from csrc/sweep.cu for
# the bi-material difference form (A1, A2) and plain form (A3, A4): the
# stencil apply(s), the masked residual, the Jacobi update and the transfer.
# The homogeneous forms do fewer, so these counts bound theirs from above;
# the byte time exceeds the operation time either way.
FLOPS_PER_NODE = {"A1": 48, "A2": 100, "A3": 45, "A4": 50}
# A5 and A6, counted the same way: one apply, the masked residual, its
# square and a quarter of the restriction (A5); three applies, two Jacobi
# updates, the prolongation, the residual norm and the restriction (A6).
FLOPS_PER_NODE.update({"A5": 50, "A6": 150})
# D1-D5, counted from csrc/general.cu: the 9-plane apply is 17 operations,
# the bi-material difference-form apply ~35, a W4 prolongation 7 and a W4
# restriction 17 per coarse node; D2/D3 counted for the bi-material
# operator, which bounds their general mode from above.
FLOPS_PER_NODE.update({"D1": 24, "D2": 85, "D3": 47, "D4": 25, "D5": 31})
# E2-E5, counted from csrc/hrelax.cu per fine node: HRELAX_FLOPS[leg] is
# (operator applies, other operations, conv chains); an apply costs
# APPLY_FLOPS[(bim, dform)], the others are the Jacobi update, increments,
# prolongation and restriction, and each conv layer of a chain costs 18.
APPLY_FLOPS = {(True, True): 44, (True, False): 33, (False, True): 27, (False, False): 12}
HRELAX_FLOPS = {"E2": (2, 12, 1), "E3": (1, 10, 1), "E4": (1, 10, 1), "E5": (1, 16, 2)}
# G1-G5, counted from csrc/elastic.cu per fine node: an operator apply of
# both components is 98 operations, the block-Jacobi update 14, the residual
# and its square 6, the zero-guess iterate 20, the prolongation of both
# components 6 and their restriction 7 (26 per coarse node).
FLOPS_PER_NODE.update({"G1": 118, "G2": 225, "G3": 124, "G4": 127, "G5": 144})
HNET_L1 = "results/learn_iterator/hnet_decay_L1_hlNone.npz"
HNET_L3 = "results/learn_iterator/hnet_decay.npz"
HNET_L3_HL1 = "results/learn_iterator/hnet_decay_L3_hl1.npz"
DEVICE = "cuda"
N_MAIN, N_COARSE, N_SMALL = 4096, 512, 128
CIRCLE = ("circle", (0.0, 0.0), 0.5)
N_EL = 2048  # the elastic cells: 2049^2 nodes (bench.py:296)
E_EL, NU_EL = 212e3, 0.288  # Plane_Stress_modify.m:11-12


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def kernel_ms(runs, reps: int = 50) -> float:
    """Device time of one launch: ``reps`` launches, cycling over ``runs``
    (one closure per input set), captured in a CUDA graph and replayed
    between one pair of CUDA events, over ``reps``.  The graph takes the
    host's per-call cost out of the device's timeline.  Median of 3."""
    import torch

    for run in runs:  # loads the kernels and fills the workspace
        run()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            runs[i % len(runs)]()
    graph.replay()
    times = []
    for _ in range(3):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return float(np.median(times))


def plain_ms(runs, reps: int = 20) -> float:
    """Time of one call of a plain version: ``reps`` back-to-back calls,
    cycling over ``runs``, between one pair of CUDA events, over ``reps``."""
    import torch

    for run in runs:
        run()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for i in range(reps):
        runs[i % len(runs)]()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def level_inputs(n: int, bim: bool, seed: int):
    """Fields of one level on the card: u at the main path's scale, f and
    the coarse correction standard normal, the circle's phase map."""
    import torch
    from multigrid_feanet_torch.core.geometry import circle_phase

    rng = np.random.default_rng(seed)
    H, Hc = n + 1, n // 2 + 1
    geo = np.zeros((H, H), np.float32)
    geo[1:-1, 1:-1] = 1.0
    u = (150000.0 * rng.uniform(size=(H, H))).astype(np.float32) * geo
    f = rng.standard_normal((H, H)).astype(np.float32)
    uc = rng.standard_normal((Hc, Hc)).astype(np.float32)
    ph = circle_phase(2.0, n) if bim else None
    return tuple(None if x is None else torch.as_tensor(x, device=DEVICE)
                 for x in (u, f, uc, ph))


def bytes_moved(name: str, n: int, bim: bool) -> int:
    """Bytes a kernel must move: each input read once, each output written
    once (f32 fields, int8 phase, f32 coarse fields)."""
    H2, Hc2, ph = (n + 1) ** 2, (n // 2 + 1) ** 2, n * n if bim else 0
    return {
        "A1_sweep": 4 * H2 * 3 + ph,
        "A1_residual": 4 * H2 * 3 + ph,
        "A1_psweep": 4 * H2 * 3 + ph + 4 * Hc2,
        "A2": 4 * H2 * 3 + ph + 4 * Hc2,
        "A3": 4 * H2 + ph + 4 * Hc2,
        "A4": 4 * H2 * 2 + ph + 4 * Hc2,
        "A5": 4 * H2 * 2 + ph + 4 * Hc2,
        "A6": 4 * H2 * 3 + ph + 4 * Hc2 * 2,
    }[name]


def stencil_bytes(n: int, bim: bool) -> int:
    """Bytes one pass of C1 or C2 must move: u and f read, the output
    written (f32), the (n+1)^2 int8 pattern ids read when two-phase."""
    H2 = (n + 1) ** 2
    return 4 * H2 * 3 + (H2 if bim else 0)


def stencil_flops(sweeps: int, pid) -> float:
    """f32 operations per node of ``sweeps`` sweeps of C1/C2 on this data,
    counted from csrc/stencil.cu: the S9 taps (17), the masked residual and
    its square (3), the update (3) and, when two-phase, the diagonal (4) and
    9 per set bit of the node's pattern id (its element's S4 taps)."""
    if pid is None:
        return sweeps * 23.0
    bits = sum(float(((pid.int() >> e) & 1).sum()) for e in range(4))
    return sweeps * (27.0 + 9.0 * bits / pid.numel())


def general_bytes(leg: str, n: int, bim: bool, coef_bytes: int) -> int:
    """Bytes a kernel of ``ops/general.py`` must move: each input read once,
    each output written once (f32 fields, int8 phase or 9 coefficient
    planes, 4 weight planes of ``coef_bytes`` each, f32 coarse fields)."""
    H2, Hc2 = (n + 1) ** 2, (n // 2 + 1) ** 2
    op = n * n if bim else 9 * coef_bytes * H2
    w4 = 4 * coef_bytes * H2
    return {
        "D1_sweep": 4 * H2 * 3 + op,
        "D1_residual": 4 * H2 * 3 + op,
        "D2": 4 * H2 * 3 + op + w4 + 4 * Hc2,
        "D3": 4 * H2 * 3 + op + w4 + 4 * Hc2,
        "D4": 4 * H2 + op + w4 + 4 * Hc2,
        "D5": 4 * H2 * 2 + op + w4 + 4 * Hc2,
    }[leg]


def hrelax_bytes(leg: str, n: int, bim: bool, L: int) -> int:
    """Bytes a kernel of ``ops/hrelax.py`` must move: each input read once,
    each output written once (f32 fields, int8 phase, f32 coarse fields,
    the (L, 3, 3) f32 kernels)."""
    H2, Hc2, ph = (n + 1) ** 2, (n // 2 + 1) ** 2, n * n if bim else 0
    fields = {"E2": 3, "E3": 3, "E4": 1, "E5": 2}[leg]
    return 4 * H2 * fields + ph + 4 * Hc2 + 36 * L


def hrelax_flops(leg: str, bim: bool, dform: bool, L: int) -> int:
    applies, extra, chains = HRELAX_FLOPS[leg]
    return applies * APPLY_FLOPS[(bim, dform)] + extra + 18 * L * chains


def elastic_bytes(leg: str, n: int, bim: bool) -> int:
    """Bytes a kernel of ``ops/elastic.py`` must move: each input read once,
    each output written once ((2, n+1, n+1) f32 fields, int8 phase,
    (2, n/2+1, n/2+1) f32 coarse fields)."""
    H2, Hc2, ph = (n + 1) ** 2, (n // 2 + 1) ** 2, n * n if bim else 0
    fields, coarse = {"G1_sweep": (3, 0), "G1_residual": (3, 0), "G2": (3, 1), "G3": (3, 1),
                      "G4": (1, 1), "G5": (2, 1)}[leg]
    return 8 * H2 * fields + 8 * Hc2 * coarse + ph


# output keywords of each leg's wrapper, in the order it returns them
OUT_NAMES = {"A1_sweep": ("out", "rsq"), "A1_residual": ("out", "rsq"),
             "A1_psweep": ("out", "rsq"), "A2": ("out", "fc_out", "rsq"),
             "A3": ("out",), "A4": ("out",),
             "D1_sweep": ("out", "rsq"), "D1_residual": ("out", "rsq"),
             "D2": ("out", "fc_out", "rsq"), "D3": ("out",), "D4": ("out",), "D5": ("out",),
             "E2": ("out", "fc_out", "rsq"), "E3": ("out",), "E4": ("out",), "E5": ("out",),
             "G1_sweep": ("out", "rsq"), "G1_residual": ("out", "rsq"),
             "G2": ("out", "fc_out", "rsq"), "G3": ("out",), "G4": ("out",), "G5": ("out",),
             "A5": ("fc_out", "rsq"), "A6": ("out", "fc_out", "rsq"),
             "C1_sweep": ("out", "rsq"), "C1_residual": ("out", "rsq"),
             **{f"C2_k{k}": ("out", "rsq") for k in range(1, 9)}}
# the legs that keep partial sums in a workspace
RSQ_LEGS = ("A1", "A2", "A5", "A6", "C1", "C2", "D1", "D2", "E2", "G1", "G2")


def hold(leg: str, call, cuda_fn, plain_fn, inputs, cfg, nbytes: int, tol: float, tags: dict):
    """Run one leg's kernel and plain version on the same inputs; return a
    record (errors, times) and fail beyond ``tol``.

    ``ms`` is the kernel's device time on cold inputs: the inputs are cloned
    into enough sets to fill twice the 50 MB L2 cache and the timed launches
    rotate over them, as the solve finds a level's fields after the other
    levels' traffic.  ``warm_ms`` repeats one input set."""
    import torch

    kcfg = dict(cfg, workspace={}) if leg[:2] in RSQ_LEGS else cfg
    got = call(cuda_fn, inputs, kcfg)
    want = call(plain_fn, inputs, cfg)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    rel, abs_err, rsq_rel = 0.0, 0.0, 0.0
    for g, w in zip(got, want):
        if g.dim() == 0:
            rsq_rel = max(rsq_rel, abs(float(g) - float(w)) / max(abs(float(w)), 1e-30))
            continue
        if not torch.isfinite(g).all():
            fail(f"{leg} {tags}: non-finite output")
        err = float((g - w).abs().max())
        abs_err = max(abs_err, err)
        rel = max(rel, err / max(1.0, float(w.abs().max())))

    sets = min(32, -(-2 * L2_BYTES // nbytes))
    xs = [inputs] + [tuple(None if t is None else t.clone() for t in inputs)
                     for _ in range(sets - 1)]
    outs = [dict(kcfg, **dict(zip(OUT_NAMES[leg], [t.clone() for t in got]))) for _ in xs]
    kruns = [lambda x=x, o=o: call(cuda_fn, x, o) for x, o in zip(xs, outs)]
    pruns = [lambda x=x: call(plain_fn, x, cfg) for x in xs]
    rec = dict(name=leg, **tags, max_rel_err=rel, max_abs_err=abs_err, rsq_rel_err=rsq_rel,
               ms=kernel_ms(kruns), warm_ms=kernel_ms(kruns[:1]), plain_ms=plain_ms(pruns),
               input_sets=sets, bytes=nbytes)
    del xs, outs, kruns, pruns
    if rel > tol or rsq_rel > tol:
        fail(f"kernel disagrees with its plain version: {rec}")
    return rec


def check_kernels(n: int, bim: bool, dform: bool, legs, seed: int = 1):
    """Hold each leg of ``ops/sweep.py`` against its plain version on one
    level's seeded inputs; one record per leg."""
    from multigrid_feanet_torch.ops import sweep as sw

    inputs = level_inputs(n, bim, seed)
    cfg = dict(a0=1.0, da=19.0 if bim else 0.0, omega=2.0 / 3.0)
    calls = {
        "A1_sweep": lambda fn, x, kw: fn(x[0], x[1], x[3], None, dform=dform, mode="sweep", **kw),
        "A1_residual": lambda fn, x, kw: fn(x[0], x[1], x[3], None, dform=dform, mode="residual", **kw),
        "A1_psweep": lambda fn, x, kw: fn(x[0], x[1], x[3], x[2], dform=dform, **kw),
        "A2": lambda fn, x, kw: fn(x[0], x[1], x[3], dform=dform, **kw),
        "A3": lambda fn, x, kw: fn(x[1], x[3], **kw),
        "A4": lambda fn, x, kw: fn(x[1], x[3], x[2], **kw),
        "A5": lambda fn, x, kw: fn(x[0], x[1], x[3], dform=dform, **kw),
        "A6": lambda fn, x, kw: fn(x[0], x[1], x[3], x[2], dform=dform, **kw),
    }
    fns = {"A1_sweep": (sw.sweep_cuda, sw.sweep_plain),
           "A1_residual": (sw.sweep_cuda, sw.sweep_plain),
           "A1_psweep": (sw.sweep_cuda, sw.sweep_plain),
           "A2": (sw.swrr_cuda, sw.swrr_plain),
           "A3": (sw.zrr_cuda, sw.zrr_plain),
           "A4": (sw.zpsweep_cuda, sw.zpsweep_plain),
           "A5": (sw.rr_cuda, sw.rr_plain),
           "A6": (sw.pswrr_cuda, sw.pswrr_plain)}
    a5cfg = dict(a0=cfg["a0"], da=cfg["da"])
    return [hold(leg, calls[leg], *fns[leg], inputs, a5cfg if leg == "A5" else cfg,
                 bytes_moved(leg, n, bim), sw.TOL,
                 dict(n=n, bim=bim, dform=dform if leg not in ("A3", "A4") else False))
            for leg in legs]


def check_stencil(n: int, bim: bool, legs, seed: int = 9):
    """Hold each leg of ``ops/stencil_sweep.py`` (C1 in its sweep and
    residual modes, C2 as ``C2_k<k>``) against its plain version on one
    level's seeded inputs, the circle's pattern ids when ``bim``; C2 also
    against k chained C1 launches.  One record per leg."""
    import torch
    from multigrid_feanet_torch.ops import stencil as tst
    from multigrid_feanet_torch.core.geometry import circle_phase
    from multigrid_feanet_torch.ops import stencil_sweep as ss
    from multigrid_feanet_torch.ops.sweep import TOL

    u, f, _, _ = level_inputs(n, False, seed)
    pid = (torch.as_tensor(tst.pattern_ids_np(circle_phase(2.0, n)), device=DEVICE)
           if bim else None)
    inputs = (u, f, pid)
    cfg = dict(a0=1.0, da=19.0 if bim else 0.0, omega=2.0 / 3.0)
    out = []
    for leg in legs:
        if leg.startswith("C1"):
            mode = leg.split("_")[1]
            call = lambda fn, x, kw, mode=mode: fn(x[0], x[1], x[2], mode=mode, **kw)
            fns, sweeps = (ss.relax_cuda, ss.relax_plain), 1
        else:
            sweeps = int(leg.split("_k")[1])
            call = lambda fn, x, kw, k=sweeps: fn(x[0], x[1], x[2], k=k, **kw)
            fns = (ss.multi_cuda, ss.multi_plain)
        rec = hold(leg, call, *fns, inputs, cfg, stencil_bytes(n, bim), TOL,
                   dict(n=n, bim=bim, sweeps=sweeps))
        rec["flops_per_node"] = stencil_flops(sweeps, pid)
        if leg.startswith("C2"):
            # k chained C1 launches on the same inputs, at TOL: FMA
            # contraction may differ between the two kernels
            got, rsq_g = ss.multi_cuda(u, f, pid, k=sweeps, **cfg)
            chain = u
            for _ in range(sweeps):
                chain, rsq_c = ss.relax_cuda(chain, f, pid, **cfg)
            torch.cuda.synchronize()
            err = float((got - chain).abs().max()) / max(1.0, float(chain.abs().max()))
            rerr = abs(float(rsq_g) - float(rsq_c)) / max(abs(float(rsq_c)), 1e-30)
            rec.update(chained_c1_rel_err=err, chained_c1_rsq_rel_err=rerr)
            if err > TOL or rerr > TOL:
                fail(f"{leg} n={n} bim={bim}: C2 disagrees with {sweeps} chained C1: {err}, {rerr}")
        out.append(rec)
    return out


def check_general(level: int, bim: bool, legs, setup, coef_dtype, seed: int = 3):
    """Hold each leg of ``ops/general.py`` against its plain version on
    level ``level`` of the 4097^2 BoxMG setup: the circle's phase map at
    level 0 when ``bim``, else the level's Galerkin planes; the level's W4
    planes.  One record per leg."""
    import torch
    from multigrid_feanet_torch.ops import general as gen
    from multigrid_feanet_torch.ops.general import GeneralSweepLevel

    n = N_MAIN >> level
    u, f, uc, ph = level_inputs(n, bim, seed)
    if bim:
        lv = GeneralSweepLevel(n, phase=ph, w4=setup[level][0], coef_dtype=coef_dtype,
                               device=DEVICE)
    else:
        lv = GeneralSweepLevel(n, s9=setup[level - 1][1], w4=setup[level][0],
                               coef_dtype=coef_dtype, device=DEVICE)
    inputs = (u, f, uc, lv.op, lv.w4)
    a0da = dict(a0=lv.a0, da=lv.da)
    calls = {
        "D1_sweep": lambda fn, x, kw: fn(x[0], x[1], x[3], mode="sweep", **kw),
        "D1_residual": lambda fn, x, kw: fn(x[0], x[1], x[3], mode="residual", **kw),
        "D2": lambda fn, x, kw: fn(x[0], x[1], x[3], x[4], **a0da, **kw),
        "D3": lambda fn, x, kw: fn(x[0], x[1], x[3], x[4], x[2], **a0da, **kw),
        "D4": lambda fn, x, kw: fn(x[1], x[3], x[4], **kw),
        "D5": lambda fn, x, kw: fn(x[1], x[3], x[4], x[2], **kw),
    }
    fns = {"D1_sweep": (gen.gsweep_cuda, gen.gsweep_plain),
           "D1_residual": (gen.gsweep_cuda, gen.gsweep_plain),
           "D2": (gen.gswrr_cuda, gen.gswrr_plain),
           "D3": (gen.gpsweep_cuda, gen.gpsweep_plain),
           "D4": (gen.zgwrr_cuda, gen.zgwrr_plain),
           "D5": (gen.zgpsweep_cuda, gen.zgpsweep_plain)}
    coef_bytes = torch.tensor([], dtype=coef_dtype).element_size()
    dname = str(coef_dtype).removeprefix("torch.")
    return [hold(leg, calls[leg], *fns[leg], inputs, dict(omega=lv.omega),
                 general_bytes(leg, n, bim, coef_bytes), gen.TOL,
                 dict(n=n, bim=bim, coef_dtype=dname))
            for leg in legs]


def load_params(path: str, device=DEVICE):
    """The (L, 3, 3) H-Net kernels of a repository checkpoint on ``device``."""
    from multigrid_feanet_torch.core.convert import hnet_params_from_arrays
    from multigrid_feanet_torch.utils import checkpoint

    return hnet_params_from_arrays(checkpoint.load(ROOT / path)[0], device=device)


def check_hrelax(n: int, bim: bool, dform: bool, ckpt: str, legs, seed: int = 5):
    """Hold each leg of ``ops/hrelax.py`` against its plain version on one
    level's seeded inputs with the kernels of checkpoint ``ckpt``; one
    record per leg."""
    from multigrid_feanet_torch.ops import hrelax as hx

    params = load_params(ckpt)
    L = int(params.shape[0])
    inputs = level_inputs(n, bim, seed) + (params,)
    cfg = dict(a0=1.0, da=19.0 if bim else 0.0, omega=2.0 / 3.0, dform=dform)
    calls = {
        "E2": lambda fn, x, kw: fn(x[0], x[1], x[3], x[4], **kw),
        "E3": lambda fn, x, kw: fn(x[0], x[1], x[3], x[2], x[4], **kw),
        "E4": lambda fn, x, kw: fn(x[1], x[3], x[4], **kw),
        "E5": lambda fn, x, kw: fn(x[1], x[3], x[2], x[4], **kw),
    }
    fns = {"E2": (hx.hswrr_cuda, hx.hswrr_plain), "E3": (hx.phrelax_cuda, hx.phrelax_plain),
           "E4": (hx.zhswrr_cuda, hx.zhswrr_plain), "E5": (hx.zphrelax_cuda, hx.zphrelax_plain)}
    return [dict(hold(leg, calls[leg], *fns[leg], inputs, cfg, hrelax_bytes(leg, n, bim, L),
                      hx.TOL, dict(n=n, bim=bim, dform=dform, L=L)),
                 flops_per_node=hrelax_flops(leg, bim, dform, L))
            for leg in legs]


def check_elastic(n: int, bim: bool, legs, seed: int = 7):
    """Hold each leg of ``ops/elastic.py`` against its plain version on one
    level's seeded inputs: u, f and the coarse correction standard normal
    with two different components, the circle's phase map when ``bim``.
    One record per leg."""
    import torch
    from multigrid_feanet_torch.core.geometry import circle_phase
    from multigrid_feanet_torch.ops import elastic as eg
    from multigrid_feanet_torch.ops.elasticity import elastic_factor_constants

    rng = np.random.default_rng(seed)
    H, Hc = n + 1, n // 2 + 1
    geo = np.zeros((H, H), np.float32)
    geo[1:-1, 1:-1] = 1.0
    u = rng.standard_normal((2, H, H)).astype(np.float32) * geo
    f = rng.standard_normal((2, H, H)).astype(np.float32)
    uc = rng.standard_normal((2, Hc, Hc)).astype(np.float32)
    ph = circle_phase(2.0, n) if bim else None
    inputs = tuple(None if x is None else torch.as_tensor(x, device=DEVICE)
                   for x in (u, f, uc, ph))
    cfg = dict(a0=1.0, da=19.0 if bim else 0.0, omega=2.0 / 3.0,
               consts=elastic_factor_constants(E_EL, NU_EL))
    calls = {
        "G1_sweep": lambda fn, x, kw: fn(x[0], x[1], x[3], mode="sweep", **kw),
        "G1_residual": lambda fn, x, kw: fn(x[0], x[1], x[3], mode="residual", **kw),
        "G2": lambda fn, x, kw: fn(x[0], x[1], x[3], **kw),
        "G3": lambda fn, x, kw: fn(x[0], x[1], x[3], x[2], **kw),
        "G4": lambda fn, x, kw: fn(x[1], x[3], **kw),
        "G5": lambda fn, x, kw: fn(x[1], x[3], x[2], **kw),
    }
    fns = {"G1_sweep": (eg.el_sweep_cuda, eg.el_sweep_plain),
           "G1_residual": (eg.el_sweep_cuda, eg.el_sweep_plain),
           "G2": (eg.el_swrr_cuda, eg.el_swrr_plain), "G3": (eg.el_psweep_cuda, eg.el_psweep_plain),
           "G4": (eg.el_zrr_cuda, eg.el_zrr_plain), "G5": (eg.el_zpsweep_cuda, eg.el_zpsweep_plain)}
    return [hold(leg, calls[leg], *fns[leg], inputs, cfg, elastic_bytes(leg, n, bim), eg.TOL,
                 dict(n=n, bim=bim))
            for leg in legs]


def build_hierarchy(n: int, bim: bool, num_levels: int, threshold: int, device=None):
    from multigrid_feanet_torch.core.problem import Problem
    from multigrid_feanet_torch.solvers.mg2 import HierarchyV2

    prob = Problem(n=n, inclusion=CIRCLE if bim else None)
    return HierarchyV2(prob, num_levels=num_levels, kernel_threshold=threshold,
                       direct_coarse=True, device=device)


def all_kernels() -> dict:
    from multigrid_feanet_torch.ops import elastic, general, hrelax, stencil_sweep, sweep

    return {**sweep.KERNELS, **general.KERNELS, **hrelax.KERNELS, **elastic.KERNELS,
            **stencil_sweep.KERNELS}


def counted(run):
    """``run()`` with every launch count zeroed just before it; returns its
    result and the counts of the kernels it launched."""
    import torch

    kernels = all_kernels()
    for k in kernels.values():
        k.launches = 0
    out = run()
    torch.cuda.synchronize()
    return out, {key: k.launches for key, k in kernels.items() if k.launches}


def timed_runs(label: str, run, hist, runs: int = 3):
    """Walls of ``runs`` calls of ``run() -> (u, history)``, each ending in a
    synchronize; fails unless every history equals ``hist``."""
    import torch

    walls = []
    for _ in range(runs):
        t0 = time.time()
        _, h = run()
        torch.cuda.synchronize()
        walls.append(time.time() - t0)
        if not np.array_equal(h, hist):
            fail(f"{label}: residual history changed between runs")
    return walls


def decay_start(lv0):
    """The f = 0 decay protocol's start: u0 = 150000 * uniform(rng 0) on the
    interior, f = 0."""
    import torch

    n = lv0.n
    u0 = (150000.0 * np.random.default_rng(0).uniform(size=(n + 1, n + 1))).astype(np.float32)
    u0 = torch.as_tensor(u0, device=lv0.device) * lv0.geo
    return u0, torch.zeros_like(u0)


def run_solve(label: str, build, expect, max_cycles: int, solve=None, lagged: bool = True):
    """Drive one 4097^2 solve from the f = 0 decay protocol: count its
    launches (every kernel in ``expect`` must launch), check it, time it.
    ``solve(hv, f, **kw)`` runs the built solver (default ``hv.solve``).
    ``lagged``: the solver's history lags one cycle and it runs whole
    chunks (the V2 convention); else it ran ``len(history)`` cycles."""
    import torch
    from multigrid_feanet_torch.solvers.jacobi import interior_norm

    n, eps, chunk = N_MAIN, 1e-6, 2
    t0 = time.time()
    hv = build()
    setup_s = time.time() - t0
    lv0 = hv.hier.finest
    u0, f0 = decay_start(lv0)

    solve = solve if solve is not None else (lambda hv, f, **kw: hv.solve(f, **kw))

    def run():
        return solve(hv, f0, u0=u0, eps=eps, max_cycles=max_cycles, chunk=chunk)

    (u, hist), launches = counted(run)
    if not all(launches.get(key) for key in expect):
        fail(f"{label}: a kernel of the path never launched: {launches}")
    if tuple(u.shape) != (n + 1, n + 1) or not torch.isfinite(u).all():
        fail(f"{label}: solution is not finite of shape {(n + 1, n + 1)}")
    if len(hist) >= max_cycles or not hist[-1] <= eps:
        fail(f"{label}: no convergence to {eps} in {max_cycles} cycles: {hist[-3:]}")
    true_res = float(interior_norm(f0 - lv0.apply(u)))
    if not true_res <= 2 * eps:
        fail(f"{label}: true residual of the returned u is {true_res}")

    walls = timed_runs(label, run, hist)
    cycles_run = chunk * -(-(len(hist) + 1) // chunk) if lagged else len(hist)
    wall = min(walls)
    out = dict(solve=label, n=n, cycles=len(hist), cycles_run=cycles_run,
               tail_q=float(np.exp(np.mean(np.diff(np.log(hist[-6:]))))),
               # bench.py's q: the mean of the last six log ratios
               q_last6=float(np.exp(np.mean(np.diff(np.log(hist))[-6:]))),
               # the H-MG row's q: the mean contraction over the whole solve
               q_bench=float((hist[-1] / hist[0]) ** (1.0 / max(1, len(hist) - 1))),
               final_res=float(hist[-1]), true_res=true_res, wall_s=wall,
               walls_s=walls, ms_per_cycle=1e3 * wall / cycles_run,
               setup_s=setup_s, launches=launches, profile=profile_solve(run, cycles_run, wall))
    print(json.dumps(out), flush=True)
    return out


# profiler kernel names -> summary labels; no name is a substring of another
# label's name except sweep_kernel, which is tested after zpsweep_kernel
KERNEL_TAGS = (("zpsweep_kernel", "A4"), ("swrr_kernel", "A2"), ("zrr_kernel", "A3"),
               ("sweep_kernel", "A1"), ("d1_gen_relax", "D1"), ("d2_gen_descent", "D2"),
               ("d3_gen_ascent", "D3"), ("d4_gen_zdescent", "D4"), ("d5_gen_zascent", "D5"),
               ("e2_h_descent", "E2"), ("e3_h_ascent", "E3"), ("e4_h_zdescent", "E4"),
               ("e5_h_zascent", "E5"), ("g1_el_relax", "G1"), ("g2_el_descent", "G2"),
               ("g3_el_ascent", "G3"), ("g4_el_zdescent", "G4"), ("g5_el_zascent", "G5"),
               ("c1_stencil_relax", "C1"), ("c2_stencil_multi", "C2"),
               ("a5_resid_restrict", "A5"), ("a6_cross_cycle", "A6"),
               ("reduce_kernel", "rsq_reduce"))


def profile_solve(solve, cycles_run: int, wall_s: float) -> dict:
    """Device time of one solve by kernel, from torch.profiler: per cycle,
    and the busy share of the unprofiled wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        solve()
        torch.cuda.synchronize()
        prof_wall = time.time() - t0
    by_kernel = {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        us = getattr(evt, "self_cuda_time_total", 0.0) if us is None else us
        name = evt.key
        for tag, label in KERNEL_TAGS:
            if tag in name:
                name = label
                break
        else:
            name = "torch:" + name[:40]
        rec = by_kernel.setdefault(name, dict(ms_per_cycle=0.0, launches=0))
        rec["ms_per_cycle"] += us / 1e3 / cycles_run
        rec["launches"] += evt.count
    busy_ms = sum(r["ms_per_cycle"] for r in by_kernel.values()) * cycles_run
    if busy_ms == 0.0:
        return dict(device_time="not measured")
    return dict(busy_ms_per_cycle=busy_ms / cycles_run,
                busy_share_of_wall=busy_ms / (1e3 * wall_s),
                profiled_wall_s=prof_wall, by_kernel=by_kernel)


def same_solve(label: str, runs: dict) -> None:
    """Fail unless the card's solve and the CPU's plain one agree: cycles
    +-1, first residual to 1e-4, history ratios in [0.8, 1.25], u to 1e-3."""
    (ug, hg), (uc, hc) = runs[DEVICE], runs["cpu"]
    m = min(len(hg), len(hc))
    ratio = hg[:m] / hc[:m]
    du = float(np.max(np.abs(ug - uc)) / np.max(np.abs(uc)))
    ok = (abs(len(hg) - len(hc)) <= 1 and abs(hg[0] - hc[0]) / hc[0] < 1e-4
          and np.all((ratio > 0.8) & (ratio < 1.25)) and du < 1e-3)
    print(json.dumps({label: dict(cycles=[len(hg), len(hc)],
                                  max_hist_ratio_dev=float(np.max(np.abs(ratio - 1))),
                                  u_rel_err=du)}), flush=True)
    if not ok:
        fail(f"{label}: the solve on the card disagrees with the CPU plain path")


def check_small_against_cpu():
    """A 129^2 interface solve on the card against the CPU's plain path."""
    rng = np.random.default_rng(2)
    f = rng.standard_normal((N_SMALL + 1, N_SMALL + 1)).astype(np.float32)
    runs = {}
    for dev in (DEVICE, "cpu"):
        hv = build_hierarchy(N_SMALL, True, num_levels=4, threshold=16, device=dev)
        u, h = hv.solve(f, eps=1e-3, max_cycles=60)
        runs[dev] = (u.cpu().numpy(), h)
    same_solve("small_solve", runs)


def boxmg_setup_on_card():
    """The 4097^2 interface hierarchy (9 levels) and its f32 BoxMG setup on
    the card, timed (first and second run) with its peak memory."""
    import torch
    from multigrid_feanet_torch.core.problem import GridHierarchy, Problem
    from multigrid_feanet_torch.ops.boxmg import boxmg_setup

    prob = Problem(n=N_MAIN, inclusion=CIRCLE)
    t0 = time.time()
    hier = GridHierarchy.create(prob, 9, device=DEVICE)
    hier_s = time.time() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.time()
    setup = boxmg_setup(hier, 9, dtype=torch.float32)
    torch.cuda.synchronize()
    secs = [time.time() - t0]
    peak = torch.cuda.max_memory_allocated() - base
    held = torch.cuda.memory_allocated() - base
    t0 = time.time()
    again = boxmg_setup(hier, 9, dtype=torch.float32)
    torch.cuda.synchronize()
    secs.append(time.time() - t0)
    del again
    for W4, Sc in setup:
        if not (torch.isfinite(W4).all() and torch.isfinite(Sc).all()):
            fail("boxmg setup: non-finite weights or coarse stencils")
    print(json.dumps(dict(boxmg_setup=dict(
        n=N_MAIN, levels=9, hierarchy_s=hier_s, setup_s=secs[0], setup_s_second=secs[1],
        peak_gb=peak / 1e9, held_gb=held / 1e9,
        coarse_n=[int(Sc.shape[0]) - 1 for _, Sc in setup]))), flush=True)
    return prob, hier, setup


def check_boxmg_small_against_cpu():
    """A 129^2 BoxMG V(2,1) solve (bc 0.7) on the card against the CPU's
    plain path, each on its own setup (compared too).  This path runs D1 on
    the Galerkin levels and D2/D3 in general mode; returns its launches."""
    import torch
    from multigrid_feanet_torch.core.problem import GridHierarchy, Problem
    from multigrid_feanet_torch.ops.boxmg import boxmg_setup
    from multigrid_feanet_torch.solvers.boxmg import BoxMGHierarchy

    rng = np.random.default_rng(3)
    f = rng.standard_normal((N_SMALL + 1, N_SMALL + 1)).astype(np.float32)
    prob = Problem(n=N_SMALL, inclusion=CIRCLE)
    runs, setups, launches = {}, {}, None
    for dev in (DEVICE, "cpu"):
        hier = GridHierarchy.create(prob, 4, device=dev)
        setups[dev] = boxmg_setup(hier, 4, dtype=torch.float32)
        bm = BoxMGHierarchy(prob, num_levels=4, kernel_threshold=16, hier=hier,
                            setup=setups[dev], device=dev)
        (u, h), counts = counted(
            lambda: bm.solve(f, bc_value=0.7, nu1=2, nu2=1, eps=1e-3, max_cycles=60))
        if dev == DEVICE:
            launches = counts
        runs[dev] = (u.cpu().numpy(), h)
    setup_err = max(float((a.cpu() - b).abs().max()) / max(1.0, float(b.abs().max()))
                    for pg, pc in zip(setups[DEVICE], setups["cpu"]) for a, b in zip(pg, pc))
    print(json.dumps(dict(boxmg_small_setup_rel_err=setup_err, launches=launches)), flush=True)
    if setup_err > 1e-5:
        fail(f"boxmg setup on the card differs from the CPU's: {setup_err}")
    if not all(launches.get(key) for key in ("A1", "D1", "D2", "D3")):
        fail(f"boxmg V(2,1): a kernel of the path never launched: {launches}")
    same_solve("boxmg_small_v21", runs)
    return launches


def check_hmg_small_against_cpu() -> dict:
    """Three 129^2 bi-material H-MG solves on the card against the CPU's
    plain path; returns each variant's launches on the card."""
    from multigrid_feanet_torch.core.problem import Problem
    from multigrid_feanet_torch.solvers.hmg import HMGHierarchy

    rng = np.random.default_rng(4)
    f = rng.standard_normal((N_SMALL + 1, N_SMALL + 1)).astype(np.float32)
    prob = Problem(n=N_SMALL, inclusion=CIRCLE)
    # eps 1e-2 keeps clear of the f32 residual floor that this random RHS
    # reaches at 129^2; the homogeneous-trained h_levels=1 net contracts
    # slowly on the interface, so that variant runs a fixed 20 cycles
    variants = {  # label: (checkpoint, hierarchy options, solve options, kernels to launch)
        "hmg_small_L3_hl1": (HNET_L3_HL1, dict(h_levels=1), dict(eps=0.0, max_cycles=20),
                             ("E2", "E3", "A3", "A4")),
        "hmg_small_nonzero_legs": (HNET_L3, dict(coarse_zero_legs=False),
                                   dict(eps=1e-2, max_cycles=60), ("E2", "E3")),
        "hmg_small_bc": (HNET_L1, dict(dform=True), dict(eps=1e-2, max_cycles=60, bc_value=0.7),
                         ("E2", "E3", "E4", "E5")),
    }
    out = {}
    for label, (ckpt, hkw, skw, expect) in variants.items():
        runs = {}
        for dev in (DEVICE, "cpu"):
            hv = HMGHierarchy(prob, num_levels=4, kernel_threshold=16, direct_coarse=True,
                              device=dev, **hkw)
            params = load_params(ckpt, dev)
            (u, h), launches = counted(lambda: hv.solve(params, f, **skw))
            if dev == DEVICE:
                out[label] = launches
                if not all(out[label].get(key) for key in expect):
                    fail(f"{label}: a kernel of the path never launched: {out[label]}")
            runs[dev] = (u.cpu().numpy(), h)
        if "bc_value" in skw and not np.allclose(runs[DEVICE][0][0], skw["bc_value"]):
            fail(f"{label}: the boundary value was not kept")
        same_solve(label, runs)
    print(json.dumps({"hmg_small_launches": out}), flush=True)
    return out


def build_elastic(threshold: int, n: int = N_EL, num_levels: int = 9, device=DEVICE):
    """The elastic cells' hierarchy: plane stress, circle r = 0.5,
    coefficients (1, 20), the direct coarse solve."""
    from multigrid_feanet_torch.solvers.elastic import ElasticHierarchy

    return ElasticHierarchy(n, E_EL, NU_EL, inclusion=CIRCLE, coefficients=(1.0, 20.0),
                            num_levels=num_levels, kernel_threshold=threshold,
                            direct_coarse=True, device=device)


def elastic_cell_checks(label: str, u, hist, launches: dict, expect: dict) -> None:
    """Fail unless the cell launched exactly ``expect`` and left a finite
    (2, n+1, n+1) solution and history."""
    import torch

    got = {key: launches.get(key, 0) for key in expect}
    if got != expect:
        fail(f"{label}: launches {launches}, expected {expect}")
    if tuple(u.shape) != (2, N_EL + 1, N_EL + 1) or not torch.isfinite(u).all():
        fail(f"{label}: solution is not finite of shape {(2, N_EL + 1, N_EL + 1)}")
    if not np.all(np.isfinite(hist)):
        fail(f"{label}: non-finite residual history {hist}")


def run_elastic_cells() -> dict:
    """The three 2049^2 elastic cells and the bench's kernel threshold of
    512 (``bench.py:336-375``): the f = 0 decay protocol from a standard
    normal u0 (rng 1), eps 0.  Returns each cell's record."""
    import torch
    from multigrid_feanet_torch.ops.elasticity import elastic_interior_norm

    n = N_EL
    t0 = time.time()
    hv = build_elastic(16)
    setup_s = time.time() - t0
    lv0 = hv.levels[0]
    u0 = torch.as_tensor(np.random.default_rng(1).standard_normal((2, n + 1, n + 1)).astype(
        np.float32), device=DEVICE)
    f0 = torch.zeros_like(u0)
    out = {}

    def vcycles(h, cycles, nu=2):
        return lambda: h.solve(f0, u0=u0, nu1=nu, nu2=nu, eps=0.0, max_cycles=cycles)

    def tail_q(hist, k):
        return float(np.exp(np.mean(np.diff(np.log(hist))[-k:])))

    # elastic_2049: V(2,2), per cycle 2 G1, G2 and G3 on each of the K = 8
    # fused levels
    K = hv.K
    (u, h12), launches = counted(vcycles(hv, 12))
    elastic_cell_checks("elastic_2049", u, h12, launches,
                        {"G1": 2 * K * 12, "G2": K * 12, "G3": K * 12})
    if not h12[-1] < h12[0]:
        fail(f"elastic_2049: the residual history does not fall: {h12}")
    (_, h4) = vcycles(hv, 4)()
    w4 = timed_runs("elastic_2049", vcycles(hv, 4), h4)
    w12 = timed_runs("elastic_2049", vcycles(hv, 12), h12)
    _, h60 = vcycles(hv, 60)()
    t4, t12 = min(w4), min(w12)
    out["elastic_2049"] = dict(
        solve="elastic_2049", n=n, K=hv.K, setup_s=setup_s, cycles=12, history_len=len(h12),
        ms_per_cycle=1e3 * (t12 - t4) / 8, t4_s=t4, t12_s=t12, walls4_s=w4, walls12_s=w12,
        tail_q12=tail_q(h12, 4), q_asym60=tail_q(h60, 8), hist12=h12.tolist(),
        hist60_last=h60[-9:].tolist(), launches=launches,
        profile=profile_solve(vcycles(hv, 12), 12, t12))
    print(json.dumps(out["elastic_2049"]), flush=True)

    # the bench's threshold: levels 256..16 as plain torch ops
    hb = build_elastic(512)
    (_, hb12), lb = counted(vcycles(hb, 12))
    ratio = hb12 / h12
    tb4 = min(timed_runs("elastic_2049_t512", vcycles(hb, 4), vcycles(hb, 4)()[1], 2))
    tb12 = min(timed_runs("elastic_2049_t512", vcycles(hb, 12), hb12, 2))
    out["elastic_2049_t512"] = dict(
        solve="elastic_2049_t512", K=hb.K, ms_per_cycle=1e3 * (tb12 - tb4) / 8, t4_s=tb4,
        t12_s=tb12, max_hist_ratio_dev=float(np.max(np.abs(ratio - 1))), launches=lb)
    print(json.dumps(out["elastic_2049_t512"]), flush=True)
    del hb
    if not np.all((ratio >= 0.99) & (ratio <= 1.01)):
        fail(f"elastic_2049_t512: history departs from threshold 16's: {ratio}")

    # elastic_pcg_2049: 16 iterations; per iteration one V(2,2) from zero
    # (2K G1, K G2, K G3) and two G1 residual passes, plus the start's
    # residual and preconditioner
    def pcg():
        return hv.solve_pcg(f0, u0=u0, nu1=2, nu2=2, eps=0.0, max_iters=16)

    (u, hp), launches = counted(pcg)
    it = len(hp)
    elastic_cell_checks("elastic_pcg_2049", u, hp, launches,
                        {"G1": 1 + 2 * K + (2 + 2 * K) * it, "G2": K * (it + 1),
                         "G3": K * (it + 1)})
    drop = float(hp[-1] / hp[0])
    if not drop <= 1e-5:
        fail(f"elastic_pcg_2049: the residual dropped only {drop}: {hp}")
    true32 = float(elastic_interior_norm(f0 - lv0.apply(u)))
    true64 = float(elastic_interior_norm(f0.double() - lv0.apply(u.double())))
    if not abs(true32 - hp[-1]) <= 1e-3 * hp[-1]:
        fail(f"elastic_pcg_2049: history ends at {hp[-1]}, the true residual is {true32}")
    wp = timed_runs("elastic_pcg_2049", pcg, hp)
    out["elastic_pcg_2049"] = dict(
        solve="elastic_pcg_2049", n=n, iterations=it, wall_s=min(wp), walls_s=wp,
        ms_per_iteration=1e3 * min(wp) / it,
        contraction=float(np.exp(np.mean(np.diff(np.log(hp + 1e-30))[-6:]))), drop=drop,
        true_res_f32=true32, true_res_f64=true64, hist=hp.tolist(), launches=launches,
        profile=profile_solve(pcg, it, min(wp)))
    print(json.dumps(out["elastic_pcg_2049"]), flush=True)

    # elastic_v11_2049: V(1,1), per cycle G2 and G3 at level 0, G4 and G5 on
    # levels 1..K-1
    (u, h11), launches = counted(vcycles(hv, 12, nu=1))
    elastic_cell_checks("elastic_v11_2049", u, h11, launches,
                        {"G2": 12, "G3": 12, "G4": (K - 1) * 12, "G5": (K - 1) * 12})
    (_, h11_4) = vcycles(hv, 4, nu=1)()
    v4 = min(timed_runs("elastic_v11_2049", vcycles(hv, 4, nu=1), h11_4))
    w11 = timed_runs("elastic_v11_2049", vcycles(hv, 12, nu=1), h11)
    out["elastic_v11_2049"] = dict(
        solve="elastic_v11_2049", n=n, cycles=12, ms_per_cycle=1e3 * (min(w11) - v4) / 8,
        t4_s=v4, t12_s=min(w11), walls12_s=w11, tail_q12=tail_q(h11, 4),
        hist12=h11.tolist(), launches=launches,
        profile=profile_solve(vcycles(hv, 12, nu=1), 12, min(w11)))
    print(json.dumps(out["elastic_v11_2049"]), flush=True)
    return out


def check_elastic_small_against_cpu() -> dict:
    """Three 129^2 bi-material elastic solves (V(2,2), V(1,1), PCG; 4
    levels, the direct solve at n = 16) on the card against the CPU's
    plain path; returns each variant's launches on the card."""
    rng = np.random.default_rng(8)
    geo = np.zeros((N_SMALL + 1, N_SMALL + 1), np.float32)
    geo[1:-1, 1:-1] = 1.0
    f = (rng.standard_normal((2, N_SMALL + 1, N_SMALL + 1)) * geo).astype(np.float32)
    variants = {  # label: (run, kernels to launch)
        "elastic_small_v22": (lambda hv: hv.solve(f, eps=1e-2, max_cycles=100), ("G1", "G2", "G3")),
        "elastic_small_v11": (lambda hv: hv.solve(f, nu1=1, nu2=1, eps=1e-2, max_cycles=100),
                              ("G2", "G3", "G4", "G5")),
        "elastic_small_pcg": (lambda hv: hv.solve_pcg(f, eps=1e-2, max_iters=60),
                              ("G1", "G2", "G3")),
    }
    out = {}
    for label, (run, expect) in variants.items():
        runs = {}
        for dev in (DEVICE, "cpu"):
            hv = build_elastic(16, n=N_SMALL, num_levels=4, device=dev)
            (u, h), launches = counted(lambda: run(hv))
            if dev == DEVICE:
                out[label] = launches
                if not all(launches.get(key) for key in expect):
                    fail(f"{label}: a kernel of the path never launched: {launches}")
            runs[dev] = (u.cpu().numpy(), h)
        same_solve(label, runs)
    print(json.dumps({"elastic_small_launches": out}), flush=True)
    return out


def build_r1(n: int, bim: bool, num_levels: int, threshold: int, device=DEVICE):
    """The round-1 ``Hierarchy`` (C1/C2 on the kernel levels) with the
    direct coarse solve."""
    from multigrid_feanet_torch.core.problem import GridHierarchy, Problem
    from multigrid_feanet_torch.solvers.mg import Hierarchy

    hier = GridHierarchy.create(Problem(n=n, inclusion=CIRCLE if bim else None), num_levels,
                                device=device)
    return Hierarchy(hier, kernel_threshold=threshold, direct_coarse=True, device=device)


def run_r1_cells() -> dict:
    """``poisson_4097_r1`` (V(1,1): C1) and ``poisson_4097_r1_v22`` (V(2,2):
    C2, C1 for the residuals): the homogeneous 4097^2 decay solve on the
    round-1 Hierarchy, 9 levels, threshold 32, at most 60 cycles.  Per cycle
    each of the K = 8 kernel levels runs nu1 + nu2 sweeps and one residual,
    and level 0 one more residual after the cycle."""
    out = {}
    K = 8
    for label, nu in (("poisson_4097_r1", 1), ("poisson_4097_r1_v22", 2)):
        rec = run_solve(label, lambda: build_r1(N_MAIN, False, 9, 32), ("C1",) if nu == 1
                        else ("C1", "C2"), 60, lagged=False,
                        solve=lambda hv, f, chunk, nu=nu, **kw: hv.solve(f, nu1=nu, nu2=nu, **kw))
        c = rec["cycles"]
        expect = {"C1": (3 * K + 1) * c} if nu == 1 else {"C1": (K + 1) * c, "C2": 2 * K * c}
        if rec["launches"] != expect:
            fail(f"{label}: launches {rec['launches']}, expected {expect}")
        out[label] = rec
    return out


def run_pswrr_cell(split: dict) -> dict:
    """``pswrr_interface_4097``: ``interface_4097`` with ``use_pswrr``.  It
    must launch A6, take the split path's cycles +-1 and land within 1% of
    its tail q."""
    rec = run_solve("pswrr_interface_4097", lambda: build_hierarchy(N_MAIN, True, 9, 32, DEVICE),
                    ("A6", "A3", "A4"), 120,
                    solve=lambda hv, f, **kw: hv.solve(f, use_pswrr=True, **kw))
    dq = abs(rec["tail_q"] / split["tail_q"] - 1.0)
    print(json.dumps(dict(pswrr_vs_split=dict(cycles=[rec["cycles"], split["cycles"]],
                                              tail_q=[rec["tail_q"], split["tail_q"]],
                                              tail_q_rel_dev=dq))), flush=True)
    if abs(rec["cycles"] - split["cycles"]) > 1 or dq > 0.01:
        fail(f"pswrr_interface_4097 departs from the split path: {rec['cycles']} cycles, "
             f"tail q {rec['tail_q']} against {split['cycles']}, {split['tail_q']}")
    return rec


def run_pcg_cell() -> dict:
    """``pcg_interface_4097``: ``HierarchyV2.solve_pcg`` on the interface
    problem from run_solve's u0, eps 1e-6, at most 60 iterations.  Per
    iteration one zero-guess V(1,1) (A3, A4 on the K fused levels) and two
    A1 residual passes (A p and the true residual), plus the start's."""
    from multigrid_feanet_torch.solvers.jacobi import interior_norm

    eps, cap = 1e-6, 60
    hv = build_hierarchy(N_MAIN, True, 9, 32, DEVICE)
    lv0 = hv.hier.finest
    u0, f0 = decay_start(lv0)

    def run():
        return hv.solve_pcg(f0, u0=u0, eps=eps, max_iters=cap)

    (u, hist), launches = counted(run)
    it, K = len(hist), hv.K
    expect = {"A1": 1 + 2 * it, "A3": K * (it + 1), "A4": K * (it + 1)}
    if launches != expect:
        fail(f"pcg_interface_4097: launches {launches}, expected {expect}")
    if it >= cap or not hist[-1] <= eps or not np.all(np.isfinite(hist)):
        fail(f"pcg_interface_4097: no convergence to {eps} in {cap} iterations: {hist[-3:]}")
    true64 = float(interior_norm(f0.double() - lv0.apply(u.double())))
    if not abs(true64 - hist[-1]) <= 1e-3 * hist[-1]:
        fail(f"pcg_interface_4097: history ends at {hist[-1]}, the true residual is {true64}")
    walls = timed_runs("pcg_interface_4097", run, hist)
    wall = min(walls)
    rec = dict(solve="pcg_interface_4097", n=N_MAIN, iterations=it, final_res=float(hist[-1]),
               true_res_f64=true64, wall_s=wall, walls_s=walls, ms_per_iteration=1e3 * wall / it,
               contraction=float(np.exp(np.mean(np.diff(np.log(hist))[-6:]))),
               hist=hist.tolist(), launches=launches,
               launches_per_iteration={k: v / it for k, v in launches.items()},
               profile=profile_solve(run, it, wall))
    print(json.dumps(rec), flush=True)
    return rec


def run_ir_cell() -> dict:
    """``ir_4097``: ``solve_ir`` on the homogeneous 4097^2 HierarchyV2
    (threshold 32, 9 levels, direct coarse) with f = apply_mass(1, h), V(1,1),
    eps 1e-6, 6 cycles per correction, at most 12 outer steps (bench.py's
    hard row).  The f64 true residual of the returned u, from a level
    assembled anew in f64, must be <= 1e-6.  Beside it, the f32 floor: 20
    plain V(1,1) cycles on the same f."""
    import torch
    from multigrid_feanet_torch.core.problem import Problem, build_level
    from multigrid_feanet_torch.ops.stencil import apply_mass
    from multigrid_feanet_torch.solvers.jacobi import interior_norm
    from multigrid_feanet_torch.solvers.mg import solve_ir

    eps = 1e-6
    t0 = time.time()
    hv = build_hierarchy(N_MAIN, False, 9, 32, DEVICE)
    lv0 = hv.hier.finest
    f = apply_mass(torch.ones((N_MAIN + 1, N_MAIN + 1), device=DEVICE), lv0.h)
    setup_s = time.time() - t0

    def run():
        return solve_ir(hv, f, nu1=1, nu2=1, eps=eps, cycles_per_correction=6, max_outer=12)

    (u, hist), launches = counted(run)
    lv64 = build_level(Problem(n=N_MAIN, dtype=torch.float64), N_MAIN, device=DEVICE)
    true64 = float(interior_norm(f.double() - lv64.apply(u)))
    if u.dtype != torch.float64 or not torch.isfinite(u).all() or not true64 <= eps:
        fail(f"ir_4097: the f64 true residual is {true64} after {len(hist)} steps: {hist}")
    if not all(launches.get(key) for key in ("A1", "A2", "A3", "A4")):
        fail(f"ir_4097: a kernel of the path never launched: {launches}")
    walls = timed_runs("ir_4097", run, hist)
    cycles = 6 * (len(hist) - 1)
    u20, h20 = hv.solve(f, eps=0.0, max_cycles=20)
    floor64 = float(interior_norm(f.double() - lv64.apply(u20.double())))
    rec = dict(solve="ir_4097", n=N_MAIN, outer_steps=len(hist), corrections=len(hist) - 1,
               hist=hist.tolist(), true_res_f64=true64, wall_s=min(walls), walls_s=walls,
               setup_s=setup_s, launches=launches, f32_20_cycles_hist_last=float(h20[-1]),
               f32_20_cycles_true_res_f64=floor64,
               profile=profile_solve(run, max(1, cycles), min(walls)))
    print(json.dumps(rec), flush=True)
    return rec


def check_r5_small_against_cpu() -> dict:
    """129^2 checks of this slice's paths on the card against the CPU's
    plain path: the bi-material round-1 Hierarchy at V(1,1) and V(2,2),
    solve_jacobi with fuse 1 and 4 (400 sweeps), the V2 and BoxMG solve_pcg
    (eps 1e-2, clear of the f32 floor of a random RHS at 129^2) and
    solve_ir on both hierarchies (homogeneous, f = apply_mass(1, h), eps
    1e-9).  Returns each check's launches on the card."""
    import torch
    from multigrid_feanet_torch.core.problem import Problem
    from multigrid_feanet_torch.ops.stencil import apply_mass
    from multigrid_feanet_torch.solvers.boxmg import BoxMGHierarchy
    from multigrid_feanet_torch.solvers.mg import solve_ir

    n = N_SMALL
    f = np.random.default_rng(10).standard_normal((n + 1, n + 1)).astype(np.float32)
    fm = apply_mass(torch.ones((n + 1, n + 1)), 2.0 / n).numpy()
    out = {}

    def both(label, build, run, expect):
        res = {}
        for dev in (DEVICE, "cpu"):
            hv = build(dev)
            r, launches = counted(lambda: run(hv))
            if dev == DEVICE:
                out[label] = launches
                if not all(launches.get(key) for key in expect):
                    fail(f"{label}: a kernel of the path never launched: {launches}")
            res[dev] = r
        return res

    for label, nu, expect in (("r1_small_v11", 1, ("C1",)), ("r1_small_v22", 2, ("C1", "C2"))):
        res = both(label, lambda dev: build_r1(n, True, 4, 16, dev),
                   lambda hv, nu=nu: hv.solve(f, nu1=nu, nu2=nu, eps=1e-2, max_cycles=60), expect)
        same_solve(label, {d: (u.cpu().numpy(), h) for d, (u, h) in res.items()})
    for fuse, key in ((1, "C1"), (4, "C2")):
        label = f"r1_small_jacobi_fuse{fuse}"
        res = both(label, lambda dev: build_r1(n, True, 4, 16, dev),
                   lambda hv, fuse=fuse: hv.solve_jacobi(f, eps=0.0, max_iters=400, fuse=fuse),
                   (key,))
        (ug, kg, rg), (uc, kc, rc) = res[DEVICE], res["cpu"]
        du = float((ug.cpu() - uc).abs().max() / uc.abs().max())
        print(json.dumps({label: dict(iters=[kg, kc], res=[rg, rc], u_rel_err=du)}), flush=True)
        if kg != kc or abs(rg / rc - 1.0) > 1e-3 or du > 1e-3:
            fail(f"{label}: the Jacobi solve on the card disagrees with the CPU plain path")
    pcgs = (("v2_small_pcg", lambda dev: build_hierarchy(n, True, 4, 16, dev), ("A1", "A3", "A4")),
            ("boxmg_small_pcg", lambda dev: BoxMGHierarchy(
                Problem(n=n, inclusion=CIRCLE), num_levels=4, kernel_threshold=16, device=dev),
             ("A1", "D2", "D3")))
    for label, build, expect in pcgs:
        res = both(label, build, lambda hv: hv.solve_pcg(f, eps=1e-2, max_iters=60), expect)
        same_solve(label, {d: (u.cpu().numpy(), h) for d, (u, h) in res.items()})
    irs = (("ir_small_r1", lambda dev: build_r1(n, False, 4, 16, dev), ("C1",)),
           ("ir_small_v2", lambda dev: build_hierarchy(n, False, 4, 16, dev), ("A2", "A3", "A4")))
    for label, build, expect in irs:
        res = both(label, build, lambda hv: solve_ir(hv, fm, eps=1e-9, cycles_per_correction=4,
                                                     max_outer=15), expect)
        (ug, hg), (uc, hc) = res[DEVICE], res["cpu"]
        du = float((ug.cpu() - uc).abs().max() / uc.abs().max())
        print(json.dumps({label: dict(outer=[len(hg), len(hc)], last=[hg[-1], hc[-1]],
                                      u_rel_err=du)}), flush=True)
        if (abs(len(hg) - len(hc)) > 1 or abs(hg[0] / hc[0] - 1.0) > 1e-6
                or not max(hg[-1], hc[-1]) <= 1e-9 or du > 1e-6):
            fail(f"{label}: solve_ir on the card disagrees with the CPU plain path")
    print(json.dumps({"r5_small_launches": out}), flush=True)
    return out


def bound(key: str, rec: dict):
    """(bound ms, "bytes" or "operations") of a check record: the larger of
    its bytes over the HBM rate and its f32 operations over the f32 rate."""
    t_bytes = 1e3 * rec["bytes"] / HBM_BYTES_PER_S
    flops = rec.get("flops_per_node", FLOPS_PER_NODE.get(key)) * (rec["n"] + 1) ** 2
    t_ops = 1e3 * flops / FP32_FLOP_PER_S
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def summary_row(key: str, rec: dict, launches: int, path: str) -> dict:
    """One row of the kernel line from a check record and a path's count."""
    n = rec["n"]
    bound_ms, bound_by = bound(key, rec)
    k = all_kernels()[key]
    return dict(name=k.name, route="cuda", source=k.source, replaces=k.replaces,
                launches=launches, max_abs_err=rec["max_abs_err"],
                max_rel_err=rec["max_rel_err"], rsq_rel_err=rec["rsq_rel_err"],
                ms=rec["ms"], warm_ms=rec["warm_ms"], plain_ms=rec["plain_ms"],
                bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None, path=path, n=n,
                **{t: rec[t] for t in ("bim", "coef_dtype", "dform", "L", "sweeps") if t in rec})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "multigrid_feanet_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from multigrid_feanet_torch import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi could not read the card: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps(dict(python=sys.version.split()[0], torch=torch.__version__,
                          cuda=torch.version.cuda)), flush=True)

    t0 = time.time()
    _build.load()
    build_s = time.time() - t0
    log = _build.library_path().with_suffix(".log").read_text()
    regs = [line.strip() for line in log.splitlines()
            if "registers" in line or ("spill" in line and " 0 bytes spill" not in line)]
    print(json.dumps(dict(build_s=build_s, ptxas=regs[:60])), flush=True)

    checks = []
    a13 = ["A1_sweep", "A1_residual", "A1_psweep", "A2"]
    checks += check_kernels(N_MAIN, True, True, a13 + ["A3", "A4"])
    checks += check_kernels(N_MAIN, True, False, a13)
    checks += check_kernels(N_MAIN // 2, True, True, ["A3", "A4"])
    # the homogeneous builds at the sizes the Poisson solve runs them
    checks += check_kernels(N_MAIN, False, True, ["A1_psweep", "A2"])
    checks += check_kernels(N_MAIN // 2, False, True, ["A3", "A4"])
    checks += check_kernels(N_COARSE, True, True, a13 + ["A3", "A4"])
    checks += check_kernels(N_COARSE, False, True, a13 + ["A3", "A4"])
    checks += check_kernels(N_COARSE, False, False, a13)
    print(json.dumps({"kernel_checks": checks}), flush=True)

    check_small_against_cpu()
    a_keys = ("A1", "A2", "A3", "A4")
    solves = [run_solve(label, lambda bim=bim: build_hierarchy(N_MAIN, bim, 9, 32, DEVICE),
                        a_keys, 120)
              for label, bim in (("interface_4097", True), ("poisson_4097", False))]

    prob, hier, setup = boxmg_setup_on_card()
    gchecks = []
    for dt in (torch.bfloat16, torch.float32):
        gchecks += check_general(0, True, ["D2", "D3"], setup, dt)
        gchecks += check_general(1, False, ["D4", "D5", "D1_sweep", "D1_residual"], setup, dt)
        gchecks += check_general(3, False, ["D2", "D3"], setup, dt)
    print(json.dumps({"general_kernel_checks": gchecks}), flush=True)

    from multigrid_feanet_torch.solvers.boxmg import BoxMGHierarchy

    boxmg = run_solve("boxmg_4097", lambda: BoxMGHierarchy(
        prob, num_levels=9, kernel_threshold=32, direct_coarse=True, hier=hier, setup=setup,
        coef_dtype=torch.bfloat16, device=DEVICE), ("D2", "D3", "D4", "D5"), 60)
    del hier, setup
    small_launches = check_boxmg_small_against_cpu()

    hchecks = []
    for bim, dform in ((False, False), (True, True)):
        hchecks += check_hrelax(N_MAIN, bim, dform, HNET_L1, ["E2", "E3"])
        hchecks += check_hrelax(N_MAIN // 2, bim, dform, HNET_L1, ["E4", "E5"])
        hchecks += check_hrelax(N_COARSE, bim, dform, HNET_L3, ["E2", "E3", "E4", "E5"])
    print(json.dumps({"hrelax_kernel_checks": hchecks}), flush=True)

    from multigrid_feanet_torch.core.problem import Problem
    from multigrid_feanet_torch.solvers.hmg import HMGHierarchy

    params = load_params(HNET_L1)
    hmg_solves = [run_solve(label, lambda bim=bim: HMGHierarchy(
        Problem(n=N_MAIN, inclusion=CIRCLE if bim else None), num_levels=9,
        kernel_threshold=32, direct_coarse=True, dform=bim, device=DEVICE),
        ("E2", "E3", "E4", "E5"), cap, solve=lambda hv, f, **kw: hv.solve(params, f, **kw))
        for label, bim, cap in (("hmg_4097", False, 40), ("hmg_interface_4097", True, 60))]
    check_hmg_small_against_cpu()

    echecks = []
    g_all = ["G1_sweep", "G1_residual", "G2", "G3", "G4", "G5"]
    for n, bim in ((N_EL, True), (N_EL, False), (N_EL // 2, True), (N_SMALL, True),
                   (N_SMALL, False)):
        echecks += check_elastic(n, bim, g_all)
    print(json.dumps({"elastic_kernel_checks": echecks}), flush=True)
    cells = run_elastic_cells()
    check_elastic_small_against_cpu()

    schecks = []
    for n, bim in ((N_MAIN, True), (N_MAIN, False), (N_COARSE, True), (N_COARSE, False)):
        schecks += check_stencil(n, bim, ["C1_sweep", "C1_residual", "C2_k2", "C2_k4", "C2_k8"])
        schecks += check_kernels(n, bim, True, ["A5", "A6"])
    for rec in schecks:
        rec["bound_ms"], rec["bound_by"] = bound(rec["name"][:2], rec)
    print(json.dumps({"r5_kernel_checks": schecks}), flush=True)
    r1 = run_r1_cells()
    pswrr = run_pswrr_cell(solves[0])
    pcg = run_pcg_cell()
    ir = run_ir_cell()
    small_r5 = check_r5_small_against_cpu()
    # A5 is a level method that no solver calls: its count is the sum over
    # every counted run of the scalar V2 and round-1 paths, which must be 0
    a5_runs = {rec["solve"]: rec["launches"] for rec in (*solves, pswrr, pcg, ir,
                                                         *r1.values())}
    a5_runs.update(small_r5)
    a5_launches = sum(launches.get("A5", 0) for launches in a5_runs.values())
    if a5_launches:
        fail(f"A5 launched on a solver path, its row says none does: {a5_runs}")

    # one row per kernel and path, at the path's shapes: A1 (psweep) and A2
    # at level 0, A3 and A4 at level 1, the largest level they run on; the
    # Poisson path runs the homogeneous builds ("_hom").  D2/D3 at level 0
    # and D4/D5 at level 1 of boxmg_4097 (bf16 planes); D1 in the 129^2
    # V(2,1) solve (f32 planes), timed on level 1 of the 4097^2 setup.
    main_shape = {"A1": ("A1_psweep", N_MAIN), "A2": ("A2", N_MAIN),
                  "A3": ("A3", N_MAIN // 2), "A4": ("A4", N_MAIN // 2)}
    summary = []
    for solve, bim in zip(solves, (True, False)):
        for key, (leg, n) in main_shape.items():
            rec = next(c for c in checks if c["name"] == leg and c["n"] == n
                       and c["bim"] == bim and (c["dform"] or key in ("A3", "A4")))
            row = summary_row(key, rec, solve["launches"][key], solve["solve"])
            summary.append(dict(row, name=row["name"] + ("" if bim else "_hom")))
    d_shape = {"D1": ("D1_sweep", N_MAIN // 2, "float32", small_launches, "boxmg_129_v21"),
               "D2": ("D2", N_MAIN, "bfloat16", boxmg["launches"], "boxmg_4097"),
               "D3": ("D3", N_MAIN, "bfloat16", boxmg["launches"], "boxmg_4097"),
               "D4": ("D4", N_MAIN // 2, "bfloat16", boxmg["launches"], "boxmg_4097"),
               "D5": ("D5", N_MAIN // 2, "bfloat16", boxmg["launches"], "boxmg_4097")}
    for key, (leg, n, dt, launches, path) in d_shape.items():
        rec = next(c for c in gchecks if c["name"] == leg and c["n"] == n
                   and c["coef_dtype"] == dt)
        summary.append(summary_row(key, rec, launches[key], path))
    # E2/E3 at level 0 and E4/E5 at level 1 of each H-MG solve (the L = 1
    # net); the interface path runs the bi-material difference form ("_bim")
    e_shape = {"E2": N_MAIN, "E3": N_MAIN, "E4": N_MAIN // 2, "E5": N_MAIN // 2}
    for solve, bim in zip(hmg_solves, (False, True)):
        for key, n in e_shape.items():
            rec = next(c for c in hchecks if c["name"] == key and c["n"] == n
                       and c["bim"] == bim and c["L"] == 1)
            row = summary_row(key, rec, solve["launches"][key], solve["solve"])
            summary.append(dict(row, name=row["name"] + ("_bim" if bim else "")))
    # G1-G3 at level 0 of elastic_2049 and elastic_pcg_2049; G2/G3 at level
    # 0 and G4/G5 at level 1 of elastic_v11_2049 (bi-material)
    g_shape = {"elastic_2049": ("", {"G1": ("G1_sweep", N_EL), "G2": ("G2", N_EL),
                                     "G3": ("G3", N_EL)}),
               "elastic_pcg_2049": ("_pcg", {"G1": ("G1_sweep", N_EL), "G2": ("G2", N_EL),
                                             "G3": ("G3", N_EL)}),
               "elastic_v11_2049": ("_v11", {"G2": ("G2", N_EL), "G3": ("G3", N_EL),
                                             "G4": ("G4", N_EL // 2), "G5": ("G5", N_EL // 2)})}
    for path, (suffix, shapes) in g_shape.items():
        for key, (leg, n) in shapes.items():
            rec = next(c for c in echecks if c["name"] == leg and c["n"] == n and c["bim"])
            row = summary_row(key, rec, cells[path]["launches"][key], path)
            summary.append(dict(row, name=row["name"] + suffix))
    # C1 and C2 at level 0 of the round-1 Poisson cells (homogeneous: C2 with
    # k = 2 at V(2,2)); A6 at level 0 of pswrr_interface_4097 (bi-material
    # difference form); A5 on the same level, which no solver path runs
    def srec(name, bim):
        return next(c for c in schecks if c["name"] == name and c["n"] == N_MAIN
                    and c["bim"] == bim)

    summary.append(summary_row("C1", srec("C1_sweep", False),
                               r1["poisson_4097_r1"]["launches"]["C1"], "poisson_4097_r1"))
    row = summary_row("C1", srec("C1_residual", False),
                      r1["poisson_4097_r1_v22"]["launches"]["C1"], "poisson_4097_r1_v22")
    summary.append(dict(row, name=row["name"] + "_v22"))
    summary.append(summary_row("C2", srec("C2_k2", False),
                               r1["poisson_4097_r1_v22"]["launches"]["C2"], "poisson_4097_r1_v22"))
    summary.append(summary_row("A5", srec("A5", True), a5_launches,
                               "no solver path (level method)"))
    summary.append(summary_row("A6", srec("A6", True), pswrr["launches"]["A6"],
                               "pswrr_interface_4097"))
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
