#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. Print the card's name and power limit; build the CUDA kernels from
   ``multigrid_feanet_torch/csrc`` and print the build time.
2. Hold each kernel (A1 in its sweep, residual and psweep modes, A2, A3, A4)
   against its plain PyTorch version on the card, at ``ops.sweep.TOL``: at
   the shapes of both solves below (4097^2 and 2049^2, bi-material and
   homogeneous), on a 4097^2 bi-material level in plain form, and on
   n = 512 levels.  Time both with CUDA events around a run of launches
   (the kernel's captured in a CUDA graph), on inputs rotated to exceed
   the L2 cache.
3. The main path: the 4097^2 bi-material interface solve (circle r = 0.5,
   coefficients (1, 20), 9 levels, kernel threshold 32, direct coarse
   solve, f = 0, u0 = 150000 * uniform(rng 0) * geo, eps 1e-6, at most 120
   cycles, chunk 2), then the homogeneous 4097^2 Poisson solve from the same
   u0.  Each solve must converge, leave a true residual below 2 eps and
   launch each of A1-A4; the launch counts are zeroed just before each
   solve and read just after.  A 129^2 interface solve on the card is held
   against the same solve on the CPU's plain path.
4. Print the kernel summary line (one row per kernel and solve, with the
   solve's launch counts), then the device line as the last line.

Each solve also reports its device time per kernel from torch.profiler and
the busy share of its wall time.
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
DEVICE = "cuda"
N_MAIN, N_COARSE, N_SMALL = 4096, 512, 128


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
    }[name]


# output keywords of each leg's wrapper, in the order it returns them
OUT_NAMES = {"A1_sweep": ("out", "rsq"), "A1_residual": ("out", "rsq"),
             "A1_psweep": ("out", "rsq"), "A2": ("out", "fc_out", "rsq"),
             "A3": ("out",), "A4": ("out",)}


def check_kernels(n: int, bim: bool, dform: bool, legs, seed: int = 1):
    """Run each leg's kernel and plain version on the same inputs; return
    one record per leg (errors, times) and fail beyond the tolerance.

    ``ms`` is the kernel's device time on cold inputs: the inputs are cloned
    into enough sets to fill twice the 50 MB L2 cache and the timed launches
    rotate over them, as the solve finds a level's fields after the other
    levels' traffic.  ``warm_ms`` repeats one input set."""
    import torch
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
    }
    fns = {"A1_sweep": (sw.sweep_cuda, sw.sweep_plain),
           "A1_residual": (sw.sweep_cuda, sw.sweep_plain),
           "A1_psweep": (sw.sweep_cuda, sw.sweep_plain),
           "A2": (sw.swrr_cuda, sw.swrr_plain),
           "A3": (sw.zrr_cuda, sw.zrr_plain),
           "A4": (sw.zpsweep_cuda, sw.zpsweep_plain)}
    records = []
    for leg in legs:
        cuda_fn, plain_fn = fns[leg]
        call, nbytes = calls[leg], bytes_moved(leg, n, bim)
        kcfg = dict(cfg, workspace={}) if leg[:2] in ("A1", "A2") else cfg
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
                fail(f"{leg} n={n} bim={bim} dform={dform}: non-finite output")
            err = float((g - w).abs().max())
            abs_err = max(abs_err, err)
            rel = max(rel, err / max(1.0, float(w.abs().max())))

        sets = min(32, -(-2 * L2_BYTES // nbytes))
        xs = [inputs] + [tuple(None if t is None else t.clone() for t in inputs)
                         for _ in range(sets - 1)]
        outs = [dict(kcfg, **dict(zip(OUT_NAMES[leg], [t.clone() for t in got])))
                for _ in xs]
        kruns = [lambda x=x, o=o: call(cuda_fn, x, o) for x, o in zip(xs, outs)]
        pruns = [lambda x=x: call(plain_fn, x, cfg) for x in xs]
        rec = dict(name=leg, n=n, bim=bim, dform=dform if leg[:2] in ("A1", "A2") else False,
                   max_rel_err=rel, max_abs_err=abs_err, rsq_rel_err=rsq_rel,
                   ms=kernel_ms(kruns), warm_ms=kernel_ms(kruns[:1]),
                   plain_ms=plain_ms(pruns), input_sets=sets, bytes=nbytes)
        del xs, outs, kruns, pruns
        if rel > sw.TOL or rsq_rel > sw.TOL:
            fail(f"kernel disagrees with its plain version: {rec}")
        records.append(rec)
    return records


def build_hierarchy(n: int, bim: bool, num_levels: int, threshold: int, device=None):
    from multigrid_feanet_torch.core.problem import Problem
    from multigrid_feanet_torch.solvers.mg2 import HierarchyV2

    prob = Problem(n=n, inclusion=("circle", (0.0, 0.0), 0.5) if bim else None)
    return HierarchyV2(prob, num_levels=num_levels, kernel_threshold=threshold,
                       direct_coarse=True, device=device)


def run_solve(label: str, bim: bool):
    """Drive one 4097^2 solve: count its launches, check it, time it."""
    import torch
    from multigrid_feanet_torch.ops.sweep import KERNELS
    from multigrid_feanet_torch.solvers.jacobi import interior_norm

    n, eps, max_cycles, chunk = N_MAIN, 1e-6, 120, 2
    t0 = time.time()
    hv = build_hierarchy(n, bim, num_levels=9, threshold=32, device=DEVICE)
    setup_s = time.time() - t0
    lv0 = hv.hier.finest
    rng = np.random.default_rng(0)
    u0 = (150000.0 * rng.uniform(size=(n + 1, n + 1))).astype(np.float32)
    u0 = torch.as_tensor(u0, device=lv0.device) * lv0.geo
    f0 = torch.zeros_like(u0)

    for k in KERNELS.values():
        k.launches = 0
    u, hist = hv.solve(f0, u0=u0, eps=eps, max_cycles=max_cycles, chunk=chunk)
    torch.cuda.synchronize()
    launches = {key: k.launches for key, k in KERNELS.items()}
    if not all(launches.values()):
        fail(f"{label}: a kernel of the path never launched: {launches}")
    if tuple(u.shape) != (n + 1, n + 1) or not torch.isfinite(u).all():
        fail(f"{label}: solution is not finite of shape {(n + 1, n + 1)}")
    if len(hist) >= max_cycles or not hist[-1] <= eps:
        fail(f"{label}: no convergence to {eps} in {max_cycles} cycles: {hist[-3:]}")
    true_res = float(interior_norm(f0 - lv0.apply(u)))
    if not true_res <= 2 * eps:
        fail(f"{label}: true residual of the returned u is {true_res}")

    walls = []
    for _ in range(3):
        t0 = time.time()
        _, h = hv.solve(f0, u0=u0, eps=eps, max_cycles=max_cycles, chunk=chunk)
        torch.cuda.synchronize()
        walls.append(time.time() - t0)
        if not np.array_equal(h, hist):
            fail(f"{label}: residual history changed between runs")
    cycles_run = chunk * -(-(len(hist) + 1) // chunk)
    wall = min(walls)
    out = dict(solve=label, n=n, cycles=len(hist), cycles_run=cycles_run,
               tail_q=float(np.exp(np.mean(np.diff(np.log(hist[-6:]))))),
               final_res=float(hist[-1]), true_res=true_res, wall_s=wall,
               walls_s=walls, ms_per_cycle=1e3 * wall / cycles_run,
               setup_s=setup_s, launches=launches,
               profile=profile_solve(lambda: hv.solve(
                   f0, u0=u0, eps=eps, max_cycles=max_cycles, chunk=chunk),
                   cycles_run, wall))
    print(json.dumps(out), flush=True)
    return out


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
        for tag, label in (("zpsweep_kernel", "A4"), ("swrr_kernel", "A2"),
                           ("zrr_kernel", "A3"), ("sweep_kernel", "A1"),
                           ("reduce_kernel", "rsq_reduce")):
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


def check_small_against_cpu():
    """A 129^2 interface solve on the card against the CPU's plain path."""
    rng = np.random.default_rng(2)
    f = rng.standard_normal((N_SMALL + 1, N_SMALL + 1)).astype(np.float32)
    runs = {}
    for dev in (DEVICE, "cpu"):
        hv = build_hierarchy(N_SMALL, True, num_levels=4, threshold=16, device=dev)
        u, h = hv.solve(f, eps=1e-3, max_cycles=60)
        runs[dev] = (u.cpu().numpy(), h)
    (ug, hg), (uc, hc) = runs[DEVICE], runs["cpu"]
    m = min(len(hg), len(hc))
    ratio = hg[:m] / hc[:m]
    du = float(np.max(np.abs(ug - uc)) / np.max(np.abs(uc)))
    ok = (abs(len(hg) - len(hc)) <= 1 and abs(hg[0] - hc[0]) / hc[0] < 1e-4
          and np.all((ratio > 0.8) & (ratio < 1.25)) and du < 1e-3)
    print(json.dumps(dict(small_solve_cycles=[len(hg), len(hc)],
                          max_hist_ratio_dev=float(np.max(np.abs(ratio - 1))),
                          u_rel_err=du)), flush=True)
    if not ok:
        fail("the 129^2 solve on the card disagrees with the CPU plain path")


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
    from multigrid_feanet_torch.ops.sweep import KERNELS

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
    solves = [run_solve("interface_4097", True), run_solve("poisson_4097", False)]

    # one row per kernel and path, at the path's shapes: A1 (psweep) and A2
    # at level 0, A3 and A4 at level 1, the largest level they run on; the
    # Poisson path runs the homogeneous builds ("_hom")
    main_shape = {"A1": ("A1_psweep", N_MAIN), "A2": ("A2", N_MAIN),
                  "A3": ("A3", N_MAIN // 2), "A4": ("A4", N_MAIN // 2)}
    summary = []
    for solve, bim in zip(solves, (True, False)):
        for key, (leg, n) in main_shape.items():
            rec = next(c for c in checks if c["name"] == leg and c["n"] == n
                       and c["bim"] == bim and (c["dform"] or key in ("A3", "A4")))
            t_bytes = 1e3 * rec["bytes"] / HBM_BYTES_PER_S
            t_ops = 1e3 * FLOPS_PER_NODE[key] * (n + 1) ** 2 / FP32_FLOP_PER_S
            k = KERNELS[key]
            summary.append(dict(
                name=k.name + ("" if bim else "_hom"), route="cuda", source=k.source,
                replaces=k.replaces, launches=solve["launches"][key],
                max_abs_err=rec["max_abs_err"], max_rel_err=rec["max_rel_err"],
                rsq_rel_err=rec["rsq_rel_err"], ms=rec["ms"], warm_ms=rec["warm_ms"],
                plain_ms=rec["plain_ms"], bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=None, path=solve["solve"], n=n))
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
