#!/usr/bin/env python3
"""Time the row-streaming legs of ``csrc/sweep.cu`` (A1-A4), ``csrc/hrelax.cu``
(E1) and ``csrc/torus.cu`` (H1) of this checkout against those of an earlier
checkout of the port on one GPU, in turns.

    python3 sweep_vs_parent.py --parent DIR [--legs all|a12|a34|e1h1|pbc] [--out FILE]
    python3 sweep_vs_parent.py --strip-scan [--out FILE]
    python3 sweep_vs_parent.py --crossover [--out FILE]
    python3 sweep_vs_parent.py --parent DIR --sass [--out FILE]

DIR holds an earlier commit's ``multigrid_feanet_torch`` (for example
``git archive <commit> multigrid_feanet_torch | tar -x -C build/parent``).
Each turn is a process of its own that imports the package of one
checkout, which builds that checkout's kernels into its own
``build/kernels``, and runs ``chip_smoke``'s holds (``check_kernels``,
``check_e1``, ``check_torus``) on it: each checkout's own wrappers are held
against their plain versions at ``TOL`` and timed with
``chip_smoke.kernel_ms`` (50 graph-replayed launches on L2-cold inputs,
median of 3).  The turns run parent, this, this, parent.

- ``a12``: ``sweep_cuda`` (sweep, residual and psweep modes) and
  ``swrr_cuda`` at 4097^2, in the bi-material difference form (the
  interface solve), the homogeneous difference form (Poisson) and the
  bi-material mass form (heat).
- ``a34``: ``zrr_cuda`` (A3) and ``zpsweep_cuda`` (A4) at every level size
  the 4097^2 interface solve launches them at (n = 2048 ... 32), in the
  bi-material and homogeneous plain forms and the bi-material mass form.
- ``e1h1``: ``hrelax_cuda`` (E1) at 4097^2 homogeneous with the L = 3 and
  L = 1 nets and the ring reset to 0 (``hjac_4097``, ``measure_q_4096``),
  bi-material with the L = 1 net in plain and difference form; homogeneous
  L = 1 with the reset at every other level size of ``measure_q_4096``
  (n = 2048 ... 2); at n = 32 with the L = 3 net and a boundary field
  (``hjac_iter_32``); and ``torus_sweep_cuda`` (H1) at n = 4096, 2048, ...,
  32 (``torus_jacobi_4096`` and the kernel levels of ``pbc_mg_4096``).
- ``pbc`` (not part of ``all``): ``chip_smoke.run_pbc_cells`` in each turn
  (the periodic cells, with their checks), and from its torch.profiler
  profiles the device time per sweep or cycle of ``torus_jacobi_4096`` and
  ``pbc_mg_4096``: of every H1 launch and its norm pass (``H1`` plus
  ``rsq_reduce``, one-pass tiles included) and of the whole device.

Prints the card's name and power limit, one JSON line per turn and a
summary line (each checkout's mean and spread over its two turns, the byte
bound and the parent-over-this ratio), and writes them to ``--out``
(default ``chiprun_out/sweep_vs_parent.json``).  Fails when a turn fails.

``--strip-scan`` times this checkout's A3 and A4 alone, bi-material plain
form, at each level size over a range of strip heights (the launch geometry
set by hand instead of ``ops/sweep.py::balanced_strip``), beside the height
``balanced_strip`` picks: the data its cost model for A3/A4 is fitted to.
Writes ``chiprun_out/sweep_strip_scan.json`` by default.

``--crossover`` times this checkout's E1 and H1 in both designs, the
one-pass tile and row streaming (the size threshold of
``ops/hrelax.py::E1_ONE_PASS_MAX_N`` and ``ops/torus.py::H1_ONE_PASS_MAX_N``
set at or below n), at n = 64 ... 1024: E1 homogeneous with the L = 1 and
L = 3 nets and the ring reset (``measure_q_4096``'s and ``hjac_4097``'s
form), bi-material with the L = 1 net; H1.  The designs take turns (tile,
streaming, streaming, tile); the summary gives each design's mean and the
tile-over-streaming ratio, the data the thresholds are set from.  Writes
``chiprun_out/sweep_crossover.json`` by default.

``--sass`` builds both checkouts' libraries and reads their machine code
with ``cuobjdump -sass``: whether every kernel of the parent's library (the
f32 instances of A1-A6 and every other source's kernels) compiles to the
same instructions in this checkout (addresses, encodings and the anonymous
namespace's name aside; a leg's storage-type template argument maps its
float instance to the parent's), the number of bf16 instances, and the
instructions of A3 and A4 in all and per step of their row loop (between
two barriers).  The parent's kernels named in CHANGED (E1 and H1, and
H1's norm pass) are compared apart, with this checkout's one-pass tiles of
E1 and H1 (RENAMED), and the new row-streaming kernels are listed; fails
unless every other kernel matches.  Writes ``chiprun_out/sweep_sass.json`` by default.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
A12_LEGS = ["A1_sweep", "A1_residual", "A1_psweep", "A2"]
A34_LEVELS = (2048, 1024, 512, 256, 128, 64, 32)
# measure_q_4096's level sizes below 4096 (E1), the kernel levels of
# pbc_mg_4096 (H1)
E1_LEVELS = (2048, 1024, 512, 256, 128, 64, 32, 16, 8, 4, 2)
H1_LEVELS = (4096, 2048, 1024, 512, 256, 128, 64, 32)
# the kernels this checkout redesigns or removes (--sass lists them apart)
CHANGED = ("e1_h_relax", "h1_torus_relax", "h1_reduce_pair")


def child(checkout: Path, legs: str) -> int:
    """One turn: hold and time the legs of ``checkout``'s package; prints the
    records as one JSON line."""
    import torch

    sys.path.insert(0, str(checkout))
    import multigrid_feanet_torch

    if not Path(multigrid_feanet_torch.__file__).resolve().is_relative_to(checkout):
        raise SystemExit(f"sweep_vs_parent: imported {multigrid_feanet_torch.__file__}, "
                         f"not the package in {checkout}")
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    heat = (cs.HEAT_THETA * cs.HEAT_DT, 20.0 * cs.HEAT_THETA * cs.HEAT_DT)
    recs = []
    if legs in ("all", "a12"):
        n = cs.N_MAIN
        recs += (cs.check_kernels(n, True, True, A12_LEGS)
                 + cs.check_kernels(n, False, True, A12_LEGS)
                 + cs.check_kernels(n, True, False, A12_LEGS, coef=heat, mass=cs.level_mass(n)))
    if legs in ("all", "a34"):
        for n in A34_LEVELS:
            recs += (cs.check_kernels(n, True, False, ["A3", "A4"])
                     + cs.check_kernels(n, False, False, ["A3", "A4"])
                     + cs.check_kernels(n, True, False, ["A3", "A4"], coef=heat,
                                        mass=cs.level_mass(n)))
    if legs in ("all", "e1h1"):
        n = cs.N_MAIN
        recs += [cs.check_e1(n, False, False, cs.HNET_ITER, bc=0.0),
                 cs.check_e1(n, False, False, cs.HNET_L1, bc=0.0),
                 cs.check_e1(n, True, False, cs.HNET_L1), cs.check_e1(n, True, True, cs.HNET_L1)]
        recs += [cs.check_e1(m, False, False, cs.HNET_L1, bc=0.0) for m in E1_LEVELS]
        recs.append(cs.check_e1(32, False, False, cs.HNET_ITER, bc="field"))
        recs += [cs.check_torus(m) for m in H1_LEVELS]
    if legs == "pbc":
        cells = cs.run_pbc_cells()
        for cell in ("torus_jacobi_4096", "pbc_mg_4096"):
            prof = cells[cell]["profile"]
            by = [prof["by_kernel"].get(k, dict(ms_per_cycle=0.0, launches=0))
                  for k in ("H1", "rsq_reduce")]
            recs += [dict(name=f"{cell}_H1_and_norms", ms=sum(r["ms_per_cycle"] for r in by),
                          launches=sum(r["launches"] for r in by)),
                     dict(name=f"{cell}_device", ms=prof["busy_ms_per_cycle"])]
        recs = [dict(r, bytes=0, max_rel_err=0.0) for r in recs]
    torch.cuda.synchronize()
    for r in recs:
        r["bound_ms"] = 1e3 * r["bytes"] / cs.HBM_BYTES_PER_S
    print(json.dumps(recs), flush=True)
    return 0


CROSS_LEVELS = (64, 128, 256, 512, 1024)


def crossover() -> list:
    """E1 (three forms) and H1 at each size of CROSS_LEVELS in both designs,
    in turns; one record per size, then a summary."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from multigrid_feanet_torch.ops import hrelax as hx
    from multigrid_feanet_torch.ops import torus as tt

    saved = hx.E1_ONE_PASS_MAX_N, tt.H1_ONE_PASS_MAX_N
    legs = {"E1_hom_L1": lambda n: cs.check_e1(n, False, False, cs.HNET_L1, bc=0.0),
            "E1_hom_L3": lambda n: cs.check_e1(n, False, False, cs.HNET_ITER, bc=0.0),
            "E1_bim_L1": lambda n: cs.check_e1(n, True, False, cs.HNET_L1),
            "H1": cs.check_torus}
    out, summary = [], {}
    try:
        for n in CROSS_LEVELS:
            ms = {leg: {"tile": [], "stream": []} for leg in legs}
            for design in ("tile", "stream", "stream", "tile"):
                limit = n if design == "tile" else -1
                hx.E1_ONE_PASS_MAX_N = {L: limit for L in saved[0]}
                tt.H1_ONE_PASS_MAX_N = limit
                for leg, run in legs.items():
                    ms[leg][design].append(run(n)["ms"])
            strips = {f"E1_{'bim' if key[2] else 'hom'}_L{key[1]}": t.strip
                      for key, t in hx._E1_TILES.items() if key[0] == n}
            strips["H1"] = next(t.strip for key, t in tt._H1_TILES.items() if key[0] == n)
            out.append(dict(n=n, ms=ms, stream_strips=strips))
            print(json.dumps(out[-1]), flush=True)
            for leg, by in ms.items():
                tile, stream = (statistics.mean(by[d]) for d in ("tile", "stream"))
                summary[f"{leg}_{n}"] = dict(tile_ms=tile, stream_ms=stream,
                                             tile_over_stream=tile / stream,
                                             spread=max((max(by[d]) - min(by[d])) / min(by[d])
                                                        for d in by))
    finally:
        hx.E1_ONE_PASS_MAX_N, tt.H1_ONE_PASS_MAX_N = saved
    return out + [dict(summary=summary)]


SCAN_STRIPS = {n: (2, 4, 6, 8) if n <= 512 else (4, 6, 8, 12, 16, 20, 24, 28, 32, 48)
               for n in A34_LEVELS}


def strip_scan() -> list:
    """A3/A4 (bi-material plain form) at each level size and strip of
    SCAN_STRIPS, and at the strip the wrappers pick; one record per level."""
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from multigrid_feanet_torch.ops import sweep as sw

    dev = torch.cuda.current_device()
    out = []
    for n in A34_LEVELS:
        picked = {r["name"]: r["ms"] for r in cs.check_kernels(n, True, False, ["A3", "A4"])}
        chosen = {leg: sw._LAUNCH_TILES[(leg, n, True, 0, 0, 0, dev)].strip for leg in ("A3", "A4")}
        by_strip = {}
        for strip in SCAN_STRIPS[n]:
            for leg in ("A3", "A4"):
                sw._LAUNCH_TILES[(leg, n, True, 0, 0, 0, dev)] = sw.TILES[leg](n, strip)
            by_strip[strip] = {r["name"]: r["ms"]
                               for r in cs.check_kernels(n, True, False, ["A3", "A4"])}
        for leg in ("A3", "A4"):
            sw._LAUNCH_TILES[(leg, n, True, 0, 0, 0, dev)] = sw.TILES[leg](n, chosen[leg])
        out.append(dict(n=n, chosen=chosen, chosen_ms=picked, ms=by_strip))
        print(json.dumps(out[-1]), flush=True)
    return out


def _library(tree: Path) -> Path:
    """Build ``tree``'s kernel library in a process of its own; its path."""
    done = subprocess.run([sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
                           "from multigrid_feanet_torch import _build; _build.load(); "
                           "print(_build.library_path())", str(tree)],
                          capture_output=True, text=True, check=True)
    return Path(done.stdout.strip().splitlines()[-1])


# sweep.cu's kernels take their storage type as a last template argument
# (float: "f", bf16: "13__nv_bfloat16"); an earlier checkout's have none
STORED = re.compile(r"\d+(sweep_kernel|swrr_kernel|zpsweep_kernel|a5_resid_restrict|"
                    r"a6_cross_cycle)I((?:L[bi]\d+E)+)(f|13__nv_bfloat16)?E")


# this checkout keeps the parent's E1 and H1 for small grids under new names
RENAMED = {"15e1_h_relax_tile": "10e1_h_relax", "13h1_torus_tile": "14h1_torus_relax"}


def _plain_name(name: str) -> tuple:
    """(source, name) of a kernel's mangled name with its anonymous
    namespace, whose identifier (a hash and a suffix that nvcc varies between
    builds) is given by its length prefix, reduced to the source's name."""
    m = re.match(r"_ZN(\d+)(_GLOBAL__N__\w+)", name)
    if not m:
        return "", name
    size = int(m.group(1))
    ident, rest = m.group(2)[:size], m.group(2)[size:] + name[m.end():]
    src = re.search(r"_\d+_([a-z0-9]+)_cu_", ident)
    src = src.group(1) if src else ""
    return src, f"_ZN_GLOBAL__N__{src}_cu_{rest}"


def _functions(lib: Path) -> dict:
    """Every kernel of a library: (source, name key, storage) -> its
    instructions, without addresses, encodings or the anonymous namespace's
    identifier.  The name key of a sweep.cu leg is its name and non-type
    template arguments (its mangled parameter types follow the storage
    argument)."""
    sys.path.insert(0, str(ROOT))
    from multigrid_feanet_torch import _build

    cuobjdump = Path(_build.nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    out = {}
    for fn in re.split(r"\n\s*Function : ", text)[1:]:
        src, name = _plain_name(fn.split("\n", 1)[0].strip())
        m = STORED.search(name) if src == "sweep" else None
        key = (src, f"{m.group(1)}<{m.group(2)}>" if m else name,
               "bf16" if m and m.group(3) and m.group(3) != "f" else "f32")
        ins = [" ".join(re.sub(r"/\*[^*]*\*/", " ", line).split())
               for line in fn.split("\n") if re.search(r"/\*[0-9a-f]{4}\*/", line)]
        out[key] = [i for i in ins if i]
    return out


def sass_report(parent: Path) -> dict:
    """Every kernel of the parent's library (its f32 sweep.cu legs A1-A6 and
    all the other sources' kernels) but those named in CHANGED against this
    checkout's, instruction for instruction; the CHANGED ones against this
    checkout's kernels of the RENAMED names (reported, not required); A3/A4's
    instruction counts per step in both storage types."""
    mine, theirs = _functions(_library(ROOT)), _functions(_library(parent))
    renamed = {}
    for (src, name, storage), ins in mine.items():
        for new, old in RENAMED.items():
            if new in name:
                renamed[(src, name.replace(new, old), storage)] = ins
    hit = {k: any(c in k[1] for c in CHANGED) for k in {*mine, *theirs}}
    same = {k: mine.get(k) == ins for k, ins in theirs.items() if not hit[k]}
    kept = {" ".join(k): renamed.get(k, mine.get(k)) == ins for k, ins in theirs.items()
            if hit[k]}
    new = sorted(" ".join(k) for k in mine if hit[k] and k not in theirs
                 and not any(r in k[1] for r in RENAMED))
    legs = {k: v for k, v in same.items() if k[0] == "sweep" and "<" in k[1]}
    a34 = {}
    for (src, name, storage), ins in mine.items():
        if src == "sweep" and (name.startswith("zpsweep_kernel")
                               or re.match(r"swrr_kernel<Lb\dELi\dELb1E>", name)):
            bars = [i for i, x in enumerate(ins) if x.startswith("BAR.SYNC")]
            steps = [b - a for a, b in zip(bars, bars[1:])]
            a34[f"{name} {storage}"] = dict(instructions=len(ins),
                                            per_step=statistics.median(steps))
    return dict(same=sum(same.values()), total=len(same),
                sweep_legs_same=sum(legs.values()), sweep_legs_total=len(legs),
                differ=[" ".join(k) for k, v in same.items() if not v],
                changed_kept_same=sum(kept.values()), changed_kept_total=len(kept),
                changed_differ=[k for k, v in kept.items() if not v], new=new,
                bf16_instances=sum(1 for k in mine if k[2] == "bf16"), a34=a34)


def _key(rec) -> str:
    if rec["name"] == "H1":
        return f"H1_{rec['n']}"
    if "n" not in rec:
        return rec["name"]
    form = "mass" if rec.get("mass") else "dform" if rec["dform"] else "plain"
    key = f"{rec['name']}_{rec['n']}_{'bim' if rec['bim'] else 'hom'}_{form}"
    if rec["name"] == "E1":
        key += f"_L{rec['L']}" + ("" if rec["bc"] is None else f"_bc{rec['bc']}")
    return key


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--legs", choices=("all", "a12", "a34", "e1h1", "pbc"), default="all")
    ap.add_argument("--out", type=Path, default=ROOT / "chiprun_out" / "sweep_vs_parent.json")
    ap.add_argument("--strip-scan", action="store_true")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--crossover", action="store_true")
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child is not None:
        return child(args.child.resolve(), args.legs)
    import torch

    if not torch.cuda.is_available():
        print("sweep_vs_parent: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    if args.strip_scan or args.crossover:
        print(smi, flush=True)
        name = "sweep_strip_scan.json" if args.strip_scan else "sweep_crossover.json"
        out = args.out if args.out.name != "sweep_vs_parent.json" else args.out.with_name(name)
        lines = [dict(card=smi)] + (strip_scan() if args.strip_scan else crossover())
        if args.crossover:
            print(json.dumps(lines[-1]), flush=True)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text("\n".join(json.dumps(line) for line in lines) + "\n")
        return 0
    if args.parent is None or not (args.parent / "multigrid_feanet_torch").is_dir():
        print("sweep_vs_parent: --parent DIR must hold a multigrid_feanet_torch",
              file=sys.stderr)
        return 2
    if args.sass:
        report = sass_report(args.parent.resolve())
        print(json.dumps(dict(sass=report)), flush=True)
        out = args.out if args.out.name != "sweep_vs_parent.json" else \
            args.out.with_name("sweep_sass.json")
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(dict(card=smi, sass=report)) + "\n")
        return 0 if report["same"] == report["total"] else 1
    print(smi, flush=True)
    lines = [dict(card=smi)]
    times = {}
    bounds = {}
    for label, tree in (("parent", args.parent), ("this", ROOT), ("this", ROOT),
                        ("parent", args.parent)):
        done = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--child",
                               str(tree.resolve()), "--legs", args.legs],
                              capture_output=True, text=True)
        if done.returncode != 0:
            print(done.stdout[-4000:], done.stderr[-4000:], sep="\n", file=sys.stderr)
            print(f"sweep_vs_parent: the {label} turn failed", file=sys.stderr)
            return 1
        recs = json.loads(done.stdout.strip().splitlines()[-1])
        turn = {_key(r): dict(ms=r["ms"], max_rel_err=r["max_rel_err"],
                              **({"launches": r["launches"]} if "launches" in r else {}))
                for r in recs}
        for r in recs:
            times.setdefault(_key(r), {}).setdefault(label, []).append(r["ms"])
            bounds[_key(r)] = r["bound_ms"]
        lines.append(dict(turn=label, legs=turn))
        print(json.dumps(lines[-1]), flush=True)
    summary = {}
    for key, by in times.items():
        (parent, p_spread), (this, t_spread) = (
            (sum(by[k]) / len(by[k]), (max(by[k]) - min(by[k])) / (sum(by[k]) / len(by[k])))
            for k in ("parent", "this"))
        summary[key] = dict(parent_ms=parent, this_ms=this, bound_ms=bounds[key],
                            parent_over_this=parent / this, this_of_bound=bounds[key] / this,
                            parent_spread=p_spread, this_spread=t_spread)
    lines.append(dict(summary=summary))
    print(json.dumps(lines[-1]), flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text("\n".join(json.dumps(line) for line in lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
