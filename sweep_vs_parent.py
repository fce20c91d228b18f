#!/usr/bin/env python3
"""Time the row-streaming legs of ``csrc/sweep.cu`` (A1-A4) of this checkout
against those of an earlier checkout of the port on one GPU, in turns.

    python3 sweep_vs_parent.py --parent DIR [--legs all|a12|a34] [--out FILE]
    python3 sweep_vs_parent.py --strip-scan [--out FILE]
    python3 sweep_vs_parent.py --parent DIR --sass [--out FILE]

DIR holds an earlier commit's ``multigrid_feanet_torch`` (for example
``git archive <commit> multigrid_feanet_torch | tar -x -C build/parent``).
Each turn is a process of its own that imports the package of one
checkout, which builds that checkout's kernels into its own
``build/kernels``, and runs ``chip_smoke.check_kernels`` on it: each
checkout's own wrappers are held against their plain versions at ``TOL``
and timed with ``chip_smoke.kernel_ms`` (50 graph-replayed launches on
L2-cold inputs, median of 3).  The turns run parent, this, this, parent.

- ``a12``: ``sweep_cuda`` (sweep, residual and psweep modes) and
  ``swrr_cuda`` at 4097^2, in the bi-material difference form (the
  interface solve), the homogeneous difference form (Poisson) and the
  bi-material mass form (heat).
- ``a34``: ``zrr_cuda`` (A3) and ``zpsweep_cuda`` (A4) at every level size
  the 4097^2 interface solve launches them at (n = 2048 ... 32), in the
  bi-material and homogeneous plain forms and the bi-material mass form.

Prints the card's name and power limit, one JSON line per turn and a
summary line (each checkout's mean and spread over its two turns, the byte
bound and the parent-over-this ratio), and writes them to ``--out``
(default ``chiprun_out/sweep_vs_parent.json``).  Fails when a turn fails.

``--strip-scan`` times this checkout's A3 and A4 alone, bi-material plain
form, at each level size over a range of strip heights (the launch geometry
set by hand instead of ``ops/sweep.py::balanced_strip``), beside the height
``balanced_strip`` picks: the data its cost model for A3/A4 is fitted to.
Writes ``chiprun_out/sweep_strip_scan.json`` by default.

``--sass`` builds both checkouts' libraries and reads their machine code
with ``cuobjdump -sass``: whether every kernel of the parent's library (the
f32 instances of A1-A6 and every other source's kernels) compiles to the
same instructions in this checkout (addresses, encodings and the anonymous
namespace's name aside; a leg's storage-type template argument maps its
float instance to the parent's), the number of bf16 instances, and the
instructions of A3 and A4 in all and per step of their row loop (between
two barriers).  Fails unless every kernel matches.  Writes
``chiprun_out/sweep_sass.json`` by default.
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
    torch.cuda.synchronize()
    for r in recs:
        r["bound_ms"] = 1e3 * r["bytes"] / cs.HBM_BYTES_PER_S
    print(json.dumps(recs), flush=True)
    return 0


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


def _functions(lib: Path) -> dict:
    """Every kernel of a library: (source, name key, storage) -> its
    instructions, without addresses, encodings or the anonymous namespace's
    hash.  The name key of a sweep.cu leg is its name and non-type template
    arguments (its mangled parameter types follow the storage argument)."""
    sys.path.insert(0, str(ROOT))
    from multigrid_feanet_torch import _build

    cuobjdump = Path(_build.nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    out = {}
    for fn in re.split(r"\n\s*Function : ", text)[1:]:
        name = fn.split("\n", 1)[0].strip()
        # the anonymous namespace: _GLOBAL__N__<hash>_<len>_<file>_cu_[<hash>]
        src = re.search(r"_GLOBAL__N__[0-9a-f]+_\d+_([a-z0-9]+)_cu_", name)
        src = src.group(1) if src else ""
        name = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__", name)
        name = re.sub(r"(_cu_)[0-9a-f]{8}(?=\d)", r"\1", name)
        m = STORED.search(name) if src == "sweep" else None
        key = (src, f"{m.group(1)}<{m.group(2)}>" if m else name,
               "bf16" if m and m.group(3) and m.group(3) != "f" else "f32")
        ins = [" ".join(re.sub(r"/\*[^*]*\*/", " ", line).split())
               for line in fn.split("\n") if re.search(r"/\*[0-9a-f]{4}\*/", line)]
        out[key] = [i for i in ins if i]
    return out


def sass_report(parent: Path) -> dict:
    """Every kernel of the parent's library (its f32 sweep.cu legs A1-A6 and
    all the other sources' kernels) against this checkout's, instruction for
    instruction; A3/A4's instruction counts per step in both storage
    types."""
    mine, theirs = _functions(_library(ROOT)), _functions(_library(parent))
    same = {k: mine.get(k) == ins for k, ins in theirs.items()}
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
                bf16_instances=sum(1 for k in mine if k[2] == "bf16"), a34=a34)


def _key(rec) -> str:
    form = "mass" if rec["mass"] else "dform" if rec["dform"] else "plain"
    return f"{rec['name']}_{rec['n']}_{'bim' if rec['bim'] else 'hom'}_{form}"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--legs", choices=("all", "a12", "a34"), default="all")
    ap.add_argument("--out", type=Path, default=ROOT / "chiprun_out" / "sweep_vs_parent.json")
    ap.add_argument("--strip-scan", action="store_true")
    ap.add_argument("--sass", action="store_true")
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
    if args.strip_scan:
        print(smi, flush=True)
        out = args.out if args.out.name != "sweep_vs_parent.json" else \
            args.out.with_name("sweep_strip_scan.json")
        lines = [dict(card=smi)] + strip_scan()
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
        turn = {_key(r): dict(ms=r["ms"], max_rel_err=r["max_rel_err"]) for r in recs}
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
