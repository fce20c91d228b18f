#!/usr/bin/env python3
"""Time A1 and A2 of this checkout against those of an earlier checkout of
the port on one GPU, in turns.

    python3 a12_vs_parent.py --parent DIR [--out FILE]

DIR holds an earlier commit's ``multigrid_feanet_torch`` (for example
``git archive <commit> multigrid_feanet_torch | tar -x -C build/parent``).
Each turn is a process of its own that imports the package of one
checkout, which builds that checkout's kernels into its own
``build/kernels``, and runs ``chip_smoke.check_kernels`` on it: each
checkout's own wrappers ``sweep_cuda`` (sweep, residual and psweep modes)
and ``swrr_cuda`` are held against their plain versions at ``TOL`` and
timed with ``chip_smoke.kernel_ms`` (50 graph-replayed launches on L2-cold
inputs, median of 3) at 4097^2, in the bi-material difference form (the
interface solve), the homogeneous difference form (Poisson) and the
bi-material mass form (heat).  The turns run parent, this, this, parent.

Prints the card's name and power limit, one JSON line per turn and a
summary line (each checkout's mean over its two turns, the byte bound and
the parent-over-this ratio), and writes them to ``--out`` (default
``chiprun_out/a12_vs_parent.json``).  Fails when a turn fails.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
LEGS = ["A1_sweep", "A1_residual", "A1_psweep", "A2"]


def child(checkout: Path) -> int:
    """One turn: hold and time A1/A2 of ``checkout``'s package; prints the
    records as one JSON line."""
    import torch

    sys.path.insert(0, str(checkout))
    import multigrid_feanet_torch

    if not Path(multigrid_feanet_torch.__file__).resolve().is_relative_to(checkout):
        raise SystemExit(f"a12_vs_parent: imported {multigrid_feanet_torch.__file__}, "
                         f"not the package in {checkout}")
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    n = cs.N_MAIN
    heat = (cs.HEAT_THETA * cs.HEAT_DT, 20.0 * cs.HEAT_THETA * cs.HEAT_DT)
    recs = (cs.check_kernels(n, True, True, LEGS)
            + cs.check_kernels(n, False, True, LEGS)
            + cs.check_kernels(n, True, False, LEGS, coef=heat, mass=cs.level_mass(n)))
    torch.cuda.synchronize()
    for r in recs:
        r["bound_ms"] = 1e3 * r["bytes"] / cs.HBM_BYTES_PER_S
    print(json.dumps(recs), flush=True)
    return 0


def _key(rec) -> str:
    form = "mass" if rec["mass"] else "dform" if rec["dform"] else "plain"
    return f"{rec['name']}_{'bim' if rec['bim'] else 'hom'}_{form}"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--out", type=Path, default=ROOT / "chiprun_out" / "a12_vs_parent.json")
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child is not None:
        return child(args.child.resolve())
    import torch

    if not torch.cuda.is_available():
        print("a12_vs_parent: no CUDA device", file=sys.stderr)
        return 2
    if args.parent is None or not (args.parent / "multigrid_feanet_torch").is_dir():
        print("a12_vs_parent: --parent DIR must hold a multigrid_feanet_torch", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    lines = [dict(card=smi)]
    times = {}
    bounds = {}
    for label, tree in (("parent", args.parent), ("this", ROOT), ("this", ROOT),
                        ("parent", args.parent)):
        done = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--child",
                               str(tree.resolve())], capture_output=True, text=True)
        if done.returncode != 0:
            print(done.stdout[-4000:], done.stderr[-4000:], sep="\n", file=sys.stderr)
            print(f"a12_vs_parent: the {label} turn failed", file=sys.stderr)
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
        parent, this = (sum(by[k]) / len(by[k]) for k in ("parent", "this"))
        summary[key] = dict(parent_ms=parent, this_ms=this, bound_ms=bounds[key],
                            parent_over_this=parent / this, this_of_bound=bounds[key] / this)
    lines.append(dict(summary=summary))
    print(json.dumps(lines[-1]), flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text("\n".join(json.dumps(line) for line in lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
