#!/usr/bin/env python3
"""Time the row-streaming legs of ``csrc/sweep.cu`` (A1-A4, A6),
``csrc/hrelax.cu`` (E1, E2, E3, E5), ``csrc/torus.cu`` (H1), ``csrc/qsweep.cu`` (F1),
``csrc/stencil.cu`` (C1, C2), ``csrc/elastic.cu`` (G1, G2, G4, G5), ``csrc/general.cu`` (D2),
``csrc/hrelax.cu``'s E4 and ``csrc/passes.cu``'s X1 of this checkout against those of an
earlier checkout of the port on one GPU, in turns.

    python3 sweep_vs_parent.py --parent DIR
        [--legs all|a12|a34|e1h1|f1a6|c1e2|e3e5|g2d2|e4c2|g1g5|g4a5|x1|pbc|g2d2_cells
                |e4c2_cells|g1g5_cells|g4a5_cells|learned|x7x8]
        [--out FILE]
    python3 sweep_vs_parent.py --strip-scan [--legs all|e3e5|g2d2|e4c2|g1g5|g4a5|x7x8]
        [--out FILE]
    python3 sweep_vs_parent.py --crossover
        [--legs all|e1h1|f1a6|c1e2|e3e5|g2d2|e4c2|g1g5|g4a5|x1] [--out FILE]
    python3 sweep_vs_parent.py --levels [--legs all|c1e2|e3e5|g2d2|e4c2|g1g5|g4a5] [--out FILE]
    python3 sweep_vs_parent.py --parent DIR --sass [--out FILE]

DIR holds an earlier commit's ``multigrid_feanet_torch`` (for example
``git archive <commit> multigrid_feanet_torch | tar -x -C build/parent``).
Each turn is a process of its own that imports the package of one
checkout, which builds that checkout's kernels into its own
``build/kernels``, and runs ``chip_smoke``'s holds (``check_kernels``,
``check_e1``, ``check_torus``, ``check_f1``, ``check_stencil``,
``check_hrelax``) on it: each checkout's own
wrappers are held
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
- ``f1a6``: ``qsweep_cuda`` (F1) at 4097^2 on the circle's bf16 and f32 Q
  (``qsweep_4097``'s) and with the bf16 Q at every size of CROSS_LEVELS;
  ``pswrr_cuda`` (A6) at 4097^2 in the bi-material difference form
  (``pswrr_interface_4097``'s) in f32 and bf16 storage, with A2 and A1's
  psweep (the split pair A6 fuses) timed beside it in the same turn, in the
  homogeneous difference and the bi-material mass form, and bi-material at
  every size of CROSS_LEVELS.  The summary adds A6 over A2 + A1 psweep for
  each checkout.
- ``c1e2``: ``relax_cuda`` (C1) in sweep and residual mode, homogeneous
  (``poisson_4097_r1``'s) and bi-material, at 4097^2 and 2049^2; and
  ``hswrr_cuda`` (E2) at 4097^2 with the L = 1 and L = 3 nets, bi-material
  in difference form (``hmg_interface_4097``'s) and homogeneous in plain
  form (``hmg_4097``'s); and the one-pass tiles at the sizes this
  checkout launches them, C1 homogeneous at n = 32 ... 256 and E2 in those
  four forms at n = 64 ... 512.
- ``e3e5``: ``phrelax_cuda`` (E3) at 4097^2 and ``zphrelax_cuda`` (E5) at
  2049^2 with the L = 1 and L = 3 nets, bi-material in difference form
  (``hmg_interface_4097``'s) and homogeneous in plain form
  (``hmg_4097``'s); and both legs in those four forms at n = 64 ... 512,
  where this checkout runs its one-pass tiles up to its thresholds.
- ``g2d2``: ``el_swrr_cuda`` (G2) at 2049^2 and 1025^2, bi-material
  (``elastic_2049``'s) and homogeneous, and bi-material at n = 64 ... 512
  (the one-pass tile's sizes); ``gswrr_cuda`` (D2) on the 4097^2 BoxMG
  setup: bi-material at level 0 in bf16 (``boxmg_4097``'s) and f32 planes,
  bi-material at n = 64 ... 512 in bf16 planes, and the general 9-plane
  form at 512^2 in bf16 and f32.
- ``e4c2``: ``zhswrr_cuda`` (E4) at 2049^2 and 1025^2 with the L = 1 net,
  bi-material in difference form (``hmg_interface_4097``'s) and homogeneous
  in plain form (``hmg_4097``'s), and homogeneous with the L = 3 net; its
  one-pass tile at n = 64 ... 512 in the two L = 1 forms; ``multi_cuda``
  (C2) at 4097^2 and 2049^2 with k = 2, 4 and 8 (homogeneous, the
  ``_v22`` cell's, and bi-material), and k = 2 on its one-pass tile at
  n = 32 ... 256.
- ``g1g5``: ``el_sweep_cuda`` (G1) in sweep and residual mode and
  ``el_swrr_cuda`` (G2, whose sweep stage G1 and G5 share) at 2049^2,
  bi-material (``elastic_2049``'s) and homogeneous, and ``el_zpsweep_cuda``
  (G5) with G1's sweep at 1025^2 in both forms; both bi-material at every
  other level size of the elastic cells (n = 512 ... 16), where this
  checkout runs its one-pass tiles up to its thresholds.
- ``g4a5``: ``el_zrr_cuda`` (G4) at 1025^2, bi-material
  (``elastic_v11_2049``'s level 1) and homogeneous, and bi-material at every
  other level size it runs on there (n = 512 ... 16); ``rr_cuda`` (A5) at
  4097^2 in the bi-material and homogeneous difference form and the
  bi-material mass form, in f32 and bf16 storage, bi-material in difference
  form at n = 8, 16 and every size of CROSS_LEVELS, and homogeneous at n =
  8 and 16 (where this checkout runs A5's one-pass tiles).
- ``x1``: ``heat_rhs_cuda`` (X1, ``csrc/passes.cu``) at 4097^2 in every
  variant ``chip_smoke.pass_legs`` holds: bi-material (``heat_march_4097``'s)
  and homogeneous, one f (the time-independent march's) and two, f32 and
  bf16 u, and the float64 problem's f64 (two f); each held bit for bit
  against its plain version by ``chip_smoke.hold``.
- ``x7x8`` (not part of ``all``): X7 and X8 (``learned_restrict_bwd_cuda``,
  ``learned_prolong_bwd_cuda``, ``csrc/passes.cu``) bi-material with 16
  channels, and X9 on each one's partial sums, at ``chip_smoke.BWD_SHAPES``
  and at the training step's levels 64 ... 4 at its batch of 64
  (X7X8_LEVELS), the fields held bit for bit against their plain versions;
  each record keeps the partial rows X9 adds (``rows``).
- ``pbc`` (not part of ``all``): ``chip_smoke.run_pbc_cells`` in each turn
  (the periodic cells, with their checks), and from its torch.profiler
  profiles the device time per sweep or cycle of ``torus_jacobi_4096`` and
  ``pbc_mg_4096``: of every H1 launch and its norm pass (``H1`` plus
  ``rsq_reduce``, one-pass tiles included) and of the whole device.
- ``g2d2_cells`` (not part of ``all``): ``chip_smoke.run_boxmg_cell`` on the
  4097^2 BoxMG setup and ``chip_smoke.run_elastic_cells`` in each turn, and
  from their torch.profiler profiles each cell's device ms per cycle (per
  iteration for the PCG), that of G2 or D2 and of the norm passes
  (``rsq_reduce``), with the cycles and q.
- ``e4c2_cells`` (not part of ``all``): ``chip_smoke.run_hmg_cells`` and
  ``chip_smoke.run_r1_cells`` in each turn (``hmg_4097``,
  ``hmg_interface_4097``, ``poisson_4097_r1``, ``poisson_4097_r1_v22``), and
  from their torch.profiler profiles each cell's device ms per cycle, that
  of E4 or C2 and of the norm passes (``rsq_reduce``), with the cycles, the
  tail q and the wall per cycle.
- ``g1g5_cells`` (not part of ``all``): ``chip_smoke.run_elastic_cells`` in
  each turn (``elastic_2049``, ``_t512``, ``_pcg``, ``_v11``), and from their
  torch.profiler profiles each cell's device ms per cycle (per iteration
  for the PCG), that of G1 (G5 on ``_v11``) and of the norm passes
  (``rsq_reduce``), with the cycles, the q and the wall per cycle.
- ``g4a5_cells`` (not part of ``all``): as ``g1g5_cells``, with G4 on
  ``_v11`` (A5 runs on no cell).
- ``learned`` (not part of ``all``): ``learned_v_cycle`` as each checkout
  serves it (the evaluator's f: mass(1) in sample 0, mass of a seeded
  normal field in the rest; init parameters; wall ms a cycle, the median
  of 6 after one; at 4097^2 also the sha256 of the iterate after 7 cycles,
  compared across the turns, ``iterates_bitwise``): at 4097^2 (12 levels,
  batch 1) and at 65^2 (6 levels)
  on batches of LEARNED_BATCHES; in a checkout with the kernel route also
  that route and the torch path forced at every batch (``_route`` and
  ``_torch`` rows); first in each turn ``intergrid_train_64``'s training
  step (batch 64 of ``make_dataset(65, 120, seed=0)``, m = 6, the median
  of 10 after one), then a graded cycle with its backward at 65^2 on that
  batch (``graded_65_b64``: random per-channel weights, the loss sum(c *
  cycle(u0)), the median of 6 after one): the kernel route's autograd
  form in a checkout that has one, the torch path in one that has not.

Prints the card's name and power limit, one JSON line per turn and a
summary line (each checkout's mean and spread over its two turns, the byte
bound and the parent-over-this ratio), and writes them to ``--out``
(default ``chiprun_out/sweep_vs_parent.json``).  Fails when a turn fails.

``--strip-scan`` times this checkout's A3 and A4 alone, bi-material plain
form, at each level size over a range of strip heights (the launch geometry
set by hand instead of ``ops/sweep.py::balanced_strip``), beside the height
``balanced_strip`` picks: the data its cost model for A3/A4 is fitted to.
With ``--legs e3e5``: E3 at 4097^2 and E5 at 2049^2 instead, with the L = 1
and L = 3 nets, bi-material difference form and homogeneous plain form,
over SCAN_STRIPS_E3E5 beside the height ``ops/hrelax.py::row_strip`` picks.
With ``--legs g2d2``: G2 at 2049^2 (bi-material and homogeneous) and D2 at
4097^2 (bi-material, bf16 and f32 planes) over SCAN_STRIPS_G2D2, beside the
height ``row_strip`` picks.  With ``--legs e4c2``: E4 at 2049^2 (L = 1,
bi-material difference form and homogeneous) and C2 at 4097^2 (k = 2,
homogeneous and bi-material) over SCAN_STRIPS_G2D2.  With ``--legs g1g5``:
G1 at 2049^2 and G5 at 1025^2, bi-material and homogeneous, over
SCAN_STRIPS_G2D2.  With ``--legs g4a5``: G4 at 1025^2 (bi-material and
homogeneous) and A5 at 4097^2 (bi-material difference form, f32 and bf16)
over SCAN_STRIPS_G2D2.
Writes ``chiprun_out/sweep_strip_scan.json`` by default.

``--crossover`` times this checkout's kernels that have a one-pass tile
in both designs, the tile and row streaming (the size threshold of
``ops/hrelax.py::E1_ONE_PASS_MAX_N``, ``ops/torus.py::H1_ONE_PASS_MAX_N``,
``ops/qsweep.py::F1_ONE_PASS_MAX_N`` and ``ops/sweep.py::A6_ONE_PASS_MAX_N``
set at or below n), at n = 64 ... 1024: with ``--legs e1h1`` (or ``all``) E1
homogeneous with the L = 1 and L = 3 nets and the ring reset
(``measure_q_4096``'s and ``hjac_4097``'s form), bi-material with the L = 1
net, and H1; with ``--legs f1a6`` (or ``all``) F1 on bf16 and f32 Q and A6
in the bi-material and homogeneous difference form (f32) and the
bi-material one in bf16 storage.  The designs take turns (tile, streaming,
streaming, tile); the summary gives each design's mean and the
tile-over-streaming ratio, the data the thresholds are set from, and the
blocks per SM the card reports for the row-streaming F1 and A6.  With
``--legs c1e2`` (or ``all``): C1 homogeneous and bi-material (sweep mode)
and E2 homogeneous with the L = 1 and L = 3 nets and bi-material in
difference form with both nets (``ops/stencil_sweep.py::C1_ONE_PASS_MAX_N``,
``ops/hrelax.py::E2_ONE_PASS_MAX_N``), with their blocks per SM.  With
``--legs e3e5`` (or ``all``): E3 and E5 in those four forms
(``ops/hrelax.py::E3_ONE_PASS_MAX_N``, ``E5_ONE_PASS_MAX_N``; ``e3e5`` alone
also at n = 8, 16 and 32), with the row-streaming kernels' blocks per SM at
strips of 8, 32 and 128 rows.  With ``--legs g2d2`` (or ``all``): G2
bi-material and homogeneous and D2 bi-material in bf16 and f32 planes and
general in bf16 on the levels of the 4097^2 BoxMG setup
(``ops/elastic.py::G2_ONE_PASS_MAX_N``, ``ops/general.py::D2_ONE_PASS_MAX_N``),
with their blocks per SM.  With ``--legs e4c2`` (or ``all``): E4
homogeneous and bi-material in difference form with the L = 1 and L = 3
nets and C2 homogeneous and bi-material with k = 1 ... 4
(``ops/hrelax.py::E4_ONE_PASS_MAX_N``,
``ops/stencil_sweep.py::C2_ONE_PASS_MAX_N``; ``e4c2`` alone also at n = 8,
16 and 32), with their blocks per SM.  With ``--legs g1g5`` (or ``all``): G1
(sweep mode) and G5, bi-material and homogeneous
(``ops/elastic.py::G1_ONE_PASS_MAX_N``, ``G5_ONE_PASS_MAX_N``; ``g1g5``
alone also at n = 8, 16, 32 and 2048), with G1's blocks per SM and G5's at
strips of 8, 32 and 128 rows.  With ``--legs g4a5`` (or ``all``): G4
bi-material and homogeneous and A5 bi-material and homogeneous in
difference form, bi-material in mass form and bi-material in difference
form in bf16 storage (``ops/elastic.py::G4_ONE_PASS_MAX_N``,
``ops/sweep.py::A5_ONE_PASS_MAX_N``; ``g4a5`` alone also at n = 8, 16, 32
and 2048), with their blocks per SM.  With ``--legs x1`` (or ``all``): X1
bi-material and homogeneous with one f, bi-material with a bf16 u, and
the f64 problem's, bi-material and homogeneous
(``ops/passes.py::X1_ONE_PASS_MAX_N``; ``x1`` alone also at n = 8, 16, 32
and 2048), with the blocks per SM of its row-streaming instances.
Writes ``chiprun_out/sweep_crossover.json`` by default.

With ``--legs x7x8``: X7, X8 and X9 (on X7's partials) at 4097^2 (batch 1)
and 65^2 (batch 64), bi-material 16, at each strip of X7X8_SCAN beside the
strip ``ops/passes.py::bwd_strip`` picks, with the partial rows of each
strip and the blocks per SM of X7 and X8 at 16 channels.

``--levels`` times this checkout's kernels that run on more than one level
size at every size of the path PERF.md's kernel table counts their
launches on, each beside its byte bound: C1 (sweep and residual) and C2
(k = 2) at 4096 ... 32 (``poisson_4097_r1``, ``_v22``; homogeneous), E2 at
4096 and E4 and E5 at 2048 ... 32 with the L = 1 net (``hmg_4097``
homogeneous and ``hmg_interface_4097`` bi-material in difference form), D4
and D5 at 2048 ... 32 on the 4097^2 BoxMG setup's bf16 planes
(``boxmg_4097``), D2 and D3 at its level 0, and G1-G5 at 2048 ... 16 (the
elastic cells, bi-material); with ``--legs c1e2``, ``e3e5`` or ``e4c2``
only the C and E rows, which also time E3 at 4096 beside E2, with ``--legs g2d2``
only the D and G rows, with ``--legs g1g5`` only the G rows, with ``--legs
g4a5`` G4 at 1024 ... 16 (``elastic_v11_2049``, bi-material) and A5 at
4096 ... 32 (bi-material difference form; on no path).  Writes
``chiprun_out/sweep_levels.json`` by default.

``--sass`` builds both checkouts' libraries and reads their machine code
with ``cuobjdump -sass``: whether every kernel of the parent's library (the
f32 instances of A1-A6 and every other source's kernels) compiles to the
same instructions in this checkout (addresses, encodings and the anonymous
namespace's name aside; a leg's storage-type template argument maps its
float instance to the parent's), the number of bf16 instances, and the
instructions of A1-A4 (whole-field and slab instances) and the row-streaming
F1, A5, A6, C1, C2, E2, E3 (whole-field and slab instances), E4, E5, G1, G2,
G4, G5, D2 and X1 in all and per step
of their row loop (between two barriers;
``loop_step`` the median of the six longest gaps, the unrolled loop's
steps), with the registers, spills and shared memory ``ptxas`` gave the
row-streaming kernels, and X7's and X8's row loop (``bwd_loops``: its
instructions, those of the flush it branches over when no id changes, and
the rest, a step's).  The parent's kernels named in CHANGED (X7's and X8's,
redesigned) are compared apart and reported, those in REMOVED (the same) are
listed if
this checkout no longer builds them; the kernels new
in this checkout are listed; fails unless every other kernel matches.  Writes
``chiprun_out/sweep_sass.json`` by default.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import itertools
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
# the parent's kernels whose code this checkout changes (--sass compares
# them apart): X7 and X8, redesigned; every other kernel of the parent must
# compile to the same instructions
CHANGED = ("x7_learned_restrict_bwd", "x8_learned_prolong_bwd")
# the parent's kernels this checkout may no longer build, by (source, name)
REMOVED = (("passes", "x7_learned_restrict_bwd"), ("passes", "x8_learned_prolong_bwd"))
# X7's and X8's row-streaming kernels (--sass: their registers and row loop)
BWD_KERNELS = ("x7_learned_restrict_bwd_rows", "x8_learned_prolong_bwd_rows")
# the training step's levels (n at a batch of 64) --legs x7x8 times beside
# chip_smoke.BWD_SHAPES
X7X8_LEVELS = ((64, 64), (32, 64), (16, 64), (8, 64), (4, 64))
# --strip-scan --legs x7x8: the strips X7, X8 and X9 are timed at, by (n, batch)
X7X8_SCAN = {(4096, 1): (2, 4, 8, 12, 16, 22, 32, 64), (64, 64): (1, 2, 4, 8), (4, 64): (1, 2, 4)}
# the row-streaming kernels whose instructions per step and registers --sass
# reports
ROW_KERNELS = ("f1_qsweep_rows", "a6_cross_cycle_rows", "c1_stencil_relax_rows",
               "c2_stencil_multi_rows", "e2_h_descent_rows", "e3_h_ascent_rows",
               "e4_h_zdescent_rows", "e5_h_zascent_rows", "g1_el_relax_rows",
               "g2_el_descent_rows", "g4_el_zdescent_rows", "g5_el_zascent_rows",
               "d2_gen_descent_rows", "a5_resid_restrict_rows",
               # A1-A4, whole-field ("sweep_kernel" also names A4's
               # zpsweep_kernel) and slab instances
               "sweep_kernel", "swrr_kernel", "sweep_slab_kernel", "swrr_slab_kernel",
               "zpsweep_slab_kernel",
               # the slab instances of the row-streaming E2 and E3
               "e2_slab_descent_rows", "e3_slab_ascent_rows",
               "x1_heat_rhs_rows")


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
    if legs in ("all", "f1a6"):
        import torch

        n = cs.N_MAIN
        recs += [cs.check_f1(n, torch.bfloat16), cs.check_f1(n, torch.float32)]
        recs += [cs.check_f1(m, torch.bfloat16) for m in CROSS_LEVELS]
        split = ["A6", "A2", "A1_psweep"]
        recs += (cs.check_kernels(n, True, True, split)
                 + cs.check_kernels(n, True, True, split, dtype=torch.bfloat16)
                 + cs.check_kernels(n, False, True, ["A6"])
                 + cs.check_kernels(n, True, False, ["A6"], coef=heat, mass=cs.level_mass(n)))
        for m in CROSS_LEVELS:
            recs += cs.check_kernels(m, True, True, ["A6"])
    if legs in ("all", "c1e2"):
        for n in (cs.N_MAIN, cs.N_MAIN // 2):
            for bim in (False, True):
                recs += cs.check_stencil(n, bim, ["C1_sweep", "C1_residual"])
        for bim, dform in ((True, True), (False, False)):
            for ckpt in (cs.HNET_L1, cs.HNET_L3):
                recs += cs.check_hrelax(cs.N_MAIN, bim, dform, ckpt, ["E2"])
                # the one-pass tiles at the sizes this checkout runs them
                for m in TILE_LEVELS:
                    recs += cs.check_hrelax(m, bim, dform, ckpt, ["E2"])
        for m in (32,) + TILE_LEVELS[:3]:
            recs += cs.check_stencil(m, False, ["C1_sweep"])
    if legs in ("all", "e3e5"):
        for bim, dform in ((True, True), (False, False)):
            for ckpt in (cs.HNET_L1, cs.HNET_L3):
                recs += cs.check_hrelax(cs.N_MAIN, bim, dform, ckpt, ["E3"])
                recs += cs.check_hrelax(cs.N_MAIN // 2, bim, dform, ckpt, ["E5"])
                # the one-pass tiles at and below this checkout's thresholds
                for m in TILE_LEVELS:
                    recs += cs.check_hrelax(m, bim, dform, ckpt, ["E3", "E5"])
    if legs in ("all", "g2d2"):
        for n in (cs.N_EL, cs.N_EL // 2):
            for bim in (True, False):
                recs += cs.check_elastic(n, bim, ["G2"])
        for m in TILE_LEVELS:
            recs += cs.check_elastic(m, True, ["G2"])
        _, _, setup = cs.boxmg_setup_on_card()
        for dt in (torch.bfloat16, torch.float32):
            recs += cs.check_general(0, True, ["D2"], setup, dt)
            recs += cs.check_general(3, False, ["D2"], setup, dt)
        for m in TILE_LEVELS:
            recs += cs.check_general(LEVEL_OF[m], True, ["D2"], setup, torch.bfloat16)
        del setup
    if legs in ("all", "e4c2"):
        for n in (cs.N_MAIN // 2, cs.N_MAIN // 4):
            for bim, dform, ckpt in ((True, True, cs.HNET_L1), (False, False, cs.HNET_L1),
                                     (False, False, cs.HNET_L3)):
                recs += cs.check_hrelax(n, bim, dform, ckpt, ["E4"])
        for m in TILE_LEVELS:
            for bim, dform in ((True, True), (False, False)):
                recs += cs.check_hrelax(m, bim, dform, cs.HNET_L1, ["E4"])
        for n in (cs.N_MAIN, cs.N_MAIN // 2):
            for bim in (False, True):
                recs += cs.check_stencil(n, bim, ["C2_k2", "C2_k4", "C2_k8"])
        for m in (32,) + TILE_LEVELS[:3]:
            recs += cs.check_stencil(m, False, ["C2_k2"])
    if legs in ("all", "g1g5"):
        for bim in (True, False):
            recs += cs.check_elastic(cs.N_EL, bim, ["G1_sweep", "G1_residual", "G2"])
            recs += cs.check_elastic(cs.N_EL // 2, bim, ["G1_sweep", "G5"])
        for m in EL_LEVELS[2:]:
            recs += cs.check_elastic(m, True, ["G1_sweep", "G5"])
    if legs in ("all", "g4a5"):
        for bim in (True, False):
            recs += cs.check_elastic(cs.N_EL // 2, bim, ["G4"])
        for m in EL_LEVELS[2:]:
            recs += cs.check_elastic(m, True, ["G4"])
        n = cs.N_MAIN
        for dt in (None, torch.bfloat16):
            recs += (cs.check_kernels(n, True, True, ["A5"], dtype=dt)
                     + cs.check_kernels(n, False, True, ["A5"], dtype=dt)
                     + cs.check_kernels(n, True, False, ["A5"], coef=heat, mass=cs.level_mass(n),
                                        dtype=dt))
        for m in SMALL_LEVELS[:2] + CROSS_LEVELS:
            recs += cs.check_kernels(m, True, True, ["A5"])
        for m in SMALL_LEVELS[:2]:
            recs += cs.check_kernels(m, False, True, ["A5"])
    if legs in ("all", "x1"):
        recs += [x1_hold(cs, cs.N_MAIN, **tags) for tags in X1_VARIANTS]
    if legs == "g1g5_cells":
        cells = cs.run_elastic_cells()
        recs += cell_records(cells, lambda name: "G5" if name.endswith("v11_2049") else "G1")
    if legs == "g4a5_cells":
        cells = cs.run_elastic_cells()
        recs += cell_records(cells, lambda name: "G4" if name.endswith("v11_2049") else "G1")
    if legs == "g2d2_cells":
        recs += descent_cells(cs)
    if legs == "e4c2_cells":
        recs += zdescent_multi_cells(cs)
    if legs == "learned":
        recs += learned_turn(cs)
    if legs == "x7x8":
        hiers = {}
        for n, N in dict.fromkeys(tuple(cs.BWD_SHAPES) + X7X8_LEVELS):
            recs += x7x8_records(cs, n, N, hiers)
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


# the batches the learned cycle is timed on at 65^2 (--legs learned)
LEARNED_BATCHES = (1, 2, 4, 8, 16, 32, 64)


def learned_turn(cs) -> list:
    """``--legs learned`` on the imported checkout (module docstring)."""
    import time

    import numpy as np
    import torch
    from multigrid_feanet_torch.core.device import full_f32
    from multigrid_feanet_torch.core.problem import GridHierarchy, Problem
    from multigrid_feanet_torch.data.rhs import make_dataset
    from multigrid_feanet_torch.learn import train_intergrid as ti
    from multigrid_feanet_torch.models import intergrid
    from multigrid_feanet_torch.ops.stencil import apply_mass

    def hier(n, levels=None):
        return GridHierarchy.create(Problem(n=n, inclusion=cs.CIRCLE), num_levels=levels,
                                    device=cs.DEVICE)

    def field(h, batch):
        H = h.finest.n_nodes
        F = np.ones((batch, H, H), np.float32)
        F[1:] = np.random.default_rng(27).standard_normal((batch - 1, H, H))
        return apply_mass(torch.as_tensor(F, device=cs.DEVICE), h.finest.h)

    def cycle_ms(h, params, f, cycle=None):
        return 1e3 * statistics.median(cs.learned_history(h, params, f, 7, cycle)["secs"][1:])

    def digest(h, params, f):
        """The sha256 of the iterate after 7 cycles from 0 (its float32 bytes)."""
        u = cs.learned_history(h, params, f, 7)["u"]
        return hashlib.sha256(u.cpu().numpy().tobytes()).hexdigest()[:16]

    def route(h, params, u, f):
        return intergrid._route(h, intergrid.DEFAULT_OMEGA).cycle(params, u, f)

    # the training step first, before the cycles' work in this process
    h64 = hier(64)
    F = torch.as_tensor(make_dataset(65, 120, seed=0).numpy()[:64], device=cs.DEVICE)
    state, secs = ti.init_state(0, device=cs.DEVICE), []
    for _ in range(11):
        torch.cuda.synchronize()
        t0 = time.time()
        state, _ = ti.train_step(h64, state, F)
        torch.cuda.synchronize()
        secs.append(time.time() - t0)
    recs = [dict(name="intergrid_train_64_step", ms=1e3 * statistics.median(secs[1:]))]
    rng = np.random.default_rng(64)
    graded = intergrid.IntergridParams(*(torch.as_tensor(
        (k + 0.1 * rng.standard_normal((16, 3, 3))).astype(np.float32), device=cs.DEVICE)
        for k in (intergrid.FULL_WEIGHTING_16, intergrid.BILINEAR_4)),
        torch.tensor([3.7, 1.1], device=cs.DEVICE))
    u0, f, c = (torch.as_tensor(rng.standard_normal((64, 65, 65)).astype(np.float32),
                                device=cs.DEVICE) for _ in range(3))
    secs = []
    for _ in range(7):
        torch.cuda.synchronize()
        t0 = time.time()
        with full_f32():
            (intergrid.learned_v_cycle(h64, graded, u0, f) * c).sum().backward()
        torch.cuda.synchronize()
        secs.append(time.time() - t0)
    recs.append(dict(name="graded_65_b64", ms=1e3 * statistics.median(secs[1:])))
    params = intergrid.IntergridParams.init(device=cs.DEVICE)
    h = hier(cs.N_MAIN, int(np.log2(cs.N_MAIN)))
    f = field(h, 1)
    recs.append(dict(name="learned_4097_b1", ms=cycle_ms(h, params, f),
                     digest=digest(h, params, f)))
    del h
    for b in LEARNED_BATCHES:
        f = field(h64, b)
        recs.append(dict(name=f"learned_65_b{b}", ms=cycle_ms(h64, params, f)))
        if hasattr(intergrid, "_route"):
            recs += [dict(name=f"learned_65_b{b}_route", ms=cycle_ms(h64, params, f, route)),
                     dict(name=f"learned_65_b{b}_torch",
                          ms=cycle_ms(h64, params, f, cs.torch_cycle))]
    return [dict(r, bytes=0, max_rel_err=0.0) for r in recs]


def x7x8_records(cs, n: int, N: int, hiers: dict) -> list:
    """X7 and X8 (bi-material, 16 channels) on a batch of N at level n of
    the imported checkout, each timed with ``chip_smoke.kernel_ms`` on
    L2-cold inputs and its field held bit for bit against its plain
    version (SystemExit otherwise), and X9 on each one's partial sums."""
    import numpy as np
    import torch
    from multigrid_feanet_torch.ops import passes as px

    x = cs.learned_pass_inputs(n, "bim16", N, 41 + n + N, hiers)
    rng = np.random.default_rng(43 + n + N)
    g_c = torch.as_tensor(rng.standard_normal((N, n // 2 + 1, n // 2 + 1)), dtype=torch.float32,
                          device=cs.DEVICE)
    g = torch.as_tensor(rng.standard_normal((N, n + 1, n + 1)), dtype=torch.float32,
                        device=cs.DEVICE)
    legs = (("X7", px.learned_restrict_bwd_cuda, px.learned_restrict_backward_plain,
             (g_c, x["r"], x["pid"], x["conv"], x["w"]), 0),
            ("X8", px.learned_prolong_bwd_cuda, px.learned_prolong_add_backward_plain,
             (g, x["v"], x["pid_c"], x["deconv"], x["w"]), 1))
    recs = []
    for key, kfn, pfn, args, which in legs:
        k, w = args[3], args[4]
        nbytes = cs.bwd_bytes(key, n, N, True)
        sets = min(8, -(-2 * cs.L2_BYTES // nbytes))
        xs = [args] + [tuple(a.clone() if torch.is_tensor(a) and a.is_floating_point() else a
                             for a in args) for _ in range(sets - 1)]
        outs = [kfn(*a) for a in xs]
        if not torch.equal(outs[0][0], pfn(*args)[0]):
            raise SystemExit(f"{key} at n = {n}, batch {N} departs from its plain version")
        rows = int(outs[0][1].shape[0])
        recs += [dict(name=key, n=n, batch=N, bim=True, bytes=nbytes, rows=rows, max_rel_err=0.0,
                      ms=cs.kernel_ms([lambda a=a, o=o: kfn(*a, *o) for a, o in zip(xs, outs)])),
                 dict(name=f"X9_{key}", n=n, batch=N, bim=True, bytes=4 * outs[0][1].numel(),
                      rows=rows, max_rel_err=0.0,
                      ms=cs.kernel_ms([lambda o=o: px.weight_grad_cuda(o[1], k, w, which)
                                       for o in outs]))]
        del xs, outs
    return recs


# the variants of X1 that chip_smoke.pass_legs holds, by their tags
X1_VARIANTS = [dict(bim=bim, bf16=bf16, two_f=two_f) for bim in (True, False)
               for bf16 in (False, True) for two_f in (False, True)] + \
              [dict(bim=bim, bf16=False, two_f=True, f64=True) for bim in (True, False)]
_X1_FIELDS = {}


def x1_hold(cs, n: int, **want) -> dict:
    """``chip_smoke.hold`` of the X1 variant of ``pass_legs(n)`` whose tags
    are ``want`` (a tag absent from either is False); the fields and forms
    of size n are made once."""
    if n not in _X1_FIELDS:
        _X1_FIELDS.clear()
        _X1_FIELDS[n] = (cs.pass_inputs(n, 24 + n), cs.pass_forms(n))
    for leg, call, cuda_fn, plain_fn, inputs, cfg, nbytes, tol, tags in cs.pass_legs(
            *_X1_FIELDS[n], n):
        if leg == "X1" and all(tags.get(k, False) == want.get(k, False) for k in {*tags, *want}):
            return cs.hold(leg, call, cuda_fn, plain_fn, inputs, cfg, nbytes, tol,
                           dict(n=n, **tags))
    raise ValueError(f"pass_legs holds no X1 variant {want}")


def cell_records(cells: dict, leg_of) -> list:
    """One record per cell of ``cells`` (chip_smoke's cell records): its
    profiled device ms per cycle (per iteration for the PCG) with its cycles
    and q, its wall ms per cycle where it has one, and those of its leg
    ``leg_of(name)`` and of the norm passes (``rsq_reduce``) with their
    launches."""
    out = []
    for name, rec in cells.items():
        prof = rec.get("profile", {})
        by = prof.get("by_kernel", {})
        q = {k: rec[k] for k in ("tail_q", "q_last6", "tail_q12", "q_asym60", "contraction")
             if k in rec}
        out.append(dict(name=f"{name}_device", ms=prof.get("busy_ms_per_cycle", 0.0),
                        cycles=rec.get("cycles", rec.get("iterations")), **q))
        if "ms_per_cycle" in rec:
            out.append(dict(name=f"{name}_wall", ms=rec["ms_per_cycle"]))
        for k in (leg_of(name), "rsq_reduce"):
            r = by.get(k, dict(ms_per_cycle=0.0, launches=0))
            out.append(dict(name=f"{name}_{k}", ms=r["ms_per_cycle"], launches=r["launches"]))
    return [dict(r, bytes=0, max_rel_err=0.0) for r in out]


def descent_cells(cs) -> list:
    """``boxmg_4097`` and the elastic cells of ``cs`` (chip_smoke), run on
    the imported checkout (``cell_records``: G2 / D2)."""
    prob, hier, setup = cs.boxmg_setup_on_card()
    cells = {"boxmg_4097": cs.run_boxmg_cell(prob, hier, setup)}
    del hier, setup
    cells.update(cs.run_elastic_cells())
    return cell_records(cells, lambda name: "D2" if name.startswith("boxmg") else "G2")


def zdescent_multi_cells(cs) -> list:
    """The H-MG and round-1 cells of ``cs`` (chip_smoke), run on the
    imported checkout (``cell_records``: E4 / C2, C1 on the V(1,1) cell)."""
    cells = cs.run_hmg_cells()
    cells.update(cs.run_r1_cells())
    return cell_records(cells, lambda name: "E4" if name.startswith("hmg")
                        else "C2" if name.endswith("v22") else "C1")


CROSS_LEVELS = (64, 128, 256, 512, 1024)
# the level sizes of the elastic cells (G1 runs at all of them, G5 from 1024)
EL_LEVELS = (2048, 1024, 512, 256, 128, 64, 32, 16)
# the level of the 4097^2 BoxMG setup at each size of CROSS_LEVELS
LEVEL_OF = {4096 >> level: level for level in range(7)}
# the smaller sizes e3e5 and e4c2 also time: E3 with L = 1 streamed faster than its
# tile at 64^2 already
SMALL_LEVELS = (8, 16, 32)
# c1e2: the sizes at which C1 (up to 256) and E2 (up to 512) run one-pass
# tiles; e3e5: the sizes around E3's and E5's thresholds
TILE_LEVELS = (64, 128, 256, 512)


def crossover(which: str) -> list:
    """The kernels of ``which`` (E1 in three forms and H1; F1 on two Q types
    and A6 in three forms; C1 in two forms and E2 in four; E3 and E5 in
    four each) at each size of CROSS_LEVELS (e3e5: also SMALL_LEVELS) in
    both designs, in turns; one record per size, then a summary."""
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from multigrid_feanet_torch.ops import hrelax as hx
    from multigrid_feanet_torch.ops import qsweep as qs
    from multigrid_feanet_torch.ops import stencil_sweep as ss
    from multigrid_feanet_torch.ops import sweep as sw
    from multigrid_feanet_torch.ops import torus as tt

    legs, thresholds, strips_of = {}, [], {}
    if which in ("all", "e1h1"):
        thresholds += [(hx, "E1_ONE_PASS_MAX_N"), (tt, "H1_ONE_PASS_MAX_N")]
        legs.update({"E1_hom_L1": lambda n: cs.check_e1(n, False, False, cs.HNET_L1, bc=0.0),
                     "E1_hom_L3": lambda n: cs.check_e1(n, False, False, cs.HNET_ITER, bc=0.0),
                     "E1_bim_L1": lambda n: cs.check_e1(n, True, False, cs.HNET_L1),
                     "H1": cs.check_torus})
        for L in (1, 3):
            for bim in (False, True):
                strips_of[f"E1_{'bim' if bim else 'hom'}_L{L}"] = \
                    lambda n, L=L, bim=bim: [t.strip for key, t in hx._E1_TILES.items()
                                             if key[:3] == (n, L, bim)]
        strips_of["H1"] = lambda n: [t.strip for key, t in tt._H1_TILES.items() if key[0] == n]
    if which in ("all", "f1a6"):
        thresholds += [(qs, "F1_ONE_PASS_MAX_N"), (sw, "A6_ONE_PASS_MAX_N")]
        bf = torch.bfloat16
        legs.update({"F1_bf16": lambda n: cs.check_f1(n, bf),
                     "F1_f32": lambda n: cs.check_f1(n, torch.float32),
                     "A6_bim_dform": lambda n: cs.check_kernels(n, True, True, ["A6"])[0],
                     "A6_hom_dform": lambda n: cs.check_kernels(n, False, True, ["A6"])[0],
                     "A6_bim_dform_bf16": lambda n: cs.check_kernels(n, True, True, ["A6"],
                                                                     dtype=bf)[0]})
        strips_of["F1"] = lambda n: [t.strip for key, t in qs._F1_TILES.items() if key[0] == n]
        strips_of["A6"] = lambda n: [t.strip for key, t in sw._LAUNCH_TILES.items()
                                     if key[:2] == ("A6", n)]
    if which in ("all", "e3e5"):
        thresholds += [(hx, "E3_ONE_PASS_MAX_N"), (hx, "E5_ONE_PASS_MAX_N")]
        for leg in ("E3", "E5"):
            for (bim, dform), (L, ckpt) in itertools.product(((False, False), (True, True)),
                                                             ((1, cs.HNET_L1), (3, cs.HNET_L3))):
                legs[f"{leg}_{'bim_dform' if bim else 'hom'}_L{L}"] = \
                    lambda n, leg=leg, bim=bim, dform=dform, ckpt=ckpt: cs.check_hrelax(
                        n, bim, dform, ckpt, [leg])[0]
            strips_of[leg] = lambda n, leg=leg: [t.strip for key, t in hx._ASCENT_TILES.items()
                                                 if key[:2] == (leg, n)]
    if which in ("all", "c1e2"):
        thresholds += [(ss, "C1_ONE_PASS_MAX_N"), (hx, "E2_ONE_PASS_MAX_N")]
        for bim in (False, True):
            legs[f"C1_{'bim' if bim else 'hom'}"] = \
                lambda n, bim=bim: cs.check_stencil(n, bim, ["C1_sweep"])[0]
        for (bim, dform), (L, ckpt) in itertools.product(((False, False), (True, True)),
                                                         ((1, cs.HNET_L1), (3, cs.HNET_L3))):
            legs[f"E2_{'bim_dform' if bim else 'hom'}_L{L}"] = \
                lambda n, bim=bim, dform=dform, ckpt=ckpt: cs.check_hrelax(
                    n, bim, dform, ckpt, ["E2"])[0]
        strips_of["C1"] = lambda n: [t.strip for key, t in ss._C1_TILES.items() if key[0] == n]
        strips_of["E2"] = lambda n: [t.strip for key, t in hx._E2_TILES.items() if key[0] == n]
    if which in ("all", "g2d2"):
        from multigrid_feanet_torch.ops import elastic as eg
        from multigrid_feanet_torch.ops import general as gen

        thresholds += [(eg, "G2_ONE_PASS_MAX_N"), (gen, "D2_ONE_PASS_MAX_N")]
        _, _, setup = cs.boxmg_setup_on_card()
        for bim in (True, False):
            legs[f"G2_{'bim' if bim else 'hom'}"] = \
                lambda n, bim=bim: cs.check_elastic(n, bim, ["G2"])[0]
        for bim, dt in ((True, torch.bfloat16), (True, torch.float32), (False, torch.bfloat16)):
            legs[f"D2_{'bim' if bim else 'general'}_{str(dt).removeprefix('torch.')}"] = \
                lambda n, bim=bim, dt=dt: cs.check_general(LEVEL_OF[n], bim, ["D2"], setup,
                                                           dt)[0]
        strips_of["G2"] = lambda n: [t.strip for key, t in eg._G2_TILES.items() if key[0] == n]
        strips_of["D2"] = lambda n: [t.strip for key, t in gen._D2_TILES.items() if key[0] == n]
    if which in ("all", "g1g5"):
        from multigrid_feanet_torch.ops import elastic as eg

        thresholds += [(eg, "G1_ONE_PASS_MAX_N"), (eg, "G5_ONE_PASS_MAX_N")]
        for bim in (True, False):
            form = "bim" if bim else "hom"
            legs[f"G1_{form}"] = lambda n, bim=bim: cs.check_elastic(n, bim, ["G1_sweep"])[0]
            legs[f"G5_{form}"] = lambda n, bim=bim: cs.check_elastic(n, bim, ["G5"])[0]
        strips_of["G1"] = lambda n: [t.strip for key, t in eg._G1_TILES.items() if key[0] == n]
        strips_of["G5"] = lambda n: [t.strip for key, t in eg._G5_TILES.items() if key[0] == n]
    if which in ("all", "g4a5"):
        from multigrid_feanet_torch.ops import elastic as eg

        thresholds += [(eg, "G4_ONE_PASS_MAX_N"), (sw, "A5_ONE_PASS_MAX_N")]
        for bim in (True, False):
            legs[f"G4_{'bim' if bim else 'hom'}"] = \
                lambda n, bim=bim: cs.check_elastic(n, bim, ["G4"])[0]
        heat = (cs.HEAT_THETA * cs.HEAT_DT, 20.0 * cs.HEAT_THETA * cs.HEAT_DT)
        legs.update({
            "A5_bim_dform": lambda n: cs.check_kernels(n, True, True, ["A5"])[0],
            "A5_hom_dform": lambda n: cs.check_kernels(n, False, True, ["A5"])[0],
            "A5_bim_mass": lambda n: cs.check_kernels(n, True, False, ["A5"], coef=heat,
                                                      mass=cs.level_mass(n))[0],
            "A5_bim_dform_bf16": lambda n: cs.check_kernels(n, True, True, ["A5"],
                                                            dtype=torch.bfloat16)[0]})
        strips_of["G4"] = lambda n: [t.strip for key, t in eg._G4_TILES.items() if key[0] == n]
        strips_of["A5"] = lambda n: [t.strip for key, t in sw._A5_TILES.items() if key[0] == n]
    if which in ("all", "x1"):
        from multigrid_feanet_torch.ops import passes as px

        thresholds += [(px, "X1_ONE_PASS_MAX_N")]
        for label, tags in (("bim", dict(bim=True, bf16=False, two_f=False)),
                            ("hom", dict(bim=False, bf16=False, two_f=False)),
                            ("bim_bf16", dict(bim=True, bf16=True, two_f=False)),
                            ("bim_f64", dict(bim=True, bf16=False, two_f=True, f64=True)),
                            ("hom_f64", dict(bim=False, bf16=False, two_f=True, f64=True))):
            legs[f"X1_{label}"] = lambda n, tags=tags: x1_hold(cs, n, **tags)
        strips_of["X1"] = lambda n: [t.strip for key, t in px._X1_TILES.items() if key[0] == n]
    if which in ("all", "e4c2"):
        thresholds += [(hx, "E4_ONE_PASS_MAX_N"), (ss, "C2_ONE_PASS_MAX_N")]
        for (bim, dform), (L, ckpt) in itertools.product(((False, False), (True, True)),
                                                         ((1, cs.HNET_L1), (3, cs.HNET_L3))):
            legs[f"E4_{'bim_dform' if bim else 'hom'}_L{L}"] = \
                lambda n, bim=bim, dform=dform, ckpt=ckpt: cs.check_hrelax(
                    n, bim, dform, ckpt, ["E4"])[0]
        for bim, k in itertools.product((False, True), range(1, ss.C2_STREAM_MAX_K + 1)):
            legs[f"C2_{'bim' if bim else 'hom'}_k{k}"] = \
                lambda n, bim=bim, k=k: cs.check_stencil(n, bim, [f"C2_k{k}"])[0]
        strips_of["E4"] = lambda n: [t.strip for key, t in hx._E4_TILES.items() if key[0] == n]
        strips_of["C2"] = lambda n: [t.strip for key, t in ss._C2_TILES.items() if key[0] == n]
    saved = [getattr(m, a) for m, a in thresholds]
    out, summary = [], {}
    try:
        sizes = (SMALL_LEVELS if which in ("e3e5", "e4c2", "g1g5", "g4a5", "x1") else ()) + \
            CROSS_LEVELS
        for n in sizes + ((2048,) if which in ("g1g5", "g4a5", "x1") else ()):
            ms = {leg: {"tile": [], "stream": []} for leg in legs}
            for design in ("tile", "stream", "stream", "tile"):
                limit = n if design == "tile" else -1
                for (m, a), v in zip(thresholds, saved):
                    setattr(m, a, {L: limit for L in v} if isinstance(v, dict) else limit)
                for leg, run in legs.items():
                    ms[leg][design].append(run(n)["ms"])
            strips = {leg: sorted(set(fn(n))) for leg, fn in strips_of.items()}
            out.append(dict(n=n, ms=ms, stream_strips=strips))
            print(json.dumps(out[-1]), flush=True)
            for leg, by in ms.items():
                tile, stream = (statistics.mean(by[d]) for d in ("tile", "stream"))
                summary[f"{leg}_{n}"] = dict(tile_ms=tile, stream_ms=stream,
                                             tile_over_stream=tile / stream,
                                             spread=max((max(by[d]) - min(by[d])) / min(by[d])
                                                        for d in by))
    finally:
        for (m, a), v in zip(thresholds, saved):
            setattr(m, a, v)
    blocks = {}
    if which in ("all", "f1a6"):
        blocks = {"F1_bf16": hx.occupancy("mg_qsweep_occupancy", 1),
                  "F1_f32": hx.occupancy("mg_qsweep_occupancy", 0)}
        for bim, form, bf16 in ((1, 1, 0), (0, 1, 0), (1, 1, 1), (1, 2, 0)):
            blocks[f"A6_bim{bim}_form{form}_bf16{bf16}_strip{sw.A12_STRIP_MAX}"] = hx.occupancy(
                "mg_a12_occupancy", 6, bim, form, 0, bf16, sw.A12_STRIP_MAX)
    if which in ("all", "c1e2"):
        for bim, mode in itertools.product((0, 1), (0, 1)):
            blocks[f"C1_bim{bim}_mode{mode}"] = hx.occupancy("st_relax_occupancy", bim, mode)
        for bim, dform, L in itertools.product((0, 1), (0, 1), (1, 3)):
            blocks[f"E2_bim{bim}_dform{dform}_L{L}"] = hx.occupancy("mg_hswrr_occupancy", bim,
                                                                    dform, L)
    if which in ("all", "g2d2"):
        for bim in (0, 1):
            blocks[f"G2_bim{bim}"] = hx.occupancy("mg_el_swrr_occupancy", bim)
            for bf16 in (0, 1):
                blocks[f"D2_bim{bim}_bf16{bf16}"] = hx.occupancy("mg_gswrr_occupancy", bim, bf16)
    if which in ("all", "e4c2"):
        for bim, dform, L in itertools.product((0, 1), (0, 1), (1, 3)):
            blocks[f"E4_bim{bim}_dform{dform}_L{L}"] = hx.occupancy("mg_zhswrr_occupancy", bim,
                                                                    dform, L)
        for bim, k in itertools.product((0, 1), range(1, ss.C2_STREAM_MAX_K + 1)):
            blocks[f"C2_bim{bim}_k{k}"] = hx.occupancy("st_multi_occupancy", bim, k)
    if which in ("all", "g1g5"):
        for bim in (0, 1):
            blocks[f"G1_bim{bim}"] = hx.occupancy("mg_el_sweep_occupancy", bim, 0)
            for strip in (8, 32, 128):
                blocks[f"G5_bim{bim}_strip{strip}"] = hx.occupancy("mg_el_zpsweep_occupancy", bim,
                                                                   strip)
    if which in ("all", "g4a5"):
        for bim in (0, 1):
            blocks[f"G4_bim{bim}"] = hx.occupancy("mg_el_zrr_occupancy", bim)
        for bim, form, bf16 in ((1, 1, 0), (0, 1, 0), (1, 2, 0), (1, 1, 1), (0, 1, 1), (1, 2, 1)):
            blocks[f"A5_bim{bim}_form{form}_bf16{bf16}"] = hx.occupancy("mg_rr_occupancy", bim,
                                                                        form, bf16)
    if which in ("all", "x1"):
        for u_type, f64, bim, one_f in itertools.product((0, 1, 2), (0, 1), (0, 1), (0, 1)):
            if u_type < 2 or f64:
                blocks[f"X1_u{u_type}_f64{f64}_bim{bim}_onef{one_f}"] = hx.occupancy(
                    "px_heat_rhs_occupancy", u_type, f64, bim, one_f)
    if which in ("all", "e3e5"):
        for sym, leg in (("mg_phrelax_occupancy", "E3"), ("mg_zphrelax_occupancy", "E5")):
            for bim, dform, L, strip in itertools.product((0, 1), (0, 1), (1, 3), (8, 32, 128)):
                blocks[f"{leg}_bim{bim}_dform{dform}_L{L}_strip{strip}"] = hx.occupancy(
                    sym, bim, dform, L, strip)
    return out + [dict(summary=summary, blocks_per_sm=blocks)]


LEVEL_SIZES = (4096, 2048, 1024, 512, 256, 128, 64, 32)


def levels(which: str) -> list:
    """The multi-level kernels (and E2 and E3, at their one size) at each
    level size of their paths, all of them or (``which`` "c1e2" or "e3e5")
    the C and E rows; one record per kernel and size."""
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    def row(rec, path):
        bound = 1e3 * rec["bytes"] / cs.HBM_BYTES_PER_S
        return dict(name=rec["name"], n=rec["n"], path=path, ms=rec["ms"], warm_ms=rec["warm_ms"],
                    bound_ms=bound, loss_ms=rec["ms"] - bound, max_rel_err=rec["max_rel_err"],
                    **{k: rec[k] for k in ("bim", "dform", "coef_dtype") if k in rec})

    out = []
    if which == "g4a5":
        for n in LEVEL_SIZES[2:] + (16,):
            out += [row(r, "elastic_v11_2049") for r in cs.check_elastic(n, True, ["G4"])]
        for n in LEVEL_SIZES:
            out += [row(r, "no path") for r in cs.check_kernels(n, True, True, ["A5"])]
        for r in out:
            print(json.dumps(r), flush=True)
        return out
    if which not in ("g2d2", "g1g5"):
        for n in LEVEL_SIZES:
            out += [row(r, "poisson_4097_r1")
                    for r in cs.check_stencil(n, False, ["C1_sweep", "C1_residual", "C2_k2"])]
        for n in LEVEL_SIZES:
            legs = ["E2", "E3"] if n == LEVEL_SIZES[0] else ["E4", "E5"]
            out += [row(r, "hmg_4097")
                    for r in cs.check_hrelax(n, False, False, cs.HNET_L1, legs)]
            out += [row(r, "hmg_interface_4097")
                    for r in cs.check_hrelax(n, True, True, cs.HNET_L1, legs)]
    if which in ("c1e2", "e3e5", "e4c2"):
        for r in out:
            print(json.dumps(r), flush=True)
        return out
    if which != "g1g5":
        _, _, setup = cs.boxmg_setup_on_card()
        out += [row(r, "boxmg_4097") for r in cs.check_general(0, True, ["D2", "D3"], setup,
                                                               torch.bfloat16)]
        for level in range(1, len(LEVEL_SIZES)):
            out += [row(r, "boxmg_4097") for r in cs.check_general(level, False, ["D4", "D5"],
                                                                   setup, torch.bfloat16)]
        del setup
    g_legs = ["G1_sweep", "G5"] if which == "g1g5" else ["G1_sweep", "G2", "G3", "G4", "G5"]
    for n in LEVEL_SIZES[1:] + (16,):
        out += [row(r, "elastic_2049") for r in cs.check_elastic(n, True, g_legs)]
    for r in out:
        print(json.dumps(r), flush=True)
    return out


SCAN_STRIPS = {n: (2, 4, 6, 8) if n <= 512 else (4, 6, 8, 12, 16, 20, 24, 28, 32, 48)
               for n in A34_LEVELS}


SCAN_STRIPS_E3E5 = (16, 22, 30, 40, 48, 62, 80, 108, 128)


def strip_scan_e3e5() -> list:
    """E3 at 4097^2 and E5 at 2049^2 (L = 1 and 3, bi-material difference
    form and homogeneous plain form) at each strip of SCAN_STRIPS_E3E5 and
    at the strip ``row_strip`` picks; one record per leg and form."""
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from multigrid_feanet_torch.ops import hrelax as hx

    dev = torch.cuda.current_device()
    out = []
    for leg, n, tiles_of in (("E3", cs.N_MAIN, hx.e3_tiles), ("E5", cs.N_MAIN // 2, hx.e5_tiles)):
        for (bim, dform), (L, ckpt) in itertools.product(((True, True), (False, False)),
                                                         ((1, cs.HNET_L1), (3, cs.HNET_L3))):
            picked = cs.check_hrelax(n, bim, dform, ckpt, [leg])[0]["ms"]
            key = (leg, n, L, bim, dform, dev)
            chosen = hx._ASCENT_TILES[key]
            by_strip = {}
            for strip in SCAN_STRIPS_E3E5:
                hx._ASCENT_TILES[key] = tiles_of(n, L, strip)
                by_strip[strip] = cs.check_hrelax(n, bim, dform, ckpt, [leg])[0]["ms"]
            hx._ASCENT_TILES[key] = chosen
            out.append(dict(leg=leg, n=n, L=L, bim=bim, dform=dform, chosen=chosen.strip,
                            chosen_ms=picked, ms=by_strip))
            print(json.dumps(out[-1]), flush=True)
    return out


SCAN_STRIPS_G2D2 = (8, 16, 22, 30, 40, 48, 62, 80, 108, 128)


def scan_cases(cases) -> list:
    """Each (leg, n, bim, tags, cache, key, tiles_of, run) of ``cases`` at the
    strip ``row_strip`` picked (``cache[key]``, after a first ``run()``) and
    at each strip of SCAN_STRIPS_G2D2 (``tiles_of(strip)`` set in its
    place); one record each."""
    out = []
    for leg, n, bim, tags, cache, key, tiles_of, run in cases:
        picked = run()
        chosen = cache[key]
        by_strip = {}
        for strip in SCAN_STRIPS_G2D2:
            cache[key] = tiles_of(strip)
            by_strip[strip] = run()
        cache[key] = chosen
        out.append(dict(leg=leg, n=n, bim=bim, **tags, chosen=chosen.strip, chosen_ms=picked,
                        ms=by_strip))
        print(json.dumps(out[-1]), flush=True)
    return out


def strip_scan_g2d2() -> list:
    """G2 at 2049^2 (bi-material and homogeneous) and D2 at 4097^2
    (bi-material, bf16 and f32 planes) at each strip of SCAN_STRIPS_G2D2
    and at the strip ``row_strip`` picks; one record per leg and form."""
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from multigrid_feanet_torch.ops import elastic as eg
    from multigrid_feanet_torch.ops import general as gen

    dev = torch.cuda.current_device()
    _, _, setup = cs.boxmg_setup_on_card()
    cases = [("G2", cs.N_EL, bim, dict(coef_dtype=None), eg._G2_TILES, (cs.N_EL, bim, dev),
              lambda s: eg.g2_tiles(cs.N_EL, s),
              lambda bim=bim: cs.check_elastic(cs.N_EL, bim, ["G2"])[0]["ms"])
             for bim in (True, False)]
    cases += [("D2", cs.N_MAIN, True, dict(coef_dtype=str(dt).removeprefix("torch.")),
               gen._D2_TILES, (cs.N_MAIN, True, dt == torch.bfloat16, dev),
               lambda s: gen.d2_tiles(cs.N_MAIN, s),
               lambda dt=dt: cs.check_general(0, True, ["D2"], setup, dt)[0]["ms"])
              for dt in (torch.bfloat16, torch.float32)]
    return scan_cases(cases)


def strip_scan_e4c2() -> list:
    """E4 at 2049^2 (L = 1, bi-material difference form and homogeneous)
    and C2 at 4097^2 (k = 2, homogeneous and bi-material) at each strip of
    SCAN_STRIPS_G2D2 and at the strip ``row_strip`` picks; one record per
    leg and form."""
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from multigrid_feanet_torch.ops import hrelax as hx
    from multigrid_feanet_torch.ops import stencil_sweep as ss

    dev = torch.cuda.current_device()
    n4, n2 = cs.N_MAIN // 2, cs.N_MAIN
    cases = [("E4", n4, bim, dict(L=1), hx._E4_TILES, (n4, 1, bim, bim, dev),
              lambda s: hx.e4_tiles(n4, 1, s),
              lambda bim=bim: cs.check_hrelax(n4, bim, bim, cs.HNET_L1, ["E4"])[0]["ms"])
             for bim in (True, False)]
    cases += [("C2", n2, bim, dict(k=2), ss._C2_TILES, (n2, 2, bim, dev),
               lambda s: ss.c2_tiles(n2, 2, s),
               lambda bim=bim: cs.check_stencil(n2, bim, ["C2_k2"])[0]["ms"])
              for bim in (False, True)]
    return scan_cases(cases)


def strip_scan_g1g5() -> list:
    """G1 at 2049^2 and G5 at 1025^2 (bi-material and homogeneous) at each
    strip of SCAN_STRIPS_G2D2 and at the strip ``row_strip`` picks; one
    record per leg and form."""
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from multigrid_feanet_torch.ops import elastic as eg

    dev = torch.cuda.current_device()
    n1, n5 = cs.N_EL, cs.N_EL // 2
    cases = [("G1", n1, bim, dict(mode="sweep"), eg._G1_TILES, (n1, bim, 0, dev),
              lambda s: eg.g1_tiles(n1, s),
              lambda bim=bim: cs.check_elastic(n1, bim, ["G1_sweep"])[0]["ms"])
             for bim in (True, False)]
    cases += [("G5", n5, bim, {}, eg._G5_TILES, (n5, bim, dev), lambda s: eg.g5_tiles(n5, s),
               lambda bim=bim: cs.check_elastic(n5, bim, ["G5"])[0]["ms"])
              for bim in (True, False)]
    return scan_cases(cases)


def strip_scan_g4a5() -> list:
    """G4 at 1025^2 (bi-material and homogeneous) and A5 at 4097^2
    (bi-material difference form, f32 and bf16) at each strip of
    SCAN_STRIPS_G2D2 and at the strip ``row_strip`` picks; one record per
    leg and form."""
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from multigrid_feanet_torch.ops import elastic as eg
    from multigrid_feanet_torch.ops import sweep as sw

    dev = torch.cuda.current_device()
    n4, n5 = cs.N_EL // 2, cs.N_MAIN
    cases = [("G4", n4, bim, {}, eg._G4_TILES, (n4, bim, dev), lambda s: eg.g4_tiles(n4, s),
              lambda bim=bim: cs.check_elastic(n4, bim, ["G4"])[0]["ms"])
             for bim in (True, False)]
    cases += [("A5", n5, True, dict(dtype=str(dt).removeprefix("torch.")), sw._A5_TILES,
               (n5, True, 1, int(dt == torch.bfloat16), dev), lambda s: sw.a5_tiles(n5, s),
               lambda dt=dt: cs.check_kernels(n5, True, True, ["A5"], dtype=dt)[0]["ms"])
              for dt in (torch.float32, torch.bfloat16)]
    return scan_cases(cases)


def strip_scan_x7x8() -> list:
    """X7, X8 and X9 (on X7's partials; ``x7x8_records``) at each strip of
    X7X8_SCAN and at the strip ``bwd_strip`` picks, with the partial rows of
    each strip and X7's and X8's blocks per SM at 16 channels."""
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from multigrid_feanet_torch.ops import passes as px

    dev = torch.device("cuda", torch.cuda.current_device())
    out, hiers = [], {}
    for (n, N), strips in X7X8_SCAN.items():
        chosen = px.bwd_launch_tiles(n, N, dev)
        by_strip = {}
        for strip in (chosen.strip,) + strips:
            px._BWD_TILES[(n, N, dev.index)] = px.BwdTiles(strip, px.bwd_blocks(n, N, strip))
            by_strip[strip] = dict(rows=px.bwd_blocks(n, N, strip), **{
                r["name"]: r["ms"] for r in x7x8_records(cs, n, N, hiers)
                if r["name"] != "X9_X8"})
        px._BWD_TILES[(n, N, dev.index)] = chosen
        out.append(dict(n=n, batch=N, chosen=chosen.strip, ms=by_strip,
                        blocks_per_sm={key: px.bwd_occupancy(key, 16) for key in ("X7", "X8")}))
        print(json.dumps(out[-1]), flush=True)
    return out


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
STORED = re.compile(r"\d+(sweep_kernel|swrr_kernel|zpsweep_kernel|a5_resid_restrict_rows|"
                    r"a5_resid_restrict|"
                    r"a6_cross_cycle|a6_cross_cycle_rows)I((?:L[bi]\d+E)+)"
                    r"(f|13__nv_bfloat16)?E")


# the counts and cell results a turn's line keeps beside each record's ms
CELL_KEYS = ("launches", "cycles", "tail_q", "q_last6", "tail_q12", "q_asym60", "contraction",
             "digest", "rows")


# kernels this checkout keeps under a new name (new name: parent's name)
RENAMED = {}


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
               for line in fn.split("\n") if re.search(r"/\*[0-9a-f]{4,}\*/", line)]
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
    removed = sorted(" ".join(k) for k in theirs if k not in mine
                     and any(k[0] == src and name in k[1] for src, name in REMOVED))
    same = {k: mine.get(k) == ins for k, ins in theirs.items()
            if not hit[k] and " ".join(k) not in removed}
    kept = {" ".join(k): renamed.get(k, mine.get(k)) == ins for k, ins in theirs.items()
            if hit[k]}
    new = sorted(" ".join(k) for k in mine if k not in theirs
                 and not any(r in k[1] for r in RENAMED))
    legs = {k: v for k, v in same.items() if k[0] == "sweep" and "<" in k[1]}
    a34 = {}
    for (src, name, storage), ins in mine.items():
        if (src == "sweep" and (name.startswith("zpsweep_kernel")
                                or re.match(r"swrr_kernel<Lb\dELi\dELb1E>", name))) \
                or any(k in name for k in ROW_KERNELS):
            bars = [i for i, x in enumerate(ins) if x.startswith("BAR.SYNC")]
            steps = [b - a for a, b in zip(bars, bars[1:])]
            # the unrolled row loop's steps are its longest gaps between barriers
            a34[f"{name} {storage}"] = dict(instructions=len(ins),
                                            per_step=statistics.median(steps),
                                            loop_step=statistics.median(sorted(steps)[-6:]))
    bwd = bwd_loops(mine)
    log = _library(ROOT).with_suffix(".log").read_text()
    ptxas = {}
    for m in re.finditer(r"Compiling entry function '(\w+)'[^\n]*\n[^\n]*\n\s*(\d+) bytes stack "
                         r"frame, (\d+) bytes spill stores, (\d+) bytes spill loads\n"
                         r"[^\n]*Used (\d+) registers[^\n]*?(?:(\d+) bytes smem)?\n", log):
        if any(k in m.group(1) for k in ROW_KERNELS + BWD_KERNELS):
            ptxas[_plain_name(m.group(1))[1]] = dict(
                registers=int(m.group(5)), spill_stores=int(m.group(3)),
                spill_loads=int(m.group(4)), smem=int(m.group(6) or 0))
    return dict(same=sum(same.values()), total=len(same), new_ptxas=ptxas,
                sweep_legs_same=sum(legs.values()), sweep_legs_total=len(legs),
                differ=[" ".join(k) for k, v in same.items() if not v],
                changed_kept_same=sum(kept.values()), changed_kept_total=len(kept),
                changed_differ=[k for k, v in kept.items() if not v], new=new,
                removed=removed,
                bf16_instances=sum(1 for k in mine if k[2] == "bf16"), per_step=a34,
                x1_issue=x1_issue(a34), bwd_loops=bwd)


_BRANCH = re.compile(r"\bBRA(?:\.\w+)*\s+(0x[0-9a-f]+)")


def bwd_loops(fns: dict) -> dict:
    """X7's and X8's row loop in machine code (``_functions``): the
    instructions from the target of its backward branch (the longest) to
    the branch, those of the flush that the first forward branch after the
    loop's first VOTE.ANY (``__any_sync``) skips when no lane's id changed,
    and the rest (a step's, without a flush); None where the code is not so
    laid out."""
    out = {}
    for (_, name, _), ins in fns.items():
        if not any(k in name for k in BWD_KERNELS):
            continue
        back = [(int(m.group(1), 16) // 16, i) for i, x in enumerate(ins)
                for m in [_BRANCH.search(x)] if m and int(m.group(1), 16) // 16 < i]
        if not back:
            out[name] = None
            continue
        a, b = max(back, key=lambda s: s[1] - s[0])
        vote = next((i for i in range(a, b) if ins[i].startswith("VOTE.ANY")), None)
        skip = next(((int(m.group(1), 16) // 16 - i - 1) for i in range(vote or b, b)
                     for m in [_BRANCH.search(ins[i])] if m and int(m.group(1), 16) // 16 > i),
                    None)
        loop = b - a + 1
        out[name] = dict(loop=loop, flush=skip, step=None if skip is None else loop - skip)
    return out


# the H100 SXM's boost clock: an SM issues at most 4 warp instructions a clock
SM_CLOCK_HZ = 1.98e9
# the row-streaming X1 instances of heat_march_4097 (f32, bi-material, one f)
# and of its homogeneous twin, by their mangled template arguments
X1_PATHS = {"bim_one_f_f32": "x1_heat_rhs_rowsIffLb1ELb1E",
            "hom_one_f_f32": "x1_heat_rhs_rowsIffLb0ELb1E"}


def x1_issue(per_step: dict) -> dict:
    """The issue bound of the row-streaming X1 at 4097^2 (f32, one f,
    bi-material and homogeneous): its warp-steps on the geometry the wrapper
    launches (x1_launch_tiles, every warp of every block at every step of
    its strip) times its machine instructions a step (``loop_step``) over
    4 warp instructions a clock on each SM at SM_CLOCK_HZ."""
    import torch

    sys.path.insert(0, str(ROOT))
    from multigrid_feanet_torch.ops import passes as px

    dev, n = torch.device("cuda", 0), 4096
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {}
    for label, tag in X1_PATHS.items():
        steps = next(v["loop_step"] for k, v in per_step.items() if tag in k)
        t = px.x1_launch_tiles(n, 0, False, label.startswith("bim"), True, dev)
        H = n + 1
        warp_steps = t.gx * (px.sw.A12_THREADS // 32) * sum(
            min(t.strip, H - y0) + px.X1_HALO_STEPS for y0 in range(0, H, t.strip))
        out[label] = dict(strip=t.strip, blocks=t.blocks, warp_steps=warp_steps,
                          instructions_per_step=steps,
                          issue_ms=1e3 * warp_steps * steps / (sms * 4 * SM_CLOCK_HZ))
    return out


def _key(rec) -> str:
    if rec["name"] == "X1":
        dt = "f64" if rec.get("f64") else "bf16" if rec.get("bf16") else "f32"
        return (f"X1_{rec['n']}_{'bim' if rec['bim'] else 'hom'}_"
                f"{'two_f' if rec['two_f'] else 'one_f'}_{dt}")
    if rec["name"] == "H1":
        return f"H1_{rec['n']}"
    if rec["name"] == "F1":
        return f"F1_{rec['n']}_{rec['q_dtype']}"
    if "n" not in rec:
        return rec["name"]
    form = "mass" if rec.get("mass") else "dform" if rec.get("dform") else "plain"
    key = f"{rec['name']}_{rec['n']}_{'bim' if rec['bim'] else 'hom'}_{form}"
    if rec["name"] in ("E1", "E2", "E3", "E4", "E5"):
        key += f"_L{rec['L']}" + ("" if rec.get("bc") is None else f"_bc{rec['bc']}")
    if rec.get("dtype"):
        key += f"_{rec['dtype']}"
    if rec.get("coef_dtype"):
        key += f"_{rec['coef_dtype']}"
    if rec.get("batch"):
        key += f"_b{rec['batch']}"
    return key


def a6_against_split(times: dict) -> dict:
    """For each checkout, A6 at 4097^2 (bi-material difference form, f32 and
    bf16) beside A2 + A1's psweep, the split pair it fuses, from the same
    turns: their means and A6's share of the pair's time."""
    out = {}
    for dt in ("", "_bfloat16"):
        legs = [f"{leg}_4096_bim_dform{dt}" for leg in ("A6", "A2", "A1_psweep")]
        if not all(k in times for k in legs):
            continue
        for label in ("parent", "this"):
            a6, a2, a1 = (statistics.mean(times[k][label]) for k in legs)
            out[f"{label}{dt}"] = dict(a6_ms=a6, a2_plus_a1_psweep_ms=a2 + a1,
                                       a6_over_pair=a6 / (a2 + a1))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--legs", choices=("all", "a12", "a34", "e1h1", "f1a6", "c1e2", "e3e5",
                                       "g2d2", "e4c2", "g1g5", "g4a5", "x1", "pbc", "g2d2_cells",
                                       "e4c2_cells", "g1g5_cells", "g4a5_cells", "learned",
                                       "x7x8"),
                    default="all")
    ap.add_argument("--out", type=Path, default=ROOT / "chiprun_out" / "sweep_vs_parent.json")
    ap.add_argument("--strip-scan", action="store_true")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--crossover", action="store_true")
    ap.add_argument("--levels", action="store_true")
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
    if args.strip_scan or args.crossover or args.levels:
        print(smi, flush=True)
        name = ("sweep_strip_scan.json" if args.strip_scan else
                "sweep_levels.json" if args.levels else "sweep_crossover.json")
        out = args.out if args.out.name != "sweep_vs_parent.json" else args.out.with_name(name)
        scan = {"e3e5": strip_scan_e3e5, "g2d2": strip_scan_g2d2, "e4c2": strip_scan_e4c2,
                "g1g5": strip_scan_g1g5, "g4a5": strip_scan_g4a5,
                "x7x8": strip_scan_x7x8}.get(args.legs, strip_scan)
        lines = [dict(card=smi)] + (scan() if args.strip_scan else
                                    levels(args.legs) if args.levels else crossover(args.legs))
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
                              **{k: r[k] for k in CELL_KEYS if k in r})
                for r in recs}
        for r in recs:
            times.setdefault(_key(r), {}).setdefault(label, []).append(r["ms"])
            bounds[_key(r)] = r["bound_ms"]
        lines.append(dict(turn=label, legs=turn))
        print(json.dumps(lines[-1]), flush=True)
    summary = {}

    def ratio(a, b):
        return a / b if a is not None and b else None

    for key, by in times.items():
        (parent, p_spread), (this, t_spread) = (
            (statistics.mean(by[k]), ratio(max(by[k]) - min(by[k]), statistics.mean(by[k])))
            if k in by else (None, None) for k in ("parent", "this"))
        summary[key] = dict(parent_ms=parent, this_ms=this, bound_ms=bounds[key],
                            parent_over_this=ratio(parent, this),
                            this_of_bound=ratio(bounds[key], this),
                            parent_spread=p_spread, this_spread=t_spread)
    lines.append(dict(summary=summary))
    print(json.dumps(lines[-1]), flush=True)
    digests = {key: sorted({line["legs"][key]["digest"] for line in lines[1:5]})
               for key in lines[1]["legs"] if "digest" in lines[1]["legs"][key]}
    if digests:  # the iterates of every turn, bit for bit (one digest) or not
        lines.append(dict(iterates_bitwise={k: len(v) == 1 for k, v in digests.items()},
                          digests=digests))
        print(json.dumps(lines[-1]), flush=True)
    pair = a6_against_split(times)
    if pair:
        lines.append(dict(a6_against_split=pair))
        print(json.dumps(lines[-1]), flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text("\n".join(json.dumps(line) for line in lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
