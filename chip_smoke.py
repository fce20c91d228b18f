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
   2049^2, bi-material and homogeneous), on 4097^2 levels in plain form,
   and on n = 512 levels; A1 and A2 also at n = 2, 16 and 32 and in every
   form at n = 126 (the row-streaming tiles' single block, ragged bands and
   strips, odd row offsets); A3 and A4 in every form (bi-material and
   homogeneous, with and without the mass triple) at n = 2, 16, 32, 126 and
   at every level size of the interface solve (64 ... 4096); all four twice
   on the same 4097^2 inputs, which must give bitwise-equal outputs and
   norms.  Time both with CUDA events around a run of launches (the
   kernel's captured in a CUDA graph), on inputs rotated to exceed the L2
   cache.
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
   the n = 512 level.  Timed as in phase 2.  Then D2 at n = 2, 126, each
   side of ``ops.general.D2_ONE_PASS_MAX_N``, 1000 and 4096 in each design
   the size takes (the one-pass tile up to the threshold, where the
   row-streaming kernel is held too), on the bi-material and the zero phase
   and a general 9-plane operator, f32 and bf16 planes, two launches
   bitwise equal.
6. The BoxMG path of ``solvers/boxmg.py``, ``boxmg_4097``: the same problem
   and u0 as ``interface_4097``, the phase-4 setup, bf16 coefficient
   planes, at most 60 cycles; it must converge, leave a true residual below
   2 eps, repeat its history, launch each of D2-D5 and no separate norm
   pass (``rsq_reduce``: D2 finishes its norm in its last block).  Then a
   129^2 BoxMG
   V(2,1) solve (bc 0.7) on the card against the CPU's plain path, with the
   card's and the CPU's setup compared; it must launch D1.
7. Hold each kernel of ``ops/hrelax.py`` (E2-E5) against its plain version,
   at ``ops.hrelax.TOL``, with the repository's H-Net checkpoints: E2 and E3
   at 4097^2, E4 and E5 at 2049^2 (homogeneous in plain form and
   bi-material in difference form, the L = 1 net), and all four at n = 512
   (bi-material and homogeneous, the L = 3 net).  Timed as in phase 2.
   Then E2, E3 and E5 each at n = 2, 126, each side of each of its
   thresholds (``ops.hrelax.E2_ONE_PASS_MAX_N``, ``E3_ONE_PASS_MAX_N``,
   ``E5_ONE_PASS_MAX_N``), 1000 and 4096 in each design the size takes (the
   one-pass tile up to the threshold, where the row-streaming kernel is
   held too), with the L = 1 and L = 3 nets, homogeneous and bi-material,
   plain and difference form, two launches bitwise equal.
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
   level), and the L = 1 net with a boundary value of 0.7.  The two
   4097^2 H-MG solves must launch no separate norm pass (``rsq_reduce``):
   E2 finishes its norm in its last block.
9. Hold each kernel of ``ops/elastic.py`` (G1 in its sweep and residual
   modes, G2-G5) against its plain version, at ``ops.elastic.TOL``, on the
   plane-stress operator of ``Plane_Stress_modify.m`` (E = 212e3, nu =
   0.288, coefficients (1, 20)): at 2049^2 bi-material (circle) and
   homogeneous, at 1025^2 (level 1) and at n = 128.  Timed as in phase 2.
   Then G2 at n = 2, 126, each side of each
   ``ops.elastic.G2_ONE_PASS_MAX_N`` threshold, 1000 and 2048 in each
   design the size takes, bi-material and homogeneous, two launches
   bitwise equal; G1 (sweep and residual mode), G5 and G4 the same at n =
   2, 126, each side of each ``G1_ONE_PASS_MAX_N`` / ``G5_ONE_PASS_MAX_N``
   / ``G4_ONE_PASS_MAX_N`` threshold, 1000, 2048 and 4096 (G4 also at
   1024, its largest level on the elastic path; u with a nonzero boundary
   ring).
10. The elastic path of ``solvers/elastic.py`` at 2049^2 (circle r = 0.5,
   9 levels, kernel threshold 16, direct coarse solve at n = 8, f = 0,
   u0 standard normal from rng 1, eps 0): ``elastic_2049``, V(2,2) for 4,
   12 and 60 cycles (ms/cycle = (t12 - t4) / 8, tail q of the last 4
   ratios, asymptotic q of the last 8); ``elastic_pcg_2049``, the
   MG-preconditioned flexible CG for 16 iterations (contraction, drop,
   history against the true residual); ``elastic_v11_2049``, V(1,1) for 12
   cycles.  Each must launch its kernels the expected number of times,
   stay finite and repeat its history over 3 runs, and launch no norm pass
   (``rsq_reduce``: G1 and G2 finish their norms in their last block).
   Then ``elastic_2049`` once more with the bench's kernel threshold of
   512.  Each cell's history (and so its cycles) and q must lie near the
   parent commit's (``PARENT_ELASTIC``: the 12-cycle V-cycles within 1e-6
   relative, the 60-cycle q and the PCG within bounds about ten times what
   was measured), its device ms per cycle printed beside the parent's.
11. Three 129^2 bi-material elastic solves on the card against the CPU's
   plain path on the f = 0 decay protocol: V(2,2) and V(1,1) for 20
   cycles and the PCG for 10 iterations, every cycle's residual within 1%
   of the CPU's.  Then hold C1, C2
   (k = 2, 4, 8; also against k chained C1 launches), A5 and A6 against
   their plain versions at 4097^2 and 512^2; C1 at n = 2, 126, each side of
   ``ops.stencil_sweep.C1_ONE_PASS_MAX_N``, 1000 and 4096 in each design the
   size takes, homogeneous and bi-material, sweep and residual mode, two
   launches bitwise equal; and A6 at n = 2, 16, 126, each side of
   ``ops.sweep.A6_ONE_PASS_MAX_N``, 1000 and 4096 in each design the size
   takes (the one-pass tile up to the threshold, where the row-streaming
   kernel is held too), bi-material and homogeneous, in plain, difference
   and mass form, f32 and bf16 storage, two launches bitwise equal; A5 the
   same at n = 2, 16, 126, each side of each ``ops.sweep.A5_ONE_PASS_MAX_N``
   threshold, 1000, 1024, 2048 and 4096; then
   the round-1 cells (whose only norm passes, ``rsq_reduce``, are C2's:
   C1 finishes its norm in its last block; X2 and X3 launch 8 times a cycle
   each, the transfers from and to the 8 kernel levels) and
   ``pswrr_interface_4097`` (A6
   at level 0, held to
   the split path's cycles +- 1 and tail q within 1%, both paths' device
   time per cycle printed).
12. Hold H1 (4096^2, n = 32 and 96, both norms) and A1-A6 in mass form
   (the heat level's operands: theta dt (1, 20), mass h^2 (1/18, 1/18,
   -1/36); 4097^2 bi-material and homogeneous, A3/A4 also at 2049^2)
   against their plain versions; H1 also at n = 2, 3, 32, 96, 130 and 4096
   in each design the size takes (the one-pass tile up to
   ``ops.torus.H1_ONE_PASS_MAX_N``, where the row-streaming kernel is held
   too), two launches bitwise equal.  Then the periodic cells on H1:
   ``pbc_jacobi_32`` (the reference's analytic problem, exactly 46 sweeps
   with its history head), ``torus_jacobi_4096`` (512 sweeps, eps None)
   and ``pbc_mg_4096`` (``solve_pbc_mg``, 12 levels, H1 on n >= 32, within
   one cycle of the JAX solver); the heat cell ``heat_march_4097``
   (``HeatSolver(backend="fused").march``, 10 steps of 2 V(1,1) cycles,
   exact A1-A4 counts and one X1 a step; the march replays one CUDA graph a
   step and must equal the eager march bit for bit, also with
   time-dependent knots, and the march with X1's one-pass tile forced; both
   timed; and one ``step``); and four 129^2
   checks against the CPU (the fused heat step and march, a float64 heat
   step on the plain backend, ``solve_pbc_mg`` at 128^2).
13. Hold B1 and B2 (4097^2, bitwise; torch.add timed beside them), F1
   (4097^2 circle (1, 20) in bf16 and f32 Q, n = 512; also against A1's
   plain-form sweep; and at n = 2, 126, each side of
   ``ops.qsweep.F1_ONE_PASS_MAX_N``, 1000 and 4096 in each design the size
   takes, bf16 and f32 Q, two launches bitwise equal) and E1 (4097^2
   homogeneous with the L = 3 and L = 1
   nets and the ring reset of h_relax; bi-material with the L = 1 net in
   both forms; n = 2, 32 and 512 with a boundary field) against their plain
   versions; E1 also at n = 2, 32, 130, 2048 and 4096 in each design the
   size takes (the one-pass tile up to ``ops.hrelax.E1_ONE_PASS_MAX_N[L]``,
   where the row-streaming kernel is held too), with L = 1 and 3,
   homogeneous, bi-material and difference form, the ring kept, reset to a
   number and to a field, two launches bitwise equal.  Then ``membench_4097`` (copy and triad GB/s, the sweep's
   share of the triad rate), ``qsweep_4097`` (512 F1 sweeps, equal to 512
   A1 sweeps), ``hjac_4097`` (256 h_relax sweeps on E1), ``hjac_iter_32``
   (Jacobi against H-Jacobi on the learned-iterator sample, >= 5x, card and
   CPU counts within 2%), ``measure_q_1024`` / ``_4096`` (H-MG q on E1
   against the JAX values), ``decay_train`` (20 error-decay steps, no kernel
   launches, the loss falls by >= 0.2) and ``hnet_train_129`` (8 epochs on
   the oracle's 129^2 dataset, the loss falls 10%, resume equals the
   straight run).
14. bf16 level storage: hold A1 (sweep, residual, psweep), A2, A5 and A6
   in bf16 against their plain versions at 4097^2 (bi-material difference
   form, homogeneous difference form, bi-material mass form; one bf16 ulp
   per element beyond ``ops.sweep.TOL``, ``ops.sweep.bf16_excess``), A3
   and A4 at 2049^2 (bi-material, homogeneous, mass), at every other level
   size of the interface solve and at n = 2, 16, 32 and 126, A1/A2 at n =
   2, 16 and 126; all six twice on the same inputs (bitwise).  Time
   bench.py's bf16 row (the homogeneous plain-form sweep, its share of
   the triad rate).  Then the cells ``interface_4097_bf16``,
   ``poisson_4097_bf16`` (23 +- 1 cycles), ``pswrr_interface_4097_bf16``
   and ``ir_4097_bf16`` (f64 residual <= 1e-6 within 20 outer steps), each
   printed beside its f32 cell, and two 129^2 bi-material bf16 decay
   solves (split and use_pswrr) on the card against the CPU (cycles +- 1,
   histories within 2%).
15. Slice 11, the learned inter-grid operators and the elastic H-Net.
   First X5 and X6 (``ops/passes.py``) held against their plain
   versions by ``hold`` at 4097^2, 129^2, 65^2 and 33^2, bi-material with
   16 and 12 channels and homogeneous with one, batch 1 and 2, at
   ``ops.sweep.TOL``, two launches bitwise, each timed beside its bound
   and its plain version and, at 4097^2, beside the torch path's split and
   convolution (``learned_pass_checks``).  Slice 28: C1 over a batch (one
   launch, ``StencilLevel.sweep_batch`` / ``residual_batch``) bit for bit
   the per-sample launches at 4097^2 (batch 1 and 2), 257^2, 65^2 and 33^2
   (batch 64), timed beside them (``c1_batch_checks``); X7 and X8 (the
   backward of X5 and X6) with X9 (their weight gradients) against their
   plain versions at 4097^2, 257^2, 65^2, 17^2 and 5^2 (batch 64) and 33^2
   in every variant: grad r and grad v bit for bit, the weight gradients within
   ``ops.passes.TOL_WEIGHT_GRAD`` of the same gradients of the inputs'
   magnitudes, two launches bitwise, each timed alone beside its bound,
   its plain version and the torch path's backward
   (``learned_backward_checks``); one graded cycle with its backward at
   65^2 (batch 64) and 257^2 (batch 4), exactly ``graded_launches``, its
   forward bit for bit the no-gradient route's, its loss and gradients
   within ``GRADED_TOL`` of the torch path's (``graded_cycles``).  Then
   ``intergrid_train_64``
   (the reference's q_m training protocol at 65^2, 10 epochs, card against
   CPU within 1e-4, resume, the train_kernel = 3 curriculum, 10 multi-size
   decay steps; every step on the route, ``train_step_launches`` exactly)
   and ``learned_vcycle_4097`` (12 learned V-cycles at 4097^2
   with the init and the multi-size trained operators on the kernel route,
   and with the init operators on the torch path beside them: ms, device
   ms a cycle, peak GB, float32 and float64 histories; every C1, X5 and X6
   call of two route cycles against its plain version; the two paths
   within 1e-4 a cycle on the f = 0 decay protocol and, on the evaluator's
   protocol, within 1e-4 of max|u| after the first cycle, the route's
   float64 residual after the last at most 1.5 times the torch path's; 6
   two-grid cycles at 129^2 on a batch of 2 with the n = 64 checkpoint
   against the CPU's route), each run with every count zeroed
   and required to equal the
   kernel route's C1, X5 and X6 launches exactly (``route_launches``: C1 3
   a batch on each kernel level, X5 and X6 one a level and cycle each;
   none on the torch path); then
   ``hnet_elastic_train_16`` (the elastic H-Net's
   training anchor) and ``h_elastic_2049`` (32 H-corrected block-Jacobi
   sweeps at 2049^2 beside 32 plain ones; 4 sweeps at 129^2 against the
   CPU), which launch no kernel (every count zeroed before each phase and
   required zero after it); and one profiled periodic training step, which
   like every slice-11 profile must run no TF32 kernel.
16. The research solvers in torch ops, which launch no kernel of the
   port (every count zeroed before each run, required zero after):
   ``elastic_boxmg_1025`` (``solvers/elastic_boxmg.py``: the 1025^2
   bi-material plane-stress problem in f64, 10 levels, block-BoxMG setup
   and direct coarse solve, f = 0 and a standard normal start; 30 W(2,2)
   cycles with tail q < 0.5, then the homogeneous problem's 20 V(2,2) with
   q < 0.33), ``adaptive_boxmg_513`` (``ops/adaptive_transfer.py``'s BoxMG
   on the 513^2 interface problem in f32, 20 V(1,1) cycles beside 20 of the
   linear ``solvers/multigrid.py`` cycle: q_adaptive <= 0.37 and below
   q_linear - 0.12) and ``boxmg_research_32`` (both solvers at n = 32 in
   f64 on the card and the CPU, 8 cycles each, every residual within 1e-9
   relative).  Each prints its setup seconds and peak GB, ms per cycle, the
   device operations of one cycle from torch.profiler, and its tail q; every
   tensor of each solver's state must lie on the card.
17. The slab forms of A1-A4 and the sharded solvers (``parallel/``):
   every fused level of ``interface_4097`` (4096 ... 32), bi-material and
   homogeneous in difference form, cut into 4 row slabs with 4 ghost rows
   copied from the whole field; A1 (sweep, psweep), A2, A3 and A4 in slab
   form on each slab, held bitwise against the whole-field kernel on the
   slab's own rows (the 4 partial norms' sum within 1e-6) and against the
   slab form's plain version at ``ops.sweep.TOL``; at 4097^2 the 4 slab
   launches timed beside the one whole-field launch (``slab_legs``).
   Then, in a world of 1 on NCCL, ``nccl_capture_check``: a captured spin,
   ``all_reduce`` and ``all_gather`` replayed (the value, the host time of
   a replay against its device time, no captured work in the watchdog's
   flight-recorder entries).  Then ``sharded_interface_4097``:
   ``ShardedHierarchyV2`` in a world of 1 on NCCL runs ``interface_4097`` and must take the split ``HierarchyV2``
   path's cycles and tail q with its iterate bitwise; the slab forms are
   timed at its shapes.  Then ``distributed_1025``: a world-1
   ``DistributedHierarchy`` solve of the 1025^2 interface problem (f = 0
   decay to 1e-2, 3 sharded levels) against ``solvers/multigrid.py::solve``
   (the same cycles, u within 1e-3 / 1e-5), and the data-parallel H-Net
   step against ``train_step`` (parameters within 1e-6).  Each of the two
   distributed solves first runs on a fresh solver both ways
   (``distributed_graph_cell``, the checks of phase 19): the one-dispatch
   solve, one CUDA graph per chunk (per cycle for ``DistributedHierarchy``)
   with its NCCL collectives inside, against ``graph=False`` bit for bit in
   cycles, history (``distributed_1025``: cycles and res) and iterate, one
   capture, both paths' walls, device time and busy share, the launches
   per replay, and each kernel's torch.profiler launches at most its
   counted ones (the profiler drops records).
18. The slab forms of E2 and E3 and the sharded H-MG: every sharded level
   of ``sharded_hmg_4097`` (4096 ... 64), bi-material and homogeneous, the
   plain form with the L = 1 net, on 4 quarter slabs and on the world-1
   slab; E2 (the one-pass tile up to ``E2_ONE_PASS_MAX_N``, as the whole
   field) and E3 in slab form on each, held bitwise against the whole-field
   kernel on the own rows and the coarse rows under them (the partial
   norms' sum within 1e-7 of the whole field's), and against the slab
   form's plain version at ``ops.hrelax.TOL``; the world-1 slab's launches
   timed beside the whole field's with each grid (``hslab_legs``).  Then,
   in a world of 1 on NCCL, ``sharded_hmg_4097``: ``ShardedHMG`` runs
   ``hmg_4097``'s configuration (homogeneous, 9 levels, threshold 32, direct
   coarse, eps 1e-6, at most 40 cycles, chunk 2, the decay start) and must
   take ``HMGHierarchy(coarse_zero_legs=False)``'s cycles, history and
   iterate bit for bit, launching E2 and E3 in slab form (at most once per
   sharded level and cycle each); both solves' ms per cycle and tail q are
   printed.  Then the bi-material interface at 4097^2 in the plain form, 4
   cycles at eps 0: the iterate bitwise the whole field's.  Both solvers
   first run ``distributed_graph_cell`` as in phase 17 (the re-solve with
   another net).
19. The one-dispatch solves (``solvers/common.py::ChunkGraphs``): every
   solve above runs its fused entry point on the card, which replays one
   CUDA graph per chunk of cycles; here each of ``interface_4097`` (f32
   and bf16), ``poisson_4097``, ``pswrr_interface_4097``,
   ``pcg_interface_4097``, ``hmg_4097``, ``hmg_interface_4097``,
   ``boxmg_4097``, ``poisson_4097_r1``, ``ir_4097``, ``elastic_2049`` and
   ``elastic_pcg_2049`` runs both ways on a fresh solver (``graph_cell``):
   the capturing solve and a warm one must equal the eager loop
   (``graph=False``) bit for bit in history, cycle count and iterate, with
   the eager loop's launch counts (a replay adds what its capture
   launched); the warm solve's own wrapper calls must be only those outside
   the captured chunks (none; A6's peeled descent and closing ascent; the
   CG start; ``ir_4097``'s X4 outer steps); the solver must hold one
   capture per key; a re-solve from
   another u0 (H-MG: with another net) must equal its eager twin and leave
   the first returned u unchanged; ``interface_4097`` replays bit for bit
   with TF32 switched on after its capture.  Both paths' walls per cycle
   (best of three), torch.profiler's device time per cycle and busy share
   are printed (``graph_cells``).
20. Slice 24, the JAX package's XLA-fused passes as kernels X1-X4
   (``ops/passes.py``): each held against its plain version by ``hold`` at
   4097^2, 33^2, 65^2 and 257^2 in every variant (X1 bi-material and
   homogeneous, f32 and bf16 u, one f or two knots, and f64; X4 homogeneous
   and two-phase, an f32 and a bf16 correction), X1, X2 and X3 bit for bit
   (a bf16 X1 within one bf16 ulp) and X4 at ``ops.passes.TOL64`` of
   max(1, max|plain|), two launches bitwise; X1 in both designs at every
   size (the one its wrapper launches, by ``ops.passes.X1_ONE_PASS_MAX_N``,
   and the other forced), held and timed the same way and equal to each
   other bit for bit; each timed
   beside its bound and its plain version and, at 4097^2, X2 and X3 beside
   ``F.conv2d`` with stride 2 and ``F.conv_transpose2d`` in full f32 and
   homogeneous f32 X1 beside ``F.conv2d`` of its fields stacked as
   channels (``x1_library``) (``pass_kernel_checks``).  Then
   ``ir_interface_4097``: ``solve_ir`` on ``interface_4097``'s bi-material
   hierarchy with f = apply_mass(1, h), 6 cycles a correction, at most 20
   outer steps, to an f64 true residual <= 1e-6 (X4 in its two-phase form,
   one launch an outer step).  ``ir_4097`` and ``ir_4097_bf16`` count X4 =
   outer steps too.
21. Print A1's and A2's 4097^2 times in every form held, each beside its
   byte bound (``a12_4097``), A3's and A4's at each level size of the
   interface solve (``a34_levels``), the bf16 times beside their bf16 byte
   bounds and this run's f32 times (``bf16_times``), the kernel summary
   line (one row per kernel and path, with the path's launch counts; the
   bf16 rows suffixed ``_bf16``; each row's byte bound also at the
   measured copy and triad rates; the rows of G4, A5 and X1 also name both
   designs' device kernels, ``symbols``, and the one the timed launch ran,
   ``design``; X1-X4 with their cells' launches, X1 with its tile's time
   and its homogeneous time beside ``F.conv2d``'s; X5, X6 and C1 with
   ``learned_vcycle_4097``'s launches, C1 with its batch times; X7, X8 and
   X9 at 65^2, batch 64, with ``intergrid_train_64``'s launches; 36
   kernels), then the device line as the last line.

Each 4097^2 solve and each elastic cell also reports its device time per
kernel from torch.profiler and the busy share of its wall time.
"""

from __future__ import annotations

import json
import re
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
HRELAX_FLOPS = {"E1": (1, 8, 1), "E2": (2, 12, 1), "E3": (1, 10, 1), "E4": (1, 10, 1),
                "E5": (1, 16, 2)}
# G1-G5, counted from csrc/elastic.cu per fine node: an operator apply of
# both components is 98 operations, the block-Jacobi update 14, the residual
# and its square 6, the zero-guess iterate 20, the prolongation of both
# components 6 and their restriction 7 (26 per coarse node).
FLOPS_PER_NODE.update({"G1": 118, "G2": 225, "G3": 124, "G4": 127, "G5": 144})
# H1, counted from csrc/torus.cu per node: the homogeneous apply 11, the
# residual 1, the update 3, the square and the wrapped-norm weights 5.
FLOPS_PER_NODE["H1"] = 20
# F1, counted from csrc/qsweep.cu per node: the bi-material plain-form apply
# 33, the residual, the diagonal and the update 7; B1 and B2 one and two
# per element.
FLOPS_PER_NODE.update({"F1": 40, "B1": 1, "B2": 2})
HNET_L1 = "results/learn_iterator/hnet_decay_L1_hlNone.npz"
HNET_L3 = "results/learn_iterator/hnet_decay.npz"
HNET_L3_HL1 = "results/learn_iterator/hnet_decay_L3_hl1.npz"
HNET_ITER = "results/learn_iterator/hnet.npz"  # the learned iterator, L = 3
# measure_q at n = 1024 with the L = 1 net (results/learn_iterator/
# decay_L1_hlNone_summary.json, the JAX run): algorithmic, so the port must
# land within 10% (H-Jacobi) and 5% (plain V(1,1)) of them
Q_JAX_1024 = {"hjac": 0.05573512241244316, "jac": 0.23737014830112457}
DEVICE = "cuda"
N_MAIN, N_COARSE, N_SMALL = 4096, 512, 128
N_ODD = 126  # A1/A2 checks: 127 rows, odd against both tile widths and strips
# the level sizes the 4097^2 interface solve launches A3 and A4 at
A34_LEVELS = (2048, 1024, 512, 256, 128, 64, 32)
CIRCLE = ("circle", (0.0, 0.0), 0.5)
N_EL = 2048  # the elastic cells: 2049^2 nodes (bench.py:296)
E_EL, NU_EL = 212e3, 0.288  # Plane_Stress_modify.m:11-12
HEAT_DT, HEAT_THETA = 1e-3, 0.5  # the heat cell (bench.py:274-289)
# pbc_mg_4096: the JAX solve_pbc_mg on the same problem (f32, on a CPU, 30
# cycles at eps 0) falls from 2.44e-3 to 4.3e-4, 8.1e-5, 1.7e-5, 6.4e-6 and
# stalls at its f32 floor, 4.96e-6: 1e-5 is the lowest decade it reaches,
# after 4 cycles.  The card must take 4 +- 1.
PBC_EPS, PBC_JAX_CYCLES = 1e-5, 4


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


def level_inputs(n: int, bim: bool, seed: int, dtype=None, ring: float = 0.0):
    """Fields of one level on the card: u at the main path's scale (its
    boundary ring ``ring``), f and the coarse correction standard normal,
    the circle's phase map; the node fields rounded to ``dtype`` when
    given."""
    import torch
    from multigrid_feanet_torch.core.geometry import circle_phase

    rng = np.random.default_rng(seed)
    H, Hc = n + 1, n // 2 + 1
    geo = np.zeros((H, H), np.float32)
    geo[1:-1, 1:-1] = 1.0
    u = (150000.0 * rng.uniform(size=(H, H))).astype(np.float32) * geo
    if ring:
        u += np.float32(ring) * (1 - geo)
    f = rng.standard_normal((H, H)).astype(np.float32)
    uc = rng.standard_normal((Hc, Hc)).astype(np.float32)
    ph = circle_phase(2.0, n) if bim else None
    out = [None if x is None else torch.as_tensor(x, device=DEVICE) for x in (u, f, uc, ph)]
    if dtype is not None:
        out[:3] = [x.to(dtype) for x in out[:3]]
    return tuple(out)


def bytes_moved(name: str, n: int, bim: bool, es: int = 4) -> int:
    """Bytes a kernel must move: each input read once, each output written
    once (node fields and coarse fields of ``es`` bytes: 4 in f32, 2 in
    bf16; the int8 phase)."""
    H2, Hc2, ph = (n + 1) ** 2, (n // 2 + 1) ** 2, n * n if bim else 0
    return {
        "A1_sweep": es * H2 * 3 + ph,
        "A1_residual": es * H2 * 3 + ph,
        "A1_psweep": es * H2 * 3 + ph + es * Hc2,
        "A2": es * H2 * 3 + ph + es * Hc2,
        "A3": es * H2 + ph + es * Hc2,
        "A4": es * H2 * 2 + ph + es * Hc2,
        "A5": es * H2 * 2 + ph + es * Hc2,
        "A6": es * H2 * 3 + ph + es * Hc2 * 2,
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
    planes, 4 weight planes of ``coef_bytes`` each, f32 coarse fields).
    D2's restriction reads only the weights P^T uses: w00 at every fine
    node, w01 at odd columns, w10 at odd rows, w11 at both (2.25 planes)."""
    H, H2, Hc2, odd = n + 1, (n + 1) ** 2, (n // 2 + 1) ** 2, n // 2
    op = n * n if bim else 9 * coef_bytes * H2
    w4 = 4 * coef_bytes * H2
    w4_restrict = coef_bytes * (H2 + 2 * H * odd + odd * odd)
    return {
        "D1_sweep": 4 * H2 * 3 + op,
        "D1_residual": 4 * H2 * 3 + op,
        "D2": 4 * H2 * 3 + op + w4_restrict + 4 * Hc2,
        "D3": 4 * H2 * 3 + op + w4 + 4 * Hc2,
        "D4": 4 * H2 + op + w4 + 4 * Hc2,
        "D5": 4 * H2 * 2 + op + w4 + 4 * Hc2,
    }[leg]


def hrelax_bytes(leg: str, n: int, bim: bool, L: int) -> int:
    """Bytes a kernel of ``ops/hrelax.py`` must move: each input read once,
    each output written once (f32 fields, int8 phase, f32 coarse fields,
    the (L, 3, 3) f32 kernels)."""
    H2, Hc2, ph = (n + 1) ** 2, (n // 2 + 1) ** 2, n * n if bim else 0
    fields = {"E1": 3, "E2": 3, "E3": 3, "E4": 1, "E5": 2}[leg]
    return 4 * H2 * fields + ph + (0 if leg == "E1" else 4 * Hc2) + 36 * L


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
             "H1": ("out", "rsq", "rsq_wrap"), "E1": ("out", "rsq"), "F1": ("out",),
             "B1": ("out",), "B2": ("out",),
             "X1": ("out",), "X2": ("out",), "X3": ("out",), "X4": ("out",),
             "X5": ("out",), "X6": ("out",),
             **{f"C2_k{k}": ("out", "rsq") for k in range(1, 9)}}
# the legs that keep partial sums in a workspace
RSQ_LEGS = ("A1", "A2", "A5", "A6", "C1", "C2", "D1", "D2", "E1", "E2", "G1", "G2", "H1",
            "X4")


def hold(leg: str, call, cuda_fn, plain_fn, inputs, cfg, nbytes: int, tol, tags: dict,
         twice: bool = False):
    """Run one leg's kernel and plain version on the same inputs; return a
    record (errors, times) and fail beyond ``tol``.  A bf16 output is held
    to one bf16 ulp per element beyond ``tol`` of max(1, max|plain|)
    (``ops.sweep.bf16_excess``): both round an f32 value that agrees to
    ``tol``.  A float64 output is compared in float64.  ``tol`` may give one
    tolerance per output (0: equal values); ``twice`` also fails unless a
    second launch on the same inputs gives the same bits.

    ``ms`` is the kernel's device time on cold inputs: the inputs are cloned
    into enough sets to fill twice the 50 MB L2 cache and the timed launches
    rotate over them, as the solve finds a level's fields after the other
    levels' traffic.  ``warm_ms`` repeats one input set."""
    import torch

    def outputs(fn, kw):
        out = call(fn, inputs, kw)
        return out if isinstance(out, tuple) else (out,)

    kcfg = dict(cfg, workspace={}) if leg[:2] in RSQ_LEGS else cfg
    got = outputs(cuda_fn, kcfg)
    if twice:
        got = tuple(t.clone() for t in got)
        again = outputs(cuda_fn, kcfg)
    want = outputs(plain_fn, cfg)
    torch.cuda.synchronize()
    rel, abs_err, rsq_rel, excess, errs = 0.0, 0.0, 0.0, None, []
    for g, w in zip(got, want):
        if g.dim() == 0:
            rsq_rel = max(rsq_rel, abs(float(g) - float(w)) / max(abs(float(w)), 1e-30))
            errs.append(abs(float(g) - float(w)) / max(abs(float(w)), 1e-30))
            continue
        if not torch.isfinite(g).all():
            fail(f"{leg} {tags}: non-finite output")
        if g.dtype != w.dtype:
            fail(f"{leg} {tags}: the kernel returns {g.dtype}, its plain version {w.dtype}")
        ct = torch.promote_types(w.dtype, torch.float32)
        err = float((g.to(ct) - w.to(ct)).abs().max())
        abs_err = max(abs_err, err)
        rel = max(rel, err / max(1.0, float(w.to(ct).abs().max())))
        errs.append(err / max(1.0, float(w.to(ct).abs().max())))
        if g.dtype == torch.bfloat16:
            from multigrid_feanet_torch.ops.sweep import bf16_excess

            excess = max(-1.0 if excess is None else excess, bf16_excess(g, w))
            errs[-1] = bf16_excess(g, w)

    sets = min(32, -(-2 * L2_BYTES // nbytes))
    xs = [inputs] + [tuple(None if t is None else t.clone() for t in inputs)
                     for _ in range(sets - 1)]
    outs = [dict(kcfg, **dict(zip(OUT_NAMES[leg], [t.clone() for t in got]))) for _ in xs]
    kruns = [lambda x=x, o=o: call(cuda_fn, x, o) for x, o in zip(xs, outs)]
    pruns = [lambda x=x: call(plain_fn, x, cfg) for x in xs]
    rec = dict(name=leg, **tags, max_rel_err=rel, max_abs_err=abs_err, rsq_rel_err=rsq_rel,
               ms=kernel_ms(kruns), warm_ms=kernel_ms(kruns[:1]), plain_ms=plain_ms(pruns),
               input_sets=sets, bytes=nbytes)
    if excess is not None:
        rec["bf16_excess"] = excess
    if twice:
        rec["bitwise_twice"] = all(torch.equal(a, b) for a, b in zip(got, again))
        del again
    del xs, outs, kruns, pruns
    if isinstance(tol, tuple):
        bad = any(e > t for e, t in zip(errs, tol))
    else:
        bad = (rel > tol if excess is None else excess > tol) or rsq_rel > tol
    if bad or not rec.get("bitwise_twice", True):
        fail(f"kernel disagrees with its plain version or with itself: {rec}")
    return rec


def level_mass(n: int) -> tuple:
    """The heat system's mass triple on a level of n elements, as
    ``ops/heat.py::heat_mass`` gives it to the fused legs."""
    from multigrid_feanet_torch.core.problem import Problem, build_level
    from multigrid_feanet_torch.ops.heat import heat_mass

    return heat_mass(build_level(Problem(n=n), n, device="cpu"))


def check_kernels(n: int, bim: bool, dform: bool, legs, seed: int = 1, coef=(1.0, 20.0),
                  mass=None, dtype=None):
    """Hold each leg of ``ops/sweep.py`` against its plain version on one
    level's seeded inputs, with the operator ``coef`` (+ ``mass``), the node
    fields in ``dtype`` (bf16: a nonzero boundary ring, which the legs pass
    through, and the record tagged ``dtype="bfloat16"``); one record per
    leg."""
    import torch
    from multigrid_feanet_torch.ops import sweep as sw

    bf16 = dtype == torch.bfloat16
    inputs = level_inputs(n, bim, seed, dtype, ring=0.7 if bf16 else 0.0)
    cfg = dict(a0=coef[0], da=coef[1] - coef[0] if bim else 0.0, omega=2.0 / 3.0, mass=mass)
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
    a5cfg = dict(a0=cfg["a0"], da=cfg["da"], mass=mass)
    return [hold(leg, calls[leg], *fns[leg], inputs, a5cfg if leg == "A5" else cfg,
                 bytes_moved(leg, n, bim, 2 if bf16 else 4), sw.TOL,
                 dict(n=n, bim=bim, dform=dform if leg not in ("A3", "A4") else False,
                      mass=mass is not None, **(dict(dtype="bfloat16") if bf16 else {})))
            for leg in legs]


def check_repeat(n: int = N_MAIN, seed: int = 1, dtype=None) -> None:
    """A1 (three modes), A2, A3 and A4 on the interface level's form (in
    bf16 storage also A5 and A6): two launches on the same inputs (and
    workspace) give bitwise-equal outputs and norms."""
    import torch
    from multigrid_feanet_torch.ops import sweep as sw

    u, f, uc, ph = level_inputs(n, True, seed, dtype)
    cfg = dict(a0=1.0, da=19.0, omega=2.0 / 3.0, dform=True, workspace={})
    zcfg = dict(a0=1.0, da=19.0, omega=2.0 / 3.0)
    runs = {"A1_sweep": lambda: sw.sweep_cuda(u, f, ph, None, mode="sweep", **cfg),
            "A1_residual": lambda: sw.sweep_cuda(u, f, ph, None, mode="residual", **cfg),
            "A1_psweep": lambda: sw.sweep_cuda(u, f, ph, uc, **cfg),
            "A2": lambda: sw.swrr_cuda(u, f, ph, **cfg),
            "A3": lambda: (sw.zrr_cuda(f, ph, **zcfg),),
            "A4": lambda: (sw.zpsweep_cuda(f, ph, uc, **zcfg),)}
    if dtype is not None:
        runs["A5"] = lambda: sw.rr_cuda(u, f, ph, a0=1.0, da=19.0, dform=True, workspace={})
        runs["A6"] = lambda: sw.pswrr_cuda(u, f, ph, uc, **cfg)
    same = {}
    for leg, run in runs.items():
        first = [t.clone() for t in run()]
        again = run()
        torch.cuda.synchronize()
        same[leg] = all(torch.equal(a, b) for a, b in zip(first, again))
    label = "a12_repeat_bitwise" if dtype is None else "bf16_repeat_bitwise"
    print(json.dumps({label: dict(n=n, **same)}), flush=True)
    if not all(same.values()):
        fail(f"{label}: the legs repeat differently: {same}")


def check_a34(sizes) -> list:
    """Hold A3 and A4 against their plain versions at each n of ``sizes`` in
    every form: bi-material and homogeneous, the plain form with and
    without the heat level's mass triple; one record per leg and form."""
    heat = (HEAT_THETA * HEAT_DT, 20.0 * HEAT_THETA * HEAT_DT)
    recs = []
    for n in sizes:
        mass = level_mass(n)
        for bim in (True, False):
            recs += check_kernels(n, bim, False, ["A3", "A4"])
            recs += check_kernels(n, bim, False, ["A3", "A4"], coef=heat, mass=mass)
    return recs


def a34_levels(recs) -> dict:
    """This run's A3/A4 times at each level size of the interface solve, in
    every form held, each beside its byte bound."""
    rows = {}
    for rec in recs:
        if rec["n"] not in A34_LEVELS:
            continue
        key = (f"{rec['name']}_{rec['n']}_{'bim' if rec['bim'] else 'hom'}_"
               f"{'mass' if rec['mass'] else 'plain'}")
        bound = 1e3 * rec["bytes"] / HBM_BYTES_PER_S
        rows[key] = dict(ms=rec["ms"], bound_ms=bound, of_bound=bound / rec["ms"])
    return rows


def a12_times(checks) -> dict:
    """This run's A1/A2 times at 4097^2 in every form held, each beside its
    byte bound; the parent's times are measured beside them by
    a12_vs_parent.py, not here."""
    rows = {}
    for rec in checks:
        if rec["n"] != N_MAIN or not rec["name"].startswith(("A1", "A2")):
            continue
        key = (f"{rec['name']}_{'bim' if rec['bim'] else 'hom'}_"
               f"{'mass' if rec['mass'] else 'dform' if rec['dform'] else 'plain'}")
        bound = 1e3 * rec["bytes"] / HBM_BYTES_PER_S
        rows[key] = dict(ms=rec["ms"], bound_ms=bound, of_bound=bound / rec["ms"])
    return rows


def check_torus(n: int, seed: int = 11):
    """Hold H1 against its plain version (both norms) on standard normal
    n x n torus fields; one record."""
    import torch
    from multigrid_feanet_torch.ops import torus as tt
    from multigrid_feanet_torch.ops.sweep import TOL

    rng = np.random.default_rng(seed)
    inputs = tuple(torch.as_tensor(rng.standard_normal((n, n)).astype(np.float32), device=DEVICE)
                   for _ in range(2))
    return hold("H1", lambda fn, x, kw: fn(x[0], x[1], **kw), tt.torus_sweep_cuda,
                tt.torus_sweep_plain, inputs, dict(a0=1.0, omega=2.0 / 3.0), 12 * n * n, TOL,
                dict(n=n))


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


def build_hierarchy(n: int, bim: bool, num_levels: int, threshold: int, device=None,
                    dtype=None):
    import torch
    from multigrid_feanet_torch.core.problem import Problem
    from multigrid_feanet_torch.solvers.mg2 import HierarchyV2

    prob = Problem(n=n, inclusion=CIRCLE if bim else None)
    return HierarchyV2(prob, num_levels=num_levels, kernel_threshold=threshold,
                       direct_coarse=True, dtype=dtype or torch.float32, device=device)


def all_kernels() -> dict:
    from multigrid_feanet_torch.ops import (elastic, general, hrelax, membench, passes,
                                            qsweep, stencil_sweep, sweep, torus)

    return {**sweep.KERNELS, **general.KERNELS, **hrelax.KERNELS, **elastic.KERNELS,
            **stencil_sweep.KERNELS, **torus.KERNELS, **qsweep.KERNELS, **membench.KERNELS,
            **passes.KERNELS}


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
    true_res = float(interior_norm(f0 - lv0.apply(u.float())))  # bf16 u: its widened values
    if not true_res <= 2 * eps:
        fail(f"{label}: true residual of the returned u is {true_res}")

    walls = timed_runs(label, run, hist)
    cycles_run = chunk * -(-(len(hist) + 1) // chunk) if lagged else len(hist)
    wall = min(walls)
    out = dict(solve=label, n=n, dtype=str(u.dtype).removeprefix("torch."), cycles=len(hist),
               cycles_run=cycles_run,
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


# profiler kernel names -> summary labels (e1_h_relax also names E1's
# one-pass tile, e1_h_relax_tile; c1_stencil_relax, c2_stencil_multi,
# e2_h_descent, e3_h_ascent, e4_h_zdescent, e5_h_zascent, d2_gen_descent and
# g2_el_descent, the one-pass tiles, also name the row-streaming
# c1_stencil_relax_rows, c2_stencil_multi_rows, e2_h_descent_rows,
# e3_h_ascent_rows, e4_h_zdescent_rows, e5_h_zascent_rows,
# d2_gen_descent_rows and g2_el_descent_rows; e2_slab_descent, the slab
# tile, names e2_slab_descent_rows); no name is a substring of another label's
# name except sweep_kernel, which is tested after zpsweep_kernel, and
# swrr_kernel, whose zero-guess instances (A3: third template argument true,
# then the storage type) A3_NAME tells apart first
A3_NAME = re.compile(r"swrr_kernel(<[^,>]*,[^,>]*,\s*(true|1)\s*[,>]|ILb\dELi\dELb1E)")
KERNEL_TAGS = (("zpsweep_kernel", "A4"), ("swrr_kernel", "A2"),
               ("sweep_kernel", "A1"), ("d1_gen_relax", "D1"), ("d2_gen_descent", "D2"),
               ("d3_gen_ascent", "D3"), ("d4_gen_zdescent", "D4"), ("d5_gen_zascent", "D5"),
               ("e2_h_descent", "E2"), ("e3_h_ascent", "E3"), ("e2_slab_descent", "E2_slab"),
               ("e3_slab_ascent", "E3_slab"), ("e4_h_zdescent", "E4"),
               ("e5_h_zascent", "E5"), ("g1_el_relax", "G1"), ("g2_el_descent", "G2"),
               ("g3_el_ascent", "G3"), ("g4_el_zdescent", "G4"), ("g5_el_zascent", "G5"),
               ("c1_stencil_relax", "C1"), ("c2_stencil_multi", "C2"),
               ("a5_resid_restrict", "A5"), ("a6_cross_cycle", "A6"),
               ("h1_torus_relax", "H1"), ("h1_torus_tile", "H1"),
               ("reduce_kernel", "rsq_reduce"), ("h1_reduce_pair", "rsq_reduce"),
               ("e1_h_relax", "E1"), ("f1_qsweep", "F1"), ("b1_copy", "B1"), ("b2_triad", "B2"),
               ("x1_heat_rhs", "X1"), ("x2_restrict", "X2"), ("x3_prolong_add", "X3"),
               ("x4_outer_step", "X4"), ("x5_learned_restrict", "X5"),
               ("x6_learned_prolong_add", "X6"), ("x7_learned_restrict_bwd", "X7"),
               ("x8_learned_prolong_bwd", "X8"), ("x9_weight_grad", "X9"))


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
    by_kernel, tf32 = {}, set()
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if "tf32" in evt.key:
            tf32.add(evt.key[:80])
        us = getattr(evt, "self_device_time_total", None)
        us = getattr(evt, "self_cuda_time_total", 0.0) if us is None else us
        name = evt.key
        for tag, label in KERNEL_TAGS:
            if tag in name:
                name = "A3" if A3_NAME.search(name) else label
                break
        else:
            name = "torch:" + name[:40]
        rec = by_kernel.setdefault(name, dict(ms_per_cycle=0.0, launches=0))
        rec["ms_per_cycle"] += us / 1e3 / cycles_run
        rec["launches"] += evt.count
    busy_ms = sum(r["ms_per_cycle"] for r in by_kernel.values()) * cycles_run
    if busy_ms == 0.0:
        return dict(device_time="not measured")
    out = dict(busy_ms_per_cycle=busy_ms / cycles_run, busy_share_of_wall=busy_ms / (1e3 * wall_s),
               profiled_wall_s=prof_wall, by_kernel=by_kernel)
    if tf32:
        out["tf32_kernels"] = sorted(tf32)
    return out


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


def run_boxmg_cell(prob, hier, setup) -> dict:
    """``boxmg_4097``: the BoxMG V(1,1) decay solve on the phase-4 setup with
    bf16 coefficient planes, at most 60 cycles."""
    import torch
    from multigrid_feanet_torch.solvers.boxmg import BoxMGHierarchy

    return run_solve("boxmg_4097", lambda: BoxMGHierarchy(
        prob, num_levels=9, kernel_threshold=32, direct_coarse=True, hier=hier, setup=setup,
        coef_dtype=torch.bfloat16, device=DEVICE), ("D2", "D3", "D4", "D5"), 60)


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


def decay_history_check(label: str, runs: dict, expect_drop: float = 1e-2) -> dict:
    """The f = 0 decay protocol's comparison of a 129^2 solve on the card
    with the CPU's plain one (``runs``: device -> (u, history)): besides
    ``same_solve``'s checks, the same number of cycles and every cycle's
    residual within SMALL_HIST_REL of the CPU's (with f = 0 no f32 residual
    floor stops the decay where a random right-hand side stalls), and a
    fall below ``expect_drop`` of the first.  Prints and returns the
    measured agreement."""
    same_solve(label, runs)
    (_, hg), (_, hc) = runs[DEVICE], runs["cpu"]
    hg, hc = np.asarray(hg), np.asarray(hc)
    if len(hg) != len(hc):
        fail(f"{label}: {len(hg)} cycles on the card, {len(hc)} on the CPU")
    rec = dict(cycles=len(hc), hist_rel_dev=float(np.max(np.abs(hg / hc - 1))),
               drop=float(hc[-1] / hc[0]))
    print(json.dumps({label: rec}), flush=True)
    if not rec["hist_rel_dev"] <= SMALL_HIST_REL or not rec["drop"] < expect_drop:
        fail(f"{label}: the card's decay history departs from the CPU's by "
             f"{rec['hist_rel_dev']} (drop {rec['drop']})")
    return rec


def decay_u0(seed: int, n: int = N_SMALL) -> np.ndarray:
    """The 129^2 checks' f = 0 decay start: u0 standard normal (rng
    ``seed``) on the interior, zero on the boundary ring."""
    geo = np.zeros((n + 1, n + 1), np.float32)
    geo[1:-1, 1:-1] = 1.0
    return (np.random.default_rng(seed).standard_normal((n + 1, n + 1)) * geo).astype(np.float32)


def check_hmg_small_against_cpu() -> dict:
    """Three 129^2 bi-material H-MG solves on the card against the CPU's
    plain path, on the f = 0 decay protocol (``decay_history_check``: u0
    standard normal, rng 4, a fixed number of cycles, every cycle within
    SMALL_HIST_REL of the CPU's); returns each variant's launches on the
    card."""
    from multigrid_feanet_torch.core.problem import Problem
    from multigrid_feanet_torch.solvers.hmg import HMGHierarchy

    u0 = decay_u0(4)
    f = np.zeros_like(u0)
    prob = Problem(n=N_SMALL, inclusion=CIRCLE)
    # cycles: the homogeneous-trained h_levels=1 net contracts slowly on the
    # interface (~0.9 a cycle), so it runs 40; with the boundary value 0.7
    # the decay reaches the f32 floor of the constant solution (~5e-5 at
    # 129^2, from the 10th cycle on the CPU), so that variant stops at 6,
    # over 100x above it
    variants = {  # label: (checkpoint, hierarchy options, solve options, kernels to launch)
        "hmg_small_L3_hl1": (HNET_L3_HL1, dict(h_levels=1), dict(max_cycles=40),
                             ("E2", "E3", "A3", "A4")),
        "hmg_small_nonzero_legs": (HNET_L3, dict(coarse_zero_legs=False), dict(max_cycles=20),
                                   ("E2", "E3")),
        "hmg_small_bc": (HNET_L1, dict(dform=True), dict(max_cycles=6, bc_value=0.7),
                         ("E2", "E3", "E4", "E5")),
    }
    out = {}
    for label, (ckpt, hkw, skw, expect) in variants.items():
        runs = {}
        for dev in (DEVICE, "cpu"):
            hv = HMGHierarchy(prob, num_levels=4, kernel_threshold=16, direct_coarse=True,
                              device=dev, **hkw)
            params = load_params(ckpt, dev)
            (u, h), launches = counted(lambda: hv.solve(params, f, u0=u0, eps=0.0, **skw))
            if dev == DEVICE:
                out[label] = launches
                if not all(out[label].get(key) for key in expect):
                    fail(f"{label}: a kernel of the path never launched: {out[label]}")
            runs[dev] = (u.cpu().numpy(), h)
        if "bc_value" in skw and not np.allclose(runs[DEVICE][0][0], skw["bc_value"]):
            fail(f"{label}: the boundary value was not kept")
        decay_history_check(label, runs)
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
        t12_s=tb12, max_hist_ratio_dev=float(np.max(np.abs(ratio - 1))), launches=lb,
        hist12=hb12.tolist())
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


# the 129^2 elastic checks: the V-cycles and PCG iterations of the f = 0
# decay protocol, and the largest departure of the card's history from the
# CPU's, cycle by cycle, relative to the CPU's (also the H-MG and round-1
# checks', decay_history_check)
ELASTIC_SMALL_CYCLES, ELASTIC_SMALL_ITERS, SMALL_HIST_REL = 20, 10, 1e-2


def check_elastic_small_against_cpu() -> dict:
    """Three 129^2 bi-material elastic solves (V(2,2), V(1,1), PCG; 4
    levels, the direct solve at n = 16) on the card against the CPU's
    plain path, on the f = 0 decay protocol (u0 standard normal, rng 8;
    eps 0, ELASTIC_SMALL_CYCLES cycles or ELASTIC_SMALL_ITERS iterations;
    ``decay_history_check``).  Returns each variant's launches on the
    card."""
    import torch

    rng = np.random.default_rng(8)
    geo = np.zeros((N_SMALL + 1, N_SMALL + 1), np.float32)
    geo[1:-1, 1:-1] = 1.0
    u0 = (rng.standard_normal((2, N_SMALL + 1, N_SMALL + 1)) * geo).astype(np.float32)
    f = np.zeros_like(u0)
    m, it = ELASTIC_SMALL_CYCLES, ELASTIC_SMALL_ITERS
    variants = {  # label: (run, kernels to launch)
        "elastic_small_v22": (lambda hv: hv.solve(f, u0=u0, eps=0.0, max_cycles=m),
                              ("G1", "G2", "G3")),
        "elastic_small_v11": (lambda hv: hv.solve(f, u0=u0, nu1=1, nu2=1, eps=0.0, max_cycles=m),
                              ("G2", "G3", "G4", "G5")),
        "elastic_small_pcg": (lambda hv: hv.solve_pcg(f, u0=u0, eps=0.0, max_iters=it),
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
            if not torch.isfinite(u).all():
                fail(f"{label}: non-finite solution on {dev}")
            runs[dev] = (u.cpu().numpy(), h)
        decay_history_check(label, runs)
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


def norm_passes(label: str, rec: dict, most: int) -> None:
    """Fail if the profiled solve of ``rec`` launched more than ``most``
    separate norm passes (``rsq_reduce``); no check where the profiler
    recorded no device time.  The profiler can lose a launch's record (on
    the H100 it has missed one G1 of a PCG solve's 305 and not its norm
    pass), never add one, so ``most`` comes from the wrappers' exact counts."""
    prof = rec["profile"]
    if "by_kernel" not in prof:
        return
    got = prof["by_kernel"].get("rsq_reduce", {}).get("launches", 0)
    if got > most:
        fail(f"{label}: {got} norm passes (rsq_reduce), at most {most} expected")


# The parent commit's (2856d2e) 4097^2 cells on an H100 (the mean of its two
# turns of ``sweep_vs_parent.py --legs e4c2_cells``, PERF.md PR 17): cycles,
# tail q, device and wall ms per cycle.  ``parent_cell`` holds a cell to the
# parent's cycles and to its tail q within ``tail_q_rel``: 0, bit for bit,
# where the path's arithmetic is the parent's; 1e-6 on the interface H-MG,
# where E4's streaming kernel and its tile differ by <= 1 ulp in the
# bi-material forms (most likely the compiler's per-kernel choice of fused
# multiply-adds; the tail q moves by 4.4e-7); 1e-3 on `_v22`, where C2 sums
# its norm in another order.
# It prints the cell's device and wall ms per cycle beside the parent's.
PARENT_CELLS = {
    "hmg_4097": dict(cycles=11, tail_q=0.05670624598860741, device_ms=0.417585,
                     wall_ms=0.7780, tail_q_rel=0.0),
    "hmg_interface_4097": dict(cycles=31, tail_q=0.407489150762558, device_ms=0.548005,
                               wall_ms=1.1021, tail_q_rel=1e-6),
    "poisson_4097_r1": dict(cycles=23, tail_q=0.2513483464717865, device_ms=2.09281,
                            wall_ms=6.8336, tail_q_rel=0.0),
    "poisson_4097_r1_v22": dict(cycles=14, tail_q=0.11144457012414932, device_ms=2.32070,
                                wall_ms=4.4469, tail_q_rel=1e-3),
}


def parent_cell(rec: dict) -> None:
    """Compare a 4097^2 cell's record with the parent's (PARENT_CELLS)."""
    par = PARENT_CELLS.get(rec["solve"])
    if par is None:
        return
    q_rel = abs(rec["tail_q"] / par["tail_q"] - 1.0)
    print(json.dumps({f"{rec['solve']}_against_parent": dict(
        cycles=[rec["cycles"], par["cycles"]], tail_q=[rec["tail_q"], par["tail_q"]],
        tail_q_rel=q_rel,
        device_ms_per_cycle=[rec["profile"].get("busy_ms_per_cycle"), par["device_ms"]],
        wall_ms_per_cycle=[rec["ms_per_cycle"], par["wall_ms"]])}), flush=True)
    if rec["cycles"] != par["cycles"] or q_rel > par["tail_q_rel"]:
        fail(f"{rec['solve']}: {rec['cycles']} cycles, tail q {rec['tail_q']}; the parent's "
             f"{par['cycles']}, {par['tail_q']} (within {par['tail_q_rel']})")


# The parent commit's (42e95f5) elastic cells on an H100 (its own
# chip_smoke.py run, PERF.md): the histories (cycles run: their lengths), q
# and device ms per cycle.  ``parent_elastic`` holds this run's histories
# and q to them, relative: the 12-cycle V-cycles within 1e-6 (a kernel's two
# designs differ by about an ulp per node where the compiler contracts other
# multiply-adds: 5.4e-7 was measured when G1 first streamed) and ``_t512``
# too (held to the parent's threshold-16 history, which the parent's
# ``_t512`` matched to 1.2e-7).  The 60-cycle q and the PCG carry such
# differences further: 60 cycles of them (q_asym60 6.7e-6 then) and a Krylov
# recurrence, whose coefficients amplify them (history 8.7e-4, contraction
# 9.4e-5): those are held to about ten times what was measured, as
# PARENT_CELLS holds ``_v22``, whose norm C2 sums in another order, to 1e-3.
PARENT_ELASTIC = {
    "elastic_2049": dict(
        hist=[408615648.0, 70815640.0, 17310630.0, 4596228.0, 1282540.625, 400748.375,
              143097.9375, 68970.203125, 33988.46484375, 20411.765625, 10829.9521484375],
        hist_rel=1e-6, q=dict(tail_q12=(0.5245033502578735, 1e-6),
                              q_asym60=(0.6741865277290344, 1e-4)), device_ms=0.519373666666666),
    "elastic_pcg_2049": dict(
        hist=[380811904.0, 45690884.0, 4613383.5, 1403544.625, 289555.28125, 111284.3515625,
              34411.078125, 12056.537109375, 4971.82568359375, 1577.7896728515625,
              476.4461975097656, 155.4217987060547, 61.86849594116211, 21.33721160888672,
              8.732805252075195, 3.211780309677124],
        hist_rel=1e-2, q=dict(contraction=(0.35599955916404724, 1e-3)),
        device_ms=0.8886240625000037),
    "elastic_v11_2049": dict(
        hist=[1498467968.0, 399846912.0, 149096960.0, 67033024.0, 32527904.0, 16589824.0,
              8746776.0, 4873143.0, 2855171.5, 1804418.125, 1199019.5],
        hist_rel=1e-6, q=dict(tail_q12=(0.6084775924682617, 1e-6)),
        device_ms=0.27929324999999827),
}


def parent_elastic(cells: dict) -> None:
    """Hold the elastic cells' histories (their cycle counts with them) and q
    to the parent's (PARENT_ELASTIC) within each one's relative bound; print
    each cell's device ms per cycle beside the parent's."""
    hists = {"elastic_2049": cells["elastic_2049"]["hist12"],
             "elastic_pcg_2049": cells["elastic_pcg_2049"]["hist"],
             "elastic_v11_2049": cells["elastic_v11_2049"]["hist12"],
             "elastic_2049_t512": cells["elastic_2049_t512"]["hist12"]}
    for label, hist in hists.items():
        par = PARENT_ELASTIC[label.removesuffix("_t512")]
        rec = cells[label]
        q = {k: dict(got=rec[k], parent=v, rel=abs(rec[k] / v - 1.0), bound=bound)
             for k, (v, bound) in par["q"].items() if label in PARENT_ELASTIC}
        dev = (abs(np.asarray(hist) / np.asarray(par["hist"]) - 1.0).max()
               if len(hist) == len(par["hist"]) else float("inf"))
        print(json.dumps({f"{label}_against_parent": dict(
            history_len=[len(hist), len(par["hist"])], max_hist_rel=float(dev),
            hist_bound=par["hist_rel"], q=q,
            device_ms_per_cycle=[rec.get("profile", {}).get("busy_ms_per_cycle"),
                                 par["device_ms"]])}), flush=True)
        if not dev <= par["hist_rel"] or any(v["rel"] > v["bound"] for v in q.values()):
            fail(f"{label}: history or q departs from the parent's: {dev} "
                 f"(at most {par['hist_rel']}), {q}")


def run_r1_cells() -> dict:
    """``poisson_4097_r1`` (V(1,1): C1) and ``poisson_4097_r1_v22`` (V(2,2):
    C2, C1 for the residuals): the homogeneous 4097^2 decay solve on the
    round-1 Hierarchy, 9 levels, threshold 32, at most 60 cycles.  Per cycle
    each of the K = 8 kernel levels runs nu1 + nu2 sweeps, one residual and
    the two transfers (X2, X3) to and from the level below, and level 0 one
    more residual after the cycle."""
    out = {}
    K = 8
    for label, nu in (("poisson_4097_r1", 1), ("poisson_4097_r1_v22", 2)):
        rec = run_solve(label, lambda: build_r1(N_MAIN, False, 9, 32), ("C1",) if nu == 1
                        else ("C1", "C2"), 60, lagged=False,
                        solve=lambda hv, f, chunk, nu=nu, **kw: hv.solve(f, nu1=nu, nu2=nu, **kw))
        c = rec["cycles"]
        expect = {"C1": (3 * K + 1) * c} if nu == 1 else {"C1": (K + 1) * c, "C2": 2 * K * c}
        expect.update(X2=K * c, X3=K * c)
        if rec["launches"] != expect:
            fail(f"{label}: launches {rec['launches']}, expected {expect}")
        out[label] = rec
    return out


def run_hmg_cells() -> dict:
    """``hmg_4097`` (homogeneous, at most 40 cycles) and
    ``hmg_interface_4097`` (bi-material in difference form, at most 60): the
    4097^2 H-MG decay solves with the L = 1 net, 9 levels, threshold 32."""
    from multigrid_feanet_torch.core.problem import Problem
    from multigrid_feanet_torch.solvers.hmg import HMGHierarchy

    params = load_params(HNET_L1)
    return {label: run_solve(label, lambda bim=bim: HMGHierarchy(
        Problem(n=N_MAIN, inclusion=CIRCLE if bim else None), num_levels=9,
        kernel_threshold=32, direct_coarse=True, dform=bim, device=DEVICE),
        ("E2", "E3", "E4", "E5"), cap, solve=lambda hv, f, **kw: hv.solve(params, f, **kw))
        for label, bim, cap in (("hmg_4097", False, 40), ("hmg_interface_4097", True, 60))}


def run_pswrr_cell(split: dict) -> dict:
    """``pswrr_interface_4097``: ``interface_4097`` with ``use_pswrr``.  It
    must launch A6, take the split path's cycles +-1 and land within 1% of
    its tail q."""
    rec = run_solve("pswrr_interface_4097", lambda: build_hierarchy(N_MAIN, True, 9, 32, DEVICE),
                    ("A6", "A3", "A4"), 120,
                    solve=lambda hv, f, **kw: hv.solve(f, use_pswrr=True, **kw))
    dq = abs(rec["tail_q"] / split["tail_q"] - 1.0)
    busy = [r["profile"].get("busy_ms_per_cycle") for r in (rec, split)]
    print(json.dumps(dict(pswrr_vs_split=dict(cycles=[rec["cycles"], split["cycles"]],
                                              tail_q=[rec["tail_q"], split["tail_q"]],
                                              tail_q_rel_dev=dq,
                                              device_ms_per_cycle=busy))), flush=True)
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


def run_ir_cell(dtype=None, max_outer: int = 12, bim: bool = False) -> dict:
    """``ir_4097``: ``solve_ir`` on the homogeneous 4097^2 HierarchyV2
    (threshold 32, 9 levels, direct coarse) with f = apply_mass(1, h), V(1,1),
    eps 1e-6, 6 cycles per correction, at most ``max_outer`` outer steps
    (bench.py's hard row: 12).  The f64 true residual of the returned u, from
    a level assembled anew in f64, must be <= 1e-6; each outer step is one
    X4 launch.  Beside it, the floor of the level storage: 20 plain V(1,1)
    cycles on the same f.  With ``dtype`` bf16 the hierarchy stores its
    levels in bf16 (``ir_4097_bf16``); with ``bim`` it is the bi-material
    interface hierarchy of ``interface_4097`` (``ir_interface_4097``: X4 in
    its two-phase form)."""
    import torch
    from multigrid_feanet_torch.core.problem import Problem, build_level
    from multigrid_feanet_torch.ops.stencil import apply_mass
    from multigrid_feanet_torch.solvers.jacobi import interior_norm
    from multigrid_feanet_torch.solvers.mg import solve_ir

    eps = 1e-6
    label = ("ir_interface_4097" if bim else "ir_4097") + ("" if dtype is None else "_bf16")
    t0 = time.time()
    hv = build_hierarchy(N_MAIN, bim, 9, 32, DEVICE, dtype)
    lv0 = hv.hier.finest
    f = apply_mass(torch.ones((N_MAIN + 1, N_MAIN + 1), device=DEVICE), lv0.h)
    setup_s = time.time() - t0

    def run():
        return solve_ir(hv, f, nu1=1, nu2=1, eps=eps, cycles_per_correction=6,
                        max_outer=max_outer)

    (u, hist), launches = counted(run)
    lv64 = build_level(Problem(n=N_MAIN, inclusion=CIRCLE if bim else None,
                               dtype=torch.float64), N_MAIN, device=DEVICE)
    true64 = float(interior_norm(f.double() - lv64.apply(u)))
    if u.dtype != torch.float64 or not torch.isfinite(u).all() or not true64 <= eps:
        fail(f"{label}: the f64 true residual is {true64} after {len(hist)} steps: {hist}")
    if not all(launches.get(key) for key in ("A1", "A2", "A3", "A4")):
        fail(f"{label}: a kernel of the path never launched: {launches}")
    if launches.get("X4") != len(hist):
        fail(f"{label}: {launches.get('X4')} X4 launches for {len(hist)} outer steps")
    walls = timed_runs(label, run, hist)
    cycles = 6 * (len(hist) - 1)
    u20, h20 = hv.solve(f, eps=0.0, max_cycles=20)
    floor64 = float(interior_norm(f.double() - lv64.apply(u20.double())))
    rec = dict(solve=label, n=N_MAIN, outer_steps=len(hist), corrections=len(hist) - 1,
               hist=hist.tolist(), true_res_f64=true64, wall_s=min(walls), walls_s=walls,
               setup_s=setup_s, launches=launches, dtype=str(hv.dtype).removeprefix("torch."),
               v11_20_cycles_hist_last=float(h20[-1]), v11_20_cycles_true_res_f64=floor64,
               profile=profile_solve(run, max(1, cycles), min(walls)))
    print(json.dumps(rec), flush=True)
    return rec


def check_r5_small_against_cpu() -> dict:
    """129^2 checks of this slice's paths on the card against the CPU's
    plain path: the bi-material round-1 Hierarchy at V(1,1) and V(2,2) (20
    cycles) and the V2 and BoxMG solve_pcg (10 iterations) on the f = 0
    decay protocol (``decay_history_check``: u0 standard normal, rng 10,
    every cycle within SMALL_HIST_REL of the CPU's), solve_jacobi with fuse
    1 and 4 (400 sweeps) and solve_ir on both hierarchies (homogeneous, f =
    apply_mass(1, h), eps 1e-9).  Returns each check's launches on the
    card."""
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

    u0 = decay_u0(10)
    f0 = np.zeros_like(u0)
    for label, nu, expect in (("r1_small_v11", 1, ("C1", "X2", "X3")),
                              ("r1_small_v22", 2, ("C1", "C2", "X2", "X3"))):
        res = both(label, lambda dev: build_r1(n, True, 4, 16, dev),
                   lambda hv, nu=nu: hv.solve(f0, u0=u0, nu1=nu, nu2=nu, eps=0.0, max_cycles=20),
                   expect)
        decay_history_check(label, {d: (u.cpu().numpy(), h) for d, (u, h) in res.items()})
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
        res = both(label, build, lambda hv: hv.solve_pcg(f0, u0=u0, eps=0.0, max_iters=10),
                   expect)
        decay_history_check(label, {d: (u.cpu().numpy(), h) for d, (u, h) in res.items()})
    irs = (("ir_small_r1", lambda dev: build_r1(n, False, 4, 16, dev), ("C1", "X4")),
           ("ir_small_v2", lambda dev: build_hierarchy(n, False, 4, 16, dev),
            ("A2", "A3", "A4", "X4")))
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


def analytic_pbc(n: int, device):
    """The reference's periodic problem (tests/test_pbc.py: rhs = 5 sin(-4 pi
    (x + 1/2)) cos(3 pi y)) on n x n torus nodes: (table, f) on ``device``."""
    import torch
    from multigrid_feanet_torch.ops import pbc
    from multigrid_feanet_torch.ops.stencil import make_homogeneous_stencil

    x = np.linspace(-1.0, 1.0, n + 1, dtype=np.float32)
    xx, yy = np.meshgrid(x, x, indexing="ij")
    rhs = (5.0 * np.sin(-4.0 * np.pi * (xx + 0.5)) * np.cos(3.0 * np.pi * yy)).astype(np.float32)
    f = pbc.apply_mass_periodic(pbc.from_wrapped(torch.as_tensor(rhs, device=device)), 2.0 / n)
    return make_homogeneous_stencil(device=device), f


def bench_f(n: int) -> np.ndarray:
    """bench.py:50-52's f: the second standard-normal (n+1)^2 draw of
    default_rng(0), float32."""
    rng = np.random.default_rng(0)
    rng.standard_normal((n + 1, n + 1))
    return rng.standard_normal((n + 1, n + 1)).astype(np.float32)


def run_pbc_cells() -> dict:
    """The periodic cells on H1: ``pbc_jacobi_32`` (the reference's 46-sweep
    anchor), ``torus_jacobi_4096`` (512 sweeps, eps None, two chunks, on
    bench.py:423-455's compatibility-shifted f) and ``pbc_mg_4096``
    (solve_pbc_mg on the analytic problem, 12 levels, H1 on n >= 32)."""
    import torch
    from multigrid_feanet_torch.ops import pbc
    from multigrid_feanet_torch.solvers.pbc_mg import solve_pbc_mg

    out = {}
    table, f = analytic_pbc(32, DEVICE)
    r0 = float(pbc.pbc_interior_norm(f))
    (u, hist), launches = counted(
        lambda: pbc.solve_jacobi_pbc(table, f, eps=5e-6, max_iters=2000, device=DEVICE))
    head = [0.21556054, 0.16937497, 0.13308503, 0.10457049, 0.08216543]
    out["pbc_jacobi_32"] = dict(solve="pbc_jacobi_32", iterations=len(hist), r0=r0,
                                head=hist[:5].tolist(), final=float(hist[-1]), launches=launches)
    print(json.dumps(out["pbc_jacobi_32"]), flush=True)
    if (len(hist) != 46 or not np.allclose(hist[:5], head, rtol=1e-4)
            or not np.isclose(r0, 0.27434009, rtol=1e-4) or launches != {"H1": 257}):
        fail(f"pbc_jacobi_32 departs from the reference's 46-sweep history: {out['pbc_jacobi_32']}")

    n, sweeps = N_MAIN, 512
    h = 2.0 / n
    F = torch.as_tensor(bench_f(n)[:n, :n], device=DEVICE)
    fb = pbc.compatibility_shift(pbc.apply_mass_periodic(F, h), h)

    def run():
        return pbc.solve_jacobi_pbc(table, fb, eps=None, max_iters=sweeps, device=DEVICE)

    (u, hist), launches = counted(run)
    if launches != {"H1": sweeps + 2} or len(hist) != sweeps or not np.all(np.isfinite(hist)):
        fail(f"torus_jacobi_4096: {len(hist)} norms, launches {launches}")
    if not hist[-1] < hist[0] or tuple(u.shape) != (n, n) or not torch.isfinite(u).all():
        fail(f"torus_jacobi_4096: the residual does not fall or u is not finite: {hist[[0, -1]]}")
    walls = timed_runs("torus_jacobi_4096", run, hist)
    wall = min(walls)
    out["torus_jacobi_4096"] = dict(
        solve="torus_jacobi_4096", n=n, sweeps=sweeps, chunks=2, wall_s=wall, walls_s=walls,
        ms_per_sweep=1e3 * wall / sweeps, first=float(hist[0]), last=float(hist[-1]),
        launches=launches, profile=profile_solve(run, sweeps, wall))
    print(json.dumps(out["torus_jacobi_4096"]), flush=True)

    table, f = analytic_pbc(n, DEVICE)

    def run_mg():
        return solve_pbc_mg(table, f, eps=PBC_EPS, max_cycles=100, kernel_threshold=32,
                            device=DEVICE)

    (u, hist), launches = counted(run_mg)
    cycles = len(hist)
    kernel_levels = sum(1 for l in range(int(np.log2(n))) if n >> l >= 32)  # 4096..32: 8
    if launches != {"H1": 2 * kernel_levels * cycles}:  # a pre- and a post-relax each
        fail(f"pbc_mg_4096: launches {launches} in {cycles} cycles")
    if not hist[-1] <= PBC_EPS or abs(cycles - PBC_JAX_CYCLES) > 1 or not torch.isfinite(u).all():
        fail(f"pbc_mg_4096: {cycles} cycles to {hist[-1]}, JAX takes {PBC_JAX_CYCLES} "
             f"to {PBC_EPS}: {hist}")
    walls = timed_runs("pbc_mg_4096", run_mg, hist)
    wall = min(walls)
    out["pbc_mg_4096"] = dict(
        solve="pbc_mg_4096", n=n, levels=12, cycles=cycles, jax_cycles=PBC_JAX_CYCLES,
        eps=PBC_EPS, hist=hist.tolist(), wall_s=wall, walls_s=walls,
        ms_per_cycle=1e3 * wall / cycles, launches=launches,
        profile=profile_solve(run_mg, cycles, wall))
    print(json.dumps(out["pbc_mg_4096"]), flush=True)
    return out


def heat_solver(n: int, num_levels: int, threshold: int, device=None):
    """The heat cell's solver: the circle r = 0.5 bi-material problem,
    HEAT_DT, HEAT_THETA, the fused backend (on the card by default)."""
    from multigrid_feanet_torch.core.problem import Problem
    from multigrid_feanet_torch.ops.heat import HeatSolver

    return HeatSolver(Problem(n=n, inclusion=CIRCLE), dt=HEAT_DT, theta=HEAT_THETA,
                      backend="fused", kernel_kw=dict(num_levels=num_levels,
                                                      kernel_threshold=threshold),
                      device=device or DEVICE)


def run_heat_cell() -> dict:
    """``heat_march_4097`` (bench.py:274-289): ``HeatSolver.march``, 10
    steps of 2 V(1,1) cycles from u0 = 0 with bench.py's f, 9 levels,
    threshold 32: exactly 20 A1, 20 A2, 140 A3, 140 A4 and 10 X1 launches
    (one right-hand side a step).  The march replays one CUDA graph a step:
    its first (capturing) and a warm march, and a time-dependent march of 3
    steps (knots f (1 + k / 10)), must equal the eager march (``graph=False``)
    bit for bit with the eager march's launch counts, the warm march making
    no wrapper call of its own, one capture per key.  Both paths are timed.
    X1 runs its row-streaming design there (``x1_design``); the graph
    march once more with its one-pass tile forced, on fresh graphs, must
    equal it bit for bit with the same launches.  Beside it one ``step`` to
    the smallest decade at least twice the step's f32 floor (the least
    residual of 12 cycles at eps 0)."""
    import torch
    from multigrid_feanet_torch.ops import passes as px
    from multigrid_feanet_torch.solvers.common import ChunkGraphs

    n, steps, cps = N_MAIN, 10, 2
    t0 = time.time()
    hs = heat_solver(n, 9, 32)
    setup_s = time.time() - t0
    f = torch.as_tensor(bench_f(n), device=DEVICE)
    u0 = torch.zeros_like(f)

    def run(graph=True):
        return hs.march(u0, f, steps, cycles_per_step=cps, graph=graph), None

    (u, _), launches = counted(run)
    c, below = steps * cps, (hs.ph.K - 1) * steps * cps  # K = 8 fused levels at 4097^2
    expect = {"A1": c, "A2": c, "A3": below, "A4": below, "X1": steps}
    if launches != expect:
        fail(f"heat_march_4097: launches {launches}, expected {expect}")
    if tuple(u.shape) != (n + 1, n + 1) or not torch.isfinite(u).all() or not u.abs().max() > 0:
        fail("heat_march_4097: the solution is not finite and nonzero")
    (ue, _), launches_e = counted(lambda: run(False))
    (uw, _), launches_w, own = own_calls(run)
    ftd = torch.stack([f * (1.0 + 0.1 * k) for k in range(4)])
    td_g, td_e = (hs.march(u0, ftd, 3, cycles_per_step=cps, graph=g) for g in (True, False))
    checks = dict(cold_bitwise=bool(torch.equal(u, ue)), warm_bitwise=bool(torch.equal(uw, ue)),
                  timedep_bitwise=bool(torch.equal(td_g, td_e)),
                  launches_equal=launches_w == launches_e == launches, own_calls=not own,
                  captures=hs.graphs.captures == 2)
    del ftd, td_g, td_e
    # the graph march once more with X1's tile forced, on fresh graphs: bit
    # for bit the row stream's march, with the same launches
    graphs, saved = hs.graphs, dict(px.X1_ONE_PASS_MAX_N)
    px.X1_ONE_PASS_MAX_N.update({k: n for k in saved})
    hs.graphs = ChunkGraphs(hs.device)
    try:
        (ut, _), launches_t = counted(run)
    finally:
        px.X1_ONE_PASS_MAX_N.update(saved)
        hs.graphs = graphs
    checks.update(tile_bitwise=bool(torch.equal(u, ut)), tile_launches=launches_t == expect)
    del ut
    walls, prof = {}, {}
    for path, graph in (("graph", True), ("eager", False)):
        walls[path] = []
        for _ in range(3):
            t0 = time.time()
            run(graph)
            torch.cuda.synchronize()
            walls[path].append(time.time() - t0)
        prof[path] = profile_solve(lambda graph=graph: run(graph), steps * cps,
                                   min(walls[path]))
    wall = min(walls["graph"])
    _, probe = hs.step(u0, f, f, eps=0.0, max_cycles=12)
    floor = float(np.min(probe))
    eps = float(10.0 ** np.ceil(np.log10(2.0 * floor)))

    def step():
        return hs.step(u0, f, f, eps=eps, max_cycles=40)

    (_, hist), step_launches = counted(step)
    step_walls = timed_runs("heat_step_4097", step, hist)
    if not hist[-1] <= eps:
        fail(f"heat_step_4097: no convergence to {eps}: {hist}")
    rec = dict(solve="heat_march_4097", n=n, steps=steps, cycles_per_step=cps, setup_s=setup_s,
               x1_design=x1_design(n), wall_s=wall, walls_s=walls["graph"],
               ms_per_step=1e3 * wall / steps, ms_per_cycle=1e3 * wall / (steps * cps),
               u_max=float(u.abs().max()), launches=launches, profile=prof["graph"],
               graph_checks=checks,
               eager=dict(walls_s=walls["eager"],
                          ms_per_step=1e3 * min(walls["eager"]) / steps,
                          profile=prof["eager"]),
               step=dict(eps=eps, floor_12_cycles=floor, probe=probe.tolist(),
                         cycles=len(hist), hist=hist.tolist(), wall_s=min(step_walls),
                         walls_s=step_walls, launches=step_launches))
    print(json.dumps(rec), flush=True)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        fail(f"heat_march_4097: the replayed march misses {failed}: own calls {own}, "
             f"captures {hs.graphs.captures}")
    return rec


def check_r6_small_against_cpu() -> dict:
    """129^2 checks of the heat and periodic paths on the card against the
    CPU's plain path: the fused HeatSolver.step (eps 1e-9, clear of its
    ~5e-12 floor) and march (10 steps of 2 cycles), a float64 HeatSolver's
    step on the plain backend (eps 1e-11; X1 in float64), and solve_pbc_mg on the
    analytic problem at 128^2, H1 on levels 128..32, to the smallest decade
    at least 100 times its f32 floor (the least norm of 12 cycles at eps 0,
    the larger of the card's and the CPU's: at eps 2e-6 the two paths'
    last norms differed by 2.7e-3).  Cycles equal, histories within 1e-3, u
    within 1e-4 of its scale.  Returns each check's launches on the card."""
    import torch
    from multigrid_feanet_torch.core.problem import Problem
    from multigrid_feanet_torch.ops.heat import HeatSolver
    from multigrid_feanet_torch.solvers.pbc_mg import solve_pbc_mg

    n = N_SMALL
    f = np.random.default_rng(12).standard_normal((n + 1, n + 1)).astype(np.float32)
    z = np.zeros_like(f)

    def pbc_mg_small(dev, eps, max_cycles):
        table, fp = analytic_pbc(n, dev)
        return solve_pbc_mg(table, fp, eps=eps, max_cycles=max_cycles, kernel_threshold=32,
                            device=dev)

    probes = {str(dev): pbc_mg_small(dev, 0.0, 12)[1] for dev in (DEVICE, "cpu")}
    floor = max(float(np.min(h)) for h in probes.values())
    pbc_eps = float(10.0 ** np.ceil(np.log10(100.0 * floor)))
    print(json.dumps({"pbc_small_floor": dict(floor_12_cycles=floor, eps=pbc_eps,
                                              probes={d: h.tolist() for d, h in probes.items()})}),
          flush=True)
    runs = {
        "heat_small_step": (lambda dev: heat_solver(n, 4, 16, dev),
                            lambda hs: hs.step(z, f, f, eps=1e-9, max_cycles=40),
                            ("A1", "A2", "A3", "A4", "X1")),
        "heat_small_march": (lambda dev: heat_solver(n, 4, 16, dev),
                             lambda hs: (hs.march(z, f, 10, cycles_per_step=2), None),
                             ("A1", "A2", "A3", "A4", "X1")),
        "heat_small_step_f64": (lambda dev: HeatSolver(Problem(n=n, inclusion=CIRCLE,
                                                               dtype=torch.float64),
                                                       dt=HEAT_DT, theta=HEAT_THETA, device=dev),
                                lambda hs: hs.step(z, f, f, eps=1e-11, max_cycles=60),
                                ("X1",)),
        "pbc_mg_small": (lambda dev: dev, lambda dev: pbc_mg_small(dev, pbc_eps, 40), ("H1",)),
    }
    out = {}
    for label, (build, run, expect) in runs.items():
        res = {}
        for dev in (DEVICE, "cpu"):
            obj = build(dev)
            (u, h), launches = counted(lambda: run(obj))
            if dev == DEVICE:
                out[label] = launches
                if not all(launches.get(key) for key in expect):
                    fail(f"{label}: a kernel of the path never launched: {launches}")
            res[dev] = (u.cpu().numpy(), h)
        (ug, hg), (uc, hc) = res[DEVICE], res["cpu"]
        d = ug - uc
        if label.startswith("pbc"):
            d = d - d.mean()  # the constant nullspace
        du = float(np.max(np.abs(d)) / np.max(np.abs(uc)))
        rec = dict(u_rel_err=du)
        ok = du < 1e-4
        if hg is not None:
            rec.update(cycles=[len(hg), len(hc)],
                       max_hist_rel_dev=float(np.max(np.abs(hg[:len(hc)] / hc[:len(hg)] - 1))))
            ok = ok and len(hg) == len(hc) and rec["max_hist_rel_dev"] < 1e-3
        print(json.dumps({label: rec}), flush=True)
        if not ok:
            fail(f"{label}: the card disagrees with the CPU plain path: {rec}")
    print(json.dumps({"r6_small_launches": out}), flush=True)
    return out


def check_e1(n: int, bim: bool, dform: bool, ckpt: str, bc=None, seed: int = 13):
    """Hold E1 against its plain version on one level's seeded inputs with
    the kernels of ``ckpt``; ``bc`` None (the ring kept), a number or
    "field" (a standard normal boundary field).  One record."""
    import torch
    from multigrid_feanet_torch.ops import hrelax as hx

    params = load_params(ckpt)
    L = int(params.shape[0])
    inputs = level_inputs(n, bim, seed) + (params,)
    bcv = bc
    if bc == "field":
        bcv = torch.as_tensor(np.random.default_rng(seed).standard_normal((n + 1, n + 1)).astype(
            np.float32), device=DEVICE)
    cfg = dict(a0=1.0, da=19.0 if bim else 0.0, omega=2.0 / 3.0, dform=dform, bc=bcv)
    rec = hold("E1", lambda fn, x, kw: fn(x[0], x[1], x[3], x[4], **kw), hx.hrelax_cuda,
               hx.hrelax_plain, inputs, cfg, hrelax_bytes("E1", n, bim, L), hx.TOL,
               dict(n=n, bim=bim, dform=dform, L=L, bc=bc))
    return dict(rec, flops_per_node=hrelax_flops("E1", bim, dform, L))


def hold_twice(label: str, kernel, plain, tol: float) -> dict:
    """Run a kernel twice and its plain version once on the same inputs
    (closures returning output tuples); fail unless the kernel's first
    outputs agree with the plain version's within ``tol`` (fields relative
    to max(1, max|plain|), bf16 fields one bf16 ulp per element beyond that
    (``ops.sweep.bf16_excess``), scalar norms relative to themselves) and
    its two launches agree bitwise.  One record of the errors."""
    import torch

    from multigrid_feanet_torch.ops.sweep import bf16_excess

    first = [t.clone() for t in kernel()]
    again = kernel()
    want = plain()
    torch.cuda.synchronize()
    rel = rsq_rel = 0.0
    for g, w in zip(first, want):
        w = w.to(g.device)
        if g.dim() == 0:
            rsq_rel = max(rsq_rel, abs(float(g) - float(w)) / max(abs(float(w)), 1e-30))
        elif g.dtype == torch.bfloat16:
            rel = max(rel, bf16_excess(g, w))
        else:
            rel = max(rel, float((g - w).abs().max()) / max(1.0, float(w.abs().max())))
    bitwise = all(torch.equal(a, b) for a, b in zip(first, again))
    finite = all(bool(torch.isfinite(g).all()) for g in first)
    rec = dict(case=label, max_rel_err=rel, rsq_rel_err=rsq_rel, bitwise=bitwise, finite=finite)
    if not (finite and bitwise and rel <= tol and rsq_rel <= tol):
        fail(f"{label}: the kernel disagrees with its plain version or with itself: {rec}")
    return rec


# E1 and H1 held at ragged sizes: n = 2 (one block), 32 and 130 (one band,
# ragged strips), 2048 and 4096 (E1: 17 bands of 250 columns, a ragged last
# band and strip); H1 also at odd n and 96.  Up to E1_ONE_PASS_MAX_N /
# H1_ONE_PASS_MAX_N the wrappers launch the one-pass tiles; there both
# designs are held, the row-streaming one by setting the threshold below n.
E1_SIZES, H1_SIZES = (2, 32, 130, 2048, N_MAIN), (2, 3, 32, 96, 130, N_MAIN)


def designs(module, name: str, n: int):
    """Whether to force row streaming, for each design of ``module``'s kernel
    to hold at size n: False (the design its wrapper launches) and, where n
    is at most ``module.<name>`` (its one-pass threshold, a number or one
    per chain depth), True, with every threshold set below n while the
    caller's loop runs it."""
    saved = getattr(module, name)
    yield False
    if n <= (max(saved.values()) if isinstance(saved, dict) else saved):
        setattr(module, name, {k: -1 for k in saved} if isinstance(saved, dict) else -1)
        try:
            yield True
        finally:
            setattr(module, name, saved)


def check_e1_variants() -> list:
    """E1 against its plain version at each n of E1_SIZES, in each design the
    size takes (``designs``), with the L = 1 and L = 3 nets, homogeneous,
    bi-material and bi-material in difference form, each with the ring kept
    (BCMODE 0), reset to 0.7 (1) and to a standard normal boundary field (2);
    two launches bitwise equal.  One record per case."""
    import torch
    from multigrid_feanet_torch.ops import hrelax as hx

    nets = {L: load_params(ckpt) for L, ckpt in ((1, HNET_L1), (3, HNET_ITER))}
    recs = []
    for n in E1_SIZES:
        bcf = torch.as_tensor(np.random.default_rng(n).standard_normal((n + 1, n + 1)).astype(
            np.float32), device=DEVICE)
        inputs = {bim: level_inputs(n, bim, 15, ring=0.3) for bim in (False, True)}
        for forced in designs(hx, "E1_ONE_PASS_MAX_N", n):
            for bim, dform in ((False, False), (True, False), (True, True)):
                u, f, _, ph = inputs[bim]
                for L, params in nets.items():
                    tile = not forced and n <= hx.E1_ONE_PASS_MAX_N[L]
                    design = "one-pass" if tile else "row-streaming"
                    for mode, bc in ((0, None), (1, 0.7), (2, bcf)):
                        cfg = dict(a0=1.0, da=19.0 if bim else 0.0, omega=2.0 / 3.0,
                                   dform=dform, bc=bc)
                        ws = {}
                        label = (f"E1 {design} n={n} {'bim' if bim else 'hom'}"
                                 f"{' dform' if dform else ''} L={L} bcmode={mode}")
                        recs.append(hold_twice(
                            label, lambda: hx.hrelax_cuda(u, f, ph, params, workspace=ws, **cfg),
                            lambda: hx.hrelax_plain(u, f, ph, params, **cfg), hx.TOL))
    return recs


def check_h1_variants() -> list:
    """H1 against its plain version (both norms) on standard normal n x n
    torus fields at each n of H1_SIZES, in each design the size takes
    (``designs``); two launches bitwise equal.  One record per case."""
    import torch
    from multigrid_feanet_torch.ops import torus as tt
    from multigrid_feanet_torch.ops.sweep import TOL

    recs = []
    for n in H1_SIZES:
        rng = np.random.default_rng(n)
        u, f = (torch.as_tensor(rng.standard_normal((n, n)).astype(np.float32), device=DEVICE)
                for _ in range(2))
        cfg = dict(a0=1.0, omega=2.0 / 3.0)
        for forced in designs(tt, "H1_ONE_PASS_MAX_N", n):
            design = "one-pass" if not forced and n <= tt.H1_ONE_PASS_MAX_N else "row-streaming"
            ws = {}
            recs.append(hold_twice(f"H1 {design} n={n}",
                                   lambda: tt.torus_sweep_cuda(u, f, workspace=ws, **cfg),
                                   lambda: tt.torus_sweep_plain(u, f, **cfg), TOL))
    return recs


def ragged_sizes(*thresholds) -> tuple:
    """F1's, A6's, C1's, E2's, E3's, E5's and D2's ragged sizes: n = 2 (one
    block), 126 (one band, ragged strips), each side of each one-pass
    threshold, 1000 (ragged bands and strips) and 4096 (17 bands, a ragged
    last band and strip)."""
    return tuple(sorted({2, N_ODD, 1000, N_MAIN, *thresholds,
                         *(t + 2 for t in thresholds)}))


def check_f1_variants() -> list:
    """F1 against its plain version on standard normal u and f (and the
    circle's (1, 20) Q in bf16 and f32) at each size of ``ragged_sizes``, in
    each design the size takes (``designs``); two launches bitwise equal.
    One record per case."""
    import torch
    from multigrid_feanet_torch.core.geometry import circle_phase
    from multigrid_feanet_torch.ops import qsweep as qs

    recs = []
    for n in ragged_sizes(qs.F1_ONE_PASS_MAX_N):
        rng = np.random.default_rng(n)
        u, f = (torch.as_tensor(rng.standard_normal((n + 1, n + 1)).astype(np.float32),
                                device=DEVICE) for _ in range(2))
        qs_by = {dt: qs.make_q(circle_phase(2.0, n), dtype=dt, device=DEVICE)
                 for dt in (torch.bfloat16, torch.float32)}
        for forced in designs(qs, "F1_ONE_PASS_MAX_N", n):
            design = "one-pass" if not forced and n <= qs.F1_ONE_PASS_MAX_N else "row-streaming"
            for dt, q in qs_by.items():
                recs.append(hold_twice(
                    f"F1 {design} n={n} q={str(dt).removeprefix('torch.')}",
                    lambda: (qs.qsweep_cuda(u, f, q, omega=2.0 / 3.0),),
                    lambda: (qs.qsweep_plain(u, f, q, omega=2.0 / 3.0),), qs.TOL))
    return recs


def check_a6_variants() -> list:
    """A6 against its plain version on standard normal u1 (boundary ring
    0.7), f and uc at each size of ``ragged_sizes``, in each design the
    size takes (``designs``): bi-material and homogeneous, plain (FORM 0),
    difference (1) and mass form (2: the heat level's operands), f32 and
    bf16 storage; two launches bitwise equal.  One record per case."""
    import torch
    from multigrid_feanet_torch.core.geometry import circle_phase
    from multigrid_feanet_torch.ops import sweep as sw

    heat = (HEAT_THETA * HEAT_DT, 20.0 * HEAT_THETA * HEAT_DT)
    recs = []
    for n in ragged_sizes(sw.A6_ONE_PASS_MAX_N) + (16,):
        rng = np.random.default_rng(n)
        H, Hc = n + 1, n // 2 + 1
        u1 = rng.standard_normal((H, H)).astype(np.float32)
        u1[[0, -1], :] = u1[:, [0, -1]] = 0.7
        fields = {torch.float32: [torch.as_tensor(x, device=DEVICE) for x in (
            u1, rng.standard_normal((H, H)).astype(np.float32),
            rng.standard_normal((Hc, Hc)).astype(np.float32))]}
        fields[torch.bfloat16] = [x.to(torch.bfloat16) for x in fields[torch.float32]]
        ph = torch.as_tensor(circle_phase(2.0, n), device=DEVICE)
        mass = level_mass(n)
        for forced in designs(sw, "A6_ONE_PASS_MAX_N", n):
            design = "one-pass" if not forced and n <= sw.A6_ONE_PASS_MAX_N else "row-streaming"
            for dt, (u, f, uc) in fields.items():
                for bim in (False, True):
                    for form in (0, 1, 2):
                        coef = heat if form == 2 else (1.0, 20.0)
                        cfg = dict(a0=coef[0], da=coef[1] - coef[0] if bim else 0.0,
                                   omega=2.0 / 3.0, dform=form == 1,
                                   mass=mass if form == 2 else None)
                        p, ws = ph if bim else None, {}
                        recs.append(hold_twice(
                            f"A6 {design} n={n} {'bim' if bim else 'hom'} form={form} "
                            f"{str(dt).removeprefix('torch.')}",
                            lambda: sw.pswrr_cuda(u, f, p, uc, workspace=ws, **cfg),
                            lambda: sw.pswrr_plain(u, f, p, uc, **cfg), sw.TOL))
    return recs


def check_c1_variants() -> list:
    """C1 against its plain version on standard normal u and f (and the
    circle's pattern ids) at each size of ``ragged_sizes``, in each design
    the size takes (``designs``): homogeneous and bi-material, sweep and
    residual mode; two launches bitwise equal.  One record per case."""
    import torch
    from multigrid_feanet_torch.core.geometry import circle_phase
    from multigrid_feanet_torch.ops import stencil as tst
    from multigrid_feanet_torch.ops import stencil_sweep as ss
    from multigrid_feanet_torch.ops.sweep import TOL

    recs = []
    for n in ragged_sizes(ss.C1_ONE_PASS_MAX_N):
        rng = np.random.default_rng(n)
        u, f = (torch.as_tensor(rng.standard_normal((n + 1, n + 1)).astype(np.float32),
                                device=DEVICE) for _ in range(2))
        pid = torch.as_tensor(tst.pattern_ids_np(circle_phase(2.0, n)), device=DEVICE)
        for forced in designs(ss, "C1_ONE_PASS_MAX_N", n):
            design = "one-pass" if not forced and n <= ss.C1_ONE_PASS_MAX_N else "row-streaming"
            for bim in (False, True):
                p = pid if bim else None
                cfg = dict(a0=1.0, da=19.0 if bim else 0.0, omega=2.0 / 3.0)
                for mode in ("sweep", "residual"):
                    ws = {}
                    recs.append(hold_twice(
                        f"C1 {design} n={n} {'bim' if bim else 'hom'} {mode}",
                        lambda: ss.relax_cuda(u, f, p, mode=mode, workspace=ws, **cfg),
                        lambda: ss.relax_plain(u, f, p, mode=mode, **cfg), TOL))
    return recs


def check_e2_variants() -> list:
    """E2 against its plain version at n = 2, 126, each side of each
    ``ops.hrelax.E2_ONE_PASS_MAX_N`` threshold, 1000 and 4096, in each
    design the size takes (``designs``), with the L = 1 and L = 3 nets,
    homogeneous and bi-material, plain and difference form, on u of the
    main path's scale (boundary ring 0.3) and standard normal f; two
    launches bitwise equal.  One record per case."""
    from multigrid_feanet_torch.ops import hrelax as hx

    nets = {L: load_params(ckpt) for L, ckpt in ((1, HNET_L1), (3, HNET_L3))}
    recs = []
    for n in ragged_sizes(*hx.E2_ONE_PASS_MAX_N.values()):
        inputs = {bim: level_inputs(n, bim, 16, ring=0.3) for bim in (False, True)}
        for forced in designs(hx, "E2_ONE_PASS_MAX_N", n):
            for bim in (False, True):
                u, f, _, ph = inputs[bim]
                for dform in (False, True):
                    for L, params in nets.items():
                        tile = not forced and n <= hx.E2_ONE_PASS_MAX_N[L]
                        cfg = dict(a0=1.0, da=19.0 if bim else 0.0, omega=2.0 / 3.0,
                                   dform=dform)
                        ws = {}
                        label = (f"E2 {'one-pass' if tile else 'row-streaming'} n={n} "
                                 f"{'bim' if bim else 'hom'}{' dform' if dform else ''} L={L}")
                        recs.append(hold_twice(
                            label, lambda: hx.hswrr_cuda(u, f, ph, params, workspace=ws, **cfg),
                            lambda: hx.hswrr_plain(u, f, ph, params, **cfg), hx.TOL))
    return recs


def check_ascent_variants(leg: str) -> list:
    """E3 (``leg`` "E3") or E5 ("E5") against its plain version at n = 2,
    126, each side of each ``ops.hrelax.E3_ONE_PASS_MAX_N`` /
    ``E5_ONE_PASS_MAX_N`` threshold, 1000 and 4096, in each design the size
    takes (``designs``), with the L = 1 and L = 3 nets, homogeneous and
    bi-material, plain and difference form, on u1 of the main path's scale
    (boundary ring 0.3; E3), standard normal f and uc; two launches bitwise
    equal.  One record per case."""
    from multigrid_feanet_torch.ops import hrelax as hx

    name = f"{leg}_ONE_PASS_MAX_N"
    nets = {L: load_params(ckpt) for L, ckpt in ((1, HNET_L1), (3, HNET_L3))}
    recs = []
    for n in ragged_sizes(*getattr(hx, name).values()):
        inputs = {bim: level_inputs(n, bim, 17, ring=0.3) for bim in (False, True)}
        for forced in designs(hx, name, n):
            for bim in (False, True):
                u, f, uc, ph = inputs[bim]
                for dform in (False, True):
                    for L, params in nets.items():
                        tile = not forced and n <= getattr(hx, name)[L]
                        cfg = dict(a0=1.0, da=19.0 if bim else 0.0, omega=2.0 / 3.0,
                                   dform=dform)
                        label = (f"{leg} {'one-pass' if tile else 'row-streaming'} n={n} "
                                 f"{'bim' if bim else 'hom'}{' dform' if dform else ''} L={L}")
                        if leg == "E3":
                            kernel = lambda: (hx.phrelax_cuda(u, f, ph, uc, params, **cfg),)
                            plain = lambda: (hx.phrelax_plain(u, f, ph, uc, params, **cfg),)
                        else:
                            kernel = lambda: (hx.zphrelax_cuda(f, ph, uc, params, **cfg),)
                            plain = lambda: (hx.zphrelax_plain(f, ph, uc, params, **cfg),)
                        recs.append(hold_twice(label, kernel, plain, hx.TOL))
    return recs


def check_e3_variants() -> list:
    """E3 at its ragged sizes in both designs (``check_ascent_variants``)."""
    return check_ascent_variants("E3")


def check_e5_variants() -> list:
    """E5 at its ragged sizes in both designs (``check_ascent_variants``)."""
    return check_ascent_variants("E5")


def check_e4_variants() -> list:
    """E4 against its plain version at n = 2, 126, each side of each
    ``ops.hrelax.E4_ONE_PASS_MAX_N`` threshold, 1000, 2048 and 4096, in
    each design the size takes (``designs``), with the L = 1 and L = 3
    nets, homogeneous and bi-material, plain and difference form, on
    standard normal f; two launches bitwise equal.  One record per case."""
    from multigrid_feanet_torch.ops import hrelax as hx

    nets = {L: load_params(ckpt) for L, ckpt in ((1, HNET_L1), (3, HNET_L3))}
    recs = []
    for n in sorted(set(ragged_sizes(*hx.E4_ONE_PASS_MAX_N.values())) | {N_MAIN // 2}):
        inputs = {bim: level_inputs(n, bim, 20) for bim in (False, True)}
        for forced in designs(hx, "E4_ONE_PASS_MAX_N", n):
            for bim in (False, True):
                _, f, _, ph = inputs[bim]
                for dform in (False, True):
                    for L, params in nets.items():
                        tile = not forced and n <= hx.E4_ONE_PASS_MAX_N[L]
                        cfg = dict(a0=1.0, da=19.0 if bim else 0.0, omega=2.0 / 3.0,
                                   dform=dform)
                        label = (f"E4 {'one-pass' if tile else 'row-streaming'} n={n} "
                                 f"{'bim' if bim else 'hom'}{' dform' if dform else ''} L={L}")
                        recs.append(hold_twice(
                            label, lambda: (hx.zhswrr_cuda(f, ph, params, **cfg),),
                            lambda: (hx.zhswrr_plain(f, ph, params, **cfg),), hx.TOL))
    return recs


def check_c2_variants() -> list:
    """C2 against its plain version on standard normal u and f (and the
    circle's pattern ids) at each size of ``ragged_sizes`` for its
    thresholds, in each design the size takes (``designs``): homogeneous and
    bi-material, k = 1 .. 4 (streamed above ``C2_ONE_PASS_MAX_N[(bim, k)]``) and
    k = 8 (the one-pass tile at every size); two launches bitwise equal.
    One record per case."""
    import torch
    from multigrid_feanet_torch.core.geometry import circle_phase
    from multigrid_feanet_torch.ops import stencil as tst
    from multigrid_feanet_torch.ops import stencil_sweep as ss
    from multigrid_feanet_torch.ops.sweep import TOL

    recs = []
    for n in ragged_sizes(*ss.C2_ONE_PASS_MAX_N.values()):
        rng = np.random.default_rng(n)
        u, f = (torch.as_tensor(rng.standard_normal((n + 1, n + 1)).astype(np.float32),
                                device=DEVICE) for _ in range(2))
        pid = torch.as_tensor(tst.pattern_ids_np(circle_phase(2.0, n)), device=DEVICE)
        for forced in designs(ss, "C2_ONE_PASS_MAX_N", n):
            for k in (1, 2, 3, 4, ss.MAX_FUSED):
                for bim in (False, True):
                    tile = k > ss.C2_STREAM_MAX_K or (
                        not forced and n <= ss.C2_ONE_PASS_MAX_N[(bim, k)])
                    if forced and tile:
                        continue
                    p = pid if bim else None
                    cfg = dict(a0=1.0, da=19.0 if bim else 0.0, omega=2.0 / 3.0, k=k)
                    ws = {}
                    recs.append(hold_twice(
                        f"C2 {'one-pass' if tile else 'row-streaming'} n={n} "
                        f"{'bim' if bim else 'hom'} k={k}",
                        lambda: ss.multi_cuda(u, f, p, workspace=ws, **cfg),
                        lambda: ss.multi_plain(u, f, p, **cfg), TOL))
    return recs


def check_d2_variants() -> list:
    """D2 against its plain version at n = 2, 126, each side of
    ``ops.general.D2_ONE_PASS_MAX_N``, 1000 and 4096, in each design the
    size takes (``designs``), on the bi-material phase, the zero phase
    (homogeneous) and a general 9-plane operator (the homogeneous Q1
    stencil, each plane scaled per node by 1 + U(-0.1, 0.1)), with W4
    planes U(0, 1), in f32 and bf16 planes; u of the main path's scale
    (boundary ring 0.3), f standard normal; two launches bitwise equal.  One
    record per case."""
    import torch
    from multigrid_feanet_torch.ops import general as gen

    q1 = np.array([-1, -1, -1, -1, 8, -1, -1, -1, -1], np.float32) / 3.0
    recs = []
    for n in ragged_sizes(gen.D2_ONE_PASS_MAX_N):
        H = n + 1
        u, f, _, ph = level_inputs(n, True, 18, ring=0.3)
        rng = np.random.default_rng(19)
        s9 = (q1[:, None, None] * (1.0 + 0.1 * rng.uniform(-1, 1, (9, H, H)))).astype(np.float32)
        w4 = rng.uniform(0, 1, (4, H, H)).astype(np.float32)
        s9, w4 = (torch.as_tensor(x, device=DEVICE) for x in (s9, w4))
        ops = {"bim": (ph, 19.0), "hom": (torch.zeros_like(ph), 0.0)}
        for forced in designs(gen, "D2_ONE_PASS_MAX_N", n):
            tile = not forced and n <= gen.D2_ONE_PASS_MAX_N
            for dt in (torch.float32, torch.bfloat16):
                w = w4.to(dt)
                cases = dict(ops, general=(s9.to(dt), 0.0))
                for form, (op, da) in cases.items():
                    cfg = dict(a0=1.0, da=da, omega=2.0 / 3.0)
                    ws = {}
                    label = (f"D2 {'one-pass' if tile else 'row-streaming'} n={n} {form} "
                             f"{str(dt).removeprefix('torch.')}")
                    recs.append(hold_twice(
                        label, lambda: gen.gswrr_cuda(u, f, op, w, workspace=ws, **cfg),
                        lambda: gen.gswrr_plain(u, f, op, w, **cfg), gen.TOL))
    return recs


def check_g2_variants() -> list:
    """G2 against its plain version at n = 2, 126, each side of each
    ``ops.elastic.G2_ONE_PASS_MAX_N`` threshold, 1000 and 2048 (the elastic
    cells' level 0), in each design the size takes (``designs``), bi-material and
    homogeneous, on the plane-stress operator of the elastic cells; u, f
    standard normal with two different components; two launches bitwise
    equal.  One record per case."""
    import torch
    from multigrid_feanet_torch.core.geometry import circle_phase
    from multigrid_feanet_torch.ops import elastic as eg
    from multigrid_feanet_torch.ops.elasticity import elastic_factor_constants

    consts = elastic_factor_constants(E_EL, NU_EL)
    recs = []
    limits = eg.G2_ONE_PASS_MAX_N.values()
    sizes = tuple(sorted({2, N_ODD, 1000, N_EL, *limits, *(t + 2 for t in limits)}))
    for n in sizes:
        rng = np.random.default_rng(20)
        H = n + 1
        geo = np.zeros((H, H), np.float32)
        geo[1:-1, 1:-1] = 1.0
        u = torch.as_tensor(rng.standard_normal((2, H, H)).astype(np.float32) * geo,
                            device=DEVICE)
        f = torch.as_tensor(rng.standard_normal((2, H, H)).astype(np.float32), device=DEVICE)
        phases = {"bim": torch.as_tensor(circle_phase(2.0, n), device=DEVICE), "hom": None}
        for forced in designs(eg, "G2_ONE_PASS_MAX_N", n):
            for form, ph in phases.items():
                tile = not forced and n <= eg.G2_ONE_PASS_MAX_N[ph is not None]
                cfg = dict(a0=1.0, da=19.0 if ph is not None else 0.0, omega=2.0 / 3.0,
                           consts=consts)
                ws = {}
                label = f"G2 {'one-pass' if tile else 'row-streaming'} n={n} {form}"
                recs.append(hold_twice(
                    label, lambda: eg.el_swrr_cuda(u, f, ph, workspace=ws, **cfg),
                    lambda: eg.el_swrr_plain(u, f, ph, **cfg), eg.TOL))
    return recs


def el_variant_inputs(n: int, seed: int):
    """The G1 and G5 variant checks' inputs at size n: u standard normal
    with two different components and a nonzero boundary ring (0.7 and
    -0.3, the values a sweep keeps), f and uc standard normal, the circle's
    phase map; on the card."""
    import torch
    from multigrid_feanet_torch.core.geometry import circle_phase

    rng = np.random.default_rng(seed)
    H, Hc = n + 1, n // 2 + 1
    geo = np.zeros((H, H), np.float32)
    geo[1:-1, 1:-1] = 1.0
    u = rng.standard_normal((2, H, H)).astype(np.float32) * geo
    u[0] += np.float32(0.7) * (1 - geo)
    u[1] -= np.float32(0.3) * (1 - geo)
    f = rng.standard_normal((2, H, H)).astype(np.float32)
    uc = rng.standard_normal((2, Hc, Hc)).astype(np.float32)
    return (*(torch.as_tensor(x, device=DEVICE) for x in (u, f, uc)),
            torch.as_tensor(circle_phase(2.0, n), device=DEVICE))


def el_variant_sizes(limits) -> tuple:
    """G1's and G5's sizes: n = 2, 126, each side of each one-pass threshold,
    1000, 2048 (the elastic cells' level 0) and 4096."""
    return tuple(sorted({2, N_ODD, 1000, N_EL, N_MAIN, *limits, *(t + 2 for t in limits)}))


def check_g1_variants() -> list:
    """G1 against its plain version in sweep and residual mode at each size
    of ``el_variant_sizes``, in each design the size takes (``designs``),
    bi-material and homogeneous, on the plane-stress operator of the elastic
    cells (``el_variant_inputs``); two launches bitwise equal.  One record
    per case."""
    from multigrid_feanet_torch.ops import elastic as eg
    from multigrid_feanet_torch.ops.elasticity import elastic_factor_constants

    consts = elastic_factor_constants(E_EL, NU_EL)
    recs = []
    for n in el_variant_sizes(eg.G1_ONE_PASS_MAX_N.values()):
        u, f, _, ph_bim = el_variant_inputs(n, 21)
        for forced in designs(eg, "G1_ONE_PASS_MAX_N", n):
            for form, ph in (("bim", ph_bim), ("hom", None)):
                tile = not forced and n <= eg.G1_ONE_PASS_MAX_N[ph is not None]
                for mode in ("sweep", "residual"):
                    cfg = dict(a0=1.0, da=19.0 if ph is not None else 0.0, omega=2.0 / 3.0,
                               consts=consts, mode=mode)
                    ws = {}
                    label = f"G1 {'one-pass' if tile else 'row-streaming'} n={n} {form} {mode}"
                    recs.append(hold_twice(
                        label, lambda: eg.el_sweep_cuda(u, f, ph, workspace=ws, **cfg),
                        lambda: eg.el_sweep_plain(u, f, ph, **cfg), eg.TOL))
    return recs


def check_g5_variants() -> list:
    """G5 against its plain version at each size of ``el_variant_sizes``, in
    each design the size takes (``designs``), bi-material and homogeneous
    (``el_variant_inputs``' f and uc); two launches bitwise equal.  One
    record per case."""
    from multigrid_feanet_torch.ops import elastic as eg
    from multigrid_feanet_torch.ops.elasticity import elastic_factor_constants

    consts = elastic_factor_constants(E_EL, NU_EL)
    recs = []
    for n in el_variant_sizes(eg.G5_ONE_PASS_MAX_N.values()):
        _, f, uc, ph_bim = el_variant_inputs(n, 22)
        for forced in designs(eg, "G5_ONE_PASS_MAX_N", n):
            for form, ph in (("bim", ph_bim), ("hom", None)):
                tile = not forced and n <= eg.G5_ONE_PASS_MAX_N[ph is not None]
                cfg = dict(a0=1.0, da=19.0 if ph is not None else 0.0, omega=2.0 / 3.0,
                           consts=consts)
                label = f"G5 {'one-pass' if tile else 'row-streaming'} n={n} {form}"
                recs.append(hold_twice(
                    label, lambda: (eg.el_zpsweep_cuda(f, ph, uc, **cfg),),
                    lambda: (eg.el_zpsweep_plain(f, ph, uc, **cfg),), eg.TOL))
    return recs


def check_g4_variants() -> list:
    """G4 against its plain version at each size of ``el_variant_sizes`` and
    at 1024 (its largest level on the elastic path), in each design the
    size takes (``designs``), bi-material and homogeneous
    (``el_variant_inputs``' f, whose boundary ring G4 reads for u1's
    neighbours' residuals); two launches bitwise equal.  One record per
    case."""
    from multigrid_feanet_torch.ops import elastic as eg
    from multigrid_feanet_torch.ops.elasticity import elastic_factor_constants

    consts = elastic_factor_constants(E_EL, NU_EL)
    recs = []
    for n in sorted({N_EL // 2, *el_variant_sizes(eg.G4_ONE_PASS_MAX_N.values())}):
        _, f, _, ph_bim = el_variant_inputs(n, 23)
        for forced in designs(eg, "G4_ONE_PASS_MAX_N", n):
            for form, ph in (("bim", ph_bim), ("hom", None)):
                tile = not forced and n <= eg.G4_ONE_PASS_MAX_N[ph is not None]
                cfg = dict(a0=1.0, da=19.0 if ph is not None else 0.0, omega=2.0 / 3.0,
                           consts=consts)
                label = f"G4 {'one-pass' if tile else 'row-streaming'} n={n} {form}"
                recs.append(hold_twice(
                    label, lambda: (eg.el_zrr_cuda(f, ph, **cfg),),
                    lambda: (eg.el_zrr_plain(f, ph, **cfg),), eg.TOL))
    return recs


def check_a5_variants() -> list:
    """A5 against its plain version (f_c and the norm) on standard normal u
    (boundary ring 0.7) and f at each size of ``ragged_sizes``, 16, 1024 and
    2048, in each design the size takes (``designs``): bi-material and
    homogeneous, plain (FORM 0), difference (1) and mass form (2: the heat
    level's operands), f32 and bf16 storage; two launches bitwise equal.
    One record per case."""
    import torch
    from multigrid_feanet_torch.core.geometry import circle_phase
    from multigrid_feanet_torch.ops import sweep as sw

    heat = (HEAT_THETA * HEAT_DT, 20.0 * HEAT_THETA * HEAT_DT)
    recs = []
    sizes = {16, N_MAIN // 4, N_MAIN // 2, *ragged_sizes(*sw.A5_ONE_PASS_MAX_N.values())}
    for n in sorted(sizes):
        rng = np.random.default_rng(n + 5)
        H = n + 1
        u = rng.standard_normal((H, H)).astype(np.float32)
        u[[0, -1], :] = u[:, [0, -1]] = 0.7
        fields = {torch.float32: [torch.as_tensor(x, device=DEVICE) for x in (
            u, rng.standard_normal((H, H)).astype(np.float32))]}
        fields[torch.bfloat16] = [x.to(torch.bfloat16) for x in fields[torch.float32]]
        ph = torch.as_tensor(circle_phase(2.0, n), device=DEVICE)
        mass = level_mass(n)
        for forced in designs(sw, "A5_ONE_PASS_MAX_N", n):
            for dt, (uu, f) in fields.items():
                for bim in (False, True):
                    tile = not forced and n <= sw.A5_ONE_PASS_MAX_N[bim]
                    design = "one-pass" if tile else "row-streaming"
                    for form in (0, 1, 2):
                        coef = heat if form == 2 else (1.0, 20.0)
                        cfg = dict(a0=coef[0], da=coef[1] - coef[0] if bim else 0.0,
                                   dform=form == 1, mass=mass if form == 2 else None)
                        p, ws = ph if bim else None, {}
                        recs.append(hold_twice(
                            f"A5 {design} n={n} {'bim' if bim else 'hom'} form={form} "
                            f"{str(dt).removeprefix('torch.')}",
                            lambda: sw.rr_cuda(uu, f, p, workspace=ws, **cfg),
                            lambda: sw.rr_plain(uu, f, p, **cfg), sw.TOL))
    return recs


def check_f1(n: int, q_dtype, seed: int = 14):
    """Hold F1 against its plain version on the circle's (1, 20) Q stream
    in ``q_dtype``; also its largest difference from A1's plain-form sweep
    on the same inputs.  One record."""
    import torch
    from multigrid_feanet_torch.core.geometry import circle_phase
    from multigrid_feanet_torch.ops import qsweep as qs
    from multigrid_feanet_torch.ops import sweep as sw

    u, f, _, ph = level_inputs(n, True, seed)
    q = qs.make_q(circle_phase(2.0, n), dtype=q_dtype, device=DEVICE)
    rec = hold("F1", lambda fn, x, kw: fn(x[0], x[1], x[2], **kw), qs.qsweep_cuda,
               qs.qsweep_plain, (u, f, q), dict(omega=2.0 / 3.0),
               4 * 3 * (n + 1) ** 2 + q.element_size() * n * n, qs.TOL,
               dict(n=n, q_dtype=str(q_dtype).removeprefix("torch.")))
    a1, _ = sw.sweep_cuda(u, f, ph, None, a0=1.0, da=19.0, omega=2.0 / 3.0, dform=False)
    rec["a1_max_abs_diff"] = float((qs.qsweep_cuda(u, f, q, omega=2.0 / 3.0) - a1).abs().max())
    return rec


def check_membench(n: int = N_MAIN):
    """Hold B1 and B2 against their plain versions, bitwise, on standard
    normal (n+1)^2 fields; ``library_ms`` is the one PyTorch call that
    computes the same function (torch.add), timed as the kernel.  Two
    records."""
    import torch
    from multigrid_feanet_torch.ops import membench as mb

    gen = torch.Generator().manual_seed(15)
    a, b = (torch.randn((n + 1, n + 1), generator=gen).to(DEVICE) for _ in range(2))
    out = torch.empty_like(a)
    recs = [hold("B1", lambda fn, x, kw: fn(x[0], **kw), mb.copy_cuda, mb.copy_plain, (a,), {},
                 8 * (n + 1) ** 2, 0.0, dict(n=n)),
            hold("B2", lambda fn, x, kw: fn(x[0], x[1], **kw), mb.triad_cuda, mb.triad_plain,
                 (a, b), {}, 12 * (n + 1) ** 2, 0.0, dict(n=n))]
    recs[0]["library_ms"] = kernel_ms([lambda: torch.add(a, 1.0, out=out)])
    recs[1]["library_ms"] = kernel_ms([lambda: torch.add(a, b, alpha=0.5, out=out)])
    return recs


def run_membench_cell(b_checks, a1_sweep: dict) -> dict:
    """``membench_4097`` (bench.py:416-421): copy and triad GB/s at 4097^2
    f32 (each field 67.1 MB, above the 50 MB L2), the torch.add rates beside
    them, and the A1 plain-form sweep's share of the triad rate
    (bench.py's sweep_stream_fraction_of_triad: the time the triad rate
    needs for the sweep's 12 B/node over the sweep's time)."""
    from multigrid_feanet_torch.ops import membench as mb

    H2 = (N_MAIN + 1) ** 2
    (copy, triad), launches = counted(lambda: (mb.copy_gbps(), mb.triad_gbps()))
    lib = {r["name"]: r["library_ms"] for r in b_checks}
    sweep_s = a1_sweep["ms"] / 1e3
    rec = dict(solve="membench_4097", n=N_MAIN, copy_gbps=copy, triad_gbps=triad,
               torch_add_copy_gbps=8 * H2 / (lib["B1"] / 1e3) / 1e9,
               torch_add_triad_gbps=12 * H2 / (lib["B2"] / 1e3) / 1e9,
               sweep_ms=a1_sweep["ms"],
               sweep_stream_fraction_of_triad=(12 * H2 / (triad * 1e9)) / sweep_s,
               sweep_vs_copy_peak=(13 * H2 / sweep_s / 1e9) / copy, launches=launches)
    print(json.dumps(rec), flush=True)
    if not (np.isfinite(copy) and np.isfinite(triad) and copy > 0 and triad > 0):
        fail(f"membench_4097: rates {copy}, {triad}")
    if not (launches.get("B1") and launches.get("B2")):
        fail(f"membench_4097: a kernel of the path never launched: {launches}")
    return rec


def run_qsweep_cell() -> dict:
    """``qsweep_4097`` (bench.py:102-118): 512 F1 sweeps (two chunks of 256,
    a synchronize after each) at 4097^2 on the circle's bf16 (1, 20) Q
    stream, from phase 2's u and bench_f; exactly 512 F1 launches, and the
    last iterate equal to 512 A1 plain-form sweeps from the same start to
    TOL."""
    import torch
    from multigrid_feanet_torch.core.geometry import circle_phase
    from multigrid_feanet_torch.ops import qsweep as qs
    from multigrid_feanet_torch.ops.sweep import TOL, SweepLevel

    n, sweeps = N_MAIN, 512
    u0, _, _, ph = level_inputs(n, True, 1)
    f = torch.as_tensor(bench_f(n), device=DEVICE)
    q = qs.make_q(circle_phase(2.0, n), device=DEVICE)
    level = SweepLevel(n, phase=ph, dform=False, device=DEVICE)
    bufs = [torch.empty_like(u0) for _ in range(2)]

    def run(sweep=lambda u, out: qs.qsweep(level, u, f, q, out=out)):
        u = u0
        for chunk in range(2):
            for s in range(sweeps // 2):
                u = sweep(u, bufs[s % 2])
            torch.cuda.synchronize()
        return u.clone(), None

    (u, _), launches = counted(run)
    if launches != {"F1": sweeps} or not torch.isfinite(u).all():
        fail(f"qsweep_4097: launches {launches}, finite {bool(torch.isfinite(u).all())}")
    ua, _ = run(lambda u, out: level.sweep(u, f, out=out)[0])
    err = float((u - ua).abs().max()) / max(1.0, float(ua.abs().max()))
    if err > TOL:
        fail(f"qsweep_4097: F1's iterate departs from A1's by {err}")
    walls = []
    for _ in range(3):
        t0 = time.time()
        run()
        walls.append(time.time() - t0)
    wall = min(walls)
    rec = dict(solve="qsweep_4097", n=n, sweeps=sweeps, q_dtype="bfloat16", wall_s=wall,
               walls_s=walls, ms_per_sweep=1e3 * wall / sweeps, rel_err_vs_a1=err,
               launches=launches, profile=profile_solve(run, sweeps, wall))
    print(json.dumps(rec), flush=True)
    return rec


def run_hjac_cell() -> dict:
    """``hjac_4097``: 256 h_relax sweeps on E1 at 4097^2 homogeneous with
    the L = 3 net of results/learn_iterator/hnet.npz, from the f = 0 decay
    start; exactly 256 E1 launches, a finite iterate whose residual fell."""
    import torch
    from multigrid_feanet_torch.core.problem import Problem, build_level
    from multigrid_feanet_torch.models import hnet
    from multigrid_feanet_torch.solvers.jacobi import interior_norm

    n, sweeps = N_MAIN, 256
    lv = build_level(Problem(n=n), n, device=DEVICE)
    params = load_params(HNET_ITER)
    u0, f = decay_start(lv)

    def run():
        return hnet.h_relax(lv, params, u0, f, sweeps), None

    (u, _), launches = counted(run)
    r0, r1 = float(interior_norm(lv.apply(u0))), float(interior_norm(f - lv.apply(u)))
    if launches != {"E1": sweeps} or not torch.isfinite(u).all() or not r1 < r0:
        fail(f"hjac_4097: launches {launches}, residual {r0} -> {r1}")
    walls = []
    for _ in range(3):
        t0 = time.time()
        run()
        torch.cuda.synchronize()
        walls.append(time.time() - t0)
    wall = min(walls)
    rec = dict(solve="hjac_4097", n=n, sweeps=sweeps, L=int(params.shape[0]), wall_s=wall,
               walls_s=walls, ms_per_sweep=1e3 * wall / sweeps, res0=r0, res_last=r1,
               launches=launches, profile=profile_solve(run, sweeps, wall))
    print(json.dumps(rec), flush=True)
    return rec


def run_hjac_iter_cell() -> dict:
    """``hjac_iter_32``, the learned-iterator anchor: a 33^2 sample of the
    port's generate_isopoisson(32, 1, seed=0) (dense f64 solve); plain
    solve_jacobi to 1e-5 against H-Jacobi on E1 with hnet.npz from u0 = 0
    under the sample's Dirichlet field.  The speedup must be >= 5x
    (tests/test_hnet.py:80) and the CPU's plain path must take the card's
    H-Jacobi count within 2%; the iterate must approach the sample's u to
    5e-4."""
    import torch
    from multigrid_feanet_torch.core.problem import Problem, build_level
    from multigrid_feanet_torch.data.datasets import generate_isopoisson
    from multigrid_feanet_torch.models import hnet
    from multigrid_feanet_torch.ops.stencil import apply_mass
    from multigrid_feanet_torch.solvers.jacobi import interior_norm, solve_jacobi

    n, eps = 32, 1e-5
    u_star, f_raw, bc_value, _ = generate_isopoisson(n, 1, seed=0)[0]

    def problem(dev):
        lv = build_level(Problem(n=n), n, device=dev)
        return lv, apply_mass(torch.as_tensor(f_raw, device=dev), lv.h), torch.as_tensor(
            bc_value, device=dev)

    def hjacobi(dev):
        lv, f, bc = problem(dev)
        params = load_params(HNET_ITER, dev)
        u, k, res = torch.zeros_like(f), 0, float("inf")
        while res > eps and k < 5000:
            u = hnet.h_relax(lv, params, u, f, 1, bc)
            res = float(interior_norm(f - lv.apply(u)))
            k += 1
        return u, k, res

    lv, f, bc = problem(DEVICE)
    _, hist = solve_jacobi(lv, f, bc_value=bc, eps=eps, max_iters=20_000)
    (ug, kg, rg), launches = counted(lambda: hjacobi(DEVICE))
    _, kc, rc = hjacobi("cpu")
    err = float(np.max(np.abs(ug.cpu().numpy() - u_star)))
    rec = dict(solve="hjac_iter_32", n=n, eps=eps, jacobi_iters=len(hist), hjacobi_iters=kg,
               hjacobi_iters_cpu=kc, speedup=len(hist) / kg, res=[rg, rc],
               max_err_vs_sample=err, launches=launches)
    print(json.dumps(rec), flush=True)
    if not (hist[-1] <= eps and rg <= eps and launches == {"E1": kg}):
        fail(f"hjac_iter_32: no convergence or launches off: {rec}")
    if not (len(hist) >= 5 * kg and abs(kg - kc) <= 0.02 * kc and err <= 5e-4):
        fail(f"hjac_iter_32 departs from the learned-iterator anchor: {rec}")
    return rec


def run_measure_q_cells() -> dict:
    """``measure_q_1024`` and ``measure_q_4096``: measure_q with the L = 1
    net, m = 10, H-Jacobi (every relax on E1: 2 per level and cycle) and
    plain V(1,1) cycles on GridHierarchy.create(Problem(n)) (log2 n
    levels, homogeneous); at 1024 within 10% / 5% of the JAX values."""
    from multigrid_feanet_torch.core.problem import GridHierarchy, Problem
    from multigrid_feanet_torch.learn.train_hnet import measure_q

    params = load_params(HNET_L1)
    out = {}
    for n in (1024, N_MAIN):
        hier = GridHierarchy.create(Problem(n=n), device=DEVICE)
        rec = dict(solve=f"measure_q_{n}", n=n, levels=hier.num_levels, m=10)
        for mode in ("hjac", "jac"):
            t0 = time.time()
            (q, rs), launches = counted(lambda: measure_q(hier, params, m=10, mode=mode))
            rec[mode] = dict(q=q, rs=rs.tolist(), wall_s=time.time() - t0, launches=launches)
        expect = {"E1": 2 * hier.num_levels * 10}
        rec["launches"] = rec["hjac"]["launches"]
        print(json.dumps(rec), flush=True)
        if rec["hjac"]["launches"] != expect or rec["jac"]["launches"]:
            fail(f"measure_q_{n}: launches {rec['hjac']['launches']}, {rec['jac']['launches']}")
        if not all(np.all(np.isfinite(rec[m]["rs"])) for m in ("hjac", "jac")):
            fail(f"measure_q_{n}: non-finite residuals")
        if n == 1024 and (abs(rec["hjac"]["q"] / Q_JAX_1024["hjac"] - 1) > 0.10
                          or abs(rec["jac"]["q"] / Q_JAX_1024["jac"] - 1) > 0.05):
            fail(f"measure_q_1024 departs from the JAX q: {rec['hjac']['q']}, {rec['jac']['q']}")
        out[rec["solve"]] = rec
    return out


def run_decay_train() -> dict:
    """``decay_train``: make_decay_step at experiments/train_hnet_decay.py's
    configuration (sizes 64-512, batch 2, m 6, warm 2, L = 1, Adam 3e-3,
    seed 0), 20 steps.  The step differentiates, so no kernel launches; the
    loss (mean log q) must fall by at least 0.2."""
    from multigrid_feanet_torch.core.problem import GridHierarchy, Problem
    from multigrid_feanet_torch.learn.train_hnet import make_decay_step

    hiers = [GridHierarchy.create(Problem(n=n), device=DEVICE) for n in (64, 128, 256, 512)]
    init_fn, step = make_decay_step(hiers, m=6, batch=2, warm=2, learning_rate=3e-3)
    state, losses = init_fn(seed=0, num_layers=1), []

    def run(state=state):
        for _ in range(20):
            state, loss = step(state)
            losses.append(float(loss))
        return state

    t0 = time.time()
    _, launches = counted(run)
    wall = time.time() - t0
    rec = dict(solve="decay_train", sizes=[64, 128, 256, 512], steps=20, s_per_step=wall / 20,
               losses=losses, drop=losses[0] - losses[-1], launches=launches)
    print(json.dumps(rec), flush=True)
    if launches or not np.all(np.isfinite(losses)) or not rec["drop"] >= 0.2:
        fail(f"decay_train: launches {launches}, loss {losses[0]} -> {losses[-1]}")
    return rec


def run_hnet_train_cell() -> dict:
    """``hnet_train_129``: train (L = 3, batch 5, k_max 20) on the port's
    generate_isopoisson(128, 10, seed=0) (the C++ CG oracle, built with g++
    at first use) for 8 epochs; losses[-1] < 0.9 losses[0]
    (tests/test_hnet.py:94's anchor), and a run stopped after 4 epochs and
    resumed from its checkpoint under build/ gives the straight run's
    losses and kernels."""
    import shutil
    from multigrid_feanet_torch.core.problem import Problem, build_level
    from multigrid_feanet_torch.data.datasets import generate_isopoisson
    from multigrid_feanet_torch.learn.train_hnet import train

    t0 = time.time()
    ds = generate_isopoisson(128, 10, seed=0)
    gen_s = time.time() - t0
    lv = build_level(Problem(n=128), 128, device=DEVICE)
    ckpt = ROOT / "build" / "smoke_hnet_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    kw = dict(batch_size=5, seed=0, k_max=20, verbose=False)
    t0 = time.time()
    (p_full, l_full), launches = counted(lambda: train(lv, ds, num_epochs=8, **kw))
    wall = time.time() - t0
    train(lv, ds, num_epochs=4, ckpt_dir=ckpt, **kw)
    p_res, l_res = train(lv, ds, num_epochs=8, ckpt_dir=ckpt, **kw)
    shutil.rmtree(ckpt, ignore_errors=True)
    rec = dict(solve="hnet_train_129", n=128, samples=10, epochs=8, dataset_s=gen_s,
               train_s=wall, losses=l_full.tolist(), losses_resumed=l_res.tolist(),
               ratio=float(l_full[-1] / l_full[0]), launches=launches)
    print(json.dumps(rec), flush=True)
    if launches or not l_full[-1] < 0.9 * l_full[0]:
        fail(f"hnet_train_129: launches {launches}, losses {l_full}")
    if not (np.allclose(l_res, l_full, rtol=1e-5)
            and np.allclose(p_res.cpu().numpy(), p_full.cpu().numpy(), rtol=1e-5, atol=1e-7)):
        fail(f"hnet_train_129: the resumed run departs from the straight run: {l_res}")
    return rec


# ---------------------------------------------------------------------------
# slice 10: bf16 level storage of A1-A6 and the V2 solves
# ---------------------------------------------------------------------------


def check_bf16_kernels() -> list:
    """Hold A1-A6 in bf16 storage against their plain versions: A1 (three
    modes), A2, A5 and A6 at 4097^2 in the bi-material difference form, the
    homogeneous difference form and the bi-material mass form; A3 and A4 at
    2049^2 (bi-material, homogeneous and mass), at the other level sizes of
    the interface solve and at n = 2, 16, 32 and 126; A1 and A2 also at
    n = 2, 16 and 126.  Then all six twice on the same 4097^2 inputs
    (bitwise)."""
    import torch

    bf = torch.bfloat16
    heat = (HEAT_THETA * HEAT_DT, 20.0 * HEAT_THETA * HEAT_DT)
    main = ["A1_sweep", "A1_residual", "A1_psweep", "A2", "A5", "A6"]
    recs = check_kernels(N_MAIN, True, True, main, dtype=bf)
    recs += check_kernels(N_MAIN, False, True, main, dtype=bf)
    recs += check_kernels(N_MAIN, True, False, main, coef=heat, mass=level_mass(N_MAIN), dtype=bf)
    recs += check_kernels(N_MAIN // 2, False, False, ["A3", "A4"], dtype=bf)
    recs += check_kernels(N_MAIN // 2, True, False, ["A3", "A4"], coef=heat,
                          mass=level_mass(N_MAIN // 2), dtype=bf)
    for n in (2, 16, N_ODD) + A34_LEVELS:
        recs += check_kernels(n, True, False, ["A3", "A4"], dtype=bf)
    for n in (2, 16, N_ODD):
        recs += check_kernels(n, True, True, ["A1_sweep", "A1_residual", "A1_psweep", "A2"],
                              dtype=bf)
    print(json.dumps({"bf16_kernel_checks": recs}), flush=True)
    check_repeat(dtype=bf)
    return recs


def bf16_times(recs, f32_recs) -> dict:
    """This run's bf16 times at 4097^2 (A3/A4: each level size), each beside
    its bf16 byte bound and this run's f32 time of the same leg and form."""
    def key(r):
        return (r["name"], r["n"], r["bim"], r["dform"], r["mass"])

    f32 = {key(r): r["ms"] for r in f32_recs if r["name"][0] == "A" and "dtype" not in r}
    rows = {}
    for r in recs:
        if r["n"] not in (N_MAIN,) + A34_LEVELS:
            continue
        form = "mass" if r["mass"] else "dform" if r["dform"] else "plain"
        bound = 1e3 * r["bytes"] / HBM_BYTES_PER_S
        rows[f"{r['name']}_{r['n']}_{'bim' if r['bim'] else 'hom'}_{form}"] = dict(
            ms=r["ms"], bound_ms=bound, of_bound=bound / r["ms"], f32_ms=f32.get(key(r)),
            f32_over_bf16=f32[key(r)] / r["ms"] if key(r) in f32 else None)
    return rows


def run_bench_bf16_sweep(recs, membench: dict) -> dict:
    """bench.py's ``sweep_us_homogeneous_bf16`` row (bench.py:138-145): the
    homogeneous plain-form A1 sweep at 4097^2 in bf16 storage, in us and as
    the share of the measured triad rate that its 6 B/node stream takes
    (bench.py's sweep_stream_fraction_of_triad, with bf16's bytes)."""
    import torch

    rec = check_kernels(N_MAIN, False, False, ["A1_sweep"], dtype=torch.bfloat16)[0]
    recs.append(rec)
    H2 = (N_MAIN + 1) ** 2
    out = dict(solve="bench_sweep_hom_bf16", n=N_MAIN, sweep_us=1e3 * rec["ms"],
               sweep_stream_fraction_of_triad=(6 * H2 / (membench["triad_gbps"] * 1e9))
               / (rec["ms"] / 1e3), triad_gbps=membench["triad_gbps"])
    print(json.dumps(out), flush=True)
    return out


def run_bf16_cells(solves: dict, ir32: dict) -> dict:
    """The V2 solves with bf16 level storage, each held to its f32 cell:
    ``poisson_4097_bf16`` (23 +- 1 cycles, the JAX package's count for both
    storage types), ``interface_4097_bf16`` (inside the 120-cycle cap;
    cycles and tail q beside f32's), ``pswrr_interface_4097_bf16`` (A6 in
    bf16, which rounds only u4 where the split path rounds u1 and u3, so its
    cycles are printed beside the split path's, not held to them) and
    ``ir_4097_bf16`` (solve_ir with
    bf16 corrections to an f64 residual <= 1e-6 within 20 outer steps)."""
    import torch

    bf = torch.bfloat16
    a_keys = ("A1", "A2", "A3", "A4")
    out = {}
    for label, bim in (("interface_4097_bf16", True), ("poisson_4097_bf16", False)):
        out[label] = run_solve(label, lambda bim=bim: build_hierarchy(N_MAIN, bim, 9, 32, DEVICE,
                                                                      bf), a_keys, 120)
    out["pswrr_interface_4097_bf16"] = run_solve(
        "pswrr_interface_4097_bf16", lambda: build_hierarchy(N_MAIN, True, 9, 32, DEVICE, bf),
        ("A6", "A3", "A4"), 120, solve=lambda hv, f, **kw: hv.solve(f, use_pswrr=True, **kw))
    out["ir_4097_bf16"] = run_ir_cell(bf, max_outer=20)
    p, i, ps = (out[k] for k in ("poisson_4097_bf16", "interface_4097_bf16",
                                 "pswrr_interface_4097_bf16"))
    f32_p, f32_i = solves["poisson_4097"], solves["interface_4097"]
    print(json.dumps({"bf16_vs_f32": dict(
        poisson_cycles=[p["cycles"], f32_p["cycles"]],
        interface_cycles=[i["cycles"], f32_i["cycles"]],
        interface_tail_q=[i["tail_q"], f32_i["tail_q"]],
        pswrr_cycles=[ps["cycles"], i["cycles"]],
        pswrr_tail_q=[ps["tail_q"], i["tail_q"]],
        pswrr_device_ms_per_cycle=[r["profile"].get("busy_ms_per_cycle") for r in (ps, i)],
        ir_corrections=[out["ir_4097_bf16"]["corrections"], ir32["corrections"]],
        ms_per_cycle=dict(interface=[i["ms_per_cycle"], f32_i["ms_per_cycle"]],
                          poisson=[p["ms_per_cycle"], f32_p["ms_per_cycle"]]))}), flush=True)
    if abs(p["cycles"] - 23) > 1:
        fail(f"poisson_4097_bf16 takes {p['cycles']} cycles, not 23 +- 1")
    return out


def check_bf16_small_against_cpu() -> dict:
    """129^2 bi-material decay solves with bf16 storage on the card against
    the same solves on the CPU's plain path (threshold 16, 4 levels, u0
    standard normal, f = 0, eps 1e-6): the split V(1,1) path and use_pswrr;
    cycles +- 1, histories within 2%.  Returns each solve's launches on the
    card."""
    import torch

    n = N_SMALL
    u0 = np.random.default_rng(3).standard_normal((n + 1, n + 1)).astype(np.float32)
    f0 = np.zeros_like(u0)
    out = {}
    for label, pswrr, expect in (("bf16_small_split", False, ("A1", "A2", "A3", "A4")),
                                 ("bf16_small_pswrr", True, ("A6", "A3", "A4"))):
        hist = {}
        for dev in (DEVICE, "cpu"):
            hv = build_hierarchy(n, True, 4, 16, dev, torch.bfloat16)
            (u, h), launches = counted(lambda: hv.solve(f0, u0=u0, eps=1e-6, max_cycles=120,
                                                        use_pswrr=pswrr))
            if u.dtype != torch.bfloat16 or not h[-1] <= 1e-6:
                fail(f"{label}: no bf16 convergence on {dev}: {h[-3:]}")
            hist[dev] = h
            if dev == DEVICE:
                out[label] = launches
                if not all(launches.get(key) for key in expect):
                    fail(f"{label}: a kernel of the path never launched: {launches}")
        hg, hc = hist[DEVICE], hist["cpu"]
        m = min(len(hg), len(hc))
        dev_ratio = float(np.max(np.abs(hg[:m] / hc[:m] - 1.0)))
        print(json.dumps({label: dict(cycles=[len(hg), len(hc)], max_hist_ratio_dev=dev_ratio,
                                      launches=out[label])}), flush=True)
        if abs(len(hg) - len(hc)) > 1 or dev_ratio > 0.02:
            fail(f"{label}: the bf16 solve on the card disagrees with the CPU plain path")
    return out


# ---------------------------------------------------------------------------
# slice 11: learned inter-grid operators and the elastic H-Net
# ---------------------------------------------------------------------------
#
# The JAX package computes these in XLA, outside any pallas_call.  The
# learned cycle's serving path (no gradient) runs C1, X5 and X6 on the card,
# each phase holding the wrappers' own counts to the route's
# exact launches; the graded cycles, the elastic H-Net and the periodic step
# run torch ops (cuDNN convolutions in full f32), and those phases run with
# every launch count zeroed and fail if any count is not zero after them.

IG_N64 = "results/intergrid_trained_interface_n64.npz"
IG_ROBUST = "results/intergrid_robust/intergrid_robust.npz"
# X5's and X6's holds: 4097^2, 129^2, 65^2 and 33^2; (inclusion, channels)
LEARNED_SIZES = (N_MAIN, 128, 64, 32)
LEARNED_VARIANTS = {"bim16": (CIRCLE, 16), "bim12": (CIRCLE, 12), "hom1": (None, 1)}
# operations a node, counted from csrc/passes.cu: X5 nine fused multiply-adds
# and x w[0] a coarse interior node; X6 2.25 taps a fine node on average
# (1, 2, 2 and 4 by parity) of a multiply and an add, x w[1] and the add
LEARNED_FLOPS = {"X5": 19, "X6": 6.5}


def learned_bytes(key: str, n: int, N: int, bim: bool) -> int:
    """Bytes X5 or X6 must move for a batch of N on an (n+1)^2 level, each
    input read once and each output written once: X5 the fine interior of
    r, its pattern ids and f_c; X6 u, v, the coarse ids and out (the weight
    table aside)."""
    H2, Hc2, I2 = (n + 1) ** 2, (n // 2 + 1) ** 2, (n - 1) ** 2
    if key == "X5":
        return N * 4 * (I2 + Hc2) + (I2 if bim else 0)
    return N * 4 * (2 * H2 + Hc2) + (Hc2 if bim else 0)


def learned_bound(key: str, n: int, N: int, nbytes: int):
    """(bound ms, "bytes" or "operations") of one X5 or X6 launch."""
    nodes = (n // 2 - 1) ** 2 if key == "X5" else (n + 1) ** 2
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * LEARNED_FLOPS[key] * N * nodes / FP32_FLOP_PER_S
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def learned_pass_inputs(n: int, variant: str, N: int, seed: int, hiers: dict):
    """Seeded operands of X5 and X6 on the card: the level's and the coarse
    level's pattern ids (circle, or None; the 2-level hierarchy built once
    per size and inclusion in ``hiers``), random per-channel kernels and w,
    r, u standard normal (N, n+1, n+1), v (N, n/2+1, n/2+1)."""
    import torch
    from multigrid_feanet_torch.core.problem import GridHierarchy, Problem
    from multigrid_feanet_torch.models.intergrid import BILINEAR_4, FULL_WEIGHTING_16

    inclusion, C = LEARNED_VARIANTS[variant]
    key = (n, inclusion is not None)
    if key not in hiers:
        hiers[key] = GridHierarchy.create(Problem(n=n, inclusion=inclusion), 2, device=DEVICE)
    hier = hiers[key]
    rng = np.random.default_rng(seed)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=DEVICE)

    return dict(pid=hier.levels[0].pid, pid_c=hier.levels[1].pid,
                conv=t(FULL_WEIGHTING_16 + 0.1 * rng.standard_normal((C, 3, 3))),
                deconv=t(BILINEAR_4 + 0.1 * rng.standard_normal((C, 3, 3))),
                w=t([3.7, 1.1]), r=t(rng.standard_normal((N, n + 1, n + 1))),
                u=t(rng.standard_normal((N, n + 1, n + 1))),
                v=t(rng.standard_normal((N, n // 2 + 1, n // 2 + 1))))


def check_learned_passes() -> list:
    """Hold X5 and X6 against their plain versions with ``hold`` at
    ``ops.sweep.TOL`` (two launches bitwise) at every size of LEARNED_SIZES,
    in every variant of LEARNED_VARIANTS (bi-material with 16 random
    channels, 12 channels where ids 12-15 have none, homogeneous with one),
    batch 1 and 2 (a compact batch: sample 1 off a 16-byte boundary at odd
    sizes), each timed beside its bound and its plain version; at 4097^2,
    bi-material 16, batch 1, beside the torch path's transfer in full f32
    (``models/intergrid.py`` ``restrict_learned``: the split and
    ``F.conv2d`` with stride 2; ``prolong_learned``: the split and
    ``F.conv_transpose2d``, without the add), 5 calls."""
    import torch
    from multigrid_feanet_torch.models.intergrid import (IntergridParams, prolong_learned,
                                                         restrict_learned)
    from multigrid_feanet_torch.ops import passes as px
    from multigrid_feanet_torch.ops.sweep import TOL

    def x5(fn, y, kw):
        return fn(*y, **kw)

    recs, hiers = [], {}
    for n in LEARNED_SIZES:
        for variant in LEARNED_VARIANTS:
            for N in (1, 2):
                x = learned_pass_inputs(n, variant, N, 27 + n + N, hiers)
                bim = x["pid"] is not None
                legs = (("X5", px.learned_restrict_cuda, px.learned_restrict_plain,
                         (x["r"], x["pid"], x["conv"], x["w"])),
                        ("X6", px.learned_prolong_add_cuda, px.learned_prolong_add_plain,
                         (x["u"], x["v"], x["pid_c"], x["deconv"], x["w"])))
                for key, kfn, pfn, inputs in legs:
                    nbytes = learned_bytes(key, n, N, bim)
                    rec = hold(key, x5, kfn, pfn, inputs, {}, nbytes, TOL,
                               dict(n=n, variant=variant, batch=N, bim=bim), twice=True)
                    rec["bound_ms"], rec["bound_by"] = learned_bound(key, n, N, nbytes)
                    rec["library_ms"] = None
                    if n == N_MAIN and variant == "bim16" and N == 1:
                        p = IntergridParams(x["conv"], x["deconv"], x["w"])
                        with torch.no_grad():
                            if key == "X5":
                                lib, base = (lambda: restrict_learned(p, x["r"], x["pid"])), 0.0
                            else:
                                lib, base = (lambda: prolong_learned(p, x["v"], x["pid_c"])), x["u"]
                            rec["library_ms"] = plain_ms([lib], 5)
                            want = pfn(*inputs)
                            rec["library_rel_err"] = float((base + lib() - want).abs().max()
                                                           / want.abs().max())
                    recs.append(rec)
                del x
        hiers.clear()
    print(json.dumps({"learned_pass_checks": recs}), flush=True)
    return recs


# slice 28: C1 over a batch, X7-X9 (the backward of X5 and X6) and the graded
# cycle on them
#
# C1's batch holds: (n, batch), each bi-material and homogeneous
C1_BATCH_SHAPES = ((N_MAIN, 1), (N_MAIN, 2), (256, 4), (64, 64), (32, 64))
# X7's and X8's holds: (n, batch), in every variant of LEARNED_VARIANTS; the
# training step's levels 64, 16 and 4 at its batch of 64
BWD_SHAPES = ((N_MAIN, 1), (256, 2), (64, 64), (32, 2), (16, 64), (4, 64))
# the hold whose operands are also laid out as the graded cycle lays them
# (samples intergrid._buffer's batch plane apart, more than a plane)
BWD_SPACED = (64, 64, "bim16")
# operations a coarse cell (X7) or node (X8), counted from csrc/passes.cu:
# nine multiply-adds for the weight sums, nine of taps, and w[i] (X7: four
# fine nodes)
BWD_FLOPS = {"X7": 40, "X8": 37}
# the graded cycle's gradient on the card against the torch path's (the
# split and cuDNN in full f32): float32 sums in other orders, as the port's
# gradient against JAX's (tests/test_torch_learned_backward.py)
GRADED_TOL = 1e-4


def check_c1_batch() -> list:
    """C1 over a batch (``StencilLevel.sweep_batch`` and
    ``residual_batch``, one launch) at C1_BATCH_SHAPES, bi-material and
    homogeneous, in both modes: bit for bit the per-sample launches, within
    ``ops.sweep.TOL`` of the plain version; the batch launch's ms beside the
    per-sample launches' (one graph-replayed run of N launches), on inputs
    that fill twice the L2 or more."""
    import torch
    from multigrid_feanet_torch.core.problem import Problem, build_level
    from multigrid_feanet_torch.models import intergrid
    from multigrid_feanet_torch.ops import stencil_sweep as ss
    from multigrid_feanet_torch.ops.sweep import TOL

    recs = []
    for n, N in C1_BATCH_SHAPES:
        for bim in (True, False):
            lv = build_level(Problem(n=n, inclusion=CIRCLE if bim else None), n, device=DEVICE)
            st = ss.StencilLevel(n, pid=lv.pid, coefficients=intergrid._c1_coefficients(lv),
                                 omega=intergrid.DEFAULT_OMEGA, device=DEVICE)
            H = n + 1
            nbytes = N * 12 * H * H + (H * H if bim else 0)
            rng = np.random.default_rng(n + N)
            sets = min(8, -(-2 * L2_BYTES // nbytes))
            xs = []
            for _ in range(sets):
                u, f = intergrid._buffer(N, H, DEVICE), intergrid._buffer(N, H, DEVICE)
                u.copy_(torch.as_tensor(rng.standard_normal((N, H, H)), dtype=torch.float32,
                                        device=DEVICE) * lv.geo)
                f.copy_(torch.as_tensor(rng.standard_normal((N, H, H)), dtype=torch.float32,
                                        device=DEVICE))
                xs.append((u, f, intergrid._buffer(N, H, DEVICE)))
            rsq = torch.empty((), device=DEVICE)
            for mode in ("sweep", "residual"):
                batch = st.sweep_batch if mode == "sweep" else st.residual_batch
                one = st.sweep if mode == "sweep" else st.residual
                u, f, _ = xs[0]
                got = batch(u, f)
                each = torch.stack([one(u[i], f[i])[0] for i in range(N)])
                want = ss.relax_batch_plain(u, f, st.pid, a0=st.a0, da=st.da, omega=st.omega,
                                            mode=mode)
                torch.cuda.synchronize()
                rel = float((got - want).abs().max()) / max(1.0, float(want.abs().max()))
                rec = dict(name=f"C1_batch_{mode}", n=n, batch=N, bim=bim,
                           bitwise_per_sample=bool(torch.equal(got, each)), max_rel_err=rel,
                           max_abs_err=float((got - want).abs().max()), bytes=nbytes,
                           ms=kernel_ms([lambda x=x: batch(x[0], x[1], out=x[2]) for x in xs]),
                           per_sample_ms=kernel_ms([lambda x=x: [
                               one(x[0][i], x[1][i], out=x[2][i], rsq=rsq) for i in range(N)]
                               for x in xs], reps=max(2, 50 // N)),
                           bound_ms=1e3 * nbytes / HBM_BYTES_PER_S)
                recs.append(rec)
                if not (rec["bitwise_per_sample"] and rel <= TOL):
                    fail(f"C1 over a batch disagrees with its launches a sample or its plain "
                         f"version: {rec}")
            del xs
    print(json.dumps({"c1_batch_checks": recs}), flush=True)
    return recs


def bwd_bytes(key: str, n: int, N: int, bim: bool) -> int:
    """Bytes X7 or X8 must move for a batch of N on an (n+1)^2 level, each
    input read once and each output written once: X7 g_c, r, the fine ids
    and grad r; X8 g, v, the coarse ids and grad v (the weights and the
    partial sums aside)."""
    H2, Hc2 = (n + 1) ** 2, (n // 2 + 1) ** 2
    if key == "X7":
        return N * 4 * (Hc2 + 2 * H2) + (H2 if bim else 0)
    return N * 4 * (H2 + 2 * Hc2) + (Hc2 if bim else 0)


def bwd_bound(key: str, n: int, N: int, nbytes: int):
    """(bound ms, "bytes" or "operations") of one X7 or X8 launch."""
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * BWD_FLOPS[key] * N * (n // 2 + 1) ** 2 / FP32_FLOP_PER_S
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def check_learned_backward() -> list:
    """X7 and X8 (``ops/passes.py``) with X9 on their partial sums, held
    against their plain versions at BWD_SHAPES in every variant of
    LEARNED_VARIANTS: grad r and grad v bit for bit (both sum in tap order),
    grad k and grad w within ``TOL_WEIGHT_GRAD`` of the same gradients of
    |g| and |r| (|v|, |k|, |w|), two launches bitwise; X9 alone against
    ``weight_grad_plain`` on the same partials, to the same tolerance; at
    BWD_SPACED also on g and the field in the graded cycle's layout, bit
    for bit the compact batch's field and partials.  Each timed alone
    (``ms``: X7 or X8; ``x9_ms``) beside its bound, the plain backward's
    ms (X7 or X8 with X9's sums), with X9's rows and X7's or X8's blocks an
    SM, and, at 4097^2 and at 65^2 (batch 64), bi-material 16, the torch
    path's backward (autograd of the split and cuDNN in full f32; no single
    PyTorch call computes a pattern-split adjoint)."""
    import torch
    from multigrid_feanet_torch.core.device import full_f32
    from multigrid_feanet_torch.models import intergrid
    from multigrid_feanet_torch.models.intergrid import (IntergridParams, prolong_learned,
                                                         restrict_learned)
    from multigrid_feanet_torch.ops import passes as px

    recs = []
    for n, N in BWD_SHAPES:
        hiers = {}
        for variant in LEARNED_VARIANTS:
            x = learned_pass_inputs(n, variant, N, 41 + n + N, hiers)
            bim = x["pid"] is not None
            rng = np.random.default_rng(43 + n + N)
            g_c = torch.as_tensor(rng.standard_normal((N, n // 2 + 1, n // 2 + 1)),
                                  dtype=torch.float32, device=DEVICE)
            g = torch.as_tensor(rng.standard_normal((N, n + 1, n + 1)), dtype=torch.float32,
                                device=DEVICE)
            legs = (("X7", px.learned_restrict_bwd_cuda, px.learned_restrict_backward_plain,
                     (g_c, x["r"], x["pid"], x["conv"], x["w"]), 0),
                    ("X8", px.learned_prolong_bwd_cuda, px.learned_prolong_add_backward_plain,
                     (g, x["v"], x["pid_c"], x["deconv"], x["w"]), 1))
            for key, kfn, pfn, args, which in legs:
                k, w = args[3], args[4]
                field, partial = kfn(*args)
                got = (field.clone(), *px.weight_grad_cuda(partial, k, w, which))
                field2, partial2 = kfn(*args)
                again = (field2, *px.weight_grad_cuda(partial2, k, w, which))
                x9_plain = px.weight_grad_plain(partial, k, w, which)
                want = pfn(*args)
                absw = pfn(*(a.abs() if torch.is_tensor(a) and a.is_floating_point() else a
                             for a in args))
                torch.cuda.synchronize()

                def excess(a, b):
                    return max(float(((p - q).abs() / (c + 1e-30)).max())
                               for p, q, c in zip(a, b, absw[1:]))

                nbytes = bwd_bytes(key, n, N, bim)
                bound_ms, bound_by = bwd_bound(key, n, N, nbytes)
                sets = min(8, -(-2 * L2_BYTES // nbytes))
                xs = [args] + [tuple(a.clone() if torch.is_tensor(a) and a.is_floating_point()
                                     else a for a in args) for _ in range(sets - 1)]
                outs = [kfn(*a) for a in xs]
                rec = dict(name=key, n=n, batch=N, variant=variant, bim=bim, bytes=nbytes,
                           field_bitwise=bool(torch.equal(got[0], want[0])),
                           max_abs_err=float((got[0] - want[0]).abs().max()),
                           weight_excess=excess(got[1:], want[1:]),
                           x9_excess=excess(got[1:], x9_plain),
                           x9_max_abs_err=max(float((a - b).abs().max())
                                              for a, b in zip(got[1:], x9_plain)),
                           bitwise_twice=all(bool(torch.equal(a, b)) for a, b in zip(got, again)),
                           ms=kernel_ms([lambda a=a, o=o: kfn(*a, *o) for a, o in zip(xs, outs)]),
                           x9_ms=kernel_ms([lambda o=o: px.weight_grad_cuda(o[1], k, w, which)
                                            for o in outs]),
                           x9_plain_ms=plain_ms([lambda o=o: px.weight_grad_plain(
                               o[1], k, w, which) for o in outs]),
                           x9_blocks=int(partial.shape[0]),
                           blocks_per_sm=px.bwd_occupancy(key, k.shape[0]),
                           plain_ms=plain_ms([lambda a=a: pfn(*a) for a in xs]),
                           bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
                if (n, N, variant) == BWD_SPACED:
                    spaced = list(args)
                    for i in (0, 1):
                        spaced[i] = intergrid._buffer(N, args[i].shape[-1], DEVICE)
                        spaced[i].copy_(args[i])
                    rec["spaced_bitwise"] = all(bool(torch.equal(a, b)) for a, b in
                                                zip(kfn(*spaced), (field2, partial2)))
                if variant == "bim16" and (n, N) in ((N_MAIN, 1), (64, 64)):
                    p = IntergridParams(x["conv"].clone(), x["deconv"].clone(), x["w"].clone())
                    with full_f32():
                        if key == "X7":
                            inp = x["r"].clone().requires_grad_()
                            out, wrt = restrict_learned(p, inp, x["pid"]), (inp, p.conv, p.w)
                        else:
                            inp = x["v"].clone().requires_grad_()
                            out, wrt = prolong_learned(p, inp, x["pid_c"]), (inp, p.deconv, p.w)
                        rec["torch_backward_ms"] = plain_ms([lambda: torch.autograd.grad(
                            out, wrt, g_c if key == "X7" else g, retain_graph=True)], 5)
                    del out, inp
                del xs, outs
                recs.append(rec)
                if not (rec["field_bitwise"] and rec["weight_excess"] <= px.TOL_WEIGHT_GRAD
                        and rec["x9_excess"] <= px.TOL_WEIGHT_GRAD and rec["bitwise_twice"]
                        and rec.get("spaced_bitwise", True)):
                    fail(f"{key} or X9 disagrees with its plain version or with itself: {rec}")
            del x
    print(json.dumps({"learned_backward_checks": recs}), flush=True)
    return recs


def check_graded_cycle() -> list:
    """One graded learned cycle and its backward on the kernel route (its
    autograd form: the C1 Functions, X5 and X6 forward, X7, X8 and X9
    backward) at 65^2 (6 levels, batch 64) and 257^2 (8 levels, batch 4),
    random per-channel weights, the loss sum(c * cycle(u0)): exactly
    ``graded_launches``, its forward bit for bit the no-gradient route's,
    and its loss and gradients in conv, deconv and w within GRADED_TOL of
    the torch path's on the card (the split and cuDNN in full f32); ms of
    the cycle with its backward on both paths (synchronised host clock,
    median of 5 after one)."""
    import torch
    from multigrid_feanet_torch.core.convert import intergrid_params_from_arrays
    from multigrid_feanet_torch.core.device import full_f32
    from multigrid_feanet_torch.core.problem import GridHierarchy, Problem
    from multigrid_feanet_torch.models import intergrid

    recs = []
    for n, N in ((64, 64), (256, 4)):
        label = f"graded_cycle_{n + 1}"
        hier = GridHierarchy.create(Problem(n=n, inclusion=CIRCLE), device=DEVICE)
        rng = np.random.default_rng(n + N)
        conv = intergrid.FULL_WEIGHTING_16 + 0.1 * rng.standard_normal((16, 3, 3))
        deconv = intergrid.BILINEAR_4 + 0.1 * rng.standard_normal((16, 3, 3))
        u0, f, c = (torch.as_tensor(rng.standard_normal((N, n + 1, n + 1)), dtype=torch.float32,
                                    device=DEVICE) for _ in range(3))
        res = {}
        for path in ("route", "torch"):
            p = intergrid_params_from_arrays(conv, deconv, [3.7, 1.1], device=DEVICE)

            def step():
                for t in p.parameters():
                    t.grad = None
                cyc = (intergrid.learned_v_cycle(hier, p, u0, f) if path == "route" else
                       intergrid._torch_cycle(hier, p, u0, f, 1, intergrid.DEFAULT_OMEGA, 0))
                loss = (cyc * c).sum()
                with full_f32():
                    loss.backward()
                return cyc.detach(), loss.detach()

            expect = graded_launches(hier) if path == "route" else {}
            cyc, loss = exact_launches(label, step, expect)
            secs = []
            for _ in range(6):
                torch.cuda.synchronize()
                t0 = time.time()
                step()
                torch.cuda.synchronize()
                secs.append(time.time() - t0)
            res[path] = dict(cycle=cyc, loss=float(loss), ms=1e3 * float(np.median(secs[1:])),
                             grads={k: getattr(p, k).grad.clone() for k in ("conv", "deconv", "w")})
        with torch.no_grad():
            plain = intergrid.learned_v_cycle(hier, p, u0, f)
        r, t = res["route"], res["torch"]
        rec = dict(name=label, n=n, batch=N, levels=hier.num_levels,
                   launches=graded_launches(hier), route_ms=r["ms"], torch_ms=t["ms"],
                   forward_bitwise_no_grad=bool(torch.equal(r["cycle"], plain)),
                   loss_rel_dev=abs(r["loss"] / t["loss"] - 1.0),
                   grad_rel_dev={k: float((r["grads"][k] - t["grads"][k]).abs().max()
                                          / t["grads"][k].abs().max()) for k in r["grads"]},
                   tol=GRADED_TOL)
        print(json.dumps(rec), flush=True)
        if not (rec["forward_bitwise_no_grad"] and rec["loss_rel_dev"] <= GRADED_TOL
                and max(rec["grad_rel_dev"].values()) <= GRADED_TOL):
            fail(f"{label}: the graded cycle departs from the torch path's: {rec}")
        recs.append(rec)
    return recs


def route_launches(hier, cycles: int, n_relax: int = 1) -> dict:
    """The launches of ``cycles`` learned V-cycles on the kernel route, at
    any batch size: C1 2 n_relax + 1 times (one launch a batch) on every
    kernel level (``models.intergrid.kernel_levels``), X5 and X6 one each a
    level and cycle."""
    from multigrid_feanet_torch.models.intergrid import kernel_levels

    K = len(kernel_levels(hier))
    return {k: v for k, v in dict(C1=(2 * n_relax + 1) * K * cycles, X5=K * cycles,
                                  X6=K * cycles).items() if v}


def graded_launches(hier, n_relax: int = 1) -> dict:
    """The launches of one graded cycle (from an iterate that needs no
    gradient) and its backward, n_relax >= 1: forward ``route_launches``;
    backward on level 0 two C1 launches a post-sweep (its pre-sweeps and
    residual need no gradient), on each coarser kernel level two a sweep
    (one for the first, whose u is 0) and two for the residual; X7 and X8
    once a kernel level, X9 twice."""
    from multigrid_feanet_torch.models.intergrid import kernel_levels

    K = len(kernel_levels(hier))
    back = dict(C1=2 * n_relax + (K - 1) * (4 * n_relax + 1), X7=K, X8=K, X9=2 * K)
    return add_counts(route_launches(hier, 1, n_relax), back)


# q_m's residuals on a kernel finest level: f - A u_m and f - A u_m0 forward,
# and the two of f - A u_m's backward (grad f = mask g, grad u)
QM_LAUNCHES = {"C1": 4}


def train_step_launches(hier, m: int = 6) -> dict:
    """One q_m training step (``learn/train_intergrid.py``): m - 1 cycles
    without gradient, a graded cycle and its backward, q_m's residuals."""
    return add_counts(route_launches(hier, m - 1), graded_launches(hier), QM_LAUNCHES)


def add_counts(*counts) -> dict:
    out = {}
    for c in counts:
        for k, v in c.items():
            out[k] = out.get(k, 0) + v
    return out


def times(counts: dict, k: int) -> dict:
    return {key: k * v for key, v in counts.items()}


def exact_launches(label: str, run, expect: dict):
    """``run()`` with every launch count zeroed; fails unless the wrappers'
    own counts are ``expect`` exactly (no other kernel launched)."""
    out, launches = counted(run)
    if launches != expect:
        fail(f"{label}: launched {launches}, expected {expect}")
    return out


def no_launches(label: str, run):
    """``run()`` with every launch count zeroed; fails if it launched any
    kernel."""
    out, launches = counted(run)
    if launches:
        fail(f"{label}: launched {launches}; this path runs no kernel")
    return out


def run_intergrid_train_cell() -> dict:
    """``intergrid_train_64``: the reference's training protocol
    (experiments/config.py IntergridTrainConfig: the 64^2 interface problem,
    its default 6 levels, m = 6, m0 = 2, batch 64, Adam 1e-3) on the port's
    make_dataset(65, 120, seed=0) for 10 epochs (20 steps).  The losses must
    be finite and equal the CPU's run of the same 10 epochs within 1e-4;
    the JAX package's own run rises over these epochs too
    (tests/test_torch_train_intergrid.py), so no fall is required.  A run
    stopped after 5 epochs and resumed from its checkpoint under build/
    gives the straight run's losses and weights (rtol 1e-5); a 2-epoch
    train_kernel = 3 run changes channel 3 of conv and deconv only, and
    never w; 10 steps of train_step_decay_multisize at 16, 32 and 64
    (batches 16, 8, 2: experiments/intergrid_robust.py) stay finite.  Each
    run launches exactly ``train_step_launches`` a step: the kernel route's
    C1, X5 and X6 in its m - 1 cycles without gradient and its graded
    cycle, the backward's C1, X7, X8 and X9, and q_m's C1 residuals (every
    count zeroed before the run and read after it).  The CPU's run takes
    the same paths (their plain versions).  One step is profiled: its top
    kernels by device time, and X7, X8 and X9."""
    import shutil
    import torch
    from multigrid_feanet_torch.core.problem import GridHierarchy, Problem
    from multigrid_feanet_torch.data.rhs import make_dataset
    from multigrid_feanet_torch.learn import train_intergrid as ti
    from multigrid_feanet_torch.models.intergrid import IntergridParams

    def hier(n, device=DEVICE):
        return GridHierarchy.create(Problem(n=n, inclusion=CIRCLE), device=device)

    label = "intergrid_train_64"
    F = make_dataset(65, 120, seed=0).numpy()
    kw = dict(batch_size=64, seed=0, m=6, m0=2, lr=1e-3, verbose=False)
    h64 = hier(64)

    def epochs(k):  # k epochs of 120 RHS: two steps each (batches of 64 and 56)
        return times(train_step_launches(h64, kw["m"]), 2 * k)

    torch.cuda.synchronize()
    t0 = time.time()
    params, losses = exact_launches(label, lambda: ti.train(h64, F, num_epochs=10, **kw),
                                    epochs(10))
    torch.cuda.synchronize()
    wall = time.time() - t0
    t0 = time.time()
    _, l_cpu = ti.train(hier(64, "cpu"), F, num_epochs=10, **kw)
    cpu_s = time.time() - t0
    ckpt = ROOT / "build" / "smoke_intergrid_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    exact_launches(label, lambda: ti.train(h64, F, num_epochs=5, ckpt_dir=ckpt, **kw),
                   epochs(5))
    p_res, l_res = exact_launches(label, lambda: ti.train(h64, F, num_epochs=10, ckpt_dir=ckpt,
                                                          **kw), epochs(5))
    shutil.rmtree(ckpt, ignore_errors=True)
    p_cur, _ = exact_launches(label, lambda: ti.train(h64, F, num_epochs=2, train_kernel=3,
                                                      **kw), epochs(2))
    init = IntergridParams.init(device=DEVICE)
    moved = {k: [i for i in range(getattr(init, k).shape[0])
                 if not torch.equal(getattr(p_cur, k)[i], getattr(init, k)[i])]
             for k in ("conv", "deconv", "w")}
    sizes, batches = (16, 32, 64), (16, 8, 2)
    hiers = tuple(hier(n) for n in sizes)
    shapes = tuple((b, n + 1, n + 1) for b, n in zip(batches, sizes))
    ms_losses = []

    def multisize(state=ti.init_state(0, device=DEVICE)):
        for _ in range(10):
            state, loss = ti.train_step_decay_multisize(hiers, state, shapes=shapes)
            ms_losses.append(float(loss))

    torch.cuda.synchronize()
    t0 = time.time()
    # 10 steps of m = 10 at each size
    exact_launches(label, multisize, add_counts(*(times(train_step_launches(h, 10), 10)
                                                  for h in hiers)))
    ms_wall = time.time() - t0
    step_state = ti.init_state(0, device=DEVICE)
    F_batch = torch.as_tensor(F[:64], device=DEVICE)
    prof = profile_top(label, lambda: ti.train_step(h64, step_state, F_batch), 1, wall / 20,
                       keep=("X7", "X8", "X9"))
    dev_cpu = float(np.max(np.abs(losses / l_cpu - 1.0)))
    rec = dict(solve=label, n=64, levels=h64.num_levels, rhs=120, epochs=10, steps=20,
               s_per_step=wall / 20, cpu_s_per_step=cpu_s / 20, losses=losses.tolist(),
               losses_cpu=l_cpu.tolist(), max_rel_dev_cpu=dev_cpu,
               drop=float(losses[0] - losses[-1]), losses_resumed=l_res.tolist(),
               curriculum_moved=moved, multisize_sizes=list(sizes),
               multisize_losses=ms_losses, multisize_s_per_step=ms_wall / 10, profile=prof,
               launches=epochs(10))
    print(json.dumps(rec), flush=True)
    if not (np.all(np.isfinite(losses)) and np.all(np.isfinite(ms_losses))):
        fail(f"{label}: non-finite loss: {rec}")
    if not dev_cpu <= 1e-4:
        fail(f"{label}: the card's losses depart from the CPU's: {rec}")
    same = all(np.allclose(getattr(p_res, k).detach().cpu().numpy(),
                           getattr(params, k).detach().cpu().numpy(), rtol=1e-5, atol=1e-7)
               for k in ("conv", "deconv", "w"))
    if not (np.allclose(l_res, losses, rtol=1e-5) and same):
        fail(f"{label}: the resumed run departs from the straight run: {rec}")
    if moved != {"conv": [3], "deconv": [3], "w": []}:
        fail(f"{label}: the train_kernel=3 curriculum moved {moved}")
    return rec


def profile_top(label: str, run, units: int, wall_s: float, top: int = 6,
                keep: tuple = ()) -> dict:
    """``profile_solve`` of ``run()`` (``units`` cycles, steps or sweeps
    taking ``wall_s`` unprofiled), its kernels cut to the ``top`` by device
    time and those named in ``keep``; fails if any kernel ran in TF32 (the
    port's convolutions, and their backward, run in full f32)."""
    prof = profile_solve(run, units, wall_s)
    if "tf32_kernels" in prof:
        fail(f"{label}: kernels ran in TF32: {prof['tf32_kernels']}")
    if "by_kernel" in prof:
        ranked = sorted(prof["by_kernel"].items(), key=lambda kv: -kv[1]["ms_per_cycle"])
        prof["by_kernel"] = dict(ranked[:top] + [kv for kv in ranked[top:] if kv[0] in keep])
        prof["kernel_names"] = len(ranked)
    return prof


def torch_cycle(hier, params, u, f):
    """A learned V-cycle on the torch path (the split and cuDNN), the
    cycle ``learned_v_cycle`` runs where it takes no kernel route."""
    from multigrid_feanet_torch.models import intergrid

    return intergrid._torch_cycle(hier, params, u, f, 1, intergrid.DEFAULT_OMEGA, 0)


def learned_history(hier, params, f, cycles: int, cycle=None, u0=None, level64=None) -> dict:
    """``cycles`` learned V-cycles from u0 (default 0) without gradient
    (``cycle``: default ``learned_v_cycle``) -> {u, hist: the interior
    residual norm of each sample after each cycle, (cycles, N), secs: each
    cycle's seconds on the host clock, synchronised, peak_gb: on the card
    the most memory allocated during a cycle; with ``level64``, a float64
    level of the finest grid, also hist64: the float64 residual norms of
    sample 0, computed outside the cycles' peak}."""
    import torch
    from multigrid_feanet_torch.models.intergrid import learned_v_cycle
    from multigrid_feanet_torch.solvers.jacobi import interior_norm

    cycle = learned_v_cycle if cycle is None else cycle
    u = torch.zeros_like(f) if u0 is None else u0
    hist, hist64, secs, peak = [], [], [], 0
    with torch.no_grad():
        for _ in range(cycles):
            if u.is_cuda:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            t0 = time.time()
            u = cycle(hier, params, u, f)
            if u.is_cuda:
                torch.cuda.synchronize()
                peak = max(peak, torch.cuda.max_memory_allocated())
            secs.append(time.time() - t0)
            hist.append(interior_norm(f - hier.finest.apply(u)).cpu().numpy())
            if level64 is not None:
                r64 = f.double() - level64.apply(u.double())
                hist64.append(float(interior_norm(r64)[0]))
    return dict(u=u, hist=np.asarray(hist), secs=secs, peak_gb=peak / 1e9,
                hist64=np.asarray(hist64))


def route_call_holds(run) -> dict:
    """``run()`` with every C1 (a batch a launch), X5 and X6 launch of the
    kernel route held against its plain version on the same operands: the
    largest difference of each kernel's output, relative to max(1,
    max|plain|) as ``hold`` measures it, over every call (C1 by mode);
    fails beyond ``ops.sweep.TOL``."""
    from multigrid_feanet_torch.ops import passes as px
    from multigrid_feanet_torch.ops import stencil_sweep as ss
    from multigrid_feanet_torch.ops.sweep import TOL

    errs = {}

    def note(key, got, want):
        err = float((got - want).abs().max()) / max(1.0, float(want.abs().max()))
        rec = errs.setdefault(key, dict(calls=0, max_rel_err=0.0))
        rec["calls"] += 1
        rec["max_rel_err"] = max(rec["max_rel_err"], err)

    saved = ss.relax_batch_cuda, px.learned_restrict_cuda, px.learned_prolong_add_cuda

    def c1(u, f, pid=None, **kw):
        out = saved[0](u, f, pid, **kw)
        kw = {k: v for k, v in kw.items() if k != "out"}
        note("C1_" + kw.get("mode", "sweep"), out, ss.relax_batch_plain(u, f, pid, **kw))
        return out

    def x5(r, pid, k, w, out=None):
        got = saved[1](r, pid, k, w, out)
        note("X5", got, px.learned_restrict_plain(r, pid, k, w))
        return got

    def x6(u, v, pid, k, w, out=None):
        got = saved[2](u, v, pid, k, w, out)
        note("X6", got, px.learned_prolong_add_plain(u, v, pid, k, w))
        return got

    ss.relax_batch_cuda, px.learned_restrict_cuda, px.learned_prolong_add_cuda = c1, x5, x6
    try:
        run()
    finally:
        ss.relax_batch_cuda, px.learned_restrict_cuda, px.learned_prolong_add_cuda = saved
    if not errs or any(r["max_rel_err"] > TOL for r in errs.values()):
        fail(f"the kernel route's launches disagree with their plain versions: {errs}")
    return errs


# learned_vcycle_4097 on the evaluator's protocol: the kernel route's iterate
# after the first cycle within EVAL_FIRST_TOL of the torch path's (of its
# max|u|), its float64 residual after the last at most EVAL_LAST_RATIO times
# the torch path's
EVAL_FIRST_TOL = 1e-4
EVAL_LAST_RATIO = 1.5


def run_learned_vcycle_cell() -> dict:
    """``learned_vcycle_4097``: the evaluator of experiments/
    learn_intergrid.py:35-47 at the production size, the 4097^2 interface
    problem with 12 levels, f = mass(1), u0 = 0, 12 cycles, with the init
    parameters and with results/intergrid_robust/intergrid_robust.npz, on
    the kernel route (C1, X5 and X6 on every kernel level, each run
    launching exactly ``route_launches``), and with the init parameters on
    the torch path (``torch_cycle``: no launch): ms per cycle (median),
    hist[6] / hist[5], the peak memory during a cycle (``base_gb`` allocated
    before: the hierarchy, f, a float64 level), the float32 and the float64
    residual norms, and device ms a cycle from a profile of one cycle.
    Finite, and the init history must fall.  Every C1, X5 and X6 launch of
    two kernel-route cycles is held against its plain version on its own
    operands (``route_call_holds``).  On the evaluator's protocol the cycle
    amplifies rounding from cycle 2 on (the two paths' rounding, C1's
    contracted multiply-adds against cuDNN's tiles, steers their histories
    apart by tens of percent; the residual of the first cycle already
    differs by a few tenths of a percent, f - A u being float32
    cancellation), so the two paths are held to each other on the iterate
    after the first cycle with the init and the robust parameters (within
    ``EVAL_FIRST_TOL`` of max|u|), on the float64 residual after the last
    (the kernel route's at most ``EVAL_LAST_RATIO`` times the torch
    path's), and on the f = 0 decay protocol (u0 = standard
    normal x geo from rng 27, 12 cycles), where the cycle amplifies
    nothing: every cycle within 1e-4 relative.  Then 6 cycles at 129^2 on
    a batch of 2 (f = mass(1) and mass of a seeded normal field: sample 1
    of the compact batch off a 16-byte boundary) with the n = 64
    checkpoint, the card's kernel route against the CPU's (jacobi_step's
    arithmetic and the plain X5 and X6): histories within 1e-4.  That checkpoint
    is a two-grid operator (results/intergrid_training_notes.md): on the
    full 7-level hierarchy its cycle diverges to inf within 5 cycles, in
    the JAX package as in the port, so it runs on 2 levels."""
    import torch
    from multigrid_feanet_torch.core.convert import intergrid_params_from_npz
    from multigrid_feanet_torch.core.problem import GridHierarchy, Problem, build_level
    from multigrid_feanet_torch.models.intergrid import (IntergridParams, kernel_levels,
                                                         learned_v_cycle, prolong_learned,
                                                         restrict_learned)
    from multigrid_feanet_torch.ops.stencil import apply_mass

    def problem(n, levels, device, batch=1):
        h = GridHierarchy.create(Problem(n=n, inclusion=CIRCLE), num_levels=levels,
                                 device=device)
        H = h.finest.n_nodes
        F = np.ones((batch, H, H), np.float32)
        F[1:] = np.random.default_rng(27).standard_normal((batch - 1, H, H))
        return h, apply_mass(torch.as_tensor(F, device=h.device), h.finest.h)

    label = "learned_vcycle_4097"
    hier, f = problem(N_MAIN, int(np.log2(N_MAIN)), DEVICE)  # 12 levels: 4097^2 ... 3^2
    lv64 = build_level(Problem(n=N_MAIN, inclusion=CIRCLE, dtype=torch.float64), N_MAIN,
                       device=DEVICE)
    expect = route_launches(hier, 12)
    rec = dict(solve=label, n=N_MAIN, levels=hier.num_levels, cycles=12,
               kernel_levels=kernel_levels(hier), launches=expect)
    runs = [("init", IntergridParams.init(device=DEVICE), learned_v_cycle),
            ("robust", intergrid_params_from_npz(IG_ROBUST, DEVICE), learned_v_cycle),
            ("init_torch", IntergridParams.init(device=DEVICE), torch_cycle)]
    for name, params, cycle in runs:
        base = torch.cuda.memory_allocated()
        run = exact_launches(label, lambda: learned_history(hier, params, f, 12, cycle,
                                                            level64=lv64),
                             expect if cycle is learned_v_cycle else {})
        u, hist, secs = run["u"], run["hist"][:, 0], run["secs"]
        rec[name] = dict(ms_per_cycle=1e3 * float(np.median(secs)), ms_cycles=[
            1e3 * t for t in secs], q_6_5=float(hist[6] / hist[5]), hist=hist.tolist(),
            hist_f64=run["hist64"].tolist(), peak_gb=run["peak_gb"], base_gb=base / 1e9)
        if not (np.all(np.isfinite(hist)) and bool(torch.isfinite(u).all())):
            fail(f"{label}: non-finite values with the {name} parameters: {rec}")
        if name != "robust":
            with torch.no_grad():
                prof = profile_top(label, lambda: cycle(hier, params, u, f), 1,
                                   1e-3 * rec[name]["ms_per_cycle"], top=12)
            rec[name]["profile"] = prof
            rec[name]["device_ms_per_cycle"] = prof.get("busy_ms_per_cycle", "not measured")
        if name == "init":
            rec[name]["call_holds"] = route_call_holds(
                lambda: learned_history(hier, params, f, 2))
        if name == "init_torch":
            with torch.no_grad():
                r0 = f - hier.finest.apply(u)
                rec[name]["restrict_ms"] = plain_ms([lambda: restrict_learned(
                    params, r0, hier.levels[0].pid)], 5)
                m = hier.levels[1].n_nodes
                v1 = torch.ones((1, m, m), device=DEVICE)
                rec[name]["prolong_ms"] = plain_ms([lambda: prolong_learned(
                    params, v1, hier.levels[1].pid)], 5)
        del u
    if not rec["init"]["hist"][-1] < rec["init"]["hist"][0]:
        fail(f"{label}: the init-parameter history does not fall: {rec}")
    k64, t64 = rec["init"]["hist_f64"], rec["init_torch"]["hist_f64"]
    rec["evaluator"] = dict(first_residual_rel_dev=abs(k64[0] / t64[0] - 1.0),
                            last_ratio=k64[-1] / t64[-1], last_limit=EVAL_LAST_RATIO,
                            first_tol=EVAL_FIRST_TOL)
    for name, params, _ in runs[:2]:  # the first cycle's iterates, init and robust
        u1 = {}
        with torch.no_grad():
            for path, cycle in (("kernels", learned_v_cycle), ("torch", torch_cycle)):
                u1[path] = exact_launches(label, lambda: cycle(
                    hier, params, torch.zeros_like(f), f), route_launches(hier, 1)
                    if cycle is learned_v_cycle else {})
        rec["evaluator"][f"first_iterate_dev_{name}"] = float(
            (u1["kernels"] - u1["torch"]).abs().max() / u1["torch"].abs().max())
        del u1
    if not (max(rec["evaluator"][f"first_iterate_dev_{k}"] for k in ("init", "robust"))
            <= EVAL_FIRST_TOL and rec["evaluator"]["last_ratio"] <= EVAL_LAST_RATIO):
        fail(f"{label}: on the evaluator's protocol the kernel route departs from the torch "
             f"path: {rec['evaluator']}")
    # the f = 0 decay protocol: the two paths' histories held to each other
    params = IntergridParams.init(device=DEVICE)
    rng = np.random.default_rng(27)
    u0 = torch.as_tensor(rng.standard_normal(f.shape).astype(np.float32), device=DEVICE)
    u0 = u0 * hier.finest.geo
    zero = torch.zeros_like(f)
    decay = {}
    for name, cycle in (("kernels", learned_v_cycle), ("torch", torch_cycle)):
        decay[name] = exact_launches(label, lambda: learned_history(
            hier, params, zero, 12, cycle, u0=u0),
            expect if cycle is learned_v_cycle else {})["hist"][:, 0]
    dev_torch = float(np.max(np.abs(decay["kernels"] / decay["torch"] - 1.0)))
    rec["decay"] = dict(hist=decay["kernels"].tolist(), hist_torch=decay["torch"].tolist(),
                        max_rel_dev_torch=dev_torch)
    if not dev_torch <= 1e-4:
        fail(f"{label}: on the decay protocol the kernel route departs from the torch path: "
             f"{rec}")
    del u0, zero
    hists = {}
    for dev in (DEVICE, "cpu"):
        h, f_small = problem(128, 2, dev, batch=2)
        params = intergrid_params_from_npz(IG_N64, dev)
        run = lambda: learned_history(h, params, f_small, 6)  # noqa: E731
        hists[dev] = (exact_launches(label, run, route_launches(h, 6)) if dev == DEVICE
                      else run())["hist"]
    dev_cpu = float(np.max(np.abs(hists[DEVICE] / hists["cpu"] - 1.0)))
    rec["small_129"] = dict(cycles=6, batch=2, hist=hists[DEVICE].tolist(),
                            hist_cpu=hists["cpu"].tolist(), max_rel_dev_cpu=dev_cpu,
                            launches=route_launches(h, 6))
    print(json.dumps(rec), flush=True)
    if not dev_cpu <= 1e-4:
        fail(f"{label}: the 129^2 learned cycles on the card depart from the CPU's: {rec}")
    return rec


def run_hnet_elastic_train_cell() -> dict:
    """``hnet_elastic_train_16``: tests/test_hnet_elastic.py:62-90 on the
    card: train_elastic on generate_elastic(16, 10, seed=0) (E = 1, nu =
    0.3), 12 epochs, batch 5, k_max 4.  The per-epoch losses are samples of
    one random k and start per batch, and rise at this seed on the port's
    draws, so the fall of at least 10% is read on the fixed evaluation
    (learn/train_hnet.py::elastic_eval_loss) before and after training.  On
    the held-out generate_elastic(16, 1, seed=123) the H-corrected sweep
    must reach 1e-4 in fewer sweeps than block-Jacobi and end within 5e-3
    of the oracle.  Returns the record with the trained kernels."""
    import torch
    from multigrid_feanet_torch.data.datasets import generate_elastic
    from multigrid_feanet_torch.learn import train_hnet as th
    from multigrid_feanet_torch.models import hnet
    from multigrid_feanet_torch.ops.elasticity import elastic_interior_norm
    from multigrid_feanet_torch.ops.stencil import apply_mass
    from multigrid_feanet_torch.solvers import elastic

    label = "hnet_elastic_train_16"
    lv = elastic.build_elastic_hierarchy(16, E=1.0, nu=0.3, num_levels=1, device=DEVICE)[0]
    t0 = time.time()
    ds = generate_elastic(16, 10, seed=0)
    ds_test = generate_elastic(16, 1, seed=123)
    gen_s = time.time() - t0
    torch.cuda.synchronize()
    t0 = time.time()
    params, losses = no_launches(label, lambda: th.train_elastic(
        lv, ds, num_epochs=12, batch_size=5, seed=0, k_max=4, verbose=False))
    torch.cuda.synchronize()
    wall = time.time() - t0
    init = th.init_state_elastic(lv, seed=0).params.detach()
    before, after = (th.elastic_eval_loss(lv, p, ds, 4) for p in (init, params))
    prof = profile_top(label, lambda: th.train_elastic(lv, ds, num_epochs=1, batch_size=5,
                                                       seed=0, k_max=4, verbose=False),
                       1, wall / 12)
    u_star = torch.as_tensor(ds_test.u[0], device=DEVICE)
    ff = apply_mass(torch.as_tensor(ds_test.f[0], device=DEVICE), lv.h)

    def sweeps_to(step):
        u = torch.zeros_like(u_star)
        for i in range(1, 3001):
            u = step(u)
            if float(elastic_interior_norm(ff - lv.apply(u))) <= 1e-4:
                return i, u
        return 3001, u

    with torch.no_grad():
        n_jac, _ = no_launches(label, lambda: sweeps_to(lambda u: elastic.relax(lv, u, ff, 1)))
        n_h, u = no_launches(label, lambda: sweeps_to(
            lambda u: hnet.h_relax_elastic(lv, params, u, ff, 1)))
    err = float((u - u_star).abs().max())
    rec = dict(solve=label, n=16, samples=10, epochs=12, dataset_s=gen_s,
               s_per_epoch=wall / 12, losses=losses.tolist(),
               epoch_ratio=float(losses[-1] / losses[0]), eval_before=before,
               eval_after=after, eval_ratio=after / before, jacobi_sweeps=n_jac,
               h_sweeps=n_h, max_err_vs_oracle=err, profile=prof, launches={})
    print(json.dumps(rec), flush=True)
    if not (np.all(np.isfinite(losses)) and after < 0.9 * before):
        fail(f"{label}: the evaluation loss does not fall by 10%: {rec}")
    if not (n_h < n_jac and err < 5e-3):
        fail(f"{label}: the trained corrector misses the held-out anchor: {rec}")
    return dict(rec, params=params)


def run_h_elastic_cell(params) -> dict:
    """``h_elastic_2049``: h_relax_elastic with the trained net, without
    gradient, for 32 sweeps on the 2049^2 plane-stress level of the
    elastic_2049 cell (E = 212e3, nu = 0.288, circle (1, 20); u0 standard
    normal from rng 1 on the interior, f = 0), ms per sweep beside 32
    solvers/elastic.relax sweeps (CUDA events around each run of 32); then 4
    sweeps at n = 128 on the card against the CPU, within 1e-5."""
    import torch
    from multigrid_feanet_torch.models import hnet
    from multigrid_feanet_torch.ops.elasticity import elastic_interior_norm
    from multigrid_feanet_torch.solvers import elastic

    label = "h_elastic_2049"

    def problem(n, device):
        lv = elastic.build_elastic_hierarchy(n, E_EL, NU_EL, inclusion=CIRCLE,
                                             coefficients=(1.0, 20.0), num_levels=1,
                                             device=device)[0]
        u0 = np.random.default_rng(1).standard_normal((2, n + 1, n + 1)).astype(np.float32)
        u0 = torch.as_tensor(u0, device=device) * lv.geo
        return lv, u0, torch.zeros_like(u0), params.to(device)

    def sweeps(lv, u, f, p, k):
        with torch.no_grad():
            return (hnet.h_relax_elastic(lv, p, u, f, k) if p is not None
                    else elastic.relax(lv, u, f, k))

    lv, u0, f, p = problem(N_EL, DEVICE)
    rec = dict(solve=label, n=N_EL, sweeps=32, launches={})
    for name, net in (("h_relax_elastic", p), ("relax", None)):
        sweeps(lv, u0, f, net, 2)  # warm
        times = []
        for _ in range(3):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            u = no_launches(label, lambda: sweeps(lv, u0, f, net, 32))
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b) / 32)
        r0, r1 = (float(elastic_interior_norm(f - lv.apply(x))) for x in (u0, u))
        rec[name] = dict(ms_per_sweep=float(np.median(times)), ms_runs=times,
                         residual_ratio=r1 / r0, profile=profile_top(
                             label, lambda: sweeps(lv, u0, f, net, 4), 4,
                             4e-3 * np.median(times)))
        if not bool(torch.isfinite(u).all()):
            fail(f"{label}: non-finite iterate from {name}: {rec}")
    outs = {}
    for dev in (DEVICE, "cpu"):
        lv_s, u0_s, f_s, p_s = problem(N_SMALL, dev)
        outs[dev] = no_launches(label, lambda: sweeps(lv_s, u0_s, f_s, p_s, 4)).cpu().numpy()
    rel = float(np.max(np.abs(outs[DEVICE] - outs["cpu"])) / np.max(np.abs(outs["cpu"])))
    rec["small_128"] = dict(sweeps=4, max_rel_dev_cpu=rel)
    print(json.dumps(rec), flush=True)
    if not rel <= 1e-5:
        fail(f"{label}: the 128^2 sweeps on the card depart from the CPU's: {rec}")
    return rec


def check_pbc_train_f32() -> dict:
    """One ``solvers/pbc_mg.py::pbc_train_step`` (a 64^2 torus, a batch of
    2 standard normal right-hand sides from rng 3, 4 levels, k = 4) under
    the profiler: the restriction kernel's gradient must run in full f32
    (its convolutions' backward once ran in TF32)."""
    import torch
    from multigrid_feanet_torch.ops.stencil import make_homogeneous_stencil
    from multigrid_feanet_torch.solvers.pbc_mg import init_pbc_state, pbc_train_step

    table = make_homogeneous_stencil(device=DEVICE)
    state = init_pbc_state(0, device=DEVICE)
    f_raw = torch.as_tensor(np.random.default_rng(3).standard_normal((2, 64, 64)),
                            dtype=torch.float32, device=DEVICE)
    prof = profile_top("pbc_train_f32", lambda: pbc_train_step(table, state, f_raw,
                                                               num_levels=4), 1, 1.0)
    rec = dict(solve="pbc_train_f32", n=64, busy_ms=prof.get("busy_ms_per_cycle"),
               launches={})
    print(json.dumps(rec), flush=True)
    return rec


def run_slice11() -> dict:
    """The slice-11 phases, in order, after X5's and X6's holds and slice
    28's (C1 over a batch, X7-X9, the graded cycle): {"learned_pass_checks":
    the holds, "c1_batch_checks", "learned_backward_checks",
    "graded_cycles": theirs, each cell's label: its record}."""
    checks = check_learned_passes()
    c1_batch = check_c1_batch()
    backward = check_learned_backward()
    graded = check_graded_cycle()
    ig_train = run_intergrid_train_cell()
    learned = run_learned_vcycle_cell()
    el_train = run_hnet_elastic_train_cell()
    h_el = run_h_elastic_cell(el_train.pop("params"))
    pbc_f32 = no_launches("pbc_train_f32", check_pbc_train_f32)
    return {"learned_pass_checks": checks, "c1_batch_checks": c1_batch,
            "learned_backward_checks": backward, "graded_cycles": graded,
            **{rec["solve"]: rec for rec in (ig_train, learned, el_train, h_el, pbc_f32)}}


def decay_q(hist, k: int) -> float:
    """Tail contraction factor: the geometric mean of the last ``k``
    residual ratios."""
    return float(np.exp(np.mean(np.diff(np.log(np.asarray(hist) + 1e-300))[-k:])))


def state_on_card(label: str, solver) -> None:
    """Fail unless every tensor reachable from ``solver`` lies on the card."""
    import torch

    seen, todo, off = set(), [solver], []
    while todo:
        obj = todo.pop()
        if id(obj) in seen:
            continue
        seen.add(id(obj))
        if isinstance(obj, torch.Tensor):
            if not obj.is_cuda:
                off.append(tuple(obj.shape))
        elif isinstance(obj, dict):
            todo += list(obj.values())
        elif isinstance(obj, (list, tuple)):
            todo += list(obj)
        elif hasattr(obj, "__dict__"):
            todo += list(vars(obj).values())
    if off:
        fail(f"{label}: solver state off the card: {off[:8]}")


def research_cycle_profile(label: str, cycle, wall_per_cycle: float) -> dict:
    """One ``cycle()`` under torch.profiler: the device operations it
    launched (every CUDA kernel, memset and copy the profiler recorded; it
    may lose a few) and its device time; fails if any of the port's CUDA
    kernels launched."""
    prof = no_launches(label, lambda: profile_solve(cycle, 1, wall_per_cycle))
    by_kernel = prof.pop("by_kernel", {})
    # no kernel of the port ran: what KERNEL_TAGS files under rsq_reduce is
    # torch's own reduce_kernel (the sums)
    if "rsq_reduce" in by_kernel:
        by_kernel["torch:reduce_kernel"] = by_kernel.pop("rsq_reduce")
    prof["launches_per_cycle"] = sum(r["launches"] for r in by_kernel.values())
    ranked = sorted(by_kernel.items(), key=lambda kv: -kv[1]["ms_per_cycle"])
    prof["top_ops"] = dict(ranked[:5])
    return prof


def setup_timed(build):
    """``build()`` on the card -> (result, seconds, peak GB allocated above
    what was held before)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.time()
    out = build()
    torch.cuda.synchronize()
    return out, time.time() - t0, (torch.cuda.max_memory_allocated() - base) / 1e9


def run_elastic_boxmg_cell(n: int = 1024) -> dict:
    """``elastic_boxmg_1025``: experiments/elastic_boxmg_study.py's large-n
    run on the card in f64: plane stress (E = 212e3, nu = 0.288), circle r
    = 0.5 with coefficients (1, 20), the 10 levels of
    build_elastic_hierarchy(1024), the block-BoxMG setup and the direct
    coarse solve; f = 0, u0 standard normal from rng 3 on the interior.
    W(2,2) for 30 cycles (tail q over the last 6 ratios < 0.5,
    tests/test_boxmg_elastic.py:95), then the homogeneous problem's V(2,2)
    for 20 cycles (q < 0.33, :112).  Prints each run's setup seconds, peak
    GB, ms per cycle (host clock over the solve, synchronised) and the
    device operations and time of one cycle from torch.profiler."""
    import torch
    from multigrid_feanet_torch.solvers import elastic
    from multigrid_feanet_torch.solvers.elastic_boxmg import ElasticBoxMG

    label = "elastic_boxmg_1025"
    rec = dict(solve=label, n=n, dtype="float64", launches={})
    for name, inc, gamma, cycles, q_max in (("bim_w22", CIRCLE, 2, 30, 0.5),
                                             ("hom_v22", None, 1, 20, 0.33)):
        levels = elastic.build_elastic_hierarchy(n, E_EL, NU_EL, inclusion=inc,
                                                 coefficients=(1.0, 20.0), dtype=torch.float64,
                                                 device=DEVICE)
        bm, setup_s, peak_gb = setup_timed(lambda: no_launches(label, lambda: ElasticBoxMG(levels)))
        state_on_card(label, bm)
        u0 = torch.as_tensor(np.random.default_rng(3).standard_normal((2, n + 1, n + 1)),
                             device=DEVICE) * levels[0].geo
        f = torch.zeros_like(u0)
        t0 = time.time()
        u, hist = no_launches(label, lambda: bm.solve(f, u0=u0, eps=0.0, max_cycles=cycles,
                                                      gamma=gamma))
        torch.cuda.synchronize()
        wall = time.time() - t0
        prof = research_cycle_profile(label, lambda: bm.v_cycle(u, f, gamma=gamma),
                                      wall / cycles)
        q = decay_q(hist, 6)
        rec[name] = dict(levels=bm.L, gamma=gamma, cycles=len(hist), setup_s=setup_s,
                         peak_gb=peak_gb, ms_per_cycle=1e3 * wall / cycles, q_tail6=q,
                         q_max=q_max, history_head=hist[:3].tolist(),
                         history_tail=hist[-3:].tolist(), profile=prof)
        if not (len(hist) == cycles and np.all(np.isfinite(hist)) and q < q_max):
            fail(f"{label} {name}: q {q} (bound {q_max}) or history: {rec[name]}")
        del bm, levels, u
    print(json.dumps(rec), flush=True)
    return rec


def run_adaptive_boxmg_cell(n: int = 512) -> dict:
    """``adaptive_boxmg_513``: experiments/adaptive_transfer_study.py's
    largest size on the card in f32: the n = 512 interface problem (circle,
    (1, 20), 9 levels), the adaptive BoxMG setup (host weights, Galerkin
    probes on the card, direct coarse solve); f = 0, u0 standard normal
    from rng 0 on the interior.  BoxMG V(1,1) and the linear V(1,1) of
    solvers/multigrid.py for 20 cycles each; tail q over 5 ratios, held to
    q_adaptive <= 0.37 and q_adaptive < q_linear - 0.12
    (tests/test_adaptive_transfer.py:147-148)."""
    import torch
    from multigrid_feanet_torch.core.problem import GridHierarchy, Problem
    from multigrid_feanet_torch.ops.adaptive_transfer import BoxMG
    from multigrid_feanet_torch.solvers import multigrid

    label, cycles = "adaptive_boxmg_513", 20
    hier = GridHierarchy.create(Problem(n=n, inclusion=CIRCLE), device=DEVICE)
    bm, setup_s, peak_gb = setup_timed(lambda: no_launches(label, lambda: BoxMG(hier)))
    state_on_card(label, bm)
    u0 = torch.as_tensor(np.random.default_rng(0).standard_normal((n + 1, n + 1)),
                         dtype=torch.float32, device=DEVICE) * hier.finest.geo
    f = torch.zeros_like(u0)
    runs = {}
    for name, solve in (("adaptive", lambda: bm.solve(f, u0=u0, eps=0.0, max_cycles=cycles)),
                        ("linear", lambda: multigrid.solve(hier, f, u0=u0, nu1=1, nu2=1,
                                                           eps=None, max_cycles=cycles))):
        t0 = time.time()
        u, hist = no_launches(label, solve)
        torch.cuda.synchronize()
        wall = time.time() - t0
        runs[name] = dict(cycles=len(hist), ms_per_cycle=1e3 * wall / cycles,
                          q_tail5=decay_q(hist, 5), history_tail=hist[-3:].tolist())
        if not (len(hist) == cycles and np.all(np.isfinite(hist))):
            fail(f"{label} {name}: history {hist}")
    runs["adaptive"]["profile"] = research_cycle_profile(
        label, lambda: bm.v_cycle(u0, f), runs["adaptive"]["ms_per_cycle"] / 1e3)
    q_ad, q_lin = runs["adaptive"]["q_tail5"], runs["linear"]["q_tail5"]
    rec = dict(solve=label, n=n, dtype="float32", levels=bm.num_levels, setup_s=setup_s,
               peak_gb=peak_gb, q_adaptive=q_ad, q_linear=q_lin, launches={}, **runs)
    print(json.dumps(rec), flush=True)
    if not (q_ad <= 0.37 and q_ad < q_lin - 0.12):
        fail(f"{label}: q_adaptive {q_ad} against q_linear {q_lin}")
    return rec


def check_boxmg_research_small_against_cpu() -> dict:
    """The two research solvers at n = 32 in f64 on the card and on the
    CPU, 8 cycles each from the f = 0 decay start: the elastic W(2,2)
    (bi-material, rng 3) and the adaptive V(1,1) (interface problem, rng
    0); every history entry within 1e-9 relative."""
    import torch
    from multigrid_feanet_torch.core.problem import GridHierarchy, Problem
    from multigrid_feanet_torch.ops.adaptive_transfer import BoxMG
    from multigrid_feanet_torch.solvers import elastic
    from multigrid_feanet_torch.solvers.elastic_boxmg import ElasticBoxMG

    label, n, cycles = "boxmg_research_32", 32, 8
    hists = {}
    for dev in (DEVICE, "cpu"):
        levels = elastic.build_elastic_hierarchy(n, E_EL, NU_EL, inclusion=CIRCLE,
                                                 coefficients=(1.0, 20.0), dtype=torch.float64,
                                                 device=dev)
        u0 = torch.as_tensor(np.random.default_rng(3).standard_normal((2, n + 1, n + 1)),
                             device=dev) * levels[0].geo
        _, h_el = no_launches(label, lambda: ElasticBoxMG(levels).solve(
            torch.zeros_like(u0), u0=u0, eps=0.0, max_cycles=cycles, gamma=2))
        hier = GridHierarchy.create(Problem(n=n, inclusion=CIRCLE, dtype=torch.float64),
                                    device=dev)
        v0 = torch.as_tensor(np.random.default_rng(0).standard_normal((n + 1, n + 1)),
                             device=dev) * hier.finest.geo
        _, h_ad = no_launches(label, lambda: BoxMG(hier).solve(torch.zeros_like(v0), u0=v0,
                                                                eps=0.0, max_cycles=cycles))
        hists[dev] = dict(elastic_w22=h_el, adaptive_v11=h_ad)
    rec = dict(solve=label, n=n, cycles=cycles, launches={})
    for key in ("elastic_w22", "adaptive_v11"):
        card, cpu = hists[DEVICE][key], hists["cpu"][key]
        rel = float(np.max(np.abs(card / cpu - 1.0))) if len(card) == len(cpu) else float("inf")
        rec[key] = dict(max_rel_dev_cpu=rel, last=[float(card[-1]), float(cpu[-1])])
        if not rel <= 1e-9:
            fail(f"{label} {key}: the card's history departs from the CPU's: {rec}")
    print(json.dumps(rec), flush=True)
    return rec


def run_research_solvers() -> dict:
    """The research solvers' phases, in order; they launch no kernel of the
    port."""
    cells = (run_elastic_boxmg_cell(), run_adaptive_boxmg_cell(),
             check_boxmg_research_small_against_cpu())
    return {rec["solve"]: rec for rec in cells}


# ---- slice 21: the slab forms of A1-A4 and the sharded solvers ----

SLAB_LEGS = ("A1_sweep", "A1_psweep", "A2", "A3", "A4")
N_SLABS, GHOST = 4, 4


def slab_calls(sw, dform: bool, cfg: dict) -> dict:
    """leg -> (whole-field call, slab call(fn, slab inputs, slab), the slab
    form's CUDA and plain functions); inputs are (u, f, uc, ph)."""
    return {
        "A1_sweep": (lambda x: sw.sweep_cuda(x[0], x[1], x[3], None, dform=dform, **cfg),
                     lambda fn, x, sl: fn(x[0], x[1], x[3], None, dform=dform, slab=sl, **cfg),
                     sw.sweep_slab_cuda, sw.sweep_plain),
        "A1_psweep": (lambda x: sw.sweep_cuda(x[0], x[1], x[3], x[2], dform=dform, **cfg),
                      lambda fn, x, sl: fn(x[0], x[1], x[3], x[2], dform=dform, slab=sl, **cfg),
                      sw.sweep_slab_cuda, sw.sweep_plain),
        "A2": (lambda x: sw.swrr_cuda(x[0], x[1], x[3], dform=dform, **cfg),
               lambda fn, x, sl: fn(x[0], x[1], x[3], dform=dform, slab=sl, **cfg),
               sw.swrr_slab_cuda, sw.swrr_plain),
        "A3": (lambda x: (sw.zrr_cuda(x[1], x[3], **cfg),),
               lambda fn, x, sl: (fn(x[1], x[3], slab=sl, **cfg),),
               sw.zrr_slab_cuda, sw.zrr_plain),
        "A4": (lambda x: (sw.zpsweep_cuda(x[1], x[3], x[2], **cfg),),
               lambda fn, x, sl: (fn(x[1], x[3], x[2], slab=sl, **cfg),),
               sw.zpsweep_slab_cuda, sw.zpsweep_plain),
    }


def slab_inputs(x, n: int, Hloc: int, r: int):
    """Rank r's slab of the level inputs ``x`` = (u, f, uc, ph) and its
    ``Slab`` (own rows [r Hloc, (r + 1) Hloc), GHOST rows each side)."""
    from multigrid_feanet_torch.parallel.shard import slab_for

    return cut_slab(x, slab_for(r, Hloc, Hloc // 2))


def cut_slab(x, sl):
    """The slab ``sl`` of the level inputs ``x`` = (u, f, uc, ph), and ``sl``."""
    from multigrid_feanet_torch.parallel.shard import cut_rows, slab_window

    fine, coarse = slab_window(sl), slab_window(sl, coarse=True)
    u, f, uc, ph = x
    xs = (cut_rows(u, *fine), cut_rows(f, *fine), cut_rows(uc, *coarse),
          None if ph is None else cut_rows(ph, *fine))
    return xs, sl


def compare_slabs(got, plain, want, Hloc: int, H: int, Hc: int) -> dict:
    """Slab r's outputs ``got[r]`` (the kernel's) and ``plain[r]`` (its
    plain slab form's) against the whole-field kernel's ``want``: the own
    rows (and the coarse rows under them) bitwise ``want``'s, the fields'
    largest absolute and relative differences from the plain form, the
    norm's relative difference from the plain form's, and, when ``want``
    ends with a norm, the partial norms' sum against it."""
    import torch

    rel, abs_err, same, rsq_parts, plain_rel = 0.0, 0.0, True, 0.0, 0.0
    for r, (g, p) in enumerate(zip(got, plain)):
        for gt, pt, wt in zip(g, p, want):
            if gt.dim() == 0:
                rsq_parts += float(gt)
                plain_rel = max(plain_rel, abs(float(gt) - float(pt)) / max(abs(float(pt)), 1e-30))
                continue
            Hl, tot = (Hloc // 2, Hc) if gt.shape[1] == Hc else (Hloc, H)
            own = min(Hl, tot - r * Hl)
            if own <= 0:
                continue
            go, po = gt[GHOST : GHOST + own], pt[GHOST : GHOST + own]
            same = same and torch.equal(go, wt[r * Hl : r * Hl + own])
            err = float((go - po).abs().max())
            abs_err = max(abs_err, err)
            rel = max(rel, err / max(1.0, float(po.abs().max())))
    out = dict(bitwise_whole=same, max_abs_err=abs_err, max_rel_err=rel,
               rsq_plain_rel_err=plain_rel)
    if want[-1].dim() == 0:
        out["rsq_parts_rel_err"] = abs(rsq_parts - float(want[-1])) / float(want[-1])
    return out


def check_slab_level(n: int, bim: bool, dform: bool, seed: int = 21) -> list:
    """A1 (sweep, psweep), A2, A3 and A4 in slab form on N_SLABS slabs of
    one level: each slab's own rows bitwise the whole-field kernel's, the
    partial norms' sum within 1e-6 of its norm, each slab held to its plain
    slab form at TOL; at N_MAIN in the difference form the slabs' launches
    timed beside the whole field's.  One record per leg; without ``dform``
    A1 and A2 only (A3 and A4 have no difference form)."""
    import torch
    from multigrid_feanet_torch.ops import sweep as sw

    H, Hc = n + 1, n // 2 + 1
    Hloc = -(-H // N_SLABS)
    Hloc += Hloc % 2
    x = level_inputs(n, bim, seed)
    cfg = dict(a0=1.0, da=19.0 if bim else 0.0, omega=2.0 / 3.0)
    slabs = [slab_inputs(x, n, Hloc, r) for r in range(N_SLABS)]
    recs = []
    for leg, (whole, call, cuda_fn, plain_fn) in slab_calls(sw, dform, cfg).items():
        if not dform and leg in ("A3", "A4"):
            continue
        want = whole(x)
        got = [call(cuda_fn, xs, sl) for xs, sl in slabs]
        plain = [call(plain_fn, xs, sl) for xs, sl in slabs]
        torch.cuda.synchronize()
        rec = dict(name=f"{leg}_slab", n=n, bim=bim, dform=dform if leg[:2] in ("A1", "A2") else False,
                   slabs=N_SLABS, Hloc=Hloc, **compare_slabs(got, plain, want, Hloc, H, Hc))
        if n == N_MAIN and dform:
            rec["whole_ms"] = kernel_ms([lambda: whole(x)])
            rec["slabs_ms"] = kernel_ms([lambda: [call(cuda_fn, xs, sl) for xs, sl in slabs]])
        recs.append(rec)
        if (not rec["bitwise_whole"] or rec["max_rel_err"] > sw.TOL
                or rec["rsq_plain_rel_err"] > sw.TOL or rec.get("rsq_parts_rel_err", 0) > 1e-6):
            fail(f"slab form disagrees: {rec}")
    return recs


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


# the slab legs' node fields read or written, and whether each writes the
# coarse rows under its rows (restriction) or reads them (prolongation)
SLAB_FIELDS = {"A1_sweep": (3, None), "A1_psweep": (3, "read"), "A2": (3, "written"),
               "A3": (1, "written"), "A4": (2, "read"), "E2": (3, "written"), "E3": (3, "read")}


def slab_grid_rows(sl, n: int) -> tuple:
    """[a, b): the global rows of a slab of level n that lie on the grid;
    the slab's other rows (padding past row n, ghost rows off the grid)
    hold no node the leg must read or write."""
    from multigrid_feanet_torch.parallel.shard import slab_window

    g, rows = slab_window(sl)
    return max(g, 0), min(g + rows, n + 1)


def slab_bytes(leg: str, n: int, sl, bim: bool) -> int:
    """Bytes a slab form must move on the grid rows [a, b) of its slab of
    level n: its node fields read and written once, the phases of the
    elements on those rows, the coarse rows under them that it writes
    (a restriction: rows ceil(a/2) .. floor((b-1)/2)) or reads (a
    prolongation: floor(a/2) .. ceil((b-1)/2)), and E2's and E3's (1, 3, 3)
    kernels."""
    a, b = slab_grid_rows(sl, n)
    fields, coarse = SLAB_FIELDS[leg]
    ph = n * (min(b, n) - max(a - 1, 0)) if bim else 0
    crows = {None: 0, "written": (b - 1) // 2 - (a + 1) // 2 + 1, "read": b // 2 - a // 2 + 1}
    return (4 * fields * (b - a) * (n + 1) + ph + 4 * (n // 2 + 1) * crows[coarse]
            + (36 if leg[0] == "E" else 0))


def slab_bound(leg: str, n: int, sl, bim: bool, flops_per_node: int) -> dict:
    """The byte and operation bound of a slab launch on its grid rows."""
    a, b = slab_grid_rows(sl, n)
    nbytes = slab_bytes(leg, n, sl, bim)
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * flops_per_node * (b - a) * (n + 1) / FP32_FLOP_PER_S
    return dict(grid_rows=b - a, bytes=nbytes, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def slab_occupancy(leg: str, n: int, form: int, mode: int, tiles, slab: bool) -> dict:
    """The blocks one SM holds of a bi-material A1-A4 launch (the
    whole-field instance's, or the slab instance's) at its strip, and the
    waves its grid takes on this card."""
    import ctypes

    import torch
    from multigrid_feanet_torch import _build
    from multigrid_feanet_torch.ops import sweep as sw

    lib = _build.load()
    if slab:
        fn, args = lib.mg_slab_occupancy, (sw._LEG_ID[leg], 1, form, mode, tiles.strip)
    else:
        fn, args = lib.mg_a12_occupancy, (sw._LEG_ID[leg], 1, form, mode, 0, tiles.strip)
    fn.argtypes, fn.restype = [ctypes.c_int] * len(args), ctypes.c_int
    per_sm = fn(*args)
    if per_sm <= 0:
        fail(f"{fn.__name__}: CUDA error {-per_sm}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return dict(strip=tiles.strip, gx=tiles.gx, gy=tiles.gy, blocks=tiles.blocks,
                blocks_per_sm=per_sm, waves=tiles.blocks / (per_sm * sms))


def slab_times(sh) -> dict:
    """The slab forms at the shapes the world-1 sharded interface solve
    gives them (A1 psweep and A2 at level 0, A3 and A4 at level 1), each
    held to its plain slab form at TOL (fields and norm): the kernel's and
    the plain form's time and the bound on its grid rows; beside them the
    whole-field kernel's time on the same level, a slab with the fewest
    rows (own rows n + 2) and each launch's grid, blocks per SM and
    waves."""
    import torch
    from multigrid_feanet_torch.ops import sweep as sw

    out = {}
    cfg = dict(a0=1.0, da=19.0, omega=2.0 / 3.0)
    for leg, level in (("A1_psweep", 0), ("A2", 0), ("A3", 1), ("A4", 1)):
        n = sh.base.hier.levels[level].n
        key = leg[:2]
        form, mode = (1, 2 if key == "A1" else 0) if key in ("A1", "A2") else (0, 0)
        x = level_inputs(n, True, 22)
        xs, sl = slab_inputs(x, n, sh.Hloc[level], 0)
        tight, tight_sl = slab_inputs(x, n, n + 2, 0)
        whole, call, cuda_fn, plain_fn = slab_calls(sw, True, cfg)[leg]
        got, want = call(cuda_fn, xs, sl), call(plain_fn, xs, sl)
        torch.cuda.synchronize()

        def own(t):  # the rank's own grid rows of a slab or of its coarse slab
            fine = t.shape[1] == n + 1
            return t[GHOST : GHOST + min(sh.Hloc[level] // (1 if fine else 2),
                                         (n if fine else n // 2) + 1)]

        err, rel, rsq_rel = 0.0, 0.0, 0.0
        for g, w in zip(got, want):
            if g.dim() == 0:
                rsq_rel = abs(float(g) - float(w)) / max(abs(float(w)), 1e-30)
                continue
            e = float((own(g) - own(w)).abs().max())
            err, rel = max(err, e), max(rel, e / max(1.0, float(own(w).abs().max())))
        rows = sl.hi + GHOST
        dev = x[0].device
        launches = (("whole", sw._launch_tiles(key, n, True, form, mode, dev, 0)),
                    ("slab", sw._slab_strip(key, n, True, form, mode, dev, rows, sl.g)),
                    ("tight", sw._slab_strip(key, n, True, form, mode, dev,
                                             tight_sl.hi + GHOST, tight_sl.g)))
        grids = {name: slab_occupancy(key, n, form, mode, tiles, name != "whole")
                 for name, tiles in launches}
        out[key] = dict(n=n, rows=rows, max_abs_err=err, max_rel_err=rel, rsq_rel_err=rsq_rel,
                        ms=kernel_ms([lambda: call(cuda_fn, xs, sl)]),
                        plain_ms=plain_ms([lambda: call(plain_fn, xs, sl)]),
                        whole_ms=kernel_ms([lambda: whole(x)]),
                        tight_rows=tight_sl.hi + GHOST,
                        tight_ms=kernel_ms([lambda: call(cuda_fn, tight, tight_sl)]),
                        grids=grids, **slab_bound(leg, n, sl, True, FLOPS_PER_NODE[key]))
        if rel > sw.TOL or rsq_rel > sw.TOL:
            fail(f"{leg} slab form at the sharded solve's shapes disagrees with its plain "
                 f"form: {out[key]}")
    return out


def run_sharded_solve() -> dict:
    """``sharded_interface_4097``: ShardedHierarchyV2 in a world of 1 (the
    group up already) against the split HierarchyV2 path from the same
    decay start: the same cycles and tail q, the iterate bitwise."""
    import torch
    from multigrid_feanet_torch.core.problem import Problem
    from multigrid_feanet_torch.parallel.shard import ShardedHierarchyV2

    label, eps, max_cycles, chunk = "sharded_interface_4097", 1e-6, 120, 2
    t0 = time.time()
    sh = ShardedHierarchyV2(Problem(n=N_MAIN, inclusion=CIRCLE), num_levels=9,
                            kernel_threshold=32, direct_coarse=True, device=DEVICE)
    setup_s = time.time() - t0
    u0, f0 = decay_start(sh.base.hier.finest)
    starts = {False: u0, True: alt_start(sh.base.hier.finest)}
    graph_rec = distributed_graph_cell(
        label, sh, lambda s, graph, alt: s.solve(f0, u0=starts[alt], eps=eps,
                                                 max_cycles=max_cycles, chunk=chunk, graph=graph),
        lambda hist: chunk * -(-(len(hist) + 1) // chunk), chunk)
    del starts

    def run():
        return sh.solve(f0, u0=u0, eps=eps, max_cycles=max_cycles, chunk=chunk)

    (u, hist), launches = counted(run)
    if not all(launches.get(k) for k in ("A1_slab", "A2_slab", "A3_slab", "A4_slab")):
        fail(f"{label}: a slab form never launched: {launches}")
    split = build_hierarchy(N_MAIN, True, 9, 32, DEVICE)
    (u_ref, h_ref), split_launches = counted(
        lambda: split.solve(f0, u0=u0, eps=eps, max_cycles=max_cycles, chunk=chunk))

    def tail_q(h):
        return float(np.exp(np.mean(np.diff(np.log(h[-6:])))))

    walls = timed_runs(label, run, hist)
    split_walls = timed_runs("interface_4097 (split)", lambda: split.solve(
        f0, u0=u0, eps=eps, max_cycles=max_cycles, chunk=chunk), h_ref)
    cycles_run = chunk * -(-(len(hist) + 1) // chunk)
    rec = dict(solve=label, n=N_MAIN, world=sh.world, S=sh.S, Hloc=sh.Hloc, cycles=len(hist),
               split_cycles=len(h_ref), tail_q=tail_q(hist), split_tail_q=tail_q(h_ref),
               history_max_rel_diff=float(np.max(np.abs(hist / h_ref - 1)))
               if len(hist) == len(h_ref) else None,
               iterate_bitwise=bool(torch.equal(u, u_ref)), final_res=float(hist[-1]),
               ms_per_cycle=1e3 * min(walls) / cycles_run,
               split_ms_per_cycle=1e3 * min(split_walls) / cycles_run, setup_s=setup_s,
               launches=launches, split_launches=split_launches, graph_cell=graph_rec)
    print(json.dumps(rec), flush=True)
    if (len(hist) != len(h_ref) or not rec["iterate_bitwise"]
            or abs(rec["tail_q"] / rec["split_tail_q"] - 1) > 1e-5):
        fail(f"{label}: differs from the split HierarchyV2 path: {rec}")
    rec["slab_times"] = slab_times(sh)
    print(json.dumps({"slab_times": rec["slab_times"]}), flush=True)
    return rec


def run_distributed_cells() -> dict:
    """``distributed_1025`` and the data-parallel H-Net step on a world-1
    ("dp", "x", "y") mesh against their single-device twins."""
    import torch
    from multigrid_feanet_torch.core.problem import GridHierarchy, Problem, build_level
    from multigrid_feanet_torch.learn import train_hnet
    from multigrid_feanet_torch.parallel import sharding
    from multigrid_feanet_torch.solvers import multigrid

    mesh = sharding.make_mesh(device=DEVICE)
    n, eps = 1024, 1e-2
    hier = GridHierarchy.create(Problem(n=n, inclusion=CIRCLE), device=DEVICE)
    dh = sharding.DistributedHierarchy(hier, mesh)
    u0s = {alt: torch.as_tensor(np.random.default_rng(3 if alt else 2).uniform(
        size=(n + 1, n + 1)).astype(np.float32), device=DEVICE) * hier.finest.geo
        for alt in (False, True)}
    u0 = u0s[False]
    f0 = torch.zeros_like(u0)

    def graph_solve(dh, graph, alt):
        """graph_cell's (u, history) pair: ``res`` once for each cycle."""
        u, cycles, res = dh.solve(f0, u0=u0s[alt], eps=eps, max_cycles=100, graph=graph)
        return u, np.full(cycles, res)

    graph_rec = distributed_graph_cell("distributed_1025", dh, graph_solve, len, 1)
    t0 = time.time()
    u, cycles, res = dh.solve(f0, u0=u0, eps=eps, max_cycles=100)
    torch.cuda.synchronize()
    wall = time.time() - t0
    u_ref, h_ref = multigrid.solve(hier, f0, u0=u0, eps=eps, max_cycles=100, chunk=1)
    close = bool(torch.allclose(u, u_ref, rtol=1e-3, atol=1e-5))
    rec = dict(solve="distributed_1025", n=n, mesh=list(mesh.mesh.shape), S=dh.S, cycles=cycles,
               ref_cycles=len(h_ref), res=res, ref_res=float(h_ref[-1]), u_close=close,
               u_max_abs_diff=float((u - u_ref).abs().max()), wall_s=wall,
               ms_per_cycle=1e3 * wall / max(cycles, 1), graph_cell=graph_rec)
    level = build_level(Problem(n=32), 32, device=DEVICE)
    rng = np.random.default_rng(1)
    B = 4
    u_star, f = (torch.as_tensor(rng.standard_normal((B, 33, 33)).astype(np.float32),
                                 device=DEVICE) for _ in range(2))
    bc_value, bc_index = torch.zeros_like(u_star), torch.ones_like(u_star)
    dp_step = sharding.sharded_hnet_train_step(mesh)
    sa, la = dp_step(level, train_hnet.init_state(level, seed=0), u_star, f, bc_value, bc_index)
    sb, lb = train_hnet.train_step(level, train_hnet.init_state(level, seed=0), u_star, f,
                                   bc_value, bc_index)
    rec["hnet_dp_param_max_diff"] = float((sa.params - sb.params).detach().abs().max())
    rec["hnet_dp_loss_rel_diff"] = abs(float(la) / float(lb) - 1)
    print(json.dumps(rec), flush=True)
    if (cycles != len(h_ref) or not close or rec["hnet_dp_param_max_diff"] > 1e-6
            or rec["hnet_dp_loss_rel_diff"] > 1e-6):
        fail(f"distributed_1025 or the dp H-Net step differs from its twin: {rec}")
    return rec


def in_world1(run):
    """``run()`` in a world-1 NCCL group on ``tcp://localhost:<free port>``,
    destroyed after it."""
    import torch.distributed as dist
    from multigrid_feanet_torch.parallel.sharding import init_distributed

    init_distributed(f"tcp://localhost:{free_port()}", 1, 0, device=DEVICE)
    try:
        return run()
    finally:
        dist.destroy_process_group()


def nccl_capture_check() -> dict:
    """NCCL under CUDA graph capture, on a new group of the world-1 ranks
    made with the flight recorder on (``TORCH_FR_BUFFER_SIZE``, read when
    a group is made; NCCL's recorder): a graph of a ~20 ms device spin, an
    ``all_reduce`` (blocking call), an ``all_gather`` into a list of chunk
    views (async, ``wait()``) and an add, captured on a side stream after
    one eager round has made the communicator, then replayed.  Records the
    host time of a replay call against its device time (a host blocked on
    NCCL would take the spin's time), the recorder's entries of the eager
    round and those made since (the watchdog retires the works it tracks
    there once they are done), ``TORCH_NCCL_BLOCKING_WAIT``, and an eager
    ``all_reduce`` after the replays.  Fails on a wrong value or a
    captured work the watchdog retired."""
    import os

    import torch
    import torch.distributed as dist

    keys = ("TORCH_FR_BUFFER_SIZE", "TORCH_NCCL_TRACE_BUFFER_SIZE")
    before = {k: os.environ.get(k) for k in keys}
    os.environ.update({k: "64" for k in keys})
    try:
        group = dist.new_group()
    finally:
        for k, v in before.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v
    world = dist.get_world_size(group)
    x = torch.ones(1024, device=DEVICE)
    out = torch.empty(world * 1024, device=DEVICE)

    def body():
        torch.cuda._sleep(40_000_000)
        dist.all_reduce(x, group=group)
        dist.all_gather(list(out.chunk(world)), x, group=group, async_op=True).wait()
        x.add_(1.0)

    c10d = torch._C._distributed_c10d
    dump = getattr(c10d, "_dump_nccl_trace_json", c10d._dump_fr_trace_json)

    def entries(after=-1):
        raw = dump(True, False)
        return [dict(id=e["record_id"], name=e["profiling_name"], state=e["state"],
                     retired=e["retired"]) for e in json.loads(raw).get("entries", [])
                if e["record_id"] > after]

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        body()  # makes the communicator
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    time.sleep(1.0)  # the watchdog's polls
    eager = entries()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        body()
    host, device = [], []
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        t0 = time.perf_counter()
        graph.replay()
        host.append(1e3 * (time.perf_counter() - t0))
        end.record()
        torch.cuda.synchronize()
        device.append(start.elapsed_time(end))
    value = float(x[0])  # 1 eager round, 3 replays: each adds 1 (all_reduce of world 1)
    time.sleep(1.0)  # the watchdog's polls
    captured = entries(max((e["id"] for e in eager), default=-1))
    dist.all_reduce(x, group=group)
    torch.cuda.synchronize()
    del graph
    dist.destroy_process_group(group)
    rec = dict(torch=torch.__version__, nccl=list(torch.cuda.nccl.version()),
               blocking_wait=os.environ.get("TORCH_NCCL_BLOCKING_WAIT"),
               replay_host_ms=host, replay_device_ms=device, value=value,
               eager_entries=eager, captured_entries=captured, after_eager=float(x[0]))
    print(json.dumps({"nccl_capture": rec}), flush=True)
    if (value != 5.0 or rec["after_eager"] != 5.0 or min(device) < 5.0
            or any(e["retired"] for e in captured)):
        fail(f"NCCL under capture: a wrong value, no spin in the replays or a captured work "
             f"in the watchdog: {rec}")
    return rec


def run_slice21() -> dict:
    """The slab legs, then, in a world-1 NCCL group, the sharded solvers."""
    recs = []
    for n in (N_MAIN,) + A34_LEVELS:
        for bim in (True, False):
            for dform in (False, True):
                recs += check_slab_level(n, bim, dform)
    print(json.dumps({"slab_legs": recs}), flush=True)
    nccl, sharded, distributed = in_world1(lambda: (nccl_capture_check(), run_sharded_solve(),
                                                    run_distributed_cells()))
    return dict(slab_legs=recs, nccl_capture=nccl, sharded=sharded, distributed=distributed)


# ---- slice 22: the slab forms of E2 and E3 and the sharded H-MG ----


def hslab_calls(hx, params, cfg: dict) -> dict:
    """leg -> (whole-field call, slab call(fn, slab inputs, slab), the slab
    form's CUDA and plain functions) of E2 and E3 in the plain form; inputs
    are (u, f, uc, ph)."""
    kw = dict(cfg, dform=False)
    return {
        "E2": (lambda x: hx.hswrr_cuda(x[0], x[1], x[3], params, **kw),
               lambda fn, x, sl: fn(x[0], x[1], x[3], params, slab=sl, **kw),
               hx.hswrr_slab_cuda, hx.hswrr_plain),
        "E3": (lambda x: (hx.phrelax_cuda(x[0], x[1], x[3], x[2], params, **kw),),
               lambda fn, x, sl: (fn(x[0], x[1], x[3], x[2], params, slab=sl, **kw),),
               hx.phrelax_slab_cuda, hx.phrelax_plain),
    }


def hslab_grids(hx, leg: str, n: int, bim: bool, rows: int, g: int) -> dict:
    """The whole field's and the slab's grids of a launch of E2 or E3 at
    level n: blocks, blocks per SM and waves (row streaming; the one-pass
    tile's blocks only)."""
    import ctypes

    import torch
    from multigrid_feanet_torch import _build

    dev = torch.device(DEVICE, torch.cuda.current_device())
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    lib = _build.load()
    if leg == "E2":
        whole = hx.e2_launch_tiles(n, 1, bim, False, dev)
        slab = hx.e2_slab_launch_tiles(n, 1, bim, dev, rows, g)
        queries = ((lib.mg_hswrr_occupancy, (int(bim), 0, 1)),
                   (lib.mg_hswrr_slab_occupancy, (int(bim),)))
    else:
        whole = hx.e3_launch_tiles(n, 1, bim, False, dev)
        slab = hx.e3_slab_launch_tiles(n, 1, bim, dev, rows, g)
        queries = ((lib.mg_phrelax_occupancy, (int(bim), 0, 1, whole.strip)),
                   (lib.mg_phrelax_slab_occupancy, (int(bim), whole.strip)))
    out = {}
    for name, tiles, (fn, args) in zip(("whole", "slab"), (whole, slab), queries):
        rec = dict(design=tiles.leg, strip=tiles.strip, gx=tiles.gx, gy=tiles.gy,
                   blocks=tiles.blocks)
        if not tiles.leg.endswith("tile"):
            fn.argtypes, fn.restype = [ctypes.c_int] * len(args), ctypes.c_int
            per_sm = fn(*args)
            if per_sm <= 0:
                fail(f"{fn.__name__}: CUDA error {-per_sm}")
            rec.update(blocks_per_sm=per_sm, waves=tiles.blocks / (per_sm * sms))
        out[name] = rec
    return out


def check_hslab_level(n: int, bim: bool, params, Hloc: int, world1, seed: int = 23) -> list:
    """E2 and E3 in slab form at level n on N_SLABS quarter slabs and on
    ``world1``, the world-1 solver's own slab of the level (``Hloc`` own
    rows): each slab's own rows (E2: and the coarse rows under them)
    bitwise the whole-field kernel's, the partial norms' sum within 1e-7 of
    its norm, each slab held to its plain slab form at TOL; the world-1
    slab's launch
    and its plain form timed beside the whole field's launch, with the
    bound on its grid rows and the grids.  One record per leg."""
    import torch
    from multigrid_feanet_torch.ops import hrelax as hx

    H, Hc = n + 1, n // 2 + 1
    quarter = -(-H // N_SLABS)
    quarter += quarter % 2
    x = level_inputs(n, bim, seed)
    cfg = dict(a0=1.0, da=19.0 if bim else 0.0, omega=2.0 / 3.0)
    layouts = {"quarter": (quarter, [slab_inputs(x, n, quarter, r) for r in range(N_SLABS)]),
               "world1": (Hloc, [cut_slab(x, world1)])}
    recs = []
    for leg, (whole, call, cuda_fn, plain_fn) in hslab_calls(hx, params, cfg).items():
        want = whole(x)
        rec = dict(name=f"{leg}_slab", n=n, bim=bim, L=1, dform=False)
        for layout, (Hloc, slabs) in layouts.items():
            got = [call(cuda_fn, xs, sl) for xs, sl in slabs]
            plain = [call(plain_fn, xs, sl) for xs, sl in slabs]
            torch.cuda.synchronize()
            res = rec[layout] = dict(slabs=len(slabs), Hloc=Hloc,
                                     **compare_slabs(got, plain, want, Hloc, H, Hc))
            if (not res["bitwise_whole"] or res["max_rel_err"] > hx.TOL
                    or res["rsq_plain_rel_err"] > hx.TOL or res.get("rsq_parts_rel_err", 0.0) > 1e-7):
                fail(f"{leg} slab form disagrees on the {layout} slabs: {rec}")
        xs, sl = layouts["world1"][1][0]
        rows = sl.hi + GHOST
        rec.update(rows=rows, **slab_bound(leg, n, sl, bim, hrelax_flops(leg, bim, False, 1)),
                   max_abs_err=rec["world1"]["max_abs_err"],
                   ms=kernel_ms([lambda: call(cuda_fn, xs, sl)]),
                   whole_ms=kernel_ms([lambda: whole(x)]),
                   plain_ms=plain_ms([lambda: call(plain_fn, xs, sl)]),
                   grids=hslab_grids(hx, leg, n, bim, rows, sl.g))
        recs.append(rec)
    return recs


def hmg_pair(bim: bool):
    """ShardedHMG in the group and HMGHierarchy(coarse_zero_legs=False)
    with hmg_4097's settings (plain form) on the 4097^2 problem."""
    from multigrid_feanet_torch.core.problem import Problem
    from multigrid_feanet_torch.parallel.shard import ShardedHMG
    from multigrid_feanet_torch.solvers.hmg import HMGHierarchy

    prob = Problem(n=N_MAIN, inclusion=CIRCLE if bim else None)
    cfg = dict(num_levels=9, kernel_threshold=32, direct_coarse=True, device=DEVICE)
    return ShardedHMG(prob, **cfg), HMGHierarchy(prob, coarse_zero_legs=False, **cfg)


def run_sharded_hmg(sh, whole, setup_s: float, params) -> dict:
    """``sharded_hmg_4097``: ``sh``, a ShardedHMG in a world of 1 (the
    group up already), against ``whole``, HMGHierarchy(coarse_zero_legs=
    False), from the same decay start: the same cycles, the history and the
    iterate bitwise, E2 and E3 launched in slab form (at most once per
    sharded level and cycle each); then the bi-material 4097^2 problem, 4
    cycles at eps 0, the history and the iterate bitwise.  Each solver
    first runs ``distributed_graph_cell``."""
    import torch

    label, eps, max_cycles, chunk = "sharded_hmg_4097", 1e-6, 40, 2
    u0, f0 = decay_start(sh.base.hier.finest)
    nets = {False: params, True: load_params(HNET_L1_ALT)}

    def graph_cell_of(sh, label, eps, max_cycles):
        """distributed_graph_cell of ``sh``: the re-solve from another u0
        with another net."""
        starts = {False: u0, True: alt_start(sh.base.hier.finest)}
        return distributed_graph_cell(
            label, sh, lambda s, graph, alt: s.solve(nets[alt], f0, u0=starts[alt], eps=eps,
                                                     max_cycles=max_cycles, chunk=chunk,
                                                     graph=graph),
            lambda hist: max_cycles if eps == 0.0 else chunk * -(-(len(hist) + 1) // chunk),
            chunk)

    graph_rec = graph_cell_of(sh, label, eps, max_cycles)

    def run(solver):
        return lambda: solver.solve(params, f0, u0=u0, eps=eps, max_cycles=max_cycles,
                                    chunk=chunk)

    (u, hist), launches = counted(run(sh))
    (u_ref, h_ref), whole_launches = counted(run(whole))
    cycles_run = chunk * -(-(len(hist) + 1) // chunk)
    most = sh.S * cycles_run
    if not all(1 <= launches.get(k, 0) <= most for k in ("E2_slab", "E3_slab")):
        fail(f"{label}: E2 or E3 in slab form launched none or more than {most} times: "
             f"{launches}")

    def tail_q(h):
        return float(np.exp(np.mean(np.diff(np.log(h[-6:])))))

    walls = timed_runs(label, run(sh), hist)
    whole_walls = timed_runs("hmg_4097 (coarse_zero_legs=False)", run(whole), h_ref)
    rec = dict(solve=label, n=N_MAIN, world=sh.world, S=sh.S, Hloc=sh.Hloc, cycles=len(hist),
               whole_cycles=len(h_ref), tail_q=tail_q(hist), whole_tail_q=tail_q(h_ref),
               history_bitwise=bool(np.array_equal(hist, h_ref)),
               iterate_bitwise=bool(torch.equal(u, u_ref)), final_res=float(hist[-1]),
               cycles_run=cycles_run, ms_per_cycle=1e3 * min(walls) / cycles_run,
               whole_ms_per_cycle=1e3 * min(whole_walls) / cycles_run, setup_s=setup_s,
               launches=launches, whole_launches=whole_launches,
               profile=profile_solve(run(sh), cycles_run, min(walls)),
               whole_profile=profile_solve(run(whole), cycles_run, min(whole_walls)),
               graph_cell=graph_rec)
    print(json.dumps(rec), flush=True)
    if (len(hist) >= max_cycles or not hist[-1] <= eps or not rec["history_bitwise"]
            or not rec["iterate_bitwise"] or len(hist) != len(h_ref)):
        fail(f"{label}: differs from HMGHierarchy(coarse_zero_legs=False) or did not "
             f"converge: {rec}")
    del sh, whole, u, u_ref
    torch.cuda.empty_cache()

    sh, whole = hmg_pair(True)
    u0, f0 = decay_start(sh.base.hier.finest)
    bim_graph_rec = graph_cell_of(sh, "sharded_hmg_interface_4097_4cycles", 0.0, 4)
    u, hist = sh.solve(params, f0, u0=u0, eps=0.0, max_cycles=4, chunk=2)
    u_ref, h_ref = whole.solve(params, f0, u0=u0, eps=0.0, max_cycles=4, chunk=2)
    bim = dict(solve="sharded_hmg_interface_4097_4cycles", cycles=len(hist),
               iterate_bitwise=bool(torch.equal(u, u_ref)),
               history_bitwise=bool(np.array_equal(hist, h_ref)),
               history=[float(h) for h in hist], whole_history=[float(h) for h in h_ref],
               graph_cell=bim_graph_rec)
    print(json.dumps(bim), flush=True)
    if not bim["iterate_bitwise"] or not bim["history_bitwise"] or not torch.isfinite(u).all():
        fail(f"the bi-material sharded H-MG differs from the whole field's: {bim}")
    del sh, whole, u, u_ref
    torch.cuda.empty_cache()
    return dict(rec, bim=bim)


def run_slice22() -> dict:
    """In a world-1 NCCL group: sharded_hmg_4097's ShardedHMG, the slab
    legs of E2 and E3 at each of its sharded levels (on quarter slabs and
    on the solver's own slab), then the sharded H-MG solves."""
    params = load_params(HNET_L1)

    def run():
        t0 = time.time()
        sh, whole = hmg_pair(False)
        setup_s = time.time() - t0
        recs = []
        for level in range(sh.S):
            for bim in (False, True):
                recs += check_hslab_level(sh.base.hier.levels[level].n, bim, params,
                                          sh.Hloc[level], sh.slabs[level].slab)
        print(json.dumps({"hslab_legs": recs}), flush=True)
        return dict(hslab_legs=recs, sharded_hmg=run_sharded_hmg(sh, whole, setup_s, params))

    return in_world1(run)


# The one-dispatch solves: on the card each fused entry point replays its
# captured chunks (solvers/common.py::ChunkGraphs); ``graph=False`` runs its
# eager loop, the twin every replayed solve is held to bit for bit.  Per
# cell: (solver, solve(solver, graph, alt) -> (u, history), cycles run by a
# history, the wrapper calls a warm solve makes outside its replays, the
# captures the solver holds after it).  ``alt`` re-solves from another u0
# (and, for H-MG, with other H-Net kernels).
HNET_L1_ALT = "results/learn_iterator/hnet_decay_L1_hl1.npz"


def zero_counts() -> dict:
    kernels = all_kernels()
    for k in kernels.values():
        k.launches = k.replayed = 0
    return kernels


def own_calls(run):
    """``run()`` with every count zeroed just before it: its result, the
    launches of each kernel (replays included) and the wrapper calls made
    outside the replays."""
    import torch

    kernels = zero_counts()
    out = run()
    torch.cuda.synchronize()
    launches = {key: k.launches for key, k in kernels.items() if k.launches}
    own = {key: k.launches - k.replayed for key, k in kernels.items() if k.launches - k.replayed}
    return out, launches, own


def same_bits(a, b) -> bool:
    (ua, ha), (ub, hb) = a, b
    return (ua.dtype == ub.dtype and bool((ua == ub).all()) and len(ha) == len(hb)
            and np.array_equal(ha, hb))


def graph_cell(label: str, solver, solve, cycles_of, outside, captures: int,
               tf32_check: bool = False) -> dict:
    """Hold one cell's replayed solve to its eager loop bit for bit (the
    first, capturing solve and a warm one), its launch counts to the eager
    loop's, the warm solve's own wrapper calls to ``outside`` (a dict, or a
    function of the eager loop's history that gives one), the solver's
    captures to ``captures``; a re-solve with other inputs both ways, bit
    for bit, leaving the warm solve's u unchanged.  Then the walls (best of
    three) and torch.profiler's device time of both paths."""
    import torch

    before = solver.graphs.captures
    cold = solve(solver, True, False)
    eager, launches_e = counted(lambda: solve(solver, False, False))
    if callable(outside):
        outside = outside(eager[1])
    warm, launches_g, own = own_calls(lambda: solve(solver, True, False))
    kept = warm[0].clone()
    alt_g, alt_e = solve(solver, True, True), solve(solver, False, True)
    checks = dict(cold_bitwise=same_bits(cold, eager), warm_bitwise=same_bits(warm, eager),
                  alt_bitwise=same_bits(alt_g, alt_e), first_u_kept=bool((warm[0] == kept).all()),
                  launches_equal=launches_g == launches_e, own_calls=own == outside,
                  captures=solver.graphs.captures == captures and before < captures)
    if tf32_check:
        # the graph keeps the TF32 settings in force at its capture
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            checks["tf32_flip_bitwise"] = same_bits(solve(solver, True, False), eager)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
    hist = eager[1]
    cycles = cycles_of(hist)
    rec = dict(solve=label, cycles=len(hist), cycles_run=cycles, captures=solver.graphs.captures,
               own_calls=own, launches=launches_g, checks=checks)
    for path, graph in (("graph", True), ("eager", False)):
        def run(graph=graph):
            return solve(solver, graph, False)

        walls = timed_runs(f"{label}_{path}", run, hist)
        prof = profile_solve(run, cycles, min(walls))
        rec[path] = dict(ms_per_cycle=1e3 * min(walls) / cycles, walls_s=walls,
                         busy_ms_per_cycle=prof.get("busy_ms_per_cycle"),
                         busy_share=prof.get("busy_share_of_wall"),
                         profiled_launches=sum(r["launches"] for k, r in
                                               prof.get("by_kernel", {}).items()
                                               if not k.startswith("torch:")),
                         profiled_by_kernel={k: r["launches"] for k, r in
                                             prof.get("by_kernel", {}).items()},
                         tf32_kernels=prof.get("tf32_kernels", []))
    print(json.dumps({"graph_cell": rec}), flush=True)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        fail(f"{label}: the replayed solve misses {failed}: own calls {own} (expected "
             f"{outside}), captures {solver.graphs.captures} (expected {captures})")
    if rec["graph"]["tf32_kernels"]:
        fail(f"{label}: the replayed solve ran TF32 kernels: {rec['graph']['tf32_kernels']}")
    return rec


def distributed_graph_cell(label: str, solver, solve, cycles_of, chunk: int) -> dict:
    """``graph_cell`` for a distributed solver in the group (fresh: no
    capture yet): its one-dispatch solve, one replay per ``chunk`` cycles
    with the NCCL collectives inside, against ``graph=False``, no wrapper
    call outside the replays, one capture.  Adds the launches per replay
    (the warm solve's counts over its replays) and holds each kernel's
    torch.profiler launches on the graph path to at most its counted ones
    (the profiler drops records; torch's own kernels are not counted)."""
    rec = graph_cell(label, solver, solve, cycles_of, {}, 1)
    replays = rec["cycles_run"] / chunk
    profiled = rec["graph"]["profiled_by_kernel"]
    over = {k: (n, rec["launches"][k]) for k, n in profiled.items()
            if k in rec["launches"] and n > rec["launches"][k]}
    out = dict(solve=label, captures=rec["captures"], replays_per_solve=replays,
               launches_per_replay={k: n / replays for k, n in rec["launches"].items()},
               profiled_launches_at_most_counted=not over,
               **{f"{path}_{key}": rec[path][key] for path in ("graph", "eager")
                  for key in ("ms_per_cycle", "busy_ms_per_cycle", "busy_share")})
    print(json.dumps({"distributed_graph_cell": out}), flush=True)
    if over:
        fail(f"{label}: torch.profiler saw more launches than the wrappers counted: {over}")
    return dict(rec, **out)


def alt_start(lv0, seed: int = 1):
    """Another decay start on ``lv0``: 150000 * uniform(rng ``seed``) on the
    interior."""
    import torch

    u1 = np.random.default_rng(seed).uniform(size=(lv0.n + 1, lv0.n + 1)).astype(np.float32)
    return 150000.0 * torch.as_tensor(u1, device=lv0.device) * lv0.geo


def run_graph_cells() -> list:
    """The replayed solves of the seven entry points against their eager
    loops (``graph_cell``), on the 4097^2 and 2049^2 cells."""
    import torch
    from multigrid_feanet_torch.core.problem import GridHierarchy, Problem
    from multigrid_feanet_torch.ops.boxmg import boxmg_setup
    from multigrid_feanet_torch.ops.stencil import apply_mass
    from multigrid_feanet_torch.solvers.boxmg import BoxMGHierarchy
    from multigrid_feanet_torch.solvers.hmg import HMGHierarchy
    from multigrid_feanet_torch.solvers.mg import solve_ir

    eps, recs, starts = 1e-6, [], {}

    def decay(solver, alt):
        """The decay start on the solver's finest level, drawn once per
        solver (drawing takes longer than a solve); ``alt``: another u0,
        150000 * uniform(rng 1) on the interior."""
        if starts.get("solver") is not solver:
            u0, f0 = decay_start(solver.hier.finest)
            u1 = alt_start(solver.hier.finest)
            starts.update(solver=solver, fields={False: (u0, f0), True: (u1, f0)})
        return starts["fields"][alt]

    def lagged(chunk):
        return lambda hist: chunk * -(-(len(hist) + 1) // chunk)

    def v2_solve(**opts):
        def solve(hv, graph, alt):
            u0, f0 = decay(hv, alt)
            return hv.solve(f0, u0=u0, eps=eps, max_cycles=120, chunk=2, graph=graph, **opts)
        return solve

    v2 = [("interface_4097", True, None, {}), ("interface_4097_bf16", True, torch.bfloat16, {}),
          ("poisson_4097", False, None, {}), ("pswrr_interface_4097", True, None,
                                              dict(use_pswrr=True))]
    for label, bim, dtype, opts in v2:
        hv = build_hierarchy(N_MAIN, bim, 9, 32, DEVICE, dtype)
        K = hv.K
        # outside A6's chunks: the peeled descent (A2 and the coarse
        # correction's A3/A4 on levels 1..K-1) and the closing ascent (A1)
        outside = {"A2": 1, "A3": K - 1, "A4": K - 1, "A1": 1} if opts else {}
        recs.append(graph_cell(label, hv, v2_solve(**opts), lagged(2), outside, 1,
                               tf32_check=label == "interface_4097"))
        if label == "interface_4097":
            def pcg(hv, graph, alt):
                u0, f0 = decay(hv, alt)
                return hv.solve_pcg(f0, u0=u0, eps=eps, max_iters=60, graph=graph)

            # outside the iterations: the start's residual (A1) and
            # preconditioner (A3/A4 on levels 0..K-1)
            recs.append(graph_cell("pcg_interface_4097", hv, pcg, len,
                                   {"A1": 1, "A3": K, "A4": K}, 3))
        del hv

    for label, bim, cap in (("hmg_4097", False, 40), ("hmg_interface_4097", True, 60)):
        params = {False: load_params(HNET_L1), True: load_params(HNET_L1_ALT)}
        hm = HMGHierarchy(Problem(n=N_MAIN, inclusion=CIRCLE if bim else None), num_levels=9,
                          kernel_threshold=32, direct_coarse=True, dform=bim, device=DEVICE)

        def hmg(hm, graph, alt, cap=cap):
            u0, f0 = decay(hm, alt)
            return hm.solve(params[alt], f0, u0=u0, eps=eps, max_cycles=cap, chunk=2,
                            graph=graph)

        recs.append(graph_cell(label, hm, hmg, lagged(2), {}, 1))
        del hm

    prob = Problem(n=N_MAIN, inclusion=CIRCLE)
    hier = GridHierarchy.create(prob, 9, device=DEVICE)
    bm = BoxMGHierarchy(prob, num_levels=9, kernel_threshold=32, direct_coarse=True, hier=hier,
                        setup=boxmg_setup(hier, 9, dtype=torch.float32),
                        coef_dtype=torch.bfloat16, device=DEVICE)

    def boxmg(bm, graph, alt):
        u0, f0 = decay(bm, alt)
        return bm.solve(f0, u0=u0, eps=eps, max_cycles=60, chunk=2, graph=graph)

    recs.append(graph_cell("boxmg_4097", bm, boxmg, lagged(2), {}, 1))
    del bm, hier

    r1 = build_r1(N_MAIN, False, 9, 32)

    def r1_solve(h, graph, alt):
        u0, f0 = decay(h, alt)
        return h.solve(f0, u0=u0, eps=eps, max_cycles=60, graph=graph)

    recs.append(graph_cell("poisson_4097_r1", r1, r1_solve, len, {}, 1))
    del r1

    hv = build_hierarchy(N_MAIN, False, 9, 32, DEVICE)
    f_ir = apply_mass(torch.ones((N_MAIN + 1, N_MAIN + 1), device=DEVICE), hv.hier.finest.h)

    def ir(hv, graph, alt):
        u0 = decay(hv, True)[0] * 1e-9 if alt else None
        return solve_ir(hv, f_ir, u0=u0, eps=eps, cycles_per_correction=6, max_outer=12,
                        graph=graph)

    # outside the corrections' replays: one X4 outer step per history entry
    recs.append(graph_cell("ir_4097", hv, ir, lambda hist: 6 * (len(hist) - 1),
                           lambda hist: {"X4": len(hist)}, 1))
    del hv
    starts.clear()

    he = build_elastic(16)
    rng = {alt: np.random.default_rng(1 + alt).standard_normal((2, N_EL + 1, N_EL + 1))
           for alt in (False, True)}
    u0s = {alt: torch.as_tensor(v.astype(np.float32), device=DEVICE) for alt, v in rng.items()}
    f_el = torch.zeros_like(u0s[False])

    def elastic(he, graph, alt):
        return he.solve(f_el, u0=u0s[alt], nu1=2, nu2=2, eps=0.0, max_cycles=12, graph=graph)

    def elastic_pcg(he, graph, alt):
        return he.solve_pcg(f_el, u0=u0s[alt], nu1=2, nu2=2, eps=0.0, max_iters=16,
                            graph=graph)

    recs.append(graph_cell("elastic_2049", he, elastic, lambda hist: 12, {}, 1))
    # outside the iterations: the start's residual (G1) and its V(2,2)
    # preconditioner from zero (2 G1, G2 and G3 on levels 0..K-1)
    recs.append(graph_cell("elastic_pcg_2049", he, elastic_pcg, len,
                           {"G1": 1 + 2 * he.K, "G2": he.K, "G3": he.K}, 3))
    del he
    print(json.dumps({"graph_cells": [
        dict(solve=r["solve"], cycles=r["cycles"], captures=r["captures"],
             **{f"{path}_{key}": r[path][key] for path in ("graph", "eager")
                for key in ("ms_per_cycle", "busy_ms_per_cycle", "busy_share",
                            "profiled_launches")}) for r in recs]}), flush=True)
    return recs


# ---------------------------------------------------------------------------
# Slice 24: the JAX package's XLA-fused passes as kernels X1-X4
# (ops/passes.py, csrc/passes.cu)
# ---------------------------------------------------------------------------

FP64_FLOP_PER_S = 34e12  # H100 SXM float64 outside the tensor cores (NVIDIA data sheet)
# operations per output node, counted from csrc/passes.cu: X1 two mass
# applies (18 each), the mix (3), K (homogeneous 18; bitplane 18 + 4 x 10)
# and the combination (4); X2 three row filters and the column filter (4
# each) and the x4, per coarse node; X3 at most the two column midpoints,
# the row midpoint, x geo and the add; X4 (f64) u + e geo (2), A (18; 58)
# the residual and its square (3)
PASS_FLOPS = {("X1", False): 61, ("X1", True): 101, ("X2", False): 17, ("X3", False): 8,
              ("X4", False): 23, ("X4", True): 63}
PASS_SIZES = (N_MAIN, 32, 64, 256)  # 4097^2 and 33^2, 65^2, 257^2
X4_F32_TOL = 2.0 ** -23  # X4's float32 r: one rounding of an f64 value that agrees to TOL64


def pass_bytes(key: str, n: int, bim: bool, es: int = 4, two_f: bool = False,
               fs: int = 4) -> int:
    """Bytes X1-X4 must move on an (n+1)^2 grid, each input read once and
    each output written once: X1 u and b (``es`` bytes), f (``fs`` bytes,
    once, or f0 and f1 when ``two_f``), pid; X2 the fine interior and the
    coarse field; X3 u, u_c, geo and u; X4 u, f, geo and u' (f64), e
    (``es``), pid and r (f32)."""
    H2, Hc2, ph = (n + 1) ** 2, (n // 2 + 1) ** 2, (n + 1) ** 2 if bim else 0
    return {"X1": H2 * (2 * es + fs * (1 + two_f)) + ph, "X2": 4 * (n - 1) ** 2 + 4 * Hc2,
            "X3": 12 * H2 + 4 * Hc2, "X4": H2 * (32 + es + 4) + ph}[key]


def pass_bound(key: str, n: int, bim: bool, nbytes: int, f64: bool = False):
    """(bound ms, "bytes" or "operations") of one X launch (``f64``: X1 in
    float64)."""
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    nodes = (n // 2 + 1) ** 2 if key == "X2" else (n + 1) ** 2
    rate = FP64_FLOP_PER_S if key == "X4" or f64 else FP32_FLOP_PER_S
    t_ops = 1e3 * PASS_FLOPS[(key, bim and key in ("X1", "X4"))] * nodes / rate
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def pass_forms(n: int) -> dict:
    """The operator forms X1 and X4 take on the (n+1)^2 levels, bi-material
    (circle) and homogeneous, f32 and f64, as the paths read them
    (``ops.passes.operator_form``), keyed (bim, dtype)."""
    import torch
    from multigrid_feanet_torch.core.problem import Problem, build_level
    from multigrid_feanet_torch.ops.passes import operator_form

    return {(bim, dt): operator_form(build_level(Problem(n=n, inclusion=CIRCLE if bim else None,
                                                         dtype=dt), n, device=DEVICE))
            for bim in (True, False) for dt in (torch.float32, torch.float64)}


def pass_inputs(n: int, seed: int) -> dict:
    """Seeded fields of one (n+1)^2 grid on the card: standard normal u, f0,
    f1 (f32 and f64), the coarse u_c, the interior mask; f64 u, f and geo, a
    correction e of 1e-3 standard normal (f32 and bf16)."""
    import torch

    rng = np.random.default_rng(seed)
    H, Hc = n + 1, n // 2 + 1
    geo = np.zeros((H, H))
    geo[1:-1, 1:-1] = 1.0

    def t(x, dtype=torch.float32):
        return torch.as_tensor(x, device=DEVICE).to(dtype).contiguous()

    u, f0, f1 = rng.standard_normal((3, H, H))
    e = 1e-3 * rng.standard_normal((H, H))
    return dict(u=t(u), f0=t(f0), f1=t(f1), uc=t(rng.standard_normal((Hc, Hc))), geo=t(geo),
                u64=t(u, torch.float64), f064=t(f0, torch.float64), f164=t(f1, torch.float64),
                f64=t(rng.standard_normal((H, H)), torch.float64), geo64=t(geo, torch.float64),
                e=t(e), e_bf16=t(e, torch.bfloat16))


def pass_legs(x: dict, forms: dict, n: int) -> list:
    """``hold``'s arguments for every variant of X1-X4 on the fields ``x``
    of pass_inputs(n) and the operator ``forms`` of pass_forms(n): (leg,
    call, kernel, plain version, inputs, cfg, bytes, tolerance, tags).  X1
    in f32 and bf16 storage, with one f (the constant source the march
    passes as both knots) or two, and in f64 (a float64 problem, two f), bit
    for bit (a bf16 b within one bf16 ulp); X2 and X3 bit for bit; X4 with
    an f32 and a bf16 correction at ``TOL64``, its f32 residual within one
    f32 rounding.  Each bi-material and homogeneous."""
    import torch
    from multigrid_feanet_torch.ops import passes as px

    def one_f(fn, y, kw):
        return fn(y[0], y[1], y[1], y[2], **kw)

    def two_f(fn, y, kw):
        return fn(y[0], y[1], y[2], y[3], **kw)

    def direct(fn, y, kw):
        return fn(*y, **kw)

    x1 = (px.heat_rhs_cuda, px.heat_rhs_plain)
    x4 = (px.outer_step_cuda, px.outer_step_plain)
    legs = []
    for bim in (True, False):
        for dtype in (torch.float32, torch.float64):
            form = dict(forms[(bim, dtype)])
            pid = form.pop("pid")
            cfg = dict(h=2.0 / n, theta=HEAT_THETA, dt=HEAT_DT, **form)
            if dtype == torch.float32:
                for bf16 in (False, True):
                    u = x["u"].to(torch.bfloat16) if bf16 else x["u"]
                    es = 2 if bf16 else 4
                    legs += [("X1", one_f, *x1, (u, x["f0"], pid), cfg,
                              pass_bytes("X1", n, bim, es), 0.0,
                              dict(bim=bim, bf16=bf16, two_f=False)),
                             ("X1", two_f, *x1, (u, x["f0"], x["f1"], pid), cfg,
                              pass_bytes("X1", n, bim, es, True), 0.0,
                              dict(bim=bim, bf16=bf16, two_f=True))]
                continue
            legs.append(("X1", two_f, *x1, (x["u64"], x["f064"], x["f164"], pid), cfg,
                         pass_bytes("X1", n, bim, 8, True, 8), 0.0,
                         dict(bim=bim, bf16=False, two_f=True, f64=True)))
            for bf16 in (False, True):
                e = x["e_bf16"] if bf16 else x["e"]
                legs.append(("X4", direct, *x4, (x["u64"], e, x["f64"], x["geo64"], pid), form,
                             pass_bytes("X4", n, bim, 2 if bf16 else 4),
                             (px.TOL64, X4_F32_TOL, px.TOL64), dict(bim=bim, bf16=bf16)))
    return legs + [("X2", direct, px.restrict_cuda, px.restrict_plain, (x["u"],), {},
                    pass_bytes("X2", n, False), 0.0, {}),
                   ("X3", direct, px.prolong_add_cuda, px.prolong_add_plain,
                    (x["u"], x["uc"], x["geo"]), {}, pass_bytes("X3", n, False), 0.0, {})]


def x1_library(x: dict, form: dict, n: int, two_f: bool):
    """One PyTorch call that computes homogeneous X1 in full f32 on the
    fields of pass_inputs(n): ``F.conv2d`` of (u, f) or (u, f0, f1) stacked
    as input channels, padding 1, with the weights (M - (1 - theta) dt K,
    dt M) or (M - (1 - theta) dt K, (1 - theta) dt M, theta dt M), M the
    mass stencil h^2 MASS_KERNEL and K the (3, 3) table; returns the call
    (its input stacked once, outside it) and its result."""
    import torch
    import torch.nn.functional as F
    from multigrid_feanet_torch.core.device import full_f32
    from multigrid_feanet_torch.ops.stencil import MASS_KERNEL

    th, dt, h = HEAT_THETA, HEAT_DT, 2.0 / n
    m, k = (h * h) * MASS_KERNEL, np.asarray(form["table"], np.float64)
    ws = [m - (1.0 - th) * dt * k] + ([(1.0 - th) * dt * m, th * dt * m] if two_f else [dt * m])
    wt = torch.as_tensor(np.stack(ws)[None], dtype=torch.float32, device=DEVICE)
    xin = torch.stack([x["u"], x["f0"]] + ([x["f1"]] if two_f else []))[None]

    def run():
        with full_f32():
            return F.conv2d(xin, wt, padding=1)

    return run, run()[0, 0]


def x1_design(n: int, f64: bool = False, bim: bool = True) -> str:
    """The device kernel X1's wrapper launches at size n."""
    return design_of("X1", dict(n=n, f64=f64, bim=bim))["design"]


def check_passes() -> list:
    """Hold X1-X4 against their plain versions with ``hold`` (two launches
    bitwise) at 4097^2, 33^2, 65^2 and 257^2 in every variant of
    ``pass_legs``, each timed beside its bound and its plain version; X1 in
    both designs (``x1_designs``), which must agree bit for bit.  At 4097^2
    X2 and X3 are timed beside one PyTorch call that computes their
    transfer (``F.conv2d`` with stride 2, ``F.conv_transpose2d``, in full
    f32) and homogeneous f32 X1 beside ``x1_library``'s ``F.conv2d`` (its
    largest difference from the plain version, relative to max|b|, in
    ``library_rel_err``).  One record per variant, size and design."""
    import torch
    import torch.nn.functional as F
    from multigrid_feanet_torch.core.device import full_f32

    w = torch.tensor([[0.25, 0.5, 0.25]], device=DEVICE)
    k4 = (4.0 * (w.T @ w)).reshape(1, 1, 3, 3)
    recs = []
    for n in PASS_SIZES:
        x, forms = pass_inputs(n, 24 + n), pass_forms(n)
        for leg, call, cuda_fn, plain_fn, inputs, cfg, nbytes, tol, tags in pass_legs(x, forms, n):
            held = ([hold(leg, call, cuda_fn, plain_fn, inputs, cfg, nbytes, tol,
                          dict(n=n, **tags), twice=True)] if leg != "X1" else
                    x1_designs(call, cuda_fn, plain_fn, inputs, cfg, nbytes, tol,
                               dict(n=n, **tags)))
            for rec in held:
                rec["bound_ms"], rec["bound_by"] = pass_bound(leg, n, tags.get("bim", False),
                                                              nbytes, tags.get("f64", False))
                rec["library_ms"] = None
            rec = held[0]  # the design the wrapper launches
            if n == N_MAIN and leg == "X1" and not (tags["bim"] or tags["bf16"] or
                                                    tags.get("f64")):
                lib, got = x1_library(x, forms[(False, torch.float32)], n, tags["two_f"])
                want = call(plain_fn, inputs, cfg)
                rec["library_ms"] = kernel_ms([lib])
                rec["library_rel_err"] = float((got - want).abs().max() / want.abs().max())
            elif n == N_MAIN and leg == "X2":  # 4 FW as one strided convolution (ring not zeroed)
                with full_f32():
                    rec["library_ms"] = kernel_ms([lambda: F.conv2d(
                        x["u"][None, None], k4, stride=2, padding=1)])
            elif n == N_MAIN and leg == "X3":  # P as one transposed convolution (no geo, no add)
                with full_f32():
                    rec["library_ms"] = kernel_ms([lambda: F.conv_transpose2d(
                        x["uc"][None, None], k4, stride=2, padding=1)])
            recs += held
        del x, forms
    print(json.dumps({"pass_kernel_checks": recs}), flush=True)
    return recs


def x1_designs(call, cuda_fn, plain_fn, inputs, cfg, nbytes, tol, tags: dict) -> list:
    """X1 at size ``tags["n"]`` in both designs: the one its wrapper
    launches there (``x1_design``) and the other, forced through the
    variant's threshold in ``ops.passes.X1_ONE_PASS_MAX_N`` (n: the tile,
    -1: the row stream); each held with ``hold``, and the two outputs equal
    bit for bit.  One record each, tagged with its ``design``, the launched
    one first."""
    import torch
    from multigrid_feanet_torch.ops import passes as px

    n, key = tags["n"], (bool(tags.get("f64")), bool(tags["bim"]))
    rows, tile = DESIGNS["X1"][:2]
    launched = x1_design(n, *key)
    saved = dict(px.X1_ONE_PASS_MAX_N)
    recs, outs = [], []
    for design in (launched, tile if launched == rows else rows):
        px.X1_ONE_PASS_MAX_N[key] = n if design == tile else -1
        try:
            recs.append(hold("X1", call, cuda_fn, plain_fn, inputs, cfg, nbytes, tol,
                             dict(tags, design=design), twice=True))
            outs.append(call(cuda_fn, inputs, cfg))
        finally:
            px.X1_ONE_PASS_MAX_N.update(saved)
    if not torch.equal(*outs):
        fail(f"X1 {tags}: the row stream and the tile differ")
    return recs


def run_slice24() -> dict:
    """The slice-24 phase: X1-X4 held against their plain versions and timed
    (``check_passes``), then ``ir_interface_4097``, ``solve_ir`` on the
    bi-material interface hierarchy (X4 in its two-phase form), at most 20
    outer steps.  ``python3 -c 'import chip_smoke as cs; cs.run_slice24()'``
    runs it alone (the kernels built first)."""
    from multigrid_feanet_torch import _build

    _build.load()
    return dict(checks=check_passes(), ir_interface_4097=run_ir_cell(bim=True, max_outer=20))


def pass_rows(checks: list, heat: dict, r1: dict, irs: dict) -> list:
    """The kernel line's rows of X1-X4 at 4097^2, each with the launches of
    its path: X1 on heat_march_4097 (bi-material, one f), X2 and X3 on
    poisson_4097_r1 and _v22, X4 on ir_4097 (homogeneous) and
    ir_interface_4097 (bi-material)."""
    k = all_kernels()

    def rec(key, **tags):
        return next(c for c in checks if c["name"] == key and c["n"] == N_MAIN and "ms" in c
                    and all(c.get(t) == v for t, v in tags.items()))

    spec = [("X1", rec("X1", bim=True, bf16=False, two_f=False), heat, ""),
            ("X2", rec("X2"), r1["poisson_4097_r1"], ""),
            ("X2", rec("X2"), r1["poisson_4097_r1_v22"], "_v22"),
            ("X3", rec("X3"), r1["poisson_4097_r1"], ""),
            ("X3", rec("X3"), r1["poisson_4097_r1_v22"], "_v22"),
            ("X4", rec("X4", bim=False, bf16=False), irs["ir_4097"], ""),
            ("X4", rec("X4", bim=True, bf16=False), irs["ir_interface_4097"], "_bim")]
    # beside X1's time: its tile's, and its homogeneous one-f time with the
    # PyTorch call that computes it
    hom = rec("X1", bim=False, bf16=False, two_f=False)
    x1_extra = dict(tile_ms=rec("X1", bim=True, bf16=False, two_f=False,
                                design=DESIGNS["X1"][1])["ms"],
                    hom_ms=hom["ms"], hom_bound_ms=hom["bound_ms"],
                    hom_library_ms=hom["library_ms"])
    rows = []
    for key, c, cell, suffix in spec:
        kern = k[key]
        rows.append(dict(name=kern.name + suffix, **design_of(key, c), route="cuda",
                         source=kern.source, replaces=kern.replaces,
                         launches=cell["launches"][key],
                         max_abs_err=c["max_abs_err"], max_rel_err=c["max_rel_err"],
                         ms=c["ms"], warm_ms=c["warm_ms"], plain_ms=c["plain_ms"],
                         bound_ms=c["bound_ms"], bound_by=c["bound_by"],
                         library_ms=c["library_ms"], path=cell["solve"], n=N_MAIN,
                         bytes=c["bytes"], **{t: c[t] for t in ("bim", "bf16", "two_f") if t in c},
                         **(x1_extra if key == "X1" else {})))
    return rows



def learned_rows(s11: dict, c1_rec: dict) -> list:
    """The kernel line's rows of X5 and X6 at 4097^2 (bi-material, 16
    channels, batch 1), and of C1 (the bi-material sweep at 4097^2, with
    its batch instance's times at 4097^2 and 65^2 beside it), each with its
    launches on learned_vcycle_4097's 12 init cycles; of X7, X8 and X9 at
    65^2, batch 64 (bi-material, 16 channels), the shapes of
    intergrid_train_64's finest level, with that cell's launches (its 10
    epochs) and their 4097^2 times beside them."""
    k = all_kernels()
    cell = s11["learned_vcycle_4097"]
    rows = []
    for key in ("X5", "X6"):
        c = next(r for r in s11["learned_pass_checks"] if r["name"] == key
                 and r["n"] == N_MAIN and r["variant"] == "bim16" and r["batch"] == 1)
        kern = k[key]
        rows.append(dict(name=kern.name, route="cuda", source=kern.source,
                         replaces=kern.replaces, launches=cell["launches"][key],
                         max_abs_err=c["max_abs_err"], max_rel_err=c["max_rel_err"],
                         ms=c["ms"], warm_ms=c["warm_ms"], plain_ms=c["plain_ms"],
                         bound_ms=c["bound_ms"], bound_by=c["bound_by"],
                         library_ms=c["library_ms"], path=cell["solve"], n=N_MAIN,
                         bytes=c["bytes"], bim=True, channels=16, batch=1,
                         bitwise_twice=c["bitwise_twice"]))
    row = summary_row("C1", c1_rec, cell["launches"]["C1"], cell["solve"])

    def c1b(n, N):
        return next(r for r in s11["c1_batch_checks"] if r["name"] == "C1_batch_sweep"
                    and r["n"] == n and r["batch"] == N and r["bim"])

    rows.append(dict(row, name=row["name"] + "_learned", batch_4097_ms=c1b(N_MAIN, 1)["ms"],
                     batch_65_b64_ms=c1b(64, 64)["ms"],
                     per_sample_65_b64_ms=c1b(64, 64)["per_sample_ms"]))
    train = s11["intergrid_train_64"]

    def bwd(key, n, N):
        return next(r for r in s11["learned_backward_checks"] if r["name"] == key
                    and r["n"] == n and r["batch"] == N and r["variant"] == "bim16")

    for key in ("X7", "X8", "X9"):
        c, big = bwd("X8" if key == "X8" else "X7", 64, 64), bwd("X8" if key == "X8" else "X7",
                                                                 N_MAIN, 1)
        kern = k[key]
        if key == "X9":  # on X7's partial sums: one block's row of 9 C floats each
            nbytes = 4 * 9 * 16 * c["x9_blocks"]
            timing = dict(ms=c["x9_ms"], plain_ms=c["x9_plain_ms"],
                          bound_ms=1e3 * nbytes / HBM_BYTES_PER_S, bound_by="bytes",
                          ms_4097=big["x9_ms"], blocks=c["x9_blocks"],
                          max_abs_err=c["x9_max_abs_err"])
        else:
            nbytes = c["bytes"]
            timing = dict(ms=c["ms"], plain_ms=c["plain_ms"], bound_ms=c["bound_ms"],
                          bound_by=c["bound_by"], ms_4097=big["ms"],
                          bound_4097_ms=big["bound_ms"], max_abs_err=c["max_abs_err"],
                          torch_backward_ms=c.get("torch_backward_ms"),
                          torch_backward_4097_ms=big.get("torch_backward_ms"))
        rows.append(dict(name=kern.name, route="cuda", source=kern.source,
                         replaces=kern.replaces, launches=train["launches"][key],
                         library_ms=None, path=train["solve"], n=64, bytes=nbytes, bim=True,
                         channels=16, batch=64, **timing))
    return rows


def hslab_rows(s22: dict) -> list:
    """The kernel line's rows of E2's and E3's slab forms: at the world-1
    slab of sharded_hmg_4097's level 0 (homogeneous), with its launches and
    the whole field's time beside them."""
    k = all_kernels()
    cell = s22["sharded_hmg"]
    rows = []
    for key in ("E2_slab", "E3_slab"):
        t = next(r for r in s22["hslab_legs"] if r["name"] == key and r["n"] == N_MAIN
                 and not r["bim"])
        kern = k[key]
        rows.append(dict(name=kern.name, route="cuda", source=kern.source, replaces=kern.replaces,
                         launches=cell["launches"][key], max_abs_err=t["max_abs_err"],
                         ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                         bound_by=t["bound_by"], library_ms=None, path=cell["solve"], n=N_MAIN,
                         rows=t["rows"], grid_rows=t["grid_rows"], bytes=t["bytes"], bim=False,
                         dform=False, L=1,
                         whole_4097_ms=t["whole_ms"]))
    return rows


def slab_rows(s21: dict) -> list:
    """The kernel line's rows of the slab forms: at the world-1 sharded
    solve's shapes, with its launches, and the 4-slab and whole-field
    times at 4097^2 beside them."""
    k = all_kernels()
    sharded = s21["sharded"]
    rows = []
    for key, leg in (("A1", "A1_psweep"), ("A2", "A2"), ("A3", "A3"), ("A4", "A4")):
        t = sharded["slab_times"][key]
        at = next(r for r in s21["slab_legs"] if r["name"] == f"{leg}_slab" and r["n"] == N_MAIN
                  and r["bim"] and "slabs_ms" in r)
        kern = k[f"{key}_slab"]
        rows.append(dict(name=kern.name, route="cuda", source=kern.source, replaces=kern.replaces,
                         launches=sharded["launches"][f"{key}_slab"],
                         max_abs_err=t["max_abs_err"], ms=t["ms"], plain_ms=t["plain_ms"],
                         bound_ms=t["bound_ms"], bound_by=t["bound_by"], library_ms=None,
                         path=sharded["solve"], n=t["n"], rows=t["rows"],
                         grid_rows=t["grid_rows"], bytes=t["bytes"],
                         bim=True, dform=key in ("A1", "A2"), slabs_4097_ms=at["slabs_ms"],
                         whole_4097_ms=at["whole_ms"]))
    return rows


def bound(key: str, rec: dict):
    """(bound ms, "bytes" or "operations") of a check record: the larger of
    its bytes over the HBM rate and its f32 operations over the f32 rate."""
    t_bytes = 1e3 * rec["bytes"] / HBM_BYTES_PER_S
    flops = rec.get("flops_per_node", FLOPS_PER_NODE.get(key)) * (rec["n"] + 1) ** 2
    t_ops = 1e3 * flops / FP32_FLOP_PER_S
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


# the device kernels of the two-design legs G4, A5 and X1: (row-streaming,
# one-pass tile), the module and threshold that choose between them and the
# record's tags that key a threshold given per instance
DESIGNS = {"G4": ("g4_el_zdescent_rows", "g4_el_zdescent", "elastic", "G4_ONE_PASS_MAX_N",
                  ("bim",)),
           "A5": ("a5_resid_restrict_rows", "a5_resid_restrict", "sweep", "A5_ONE_PASS_MAX_N",
                  ("bim",)),
           "X1": ("x1_heat_rhs_rows", "x1_heat_rhs", "passes", "X1_ONE_PASS_MAX_N",
                  ("f64", "bim"))}


def design_of(key: str, rec: dict) -> dict:
    """``symbols`` (both designs' device kernels) and ``design`` (the one
    the record's launches ran) of a row of DESIGNS' legs; {} for the rest."""
    import importlib

    if key not in DESIGNS:
        return {}
    rows, tile, module, name, tags = DESIGNS[key]
    limit = getattr(importlib.import_module(f"multigrid_feanet_torch.ops.{module}"), name)
    if isinstance(limit, dict):
        by = tuple(bool(rec.get(t)) for t in tags)
        limit = limit[by if len(by) > 1 else by[0]]
    return dict(symbols=[rows, tile], design=tile if rec["n"] <= limit else rows)


def summary_row(key: str, rec: dict, launches: int, path: str) -> dict:
    """One row of the kernel line from a check record and a path's count."""
    n = rec["n"]
    bound_ms, bound_by = bound(key, rec)
    k = all_kernels()[key]
    return dict(name=k.name, **design_of(key, rec), route="cuda", source=k.source,
                replaces=k.replaces,
                launches=launches, max_abs_err=rec["max_abs_err"],
                max_rel_err=rec["max_rel_err"], rsq_rel_err=rec["rsq_rel_err"],
                ms=rec["ms"], warm_ms=rec["warm_ms"], plain_ms=rec["plain_ms"],
                bound_ms=bound_ms, bound_by=bound_by,
                library_ms=rec.get("library_ms"), path=path, n=n, bytes=rec["bytes"],
                **{t: rec[t] for t in ("bim", "coef_dtype", "dform", "L", "sweeps", "mass", "bc",
                                       "q_dtype", "a1_max_abs_diff", "dtype", "bf16_excess")
                   if t in rec})


def stamp(label: str, since: float) -> None:
    """Print the seconds since ``since`` at the end of a phase: the run's
    time budget, phase by phase."""
    print(json.dumps({"phase_done": label, "elapsed_s": time.time() - since}), flush=True)


def time_captures() -> dict:
    """Count the CUDA graph captures of every solver from here on and the
    seconds they take (``torch.cuda.graph`` synchronizes, collects garbage
    and empties the allocator's cache before each)."""
    from multigrid_feanet_torch.solvers.common import ChunkGraphs

    stats, capture = dict(captures=0, seconds=0.0), ChunkGraphs._capture

    def timed(graphs, body):
        t0 = time.time()
        try:
            return capture(graphs, body)
        finally:
            stats["captures"] += 1
            stats["seconds"] += time.time() - t0

    ChunkGraphs._capture = timed
    return stats


def main() -> int:
    import torch

    start = time.time()
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
    warnings = [line.strip() for line in log.splitlines() if "warning" in line]
    compile_s = {m.group(1): float(m.group(2)) for m in re.finditer(r"^== (\S+) \(([\d.]+) s\)",
                                                                     log, re.M)}
    print(json.dumps(dict(build_s=build_s, compile_s=compile_s, ptxas=regs[:60],
                          warnings=warnings[:20])), flush=True)
    captures = time_captures()

    checks = []
    a13 = ["A1_sweep", "A1_residual", "A1_psweep", "A2"]
    checks += check_kernels(N_MAIN, True, True, a13 + ["A3", "A4"])
    checks += check_kernels(N_MAIN, True, False, a13)
    checks += check_kernels(N_MAIN // 2, True, True, ["A3", "A4"])
    # the homogeneous builds at the sizes the Poisson solve runs them
    checks += check_kernels(N_MAIN, False, True, a13)
    checks += check_kernels(N_MAIN, False, False, a13)
    checks += check_kernels(N_MAIN // 2, False, True, ["A3", "A4"])
    checks += check_kernels(N_COARSE, True, True, a13 + ["A3", "A4"])
    checks += check_kernels(N_COARSE, False, True, a13 + ["A3", "A4"])
    checks += check_kernels(N_COARSE, False, False, a13)
    # the row-streaming A1/A2 on a single block (n = 2), ragged last bands
    # and strips and odd row offsets (n = 16, 32, 126), every form at 126
    for n in (2, 16, 32):
        checks += check_kernels(n, True, True, a13)
    for bim in (True, False):
        for dform in (True, False):
            checks += check_kernels(N_ODD, bim, dform, a13)
        checks += check_kernels(N_ODD, bim, False, a13, mass=level_mass(N_ODD),
                                coef=(HEAT_THETA * HEAT_DT, 20.0 * HEAT_THETA * HEAT_DT))
    print(json.dumps({"kernel_checks": checks}), flush=True)
    # the row-streaming A3/A4 on a single block (n = 2), ragged bands and
    # strips (16, 32, 126) and every level size of the interface solve
    a34checks = check_a34((2, 16, N_ODD) + A34_LEVELS[::-1] + (N_MAIN,))
    print(json.dumps({"a34_kernel_checks": a34checks}), flush=True)
    check_repeat()

    stamp("a_kernels", start)
    check_small_against_cpu()
    a_keys = ("A1", "A2", "A3", "A4")
    solves = [run_solve(label, lambda bim=bim: build_hierarchy(N_MAIN, bim, 9, 32, DEVICE),
                        a_keys, 120)
              for label, bim in (("interface_4097", True), ("poisson_4097", False))]

    stamp("v2_cells", start)
    prob, hier, setup = boxmg_setup_on_card()
    gchecks = []
    for dt in (torch.bfloat16, torch.float32):
        gchecks += check_general(0, True, ["D2", "D3"], setup, dt)
        gchecks += check_general(1, False, ["D4", "D5", "D1_sweep", "D1_residual"], setup, dt)
        gchecks += check_general(3, False, ["D2", "D3"], setup, dt)
    print(json.dumps({"general_kernel_checks": gchecks}), flush=True)

    print(json.dumps({"d2_variants": check_d2_variants()}), flush=True)
    boxmg = run_boxmg_cell(prob, hier, setup)
    # D2 adds its norm in its last block; D3-D5 have none
    norm_passes("boxmg_4097", boxmg, 0)
    del hier, setup
    small_launches = check_boxmg_small_against_cpu()

    hchecks = []
    for bim, dform in ((False, False), (True, True)):
        hchecks += check_hrelax(N_MAIN, bim, dform, HNET_L1, ["E2", "E3"])
        hchecks += check_hrelax(N_MAIN // 2, bim, dform, HNET_L1, ["E4", "E5"])
        hchecks += check_hrelax(N_COARSE, bim, dform, HNET_L3, ["E2", "E3", "E4", "E5"])
    print(json.dumps({"hrelax_kernel_checks": hchecks}), flush=True)
    print(json.dumps({"e2_variants": check_e2_variants()}), flush=True)
    print(json.dumps({"e3_variants": check_e3_variants()}), flush=True)
    print(json.dumps({"e5_variants": check_e5_variants()}), flush=True)
    print(json.dumps({"e4_variants": check_e4_variants()}), flush=True)

    stamp("boxmg", start)
    hmg_solves = list(run_hmg_cells().values())
    for rec in hmg_solves:  # E2 adds its norm in its last block; E3-E5 have none
        norm_passes(rec["solve"], rec, 0)
        parent_cell(rec)
    check_hmg_small_against_cpu()

    echecks = []
    g_all = ["G1_sweep", "G1_residual", "G2", "G3", "G4", "G5"]
    for n, bim in ((N_EL, True), (N_EL, False), (N_EL // 2, True), (N_SMALL, True),
                   (N_SMALL, False)):
        echecks += check_elastic(n, bim, g_all)
    print(json.dumps({"elastic_kernel_checks": echecks}), flush=True)
    print(json.dumps({"g2_variants": check_g2_variants()}), flush=True)
    print(json.dumps({"g1_variants": check_g1_variants()}), flush=True)
    print(json.dumps({"g5_variants": check_g5_variants()}), flush=True)
    print(json.dumps({"g4_variants": check_g4_variants()}), flush=True)
    stamp("hmg", start)
    cells = run_elastic_cells()
    # G1 and G2 add their norms in their last block: no elastic solve
    # launches a norm pass
    for label in ("elastic_2049", "elastic_pcg_2049", "elastic_v11_2049"):
        norm_passes(label, cells[label], 0)
    parent_elastic(cells)
    check_elastic_small_against_cpu()

    schecks = []
    for n, bim in ((N_MAIN, True), (N_MAIN, False), (N_COARSE, True), (N_COARSE, False)):
        schecks += check_stencil(n, bim, ["C1_sweep", "C1_residual", "C2_k2", "C2_k4", "C2_k8"])
        schecks += check_kernels(n, bim, True, ["A5", "A6"])
    for rec in schecks:
        rec["bound_ms"], rec["bound_by"] = bound(rec["name"][:2], rec)
    print(json.dumps({"r5_kernel_checks": schecks}), flush=True)
    print(json.dumps({"c1_variants": check_c1_variants()}), flush=True)
    print(json.dumps({"c2_variants": check_c2_variants()}), flush=True)
    print(json.dumps({"a6_variants": check_a6_variants()}), flush=True)
    print(json.dumps({"a5_variants": check_a5_variants()}), flush=True)
    stamp("elastic", start)
    r1 = run_r1_cells()
    for label, rec in r1.items():  # C1 and C2 add their norms in their last block
        norm_passes(label, rec, 0)
        parent_cell(rec)
    pswrr = run_pswrr_cell(solves[0])
    pcg = run_pcg_cell()
    ir = run_ir_cell()
    small_r5 = check_r5_small_against_cpu()

    # slice 6: H1 and the mass form of A1-A6 against their plain versions
    # (the heat level's operands: theta dt (1, 20), mass h^2 (1/18, 1/18,
    # -1/36)), then the periodic and heat cells
    r6checks = []
    heat_coef = (HEAT_THETA * HEAT_DT, 20.0 * HEAT_THETA * HEAT_DT)
    for bim in (True, False):
        r6checks += check_kernels(N_MAIN, bim, False, a13 + ["A3", "A4", "A5", "A6"],
                                  coef=heat_coef, mass=level_mass(N_MAIN))
        r6checks += check_kernels(N_MAIN // 2, bim, False, ["A3", "A4"], coef=heat_coef,
                                  mass=level_mass(N_MAIN // 2))
    r6checks += [check_torus(n) for n in (N_MAIN, 32, 96)]
    for rec in r6checks:
        rec["bound_ms"], rec["bound_by"] = bound(rec["name"][:2], rec)
    print(json.dumps({"r6_kernel_checks": r6checks}), flush=True)
    print(json.dumps({"h1_variants": check_h1_variants()}), flush=True)
    stamp("round1", start)
    pbc_cells = run_pbc_cells()
    heat = run_heat_cell()
    small_r6 = check_r6_small_against_cpu()

    # slice 7: B1, B2, F1 and E1 against their plain versions, then the
    # bandwidth, Q-stream, H-Jacobi and training cells
    r7checks = check_membench()
    r7checks += [check_f1(n, dt) for n, dt in ((N_MAIN, torch.bfloat16), (N_MAIN, torch.float32),
                                               (N_COARSE, torch.bfloat16))]
    r7checks += [check_e1(N_MAIN, False, False, HNET_ITER, bc=0.0),
                 check_e1(N_MAIN, False, False, HNET_L1, bc=0.0),
                 check_e1(N_MAIN, True, False, HNET_L1), check_e1(N_MAIN, True, True, HNET_L1)]
    r7checks += [check_e1(n, bim, False, ckpt, bc="field") for n in (2, 32, N_COARSE)
                 for bim, ckpt in ((False, HNET_ITER), (True, HNET_L1))]
    for rec in r7checks:
        rec["bound_ms"], rec["bound_by"] = bound(rec["name"][:2], rec)
    print(json.dumps({"r7_kernel_checks": r7checks}), flush=True)
    print(json.dumps({"e1_variants": check_e1_variants()}), flush=True)
    print(json.dumps({"f1_variants": check_f1_variants()}), flush=True)
    a1_plain = next(c for c in checks if c["name"] == "A1_sweep" and c["n"] == N_MAIN
                    and c["bim"] and not c["dform"])
    stamp("periodic_heat", start)
    membench = run_membench_cell(r7checks[:2], a1_plain)
    qsweep_cell = run_qsweep_cell()
    hjac = run_hjac_cell()
    hjac_iter = run_hjac_iter_cell()
    mq = run_measure_q_cells()
    run_decay_train()
    run_hnet_train_cell()

    # slice 10: A1-A6 in bf16 storage against their plain versions, bench.py's
    # bf16 sweep row, the bf16 V2 solves and two 129^2 bf16 solves against
    # the CPU
    stamp("slice7", start)
    bf_checks = check_bf16_kernels()
    bench_bf16 = run_bench_bf16_sweep(bf_checks, membench)
    bf_cells = run_bf16_cells({rec["solve"]: rec for rec in solves}, ir)
    small_bf16 = check_bf16_small_against_cpu()

    # slice 11: the learned inter-grid operators (X5 and X6 held first; the
    # serving cycle on C1, X5 and X6) and the elastic H-Net
    stamp("bf16", start)
    s11 = run_slice11()

    # the research solvers: the block-BoxMG elastic and adaptive scalar
    # BoxMG solvers in torch ops, which launch no kernel of the port
    stamp("slice11", start)
    run_research_solvers()

    # slice 21: the slab forms of A1-A4, the world-1 sharded solvers
    stamp("research", start)
    s21 = run_slice21()
    # slice 22: the slab forms of E2 and E3, the world-1 sharded H-MG
    stamp("slice21", start)
    s22 = run_slice22()
    stamp("slice22", start)
    # slice 23: the replayed solves against their eager loops
    run_graph_cells()
    stamp("graph_cells", start)
    # slice 24: X1-X4 against their plain versions, the interface IR cell
    s24 = run_slice24()
    stamp("slice24", start)
    print(json.dumps({"graph_captures": captures}), flush=True)

    # A5 is a level method that no solver calls: its count is the sum over
    # every counted run of the scalar V2, round-1 and heat paths, which must
    # be 0
    a5_runs = {rec["solve"]: rec["launches"] for rec in (*solves, pswrr, pcg, ir, heat,
                                                         *r1.values(), *bf_cells.values(),
                                                         s24["ir_interface_4097"])}
    a5_runs.update(small_r5)
    a5_runs.update(small_r6)
    a5_runs.update(small_bf16)
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
    # A1 (psweep) and A2 at level 0, A3 and A4 at level 1 of heat_march_4097
    # (bi-material plain form with the mass triple, "_mass"); H1 at 4096^2
    # on both periodic paths
    for key, (leg, n) in main_shape.items():
        rec = next(c for c in r6checks if c["name"] == leg and c["n"] == n and c["bim"])
        row = summary_row(key, rec, heat["launches"][key], "heat_march_4097")
        summary.append(dict(row, name=row["name"] + "_mass"))
    h1 = next(c for c in r6checks if c["name"] == "H1" and c["n"] == N_MAIN)
    for path, suffix in (("torus_jacobi_4096", ""), ("pbc_mg_4096", "_mg")):
        row = summary_row("H1", h1, pbc_cells[path]["launches"]["H1"], path)
        summary.append(dict(row, name=row["name"] + suffix))
    # B1/B2 on membench_4097, F1 (bf16 Q) on qsweep_4097, E1 at 4097^2 on
    # hjac_4097 (L = 3) and measure_q_4096 (L = 1), and at n = 32 on the
    # learned-iterator cell (L = 3, a boundary field)
    def r7rec(name, **tags):
        return next(c for c in r7checks if c["name"] == name
                    and all(c.get(k) == v for k, v in tags.items()))

    for key in ("B1", "B2"):
        summary.append(summary_row(key, r7rec(key), membench["launches"][key], "membench_4097"))
    summary.append(summary_row("F1", r7rec("F1", n=N_MAIN, q_dtype="bfloat16"),
                               qsweep_cell["launches"]["F1"], "qsweep_4097"))
    for rec, cell, suffix in (
            (r7rec("E1", n=N_MAIN, L=3), hjac, ""),
            (r7rec("E1", n=N_MAIN, L=1, bim=False), mq[f"measure_q_{N_MAIN}"], "_measure_q"),
            (r7rec("E1", n=32, L=3), hjac_iter, "_iter")):
        row = summary_row("E1", rec, cell["launches"]["E1"], cell["solve"])
        summary.append(dict(row, name=row["name"] + suffix))
    # bf16 storage: A1 (psweep) and A2 at level 0, A3 and A4 at level 1 of
    # interface_4097_bf16 ("_bf16") and poisson_4097_bf16 ("_hom_bf16"); A6
    # at level 0 of pswrr_interface_4097_bf16; A5, which no path runs
    for cell, bim, suffix in (("interface_4097_bf16", True, "_bf16"),
                              ("poisson_4097_bf16", False, "_hom_bf16")):
        for key, (leg, n) in main_shape.items():
            rec = next(c for c in bf_checks if c["name"] == leg and c["n"] == n
                       and c["bim"] == bim and not c["mass"]
                       and (c["dform"] or key in ("A3", "A4")))
            row = summary_row(key, rec, bf_cells[cell]["launches"][key], cell)
            summary.append(dict(row, name=row["name"] + suffix))

    def bfrec(name):
        return next(c for c in bf_checks if c["name"] == name and c["n"] == N_MAIN
                    and c["bim"] and c["dform"])

    row = summary_row("A5", bfrec("A5"), a5_launches, "no solver path (level method)")
    summary.append(dict(row, name=row["name"] + "_bf16"))
    row = summary_row("A6", bfrec("A6"), bf_cells["pswrr_interface_4097_bf16"]["launches"]["A6"],
                      "pswrr_interface_4097_bf16")
    summary.append(dict(row, name=row["name"] + "_bf16"))
    # every row's byte bound also at the measured copy and triad rates
    summary += slab_rows(s21) + hslab_rows(s22)
    # X1 on heat_march_4097, X2/X3 on the round-1 cells, X4 on the IR cells
    summary += pass_rows(s24["checks"], heat, r1, {"ir_4097": ir,
                                                   "ir_interface_4097": s24["ir_interface_4097"]})
    # X5, X6 and C1 on learned_vcycle_4097 (bi-material, 16 channels, batch 1)
    summary += learned_rows(s11, srec("C1_sweep", True))
    for row in summary:
        row["bound_copy_ms"] = 1e3 * row["bytes"] / (membench["copy_gbps"] * 1e9)
        row["bound_triad_ms"] = 1e3 * row["bytes"] / (membench["triad_gbps"] * 1e9)
    print(json.dumps({"a12_4097": a12_times(checks + r6checks)}), flush=True)
    print(json.dumps({"a34_levels": a34_levels(a34checks)}), flush=True)
    print(json.dumps({"bf16_times": bf16_times(bf_checks, checks + a34checks + schecks
                                                + r6checks),
                      "bench_bf16": bench_bf16}), flush=True)
    # every kernel of the port has a row: the 27 TPU kernels' and X1-X9
    names = sorted({row["name"].split("_")[0] for row in summary})
    print(json.dumps({"kernel_line": dict(rows=len(summary), kernels=len(names),
                                          names=names)}), flush=True)
    if len(names) != 36:
        fail(f"the kernel line names {len(names)} kernels, not 36: {names}")
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
