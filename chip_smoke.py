#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pytdscf_torch``) on one NVIDIA GPU.

Run from the repository root on a machine with an H100 and the CUDA toolkit:

    python3 chip_smoke.py

Phases (any failure exits nonzero, before the result line):

1. print the card (``nvidia-smi`` name and power limit), the torch and CUDA
   versions, and check that TF32 is off for matmuls and cuDNN;
2. build the kernels from ``pytdscf_torch/csrc`` with nvcc;
3. the 184-site singlet-fission chain at D=30 (``bench.py``'s main path),
   complex64, thresh_exp 1e-6, max_krylov 10, dt 0.2 fs:
   a. each kernel of the path against its plain PyTorch version on the
      chain's operands after one step: the Lanczos exponential (H step at
      a bulk and at the exciton site, K step at a bulk bond: same status,
      ‖Δψ‖ < 5e-6, a second launch bit-identical) through one block and
      clusters of 8 and 16 CTAs, each timed; the same checks and times for
      every Lanczos shape of a chain step on its own operands (the route
      sweep); the MGS QR at (240, 30), full rank and rank deficient, and
      at the later paths' one-block shapes (560, 20), (200, 20) and (72,
      12) (orthogonality, reconstruction, agreement; each timed beside its
      plain version and ``torch.linalg.qr``);
   b. five counted steps through ``TDVPEngine.propagate``: ⟨H⟩ within 5e-6
      of 0.0182253410, norm within 1e-5 of 1, and exactly 734 Lanczos and
      366 QR kernel launches per step, the Lanczos ones by route and
      cluster size as the shapes decide (H steps on 16 CTAs, (30, 30) K
      steps on 8, the M = 8 edge steps on one block);
   c. one more step under ``torch.profiler`` (lines ``profile:``);
   d. ``bench.py``'s fused driver on a fresh engine: ``propagate_steps(dt,
      1)`` (a host step, then the capture of the step as a CUDA graph),
      then 5 blocks of 4 replayed steps, counted: ⟨H⟩ of the end state
      within 5e-6 of the literal, as the engine reports it (complex64)
      and contracted in complex128, the norm, the launches of every step
      by route and cluster size as in b (counted through the replays'
      accounting), ``graph_steps`` 20 and ``eager_steps`` 1, no plain
      call, and the mean Krylov dimension of steps 1-5 within 0.05 of b's;
      the capture time and peak memory beside b's, the cost of the step's
      copy of its carry; one more block under ``torch.profiler``, whose
      trace must hold every kernel node of its replays as b's steps
      launch them, by kernel, route and cluster size (the launches that
      the ``kernels`` line reports for this path), and gives the MGS
      kernel's device time a step by operand shape (in the launch order
      of the warm-up step) beside one launch of each shape timed alone;
4. the same chain through the port's entry point, ``Simulator.propagate``
   (1 + 5 steps of 0.2 fs, thresh_sil 1e-6, complex64, ``fetch_stride=1``:
   properties read after each step), with the fused whole-site kernel on
   (``PYTDSCF_PALLAS_WHOLESITE=1``):
   a. the site kernel against its plain version on the chain's operands at
      the bulk site and the exciton site, both directions (cores, psi_next
      and blocks within 5e-6, |Δlog| < 5e-6, the same Krylov status, a
      second launch bit-identical), through its own route; at the bulk,
      forward, also through the one-block route and a cluster of 8 CTAs,
      each timed beside the same update through the separate kernels;
   b. the run, counted: ⟨H⟩ within 5e-6 of 0.0182253410, the norm,
      ``autocorr.dat`` and ``populations.dat`` with 6 rows, exactly 360
      site (each on its shape's route: all on the cluster), 14 Lanczos and
      6 QR launches per step, no plain call, and the mean Krylov
      dimension within 0.05 of phase 3's over the same steps;
   c. three bare ``propagate`` steps of its engine (s/step) and one under
      ``torch.profiler``;
5. the same Simulator, 17 steps, at its default stride on the card, 16,
   with the separate kernels (the user's default path): one block of 16
   steps as replays of the step graph with the properties collected
   inside it, then one inline step, held to a stride-1 run of the same
   model made here: the gates of 4b (⟨H⟩ as 3d) with 734 Lanczos (by
   route and size) and 366 QR launches per step, the mean Krylov
   dimension within 0.05 of 3d's over the same 17 steps, ``graph_steps``
   15, and every ``.dat`` value within 1e-6 of the stride-1 run's; then
   the same run again under ``torch.profiler``: its trace must hold the
   stride-1 run's launches, by kernel, route and cluster size (the
   launches that the ``kernels`` line reports for this path);
6. the same with the fused site kernel (360 site, 14 Lanczos, 6 QR
   launches per step), and two blocks of 4 bare replayed steps of its
   engine, one more under ``torch.profiler``, traced and counted as 3d;
7. the χ=1024 radical-pair Liouville MPDO (``bench_chi.py``'s defaults at
   the "balanced" precision rung: Arnoldi, relaxed Krylov from iteration
   1 through the bf16 matvec kernels):
   a. build, ``right_canonicalize`` on the card, and each matvec kernel
      against its plain version on the chain's operands (bulk and edge
      sites; relative error < 1e-4, which the plain output rounded to bf16
      must fail; a second launch bit-identical; kernel and plain times at
      the bulk); ``heff_lo`` at the bulk with d = 9 and d = 16 on seeded
      random operands (< 3e-4, the bf16-rounded output failing it), and
      one ``heff_lo`` call at the χ=2048 bulk, timed, allocating under
      2 GB; the MGS QR against its plain version on the chain's own
      gauge operands at every shape it takes there, (1024, 64) down to
      (4, 4), the (1024, 64) one through the cluster route (timed beside
      ``torch.linalg.qr``), a second launch bit-identical; the one-pass
      environment transfer (``env_precision="default"``, ``renorm_left_lo``
      / ``_right_lo``: the one-pass chain with din ≠ dout) at the bulk
      against its plain version (< 1e-4), a second launch bit-identical;
   b. a host-driven witness: one warm-up step, whose every Krylov control
      step's inputs are recorded and replayed through the control kernel
      and its plain version (coefficients within 2e-5, the same flags and
      status; the kernel timed as 200 launches replayed in one CUDA graph,
      beside a kernel that does no work, its plain version and
      ``torch.linalg.matrix_exp``), then 3 steps under
      ``torch.profiler`` and 2 timed (cut from 1 + 10: the replays below
      carry the 1 + 10 steps);
   c. a fresh engine through ``propagate_steps``: a host step and the
      capture of the step as a CUDA graph with its Krylov iterations as IF
      nodes (whose conditions the control kernel sets), then the witness's
      3 steps as replays under the profiler: the
      same Krylov statistics, the same launches by the device's count
      (each kernel a replay runs in an IF node adds one to its own counter
      on the device; the profiler loses and misnames kernels inside IF-node bodies, so
      the trace is held to the witness's only for the kernels outside
      them, MGS); then 7 timed replays (1 + 10 steps in all): bench_chi.py's
      invariants, the electron populations within 6e-5 of its gold entry
      (``bench_expected.json``), heff_lo + keff_lo launches equal to the
      relaxed matvecs ``krylov_stats`` counts, one control step per Krylov
      iteration, every (1024, 64) gauge move through the MGS cluster
      kernel, no plain-version call, the peak memory beside the witness's;
8. the same radical pair at ``bench_chi.py``'s own default rung,
   "throughput" (its ``BENCH_PENV=1`` semantics): bf16x3 iteration-0
   matvecs and every in-sweep environment transfer through the bf16x3
   chain kernel, relaxed Krylov from iteration 1:
   a. build, ``right_canonicalize``, and the chain kernel against its plain
      version on the chain's own operands through each of its four
      mappings (environment transfer left and right, H_eff and K_eff
      matvec) at the bulk site and two edge sites: relative error < 2e-5,
      which the plain version with its lo passes dropped must fail; a
      second launch bit-identical; the lo planes of the operands nonzero;
      at the bulk the kernel's, the plain version's and one complex64
      ``torch.einsum``'s times; the same checks at the bulk with d = 9 and
      d = 16 (w = 8) on seeded random operands, for both transfers and the
      H_eff matvec;
   b. and c. as 7b and 7c, with 34 environment transfers per step through
      the kernel and one "high" matvec launch per Krylov call;
9. the χ=1024 radical pair through ``Simulator.propagate`` at "throughput"
   from its Hartree product, 5 steps at ``fetch_stride`` 4 (a block of a
   host step, the capture and 3 replays, then an inline step) against
   stride 1: every ``populations.dat`` value within 1e-6;
10. ``bench_chi.py``'s χ=2048 anchor (``BENCH_CHI=2048 BENCH_RP_NUC=6
   BENCH_KRYLOV=8``) at "throughput": a host step and the capture; one
   replayed step against the same step driven from the host (the same
   Krylov statistics and launches); then 5 timed replays from the state
   after the capture: its populations within 5e-5 of the gold entry
   ``chi2048_nuc6_split1_lt2_dt1_steps5_complex64``, the launch gates of
   7c, the peak memory, one more replayed step under the profiler;
11. the IR-spectrum workflow on H2O (``tests/test_h2o_pipeline.py``: 3
   modes, 9 primitives, D=9) through the port's entry points:
   ``Simulator.relax`` (10 improved steps of 0.1 fs, each site's ground
   state one ``lanczos_gs`` launch), ``operate`` (μ·E, efield 1e-2 each
   way), ``propagate`` (500 steps of 0.2 fs at the default stride 16:
   graph replays) from the checkpoints, then the spectrum: the ZPE within
   1e-6 of 0.0208557166, the bend 1612 ± 90 and stretch 3787 ± 180 cm⁻¹,
   E_gs below the harmonic ZPE, the norm and ⟨H⟩ over the run, one
   ground-state launch per site update and no plain call; s/step, the
   restarts' distribution, busy share (one more step profiled) and peak
   memory of each stage;
12. the same workflow for butadiene at ``examples/butadiene_ir_spectrum.py``'s
   own settings (14 active modes, 6 primitives, D=12; 8 improved steps,
   operate, 400 steps): E_gs within 1e-6 and ‖μ|0⟩‖ within 1e-4
   (relative) of the JAX package's gold (``GOLD_C4H6``), E_gs below the
   harmonic ZPE, the norm within 1e-5 and ⟨H⟩ within 1e-5 over the 400
   steps, the strongest line in 600-3500 cm⁻¹ within one frequency bin of
   the gold; then the ground-state kernel against its plain version on
   the relaxed state's own operands at each of its shapes, on the route,
   cluster size and block size ``cuda_lanczos.gs_plan`` gives it
   (energies within 1e-6 relative, |⟨kernel|plain⟩| ≥ 1 − 1e-5), the bulk
   timed (ms a call and a matvec-iteration) beside the plain version and
   ``torch.linalg.eigh`` of the dense H_eff, and H2O's (81, 9) shape
   timed;
13. imaginary-time relaxation of butadiene from its Hartree product, 4
   steps, with the separate kernels and with the fused site kernel: ⟨H⟩
   non-increasing step by step, the end ⟨H⟩ within 1e-6 of the same steps
   through the plain versions on the host, the norm;
14. ``lanczos_expm`` (both signs) and ``site_step`` at that real scale
   against their plain versions on the bulk site's operands (the
   criteria of 3a and 4a);
15. one improved step replayed from a CUDA graph (``propagate_steps``)
   against the same step driven from the host: ⟨H⟩ equal within 5e-6,
   the same ground-state telemetry, and the replay's traced launches of
   ``lanczos_gs`` and ``mgs_qr`` by route equal to the host step's; the
   traced step's device time by kernel;
16. pyrazine's 24-mode S2 dynamics at ``examples/pyrazine_s2_dynamics.py``'s
   own settings (nprim 10, D=20, 1500 steps of 0.1 fs, energy and the
   autocorrelation, the card's default stride 16: graph replays): the norm
   and the relative ⟨H⟩ drift within 1e-5, the final S1/S2 populations
   (``TDVPEngine.reduced_density``: the GPU machine has no h5py) and the
   absorption maximum in 220-280 nm against the JAX package's gold
   (``scripts/a4_gold.py``); the Lanczos kernel against its plain version
   at the bulk (200, 20) H step on the cluster, timed;
17. donor–acceptor model B at ``examples/donor_acceptor_model_b.py``'s own
   settings (114 sites, nfock 28, D=20, 0.2 fs, the 26 level projectors
   every 10 steps: each step host-driven), 10 steps (its Hamiltonian built
   in a child process while phases 3-15 run): the per-site census of its
   Krylov routes (the einsum program where the channels pass
   ``cuda_lanczos.fits``, one block, the cluster) and the Lanczos launches
   equal to it, the 26 populations after step 10 against the gold and
   their sums; each route on its own operands (the Lanczos kernel at the
   one-block and the cluster H step against its plain version, the einsum
   program's control steps through ``krylov_ctl`` against its plain
   version, each timed), MGS at the (560, 20) gauge; then without
   observables one replayed step against the same step host-driven (Krylov
   statistics, launches, populations) and 4 timed replays;
18. the DVR grid models at their tests' sizes: Hénon–Heiles in both
   parameter sets (energy within 1e-6 of the literals) and H2CO's 6-mode
   SOP model (e10 − e0 within 1e-6);
19. several electronic states (one MPS a state, a fused MPO a coupled
   state pair, the pair sums batched by MPO shape: ``mps/pairs.py``):
   a. the Ambrosek aggregate of ``tests/test_relax_operate.py`` (2 states,
      4 modes, 5 primitives, D 4/5) through ``Simulator.relax``
      (imaginary time, and improved relaxation to the ZPE),
      ``propagate`` (the default stride: replays) and both again from
      ``proj_gs``'s start: each ⟨H⟩ within its bar of its literal (three
      times the port's complex64 CPU run's distance, at least 1e-9:
      ``scripts/a3_gold.py``); ``operate`` with the transition dipole
      (two state pairs) on the improved ground state against the same on
      the CPU in complex128; no Lanczos, fused-site or ground-state launch,
      one MGS launch a state a gauge move;
   b. the 27-state LH2 exciton model (``matJ_LH2_exciton``: 189 state
      pairs, 27 sites of 8 primitives, D=8, dt 0.5 fs) through
      ``Simulator.propagate``, 20 steps host-driven: every populations row
      and ⟨H⟩ at the end against ``scripts/a3_gold.json`` (the JAX package
      in complex128), the sums, 27 × 26 × 2 MGS launches a step and one
      ``krylov_ctl`` launch a Krylov iteration; the kernels of the path on
      its operands at the bulk (``krylov_ctl`` on the H step's control
      steps, MGS at (64, 8) live and with no weight, and at (8, 8), each
      timed beside ``torch.linalg.qr`` / ``torch.linalg.matrix_exp``), the
      launches of one pair-sum matvec; then a replayed step under the
      profiler against the same step host-driven and 8 timed replays.

Every run of the chain gates the complex64 ⟨H⟩ it reports at 5e-6: the
engine contracts ⟨H⟩ in complex128 and rounds only the value to
complex64 (ROADMAP C3); ``energy64``, the same contraction divided by the
norm and not rounded, is printed beside it and gates the long runs too.

The second-to-last line of stdout is a JSON object with each kernel's
launches, error, times and bound (the least time the card could take for
the timed call's work: its operations at the card's peak for their type or
its bytes at the memory rate, whichever is larger; H100 SXM data sheet
peaks at 700 W); the MGS entry carries its timed shapes as ``cases``,
each with its route and its launches on the main paths, the replayed
chain's MGS device time by shape and the paths' MGS launches a step by
shape; the Lanczos and
site entries their launches by route, the cluster size and the bulk
times of every route (the Lanczos entry also the K step's, its cluster
launches by size and the route sweep).  The last line is
the result ``{"ok": true, "device": {...}}``.  The script imports no JAX.

``python3 chip_smoke.py --save-state DIR`` also keeps the end states of the
graph chain and of both stride-16 runs as ``DIR/<run>.npz``, which
``tests/torch_energy_c64.py`` reads.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

E_REF = 0.0182253410  # ⟨H⟩ of the chain (bench.py); energy is conserved
E_TOL = 5.0e-06  # complex64 tolerance of bench.py
NORM_TOL = 1.0e-05
LANCZOS_TOL = 5.0e-06  # ‖Δψ‖, tests/test_pallas_lanczos.py
# the one-block MGS shapes of the later paths' bulk gauges, each timed in
# phase 3a beside the chain's (240, 30)
MGS_PATH_SHAPES = (("model B", (560, 20)), ("pyrazine", (200, 20)),
                   ("butadiene", (72, 12)))
BOND = 30
DT_FS = 0.2
TIMED_STEPS = 5
# bench.py's fused driver: propagate_steps(dt, 1), then blocks of 4
GRAPH_BLOCK = 4
GRAPH_BLOCKS = 5
SIM_STEPS = 1 + TIMED_STEPS  # the stride-1 Simulator run: phase 3's steps
# the strided Simulator runs: at the default stride (16) one replayed block
# of 16 steps, then one inline step
STRIDE_STEPS = 17
BARE_STEPS = 3
KRYLOV_TOL = 0.05  # mean Krylov dimension over the same steps of two runs
ROW_TOL = 1.0e-06  # .dat values, stride 16 against stride 1
# fused site kernel vs its plain version, the dead columns of Q (the MGS
# completions, which carry none of the state): each is e_k orthogonalised
# against every column before it and inherits their rounding; at the
# exciton site they read 1e-6 to 5.7e-6 (the live ones 1.2e-7 at most,
# weighted by their share), a wrong completion O(0.1)
DEAD_COLUMN_TOL = 1.0e-04
GAUGE_TOL = 1.0e-05  # max |QᴴQ − I|, the engine's complex64 gauge check
BULK_SITE = 30
EXCITON_SITE = 61  # n_left of singlet_fission_chain()
# bench_chi.py's defaults (its lines 100-189) and its gold populations
CHI = 1024
RP_NUC = 8  # nuclei per radical: 18 sites with the split electron layout
RP_KRYLOV = 7
RP_THRESH = 1.0e-06
RP_DT = 0.5
RP_STEPS = 10  # timed steps after one warm-up step, as in bench_chi.py
RP_KEY = "chi1024_nuc8_split1_lt2_dt1_steps10_complex64"
RP_BULK_SITE = 8  # a (1024, 4, 1024) site
# the host-driven witness of the replayed radical pair: after one warm-up
# step, RP_HOST_STEPS steps traced (held to the same replayed steps), then
# RP_HOST_TIMED steps timed (cut from 1 + 10 to keep the run short)
RP_HOST_STEPS = 3
RP_HOST_TIMED = 2
# the radical pair through Simulator.propagate: one block of 4 (a host
# step, the capture, 3 replays) and one inline step, against stride 1
RP_SIM_STEPS = 5
RP_SIM_STRIDE = 4
# the χ=2048 anchor (bench_chi.py with BENCH_CHI=2048 BENCH_RP_NUC=6
# BENCH_KRYLOV=8): 1 + 5 steps at "throughput", the 5 as graph replays
CHI_ANCHOR = 2048
ANCHOR_NUC = 6
ANCHOR_KRYLOV = 8
ANCHOR_STEPS = 5
ANCHOR_KEY = "chi2048_nuc6_split1_lt2_dt1_steps5_complex64"
# the Krylov control kernel vs its plain version on the radical pair's own
# reduced matrices: the coefficients relative to the largest (float32
# Taylor products in another order; tests/test_torch_krylov.py's bar), the
# flags and status equal unless the error lies within 1e-3 of the
# threshold (a decision at round-off)
CTL_TOL = 2.0e-05
# the control kernel's device time: launches captured into one graph
GRAPH_LAUNCHES = 200
CTL_EDGE = 1.0e-03
# relaxed matvec kernel vs its plain version, relative to the output norm:
# the same bf16 rounding points, float32 sums in another order.  On the
# chain's operands the kernels read 0 to 9.2e-6 and one bf16 rounding more
# (the output rounded to bf16) 1.4e-3 to 1.7e-3, so the bar sits between.
# Random operands read more, up to 1.1e-4 at the bulk with d = 16 (long
# unstructured sums put many T1 entries near a bf16 rounding boundary):
# there the bar is tests/test_torch_matvec.py's 3e-4, which the
# bf16-rounded output fails all the same
MATVEC_TOL = 1.0e-04
MATVEC_TOL_RANDOM = 3.0e-04
# sites the JAX package runs and the earlier kernels refused, at the χ=1024
# bulk on seeded random operands: a spin-1 nucleus (d = 9) and the electron
# pair of bench_chi.py's BENCH_SPLIT=0 layout (d = 16), MPO width 8
WIDE_D = (9, 16)
# one heff_lo call at the χ=2048 anchor's bulk (d = 4, w = 8): the scratch
# it allocates (ψ's planes, T1, T2, the output) must stay under this
CHI2048_PEAK_BYTES = 2.0e9
# bf16x3 chain kernel vs its plain version, relative to the output norm:
# the same splits and rounding points, the float32 sums in the tensor
# cores' own order (1.5e-7 to 9.1e-6 on the chain's operands); the plain
# version with its lo passes dropped (one bf16 pass) reads 5.5e-4 to
# 1.4e-2 there and must fail it
CHAIN_TOL = 2.0e-05
# the IR-spectrum workflow (relax → operate(μ·E) → propagate → spectrum):
# H2O as tests/test_h2o_pipeline.py runs it (10 improved steps, 500 steps
# of 0.2 fs) and its literals: the ZPE (held here in complex64 to 1e-6) and
# the bend and stretch lines within the test's windows
H2O_RELAX_STEPS = 10
H2O_PROP_STEPS = 500
H2O_ZPE = 0.0208557166
H2O_ZPE_TOL = 1.0e-06
H2O_BEND = (1612.0, 90.0)
H2O_STRETCH = (3787.0, 180.0)
EFIELD = (1.0e-02, 1.0e-02, 1.0e-02)
# butadiene at examples/butadiene_ir_spectrum.py's own settings (8 improved
# steps, operate 10 sweeps, 400 steps of 0.2 fs); its gold from the JAX
# package on the CPU in complex128 with the example's settings (LAPACK's
# gauge; the JAX package pinned to its MGS gauge, the port's, reads E_gs
# 0.06757225533221635 and ‖μ|0⟩‖ 0.0013707910419449817: 1.5e-9 and 5e-6
# relative away): E_gs, ‖μ|0⟩‖, the strongest line in 600-3500 cm⁻¹ and the
# frequency grid's spacing
GOLD_C4H6 = {"e_gs": 0.06757225687261864, "norm": 0.0013707978631834132,
             "peak": 2956.893669394627, "bin": 209.26223337514966}
C4H6_RELAX_STEPS = 8
C4H6_PROP_STEPS = 400
C4H6_BULK = 6  # a (12, 6, 12) site under the (30, 6, 6, 30) MPO core
C4H6_E_TOL = 1.0e-06  # E_gs in complex64 against the gold
C4H6_NORM_RTOL = 1.0e-04  # ‖μ|0⟩‖ in complex64, relative
# ⟨H⟩ of the propagated μ|0⟩ (complex64, contracted in complex128) over
# the whole run, last step against the start
WF_E_DRIFT = 1.0e-05
# imaginary-time relaxation of butadiene: steps of 0.1 fs from the Hartree
# product; ⟨H⟩ may not rise by more than the rounding of a complex64 value
# (0.07 × 6e-8) with margin; the end ⟨H⟩ against the plain route's
IMAG_STEPS = 4
IMAG_SLACK = 1.0e-07
IMAG_TOL = 1.0e-06
# the Krylov threshold of the real-scale kernel checks (the chain's)
REAL_SCALE_THRESH = 1.0e-06
# the ground-state kernel against its plain version: the energy relative,
# and |⟨kernel|plain⟩| (float32 sums in another order; the 1e-12 restart
# test sits at rounding, so the pass counts may differ)
GS_E_RTOL = 1.0e-06
GS_OVERLAP_TOL = 1.0e-05
# the H2O shape whose ground state is timed beside the butadiene bulk
H2O_TIMED = (81, 9, 3)
# (M, r, channels) of a random site that takes the ground-state kernel's
# wide layout (its whole vectors in device scratch), which no relax site
# reaches
GS_WIDE = (300, 30, 4)
# the launches of the port's kernels in a profiler trace: the kernel's
# name, the wrapper and route that launch it (the MGS "device" route also
# launches mgs_qr_kernel; the paths that count by trace never take it, as
# their host-launched steps show), one marker kernel each side of the run
TRACED_KERNELS = {
    "lanczos_expm_kernel": ("lanczos_expm", "block"),
    "lanczos_expm_cluster_kernel": ("lanczos_expm", "cluster"),
    "mgs_qr_kernel": ("mgs_qr", "block"),
    "mgs_qr_cluster_kernel": ("mgs_qr", "cluster"),
    "site_step_kernel": ("site_step", "block"),
    "site_step_cluster_kernel": ("site_step", "cluster"),
}
# every kernel of the port's sources (the traced launches by name): the
# staged GEMMs and their planes kernel (chain_tc.cu, keff_tc.cu), the
# Krylov control step, MGS, Lanczos, the fused site
PORT_KERNELS = ("cgemm_kernel", "planes_kernel", "krylov_ctl_kernel",
                "mgs_qr", "lanczos_expm", "site_step", "lanczos_gs")
MARKER = "spin_kernel"  # torch.cuda._sleep
MARK_CYCLES = 1000
TRACE_SETTLE_S = 0.5
TRACE_PRIME = 256
TRACE_ATTEMPTS = 5
# the card's peaks (H100 SXM data sheet, dense, at 700 W)
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12


# ``--save-state DIR``: the long runs' end states are kept there
SAVE_DIR: str | None = None


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def save_state(tag: str, engine, e32: float, e64: float, nsteps: int):
    """With ``--save-state DIR``: the engine's cores and the card's two
    readings of ⟨H⟩, in complex64 (``expectation``) and in complex128
    (:func:`energy64`), as ``DIR/<tag>.npz`` for
    ``tests/torch_energy_c64.py``."""
    if SAVE_DIR is None:
        return
    os.makedirs(SAVE_DIR, exist_ok=True)
    path = os.path.join(SAVE_DIR, f"{tag}.npz")
    np.savez(path, *[c.cpu().numpy() for c in engine.cores[0]], e32=e32,
             e64=e64, nsteps=nsteps)
    log(f"{tag}: end state saved to {path}")


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` on the card over ``reps`` runs, after
    two warm-up runs (CUDA events around the whole batch)."""
    import torch

    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def graph_ms(fn, launches: int = GRAPH_LAUNCHES, replays: int = 5) -> float:
    """Device milliseconds of one ``fn()`` with no host in the loop:
    ``launches`` calls captured into one CUDA graph, replayed ``replays``
    times after one warm-up replay, the events' time over the calls
    replayed."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (replays * launches)


def bound(flops: float, peak: float, nbytes: float) -> dict:
    """The least time (ms) for ``flops`` operations at ``peak`` FLOP/s and
    ``nbytes`` of operands read and output written at the memory rate: the
    larger of the two, and which one it is."""
    ops_ms, bytes_ms = 1e3 * flops / peak, 1e3 * nbytes / PEAK_BYTES
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def chain_flops(B, K, X, Rd, din, dout, wl, wr, has_w=True) -> float:
    """Real FLOPs of one pass of the four-tensor chain (8 per complex
    multiply-add): T1 over r, the W mix, the output over (a, k)."""
    mix = K * X * wl * dout * din * wr if has_w else 0
    return 8.0 * (K * din * X * wr * Rd + mix + B * dout * X * wl * K)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def phase_device():
    import torch

    import pytdscf_torch  # noqa: F401  (the package turns TF32 off)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    log(f"allow_tf32: matmul {tf32[0]}, cudnn {tf32[1]}")
    require(tf32 == (False, False), "TF32 must be off for the port")


def phase_build():
    from pytdscf_torch import _cuda

    path, ptxas, seconds = _cuda.build()
    log(f"build: {path.name} in {seconds:.1f} s")
    for line in ptxas.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")
    _cuda.load()


def build_engine(device):
    from pytdscf_torch.config import Config
    from pytdscf_torch.models.holstein import singlet_fission_chain
    from pytdscf_torch.mps.lattice import alloc_hartree_product
    from pytdscf_torch.mps.tdvp import TDVPEngine

    basis, ham = singlet_fission_chain()
    phys = [b.nprim for b in basis]
    vecs = []
    for i, b in enumerate(basis):
        v = np.zeros(b.nprim, dtype=complex)
        v[1 if i == EXCITON_SITE else 0] = 1.0
        vecs.append(v)
    cores = [alloc_hartree_product(phys, BOND, vecs)]
    config = Config(thresh_exp=1.0e-06, max_krylov=10, dtype="complex64",
                    fused_site=False)
    return TDVPEngine(cores, ham, config, device)


def site_operands(engine, p: int):
    """(L, lL), W, (R, lR) and the left block past site p (None at the
    last site), from the engine's current cores."""
    left = engine.build_left_env_stack()
    right = engine.build_right_env_stack()
    past = left[p + 1] if p + 1 < len(left) else None
    return left[p], engine.W[p], right[engine.nsite - 1 - p], past


def check_lanczos(engine, dt_au, results):
    """The Lanczos kernel against its plain version on the chain's
    operands: the H step at the bulk and the exciton site, the K step at a
    bulk bond, each through its own route and size
    (``cuda_lanczos.route``, ``cluster_size``), through one block and
    through clusters of 8 and 16 CTAs: the plain version's status, ‖Δψ‖ <
    5e-6, a second launch equal bit for bit.  Each is timed; the bulk H
    step also as the entry of the ``kernels`` line, the bulk K step for
    the route crossover."""
    import torch

    from pytdscf_torch.mps import cuda_lanczos as CL
    from pytdscf_torch.mps import kernels as K

    cfg = engine.config
    checks = []
    for p in (BULK_SITE, EXCITON_SITE):
        (L, lL), W, (R, lR), (L1, lL1) = site_operands(engine, p)
        psi = engine.cores[0][p]
        l, d, r = psi.shape
        ch = CL.heff_channels(L, W, R, torch.exp(lL + lR))
        checks.append((f"H step, site {p}", ch, psi.reshape(l * d, r).contiguous(),
                       -0.5j * dt_au))
        if p == BULK_SITE:
            _, sig = K.qr_right(psi)
            kch = CL.keff_channels(L1, R, torch.exp(lL1 + lR))
            checks.append((f"K step, bond {p}", kch, sig.contiguous(),
                           0.5j * dt_au))
    worst = 0.0
    for name, ch, v, scale in checks:
        args = (v, scale, cfg.thresh_exp, cfg.max_krylov, cfg.conserve_norm)
        kmax = min(cfg.max_krylov, v.numel())
        out_p, st_p = CL.lanczos_expm_plain(*ch, v, scale, cfg.thresh_exp,
                                            kmax, cfg.conserve_norm)
        st_p = st_p.tolist()
        plain_ms = cuda_ms(lambda: CL.lanczos_expm_plain(
            *ch, v, scale, cfg.thresh_exp, kmax, cfg.conserve_norm), 5)
        nc, M, r = ch[0].shape[0], v.shape[0], v.shape[1]
        own, own_c = CL.route(M, r, nc), CL.cluster_size(M, r, nc)
        variants = [(own, own_c)] + [
            (way, c) for way, c in (("block", None), ("cluster", 8),
                                    ("cluster", 16))
            if (way, c) != (own, own_c)
            and (way == "block" or CL.smem_bytes(nc, M, r, c) <= CL.MAX_SMEM)]
        times = {}
        for way, size in variants:
            kw = dict(way=way, cluster=size)
            out_k, st_k = CL.lanczos_expm(ch, *args, **kw)
            again, _ = CL.lanczos_expm(ch, *args, **kw)
            torch.cuda.synchronize()
            st_k = st_k.tolist()
            tag = route_tag(way, size)
            dpsi = float(torch.linalg.vector_norm(out_k - out_p))
            err = float(torch.max(torch.abs(out_k - out_p)))
            require(bool(torch.isfinite(out_k).all()),
                    f"lanczos {name} [{tag}]: not finite")
            require(torch.equal(out_k, again), f"lanczos {name} [{tag}]: a "
                    "second launch gave another result")
            require(st_k == st_p, f"lanczos {name} [{tag}]: kernel status "
                    f"{st_k} vs plain {st_p}")
            require(dpsi < LANCZOS_TOL, f"lanczos {name} [{tag}]: ‖Δψ‖ "
                    f"{dpsi:.3e}")
            times[tag] = cuda_ms(lambda: CL.lanczos_expm(ch, *args, **kw), 50)
            if (way, size) == variants[0]:
                ms, worst = times[tag], max(worst, err)
            log(f"lanczos {name} [{tag}]: M={M} r={r} nc={nc} k_used="
                f"{st_k[0]} ‖Δψ‖={dpsi:.3e} max|Δ|={err:.3e}; repeat "
                f"bit-identical; kernel {times[tag]:.4f} ms")
        log(f"lanczos {name}: route {own}, plain {plain_ms:.4f} ms; "
            + ", ".join(f"{k} {t:.4f} ms" for k, t in times.items()))
        if "lanczos_expm" not in results:
            # k_used matvecs of Σ_c H_c·(ψ·Rt_c): nc·(M·r² + M²·r) complex
            # multiply-adds each (the Krylov recurrence around them is
            # smaller by M)
            H, Rt = ch
            flops = 8.0 * st_p[0] * nc * (M * r * r + M * M * r)
            results["lanczos_expm"] = {
                "ms": ms, "plain_ms": plain_ms, "library_ms": None,
                "route": own, "cluster": own_c, "times_by_route": times,
                **bound(flops, PEAK_FP32, nbytes(H, Rt, v, out_p))}
        if name.startswith("K step"):
            results["lanczos_expm"]["k_step_times_by_route"] = times
        if name == f"H step, site {BULK_SITE}":
            # the cost of one iteration and of the rest (launch, set-up,
            # result) on each route: one and ten iterations, no stopping;
            # on the cluster also with the first channel alone, whose
            # matvec does a quarter of the work with the same exchanges
            per = {}
            one = tuple(t[:1].contiguous() for t in ch)
            for way, chs in (("block", ch), ("cluster", ch),
                             ("cluster, 1 channel", one)):
                t1, t10 = (cuda_ms(lambda k=k, chs=chs: CL.lanczos_expm(
                    chs, v, scale, 0.0, k, cfg.conserve_norm,
                    way=way.split(",")[0]), 20) for k in (1, 10))
                per[way] = {"per_iteration_ms": (t10 - t1) / 9,
                            "fixed_ms": t1 - (t10 - t1) / 9}
            results["lanczos_expm"]["iteration_cost"] = per
            log(f"lanczos {name}: per iteration (slope of 1 → 10 "
                "iterations) " + ", ".join(
                    f"{way} {c['per_iteration_ms']:.4f} ms + "
                    f"{c['fixed_ms']:.4f} ms fixed" for way, c in per.items()))
    return worst


def route_tag(way: str, size) -> str:
    return way + (f" C={size}" if way == "cluster" else "")


def lanczos_shapes(engine) -> dict:
    """The Lanczos launches of one chain step by (kind, M, r, nc): every
    site's H step in both half-sweeps (ψ (l·d, r)), and the K step of
    every non-last site of each (σ (r, r) forward, (l, l) backward)."""
    per: dict = {}
    n = engine.nsite
    for p, core in enumerate(engine.cores[0]):
        l, d, r = core.shape
        wl, wr = engine.W[p].shape[0], engine.W[p].shape[-1]
        for key, k in ((("H", l * d, r, wr), 2),
                       (("K", r, r, wr), int(p < n - 1)),
                       (("K", l, l, wl), int(p > 0))):
            per[key] = per.get(key, 0) + k
    return per


def lanczos_routes(engine) -> tuple[dict, dict]:
    """Lanczos launches of one chain step by route, and the cluster
    route's by size (``cuda_lanczos.route``, ``cluster_size``)."""
    from pytdscf_torch.mps import cuda_lanczos as CL

    per, sizes = dict.fromkeys(CL.ROUTES, 0), {}
    for (_, M, r, nc), k in lanczos_shapes(engine).items():
        per[CL.route(M, r, nc)] += k
        c = CL.cluster_size(M, r, nc)
        if c is not None and k:
            sizes[c] = sizes.get(c, 0) + k
    return per, sizes


def lanczos_sweep(engine, dt_au, results) -> None:
    """Every Lanczos shape of a chain step on the chain's own operands (the
    first site that has it, forward), through one block and clusters of 8
    and 16 CTAs where they fit: each checked as ``check_lanczos`` checks
    (status, ‖Δψ‖, a bit-identical repeat) and timed.  Logs, per shape, its
    launches per step, its route and the fastest; and the device time of
    one step's Lanczos calls under the routes as set and under each fixed
    choice.  Timing only: the routes are the wrappers' own."""
    import torch

    from pytdscf_torch.mps import cuda_lanczos as CL
    from pytdscf_torch.mps import kernels as K

    cfg = engine.config
    left = engine.build_left_env_stack()
    right = engine.build_right_env_stack()
    shapes = lanczos_shapes(engine)
    rows = []
    for (kind, M, r, nc), count in sorted(shapes.items()):
        if not count:
            continue
        for p, core in enumerate(engine.cores[0]):
            l, d, rr = core.shape
            wr = engine.W[p].shape[-1]
            if (kind == "H" and (l * d, rr, wr) == (M, r, nc)) or (
                    kind == "K" and p < engine.nsite - 1
                    and (rr, rr, wr) == (M, r, nc)):
                break
        else:
            log(f"lanczos sweep: no forward site with {kind} {(M, r, nc)}")
            continue
        (L, lL), W = left[p], engine.W[p]
        R, lR = right[engine.nsite - 1 - p]
        psi = engine.cores[0][p]
        if kind == "H":
            ch = CL.heff_channels(L, W, R, torch.exp(lL + lR))
            v, scale = psi.reshape(M, r).contiguous(), -0.5j * dt_au
        else:
            L1, lL1 = left[p + 1]
            ch = CL.keff_channels(L1, R, torch.exp(lL1 + lR))
            v, scale = K.qr_right(psi)[1].contiguous(), 0.5j * dt_au
        args = (v, scale, cfg.thresh_exp, cfg.max_krylov, cfg.conserve_norm)
        kmax = min(cfg.max_krylov, v.numel())
        out_p, st_p = CL.lanczos_expm_plain(*ch, v, scale, cfg.thresh_exp,
                                            kmax, cfg.conserve_norm)
        st_p = st_p.tolist()
        times = {}
        for way, size in (("block", None), ("cluster", 8), ("cluster", 16)):
            if way == "cluster" and CL.smem_bytes(nc, M, r, size) > CL.MAX_SMEM:
                continue
            kw = dict(way=way, cluster=size)
            tag = route_tag(way, size)
            out_k, st_k = CL.lanczos_expm(ch, *args, **kw)
            again, _ = CL.lanczos_expm(ch, *args, **kw)
            torch.cuda.synchronize()
            dpsi = float(torch.linalg.vector_norm(out_k - out_p))
            require(st_k.tolist() == st_p, f"lanczos sweep {kind} "
                    f"{(M, r, nc)} [{tag}]: status {st_k.tolist()} vs {st_p}")
            require(dpsi < LANCZOS_TOL and torch.equal(out_k, again),
                    f"lanczos sweep {kind} {(M, r, nc)} [{tag}]: ‖Δψ‖ "
                    f"{dpsi:.3e} or a repeat differs")
            times[tag] = cuda_ms(lambda: CL.lanczos_expm(ch, *args, **kw), 50)
        own = route_tag(CL.route(M, r, nc), CL.cluster_size(M, r, nc))
        rows.append({"kind": kind, "shape": [M, r, nc], "site": p,
                     "per_step": count, "k_used": st_p[0], "route": own,
                     "fastest": min(times, key=times.get), "ms": times})
        log(f"lanczos sweep {kind} (M, r, nc)={(M, r, nc)} site {p}: "
            f"{count}/step, k {st_p[0]}, own {own}, fastest {rows[-1]['fastest']}; "
            + ", ".join(f"{t} {ms:.4f} ms" for t, ms in times.items()))
    step_ms = {"as routed": sum(x["per_step"] * x["ms"][x["route"]]
                                for x in rows)}
    for tag in ("block", "cluster C=8", "cluster C=16"):
        if all(tag in x["ms"] for x in rows):
            step_ms[tag] = sum(x["per_step"] * x["ms"][tag] for x in rows)
    step_ms["fastest each"] = sum(x["per_step"] * x["ms"][x["fastest"]]
                                  for x in rows)
    log("lanczos sweep: one step's Lanczos device ms (per-shape time × "
        "launches) " + ", ".join(f"{k} {v:.2f}" for k, v in step_ms.items()))
    results["lanczos_expm"]["route_sweep"] = rows
    results["lanczos_expm"]["route_sweep_step_ms"] = step_ms


def check_mgs(name: str, m, timed: bool = False):
    """The MGS kernel against its plain version on the card, on one
    complex64 (N, r) matrix, with the _check criteria of
    tests/test_pallas_qr.py: (max |Δ| of Q and R, R, kernel ms, plain ms);
    the times are None unless ``timed``."""
    import torch

    from pytdscf_torch.mps import cuda_qr as CQ

    q, rm = CQ.mgs_qr(m)
    q2, r2 = CQ.mgs_qr(m)
    q_p, r_p = CQ.mgs_qr_plain(m)
    torch.cuda.synchronize()
    n, r = m.shape
    way = CQ.route(n, r)
    require(torch.equal(q, q2) and torch.equal(rm, r2),
            f"mgs_qr {name}: a second launch gave another result")
    eye = torch.eye(r, dtype=m.dtype, device=m.device)
    mnorm = float(torch.linalg.vector_norm(m))
    orth = float(torch.linalg.matrix_norm(eye - q.conj().T @ q))
    rec = float(torch.linalg.matrix_norm(q @ rm - m))
    dq = float(torch.linalg.matrix_norm(q - q_p))
    dr = float(torch.linalg.matrix_norm(rm - r_p))
    require(orth < 1e-5 * r, f"mgs_qr {name}: orthogonality {orth:.3e}")
    require(rec < 1e-5 * mnorm + 1e-7, f"mgs_qr {name}: Q·R−m {rec:.3e}")
    require(dq < 5e-6 * math.sqrt(n * r), f"mgs_qr {name}: ‖ΔQ‖ {dq:.3e}")
    require(dr < 5e-6 * r * mnorm + 1e-6, f"mgs_qr {name}: ‖ΔR‖ {dr:.3e}")
    err = max(float(torch.max(torch.abs(q - q_p))),
              float(torch.max(torch.abs(rm - r_p))))
    line = (f"mgs_qr {name} ({n}, {r}), {way} route: orth {orth:.3e} rec "
            f"{rec:.3e} ‖ΔQ‖ {dq:.3e} ‖ΔR‖ {dr:.3e} max|Δ| {err:.3e}; repeat "
            "bit-identical")
    times = None
    if timed:
        times = {"shape": [n, r], "route": way,
                 "ms": cuda_ms(lambda: CQ.mgs_qr(m), 200),
                 "plain_ms": cuda_ms(lambda: CQ.mgs_qr_plain(m), 10),
                 "library_ms": cuda_ms(lambda: torch.linalg.qr(m), 50),
                 # MGS×2: two passes of N·r² complex multiply-adds
                 **bound(8.0 * 2 * n * r * r, PEAK_FP32, nbytes(m, q, rm))}
        line += (f"; kernel {times['ms']:.4f} ms, plain "
                 f"{times['plain_ms']:.4f} ms, torch.linalg.qr "
                 f"{times['library_ms']:.4f} ms, bound "
                 f"{times['bound_ms']:.2e} ms")
    log(line)
    return err, rm, times


def check_qr(results):
    """The MGS kernel against its plain version at the chain's (240, 30),
    full rank and rank deficient, and at the one-block shapes of the
    later paths (MGS_PATH_SHAPES), full rank, each timed beside its plain
    version, ``torch.linalg.qr`` and its bound (the entry's ``cases``;
    the (240, 30) full-rank case is the entry's own time)."""
    import torch

    def seeded(shape):
        rng = np.random.default_rng(0)
        a = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
        return a / np.linalg.norm(a)

    full = seeded((240, 30))
    deficient = full.copy()
    deficient[:, [3, 7, 29]] = 0.0
    worst = 0.0
    for name, m_np in (("full rank", full), ("rank deficient", deficient),
                       *((f"{tag} shape", seeded(shape))
                         for tag, shape in MGS_PATH_SHAPES)):
        m = torch.as_tensor(m_np, dtype=torch.complex64, device="cuda")
        err, rm, times = check_mgs(name, m, timed=True)
        if name == "rank deficient":
            for k in (3, 7, 29):
                require(abs(complex(rm[k, k])) < 1e-6,
                        f"mgs_qr: dead column {k} has a nonzero R diagonal")
        worst = max(worst, err)
        if "mgs_qr" not in results:  # the full-rank factor, timed
            results["mgs_qr"] = {**times, "cases": [times]}
        elif name != "rank deficient":
            results["mgs_qr"]["cases"].append(times)
    return worst


def mgs_launch_shapes(run) -> list[tuple[int, int]]:
    """The operand shapes of the MGS kernel launches of ``run()``, in
    launch order: ``kernels.thin_qr`` reaches the wrapper through its
    module's name ``cuda_qr``, which a recorder stands for meanwhile (the
    wrapper and its counts are untouched)."""
    from pytdscf_torch.mps import cuda_qr as CQ
    from pytdscf_torch.mps import kernels as K

    shapes = []

    def mgs_qr(m):
        shapes.append(tuple(m.shape))
        return CQ.mgs_qr(m)

    K.cuda_qr = SimpleNamespace(mgs_qr=mgs_qr)
    try:
        run()
    finally:
        K.cuda_qr = CQ
    return shapes


def shape_counts(shapes) -> dict[str, int]:
    """How many of ``shapes`` are each shape."""
    out: dict[str, int] = {}
    for shape in shapes:
        out[str(shape)] = out.get(str(shape), 0) + 1
    return out


def record_step_shapes(tag: str, engine, step, times) -> list:
    """The MGS launches of one host-driven ``step()`` of ``engine``, as
    recorded by :func:`mgs_launch_shapes`, held to the step's gauge moves
    (:func:`mgs_moves`, shape for shape) and counted by shape into
    ``times["mgs_step_shapes"][tag]``."""
    shapes = mgs_launch_shapes(step)
    require(sorted(map(str, shapes)) == sorted(
        str(shape) for _, _, shape in mgs_moves(engine)),
        f"{tag}: a step's {len(shapes)} MGS launches are not its gauge "
        "moves")
    times["mgs_step_shapes"][tag] = shape_counts(shapes)
    log(f"{tag}: MGS launches of one host-driven step by shape, as "
        f"recorded {times['mgs_step_shapes'][tag]}")
    return shapes


def mgs_replay_by_shape(shapes, events, steps: int) -> list[dict]:
    """The MGS kernel's device time in a trace of ``steps`` replayed steps
    by operand shape: the trace's MGS kernels in time order (``events``,
    (start, microseconds)) follow one step's launch order ``shapes`` step
    after step.  Each shape's launches and device ms a step, its mean ms a
    launch beside one launch timed alone on seeded operands (CUDA events),
    largest share first."""
    import torch

    from pytdscf_torch.mps import cuda_qr as CQ

    require(len(events) == steps * len(shapes),
            f"mgs by shape: {len(events)} traced launches, {steps} × "
            f"{len(shapes)} expected")
    acc: dict[tuple[int, int], list[float]] = {}
    for i, (_, dur) in enumerate(sorted(events)):
        acc.setdefault(shapes[i % len(shapes)], []).append(dur / 1e3)
    rows = []
    rng = np.random.default_rng(0)
    for shape, durs in acc.items():
        a = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
        m = torch.as_tensor(a / np.linalg.norm(a), dtype=torch.complex64,
                            device="cuda")
        rows.append({"shape": list(shape), "per_step": len(durs) // steps,
                     "ms_per_step": sum(durs) / steps,
                     "mean_ms": sum(durs) / len(durs),
                     "alone_ms": cuda_ms(lambda: CQ.mgs_qr(m), 50)})
    return sorted(rows, key=lambda x: -x["ms_per_step"])


def profile_step(engine, dt_au) -> None:
    """One host-driven TDVP step under ``torch.profiler``."""
    profile_run(lambda: engine.propagate(dt_au))


def profile_run(run, count: bool = False):
    """``run()`` under ``torch.profiler``: its wall time, the summed
    device time of every kernel (busy share of the wall time), each kernel
    of the port, and the torch ops that launch kernels most often.
    Returns the busy share; with ``count``, also the launches of the port's
    kernels that the profiler saw (:func:`traced_launches`)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, TRACE_ATTEMPTS + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            if count:
                # a trace can lose the first kernels of a session (a
                # replayed chain step lost its first 25 in one probe):
                # settle, launch some small kernels, then bracket the run
                # with one marker kernel each side
                time.sleep(TRACE_SETTLE_S)
                one = torch.zeros((), device="cuda")
                for _ in range(TRACE_PRIME):
                    one.add_(1.0)
                torch.cuda.synchronize()
                torch.cuda._sleep(MARK_CYCLES)
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
            if count:
                torch.cuda._sleep(MARK_CYCLES)
                torch.cuda.synchronize()
        seen = traced_launches(prof) if count else None
        if seen is None or (seen["markers"] == 2 and not seen["lost"]):
            break
        log(f"profile: the trace lost the marker kernel at the run's "
            f"{' and '.join(seen['lost'])} (attempt {attempt}); the run "
            "again")
    else:
        raise SmokeFailure(f"profile: {TRACE_ATTEMPTS} traces of the run "
                           "each lost a marker kernel")
    events = prof.key_averages()
    on_device = sorted((e for e in events if e.device_type == DeviceType.CUDA
                        and MARKER not in e.key),
                       key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in on_device) / 1e3
    require(busy_ms > 0.0, "profile: no device time was traced")
    log(f"profile: wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms "
        f"({100 * busy_ms / wall_ms:.1f} % of the wall time)")
    for e in on_device[:8]:
        ms = e.self_device_time_total / 1e3
        log(f"profile: device {ms:9.2f} ms {e.count:6d}x "
            f"{100 * ms / wall_ms:5.1f} %  {e.key[:70]}")
    ops = sorted((e for e in events if e.key.startswith("aten::")
                  and e.self_device_time_total > 0), key=lambda e: -e.count)
    for e in ops[:5]:
        log(f"profile: op {e.key} {e.count}x, device "
            f"{e.self_device_time_total / 1e3:.2f} ms")
    if count:
        log(f"profile: the port's kernels as traced: {launch_text(seen)}")
        seen["device_ms"] = {e.key: e.self_device_time_total / 1e3
                             for e in on_device}
        return busy_ms / wall_ms, seen
    return busy_ms / wall_ms


def launch_record() -> dict:
    """Launches of the port's kernels (zeros): by kernel, by route and,
    for the Lanczos clusters, by cluster size."""
    from pytdscf_torch.mps import cuda_lanczos as CL
    from pytdscf_torch.mps import cuda_qr as CQ
    from pytdscf_torch.mps import cuda_site as CS

    return {"lanczos_expm": 0, "mgs_qr": 0, "site_step": 0,
            "lanczos_gs": 0,
            "lanczos_expm_routes": dict.fromkeys(CL.ROUTES, 0),
            "lanczos_expm_sizes": {},
            "mgs_qr_routes": dict.fromkeys(CQ.ROUTES, 0),
            "site_step_routes": dict.fromkeys(CS.ROUTES, 0),
            "lanczos_gs_routes": dict.fromkeys(CL.ROUTES, 0),
            "lanczos_gs_sizes": {}}


def traced_launches(prof) -> dict:
    """The launches of the port's kernels in a profiler trace: each kernel
    event by its name (:data:`TRACED_KERNELS`) and, for a cluster, its
    grid (one cluster of ``grid`` CTAs), with the marker kernels
    (``markers``).  Graph replays launch their kernel nodes on the card,
    and the trace records each like any other launch."""
    out = {**launch_record(), "markers": 0, "by_name": {}, "mgs_events": []}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    marks, ends = [], [math.inf, -math.inf]
    for e in events:
        if e.get("cat") != "kernel":
            continue
        name = e.get("name", "")
        if MARKER + "(" in name:
            out["markers"] += 1
            marks.append(float(e["ts"]))
            continue
        if any(k in name for k in PORT_KERNELS):
            ends = [min(ends[0], float(e["ts"])), max(ends[1], float(e["ts"]))]
            out["by_name"][name] = out["by_name"].get(name, 0) + 1
        if "lanczos_gs_kernel" in name:
            # one kernel for both routes: the one-block route is a
            # cluster of one CTA
            ends = [min(ends[0], float(e["ts"])), max(ends[1], float(e["ts"]))]
            size = int(e["args"]["grid"][0])
            way = "block" if size == 1 else "cluster"
            out["lanczos_gs"] += 1
            out["lanczos_gs_routes"][way] += 1
            if way == "cluster":
                sizes = out["lanczos_gs_sizes"]
                sizes[size] = sizes.get(size, 0) + 1
        for short, (kernel, way) in TRACED_KERNELS.items():
            if short + "(" in name:
                ends = [min(ends[0], float(e["ts"])),
                        max(ends[1], float(e["ts"]))]
                if kernel == "mgs_qr":
                    out["mgs_events"].append((float(e["ts"]),
                                              float(e["dur"])))
                out[kernel] += 1
                out[f"{kernel}_routes"][way] += 1
                if kernel == "lanczos_expm" and way == "cluster":
                    size = int(e["args"]["grid"][0])
                    sizes = out["lanczos_expm_sizes"]
                    sizes[size] = sizes.get(size, 0) + 1
    out["lost"] = [side for side, ok in (
        ("start", any(t < ends[0] for t in marks)),
        ("end", any(t > ends[1] for t in marks))) if not ok]
    return out


def counted_launches() -> dict:
    """The wrappers' launch counters in the form of :func:`launch_record`."""
    from pytdscf_torch.mps import cuda_lanczos as CL
    from pytdscf_torch.mps import cuda_qr as CQ
    from pytdscf_torch.mps import cuda_site as CS

    return {"lanczos_expm": CL.lanczos_expm.launches,
            "mgs_qr": CQ.mgs_qr.launches,
            "site_step": CS.site_step_fused.launches,
            "lanczos_expm_routes": dict(CL.lanczos_expm.route_launches),
            "lanczos_expm_sizes": {k: v for k, v in
                                   CL.lanczos_expm.cluster_launches.items()
                                   if v},
            "mgs_qr_routes": dict(CQ.mgs_qr.route_launches),
            "site_step_routes": dict(CS.site_step_fused.route_launches),
            "lanczos_gs": CL.ground_state.launches,
            "lanczos_gs_routes": dict(CL.ground_state.route_launches),
            "lanczos_gs_sizes": {k: v for k, v in
                                 CL.ground_state.cluster_launches.items()
                                 if v}}


def scaled(rec: dict, num: int, den: int = 1) -> dict:
    """A launch record times num/den (exact: it raises on a remainder)."""
    def one(n):
        require(n * num % den == 0, f"launches {n} × {num} / {den}")
        return n * num // den

    return {k: ({kk: one(vv) for kk, vv in v.items()} if isinstance(v, dict)
                else one(v)) for k, v in rec.items()
            if k not in ("markers", "lost", "by_name", "mgs_events",
                         "device_ms")}


def launch_text(rec: dict) -> str:
    return (f"lanczos {rec['lanczos_expm']} by route "
            f"{rec['lanczos_expm_routes']} by size "
            f"{rec['lanczos_expm_sizes']}, qr {rec['mgs_qr']} by route "
            f"{rec['mgs_qr_routes']}, site_step {rec['site_step']} by route "
            f"{rec['site_step_routes']}, lanczos_gs {rec['lanczos_gs']} by "
            f"route {rec['lanczos_gs_routes']} by size "
            f"{rec['lanczos_gs_sizes']}")


def path_launches(rec: dict) -> dict:
    """A main path's entries for the ``kernels`` line, from a launch
    record: (launches, error) per kernel and the by-route tallies."""
    out = {k: v for k, v in rec.items() if k.endswith(("_routes", "_sizes"))}
    for name in ("lanczos_expm", "mgs_qr", "site_step", "lanczos_gs"):
        if rec.get(name):
            out[name] = (rec[name], None)
    return out


def counters() -> dict:
    """Every kernel wrapper's launch counter, by kernel name."""
    from pytdscf_torch.mps import cuda_krylov as CK
    from pytdscf_torch.mps import cuda_lanczos as CL
    from pytdscf_torch.mps import cuda_matvec as CM
    from pytdscf_torch.mps import cuda_qr as CQ
    from pytdscf_torch.mps import cuda_renorm as CR
    from pytdscf_torch.mps import cuda_site as CS

    return {"lanczos_expm": CL.lanczos_expm, "mgs_qr": CQ.mgs_qr,
            "heff_lo": CM.heff_lo, "keff_lo": CM.keff_lo,
            "renorm_hi": CR.renorm_hi, "renorm_lo": CR.renorm_lo,
            "matvec_hi": CR.matvec_hi, "site_step": CS.site_step_fused,
            "krylov_ctl": CK.krylov_ctl, "lanczos_gs": CL.ground_state}


def reset_counts() -> None:
    """Zero every kernel wrapper's launch, by-route and plain-call counts."""
    for c in counters().values():
        c.launches = 0
        c.plain_calls = 0
        if hasattr(c, "route_launches"):
            c.route_launches = dict.fromkeys(c.route_launches, 0)
        if hasattr(c, "cluster_launches"):
            c.cluster_launches = {}


def plain_calls() -> int:
    return sum(c.plain_calls for c in counters().values())


def phase_chain(times) -> tuple[dict, float, object]:
    """The 184-site singlet-fission chain (PR 1's main path).  Returns the
    kernels' (launches, max |Δ|), the mean Krylov dimension over all its
    steps (warm-up included) and the engine."""
    import torch

    from pytdscf_torch import units
    from pytdscf_torch.mps import cuda_lanczos as CL
    from pytdscf_torch.mps import cuda_qr as CQ
    from pytdscf_torch.mps import cuda_renorm as CR
    from pytdscf_torch.mps import cuda_site as CS

    dt_au = DT_FS / units.au_in_fs
    t0 = time.perf_counter()
    engine = build_engine("cuda")
    log(f"engine: {engine.nsite} sites, D={BOND}, built in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    mgs_shapes = record_step_shapes(
        "chain", engine, lambda: engine.propagate(dt_au), times)
    torch.cuda.synchronize()
    log(f"warm-up step: {time.perf_counter() - t0:.3f} s")
    require(len(mgs_shapes) == 2 * (engine.nsite - 1),
            f"chain: {len(mgs_shapes)} MGS launches a step")

    err_lz = check_lanczos(engine, dt_au, times)
    lanczos_sweep(engine, dt_au, times)
    err_qr = check_qr(times)

    # ---- the main path, counted
    k_warm, calls_warm, _, _ = engine.krylov_stats()
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_s, step_k, capped = [], [(k_warm, calls_warm)], 0
    for _ in range(TIMED_STEPS):
        t0 = time.perf_counter()
        engine.propagate(dt_au)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        k, c, cap, _ = engine.krylov_stats()
        step_k.append((k, c))
        capped += cap
    peak = torch.cuda.max_memory_allocated()
    n_lz, n_qr = CL.lanczos_expm.launches, CQ.mgs_qr.launches
    avg_k, calls = mean_krylov(step_k[1:]), sum(c for _, c in step_k[1:])
    energy = engine.expectation().real
    norm = engine.norm()
    finite = all(bool(torch.isfinite(c).all()) for c in engine.cores[0])
    log(f"main path: s/step {[round(s, 4) for s in step_s]} "
        f"(median {float(np.median(step_s)):.4f}); energy {energy:.10f} "
        f"(|Δ| {abs(energy - E_REF):.2e}; in complex128 "
        f"{energy64(engine):.10f}); norm {norm:.8f}; "
        f"avg Krylov {avg_k:.3f} over {calls} calls, cap hits {capped}; "
        f"launches: lanczos {n_lz}, qr {n_qr}; peak memory "
        f"{peak / 2**20:.1f} MiB")
    require(finite, "main path: cores not finite")
    require(abs(energy - E_REF) <= E_TOL,
            f"energy {energy:.10f} vs {E_REF} (tol {E_TOL})")
    require(abs(norm - 1.0) <= NORM_TOL, f"norm {norm:.8f}")
    per_step = 2 * (2 * engine.nsite - 1)
    require(n_lz == TIMED_STEPS * per_step,
            f"lanczos launches {n_lz} != {TIMED_STEPS} × {per_step}")
    require(n_qr == TIMED_STEPS * 2 * (engine.nsite - 1),
            f"qr launches {n_qr} != {TIMED_STEPS} × {2 * (engine.nsite - 1)}")
    require(CR.renorm_hi.launches == CR.matvec_hi.launches == 0,
            "the bf16x3 kernel ran on the float32 chain")
    require(plain_calls() == 0, "main path: a plain version ran on the card")
    require(CS.site_step_fused.launches == 0, "the fused site kernel ran "
            "with fused_site off")
    routes = dict(CQ.mgs_qr.route_launches)
    require(routes["block"] == n_qr, f"qr launches by route {routes}: the "
            "chain's shapes take the one-block route")
    lz_routes = dict(CL.lanczos_expm.route_launches)
    lz_sizes = dict(CL.lanczos_expm.cluster_launches)
    per, sizes = lanczos_routes(engine)
    want = {k: TIMED_STEPS * n for k, n in per.items()}
    want_sizes = {k: TIMED_STEPS * n for k, n in sizes.items()}
    log(f"main path: lanczos launches by route {lz_routes}, the cluster's "
        f"by size {lz_sizes}")
    require(lz_routes == want and want["cluster"] > 0,
            f"lanczos launches by route {lz_routes} != {want}")
    require(lz_sizes == want_sizes and want_sizes.get(CL.CLUSTER, 0) > 0,
            f"lanczos cluster launches by size {lz_sizes} != {want_sizes}")
    # the launches of one host-launched step: what a replayed step must
    # launch on the card
    per_step_rec = scaled(counted_launches(), 1, TIMED_STEPS)
    profile_step(engine, dt_au)
    return ({"lanczos_expm": (n_lz, err_lz), "mgs_qr": (n_qr, err_qr),
             "mgs_qr_routes": routes, "lanczos_expm_routes": lz_routes,
             "lanczos_expm_sizes": lz_sizes},
            {"step_k": step_k, "peak": peak, "per_step": per_step_rec,
             "mgs_shapes": mgs_shapes},
            engine)


def mean_krylov(steps) -> float:
    """The mean Krylov dimension over (mean, calls) records."""
    return sum(k * c for k, c in steps) / sum(c for _, c in steps)


def energy64(engine) -> float:
    """⟨H⟩/⟨Ψ|Ψ⟩ of the engine's state, contracted wholly in complex128 on
    the card: a second reading beside the complex64 value the engine
    reports (``expectation``, the Simulator's rows), which contracts ⟨H⟩
    in complex128 too but rounds it to complex64 and does not divide by
    the norm (ROADMAP C3)."""
    import torch

    from pytdscf_torch.mps import kernels as K

    c128 = torch.complex128
    block, log = engine._right_block(engine.W, c128)
    one = torch.ones((1, 1, 1), dtype=c128, device=engine.device)
    cores = [c.to(c128) for c in engine.cores[0]]
    sig = K.heff_apply(one, engine.W[0].to(c128), block, cores[0])
    S = torch.ones((1, 1), dtype=c128, device=engine.device)
    for c in cores:
        S = K.ovlp_left_conj(S, c, c)
    return (complex(torch.sum(cores[0].conj() * sig)) * math.exp(float(log))
            / complex(S[0, 0])).real


def phase_chain_graph(eager, times) -> tuple[dict, float]:
    """bench.py's fused driver on a fresh engine: ``propagate_steps(dt,
    1)`` (a host step, then the capture of the step graph), then
    ``GRAPH_BLOCKS`` blocks of ``GRAPH_BLOCK`` replayed steps, counted and
    held to the host-driven phase ``eager``.  Returns the path's launches
    and the mean Krylov dimension over its first ``STRIDE_STEPS`` steps.
    The launches are the profiler's count of one more replayed block's
    kernels, the same as the counters' replay accounting of it; the same
    trace gives the MGS kernel's device time by operand shape
    (``times["mgs_qr"]["chain_replay_by_shape"]``)."""
    import torch

    from pytdscf_torch import units
    from pytdscf_torch.mps import cuda_lanczos as CL
    from pytdscf_torch.mps import cuda_qr as CQ
    from pytdscf_torch.mps import cuda_site as CS

    dt_au = DT_FS / units.au_in_fs
    engine = build_engine("cuda")
    require(engine.capturable(), "graph chain: the chain is not capturable")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine.propagate_steps(dt_au, 1)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    (prog,) = engine._programs.values()
    step_k = [engine.krylov_stats()[:2]]
    reset_counts()
    block_s = []
    for _ in range(GRAPH_BLOCKS):
        t0 = time.perf_counter()
        engine.propagate_steps(dt_au, GRAPH_BLOCK)
        torch.cuda.synchronize()
        block_s.append((time.perf_counter() - t0) / GRAPH_BLOCK)
        step_k.append(engine.krylov_stats()[:2])
    peak = torch.cuda.max_memory_allocated()
    steps = GRAPH_BLOCKS * GRAPH_BLOCK
    n_lz, n_qr = CL.lanczos_expm.launches, CQ.mgs_qr.launches
    lz_routes = dict(CL.lanczos_expm.route_launches)
    lz_sizes = dict(CL.lanczos_expm.cluster_launches)
    routes = dict(CQ.mgs_qr.route_launches)
    e32, energy, norm = engine.expectation().real, energy64(engine), \
        engine.norm()
    save_state("graph_chain", engine, e32, energy, 1 + steps)
    # steps 1-5 (warm-up and the first block) against the host-driven
    # phase's steps 1-5
    k5, k5_eager = mean_krylov(step_k[:2]), mean_krylov(eager["step_k"][:5])
    log(f"graph chain: warm-up step and capture {warm:.3f} s (capture and "
        f"instantiate {prog.capture_s:.3f} s); s/step per block "
        f"{[round(x, 4) for x in block_s]} (median "
        f"{float(np.median(block_s)):.4f}); energy {energy:.10f} (|Δ| "
        f"{abs(energy - E_REF):.2e}; evaluated in complex64 {e32:.10f}); "
        f"norm {norm:.8f}; avg Krylov "
        f"{mean_krylov(step_k[1:]):.3f} (steps 1-5: {k5:.3f}, host-driven "
        f"phase {k5_eager:.3f}); graph_steps {engine.graph_steps}, "
        f"eager_steps {engine.eager_steps}; launches: lanczos {n_lz} by "
        f"route {lz_routes}, by size {lz_sizes}, qr {n_qr}")
    log(f"graph chain: peak memory {peak / 2**20:.1f} MiB (host-driven "
        f"phase {eager['peak'] / 2**20:.1f} MiB); reserved "
        f"{torch.cuda.memory_reserved() / 2**20:.1f} MiB")
    require(all(bool(torch.isfinite(c).all()) for c in engine.cores[0]),
            "graph chain: cores not finite")
    require(abs(energy - E_REF) <= E_TOL,
            f"graph chain: energy {energy:.10f} vs {E_REF} (tol {E_TOL})")
    require(abs(e32 - E_REF) <= E_TOL, f"graph chain: complex64 energy "
            f"{e32:.10f} vs {E_REF} (tol {E_TOL})")
    require(abs(norm - 1.0) <= NORM_TOL, f"graph chain: norm {norm:.8f}")
    per, sizes = lanczos_routes(engine)
    want = {k: steps * n for k, n in per.items()}
    want_sizes = {k: steps * n for k, n in sizes.items()}
    require(n_lz == steps * 2 * (2 * engine.nsite - 1)
            and lz_routes == want and lz_sizes == want_sizes,
            f"graph chain: lanczos launches {n_lz} by route {lz_routes} by "
            f"size {lz_sizes} != {steps} steps of the host-driven phase's")
    require(n_qr == steps * 2 * (engine.nsite - 1)
            and routes["block"] == n_qr,
            f"graph chain: qr launches {n_qr} by route {routes}")
    require(CS.site_step_fused.launches == 0, "graph chain: site_step ran")
    require(plain_calls() == 0, "graph chain: a plain version ran")
    require((engine.graph_steps, engine.eager_steps) == (steps, 1),
            f"graph chain: graph_steps {engine.graph_steps}, eager_steps "
            f"{engine.eager_steps} != ({steps}, 1)")
    require(abs(k5 - k5_eager) <= KRYLOV_TOL,
            f"graph chain: mean Krylov {k5:.3f} vs {k5_eager:.3f}")
    # the launches of a replayed block as the card ran them: every kernel
    # node of each replay in the profiler's trace, against the
    # host-launched steps of phase b and the counters' replay accounting
    busy, seen = profile_run(lambda: (
        reset_counts(), engine.propagate_steps(dt_au, GRAPH_BLOCK)),
        count=True)
    log(f"graph chain: a replayed block of {GRAPH_BLOCK} steps keeps the "
        f"device {100 * busy:.1f} % busy")
    want = scaled(eager["per_step"], GRAPH_BLOCK)
    require(scaled(seen, 1) == want,
            f"graph chain: traced launches of {GRAPH_BLOCK} replayed steps "
            f"{launch_text(seen)} != {launch_text(want)}")
    require(counted_launches() == want,
            f"graph chain: counters after {GRAPH_BLOCK} replayed steps "
            f"{launch_text(counted_launches())} != {launch_text(want)}")
    rows = mgs_replay_by_shape(eager["mgs_shapes"], seen["mgs_events"],
                               GRAPH_BLOCK)
    times["mgs_qr"]["chain_replay_by_shape"] = rows
    log(f"graph chain: MGS device time a replayed step "
        f"{sum(x['ms_per_step'] for x in rows):.3f} ms over "
        f"{sum(x['per_step'] for x in rows)} launches; by shape: " + "; ".join(
            f"{tuple(x['shape'])} {x['per_step']}x {x['ms_per_step']:.3f} ms "
            f"(mean {x['mean_ms']:.4f}, alone {x['alone_ms']:.4f})"
            for x in rows))
    # what the step's copy of its new carry into the buffers costs inside
    # a graph (the same copy, recorded alone)
    from pytdscf_torch.mps.step_graph import copy_all

    new_carry = [b.clone() for b in prog.buffers]
    copy_graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(copy_graph):
        copy_all(prog.buffers, new_carry)
    copy_ms = cuda_ms(copy_graph.replay, 20)
    log(f"graph chain: copy-back of the carry ({len(new_carry)} tensors, "
        f"{nbytes(*new_carry) / 2**20:.1f} MiB) {copy_ms:.4f} ms a step, "
        "replayed")
    del copy_graph
    nblk = (STRIDE_STEPS - 1) // GRAPH_BLOCK
    return path_launches(seen), mean_krylov(step_k[:1 + nblk])


# ------------------------------------- the chain through Simulator.propagate
def site_flops(st, nc, M, r, P2) -> float:
    """Real FLOPs of one fused site update from its Krylov status (8 per
    complex multiply-add): kH H matvecs nc·(M·r² + M²·r), the
    renormalisation nc·(M²·r + M·r²), kK K matvecs 2·nc·r³, the MGS×2
    passes 2·M·r² and the absorb r²·P2."""
    kh, _, kk, _ = st
    return 8.0 * (kh * nc * (M * r * r + M * M * r)
                  + nc * (M * M * r + M * r * r)
                  + kk * 2 * nc * r ** 3 + 2 * M * r * r + r * r * P2)


def gauge_weights(args, kw) -> tuple:
    """The site tensor Q as forward-form columns, and each column's share
    |R_kk| / max_j |R_jj| of the plain version's gauge ψ₁ = Q·R: rounding
    differences of order ε‖ψ₁‖ move a column of Q by ε/share, so a column
    that carries 1e-2 of the state is fixed only to 1e2 ε."""
    import torch

    from pytdscf_torch.mps import cuda_lanczos as CL
    from pytdscf_torch.mps import cuda_qr as CQ
    from pytdscf_torch.mps import cuda_site as CS

    psi, nxt, L, W, R, scale, thresh, lL, lR = args
    p, _, Lf, Wf, Rf, _, _ = CS.forward_form(psi, nxt, L, W, R, lL, lR,
                                             kw["forward"])
    l, d, r = p.shape
    psi1, _ = CL.lanczos_expm_plain(
        *CL.heff_channels(Lf, Wf, Rf), p.reshape(l * d, r), scale, thresh,
        min(kw["max_dim"], l * d * r), kw["conserve"], fac=torch.exp(lL + lR))
    diag = CQ.mgs_qr_plain(psi1)[1].diagonal().abs()

    def columns(site):
        return (site if kw["forward"] else site.permute(2, 1, 0)).reshape(l * d, r)

    return columns, diag / diag.max()


def site_route(psi, W, forward: bool) -> str:
    """The fused site kernel's route for a site in a direction (its
    forward-form shape)."""
    from pytdscf_torch.mps import cuda_site as CS

    l, d, r = psi.shape
    if forward:
        return CS.route(W.shape[-1], l * d, r)
    return CS.route(W.shape[0], r * d, l)


def check_site_once(where, args, kw, want, way_kw) -> tuple:
    """One kernel run of the fused site kernel against the plain version's
    result ``want``: ψ_next, the blocks and the log-scale to 5e-6
    absolute; the site tensor Q column by column, a live column's error
    weighted by its share of the state (``gauge_weights``) to 5e-6, a dead
    one's to DEAD_COLUMN_TOL, Q orthonormal to GAUGE_TOL; the plain
    version's status; a second launch equal bit for bit.  Returns (the
    unweighted errors, the report)."""
    import torch

    from pytdscf_torch.mps import cuda_site as CS

    got = CS.site_step_fused(*args, **kw, **way_kw)
    again = CS.site_step_fused(*args, **kw, **way_kw)
    torch.cuda.synchronize()
    st, st_p = got[4].tolist(), want[4].tolist()
    require(all(bool(torch.isfinite(t).all()) for t in got[:3]),
            f"{where}: not finite")
    require(all(torch.equal(a, b) for a, b in zip(got, again)),
            f"{where}: a second launch gave another result")
    require(st == st_p, f"{where}: status {st} vs plain {st_p}")
    errs = [float(torch.max(torch.abs(a - b)))
            for a, b in zip(got[:3], want[:3])]
    dlog = abs(float(got[3]) - float(want[3]))
    columns, share = gauge_weights(args, kw)
    q = columns(got[0])
    dq = torch.abs(q - columns(want[0])).amax(0)
    werr = float(torch.max(dq * share))
    dead = share == 0
    dead_err = float(dq[dead].max()) if bool(dead.any()) else 0.0
    eye = torch.eye(q.shape[1], dtype=q.dtype, device=q.device)
    orth = float(torch.max(torch.abs(q.mH @ q - eye)))
    require(max(werr, *errs[1:], dlog) < LANCZOS_TOL
            and dead_err < DEAD_COLUMN_TOL and orth < GAUGE_TOL,
            f"{where}: max|Δ| site (weighted) {werr:.3e}, dead "
            f"columns {dead_err:.3e}, |QᴴQ−I| {orth:.3e}, next, "
            f"blocks {errs[1:]}, |Δlog| {dlog:.3e}")
    line = (f"{where}: status {st}; max|Δ| site {errs[0]:.3e} (live columns "
            f"weighted {werr:.3e}, {int(dead.sum())} dead columns "
            f"{dead_err:.3e}; |QᴴQ−I| {orth:.3e}) next {errs[1]:.3e} "
            f"blocks {errs[2]:.3e}, |Δlog| {dlog:.3e}; repeat bit-identical")
    return [*errs, dlog], line


def check_site(engine, dt_au, results) -> float:
    """The fused site kernel against its plain version on the chain's
    operands: the bulk site and the exciton site, forward (next core p + 1)
    and backward (p − 1), each through its own route
    (``cuda_site.route``), with ``check_site_once``'s criteria.  At the
    bulk, forward, also through the one-block route and the other cluster
    size (8 or 16 CTAs), all timed, beside the plain version and the same
    update through the separate kernels."""
    from pytdscf_torch.config import Config
    from pytdscf_torch.mps import cuda_site as CS
    from pytdscf_torch.mps.tdvp import _site_step

    cfg = Config(thresh_exp=1.0e-06, dtype="complex64")  # Simulator's
    worst = 0.0
    for p in (BULK_SITE, EXCITON_SITE):
        (L, lL), W, (R, lR), _ = site_operands(engine, p)
        psi = engine.cores[0][p].contiguous()
        for forward in (True, False):
            nxt = engine.cores[0][p + 1 if forward else p - 1].contiguous()
            args = (psi, nxt, L, W, R, -0.5j * dt_au, cfg.thresh_exp, lL, lR)
            kw = dict(forward=forward, max_dim=cfg.max_krylov,
                      conserve=cfg.conserve_norm)
            want = CS.site_step_fused_plain(*args, **kw)
            own = site_route(psi, W, forward)
            where = (f"site_step site {p} "
                     f"{'forward' if forward else 'backward'}")
            # (route, C): its own, and at the bulk forward the one-block
            # route and the other cluster size where it fits
            variants = [(own, CS.CLUSTER)]
            if p == BULK_SITE and forward:
                l, d, r = psi.shape
                variants += [("block", CS.CLUSTER)]
                variants += [("cluster", c) for c in (8, 16)
                             if c != CS.CLUSTER and CS.smem_bytes(
                                 W.shape[-1], l * d, r, "cluster", c)
                             <= CS.MAX_SMEM]
            times = {}
            for way, size in variants:
                way_kw = dict(way=way, cluster=size)
                tag = way + (f" C={size}" if way == "cluster" else "")
                errs, line = check_site_once(f"{where} [{tag}]", args, kw,
                                             want, way_kw)
                if len(variants) > 1:
                    times[tag] = cuda_ms(lambda: CS.site_step_fused(
                        *args, **kw, **way_kw), 20)
                    line += f"; kernel {times[tag]:.4f} ms"
                log(f"{line}; psi {tuple(psi.shape)} W {tuple(W.shape)}")
                if (way, size) == variants[0]:
                    worst = max(worst, *errs)  # unweighted, as reported
                    st = want[4].tolist()
            if len(variants) > 1:
                ms = times[next(iter(times))]
                plain_ms = cuda_ms(lambda: CS.site_step_fused_plain(*args, **kw), 3)
                sep = dict(cfg=cfg.replace(fused_site=False), forward=True,
                           last=False)
                sep_ms = cuda_ms(lambda: _site_step(
                    psi, nxt, L, W, R, -0.5j * dt_au, lL, lR, **sep), 20)
                l, d, r = psi.shape
                flops = site_flops(st, W.shape[-1], l * d, r, nxt[0].numel())
                results["site_step"] = {
                    "ms": ms, "plain_ms": plain_ms, "library_ms": None,
                    "route": own, "cluster": CS.CLUSTER,
                    "times_by_route": times,
                    "separate_kernels_ms": sep_ms,
                    **bound(flops, PEAK_FP32, nbytes(psi, nxt, L, W, R,
                                                     *want[:4]))}
                log(f"{where}: route {own}; plain {plain_ms:.4f} ms, "
                    f"separate kernels {sep_ms:.4f} ms, bound "
                    f"{results['site_step']['bound_ms']:.4f} ms; "
                    + ", ".join(f"{k} {t:.4f} ms" for k, t in times.items()))
    return worst


def site_routes(engine) -> dict:
    """Fused-site launches of one step by route: each half-sweep's
    non-last sites that ``cuda_site.site_fits`` takes, through the route
    of their forward-form shape."""
    from pytdscf_torch.mps import cuda_site as CS

    per = dict.fromkeys(CS.ROUTES, 0)
    cores, n = engine.cores[0], engine.nsite
    for p in range(n):
        for forward, q in ((True, p + 1), (False, p - 1)):
            if not 0 <= q < n:
                continue
            if CS.site_fits(cores[p].shape, engine.W[p].shape,
                            cores[q].shape, engine.config.max_krylov):
                per[site_route(cores[p], engine.W[p], forward)] += 1
    return per


def chain_model():
    """The chain as a user builds it for ``Simulator``: the Hartree
    product with the exciton level 1 occupied, bond dimension D."""
    from pytdscf_torch import Model
    from pytdscf_torch.models.holstein import singlet_fission_chain

    basis, ham = singlet_fission_chain()
    model = Model(basis, ham, bond_dim=BOND)
    vecs = []
    for i, b in enumerate(basis):
        v = np.zeros(b.nprim, dtype=complex)
        v[1 if i == EXCITON_SITE else 0] = 1.0
        vecs.append(v)
    model.init_HartreeProduct = [vecs]
    return model


def dat_rows(path: str) -> tuple[list, np.ndarray]:
    """The rows of a Simulator ``.dat`` file, as lines and as numbers (a
    complex column as its real and imaginary parts)."""
    with open(path) as fh:
        lines = [ln for ln in fh if not ln.startswith("#")]
    return lines, np.asarray(
        [[x for tok in ln.split() for c in [complex(tok)]
          for x in ((c.real, c.imag) if "j" in tok else (c.real,))]
         for ln in lines])


def run_simulator(model, stride, fused: bool, steps: int):
    """``Simulator.propagate`` of the chain over ``steps`` steps of 0.2
    fs (thresh_sil 1e-6) at ``fetch_stride=stride`` (None: the default),
    with the fused site kernel on or off, counted from zero: its outputs,
    launches, and ``.dat`` rows as lines and as numbers."""
    import torch

    from pytdscf_torch import Simulator
    from pytdscf_torch.mps import cuda_lanczos as CL
    from pytdscf_torch.mps import cuda_qr as CQ
    from pytdscf_torch.mps import cuda_site as CS

    cwd, switch = os.getcwd(), os.environ.get("PYTDSCF_PALLAS_WHOLESITE")
    os.environ["PYTDSCF_PALLAS_WHOLESITE"] = "1" if fused else "0"
    try:
        with tempfile.TemporaryDirectory() as tmp:
            os.chdir(tmp)
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sim = Simulator("chip_sf", model)
            energy, wf = sim.propagate(stepsize=DT_FS, maxstep=steps,
                                       thresh_sil=1.0e-06,
                                       fetch_stride=stride)
            torch.cuda.synchronize()
            run = SimpleNamespace(
                sim=sim, energy=energy, wf=wf, engine=wf.engine, steps=steps,
                wall=time.perf_counter() - t0,
                n_site=CS.site_step_fused.launches,
                n_lz=CL.lanczos_expm.launches, n_qr=CQ.mgs_qr.launches,
                plain=plain_calls(),
                qr_by=dict(CQ.mgs_qr.route_launches),
                site_by=dict(CS.site_step_fused.route_launches),
                lz_by=dict(CL.lanczos_expm.route_launches),
                lz_sizes=dict(CL.lanczos_expm.cluster_launches),
                launches=counted_launches(), rows={}, values={})
            for name in ("autocorr", "populations"):
                run.rows[name], run.values[name] = dat_rows(
                    os.path.join("chip_sf_prop", f"{name}.dat"))
    finally:
        os.chdir(cwd)
        if switch is None:
            os.environ.pop("PYTDSCF_PALLAS_WHOLESITE")
        else:
            os.environ["PYTDSCF_PALLAS_WHOLESITE"] = switch
    return run


def check_simulator(tag: str, run, chain_k: float, stride: int) -> tuple:
    """The gates of a Simulator run of the chain, whichever its stride and
    site route: energy and norm, a row per step, the launches of every
    step by route, no plain call, the Krylov calls and their mean dimension
    within ``KRYLOV_TOL`` of ``chain_k`` (another run's over the same
    steps).  Every run holds the complex64 energies it reports (the last
    pre-step row and the end state's ``expectation``) to the literal within
    ``E_TOL``, and the longer runs the end state's ``energy64`` too.
    Returns (mean Krylov dimension, loop s/step)."""
    import torch

    engine, steps = run.engine, run.steps
    avg_k, calls, capped, _ = engine.krylov_stats()
    e_end, norm = run.wf.expectation(), run.wf.norm()
    e64 = energy64(engine)
    if stride > 1:
        save_state("simulator_stride16_" + ("fused" if engine.config.fused_site
                                            else "separate"),
                   engine, e_end.real, e64, steps)
    diag = run.sim.diagnostics
    sweep_s = diag.elapsed.get("sweep", 0.0) / steps
    props_s = diag.elapsed.get("props", 0.0) / steps
    log(f"{tag}: {steps} steps in {run.wall:.3f} s (set-up included); "
        f"per step: sweep {sweep_s:.4f} s, properties {props_s:.4f} s, loop "
        f"{sweep_s + props_s:.4f} s; energy {run.energy:.10f} (last "
        f"pre-step), {e_end:.10f} (end; |Δ| {abs(e_end - E_REF):.2e}), "
        f"{e64:.10f} (end, in complex128; |Δ| {abs(e64 - E_REF):.2e}); norm "
        f"{norm:.8f}; avg Krylov {avg_k:.3f} over {calls} calls (against "
        f"{chain_k:.3f}), cap hits {capped}; graph_steps "
        f"{engine.graph_steps}, eager_steps {engine.eager_steps}; launches: "
        f"site_step {run.n_site}, lanczos {run.n_lz}, qr {run.n_qr}; rows: "
        f"autocorr {len(run.rows['autocorr'])}, populations "
        f"{len(run.rows['populations'])}")
    log(f"{tag}: last rows: autocorr {run.rows['autocorr'][-1].strip()!r}, "
        f"populations {run.rows['populations'][-1].strip()!r}")
    log(f"{tag}: launches by route: site_step {run.site_by}, lanczos "
        f"{run.lz_by} (clusters by size {run.lz_sizes}), qr {run.qr_by}")
    require(all(bool(torch.isfinite(c).all()) for c in engine.cores[0]),
            f"{tag}: cores not finite")
    gates = [(run.energy, E_TOL), (e_end, E_TOL)] if steps == SIM_STEPS \
        else [(e64, E_TOL), (run.energy, E_TOL), (e_end, E_TOL)]
    for e, tol in gates:
        require(abs(e - E_REF) <= tol, f"{tag}: energy {e:.10f} vs "
                f"{E_REF} (tol {tol})")
    require(math.isfinite(run.energy), f"{tag}: energy {run.energy}")
    require(abs(norm - 1.0) <= NORM_TOL, f"{tag}: norm {norm:.8f}")
    require(all(len(v) == steps for v in run.rows.values()),
            f"{tag}: .dat rows {[len(v) for v in run.rows.values()]}")
    require(run.plain == 0, f"{tag}: {run.plain} plain-version calls on "
            "the card")
    require(calls == steps * 2 * (2 * engine.nsite - 1),
            f"{tag}: {calls} Krylov calls")
    require(abs(avg_k - chain_k) <= KRYLOV_TOL,
            f"{tag}: mean Krylov {avg_k:.3f} vs {chain_k:.3f}")
    if engine.config.fused_site:
        want_site = {k: steps * n for k, n in site_routes(engine).items()}
        per_step = {"site_step": 2 * 180, "lanczos_expm": 14, "mgs_qr": 6}
        require(run.site_by == want_site and want_site["cluster"] > 0,
                f"{tag}: site_step launches by route {run.site_by} != "
                f"{want_site}")
    else:
        per, sizes = lanczos_routes(engine)
        want = {k: steps * n for k, n in per.items()}
        want_sizes = {k: steps * n for k, n in sizes.items()}
        per_step = {"site_step": 0, "lanczos_expm": 2 * (2 * engine.nsite - 1),
                    "mgs_qr": 2 * (engine.nsite - 1)}
        require(run.lz_by == want and run.lz_sizes == want_sizes,
                f"{tag}: lanczos launches by route {run.lz_by}, by size "
                f"{run.lz_sizes} != {want}, {want_sizes}")
    for name, n in (("site_step", run.n_site), ("lanczos_expm", run.n_lz),
                    ("mgs_qr", run.n_qr)):
        require(n == steps * per_step[name],
                f"{tag}: {name} launches {n} != {steps} × {per_step[name]}")
    require(run.qr_by["block"] == run.n_qr,
            f"{tag}: qr launches by route {run.qr_by}")
    if stride > 1:
        # one block of steps − 1: a host step and replays; the last step,
        # a block of one, runs inline
        want = (steps - 2, 2)
        require((engine.graph_steps, engine.eager_steps) == want,
                f"{tag}: graph_steps {engine.graph_steps}, eager_steps "
                f"{engine.eager_steps} != {want}")
    return avg_k, sweep_s + props_s


def rows_gap(run, ref) -> float:
    """The largest difference between two runs' ``.dat`` values."""
    return max(float(np.max(np.abs(run.values[k] - ref.values[k])))
               for k in ("autocorr", "populations"))


def phase_simulator(times, chain_k: float, chain_engine) -> dict:
    """The 184-site chain through ``Simulator.propagate`` with the fused
    site kernel on, at ``fetch_stride=1``: every step host-driven, its
    properties read after each, as phase 3's steps; then bare host-driven
    steps of its engine."""
    import torch

    from pytdscf_torch import units
    from pytdscf_torch.mps import cuda_lanczos as CL
    from pytdscf_torch.mps import cuda_qr as CQ
    from pytdscf_torch.mps import cuda_site as CS

    dt_au = DT_FS / units.au_in_fs
    err = check_site(chain_engine, dt_au, times)
    t0 = time.perf_counter()
    model = chain_model()
    log(f"simulator: model of {model.get_ndof()} sites built in "
        f"{time.perf_counter() - t0:.1f} s")
    run = run_simulator(model, 1, fused=True, steps=SIM_STEPS)
    check_simulator("simulator", run, chain_k, 1)

    # ---- the bare fused-site sweep of the same engine
    engine = run.engine
    reset_counts()
    step_s = []
    for _ in range(BARE_STEPS):
        t0 = time.perf_counter()
        engine.propagate(dt_au)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    log(f"simulator engine, bare steps: s/step {[round(x, 4) for x in step_s]}"
        f" (median {float(np.median(step_s)):.4f}); launches: site_step "
        f"{CS.site_step_fused.launches}, lanczos {CL.lanczos_expm.launches}, "
        f"qr {CQ.mgs_qr.launches}")
    require(CS.site_step_fused.launches == BARE_STEPS * 2 * 180,
            "bare steps: site_step launches")
    profile_step(engine, dt_au)
    return {"site_step": (run.n_site, err), "lanczos_expm": (run.n_lz, None),
            "mgs_qr": (run.n_qr, None), "mgs_qr_routes": run.qr_by,
            "site_step_routes": run.site_by,
            "lanczos_expm_routes": run.lz_by}


def phase_simulator_strided(chain_k: float, fused: bool) -> dict:
    """The chain through ``Simulator.propagate`` at its default stride on
    the card (16): one block of 16 steps through
    ``propagate_steps_collect`` (a host step, the capture, 15 replays), one
    packed read of its rows, then one inline step.  Held to a stride-1 run
    of the same model and site route, made here: every ``.dat`` value
    within ``ROW_TOL``.  Then the same run again under the profiler: the
    launches of its host steps and replays as the trace shows them, equal
    to the stride-1 run's.  With the fused site kernel, also bare replayed
    steps of the same engine, timed, and one block traced and counted."""
    import torch

    from pytdscf_torch import units
    from pytdscf_torch.mps import cuda_site as CS

    tag = f"simulator stride 16, {'fused site' if fused else 'separate kernels'}"
    model = chain_model()
    ref = run_simulator(model, 1, fused=fused, steps=STRIDE_STEPS)
    check_simulator(f"{tag}: stride-1 reference", ref, chain_k, 1)
    run = run_simulator(model, None, fused=fused, steps=STRIDE_STEPS)
    require(run.engine.config.fetch_stride == 16,
            f"{tag}: default fetch_stride {run.engine.config.fetch_stride}")
    check_simulator(tag, run, chain_k, 16)
    gap = rows_gap(run, ref)
    log(f"{tag}: .dat values within {gap:.2e} of the stride-1 run (tol "
        f"{ROW_TOL})")
    require(gap <= ROW_TOL, f"{tag}: rows {gap:.2e} from stride 1")
    # ---- the same run under the profiler: its launches as the card ran
    # them (host steps and replays alike), against the stride-1 run's
    # host launches; its counters' replay accounting and its rows the same
    box = []
    busy, seen = profile_run(lambda: box.append(run_simulator(
        model, None, fused=fused, steps=STRIDE_STEPS)), count=True)
    traced = box[-1]  # the run of the trace that was counted
    log(f"{tag}: the run again under the profiler (set-up included) keeps "
        f"the device {100 * busy:.1f} % busy; graph_steps "
        f"{traced.engine.graph_steps}, eager_steps {traced.engine.eager_steps}")
    require(scaled(seen, 1) == ref.launches,
            f"{tag}: traced launches {launch_text(seen)} != the stride-1 "
            f"run's {launch_text(ref.launches)}")
    require(traced.launches == ref.launches,
            f"{tag}: counters of the traced run "
            f"{launch_text(traced.launches)} != the traced launches")
    require(rows_gap(traced, run) <= ROW_TOL,
            f"{tag}: the traced run's rows differ from the run's")
    require((traced.engine.graph_steps, traced.engine.eager_steps)
            == (STRIDE_STEPS - 2, 2), f"{tag}: the traced run's steps")
    path = path_launches(seen)
    del traced, box
    if not fused:
        return path
    # ---- bare replayed fused-site steps of the same engine
    engine, dt_au = run.engine, DT_FS / units.au_in_fs
    engine.propagate_steps(dt_au, 1)  # the program without properties
    reset_counts()
    step_s = []
    for _ in range(2):
        t0 = time.perf_counter()
        engine.propagate_steps(dt_au, GRAPH_BLOCK)
        torch.cuda.synchronize()
        step_s.append((time.perf_counter() - t0) / GRAPH_BLOCK)
    log(f"{tag}, bare replayed steps: s/step per block "
        f"{[round(x, 4) for x in step_s]}; launches: site_step "
        f"{CS.site_step_fused.launches}")
    require(CS.site_step_fused.launches == 2 * GRAPH_BLOCK * 2 * 180,
            f"{tag}: bare replayed steps: site_step launches")
    busy, seen = profile_run(lambda: (
        reset_counts(), engine.propagate_steps(dt_au, GRAPH_BLOCK)),
        count=True)
    log(f"{tag}: a replayed block of {GRAPH_BLOCK} bare steps keeps the "
        f"device {100 * busy:.1f} % busy")
    want = scaled(ref.launches, GRAPH_BLOCK, STRIDE_STEPS)
    require(scaled(seen, 1) == want and counted_launches() == want,
            f"{tag}: {GRAPH_BLOCK} bare replayed steps: traced launches "
            f"{launch_text(seen)}, counted {launch_text(counted_launches())}"
            f" != {launch_text(want)}")
    return path


# ------------------------------------------------- χ=1024 radical pair
def rp_model(chi: int = CHI, nuc: int = RP_NUC):
    """bench_chi.py's radical-pair Liouvillian (its lines 113-127): nuc+nuc
    nuclei, split electron sites, at bond dimension chi: (basis, model,
    first electron site)."""
    from pytdscf_torch.model import Model
    from pytdscf_torch.models.radical_pair import radical_pair_liouvillian

    hfc = [round(0.15 + 0.07 * k, 4) for k in range(nuc)]
    basis, mpo, ele = radical_pair_liouvillian(
        hfcs_1=[(2, a) for a in hfc], hfcs_2=[(2, a) for a in hfc],
        split_electron=True,
    )
    return basis, Model(basis, {"hamiltonian": mpo}, space="liouville",
                        bond_dim=chi), ele


def build_rp_engine(device, preset: str, chi: int = CHI, nuc: int = RP_NUC,
                    krylov: int = RP_KRYLOV):
    """bench_chi.py's defaults (its lines 100-189) on the port, at a
    precision rung ("balanced" or "throughput"): the 8+8-nucleus
    split-electron radical-pair Liouvillian, χ=1024 (or ``chi``, ``nuc``
    and the Krylov buffer ``krylov`` of its χ=2048 anchor), the singlet
    product state plus ε=1e-4 noise from ``default_rng(42)``, Arnoldi with
    relaxed Krylov from iteration 1."""
    from pytdscf_torch.config import Config
    from pytdscf_torch.models.radical_pair import singlet_product_state
    from pytdscf_torch.mps.lattice import (
        alloc_hartree_product,
        bond_dims_for_site,
    )
    from pytdscf_torch.mps.tdvp import TDVPEngine

    basis, model, ele = rp_model(chi, nuc)
    phys = [b.nstate for b in basis]
    vecs = singlet_product_state(basis, ele, split_electron=True)
    cores = alloc_hartree_product(phys, 4, vecs, space="liouville")
    rng = np.random.default_rng(42)
    noisy = []
    for p, c in enumerate(cores):
        m_l, m_r = bond_dims_for_site(phys, p, chi)
        full = np.zeros((m_l, phys[p], m_r), dtype=np.complex128)
        full[: c.shape[0], :, : c.shape[2]] = c
        scale = 1.0e-04 * max(np.abs(c).max(), 1e-30)
        full += scale * (rng.normal(size=full.shape)
                         + 1j * rng.normal(size=full.shape))
        noisy.append(full)
    config = Config(
        space="liouville", integrator="arnoldi", thresh_exp=RP_THRESH,
        max_krylov=krylov, dtype="complex64", conserve_norm=False,
    ).with_precision_preset(preset)
    return TDVPEngine([noisy], model.hamiltonian, config, device), ele


def mgs_moves(engine) -> list[tuple[int, str, tuple[int, int]]]:
    """Gauge moves of one step that take the MGS kernel, as (site, "QR" or
    "LQ", operand shape); the others are CholeskyQR³ (r >=
    CHOLESKY_QR_MIN_R and N >= r)."""
    from pytdscf_torch.mps.kernels import CHOLESKY_QR_MIN_R

    moves = []
    for p in range(engine.nsite):
        l, d, r = engine.cores[0][p].shape
        if p < engine.nsite - 1:
            moves.append((p, "QR", (l * d, r)))  # forward half-sweep
        if p > 0:
            moves.append((p, "LQ", (r * d, l)))  # backward half-sweep
    return [(p, kind, (n, k)) for p, kind, (n, k) in moves
            if not (k >= CHOLESKY_QR_MIN_R and n >= k)]


def check_qr_gauge(engine, results) -> float:
    """The MGS kernel against its plain version on the radical pair's own
    gauge operands after ``right_canonicalize``, at every shape the kernel
    takes on this chain: the backward half-sweep's LQ operand (r·d, l) of
    the first site of each shape (a right-orthogonal core: orthonormal
    columns), and the forward QR operand (l·d, r) of a right-orthogonal
    site at the largest shape, (1024, 64), which takes the cluster route
    (timed: a second case of the ``mgs_qr`` entry)."""
    moves = mgs_moves(engine)
    big = max((shape for _, _, shape in moves), key=lambda s: s[0] * s[1])
    picks: dict[tuple[str, tuple[int, int]], int] = {}
    for p, kind, shape in moves:
        if kind == "LQ" or (p > 0 and shape == big):
            picks.setdefault((kind, shape), p)
    worst = 0.0
    for (kind, shape), p in sorted(picks.items(), key=lambda kv: kv[0][1]):
        psi = engine.cores[0][p]
        l, d, r = psi.shape
        m = (psi.reshape(l * d, r) if kind == "QR"
             else psi.permute(2, 1, 0).reshape(r * d, l)).contiguous()
        timed = shape == big and kind == "QR"
        err, _, times = check_mgs(f"{kind} operand of site {p}", m, timed)
        if timed and not any(c["shape"] == times["shape"]
                             for c in results["mgs_qr"]["cases"]):
            results["mgs_qr"]["cases"].append(times)
        worst = max(worst, err)
    return worst


def check_matvec(engine, results) -> dict:
    """Each relaxed matvec kernel against its plain version on the card,
    on the chain's own operands: the bulk site (timed) and two edge sites
    (ragged tiles)."""
    import torch

    from pytdscf_torch.mps import cuda_matvec as CM
    from pytdscf_torch.mps import kernels as K

    left = engine.build_left_env_stack()
    right = engine.build_right_env_stack()
    cases = []
    for p in (RP_BULK_SITE, 3, 0):
        (L, _), (R, _), W = left[p], right[engine.nsite - 1 - p], engine.W[p]
        L1 = left[p + 1][0]
        psi = engine.cores[0][p].contiguous()
        _, sig = K.qr_right(psi)
        sig = sig.contiguous()
        (l, d, r), wl, wr = psi.shape, W.shape[0], W.shape[3]
        # at the bulk: one complex64 torch.einsum of the same chain (the
        # library-call yardstick, never called by the port) and its FLOPs
        lib_h = lib_k = None
        if p == RP_BULK_SITE:
            transfer_err = check_renorm_lo(engine, L, R, p)
            # (operands bound now: the loop rebinds the names)
            lib_h = (lambda psi=psi, R=R, W=W, L=L: torch.einsum(
                         "kjr,xcr,aijc,bak->bix", psi, R, W, L),
                     chain_flops(l, l, r, r, d, d, wl, wr))
            lib_k = (lambda sig=sig, R=R, L1=L1: torch.einsum(
                         "kr,xar,bak->bx", sig, R, L1),
                     chain_flops(r, r, r, r, 1, 1, wr, wr, has_w=False))
        cases.append(("heff_lo", p, CM.heff_operands(L, W, R), psi, lib_h))
        cases.append(("keff_lo", p, CM.keff_operands(L1, R), sig, lib_k))
    del left, right
    worst: dict[str, float] = {}
    for name, p, ops, v, timed in cases:
        kernel = getattr(CM, name)
        plain = K.heff_apply_lo if name == "heff_lo" else K.keff_apply_lo
        planes = CM.plain_planes(ops)
        got = kernel(ops, v)
        again = kernel(ops, v)
        want = plain(*planes, v)
        torch.cuda.synchronize()
        require(bool(torch.isfinite(got).all()), f"{name} site {p}: not finite")
        require(torch.equal(got, again), f"{name} site {p}: a second launch "
                "gave another result")
        rel = float(torch.linalg.vector_norm(got - want)
                    / torch.linalg.vector_norm(want))
        err = float(torch.max(torch.abs(got - want)))
        require(rel < MATVEC_TOL, f"{name} site {p}: rel {rel:.3e} vs plain")
        line = (f"{name} site {p}: v {tuple(v.shape)} out {tuple(got.shape)} "
                f"rel {rel:.3e} max|Δ| {err:.3e}")
        if timed is not None:
            # the bar catches one bf16 rounding more: the plain output
            # rounded to bf16 must fail it
            coarse = torch.complex(want.real.to(torch.bfloat16).float(),
                                   want.imag.to(torch.bfloat16).float())
            rel_coarse = float(torch.linalg.vector_norm(coarse - want)
                               / torch.linalg.vector_norm(want))
            require(rel_coarse > MATVEC_TOL, f"{name}: the bf16-rounded "
                    f"output reads {rel_coarse:.3e}, inside the bar")
            line += f" (bf16-rounded output: rel {rel_coarse:.3e})"
            ms = cuda_ms(lambda: kernel(ops, v), 20)
            plain_ms = cuda_ms(lambda: plain(*planes, v), 5)
            lib, flops = timed
            lib_ms = cuda_ms(lib, 5)
            moved = nbytes(v, *(t for pair in planes for t in pair), got)
            results[name] = {"ms": ms, "plain_ms": plain_ms,
                             "library_ms": lib_ms,
                             **bound(flops, PEAK_BF16, moved)}
            line += (f" kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                     f"torch.einsum {lib_ms:.4f} ms, bound "
                     f"{results[name]['bound_ms']:.4f} ms")
        log(line)
        worst[name] = max(worst.get(name, 0.0), err)
    worst["heff_lo"] = max(worst["heff_lo"], check_heff_wide(),
                           transfer_err)
    return worst


def check_renorm_lo(engine, L, R, p: int) -> float:
    """The one-pass environment transfer (``env_precision="default"``:
    ``chain_tc.cu``'s one-pass chain in its din ≠ dout mode) against its
    plain version on the card, both ways through site
    ``p`` with its own blocks ``L`` and ``R``: the largest error."""
    import torch

    from pytdscf_torch.mps import cuda_renorm as CR
    from pytdscf_torch.mps import kernels as K

    core, W = engine.cores[0][p].contiguous(), engine.W[p]
    worst = 0.0
    for way, kernel, plain, blk in (
            ("left", CR.renorm_left_lo, K.renorm_block_left_lo, L),
            ("right", CR.renorm_right_lo, K.renorm_block_right_lo, R)):
        got = kernel(blk, core, W, core)
        again = kernel(blk, core, W, core)
        want = plain(blk, core, W, core)
        where = f"renorm_lo {way} site {p}"
        torch.cuda.synchronize()
        require(bool(torch.isfinite(got).all()), f"{where}: not finite")
        require(torch.equal(got, again), f"{where}: a second launch gave "
                "another result")
        rel = float(torch.linalg.vector_norm(got - want)
                    / torch.linalg.vector_norm(want))
        err = float(torch.max(torch.abs(got - want)))
        require(rel < MATVEC_TOL, f"{where}: rel {rel:.3e} vs plain")
        log(f"{where}: block {tuple(blk.shape)} → {tuple(got.shape)} (MPO "
            f"{W.shape[0]} → {W.shape[3]}) rel {rel:.3e} max|Δ| {err:.3e}")
        worst = max(worst, err)
    return worst


def seeded(seed: int):
    """complex64 tensors on the card from numpy's default_rng(seed), each
    of unit norm as the engine keeps its blocks (so that the absolute
    errors compare with those on the chain's operands)."""
    import torch

    rng = np.random.default_rng(seed)

    def cx(*shape):
        a = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
        return torch.as_tensor(a / np.linalg.norm(a), dtype=torch.complex64,
                               device="cuda")

    return cx


def check_heff_wide() -> float:
    """heff_lo against its plain version at the χ=1024 bulk with d = 9 and
    d = 16 (w = 8) on seeded random operands (relative error under
    MATVEC_TOL_RANDOM, which the bf16-rounded plain output must fail; a
    second launch bit-identical), then one call at the χ=2048 bulk (d = 4,
    w = 8): its time, and the device memory it allocates, under
    CHI2048_PEAK_BYTES.  Returns the largest max |Δ| of the d = 9, 16
    checks."""
    import torch

    from pytdscf_torch.mps import cuda_matvec as CM
    from pytdscf_torch.mps import kernels as K

    worst = 0.0
    for d in WIDE_D:
        cx = seeded(100 + d)
        n, w = CHI, 8
        ops = CM.heff_operands(cx(n, w, n), cx(w, d, d, w), cx(n, w, n))
        psi = cx(n, d, n)
        got, again = CM.heff_lo(ops, psi), CM.heff_lo(ops, psi)
        want = K.heff_apply_lo(*CM.plain_planes(ops), psi)
        torch.cuda.synchronize()
        norm = torch.linalg.vector_norm(want)
        rel = float(torch.linalg.vector_norm(got - want) / norm)
        coarse = torch.complex(want.real.to(torch.bfloat16).float(),
                               want.imag.to(torch.bfloat16).float())
        rel_coarse = float(torch.linalg.vector_norm(coarse - want) / norm)
        err = float(torch.max(torch.abs(got - want)))
        require(bool(torch.isfinite(got).all()), f"heff_lo d={d}: not finite")
        require(torch.equal(got, again), f"heff_lo d={d}: a second launch "
                "gave another result")
        require(rel < MATVEC_TOL_RANDOM < rel_coarse,
                f"heff_lo d={d}: rel {rel:.3e} (bf16-rounded output "
                f"{rel_coarse:.3e}) vs the bar {MATVEC_TOL_RANDOM}")
        log(f"heff_lo d={d} w={w} χ={n} (random): rel {rel:.3e} max|Δ| "
            f"{err:.3e} (bf16-rounded output: rel {rel_coarse:.3e}); repeat "
            "bit-identical")
        worst = max(worst, err)
        del ops, psi, got, again, want, coarse
    torch.cuda.empty_cache()

    cx = seeded(2048)
    n, d, w = 2 * CHI, 4, 8
    ops = CM.heff_operands(cx(n, w, n), cx(w, d, d, w), cx(n, w, n))
    psi = cx(n, d, n)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = CM.heff_lo(ops, psi)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    finite = bool(torch.isfinite(out).all())
    del out
    ms = cuda_ms(lambda: CM.heff_lo(ops, psi), 5)
    log(f"heff_lo χ={n} d={d} w={w}: kernel {ms:.4f} ms, allocates "
        f"{peak / 1e9:.3f} GB at its peak (bar {CHI2048_PEAK_BYTES / 1e9:g} "
        "GB)")
    require(finite, "heff_lo χ=2048: not finite")
    require(peak < CHI2048_PEAK_BYTES,
            f"heff_lo χ=2048 allocates {peak / 1e9:.3f} GB")
    del ops, psi
    torch.cuda.empty_cache()
    return worst


def check_chain3(engine, results) -> dict:
    """The bf16x3 chain kernel against its plain version on the card, on
    the chain's own operands after ``right_canonicalize``, through each of
    its four mappings: the environment transfer left and right, the H_eff
    and K_eff matvec, at the bulk site (the first two timed, beside one
    complex64 ``torch.einsum`` of the same chain) and two edge sites
    (ragged tiles, MPO widths 1 and 7)."""
    import torch

    from pytdscf_torch.mps import cuda_matvec as CM
    from pytdscf_torch.mps import cuda_renorm as CR
    from pytdscf_torch.mps import kernels as K

    def heff_plain(ops, v, passes=3):
        return K.chain3_plain(K.hilo(v), *CR.plain_hilo(ops), passes=passes)

    def keff_plain(ops, v, passes=3):
        return K.chain3_plain(K.hilo(v.unsqueeze(1)), *CR.plain_hilo(ops),
                              passes=passes)[:, 0, :]

    left = engine.build_left_env_stack()
    right = engine.build_right_env_stack()
    cases = []
    for p in (RP_BULK_SITE, 3, 0):
        (L, _), (R, _), W = left[p], right[engine.nsite - 1 - p], engine.W[p]
        psi = engine.cores[0][p].contiguous()
        a, sig = K.qr_right(psi)
        sig = sig.contiguous()
        hops = CR.heff_operands(L, W, R)
        kops = CR.keff_operands(left[p + 1][0], R)
        (l, d, r), wl, wr = psi.shape, W.shape[0], W.shape[3]
        timing = {  # library call, bf16x3 FLOPs, complex64 bytes moved
            "renorm_hi": (
                lambda L=L, a=a, W=W: torch.einsum(
                    "bak,bio,aijc,kjp->ocp", L, a.conj(), W, a),
                3 * chain_flops(r, l, r, l, wl, wr, d, d),
                nbytes(L, a, W, a) + 8 * r * wr * r),
            "matvec_hi": (
                lambda L=L, W=W, R=R, psi=psi: torch.einsum(
                    "kjr,xcr,aijc,bak->bix", psi, R, W, L),
                3 * chain_flops(l, l, r, r, d, d, wl, wr),
                nbytes(psi, L, W, R, psi)),
        } if p == RP_BULK_SITE else {}
        # (counter, label, wrapper, plain, args, operands whose lo planes
        # must be nonzero (W can be exact in bf16: left out), timing)
        cases += [
            ("renorm_hi", f"left, site {p}", CR.renorm_left_hi,
             K.renorm_block_left_hi, (L, a, W, a), (L, a),
             timing.get("renorm_hi")),
            ("renorm_hi", f"right, site {p}", CR.renorm_right_hi,
             K.renorm_block_right_hi, (R, psi, W, psi), (R, psi), None),
            ("matvec_hi", f"H_eff, site {p}", CR.heff_hi, heff_plain,
             (hops, psi), (psi, L, R), timing.get("matvec_hi")),
            ("matvec_hi", f"K_eff, bond {p}", CR.keff_hi, keff_plain,
             (kops, sig), (sig, left[p + 1][0], R), None),
        ]
    del left, right
    # sites the earlier kernel refused: d = 9 and 16 at the bulk, w = 8
    for d in WIDE_D:
        cx = seeded(200 + d)
        n, w = CHI, 8
        blk, A, Wd = cx(n, w, n), cx(n, d, n), cx(w, d, d, w)
        psi_d = cx(n, d, n)
        cases += [
            ("renorm_hi", f"left, d={d} (random)", CR.renorm_left_hi,
             K.renorm_block_left_hi, (blk, A, Wd, A), (blk, A), None),
            ("renorm_hi", f"right, d={d} (random)", CR.renorm_right_hi,
             K.renorm_block_right_hi, (blk, A, Wd, A), (blk, A), None),
            ("matvec_hi", f"H_eff, d={d} (random)", CR.heff_hi, heff_plain,
             (CR.heff_operands(blk, Wd, blk), psi_d), (psi_d, blk), None),
        ]
    worst: dict[str, float] = {}
    for name, label, kernel, plain, args, split, timed in cases:
        got = kernel(*args)
        again = kernel(*args)
        want = plain(*args)
        one_pass = plain(*args, passes=1)
        torch.cuda.synchronize()
        where = f"{name} {label}"
        require(bool(torch.isfinite(got).all()), f"{where}: not finite")
        require(torch.equal(got, again),
                f"{where}: a second launch gave another result")
        norm = torch.linalg.vector_norm(want)
        rel = float(torch.linalg.vector_norm(got - want) / norm)
        rel_one = float(torch.linalg.vector_norm(one_pass - want) / norm)
        err = float(torch.max(torch.abs(got - want)))
        require(rel < CHAIN_TOL, f"{where}: rel {rel:.3e} vs plain")
        require(rel_one > CHAIN_TOL, f"{where}: the one-pass plain version "
                f"reads {rel_one:.3e}, inside the bar")
        # the wrapper's split of each operand (the trivial (1, 1, 1) edge
        # block is exactly 1: no lo part)
        require(all(bool(CM.bf16_planes(t, passes=3)[2:].any())
                    for t in split if t.numel() > 1),
                f"{where}: an operand's lo planes are all zero")
        line = (f"{where}: out {tuple(got.shape)} rel {rel:.3e} max|Δ| "
                f"{err:.3e} (one pass: rel {rel_one:.3e}); lo planes nonzero")
        if timed is not None:
            lib, flops, moved = timed
            times = {"ms": cuda_ms(lambda: kernel(*args), 10),
                     "plain_ms": cuda_ms(lambda: plain(*args), 3),
                     "library_ms": cuda_ms(lib, 3),
                     **bound(flops, PEAK_BF16, moved)}
            results[name] = times
            line += (f"; kernel {times['ms']:.4f} ms, plain "
                     f"{times['plain_ms']:.4f} ms, torch.einsum "
                     f"{times['library_ms']:.4f} ms, bound "
                     f"{times['bound_ms']:.4f} ms")
        log(line)
        worst[name] = max(worst.get(name, 0.0), err)
    return worst


def record_ctl(run) -> list:
    """``run()`` with every Krylov control step's inputs recorded: (T, G,
    the previous coefficients, keywords), cloned on the card before the
    step wrote its outputs."""
    from pytdscf_torch.mps import cuda_krylov as CK
    from pytdscf_torch.mps import integrator

    recs = []

    def recorded(T, G, c, flags, status, **kw):
        recs.append((T.clone(), None if G is None else G.clone(), c.clone(),
                     {k: v for k, v in kw.items() if k != "handles"}))
        return CK.krylov_ctl(T, G, c, flags, status, **kw)

    # the program reaches the control step through its module reference:
    # give it one whose krylov_ctl records first
    integrator.CK = SimpleNamespace(active=CK.active, krylov_ctl=recorded)
    try:
        run()
    finally:
        integrator.CK = CK
    return recs


def check_krylov_ctl(recs, results, tag: str,
                     gap_edge: bool = False) -> float:
    """The Krylov control kernel against its plain version on a radical-pair
    step's own reduced matrices (every control step of the step): the new
    coefficients within ``CTL_TOL`` of the plain ones (relative to the
    largest), the flags and status equal (but where the plain error lies
    within ``CTL_EDGE`` of the threshold, or, with ``gap_edge``, within the
    distance between the kernel's and the plain coefficients, in the same
    norm: a test whose threshold sits at the float32 rounding of the
    error, as model B's 1e-7 does, is decided by that rounding in either
    version).  With ``gap_edge`` the kernel's flags and status must also
    be the decision that its own error calls for (:func:`ctl_decision` of
    ‖c_kernel − c_prev‖ in complex128, the norm it tests), wherever that
    error lies outside ``CTL_EDGE`` of the threshold: the stop decision is
    held at every step, the band's too.  At the largest dimension of the
    step, the kernel's and the plain version's times.  Returns the largest
    error."""
    import torch

    from pytdscf_torch.mps import cuda_krylov as CK

    worst, edges, own = 0.0, 0, 0
    for T, G, c0, kw in recs:
        out = {}
        for dev in ("cuda", "cpu"):
            c = c0.clone().to(dev)
            kmax = c.shape[0]
            flags = torch.zeros(kmax + 1, dtype=torch.bool, device=dev)
            status = torch.zeros(3, dtype=torch.int32, device=dev)
            fn = CK.krylov_ctl if dev == "cuda" else CK.krylov_ctl_plain
            fn(T.to(dev), None if G is None else G.to(dev), c, flags, status,
               **kw)
            out[dev] = (c.cpu(), flags.cpu(), status.cpu())
        (ck, fk, sk), (cp, fp, sp) = out["cuda"], out["cpu"]
        err = float(torch.max(torch.abs(ck - cp))) / max(
            1.0, float(torch.max(torch.abs(cp))))
        worst = max(worst, err)
        m = kw["k"] + 1

        def norm(x):
            x = x.to(torch.complex128)
            if G is None:
                return float(torch.linalg.vector_norm(x))
            g = G.cpu().to(torch.complex128)[:m, :m]
            return math.sqrt(max(float((x[:m].conj() @ (g @ x[:m])).real),
                                 0.0))

        e = norm(cp - c0.cpu())
        band = CTL_EDGE * kw["thresh"] + (norm(ck - cp) if gap_edge else 0.0)
        edge = kw["k"] > 0 and abs(e - kw["thresh"]) <= band
        edges += edge
        require(edge or (torch.equal(fk, fp) and torch.equal(sk, sp)),
                f"{tag}: krylov_ctl at k={kw['k']}: flags {fk.tolist()} "
                f"status {sk.tolist()} != plain {fp.tolist()} {sp.tolist()}")
        e_k = norm(ck - c0.cpu())
        if gap_edge and abs(e_k - kw["thresh"]) > CTL_EDGE * kw["thresh"]:
            fw, sw = ctl_decision(e_k, T, kw, c0.shape[0])
            own += 1
            require(torch.equal(fk, fw) and torch.equal(sk, sw),
                    f"{tag}: krylov_ctl at k={kw['k']}: flags {fk.tolist()} "
                    f"status {sk.tolist()}, but its own error {e_k:.6e} "
                    f"(threshold {kw['thresh']}) calls for {fw.tolist()} "
                    f"{sw.tolist()}")
    require(worst <= CTL_TOL, f"{tag}: krylov_ctl coefficients {worst:.2e} "
            f"from plain (tol {CTL_TOL})")
    T, G, c0, kw = max(recs, key=lambda r: r[3]["k"])
    m, kmax = kw["k"] + 1, c0.shape[0]
    dev = T.device
    flags = torch.zeros(kmax + 1, dtype=torch.bool, device=dev)
    status = torch.zeros(3, dtype=torch.int32, device=dev)
    c = c0.clone()

    def call(fn):
        return lambda: fn(T, G, c, flags, status, **kw)

    # the kernel's device time as the step graph runs it: its launches
    # in one graph, counted on a device int of their own (not the step
    # program's, which its settle reads)
    saved = CK.krylov_ctl.replayed.get(dev.index)
    CK.krylov_ctl.replayed[dev.index] = torch.zeros(1, dtype=torch.int32,
                                                    device=dev)
    try:
        ms = graph_ms(call(CK.krylov_ctl))
    finally:
        if saved is None:
            del CK.krylov_ctl.replayed[dev.index]
        else:
            CK.krylov_ctl.replayed[dev.index] = saved
    floor_ms = graph_ms(lambda: torch.cuda._sleep(0))
    plain_ms = cuda_ms(lambda: CK.krylov_ctl_plain(
        T, G, c0.clone(), flags, status, **kw), 10)
    # the work: 12 + s dense m×m complex products, 8 flops a multiply-add
    A = complex(kw["scale"]) * T[:m, :m]
    lib_ms = cuda_ms(lambda: torch.linalg.matrix_exp(A)[:, 0], 20)
    norm1 = float(torch.max(torch.sum(torch.abs(
        A.cpu().to(torch.complex128)), dim=0)))
    sq = int(min(max(math.ceil(math.log2(max(norm1, 1e-30))) + 3, 0), 64))
    flops = 8.0 * (12 + sq) * m ** 3
    io = nbytes(T, c0) + c0.numel() * c0.element_size() + kmax + 1 + 12 + (
        0 if G is None else nbytes(G))
    log(f"{tag}: krylov_ctl on the step's {len(recs)} control steps: max "
        f"|Δc| {worst:.2e} (tol {CTL_TOL}), flags and status equal "
        f"({edges} at the threshold's edge)"
        + (f", {own} the decision of the kernel's own error" if gap_edge
           else "") + f"; at k_used={m} ({sq} squarings) {ms:.5f} ms a "
        f"launch replayed in a graph (an empty kernel {floor_ms:.5f}), "
        f"plain {plain_ms:.4f} ms, torch.linalg.matrix_exp {lib_ms:.4f} ms")
    if "krylov_ctl" not in results:
        results["krylov_ctl"] = {"ms": ms, "plain_ms": plain_ms,
                                 **bound(flops, PEAK_FP32, io),
                                 "library_ms": lib_ms, "floor_ms": floor_ms,
                                 "k_used": m,
                                 "path": "warp" if m <= CK.WARP_M else "block"}
    return worst


def ctl_decision(err: float, T, kw: dict, kmax: int) -> tuple:
    """The flags and status that a Krylov control step at iteration
    ``kw["k"]`` writes (into zeroed flags) for the error ``err`` of its
    coefficients: ``krylov_ctl_plain``'s decision, on the host."""
    import torch

    from pytdscf_torch.mps import cuda_krylov as CK

    k, m = kw["k"], kw["k"] + 1
    conv = k > 0 and err < kw["thresh"]
    breakdown = float(T[k + 1, k].real) < CK.EPS
    capped = m >= kmax
    done = conv or breakdown or capped
    flags = torch.zeros(kmax + 1, dtype=torch.bool)
    flags[0], flags[1 + k] = not done, done
    relax = kw["relax_after"]
    status = torch.tensor(
        [m, int(capped and not conv and not breakdown and not kw["exact"]),
         0 if relax is None else max(m - relax, 0)], dtype=torch.int32)
    return flags, status


def rp_launches() -> dict:
    """The radical pair's kernel counters, by kernel."""
    return {name: c.launches for name, c in counters().items()}


def host_snapshot(engine):
    """A function that puts a host-driven engine back to its state now,
    with its Krylov telemetry and every counter at zero: a traced window
    that runs again runs the same steps."""
    cores = [c.clone() for c in engine.cores[0]]
    env = [(b.clone(), g.clone()) for b, g in engine.env_stack]
    side = engine._env_side

    def restore():
        engine.cores = [[c.clone() for c in cores]]
        engine.env_stack = [(b.clone(), g.clone()) for b, g in env]
        engine._env_side = side
        engine.krylov_stats()
        reset_counts()

    return restore


def program_snapshot(engine, steps: bool = False):
    """:func:`host_snapshot` for an engine whose state is its step
    program's buffers; with ``steps``, its step counts (``graph_steps``,
    ``eager_steps``) go back too, for a traced window that may run again."""
    from pytdscf_torch.mps.step_graph import copy_all

    (prog,) = engine._programs.values()
    saved = [b.clone() for b in prog.buffers]
    counts = engine.graph_steps, engine.eager_steps

    def restore():
        copy_all(prog.buffers, saved)
        prog.install(engine)
        if steps:
            engine.graph_steps, engine.eager_steps = counts
        engine.krylov_stats()
        reset_counts()

    return restore


def rp_gold(engine, ele, key: str, tag: str) -> float:
    """bench_chi.py's invariants and its blessed-population check of the
    ``key`` entry of ``bench_expected.json``: the drift from gold."""
    tr = engine.trace()
    rdm = engine.reduced_density_liouville((0,) * ele + (2, 2))
    pops = np.real(np.einsum("aabb->ab", rdm)).reshape(-1)
    with open(Path(__file__).resolve().parent / "bench_expected.json") as fh:
        gold = json.load(fh)[key]
    drift = float(np.max(np.abs(pops - np.asarray(gold["pops"]))))
    log(f"{tag}: trace {tr.real:.6f}{tr.imag:+.2e}j; populations "
        f"{np.round(pops, 6).tolist()}; drift from gold [{key}] "
        f"{drift:.2e} (tol {gold['tol']:g})")
    require(np.isfinite(tr.real) and bool(np.all(np.isfinite(pops))),
            f"{tag}: non-finite trace/populations: {tr}, {pops}")
    require(0.90 <= tr.real <= 1.0001, f"{tag}: trace {tr.real:.6f} "
            "outside the Haberkorn-decay window [0.90, 1.0001]")
    require(abs(tr.imag) <= 1e-3, f"{tag}: trace imaginary part "
            f"{tr.imag:.2e}")
    require(bool(np.all(pops >= -1e-4)), f"{tag}: negative population "
            f"{pops}")
    require(abs(float(np.sum(pops)) - tr.real) <= 2e-3,
            f"{tag}: Σpops {float(np.sum(pops)):.6f} != trace {tr.real:.6f}")
    require(drift <= float(gold["tol"]),
            f"{tag}: populations drift {drift:.2e} > {gold['tol']} from gold")
    return drift


def rp_launch_gates(engine, tag: str, steps: int, stats, n: dict) -> None:
    """The launch gates of ``steps`` radical-pair steps from their counters
    ``n`` and Krylov statistics ``stats``: every relaxed matvec through a
    kernel (``krylov_stats`` counts them on the device), every Krylov
    iteration through one control step, every MGS gauge move on its
    route's kernel, at "throughput" every in-sweep transfer and each Krylov
    call's exact-prefix matvec through the bf16x3 kernel, no plain call."""
    avg_k, calls, _, relaxed = stats
    moves = mgs_moves(engine)
    require(relaxed > 0, f"{tag}: no relaxed matvec ran")
    require(n["heff_lo"] + n["keff_lo"] == relaxed,
            f"{tag}: heff_lo + keff_lo launches {n['heff_lo']} + "
            f"{n['keff_lo']} != {relaxed} relaxed matvecs")
    require(n["heff_lo"] > 0 and n["keff_lo"] > 0,
            f"{tag}: a matvec kernel was never launched")
    require(n["krylov_ctl"] == round(avg_k * calls),
            f"{tag}: krylov_ctl launches {n['krylov_ctl']} != "
            f"{round(avg_k * calls)} Krylov iterations")
    require(plain_calls() == 0, f"{tag}: a plain version ran on the card")
    require(n["lanczos_expm"] == n["site_step"] == 0,
            f"{tag}: a Lanczos kernel ran on the Arnoldi path")
    require(n["mgs_qr"] == steps * len(moves),
            f"{tag}: qr launches {n['mgs_qr']} != {steps} × {len(moves)}")
    if engine.config.env_precision == "high":
        transfers = steps * 2 * (engine.nsite - 1)
        require(n["renorm_hi"] == transfers,
                f"{tag}: renorm_hi launches {n['renorm_hi']} != {transfers}")
        require(n["matvec_hi"] == calls,
                f"{tag}: matvec_hi launches {n['matvec_hi']} != {calls} "
                "Krylov calls")
    else:
        require(n["renorm_hi"] == n["matvec_hi"] == 0,
                f"{tag}: the bf16x3 kernel ran on the float32 rung")


def phase_radical_pair(times, preset: str) -> dict:
    """The χ=1024 radical-pair Liouville MPDO of bench_chi.py at a
    precision rung.  The kernel checks; a host-driven witness (a warm-up
    step, whose Krylov control steps check the control kernel, then
    ``RP_HOST_STEPS`` steps under the profiler and ``RP_HOST_TIMED``
    timed); then a fresh engine through ``propagate_steps``: a host step
    and the capture of the step as a CUDA graph (its Krylov iterations IF
    nodes), the same ``RP_HOST_STEPS`` steps as replays under the profiler
    (Krylov statistics, counted and traced launches equal to the
    witness's), then the rest of 1 + ``RP_STEPS`` steps as timed replays:
    bench_chi.py's invariants, its gold populations, the launch gates.
    Returns {kernel: (launches, max |Δ| against plain or None)}."""
    import torch

    from pytdscf_torch.mps import cuda_qr as CQ

    tag = f"radical pair [{preset}]"
    t0 = time.perf_counter()
    engine, ele = build_rp_engine("cuda", preset)
    log(f"{tag}: {engine.nsite} sites, χ={CHI}, MPO widths "
        f"{sorted({int(w.shape[0]) for w in engine.W[1:]})}, built in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    engine.right_canonicalize()
    tr0 = engine.trace()
    log(f"{tag}: right_canonicalize + trace {tr0.real:.6f}"
        f"{tr0.imag:+.2e}j in {time.perf_counter() - t0:.2f} s")
    high = engine.config.env_precision == "high"
    if high:
        err = check_chain3(engine, times)
    else:
        err = check_matvec(engine, times)
        err["mgs_qr"] = check_qr_gauge(engine, times)
    torch.cuda.empty_cache()

    # ---- host-driven witness
    engine.krylov_stats()
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    recs = record_ctl(lambda: engine.propagate(RP_DT))
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    err["krylov_ctl"] = check_krylov_ctl(recs, times, tag)
    del recs
    restore = host_snapshot(engine)
    busy_h, seen_h = profile_run(lambda: (restore(), [
        engine.propagate(RP_DT) for _ in range(RP_HOST_STEPS)]), count=True)
    stats_h, n_h = engine.krylov_stats(), rp_launches()
    host_s = []
    for _ in range(RP_HOST_TIMED):
        t0 = time.perf_counter()
        engine.propagate(RP_DT)
        torch.cuda.synchronize()
        host_s.append(time.perf_counter() - t0)
    peak_h = torch.cuda.max_memory_allocated() / 1e9
    log(f"{tag}, host-driven: warm-up {warm_s:.3f} s; s/step "
        f"{[round(x, 4) for x in host_s]}; {RP_HOST_STEPS} steps traced "
        f"keep the device {100 * busy_h:.1f} % busy; Krylov {stats_h}; "
        f"launches {n_h}; peak device memory {peak_h:.2f} GB")
    del engine, restore
    torch.cuda.empty_cache()

    # ---- the same steps as graph replays, through propagate_steps
    engine, _ = build_rp_engine("cuda", preset)
    engine.right_canonicalize()
    engine.krylov_stats()
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine.propagate_steps(RP_DT, 1)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    (prog,) = engine._programs.values()
    require(engine.capturable() and prog.graph is not None
            and prog.branches is not None,
            f"{tag}: the step was not captured with its IF nodes")
    restore = program_snapshot(engine, steps=True)
    busy_g, seen_g = profile_run(lambda: (
        restore(), engine.propagate_steps(RP_DT, RP_HOST_STEPS)), count=True)
    stats_g, n_g = engine.krylov_stats(), rp_launches()
    log(f"{tag}, graph: host step, warm-up capture and capture {first_s:.3f}"
        f" s (capture and instantiate {prog.capture_s:.3f} s); "
        f"{RP_HOST_STEPS} replays traced keep the device "
        f"{100 * busy_g:.1f} % busy; Krylov {stats_g}; launches {n_g}")
    require(stats_g == stats_h, f"{tag}: replayed Krylov statistics "
            f"{stats_g} != host-driven {stats_h}")
    require(n_g == n_h, f"{tag}: replayed launches (device-counted) {n_g} "
            f"!= host-driven {n_h}")
    # the profiler records every launch of the host-driven steps, but not
    # the kernels that a replay runs inside an IF node's body: it loses
    # some and names others wrongly (on an H100 with torch 2.11: 931
    # control kernels traced where the device counted 1010, 863 planes
    # kernels where 800 ran).  So the kernels outside every body (MGS) are
    # held to the trace
    # exactly, and the bodies' launches to the device's count above
    host_seen, graph_seen = seen_h["by_name"], seen_g["by_name"]
    outside = [k for k in host_seen if "mgs_qr" in k]
    require(outside and all(graph_seen.get(k) == host_seen[k]
                            for k in outside),
            f"{tag}: traced MGS launches of the replays "
            f"{[graph_seen.get(k) for k in outside]} != the host-driven "
            f"steps' {[host_seen[k] for k in outside]}")
    log(f"{tag}: traced launches, host-driven steps against replays "
        "(inside IF-node bodies the trace is not a count): "
        + ", ".join(f"{k.split('(')[0].split('::')[-1][:40]} "
                    f"{host_seen[k]}/{graph_seen.get(k, 0)}"
                    for k in sorted(host_seen)))
    # ---- the rest of the 1 + RP_STEPS steps, replayed and timed
    reset_counts()
    engine.krylov_stats()
    nrest = RP_STEPS - RP_HOST_STEPS
    t0 = time.perf_counter()
    engine.propagate_steps(RP_DT, nrest)
    torch.cuda.synchronize()
    replay_s = (time.perf_counter() - t0) / nrest
    peak_g = torch.cuda.max_memory_allocated() / 1e9
    stats, n = engine.krylov_stats(), rp_launches()
    tflops = engine.flops_estimate(max(stats[0], 1.0)) / replay_s / 1e12
    log(f"{tag}, graph: {nrest} replays {replay_s:.4f} s/step "
        f"(~{tflops:.1f} algorithmic TFLOP/s); avg Krylov {stats[0]:.3f} "
        f"over {stats[1]} calls, cap hits {stats[2]}; relaxed matvecs "
        f"{stats[3]}; launches {n}, qr by route "
        f"{dict(CQ.mgs_qr.route_launches)}; graph_steps "
        f"{engine.graph_steps}, eager_steps {engine.eager_steps}; peak "
        f"device memory {peak_g:.2f} GB (host-driven {peak_h:.2f} GB)")
    require((engine.graph_steps, engine.eager_steps) == (RP_STEPS, 1),
            f"{tag}: graph_steps {engine.graph_steps}, eager_steps "
            f"{engine.eager_steps} != ({RP_STEPS}, 1)")
    rp_gold(engine, ele, RP_KEY, tag)
    rp_launch_gates(engine, tag, nrest, stats, n)
    moves = mgs_moves(engine)
    by_route = {way: nrest * sum(CQ.route(*shape) == way
                                 for _, _, shape in moves)
                for way in CQ.ROUTES}
    routes = dict(CQ.mgs_qr.route_launches)
    require(routes == by_route and by_route["cluster"] > 0,
            f"{tag}: qr launches by route {routes} != {by_route}")
    return {**{name: (v, err.get(name)) for name, v in n.items() if v},
            "mgs_qr_routes": routes}


def phase_rp_simulator() -> dict:
    """The χ=1024 radical pair through ``Simulator.propagate`` at
    "throughput" (Arnoldi, ``conserve_norm=False``, bench_chi.py's model
    from its Hartree product): ``RP_SIM_STEPS`` steps at ``fetch_stride``
    ``RP_SIM_STRIDE`` (a block of a host step, the capture and replays,
    then an inline step) against stride 1: every ``populations.dat`` value
    within ``ROW_TOL``."""
    import torch

    from pytdscf_torch import Simulator, units
    from pytdscf_torch.models.radical_pair import singlet_product_state
    from pytdscf_torch.mps import cuda_qr as CQ

    basis, model, ele = rp_model()
    model.init_HartreeProduct = [
        singlet_product_state(basis, ele, split_electron=True)]
    rows, runs = {}, {}
    cwd = os.getcwd()
    for stride in (1, RP_SIM_STRIDE):
        with tempfile.TemporaryDirectory() as tmp:
            os.chdir(tmp)
            try:
                reset_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                sim = Simulator("chip_rp", model)
                _, wf = sim.propagate(
                    stepsize=RP_DT * units.au_in_fs, maxstep=RP_SIM_STEPS,
                    autocorr=False, energy=False, conserve_norm=False,
                    integrator="arnoldi", thresh_sil=RP_THRESH,
                    precision_preset="throughput", fetch_stride=stride)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                with open(os.path.join("chip_rp_prop", "populations.dat")) as fh:
                    lines = [ln for ln in fh if not ln.startswith("#")]
            finally:
                os.chdir(cwd)
        rows[stride] = np.asarray([[float(x) for x in ln.split()]
                                   for ln in lines])
        eng = wf.engine
        diag = sim.diagnostics
        runs[stride] = (eng.graph_steps, eng.eager_steps, rp_launches(),
                        dict(CQ.mgs_qr.route_launches))
        log(f"radical pair, Simulator at fetch_stride {stride}: "
            f"{RP_SIM_STEPS} steps in {wall:.2f} s (set-up included); "
            f"sweep {diag.elapsed.get('sweep', 0.0) / RP_SIM_STEPS:.4f} "
            f"s/step; graph_steps {eng.graph_steps}, eager_steps "
            f"{eng.eager_steps}; launches {runs[stride][2]}; last row "
            f"{lines[-1].strip()!r}")
        require(plain_calls() == 0, "radical pair Simulator: a plain "
                "version ran on the card")
        del sim, wf, eng
        torch.cuda.empty_cache()
    gap = float(np.max(np.abs(rows[RP_SIM_STRIDE] - rows[1])))
    log(f"radical pair, Simulator: stride-{RP_SIM_STRIDE} rows within "
        f"{gap:.2e} of stride 1 (tol {ROW_TOL})")
    require(rows[1].shape == rows[RP_SIM_STRIDE].shape
            and rows[1].shape[0] == RP_SIM_STEPS,
            f"radical pair Simulator: rows {rows[1].shape}, "
            f"{rows[RP_SIM_STRIDE].shape}")
    require(np.all(np.isfinite(rows[1])), "radical pair Simulator: rows "
            "not finite")
    require(gap <= ROW_TOL, f"radical pair Simulator: stride-"
            f"{RP_SIM_STRIDE} rows {gap:.2e} from stride 1")
    require(runs[RP_SIM_STRIDE][:2] == (RP_SIM_STRIDE - 1, 2),
            f"radical pair Simulator: graph_steps, eager_steps "
            f"{runs[RP_SIM_STRIDE][:2]}")
    n, routes = runs[RP_SIM_STRIDE][2:]
    return {**{name: (v, None) for name, v in n.items() if v},
            "mgs_qr_routes": routes}


def phase_anchor() -> dict:
    """bench_chi.py's χ=2048 anchor (6+6 nuclei, Krylov buffer 8) at
    "throughput": a host step and the capture; from the state after them
    one replayed step against one host-driven step (Krylov statistics and
    launches equal, the replay's counted on the device); then from that
    state again ``ANCHOR_STEPS`` graph replays, timed: its gold
    populations, the launch gates, the peak memory; one more replayed step
    under the profiler (busy share)."""
    import torch

    from pytdscf_torch.mps import cuda_qr as CQ

    tag = f"χ={CHI_ANCHOR} anchor [throughput]"
    t0 = time.perf_counter()
    engine, ele = build_rp_engine("cuda", "throughput", chi=CHI_ANCHOR,
                                  nuc=ANCHOR_NUC, krylov=ANCHOR_KRYLOV)
    engine.right_canonicalize()
    torch.cuda.synchronize()
    log(f"{tag}: {engine.nsite} sites, built and canonicalised in "
        f"{time.perf_counter() - t0:.1f} s")
    engine.krylov_stats()
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine.propagate_steps(RP_DT, 1)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    (prog,) = engine._programs.values()
    # the peak of the host step, the captures and (below) the timed
    # replays: not of the witness, whose host step runs beside the pool
    peak_first = torch.cuda.max_memory_allocated()
    # one replayed step against the same step driven from the host
    restore = program_snapshot(engine)
    restore()
    engine.propagate_steps(RP_DT, 1)
    stats_g, n_g = engine.krylov_stats(), rp_launches()
    restore()
    engine.propagate(RP_DT)
    stats_h, n_h = engine.krylov_stats(), rp_launches()
    log(f"{tag}: one step replayed, Krylov {stats_g}, launches {n_g}; "
        f"host-driven, Krylov {stats_h}, launches {n_h}")
    require(stats_g == stats_h, f"{tag}: replayed Krylov statistics "
            f"{stats_g} != host-driven {stats_h}")
    require(n_g == n_h, f"{tag}: replayed launches (device-counted) {n_g} "
            f"!= host-driven {n_h}")
    restore()
    del restore
    engine.krylov_stats()
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine.propagate_steps(RP_DT, ANCHOR_STEPS)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / ANCHOR_STEPS
    peak = max(peak_first, torch.cuda.max_memory_allocated()) / 1e9
    stats, n = engine.krylov_stats(), rp_launches()
    routes = dict(CQ.mgs_qr.route_launches)
    log(f"{tag}: host step and captures {first_s:.3f} s (capture and "
        f"instantiate {prog.capture_s:.3f} s); {ANCHOR_STEPS} replays "
        f"{step_s:.4f} s/step; avg Krylov {stats[0]:.3f} over {stats[1]} "
        f"calls, cap hits {stats[2]}, relaxed matvecs {stats[3]}; launches "
        f"{n}; graph_steps {engine.graph_steps}; peak device memory "
        f"{peak:.2f} GB")
    require((engine.graph_steps, engine.eager_steps)
            == (ANCHOR_STEPS + 1, 2),
            f"{tag}: graph_steps {engine.graph_steps}, eager_steps "
            f"{engine.eager_steps}")
    rp_gold(engine, ele, ANCHOR_KEY, tag)
    rp_launch_gates(engine, tag, ANCHOR_STEPS, stats, n)
    busy = profile_run(lambda: engine.propagate_steps(RP_DT, 1))
    log(f"{tag}: a replayed step keeps the device {100 * busy:.1f} % busy")
    return {**{name: (v, None) for name, v in n.items() if v},
            "mgs_qr_routes": routes}


# ------------------------------------------------------------------------
# relax → operate(μ) → propagate → spectrum (ROADMAP A7, one state)


def ir_models(name: str):
    """(basinfo, H model, μ·E model, harmonic ZPE) of a workflow: the H2O
    surface of ``tests/test_h2o_pipeline.py`` (3 modes, 9 primitives, D=9)
    or ``examples/butadiene_ir_spectrum.py``'s C4H6 local-mode surface (14
    active modes, 6 primitives, D=12), μ at efield (1e-2, 1e-2, 1e-2)."""
    from pytdscf_torch import units
    from pytdscf_torch.basis.ho import PrimBas_HO
    from pytdscf_torch.model import BasInfo, Model
    from pytdscf_torch.operators.sop import read_potential_nMR
    from pytdscf_torch.potentials import h2o_k_orig, h2o_mu, load

    if name == "h2o":
        k_orig, mu, modes, nprim, bond = h2o_k_orig, h2o_mu, [1, 2, 3], 9, 9
        active = None
    else:
        k_orig = load("c4h6_local_potential")["k_orig"]
        mu = load("c4h6_local_dipole")["mu"]
        modes = sorted({i for key in k_orig for i in key})
        nprim, bond, active = 6, 12, modes
    prim = [[PrimBas_HO(0.0, math.sqrt(k_orig[(m, m)]) * units.au_in_cm1,
                        nprim) for m in modes]]
    basinfo = BasInfo(prim)
    model = Model(basinfo, {"hamiltonian": read_potential_nMR(k_orig)},
                  bond_dim=bond)
    mu_ham = read_potential_nMR(None, dipole_emu=mu, efield=EFIELD,
                                active_modes=active)
    model_mu = Model(basinfo, {"hamiltonian": mu_ham}, bond_dim=bond)
    zpe = sum(math.sqrt(k_orig[(m, m)]) for m in modes) / 2
    return model, model_mu, zpe


def workflow_counts() -> dict:
    """The launches of the workflow's kernels since the last reset, by
    kernel, route and cluster size, and the plain-version calls."""
    return {**counted_launches(), "plain": plain_calls()}


def fs(t: float) -> float:
    """``t`` fs in atomic units of time."""
    from pytdscf_torch import units

    return t / units.au_in_fs


def timed_phase(tag: str, run):
    """``run()`` from zeroed counts, the peak memory reset: (its result,
    wall seconds, the counts after it, the peak bytes above what was
    allocated before it)."""
    import torch

    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = workflow_counts()
    peak = torch.cuda.max_memory_allocated() - base
    require(n["plain"] == 0, f"{tag}: {n['plain']} plain-version calls")
    log(f"{tag}: {wall:.3f} s, peak {peak / 2**20:.1f} MiB above the "
        f"{base / 2**20:.1f} MiB allocated before; launches "
        f"lanczos_gs {n['lanczos_gs']} by route {n['lanczos_gs_routes']} by "
        f"size {n['lanczos_gs_sizes']}, lanczos_expm {n['lanczos_expm']}, "
        f"site_step {n['site_step']}, mgs_qr {n['mgs_qr']}")
    return out, wall, n, peak


def traced_run(tag: str, run, first: dict | None = None,
               steps: tuple[int, int] = (1, 1)):
    """``run()`` under the profiler from zeroed counts (again, from zeroed
    counts, where the trace lost a marker): (its result, the busy share,
    the launches of the port's kernels).  A replayed step only accounts
    for its launches (it adds what the captured step added), so the
    launches as traced must equal the counters', and, given ``first`` (a
    launch record of ``steps[1]`` steps), ``first`` scaled to this run's
    ``steps[0]``; no plain call."""
    box = []
    busy, seen = profile_run(lambda: (reset_counts(), box.append(run())),
                             count=True)
    counted = counted_launches()
    require(plain_calls() == 0, f"{tag}: {plain_calls()} plain-version "
            "calls")
    require(scaled(seen, 1) == counted, f"{tag}: traced {launch_text(seen)} "
            f"!= counted {launch_text(counted)}")
    if first is not None:
        want = scaled({k: v for k, v in first.items() if k != "plain"},
                      *steps)
        require(counted == want, f"{tag}: counted {launch_text(counted)} != "
                f"the first run's {launch_text(want)}")
    return box[-1], busy, counted


def passes_text(stats: dict) -> str:
    hist = {k: v for k, v in enumerate(stats["passes_hist"]) if v}
    calls = stats["calls"]
    return (f"{calls} ground states: passes {hist} (mean "
            f"{stats['passes'] / max(calls, 1):.2f}), "
            f"{stats['iterations']} Lanczos iterations, "
            f"{stats['breakdowns']} breakdowns")


def spectrum_peaks(job: str, e_gs: float, windows) -> list:
    """The strongest line in each (lo, hi) cm⁻¹ window of the spectrum of
    ``{job}_prop/autocorr.dat``, and the frequency grid's spacing."""
    from pytdscf_torch import spectra, units

    t_fs, ac = spectra.load_autocorr(f"{job}_prop/autocorr.dat")
    freq, inten = spectra.ifft_autocorr(t_fs, ac,
                                        E_shift=e_gs * units.au_in_eV)
    out = []
    for lo, hi in windows:
        sel = (freq > lo) & (freq < hi)
        out.append(float(freq[sel][np.argmax(inten[sel])]))
    return out, float(abs(freq[1] - freq[0]))


def phase_workflow(name: str, relax_steps: int, prop_steps: int) -> tuple:
    """The IR-spectrum workflow through the port's entry points on the
    card: ``Simulator.relax`` (improved, 0.1 fs), ``operate`` (μ·E, up to
    10 sweeps), ``propagate`` (0.2 fs, the card's default ``fetch_stride``
    16: graph replays) from the checkpoints the steps before wrote, then
    the spectrum (``spectra.ifft_autocorr``, E_shift = E_gs), then the
    propagate stage again under the profiler, whose traced launches count
    for it (equal to the counters' accounting of its replays, its
    autocorrelation within ROW_TOL of the first run's).  Gates: E_gs
    below the harmonic ZPE, the norm within NORM_TOL over the run, ⟨H⟩
    conserved to WF_E_DRIFT, no plain call, the ground-state kernel
    launched at every relax site, and the model's literals (H2O: the ZPE
    and both peaks of ``tests/test_h2o_pipeline.py``; C4H6: the JAX
    package's gold, ``GOLD_C4H6``).  Returns (the kernels' launches over
    the three stages: relax and operate as counted, propagate as traced;
    the relaxed engine, the Hamiltonian model)."""
    import torch

    from pytdscf_torch import Simulator
    from pytdscf_torch.config import Config
    from pytdscf_torch.mps.tdvp import TDVPEngine
    from pytdscf_torch.checkpoint import load_wavefunction

    tag = f"workflow {name}"
    model, model_mu, zpe = ir_models(name)
    cwd = os.getcwd()
    total = {}
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            (e_gs, wf), wall, n, peak = timed_phase(
                f"{tag}: relax ({relax_steps} improved steps)",
                lambda: Simulator(name, model, verbose=0).relax(
                    maxstep=relax_steps, stepsize=0.1, improved=True))
            gs_engine = wf.engine
            log(f"{tag}: MGS gauge moves a step by shape (mgs_moves) "
                f"{shape_counts(s for *_, s in mgs_moves(gs_engine))}")
            stats = gs_engine.ground_state_stats()
            log(f"{tag}: relax {wall / relax_steps:.4f} s/step; "
                f"{passes_text(stats)}")
            nsite = gs_engine.nsite
            require(n["lanczos_gs"] == 2 * nsite * relax_steps
                    == stats["calls"],
                    f"{tag}: {n['lanczos_gs']} ground-state launches, "
                    f"{stats['calls']} counted on the device, for "
                    f"{2 * nsite * relax_steps} site updates")
            require(n["lanczos_expm"] == 0 and n["site_step"] == 0,
                    f"{tag}: an exponential ran in improved relaxation")
            log(f"{tag}: E_gs {e_gs!r} Eh; harmonic ZPE {zpe!r}")
            require(e_gs < zpe, f"{tag}: E_gs {e_gs} not below the "
                    f"harmonic ZPE {zpe}")
            _add_counts(total, n)
            busy = profile_run(lambda: gs_engine.propagate(fs(0.1)))
            log(f"{tag}: one more improved step keeps the device "
                f"{100 * busy:.1f} % busy")
            (norm, _), wall_op, n, _ = timed_phase(
                f"{tag}: operate", lambda: Simulator(
                    name, model_mu, verbose=0).operate(
                        maxstep=10, restart=True, loadfile_ext="_gs"))
            log(f"{tag}: ‖μ|0⟩‖ {norm!r}")
            _add_counts(total, n)
            start = load_wavefunction(f"wf_{name}_operate.pkl")["cores"]
            e0 = TDVPEngine(start, model.hamiltonian,
                            Config(dtype="complex64"), "cuda"
                            ).expectation().real
            sim = Simulator(name, model, verbose=0)
            (e_end, pwf), wall_p, n_prop, peak_p = timed_phase(
                f"{tag}: propagate ({prop_steps} steps, stride 16)",
                lambda: sim.propagate(maxstep=prop_steps, stepsize=0.2,
                                      restart=True,
                                      loadfile_ext="_operate"))
            _, first = dat_rows(f"{name}_prop/autocorr.dat")
            eng = pwf.engine
            log(f"{tag}: propagate {wall_p / prop_steps:.4f} s/step "
                f"(graph steps {eng.graph_steps}, host steps "
                f"{eng.eager_steps}; sweep {sim.diagnostics.report()})")
            require(eng.graph_steps > prop_steps // 2,
                    f"{tag}: {eng.graph_steps} replayed steps")
            pops = np.loadtxt(f"{name}_prop/populations.dat")[:, 1]
            drift_n = float(np.max(np.abs(pops - 1.0)))
            drift_e = abs(e_end - e0)
            log(f"{tag}: ⟨H⟩ {e0!r} at the start, {e_end!r} at the last "
                f"step (drift {drift_e:.3e}); max |norm² − 1| {drift_n:.3e} "
                f"over {len(pops)} rows")
            require(drift_n < NORM_TOL and drift_e < WF_E_DRIFT,
                    f"{tag}: norm² drift {drift_n:.3e} (bar {NORM_TOL}), "
                    f"⟨H⟩ drift {drift_e:.3e} (bar {WF_E_DRIFT})")
            busy = profile_run(lambda: eng.propagate_steps(fs(0.2), 4))
            log(f"{tag}: 4 replayed steps keep the device "
                f"{100 * busy:.1f} % busy")
            if name == "h2o":
                (bend, stretch), res = spectrum_peaks(
                    name, e_gs, [(1000, 3000), (3000, 4100)])
                log(f"{tag}: ZPE {e_gs!r} (literal {H2O_ZPE}, "
                    f"|Δ| {abs(e_gs - H2O_ZPE):.3e}, bar {H2O_ZPE_TOL}); "
                    f"bend {bend:.1f}, stretch {stretch:.1f} cm⁻¹ "
                    f"(grid {res:.1f})")
                require(abs(e_gs - H2O_ZPE) <= H2O_ZPE_TOL,
                        f"{tag}: ZPE {e_gs} vs {H2O_ZPE}")
                require(abs(bend - H2O_BEND[0]) <= H2O_BEND[1]
                        and abs(stretch - H2O_STRETCH[0]) <= H2O_STRETCH[1],
                        f"{tag}: peaks {bend}, {stretch}")
            else:
                (peak_f,), res = spectrum_peaks(name, e_gs, [(600, 3500)])
                gold = GOLD_C4H6
                log(f"{tag}: E_gs |Δ| {abs(e_gs - gold['e_gs']):.3e} from "
                    f"gold (bar {C4H6_E_TOL}); ‖μ|0⟩‖ relative |Δ| "
                    f"{abs(norm / gold['norm'] - 1):.3e} (bar "
                    f"{C4H6_NORM_RTOL}); strongest line {peak_f:.2f} cm⁻¹ "
                    f"(gold {gold['peak']:.2f}, grid {res:.2f})")
                require(abs(e_gs - gold["e_gs"]) <= C4H6_E_TOL,
                        f"{tag}: E_gs {e_gs} vs gold {gold['e_gs']}")
                require(abs(norm / gold["norm"] - 1) <= C4H6_NORM_RTOL,
                        f"{tag}: ‖μ|0⟩‖ {norm} vs gold {gold['norm']}")
                require(abs(peak_f - gold["peak"]) <= gold["bin"] * 1.0001,
                        f"{tag}: strongest line {peak_f} vs gold "
                        f"{gold['peak']} (one bin {gold['bin']})")
            # ---- the propagate stage again under the profiler: its
            # launches as the card ran them (one host step, then replays),
            # which the counters only account for (a replay adds what the
            # captured step added); the path's launches come from the trace
            (_, again_wf), busy, traced = traced_run(
                f"{tag}: propagate", lambda: Simulator(
                    name, model, verbose=0).propagate(
                        maxstep=prop_steps, stepsize=0.2, restart=True,
                        loadfile_ext="_operate"), n_prop)
            _, again = dat_rows(f"{name}_prop/autocorr.dat")
            gap = float(np.max(np.abs(again - first)))
            log(f"{tag}: propagate again under the profiler keeps the device "
                f"{100 * busy:.1f} % busy; graph steps "
                f"{again_wf.engine.graph_steps}; autocorrelation within "
                f"{gap:.2e} of the first run's")
            require(gap <= ROW_TOL, f"{tag}: the traced propagate's "
                    f"autocorrelation {gap:.2e} from the first run's")
            _add_counts(total, traced)
            log(f"{tag}: relax {wall:.2f} s, operate {wall_op:.2f} s, "
                f"propagate {wall_p:.2f} s; peak memory relax "
                f"{peak / 2**20:.1f} MiB, propagate {peak_p / 2**20:.1f} MiB")
        finally:
            os.chdir(cwd)
    return total, gs_engine, model


def _add_counts(total: dict, n: dict) -> None:
    for key, value in n.items():
        if isinstance(value, dict):
            sub = total.setdefault(key, {})
            for k, v in value.items():
                sub[k] = sub.get(k, 0) + v
        else:
            total[key] = total.get(key, 0) + value


def workflow_path(total: dict) -> dict:
    """A workflow's entries for the ``kernels`` line."""
    return path_launches({k: v for k, v in total.items() if k != "plain"})


def phase_imaginary(model) -> dict:
    """Imaginary-time relaxation of butadiene from its Hartree product
    (``Config.relax="imaginary"``: scale −dt/2 real, norm restored after
    every exponential; the relax defaults thresh 1e-9, max_krylov 20), with
    the separate kernels and with the fused site kernel: ⟨H⟩ non-increasing
    step by step (to IMAG_SLACK), the norm 1, the end ⟨H⟩ within IMAG_TOL
    of the same steps through the plain versions (complex64 on the host);
    then ``lanczos_expm`` and ``site_step`` at that real scale against
    their plain versions on the bulk site's operands."""
    import torch

    from pytdscf_torch import Simulator
    from pytdscf_torch.config import Config
    from pytdscf_torch.mps.tdvp import TDVPEngine

    dt = fs(0.1)
    cores = Simulator("c4h6", model, verbose=0)._alloc_initial_cores()
    plain = TDVPEngine(cores, model.hamiltonian,
                       Config(relax="imaginary", dtype="complex64",
                              fused_site=False), "cpu")
    for _ in range(IMAG_STEPS):
        plain.propagate(dt)
    e_plain = plain.expectation().real
    out, engines = {}, {}
    for fused in (False, True):
        tag = f"imaginary c4h6 ({'fused site' if fused else 'separate'})"
        engine = TDVPEngine(cores, model.hamiltonian,
                            Config(relax="imaginary", dtype="complex64",
                                   fused_site=fused), "cuda")
        energies = [engine.expectation().real]

        def run(engine=engine, energies=energies):
            for _ in range(IMAG_STEPS):
                engine.propagate(dt)
                energies.append(engine.expectation().real)

        _, wall, n, peak = timed_phase(tag, run)
        steps = np.diff(energies)
        log(f"{tag}: {wall / IMAG_STEPS:.4f} s/step; ⟨H⟩ {energies}; end "
            f"|Δ| from the plain route {abs(energies[-1] - e_plain):.3e}; "
            f"norm {engine.norm():.7f}")
        require(bool(np.all(steps <= IMAG_SLACK)),
                f"{tag}: ⟨H⟩ rose in a step: {steps}")
        require(abs(energies[-1] - e_plain) <= IMAG_TOL,
                f"{tag}: end ⟨H⟩ {energies[-1]} vs plain {e_plain}")
        require(abs(engine.norm() - 1.0) < NORM_TOL, f"{tag}: norm")
        require(n["lanczos_expm"] > 0 and (n["site_step"] > 0) == fused,
                f"{tag}: launches {n}")
        busy = profile_run(lambda: engine.propagate(dt))
        log(f"{tag}: one more step keeps the device {100 * busy:.1f} % busy")
        _add_counts(out, n)
        engines[fused] = engine
    return out, engines[False], dt


def check_real_scale(engine, dt) -> tuple[float, float]:
    """``lanczos_expm`` and ``site_step`` at the real scale −dt/2 (and the
    K step's +dt/2) against their plain versions on the imaginary-time
    run's bulk site, its centre moved there: the plain version's status,
    ‖Δψ‖ < LANCZOS_TOL, a second launch bit-identical (the site kernel by
    check_site_once).  At the chain's thresh_exp, REAL_SCALE_THRESH: the
    relax default 1e-9 lies below the float32 rounding of ‖ψ_k − ψ_k−1‖,
    where two summation orders take the stop at different k (the fused
    site's K step stopped at 7 against the plain version's 8).  Returns
    the largest errors of each kernel."""
    import torch

    from pytdscf_torch.mps import cuda_lanczos as CL
    from pytdscf_torch.mps import cuda_site as CS

    p = C4H6_BULK
    (L, lL), W, (R, lR), psi, nxt = centred_operands(engine, p)
    l, d, r = psi.shape
    scale = complex(-0.5 * dt)
    cfg = engine.config.replace(thresh_exp=REAL_SCALE_THRESH)
    worst = 0.0
    ch = CL.heff_channels(L, W, R, torch.exp(lL + lR))
    v = psi.reshape(l * d, r)
    for sc, tag in ((scale, "H step"), (-scale, "the sign of the K step")):
        got, st = CL.lanczos_expm(ch, v, sc, cfg.thresh_exp, cfg.max_krylov,
                                  True)
        again, _ = CL.lanczos_expm(ch, v, sc, cfg.thresh_exp,
                                   cfg.max_krylov, True)
        want, st_p = CL.lanczos_expm_plain(*ch, v, sc, cfg.thresh_exp,
                                           min(cfg.max_krylov, l * d * r),
                                           True)
        err = float(torch.linalg.vector_norm(got - want))
        log(f"real scale {sc.real:+.4f}: lanczos_expm ({l * d}, {r}) "
            f"{tag}: status {st.tolist()} vs plain {st_p.tolist()}, "
            f"‖Δψ‖ {err:.3e}, norm {float(torch.linalg.vector_norm(got)):.7f}")
        require(st.tolist() == st_p.tolist() and err < LANCZOS_TOL
                and torch.equal(got, again),
                f"real-scale lanczos_expm {tag}: ‖Δψ‖ {err:.3e}")
        worst = max(worst, err)
    args = (psi, nxt, L, W, R, scale, cfg.thresh_exp, lL, lR)
    kw = dict(forward=True, max_dim=cfg.max_krylov, conserve=True)
    if CS.site_fits(psi.shape, W.shape, nxt.shape, cfg.max_krylov):
        want = CS.site_step_fused_plain(*args, **kw)
        errs, line = check_site_once("real-scale site_step (bulk, forward)",
                                     args, kw, want, {})
        log(line)
    else:
        raise SmokeFailure("the fused site kernel does not take the bulk "
                           "site of butadiene")
    return worst, max(errs)


def centred_operands(engine, p: int):
    """``site_operands`` of site p with the state's centre moved there
    (``qr_right`` over sites 0..p−1 of a copy of the cores), so that H_eff
    is the Hamiltonian projected on the site's space and ψ the centre:
    ((L, lL), W, (R, lR), ψ, the next core or None at the last site)."""
    from pytdscf_torch.mps import kernels as K

    cores = [c.clone() for c in engine.cores[0]]
    for q in range(p):
        a, sig = K.qr_right(cores[q])
        cores[q] = a
        cores[q + 1] = K.absorb_right(sig, cores[q + 1])
    saved = engine.cores[0]
    engine.cores[0] = cores
    try:
        left, W, right, _ = site_operands(engine, p)
    finally:
        engine.cores[0] = saved
    nxt = cores[p + 1].contiguous() if p + 1 < len(cores) else None
    return left, W, right, cores[p].contiguous(), nxt


def dense_heff(ch):
    """The dense H_eff (M·r)² of the channels: H[(i,a),(j,b)] = Σ_c
    H_c[i,j] Rt_c[b,a]."""
    import torch

    H, Rt = ch
    nc, M, _ = H.shape
    r = Rt.shape[1]
    return torch.einsum("cij,cba->iajb", H, Rt).reshape(M * r, M * r)


def check_ground_state(engines, times) -> float:
    """The ground-state kernel against its plain version at every shape
    that the relax stages launched it at: each site of each relaxed state
    in ``engines`` ({model: engine}), its centre moved there, one check
    per distinct (M, r, channels), which also fixes the route and cluster
    size (``gs_plan``).  Gates at each: energies within GS_E_RTOL
    (relative), |⟨kernel|plain⟩| ≥ 1 − GS_OVERLAP_TOL (the Ritz vectors
    may differ in phase; their pass counts at the rounding level of the
    1e-12 test), the unit norm, a second launch bit-identical.  The
    butadiene bulk is timed beside the plain version and
    ``torch.linalg.eigh`` of the dense H_eff (the same lowest
    eigenvector), with its bound: the run's matvecs at the fp32 peak."""
    import torch

    from pytdscf_torch.mps import cuda_lanczos as CL

    worst, seen, h2o = 0.0, set(), None
    for name, engine in engines.items():
        for p in range(engine.nsite):
            (L, lL), W, (R, lR), psi, _ = centred_operands(engine, p)
            l, d, r = psi.shape
            M, nc = l * d, W.shape[-1]
            bulk = name == "c4h6" and p == C4H6_BULK
            h2o_timed = name == "h2o" and (M, r, nc) == H2O_TIMED
            if (M, r, nc) in seen and not bulk:
                continue
            seen.add((M, r, nc))
            ch = CL.heff_channels(L, W, R, torch.exp(lL + lR))
            v = psi.reshape(M, r).contiguous()
            got, st = CL.ground_state(ch, v)
            again, _ = CL.ground_state(ch, v)
            want, st_p = CL.ground_state_plain(*ch, v)
            torch.cuda.synchronize()

            def energy(x, ch=ch):
                return torch.vdot(x.reshape(-1),
                                  CL._matvec(*ch, x).reshape(-1)).real.item()

            ek, ep = energy(got), energy(want)
            ov = abs(torch.vdot(got.reshape(-1), want.reshape(-1)).item())
            nrm = float(torch.linalg.vector_norm(got))
            way, size = CL.gs_plan(M, r, nc)[:2]
            log(f"ground state {name} site {p} ({M}, {r}), {nc} channels, "
                f"{way} of {size}: E {ek!r} vs plain {ep!r} (rel "
                f"{abs(ek - ep) / abs(ep):.3e}), |⟨k|p⟩| {ov:.9f}, norm "
                f"{nrm:.7f}; status {st.tolist()} vs plain {st_p.tolist()}")
            require(abs(ek - ep) <= GS_E_RTOL * abs(ep)
                    and ov >= 1 - GS_OVERLAP_TOL and abs(nrm - 1) < NORM_TOL
                    and torch.equal(got, again),
                    f"ground state {name} site {p}: E {ek} vs {ep}, "
                    f"overlap {ov}, norm {nrm}")
            worst = max(worst, abs(ek - ep) / abs(ep))
            passes, iters, _ = st.tolist()
            matvecs = iters + passes
            if h2o_timed:
                ms = cuda_ms(lambda: CL.ground_state(ch, v), 20)
                h2o = {"ms": ms, "ms_per_iteration": ms / matvecs,
                       "passes": passes, "iterations": iters,
                       "shape": [M, r, nc], "route": way,
                       "cluster_ctas": size, "threads": CL.gs_plan(M, r, nc)[2]}
                log(f"ground state h2o ({M}, {r}): kernel {ms:.4f} ms "
                    f"({passes} passes, {iters} iterations, "
                    f"{1e3 * ms / matvecs:.2f} µs a matvec-iteration)")
            if not bulk:
                continue
            flops = matvecs * 8.0 * nc * (M * M * r + M * r * r)
            ms = cuda_ms(lambda: CL.ground_state(ch, v), 5)
            plain_ms = cuda_ms(lambda: CL.ground_state_plain(*ch, v), 1)
            D = dense_heff(ch)
            lib_ms = cuda_ms(lambda: torch.linalg.eigh(D), 3)
            lam, vec = torch.linalg.eigh(D)
            log(f"ground state bulk: kernel {ms:.4f} ms ({passes} passes, "
                f"{iters} iterations, {1e3 * ms / matvecs:.2f} µs a "
                f"matvec-iteration), plain {plain_ms:.4f} ms, "
                f"torch.linalg.eigh of the dense ({M * r})² H_eff "
                f"{lib_ms:.4f} ms (lowest {lam[0].item()!r} vs the kernel's "
                f"{ek!r}); {flops / 1e6:.1f} MFLOP")
            times["lanczos_gs"] = {
                "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                **bound(flops, PEAK_FP32, nbytes(*ch, v, got)),
                "ms_per_iteration": ms / matvecs,
                "passes": passes, "iterations": iters,
                "shape": [M, r, nc], "route": way, "cluster_ctas": size,
                "threads": CL.gs_plan(M, r, nc)[2]}
    times["lanczos_gs"]["h2o"] = h2o
    log(f"ground state: {len(seen)} shapes checked, {sorted(seen)}")
    # the wide layout on a random Hermitian site, the same gates
    import numpy as np

    M, r, nc = GS_WIDE
    rng = np.random.default_rng(13)
    H = rng.normal(size=(nc, M, M)) + 1j * rng.normal(size=(nc, M, M))
    Rt = rng.normal(size=(nc, r, r)) + 1j * rng.normal(size=(nc, r, r))
    ch = tuple(torch.tensor((x + x.conj().transpose(0, 2, 1))
                            / (2 * x.shape[1]), dtype=torch.complex64,
                            device="cuda") for x in (H, Rt))
    v = torch.tensor(rng.normal(size=(M, r)) + 1j * rng.normal(size=(M, r)),
                     dtype=torch.complex64, device="cuda")
    plan = CL.gs_plan(M, r, nc)
    require(plan[3], f"ground state ({M}, {r}), {nc} channels: plan {plan} "
            "is not the wide layout")
    got, st = CL.ground_state(ch, v)
    again, _ = CL.ground_state(ch, v)
    want, st_p = CL.ground_state_plain(*ch, v)
    ek, ep = (torch.vdot(x.reshape(-1), CL._matvec(*ch, x).reshape(-1))
              .real.item() for x in (got, want))
    ov = abs(torch.vdot(got.reshape(-1), want.reshape(-1)).item())
    nrm = float(torch.linalg.vector_norm(got))
    log(f"ground state wide ({M}, {r}), {nc} channels, {plan[0]} of "
        f"{plan[1]}, layout {plan[3:6]}: E {ek!r} vs plain {ep!r} (rel "
        f"{abs(ek - ep) / abs(ep):.3e}), |⟨k|p⟩| {ov:.9f}, norm {nrm:.7f}; "
        f"status {st.tolist()} vs plain {st_p.tolist()}")
    require(abs(ek - ep) <= GS_E_RTOL * abs(ep) and ov >= 1 - GS_OVERLAP_TOL
            and abs(nrm - 1) < NORM_TOL and torch.equal(got, again),
            f"ground state wide: E {ek} vs {ep}, overlap {ov}, norm {nrm}")
    passes, iters, _ = st.tolist()
    ms = cuda_ms(lambda: CL.ground_state(ch, v), 3)
    times["lanczos_gs"]["wide"] = {
        "ms": ms, "ms_per_iteration": ms / (iters + passes),
        "passes": passes, "iterations": iters, "shape": [M, r, nc],
        "route": plan[0], "cluster_ctas": plan[1], "threads": plan[2]}
    log(f"ground state wide ({M}, {r}): kernel {ms:.4f} ms ({passes} "
        f"passes, {iters} iterations, {1e3 * ms / (iters + passes):.2f} µs "
        "a matvec-iteration)")
    return max(worst, abs(ek - ep) / abs(ep))


def phase_improved_replay(gs_engine, model, times) -> dict:
    """One improved-relaxation step replayed from a CUDA graph against the
    same step driven from the host (``TDVPEngine.propagate_steps``: a host
    step and the capture, then the replay; the host engine: two
    ``propagate`` steps from the same state): ⟨H⟩ equal to complex64
    tolerance, the ground states' pass telemetry equal, and the replayed
    step's traced launches (by kernel and route) equal to the host step's
    counted ones.  The traced step's device time by kernel goes into
    ``times["relax_step_device_ms"]``."""
    import torch

    from pytdscf_torch.config import Config
    from pytdscf_torch.mps.tdvp import TDVPEngine

    dt = fs(0.1)
    cores = [[c.cpu().numpy() for c in gs_engine.cores[0]]]
    cfg = Config(relax="improved", dtype="complex64")
    host = TDVPEngine(cores, model.hamiltonian, cfg, "cuda")
    graph = TDVPEngine(cores, model.hamiltonian, cfg, "cuda")
    require(graph.capturable(), "improved relaxation of butadiene is not "
            "capturable: a site is past gs_fits")
    host.propagate(dt)
    graph.propagate_steps(dt, 1)
    host.ground_state_stats()
    graph.ground_state_stats()
    reset_counts()
    host.propagate(dt)
    torch.cuda.synchronize()
    want = counted_launches()
    restore = program_snapshot(graph, steps=True)
    _, seen = profile_run(lambda: (
        restore(), graph.ground_state_stats(),
        graph.propagate_steps(dt, 1)), count=True)
    e_h, e_g = host.expectation().real, graph.expectation().real
    s_h, s_g = host.ground_state_stats(), graph.ground_state_stats()
    by_kernel = {}
    for key, ms in seen["device_ms"].items():
        short = ("lanczos_gs" if "lanczos_gs_kernel" in key else
                 "mgs_qr" if "mgs_qr" in key else "other")
        by_kernel[short] = by_kernel.get(short, 0.0) + ms
    total = sum(by_kernel.values())
    times["relax_step_device_ms"] = {"total": total, **by_kernel}
    log(f"improved replay: the traced step's device time {total:.3f} ms: "
        + ", ".join(f"{k} {v:.3f} ms ({100 * v / total:.1f} %)"
                    for k, v in sorted(by_kernel.items(),
                                       key=lambda kv: -kv[1])))
    log(f"improved replay: graph steps {graph.graph_steps}; ⟨H⟩ host "
        f"{e_h!r}, replay {e_g!r} (|Δ| {abs(e_h - e_g):.3e}); passes host "
        f"{s_h['passes']}, replay {s_g['passes']}; launches host "
        f"{launch_text(want)}; replay traced {launch_text(seen)}")
    require(graph.graph_steps == 1, "improved replay: no replayed step")
    require(abs(e_h - e_g) <= E_TOL, "improved replay: ⟨H⟩ differs")
    require(s_h["calls"] == s_g["calls"] == 2 * graph.nsite,
            f"improved replay: {s_g['calls']} ground states")
    for key in ("lanczos_gs", "lanczos_gs_routes", "mgs_qr", "mgs_qr_routes"):
        require(seen[key] == want[key],
                f"improved replay: {key} traced {seen[key]} vs host "
                f"{want[key]}")
    return {"lanczos_gs": (seen["lanczos_gs"], None),
            "lanczos_gs_routes": seen["lanczos_gs_routes"]}


def phase_relax_operate(times) -> list:
    """Phases 11-15: the IR-spectrum workflow on H2O and on butadiene at
    full settings, imaginary-time relaxation in both site modes, the
    kernel checks at a real scale and of the ground state, one replayed
    improved step."""
    import torch

    paths = []
    h2o, h2o_engine, _ = phase_workflow("h2o", H2O_RELAX_STEPS,
                                        H2O_PROP_STEPS)
    paths.append(workflow_path(h2o))
    torch.cuda.empty_cache()
    c4h6, gs_engine, model = phase_workflow("c4h6", C4H6_RELAX_STEPS,
                                            C4H6_PROP_STEPS)
    paths.append(workflow_path(c4h6))
    err_gs = check_ground_state({"h2o": h2o_engine, "c4h6": gs_engine}, times)
    paths.append({"lanczos_gs": (0, err_gs)})
    imag, imag_engine, dt = phase_imaginary(model)
    paths.append(workflow_path(imag))
    err_lz, err_site = check_real_scale(imag_engine, dt)
    paths += [{"lanczos_expm": (0, err_lz)}, {"site_step": (0, err_site)}]
    paths.append(phase_improved_replay(gs_engine, model, times))
    return paths


# ------------------------------------------------------------------------
# the JAX package's one-state models (ROADMAP A4)


# pyrazine's 24-mode QVC model at examples/pyrazine_s2_dynamics.py's own
# settings (nprim 10, D=20, dt 0.1 fs, S2 ⊗ vacuum, energy and the t/2
# autocorrelation, 1500 steps at the card's default stride 16) and its gold
# from scripts/a4_gold.py (the JAX package on the CPU in complex128, pinned
# to its MGS gauge, the port's): the final state's S1/S2 populations, the
# absorption maximum in the 220-280 nm window of the example's spectrum
# and the frequency grid's spacing
PYRAZINE_STEPS = 1500
PYRAZINE_DT = 0.1
PYRAZINE_NPRIM = 10
PYRAZINE_BOND = 20
PYRAZINE_BULK = 12  # a (20, 10, 20) site
GOLD_PYRAZINE = {"pops": (0.6702145747076886, 0.3297854252923114),
                 "peak_cm1": 38007.19446829216, "peak_nm": 263.1080809803678,
                 "bin_cm1": 111.29929929925129}
# the bar: three times the port's own complex64 run on the CPU (the
# kernels' plain versions, stride 16; scripts/a4_gold.py --port complex64)
# against the gold, 0.0360787 (S1 0.7062932 against 0.6702146). Under the
# MGS gauge the S2 → S1 transfer starts from rounding noise (S1 stays below
# 1e-18 for the first 10 fs), so the trajectory depends on the precision:
# the port's complex128 run meets the gold's energy to 2e-13 and its S1 to
# only 1.0e-6
PYRAZINE_POP_TOL = 0.108
# a gate that rounding does not decide: the autocorrelation a(2t) =
# ⟨ψ*(t)|ψ(t)⟩ of the first 40 fs of the state (rows 0-400 of
# autocorr.dat, every 20th row), from the same gold run, where the port's
# complex64 CPU run stays within 4.1434e-5 of the gold (its own rows part
# from it only at row ~950); the bar is three times that
PYRAZINE_AC_ROWS = range(0, 401, 20)
GOLD_PYRAZINE_AC = [
    1.0, -0.175619354 - 0.56020062j, -0.170335571 - 0.008309491j,
    -0.039978312 + 0.012615477j, -0.014755863 - 0.000726961j,
    -0.007464326 - 0.006232779j, -0.001793025 - 0.010478013j,
    -0.006356853 - 0.033591977j, -0.015387172 + 0.02362097j,
    0.030712481 - 0.121279467j, -0.167648173 + 0.011283903j,
    -0.012704203 + 0.044121576j, -0.030293768 + 0.01307944j,
    -0.046028137 + 0.016832842j, -0.189837406 - 0.002988685j,
    -0.05481663 + 0.450157668j, 0.508745785 + 0.141826603j,
    0.17181782 - 0.374924763j, -0.168921634 - 0.143306692j,
    -0.064853261 + 0.048470221j, -0.019977429 + 0.036695372j,
]
PYRAZINE_AC_TOL = 1.24e-04
# the traced rerun of pyrazine's propagate: one host step, two blocks of
# 16 (the second all replays) and an inline step, its launches held to
# the counters' accounting and to the 1500-step run's, step for step
PYRAZINE_TRACED_STEPS = 33
# donor–acceptor model B at examples/donor_acceptor_model_b.py's own
# settings (13 fragments, 8 F and 8 OT modes, nfock 28, D=20, dt 0.2 fs,
# the 26 level projectors every 10 steps), 10 host-driven steps (cut from
# 1000; 20 until the several-state phase took their time), then
# MODEL_B_REPLAYS replayed steps without observables; its gold from
# scripts/a4_gold.py's run of MODEL_B_GOLD_STEPS steps as above: the 26
# populations after step 10 (its .dat row, 9 decimals)
MODEL_B_STEPS = 10
MODEL_B_GOLD_STEPS = 20
MODEL_B_DT = 0.2
MODEL_B_EVERY = 10
MODEL_B_REPLAYS = 4
MODEL_B_NFOCK = 28
MODEL_B_BOND = 20
# the bar: three times the port's complex64 CPU run against the gold,
# 9.80e-7 (after step 20, which the smoke no longer runs; after step 10:
# 8.93e-7), the bar step 10 has had since the phase was written; a
# complex64 expectation carries the rounding of its log-scale, |log|·2⁻²⁴
# relative (step 0 reads LE₁ 0.999998629)
MODEL_B_POP_TOL = 2.9e-06
GOLD_MODEL_B = {
    "10": [
        0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 8e-09, 1.398e-06, 0.000164176,
        0.010642041, 0.296560555, 0.616307226, 0.074418346, 0.001885986,
        2.0145e-05, 1.19e-07, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
    ],
}
POP_SUM_TOL = 1.0e-05
# a replayed model B step against the same step driven from the host: the
# 26 populations (complex64 sums in another order)
REPLAY_POP_TOL = 1.0e-06
# tests/test_henon_heiles.py's two parameter sets (ω cm⁻¹, λ, modes, grid,
# D, dt fs, the energy literal) and tests/test_h2co.py's model: energies
# in complex64 to 1e-6
HENON_HEILES = {
    "1d": (4000, 1.0e-05, 1, 5, 4, 0.01, 0.027338011517478895),
    "2d": (2000, 1.0e-03, 2, 5, 4, 0.001, 0.018225341011652626),
}
DVR_E_TOL = 1.0e-06


# several electronic states (ROADMAP A3). The Ambrosek aggregate of
# tests/test_relax_operate.py (2 molecules, 2 modes each, 5 HO primitives):
# each case (kind, coupled: coupleJ −0.04 eV, bond, proj_gs, steps, dt fs)
# with its literal (the improved case: the ZPE Σω/au_in_cm1)
AMBROSEK_FREQS = (763.31, 1556.64)
AMBROSEK_DISPS = (0.317, 0.429)
AMBROSEK_NPRIM = 5
AMBROSEK = {
    "imag_relax": ("imaginary", False, 4, False, 2, 0.05, 0.010570469969995883),
    "propagate": ("propagate", False, 4, False, 3, 0.05, 0.010570469969995852),
    "projgs_propagate": ("propagate", True, 5, True, 3, 0.05,
                         0.011397875485012856),
    "projgs_imag_relax": ("imaginary", True, 5, True, 2, 0.05,
                          0.011367589141866094),
    "improved": ("improved", False, 4, False, 5, 0.1, None),
}
# the bars: three times the port's own complex64 run on the CPU
# (scripts/a3_gold.py ambrosek --port complex64) from each literal, at least
# 1e-9: 1.661e-9, 2.584e-9, 2.348e-9, 8.805e-10 and 1.661e-9 from them
# operate: the improved case's ground state under the transition dipole
# (ambrosek_dipole), ‖μ|Ψ⟩‖ and the fitted populations against the same
# through the port's plain versions on the CPU in complex128
AMBROSEK_MU = 0.01
AMBROSEK_OPERATE_TOL = 1.0e-5
AMBROSEK_BARS = {"imag_relax": 4.99e-9, "propagate": 7.76e-9,
                 "projgs_propagate": 7.05e-9, "projgs_imag_relax": 2.65e-9,
                 "improved": 4.99e-9}
# the 27-state LH2 exciton model (util.helper_input.matJ_LH2_exciton: 27
# pigments, one mode of 203.3 cm⁻¹ each, S = 0.056), 8 HO primitives a
# pigment, D=8, the whole weight on state 0, dt 0.5 fs: 189 state pairs;
# LH2_STEPS host-driven steps against scripts/a3_gold.py's gold (the JAX
# package in complex128), then LH2_REPLAYS replayed steps
LH2_STEPS = 20
LH2_DT = 0.5
LH2_BOND = 8
LH2_NPRIM = 8
LH2_GOLD = "scripts/a3_gold.json"
LH2_REPLAYS = 8
# the bars: three times the port's complex64 CPU run (scripts/a3_gold.py
# lh2 --port complex64) from the gold: its populations 5.36e-7 (step 13;
# the .dat rows carry 9 decimals), its ⟨H⟩ after the last step 1.106e-6
# relative (thresh 1e-7 in complex64 against the gold's 1e-9 in
# complex128)
LH2_POP_TOL = 1.61e-6
LH2_E_TOL = 3.32e-6


def ambrosek_literal(case: str) -> float:
    from pytdscf_torch import units

    literal = AMBROSEK[case][-1]
    return sum(AMBROSEK_FREQS) / units.au_in_cm1 if literal is None else literal


def ambrosek_model(pkg: str, coupled: bool, bond: int, proj_gs: bool,
                   excited: bool = False):
    """tests/test_relax_operate.py's aggregate, built by the package named
    ``pkg`` (the smoke's is the port, ``pytdscf_torch``): ``coupled``
    coupleJ −0.04 eV, else 0; ``proj_gs`` with ``primbas_gs`` set;
    ``excited`` the improved case's mixed vibrational start."""
    import importlib

    def mod(path):
        return importlib.import_module(f"{pkg}.{path}")

    units, ho = mod("units"), mod("basis").PrimBas_HO
    s0 = [ho(0.0, f, AMBROSEK_NPRIM) for f in AMBROSEK_FREQS]
    s1 = [ho(d, f, AMBROSEK_NPRIM)
          for f, d in zip(AMBROSEK_FREQS, AMBROSEK_DISPS)]
    prim, _, _, matJ = mod("util.helper_input").matJ_1D_exciton(
        2, AMBROSEK_NPRIM, s0, s1, -0.04 / units.au_in_eV if coupled else 0.0)
    basinfo = mod("model").BasInfo(prim)
    ham = mod("operators.sop").PolynomialHamiltonian(basinfo.get_ndof(),
                                                     basinfo.get_nstate())
    ham.coupleJ = matJ
    ham.set_HO_potential(basinfo)
    model = mod("model").Model(basinfo, {"hamiltonian": ham}, bond_dim=bond)
    model.init_weight_ESTATE = [1.0, 0.0]
    if proj_gs:
        model.primbas_gs = s0 * 2
    if excited:
        es, gs = [0.6, 0.8, 0.0, 0.0, 0.0], [1.0, 0.0, 0.0, 0.0, 0.0]
        model.init_weight_VIBSTATE = [[es, gs, gs, gs], [gs, gs, gs, gs]]
    return model


def ambrosek_dipole(pkg: str, mu: float):
    """The aggregate's transition dipole as a model's operator: ``mu``
    between the two states (``coupleJ``, through the states' primitive
    overlaps), nothing on the diagonal: two state pairs, (0, 1) and (1, 0),
    not the Hamiltonian's four."""
    import importlib

    def mod(path):
        return importlib.import_module(f"{pkg}.{path}")

    basinfo = ambrosek_model(pkg, False, 4, False).basinfo
    op = mod("operators.sop").PolynomialHamiltonian(basinfo.get_ndof(), 2)
    op.coupleJ = [[0.0, mu], [mu, 0.0]]
    return mod("model").Model(basinfo, {"hamiltonian": op}, bond_dim=4)


def lh2_model(pkg: str):
    """The 27-state LH2 exciton model, built by the package named ``pkg``:
    ``PolynomialHamiltonian(27, 27)`` with ``matJ_LH2_exciton``'s
    couplings and ``set_HO_potential``, D=LH2_BOND, the whole weight on
    state 0."""
    import importlib

    def mod(path):
        return importlib.import_module(f"{pkg}.{path}")

    matJ, prim, _, _ = mod("util.helper_input").matJ_LH2_exciton(LH2_NPRIM)
    basinfo = mod("model").BasInfo(prim)
    ham = mod("operators.sop").PolynomialHamiltonian(basinfo.get_ndof(),
                                                     basinfo.get_nstate())
    ham.coupleJ = matJ
    ham.set_HO_potential(basinfo)
    model = mod("model").Model(basinfo, {"hamiltonian": ham},
                               bond_dim=LH2_BOND)
    model.init_weight_ESTATE = [1.0] + [0.0] * (basinfo.get_nstate() - 1)
    return model


class ModelBBuild:
    """Donor–acceptor model B's basis, Hamiltonian and fused MPO
    (``donor_acceptor_b(nfock=28)``: a minute of SVDs on the host) built
    in a child process while the earlier phases run on the card, handed
    over as a pickle in a temporary directory.  :meth:`stop` ends the
    child and removes the directory."""

    CODE = (
        "import pickle, sys\n"
        "from pytdscf_torch.models.donor_acceptor import donor_acceptor_b\n"
        "import time\n"
        "t0 = time.perf_counter()\n"
        "basis, ham = donor_acceptor_b(nfock=int(sys.argv[2]))\n"
        "ham.fused_mpo([b.nprim for b in basis])\n"
        "with open(sys.argv[1], 'wb') as fh:\n"
        "    pickle.dump((basis, ham), fh, protocol=4)\n"
        "print(time.perf_counter() - t0)\n"
    )

    def __init__(self):
        self.tmp = tempfile.TemporaryDirectory()
        self.path = os.path.join(self.tmp.name, "model_b.pkl")
        root = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ, OMP_NUM_THREADS="2",
                   PYTHONPATH=os.pathsep.join(
                       [root, os.environ.get("PYTHONPATH", "")]))
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-c", self.CODE, self.path, str(MODEL_B_NFOCK)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)

    def result(self):
        import pickle

        built, err = self.proc.communicate(timeout=900)
        require(self.proc.returncode == 0,
                f"model B build failed ({self.proc.returncode}): {err[-2000:]}")
        with open(self.path, "rb") as fh:
            out = pickle.load(fh)
        log(f"model B: built in a child process in {float(built):.1f} s, "
            f"taken {time.perf_counter() - self.t0:.1f} s after it started")
        return out

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.tmp.cleanup()


def krylov_census(engine) -> list:
    """Every Krylov call of one step of ``engine``: (kind, site, M, r,
    channels, route, cluster size, calls a step), the route ``"einsum"``
    where the channels do not fit the kernel (``cuda_lanczos.fits``: the
    Krylov program over the einsums, its control ``krylov_ctl``), else the
    Lanczos kernel's route and cluster size.  H steps run twice a step,
    the K step once each way."""
    from pytdscf_torch.mps import cuda_lanczos as CL

    kmax = engine.config.max_krylov
    rows, n = [], engine.nsite
    for p, core in enumerate(engine.cores[0]):
        l, d, r = core.shape
        wl, wr = engine.W[p].shape[0], engine.W[p].shape[-1]
        for kind, (M, rr, nc), k in (("H", (l * d, r, wr), 2),
                                     ("K", (r, r, wr), int(p < n - 1)),
                                     ("K", (l, l, wl), int(p > 0))):
            if not k:
                continue
            if CL.fits((M, rr), nc, kmax):
                way, size = CL.route(M, rr, nc), CL.cluster_size(M, rr, nc)
            else:
                way, size = "einsum", None
            rows.append((kind, p, M, rr, nc, way, size, k))
    return rows


def census_text(rows) -> str:
    """The census's calls a step by kind and route, and each site's H-step
    route and channel count."""
    tally: dict = {}
    for kind, _, _, _, _, way, size, k in rows:
        key = f"{kind} {route_tag(way, size) if way != 'einsum' else way}"
        tally[key] = tally.get(key, 0) + k
    sites = " ".join(
        f"{p}:{'e' if way == 'einsum' else 'b' if way == 'block' else size}"
        f"/{nc}" for kind, p, M, r, nc, way, size, _ in rows if kind == "H")
    return f"calls a step {tally}; H step site:route/channels {sites}"


def check_lanczos_site(tag: str, ch, v, scale, cfg) -> dict:
    """The Lanczos kernel on its own route against its plain version on
    one site's operands: the plain version's status, ‖Δψ‖ < LANCZOS_TOL, a
    second launch bit-identical; both timed, with the call's bound."""
    import torch

    from pytdscf_torch.mps import cuda_lanczos as CL

    nc, (M, r) = ch[0].shape[0], v.shape
    kmax = min(cfg.max_krylov, v.numel())
    args = (v, scale, cfg.thresh_exp, cfg.max_krylov, cfg.conserve_norm)
    out_k, st_k = CL.lanczos_expm(ch, *args)
    again, _ = CL.lanczos_expm(ch, *args)
    out_p, st_p = CL.lanczos_expm_plain(*ch, v, scale, cfg.thresh_exp, kmax,
                                        cfg.conserve_norm)
    torch.cuda.synchronize()
    way, size = CL.route(M, r, nc), CL.cluster_size(M, r, nc)
    dpsi = float(torch.linalg.vector_norm(out_k - out_p))
    err = float(torch.max(torch.abs(out_k - out_p)))
    require(bool(torch.isfinite(out_k).all()), f"{tag}: not finite")
    require(torch.equal(out_k, again), f"{tag}: a second launch gave "
            "another result")
    require(st_k.tolist() == st_p.tolist(), f"{tag}: kernel status "
            f"{st_k.tolist()} vs plain {st_p.tolist()}")
    require(dpsi < LANCZOS_TOL, f"{tag}: ‖Δψ‖ {dpsi:.3e}")
    ms = cuda_ms(lambda: CL.lanczos_expm(ch, *args), 20)
    plain_ms = cuda_ms(lambda: CL.lanczos_expm_plain(
        *ch, v, scale, cfg.thresh_exp, kmax, cfg.conserve_norm), 3)
    k_used = int(st_p[0])
    flops = 8.0 * k_used * nc * (M * r * r + M * M * r)
    case = {"case": tag, "shape": [M, r, nc], "route": way,
            "cluster_ctas": size, "k_used": k_used, "ms": ms,
            "plain_ms": plain_ms, "max_abs_err": err,
            **bound(flops, PEAK_FP32, nbytes(*ch, v, out_p))}
    log(f"{tag}: ({M}, {r}), {nc} channels, {route_tag(way, size)}: k_used "
        f"{k_used}, ‖Δψ‖ {dpsi:.3e}, max|Δ| {err:.3e}; repeat bit-identical; "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{case['bound_ms']:.2e} ms ({case['bound_by']})")
    return case


def centred_h_step(engine, p: int, dt_au: float, channels: bool = True):
    """The H step of site p with the centre moved there: the kernel's
    channels (None unless ``channels``), ψ (M, r) and the scale
    (−i·dt/2), with the operands ((L, lL), W, (R, lR), ψ)."""
    import torch

    from pytdscf_torch.mps import cuda_lanczos as CL

    (L, lL), W, (R, lR), psi, _ = centred_operands(engine, p)
    l, d, r = psi.shape
    ch = CL.heff_channels(L, W, R, torch.exp(lL + lR)) if channels else None
    return ch, psi.reshape(l * d, r).contiguous(), -0.5j * dt_au, (
        (L, lL), W, (R, lR), psi)


def initial_energy(model, bond: int) -> float:
    """⟨H⟩ of ``model``'s Hartree product on the card (complex64 state,
    contracted in complex128)."""
    from pytdscf_torch.config import Config
    from pytdscf_torch.mps.lattice import alloc_hartree_product
    from pytdscf_torch.mps.tdvp import TDVPEngine

    phys = [b.nprim for b in model.basinfo.prim_info[0]]
    vecs = [np.asarray(v, dtype=complex) for v in model.init_HartreeProduct[0]]
    cores = [alloc_hartree_product(phys, bond, vecs)]
    return TDVPEngine(cores, model.hamiltonian, Config(dtype="complex64"),
                      "cuda").expectation().real


def absorption_peak(job: str, omega_ev, spectra) -> tuple[float, float,
                                                          float]:
    """examples/pyrazine_s2_dynamics.py's spectrum of
    ``{job}_prop/autocorr.dat`` (damping 150 fs, its E_shift, the cos
    window) through the package module ``spectra``: the maximum in the
    220-280 nm window (nm, cm⁻¹) and the grid's spacing (cm⁻¹)."""
    t_fs, auto = spectra.load_autocorr(f"{job}_prop/autocorr.dat")
    damp = np.exp(-np.abs(t_fs) / 150.0)
    e0_ev = 0.5 * sum(omega_ev) - (3.94 + 4.89) / 2.0
    freq, inten = spectra.ifft_autocorr(t_fs, auto * damp, E_shift=e0_ev,
                                        window="cos")
    mask = freq > 0
    nm = 1.0e7 / freq[mask]
    sel = (nm > 220) & (nm < 280)
    i = int(np.argmax(inten[mask][sel]))
    return float(nm[sel][i]), float(freq[mask][sel][i]), float(
        abs(freq[1] - freq[0]))


def phase_pyrazine(times) -> dict:
    """Pyrazine's 24-mode QVC model through ``Simulator.propagate`` at the
    example's settings and the card's default stride 16 (graph replays),
    its ρ read from the engine (``reduced_density``: the GPU machine has no
    h5py for the .nc file).  Gates: the norm and the relative ⟨H⟩ drift
    within NORM_TOL and WF_E_DRIFT over the run, the autocorrelation of
    the first 40 fs within PYRAZINE_AC_TOL and the final S1/S2
    populations within PYRAZINE_POP_TOL of the gold, the absorption
    maximum within one bin of the gold's, no plain call; the first
    PYRAZINE_TRACED_STEPS steps again under the profiler, their launches
    as traced equal to the counters' and to the run's step for step,
    their rows equal to the run's; then the Lanczos kernel against its
    plain version at the bulk H step (the centre moved there), timed.
    Prints s/step, the busy share of a replayed block, peak memory and the
    launches by kernel and route."""
    import torch

    from pytdscf_torch import Model, Simulator, spectra
    from pytdscf_torch.models.pyrazine import OMEGA_EV, pyrazine_qvc

    tag = "pyrazine"
    basis, ham = pyrazine_qvc(nprim=PYRAZINE_NPRIM)
    model = Model(basis, {"hamiltonian": ham}, bond_dim=PYRAZINE_BOND)
    vac = [1.0] + [0.0] * (PYRAZINE_NPRIM - 1)
    model.init_HartreeProduct = [[[0.0, 1.0]] + [vac] * (len(basis) - 1)]
    e0 = initial_energy(model, PYRAZINE_BOND)
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            sim = Simulator(tag, model, verbose=0)
            (e_end, wf), wall, n, peak = timed_phase(
                f"{tag}: propagate ({PYRAZINE_STEPS} steps of "
                f"{PYRAZINE_DT} fs, stride 16)",
                lambda: sim.propagate(maxstep=PYRAZINE_STEPS,
                                      stepsize=PYRAZINE_DT, energy=True,
                                      autocorr=True))
            engine = wf.engine
            log(f"{tag}: {wall / PYRAZINE_STEPS:.5f} s/step (graph steps "
                f"{engine.graph_steps}, host steps {engine.eager_steps}; "
                f"{sim.diagnostics.report()}); peak "
                f"{peak / 2**20:.1f} MiB; launches {launch_text(n)}")
            require(engine.graph_steps > PYRAZINE_STEPS // 2,
                    f"{tag}: {engine.graph_steps} replayed steps")
            pops = np.loadtxt(f"{tag}_prop/populations.dat")[:, 1]
            drift_n = float(np.max(np.abs(pops - 1.0)))
            drift_e = abs(e_end - e0) / abs(e0)
            rho = engine.reduced_density((2,))
            s1, s2 = float(rho[0, 0].real), float(rho[1, 1].real)
            gold = GOLD_PYRAZINE
            gap = max(abs(s1 - gold["pops"][0]), abs(s2 - gold["pops"][1]))
            _, first = dat_rows(f"{tag}_prop/autocorr.dat")
            rows = list(PYRAZINE_AC_ROWS)
            ac_gap = float(np.max(np.abs(first[rows, 1] + 1j * first[rows, 2]
                                         - np.asarray(GOLD_PYRAZINE_AC))))
            nm, peak_f, res = absorption_peak(tag, OMEGA_EV, spectra)
            log(f"{tag}: ⟨H⟩ {e0!r} at the start, {e_end!r} at the end "
                f"(relative drift {drift_e:.3e}); max |norm² − 1| "
                f"{drift_n:.3e} over {len(pops)} rows; autocorrelation of "
                f"the first 40 fs (rows {rows[0]}-{rows[-1]}) |Δ| "
                f"{ac_gap:.3e} from gold (bar {PYRAZINE_AC_TOL}); final "
                f"populations S1 "
                f"{s1:.9f} S2 {s2:.9f} (gold {gold['pops'][0]:.9f} "
                f"{gold['pops'][1]:.9f}, |Δ| {gap:.3e}, bar "
                f"{PYRAZINE_POP_TOL}); absorption maximum {nm:.2f} nm = "
                f"{peak_f:.2f} cm⁻¹ (gold {gold['peak_nm']:.2f} nm = "
                f"{gold['peak_cm1']:.2f}, grid {res:.2f} cm⁻¹)")
            require(drift_n < NORM_TOL and drift_e < WF_E_DRIFT,
                    f"{tag}: norm² drift {drift_n:.3e} (bar {NORM_TOL}), "
                    f"⟨H⟩ drift {drift_e:.3e} (bar {WF_E_DRIFT})")
            require(ac_gap <= PYRAZINE_AC_TOL, f"{tag}: autocorrelation of "
                    f"the first 40 fs {ac_gap:.3e} from gold")
            require(gap <= PYRAZINE_POP_TOL, f"{tag}: populations {s1}, "
                    f"{s2} vs gold {gold['pops']}")
            require(abs(peak_f - gold["peak_cm1"]) <= gold["bin_cm1"] * 1.0001,
                    f"{tag}: absorption maximum {peak_f} vs gold "
                    f"{gold['peak_cm1']} (one bin {gold['bin_cm1']})")
            # ---- the run's launches are the counters' accounting of its
            # replays: its first steps again under the profiler hold that
            # accounting to what the card launched, step for step
            nt = PYRAZINE_TRACED_STEPS
            (_, wf_t), busy_t, _ = traced_run(
                f"{tag}: propagate again ({nt} steps)",
                lambda: Simulator(f"{tag}_traced", model, verbose=0).propagate(
                    maxstep=nt, stepsize=PYRAZINE_DT, energy=True,
                    autocorr=True), n, (nt, PYRAZINE_STEPS))
            _, again = dat_rows(f"{tag}_traced_prop/autocorr.dat")
            row_gap = float(np.max(np.abs(again - first[:nt])))
            log(f"{tag}: its first {nt} steps again under the profiler "
                f"(graph steps {wf_t.engine.graph_steps}): device "
                f"{100 * busy_t:.1f} % busy, launches as traced equal to the "
                f"run's step for step, autocorrelation within {row_gap:.2e} "
                "of the run's")
            require(wf_t.engine.graph_steps > nt // 2,
                    f"{tag}: {wf_t.engine.graph_steps} replayed steps in the "
                    "traced run")
            require(row_gap <= ROW_TOL, f"{tag}: the traced run's "
                    f"autocorrelation {row_gap:.2e} from the run's")
            case = check_lanczos_site(
                f"{tag} lanczos H step, site {PYRAZINE_BULK}",
                *centred_h_step(engine, PYRAZINE_BULK, fs(PYRAZINE_DT))[:3],
                engine.config)
            times.setdefault("a4_lanczos", []).append(case)
            record_step_shapes(tag, engine, lambda: engine.propagate(
                fs(PYRAZINE_DT)), times)
            engine.propagate_steps(fs(PYRAZINE_DT), 16)  # its program
            busy = profile_run(lambda: engine.propagate_steps(
                fs(PYRAZINE_DT), 16))
            log(f"{tag}: a block of 16 replayed steps keeps the device "
                f"{100 * busy:.1f} % busy")
            times["a4_runs"][tag] = {
                "s_per_step": wall / PYRAZINE_STEPS, "busy": busy,
                "peak_mib": peak / 2**20}
        finally:
            os.chdir(cwd)
    torch.cuda.empty_cache()
    return {**workflow_path(n), "lanczos_expm": (n["lanczos_expm"],
                                                 case["max_abs_err"])}


def level_pops(wf, ops) -> list[float]:
    return [float(wf.expectation(ops[f"N{k}"])) for k in range(len(ops))]


def phase_model_b(times, build) -> dict:
    """Donor–acceptor model B through ``Simulator.propagate`` at the
    example's settings (observables every 10 steps: each step host-driven,
    as in the JAX package), MODEL_B_STEPS steps: the per-site route census of its
    Krylov calls (einsum program, one block, cluster), the Lanczos
    launches of the run equal to the census's, ``krylov_ctl`` launched;
    the 26 level populations after step 10 within MODEL_B_POP_TOL of the
    gold, their sums within POP_SUM_TOL of 1; then
    each route on its own operands (the centre moved to the site): the
    Lanczos kernel against its plain version at a one-block and a cluster
    site, timed; the einsum program's control step (``krylov_ctl``)
    against its plain version, the call timed; MGS at the (560, 20)
    gauge; then, without observables, a replayed step under the profiler
    against the same step driven from the host (Krylov statistics equal;
    the launches of the Lanczos and MGS kernels, which run outside the
    step's IF nodes, as traced equal to the host step's, those of
    ``krylov_ctl`` as counted on the device; the populations within
    REPLAY_POP_TOL) and MODEL_B_REPLAYS timed replays."""
    import torch

    from pytdscf_torch import Model, Simulator
    from pytdscf_torch.models.donor_acceptor import electron_level_projectors
    from pytdscf_torch.mps import cuda_krylov as CK
    from pytdscf_torch.mps.tdvp import TDVPEngine, _einsum_expm

    tag = "model B"
    basis, ham = build.result()
    ops = electron_level_projectors(basis)
    model = Model(basis, {"hamiltonian": ham, **ops},
                  bond_dim=MODEL_B_BOND)
    n_frag = basis[0].nprim // 2
    ele0 = [0.0] * n_frag + [1.0] + [0.0] * (n_frag - 1)
    vac = [1.0] + [0.0] * (MODEL_B_NFOCK - 1)
    model.init_HartreeProduct = [[ele0] + [vac] * (len(basis) - 1)]
    dt = fs(MODEL_B_DT)
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            sim = Simulator("model_b", model, verbose=0)
            (e_end, wf), wall, n, peak = timed_phase(
                f"{tag}: propagate ({MODEL_B_STEPS} steps of {MODEL_B_DT} "
                f"fs, observables every {MODEL_B_EVERY})",
                lambda: sim.propagate(
                    maxstep=MODEL_B_STEPS, stepsize=MODEL_B_DT, energy=True,
                    autocorr=False, observables=True,
                    observables_per_step=MODEL_B_EVERY))
            n_ctl = CK.krylov_ctl.launches
            engine = wf.engine
            rows = krylov_census(engine)
            per_step = sum(k for *_, way, _, k in rows if way != "einsum")
            log(f"{tag}: {engine.nsite} sites; census: {census_text(rows)}")
            log(f"{tag}: host-driven {wall / MODEL_B_STEPS:.4f} s/step with "
                f"observables ({sim.diagnostics.report()}); peak "
                f"{peak / 2**20:.1f} MiB; launches {launch_text(n)}, "
                f"krylov_ctl {n_ctl}")
            require(engine.eager_steps == MODEL_B_STEPS
                    and engine.graph_steps == 0,
                    f"{tag}: {engine.graph_steps} replayed steps with "
                    "observables on")
            require(n["lanczos_expm"] == per_step * MODEL_B_STEPS,
                    f"{tag}: {n['lanczos_expm']} Lanczos launches, the census "
                    f"says {per_step} a step")
            require(n_ctl > 0, f"{tag}: no krylov_ctl launch on the einsum "
                    "sites")
            got = {str(MODEL_B_STEPS): level_pops(wf, ops)}
            for step, pops in got.items():
                gap = float(np.max(np.abs(np.asarray(pops)
                                          - GOLD_MODEL_B[step])))
                total = float(np.sum(pops))
                log(f"{tag}: level populations at step {step}: max |Δ| from "
                    f"gold {gap:.3e} (bar {MODEL_B_POP_TOL}), sum {total!r}; "
                    f"LE₁ {pops[n_frag]:.6f}, CS₁ {pops[n_frag - 1]:.6f}")
                require(gap <= MODEL_B_POP_TOL, f"{tag}: populations at "
                        f"step {step} {gap:.3e} from gold")
                require(abs(total - 1.0) <= POP_SUM_TOL,
                        f"{tag}: populations at step {step} sum to {total}")
            # ---- each route on its own operands
            cases, err = {}, 0.0
            for way in ("block", "cluster", "einsum"):
                # the route's widest H step (model B's bulk, M = 560)
                p = max((row for row in rows
                         if row[0] == "H" and row[5] == way),
                        key=lambda row: (row[2], -row[1]))[1]
                ch, v, scale, (L, W, R, psi) = centred_h_step(
                    engine, p, dt, channels=way != "einsum")
                if way != "einsum":
                    case = check_lanczos_site(
                        f"{tag} lanczos H step, site {p}", ch, v, scale,
                        engine.config)
                    err = max(err, case["max_abs_err"])
                    times.setdefault("a4_lanczos", []).append(case)
                    cases[way] = case["ms"]
                    continue
                (Lb, lL), (Rb, lR) = L, R
                hfac = torch.exp(lL + lR)
                cfg = engine.config

                def call():
                    return _einsum_expm(psi, scale, hfac, cfg, Lb, Rb, W)
                recs = record_ctl(call)
                ctl = {}
                err_ctl = check_krylov_ctl(recs, ctl, f"{tag} site {p}",
                                           gap_edge=True)
                cases[way] = cuda_ms(call, 5)
                log(f"{tag}: einsum H step at site {p} ({psi.shape}, "
                    f"{W.shape[-1]} channels): {cases[way]:.4f} ms a call, "
                    f"{len(recs)} control steps")
                times["a4_krylov_ctl"] = {**ctl["krylov_ctl"], "site": p}
            times["a4_model_b_routes"] = cases
            p = next(p for kind, p, M, *_ in rows if kind == "H" and M == 560)
            m = centred_operands(engine, p)[3].reshape(560, -1).contiguous()
            err_q, _, qcase = check_mgs(f"{tag} gauge, site {p}", m,
                                        timed=True)
            times["a4_mgs"] = qcase
            # ---- replayed against host-driven, observables off
            g = TDVPEngine(engine.to_numpy(), model.hamiltonian,
                           engine.config, "cuda")
            require(g.capturable(), f"{tag}: a step is not capturable")
            t0 = time.perf_counter()
            g.propagate_steps(dt, 1)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            (prog,) = g._programs.values()
            restore = program_snapshot(g)
            _, busy, n_g = traced_run(
                f"{tag}: one replayed step",
                lambda: (restore(), g.propagate_steps(dt, 1)))
            stats_g, ctl_g = g.krylov_stats(), CK.krylov_ctl.launches
            pops_g = [float(g.expectation(ops[f"N{k}"]).real)
                      for k in range(len(ops))]
            restore()
            t0 = time.perf_counter()
            record_step_shapes(tag, g, lambda: g.propagate(dt), times)
            torch.cuda.synchronize()
            host_s = time.perf_counter() - t0
            stats_h, ctl_h = g.krylov_stats(), CK.krylov_ctl.launches
            n_h = counted_launches()
            pops_h = [float(g.expectation(ops[f"N{k}"]).real)
                      for k in range(len(ops))]
            gap = max(abs(a - b) for a, b in zip(pops_g, pops_h))
            log(f"{tag}: one step replayed, Krylov {stats_g}, launches as "
                f"traced {launch_text(n_g)}, krylov_ctl {ctl_g} on the "
                f"device; host-driven ({host_s:.4f} s), Krylov {stats_h}, "
                f"launches {launch_text(n_h)}, krylov_ctl {ctl_h}; "
                f"populations max |Δ| {gap:.3e}; the replay keeps the device "
                f"{100 * busy:.1f} % busy")
            require(stats_g == stats_h, f"{tag}: replayed Krylov statistics "
                    f"{stats_g} != host-driven {stats_h}")
            require(n_g == n_h and ctl_g == ctl_h, f"{tag}: replayed "
                    f"launches {launch_text(n_g)}, krylov_ctl {ctl_g} != "
                    f"host-driven {launch_text(n_h)}, krylov_ctl {ctl_h}")
            require(gap <= REPLAY_POP_TOL, f"{tag}: replayed populations "
                    f"{gap:.3e} from the host-driven step's")
            restore()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            g.propagate_steps(dt, MODEL_B_REPLAYS)
            torch.cuda.synchronize()
            step_s = (time.perf_counter() - t0) / MODEL_B_REPLAYS
            n_r = rp_launches()
            log(f"{tag}: host step and capture {first_s:.3f} s (capture "
                f"{prog.capture_s:.3f} s); {MODEL_B_REPLAYS} replays "
                f"{step_s:.4f} s/step, launches {n_r}, peak "
                f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
            times["a4_runs"]["model_b"] = {
                "host_s_per_step": wall / MODEL_B_STEPS,
                "host_step_s": host_s, "replay_s_per_step": step_s,
                "busy": busy, "peak_mib": peak / 2**20}
        finally:
            os.chdir(cwd)
    del g, engine, wf
    torch.cuda.empty_cache()
    return {**workflow_path(n), "lanczos_expm": (n["lanczos_expm"], err),
            "mgs_qr": (n["mgs_qr"], err_q), "krylov_ctl": (n_ctl, err_ctl)}


def henon_heiles_terms(w: float, lam: float, f: int) -> dict:
    """tests/test_henon_heiles.py's mass-weighted nMR components:
    V = Σ w²Qᵢ²/2 + λ w^{3/2} (Σ Qᵢ²Qᵢ₊₁ − Qᵢ₊₁³/3)."""
    funcs = {(0,): lambda q: w**2 / 2 * q**2}
    for i in range(1, f):
        funcs[(i,)] = lambda q: w**2 / 2 * q**2 - lam * w**1.5 / 3 * q**3
        funcs[(i - 1, i)] = lambda qa, qb: lam * w**1.5 * qa**2 * qb
    return funcs


def phase_dvr() -> dict:
    """The DVR grid models and an SOP model at their tests' sizes through
    ``Simulator.propagate`` on the card (complex64, stride 16): Hénon–Heiles
    in both parameter sets (``construct_nMR_recursive`` and the kinetic
    MPO), energy within DVR_E_TOL of the literals; H2CO's 6-mode SOP model
    (``potentials.ch2o_k_orig``), e10 − e0 within DVR_E_TOL and the norm.
    Each run goes under the profiler (:func:`traced_run`): a run of more
    than one step replays, and its launches are those traced."""
    from pytdscf_torch import Model, Simulator, units
    from pytdscf_torch.basis import HarmonicOscillator, PrimBas_HO
    from pytdscf_torch.model import BasInfo
    from pytdscf_torch.operators.dvr import (construct_kinetic_mpo,
                                             construct_nMR_recursive)
    from pytdscf_torch.operators.sop import read_potential_nMR
    from pytdscf_torch.potentials import ch2o_k_orig

    total: dict = {}
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            for key, (omega, lam, f, ngrid, bond, dt, lit) in (
                    HENON_HEILES.items()):
                prims = [HarmonicOscillator(ngrid, omega) for _ in range(f)]
                pot = construct_nMR_recursive(
                    prims, nMR=2, rate=0.99999999999,
                    func=henon_heiles_terms(omega / units.au_in_cm1, lam, f))
                model = Model(prims, {"potential": pot,
                                      "kinetic": construct_kinetic_mpo(prims)},
                              bond_dim=bond)
                gs = [1.0] + [0.0] * (ngrid - 1)
                es = [0.0, 1.0] + [0.0] * (ngrid - 2)
                model.init_weight_VIBSTATE = [[es] + [gs] * (f - 1)]
                (energy, _), _, n = traced_run(
                    f"dvr: Hénon–Heiles {key}", lambda: Simulator(
                        f"hh_{key}", model, verbose=0).propagate(
                            maxstep=3, stepsize=dt))
                log(f"dvr: Hénon–Heiles {key}: ⟨H⟩ {energy!r} (literal "
                    f"{lit!r}, |Δ| {abs(energy - lit):.3e}, bar {DVR_E_TOL})")
                require(abs(energy - lit) <= DVR_E_TOL,
                        f"dvr: Hénon–Heiles {key} ⟨H⟩ {energy} vs {lit}")
                _add_counts(total, n)
            prim = [[PrimBas_HO(0.0, math.sqrt(ch2o_k_orig[(i, i)])
                                * units.au_in_cm1, 6) for i in range(1, 7)]]
            model = Model(BasInfo(prim), {"hamiltonian": read_potential_nMR(
                ch2o_k_orig)}, bond_dim=6)
            sim = Simulator("h2co", model, verbose=0)
            (e0, _), _, n0 = traced_run(
                "dvr: H2CO (1 step)", lambda: sim.propagate(maxstep=1,
                                                           stepsize=0.1))
            (e10, wf), _, n10 = traced_run(
                "dvr: H2CO (10 steps)", lambda: sim.propagate(maxstep=10,
                                                             stepsize=0.1))
            norm = wf.norm()
            log(f"dvr: H2CO e0 {e0!r}, e10 {e10!r} (|Δ| {abs(e10 - e0):.3e}, "
                f"bar {DVR_E_TOL}); norm {norm!r}")
            require(abs(e10 - e0) <= DVR_E_TOL and abs(norm - 1) < NORM_TOL,
                    f"dvr: H2CO e10 {e10} vs e0 {e0}, norm {norm}")
            _add_counts(total, n0)
            _add_counts(total, n10)
        finally:
            os.chdir(cwd)
    return workflow_path(total)


def phase_one_state_models(times, build) -> list:
    """Phases 16-18: pyrazine, donor–acceptor model B, the DVR models."""
    times["a4_runs"] = {}
    paths = [phase_pyrazine(times), phase_model_b(times, build)]
    paths.append(phase_dvr())
    return paths


def phase_ambrosek(times) -> dict:
    """The Ambrosek aggregate's five cases (tests/test_relax_operate.py)
    through the port's entry points on the card in complex64: imaginary
    relaxation and propagation (the default stride 16: a host step, the
    capture and replays), both again from ``proj_gs``'s projected start
    under the coupled Hamiltonian, and improved relaxation to the ZPE
    (``integrator.ground_state_multi`` over the pair sums).  Each energy
    within its bar (AMBROSEK_BARS) of its literal; no Lanczos, fused-site
    or ground-state kernel launch, one MGS launch a state a gauge move, no
    plain call.  Then ``operate`` with the transition dipole
    (:func:`ambrosek_dipole`, two state pairs) on the improved ground
    state, held to the same on the CPU in complex128 (run after the
    card's counted window: the CPU takes the plain versions)."""
    from pytdscf_torch import Simulator
    from pytdscf_torch.mps import cuda_krylov as CK

    total: dict = {}
    n_ctl = 0
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            for case, (kind, coupled, bond, proj_gs, steps, dt, _) in (
                    AMBROSEK.items()):
                tag = f"ambrosek {case}"
                model = ambrosek_model("pytdscf_torch", coupled, bond,
                                       proj_gs, excited=kind == "improved")
                sim = Simulator(f"amb_{case}", model, proj_gs=proj_gs,
                                verbose=0)
                if kind == "propagate":
                    def run():
                        return sim.propagate(maxstep=steps, stepsize=dt)
                else:
                    def run():
                        return sim.relax(maxstep=steps, stepsize=dt,
                                         improved=kind == "improved")
                (energy, wf), wall, n, _ = timed_phase(tag, run)
                ctl = CK.krylov_ctl.launches
                engine = wf.engine
                literal = ambrosek_literal(case)
                gap = abs(energy - literal)
                # sites 4, 2 states: one gauge move a state at each site
                # but the last, each way, each step (the Simulator's first
                # step of a block runs from the host, a replay of the rest)
                moves = engine.nstate * (engine.nsite - 1) * 2 * steps
                log(f"{tag}: ⟨H⟩ {energy!r}, literal {literal!r}, |Δ| "
                    f"{gap:.3e} (bar {AMBROSEK_BARS[case]:.3e}); {wall:.3f} s "
                    f"({engine.eager_steps} host, {engine.graph_steps} "
                    f"replayed steps), populations {wf.pop_states()}; "
                    f"launches mgs_qr {n['mgs_qr']}, krylov_ctl {ctl}")
                require(gap <= AMBROSEK_BARS[case], f"{tag}: ⟨H⟩ {energy} vs "
                        f"{literal} (bar {AMBROSEK_BARS[case]})")
                require(engine.nstate == 2 and engine.pairset is not None,
                        f"{tag}: {engine.nstate} states")
                require(n["lanczos_expm"] == n["site_step"]
                        == n["lanczos_gs"] == 0, f"{tag}: a one-state kernel "
                        f"ran: {launch_text(n)}")
                require(n["mgs_qr"] == moves, f"{tag}: {n['mgs_qr']} MGS "
                        f"launches, {moves} gauge moves")
                require(kind == "improved" or ctl > 0,
                        f"{tag}: no krylov_ctl launch")
                _add_counts(total, n)
                n_ctl += ctl
            # ---- operate: μ on the improved case's ground state
            tag = "ambrosek operate"
            model = ambrosek_dipole("pytdscf_torch", AMBROSEK_MU)

            def operate(dev):
                return Simulator("amb_improved", model, verbose=0,
                                 device=dev).operate(restart=True,
                                                     loadfile_ext="_gs")
            (norm, wf), wall, n, _ = timed_phase(tag, lambda: operate("cuda"))
            pops = wf.pop_states()
            norm_p, wf_p = operate("cpu")
            pops_p = wf_p.pop_states()
            reset_counts()
            gap = max(abs(norm - norm_p) / norm_p,
                      *(abs(a - b) for a, b in zip(pops, pops_p)))
            log(f"{tag}: ‖μ|Ψ⟩‖ {norm!r} (complex128 on the CPU {norm_p!r}), "
                f"populations {pops} ({pops_p}), largest |Δ| {gap:.3e} (bar "
                f"{AMBROSEK_OPERATE_TOL}); {wall:.3f} s, mgs_qr "
                f"{n['mgs_qr']} launches")
            require(gap <= AMBROSEK_OPERATE_TOL, f"{tag}: ‖μ|Ψ⟩‖ {norm} and "
                    f"populations {pops} vs {norm_p}, {pops_p}")
            require(n["mgs_qr"] > 0 and n["lanczos_expm"] == 0,
                    f"{tag}: launches {launch_text(n)}")
            _add_counts(total, n)
        finally:
            os.chdir(cwd)
    out = workflow_path(total)
    out["krylov_ctl"] = (n_ctl, None)
    return out


def multi_centred(engine, p: int):
    """The operands of site p of a several-state engine with every
    state's centre moved there (``qr_right`` over sites 0..p−1 of a copy of
    the cores): ``((Ls, lLs), (Rs, lRs))`` per pair group, the groups'
    MPO cores at the site, and the states' site tensors."""
    import torch

    from pytdscf_torch.mps import kernels as K
    from pytdscf_torch.mps import pairs as P

    cores = [[c.clone() for c in state] for state in engine.cores]
    for state in cores:
        for q in range(p):
            a, sig = K.qr_right(state[q])
            state[q] = a
            state[q + 1] = K.absorb_right(sig, state[q + 1])
    groups = engine.pairset.groups

    def blocks(sites, forward):
        b, lg = (list(x) for x in engine._trivial_multi())
        for q in sites:
            site = torch.stack([state[q] for state in cores])
            for k, g in enumerate(groups):
                b[k], lg[k] = P.normalize(
                    P.transfer(g, b[k], site, g.W[q], forward), lg[k])
        return b, lg

    env = (blocks(range(p), True),
           blocks(range(engine.nsite - 1, p, -1), False))
    return env, [g.W[p] for g in groups], [state[p] for state in cores]


def kernel_launches(run) -> int:
    """The kernels the card ran for ``run()`` (host-driven: every launch
    is the host's), as a profiler trace counts them between two marker
    kernels (:func:`profile_run`'s bracket: a trace can lose the first
    kernels of a session; one that lost a marker is taken again)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run()
    for _ in range(TRACE_ATTEMPTS):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(TRACE_SETTLE_S)
            one = torch.zeros((), device="cuda")
            for _ in range(TRACE_PRIME):
                one.add_(1.0)
            torch.cuda.synchronize()
            torch.cuda._sleep(MARK_CYCLES)
            torch.cuda.synchronize()
            run()
            torch.cuda.synchronize()
            torch.cuda._sleep(MARK_CYCLES)
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as fh:
                kernels = [(float(e["ts"]), e.get("name", "")) for e in
                           json.load(fh)["traceEvents"]
                           if e.get("cat") == "kernel"]
        marks = [ts for ts, name in kernels if MARKER + "(" in name]
        if len(marks) == 2:
            n = sum(marks[0] < ts < marks[1] for ts, _ in kernels)
            require(n > 0, "kernel_launches: no kernel between the markers")
            return n
        log(f"kernel_launches: {len(marks)} marker kernels traced; again")
    raise SmokeFailure(f"kernel_launches: {TRACE_ATTEMPTS} traces each lost "
                       "a marker kernel")


def phase_lh2(times) -> dict:
    """The 27-state LH2 exciton model (189 state pairs, 27 × 27 sites)
    through ``Simulator.propagate`` on the card in complex64, LH2_STEPS
    steps of LH2_DT fs host-driven (``fetch_stride`` 1): every
    ``populations.dat`` row and the final populations within LH2_POP_TOL
    of scripts/a3_gold.py's gold, their sums within POP_SUM_TOL of 1, ⟨H⟩
    after the last step within LH2_E_TOL (relative) of the gold's; no
    Lanczos, fused-site or ground-state launch, 27 MGS launches a gauge
    move, one ``krylov_ctl`` launch a Krylov iteration, no plain call.
    Then at the bulk site (the centre moved there): launches of one H_eff
    and one K_eff pair-sum matvec, ``krylov_ctl`` against its plain
    version on the H step's own control steps, timed; MGS at the path's
    gauge shapes, a live core and a state with no weight (every column a
    dead-column completion), timed beside ``torch.linalg.qr``.  Then the
    end state on a fresh engine: a host step and the capture, one
    replayed step under the profiler against the same step host-driven
    (Krylov statistics, launches, populations within REPLAY_POP_TOL) and
    LH2_REPLAYS timed replays (s/step, busy share, peak memory)."""
    import torch

    from pytdscf_torch import Simulator
    from pytdscf_torch.mps import cuda_krylov as CK
    from pytdscf_torch.mps import pairs as P
    from pytdscf_torch.mps.tdvp import TDVPEngine, _multi_expm

    tag = "lh2"
    t0 = time.perf_counter()
    model = lh2_model("pytdscf_torch")
    built = time.perf_counter() - t0
    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, LH2_GOLD)) as fh:
        gold = json.load(fh)
    require(gold["steps"] >= LH2_STEPS and gold["dt_fs"] == LH2_DT
            and gold["bond"] == LH2_BOND, f"{tag}: the gold's settings "
            f"{gold['steps']} steps of {gold['dt_fs']} fs, D={gold['bond']}")
    dt = fs(LH2_DT)
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            sim = Simulator(tag, model, verbose=0)
            (_, wf), wall, n, peak = timed_phase(
                f"{tag}: propagate ({LH2_STEPS} steps of {LH2_DT} fs, "
                "host-driven)", lambda: sim.propagate(
                    maxstep=LH2_STEPS, stepsize=LH2_DT, fetch_stride=1))
            n_ctl = CK.krylov_ctl.launches
            engine = wf.engine
            kry, calls, capped, _ = engine.krylov_stats(reset=False)
            nst, nsite = engine.nstate, engine.nsite
            groups = engine.pairset.groups
            log(f"{tag}: {nst} states, {nsite} sites, {len(engine.pairs)} "
                f"pairs in {len(groups)} groups (MPO widths "
                f"{[int(g.W[1].shape[1]) for g in groups]}, "
                f"{[len(g) for g in groups]} pairs), built in {built:.1f} s; "
                f"host-driven {wall / LH2_STEPS:.4f} s/step "
                f"({sim.diagnostics.report()}); peak {peak / 2**20:.1f} MiB; "
                f"Krylov mean {kry:.3f} over {calls} calls ({capped} capped); "
                f"launches {launch_text(n)}, krylov_ctl {n_ctl}")
            require(engine.eager_steps == LH2_STEPS and engine.graph_steps == 0,
                    f"{tag}: {engine.graph_steps} replayed steps at stride 1")
            require(n["lanczos_expm"] == n["site_step"] == n["lanczos_gs"]
                    == 0, f"{tag}: a one-state kernel ran: {launch_text(n)}")
            moves = nst * (nsite - 1) * 2 * LH2_STEPS
            require(n["mgs_qr"] == moves, f"{tag}: {n['mgs_qr']} MGS launches, "
                    f"{moves} gauge moves")
            require(n_ctl == round(kry * calls), f"{tag}: {n_ctl} krylov_ctl "
                    f"launches, {round(kry * calls)} Krylov iterations")
            rows = np.loadtxt(f"{tag}_prop/populations.dat", ndmin=2)[:, 1:]
            pops = np.vstack([rows, [wf.pop_states()]])
            want = np.asarray(gold["pops"][:LH2_STEPS + 1])
            gaps = np.max(np.abs(pops - want), axis=1)
            sums = np.abs(pops.sum(axis=1) - 1.0)
            e_end = float(engine.expectation().real)
            e_gold = gold["energies"][LH2_STEPS]
            e_gap = abs(e_end - e_gold) / abs(e_gold)
            log(f"{tag}: populations max |Δ| from gold {float(gaps.max()):.3e}"
                f" (bar {LH2_POP_TOL}; by step "
                f"{[float(f'{g:.2e}') for g in gaps]}); state 0 "
                f"{pops[-1, 0]:.9f} (gold {want[-1, 0]:.9f}), max |Σ − 1| "
                f"{float(sums.max()):.3e}; ⟨H⟩ {e_end!r} (gold {e_gold!r}, "
                f"relative |Δ| {e_gap:.3e}, bar {LH2_E_TOL})")
            require(float(gaps.max()) <= LH2_POP_TOL,
                    f"{tag}: populations {float(gaps.max()):.3e} from gold")
            require(float(sums.max()) <= POP_SUM_TOL,
                    f"{tag}: populations sum to 1 ± {float(sums.max()):.3e}")
            require(e_gap <= LH2_E_TOL, f"{tag}: ⟨H⟩ {e_end} vs gold {e_gold}")
            # ---- the bulk site: launches a matvec, the kernels there
            p = nsite // 2
            ((Ls, lLs), (Rs, lRs)), W, psis = multi_centred(engine, p)
            x = torch.stack(psis)
            shape = tuple(x.shape[1:])
            hfacs = [torch.exp(a + b) for a, b in zip(lLs, lRs)]
            hmv = P.matvec(groups, Ls, W, Rs, hfacs, nst, shape)
            kmv = P.matvec(groups, Ls, None, Ls, hfacs, nst, shape[::2])
            v, s = x.reshape(-1), torch.randn(
                nst * shape[0] * shape[2], dtype=x.dtype, device=x.device)
            per_h = kernel_launches(lambda: hmv(v))
            per_k = kernel_launches(lambda: kmv(s))
            h_ms = cuda_ms(lambda: hmv(v), 20)
            log(f"{tag}: one pair-sum matvec at site {p} ({nst}, {shape}) "
                f"launches {per_h} kernels (H_eff; {h_ms:.4f} ms) and {per_k} "
                f"(K_eff), host-driven, for {len(engine.pairs)} pairs")
            cfg = engine.config
            recs = record_ctl(lambda: _multi_expm(
                v, shape, -0.5j * dt, hfacs, cfg, groups, Ls, Rs, W))
            ctl = {}
            err_ctl = check_krylov_ctl(recs, ctl, f"{tag} site {p}",
                                       gap_edge=True)
            times["a3_krylov_ctl"] = {**ctl["krylov_ctl"], "site": p,
                                      "launches_per_matvec": {"H": per_h,
                                                              "K": per_k}}
            err_q = 0.0
            cases = []
            M, r = shape[0] * shape[1], shape[2]
            for name, m in (
                    (f"bulk, state 0, site {p}", psis[0].reshape(M, r)),
                    (f"bulk, state {nst - 1}, site {p}",
                     psis[-1].reshape(M, r)),
                    ("bulk, a state with no weight",
                     torch.zeros((M, r), dtype=x.dtype, device=x.device)),
                    ("edge, state 0, site 0",
                     engine.cores[0][0].reshape(-1, r))):
                err, _, case = check_mgs(f"{tag} {name}", m.contiguous(),
                                         timed=True)
                err_q = max(err_q, err)
                cases.append({**case, "case": name})
            times["a3_mgs"] = cases
            shapes = mgs_launch_shapes(lambda: engine.propagate(dt))
            times["mgs_step_shapes"][tag] = shape_counts(shapes)
            require(len(shapes) == nst * (nsite - 1) * 2,
                    f"{tag}: {len(shapes)} MGS launches a step")
            log(f"{tag}: MGS launches of one host-driven step by shape "
                f"{times['mgs_step_shapes'][tag]}")
            # ---- replayed against host-driven
            g = TDVPEngine(engine.to_numpy(), model.hamiltonian, cfg, "cuda")
            require(g.capturable(), f"{tag}: a step is not capturable")
            t0 = time.perf_counter()
            g.propagate_steps(dt, 1)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            (prog,) = g._programs.values()
            restore = program_snapshot(g)
            _, busy, n_g = traced_run(
                f"{tag}: one replayed step",
                lambda: (restore(), g.propagate_steps(dt, 1)))
            stats_g, ctl_g = g.krylov_stats(), CK.krylov_ctl.launches
            pops_g = g.pop_states()
            restore()
            t0 = time.perf_counter()
            g.propagate(dt)
            torch.cuda.synchronize()
            host_s = time.perf_counter() - t0
            stats_h, ctl_h = g.krylov_stats(), CK.krylov_ctl.launches
            n_h = counted_launches()
            pops_h = g.pop_states()
            gap = max(abs(a - b) for a, b in zip(pops_g, pops_h))
            log(f"{tag}: one step replayed, Krylov {stats_g}, launches as "
                f"traced {launch_text(n_g)}, krylov_ctl {ctl_g} on the "
                f"device; host-driven ({host_s:.4f} s), Krylov {stats_h}, "
                f"launches {launch_text(n_h)}, krylov_ctl {ctl_h}; "
                f"populations max |Δ| {gap:.3e}; the replay keeps the device "
                f"{100 * busy:.1f} % busy")
            require(stats_g == stats_h, f"{tag}: replayed Krylov statistics "
                    f"{stats_g} != host-driven {stats_h}")
            require(n_g == n_h and ctl_g == ctl_h, f"{tag}: replayed "
                    f"launches {launch_text(n_g)}, krylov_ctl {ctl_g} != "
                    f"host-driven {launch_text(n_h)}, krylov_ctl {ctl_h}")
            require(gap <= REPLAY_POP_TOL, f"{tag}: replayed populations "
                    f"{gap:.3e} from the host-driven step's")
            restore()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            g.propagate_steps(dt, LH2_REPLAYS)
            torch.cuda.synchronize()
            step_s = (time.perf_counter() - t0) / LH2_REPLAYS
            n_r = rp_launches()
            require(plain_calls() == 0, f"{tag}: {plain_calls()} plain calls "
                    "in the replays")
            require(abs(sum(g.pop_states()) - 1.0) <= POP_SUM_TOL,
                    f"{tag}: replayed populations sum to {sum(g.pop_states())}")
            replay_peak = torch.cuda.max_memory_allocated() - base
            log(f"{tag}: host step and capture {first_s:.3f} s (capture "
                f"{prog.capture_s:.3f} s); {LH2_REPLAYS} replays "
                f"{step_s:.4f} s/step, launches {n_r}, peak "
                f"{replay_peak / 2**20:.1f} MiB above the "
                f"{base / 2**20:.1f} MiB allocated before")
            times["a3_runs"] = {
                "host_s_per_step": wall / LH2_STEPS, "host_step_s": host_s,
                "replay_s_per_step": step_s, "capture_s": prog.capture_s,
                "busy_replayed": busy, "peak_mib": peak / 2**20,
                "replay_peak_mib": replay_peak / 2**20,
                "launches_per_matvec": {"H": per_h, "K": per_k},
                "pops_gap": float(gaps.max()), "e_gap": e_gap}
        finally:
            os.chdir(cwd)
    del g, engine, wf
    torch.cuda.empty_cache()
    return {**workflow_path(n), "mgs_qr": (n["mgs_qr"], err_q),
            "krylov_ctl": (n_ctl, err_ctl)}


def phase_multistate(times) -> list:
    """Phase 19: several electronic states (the Ambrosek aggregate, the
    27-state LH2 model)."""
    return [phase_ambrosek(times), phase_lh2(times)]


KERNELS = [
    ("lanczos_expm", "pytdscf_torch/csrc/lanczos_expm.cu",
     "pytdscf_tpu/mps/pallas_lanczos.py:296"),
    ("mgs_qr", "pytdscf_torch/csrc/mgs_qr.cu",
     "pytdscf_tpu/mps/pallas_qr.py:153"),
    ("heff_lo", "pytdscf_torch/csrc/chain_tc.cu",
     "pytdscf_tpu/mps/pallas_matvec.py:175"),
    ("keff_lo", "pytdscf_torch/csrc/keff_tc.cu",
     "pytdscf_tpu/mps/pallas_matvec.py:244"),
    # the bf16x3 mode of the same source, two wrappers: the environment
    # transfer, and the "high" matvec that the JAX package runs as an XLA
    # einsum at Precision.HIGH
    ("renorm_hi", "pytdscf_torch/csrc/chain_tc.cu",
     "pytdscf_tpu/mps/pallas_renorm.py:223"),
    ("matvec_hi", "pytdscf_torch/csrc/chain_tc.cu",
     "pytdscf_tpu/mps/pallas_renorm.py:223"),
    ("site_step", "pytdscf_torch/csrc/site_step.cu",
     "pytdscf_tpu/mps/pallas_site.py:342"),
    # no pl.pallas_call: the control of the JAX package's Arnoldi
    # while_loop (the Lanczos one is at :228)
    ("krylov_ctl", "pytdscf_torch/csrc/krylov_ctl.cu",
     "pytdscf_tpu/mps/integrator.py:322"),
    # no pl.pallas_call: improved relaxation's restarted Lanczos, the JAX
    # package's _ground_state_multi (XLA while_loop and eigh) over
    # lanczos_ground_state (integrator.py:552)
    ("lanczos_gs", "pytdscf_torch/csrc/lanczos_gs.cu",
     "pytdscf_tpu/mps/tdvp.py:176"),
]


def main() -> int:
    import argparse

    import torch

    global SAVE_DIR
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--save-state", metavar="DIR",
                        help="keep the end states of the long chain runs "
                        "(the graph driver, both stride-16 Simulator runs) "
                        "as DIR/<run>.npz")
    SAVE_DIR = parser.parse_args().save_state
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs an NVIDIA "
              "GPU and does not fall back to the CPU", file=sys.stderr)
        return 1
    build = ModelBBuild()
    try:
        return run_phases(build)
    finally:
        build.stop()


def run_phases(build) -> int:
    import torch

    t_start = time.perf_counter()

    def clock(name: str, result):
        """``result``, with the seconds since the start logged beside the
        phase that made it."""
        torch.cuda.empty_cache()
        log(f"clock: {name} done at {time.perf_counter() - t_start:.1f} s")
        return result

    phase_device()
    phase_build()

    times: dict[str, dict] = {"mgs_step_shapes": {}}
    chain, eager, chain_engine = clock("chain", phase_chain(times))
    graph, graph_k = clock("chain graph", phase_chain_graph(eager, times))
    fused = clock("simulator", phase_simulator(
        times, mean_krylov(eager["step_k"]), chain_engine))
    del chain_engine
    paths = [chain, graph, fused,
             clock("simulator stride 16", phase_simulator_strided(
                 graph_k, fused=False)),
             clock("simulator stride 16, fused site", phase_simulator_strided(
                 graph_k, fused=True))]
    for preset in ("balanced", "throughput"):
        paths.append(clock(f"radical pair {preset}",
                           phase_radical_pair(times, preset)))
    paths.append(clock("radical pair simulator", phase_rp_simulator()))
    paths.append(clock("anchor", phase_anchor()))
    paths += clock("relax and operate", phase_relax_operate(times))
    paths += clock("one-state models", phase_one_state_models(times, build))
    log("one-state models: " + json.dumps(times["a4_runs"]))
    paths += clock("several states", phase_multistate(times))
    log("several states: " + json.dumps(times["a3_runs"]))

    kernels = []
    for name, source, replaces in KERNELS:
        # launches: summed over the main paths that run the kernel; the
        # error: the largest against plain over the paths that check it
        runs = [path[name] for path in paths if name in path]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(n for n, _ in runs),
            "max_abs_err": max(e for _, e in runs if e is not None),
            **{key: times[name][key] for key in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        })
    # launches by route, summed over the main paths
    gs = kernels[[k["name"] for k in kernels].index("lanczos_gs")]
    gs["launches_by_route"] = {
        way: sum(path.get("lanczos_gs_routes", {}).get(way, 0)
                 for path in paths) for way in ("block", "cluster")}
    gs["bulk"] = {key: times["lanczos_gs"][key] for key in (
        "passes", "iterations", "shape", "route", "cluster_ctas", "threads",
        "ms_per_iteration")}
    gs["h2o"] = times["lanczos_gs"]["h2o"]
    gs["relax_step_device_ms"] = times["relax_step_device_ms"]
    for name in ("lanczos_expm", "site_step"):
        entry = kernels[[k["name"] for k in kernels].index(name)]
        entry["launches_by_route"] = {
            way: sum(path.get(f"{name}_routes", {}).get(way, 0)
                     for path in paths)
            for way in ("block", "cluster")}
        entry["cluster_ctas"] = times[name]["cluster"]
        entry["times_by_route"] = times[name]["times_by_route"]
    kernels[0]["cluster_launches_by_size"] = {
        str(c): sum(path.get("lanczos_expm_sizes", {}).get(c, 0)
                    for path in paths) for c in (8, 16)}
    for key in ("k_step_times_by_route", "iteration_cost", "route_sweep",
                "route_sweep_step_ms"):
        kernels[0][key] = times["lanczos_expm"][key]
    # the one-state models' shapes: each timed on its own route
    kernels[0]["model_cases"] = times["a4_lanczos"]
    kernels[0]["model_b_route_ms"] = times["a4_model_b_routes"]
    times["mgs_qr"]["cases"].append(times["a4_mgs"])
    times["mgs_qr"]["cases"] += times["a3_mgs"]
    ctl = kernels[[k["name"] for k in kernels].index("krylov_ctl")]
    ctl["model_b"] = times["a4_krylov_ctl"]
    ctl["lh2"] = times["a3_krylov_ctl"]
    for key in ("floor_ms", "k_used", "path"):
        ctl[key] = times["krylov_ctl"][key]
    # the MGS cases: each timed shape with its launches a step at that
    # shape in each path whose host-driven step was recorded
    # (record_step_shapes); the replayed chain's MGS time by shape; the
    # recorded steps' launches by shape
    mgs = kernels[[k["name"] for k in kernels].index("mgs_qr")]
    steps = times["mgs_step_shapes"]
    mgs["cases"] = [
        {**case, "launches_a_step": {
            path: counts[str(tuple(case["shape"]))]
            for path, counts in steps.items()
            if str(tuple(case["shape"])) in counts}}
        for case in times["mgs_qr"]["cases"]]
    mgs["chain_replay_by_shape"] = times["mgs_qr"]["chain_replay_by_shape"]
    mgs["step_shapes"] = steps
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
