#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port's main path on one NVIDIA card.

    python3 chip_smoke.py            # the whole run (needs one card)
    python3 chip_smoke.py --quick    # build + kernel-vs-twin checks only

Phases (any failure exits non-zero):

1. Environment: torch / CUDA versions, the card's name and power limit,
   then the build of every ``quantum_simulations_tpu_torch/csrc/*.cu``
   (one nvcc per source, started together; ptxas register report), and
   the count of tensor-core instructions (HGMMA, the warpgroup MMA, and
   HMMA, mma.sync, from ``cuobjdump -sass``) in each of the five
   instances of the dim-128 lane / positioned panel kernel and the two of
   the dual panel kernel; fails if one has neither.
2. Each kernel against its plain torch twin on the card, on seeded
   unit-norm states.  At n = 28 with the operands of the requests:
   nonstab28's W's (positioned pos 11 / 14 / 21, dual with and without
   its pre-straddler, the lane panel on the (2^21, 128) view), qaoa28's
   43-term diag run through ``fused_diag``, qft28's pos-21 panel with its
   147-term run as the diag epilogue, qft28's ``bitperm_swap`` and
   ``bitperm_transpose``, deutsch_jozsa28's ``pair_update`` gates
   (7, 27) and (20, 27) and ``mixed_pair`` gate (0, 27), qpe28's
   ``mixed_pair`` gate (6, 20) and multiswap, w_qft28's two
   ``mixed_low_pair`` gates, and the ``bitperm_cross`` of qft28 with
   ``QST_BITPERM_DECOMP=0``.  At n = 20 with random operands: positioned
   pos 7 / 8 / 9, a ragged 64-wide top window, dual in (7, 0) order,
   dual with general complex pre- and post-straddlers, ``fused_diag``,
   the lane / positioned / dual diag epilogues (order <= 3 terms, sum
   |coeff| > 100 rad), the three bit permutations, and the three pair
   wrappers with random 4x4 unitaries for lo in {0, 1, 2, 6, 7, 12, 13}
   in both qubit orders.  Then, at n = 20, every in-place instance (the
   capacity tier's): lane / positioned / dual panels with straddlers and
   diag epilogues, ``fused_diag``, the three pair wrappers, ``midpair``
   for lo 7, 8, 9 in both orders, the in-place transpose and crossing,
   ``bitperm_involution`` on random involutions and ``bitperm_swap`` in
   place on random bit permutations, each on a copy of one state: the
   result must be the given planes, equal bit for bit to the
   out-of-place run, and within 1e-5 of the plain twin.  Panel mode's
   two kernels: ``tiled_transpose`` at n = 28 on the (2^21, 2^7),
   (2^7, 2^21) and (2^14, 2^14) views, at n = 20 on (2^11, 2^9) and at
   n = 10 on every (2^(10 - r), 2^r) (ragged tiles), bit for bit; the
   lane panel's rotated store on nonstab28's first panel at n = 28 and
   on random W at n = 20 and n = 10 (R = 8 rows); at n = 10 the dim-128
   lane panel on R = 8 rows (also with a diag run) and the positioned one
   at pos 2 (C = 4).  Every dim-128 lane, positioned and dual case
   (tensor cores, split TF32; the in-place ones too) is also held to its
   plain twin in float64, and the float32 twin's own ||diff||_2 to it (a
   float32 contraction, the accuracy of a float32 kernel) is reported
   beside it.  Fails on ||diff||_2 > 1e-5 (to the float32 twin, and for
   the dual to the float64 one; the lane and positioned panels' bound to
   the float64 twin is 2.8e-7, ``TOL_TC_F64``), or on any difference for
   a bit permutation.  Last, the readout kernel ``zstring_sum`` at n = 20
   and n = 28 on a complex64 tensor's ``.real`` / ``.imag`` and on two
   float32 planes, with one string (qubits 0 and n - 1) and with
   qaoa_maxcut(n)'s edges (50 at n = 28): within 1e-6 of the plain twin
   (``sampling.zstring_sums_plain``), equal bit for bit when repeated,
   one launch a call.
3. The main path, five requests through the entry points, the counters
   set to 0 just before each request and read just after it, no plain
   twin called: ``api.simulate(non_stabilizer(28, depth=4, seed=7),
   SimulatorConfig(mode="window"))`` (dual_panel 2, positioned_panel 3),
   ``hadamard_wall(28)`` with ``QST_PANEL_PAIR_FUSE=0`` (lane_panel 1,
   positioned_panel 3; every amplitude 2^-14), ``qft(28)``
   (positioned_panel 1, positioned_panel+diag 3, lane_panel 1,
   bitperm_swap 1, bitperm_transpose 1; every amplitude 2^-14 within
   1e-6), ``qaoa_maxcut(28)`` (dual_panel 3, positioned_panel 8,
   positioned_panel+diag 2, fused_diag 2), and qft28 once more through
   ``simulator.simulate`` from a seeded random unit-norm state (from |0>
   a wrong phase on a control still 0 can hide).  Then the two-qubit
   gate requests: ``qpe(27)`` (mixed_pair 7, bitperm_swap 1 for its
   multiswap, and its panels and diag runs), ``qft_adder(28)``
   (mixed_pair 14, bitperm_swap 2), ``deutsch_jozsa(28)`` (pair_update
   14, mixed_pair 7), ``w_qft(28)`` (mixed_low_pair 2), ``qft(28)`` with
   ``QST_BITPERM_DECOMP=0`` (bitperm_swap 1, bitperm_cross 1; every
   amplitude 2^-14) and qpe28 once more from a random state.  No request
   calls the plain torch gate paths (``dense.GATE_CALLS == 0``).  Each
   but the wall: |norm2 - 1| <= 1e-5 and ||psi - psi_f64||_2 <= 1e-5
   against the plain twins in float64 on the card, from the same state.
   Each request runs once more through ``SimulatorConfig(mode=
   "capacity")`` (the random-state ones through
   ``runtime.capacity.simulate_capacity`` from copies of that state):
   only in-place launches (the ``" inplace"`` keys, ``midpair``,
   ``bitperm_involution``), and a state within 1e-6 of the window run's.
   Then panel mode (``SimulatorConfig(mode="panel")``, the CLI's
   default) for nonstab28 (lane_panel+rotate 9, lane_panel 1,
   tiled_transpose 7), ghz28 (4, 1, 10) and qft28 (34, 27, 63,
   mixed_pair 8; 210 plain torch gate calls for its diagonal gates), and
   fused mode (``SimulatorConfig()``, the API's default) for nonstab28
   (lane_panel 9, pair_update 27, mixed_low_pair 1; 89 plain calls) and
   ghz28 (1, 14, 1; 6), each counted from 0 with no plain twin called,
   within 1e-5 of its float64 twins (the same mode's schedule) and of
   its window-mode state; nonstab28 panel's peak memory at most 4
   planes + 1 GiB above what was held before it.  Last,
   ``python -m quantum_simulations_tpu_torch run ghz28.json`` as a
   subprocess: top two 0x0 and 0xfffffff at 0.5 each.  Between them,
   qaoa28's state read as an energy request (``observables.maxcut_energy``
   over its 50 edges, random weights): zstring_sum 1 and nothing else,
   within 1e-6 of the twin's energy per unit weight.
4. Times at n = 28: per kernel the median CUDA-event ms, the plain
   twin's ms, one torch library call computing the same function
   (timed here, never used by the port; for a diag run, with or without
   a panel, an elementwise product with its 2^28 phase table, built
   outside the timing), and the bound: the larger of bytes / 3.35 TB/s and
   flop / 67 TFLOP/s (H100 SXM data sheet, float32 outside the tensor
   cores), with the flop the function needs (6 per complex multiply-add,
   none for a select straddler, 6 per amplitude for a diag rotation,
   none for a bit permutation).  The tensor-core rows (the lane panel,
   rotated or with a diag run, the positioned panel, the dual panel)
   count the same multiply-adds as TF32 flop at 495 TFLOP/s: split TF32
   takes three TF32 products a real product, 18 flop a complex
   multiply-add by Gauss (1.25 ms a 128-wide contraction at n = 28, under
   the 1.28 ms of bytes; the dual's two, 2.50 ms, over them), plus a
   straddler's and a diag run's float32 flop; the float32 bound of a SIMT
   kernel is given beside it (``bound_simt_ms``).  Each epilogue row also
   times the same panel without it.  The pair kernel at its classes (pair_update
   column (7, 27) and row (20, 27), mixed_pair (0, 27), mixed_low_pair
   (6, 7) and (7, 6)), its library call an einsum of the (2, 2, 2, 2)
   coefficients with the complex64 (A, 2, B, 2, C) view, and
   ``bitperm_cross``.  Then the kernel time of every pass of qft28,
   qaoa28 and qpe28, and the end-to-end time of nonstab28, qft28,
   qaoa28, qpe28 and qft_adder28 by the two-point estimator
   (t(2R) - t(R)) / R with amplitude-updates/s = gates * 2^28 / t.
   Each kernel row also times the in-place instance on the same
   operands (``inplace_ms``); ``midpair`` on qpe28's (9, 17) SWAP and a
   random (8, 27) gate, ``bitperm_involution`` on qft28's grid
   permutation (its bound counts only the rows it moves).  Panel mode:
   ``tiled_transpose`` at the three phase-2 shapes (library:
   ``.t().contiguous()``), the rotated lane panel beside the separate
   form (the panel, then the transpose; library: ``(x @ W.T).t()
   .contiguous()``), every pass of nonstab28's panel schedule, and e2e
   of nonstab28 panel (also with the panel and the rotation as two
   passes), qft28
   panel and nonstab28 fused.  The readout: ``zstring_sum`` on one
   string and on qaoa28's 50 edges, interleaved and planar (bound: one
   read of 8 bytes an amplitude, 0.641 ms; library: the per-string plain
   readout the port had before the kernel, a 2^26 sign table and four
   chunks).
5. The capacity tier at n = 33, the largest state an 80 GB card holds
   (two 32 GiB planes; an out-of-place pass would need 128 GiB).  With
   under 1 GiB allocated before it, ghz(33), non_stabilizer(33, depth=4,
   seed=7), qft(33) and qpe(32) run through ``api.simulate(cd,
   SimulatorConfig(mode="capacity"))``, each with its launch counts, no
   plain call, ``dense.GATE_CALLS == 0`` and a peak
   ``max_memory_allocated`` <= 65 GiB.  No float64 twin fits at this
   size, so each state is held to what is known of it: ghz33's two end
   amplitudes 2^-1/2 within 1e-6 and its top two indices, its <Z0 Z32>,
   <Z32> and <Z0...Z32> (1, 0, 0 within 1e-5: index bit 32) in one
   zstring_sum launch within 1e-6 of the twin; qft33 uniform
   (chunked ||psi - 2^-16.5||_2 <= 1e-5); nonstab33 followed by its
   inverse back at |0> within 1e-5; qpe33 at index 2^32 + 2^29 with
   probability >= 1 - 1e-5; every |norm2 - 1| <= 1e-5.  Times:
   nonstab33 and qft33 by (t(2) - t(1)) / 1, ghz33 and qpe33 one run.

6. The tiers around the dense engine, each request through the entry
   points with the counters set to 0 before it and read after it, no
   plain twin called.  The sparse tier: ``api.simulate(cd,
   SimulatorConfig(sparse=True))`` of ghz(62) (nnz 2, both amplitudes
   2^-1/2 within 1e-12) and w_state(62) (nnz 62, each |amp|^2 = 1/62
   within 1e-12) on the card's COO tier, ``simulate_sparse(ghz(63),
   force_tier="numpy")`` (bit 62), hadamard_wall(22) (nnz 2^22, every
   amplitude 2^-11 within 1e-12; the COO gates timed alone), ``api.sample``
   of ghz62 (every row all 0 or all 1) and ghz(1000) on the host's
   bigint tier.  The adaptive tier at n = 26 (its dense cap): qft(26) and
   hadamard_wall(26) with ``sparse="auto"``, fused (the default) and
   window: ``switched_at`` and ``nnz_history`` as the rule gives them on
   |0> (the H that takes nnz past 2^22: gate 23 of the wall), the
   hand-off's kernels launched (ADAPT_NEED; the wall's fused hand-off is
   three plain torch gates, ADAPT_DENSE), the API's numpy result equal
   to the tier's, and each state within 1e-5 of the whole circuit run in
   float64 through the plain twins on the card (the wall uniform 2^-13
   within 1e-6); the fused runs' COO gates timed alone.  The trajectory
   tier: traj28 (``traj_circuit(28)``: non_stabilizer(28, 4, 7), two
   MEASUREs, two conditions, RESET, non_stabilizer(28, 2, 8), a last
   MEASURE) through ``api.simulate(cd, SimulatorConfig(trajectory_seed=s))``
   for each seed of TRAJ_SEEDS (lane_panel, pair_update and mixed_low_pair
   launched), then the tier once more warm (its e2e time) and in
   complex128 on the card (the plain twins): the same outcomes and
   registers, ||psi - psi_f64||_2 <= 1e-5, |norm2 - 1| <= 1e-5;
   ``api.sample`` of traj28, every shot's bit 20 the last outcome.  The
   CLI as subprocesses: ``run ghz62.json --sparse`` (top 0x0 and
   0x3fffffffffffffff at 2^-1/2), ``run mixed.qasm --trajectory
   --trajectory-seed 3`` (its probabilities those of the port's oracle
   copy within 1e-6) and ``export qft8.json --format qasm`` (``to_qasm``'s
   text).

7. The out-of-core spill tier (``runtime/spill.py``: the state in host
   DRAM or disk chunks, streamed through the card in stripes), each
   request counted from 0 with its launches equal to ``spill_want`` (every
   op of every step through ``gate_route`` at the stacked group's width,
   once per group), no plain twin, and its plain torch gate calls as
   planned.  First the host's facts: MemTotal / MemAvailable, CPUs, free
   disk, numpy, the PCIe link, and pinned copy rates of 1 GiB each way
   alone and both at once.  nonstab30 (``non_stabilizer(30, 4, 7)``) on
   the host backend at m = 26, unstaged (16 steps, groups up to 2^30),
   pipelined, ``pipeline=False`` and ``transfer="f32"``: equal bit for bit,
   within 1e-5 of fused mode in HBM.  At full size, single copy, m = 28
   (64 GiB through the card each way per step) when MemAvailable holds the
   state and 8 GiB: ghz33 pipelined and synchronous (closed form within
   1e-6, chunk by chunk on the card) and nonstab33 staged (7 steps,
   groups of at most 2^30, the un-permute in place), within 1e-5 of the
   capacity tier's nonstab33, chunk by chunk; ghz34 needs 128 GiB and is
   not run.  nonstab28 on the disk backend at m = 24 in subprocesses:
   crashed by ``QST_CRASH_AFTER_STRIPE`` inside its first group step (the
   WAL's done_steps below the total), resumed in a fresh process, within
   1e-5 of fused mode in HBM.  The CLI: ``run ghz28.json --mode fused
   --stripe-qubits 24``, host and disk, the in-HBM run's output.  The
   native oracle (g++) on nonstab20 within 1e-10 of the numpy oracle.
   Each request prints its seconds, steps, groups, bytes and GB/s each
   way beside the pinned rates, the host's wait and allocation seconds,
   launches, plain gate calls and peak device memory.

8. The sharded tier and the WAL runner (``parallel/``,
   ``runtime/runner.py``), positions sharing the card
   (``make_mesh(devices=[cuda:0] * D)``).  Each request is counted from
   0: its launches summed over the positions, its plain torch gate calls
   and the bytes ``parallel/comm`` hands between positions must equal
   ``sharded_want`` (derived before it runs: each step's local ops
   dispatched dry on meta planes, each zero-traffic gate's block per
   position, ``exchange_bytes`` / ``reshard_bytes``), and no plain twin
   may run.  nonstab30 (``non_stabilizer(30, 4, 7)``) in window mode on
   8 positions of 2^27, within 1e-5 of the one-device window run, warm
   ms beside it; its readout on the mesh (<Z0 Z29>, P(1) of q3 and q29
   within 1e-9 of the same sums over the gathered planes and 2e-5 of the
   one-device ones, the collapses by ``measure_qubit_sharded`` within
   1e-6 / 1e-5 of the gathered / one-device collapse); ghz30's 1000 shots
   by ``sample_bits_sharded``, every row all 0 or all 1; random30
   (600 gates, seed 9) staged by ``stage_circuit(cd, 27, "heuristic")``,
   its boundary SWAPs as all_to_all reshards, within 1e-5 of the
   unstaged one-device run after the permutation; qft28 in fused mode
   within 1e-5 of the one-device window run; qft31 in place on 2
   positions of 2^30: unstaged its build raises the capacity
   ``ValueError``, staged from a seeded random state it reshards in the
   shards' memory (peak at most one shard plane above the state) and
   lands within 1e-5 of the one-device capacity run after the
   permutation.  The runner: nonstab28 on 4 positions, window mode, one
   level a step, in a subprocess crashed by ``QST_CRASH_AFTER_STEP=1``
   (WAL done_steps 1), resumed in a fresh one, ``collect_state`` equal
   bit for bit to an uninterrupted run in this process (checkpoint s and
   GB/s); nonstab30 through ``api.simulate(cd, SimulatorConfig(mode=
   "capacity"), work_dir=...)`` within 1e-6 of the capacity tier.  A pod
   of 2 processes x 2 positions over gloo, card pieces staged through
   host memory, both on this card (``parallel.pod_worker``): every
   shard's sha256 equal to the in-process 4-position run's, launches,
   plain torch gate calls and bytes handed between positions, each
   summed over the processes, equal to the plan, the host-staged bytes
   and GB/s.  The spill tier across a mesh: nonstab28 in host stripes of
   2^26, each group sharded over 4 positions (``spill_mesh_want``),
   through each position's pinned ``StripeIO``, within 1e-5 of the
   one-device window run.  The CLI in this process: ``run ghz28.json --work-dir`` twice
   (the second finds the run done: the same output and WAL),
   ``placement --devices 1 --qubits 28`` (exit 0), ``run --devices 2``
   (exit 1, naming the one card).  Phase 8's seconds and the card line
   close it.
9. The bench tier (``quantum_simulations_tpu_torch/bench/``), run after
   phase 4 and before phase 5 (before phase 7 pins host memory): the
   CLI's nine ``python -m quantum_simulations_tpu_torch bench <which>``,
   then ``bench.c128_diff`` (sizes 16, 18), ``bench.passes`` on nonstab28
   (reps 6, samples 3), ``bench.sharded shard_timing 30`` and
   ``bench.headline``, each a subprocess started ahead of its turn and
   waiting for a go file (:data:`BENCH_ARGV`), host MemAvailable and the
   card's free memory logged before each.  A bench that exits non-zero
   fails the phase after its stderr's tail.  Each JSON is held by
   :func:`check_bench`: suite 0 mismatches; c128_diff met; every matrix
   row ok, its sharded rows (8 positions sharing the card) present;
   e2e, sweep and baseline_configs' walls and rates > 0; no kernel_bw row
   above 105% of 3.35 TB/s; passes attributes every pass once, no row
   above 105% of its bound, its TOTAL within 1.5x of phase 4's nonstab28
   window ms; shard_timing has an exchange and at most collectives x
   shard bytes; capacity's peak at n = 30 at most the two planes + 1
   GiB; the headline within 1.5x of phase 4's nonstab28 rate.  One
   ``bench <name>`` line each (with the kernels' launches by key), then
   the launches by kernel and the phase's seconds.
10. The bench diagnostics, run right after phase 9 by the same loop
   (:func:`bench_tier`) from :data:`DIAG_ARGV`, at the JAX package's
   defaults, budget 240 s: ``bench.probe_transfer`` (every copy checked,
   each pinned rate in (0, 64] GB/s), ``bench.opprof`` (qft26's and
   nonstab28's classes and counts equal to the schedule, no rate above
   105% of 3.35 TB/s, nonstab28's est_total_s within 1.5x of phase 4's
   window e2e, the straddler policies), ``bench.overhead all`` (the I/O
   variants' norms within 1e-5 and states within 1e-6, the lane-panel
   chain's slope within 1.5x of phase 4's lane_panel row, the diag
   variants), ``bench.overhead wal`` at n = 26 (cut from the default 28
   for the script's time limit; checkpoints under the phase's work dir, a
   rate > 0, the same steps in every configuration),
   ``bench.capacity sample`` (1e6 shots at n = 30: each one-count within
   5 sigma of its exact P(1), the card's peak reported and at most the
   planes + 1 GiB),
   ``bench.spill_bw`` overlap (bit-equal), slice40 (stripe passes = steps
   x 2^14), real (within 1e-5 of the window run) and ghz (n = 31, 16 GiB
   pinned: poles and off-pole amplitudes within 1e-6), ``bench.sharded``
   (ghz30 / sycamore30 on 8 positions, the complex128 oracle rows within
   1e-10) and ``bench.sharded mesh16`` (the five-tier dry run and the
   pod14 program on 16 positions).
11. The corpus tier, run right after phase 10 by the same loop from
   :func:`corpus_argv`, budget 75 s, on a corpus the phase writes under
   its work dir (QASMBench's ``<name>/<name>.qasm``, from
   ``circuit/library`` through ``export_qasm.to_qasm``; each subprocess's
   ``QST_QASMBENCH`` from :data:`CORPUS_ENV`): ``bench.corpus --tier all
   --seg-gates 4 --seg-k 1`` over qft_n14 and sycamore_n18 (e2e: three
   tiers at complex128), nonstab_n26 (one 4-gate segment restart),
   traj_n16 (:func:`traj_qasm`: the trajectory twin, outcomes equal to the
   oracle's), adder_n40 (classical, basis state that of a + b) and
   qft_n33 (skipped with the JAX package's reason): every other row
   ``verified`` within 1e-10; ``verify_one(sycamore_n18,
   spot_sharded=True)`` (8 positions sharing the card, within 1e-10);
   ``bench.corpus33`` on random_circuit(28, 200, seed=8) in stripes of
   2^24 (``verified_c64``: norm within 1e-5, lightcone amplitudes within
   1e-6, a host bit in the segment, launches equal to ``spill_want``,
   lane_panel and the pair kernel among them); a fingerprint of
   qaoa_maxcut(14) built by ``fingerprints.torch_simulate`` on the CPU
   and ``fingerprints.verify`` against it (within 1e-10), then refused
   with one top-k amplitude moved by 1e-6; ``bench.corpus --tier all
   --seg-gates 4 --seg-k 1`` over a second corpus (``corpus_big``): the
   branches the tier takes only at n = 29-31, switched on lower by
   :data:`CORPUS_ENV` (nonstab_n26's segment through the disk memmap as
   sub-programs of 2 gates; :func:`traj_short` at n = 22 through the
   unitary-runs branch), both ``verified`` within 1e-10.  complex128 runs
   the plain twins on the card (above ``dense.PLAIN_BLOCK`` amplitudes
   block by block); only corpus33 launches kernels.  n = 33, the size
   corpus33 exists for, is :func:`corpus33_full`, and n = 27-31, the
   sizes of the segment and trajectory policies, :func:`corpus_full`,
   both run by hand.

After each phase, ``script: phase N done at T s`` gives the script's
clock since the card was found (build included).

The last lines: the card line as nvidia-smi prints it, one JSON object
``{"kernels": [...]}``, and ``{"ok": true, "device": {...}}``.  The
whole record also goes to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

try:  # the card's peaks and a pass's bound: the benches' one account
    from quantum_simulations_tpu_torch.bench import HBM_BYTES_PER_S, bound
except ImportError:  # alone in a directory: main() says so and fails
    pass

# The kernels whose dim-128 instances run on the tensor cores (split TF32,
# csrc/panels.cu namespace tc), and the phase-4 rows timed on them.
TC_KERNELS = ("lane_panel", "positioned_panel", "dual_panel")
TC_ROWS = ("lane_panel", "lane_panel+diag", "lane_panel+rotate",
           "positioned_panel", "positioned_panel+diag", "dual_panel",
           "dual_panel+diag")
GIB = 1 << 30
SEED = 7
NQ = 28                        # the requests' width: full size, not cut
NBIG = 33                      # the capacity tier's: the largest state one
#                                80 GB card holds (two 32 GiB planes)
CSRC = "quantum_simulations_tpu_torch/csrc"
SRC = {"lane_panel": f"{CSRC}/panels.cu",
       "positioned_panel": f"{CSRC}/panels.cu",
       "dual_panel": f"{CSRC}/panels.cu",
       "fused_diag": f"{CSRC}/diag.cu",
       "bitperm_swap": f"{CSRC}/bitperm.cu",
       "bitperm_transpose": f"{CSRC}/bitperm.cu",
       "bitperm_cross": f"{CSRC}/bitperm.cu",
       "pair_update": f"{CSRC}/pair.cu",
       "mixed_pair": f"{CSRC}/pair.cu",
       "mixed_low_pair": f"{CSRC}/pair.cu",
       "midpair": f"{CSRC}/pair.cu",
       "bitperm_involution": f"{CSRC}/bitperm.cu",
       "tiled_transpose": f"{CSRC}/bitperm.cu",
       "zstring_sum": f"{CSRC}/readout.cu"}
KERNELS = list(SRC)
PALLAS = "quantum_simulations_tpu/ops/pallas_kernels.py"
REPLACES = {"lane_panel": f"{PALLAS}:93",
            "positioned_panel": f"{PALLAS}:605",
            "dual_panel": f"{PALLAS}:343",
            "fused_diag": f"{PALLAS}:1297",
            "bitperm_swap": f"{PALLAS}:1977",
            "bitperm_transpose": f"{PALLAS}:2155",
            "bitperm_cross": f"{PALLAS}:1890",
            "pair_update": f"{PALLAS}:898",
            "mixed_pair": f"{PALLAS}:1107",
            "mixed_low_pair": f"{PALLAS}:1692",
            "midpair": f"{PALLAS}:1187",
            "bitperm_involution": f"{PALLAS}:2147",
            "tiled_transpose": f"{PALLAS}:2198",
            "zstring_sum": "none: the JAX package's readout is jnp "
                           "(quantum_simulations_tpu/ops/sampling.py:45)"}
# lane_panel's rotate option replaces the transposed store of
# _panel_kernel (the kernels line reports it inside lane_panel's record).
ROTATE_REPLACES = f"{PALLAS}:116"
# The request whose launches each kernel reports; each request has
# counts of its own.  A panel's launches count its "+diag" and
# "+rotate" keys too.
PATH = {"lane_panel": "nonstab28 panel",
        "positioned_panel": "qaoa28",
        "dual_panel": "qaoa28",
        "fused_diag": "qaoa28",
        "bitperm_swap": "qft28",
        "bitperm_transpose": "qft28",
        "bitperm_cross": "qft28 nodecomp",
        "pair_update": "deutsch_jozsa28",
        "mixed_pair": "qpe28",
        "mixed_low_pair": "w_qft28",
        "midpair": "qpe33",
        "bitperm_involution": "qft33",
        "tiled_transpose": "nonstab28 panel",
        "zstring_sum": "qaoa28 energy"}
# Launches of each request, by counter key (keys not listed: 0).
WANT = {"nonstab28": {"dual_panel": 2, "positioned_panel": 3},
        "hadamard_wall28": {"lane_panel": 1, "positioned_panel": 3},
        "qft28": {"positioned_panel": 1, "positioned_panel+diag": 3,
                  "lane_panel": 1, "bitperm_swap": 1, "bitperm_transpose": 1},
        "qaoa28": {"dual_panel": 3, "positioned_panel": 8,
                   "positioned_panel+diag": 2, "fused_diag": 2},
        "qaoa28 energy": {"zstring_sum": 1}}
WANT.update({
    "qpe28": {"dual_panel": 1, "positioned_panel": 5, "fused_diag": 3,
              "bitperm_swap": 1, "mixed_pair": 7, "lane_panel+diag": 1,
              "positioned_panel+diag": 1},
    "qft_adder28": {"positioned_panel+diag": 5, "bitperm_swap": 2,
                    "fused_diag": 3, "lane_panel": 1, "positioned_panel": 3,
                    "mixed_pair": 14, "lane_panel+diag": 1},
    "deutsch_jozsa28": {"dual_panel": 2, "positioned_panel": 4,
                        "mixed_pair": 7, "pair_update": 14},
    "w_qft28": {"lane_panel": 2, "mixed_low_pair": 2, "positioned_panel": 5,
                "positioned_panel+diag": 3, "bitperm_swap": 1,
                "bitperm_transpose": 1},
    "qft28 nodecomp": {"positioned_panel+diag": 3, "lane_panel": 1,
                       "positioned_panel": 1, "bitperm_swap": 1,
                       "bitperm_cross": 1}})
WANT["qft28 random state"] = WANT["qft28"]
WANT["qpe28 random state"] = WANT["qpe28"]
# The same requests in place (SimulatorConfig(mode="capacity")): every
# kernel's aliasing instance (" inplace" keys; midpair and
# bitperm_involution run in place only), routed as the reference's
# capacity tier routes them.
WANT.update({
    "nonstab28 capacity": {"positioned_panel inplace": 3,
                           "dual_panel inplace": 2},
    "hadamard_wall28 capacity": {"lane_panel inplace": 1,
                                 "positioned_panel inplace": 3},
    "qft28 capacity": {"lane_panel inplace": 1, "positioned_panel inplace": 1,
                       "positioned_panel+diag inplace": 3,
                       "bitperm_involution": 1,
                       "bitperm_transpose inplace": 1},
    "qaoa28 capacity": {"positioned_panel inplace": 8,
                        "positioned_panel+diag inplace": 2,
                        "dual_panel inplace": 3, "fused_diag inplace": 2},
    "qpe28 capacity": {"lane_panel+diag inplace": 1,
                       "positioned_panel inplace": 5,
                       "positioned_panel+diag inplace": 1,
                       "dual_panel inplace": 1, "fused_diag inplace": 3,
                       "mixed_pair inplace": 7, "midpair": 3},
    "qft_adder28 capacity": {"lane_panel inplace": 1,
                             "lane_panel+diag inplace": 1,
                             "positioned_panel inplace": 3,
                             "positioned_panel+diag inplace": 5,
                             "fused_diag inplace": 3, "pair_update inplace": 2,
                             "mixed_pair inplace": 14, "midpair": 6},
    "deutsch_jozsa28 capacity": {"positioned_panel inplace": 4,
                                 "dual_panel inplace": 2,
                                 "pair_update inplace": 11,
                                 "mixed_pair inplace": 7, "midpair": 3},
    "w_qft28 capacity": {"lane_panel inplace": 2, "positioned_panel inplace": 5,
                         "positioned_panel+diag inplace": 3,
                         "bitperm_involution": 1,
                         "bitperm_transpose inplace": 1,
                         "mixed_low_pair inplace": 2},
    "qft28 nodecomp capacity": {"lane_panel inplace": 1,
                                "positioned_panel inplace": 1,
                                "positioned_panel+diag inplace": 3,
                                "bitperm_cross inplace": 1,
                                "pair_update inplace": 1, "midpair": 3}})
WANT["qft28 random state capacity"] = WANT["qft28 capacity"]
WANT["qpe28 random state capacity"] = WANT["qpe28 capacity"]
# Phase 5, n = 33 in place: every op of the four requests on a kernel.
CAPACITY33 = ("ghz33", "nonstab33", "qft33", "qpe33")
WANT.update({
    "ghz33": {"lane_panel inplace": 1, "positioned_panel inplace": 6,
              "mixed_low_pair inplace": 1},
    "nonstab33": {"positioned_panel inplace": 12, "dual_panel inplace": 3},
    "nonstab33 inverse": {"positioned_panel inplace": 12,
                          "dual_panel inplace": 3, "fused_diag inplace": 2},
    "qft33": {"lane_panel inplace": 1, "positioned_panel inplace": 2,
              "positioned_panel+diag inplace": 4, "bitperm_involution": 1,
              "bitperm_transpose inplace": 1},
    "qpe33": {"lane_panel+diag inplace": 1, "positioned_panel inplace": 6,
              "positioned_panel+diag inplace": 2, "dual_panel inplace": 1,
              "fused_diag inplace": 3, "pair_update inplace": 3,
              "mixed_pair inplace": 7, "midpair": 3}})
WANT_CAPACITY33 = CAPACITY33 + ("nonstab33 inverse",)
# Panel mode (SimulatorConfig(mode="panel"), the CLI's default) and fused
# mode (SimulatorConfig(), the API's default) at n = 28, out of place.  A
# 128-wide panel followed by a rotation by 7 is one rotated lane panel;
# every other rotation step, the final un-rotation's too, one
# tiled_transpose.  Gates no kernel takes (diagonal gates, 1q gates above
# the lane window, CNOTs of close bits >= 7) run the plain torch paths of
# ops/dense.py as the reference's XLA paths: DENSE counts those calls.
PANEL28 = ("nonstab28 panel", "ghz28 panel", "qft28 panel")
FUSED28 = ("nonstab28 fused", "ghz28 fused")
WANT.update({
    "nonstab28 panel": {"lane_panel+rotate": 9, "lane_panel": 1,
                        "tiled_transpose": 7},
    "ghz28 panel": {"lane_panel+rotate": 4, "lane_panel": 1,
                    "tiled_transpose": 10},
    "qft28 panel": {"lane_panel+rotate": 34, "lane_panel": 27,
                    "tiled_transpose": 63, "mixed_pair": 8},
    "nonstab28 fused": {"lane_panel": 9, "pair_update": 27,
                        "mixed_low_pair": 1},
    "ghz28 fused": {"lane_panel": 1, "pair_update": 14, "mixed_low_pair": 1}})
DENSE = {"qft28 panel": 210, "nonstab28 fused": 89, "ghz28 fused": 6}
PANEL_PEAK_PLANES = 4          # input and output planes of one pass
# The requests timed end to end (window mode) and in panel / fused mode.
# qpe(32) with theta = 1/8: eigenstate bit 32 and counting bit 29 set.
QPE33_ANSWER = (1 << 32) | (1 << 29)
PEAK_LIMIT = 65 * GIB          # the two planes (64 GiB) + 1 GiB
E2E = ("nonstab28", "qft28", "qaoa28", "qpe28", "qft_adder28")
TOL_L2 = 1e-5
TOL_TC_F64 = 2.8e-7            # the lane / positioned kernel's precision rule:
#                                ||diff||_2 to the float64 twin, float32 class
TOL_CAPACITY = 1e-6            # capacity-tier state against the window run's
TOL_ZSTRING = 1e-6             # zstring_sum's sums against its twin's (unit norm)
# Phase 6: the sparse (COO on the card, bigint on the host), adaptive and
# trajectory tiers.
NSPARSE = 62                   # the COO tier's widest (int64 indices)
NWALL_SPARSE = 22              # hwall22: 2^22 nonzeros at its last gate
NADAPT = 26                    # sparse/adaptive.DENSE_MAX_QUBITS
TRAJ_SEEDS = (3, 11)
# The kernels each phase-6 request must launch (> 0), and the calls of
# the plain torch gate paths (ops/dense.py, the reference's XLA paths) its
# hand-off makes: fused mode runs 1q gates above the lane window there.
# The wall's fused hand-off is three 1q gates on bits 23-25 and launches
# no kernel.
ADAPT_NEED = {"qft26 auto": ("lane_panel", "mixed_pair", "bitperm_swap"),
              "qft26 auto window": ("lane_panel", "bitperm_swap",
                                    "bitperm_transpose"),
              "hwall26 auto": (),
              "hwall26 auto window": ("positioned_panel",)}
ADAPT_DENSE = {"qft26 auto": 3, "qft26 auto window": 0, "hwall26 auto": 3,
               "hwall26 auto window": 0}
TRAJ_NEED = ("lane_panel", "pair_update", "mixed_low_pair")
# The 4-qubit MIXED circuit of tests/test_trajectory.py (RESET, two
# MEASUREs, two conditions), for the CLI's --trajectory.
MIXED_QASM = """OPENQASM 2.0;
qreg q[4];
creg c[2];
h q[0];
cx q[0],q[1];
measure q[0] -> c[0];
if(c==1) x q[2];
reset q[1];
h q[1];
rz(pi/3) q[2];
measure q[1] -> c[1];
if(c==3) z q[3];
h q[3];
cp(pi/4) q[2],q[3];
"""

RECORD: dict = {"cases": [], "times": []}


def log(*a):
    print(*a, flush=True)


def circuits() -> dict:
    """The requests' circuits at width NQ."""
    from quantum_simulations_tpu_torch.circuit import library

    return {"nonstab28": library.non_stabilizer(NQ, depth=4, seed=7),
            "hadamard_wall28": library.hadamard_wall(NQ),
            "qft28": library.qft(NQ),
            "qaoa28": library.qaoa_maxcut(NQ),
            "qpe28": library.qpe(NQ - 1),
            "qft_adder28": library.qft_adder(NQ),
            "deutsch_jozsa28": library.deutsch_jozsa(NQ),
            "w_qft28": library.w_qft(NQ)}


def panel_circuits() -> dict:
    """The panel- and fused-mode requests' circuits at width NQ."""
    from quantum_simulations_tpu_torch.circuit import library

    return {"nonstab28": library.non_stabilizer(NQ, depth=4, seed=7),
            "ghz28": library.ghz(NQ),
            "qft28": library.qft(NQ)}


def pass_name(op, rotated: bool = False) -> str:
    """A short name of one pass of a panel schedule."""
    kind = type(op).__name__
    if kind == "PanelOp":
        return "Panel" + ("+rotate" if rotated else "")
    if kind == "RotateOp":
        return f"Rotate{op.r}"
    return f"{op.name}{op.qubits}"


def circuits33() -> dict:
    """The capacity requests at width NBIG."""
    from quantum_simulations_tpu_torch.circuit import library

    return {"ghz33": library.ghz(NBIG),
            "nonstab33": library.non_stabilizer(NBIG, depth=4, seed=7),
            "qft33": library.qft(NBIG),
            "qpe33": library.qpe(NBIG - 1)}


def traj_circuit(n: int) -> dict:
    """traj28 at width n (tests/test_torch_trajectory.py runs n = 14):
    non_stabilizer(n, depth=4, seed=7); MEASURE q0 -> c[0], q(n-1) ->
    c[1]; X q(n/2) if c == 1, Z q(3n/4) if c == 3; RESET q3, H q3,
    CNOT(3, 5n/7); non_stabilizer(n, depth=2, seed=8); MEASURE q(5n/7)
    -> c[2]."""
    from quantum_simulations_tpu_torch.circuit import library

    def measure(q, cbit):
        return {"qubits": [q], "gate": "MEASURE",
                "params": {"creg": "c", "cbit": cbit}}

    t = 5 * n // 7
    gates = list(library.non_stabilizer(n, depth=4, seed=7)["gates"])
    gates += [measure(0, 0), measure(n - 1, 1),
              {"qubits": [n // 2], "gate": "X", "cond": {"creg": "c", "value": 1}},
              {"qubits": [3 * n // 4], "gate": "Z",
               "cond": {"creg": "c", "value": 3}},
              {"qubits": [3], "gate": "RESET"}, {"qubits": [3], "gate": "H"},
              {"qubits": [3, t], "gate": "CNOT"}]
    gates += library.non_stabilizer(n, depth=2, seed=8)["gates"]
    gates.append(measure(t, 2))
    return {"number_of_qubits": n, "gates": gates}


def inverse(cd: dict) -> dict:
    """The circuit's inverse: its gates reversed, T <-> TDG (H and CNOT
    are their own inverses)."""
    swap = {"T": "TDG", "TDG": "T"}
    gates = [dict(g, gate=swap.get(g["gate"], g["gate"]))
             for g in reversed(cd["gates"])]
    if not {g["gate"] for g in gates} <= {"H", "CNOT", "T", "TDG"}:
        raise ValueError("inverse: H / CNOT / T / TDG circuits only")
    return {"number_of_qubits": cd["number_of_qubits"], "gates": gates}


def chunks(re, im):
    """(start, re chunk, im chunk) views of at most 2^28 amplitudes (the
    capacity readout's chunk): no temporary of a whole plane."""
    from quantum_simulations_tpu_torch.ops import sampling

    step = sampling._chunk(re)
    for s in range(0, re.numel(), step):
        yield s, re[s:s + step], im[s:s + step]


def uniform_distance(re, im) -> float:
    """||psi - 2^(-n/2) (1, ..., 1)||_2 in float64, chunk by chunk."""
    import torch

    a = 2.0 ** (-(re.numel().bit_length() - 1) / 2)
    acc = torch.zeros((), dtype=torch.float64, device=re.device)
    for _, r, i in chunks(re, im):
        acc += ((r.double() - a) ** 2).sum() + (i.double() ** 2).sum()
    return math.sqrt(float(acc))


def plane_distance(a, b) -> float:
    """||a - b||_2 of two plane pairs in float64, chunk by chunk."""
    import torch

    acc = torch.zeros((), dtype=torch.float64, device=a[0].device)
    for (s, r, i), (_, r2, i2) in zip(chunks(*a), chunks(*b)):
        acc += ((r.double() - r2.double()) ** 2).sum()
        acc += ((i.double() - i2.double()) ** 2).sum()
    return math.sqrt(float(acc))


class env_switch:
    """``with env_switch("QST_BITPERM_DECOMP", "0"):`` sets one switch
    for the block and restores it after."""

    def __init__(self, key: str, value: str):
        self.key, self.value = key, value

    def __enter__(self):
        self.old = os.environ.get(self.key)
        os.environ[self.key] = self.value

    def __exit__(self, *exc):
        if self.old is None:
            del os.environ[self.key]
        else:
            os.environ[self.key] = self.old


def nodecomp():
    """qft28's terminal SWAP network as one BitPermOp (bitperm_cross)."""
    return env_switch("QST_BITPERM_DECOMP", "0")


def gate_modules():
    """The kernel modules of the state's passes (those a dry run stubs)."""
    from quantum_simulations_tpu_torch.ops import bitperm_kernels as bk
    from quantum_simulations_tpu_torch.ops import diag_kernels as dk
    from quantum_simulations_tpu_torch.ops import pair_kernels as pq
    from quantum_simulations_tpu_torch.ops import panel_kernels as pk

    return pk, dk, bk, pq


def count_modules():
    """Every kernel module whose launches a request counts: the passes'
    and the readout's."""
    from quantum_simulations_tpu_torch.ops import readout_kernels as rk

    return (*gate_modules(), rk)


def reset_counts() -> None:
    from quantum_simulations_tpu_torch.ops import dense

    for m in count_modules():
        m.reset_counts()
    dense.GATE_CALLS = 0


def launches() -> dict:
    """Launch counts by key, those that are not 0."""
    return {k: v for m in count_modules() for k, v in m.LAUNCHES.items() if v}


def plain_calls() -> dict:
    return {k: v for m in count_modules() for k, v in m.PLAIN_CALLS.items() if v}


def kernel_of(key: str) -> str:
    return key.split(" ")[0].removesuffix("+diag").removesuffix("+rotate")


def is_inplace(key: str) -> bool:
    return key.endswith(" inplace") or key in ("midpair", "bitperm_involution")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def hmma_counts(libs) -> dict:
    """Tensor-core instructions in each instance of the tensor-core panel
    kernels (the lane / positioned kernel's five, the dual kernel's two),
    from ``cuobjdump -sass`` of the built library of csrc/panels.cu:
    {"lane_panel <template args>": {"HGMMA": count, "HMMA": count}}
    (HGMMA: warpgroup MMA, wgmma; HMMA: mma.sync)."""
    import re

    from quantum_simulations_tpu_torch.ops import cuda_build

    lib = next(p for p in libs if p.name.startswith("libpanels-"))
    tool = Path(cuda_build.nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts: dict = {}
    fn = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = None
            t = re.search(r"panel_tc_kernelILb(\d)ELb(\d)ELb(\d)E", m.group(1))
            d = re.search(r"dual_tc_kernelILb(\d)E", m.group(1))
            if t:
                pos, alias, rot = (int(b) for b in t.groups())
                fn = (("positioned_panel" if pos else "lane_panel")
                      + (" inplace" if alias else "") + (" rotate" if rot else ""))
            elif d:
                fn = "dual_panel" + (" inplace" if d.group(1) == "1" else "")
            if fn is not None:
                counts[fn] = {"HGMMA": 0, "HMMA": 0}
        elif fn is not None:
            for op in ("HGMMA", "HMMA"):
                if re.search(rf"\b{op}\b", line):
                    counts[fn][op] += 1
    return counts


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------

def unit_state(n: int, seed: int, dev):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    re = torch.from_numpy(rng.standard_normal(1 << n, dtype=np.float32)).to(dev)
    im = torch.from_numpy(rng.standard_normal(1 << n, dtype=np.float32)).to(dev)
    norm = math.sqrt(norm2(re, im))
    return (re.double() / norm).float(), (im.double() / norm).float()


def norm2(re, im) -> float:
    """sum |psi|^2 of (re, im) planes, accumulated in float64."""
    return float((re.double() ** 2).sum() + (im.double() ** 2).sum())


def rand_unitary(dim: int, rng):
    import numpy as np

    a = rng.standard_normal((dim, dim)) + 1j * rng.standard_normal((dim, dim))
    q, r = np.linalg.qr(a)
    return q * (np.diag(r) / np.abs(np.diag(r)))


def diff(a, b):
    """(max abs error, ||a - b||_2) of two plane pairs, in float64."""
    import torch

    dr = a[0].double() - b[0].double()
    di = a[1].double() - b[1].double()
    mx = max(float(dr.abs().max()), float(di.abs().max()))
    l2 = float(torch.sqrt((dr * dr).sum() + (di * di).sum()))
    return mx, l2


def cuda_ms(fn, reps: int) -> float:
    """Median device time of one call, by CUDA events around each call,
    after one warm-up call."""
    import torch

    fn()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def qaoa_edges(n: int) -> list:
    """qaoa_maxcut(n)'s graph: the qubit pairs of its RZZ gates."""
    from quantum_simulations_tpu_torch.circuit import library

    return sorted({tuple(g["qubits"]) for g in library.qaoa_maxcut(n)["gates"]
                   if g["gate"] == "RZZ"})


def readout_masks(n: int) -> dict:
    """The readout's cases at width n: one string (qubits 0 and n - 1) and
    qaoa_maxcut(n)'s edges, as zstring_sum masks."""
    return {"K=1": [1 | (1 << (n - 1))],
            "edges": [(1 << i) | (1 << j) for i, j in qaoa_edges(n)]}


def zstring_library(re, im, mask: int):
    """<Z...Z> of one string as the port read it before zstring_sum, in
    plain torch: a sign table over the chunk's 2^26 indices, shared by
    the chunks, and one sign a chunk for the bits above."""
    import torch

    from quantum_simulations_tpu_torch.ops import sampling

    L = sampling._chunk(re)
    signs = 1.0 - 2.0 * sampling._bit_parity(L, mask & (L - 1),
                                             re.device).to(re.dtype)
    acc = torch.zeros((), dtype=torch.float64, device=re.device)
    for start in range(0, re.numel(), L):
        r, i = re[start:start + L], im[start:start + L]
        p = r * r
        p.addcmul_(i, i)
        sign = -1.0 if bin(start & mask).count("1") & 1 else 1.0
        acc += sign * p.mul_(signs).sum(dtype=torch.float64)
        del p
    return acc


def moved_rows(n: int, src) -> int:
    """Rows (of 128 amplitudes) that an involution ``src`` of the bits
    >= 7 moves: all but those equal in both bits of each 2-cycle."""
    pairs = sum(1 for b in range(7, n) if src[b] > b)
    return (1 << (n - 7)) - (1 << (n - 7 - pairs))


def phase_table(N: int, dterms, dev, fdtype=None):
    """exp(i theta) of a diag run over all N amplitudes, theta summed in
    float64, as a complex tensor of ``fdtype`` (float32): the operand of
    the library calls that apply a diag run.  It is a 2^28 table that the
    kernels never read, so those calls move more bytes than the function
    needs."""
    import torch

    from quantum_simulations_tpu_torch.ops import diag_kernels as dk

    th = dk.terms_theta(N, dterms.terms, torch.float64, dev)
    fdtype = torch.float32 if fdtype is None else fdtype
    return torch.complex(torch.cos(th).to(fdtype), torch.sin(th).to(fdtype))


def panel_library(xc, W, pos: int, ph=None):
    """One torch call computing a single-window panel at ``pos`` on the
    complex state ``xc`` (the lane panel at pos 0) and, with ``ph``
    (:func:`phase_table`), its diag epilogue in the same call."""
    import torch

    if pos == 0:
        xl = xc.view(-1, 128)
        if ph is None:
            Wt = W.T.contiguous()
            return lambda: xl @ Wt
        pv = ph.view(xl.shape)
        return lambda: torch.einsum("aj,ij,ai->ai", xl, W, pv)
    xv = xc.view(-1, W.shape[0], 1 << pos)
    if ph is None:
        return lambda: torch.einsum("ij,ajc->aic", W, xv)
    pv = ph.view(xv.shape)
    return lambda: torch.einsum("ij,ajc,aic->aic", W, xv, pv)


def dual_library(xc, op, cw, ph=None):
    """One torch call computing a (0, 7) dual pass on the complex state
    ``xc``, straddler included: an einsum of the lane W, the row W and,
    with a pre-straddler on (lane bit 6, row bit qb - 7), its U as
    (2, 2, 2, 2) in (bit 6, qb) order over the (A, 2^(6-dbit), 2,
    2^dbit, 2, 64) view.  The two panels commute (they act on different
    axes); the straddler comes first.  With ``ph`` (:func:`phase_table`)
    the diag epilogue rides the same einsum (no pre-straddler then)."""
    import torch

    lane, row = (op.first, op.second) if op.first.pos == 0 else (op.second, op.first)
    Wl, Wr = cw(lane.W), cw(row.W)
    if op.post_straddle is not None:
        raise ValueError("dual_library: no post-straddler on the main path")
    if op.pre_straddle is None:
        xv = xc.view(-1, 128, 128)
        if ph is not None:
            pv = ph.view(xv.shape)
            return lambda: torch.einsum("ij,ajm,lm,ail->ail", Wr, xv, Wl, pv)
        return lambda: torch.einsum("ij,ajm,lm->ail", Wr, xv, Wl)
    if ph is not None:
        raise ValueError("dual_library: no diag epilogue after a pre-straddler")
    _, qb, U = op.pre_straddle
    dbit = qb - 7
    H, L = 1 << (6 - dbit), 1 << dbit
    xv = xc.view(-1, H, 2, L, 2, 64)
    U4 = cw(U).view(2, 2, 2, 2)
    return lambda: torch.einsum("SRsr,ahrosm,lSm,ihRo->ail", U4, xv,
                                Wl.view(128, 2, 64), Wr.view(128, H, 2, L))


def pair_library(xc, qa: int, qb: int, U):
    """One torch call computing a two-qubit gate on the complex state
    ``xc``: an einsum of the (2, 2, 2, 2) coefficients C[ho, lo_, h, l]
    with the (A, 2, B, 2, C) view."""
    import torch

    from quantum_simulations_tpu_torch.ops import pair_kernels as pq

    n = xc.numel().bit_length() - 1
    hi, lo = max(qa, qb), min(qa, qb)
    xv = xc.view(1 << (n - hi - 1), 2, 1 << (hi - lo - 1), 2, 1 << lo)
    C4 = torch.as_tensor(pq.pair_coeffs(U, qa, qb), dtype=xc.dtype,
                         device=xc.device)
    return lambda: torch.einsum("HLhl,ahblc->aHbLc", C4, xv)


def cross_library(xc, cross):
    """One torch call computing ``bitperm_cross`` on the complex state
    ``xc``: ``permute(...).contiguous()`` of its factored bit view."""
    from quantum_simulations_tpu_torch.ops import bitperm_kernels as bk

    n = xc.numel().bit_length() - 1
    shape, dims = bk.permute_view(n, bk.cross_sources(n, cross))
    xs = xc.view(shape)
    return lambda: xs.permute(dims).contiguous()


# ---------------------------------------------------------------------------
# Phase 2: every kernel against its plain twin
# ---------------------------------------------------------------------------

def rand_terms(n: int, count: int, rng, scale: float = 5.0):
    """Random Möbius terms of order <= 3 (and the global term) on n
    qubits; with scale 5, sum |coeff| is about 2.5 * count rad."""
    terms = {(): float(rng.uniform(-scale, scale))}
    while len(terms) < count:
        qs = sorted(rng.choice(n, rng.integers(1, 4), replace=False))
        terms[tuple(int(q) for q in qs)] = float(rng.uniform(-scale, scale))
    return tuple(terms.items())


def case(label, kernel, kern, twin, exact=False, dim=128):
    """A phase-2 case; ``dim``: the panel width (a dim-128 lane or
    positioned panel runs on the tensor cores and is also held to its
    float64 twin, beside its float32 twin's distance to it)."""
    return dict(label=label, kernel=kernel, kern=kern, twin=twin, exact=exact,
                dim=dim)


def find(paired, kind, *, pos=None, diag=None):
    """The first (op, diag_terms) of a schedule with that op class name,
    position and (with diag=True) a diag epilogue."""
    for op, dt in paired:
        if (type(op).__name__ == kind and (pos is None or op.pos == pos)
                and (diag is None or (dt is not None) == diag)):
            return op, dt
    raise LookupError(f"no {kind} pos={pos} diag={diag} in the schedule")


def kernel_cases(n: int, scheds, rng):
    """The phase-2 cases at size n."""
    from quantum_simulations_tpu_torch.circuit.panelize import (
        DualPanelOp, WindowPanelOp,
    )
    from quantum_simulations_tpu_torch.ops import bitperm_kernels as bk
    from quantum_simulations_tpu_torch.ops import diag_kernels as dk
    from quantum_simulations_tpu_torch.ops import panel_kernels as pk

    cases = []
    if n == NQ:
        ops = [op for op, _ in scheds["nonstab28"]]
        for op in ops:
            if isinstance(op, WindowPanelOp):
                cases.append(case(
                    f"positioned pos{op.pos}", "positioned_panel",
                    lambda x, op=op: pk.positioned_panel(*x, op.W, op.pos),
                    lambda x, op=op: pk.positioned_panel_plain(*x, op.W, op.pos)))
            elif isinstance(op, DualPanelOp):
                tag = "dual" + (" +pre" if op.pre_straddle else "") + (
                    " +post" if op.post_straddle else "")
                args = (op.first.W, op.first.pos, op.second.W, op.second.pos)
                kw = dict(straddle=op.pre_straddle, post_straddle=op.post_straddle)
                cases.append(case(
                    tag, "dual_panel",
                    lambda x, a=args, k=kw: pk.dual_panel(*x, *a, **k),
                    lambda x, a=args, k=kw: pk.dual_panel_plain(*x, *a, **k)))
        W0 = ops[0].first.W
        cases.append(case("lane (2^21, 128)", "lane_panel",
                          lambda x: pk.lane_panel(*x, W0),
                          lambda x: pk.lane_panel_plain(*x, W0)))
        diag43 = next(op.terms for op, _ in scheds["qaoa28"]
                      if type(op).__name__ == "DiagOp")
        cases.append(case(f"fused_diag qaoa28 run ({len(diag43)} terms)",
                          "fused_diag",
                          lambda x: dk.fused_diag(*x, diag43),
                          lambda x: dk.fused_diag_plain(*x, diag43)))
        op, dt = find(scheds["qft28"], "WindowPanelOp", diag=True)
        cases.append(case(
            f"positioned pos{op.pos} +diag{len(dt)} (qft28)", "positioned_panel",
            lambda x: pk.positioned_panel(*x, op.W, op.pos, diag_terms=dt),
            lambda x: pk.positioned_panel_plain(*x, op.W, op.pos, diag_terms=dt)))
        swap, _ = find(scheds["qft28"], "BitPermGridOp")
        gm = dict(swap.grid_map)
        cases.append(case("bitperm_swap qft28", "bitperm_swap",
                          lambda x: bk.bitperm_swap(*x, swap.pairs, gm),
                          lambda x: bk.bitperm_swap_plain(*x, swap.pairs, gm),
                          exact=True))
        cases.append(case("bitperm_transpose", "bitperm_transpose",
                          lambda x: bk.bitperm_transpose(*x),
                          lambda x: bk.bitperm_transpose_plain(*x),
                          exact=True))
        dj = gate_ops(scheds["deutsch_jozsa28"])
        for qs in DJ_GATES:
            cases.append(pair_case(f"deutsch_jozsa28 {qs}", dj[qs]))
        qpe = gate_ops(scheds["qpe28"])
        qs = next(iter(qpe))
        cases.append(pair_case(f"qpe28 {qs}", qpe[qs]))
        ms, _ = find(scheds["qpe28"], "MultiSwapOp")
        cases.append(case(f"bitperm_swap qpe28 multiswap {ms.pairs}",
                          "bitperm_swap",
                          lambda x: bk.bitperm_swap(*x, ms.pairs, {}),
                          lambda x: bk.bitperm_swap_plain(*x, ms.pairs, {}),
                          exact=True))
        wq = gate_ops(scheds["w_qft28"])
        for qs in ((6, 7), (7, 6)):
            cases.append(pair_case(f"w_qft28 {qs}", wq[qs]))
        bp, _ = find(scheds["qft28 nodecomp"], "BitPermOp")
        cases.append(case(f"bitperm_cross qft28 nodecomp {bp.cross}",
                          "bitperm_cross",
                          lambda x: bk.bitperm_cross(*x, bp.cross),
                          lambda x: bk.bitperm_cross_plain(*x, bp.cross),
                          exact=True))
        # Panel mode: a rotation step's transpose at the shapes of r = 7,
        # 21 and 14, and nonstab28's first panel with the rotated store.
        for rb in (7, 21, 14):
            cases.append(transpose_case(n, rb))
        Wp = panel_W(scheds["nonstab28 panel"])
        cases.append(case("lane +rotate (nonstab28 panel 1)", "lane_panel",
                          lambda x: pk.lane_panel(*x, Wp, rotate=True),
                          lambda x: pk.lane_panel_plain(*x, Wp, rotate=True)))
        return cases
    if n < 14:
        # Ragged: every rotation step of a small state (a dim below 128)
        # and the rotated store of R < 128 rows.
        cases = [transpose_case(n, rb) for rb in range(1, n)]
        W = rand_unitary(128, rng)
        cases.append(case("lane +rotate ragged", "lane_panel",
                          lambda x: pk.lane_panel(*x, W, rotate=True),
                          lambda x: pk.lane_panel_plain(*x, W, rotate=True)))
        # Dim 128 below one 128-row tile (R = 2^(n - 7)) and below pos 7
        # (C = 4 columns a tile): the tensor-core kernels' ragged loads.
        terms = rand_terms(n, 20, rng)
        cases.append(case("lane ragged", "lane_panel",
                          lambda x: pk.lane_panel(*x, W),
                          lambda x: pk.lane_panel_plain(*x, W)))
        cases.append(case("lane +diag ragged", "lane_panel",
                          lambda x: pk.lane_panel(*x, W, diag_terms=terms),
                          lambda x: pk.lane_panel_plain(*x, W, diag_terms=terms)))
        cases.append(case("positioned dim128 pos2", "positioned_panel",
                          lambda x: pk.positioned_panel(*x, W, 2),
                          lambda x: pk.positioned_panel_plain(*x, W, 2)))
        return cases
    for pos in (7, 8, 9):
        W = rand_unitary(128, rng)
        cases.append(case(f"positioned pos{pos}", "positioned_panel",
                          lambda x, W=W, p=pos: pk.positioned_panel(*x, W, p),
                          lambda x, W=W, p=pos: pk.positioned_panel_plain(*x, W, p)))
    W64 = rand_unitary(64, rng)
    cases.append(case("positioned ragged dim64 pos14", "positioned_panel",
                      lambda x: pk.positioned_panel(*x, W64, n - 6),
                      lambda x: pk.positioned_panel_plain(*x, W64, n - 6),
                      dim=64))
    Wa, Wb = rand_unitary(128, rng), rand_unitary(128, rng)
    cases.append(case("dual (7,0)", "dual_panel",
                      lambda x: pk.dual_panel(*x, Wa, 7, Wb, 0),
                      lambda x: pk.dual_panel_plain(*x, Wa, 7, Wb, 0)))
    pre, post = (6, 10, rand_unitary(4, rng)), (6, 13, rand_unitary(4, rng))
    strad = dict(straddle=pre, post_straddle=post)
    cases.append(case("dual (0,7) complex pre qb10 + post qb13", "dual_panel",
                      lambda x: pk.dual_panel(*x, Wb, 0, Wa, 7, **strad),
                      lambda x: pk.dual_panel_plain(*x, Wb, 0, Wa, 7, **strad)))
    terms = rand_terms(n, 60, rng)
    cases.append(case(f"fused_diag random ({len(terms)} terms)", "fused_diag",
                      lambda x: dk.fused_diag(*x, terms),
                      lambda x: dk.fused_diag_plain(*x, terms)))
    for pos in (7, 13):
        cases.append(case(
            f"positioned pos{pos} +diag random", "positioned_panel",
            lambda x, p=pos: pk.positioned_panel(*x, Wa, p, diag_terms=terms),
            lambda x, p=pos: pk.positioned_panel_plain(*x, Wa, p, diag_terms=terms)))
    cases.append(case("lane +diag random", "lane_panel",
                      lambda x: pk.lane_panel(*x, Wb, diag_terms=terms),
                      lambda x: pk.lane_panel_plain(*x, Wb, diag_terms=terms)))
    dkw = dict(strad, diag_terms=terms)
    cases.append(case("dual (0,7) pre + post +diag random", "dual_panel",
                      lambda x: pk.dual_panel(*x, Wb, 0, Wa, 7, **dkw),
                      lambda x: pk.dual_panel_plain(*x, Wb, 0, Wa, 7, **dkw)))
    pairs, gm = ((7, 19), (8, 18), (9, 17), (10, 16)), {11: 13, 13: 15, 15: 11}
    cases.append(case("bitperm_swap pairs + 3-cycle", "bitperm_swap",
                      lambda x: bk.bitperm_swap(*x, pairs, gm),
                      lambda x: bk.bitperm_swap_plain(*x, pairs, gm), exact=True))
    cases.append(case("bitperm_transpose", "bitperm_transpose",
                      lambda x: bk.bitperm_transpose(*x),
                      lambda x: bk.bitperm_transpose_plain(*x), exact=True))
    cross = (19, 13, 17, 14, 18, 16, 15)
    cases.append(case(f"bitperm_cross {cross}", "bitperm_cross",
                      lambda x: bk.bitperm_cross(*x, cross),
                      lambda x: bk.bitperm_cross_plain(*x, cross), exact=True))
    for qa, qb in PAIR_CLASSES:
        U = rand_unitary(4, rng)
        cases.append(pair_case(f"random U ({qa}, {qb})",
                               ((qa, qb), U)))
    cases.append(transpose_case(n, 9))
    cases.append(case("lane +rotate random", "lane_panel",
                      lambda x: pk.lane_panel(*x, Wb, rotate=True),
                      lambda x: pk.lane_panel_plain(*x, Wb, rotate=True)))
    return cases


def transpose_case(n: int, rb: int):
    """``tiled_transpose`` of the (2^(n - rb), 2^rb) view (the rotation
    step r = rb) against its twin, bit for bit."""
    from quantum_simulations_tpu_torch.ops import bitperm_kernels as bk

    rows, cols = 1 << (n - rb), 1 << rb
    return case(f"tiled_transpose (2^{n - rb}, 2^{rb})", "tiled_transpose",
                lambda x: bk.tiled_transpose(*x, rows, cols),
                lambda x: bk.tiled_transpose_plain(*x, rows, cols), exact=True)


def panel_W(items):
    """The W of the first PanelOp of a panel schedule [(op, rotated)]."""
    return next(op.W for op, _ in items if type(op).__name__ == "PanelOp")


# deutsch_jozsa28's gates for pair_update's column body (lo <= 12) and
# row body, and for mixed_pair.
DJ_GATES = ((7, NQ - 1), (NQ - 8, NQ - 1), (0, NQ - 1))

# (qa, qb) at n = 20: lo in {0, 1, 2, 6, 7, 12, 13}, both qubit orders,
# every wrapper: mixed_low_pair (hi 7..9), mixed_pair (hi >= 10),
# pair_update column (lo <= 12) and row (lo >= 13) bodies.
PAIR_CLASSES = ((0, 7), (9, 1), (2, 8), (6, 7), (7, 6),
                (0, 19), (12, 1), (2, 10), (6, 15),
                (7, 11), (19, 7), (12, 16), (13, 14), (17, 13))


def gate_ops(paired) -> dict:
    """{qubits: (qubits, U)} of a schedule's PhysGateOps."""
    return {op.qubits: (op.qubits, op.U) for op, _ in paired
            if type(op).__name__ == "PhysGateOp"}


def pair_wrapper(qa: int, qb: int) -> str:
    """The pair wrapper (and launch key) that takes (qa, qb)."""
    from quantum_simulations_tpu_torch.ops import pair_kernels as pq

    if pq.pair_update_supported(qa, qb):
        return "pair_update"
    if pq.mixed_pair_supported(qa, qb):
        return "mixed_pair"
    return "mixed_low_pair"


def pair_case(label: str, gate):
    """A pair-kernel case: the wrapper that takes the gate's qubits
    against the plain twin."""
    from quantum_simulations_tpu_torch.ops import pair_kernels as pq

    (qa, qb), U = gate
    name = pair_wrapper(qa, qb)
    wrap = getattr(pq, name)
    return case(f"{name} {label}", name,
                lambda x: wrap(*x, qa, qb, U),
                lambda x: pq.pair_gate_plain(*x, qa, qb, U))


def inplace_cases(n: int, rng) -> list:
    """The phase-2 in-place cases at size n (random operands): each
    ``fn(re, im, inplace)`` runs a kernel's aliasing instance or its
    out-of-place one; ``twin(x)`` is the plain twin."""
    import numpy as np

    from quantum_simulations_tpu_torch.ops import bitperm_kernels as bk
    from quantum_simulations_tpu_torch.ops import dense
    from quantum_simulations_tpu_torch.ops import diag_kernels as dk
    from quantum_simulations_tpu_torch.ops import pair_kernels as pq
    from quantum_simulations_tpu_torch.ops import panel_kernels as pk

    Wa, Wb, W64 = rand_unitary(128, rng), rand_unitary(128, rng), rand_unitary(64, rng)
    terms = rand_terms(n, 60, rng)
    strad = dict(straddle=(6, 10, rand_unitary(4, rng)),
                 post_straddle=(6, 13, rand_unitary(4, rng)))
    cases = [
        case("lane", "lane_panel",
             lambda re, im, ip: pk.lane_panel(re, im, Wb, inplace=ip),
             lambda x: pk.lane_panel_plain(*x, Wb)),
        case("lane +diag", "lane_panel",
             lambda re, im, ip: pk.lane_panel(re, im, Wb, diag_terms=terms,
                                              inplace=ip),
             lambda x: pk.lane_panel_plain(*x, Wb, diag_terms=terms)),
        case("positioned ragged dim64 pos14", "positioned_panel",
             lambda re, im, ip: pk.positioned_panel(re, im, W64, n - 6, inplace=ip),
             lambda x: pk.positioned_panel_plain(*x, W64, n - 6), dim=64),
        case("dual (7,0)", "dual_panel",
             lambda re, im, ip: pk.dual_panel(re, im, Wa, 7, Wb, 0, inplace=ip),
             lambda x: pk.dual_panel_plain(*x, Wa, 7, Wb, 0)),
        case("dual (0,7) pre + post +diag", "dual_panel",
             lambda re, im, ip: pk.dual_panel(re, im, Wb, 0, Wa, 7, diag_terms=terms,
                                              inplace=ip, **strad),
             lambda x: pk.dual_panel_plain(*x, Wb, 0, Wa, 7, diag_terms=terms,
                                           **strad)),
        case(f"fused_diag ({len(terms)} terms)", "fused_diag",
             lambda re, im, ip: dk.fused_diag(re, im, terms, inplace=ip),
             lambda x: dk.fused_diag_plain(*x, terms)),
        case("bitperm_transpose", "bitperm_transpose",
             lambda re, im, ip: bk.bitperm_transpose(re, im, inplace=ip),
             lambda x: bk.bitperm_transpose_plain(*x), exact=True),
    ]
    for pos, dt in ((7, None), (9, None), (13, terms)):
        cases.append(case(
            f"positioned pos{pos}" + (" +diag" if dt else ""), "positioned_panel",
            lambda re, im, ip, p=pos, dt=dt: pk.positioned_panel(
                re, im, Wa, p, diag_terms=dt, inplace=ip),
            lambda x, p=pos, dt=dt: pk.positioned_panel_plain(*x, Wa, p, diag_terms=dt)))
    cross = (19, 13, 17, 14, 18, 16, 15)
    cases.append(case(f"bitperm_cross {cross}", "bitperm_cross",
                      lambda re, im, ip: bk.bitperm_cross(re, im, cross, inplace=ip),
                      lambda x: bk.bitperm_cross_plain(*x, cross), exact=True))
    for name, qa, qb in (("pair_update", 12, 16), ("pair_update", 17, 13),
                         ("mixed_pair", 0, 19), ("mixed_pair", 15, 1),
                         ("mixed_low_pair", 6, 7), ("mixed_low_pair", 9, 2)):
        U = rand_unitary(4, rng)
        cases.append(case(
            f"{name} ({qa}, {qb})", name,
            lambda re, im, ip, f=getattr(pq, name), qa=qa, qb=qb, U=U: f(
                re, im, qa, qb, U, inplace=ip),
            lambda x, qa=qa, qb=qb, U=U: pq.pair_gate_plain(*x, qa, qb, U)))
    # midpair for lo 7, 8, 9 in both orders; out of place the same kernel.
    for (qa, qb), U in zip(((7, 11), (11, 7), (8, 14), (14, 8), (9, 19), (19, 9),
                            (9, 16)), [rand_unitary(4, rng) for _ in range(6)]
                           + [dense._SWAP4]):
        cases.append(case(
            f"midpair ({qa}, {qb})", "midpair",
            lambda re, im, ip, qa=qa, qb=qb, U=U: (
                pq.midpair(re, im, qa, qb, U) if ip
                else pq._pair_gate("midpair", re, im, qa, qb, U, False)),
            lambda x, qa=qa, qb=qb, U=U: pq.pair_gate_plain(*x, qa, qb, U)))
    # bitperm_involution on random involutions of the bits 7..n-1 (out of
    # place: the same transpositions as one bitperm_swap gather), then
    # bitperm_swap in place on random permutations (at most two passes).
    for _ in range(3):
        bits = [int(b) for b in rng.permutation(np.arange(7, n))]
        k = int(rng.integers(1, (n - 7) // 2 + 1))
        pairs = tuple((bits[2 * i], bits[2 * i + 1]) for i in range(k))
        src = bk.bit_sources(n, pairs, {})
        cases.append(case(
            f"bitperm_involution {k} random pairs", "bitperm_involution",
            lambda re, im, ip, p=pairs, s=src: (
                bk.bitperm_involution(re, im, s) if ip
                else bk.bitperm_swap(re, im, p, {})),
            lambda x, p=pairs: bk.bitperm_swap_plain(*x, p, {}), exact=True))
    for _ in range(3):
        top = [int(b) for b in rng.permutation(np.arange(10, n))]
        gm = {10 + i: b for i, b in enumerate(top)}
        pairs = (tuple(int(b) for b in rng.choice([7, 8, 9], 2, replace=False)),)
        cases.append(case(
            "bitperm_swap in place, random permutation", "bitperm_involution",
            lambda re, im, ip, p=pairs, g=gm: bk.bitperm_swap(re, im, p, g,
                                                               inplace=ip),
            lambda x, p=pairs, g=gm: bk.bitperm_swap_plain(*x, p, g), exact=True))
    return cases


def check_inplace(dev, n: int, rng, worst: dict) -> None:
    """Each in-place case on a copy of one state: the result is the given
    planes, equal bit for bit to the out-of-place run and within TOL_L2
    of the plain twin (equal for a bit permutation)."""
    import torch

    x = unit_state(n, SEED + 100 + n, dev)
    for c in inplace_cases(n, rng):
        out = c["kern"](x[0], x[1], False)
        re, im = x[0].clone(), x[1].clone()
        got = c["kern"](re, im, True)
        torch.cuda.synchronize()
        want = c["twin"](x)
        mx, l2 = diff((re, im), want)
        aliased = got[0] is re and got[1] is im
        same = torch.equal(re, out[0]) and torch.equal(im, out[1])
        ok = (aliased and same and l2 <= TOL_L2
              and bool(torch.isfinite(re).all() and torch.isfinite(im).all()))
        if c["exact"]:
            ok = ok and torch.equal(re, want[0]) and torch.equal(im, want[1])
        rec = dict(n=n, case="inplace " + c["label"], kernel=c["kernel"],
                   max_abs_err=mx, l2_diff=l2, equals_out_of_place=same)
        f64 = ""
        if c["kernel"] in TC_KERNELS and c["dim"] == 128:
            rec.update(against_f64_twin(c, x, (re, im), want))
            ok = ok and rec["l2_vs_f64"] <= tol_f64(c)
            f64 = (f" vs_f64: l2={rec['l2_vs_f64']:.3e} "
                   f"f32_twin_l2={rec['f32_twin_l2_vs_f64']:.3e}")
        log(f"check n={n} inplace {c['label']:<34} max_abs_err={mx:.3e} "
            f"l2_diff={l2:.3e} aliased={aliased} =out_of_place={same}"
            f"{' exact' if c['exact'] else ''}{f64} {'ok' if ok else 'FAIL'}")
        RECORD["cases"].append(rec)
        if not ok:
            raise AssertionError(f"{c['kernel']} in place ({c['label']}, n={n}) "
                                 f"disagrees: aliased={aliased}, equal to out of "
                                 f"place={same}, ||diff||_2 = {l2:.3e}")
        worst[c["kernel"]] = max(worst.get(c["kernel"], 0.0), mx)
        del out, got, want, re, im
    del x
    torch.cuda.empty_cache()


def tol_f64(c) -> float:
    """The bound on a tensor-core case's ||diff||_2 to its float64 twin:
    the lane / positioned kernel's precision rule (TOL_TC_F64), the
    dual's TOL_L2."""
    return TOL_TC_F64 if c["kernel"] in ("lane_panel", "positioned_panel") else TOL_L2


def against_f64_twin(c, x, got, want32) -> dict:
    """||diff||_2 of a tensor-core panel's result ``got`` and of its
    float32 twin's ``want32`` (same operands) against the plain twin in
    float64."""
    want = c["twin"]((x[0].double(), x[1].double()))
    out = dict(l2_vs_f64=diff(got, want)[1],
               f32_twin_l2_vs_f64=diff(want32, want)[1])
    del want
    return out


def check_kernels(dev, scheds) -> dict:
    import numpy as np
    import torch

    worst: dict = {}
    check_inplace(dev, 20, np.random.default_rng(SEED + 1), worst)
    rng = np.random.default_rng(SEED)
    for n in (10, 20, NQ):
        x = unit_state(n, SEED + n, dev)
        for c in kernel_cases(n, scheds, rng):
            got = c["kern"](x)
            torch.cuda.synchronize()
            want = c["twin"](x)
            mx, l2 = diff(got, want)
            ok = l2 <= TOL_L2 and bool(torch.isfinite(got[0]).all())
            if c["exact"]:
                ok = ok and torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            rec = dict(n=n, case=c["label"], kernel=c["kernel"],
                       max_abs_err=mx, l2_diff=l2)
            f64 = ""
            if c["kernel"] in TC_KERNELS and c["dim"] == 128:
                rec.update(against_f64_twin(c, x, got, want))
                ok = ok and rec["l2_vs_f64"] <= tol_f64(c)
                f64 = (f" vs_f64: l2={rec['l2_vs_f64']:.3e} "
                       f"f32_twin_l2={rec['f32_twin_l2_vs_f64']:.3e}")
            log(f"check n={n} {c['label']:<42} max_abs_err={mx:.3e} "
                f"l2_diff={l2:.3e}{' exact' if c['exact'] else ''}{f64} "
                f"{'ok' if ok else 'FAIL'}")
            RECORD["cases"].append(rec)
            if not ok:
                raise AssertionError(f"{c['kernel']} ({c['label']}, n={n}) "
                                     f"disagrees with its plain twin: "
                                     f"||diff||_2 = {l2:.3e}")
            worst[c["kernel"]] = max(worst.get(c["kernel"], 0.0), mx)
            del got, want
        del x
        torch.cuda.empty_cache()
    check_readout(dev, worst)
    return worst


def check_readout(dev, worst: dict) -> None:
    """zstring_sum against its plain twin at n = 20 and NQ, on a complex64
    tensor's views and on two contiguous planes, with one string and with
    qaoa_maxcut(n)'s edges: within TOL_ZSTRING, bit-equal when
    repeated, one launch a call."""
    import torch

    from quantum_simulations_tpu_torch.ops import readout_kernels as rk
    from quantum_simulations_tpu_torch.ops import sampling

    for n in (20, NQ):
        x = unit_state(n, SEED + 2 * n, dev)
        xc = torch.complex(*x)
        layouts = {"interleaved": (xc.real, xc.imag), "planar": x}
        for layout, (re, im) in layouts.items():
            for case, masks in readout_masks(n).items():
                rk.reset_counts()
                got = sampling.zstring_sums(re, im, masks)
                again = sampling.zstring_sums(re, im, masks)
                torch.cuda.synchronize()
                calls = (rk.LAUNCHES["zstring_sum"], rk.PLAIN_CALLS["zstring_sum"])
                want = sampling.zstring_sums_plain(re, im, masks)
                mx = float((got - want).abs().max())
                exact = torch.equal(got, again)
                ok = mx <= TOL_ZSTRING and exact and calls == (2, 0)
                label = f"zstring_sum {layout} {case} (K={len(masks)})"
                log(f"check n={n} {label:<42} max_abs_err={mx:.3e} "
                    f"repeat {'exact' if exact else 'DIFFERS'} "
                    f"launches, plain={calls} {'ok' if ok else 'FAIL'}")
                RECORD["cases"].append(dict(n=n, case=label, kernel="zstring_sum",
                                            max_abs_err=mx, exact_repeat=exact))
                if not ok:
                    raise AssertionError(f"zstring_sum ({label}, n={n}) "
                                         f"disagrees with its plain twin: {mx:.3e}, "
                                         f"repeat exact {exact}, calls {calls}")
                worst["zstring_sum"] = max(worst.get("zstring_sum", 0.0), mx)
                del got, again, want
        del x, xc, layouts, re, im
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 3: the main path
# ---------------------------------------------------------------------------

def request(label: str, run) -> tuple:
    """Run one request with the counters set to 0 just before it; check
    its launches against WANT, that no plain twin ran and that the plain
    torch gate paths ran DENSE[label] times (0 unless listed)."""
    reset_counts()
    t0 = time.perf_counter()
    out = run()
    wall = time.perf_counter() - t0
    from quantum_simulations_tpu_torch.ops import dense

    got, plain, gates = launches(), plain_calls(), dense.GATE_CALLS
    log(f"main {label}: {wall:.3f} s (first call: schedule, operand upload, "
        f"host copy) launches={got} plain_calls={plain} dense_gate_calls={gates}")
    want_dense = DENSE.get(label, 0)
    if got != WANT[label] or plain or gates != want_dense:
        raise AssertionError(f"{label} launch counts {got} / plain {plain} / "
                             f"dense {gates}, want {WANT[label]}, no plain "
                             f"call and {want_dense} dense calls")
    return out, got, wall


def against_f64(label: str, psi, cd, dev, initial_state=None,
                mode: str = "window") -> dict:
    """|norm2 - 1| and ||psi - psi_f64||_2 against the plain twins in
    float64 on the card running the same mode's schedule, from the same
    initial state."""
    import numpy as np
    import torch

    from quantum_simulations_tpu_torch.runtime import simulator

    if isinstance(psi, np.ndarray):
        psi = torch.from_numpy(psi)
    got = psi.to(dev).to(torch.complex128)
    del psi
    nrm2 = norm2(got.real, got.imag)
    finite = bool(torch.isfinite(torch.view_as_real(got)).all())
    ref = simulator.simulate(cd, dtype="complex128", mode=mode,
                             device=dev, plain=True, initial_state=initial_state)
    l2 = float(torch.linalg.vector_norm(got - ref))
    mx = float((got - ref).abs().max())
    del got, ref
    torch.cuda.empty_cache()
    log(f"main {label} vs plain float64 twins on the card: norm2={nrm2:.9f} "
        f"|norm2-1|={abs(nrm2 - 1):.3e} ||psi-psi_f64||_2={l2:.3e} "
        f"max_abs={mx:.3e}")
    if not (finite and abs(nrm2 - 1) <= 1e-5 and l2 <= 1e-5):
        raise AssertionError(f"{label} output is off the float64 reference")
    return dict(norm2=nrm2, l2_vs_f64=l2, max_abs_vs_f64=mx)


def energy_request(psi, dev, counts: dict) -> dict:
    """qaoa28's state read as an energy request: ``maxcut_energy`` over
    its edges with random weights, one zstring_sum launch and nothing
    else, within TOL_ZSTRING per unit weight of the same sum over the
    twin's <Z_i Z_j>."""
    import numpy as np
    import torch

    from quantum_simulations_tpu_torch.ops import observables, sampling

    label = "qaoa28 energy"
    edges = qaoa_edges(NQ)
    w = [float(v) for v in np.random.default_rng(SEED).uniform(0.1, 2.0, len(edges))]
    dpsi = torch.as_tensor(psi, device=dev)
    energy, counts[label], wall = request(
        label, lambda: observables.maxcut_energy(dpsi, edges, w))
    zz = sampling.zstring_sums_plain(
        dpsi.real, dpsi.imag, [(1 << i) | (1 << j) for i, j in edges]).tolist()
    want = sum(0.5 * wij * (1.0 - z) for z, wij in zip(zz, w))
    err = abs(energy - want) / sum(w)
    del dpsi
    ok = err <= TOL_ZSTRING
    log(f"main {label}: {len(edges)} edges, energy={energy:.12f} twin's "
        f"{want:.12f}, |diff| / sum(w)={err:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label} is off the twin's energy: {err:.3e}")
    return dict(first_call_s=wall, edges=len(edges), energy=energy,
                twin_energy=want, err_per_weight=err)


def main_path(dev) -> dict:
    import numpy as np
    import torch

    from quantum_simulations_tpu_torch import SimulatorConfig, api
    from quantum_simulations_tpu_torch.runtime import capacity, simulator

    cfg = SimulatorConfig(mode="window")
    cap = SimulatorConfig(mode="capacity")
    counts: dict = {}
    main: dict = {}
    cds = circuits()

    def in_place(label, cd, psi, psi0=None):
        """The request once more through the capacity tier (every pass in
        place): its state equals the window run's ``psi`` within
        TOL_CAPACITY.  From ``psi0``: copies of its planes, updated in
        place."""
        if psi0 is None:
            run = lambda: api.simulate(cd, cap, device=dev)  # noqa: E731
        else:
            run = lambda: capacity.simulate_capacity(  # noqa: E731
                cd, device=dev, initial_planes=(psi0.real.contiguous(),
                                                psi0.imag.contiguous()))
        key = label + " capacity"
        res, counts[key], wall = request(key, run)
        ref = torch.as_tensor(psi, device=dev)
        l2 = plane_distance((res.re, res.im), (ref.real, ref.imag))
        del res, ref
        log(f"main {key}: ||psi_capacity - psi_window||_2 = {l2:.3e}")
        if not l2 <= TOL_CAPACITY:
            raise AssertionError(f"{key} is off the window-mode state")
        main[key] = dict(first_call_s=wall, l2_vs_window=l2)

    cd = cds["nonstab28"]
    psi, counts["nonstab28"], wall = request(
        "nonstab28", lambda: api.simulate(cd, cfg, device=dev))
    main["nonstab28"] = dict(first_call_s=wall, **against_f64(
        "nonstab28", psi, cd, dev))
    in_place("nonstab28", cd, psi)
    del psi

    # The unpaired-panel schedule, whose pos-0 panel runs lane_panel.
    # H on every qubit: every amplitude is 2^-14.
    with env_switch("QST_PANEL_PAIR_FUSE", "0"):
        wall_psi, counts["hadamard_wall28"], wall = request(
            "hadamard_wall28",
            lambda: api.simulate(cds["hadamard_wall28"], cfg, device=dev))
        in_place("hadamard_wall28", cds["hadamard_wall28"], wall_psi)
    exact = 2.0 ** (-NQ / 2)
    hw_err = float(np.max(np.abs(wall_psi - exact)))
    del wall_psi
    log(f"main hadamard_wall28 (QST_PANEL_PAIR_FUSE=0): max |psi - 2^-14| = "
        f"{hw_err:.3e}")
    if not hw_err <= 1e-6:
        raise AssertionError("hadamard_wall28 is off the exact state")
    main["hadamard_wall28"] = dict(first_call_s=wall, max_err_vs_exact=hw_err)

    # QFT|0> is uniform: every amplitude 2^-14.
    qft = cds["qft28"]
    psi, counts["qft28"], wall = request(
        "qft28", lambda: api.simulate(qft, cfg, device=dev))
    qft_err = float(np.max(np.abs(psi - exact)))
    log(f"main qft28: max |psi - 2^-14| = {qft_err:.3e}")
    if not qft_err <= 1e-6:
        raise AssertionError("qft28 of |0> is off the uniform state")
    main["qft28"] = dict(first_call_s=wall, max_err_vs_exact=qft_err,
                         **against_f64("qft28", psi, qft, dev))
    in_place("qft28", qft, psi)
    del psi

    qaoa = cds["qaoa28"]
    psi, counts["qaoa28"], wall = request(
        "qaoa28", lambda: api.simulate(qaoa, cfg, device=dev))
    main["qaoa28"] = dict(first_call_s=wall, **against_f64(
        "qaoa28", psi, qaoa, dev))
    in_place("qaoa28", qaoa, psi)
    main["qaoa28 energy"] = energy_request(psi, dev, counts)
    del psi

    re0, im0 = unit_state(NQ, SEED + 1, dev)
    psi0 = torch.complex(re0, im0)
    del re0, im0
    psi, counts["qft28 random state"], wall = request(
        "qft28 random state",
        lambda: simulator.simulate(qft, mode="window", device=dev,
                                   initial_state=psi0))
    main["qft28 random state"] = dict(first_call_s=wall, **against_f64(
        "qft28 random state", psi, qft, dev, initial_state=psi0))
    in_place("qft28 random state", qft, psi, psi0)
    del psi

    # The two-qubit gate requests.
    for label in ("qpe28", "qft_adder28", "deutsch_jozsa28", "w_qft28"):
        cd = cds[label]
        psi, counts[label], wall = request(
            label, lambda cd=cd: api.simulate(cd, cfg, device=dev))
        main[label] = dict(first_call_s=wall, **against_f64(label, psi, cd, dev))
        in_place(label, cd, psi)
        del psi

    # qft28 with its SWAP network as one BitPermOp: still uniform.
    with nodecomp():
        psi, counts["qft28 nodecomp"], wall = request(
            "qft28 nodecomp", lambda: api.simulate(qft, cfg, device=dev))
        nd_err = float(np.max(np.abs(psi - exact)))
        log(f"main qft28 nodecomp (QST_BITPERM_DECOMP=0): max |psi - 2^-14| "
            f"= {nd_err:.3e}")
        if not nd_err <= 1e-6:
            raise AssertionError("qft28 nodecomp of |0> is off the uniform state")
        main["qft28 nodecomp"] = dict(
            first_call_s=wall, max_err_vs_exact=nd_err,
            **against_f64("qft28 nodecomp", psi, qft, dev))
        in_place("qft28 nodecomp", qft, psi)
        del psi

    qpe = cds["qpe28"]
    psi, counts["qpe28 random state"], wall = request(
        "qpe28 random state",
        lambda: simulator.simulate(qpe, mode="window", device=dev,
                                   initial_state=psi0))
    main["qpe28 random state"] = dict(first_call_s=wall, **against_f64(
        "qpe28 random state", psi, qpe, dev, initial_state=psi0))
    in_place("qpe28 random state", qpe, psi, psi0)
    del psi, psi0
    torch.cuda.empty_cache()
    RECORD["main"] = dict(launches=counts, **main)
    return counts


def panel_path(dev) -> dict:
    """Phase 3, panel and fused mode: each request of PANEL28 and FUSED28
    through ``api.simulate`` (``SimulatorConfig(mode="panel")``, the CLI's
    default, and ``SimulatorConfig()``, the API's), counted from 0, with
    its peak device memory above what was held before it, its distance
    to the float64 twins of the same schedule and to the window run's
    state; then ``python -m quantum_simulations_tpu_torch run ghz28.json``
    as a subprocess (a process of its own: its launches are not counted
    here; ghz28 panel above runs the same path)."""
    import gc

    import torch

    from quantum_simulations_tpu_torch import SimulatorConfig, api

    cds = panel_circuits()
    counts: dict = {}
    out: dict = {}
    plane = 4 << NQ                  # one float32 plane, bytes
    for label in PANEL28 + FUSED28:
        name, mode = label.split()
        cd = cds[name]
        cfg = SimulatorConfig(mode="panel") if mode == "panel" else SimulatorConfig()
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        psi, counts[label], wall = request(
            label, lambda cd=cd, cfg=cfg: api.simulate(cd, cfg, device=dev))
        peak = torch.cuda.max_memory_allocated() - held
        rec = dict(first_call_s=wall, peak_gib=peak / GIB,
                   peak_planes=peak / plane,
                   **against_f64(label, psi, cd, dev, mode=mode))
        a = torch.from_numpy(psi).to(dev)
        del psi
        b = torch.from_numpy(api.simulate(cd, SimulatorConfig(mode="window"),
                                          device=dev)).to(dev)
        rec["l2_vs_window"] = plane_distance((a.real, a.imag), (b.real, b.imag))
        del a, b
        log(f"main {label}: peak {peak / GIB:.3f} GiB above {held / GIB:.3f} "
            f"GiB held ({peak / plane:.3f} planes), ||psi - psi_window||_2 = "
            f"{rec['l2_vs_window']:.3e}")
        ok = rec["l2_vs_window"] <= TOL_L2
        if label == "nonstab28 panel":
            ok = ok and peak <= PANEL_PEAK_PLANES * plane + GIB
        if not ok:
            raise AssertionError(f"{label} fails its check: {rec}")
        out[label] = rec

    gc.collect()
    torch.cuda.empty_cache()
    root = Path(__file__).resolve().parent
    path = root / "chiprun_out" / "ghz28.json"
    path.parent.mkdir(exist_ok=True)
    path.write_text(json.dumps(cds["ghz28"]))
    cmd = [sys.executable, "-m", "quantum_simulations_tpu_torch", "run",
           str(path), "--top", "2", "--device", dev.type]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                          timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"the CLI exited {proc.returncode}:\n{proc.stderr}")
    res = json.loads(proc.stdout)
    top = sorted(i for i, _ in res["top"])
    ok = (top == ["0x0", hex((1 << NQ) - 1)] and abs(res["norm2"] - 1) <= 1e-5
          and all(abs(p - 0.5) <= 1e-5 for _, p in res["top"]))
    log(f"main cli run ghz28.json (mode panel, a subprocess): {wall:.3f} s, "
        f"norm2={res['norm2']:.9f} top={res['top']} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"the CLI's ghz28 output is off: {res}")
    out["cli ghz28"] = dict(wall_s=wall, **res)
    RECORD["panel_fused"] = dict(launches=counts, **out)
    return counts


# ---------------------------------------------------------------------------
# Phase 4: times
# ---------------------------------------------------------------------------

def times(dev, scheds) -> dict:
    import numpy as np
    import torch

    from quantum_simulations_tpu_torch.circuit.panelize import (
        DualPanelOp, WindowPanelOp,
    )
    from quantum_simulations_tpu_torch.ops import bitperm_kernels as bk
    from quantum_simulations_tpu_torch.ops import dense
    from quantum_simulations_tpu_torch.ops import diag_kernels as dk
    from quantum_simulations_tpu_torch.ops import pair_kernels as pq
    from quantum_simulations_tpu_torch.ops import panel_kernels as pk
    from quantum_simulations_tpu_torch.ops import readout_kernels as rk
    from quantum_simulations_tpu_torch.ops import sampling
    from quantum_simulations_tpu_torch.runtime import simulator

    n, N = NQ, 1 << NQ
    x = unit_state(n, SEED, dev)
    xc = torch.complex(*x)

    def cw(W):
        return torch.as_tensor(W, dtype=torch.complex64, device=dev)

    rows: dict = {}

    def row(name, label, kern, twin, lib, dims, straddles=(), diag=None,
            panel=None, inplace=None, bnd=None, separate=None):
        """One timed row; ``panel``: the same panel without its diag
        epilogue, ``inplace``: the kernel's in-place instance on the same
        operands, ``separate``: the same function as two passes (a
        rotated panel as the panel, then a transpose), each timed beside
        it; ``bnd``: a (bound_ms, bound_by) that :func:`bound` does not
        cover.  An in-place call updates ``x``: every one is unitary or a
        permutation, so ``x`` stays a unit-norm state."""
        ms = cuda_ms(kern, reps=10)
        plain_ms = cuda_ms(twin, reps=3)
        lib_ms = None if lib is None else cuda_ms(lib, reps=5)
        extra = {}
        tc = name in TC_ROWS
        for key, fn in (("panel_ms", panel), ("inplace_ms", inplace),
                        ("separate_ms", separate)):
            if fn is not None:
                extra[key] = cuda_ms(fn, reps=10)
        b_ms, b_by = bnd or bound(N, dims, straddles, diag, tc=tc)
        if tc:  # the float32 bound of the same work on the SIMT units, beside
            extra["bound_simt_ms"] = bound(N, dims, straddles, diag)[0]
        log(f"time {label:<30} ms={ms:.3f} plain_ms={plain_ms:.3f} "
            f"library_ms={'none' if lib_ms is None else f'{lib_ms:.3f}'} "
            + "".join(f"{k}={v:.3f} " for k, v in extra.items())
            + f"bound_ms={b_ms:.3f} ({b_by}{', tensor-core split TF32' if tc else ''}) "
            f"bound/ms={b_ms / ms:.3f}")
        rec = dict(kernel=name, case=label, ms=ms, plain_ms=plain_ms,
                   library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by, **extra)
        RECORD["times"].append(rec)
        rows.setdefault(name, rec)

    ops = [op for op, _ in scheds["nonstab28"]]
    for op in ops:
        if isinstance(op, WindowPanelOp):
            w = pk.w_planes(op.W, dev, torch.float32)  # one split operand
            row("positioned_panel", f"positioned pos{op.pos}",
                lambda op=op, w=w: pk.positioned_panel(*x, w, op.pos),
                lambda op=op, w=w: pk.positioned_panel_plain(*x, w, op.pos),
                panel_library(xc, cw(op.W), op.pos), [128],
                inplace=lambda op=op, w=w: pk.positioned_panel(
                    *x, w, op.pos, inplace=True))
    # The dual rows: op 0 (no straddler) first, so it is the JSON row.
    duals = sorted((op for op in ops if isinstance(op, DualPanelOp)),
                   key=lambda o: o.pre_straddle is not None)
    for op in duals:
        w1 = pk.w_planes(op.first.W, dev, torch.float32)
        w2 = pk.w_planes(op.second.W, dev, torch.float32)
        s = pk.Straddle.of(op.pre_straddle)
        row("dual_panel", "dual" + (" +pre" if s else ""),
            lambda w1=w1, w2=w2, op=op, s=s: pk.dual_panel(
                *x, w1, op.first.pos, w2, op.second.pos, straddle=s),
            lambda w1=w1, w2=w2, op=op, s=s: pk.dual_panel_plain(
                *x, w1, op.first.pos, w2, op.second.pos, straddle=s),
            dual_library(xc, op, cw), [128, 128], [s] if s else [],
            inplace=lambda w1=w1, w2=w2, op=op, s=s: pk.dual_panel(
                *x, w1, op.first.pos, w2, op.second.pos, straddle=s,
                inplace=True))
    w0 = pk.w_planes(ops[0].first.W, dev, torch.float32)
    row("lane_panel", "lane (2^21, 128)",
        lambda: pk.lane_panel(*x, w0), lambda: pk.lane_panel_plain(*x, w0),
        panel_library(xc, cw(ops[0].first.W), 0), [128],
        inplace=lambda: pk.lane_panel(*x, w0, inplace=True))

    # fused_diag on qaoa28's 43-term run.  Its library call multiplies by
    # a 2^28 complex64 phase table built outside the timing: that reads
    # 50% more bytes than the function needs.
    diag43 = dk.DiagTerms.of(next(op.terms for op, _ in scheds["qaoa28"]
                                  if type(op).__name__ == "DiagOp"))
    diag43.operand(dev)
    ph = phase_table(N, diag43, dev)
    row("fused_diag", f"fused_diag qaoa28 ({len(diag43.terms)} terms)",
        lambda: dk.fused_diag(*x, diag43),
        lambda: dk.fused_diag_plain(*x, diag43),
        lambda: xc * ph, [], diag=diag43,
        inplace=lambda: dk.fused_diag(*x, diag43, inplace=True))

    # The three diag epilogues with qft28's 147-term run, each beside the
    # same panel without it.  Their library call is one einsum of the
    # panel and the run's 2^28 phase table (built outside the timing):
    # it reads that table on top of what the function needs.
    opd, d147 = find(scheds["qft28"], "WindowPanelOp", diag=True)
    d147 = dk.DiagTerms.of(d147)
    d147.operand(dev)
    ph = phase_table(N, d147, dev)
    wd, pd = pk.w_planes(opd.W, dev, torch.float32), opd.pos
    row("positioned_panel+diag", f"positioned pos{pd} +diag{len(d147.terms)} (qft28)",
        lambda: pk.positioned_panel(*x, wd, pd, diag_terms=d147),
        lambda: pk.positioned_panel_plain(*x, wd, pd, diag_terms=d147),
        panel_library(xc, cw(opd.W), pd, ph), [128], diag=d147,
        panel=lambda: pk.positioned_panel(*x, wd, pd),
        inplace=lambda: pk.positioned_panel(*x, wd, pd, diag_terms=d147,
                                            inplace=True))
    op0, _ = find(scheds["qft28"], "WindowPanelOp", pos=0)
    wq0 = pk.w_planes(op0.W, dev, torch.float32)
    row("lane_panel+diag", f"lane +diag{len(d147.terms)} (qft28 @0 W)",
        lambda: pk.lane_panel(*x, wq0, diag_terms=d147),
        lambda: pk.lane_panel_plain(*x, wq0, diag_terms=d147),
        panel_library(xc, cw(op0.W), 0, ph), [128], diag=d147,
        panel=lambda: pk.lane_panel(*x, wq0),
        inplace=lambda: pk.lane_panel(*x, wq0, diag_terms=d147, inplace=True))
    dop = duals[0]
    dw1 = pk.w_planes(dop.first.W, dev, torch.float32)
    dw2 = pk.w_planes(dop.second.W, dev, torch.float32)
    dargs = (dw1, dop.first.pos, dw2, dop.second.pos)
    row("dual_panel+diag", f"dual +diag{len(d147.terms)} (nonstab28 W)",
        lambda: pk.dual_panel(*x, *dargs, diag_terms=d147),
        lambda: pk.dual_panel_plain(*x, *dargs, diag_terms=d147),
        dual_library(xc, dop, cw, ph), [128, 128], diag=d147,
        panel=lambda: pk.dual_panel(*x, *dargs),
        inplace=lambda: pk.dual_panel(*x, *dargs, diag_terms=d147,
                                      inplace=True))
    del ph

    # The bit permutations of qft28.
    swap, _ = find(scheds["qft28"], "BitPermGridOp")
    gm = dict(swap.grid_map)
    shape, dims = bk.permute_view(n, bk.bit_sources(n, swap.pairs, gm))
    xs = xc.view(shape)
    row("bitperm_swap", "bitperm_swap qft28",
        lambda: bk.bitperm_swap(*x, swap.pairs, gm),
        lambda: bk.bitperm_swap_plain(*x, swap.pairs, gm),
        lambda: xs.permute(dims).contiguous(), [])
    xt = xc.view(128, -1, 128)
    row("bitperm_transpose", "bitperm_transpose",
        lambda: bk.bitperm_transpose(*x), lambda: bk.bitperm_transpose_plain(*x),
        lambda: xt.transpose(0, 2).contiguous(), [],
        inplace=lambda: bk.bitperm_transpose(*x, inplace=True))

    # The in-place permutation: qft28's BitPermGridOp at capacity is one
    # involution (its pairs and its grid_map's 2-cycles); the bound counts
    # the rows it moves.  Its library call is the same permute as above.
    src = bk.bit_sources(n, swap.pairs, gm)
    inv, = bk.involution_factors(src)
    moved = moved_rows(n, inv)
    row("bitperm_involution",
        f"bitperm_involution qft28 ({moved} of {N >> 7} rows move)",
        lambda: bk.bitperm_involution(*x, inv),
        lambda: bk.bitperm_involution(*x, inv, plain=True),
        lambda: xs.permute(dims).contiguous(), [],
        bnd=(1e3 * moved * 128 * 4 * 4 / HBM_BYTES_PER_S, "bytes"))
    del xs, xt

    # The pair kernel at its classes, with the requests' gates; the
    # library call is one einsum over the complex64 (A, 2, B, 2, C) view.
    dj, wq = gate_ops(scheds["deutsch_jozsa28"]), gate_ops(scheds["w_qft28"])
    col, rw, mixed = DJ_GATES
    for label, (qs, U) in ((f"column {col}", dj[col]), (f"row {rw}", dj[rw]),
                           (str(mixed), dj[mixed]),
                           ("(6, 7)", wq[(6, 7)]), ("(7, 6)", wq[(7, 6)])):
        qa, qb = qs
        name = pair_wrapper(qa, qb)
        row(name, f"{name} {label}",
            lambda qa=qa, qb=qb, U=U, f=getattr(pq, name): f(*x, qa, qb, U),
            lambda qa=qa, qb=qb, U=U: pq.pair_gate_plain(*x, qa, qb, U),
            pair_library(xc, qa, qb, U), [4],
            # pair_update runs in place from bit 10 on (midpair below)
            inplace=None if name == "pair_update" and min(qa, qb) < 10 else (
                lambda qa=qa, qb=qb, U=U, f=getattr(pq, name): f(
                    *x, qa, qb, U, inplace=True)))
    # midpair: qpe28's multiswap pair (9, 17) at capacity (a SWAP), and a
    # random unitary on (8, 27); in place only.
    for qa, qb, U in ((9, 17, dense._SWAP4),
                      (8, NQ - 1, rand_unitary(4, np.random.default_rng(SEED)))):
        row("midpair", f"midpair ({qa}, {qb})",
            lambda qa=qa, qb=qb, U=U: pq.midpair(*x, qa, qb, U),
            lambda qa=qa, qb=qb, U=U: pq.midpair(*x, qa, qb, U, plain=True),
            pair_library(xc, qa, qb, U), [4])
    bp, _ = find(scheds["qft28 nodecomp"], "BitPermOp")
    tables = bk.CrossTables.of(bp.cross)
    tables.operand(dev)
    row("bitperm_cross", "bitperm_cross qft28 nodecomp",
        lambda: bk.bitperm_cross(*x, tables),
        lambda: bk.bitperm_cross_plain(*x, tables),
        cross_library(xc, tables.cross), [],
        inplace=lambda: bk.bitperm_cross(*x, tables, inplace=True))

    # Panel mode: a rotation step's transpose at the shapes of r = 7, 21
    # and 14 (the first is the JSON row), and nonstab28's first panel
    # with the rotated store beside the separate form (the panel, then
    # the r = 7 transpose).  Their library calls: `.t().contiguous()` of
    # the complex64 view, and the product followed by it.
    for rb in (7, 21, 14):
        tr, tc = 1 << (n - rb), 1 << rb
        xv = xc.view(tr, tc)
        row("tiled_transpose", f"tiled_transpose (2^{n - rb}, 2^{rb})",
            lambda tr=tr, tc=tc: bk.tiled_transpose(*x, tr, tc),
            lambda tr=tr, tc=tc: bk.tiled_transpose_plain(*x, tr, tc),
            lambda xv=xv: xv.t().contiguous(), [])
    Wp = panel_W(scheds["nonstab28 panel"])
    wp = pk.w_planes(Wp, dev, torch.float32)
    Wpt, xl = cw(Wp).T.contiguous(), xc.view(-1, 128)
    row("lane_panel+rotate", "lane +rotate (nonstab28 panel 1)",
        lambda: pk.lane_panel(*x, wp, rotate=True),
        lambda: pk.lane_panel_plain(*x, wp, rotate=True),
        lambda: (xl @ Wpt).t().contiguous(), [128],
        separate=lambda: bk.tiled_transpose(*pk.lane_panel(*x, wp), N >> 7, 128))

    # The readout: one string and qaoa28's 50 edges on the complex64
    # tensor's views (the first is the JSON row) and on the planes.  Its
    # bound is one read of the state; its library call the per-string
    # plain readout the port had before the kernel (one string only).
    read_bound = (1e3 * N * 8 / HBM_BYTES_PER_S, "bytes")
    for layout, planes in (("interleaved", (xc.real, xc.imag)), ("planar", x)):
        for case, masks in readout_masks(n).items():
            row("zstring_sum", f"zstring_sum {layout} {case} (K={len(masks)})",
                lambda p=planes, m=masks: rk.zstring_sum(*p, m),
                lambda p=planes, m=masks: sampling.zstring_sums_plain(*p, m),
                (lambda p=planes, m=masks[0]: zstring_library(*p, m))
                if len(masks) == 1 else None, [], bnd=read_bound)
    del xc, xv, xl

    # Every pass of qft28 and qaoa28, operands already on the card.
    RECORD["passes"] = {}
    for label in ("qft28", "qaoa28", "qpe28"):
        prepared = simulator.prepare_schedule(scheds[label], dev, torch.float32)
        recs = []
        for i, (op, dt) in enumerate(prepared):
            ms = cuda_ms(lambda op=op, dt=dt: simulator.apply_window_op(
                *x, op, dt), reps=5)
            name = type(op).__name__ + (f"@{op.pos}" if hasattr(op, "pos") else "")
            if type(op).__name__ == "PhysGateOp":
                name += str(op.qubits)
            if dt is not None:
                name += f"+diag{len(dt.terms)}"
            elif type(op).__name__ == "DiagOp":
                name += f"({len(op.terms.terms)} terms)"
            recs.append(dict(op=name, ms=ms))
            log(f"pass {label} {i + 1:>2} {name:<28} ms={ms:.3f}")
        total = sum(r["ms"] for r in recs)
        log(f"pass {label} sum of {len(recs)} pass medians: {total:.3f} ms")
        RECORD["passes"][label] = dict(passes=recs, sum_ms=total)
    # Every pass of nonstab28's panel schedule.
    label = "nonstab28 panel"
    recs = []
    for i, (op, rot) in enumerate(simulator.prepare_passes(
            scheds[label], dev, torch.float32)):
        ms = cuda_ms(lambda op=op, rot=rot: simulator.apply_panel_op(
            *x, op, rot), reps=5)
        recs.append(dict(op=pass_name(op, rot), ms=ms))
        log(f"pass {label} {i + 1:>2} {recs[-1]['op']:<28} ms={ms:.3f}")
    total = sum(r["ms"] for r in recs)
    log(f"pass {label} sum of {len(recs)} pass medians: {total:.3f} ms")
    RECORD["passes"][label] = dict(passes=recs, sum_ms=total)
    del x
    torch.cuda.empty_cache()

    RECORD["e2e"] = {label: e2e(label, cd, dev)
                     for label, cd in circuits().items() if label in E2E}
    pcds = panel_circuits()
    for label, R in (("nonstab28 panel", 3), ("qft28 panel", 1),
                     ("nonstab28 fused", 1)):
        name, mode = label.split()
        RECORD["e2e"][label] = e2e(label, pcds[name], dev, mode, R)
    # Whether the rotated store paid: the same schedule, the panel and
    # the rotation by 7 as two passes.
    body = simulator.run_passes(simulator.prepare_passes(
        simulator.panel_schedule(pcds["nonstab28"], fuse_rotate=False), dev,
        torch.float32))
    RECORD["e2e"]["nonstab28 panel unfused"] = e2e(
        "nonstab28 panel unfused", pcds["nonstab28"], dev, "panel",
        fn=lambda re, im: body([re, im]))
    return rows


def e2e(label: str, cd: dict, dev, mode: str = "window", R: int = 3,
        fn=None) -> dict:
    """Two-point estimator (t(2R) - t(R)) / R: the fixed per-call cost
    cancels.  ``mode``: window, panel or fused; ``fn``: a planar
    ``fn(re, im)`` to time instead of the mode's."""
    import torch

    from quantum_simulations_tpu_torch.ops import dense
    from quantum_simulations_tpu_torch.runtime import simulator

    n = cd["number_of_qubits"]
    N = 1 << n
    if fn is None:
        build = {"window": simulator.build_window_circuit_fn,
                 "panel": simulator.build_panel_circuit_fn,
                 "fused": simulator.build_circuit_fn}[mode]
        fn = build(cd, planar_io=True, device=dev)

    def chain(k: int) -> float:
        st = dense.zero_state_planar(n, torch.float32, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(k):
            st = fn(*st)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    chain(1)
    t1 = min(chain(R) for _ in range(3))
    t2 = min(chain(2 * R) for _ in range(3))
    dt = (t2 - t1) / R
    gates = len(cd["gates"])
    rate = gates * N / dt
    tag = label if mode in label.split() else f"{label} {mode}"
    log(f"e2e {tag}: {dt * 1e3:.3f} ms per run "
        f"(t({R})={t1:.4f} s, t({2 * R})={t2:.4f} s), "
        f"{rate:.4e} amp-updates/s ({gates} gates x 2^{n} / t)")
    return dict(ms=dt * 1e3, t_R=t1, t_2R=t2, R=R, amp_updates_per_s=rate,
                gates=gates)


# ---------------------------------------------------------------------------
# Phase 5: the capacity tier at n = 33
# ---------------------------------------------------------------------------

def chain_s(fn, re, im, k: int) -> float:
    """Wall seconds of ``k`` in-place runs of ``fn`` from |0>, the planes
    reset outside the timing."""
    import torch

    re.zero_()
    im.zero_()
    re[0] = 1.0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(k):
        fn(re, im)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def zero_distance(res) -> float:
    """||psi - |0>||_2 from the planes: norm2 - |psi_0|^2 + |psi_0 - 1|^2."""
    a = complex(float(res.re[0]), float(res.im[0]))
    return math.sqrt(max(res.norm2() - abs(a) ** 2 + abs(a - 1) ** 2, 0.0))


def ghz33_readout(res) -> tuple:
    """<Z0 Z32>, <Z32> and <Z0...Z32> of ghz33's planes (1, 0, 0) in one
    counted zstring_sum launch (index bit 32), and the twin's: (record,
    launches)."""
    import torch

    from quantum_simulations_tpu_torch.ops import sampling

    masks = [1 | (1 << (NBIG - 1)), 1 << (NBIG - 1), (1 << NBIG) - 1]
    reset_counts()
    got = sampling.zstring_sums(res.re, res.im, masks).tolist()
    torch.cuda.synchronize()
    got_launches, plain = launches(), plain_calls()
    twin = sampling.zstring_sums_plain(res.re, res.im, masks).tolist()
    exact = (1.0, 0.0, (1 + (-1) ** NBIG) / 2)  # |1...1>'s parity: NBIG's
    exact_err = max(abs(g - e) for g, e in zip(got, exact))
    twin_err = max(abs(g - t) for g, t in zip(got, twin))
    ok = (exact_err <= TOL_L2 and twin_err <= TOL_ZSTRING
          and got_launches == {"zstring_sum": 1} and not plain)
    log(f"capacity ghz{NBIG} readout <Z0 Z{NBIG - 1}>, <Z{NBIG - 1}>, <Z all>: "
        f"{got} (twin {twin}), |diff| to {exact} {exact_err:.3e}, to the twin "
        f"{twin_err:.3e}, launches={got_launches} plain_calls={plain} "
        f"{'ok' if ok else 'FAIL'}")
    return dict(z=got, twin=twin, exact_err=exact_err, twin_err=twin_err,
                ok=ok), got_launches


def capacity33(dev) -> dict:
    """ghz33, nonstab33 (then its inverse), qft33 and qpe33 through
    ``api.simulate(cd, SimulatorConfig(mode="capacity"))`` on two 32 GiB
    planes.  No float64 twin exists at this size (it would be 128 GiB), so
    each state is held to what is known of it exactly."""
    import gc

    import torch

    from quantum_simulations_tpu_torch import SimulatorConfig, api
    from quantum_simulations_tpu_torch.runtime import capacity, simulator

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    free, total = torch.cuda.mem_get_info()
    log(f"capacity n={NBIG}: memory_allocated={held / GIB:.3f} GiB before, "
        f"card free={free / GIB:.3f} / total={total / GIB:.3f} GiB")
    if not held < GIB:
        raise AssertionError(f"{held / GIB:.3f} GiB still allocated before n = {NBIG}")
    cfg = SimulatorConfig(mode="capacity")
    cds = circuits33()
    counts: dict = {}
    out: dict = {"allocated_before_gib": held / GIB, "card_total_gib": total / GIB}
    amp = 2.0 ** -0.5
    for label in CAPACITY33:
        cd = cds[label]
        torch.cuda.reset_peak_memory_stats()
        res, counts[label], wall = request(
            label, lambda cd=cd: api.simulate(cd, cfg, device=dev))
        peak = torch.cuda.max_memory_allocated()
        rec = dict(first_call_s=wall, peak_gib=peak / GIB, gates=len(cd["gates"]))
        nrm2 = res.norm2()
        rec["norm2"] = nrm2
        ok = abs(nrm2 - 1) <= 1e-5 and peak <= PEAK_LIMIT
        if label == "ghz33":
            ends = [complex(float(res.re[i]), float(res.im[i]))
                    for i in (0, (1 << NBIG) - 1)]
            top = sorted(i for i, _ in res.top_amplitudes(2))
            rec.update(end_err=max(abs(a - amp) for a in ends), top2=top)
            ok = ok and rec["end_err"] <= 1e-6 and top == [0, (1 << NBIG) - 1]
            rec["readout"], counts["ghz33 readout"] = ghz33_readout(res)
            ok = ok and rec["readout"]["ok"]
        elif label == "qft33":
            rec["l2_vs_exact"] = uniform_distance(res.re, res.im)
            ok = ok and rec["l2_vs_exact"] <= 1e-5
        elif label == "qpe33":
            (idx, a), = res.top_amplitudes(1)
            rec.update(top_index=idx, top_prob=abs(a) ** 2)
            ok = ok and idx == QPE33_ANSWER and abs(a) ** 2 >= 1 - 1e-5
        else:  # nonstab33, then its inverse on the same planes
            inv = inverse(cd)
            torch.cuda.reset_peak_memory_stats()
            res, counts["nonstab33 inverse"], rec["inverse_first_call_s"] = request(
                "nonstab33 inverse", lambda: capacity.simulate_capacity(
                    inv, device=dev, initial_planes=(res.re, res.im)))
            rec["inverse_peak_gib"] = torch.cuda.max_memory_allocated() / GIB
            rec["l2_vs_zero"] = zero_distance(res)
            ok = (ok and rec["l2_vs_zero"] <= 1e-5
                  and rec["inverse_peak_gib"] * GIB <= PEAK_LIMIT)
        # Times: the schedule is compiled and its operands are on the card.
        fn = simulator.build_window_circuit_fn(cd, planar_io=True, inplace=True,
                                               device=dev)
        if label in ("nonstab33", "qft33"):
            chain_s(fn, res.re, res.im, 1)
            t1 = chain_s(fn, res.re, res.im, 1)
            t2 = chain_s(fn, res.re, res.im, 2)
            dt = t2 - t1
            rec.update(t_1=t1, t_2=t2, how="(t(2) - t(1)) / 1")
        else:
            dt = chain_s(fn, res.re, res.im, 1)
            rec["how"] = "one run"
        rec.update(ms=dt * 1e3, amp_updates_per_s=len(cd["gates"]) * (1 << NBIG) / dt)
        log(f"capacity {label}: " + " ".join(
            f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in rec.items()) + f" {'ok' if ok else 'FAIL'}")
        log(f"e2e {label} capacity: {dt * 1e3:.3f} ms per run ({rec['how']}), "
            f"{rec['amp_updates_per_s']:.4e} amp-updates/s ({rec['gates']} gates "
            f"x 2^{NBIG} / t), peak {peak / GIB:.3f} GiB")
        out[label] = rec
        del res, fn
        gc.collect()
        torch.cuda.empty_cache()
        if not ok:
            raise AssertionError(f"{label} fails its check: {rec}")
    RECORD["capacity33"] = dict(launches=counts, **out)
    return counts


# ---------------------------------------------------------------------------
# Phase 6: the sparse, adaptive and trajectory tiers
# ---------------------------------------------------------------------------

def tier_request(label: str, run, need=(), dense_calls=None) -> tuple:
    """Run one phase-6 request with the counters set to 0 just before it:
    no plain twin may run, every kernel in ``need`` must launch, and the
    plain torch gate paths must run ``dense_calls`` times where given."""
    import torch

    from quantum_simulations_tpu_torch.ops import dense

    reset_counts()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got, plain, gates = launches(), plain_calls(), dense.GATE_CALLS
    log(f"tiers {label}: {wall:.3f} s launches={got} plain_calls={plain} "
        f"dense_gate_calls={gates}")
    missing = [k for k in need if not got.get(k)]
    if plain or missing or (dense_calls is not None and gates != dense_calls):
        raise AssertionError(f"{label}: launches {got}, plain {plain}, dense "
                             f"{gates}; want {need} launched, no plain call, "
                             f"{dense_calls} dense calls")
    return out, got, wall


def coo_gates(cd: dict, upto: int, dev) -> tuple:
    """Seconds of the COO tier's loop over the circuit's first ``upto``
    gates on the card from |0> (synchronised; no SparseState built), and
    its (idx, amp) tensors."""
    import torch

    from quantum_simulations_tpu_torch.circuit import gates as G
    from quantum_simulations_tpu_torch.circuit.contract import validate_circuit_dict
    from quantum_simulations_tpu_torch.sparse import engine

    gates = validate_circuit_dict(cd)["gates"][:upto]
    idx, amp = engine.coo_zero_state(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for g in gates:
        idx, amp = engine._apply_gate_coo(
            idx, amp, g["qubits"], G.gate_matrix(g["gate"], g["params"]),
            engine.DEFAULT_THRESHOLD)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, (idx, amp)


def sparse_requests(dev, rec: dict, counts: dict) -> None:
    """The sparse tier through the entry points: the COO tier on the card
    (ghz62, w62, ghz63 forced, hwall22: 2^22 nonzeros), its sampler, and
    the bigint tier on the host (ghz1000)."""
    import torch

    from quantum_simulations_tpu_torch import SimulatorConfig, api, library
    from quantum_simulations_tpu_torch.sparse import engine

    cfg = SimulatorConfig(sparse=True)
    amp = 2.0 ** -0.5
    checks = {
        "ghz62 sparse": (lambda: api.simulate(library.ghz(NSPARSE), cfg,
                                              device=dev),
                         [0, (1 << NSPARSE) - 1], lambda a: abs(a - amp)),
        "w62 sparse": (lambda: api.simulate(library.w_state(NSPARSE), cfg,
                                            device=dev),
                       [1 << q for q in range(NSPARSE)],
                       lambda a: abs(abs(a) ** 2 - 1 / NSPARSE)),
        "ghz63 sparse coo": (lambda: engine.simulate_sparse(
            library.ghz(63), force_tier="numpy", device=dev),
            [0, (1 << 63) - 1], lambda a: abs(a - amp)),
        "ghz1000 sparse bigint": (lambda: api.simulate(library.ghz(1000), cfg,
                                                       device=dev),
                                  [0, (1 << 1000) - 1], lambda a: abs(a - amp)),
    }
    for label, (run, support, err) in checks.items():
        st, counts[label], wall = tier_request(label, run)
        worst = max(err(a) for _, a in st.items())
        ok = sorted(i for i, _ in st.items()) == support and worst <= 1e-12
        log(f"tiers {label}: nnz={len(st)} worst={worst:.3e} "
            f"{'ok' if ok else 'FAIL'}")
        rec[label] = dict(wall_s=wall, nnz=len(st), worst_err=worst)
        if not ok:
            raise AssertionError(f"{label} is off its closed form")

    # hwall22: real card work, 2^22 entries (int64 + complex128) at its
    # last gate.  The COO gates alone, synchronised, then the request.
    wall22 = library.hadamard_wall(NWALL_SPARSE)
    coo_s, (idx, a) = coo_gates(wall22, NWALL_SPARSE, dev)
    worst_dev = float((a - 2.0 ** (-NWALL_SPARSE / 2)).abs().max())
    del idx, a
    label = f"hwall{NWALL_SPARSE} sparse"
    st, counts[label], wall = tier_request(
        label, lambda: api.simulate(wall22, cfg, device=dev))
    target = 2.0 ** (-NWALL_SPARSE / 2)
    worst = max(abs(v - target) for _, v in st.items())
    ok = len(st) == 1 << NWALL_SPARSE and worst <= 1e-12 and worst_dev <= 1e-12
    log(f"tiers {label}: nnz={len(st)} max |amp - 2^-{NWALL_SPARSE // 2}| = "
        f"{worst:.3e}; COO gates on the card {coo_s * 1e3:.3f} ms "
        f"({len(wall22['gates'])} gates), the request {wall:.3f} s "
        f"(its SparseState a host dict) {'ok' if ok else 'FAIL'}")
    rec[label] = dict(wall_s=wall, coo_ms=coo_s * 1e3, nnz=len(st),
                      worst_err=worst)
    del st
    if not ok:
        raise AssertionError(f"{label} is off the uniform state")

    label = "ghz62 sparse sample"
    bits, counts[label], wall = tier_request(label, lambda: api.sample(
        library.ghz(NSPARSE), 64, seed=1, config=cfg, device=dev))
    rows = set(bits.sum(axis=1).tolist())
    log(f"tiers {label}: rows' bit sums {sorted(rows)}")
    rec[label] = dict(wall_s=wall, row_sums=sorted(rows))
    if not (bits.shape == (64, NSPARSE) and rows <= {0, NSPARSE}):
        raise AssertionError(f"{label}: a row is neither all 0 nor all 1")


def adaptive_requests(dev, rec: dict, counts: dict) -> None:
    """qft26 and hwall26 with ``sparse="auto"`` at n = 26 (the dense cap):
    the COO tier on the card until nnz > 2^22, then the hand-off to the
    dense tier on the card, fused (the default) and window."""
    import numpy as np
    import torch

    from quantum_simulations_tpu_torch import SimulatorConfig, api, library
    from quantum_simulations_tpu_torch.sparse import adaptive

    for name, cd in (("qft26", library.qft(NADAPT)),
                     ("hwall26", library.hadamard_wall(NADAPT))):
        # On |0>, only an H changes the support of these circuits (it
        # doubles it): the rule switches after the H that takes nnz past
        # 2^n / 16, the (n - 3)th.
        hs = [i for i, g in enumerate(cd["gates"]) if g["gate"] == "H"]
        want_at = hs[NADAPT - 4] + 1
        want_hist = [2 ** sum(1 for h in hs if h <= i) for i in range(want_at)]
        for mode in ("fused", "window"):
            label = f"{name} auto" + (" window" if mode == "window" else "")
            res, counts[label], wall = tier_request(
                label, lambda cd=cd, mode=mode: adaptive.simulate_adaptive(
                    cd, mode=mode, device=dev),
                ADAPT_NEED[label], ADAPT_DENSE.get(label))
            r = dict(wall_s=wall, switched_at=res.switched_at,
                     nnz_at_switch=res.nnz_history[-1], gates=len(cd["gates"]))
            ok = (res.switched_at == want_at and res.nnz_history == want_hist
                  and res.is_dense and res.state.device.type == dev.type
                  and res.state.dtype == torch.complex64)
            # The same request through the API: a host numpy vector.
            psi = api.simulate(cd, SimulatorConfig(sparse="auto", mode=mode),
                               device=dev)
            ok = ok and isinstance(psi, np.ndarray) and np.array_equal(
                psi, res.state.cpu().numpy())
            if name == "hwall26":
                r["max_err_vs_exact"] = float(
                    (res.state - 2.0 ** (-NADAPT / 2)).abs().max())
                ok = ok and r["max_err_vs_exact"] <= 1e-6
            del psi
            r.update(against_f64(label, res.state, cd, dev, mode="window"))
            log(f"tiers {label}: switched_at={res.switched_at} (want {want_at}) "
                f"nnz at the switch {res.nnz_history[-1]} "
                f"{'ok' if ok else 'FAIL'}")
            del res
            torch.cuda.empty_cache()
            rec[label] = r
            if not ok:
                raise AssertionError(f"{label} fails its check: {r}")
        rec[f"{name} auto"]["split"] = adaptive_split(name, cd, want_at, dev)


def adaptive_split(name: str, cd: dict, at: int, dev, reps: int = 3) -> list:
    """The fused adaptive run's three stages, each synchronised, ``reps``
    times over (the hand-off's schedule is built by then): the COO gates
    up to the switch at gate ``at``, the scatter into a dense complex64
    tensor, and the rest of the circuit through ``simulator.simulate``."""
    import torch

    from quantum_simulations_tpu_torch.runtime import simulator

    n = cd["number_of_qubits"]
    rest = {"number_of_qubits": n, "gates": cd["gates"][at:]}
    out = []
    for _ in range(reps):
        coo_s, (idx, amp) = coo_gates(cd, at, dev)
        t0 = time.perf_counter()
        psi = torch.zeros(1 << n, dtype=torch.complex64, device=dev)
        psi.index_put_((idx,), amp.to(torch.complex64))
        torch.cuda.synchronize()
        scatter_s = time.perf_counter() - t0
        del idx, amp
        t0 = time.perf_counter()
        psi = simulator.simulate(rest, initial_state=psi, device=dev)
        torch.cuda.synchronize()
        out.append(dict(coo_s=coo_s, scatter_s=scatter_s,
                        handoff_s=time.perf_counter() - t0))
        del psi
    log(f"tiers {name} auto split (fused; COO gates, scatter, hand-off in s): "
        + "; ".join(f"{r['coo_s']:.4f}, {r['scatter_s']:.4f}, "
                    f"{r['handoff_s']:.4f}" for r in out))
    return out


def trajectory_requests(dev, rec: dict, counts: dict) -> None:
    """traj28 (``traj_circuit(28)``) through ``api.simulate`` for each seed
    of TRAJ_SEEDS, held to its float64 twin on the card (the same tier in
    complex128: the plain twins); then ``api.sample`` of it."""
    import torch

    from quantum_simulations_tpu_torch import SimulatorConfig, api
    from quantum_simulations_tpu_torch.runtime.trajectory import simulate_trajectory

    cd = traj_circuit(NQ)
    outs_by_seed = {}
    for seed in TRAJ_SEEDS:
        label = f"traj28 seed {seed}"
        psi, counts[label], wall = tier_request(
            label, lambda seed=seed: api.simulate(
                cd, SimulatorConfig(trajectory_seed=seed), device=dev),
            TRAJ_NEED)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got, cregs, outs = simulate_trajectory(cd, seed=seed, device=dev)
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        same = float(torch.linalg.vector_norm(
            got - torch.from_numpy(psi).to(dev)))
        del psi
        ref, cregs64, outs64 = simulate_trajectory(
            cd, seed=seed, dtype="complex128", device=dev)
        l2 = float(torch.linalg.vector_norm(got.to(torch.complex128) - ref))
        del ref
        nrm2 = norm2(got.real, got.imag)
        del got
        torch.cuda.empty_cache()
        ok = (outs == outs64 and cregs == cregs64 and l2 <= TOL_L2
              and abs(nrm2 - 1) <= 1e-5 and same <= TOL_CAPACITY)
        outs_by_seed[seed] = outs
        rec[label] = dict(first_call_s=wall, e2e_ms=warm * 1e3, outcomes=outs,
                          cregs=cregs, l2_vs_f64=l2, norm2=nrm2,
                          l2_vs_api=same, gates=len(cd["gates"]))
        log(f"tiers {label}: outcomes {outs} (f64 {outs64}) cregs {cregs} "
            f"||psi - psi_f64||_2={l2:.3e} norm2={nrm2:.9f} "
            f"||psi - psi_api||_2={same:.3e}; e2e {warm * 1e3:.3f} ms "
            f"(a second run, segments built) {'ok' if ok else 'FAIL'}")
        log(f"e2e traj28 seed {seed}: {warm * 1e3:.3f} ms per run "
            f"({len(cd['gates'])} gates, one run after the first)")
        if not ok:
            raise AssertionError(f"{label} is off its float64 twin: {rec[label]}")

    seed = TRAJ_SEEDS[0]
    label = "traj28 sample"
    bits, counts[label], wall = tier_request(label, lambda: api.sample(
        cd, 64, seed=1, config=SimulatorConfig(trajectory_seed=seed),
        device=dev), TRAJ_NEED)
    q = cd["gates"][-1]["qubits"][0]
    col = set(bits[:, q].tolist())
    rec[label] = dict(wall_s=wall, measured_qubit=q, column=sorted(col))
    log(f"tiers {label}: bit {q} of every shot in {sorted(col)}, the last "
        f"outcome {outs_by_seed[seed][-1]}")
    if not (bits.shape == (64, NQ) and col == {outs_by_seed[seed][-1]}):
        raise AssertionError(f"{label}: the measured bit is not collapsed")


def cli_tiers(dev, rec: dict) -> None:
    """The CLI on the card, as subprocesses: ``run ghz62.json --sparse``,
    ``run mixed.qasm --trajectory --trajectory-seed 3`` (the CPU tests'
    4-qubit MIXED circuit, against the port's oracle copy) and ``export
    qft8.json --format qasm`` (against ``to_qasm`` in this process)."""
    import numpy as np

    from quantum_simulations_tpu_torch import library, oracle
    from quantum_simulations_tpu_torch.circuit.export_qasm import to_qasm
    from quantum_simulations_tpu_torch.circuit.import_qasm import qasm_to_dict

    root = Path(__file__).resolve().parent
    out = root / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "ghz62.json").write_text(json.dumps(library.ghz(NSPARSE)))
    (out / "mixed.qasm").write_text(MIXED_QASM)
    (out / "qft8.json").write_text(json.dumps(library.qft(8)))

    def cli(*argv) -> str:
        cmd = [sys.executable, "-m", "quantum_simulations_tpu_torch", *argv]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                              timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"{argv} exited {proc.returncode}:\n{proc.stderr}")
        rec["cli " + " ".join(argv[:2])] = dict(wall_s=time.perf_counter() - t0)
        return proc.stdout

    res = json.loads(cli("run", str(out / "ghz62.json"), "--sparse", "--top",
                         "2", "--device", dev.type))
    amp = 2.0 ** -0.5
    ok = ([i for i, _ in res["top"]] == ["0x0", hex((1 << NSPARSE) - 1)]
          and res["nonzero"] == 2
          and all(abs(complex(*a) - amp) <= 1e-12 for _, a in res["top"]))
    log(f"tiers cli run ghz62.json --sparse: {res} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the CLI's sparse ghz62 output is off")

    res = json.loads(cli("run", str(out / "mixed.qasm"), "--trajectory",
                         "--trajectory-seed", "3", "--top", "16",
                         "--device", dev.type))
    psi_o, _, _ = oracle.simulate_trajectory(
        qasm_to_dict(MIXED_QASM, nonunitary="trajectory"), seed=3)
    probs = np.abs(psi_o) ** 2
    got = {int(i, 16): p for i, p in res["top"]}
    worst = max(abs(got.get(i, 0.0) - float(probs[i])) for i in range(16))
    ok = (res["n_amplitudes"] == 16 and worst <= 1e-6
          and {i for i, p in got.items() if p > 1e-6}
          == {i for i in range(16) if probs[i] > 1e-6})
    log(f"tiers cli run mixed.qasm --trajectory --trajectory-seed 3: top "
        f"{res['top'][:4]}, max |p - p_oracle| = {worst:.3e} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the CLI's trajectory output is off the oracle")

    text = cli("export", str(out / "qft8.json"), "--format", "qasm")
    ok = text == to_qasm(library.qft(8))
    log(f"tiers cli export qft8.json --format qasm: {len(text)} bytes "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the CLI's export differs from to_qasm")


def tiers(dev) -> dict:
    """Phase 6: the sparse, adaptive and trajectory tiers, then the CLI."""
    import gc

    import torch

    rec: dict = {}
    counts: dict = {}
    sparse_requests(dev, rec, counts)
    adaptive_requests(dev, rec, counts)
    gc.collect()
    torch.cuda.empty_cache()
    trajectory_requests(dev, rec, counts)
    cli_tiers(dev, rec)
    RECORD["tiers"] = dict(launches=counts, **rec)
    return counts


# ---------------------------------------------------------------------------
# Phase 7: the out-of-core spill tier (host and disk stripes through the card)
# ---------------------------------------------------------------------------

NSPILL, SPILL_M = 33, 28       # 64 GiB in host DRAM, stripes of 2 GiB
NSPILL_MID, SPILL_M_MID = 30, 26   # nonstab30: 16 steps, groups to 2^30
NDISK, DISK_M = 28, 24         # nonstab28 on disk: stripes of 128 MiB
NNATIVE = 20                   # the native oracle against the numpy one
HOST_MARGIN = 8 * GIB          # host RAM a full-size request leaves free
SPILL_CHUNK = 1 << 26          # amplitudes per chunk of a host-side check


def meminfo() -> dict:
    """/proc/meminfo in bytes (MemTotal, MemAvailable, ...)."""
    out = {}
    for line in Path("/proc/meminfo").read_text().splitlines():
        key, val = line.split(":", 1)
        out[key] = int(val.split()[0]) * 1024
    return out


def pcie_rates(dev, nbytes: int = GIB, reps: int = 5) -> dict:
    """Median GB/s of pinned host -> device and device -> host copies of
    ``nbytes`` (CUDA events on a copy stream), each direction alone, then
    both at once on two streams (the spill pipeline's case)."""
    import torch

    host = [torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
            for _ in range(2)]
    card = [torch.empty(nbytes, dtype=torch.uint8, device=dev)
            for _ in range(2)]
    streams = [torch.cuda.Stream(dev) for _ in range(2)]

    def timed(copies) -> float:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        ev[0].record()
        for st, (dst, src) in zip(streams, copies):
            st.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(st):
                dst.copy_(src, non_blocking=True)
        for st in streams[:len(copies)]:
            torch.cuda.current_stream().wait_stream(st)
        ev[1].record()
        torch.cuda.synchronize()
        return ev[0].elapsed_time(ev[1]) / 1e3

    out = {}
    for name, copies in (("h2d", [(card[0], host[0])]),
                         ("d2h", [(host[1], card[1])]),
                         ("both", [(card[0], host[0]), (host[1], card[1])])):
        timed(copies)
        t = statistics.median(timed(copies) for _ in range(reps))
        out[name + "_gbps"] = nbytes / t / 1e9
    del host, card
    torch.cuda.empty_cache()
    return out


def spill_env(dev, work: Path) -> dict:
    """The facts a spill run is bounded by: host RAM, CPUs, disk, numpy,
    the PCIe link and the pinned copy rates."""
    import shutil

    import numpy as np

    mem = meminfo()
    link = subprocess.run(
        ["nvidia-smi", "--query-gpu=pcie.link.gen.current,pcie.link.width.current,"
         "pcie.link.gen.max,pcie.link.width.max", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    work.mkdir(parents=True, exist_ok=True)
    import torch

    env = dict(mem_total_gib=mem["MemTotal"] / GIB,
               mem_available_gib=mem["MemAvailable"] / GIB,
               cpu_count=os.cpu_count(), numpy=np.__version__,
               disk_free_gib=shutil.disk_usage(work).free / GIB,
               pcie_link=link,
               host_cache_release=hasattr(torch._C, "_host_emptyCache"),
               **pcie_rates(dev))
    log("spill env: " + " ".join(
        f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
        for k, v in env.items()))
    return env


def spill_want(cd: dict, m: int) -> tuple:
    """The launches the spill tier must make for ``cd`` (already staged)
    at stripe width m, by kernel key, and its plain torch gate calls:
    every op of every step through ``simulator.gate_route`` at the
    stacked array's width m + r, once per group (2^(n - m - r) groups)."""
    from quantum_simulations_tpu_torch.circuit.fusion import LowPanelOp
    from quantum_simulations_tpu_torch.runtime import simulator, spill

    n = cd["number_of_qubits"]
    want: dict = {}
    dense_calls = 0
    for step in spill.compile_steps(cd, k=m, panel_width=7):
        bits = spill._group_bits(step, m)
        groups = 1 << (n - m - len(bits))
        for op in spill._remap_ops(step, m, bits):
            key = ("lane_panel" if isinstance(op, LowPanelOp) else
                   simulator.gate_route(op.qubits, op.U, m + len(bits)))
            if key == "dense":
                dense_calls += groups
            else:
                want[key] = want.get(key, 0) + groups
    return want, dense_calls


def spill_request(label: str, run, want: dict, dense_calls: int) -> tuple:
    """One spill request with the counters set to 0 just before it: the
    launches must be ``want`` exactly, no plain twin, ``dense_calls``
    plain torch gates; returns (result, launches, wall s, peak GiB)."""
    import torch

    from quantum_simulations_tpu_torch.ops import dense

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got, plain, gates = launches(), plain_calls(), dense.GATE_CALLS
    peak = torch.cuda.max_memory_allocated() / GIB
    log(f"spill {label}: {wall:.3f} s launches={got} plain_calls={plain} "
        f"dense_gate_calls={gates} peak={peak:.3f} GiB")
    if got != want or plain or gates != dense_calls:
        raise AssertionError(f"{label}: launches {got}, plain {plain}, dense "
                             f"{gates}; want {want}, no plain call, "
                             f"{dense_calls} dense calls")
    return out, got, wall, peak


def spill_line(label: str, st: dict, wall: float, env: dict) -> dict:
    """The request's record: steps, groups, bytes and GB/s each way over
    its streaming seconds (the request less its host-buffer allocation)
    beside the pinned rates, and the host's wait and allocation seconds."""
    stream = wall - st["alloc_s"]
    rec = dict(wall_s=wall, stream_s=stream, **st,
               up_gbps=st["bytes_up"] / stream / 1e9,
               down_gbps=st["bytes_down"] / stream / 1e9)
    log(f"spill {label}: steps={st['steps']} groups={st['groups']} "
        f"bytes up/down={st['bytes_up'] / GIB:.1f}/{st['bytes_down'] / GIB:.1f} "
        f"GiB in {stream:.3f} s of streaming, {rec['up_gbps']:.3f}/"
        f"{rec['down_gbps']:.3f} GB/s (pinned copies alone {env['h2d_gbps']:.3f}/"
        f"{env['d2h_gbps']:.3f} GB/s, both at once {env['both_gbps']:.3f} "
        f"each), host waits {st['wait_s']:.3f} s, host buffers "
        f"{st['alloc_s']:.3f} s (pinned={st['pinned']})")
    return rec


def host_distance(psi, dev, ref_chunk) -> float:
    """||psi - ref||_2 over a host state, chunk by chunk on the card:
    ``ref_chunk(lo, hi)`` gives the reference's (re, im) planes (or a
    complex tensor) of amplitudes [lo, hi) on the card."""
    import torch

    total = 0.0
    for lo in range(0, psi.size, SPILL_CHUNK):
        hi = min(lo + SPILL_CHUNK, psi.size)
        x = torch.from_numpy(psi[lo:hi]).to(dev).to(torch.complex128)
        ref = ref_chunk(lo, hi)
        if isinstance(ref, tuple):
            ref = torch.complex(ref[0].double(), ref[1].double())
        total += float(((x - ref.to(torch.complex128)).abs() ** 2).sum())
    return math.sqrt(total)


def spill_mid(dev, env: dict, rec: dict, counts: dict) -> None:
    """nonstab30 on the host backend at m = 26, unstaged (16 steps, groups
    up to 2^30): within 1e-5 of fused mode in HBM on the card; then
    ``pipeline=False`` and ``transfer="f32"``, each equal bit for bit."""
    import numpy as np
    import torch

    from quantum_simulations_tpu_torch import library
    from quantum_simulations_tpu_torch.runtime import simulator, spill
    from quantum_simulations_tpu_torch.utils.transfer import release_pinned_cache

    n, m = NSPILL_MID, SPILL_M_MID
    cd = library.non_stabilizer(n, 4, SEED)
    want, dense_calls = spill_want(cd, m)
    runs = {}
    for label, kw in ((f"nonstab{n}", {}),
                      (f"nonstab{n} sync", dict(pipeline=False)),
                      (f"nonstab{n} f32", dict(transfer="f32"))):
        st: dict = {}
        psi, counts[label + " spill"], wall, peak = spill_request(
            label, lambda kw=kw, st=st: spill.run_out_of_core(
                cd, stripe_qubits=m, device=dev, stats=st, **kw),
            want, dense_calls)
        r = spill_line(label, st, wall, env)
        r.update(peak_gib=peak, dense_gate_calls=dense_calls)
        runs[label] = psi
        rec[label] = r
    base = runs[f"nonstab{n}"]
    same = {k: bool(np.array_equal(v, base)) for k, v in runs.items()}
    del psi
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = simulator.simulate(cd, device=dev)
    torch.cuda.synchronize()
    rec[f"nonstab{n}"]["fused_in_hbm_s"] = time.perf_counter() - t0
    l2 = float(torch.linalg.vector_norm(
        torch.from_numpy(base).to(dev).to(torch.complex128)
        - ref.to(torch.complex128)))
    del ref, runs, base
    torch.cuda.empty_cache()
    release_pinned_cache()
    rec[f"nonstab{n}"].update(l2_vs_fused=l2, bit_equal=same)
    t = {k: rec[k]["stream_s"] for k in rec if k.startswith(f"nonstab{n}")}
    ok = l2 <= TOL_L2 and all(same.values())
    log(f"spill nonstab{n}: ||psi - psi_fused_hbm||_2={l2:.3e}, bit-equal "
        f"{same}; pipelined {t[f'nonstab{n}']:.3f} s, sync "
        f"{t[f'nonstab{n} sync']:.3f} s (overlap saves "
        f"{t[f'nonstab{n} sync'] - t[f'nonstab{n}']:.3f} s), f32 "
        f"{t[f'nonstab{n} f32']:.3f} s; fused in HBM "
        f"{rec[f'nonstab{n}']['fused_in_hbm_s']:.3f} s {'ok' if ok else 'FAIL'} "
        f"(streaming seconds: each request less its host-buffer allocation)")
    if not ok:
        raise AssertionError(f"nonstab{n} spill is off: {rec[f'nonstab{n}']}")


def spill_big(dev, env: dict, rec: dict, counts: dict) -> None:
    """ghz33 (pipelined, then synchronous) and staged nonstab33 on the
    host backend, single copy, m = 28: 64 GiB through the card each way
    per step.  ghz33 against its closed form, nonstab33 against the
    capacity tier's run on the card, chunk by chunk."""
    import gc

    import numpy as np
    import torch

    from quantum_simulations_tpu_torch import SimulatorConfig, api, library
    from quantum_simulations_tpu_torch.circuit import staging
    from quantum_simulations_tpu_torch.runtime import spill
    from quantum_simulations_tpu_torch.utils.transfer import release_pinned_cache

    n, m = NSPILL, SPILL_M
    need = (8 << n) + HOST_MARGIN
    # Measured before phase 7 pinned anything: memory CUDA unpinned stays
    # out of MemAvailable, though CUDA hands it out again.
    avail = env["mem_available_gib"] * GIB
    if avail < need:
        log(f"spill n={n}: SKIPPED, host MemAvailable {avail / GIB:.1f} GiB "
            f"< {need / GIB:.1f} GiB (the state + margin)")
        rec["big_skipped"] = dict(mem_available_gib=avail / GIB,
                                  need_gib=need / GIB)
        return
    amp = 2.0 ** -0.5
    ghz = library.ghz(n)
    want, dense_calls = spill_want(ghz, m)
    psi = None
    for label, kw in ((f"ghz{n}", {}), (f"ghz{n} sync", dict(pipeline=False))):
        if psi is not None:
            # The synchronous run adopts the first run's pinned buffer,
            # reset to |0>, instead of pinning 64 GiB anew.
            torch.from_numpy(psi.view(np.uint8)).zero_()
            psi[0] = 1
            kw = dict(kw, initial_state=psi)
        st: dict = {}
        psi, counts[label + " spill"], wall, peak = spill_request(
            label, lambda kw=kw, st=st: spill.run_out_of_core(
                ghz, stripe_qubits=m, single_copy=True, device=dev, stats=st,
                **kw), want, dense_calls)
        r = spill_line(label, st, wall, env)
        ends = (complex(psi[0]), complex(psi[-1]))
        top = (1 << n) - 1

        def closed(lo, hi, dev=dev):
            z = torch.zeros(hi - lo, dtype=torch.complex128, device=dev)
            if lo == 0:
                z[0] = amp
            if hi == 1 << n:
                z[-1] = amp
            return z

        t0 = time.perf_counter()
        r.update(peak_gib=peak, end_err=max(abs(a - amp) for a in ends),
                 l2_vs_closed=host_distance(psi, dev, closed),
                 check_s=time.perf_counter() - t0, top=top)
        ok = r["end_err"] <= 1e-6 and r["l2_vs_closed"] <= 1e-6
        log(f"spill {label}: end amplitudes within {r['end_err']:.3e} of "
            f"2^-1/2, ||psi - closed form||_2={r['l2_vs_closed']:.3e} "
            f"(checked in {r['check_s']:.3f} s) {'ok' if ok else 'FAIL'}")
        rec[label] = r
        if not ok:
            raise AssertionError(f"{label} is off its closed form: {r}")
    del psi, kw  # its pinned block stays cached for nonstab33's buffer
    gc.collect()
    log(f"spill ghz{n}: pipelined {rec[f'ghz{n}']['stream_s']:.3f} s of "
        f"streaming (its host buffer {rec[f'ghz{n}']['alloc_s']:.3f} s more), "
        f"sync {rec[f'ghz{n} sync']['stream_s']:.3f} s (the buffer adopted)")

    cd = library.non_stabilizer(n, 4, SEED)
    t0 = time.perf_counter()
    staged, l2p, _ = staging.stage_circuit(cd, m, "heuristic")
    plan_s = time.perf_counter() - t0
    want, dense_calls = spill_want(staged, m)
    label = f"nonstab{n} staged"
    st = {}
    psi, counts[label + " spill"], wall, peak = spill_request(
        label, lambda: spill.run_out_of_core(
            cd, stripe_qubits=m, single_copy=True, use_staging=True,
            device=dev, stats=st), want, dense_calls)
    r = spill_line(label, st, wall, env)
    r.update(peak_gib=peak, plan_s=plan_s, blocks_unpermuted=len(
        staging._bit_runs(l2p)))
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cap = api.simulate(cd, SimulatorConfig(mode="capacity"), device=dev)
    torch.cuda.synchronize()
    r["capacity_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    r["l2_vs_capacity"] = host_distance(
        psi, dev, lambda lo, hi: (cap.re[lo:hi], cap.im[lo:hi]))
    r["check_s"] = time.perf_counter() - t0
    del cap, psi
    gc.collect()
    torch.cuda.empty_cache()
    release_pinned_cache()
    ok = r["l2_vs_capacity"] <= TOL_L2
    log(f"spill {label}: ||psi - psi_capacity||_2={r['l2_vs_capacity']:.3e} "
        f"(capacity run {r['capacity_s']:.3f} s, check {r['check_s']:.3f} s; "
        f"staging plan {plan_s:.3f} s) {'ok' if ok else 'FAIL'}")
    rec[label] = r
    if not ok:
        raise AssertionError(f"{label} is off the capacity tier: {r}")
    log(f"spill ghz{n + 1}: not run, host MemAvailable {avail / GIB:.1f} GiB "
        f"< {((16 << n) + HOST_MARGIN) / GIB:.1f} GiB"
        if avail < (16 << n) + HOST_MARGIN else
        f"spill ghz{n + 1}: not run (optional; the budget)")


def spill_disk(dev, work: Path, rec: dict) -> None:
    """nonstab28 on the disk backend at m = 24, in subprocesses: crashed by
    QST_CRASH_AFTER_STRIPE inside its first group step (the WAL's
    done_steps below the total), resumed in a fresh process, then within
    1e-5 of fused mode in HBM."""
    import shutil

    import torch

    from quantum_simulations_tpu_torch import library
    from quantum_simulations_tpu_torch.runtime import simulator, spill

    n, m = NDISK, DISK_M
    cd = library.non_stabilizer(n, 4, SEED)
    steps = spill.compile_steps(cd, k=m, panel_width=7)
    group = next(i for i, s in enumerate(steps) if spill._group_bits(s, m))
    per_step = 1 << (n - m)
    crash = group * per_step + per_step // 2
    wd = work / f"nonstab{n}_disk"
    shutil.rmtree(wd, ignore_errors=True)
    root = Path(__file__).resolve().parent
    cdfile = work / f"nonstab{n}.json"
    cdfile.write_text(json.dumps(cd))
    script = (f"import json, sys; sys.path.insert(0, {str(root)!r}); "
              f"from quantum_simulations_tpu_torch.runtime import spill; "
              f"spill.run_out_of_core(json.loads(open({str(cdfile)!r}).read()), "
              f"stripe_qubits={m}, backend='disk', work_dir={str(wd)!r}, "
              f"device='cuda')")
    env = dict(os.environ, **{spill.CRASH_ENV: str(crash)})
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", script], env=env, cwd=root,
                          capture_output=True, text=True, timeout=900)
    crash_s = time.perf_counter() - t0
    done = json.loads((wd / "wal.json").read_text())["done_steps"]
    env.pop(spill.CRASH_ENV)
    t0 = time.perf_counter()
    proc2 = subprocess.run([sys.executable, "-c", script], env=env, cwd=root,
                           capture_output=True, text=True, timeout=900)
    resume_s = time.perf_counter() - t0
    if proc.returncode != 1 or proc2.returncode != 0:
        raise AssertionError(f"disk crash {proc.returncode} / resume "
                             f"{proc2.returncode}:\n{proc.stderr}\n{proc2.stderr}")
    psi = spill.collect_state(wd)
    ref = simulator.simulate(cd, device=dev)
    l2 = float(torch.linalg.vector_norm(
        torch.from_numpy(psi).to(dev).to(torch.complex128)
        - ref.to(torch.complex128)))
    del psi, ref
    torch.cuda.empty_cache()
    shutil.rmtree(wd, ignore_errors=True)
    r = dict(steps=len(steps), first_group_step=group, crash_after=crash,
             done_steps_at_crash=done, crash_run_s=crash_s, resume_s=resume_s,
             l2_vs_fused=l2)
    ok = done == group < len(steps) and l2 <= TOL_L2
    log(f"spill nonstab{n} disk: crashed after {crash + 1} stripe writes "
        f"(step {group} of {len(steps)}, a group step) in {crash_s:.3f} s, "
        f"WAL done_steps={done}; resumed in a fresh process in "
        f"{resume_s:.3f} s; ||psi - psi_fused_hbm||_2={l2:.3e} "
        f"{'ok' if ok else 'FAIL'}")
    rec[f"nonstab{n} disk"] = r
    if not ok:
        raise AssertionError(f"nonstab{n} disk crash/resume is off: {r}")


def spill_cli(dev, work: Path, rec: dict) -> None:
    """``run ghz28.json --mode fused --stripe-qubits 24``, host and disk
    backend, as subprocesses: the same output as the in-HBM run's (the
    same command without ``--stripe-qubits``, in this process)."""
    import contextlib
    import io
    import shutil

    from quantum_simulations_tpu_torch import library
    from quantum_simulations_tpu_torch.__main__ import main as cli_main

    root = Path(__file__).resolve().parent
    path = work / f"ghz{NDISK}.json"
    path.write_text(json.dumps(library.ghz(NDISK)))
    base = ["run", str(path), "--mode", "fused", "--top", "2",
            "--device", dev.type]
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        if cli_main(base) != 0:
            raise AssertionError("the in-HBM CLI run failed")
    outs = {"in HBM": json.loads(text.getvalue())}
    for label, extra in (("host", ["--stripe-qubits", str(DISK_M)]),
                         ("disk", ["--stripe-qubits", str(DISK_M),
                                   "--spill-backend", "disk", "--work-dir",
                                   str(work / "cli_disk")])):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "quantum_simulations_tpu_torch", *base,
             *extra], cwd=root, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"cli {label} exited {proc.returncode}:\n"
                                 f"{proc.stderr}")
        outs[label] = json.loads(proc.stdout)
        rec[f"cli ghz{NDISK} {label}"] = dict(wall_s=time.perf_counter() - t0)
    shutil.rmtree(work / "cli_disk", ignore_errors=True)
    want = outs["in HBM"]
    for label in ("host", "disk"):
        got = outs[label]
        exact = got == want
        ok = (exact or (
            [i for i, _ in got["top"]] == [i for i, _ in want["top"]]
            and all(abs(a - b) <= 1e-6 for (_, a), (_, b)
                    in zip(got["top"], want["top"]))
            and abs(got["norm2"] - want["norm2"]) <= 1e-6))
        rec[f"cli ghz{NDISK} {label}"].update(exact=exact, top=got["top"])
        log(f"spill cli run ghz{NDISK}.json --mode fused --stripe-qubits "
            f"{DISK_M} ({label}): top {got['top'][:2]} norm2 {got['norm2']}; "
            f"{'equal to' if exact else 'within 1e-6 of'} the in-HBM run's "
            f"output {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"the CLI's {label} spill output differs: "
                                 f"{got} vs {want}")


def native_check(rec: dict) -> None:
    """The native oracle (C++/OpenMP, built with g++) on nonstab20 within
    1e-10 of the numpy oracle."""
    import numpy as np

    from quantum_simulations_tpu_torch import library, native
    from quantum_simulations_tpu_torch.oracle import dense_numpy
    from quantum_simulations_tpu_torch.oracle import native as nat

    cd = library.non_stabilizer(NNATIVE, 4, SEED)
    t0 = time.perf_counter()
    if not nat.available():
        raise AssertionError(f"the native engine did not build: "
                             f"{native.BUILD_ERROR}")
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = nat.simulate(cd)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = dense_numpy.simulate(cd)
    numpy_s = time.perf_counter() - t0
    err = float(np.abs(got - want).max())
    ok = err <= 1e-10
    rec[f"native nonstab{NNATIVE}"] = dict(max_abs=err, build_s=build_s,
                                          native_s=native_s, numpy_s=numpy_s)
    log(f"spill native nonstab{NNATIVE}: max |psi - psi_numpy| = {err:.3e}; "
        f"build {build_s:.3f} s, native {native_s:.3f} s, numpy "
        f"{numpy_s:.3f} s (host CPU) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the native oracle is off the numpy oracle")


def spill_tier(dev) -> dict:
    """Phase 7: the spill tier's requests; returns their launch counts."""
    import gc
    import shutil

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    work = Path(__file__).resolve().parent / "build" / "chip_smoke_spill"
    rec: dict = {}
    counts: dict = {}
    try:
        env = spill_env(dev, work)
        rec["env"] = env
        spill_big(dev, env, rec, counts)
        spill_mid(dev, env, rec, counts)
        spill_disk(dev, work, rec)
        spill_cli(dev, work, rec)
        native_check(rec)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    RECORD["spill"] = dict(launches=counts, **rec)
    return counts


# ---------------------------------------------------------------------------
# Phase 8: the sharded tier and the WAL runner, positions sharing the card
# ---------------------------------------------------------------------------

NSH, SH_POS = 30, 8            # the reference's sharded size: 8 shards of 2^27
NSH_CAP, CAP_POS = 31, 2       # 2 shards of 2^30 (the capacity guard: 2^27)
NRUN, RUN_POS = 28, 4          # the runner's crash / resume request
POD_PROCS, POD_POS = 2, 2      # the gloo pod: processes x positions each
NRUN_CAP = 30                  # the runner in place on one position
NSPM, SPM_M, SPM_POS = 28, 26, 4  # spill across a mesh: stripes of 2^26 on 4
RANDOM_GATES = 600
SHOTS = 1000
# A readout scalar of the sharded state against the same sum over its
# gathered planes (float64 sums in another order), and against the
# one-device state's (two float32 runs ||dpsi||_2 <= 1e-5 apart: a
# probability moves by at most 2 ||dpsi||_2).
TOL_READOUT = 1e-9
TOL_READOUT_ONE = 2 * TOL_L2


class dry_run:
    """``with dry_run(): ...``: the kernel wrappers take meta tensors for
    card planes and launch nothing, so the launch counts are those the
    dispatch would make (tests/test_torch_capacity.py's dry run)."""

    def __enter__(self):
        self.saved = [(m, m.on_card, m.launch) for m in gate_modules()]
        for m in gate_modules():
            m.on_card = lambda name, re, im: True
            m.launch = lambda *a: None
        return self

    def __exit__(self, *exc):
        for m, on_card, launch in self.saved:
            m.on_card, m.launch = on_card, launch


def _counted(run) -> tuple:
    """(launches, plain torch gate calls) a dry ``run()`` makes."""
    from quantum_simulations_tpu_torch.ops import dense

    reset_counts()
    run()
    return launches(), dense.GATE_CALLS


def _add(total: dict, part: dict, times: int = 1) -> None:
    for key, v in part.items():
        total[key] = total.get(key, 0) + v * times


def sharded_want(cd: dict, positions: int, mode: str = "window",
                 inplace: bool = False, max_levels=None) -> tuple:
    """The plan of a sharded request, derived before it runs: (launches
    summed over the positions, plain torch gate calls, bytes moved
    between positions).  Each step's local ops are dispatched once, dry,
    on meta planes of 2^k (the same on every position); each zero-traffic
    gate's W_0 per position (window mode; an identity block is skipped);
    an exchanging gate ships ``exchange_bytes`` a position and makes one
    plain gate call a position for offset 0 and for each offset that ships
    the whole shard (``offset_traffic`` 1.0) when it has a local qubit; a
    reshard ships ``reshard_bytes``' all_to_all_bytes a position."""
    import numpy as np
    import torch

    from quantum_simulations_tpu_torch.circuit.fusion import compile_steps
    from quantum_simulations_tpu_torch.ops import exchange
    from quantum_simulations_tpu_torch.parallel import executor as E
    from quantum_simulations_tpu_torch.parallel.reshard import (
        plan_boundary_reshard, reshard_bytes)
    from quantum_simulations_tpu_torch.runtime import simulator

    n = cd["number_of_qubits"]
    k = n - (positions.bit_length() - 1)
    window = mode == "window"
    steps = compile_steps(cd, k=k, panel_width=None if window else 7,
                          max_levels_per_step=max_levels)
    meta, f32 = torch.device("meta"), torch.float32

    def planes():
        return (torch.empty(1 << k, device=meta),
                torch.empty(1 << k, device=meta))

    def local(i, step):
        re, im = planes()
        if window:
            for op, dt in simulator.prepare_schedule(paired[i], meta, f32):
                re, im = simulator.apply_window_op(re, im, op, dt,
                                                   inplace=inplace)
        else:
            for op, _ in simulator.prepare_passes(
                    [(op, False) for op in step.local_ops], meta, f32):
                re, im = simulator.apply_panel_op(re, im, op)

    want: dict = {}
    dense_calls = nbytes = 0
    with dry_run():
        paired = E.window_ops(steps, k, inplace) if window else None
        for i, step in enumerate(steps):
            got, calls = _counted(lambda: local(i, step))
            _add(want, got, positions)
            dense_calls += calls * positions
            pairs, rest = plan_boundary_reshard(step.nonlocal_ops, k)
            if pairs:
                nbytes += positions * reshard_bytes(k, len(pairs))[
                    "all_to_all_bytes"]
            for op in rest:
                U, qs = np.asarray(op.U), tuple(op.qubits)
                traffic = exchange.offset_traffic(U, qs, k)
                if window and not traffic:
                    for s in range(positions):
                        W, loc = E._zero_block(op, k, s)
                        if loc and not np.array_equal(W, np.eye(len(W))):
                            got, calls = _counted(lambda: simulator.apply_gate(
                                *planes(), loc, W, inplace=inplace,
                                name=op.name))
                            _add(want, got)
                            dense_calls += calls
                    continue
                calls, moved = _exchange_want(U, qs, k, positions)
                dense_calls += calls
                nbytes += moved
    reset_counts()
    return want, dense_calls, nbytes


def _exchange_want(U, qs: tuple, k: int, positions: int) -> tuple:
    """(plain torch gate calls, bytes handed between positions) of one
    gate through the XOR-offset exchange on shards of 2^k: it ships
    ``exchange_bytes`` a position and makes one plain gate call a
    position for offset 0 and for each offset that ships the whole shard
    (``offset_traffic`` 1.0) when it has a local qubit."""
    from quantum_simulations_tpu_torch.ops import exchange

    calls = 0
    if any(q < k for q in qs):
        calls = positions * ((0 in exchange.nonzero_offsets(U, qs, k)) + sum(
            frac == 1.0 for _, frac in exchange.offset_traffic(U, qs, k)))
    return calls, positions * exchange.exchange_bytes(U, qs, k)


def spill_mesh_want(cd: dict, m: int, positions: int) -> tuple:
    """The plan of a spill run across a mesh (``run_out_of_core(...,
    mesh=)``), as :func:`sharded_want`'s: each step's ops as
    ``spill._remap_ops_mesh`` gives them, once per group (2^(n - m - r)
    groups of shards of 2^(m - d + r)); a gate on a mesh bit by the
    exchange model, every other op dispatched dry on meta planes, once
    a position."""
    import numpy as np
    import torch

    from quantum_simulations_tpu_torch.circuit.fusion import GateOp
    from quantum_simulations_tpu_torch.runtime import simulator, spill

    n = cd["number_of_qubits"]
    d = positions.bit_length() - 1
    meta, f32 = torch.device("meta"), torch.float32
    want: dict = {}
    dense_calls = nbytes = 0
    with dry_run():
        for step in spill.compile_steps(cd, k=m, panel_width=min(7, m - d)):
            bits = spill._group_bits(step, m)
            groups = 1 << (n - m - len(bits))
            k = m - d + len(bits)
            for op in spill._remap_ops_mesh(step, m, bits, d):
                if isinstance(op, GateOp) and max(op.qubits) >= k:
                    calls, moved = _exchange_want(np.asarray(op.U),
                                                  tuple(op.qubits), k, positions)
                    dense_calls += groups * calls
                    nbytes += groups * moved
                    continue
                prepared = simulator.prepare_passes([(op, False)], meta, f32)[0][0]
                got, calls = _counted(lambda: simulator.apply_panel_op(
                    torch.empty(1 << k, device=meta),
                    torch.empty(1 << k, device=meta), prepared))
                _add(want, got, groups * positions)
                dense_calls += groups * positions * calls
    reset_counts()
    return want, dense_calls, nbytes


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()


def _free(dev) -> None:
    import gc

    import torch

    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _peak_reset(dev) -> int:
    """Reset the peak; returns the bytes held now."""
    import torch

    if dev.type != "cuda":
        return 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def _peak(dev) -> int:
    import torch

    return torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0


def sharded_request(label: str, run, plan: tuple, dev) -> tuple:
    """One phase-8 request with the counters set to 0 just before it: its
    launches must be the plan's, no plain twin may run, its plain torch
    gate calls and its bytes moved between positions (``comm``) the
    plan's.  Returns (result, launches, wall s, bytes)."""
    from quantum_simulations_tpu_torch.ops import dense
    from quantum_simulations_tpu_torch.parallel import comm

    want, dense_calls, nbytes = plan
    reset_counts()
    comm.reset_counts()
    t0 = time.perf_counter()
    out = run()
    _sync(dev)
    wall = time.perf_counter() - t0
    got, plain, gates = launches(), plain_calls(), dense.GATE_CALLS
    moved = comm.moved_bytes()
    log(f"sharded {label}: {wall * 1e3:.3f} ms (first call: schedule, "
        f"operand upload) launches={got} plain_calls={plain} "
        f"dense_gate_calls={gates} bytes_moved={moved} "
        f"(ppermute {comm.TRAFFIC['ppermute_bytes']}, all_to_all "
        f"{comm.TRAFFIC['all_to_all_bytes']})")
    if got != want or plain or gates != dense_calls or moved != nbytes:
        raise AssertionError(
            f"{label}: launches {got}, plain {plain}, dense {gates}, bytes "
            f"{moved}; the plan: {want}, no plain call, {dense_calls} dense "
            f"calls, {nbytes} bytes")
    return out, got, wall, moved


def shard_distance(state, ref_re, ref_im) -> float:
    """||psi_sharded - psi_ref||_2 in float64, shard by shard against the
    reference planes' slices."""
    k = state.k
    acc = 0.0
    for s, (re, im) in state.shards.items():
        sl = slice(s << k, (s + 1) << k)
        for a, b in ((re, ref_re[sl]), (im, ref_im[sl])):
            for lo in range(0, a.numel(), SPILL_CHUNK):
                d = a[lo:lo + SPILL_CHUNK].double() - b[lo:lo + SPILL_CHUNK].double()
                acc += float((d * d).sum())
    return math.sqrt(acc)


def permuted_distance(state, ref_re, ref_im, log2phys) -> float:
    """||permute(psi_sharded) - psi_ref||_2 for a staged run, chunk by
    chunk on the device: logical index L reads physical index P, where
    bit log2phys[q] of P is bit q of L (``staging.permute_state``)."""
    import torch

    dev = ref_re.device
    full = [torch.cat([state.shards[s][p] for s in range(state.mesh.size)])
            for p in (0, 1)]
    acc = 0.0
    for lo in range(0, ref_re.numel(), SPILL_CHUNK):
        hi = min(lo + SPILL_CHUNK, ref_re.numel())
        L = torch.arange(lo, hi, device=dev, dtype=torch.int64)
        P = torch.zeros_like(L)
        for q, b in enumerate(log2phys):
            P |= ((L >> q) & 1) << b
        for f, ref in zip(full, (ref_re, ref_im)):
            d = f[P].double() - ref[lo:hi].double()
            acc += float((d * d).sum())
    del full
    return math.sqrt(acc)


def _mesh_on(dev, positions: int):
    from quantum_simulations_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(devices=[dev] * positions)


def _timed(run, dev) -> float:
    """Seconds of one warm call (its schedule compiled and cached)."""
    _sync(dev)
    t0 = time.perf_counter()
    out = run()
    _sync(dev)
    del out
    return time.perf_counter() - t0


def sharded_window(dev, rec: dict, counts: dict) -> None:
    """nonstab30 over 8 positions in window mode, then the readout on it
    (Z strings, measurements) and ghz30's samples; random30 staged (its
    boundary SWAPs as all_to_all reshards); qft28 in fused mode."""
    import torch

    from quantum_simulations_tpu_torch import library
    from quantum_simulations_tpu_torch.circuit import staging
    from quantum_simulations_tpu_torch.ops import sampling
    from quantum_simulations_tpu_torch.parallel import executor as E
    from quantum_simulations_tpu_torch.runtime import simulator

    mesh = _mesh_on(dev, SH_POS)
    n = NSH
    label = f"nonstab{n} window"
    cd = library.non_stabilizer(n, 4, SEED)
    st, counts[label], wall, moved = sharded_request(
        label, lambda: E.simulate_sharded(mesh, cd, mode="window"),
        sharded_want(cd, SH_POS), dev)
    warm_s = _timed(lambda: E.simulate_sharded(mesh, cd, mode="window"), dev)
    ref = simulator.simulate(cd, mode="window", device=dev)
    ref_re, ref_im = ref.real.contiguous(), ref.imag.contiguous()
    del ref
    one_s = _timed(lambda: simulator.simulate(cd, mode="window", device=dev), dev)
    l2 = shard_distance(st, ref_re, ref_im)
    r = dict(first_ms=wall * 1e3, ms=warm_s * 1e3, one_device_ms=one_s * 1e3,
             bytes_moved=moved, l2_vs_one_device=l2)
    log(f"sharded {label} ({SH_POS} positions of 2^{n - 3} on {dev}): "
        f"{warm_s * 1e3:.3f} ms warm, one device {one_s * 1e3:.3f} ms warm; "
        f"{moved} bytes handed between positions (references on one card); "
        f"||psi - psi_one_device||_2="
        f"{l2:.3e} {'ok' if l2 <= TOL_L2 else 'FAIL'}")
    rec[label] = r
    if l2 > TOL_L2:
        raise AssertionError(f"{label} is off the one-device run: {r}")

    # The readout, on the mesh: against the same sums over the gathered
    # planes, and against the one-device planes'.
    full = [torch.cat([st.shards[s][p] for s in range(SH_POS)]) for p in (0, 1)]
    qs = [0, n - 1]
    z = sampling.expectation_z_sharded(st, qs)
    z_full = sampling.expectation_z_planar(*full, qs)
    z_ref = sampling.expectation_z_planar(ref_re, ref_im, qs)
    r = dict(z=z, z_gathered=z_full, z_one_device=z_ref)
    ok = abs(z - z_full) <= TOL_READOUT and abs(z - z_ref) <= TOL_READOUT_ONE
    for q in (3, n - 1):
        gen = torch.Generator().manual_seed(q)
        outcome, post = sampling.measure_qubit_sharded(st, q, gen)
        p1 = sampling.qubit_probability_sharded(st, q)
        p1_full = sampling.qubit_probability_planar(*full, q)
        p1_ref = sampling.qubit_probability_planar(ref_re, ref_im, q)
        pr, pi = full[0].clone(), full[1].clone()
        sampling.collapse_planar_(pr, pi, q, outcome)
        l2q = shard_distance(post, pr, pi)
        pr.copy_(ref_re)
        pi.copy_(ref_im)
        sampling.collapse_planar_(pr, pi, q, outcome)
        l2q_one = shard_distance(post, pr, pi)
        del post, pr, pi
        r[f"measure_q{q}"] = dict(outcome=outcome, p1=p1, p1_gathered=p1_full,
                                  p1_one_device=p1_ref, l2_collapsed=l2q,
                                  l2_collapsed_one_device=l2q_one)
        ok = (ok and abs(p1 - p1_full) <= TOL_READOUT
              and abs(p1 - p1_ref) <= TOL_READOUT_ONE and l2q <= 1e-6
              and l2q_one <= TOL_L2)
    log(f"sharded readout {label}: <Z0 Z{n - 1}>={z:.9f} (gathered "
        f"{z_full:.9f}, one device {z_ref:.9f}); measure q3 / q{n - 1}: "
        + "; ".join(
            f"{k} outcome {v['outcome']} P(1)={v['p1']:.9f} (gathered "
            f"{v['p1_gathered']:.9f}, one device {v['p1_one_device']:.9f}) "
            f"||collapsed - gathered collapsed||_2={v['l2_collapsed']:.3e}, "
            f"- one device's {v['l2_collapsed_one_device']:.3e}"
            for k, v in r.items() if k.startswith("measure"))
        + f" {'ok' if ok else 'FAIL'}")
    rec[f"readout {label}"] = r
    del st, ref_re, ref_im, full
    _free(dev)
    if not ok:
        raise AssertionError(f"the sharded readout is off: {r}")
    label = f"ghz{n} window"
    ghz = library.ghz(n)
    st, counts[label], wall, moved = sharded_request(
        label, lambda: E.simulate_sharded(mesh, ghz, mode="window"),
        sharded_want(ghz, SH_POS), dev)
    t0 = time.perf_counter()
    bits = sampling.sample_bits_sharded(st, SHOTS, seed=SEED)
    sample_s = time.perf_counter() - t0
    ones = bits.sum(dim=1).tolist()
    ok = set(ones) == {0, n} and bits.shape == (SHOTS, n)
    rec[label] = dict(first_ms=wall * 1e3, sample_ms=sample_s * 1e3,
                      all_ones=ones.count(n), all_zeros=ones.count(0))
    log(f"sharded readout {label}: {SHOTS} shots in {sample_s * 1e3:.3f} ms, "
        f"{ones.count(0)} all-0 and {ones.count(n)} all-1, no other "
        f"{'ok' if ok else 'FAIL'}")
    del st
    _free(dev)
    if not ok:
        raise AssertionError(f"{label} samples are not GHZ's")

    # random30, staged: the boundary SWAPs reshard as all_to_all.
    label = f"random{n} window staged"
    cd = library.random_circuit(n, RANDOM_GATES, seed=9)
    t0 = time.perf_counter()
    staged, l2p, _ = staging.stage_circuit(cd, n - 3, method="heuristic")
    plan_s = time.perf_counter() - t0
    plan = sharded_want(staged, SH_POS)
    st, counts[label], wall, moved = sharded_request(
        label, lambda: E.simulate_sharded(mesh, staged, mode="window"), plan, dev)
    from quantum_simulations_tpu_torch.parallel import comm

    reshard_bytes = comm.TRAFFIC["all_to_all_bytes"]
    _sync(dev)
    t0 = time.perf_counter()
    ref = simulator.simulate(cd, mode="window", device=dev)
    _sync(dev)
    one_s = time.perf_counter() - t0
    ref_re, ref_im = ref.real.contiguous(), ref.imag.contiguous()
    del ref
    l2 = permuted_distance(st, ref_re, ref_im, l2p)
    ok = l2 <= TOL_L2 and reshard_bytes > 0
    rec[label] = dict(first_ms=wall * 1e3, one_device_ms=one_s * 1e3,
                      staging_plan_s=plan_s, bytes_moved=moved,
                      all_to_all_bytes=reshard_bytes, l2_vs_unstaged=l2)
    log(f"sharded {label}: staging plan {plan_s:.3f} s; {wall * 1e3:.3f} ms "
        f"(first call), one device unstaged {one_s * 1e3:.3f} ms (first call); "
        f"all_to_all {reshard_bytes} of {moved} bytes; after the permutation "
        f"||psi - psi_unstaged||_2={l2:.3e} {'ok' if ok else 'FAIL'}")
    del st, ref_re, ref_im
    _free(dev)
    if not ok:
        raise AssertionError(f"{label} is off: {rec[label]}")

    # qft28 fused: cross-shard CRs at zero traffic, the terminal SWAPs
    # exchanging.
    label = f"qft{NQ} fused"
    cd = library.qft(NQ)
    st, counts[label], wall, moved = sharded_request(
        label, lambda: E.simulate_sharded(mesh, cd, mode="fused"),
        sharded_want(cd, SH_POS, "fused"), dev)
    _sync(dev)
    t0 = time.perf_counter()
    ref = simulator.simulate(cd, mode="window", device=dev)
    _sync(dev)
    one_s = time.perf_counter() - t0
    l2 = shard_distance(st, ref.real.contiguous(), ref.imag.contiguous())
    rec[label] = dict(first_ms=wall * 1e3, one_device_window_ms=one_s * 1e3,
                      bytes_moved=moved, l2_vs_window_one_device=l2)
    log(f"sharded {label}: {wall * 1e3:.3f} ms, one device (window) "
        f"{one_s * 1e3:.3f} ms, both first calls; {moved} bytes handed "
        f"between positions; "
        f"||psi - psi_window_one_device||_2={l2:.3e} "
        f"{'ok' if l2 <= TOL_L2 else 'FAIL'}")
    del st, ref
    _free(dev)
    if l2 > TOL_L2:
        raise AssertionError(f"{label} is off the window run: {rec[label]}")


def sharded_capacity(dev, rec: dict, counts: dict) -> None:
    """qft31 over 2 positions of 2^30 in place: unstaged it raises the
    capacity ValueError; staged, from a seeded random state, it reshards
    in the shards' memory and matches the one-device capacity run after
    the permutation."""
    import torch

    from quantum_simulations_tpu_torch import library
    from quantum_simulations_tpu_torch.circuit import staging
    from quantum_simulations_tpu_torch.parallel import executor as E
    from quantum_simulations_tpu_torch.parallel.mesh import ShardedState
    from quantum_simulations_tpu_torch.runtime.capacity import simulate_capacity

    n, k = NSH_CAP, NSH_CAP - 1
    mesh = _mesh_on(dev, CAP_POS)
    cd = library.qft(n)
    label = f"qft{n} capacity staged"
    try:
        E.build_circuit_fns(mesh, cd, mode="window", inplace=True)
    except ValueError as e:
        refused = str(e)
    else:
        raise AssertionError(f"qft{n} unstaged in place did not raise")
    log(f"sharded qft{n} capacity unstaged: ValueError {refused[:96]}... ok")
    staged, l2p, _ = staging.stage_circuit(cd, k, method="heuristic")
    plan = sharded_want(staged, CAP_POS, inplace=True)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    re = torch.randn(1 << n, generator=gen, device=dev)
    im = torch.randn(1 << n, generator=gen, device=dev)
    scale = 1.0 / math.sqrt(norm2(re, im))
    re.mul_(scale)
    im.mul_(scale)
    st = ShardedState(mesh, n, {s: (re[s << k:(s + 1) << k].clone(),
                                    im[s << k:(s + 1) << k].clone())
                                for s in range(CAP_POS)})
    steps, fn = E.build_circuit_fns(mesh, staged, mode="window", inplace=True)
    held = _peak_reset(dev)
    st, counts[label], wall, moved = sharded_request(
        label, lambda: fn(st), plan, dev)
    extra = _peak(dev) - held
    t0 = time.perf_counter()
    simulate_capacity(cd, device=dev, initial_planes=(re, im))
    _sync(dev)
    one_s = time.perf_counter() - t0
    l2 = permuted_distance(st, re, im, l2p)
    shard_plane = 4 << k
    ok = l2 <= TOL_L2 and extra <= shard_plane
    rec[label] = dict(first_ms=wall * 1e3, one_device_capacity_ms=one_s * 1e3,
                      bytes_moved=moved, peak_extra_gib=extra / GIB,
                      shard_plane_gib=shard_plane / GIB, l2_vs_one_device=l2,
                      refused=refused)
    log(f"sharded {label} ({CAP_POS} positions of 2^{k}, in place): "
        f"{wall * 1e3:.3f} ms (first call), one device {one_s * 1e3:.3f} ms; "
        f"{moved} bytes resharded; peak {extra / GIB:.3f} GiB above the "
        f"state (a shard plane: {shard_plane / GIB:.0f} GiB); after the "
        f"permutation ||psi - psi_one_device||_2={l2:.3e} "
        f"{'ok' if ok else 'FAIL'}")
    del st, re, im, fn
    _free(dev)
    if not ok:
        raise AssertionError(f"{label} is off: {rec[label]}")


# A subprocess's start-up (python, torch, the port, the card's context:
# 8-10 s) goes beside other work; it waits for its go file, whose path
# is its first argument, then runs the code that follows.
_GATE = ("import os, sys, time, torch, quantum_simulations_tpu_torch\n"
         "if torch.cuda.is_available(): torch.cuda.init()\n"
         "go = sys.argv.pop(1)\n"
         "while not os.path.exists(go): time.sleep(0.02)\n")


def _gated(code: str, args: list, go: Path, env: dict, root: Path):
    """Start ``code`` (after :data:`_GATE`) with ``args`` in a process
    that waits for ``go`` to exist before it runs."""
    return subprocess.Popen([sys.executable, "-c", _GATE + code, str(go), *args],
                            env=env, cwd=root, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _stop(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def _runner_script(root: Path, cdfile: Path, wd: Path, dev, positions: int) -> str:
    return (f"import json, sys; sys.path.insert(0, {str(root)!r}); "
            f"from quantum_simulations_tpu_torch.parallel.mesh import make_mesh; "
            f"from quantum_simulations_tpu_torch.runtime import runner; "
            f"from quantum_simulations_tpu_torch.utils import timing; "
            f"st = {{}}; runner.run(json.loads(open({str(cdfile)!r}).read()), "
            f"{str(wd)!r}, mesh=make_mesh(devices=[{str(dev)!r}] * {positions}), "
            f"mode='window', max_levels_per_step=1, "
            f"checkpoint_every=int(sys.argv[1]), stats=st); "
            f"print(json.dumps(dict(st, timers=timing.snapshot()['timers_s'])))")


def _gbps(st: dict) -> float:
    return st["checkpoint_bytes"] / st["checkpoint_s"] / 1e9 if st["checkpoint_s"] else 0.0


def sharded_runner(dev, work: Path, rec: dict, counts: dict) -> None:
    """nonstab28 through the runner on 4 positions, window mode, one level
    a step: a process crashed by QST_CRASH_AFTER_STEP=1 (after step 0's
    commit), a fresh process resumes; the committed state equal bit for
    bit to an uninterrupted run in this process.  Then nonstab30 through
    ``api.simulate(..., SimulatorConfig(mode="capacity"), work_dir=...)``
    on one position, within 1e-6 of the capacity tier."""
    import shutil

    import numpy as np

    from quantum_simulations_tpu_torch import SimulatorConfig, api, library
    from quantum_simulations_tpu_torch.circuit.fusion import compile_steps
    from quantum_simulations_tpu_torch.runtime import runner
    from quantum_simulations_tpu_torch.runtime.capacity import simulate_capacity
    from quantum_simulations_tpu_torch.utils import timing
    from quantum_simulations_tpu_torch.utils.transfer import release_pinned_cache

    root = Path(__file__).resolve().parent
    n = NRUN
    cd = library.non_stabilizer(n, 4, SEED)
    total = len(compile_steps(cd, k=n - 2, max_levels_per_step=1))
    cdfile = work / f"nonstab{n}.json"
    cdfile.write_text(json.dumps(cd))
    wd = work / f"nonstab{n}_runner"
    script = _runner_script(root, cdfile, wd, dev, RUN_POS)
    env = dict(os.environ, **{runner.CRASH_ENV: "1"})
    # The resuming process starts now too and waits for the crash.
    go = work / "resume.go"
    resume = _gated(script, [str(total)], go,
                    {k: v for k, v in env.items() if k != runner.CRASH_ENV}, root)
    t0 = time.perf_counter()
    crash = subprocess.Popen([sys.executable, "-c", script, "1"], env=env,
                             cwd=root, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
    # The uninterrupted run goes while the crashing process starts up
    # (imports, card context): its checkpoint is written before the other
    # process reaches its first.
    label = f"nonstab{n} runner window"
    st: dict = {}
    mesh = _mesh_on(dev, RUN_POS)
    try:
        _, counts[label], wall, moved = sharded_request(
            label, lambda: runner.run(cd, work / "uninterrupted", mesh=mesh,
                                      mode="window", max_levels_per_step=1,
                                      use_wal=False, stats=st),
            sharded_want(cd, RUN_POS, max_levels=1), dev)
        crash_err = crash.communicate(timeout=600)[1]
        crash_s = time.perf_counter() - t0
        done = json.loads((wd / "wal.json").read_text())["done_steps"]
        t0 = time.perf_counter()
        go.touch()
        resume_out, resume_err = resume.communicate(timeout=600)
        resume_s = time.perf_counter() - t0
    finally:
        _stop([crash, resume])
    if crash.returncode != 1 or resume.returncode != 0:
        raise AssertionError(f"runner crash {crash.returncode} / resume "
                             f"{resume.returncode}:\n{crash_err}\n{resume_err}")
    resumed = json.loads(resume_out.strip().splitlines()[-1])
    a = runner.collect_state(wd)
    b = runner.collect_state(work / "uninterrupted")
    equal = bool(np.array_equal(a, b))
    del a, b
    r = dict(steps=total, done_steps_at_crash=done, crash_run_s=crash_s,
             resume_run_s=resume_s, resume_stats=resumed, uninterrupted_s=wall,
             uninterrupted_stats=st, bit_equal=equal,
             checkpoint_gbps=_gbps(st), resume_checkpoint_gbps=_gbps(resumed))
    ok = equal and done == 1
    log(f"sharded {label} ({RUN_POS} positions, {total} steps of one level): "
        f"crashed after step 1's buffer in {crash_s:.3f} s (WAL done_steps="
        f"{done}; the uninterrupted run beside its start-up), resumed in a "
        f"fresh process (started beside the crash, waiting for it) in "
        f"{resume_s:.3f} s (its buffer read, checked and "
        f"uploaded in {resumed['resume_s']:.3f} s, compile "
        f"{resumed['timers'].get('runner.compile', 0.0):.3f} s, "
        f"{resumed['checkpoints']} checkpoint, {resumed['checkpoint_s']:.3f} s, "
        f"{_gbps(resumed):.3f} GB/s); uninterrupted {wall:.3f} s with "
        f"{st['checkpoints']} checkpoint of {st['checkpoint_bytes'] / GIB:.3f} "
        f"GiB in {st['checkpoint_s']:.3f} s ({_gbps(st):.3f} GB/s: copy to the "
        f"host, sha256, write, fsync); collect_state bit-equal {equal} "
        f"{'ok' if ok else 'FAIL'}")
    rec[label] = r
    shutil.rmtree(wd, ignore_errors=True)
    shutil.rmtree(work / "uninterrupted", ignore_errors=True)
    if not ok:
        raise AssertionError(f"{label} crash / resume is off: {r}")

    n = NRUN_CAP
    cd = library.non_stabilizer(n, 4, SEED)
    label = f"nonstab{n} runner capacity"
    wd = work / f"nonstab{n}_capacity"
    timing.reset()
    psi, counts[label], wall, _ = sharded_request(
        label, lambda: api.simulate(cd, SimulatorConfig(mode="capacity"),
                                    work_dir=wd, device=dev),
        sharded_want(cd, 1, inplace=True), dev)
    ck_s = timing.snapshot()["timers_s"].get("runner.checkpoint", 0.0)
    ck_bytes = sum(p.stat().st_size for p in wd.glob("state_*.npy"))
    cap = simulate_capacity(cd, device=dev)
    l2 = host_distance(psi, dev, lambda lo, hi: (cap.re[lo:hi], cap.im[lo:hi]))
    del psi, cap
    shutil.rmtree(wd, ignore_errors=True)
    _free(dev)
    release_pinned_cache()
    ok = l2 <= TOL_CAPACITY
    rec[label] = dict(wall_s=wall, checkpoint_s=ck_s, checkpoint_bytes=ck_bytes,
                      checkpoint_gbps=ck_bytes / ck_s / 1e9 if ck_s else 0.0,
                      l2_vs_capacity=l2)
    log(f"sharded {label}: {wall:.3f} s through api.simulate(work_dir=...) "
        f"with its checkpoint of {ck_bytes / GIB:.3f} GiB in {ck_s:.3f} s "
        f"({rec[label]['checkpoint_gbps']:.3f} GB/s) and the read-back; "
        f"||psi - psi_capacity||_2={l2:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label} is off the capacity tier: {rec[label]}")


_POD_RUN = ("import runpy\nsys.argv.pop(0)\n"
            "runpy.run_module(sys.argv[0], run_name='__main__', alter_sys=True)\n")


def pod_start(dev, work: Path) -> list:
    """The pod's processes (``parallel.pod_worker`` on nonstab28, window
    mode), started at the start of phase 8 and waiting for
    ``work/pod.go`` (:func:`_gated`)."""
    from quantum_simulations_tpu_torch import library

    root = Path(__file__).resolve().parent
    cdfile = work / f"pod_nonstab{NRUN}.json"
    cdfile.write_text(json.dumps(library.non_stabilizer(NRUN, 4, SEED)))
    procs = []
    for i in range(POD_PROCS):
        env = dict(os.environ, QST_COORDINATOR=f"file://{work / 'pod_store'}",
                   QST_NUM_PROCESSES=str(POD_PROCS), QST_PROCESS_ID=str(i),
                   QST_DIST_BACKEND="gloo", QST_DIST_TIMEOUT="300")
        procs.append(_gated(_POD_RUN, [
            "quantum_simulations_tpu_torch.parallel.pod_worker", str(cdfile),
            "--devices", str(POD_PROCS * POD_POS), "--mode", "window",
            "--device", str(dev)], work / "pod.go", env, root))
    return procs


def sharded_pod(dev, work: Path, rec: dict, counts: dict, procs: list) -> None:
    """nonstab28 in window mode on a pod of 2 processes x 2 positions, over
    gloo with each card piece staged through host memory, both processes
    on this card (``procs``, from :func:`pod_start`): every shard's sha256
    equal to the in-process 4-position run's (made first), the launches,
    plain torch gate calls and bytes handed between positions, each
    summed over the processes, the plan's, and the host-staged
    exchange's bytes and seconds."""
    from quantum_simulations_tpu_torch import library
    from quantum_simulations_tpu_torch.parallel import executor as E
    from quantum_simulations_tpu_torch.parallel.pod_worker import shard_digests

    n, positions = NRUN, POD_PROCS * POD_POS
    cd = library.non_stabilizer(n, 4, SEED)
    plan = sharded_want(cd, positions)
    outs = []
    try:
        label = f"nonstab{n} window {positions} positions"
        st, counts[label], wall, moved = sharded_request(
            label, lambda: E.simulate_sharded(_mesh_on(dev, positions), cd,
                                              mode="window"), plan, dev)
        want = {str(s): h for s, h in shard_digests(st).items()}
        del st
        _free(dev)
        t0 = time.perf_counter()
        (work / "pod.go").touch()
        for p in procs:
            outs.append(p.communicate(timeout=600))
        pod_s = time.perf_counter() - t0
    finally:
        _stop(procs)
    if any(p.returncode for p in procs):
        raise AssertionError("the pod failed:\n" + "\n".join(e for _, e in outs))
    got = json.loads(outs[0][0])
    ex = got["exchange"]
    run_s = max(got["run_s_by_process"])
    remote_gbps = ex["remote_bytes"] / ex["remote_s"] / 1e9 if ex["remote_s"] else 0.0
    pod_bytes = sum(p["ppermute_bytes"] + p["all_to_all_bytes"]
                    for p in got["exchange_by_process"])
    equal = got["shards_sha256"] == want
    ok = (equal and got["launches"] == plan[0] and got["processes"] == POD_PROCS
          and got["dense_gate_calls"] == plan[1] and pod_bytes == plan[2])
    rec[f"pod {label}"] = dict(
        wall_s=pod_s, run_s=run_s, in_process_first_ms=wall * 1e3,
        bit_equal=equal, launches=got["launches"],
        dense_gate_calls=got["dense_gate_calls"], bytes_moved=pod_bytes,
        exchange=got["exchange_by_process"], remote_gbps=remote_gbps)
    log(f"sharded pod {POD_PROCS} processes x {POD_POS} positions of "
        f"nonstab{n} window (gloo, host-staged, one card): {pod_s:.3f} s for "
        f"both processes from their go (started with phase 8), {run_s:.3f} "
        f"s of it from the mesh to the result (the in-process run: "
        f"{wall:.3f} s); launches {got['launches']}, "
        f"dense_gate_calls={got['dense_gate_calls']}, bytes_moved={pod_bytes} "
        f"summed over the processes (the plan: {plan[1]}, {plan[2]}); "
        f"process 0 moved {ex['remote_bytes']} bytes across processes in "
        f"{ex['remote_s']:.3f} s ({remote_gbps:.3f} GB/s); every shard's "
        f"sha256 equal to the in-process run's: {equal} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"the pod run is off: {rec[f'pod {label}']}")


def sharded_spill(dev, rec: dict, counts: dict) -> None:
    """nonstab28 through the spill tier across a mesh: host stripes of
    2^26, each stripe group sharded over 4 positions of the card (shard
    bits 0-23, mesh bits 24-25, stripe bits 26-27), each position's
    sub-blocks through its own pinned ``StripeIO``: launches, plain gate
    calls and bytes handed between positions as ``spill_mesh_want``,
    every stripe once up and once down a step, within 1e-5 of the
    one-device window run."""
    from quantum_simulations_tpu_torch import library
    from quantum_simulations_tpu_torch.runtime import simulator, spill
    from quantum_simulations_tpu_torch.utils.transfer import release_pinned_cache

    n, m = NSPM, SPM_M
    cd = library.non_stabilizer(n, 4, SEED)
    label = f"nonstab{n} spill mesh"
    mesh = _mesh_on(dev, SPM_POS)
    st: dict = {}
    psi, counts[label], wall, moved = sharded_request(
        label, lambda: spill.run_out_of_core(cd, stripe_qubits=m, mesh=mesh,
                                             device=dev, stats=st),
        spill_mesh_want(cd, m, SPM_POS), dev)
    ref = simulator.simulate(cd, mode="window", device=dev)
    l2 = host_distance(psi, dev, lambda lo, hi: ref[lo:hi])
    del psi, ref
    _free(dev)
    release_pinned_cache()
    stream = wall - st["alloc_s"]
    ok = (l2 <= TOL_L2 and st["pinned"] == (dev.type == "cuda")
          and st["bytes_up"] == st["bytes_down"] == st["steps"] * (8 << n))
    rec[label] = dict(wall_s=wall, stream_s=stream, l2_vs_window=l2,
                      bytes_moved=moved, gbps_each_way=st["bytes_up"] / stream / 1e9,
                      **st)
    log(f"sharded {label} ({SPM_POS} positions, stripes of 2^{m}): {wall:.3f} s "
        f"({st['alloc_s']:.3f} s of it pinning the host buffers), "
        f"steps={st['steps']} groups={st['groups']}, "
        f"{st['bytes_up'] / GIB:.1f} GiB each way "
        f"({rec[label]['gbps_each_way']:.3f} GB/s over {stream:.3f} s, "
        f"pinned {st['pinned']}), {moved} bytes between positions; "
        f"||psi - psi_window||_2={l2:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label} is off: {rec[label]}")


def sharded_cli(dev, work: Path, rec: dict) -> None:
    """The CLI in this process: ``run ghz28.json --work-dir wd`` twice (the
    second resumes a finished run: the same output, the WAL as it was),
    ``placement --devices 1 --qubits 28`` (exit 0) and ``run ghz28.json
    --devices 2`` (exit 1, naming the one card found)."""
    import contextlib
    import io

    from quantum_simulations_tpu_torch import library
    from quantum_simulations_tpu_torch.__main__ import main as cli_main

    path = work / f"ghz{NRUN}.json"
    path.write_text(json.dumps(library.ghz(NRUN)))
    wd = work / "cli_wd"

    def cli(argv):
        out, err = io.StringIO(), io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            code = cli_main(argv + ["--device", dev.type])
        return code, out.getvalue(), err.getvalue(), time.perf_counter() - t0

    runs = []
    for _ in range(2):
        runs.append(cli(["run", str(path), "--work-dir", str(wd), "--top", "2"]))
        runs[-1] += (json.loads((wd / "wal.json").read_text()),)
    top = json.loads(runs[0][1])["top"]
    code_p, out_p, _, place_s = cli(["placement", "--devices", "1", "--qubits",
                                     str(NRUN)])
    place = json.loads(out_p)
    code_d, _, err_d, _ = cli(["run", str(path), "--devices", "2"])
    name = __import__("torch").cuda.get_device_name(0) if dev.type == "cuda" else ""
    ok = (runs[0][0] == runs[1][0] == 0 and runs[0][1] == runs[1][1]
          and runs[0][4] == runs[1][4]
          and [i for i, _ in top] == ["0x0", hex((1 << NRUN) - 1)]
          and all(abs(p - 0.5) <= 1e-6 for _, p in top)
          and code_p == 0 and place["invariants"]["ok"]
          and place["sharded_array_check"]["ok"]
          and code_d == 1 and "need 2 devices, have" in err_d and name in err_d)
    rec[f"cli ghz{NRUN}"] = dict(run_s=runs[0][3], resume_s=runs[1][3], top=top,
                                 placement_s=place_s, placement_exit=code_p,
                                 devices2_exit=code_d,
                                 devices2_error=err_d.strip())
    log(f"sharded cli run ghz{NRUN}.json --work-dir: {runs[0][3]:.3f} s, top "
        f"{top}; again (a finished run: no step) {runs[1][3]:.3f} s, the same "
        f"output and WAL {runs[0][4]}; placement --devices 1 --qubits {NRUN}: "
        f"exit {code_p} in {place_s:.3f} s; run --devices 2: exit {code_d}, "
        f"{err_d.strip()!r} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"the CLI's sharded / runner flags are off: "
                             f"{rec[f'cli ghz{NRUN}']}")


def sharded_tier(dev) -> dict:
    """Phase 8: the sharded tier's and the runner's requests; returns their
    launch counts."""
    import shutil

    _free(dev)
    t0 = time.perf_counter()
    work = Path(__file__).resolve().parent / "build" / "chip_smoke_sharded"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    rec: dict = {}
    counts: dict = {}
    log(f"sharded phase 8: host MemAvailable "
        f"{meminfo()['MemAvailable'] / GIB:.1f} GiB")
    pod = pod_start(dev, work)
    parts = {"window": lambda: sharded_window(dev, rec, counts),
             "capacity": lambda: sharded_capacity(dev, rec, counts),
             "runner": lambda: sharded_runner(dev, work, rec, counts),
             "pod": lambda: sharded_pod(dev, work, rec, counts, pod),
             "spill": lambda: sharded_spill(dev, rec, counts),
             "cli": lambda: sharded_cli(dev, work, rec)}
    try:
        for name, part in parts.items():
            part()
            rec[f"{name}_done_s"] = time.perf_counter() - t0
            log(f"sharded phase 8: {name} done at {rec[name + '_done_s']:.3f} s")
    finally:
        _stop(pod)
        shutil.rmtree(work, ignore_errors=True)
    rec["phase_s"] = time.perf_counter() - t0
    log(f"sharded phase 8: {rec['phase_s']:.3f} s; card {card_line() if dev.type == 'cuda' else dev}")
    RECORD["sharded"] = dict(launches=counts, **rec)
    return counts


# ---------------------------------------------------------------------------
# Phase 9: the bench tier
# ---------------------------------------------------------------------------

PORT = "quantum_simulations_tpu_torch"
# Each bench of phase 9 is a subprocess: its argv after the interpreter.
# The CLI's nine run at the JAX package's defaults, except where a
# ``--set`` (or, for the others, a flag) cuts one to the phase's budget.
BENCH_ARGV = {
    "kernel_bw": ["-m", PORT, "bench", "kernel_bw"],
    "e2e": ["-m", PORT, "bench", "e2e"],
    "sweep": ["-m", PORT, "bench", "sweep"],
    "suite": ["-m", PORT, "bench", "suite"],
    "spill_bw": ["-m", PORT, "bench", "spill_bw"],
    "baseline_configs": ["-m", PORT, "bench", "baseline_configs"],
    "capacity": ["-m", PORT, "bench", "capacity"],
    "matrix": ["-m", PORT, "bench", "matrix"],
    "projection": ["-m", PORT, "bench", "projection"],
    "c128_diff": ["-m", f"{PORT}.bench.c128_diff", "--sizes", "16,18"],
    "passes": ["-m", f"{PORT}.bench.passes", "--config", "nonstab28",
               "--reps", "6", "--samples", "3"],
    "shard_timing": ["-m", f"{PORT}.bench.sharded", "shard_timing", "30"],
    "headline": ["-m", f"{PORT}.bench.headline"],
}
BENCH_AHEAD = 2          # subprocesses started (and waiting) beside the running one
BENCH_BUDGET_S = 180.0
BENCH_RATIO = 1.5        # passes' TOTAL and the headline against phase 4
BENCH_OVER = 1.05        # no reading above 105% of a bound

# A bench subprocess after :data:`_GATE`: its module run as ``-m`` runs it;
# then the kernels' launches in that process, by key, go to stderr.
# An argv of ``-c <code>`` runs the code instead (phase 11's entries that
# are a function call, not a module's ``__main__``).
_BENCH_RUN = ("import json, runpy\n"
              "from quantum_simulations_tpu_torch.ops import (\n"
              "    bitperm_kernels, diag_kernels, pair_kernels, panel_kernels)\n"
              "kind, mod = sys.argv[1], sys.argv[2]\n"
              "sys.argv = [mod] + sys.argv[3:]\n"
              "try:\n"
              "    if kind == '-c':\n"
              "        exec(mod, {'__name__': '__main__'})\n"
              "    else:\n"
              "        runpy.run_module(mod, run_name='__main__', alter_sys=True)\n"
              "finally:\n"
              "    print('LAUNCHES ' + json.dumps({\n"
              "        k: v for m in (bitperm_kernels, diag_kernels, pair_kernels,\n"
              "                       panel_kernels) for k, v in m.LAUNCHES.items()\n"
              "        if v}), file=sys.stderr, flush=True)\n")
LAUNCHES_TAG = "LAUNCHES "


def bench_launches(err: str) -> dict:
    """The launches a bench subprocess reported on its stderr."""
    lines = [line for line in err.splitlines() if line.startswith(LAUNCHES_TAG)]
    return json.loads(lines[-1][len(LAUNCHES_TAG):]) if lines else {}


def last_json(out: str):
    """The JSON document a bench printed last: its last line, or (printed
    with ``indent``) the lines from the last one that is ``{``."""
    lines = out.rstrip().splitlines()
    try:
        return json.loads(lines[-1])
    except (IndexError, json.JSONDecodeError):
        start = max(i for i, line in enumerate(lines) if line == "{")
        return json.loads("\n".join(lines[start:]))


def _positive(rows, *keys) -> None:
    bad = [r for r in rows if not all(r[k] > 0 for k in keys)]
    if bad:
        raise AssertionError(f"a wall time or rate is not > 0: {bad[:3]}")


def check_bench(name: str, out: dict, ref: dict) -> str:
    """Hold one bench's JSON to phase 9's checks (``ref``: phase 4's e2e
    nonstab28 window record, ``ms`` and ``amp_updates_per_s``); returns
    its key numbers for the log line, raises AssertionError if a check
    fails."""
    from quantum_simulations_tpu_torch.bench import HBM_BYTES_PER_S

    if name == "suite":
        if out["n_mismatch"]:
            raise AssertionError(f"suite: {out['n_mismatch']} mismatches: "
                                 f"{[r for r in out['rows'] if r.get('status') == 'MISMATCH'][:3]}")
        ok = [r for r in out["rows"] if r["status"] == "ok"]
        return (f"{len(ok)} rows ok ({len(out['rows']) - len(ok)} skipped), "
                f"worst err {max(r['max_err'] for r in ok):.3e}")
    if name == "c128_diff":
        if not out["met"]:
            raise AssertionError(f"c128_diff not met: {out}")
        return f"met, worst amp err {out['worst_amp_err']:.3e}"
    if name == "matrix":
        rows = [r for r in out["rows"] if not r["status"].startswith("skip")]
        bad = [r for r in rows if r["status"] != "ok"]
        if bad or out["n_bad"]:
            raise AssertionError(f"matrix: rows not ok: {bad[:3]}")
        sharded = [r for r in rows if "sharded" in r["tiers"]]
        want = [r for r in rows if (1 << r["n"]) >= out["positions"] * 128]
        if not want or len(sharded) != len(want):
            raise AssertionError(f"matrix: {len(sharded)} sharded rows of "
                                 f"{len(want)} wanted")
        worst = max(t["max_err"] for r in rows for t in r["tiers"].values())
        return (f"{len(rows)} rows ok over {out['tiers_seen']}, {len(sharded)} "
                f"sharded on {out['positions']} positions, worst err {worst:.3e}")
    if name == "e2e":
        _positive(out["results"], "wall_s", "amp_updates_per_s")
        best = max(out["results"], key=lambda r: r["amp_updates_per_s"])
        return (f"{len(out['results'])} rows; best {best['family']}{best['n']} "
                f"{best['mode']} {best['amp_updates_per_s']:.4e} amp-updates/s")
    if name == "sweep":
        _positive(out["rows"], "wall_s")
        return ", ".join(f"{r['mode']}/{r.get('use_fusion', '')}/"
                         f"{r.get('panel_width', '')} {r['wall_s'] * 1e3:.3f} ms"
                         for r in out["rows"])
    if name == "baseline_configs":
        _positive(out["rows"], "steady_s", "amp_updates_per_s")
        return ", ".join(f"{r['config']} {r['steady_s'] * 1e3:.3f} ms"
                         for r in out["rows"])
    if name == "kernel_bw":
        limit = BENCH_OVER * HBM_BYTES_PER_S / 1e9
        bad = {k: v for k, v in out["ops"].items()
               if "error" in v or not (v["s_per_pass"] > 0 and v["GBs"] <= limit)}
        if bad:
            raise AssertionError(f"kernel_bw: rows in error or above "
                                 f"{limit:.0f} GB/s: {bad}")
        return ", ".join(f"{k} {v['GBs']:.1f}" for k, v in out["ops"].items()) + " GB/s"
    if name == "passes":
        covered = sorted(p for r in out["rows"] for p in r["passes"])
        if covered != list(range(out["passes"])):
            raise AssertionError(f"passes: attributed {covered}, not each of "
                                 f"{out['passes']} once")
        over = [r for r in out["rows"]
                if r["floor_ms"] > BENCH_OVER * r["measured_ms"]]
        if over:
            raise AssertionError(f"passes: rows above {BENCH_OVER:.0%} of "
                                 f"their bound: {over}")
        ratio = out["total_ms"] / ref["ms"]
        if not 1 / BENCH_RATIO <= ratio <= BENCH_RATIO:
            raise AssertionError(f"passes: TOTAL {out['total_ms']} ms is "
                                 f"{ratio:.3f} x phase 4's {ref['ms']:.3f} ms")
        return (f"TOTAL {out['total_ms']:.3f} ms ({ratio:.3f} x phase 4), bound "
                f"{out['floor_total_ms']:.3f} ms; " + "; ".join(
                    f"{r['kind']} {r['measured_ms']:.3f} ms {r['pct_of_bound']}% "
                    f"{r['binding']}" for r in out["rows"]))
    if name == "shard_timing":
        shard = out["shard_amplitudes"] * 8
        if not (out["collectives"] >= 1 and out["exchange_bytes_per_position"]
                <= out["collectives"] * shard and out["measured_shard_compute_s"] > 0):
            raise AssertionError(f"shard_timing: {out}")
        return (f"{out['config']}: shard compute {out['measured_shard_compute_s']:.4f} s, "
                f"{out['local_window_passes']} passes, {out['collectives']} "
                f"exchanges, {out['exchange_bytes_per_position']} B a position")
    if name == "capacity":
        _positive(out["rows"], "steady_s", "amp_updates_per_s")
        over = [r for r in out["rows"]
                if "peak_gib" in r and r["peak_gib"] > r["planes_gib"] + 1]
        if over:
            raise AssertionError(f"capacity: peak above 2 planes + 1 GiB: {over}")
        return ", ".join(f"{r['config']} {r['steady_s'] * 1e3:.3f} ms "
                         f"peak {r.get('peak_gib', 0):.3f} GiB" for r in out["rows"])
    if name == "headline":
        ratio = out["metric"] / ref["amp_updates_per_s"]
        if not 1 / BENCH_RATIO <= ratio <= BENCH_RATIO:
            raise AssertionError(f"headline: {out['metric']:.4e} is {ratio:.3f} x "
                                 f"phase 4's {ref['amp_updates_per_s']:.4e}")
        return (f"{out['metric']:.4e} amp-updates/s ({ratio:.3f} x phase 4), "
                f"vs_baseline {out['vs_baseline']:.1f}, t {out['wall_s'] * 1e3:.3f} ms")
    if name == "spill_bw":
        _positive(out["rows"], "wall_s", "MB_per_s")
        if abs(out["rows"][0]["norm"] - 1) > 1e-4:
            raise AssertionError(f"spill_bw: norm {out['rows'][0]['norm']}")
        return ", ".join(f"{r['backend']} {r['MB_per_s']:.1f} MB/s" for r in out["rows"])
    if name == "projection":
        if not (math.isfinite(out["projected_total_s"]) and out["local_s"] > 0):
            raise AssertionError(f"projection: {out}")
        return (f"{out['projected_total_s']:.3f} s projected at "
                f"{out['amp_updates_per_s']:.4e} amp-updates/s, "
                f"{out['reshard_gib_per_position']} GiB resharded a position")
    raise KeyError(name)


def _stdout_json(out: str, err: str):
    return last_json(out)


def open_phase(dev, argv: dict, phase: int, *, prepare=None, envs=None) -> dict:
    """A bench phase's work dir (``build/chip_smoke_phase<N>``, made anew;
    ``prepare(work)`` then fills it) and its first subprocesses started,
    waiting for their go files: ``{"work", "procs", "start"}``.  The entry
    ``{work}`` in an argv, or in a value of ``envs[name]`` (variables set
    for that bench alone), is the work dir."""
    import shutil

    root = Path(__file__).resolve().parent
    work = root / "build" / f"chip_smoke_phase{phase}"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    if prepare is not None:
        prepare(work)
    env = dict(os.environ)  # the benches measure the device the phase is given
    env.pop("QST_BENCH_PLATFORM", None)
    if dev.type == "cpu":
        env["QST_BENCH_PLATFORM"] = "cpu"
    procs: dict = {}

    def start(name):
        args = [a.replace("{work}", str(work)) for a in argv[name]]
        own = dict(env, **{k: v.replace("{work}", str(work))
                           for k, v in (envs or {}).get(name, {}).items()})
        procs[name] = _gated(_BENCH_RUN, args, work / f"{name}.go", own, root)

    try:
        for name in list(argv)[:BENCH_AHEAD + 1]:
            start(name)
    except BaseException:
        _stop(procs.values())
        raise
    return {"work": work, "procs": procs, "start": start}


def bench_tier(dev, ref: dict, argv: dict, budget_s: float, phase: int,
               check, *, parse=_stdout_json, opened=None, then=None) -> None:
    """Phase 9 (:data:`BENCH_ARGV`, :func:`check_bench`), phase 10
    (:data:`DIAG_ARGV`, :func:`check_diag`) or phase 11
    (:func:`corpus_argv`, :func:`check_corpus`): every bench of ``argv``
    as a subprocess (started ahead of its turn, waiting for a go file),
    its output read by ``parse(stdout, stderr)`` (by default the JSON it
    printed last), held to ``check(name, result, ref)`` and its kernels'
    launches logged by key.  A bench that exits non-zero fails the phase
    after its stderr's tail.  The phase is ``opened`` (:func:`open_phase`)
    here unless it was opened earlier; its work dir is removed after.
    ``then()`` runs as the last bench starts: phase 10 opens phase 11
    there, so phase 11's first processes start while it runs."""
    import shutil

    import torch

    _free(dev)
    opened = opened or open_phase(dev, argv, phase)
    work, procs, start = opened["work"], opened["procs"], opened["start"]
    names = list(argv)
    rec: dict = {}
    t_phase = time.perf_counter()

    try:
        for i, name in enumerate(names):
            free, _ = torch.cuda.mem_get_info(dev) if dev.type == "cuda" else (0, 0)
            log(f"bench {name}: host MemAvailable "
                f"{meminfo()['MemAvailable'] / GIB:.1f} GiB, card free "
                f"{free / GIB:.1f} GiB")
            t0 = time.perf_counter()
            (work / f"{name}.go").touch()
            if then is not None and i == len(names) - 1:
                then()
            out, err = procs[name].communicate(timeout=600)
            dt = time.perf_counter() - t0
            if i + BENCH_AHEAD + 1 < len(names):
                start(names[i + BENCH_AHEAD + 1])
            if procs[name].returncode != 0:
                log(f"bench {name}: FAIL exit {procs[name].returncode} after "
                    f"{dt:.3f} s; stderr tail:\n{err[-4000:]}")
                raise AssertionError(f"bench {name} exited "
                                     f"{procs[name].returncode}")
            result = parse(out, err)
            rec[name] = dict(s=dt, result=result, launches=bench_launches(err))
            try:
                summary = check(name, result, ref)
            except AssertionError:
                log(f"bench {name}: FAIL in {dt:.3f} s; stdout tail:\n{out[-3000:]}")
                raise
            log(f"bench {name}: {dt:.3f} s; {summary}; launches "
                f"{rec[name]['launches']} ok")
    finally:
        _stop(procs.values())
        shutil.rmtree(work, ignore_errors=True)
    rec["phase_s"] = time.perf_counter() - t_phase
    by_kernel: dict = {}
    for name in names:
        for k, v in rec[name]["launches"].items():
            by_kernel[kernel_of(k)] = by_kernel.get(kernel_of(k), 0) + v
    rec["launches_by_kernel"] = by_kernel
    log(f"bench phase {phase} launches by kernel: {by_kernel}")
    log(f"bench phase {phase}: {rec['phase_s']:.3f} s (budget {budget_s:.0f} s"
        f"{'' if rec['phase_s'] <= budget_s else ', OVER'}); card "
        f"{card_line() if dev.type == 'cuda' else dev}")
    RECORD[f"bench{phase}"] = rec


# ---------------------------------------------------------------------------
# Phase 10: the bench diagnostics
# ---------------------------------------------------------------------------

# Each diagnostic of phase 10 is a subprocess, at the JAX package's
# defaults but for wal_tax: its argv after the interpreter ({work}: the
# phase's work dir).
NWAL = 26
DIAG_ARGV = {
    "probe_transfer": ["-m", f"{PORT}.bench.probe_transfer"],
    "opprof": ["-m", f"{PORT}.bench.opprof"],
    "overhead": ["-m", f"{PORT}.bench.overhead", "all"],
    # nonstab26, not the default nonstab28: its 2 GiB fsync'd checkpoints
    # cost about 20 s, which the script's time limit does not leave
    "wal_tax": ["-m", f"{PORT}.bench.overhead", "wal", "{work}/wal_tax",
                str(NWAL)],
    "sample_run": ["-m", f"{PORT}.bench.capacity", "sample"],
    "spill_overlap": ["-m", f"{PORT}.bench.spill_bw", "overlap"],
    "spill_slice": ["-m", f"{PORT}.bench.spill_bw", "slice40"],
    "spill_real": ["-m", f"{PORT}.bench.spill_bw", "real"],
    "spill_ghz31": ["-m", f"{PORT}.bench.spill_bw", "ghz"],
    "sharded_run": ["-m", f"{PORT}.bench.sharded"],
    "sharded_run16": ["-m", f"{PORT}.bench.sharded", "mesh16", "{work}/mesh16"],
}
DIAG_BUDGET_S = 240.0
PCIE_GBS = 64.0          # PCIe Gen5 x16, each way: no copy rate above it
DIAG_NORM = 1e-5         # |norm2 - 1|
DIAG_INPLACE = 1e-6      # an in-place state against the out-of-place one
DIAG_SIGMA = 5.0         # a sampled one-count against its exact P(1)
DIAG_POLE = 1e-6         # a GHZ pole's error, an off-pole amplitude
DIAG_C128 = 1e-10        # complex128 rows against the oracle
DIAG_POD = 1e-4          # the pod program (complex64) against the oracle


def _norm_ok(x: float) -> bool:
    return abs(x - 1.0) <= DIAG_NORM


def _schedule_classes(cd: dict) -> dict:
    from collections import Counter

    from quantum_simulations_tpu_torch.bench.opprof import _class_key
    from quantum_simulations_tpu_torch.circuit.panelize import compile_window_schedule

    return dict(Counter(_class_key(op) for op in
                        compile_window_schedule(cd, diag_terms_only=True)))


def _not_over(what: str, rows: dict) -> None:
    limit = BENCH_OVER * HBM_BYTES_PER_S / 1e9
    bad = {k: v for k, v in rows.items()
           if not (v["s_per_pass"] > 0 and v["GBs"] <= limit)}
    if bad:
        raise AssertionError(f"{what}: rows at 0 s or above {limit:.0f} GB/s: {bad}")


def check_diag(name: str, out: dict, ref: dict) -> str:
    """Hold one diagnostic's JSON to phase 10's checks (``ref``: phase 4's
    nonstab28 window ``ms`` and its ``lane_panel_ms`` row); returns its key
    numbers for the log line, raises AssertionError if a check fails."""
    from quantum_simulations_tpu_torch.circuit import library

    if name == "probe_transfer":
        if out["failed"] or any("error" in r for r in out["rows"] + out["both_ways"]):
            raise AssertionError(f"probe_transfer: copies failed: {out['failed']}")
        pinned = ([(r["h2d_GBs"], r["d2h_GBs"]) for r in out["rows"]
                   if r["memory"] == "pinned"]
                  + [(r["each_way_GBs"],) for r in out["both_ways"]
                     if r["memory"] == "pinned"])
        if not all(0 < x <= PCIE_GBS for t in pinned for x in t):
            raise AssertionError(f"probe_transfer: a pinned rate outside (0, "
                                 f"{PCIE_GBS:.0f}] GB/s: {pinned}")
        return "; ".join(
            f"{r['dtype']} {r['MB']} MB {r['memory']} up {r['h2d_GBs']:.3f} "
            f"down {r['d2h_GBs']:.3f}" for r in out["rows"]) + "; both ways " + \
            ", ".join(f"{r['dtype']} {r['MB']} MB {r['each_way_GBs']:.3f} each"
                      for r in out["both_ways"]) + " GB/s"
    if name == "opprof":
        for key, cd in (("qft", library.qft(out["qft"]["n"])),
                        ("nonstab", library.non_stabilizer(out["nonstab"]["n"]))):
            got = {k: v["count"] for k, v in out[key]["classes"].items()}
            want = _schedule_classes(cd)
            if got != want or out[key]["ops"] != sum(want.values()):
                raise AssertionError(f"opprof {key}: classes {got}, the schedule's {want}")
            _not_over(f"opprof {key}", out[key]["classes"])
        _not_over("opprof policies", out["policies"]["cases"])
        ratio = out["nonstab"]["est_total_s"] * 1e3 / ref["ms"]
        if not 1 / BENCH_RATIO <= ratio <= BENCH_RATIO:
            raise AssertionError(f"opprof: nonstab est_total_s "
                                 f"{out['nonstab']['est_total_s']} is {ratio:.3f} x "
                                 f"phase 4's {ref['ms']:.3f} ms")
        return "; ".join(
            f"{key}{out[key]['n']} est {out[key]['est_total_s'] * 1e3:.3f} ms ("
            + ", ".join(f"{k} x{v['count']} {v['s_per_pass'] * 1e3:.3f} ms "
                        f"{v['GBs']:.1f} GB/s" for k, v in out[key]["classes"].items())
            + ")" for key in ("qft", "nonstab")) + \
            f"; nonstab {ratio:.3f} x phase 4; policies " + ", ".join(
                f"{k} {v['s_per_pass'] * 1e3:.3f} ms" for k, v in out["policies"]["cases"].items())
    if name == "overhead":
        rows = out["nonstab_variants"]
        bad = [r for r in rows if not _norm_ok(r["norm2"])
               or r["l2_vs_planar_io"] > DIAG_INPLACE]
        fit = out["panel_scaling"]["fit"]
        if bad:
            raise AssertionError(f"overhead: variants off: {bad}")
        ratio = fit["slope_ms_per_pass"] / ref["lane_panel_ms"]
        if not 1 / BENCH_RATIO <= ratio <= BENCH_RATIO:
            raise AssertionError(f"overhead: slope {fit['slope_ms_per_pass']:.3f} ms is "
                                 f"{ratio:.3f} x phase 4's lane_panel "
                                 f"{ref['lane_panel_ms']:.3f} ms")
        _not_over("overhead diag", {r["variant"]: r for r in out["diag_variants"]})
        return ("; ".join(f"{r['variant']} {r['steady_s'] * 1e3:.3f} ms, "
                          f"{r['ms_per_pass']:.3f} ms a pass of {r['passes']}, l2 "
                          f"{r['l2_vs_planar_io']:.3e}" for r in rows)
                + f"; chain fixed {fit['intercept_ms']:.3f} ms, pass "
                  f"{fit['slope_ms_per_pass']:.3f} ms ({ratio:.3f} x phase 4), norm2 "
                  f"{out['panel_scaling']['norm2']:.9f}; diag "
                + ", ".join(f"{r['variant']} ({r['n_terms']} terms) "
                            f"{r['s_per_pass'] * 1e3:.3f} ms {r['GBs']:.1f} GB/s"
                            for r in out["diag_variants"]))
    if name == "wal_tax":
        rows = out["wal_tax"]
        if (len({r["n_steps"] for r in rows}) != 1
                or not all(r["checkpoint_MB_s"] and r["checkpoint_MB_s"] > 0
                           for r in rows)):
            raise AssertionError(f"wal_tax: steps differ or no checkpoint rate: {rows}")
        return "; ".join(f"{r['config']} wall {r['wall_s']:.3f} s, steps "
                         f"{r['exec_s']:.3f} s ({r['n_steps']}), {r['n_checkpoints']} "
                         f"checkpoints {r['checkpoint_s']:.3f} s at "
                         f"{r['checkpoint_MB_s']:.1f} MB/s" for r in rows)
    if name == "sample_run":
        z = max(abs(c - out["shots"] * p) / math.sqrt(out["shots"] * p * (1 - p))
                for c, p in zip(out["counts"], out["p1"]))
        # a card run must report its peak; only the CPU rehearsal has none
        if out["device"] != "cpu" and "peak_gib" not in out:
            raise AssertionError("sample_run: the card run reports no peak_gib")
        over = out.get("peak_gib", 0.0) > out["planes_gib"] + 1
        if not _norm_ok(out["norm2"]) or z > DIAG_SIGMA or over:
            raise AssertionError(f"sample_run: norm2 {out['norm2']}, worst "
                                 f"{z:.2f} sigma, peak {out.get('peak_gib')} GiB")
        return (f"{out['config']} {out['passes']} passes {out['circuit_s']:.3f} s; "
                f"{out['shots']} shots {out['sample_s']:.4f} s, "
                f"{out['shots_per_s']:.4e} shots/s; worst {z:.2f} sigma; peak "
                f"{out.get('peak_gib', 0):.3f} GiB of {out['planes_gib']:.0f} GiB planes")
    if name == "spill_overlap":
        if not (out["bit_equal"] and _norm_ok(out["pipelined"]["norm"])
                and _norm_ok(out["synchronous"]["norm"])):
            raise AssertionError(f"spill_overlap: {out}")
        return (f"pipelined {out['pipelined']['wall_s']:.3f} s, synchronous "
                f"{out['synchronous']['wall_s']:.3f} s, x{out['overlap_speedup']:.3f}, "
                f"bit-equal")
    if name == "spill_slice":
        kinds = {r["step_kind"] for r in out["measured"]}
        want = out["steps"] << (out["n"] - out["stripe_qubits"])
        if kinds != {"local", "nonlocal"} or out["total_stripe_passes"] != want \
                or not out["est_full_run_s"] > 0:
            raise AssertionError(f"spill_slice: {out}")
        return (f"qft{out['n']} m={out['stripe_qubits']}: {out['steps']} steps, "
                f"{out['total_stripe_passes']} stripe passes; " + ", ".join(
                    f"{r['step_kind']} ({r['group_stripes']} stripes) "
                    f"{r['per_stripe_s'] * 1e3:.3f} ms a stripe, {r['stripe_GB_s']:.3f} GB/s"
                    for r in out["measured"]) + f"; est {out['est_full_run_h']:.3f} h")
    if name == "spill_real":
        if not out["l2_vs_inhbm"] <= TOL_L2:
            raise AssertionError(f"spill_real: ||psi - psi_HBM|| {out['l2_vs_inhbm']}")
        return (f"n={out['n']} m={out['stripe_qubits']} f32 {out['wall_s']:.3f} s, "
                f"{out['MB_per_s_streamed']:.1f} MB/s streamed, ||psi - psi_HBM||_2="
                f"{out['l2_vs_inhbm']:.3e}")
    if name == "spill_ghz31":
        errs = (out["amp0_err"], out["ampN_err"], out["max_offpole_amp"])
        if max(errs) > DIAG_POLE or not _norm_ok(out["norm2"]):
            raise AssertionError(f"spill_ghz31: {out}")
        return (f"ghz{out['n']} m={out['stripe_qubits']} {out['state_GiB']:.0f} GiB "
                f"pinned={out['pinned']} {out['wall_s']:.3f} s (alloc "
                f"{out['alloc_s']:.3f} s), {out['MB_per_s_streamed']:.1f} MB/s "
                f"streamed; pole errors {errs[0]:.3e} {errs[1]:.3e}, off-pole "
                f"{errs[2]:.3e}, norm2 {out['norm2']:.9f}")
    if name == "sharded_run":
        ghz = next(r for r in out["rows"] if r["config"].startswith("ghz"))
        syc = next(r for r in out["rows"] if r["config"].startswith("sycamore")
                   and "d2" in r["config"])
        orc = [r for r in out["rows"] if "max_err_vs_oracle" in r]
        if (max(ghz["amp0_err"], ghz["ampN_err"]) > DIAG_POLE or not _norm_ok(syc["norm2"])
                or len(orc) != 2 or max(r["max_err_vs_oracle"] for r in orc) > DIAG_C128):
            raise AssertionError(f"sharded_run: {out['rows']}")
        return "; ".join(f"{r['config']} {r['wall_s']:.3f} s" for r in out["rows"]) + \
            (f"; poles {ghz['amp0_err']:.3e} {ghz['ampN_err']:.3e}, norm2 "
             f"{syc['norm2']:.9f}, oracle " + ", ".join(
                 f"{r['max_err_vs_oracle']:.3e}" for r in orc))
    if name == "sharded_run16":
        dry, pod = out["rows"]
        if not (dry["ok"] and len(dry["tiers"]) == 5 and len(dry["max_err"]) == 5
                and pod["max_err_vs_oracle"] <= DIAG_POD
                and pod["sampler_min_prob_sampled"] > 1e-12):
            raise AssertionError(f"sharded_run16: {out['rows']}")
        return (f"dry run {dry['wall_s']:.3f} s, tiers " + ", ".join(
            f"{k} {v:.3e}" for k, v in dry["max_err"].items())
            + f"; pod14 on 16 positions err {pod['max_err_vs_oracle']:.3e}, "
              f"{pod['stages']} stages, 64 shots min p {pod['sampler_min_prob_sampled']:.3e}")
    raise KeyError(name)


# ---------------------------------------------------------------------------
# Phase 11: the corpus tier
# ---------------------------------------------------------------------------

# The corpus the phase writes in QASMBench's cluster/ layout
# (<name>/<name>.qasm) from circuit/library through export_qasm.to_qasm,
# and each circuit's policy (corpus.py): the method its row must carry.
# Under corpus/ for `corpus --tier all`; under extra/ the circuits of
# corpus33 and of the fingerprint check, which the corpus run must not see;
# under big/ corpus_big's two.
CORPUS_N = {"qft": 14, "sycamore": 18, "nonstab": 26, "traj": 16,
            "adder": 40, "qft33": 33}
CORPUS_METHOD = {"qft": "e2e_c128", "sycamore": "e2e_c128",
                 "nonstab": "segment_restart_c128[4]_fusedtier",
                 "traj": "trajectory_twin_c128",
                 "adder": "sparse_exact_vs_classical_oracle",
                 "qft33": "parse_only"}
CORPUS_SEG = ("--seg-gates", "4", "--seg-k", "1")
# The JAX package's reason for a dense row it cannot twin (n = 33).
CORPUS_REASON = ("c128 twin needs 384 GiB host RAM (>125); runnable at c64 "
                 "via spill tier")
ADDER_A, ADDER_B = 370001, 150037  # both operands: only X / CNOT / CCX
# corpus33: random_circuit(28, 200, seed=8), whose first host-bit window
# of 7 gates runs lane_panel and the pair kernel in its stripe groups.
C33_N, C33_M, C33_SEG, C33_SEED = 28, 24, 7, 8
FP_N = 14                # the fingerprint check's circuit: qaoa_maxcut(14)
FP_SHIFT = 1e-6          # the corrupted fingerprint's shift of one amplitude
TOL_C64_NORM, TOL_C64_AMP = 1e-5, 1e-6   # corpus33's own bounds
# corpus_big, under big/: the branches the corpus tier takes only at
# n = 29-31, lowered by its switches (CORPUS_ENV) to sizes the phase's
# budget holds: nonstab_n26's segment streamed through a disk memmap as
# sub-programs of 2 gates, traj_short(22) through the unitary-runs branch.
BIG_N = {"nonstab": 26, "traj": 22}
BIG_METHOD = {"nonstab": "segment_restart_c128[4]_fusedtier",
              "traj": "unitary_runs_segment_restart_c128[32]_fusedtier"}


def corpus_name(key: str) -> str:
    return "qft_n33" if key == "qft33" else f"{key}_n{CORPUS_N[key]}"


def big_name(key: str) -> str:
    return f"{key}_n{BIG_N[key]}"


def c33_name() -> str:
    return f"random_n{C33_N}"


def fp_name() -> str:
    return f"qaoa_n{FP_N}"


def traj_qasm(n: int) -> str:
    """``traj_circuit(n)`` as OpenQASM 2.0 (:func:`nonunitary_qasm`)."""
    return nonunitary_qasm(traj_circuit(n))


def nonunitary_qasm(cd: dict) -> str:
    """A trajectory circuit as OpenQASM 2.0: its unitary gates as
    ``to_qasm`` writes them, and the MEASURE, RESET and conditions that
    the exporter does not write."""
    from quantum_simulations_tpu_torch.circuit.export_qasm import to_qasm

    n = cd["number_of_qubits"]
    lines = ["OPENQASM 2.0;", 'include "qelib1.inc";', f"qreg q[{n}];",
             "creg c[3];"]
    for g in cd["gates"]:
        q = g["qubits"][0]
        if g["gate"] == "MEASURE":
            lines.append(f"measure q[{q}] -> c[{g['params']['cbit']}];")
        elif g["gate"] == "RESET":
            lines.append(f"reset q[{q}];")
        else:
            one = {k: v for k, v in g.items() if k != "cond"}
            text = to_qasm({"number_of_qubits": n, "gates": [one]})
            stmt = text.splitlines()[3:]
            if "cond" in g:
                c = g["cond"]
                stmt = [f"if({c['creg']}=={c['value']}) {s}" for s in stmt]
            lines += stmt
    return "\n".join(lines) + "\n"


def traj_short(n: int) -> dict:
    """A short trajectory circuit on n >= 8 qubits: 16 unitary gates in
    four runs (6, 4, 4, 2; the unitary-runs branch samples the first
    three), MEASURE q0 -> c[0], X q(n/3) if c == 1, RESET q1, MEASURE
    q(n-1) -> c[1], Z q4 if c == 2.  Short, because the numpy oracle's
    trajectory twin spends seconds a gate on 2^28 amplitudes."""
    def gate(name, *qubits, cond=None):
        g = {"qubits": list(qubits), "gate": name, "params": {}}
        return g if cond is None else dict(g, cond={"creg": "c", "value": cond})

    def measure(q, cbit):
        return {"qubits": [q], "gate": "MEASURE",
                "params": {"creg": "c", "cbit": cbit}}

    gates = [gate("H", 0), gate("H", 1), gate("H", 2),
             gate("CNOT", 0, n - 1), gate("CNOT", 1, n // 2), gate("T", n // 2),
             measure(0, 0),
             gate("X", n // 3, cond=1), gate("H", n - 2),
             gate("CNOT", n - 2, 3), gate("S", 3),
             {"qubits": [1], "gate": "RESET"},
             gate("H", 1), gate("CNOT", 1, n - 3), gate("T", n - 3),
             gate("CNOT", 2, n - 1),
             measure(n - 1, 1),
             gate("Z", 4, cond=2), gate("H", 4)]
    return {"number_of_qubits": n, "gates": gates}


def corpus_texts() -> dict:
    """{"corpus": {name: qasm}, "extra": {name: qasm}, "big": {name: qasm}}."""
    from quantum_simulations_tpu_torch.circuit import library
    from quantum_simulations_tpu_torch.circuit.export_qasm import to_qasm

    N = CORPUS_N
    corpus = {
        "qft": to_qasm(library.qft(N["qft"])),
        "sycamore": to_qasm(library.sycamore_like(N["sycamore"], depth=4)),
        "nonstab": to_qasm(library.non_stabilizer(N["nonstab"])),
        "traj": traj_qasm(N["traj"]),
        "adder": to_qasm(library.ripple_adder(N["adder"], ADDER_A, ADDER_B)),
        "qft33": to_qasm(library.qft(N["qft33"])),
    }
    extra = {c33_name(): to_qasm(library.random_circuit(C33_N, 200, seed=C33_SEED)),
             fp_name(): to_qasm(library.qaoa_maxcut(FP_N))}
    big = {big_name("nonstab"): to_qasm(library.non_stabilizer(BIG_N["nonstab"])),
           big_name("traj"): nonunitary_qasm(traj_short(BIG_N["traj"]))}
    return {"corpus": {corpus_name(k): v for k, v in corpus.items()},
            "extra": extra, "big": big}


def adder_basis() -> int:
    """ripple_adder(n, a, b)'s output basis state by arithmetic: a on bits
    1..m, (a + b) mod 2^m on bits m+1..2m, the carry on bit 2m+1."""
    m = (CORPUS_N["adder"] - 2) // 2
    a, b = ADDER_A % (1 << m), ADDER_B % (1 << m)  # the bits the circuit sets
    return (a << 1) | (((a + b) % (1 << m)) << (m + 1)) | (((a + b) >> m) << (2 * m + 1))


def write_corpus(work: Path) -> dict:
    """The phase's corpus under ``work``; returns what the checks hold the
    rows to that the files decide: corpus33's launches and plain gate
    calls, ``spill_want`` of the segment it will pick."""
    from quantum_simulations_tpu_torch.bench.corpus import parse_one
    from quantum_simulations_tpu_torch.bench.corpus33 import _pick_segment

    for tree, files in corpus_texts().items():
        for name, text in files.items():
            d = work / tree / name
            d.mkdir(parents=True)
            (d / f"{name}.qasm").write_text(text)
    cd, _, _ = parse_one(str(work / "extra" / c33_name() / f"{c33_name()}.qasm"))
    seg, _ = _pick_segment(cd, C33_SEG, C33_M)
    want, dense = spill_want({"number_of_qubits": C33_N, "gates": seg}, C33_M)
    log(f"corpus: {sorted(os.listdir(work / 'corpus'))} under corpus/, "
        f"{sorted(os.listdir(work / 'extra'))} under extra/, "
        f"{sorted(os.listdir(work / 'big'))} under big/; corpus33's "
        f"segment {[(g['gate'], g['qubits']) for g in seg]}: launches {want}, "
        f"{dense} plain gate calls")
    return {"corpus33_want": want, "corpus33_dense": dense}


def spot_sharded(name: str) -> None:
    """Phase 11's subprocess: ``verify_one(name, spot_sharded=True)`` over
    ``QST_QASMBENCH`` (``run`` spots only the names it is given)."""
    from quantum_simulations_tpu_torch.bench.corpus import CLUSTER, verify_one

    print(json.dumps(verify_one(name, os.path.join(CLUSTER, name, f"{name}.qasm"),
                                spot_sharded=True)), flush=True)


def fingerprint_check(name: str) -> None:
    """Phase 11's subprocess: ``name``'s fingerprint built by the port's
    independent engine (``torch_simulate``, on the CPU), frozen beside the
    corpus, then ``fingerprints.verify`` (``simulate_np`` on the device,
    complex128) against it and against a copy with one top-k amplitude
    shifted by :data:`FP_SHIFT`."""
    import copy

    import numpy as np

    from quantum_simulations_tpu_torch.bench import fingerprints as F
    from quantum_simulations_tpu_torch.bench.corpus import CLUSTER, parse_one

    cd, mode, err = parse_one(os.path.join(CLUSTER, name, f"{name}.qasm"))
    assert cd is not None and mode == "unitary", (name, err)
    fp = F._fingerprint(F.torch_simulate(cd), np.random.default_rng(42))
    fp["gates"] = len(cd["gates"])
    frozen = {"engine": "torch axis-permutation statevector (complex128)",
              "tol": F.TOL, "circuits": {name: fp}}
    bad = copy.deepcopy(frozen)
    bad["circuits"][name]["topk"][0][1] += FP_SHIFT
    out = {}
    for key, doc in (("verify", frozen), ("corrupted", bad)):
        path = os.path.join(CLUSTER, f"{key}_fingerprints.json")
        with open(path, "w") as f:
            json.dump(doc, f)
        out[key] = F.verify(path)
    print(json.dumps(out), flush=True)


# corpus33 at the size it exists for, run by hand (below); the script's
# limit does not leave it: random_circuit(33, 200, seed=1), whose first
# host-bit window of 10 gates runs lane_panel and the pair kernel.
C33_FULL_N, C33_FULL_M, C33_FULL_SEG, C33_FULL_SEED = 33, 28, 10, 1


def corpus33_full() -> dict:
    """``verify_one_33`` at n = 33 on the card: 64 GiB of complex64 in
    pinned host memory, stripes of 2^28, filled twice from 512 chunk
    streams (the norm, then the stripes).  Not a phase (minutes of host
    work the 1200 s limit does not leave); run it alone:

        python -c "import chip_smoke; chip_smoke.corpus33_full()"

    Logs the card, the host's memory, the row (wall, engine and
    allocation seconds, norm_err, max_amp_err) and the launches, which
    must equal ``spill_want`` of the segment; the record goes to
    ``chiprun_out/corpus33_full.json``."""
    import shutil

    from quantum_simulations_tpu_torch.bench import corpus33
    from quantum_simulations_tpu_torch.bench.corpus import parse_one
    from quantum_simulations_tpu_torch.circuit import library
    from quantum_simulations_tpu_torch.circuit.export_qasm import to_qasm

    root = Path(__file__).resolve().parent
    work = root / "build" / "corpus33_full"
    shutil.rmtree(work, ignore_errors=True)
    name = f"random_n{C33_FULL_N}"
    (work / name).mkdir(parents=True)
    path = work / name / f"{name}.qasm"
    path.write_text(to_qasm(library.random_circuit(C33_FULL_N, 200,
                                                   seed=C33_FULL_SEED)))
    cd, _, _ = parse_one(str(path))
    seg, _ = corpus33._pick_segment(cd, C33_FULL_SEG, C33_FULL_M)
    want, dense = spill_want({"number_of_qubits": C33_FULL_N, "gates": seg},
                             C33_FULL_M)
    log(f"corpus33_full: card {card_line()}; host MemAvailable "
        f"{meminfo()['MemAvailable'] / GIB:.1f} GiB; segment "
        f"{[(g['gate'], g['qubits']) for g in seg]}: launches {want}, "
        f"{dense} plain gate calls")
    corpus33.CLUSTER = str(work)
    reset_counts()
    try:
        row = corpus33.verify_one_33(name, seg_gates=C33_FULL_SEG,
                                     stripe_qubits=C33_FULL_M)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    got = launches()
    rec = dict(card=card_line(), row=row, launches=got, want=want)
    out = root / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "corpus33_full.json").write_text(json.dumps(rec, indent=1))
    log(json.dumps(rec))
    if not (row["status"] == "verified_c64" and got == want
            and row["norm_err"] < TOL_C64_NORM and row["max_amp_err"] < TOL_C64_AMP):
        raise AssertionError(f"corpus33_full: {row}; launches {got}, want {want}")
    return rec


# The corpus tier's segment and trajectory policies at the sizes they
# exist for (bench/corpus.py: segments for 21 <= n <= 31 at the policy's
# own plan, the trajectory twin up to n = 28 and its unitary-runs branch
# above), run by hand (below): host draws and the numpy oracle take tens
# of minutes.  Each row's segment plan, by corpus._seg_plan: nonstab_n27
# and qft_n28 4 segments of 24 gates, random_n29 2 of 12, sycamore_n30
# and nonstab_n31 1 of 12 (n = 31 through the disk memmap, as sub-programs
# of 4 gates); traj_n28 the full twin of traj_short(28), both seeds;
# traj_n30 traj_circuit(30)'s unitary runs, 1 segment of 12.
FULL_PEAK_EXTRA = 2 * GIB   # a segment row's card peak: 2 states + this


def full_texts() -> dict:
    """{name: () -> qasm} of ``corpus_full``'s rows."""
    from quantum_simulations_tpu_torch.circuit import library
    from quantum_simulations_tpu_torch.circuit.export_qasm import to_qasm

    return {
        "nonstab_n27": lambda: to_qasm(library.non_stabilizer(27)),
        "qft_n28": lambda: to_qasm(library.qft(28)),
        "random_n29": lambda: to_qasm(library.random_circuit(29, 200, seed=3)),
        "sycamore_n30": lambda: to_qasm(library.sycamore_like(30, depth=4)),
        "nonstab_n31": lambda: to_qasm(library.non_stabilizer(31)),
        "traj_n28": lambda: nonunitary_qasm(traj_short(28)),
        "traj_n30": lambda: traj_qasm(30),
    }


class _RssPeak:
    """The process's peak resident set while open, sampled every 50 ms
    from /proc/self/statm."""

    def __enter__(self):
        import threading

        self.peak, self._stop = 0, threading.Event()
        self._page = os.sysconf("SC_PAGE_SIZE")
        self._sample()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def _sample(self) -> None:
        with open("/proc/self/statm") as f:
            self.peak = max(self.peak, int(f.read().split()[1]) * self._page)

    def _run(self) -> None:
        while not self._stop.wait(0.05):
            self._sample()

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self._sample()


def disk_line(path) -> dict:
    """Free space and file system of the mount that holds ``path``."""
    import shutil

    from quantum_simulations_tpu_torch.bench.corpus import _mount

    mnt, fstype = _mount(str(path))
    return {"path": str(path), "mount": mnt, "fstype": fstype,
            "free_gib": shutil.disk_usage(path).free / GIB}


def oracle_probe(n: int = 28) -> dict:
    """Seconds of the host's numpy oracle at n: one random state
    (``corpus._rand_state``), one H, one CNOT and one random 4x4 gate
    through ``apply_gate_lean`` (the trajectory twin's and the segment
    oracle's gate), and one MEASURE's P(1) and collapse (``_p1``,
    ``_collapse``)."""
    import numpy as np

    from quantum_simulations_tpu_torch.bench.corpus import _rand_state
    from quantum_simulations_tpu_torch.circuit import gates as G
    from quantum_simulations_tpu_torch.oracle import dense_numpy as oracle

    out = {"n": n}
    t0 = time.perf_counter()
    psi = _rand_state(n, 5)
    out["rand_state_s"] = time.perf_counter() - t0
    rng = np.random.default_rng(5)
    u4, _ = np.linalg.qr(rng.standard_normal((4, 4))
                         + 1j * rng.standard_normal((4, 4)))
    for key, qubits, U in (("H", [n // 2], G.gate_matrix("H", {})),
                           ("CNOT", [1, n - 1], G.gate_matrix("CNOT", {})),
                           ("U4", [2, n - 2], u4)):
        t0 = time.perf_counter()
        oracle.apply_gate_lean(psi, qubits, U)
        out[f"{key}_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    p1 = oracle._p1(psi, 0)
    psi = oracle._collapse(psi, 0, int(p1 < 0.5))
    out["measure_s"] = time.perf_counter() - t0
    del psi
    log(f"oracle_probe: {json.dumps(out)}")
    return out


def corpus_full(names=None, out_dir=None) -> dict:
    """``corpus.verify_one`` on each row of :func:`full_texts` (``names``:
    some of them, so that rows can run in separate card calls), in this
    process, on a corpus written under ``build/corpus_full`` (removed
    after) with its memmap scratch there.  Not a phase; run it alone:

        python -c "import chip_smoke; chip_smoke.corpus_full()"
        python -c "import chip_smoke; chip_smoke.corpus_full(['nonstab_n31'])"

    First :func:`oracle_probe` at n = 28.  Per row: the row, its wall
    split as the row splits it (host draws, upload, card engine,
    download, with the memmap at n = 31, oracle, comparison) and the
    rest (parsing, writing the file), the card's peak
    (``max_memory_allocated`` from a reset) and the host's peak RSS.  The record goes to ``corpus_full.json`` in
    ``out_dir`` (by default ``chiprun_out/``) after every row.  A row
    that raises is recorded with its traceback and the next one runs.
    Raises at the end if a row is not ``verified`` below 1e-10 or a
    segment row's card peak passes 2 states + 2 GiB (66 GiB at n = 31)."""
    import shutil

    import torch

    from quantum_simulations_tpu_torch.bench import corpus, setup_platform

    dev = setup_platform()
    if dev.type == "cuda":  # the allocator's statistics exist from here on
        dev = torch.device("cuda", torch.cuda.current_device())
        torch.zeros(1, device=dev)
    texts = full_texts()
    names = list(texts) if names is None else list(names)
    root = Path(__file__).resolve().parent
    work = root / "build" / "corpus_full"
    shutil.rmtree(work, ignore_errors=True)
    (work / "scratch").mkdir(parents=True)
    out = Path(out_dir) if out_dir is not None else root / "chiprun_out"
    out.mkdir(exist_ok=True)
    rec = dict(card=card_line() if dev.type == "cuda" else str(dev),
               host=dict(mem_available_gib=meminfo()["MemAvailable"] / GIB,
                         scratch=disk_line(work / "scratch"),
                         tmpdir=disk_line(os.environ.get("TMPDIR", "/tmp"))),
               rows=[])
    log(f"corpus_full: {rec['card']}; host {json.dumps(rec['host'])}")
    rec["oracle_probe"] = oracle_probe(28) if dev.type == "cuda" else None
    old_scratch = os.environ.get("QST_SCRATCH")
    os.environ["QST_SCRATCH"] = str(work / "scratch")
    try:
        for name in names:
            path = work / name / f"{name}.qasm"
            path.parent.mkdir()
            path.write_text(texts[name]())
            if dev.type == "cuda":
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            with _RssPeak() as rss:
                try:
                    row = corpus.verify_one(name, str(path))
                except Exception:  # the row fails; the rows after it still run
                    row = {"circuit": name, "status": "ERROR",
                           "error": traceback.format_exc()[-2000:]}
            wall = time.perf_counter() - t0
            split = dict(row.get("split_s", {}))
            split["rest"] = wall - sum(split.values())
            entry = dict(row=row, wall_s=wall, split_s=split,
                         host_peak_rss_gib=rss.peak / GIB,
                         card_peak_gib=(torch.cuda.max_memory_allocated(dev) / GIB
                                        if dev.type == "cuda" else None))
            if str(row.get("method", "")).endswith("fusedtier") and row.get("gates_checked"):
                entry["oracle_s_per_gate"] = split.get("oracle", 0.0) / row["gates_checked"]
            rec["rows"].append(entry)
            (out / "corpus_full.json").write_text(json.dumps(rec, indent=1))
            log(f"corpus_full {name}: {json.dumps(entry)}")
    finally:
        if old_scratch is None:
            os.environ.pop("QST_SCRATCH", None)
        else:
            os.environ["QST_SCRATCH"] = old_scratch
        shutil.rmtree(work, ignore_errors=True)
    bad = []
    for e in rec["rows"]:
        row, peak = e["row"], e["card_peak_gib"]
        n = row.get("n", 0)
        if not (row.get("status") == "verified" and row.get("max_amp_err", 1.0) < DIAG_C128):
            bad.append(row)
        elif ("segment_restart" in row["method"] and peak is not None
              and peak * GIB > 2 * (16 << n) + FULL_PEAK_EXTRA):
            bad.append(dict(row, card_peak_gib=peak))
    if bad:
        raise AssertionError(f"corpus_full: rows not verified or over 2 states "
                             f"+ {FULL_PEAK_EXTRA // GIB} GiB on the card: {bad}")
    return rec


def corpus_argv() -> dict:
    """Phase 11's subprocesses (after :data:`_GATE`), each with its own
    QST_QASMBENCH (:data:`CORPUS_ENV`)."""
    return {
        "corpus": ["-m", f"{PORT}.bench.corpus", "--tier", "all", *CORPUS_SEG],
        "corpus_sharded": ["-c", "import chip_smoke; chip_smoke.spot_sharded("
                           f"{corpus_name('sycamore')!r})"],
        "corpus33": ["-m", f"{PORT}.bench.corpus33", "--names", c33_name(),
                     "--stripe-qubits", str(C33_M), "--seg-gates", str(C33_SEG)],
        "fingerprints": ["-c", "import chip_smoke; chip_smoke.fingerprint_check("
                         f"{fp_name()!r})"],
        "corpus_big": ["-m", f"{PORT}.bench.corpus", "--tier", "all", *CORPUS_SEG],
    }


CORPUS_ENV = {"corpus": {"QST_QASMBENCH": "{work}/corpus"},
              "corpus_sharded": {"QST_QASMBENCH": "{work}/corpus"},
              "corpus33": {"QST_QASMBENCH": "{work}/extra"},
              "fingerprints": {"QST_QASMBENCH": "{work}/extra"},
              "corpus_big": {"QST_QASMBENCH": "{work}/big", "QST_SCRATCH": "{work}",
                             "QST_SEG_DISK_MIN": str(BIG_N["nonstab"]),
                             "QST_SEG_ENGINE_CHUNK": "2",
                             "QST_TRAJ_FULL_NMAX": str(BIG_N["traj"] - 2)}}
CORPUS_BUDGET_S = 75.0
PAIR_KEYS = ("pair_update", "mixed_pair", "mixed_low_pair", "midpair")


def corpus_output(out: str, err: str) -> dict:
    """Every JSON line a phase-11 subprocess printed, and its launches."""
    docs = []
    for line in out.splitlines():
        try:
            docs.append(json.loads(line))
        except json.JSONDecodeError:
            continue
    return {"json": docs, "launches": bench_launches(err)}


def _c128_ok(row: dict) -> bool:
    errs = list(row.get("tiers", {}).values()) + [row.get("max_amp_err", 0.0)]
    return all(e < DIAG_C128 for e in errs)


def check_corpus(name: str, res: dict, ref: dict) -> str:
    """Hold one phase-11 subprocess's output (:func:`corpus_output`) to its
    checks (``ref``: :func:`write_corpus`'s); returns its key numbers for
    the log line, raises AssertionError if a check fails.  A run with no
    row, or with a row that is not ``verified…`` (but the n = 33 one,
    ``skipped`` with the JAX package's reason), fails."""
    docs = res["json"]
    if not docs:
        raise AssertionError(f"{name}: printed no JSON")
    if name == "corpus":
        summary, rows = docs[-1], [d for d in docs[:-1] if "circuit" in d]
        want = {corpus_name(k): k for k in CORPUS_N}
        if (summary.get("total_files") != len(want) or summary.get("failed")
                or summary.get("checked") != len(want)
                or sorted(r["circuit"] for r in rows) != sorted(want)):
            raise AssertionError(f"corpus: {summary}, rows "
                                 f"{[r['circuit'] for r in rows]}; want {sorted(want)}")
        for r in rows:
            key = want[r["circuit"]]
            if key == "qft33":
                ok = (r["status"] == "skipped" and r.get("method") == "parse_only"
                      and r.get("reason") == CORPUS_REASON)
            else:
                ok = (r["status"] == "verified" and r.get("method") == CORPUS_METHOD[key]
                      and _c128_ok(r))
            if key in ("qft", "sycamore"):
                ok = ok and set(r["tiers"]) == {"pergate", "fused", "window"}
            if key == "traj":
                ok = ok and r["seeds"] == [0, 1] and r["boundaries"] == 4
            if key == "adder":
                ok = ok and r["nnz"] == 1 and r["basis_state"] == hex(adder_basis())
            if not ok:
                raise AssertionError(f"corpus: row {r}")
        return (f"{summary['verified']} verified, {summary['skipped']} skipped of "
                f"{summary['total_files']}; " + ", ".join(
                    f"{r['circuit']} {r.get('method')} {r.get('max_amp_err', 0):.3e} "
                    f"{r.get('wall_s')} s" for r in rows))
    if name == "corpus_big":
        summary, rows = docs[-1], [d for d in docs[:-1] if "circuit" in d]
        want = {big_name(k): BIG_METHOD[k] for k in BIG_N}
        if (summary.get("failed") or summary.get("checked") != len(want)
                or sorted(r["circuit"] for r in rows) != sorted(want)):
            raise AssertionError(f"corpus_big: {summary}, rows "
                                 f"{[r['circuit'] for r in rows]}; want {sorted(want)}")
        for r in rows:
            if not (r["status"] == "verified" and r.get("method") == want[r["circuit"]]
                    and r.get("gates_checked", 0) >= 4 and _c128_ok(r)):
                raise AssertionError(f"corpus_big: row {r}")
        return ", ".join(f"{r['circuit']} {r['method']} {r['gates_checked']} gates "
                         f"{r['max_amp_err']:.3e} {r['wall_s']} s" for r in rows)
    row = docs[-1]
    if name == "corpus_sharded":
        if not (row["status"] == "verified" and "sharded8" in row["tiers"]
                and _c128_ok(row)):
            raise AssertionError(f"corpus_sharded: {row}")
        return (f"{row['circuit']} " + ", ".join(
            f"{k} {v:.3e}" for k, v in row["tiers"].items()) + f", {row['wall_s']} s")
    if name == "corpus33":
        got = res["launches"]
        keys = {kernel_of(k) for k in got}
        if not (row["status"] == "verified_c64" and row["n"] == C33_N
                and row["stripe_qubits"] == C33_M
                and row["norm_err"] < TOL_C64_NORM and row["max_amp_err"] < TOL_C64_AMP
                and row["host_bit_qubits_in_segment"]
                and "lane_panel" in keys and keys & set(PAIR_KEYS)
                and got == ref["corpus33_want"]):
            raise AssertionError(f"corpus33: {row}; launches {got}, want "
                                 f"{ref['corpus33_want']} with lane_panel and a "
                                 f"pair kernel")
        return (f"{row['circuit']} n={row['n']} m={row['stripe_qubits']} "
                f"{row['status']}: norm_err {row['norm_err']:.3e}, lightcone "
                f"{row['max_amp_err']:.3e}, host bits "
                f"{row['host_bit_qubits_in_segment']}, {row['steps']} steps "
                f"{row['groups']} groups, engine {row['engine_s']} s (alloc "
                f"{row['alloc_s']} s), wall {row['wall_s']} s")
    if name == "fingerprints":
        good, bad = row["verify"], row["corrupted"]
        errs = [r["max_amp_err"] for r in good["rows"]]
        bad_errs = [r["max_amp_err"] for r in bad["rows"]]
        if not (good["all_ok"] and len(errs) == 1 and errs[0] < DIAG_C128
                and not bad["all_ok"] and len(bad_errs) == 1
                and bad_errs[0] > DIAG_C128):
            raise AssertionError(f"fingerprints: {row}")
        return (f"{good['rows'][0]['circuit']} {errs[0]:.3e} against its frozen "
                f"fingerprint; shifted by {FP_SHIFT:g}: {bad_errs[0]:.3e}, refused")
    raise KeyError(name)


def corpus_open(dev) -> dict:
    """Phase 11 opened (:func:`open_phase`): its corpus written, the ref its
    checks read (``"ref"``), its first subprocesses started."""
    ref: dict = {}
    opened = open_phase(dev, corpus_argv(), 11, envs=CORPUS_ENV,
                        prepare=lambda work: ref.update(write_corpus(work)))
    opened["ref"] = ref
    return opened


def corpus_tier(dev, opened=None) -> dict:
    """Phase 11: the corpus modules through :func:`bench_tier`, on a corpus
    written to the phase's work dir (``opened`` while phase 10's last
    bench ran, or here); returns the launches of its subprocesses, summed
    by key (the ``corpus tier`` path of the kernels line)."""
    opened = opened or corpus_open(dev)
    argv = corpus_argv()
    bench_tier(dev, opened["ref"], argv, CORPUS_BUDGET_S, 11, check_corpus,
               parse=corpus_output, opened=opened)
    total: dict = {}
    for name in argv:
        _add(total, RECORD["bench11"][name]["launches"])
    return {"corpus tier": total}


def kernels_line(counts: dict, rows: dict, worst: dict) -> list:
    """One record per kernel: its launches in the request that runs it
    (a panel's "+diag" and "+rotate" launches included; the requests
    that launch it, by key), its worst error in phase 2 and its phase-4
    row.  lane_panel's record holds its rotate option's row too."""
    kernels = []
    for name in KERNELS:
        r = rows[name]
        by_path = {p: {k: v for k, v in c.items() if kernel_of(k) == name}
                   for p, c in counts.items()}
        inplace = {p: sum(v for k, v in c.items() if is_inplace(k))
                   for p, c in by_path.items()
                   if p.endswith(" capacity") or p in WANT_CAPACITY33}
        rec = dict(
            name=name, route="cuda", source=SRC[name], replaces=REPLACES[name],
            launches=sum(by_path[PATH[name]].values()), path=PATH[name],
            launches_by_path={p: c for p, c in by_path.items() if c},
            inplace_launches={p: v for p, v in inplace.items() if v},
            max_abs_err=worst[name], ms=r["ms"], inplace_ms=r.get("inplace_ms"),
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"])
        if name in TC_KERNELS:  # the float32 bound of a SIMT kernel, beside
            rec["bound_simt_ms"] = r["bound_simt_ms"]
        if name == "lane_panel":
            rr = rows["lane_panel+rotate"]
            rec["rotate"] = dict(
                replaces=ROTATE_REPLACES,
                launches=by_path[PATH[name]].get("lane_panel+rotate", 0),
                **{k: rr[k] for k in ("ms", "separate_ms", "plain_ms",
                                      "bound_ms", "bound_by", "library_ms")})
        kernels.append(rec)
    RECORD["kernels"] = kernels
    return kernels


# ---------------------------------------------------------------------------

def main() -> int:
    quick = "--quick" in sys.argv[1:]
    import torch

    if not torch.cuda.is_available():
        log("FAIL: torch.cuda.is_available() is False: chip_smoke.py needs a card")
        return 2
    try:
        from quantum_simulations_tpu_torch.ops import cuda_build
        from quantum_simulations_tpu_torch.runtime.simulator import (
            panel_schedule, schedule,
        )
    except ImportError as e:
        log(f"FAIL: the port is not beside this script ({e})")
        return 2

    t_main = time.perf_counter()
    RECORD["done_at_s"] = {}

    def done(what: str) -> None:  # the script's clock at each phase's end
        RECORD["done_at_s"][what] = time.perf_counter() - t_main
        log(f"script: {what} done at {RECORD['done_at_s'][what]:.1f} s")

    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"env python={sys.version.split()[0]} torch={torch.__version__} "
        f"cuda={torch.version.cuda} devices={torch.cuda.device_count()} "
        f"name={torch.cuda.get_device_name(0)}")
    log(f"card (name, power.limit): {card}")
    RECORD.update(card=card, torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    libs = cuda_build.build_all(verbose=True)
    build_s = time.perf_counter() - t0
    log(f"build {[p.name for p in libs]} in {build_s:.1f} s")
    RECORD["build_s"] = build_s
    hmma = hmma_counts(libs)
    log(f"build tensor-core instructions (HGMMA and HMMA, cuobjdump -sass) "
        f"per instance of the dim-128 panel kernels: {hmma}")
    RECORD["hmma"] = hmma
    if len(hmma) != 7 or not all(sum(c.values()) for c in hmma.values()):
        raise AssertionError(f"the tensor-core panels are not all built with "
                             f"tensor-core instructions: {hmma}")

    scheds = {label: schedule(cd) for label, cd in circuits().items()
              if label != "hadamard_wall28"}
    with nodecomp():
        scheds["qft28 nodecomp"] = schedule(circuits()["qft28"])
    for label, paired in scheds.items():
        log(f"{label} schedule: " + ", ".join(
            type(o).__name__ + (f"@{o.pos}" if hasattr(o, "pos") else "")
            + (" +pre" if getattr(o, "pre_straddle", None) else "")
            + ("" if dt is None else f" +diag{len(dt)}") for o, dt in paired))
    for label, cd in panel_circuits().items():
        scheds[label + " panel"] = panel_schedule(cd)
        log(f"{label} panel schedule: " + ", ".join(
            pass_name(o, r) for o, r in scheds[label + " panel"][:24])
            + (" ..." if len(scheds[label + " panel"]) > 24 else ""))

    done("phase 1")
    worst = check_kernels(dev, scheds)
    done("phase 2")
    if quick:
        log("quick: build and kernel checks passed")
        return 0
    counts = main_path(dev)
    done("phase 3 main path")
    counts.update(panel_path(dev))
    done("phase 3 panel path")
    rows = times(dev, scheds)
    done("phase 4")
    bench_tier(dev, RECORD["e2e"]["nonstab28"], BENCH_ARGV, BENCH_BUDGET_S, 9,
               check_bench)
    done("phase 9")
    phase11: dict = {}  # opened while phase 10's last bench runs
    try:
        bench_tier(dev, {"ms": RECORD["e2e"]["nonstab28"]["ms"],
                         "lane_panel_ms": rows["lane_panel"]["ms"]},
                   DIAG_ARGV, DIAG_BUDGET_S, 10, check_diag,
                   then=lambda: phase11.update(corpus_open(dev)))
        done("phase 10")
        counts.update(corpus_tier(dev, phase11))
    finally:
        _stop(phase11.get("procs", {}).values())
    done("phase 11")
    counts.update(capacity33(dev))
    done("phase 5")
    counts.update(tiers(dev))
    done("phase 6")
    counts.update(spill_tier(dev))
    done("phase 7")
    counts.update(sharded_tier(dev))
    done("phase 8")
    kernels = kernels_line(counts, rows, worst)
    out = Path(__file__).resolve().parent / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(RECORD, indent=1))
    log(card_line())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:
        traceback.print_exc()
        log("FAIL: a phase failed (traceback above)")
        code = 1
    sys.exit(code)
