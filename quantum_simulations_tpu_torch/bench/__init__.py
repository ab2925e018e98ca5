"""Benchmark suite of the port (the JAX package's ``bench/``).

* :mod:`kernel_bw`        — GB/s by op class against the card's byte rate
* :mod:`e2e`              — end-to-end circuit throughput across families
* :mod:`sweep`            — execution-knob sweep on one workload
* :mod:`suite`            — correctness + wall time over the circuit library
* :mod:`spill_bw`         — out-of-core stripe streaming throughput
* :mod:`c128_diff`        — complex128 differential against the numpy oracle
* :mod:`passes`           — the window schedule's per-pass table against the bound
* :mod:`sharded`          — one shard's compute and the exchange bytes
* :mod:`baseline_configs` — the five BASELINE.md configurations end to end
* :mod:`capacity`         — n = 30 in place
* :mod:`matrix`           — every family through every tier at 1e-10
* :mod:`projection`       — 34 qubits on 16 positions, projected
* :mod:`headline`         — nonstab28 window mode, one JSON line

The diagnostics (run as modules, as in the JAX package; the CLI's
``bench`` keeps its nine choices), which say where an end-to-end time
goes:

* :mod:`opprof`           — time per op class of a real window schedule,
  and the straddler policies raced
* :mod:`overhead`         — the cost of a pass beyond its kernel, the fixed
  cost of a chain, the WAL runner's durability tax, the diag variants
* :mod:`probe_transfer`   — host <-> card copy rates, pinned and pageable
* :mod:`capacity`         — ``sample_run``: 1e6 shots on the card at n = 30
* :mod:`spill_bw`         — ``overlap``, ``slice_run`` (qft40 extrapolated),
  ``real_chip`` (f32 stripes), ``real_chip_ghz`` (n = 31 in host memory)
* :mod:`sharded`          — ``run`` (n = 30 on 8 positions), ``run16`` (the
  five-tier dry run and the n = 14 pod program on 16 positions)

The corpus tier (run as modules; the corpus is QASMBench's ``cluster/``
tree, named by ``QST_QASMBENCH``, with HiSVSIM's partition files):

* :mod:`corpus`           — every circuit of the corpus verified against the
  numpy oracle under its size's policy (complex128, 1e-10)
* :mod:`corpus33`         — n = 33 segments at complex64 through the spill
  tier, held to their exact lightcone amplitudes
* :mod:`fingerprints`     — the card's state against amplitudes frozen by an
  independent torch engine
* :mod:`hisvsim_parts`    — the staging scheduler against HiSVSIM's
  partitions (host planning only)

Every bench measures the card (``cuda:0``).  ``QST_BENCH_PLATFORM=cpu``
runs it on the CPU instead, where the kernels' plain twins run: the tests
do so, and a CPU number is never a card number.  Without a card and
without that variable :func:`setup_platform` raises.

This module also keeps the one account of the card's peaks, used by the
benches and by ``chip_smoke.py``.
"""
from __future__ import annotations

import os
import statistics
import subprocess
import time

import torch

# NVIDIA H100 SXM data sheet (dense rates, 700 W).
HBM_BYTES_PER_S = 3.35e12      # HBM3
FP32_FLOP_PER_S = 67e12        # float32 outside the tensor cores
TF32_FLOP_PER_S = 495e12       # TF32 on the tensor cores, dense
# NVLink 4, each way, per card (data sheet, not measured: the machine has
# one card, so no byte has crossed a link).
NVLINK_BYTES_PER_S = 450e9


def setup_platform() -> torch.device:
    """The device the benches measure: the card, or the CPU under
    ``QST_BENCH_PLATFORM=cpu``.  Raises when there is no card and the CPU
    was not asked for: a bench never falls back."""
    plat = os.environ.get("QST_BENCH_PLATFORM", "")
    if plat == "cpu":
        return torch.device("cpu")
    if plat not in ("", "cuda", "gpu"):
        raise ValueError(f"QST_BENCH_PLATFORM={plat!r}: 'cpu', or unset for "
                         f"the card")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: the benches measure the card; "
                           "QST_BENCH_PLATFORM=cpu runs them on the CPU "
                           "(the kernels' plain twins)")
    return torch.device("cuda", 0)


def describe(dev: torch.device) -> str:
    """The device as results name it: the card's name and power limit as
    ``nvidia-smi`` prints them, or ``cpu``."""
    if dev.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[dev.index or 0]


def force(*x) -> float:
    """sum |psi|^2 of a complex tensor or of (re, im) planes, fetched to
    the host: the fetch waits for the device, so it is the barrier.  It
    sums in float64 over chunks of 2^24 values, so it holds 128 MiB
    beside the state at most (a capacity run's peak counts it)."""
    if len(x) == 1 and x[0].is_complex():
        x = (torch.view_as_real(x[0]),)
    acc = torch.zeros((), dtype=torch.float64, device=x[0].device)
    for p in x:
        for c in p.reshape(-1).split(1 << 24):
            c = c.double()
            acc += torch.dot(c, c)
    return float(acc)


def warm_grant(dev: torch.device) -> float:
    """The card's context and the port's kernels built (``nvcc`` at first
    use, cached under ``build/torch_kernels``); seconds.  Nothing on the
    CPU."""
    t0 = time.perf_counter()
    if dev.type == "cuda":
        from ..ops import cuda_build

        torch.ones(128, 128, device=dev).sum().item()
        cuda_build.build_all()
    return time.perf_counter() - t0


def timeit(fn, reps: int = 5) -> float:
    """Median-of-reps wall time of fn() (fn must force internally)."""
    fn()  # warm
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def device_s(fn, iters: int, reps: int, dev: torch.device) -> float:
    """Seconds of one call of ``fn``: the median over ``reps`` of a run of
    ``iters`` calls, after one warm call; on the card by CUDA events around
    the run, on the CPU by the host clock."""
    fn()
    ts = []
    for _ in range(reps):
        if dev.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(iters):
                fn()
            b.record()
            b.synchronize()
            ts.append(a.elapsed_time(b) * 1e-3 / iters)
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            ts.append((time.perf_counter() - t0) / iters)
    return statistics.median(ts)


def straddle_flop(s) -> int:
    """flop per amplitude of a (6, qb) straddler by the reference's term
    plan: a select (CNOT) only moves data; a unit / real / complex term
    costs 2 / 4 / 8 (a general complex U: 32)."""
    import numpy as np

    from ..ops import panel_kernels as pk

    kinds = pk._straddle_plan(s.qb, s.U, np.float32)[2][2]
    return sum({"select": 0, "unit": 2, "real": 4, "complex": 8}[k]
               for k in kinds)


def work(N: int, dims: list[int], straddles=(), diag=None, tc=False):
    """(bytes, seconds of operations) of the work a pass needs.  Bytes: both
    planes read and written once, each W and straddler U read once, a
    diag run's packed operand read once.  Operations: a complex
    contraction of width dim costs 6 * dim flop per amplitude by Gauss's
    three real products (the reference's default, ``_cmul_planes`` in
    pallas_kernels.py), plus 4 adds, at the float32 rate; with ``tc`` (the
    tensor-core panels, split TF32) each of the three real products takes
    three TF32 products, 18 * dim flop per amplitude at the TF32 rate; a
    straddler costs :func:`straddle_flop`; a diag run's rotation 6
    per amplitude (its angle sums are integer adds and its cos / sin one
    sincos, not counted); a bit permutation none."""
    nbytes = (4 * N * 4 + sum(2 * d * d * 4 for d in dims)
              + 32 * 4 * len(straddles)
              + (0 if diag is None else 4 * diag.words.size))
    fp32 = N * (sum(straddle_flop(s) for s in straddles)
                + (0 if diag is None else 6))
    if tc:
        t_f = (fp32 / FP32_FLOP_PER_S
               + N * sum(18 * d for d in dims) / TF32_FLOP_PER_S)
    else:
        t_f = (fp32 + N * sum(6 * d + 4 for d in dims)) / FP32_FLOP_PER_S
    return nbytes, t_f


def bound(N: int, dims: list[int], straddles=(), diag=None, tc=False):
    """(bound_ms, bound_by) of the work the function needs (:func:`work`):
    the larger of its bytes at the card's byte rate and its operations at
    the rate of their type."""
    nbytes, t_f = work(N, dims, straddles, diag, tc)
    t_b = nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")
