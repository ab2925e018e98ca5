"""Run one cell of ``BENCHMARK.json`` once and print one JSON line.

    python3 -m gpubench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up: torch and the CUDA context, the port's kernels (built into the
checkout's ``build/torch_kernels/`` the first time, loaded after), one
warm request of the cell's own traffic.  Then one client runs a closed
loop for ``--seconds``: a request is sent when the last has returned,
and the window ends when the request under way at the deadline has.
``--trace 1`` runs the window under ``torch.profiler`` and reports the
cell's per-layer metrics, ``--trace 0`` its end-to-end metrics: each
metric is read from the run's record (:class:`Run`) by its reader,
``metrics/<name>.py``.  After
the window the reference checks what the requests returned
(``check.py``).  Without a card the run fails; it never falls back to
the CPU.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "quantum_simulations_tpu")


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""
    name: str
    chips: int
    config: dict
    traffic: dict
    check: dict
    end_to_end: list
    per_layer: list


def _mine(metrics: list, name: str) -> list:
    return [m for m in metrics if name in m.get("workloads", [name])]


def load_cell(spec: dict, workload: str, root: Path = ROOT) -> Cell:
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    return Cell(
        name=workload, chips=int(w["chips"]),
        config=load_json(root / conf["file"]),
        traffic=load_json(HERE / "traffic" / f"{w['traffic']}.json"),
        check=load_json(HERE / "checks" / f"{workload}.json"),
        end_to_end=_mine(spec["end_to_end"], workload),
        per_layer=_mine(spec["per_layer"], workload))


def metric_file(name: str) -> Path:
    """``metrics/<name>.py``; a metric split by cells, ``<base>.<cells>``,
    without a file of its own is read by its base's."""
    parts = name.split(".")
    for k in range(len(parts), 0, -1):
        path = HERE / "metrics" / (".".join(parts[:k]) + ".py")
        if path.is_file():
            return path
    raise FileNotFoundError(f"no reader for metric {name!r} in {HERE / 'metrics'}")


def reader(name: str):
    """The reader module of a metric: its ``read(run)`` and the port's
    counters it reads (``COUNTERS``, specs ``"<module>:<NAME>"``)."""
    path = metric_file(name)
    mod_spec = importlib.util.spec_from_file_location(
        "gpubench_metric_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Run:
    """What one run recorded, for the metric readers."""
    n: int
    config: dict
    traffic: dict
    records: list
    done: list
    window_s: float
    setup_s: float
    memory_peak_bytes: int
    counters: dict
    trace: object = None

    @property
    def requests(self) -> int:
        """Requests completed in the window."""
        return len(self.done)

    @property
    def readout_s(self) -> list:
        """Each completed request's readout seconds, where traced."""
        return [r.readout_s for r in self.done if r.readout_s is not None]


def _no_span(name: str):
    return contextlib.nullcontext()


@dataclasses.dataclass
class Record:
    request: object
    answer: object
    seconds: float
    readout_s: float | None


def window(system, stream, cfg, seconds: float, capture, traced: bool):
    """The closed loop: (records, failed, window seconds)."""
    from .trace import span

    records, failed = [], 0
    spanning = span if traced else _no_span
    t0 = time.perf_counter()
    deadline = t0 + seconds
    with capture, spanning("gpubench.window"):
        while time.perf_counter() < deadline:
            req = stream.next()
            capture.clear()
            t1 = time.perf_counter()
            try:
                with spanning("gpubench.request"):
                    answer = system.answer(stream.kind, req, cfg, spanning)
            except Exception:  # a failed request is counted, and reported
                if not failed:
                    traceback.print_exc()
                failed += 1
                answer = None
            t2 = time.perf_counter()
            ready = capture.ready_at if traced else None
            records.append(Record(req, answer, t2 - t1,
                                  None if ready is None else t2 - ready))
    return records, failed, time.perf_counter() - t0


def card_info() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             system=None, t_start: float = None) -> dict:
    """Set up, run the window and check it; the result's dict.  The card
    check is the caller's (``main``): tests run this on the CPU."""
    import torch

    from . import check
    from . import stream as st
    from .systems import Capture, Port
    from .trace import profiled

    t_start = T_START if t_start is None else t_start
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    t = time.perf_counter()
    if cuda:
        torch.cuda.init()
        torch.zeros(1, device=dev)
        torch.cuda.synchronize()
    log(f"setup torch_and_context_s {time.perf_counter() - t_start:.3f}")
    t = time.perf_counter()
    system = system or Port(dev)
    system.prepare()
    log(f"setup kernels_s {time.perf_counter() - t:.3f}")

    config, traffic = cell.config, cell.traffic
    n = config["params"]["n"]
    cfg = system.config(traffic.get("simulator", {}))
    t = time.perf_counter()
    warm = st.Stream.warm(config, traffic, seed)
    with Capture(system, traced=False):
        system.answer(warm.kind, warm.next(), cfg, _no_span)
    if cuda:
        torch.cuda.synchronize()
    log(f"setup warm_request_s {time.perf_counter() - t:.3f}")
    setup_s = time.perf_counter() - t_start
    log(f"setup setup_s {setup_s:.3f}")

    stream = st.Stream(config, traffic, seed)
    capture = Capture(system, traced=trace)
    readers = {m["name"]: reader(m["name"])
               for m in (cell.per_layer if trace else cell.end_to_end)}
    specs = sorted({c for r in readers.values()
                    for c in getattr(r, "COUNTERS", ())})
    before = {c: system.counter(c) for c in specs}
    prof: dict = {}
    with profiled(dev, prof) if trace else contextlib.nullcontext():
        records, failed, window_s = window(system, stream, cfg, seconds,
                                           capture, trace)
    counters = {c: system.counter(c) - before[c] for c in specs}
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    done = [r for r in records if r.answer is not None]
    log(f"window requests {len(records)} failed {failed} s {window_s:.3f}")

    t = time.perf_counter()
    state = capture.state
    capture.clear()
    if cuda:
        torch.cuda.empty_cache()
    numbers = check.compare(stream.kind, records, state, config, traffic,
                            cell.check, seed, dev)
    del state
    correct, rows = check.verdict(numbers, cell.check["limits"],
                                  len(records), failed)
    log(f"check_s {time.perf_counter() - t:.3f}")

    record = Run(n=n, config=config, traffic=traffic, records=records,
                 done=done, window_s=window_s, setup_s=setup_s,
                 memory_peak_bytes=int(peak), counters=counters,
                 trace=prof.get("trace"))
    metrics: dict = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = readers[m["name"]].read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    device_info = {
        "platform": "gpu" if cuda else dev.type,
        "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
        "count": 1,
        "memory_peak_bytes": int(peak),
    }
    result = {"correct": bool(correct), "attempted": len(records),
              "failed": failed, "metrics": metrics, "device": device_info}
    if trace:
        tr = prof["trace"]
        device_info["busy_s"] = tr.busy_s
        device_info["window_s"] = tr.window_s
        result["breakdown"] = tr.breakdown()
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    return result


def set_environment() -> None:
    """Before the port is imported: the kernels' build directory at its
    fixed place in the checkout."""
    os.environ["QST_TORCH_BUILD_DIR"] = str(ROOT / "build" / "torch_kernels")


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    spec = load_json(ROOT / "BENCHMARK.json")
    cell = load_cell(spec, args.workload)
    seconds = spec["run_seconds"] if args.seconds is None else args.seconds
    set_environment()

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"gpubench: the cell needs {cell.chips} CUDA card(s); "
            f"torch.cuda.is_available() = {torch.cuda.is_available()}")
        return 2
    result = run_cell(cell, args.seed, seconds, bool(args.trace), "cuda:0")
    log(f"card {card_info()}")
    bad = forbidden_modules()
    if bad:
        log(f"gpubench: the process loaded {bad}")
        return 3
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
