"""Host <-> card copy rates, the paths the spill tier streams over.

The out-of-core tier (``runtime/spill.py``) moves every stripe host ->
card and back; its rate is set by these copies.  :func:`run` times each
direction at 4, 64 and 512 MB, for float32 and complex64, from pinned
(page-locked: asynchronous DMA) and from pageable host memory (CUDA
stages the copy through its own pinned buffer), and both directions at
once from pinned memory (the spill pipeline's case: one copy stream each
way).  Each copy is checked: every element that went up or came down is
1.  A copy that raises is reported as its exception
in ``rows[...]["error"]`` and in ``failed``, and the other probes go on.

Times are host-clock medians of ``reps`` copies, each ended by
``torch.cuda.synchronize``.  On the CPU (``QST_BENCH_PLATFORM=cpu``)
both sides are host memory and nothing is pinned: a CPU number is a
memcpy rate, never a PCIe one.

Run: ``python -m quantum_simulations_tpu_torch.bench.probe_transfer``
(the JSON is the last line).
"""
from __future__ import annotations

import json
import statistics
import time

from . import describe, setup_platform

MB = 1 << 20


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _median_s(fn, reps: int, dev) -> float:
    fn()  # warm: the first copy of a size maps its pages
    _sync(dev)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def _host(count: int, dtype, pinned: bool):
    import torch

    return torch.ones(count, dtype=dtype, pin_memory=pinned)


def _ones(t, what: str) -> None:
    """The bytes arrived: every element of ``t`` is 1."""
    import torch

    x = torch.view_as_real(t) if t.is_complex() else t
    got = float(x.sum(dtype=torch.float64))
    if got != t.numel():
        raise RuntimeError(f"{what}: {t.numel()} elements sum to {got}, "
                           f"not {t.numel()}")


def _one_way(mb: int, dtype, pinned: bool, dev, reps: int) -> dict:
    import torch

    count = mb * MB // torch.empty((), dtype=dtype).element_size()
    host = _host(count, dtype, pinned)
    card = torch.empty(count, dtype=dtype, device=dev)
    nb = dict(non_blocking=pinned)
    up = _median_s(lambda: card.copy_(host, **nb), reps, dev)
    _ones(card, "host -> device")
    host.zero_()
    down = _median_s(lambda: host.copy_(card, **nb), reps, dev)
    _ones(host, "device -> host")
    nbytes = count * card.element_size()
    return {"h2d_s": up, "d2h_s": down,
            "h2d_GBs": nbytes / up / 1e9, "d2h_GBs": nbytes / down / 1e9}


def _both_ways(mb: int, dtype, dev, reps: int) -> dict:
    """Pinned host -> card on one stream while card -> pinned host runs
    on another, as the spill pipeline's copy streams do."""
    import torch

    count = mb * MB // torch.empty((), dtype=dtype).element_size()
    h_up = _host(count, dtype, dev.type == "cuda")
    h_down = _host(count, dtype, dev.type == "cuda").zero_()
    c_up = torch.empty(count, dtype=dtype, device=dev)
    c_down = torch.ones(count, dtype=dtype, device=dev)
    if dev.type == "cuda":
        s_up, s_down = torch.cuda.Stream(dev), torch.cuda.Stream(dev)

        def both():
            s_up.wait_stream(torch.cuda.current_stream(dev))
            s_down.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(s_up):
                c_up.copy_(h_up, non_blocking=True)
            with torch.cuda.stream(s_down):
                h_down.copy_(c_down, non_blocking=True)
    else:
        def both():
            c_up.copy_(h_up)
            h_down.copy_(c_down)
    dt = _median_s(both, reps, dev)
    _ones(c_up, "host -> device, both ways")
    _ones(h_down, "device -> host, both ways")
    nbytes = count * c_up.element_size()
    return {"s": dt, "each_way_GBs": nbytes / dt / 1e9,
            "total_GBs": 2 * nbytes / dt / 1e9}


def run(sizes_mb=(4, 64, 512), reps: int = 5) -> dict:
    """Every probe's rates (GB/s = 1e9 bytes/s) by dtype, size and host
    memory, then both directions at once from pinned memory."""
    import torch

    dev = setup_platform()
    if dev.type == "cuda":
        torch.ones(1, device=dev).sum().item()  # the context, outside the timing
    mems = ("pinned", "pageable") if dev.type == "cuda" else ("pageable",)
    rows, both, failed = [], [], []
    for dtype in (torch.float32, torch.complex64):
        name = str(dtype).removeprefix("torch.")
        for mb in sizes_mb:
            for mem in mems:
                row = {"dtype": name, "MB": mb, "memory": mem}
                try:
                    row.update(_one_way(mb, dtype, mem == "pinned", dev, reps))
                except RuntimeError as e:  # reported, as a failed copy is
                    row["error"] = f"{type(e).__name__}: {str(e)[:200]}"
                    failed.append(row)
                rows.append(row)
            row = {"dtype": name, "MB": mb, "memory": mems[0]}
            try:
                row.update(_both_ways(mb, dtype, dev, reps))
            except RuntimeError as e:
                row["error"] = f"{type(e).__name__}: {str(e)[:200]}"
                failed.append(row)
            both.append(row)
    return {"device": describe(dev), "reps": reps, "rows": rows,
            "both_ways": both, "failed": failed}


def main() -> None:
    print(json.dumps(run()))


if __name__ == "__main__":
    main()
