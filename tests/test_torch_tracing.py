"""The port's spans and counters (``utils/timing.py``): off without a
profiler, ``user_annotation`` events nested by layer under one, the
schedule-cache and readout-pass counters, and the runner's timers."""
import contextlib
import json

import pytest
import torch

from quantum_simulations_tpu_torch import SimulatorConfig, api, library
from quantum_simulations_tpu_torch.ops import observables, sampling
from quantum_simulations_tpu_torch.runtime import runner, simulator
from quantum_simulations_tpu_torch.utils import timing

CPU = "cpu"
WINDOW = SimulatorConfig(mode="window")


def annotations(fn, tmp_path):
    """``fn()`` under ``torch.profiler``: its result and the trace's
    user annotations as ``(name, start, end)``."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    rows = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in events if e.get("cat") == "user_annotation"]
    return out, rows


def named(rows, name):
    return [r for r in rows if r[0] == name]


def inside(rows, child, parent) -> bool:
    """Every ``child`` span lies within some ``parent`` span."""
    parents = named(rows, parent)
    return bool(named(rows, child)) and all(
        any(pa <= a and b <= pb for _, pa, pb in parents)
        for _, a, b in named(rows, child))


def fresh(n=8, seed=0):
    """A circuit no other test compiled."""
    return library.non_stabilizer(n, depth=2, seed=1000 + seed)


def test_span_without_a_profiler_is_the_shared_null_context():
    assert not torch.autograd._profiler_enabled()
    timing.reset()
    a, b = timing.span("qst.a"), timing.span("qst.b")
    assert a is b and isinstance(a, contextlib.nullcontext)
    with a:
        pass
    api.expectation_z(fresh(seed=1), [0], WINDOW, device=CPU)
    assert timing.snapshot() == {"timers_s": {}, "counts": {}}


def test_expectation_z_spans_nest_by_layer(tmp_path):
    timing.reset()
    cd = fresh(seed=2)
    want = api.expectation_z(cd, [0, 3], WINDOW, device=CPU)
    simulator._COMPILE_CACHE.clear()
    got, rows = annotations(
        lambda: api.expectation_z(cd, [0, 3], WINDOW, device=CPU), tmp_path)
    assert got == pytest.approx(want, abs=1e-6)
    for child, parent in [("qst.api.run", "qst.api.expectation_z"),
                          ("qst.simulate", "qst.api.run"),
                          ("qst.compile", "qst.simulate"),
                          ("qst.compile.schedule", "qst.compile"),
                          ("qst.compile.prepare", "qst.compile"),
                          ("qst.passes", "qst.simulate"),
                          ("qst.from_planar", "qst.simulate"),
                          ("qst.contract.hash", "qst.simulate"),
                          ("qst.readout.expectation_z",
                           "qst.api.expectation_z")]:
        assert inside(rows, child, parent), (child, parent, rows)
    assert len(named(rows, "qst.readout.expectation_z")) == 1
    assert not inside(rows, "qst.readout.expectation_z", "qst.api.run")
    # api.run, simulator.simulate, build_window_circuit_fn and the
    # window schedule's compile each validate the circuit
    assert len(named(rows, "qst.contract.validate")) == 4
    snap = timing.snapshot()
    assert snap["counts"]["qst.compile.calls"] == 1
    assert snap["timers_s"]["qst.api.expectation_z"] >= snap["timers_s"][
        "qst.api.run"] > 0


def test_the_schedule_cache_counts_hits_and_misses(tmp_path):
    cd = fresh(seed=3)
    api.expectation_z(cd, [1], WINDOW, device=CPU)
    h, m = simulator.SCHEDULE_CACHE_HITS, simulator.SCHEDULE_CACHE_MISSES
    _, rows = annotations(
        lambda: api.expectation_z(cd, [1], WINDOW, device=CPU), tmp_path)
    assert not named(rows, "qst.compile") and named(rows, "qst.passes")
    assert (simulator.SCHEDULE_CACHE_HITS - h,
            simulator.SCHEDULE_CACHE_MISSES - m) == (1, 0)
    api.expectation_z(fresh(seed=4), [1], WINDOW, device=CPU)
    assert (simulator.SCHEDULE_CACHE_HITS - h,
            simulator.SCHEDULE_CACHE_MISSES - m) == (1, 1)


@pytest.mark.parametrize("mode", ["fused", "panel", "window"])
def test_every_builder_counts_its_lookup(mode):
    cd = fresh(seed=5)
    cfg = SimulatorConfig(mode=mode)
    simulator.reset_counts()
    api.simulate(cd, cfg, device=CPU)
    api.simulate(cd, cfg, device=CPU)
    assert (simulator.SCHEDULE_CACHE_HITS,
            simulator.SCHEDULE_CACHE_MISSES) == (1, 1)


def test_readout_passes():
    psi = api.run(fresh(seed=6), WINDOW, device=CPU)
    edges = [(0, 1), (1, 2), (2, 5), (4, 7), (3, 6)]
    sampling.reset_counts()
    sampling.expectation_z(psi, [0, 2])
    assert sampling.READOUT_PASSES == 1
    observables.maxcut_energy(psi, edges)
    assert sampling.READOUT_PASSES == 1 + len(edges)
    sampling.reset_counts()
    api.sample(fresh(seed=6), 64, seed=3, config=WINDOW, device=CPU)
    assert sampling.READOUT_PASSES == 1
    sampling.reset_counts()
    api.expectation_z(fresh(seed=6), [1], WINDOW, device=CPU)
    assert sampling.READOUT_PASSES == 1


def test_maxcut_energy_and_sample_spans(tmp_path):
    psi = api.run(fresh(seed=7), WINDOW, device=CPU)
    edges = [(0, 1), (2, 3), (4, 5)]
    _, rows = annotations(lambda: observables.maxcut_energy(psi, edges),
                          tmp_path)
    # one span for the whole energy: its edges' passes open none, so a
    # trace's idle gaps between them fall inside it
    assert len(named(rows, "qst.readout.maxcut_energy")) == 1
    assert not named(rows, "qst.readout.expectation_z")
    _, rows = annotations(lambda: api.sample(fresh(seed=7), 32, seed=1,
                                             config=WINDOW, device=CPU),
                          tmp_path)
    assert inside(rows, "qst.api.run", "qst.api.sample")
    assert inside(rows, "qst.readout.sample", "qst.api.sample")
    assert not inside(rows, "qst.readout.sample", "qst.api.run")


def test_timer_accumulates_and_annotates_under_a_profiler(tmp_path):
    def step():
        with timing.timer("runner.step"):
            pass

    timing.reset()
    step()
    _, rows = annotations(step, tmp_path)
    assert timing.snapshot()["counts"]["runner.step.calls"] == 2
    assert named(rows, "runner.step")


def test_runner_timers_accumulate_without_a_profiler(tmp_path):
    timing.reset()
    runner.run(fresh(seed=8), tmp_path / "wd", checkpoint_every=1,
               device=CPU)
    snap = timing.snapshot()
    for name in ("runner.compile", "runner.step", "runner.checkpoint"):
        assert snap["counts"][f"{name}.calls"] >= 1
        assert snap["timers_s"][name] >= 0
    assert not [k for k in snap["timers_s"] if k.startswith("qst.")]
