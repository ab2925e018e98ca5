"""The per-layer metrics that read the port's own spans (``qst.*``) and
counters, on a traced window at n = 10 on the CPU through ``run_cell``:
each reads what its request kind predicts, under the names the cell
gives it, and a system without the spans or counters gives no reading."""
import copy
import math
import time

import pytest
import torch

from gpubench import program
from gpubench import run as R
from gpubench import stream as st
from gpubench.systems import Control

SPEC = R.load_json(R.ROOT / "BENCHMARK.json")
READERS = ("contract_ms_per_request", "compile_ms_per_request",
           "schedule_cache_hit_pct", "readout_passes_per_request")
SEED = 2 ** 31 + 1234


def traced(workload, n=10, system=None):
    """The cell at ``n`` qubits, every reader above added to what it
    reports, run traced for 0.3 s in a process whose schedule cache is
    empty, as a run's is: (cell, result)."""
    from quantum_simulations_tpu_torch.runtime import simulator

    simulator._COMPILE_CACHE.clear()
    cell = copy.deepcopy(R.load_cell(SPEC, workload))
    cell.config["params"]["n"] = n
    if "edges" in cell.config:
        cell.config["edges"]["params"]["n"] = n
    if "reference" in cell.config:
        cell.config["reference"]["cut"] = n // 2
    own = {m["name"].split(".")[0] for m in cell.per_layer}
    cell.per_layer += [{"name": r, "unit": "x"} for r in READERS
                       if r not in own]
    return cell, R.run_cell(cell, SEED, 0.3, True, "cpu", system=system,
                            t_start=time.perf_counter())


def values(res):
    return {k.split(".")[0]: m["value"] for k, m in res["metrics"].items()}


def edges(cell):
    return len(st.edges(cell.config))


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_each_cell_reports_its_program_metrics(workload):
    cell, res = traced(workload)
    assert res["correct"] is True and res["failed"] == 0
    names = set(res["metrics"])
    new_circuit = cell.traffic["new_instance"]
    if new_circuit:
        assert {"contract_ms_per_request.new_circuit",
                "compile_ms_per_request.new_circuit",
                "readout_passes_per_request.new_circuit"} <= names
    else:
        assert {"contract_ms_per_request", "schedule_cache_hit_pct",
                "readout_passes_per_request"} <= names
    v = values(res)
    assert v["contract_ms_per_request"] > 0
    kind = cell.traffic["kind"]
    passes = {"expectation_z": 1, "sample": 1,
              "maxcut_energy": math.ceil(edges(cell) / 128)}[kind]
    assert v["readout_passes_per_request"] == passes
    if new_circuit:
        # every request is a new circuit: one lookup, one miss, a compile
        assert v["schedule_cache_hit_pct"] == 0
        assert v["compile_ms_per_request"] > 0
    else:
        # the warm request compiled the one circuit; the window only hits
        assert v["schedule_cache_hit_pct"] == 100
        assert v["compile_ms_per_request"] == 0


def test_energy_reads_one_pass_an_edge():
    """Every edge's <Z_i Z_j> in one readout pass of up to 128 Z-strings
    (``sampling.zstring_sums``): ceil(edges / 128) passes, not one an edge."""
    cell, res = traced("qaoa28.energy.window", n=9)
    assert edges(cell) > 1
    assert values(res)["readout_passes_per_request"] == math.ceil(
        edges(cell) / 128) == 1


def test_no_spans_and_no_counters_give_no_reading():
    """The control calls none of the port: no ``qst.*`` span in the trace
    and no counter moves, so the span and hit-share readers give nothing
    and the run does not fail."""
    _, res = traced("nonstab28.zsweep.window",
                    system=Control(torch.device("cpu")))
    names = {k.split(".")[0] for k in res["metrics"]}
    assert not names & {"contract_ms_per_request", "compile_ms_per_request",
                        "schedule_cache_hit_pct"}


def test_present_leaves_out_what_the_port_lacks():
    specs = ["ops.sampling:READOUT_PASSES", "ops.sampling:NO_SUCH_COUNTER",
             "no_such_module:X", "runtime.simulator:SCHEDULE_CACHE_HITS"]
    assert program.present(specs) == [specs[0], specs[3]]


class _Trace:
    t0, t1 = 100.0, 200.0

    def __init__(self, rows):
        rows = sorted(rows)
        self._spans = ([r[0] for r in rows], rows)


class _Run:
    def __init__(self, rows, requests=2):
        self.trace = _Trace(rows)
        self.requests = requests


def test_nested_spans_count_once_and_clip_to_the_window():
    rows = [(90.0, 110.0, "qst.contract.validate"),      # clipped to 100-110
            (120.0, 140.0, "qst.contract.hash"),
            (125.0, 130.0, "qst.contract.validate"),     # inside the hash
            (150.0, 160.0, "qst.compile"),
            (195.0, 230.0, "qst.contract.validate"),     # clipped to 195-200
            (250.0, 260.0, "qst.contract.validate")]     # after the window
    run = _Run(rows)
    contract = lambda name: name.startswith("qst.contract.")  # noqa: E731
    assert program.intervals(run, contract) == [[100.0, 110.0],
                                                 [120.0, 140.0],
                                                 [195.0, 200.0]]
    assert program.ms_per_request(run, contract) == pytest.approx(35e-3 / 2)
    assert program.ms_per_request(_Run([(120.0, 130.0, "gpubench.run")]),
                                  contract) is None
