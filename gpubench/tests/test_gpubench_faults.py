"""The check must find a broken timed path wrong.

Each cell is run on the CPU at n = 10 (the port's plain twins) with one
of ``faults.FAULTS`` planted underneath, or with the control (the
reference with TF32 products in the port's place; the cut reference's
TF32 halves for a configuration held to it), and ``correct`` has to
come out false.  Unbroken, each run is correct.
"""
import copy
import time

import pytest
import torch

from gpubench import run as R
from gpubench.faults import FAULTS
from gpubench.systems import Control

SPEC = R.load_json(R.ROOT / "BENCHMARK.json")
WORKLOADS = [w["name"] for w in SPEC["workloads"]]


# The first Z-string of this seed (qubits 0, 1, 3, 6) is one that a readout
# over half of the amplitudes moves at n = 10, so that fault shows however
# few requests a loaded CPU completes in the window.
SEED = 2 ** 31 + 7


def small(workload, n=10):
    """The cell at ``n`` qubits; a cut reference cut in the middle."""
    cell = copy.deepcopy(R.load_cell(SPEC, workload))
    cell.config["params"]["n"] = n
    if "edges" in cell.config:
        cell.config["edges"]["params"]["n"] = n
    if "reference" in cell.config:
        cell.config["reference"]["cut"] = n // 2
    return cell


def run_small(workload, seed=SEED, seconds=0.3, n=10, system=None):
    cell = small(workload, n)
    return R.run_cell(cell, seed, seconds, False, "cpu", system=system,
                      t_start=time.perf_counter())


@pytest.mark.parametrize("workload", WORKLOADS)
def test_unbroken_runs_are_correct(workload):
    res = run_small(workload)
    assert res["correct"] is True, res["checks"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_fault_is_not_correct(workload, fault):
    with FAULTS[fault]():
        res = run_small(workload)
    assert res["correct"] is False, (fault, res["checks"])


@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_control_is_not_correct(workload):
    control = Control(torch.device("cpu"), small(workload).config)
    res = run_small(workload, seconds=0.5, system=control)
    assert res["attempted"] > 0 and res["failed"] == 0
    assert res["correct"] is False, res["checks"]
    assert res["checks"]["state_err"]["value"] > res["checks"]["state_err"]["limit"]
