"""The harness on the CPU at small n: the last line's keys, discovery of
files a later change adds, the card check, and the module scan."""
import ast
import copy
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

from gpubench import run as R
from gpubench import stream as st

HERE = Path(__file__).resolve().parent.parent
ROOT = HERE.parent
SPEC = R.load_json(ROOT / "BENCHMARK.json")
WORKLOADS = [w["name"] for w in SPEC["workloads"]]
FORBIDDEN = {"jax", "jaxlib", "flax", "quantum_simulations_tpu"}


def small(cell, n=10):
    cell = copy.deepcopy(cell)
    cell.config["params"]["n"] = n
    if "edges" in cell.config:
        cell.config["edges"]["params"]["n"] = n
    if "reference" in cell.config:
        cell.config["reference"]["cut"] = n // 2
    return cell


def run_small(workload, trace, seed=2 ** 31 + 99, seconds=0.3, **kw):
    cell = small(R.load_cell(SPEC, workload))
    return cell, R.run_cell(cell, seed, seconds, trace, "cpu",
                            t_start=time.perf_counter(), **kw)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_result_line_keys(workload, trace):
    cell, res = run_small(workload, trace)
    keys = list(res)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks"
    assert ("breakdown" in res) == trace
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    names = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    assert set(res["metrics"]) <= names
    if not trace:
        assert set(res["metrics"]) == names
        assert "setup_s" in names and len(names) >= 2
    else:
        base = {name.split(".")[0] for name in res["metrics"]}
        assert "passes_per_request" in base
        if any(m["name"].startswith("readout_ms_per_request")
               for m in cell.per_layer):
            assert "readout_ms_per_request" in base
        assert set(res["device"]) >= {"busy_s", "window_s"}
        bd = res["breakdown"]
        assert set(bd) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in bd.values())
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] == m["value"]
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(res)


def test_every_cell_reports_its_metrics():
    for w in SPEC["workloads"]:
        cell = R.load_cell(SPEC, w["name"])
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in e2e
        for m in cell.per_layer + cell.end_to_end:
            assert R.metric_file(m["name"]).parent == HERE / "metrics"
            assert callable(R.reader(m["name"]).read)
        kind = st.Stream(cell.config, cell.traffic, 1).kind
        assert set(cell.check["limits"]) == {"state_err", kind.NUMBER}


def test_a_split_metric_is_read_by_its_base(tmp_path, monkeypatch):
    (tmp_path / "metrics").mkdir()
    for stem in ("a_b", "a_b.c"):
        (tmp_path / "metrics" / f"{stem}.py").write_text(f"NAME = {stem!r}\n")
    monkeypatch.setattr(R, "HERE", tmp_path)
    assert R.reader("a_b.x").NAME == "a_b"
    assert R.reader("a_b.x.y").NAME == "a_b"
    assert R.reader("a_b.c").NAME == "a_b.c"
    assert R.reader("a_b.c.d").NAME == "a_b.c"
    with pytest.raises(FileNotFoundError):
        R.metric_file("nothing.x")


def test_main_without_a_card_fails_and_prints_nothing(capsys, monkeypatch):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: main would run the cell")
    monkeypatch.setenv("QST_TORCH_BUILD_DIR", "unset")
    rc = R.main(["--workload", WORKLOADS[0], "--seed", "1", "--seconds", "1"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def _copy_with_additions(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(HERE, root / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = copy.deepcopy(SPEC)
    spec["configs"].append({"name": "nonstab9", "source": "test",
                            "file": "gpubench/configs/nonstab9.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "nonstab9.pairs.window",
                              "config": "nonstab9", "traffic": "pairs.window",
                              "chips": 1, "why": "test"})
    spec["workloads"].append({"name": "nonstab9.zero.window",
                              "config": "nonstab9", "traffic": "zero.window",
                              "chips": 1, "why": "test"})
    new = ["nonstab9.pairs.window", "nonstab9.zero.window"]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if m["name"] in ("amp_updates_per_s", "setup_s", "passes_per_request"):
            m.setdefault("workloads", [])
            m["workloads"] += new
    for name in ("requests_seen", "panel_plain_calls"):
        spec["per_layer"].append({"name": name, "unit": "req",
                                  "better": "higher",
                                  "source": "program_counter",
                                  "layer": "executor and schedules",
                                  "moves": "amp_updates_per_s",
                                  "workloads": new})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    g = root / "gpubench"
    (g / "configs" / "nonstab9.json").write_text(json.dumps({
        "name": "nonstab9", "maker": "non_stabilizer",
        "params": {"n": 9, "depth": 2, "seed": 4}, "dtype": "complex64"}))
    (g / "traffic" / "pairs.window.json").write_text(json.dumps({
        "kind": "expectation_z", "simulator": {"mode": "window"},
        "new_instance": False, "z_weight": [2, 2]}))
    (g / "checks" / "nonstab9.pairs.window.json").write_text(json.dumps({
        "limits": {"state_err": 1e-4, "z_err": 1e-5}, "requests": 1}))
    (g / "metrics" / "requests_seen.py").write_text(
        "def read(run):\n    return float(run.requests)\n")
    (g / "metrics" / "panel_plain_calls.py").write_text(
        "COUNTERS = ['ops.panel_kernels:PLAIN_CALLS']\n"
        "def read(run):\n"
        "    return float(run.counters[COUNTERS[0]])\n")
    # a new kind of request: the probability of |0...0>, after api.run
    (g / "kinds" / "prob_zero.py").write_text(
        "NUMBER = 'p0_err'\n"
        "def draw(stream, rng):\n    return {}\n"
        "def call(port, req, cfg, spanning):\n"
        "    psi = port.run(req.circuit, cfg)\n"
        "    return float(psi.reshape(-1)[0].abs() ** 2)\n"
        "def control(ctl, req, cfg, spanning):\n"
        "    return float(ctl.probs(ctl.run(req.circuit, cfg))[0])\n"
        "def error(answer, req, probs, n, config):\n"
        "    return abs(answer - float(probs[0]))\n")
    (g / "traffic" / "zero.window.json").write_text(json.dumps({
        "kind": "prob_zero", "simulator": {"mode": "window"},
        "new_instance": False}))
    (g / "checks" / "nonstab9.zero.window.json").write_text(json.dumps({
        "limits": {"state_err": 1e-4, "p0_err": 1e-6}, "requests": 1}))
    return root


_RUN_NEW = (
    "import json, sys, time\n"
    "from gpubench import run as R\n"
    "from gpubench.systems import Control\n"
    "import torch\n"
    "spec = R.load_json(R.ROOT / 'BENCHMARK.json')\n"
    "cell = R.load_cell(spec, sys.argv[1])\n"
    "trace = sys.argv[2] == '1'\n"
    "system = Control(torch.device('cpu')) if sys.argv[3] == 'control' else None\n"
    "res = R.run_cell(cell, 5, 0.2, trace, 'cpu', system=system,\n"
    "                 t_start=time.perf_counter())\n"
    "print(json.dumps(res))\n")


@pytest.mark.parametrize("system", ["port", "control"])
@pytest.mark.parametrize("trace", ["0", "1"])
@pytest.mark.parametrize("workload", ["nonstab9.pairs.window",
                                      "nonstab9.zero.window"])
def test_new_files_are_found_without_an_edit(tmp_path, workload, trace,
                                             system):
    """A configuration, a traffic mix, a kind of request, a check and
    per-layer metrics (one of a counter no other reads) added as files."""
    root = _copy_with_additions(tmp_path)
    out = subprocess.run([sys.executable, "-c", _RUN_NEW, workload, trace,
                          system], cwd=root,
                         capture_output=True, text=True, timeout=300,
                         env={"PYTHONPATH": f"{root}:{ROOT}", "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    number = "z_err" if "pairs" in workload else "p0_err"
    assert set(res["checks"]) == {"state_err", number}
    if system == "control":
        assert res["correct"] is False, res["checks"]
        return
    assert res["correct"] is True, res["checks"]
    if trace == "1":
        m = res["metrics"]
        assert m["requests_seen"]["value"] >= 1
        assert m["panel_plain_calls"]["value"] >= 1
        assert m["passes_per_request"]["value"] >= 1
    else:
        assert set(res["metrics"]) == {"amp_updates_per_s", "setup_s"}


def test_a_bare_checkout_fails_and_prints_nothing(tmp_path):
    root = tmp_path / "bare"
    shutil.copytree(HERE, root / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root)
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys, time\nfrom gpubench import run as R\n"
         "spec = R.load_json(R.ROOT / 'BENCHMARK.json')\n"
         f"R.run_cell(R.load_cell(spec, {WORKLOADS[0]!r}), 1, 0.1, False, 'cpu')\n"
         "print('{}')\n"],
        cwd=root, capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": str(root), "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout == ""
    assert "quantum_simulations_tpu_torch" in out.stderr


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], 0
        elif isinstance(node, ast.ImportFrom):
            yield (node.module or "").split(".")[0], node.level


def test_no_module_imports_jax_or_the_jax_package():
    files = list(HERE.rglob("*.py"))
    assert len(files) > 10
    for f in files:
        for top, level in _imports(f):
            assert level or top not in FORBIDDEN, (f, top)
            if "reference" in f.relative_to(HERE).parts:
                assert level or top not in {"quantum_simulations_tpu_torch",
                                            "gpubench"}, (f, top)
                assert level <= 1, (f, top)


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "quantum_simulations_tpu_torchx", sys)
    assert "quantum_simulations_tpu" not in R.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert R.forbidden_modules() == ["jax"]
