"""The PyTorch port stands alone: it loads neither JAX nor the JAX package."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "quantum_simulations_tpu_torch"

MODULES = [
    "quantum_simulations_tpu_torch",
    "quantum_simulations_tpu_torch.__main__",
    "quantum_simulations_tpu_torch.api",
    "quantum_simulations_tpu_torch.bench",
    "quantum_simulations_tpu_torch.bench.baseline_configs",
    "quantum_simulations_tpu_torch.bench.c128_diff",
    "quantum_simulations_tpu_torch.bench.capacity",
    "quantum_simulations_tpu_torch.bench.corpus",
    "quantum_simulations_tpu_torch.bench.corpus33",
    "quantum_simulations_tpu_torch.bench.e2e",
    "quantum_simulations_tpu_torch.bench.fingerprints",
    "quantum_simulations_tpu_torch.bench.hisvsim_parts",
    "quantum_simulations_tpu_torch.bench.headline",
    "quantum_simulations_tpu_torch.bench.kernel_bw",
    "quantum_simulations_tpu_torch.bench.matrix",
    "quantum_simulations_tpu_torch.bench.opprof",
    "quantum_simulations_tpu_torch.bench.overhead",
    "quantum_simulations_tpu_torch.bench.passes",
    "quantum_simulations_tpu_torch.bench.probe_transfer",
    "quantum_simulations_tpu_torch.bench.projection",
    "quantum_simulations_tpu_torch.bench.sharded",
    "quantum_simulations_tpu_torch.bench.spill_bw",
    "quantum_simulations_tpu_torch.bench.suite",
    "quantum_simulations_tpu_torch.bench.sweep",
    "quantum_simulations_tpu_torch.convert",
    "quantum_simulations_tpu_torch.circuit.dag",
    "quantum_simulations_tpu_torch.circuit.export_qasm",
    "quantum_simulations_tpu_torch.circuit.fusion",
    "quantum_simulations_tpu_torch.circuit.import_qasm",
    "quantum_simulations_tpu_torch.circuit.import_qiskit",
    "quantum_simulations_tpu_torch.circuit.panelize",
    "quantum_simulations_tpu_torch.ops.bitperm_kernels",
    "quantum_simulations_tpu_torch.ops.cuda_build",
    "quantum_simulations_tpu_torch.ops.dense",
    "quantum_simulations_tpu_torch.ops.diag_kernels",
    "quantum_simulations_tpu_torch.ops.observables",
    "quantum_simulations_tpu_torch.ops.pair_kernels",
    "quantum_simulations_tpu_torch.ops.panel_kernels",
    "quantum_simulations_tpu_torch.ops.sampling",
    "quantum_simulations_tpu_torch.oracle",
    "quantum_simulations_tpu_torch.parallel.comm",
    "quantum_simulations_tpu_torch.parallel.distributed",
    "quantum_simulations_tpu_torch.parallel.executor",
    "quantum_simulations_tpu_torch.parallel.mesh",
    "quantum_simulations_tpu_torch.parallel.placement",
    "quantum_simulations_tpu_torch.parallel.pod_worker",
    "quantum_simulations_tpu_torch.parallel.reshard",
    "quantum_simulations_tpu_torch.runtime.capacity",
    "quantum_simulations_tpu_torch.runtime.metadata",
    "quantum_simulations_tpu_torch.runtime.runner",
    "quantum_simulations_tpu_torch.runtime.simulator",
    "quantum_simulations_tpu_torch.runtime.trajectory",
    "quantum_simulations_tpu_torch.sparse.adaptive",
    "quantum_simulations_tpu_torch.sparse.engine",
    "quantum_simulations_tpu_torch.sparse.merge",
    "quantum_simulations_tpu_torch.utils.logging",
    "quantum_simulations_tpu_torch.utils.timing",
]


def _foreign(name: str) -> bool:
    return (name == "jax" or name.startswith("jax.")
            or name == "quantum_simulations_tpu"
            or name.startswith("quantum_simulations_tpu."))


def test_import_leaves_jax_out():
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in MODULES)
            + "from quantum_simulations_tpu_torch.circuit import library\n"
            + "from quantum_simulations_tpu_torch.circuit.panelize import compile_window_schedule\n"
            + "compile_window_schedule(library.non_stabilizer(14))\n"
            + "from quantum_simulations_tpu_torch.runtime.simulator import panel_schedule, fused_ops\n"
            + "panel_schedule(library.non_stabilizer(14)); fused_ops(library.qft(10))\n"
            + "print('\\n'.join(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True).stdout.split()
    assert "quantum_simulations_tpu_torch.runtime.simulator" in out
    assert [m for m in out if _foreign(m)] == []


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_foreign_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        assert not [n for n in names if _foreign(n)], (path, node.lineno, names)


def test_entry_points_default_to_the_card():
    import torch

    from quantum_simulations_tpu_torch import SimulatorConfig, api, library
    from quantum_simulations_tpu_torch.runtime import simulator

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    cd = library.non_stabilizer(14)
    cfg = SimulatorConfig(mode="window")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.simulate(cd, cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        simulator.simulate(cd, mode="window")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        simulator.build_window_circuit_fn(cd)
    assert api.simulate(cd, cfg, device="cpu").shape == (1 << 14,)
    # the sparse COO, adaptive and trajectory tiers
    from quantum_simulations_tpu_torch.runtime.trajectory import simulate_trajectory
    from quantum_simulations_tpu_torch.sparse.adaptive import simulate_adaptive
    from quantum_simulations_tpu_torch.sparse.engine import simulate_sparse

    traj = {"number_of_qubits": 2, "gates": [
        {"qubits": [0], "gate": "H"}, {"qubits": [0], "gate": "RESET"}]}
    for run in (lambda: simulate_sparse(library.ghz(10)),
                lambda: simulate_sparse(library.ghz(63), force_tier="numpy"),
                lambda: simulate_adaptive(library.qft(8)),
                lambda: simulate_trajectory(traj),
                lambda: api.simulate(library.ghz(10), SimulatorConfig(sparse=True)),
                lambda: api.simulate(traj)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            run()
    assert len(simulate_sparse(library.ghz(10), device="cpu")) == 2


def test_cuda_build_needs_nvcc(monkeypatch, tmp_path):
    import shutil
    from pathlib import Path

    from quantum_simulations_tpu_torch.ops import cuda_build

    monkeypatch.setenv("QST_TORCH_BUILD_DIR", str(tmp_path))
    lib = cuda_build.library_path("panels")
    assert lib.parent == tmp_path and lib.name.startswith("libpanels-")
    if shutil.which("nvcc") or Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("nvcc is present")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("QST_NVCC", raising=False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.build_all()


def test_library_hash_covers_the_headers(monkeypatch, tmp_path):
    """Editing a header that several sources include (phase.cuh) must
    rebuild each of them: a stale library is never loaded."""
    import shutil

    from quantum_simulations_tpu_torch.ops import cuda_build

    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC, csrc)
    monkeypatch.setenv("QST_TORCH_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(cuda_build, "CSRC", csrc)
    before = {s: cuda_build.library_path(s) for s in ("panels", "diag", "bitperm")}
    assert all(p.parent == tmp_path / "build" for p in before.values())
    header = csrc / "phase.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    after = {s: cuda_build.library_path(s) for s in before}
    assert after["panels"] != before["panels"]
    assert after["diag"] != before["diag"]
    (csrc / "diag.cu").write_bytes((csrc / "diag.cu").read_bytes() + b" ")
    assert cuda_build.library_path("diag") != after["diag"]
    assert cuda_build.library_path("panels") == after["panels"]
