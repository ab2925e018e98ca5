"""Qiskit -> circuit-dict importer, an optional dependency (a copy of
``quantum_simulations_tpu/circuit/import_qiskit.py``).

Capability parity with ``wenbo_engine/circuit/import_qiskit.py`` (its
transpiled-basis importer) but accepting the wider native gate set so
most circuits need no transpilation at all.  Gracefully unavailable
when qiskit is not installed (it is not baked into this image; the
dual-oracle tests skip instead of failing).
"""
from __future__ import annotations

import math

try:
    import qiskit  # noqa: F401
    HAVE_QISKIT = True
except ImportError:
    HAVE_QISKIT = False

# qiskit op name -> (gate, param names)
_DIRECT = {
    "h": "H", "x": "X", "y": "Y", "z": "Z", "s": "S", "t": "T",
    "sdg": "SDG", "tdg": "TDG", "sx": "SX",
    "cx": "CNOT", "cy": "CY", "cz": "CZ", "swap": "SWAP",
    "ccx": "CCX", "ccz": "CCZ", "cswap": "CSWAP",
}
_ANGLED = {
    "rx": ("RX", "theta"), "ry": ("RY", "theta"), "rz": ("RZ", "theta"),
    "p": ("P", "phi"), "u1": ("P", "phi"),
    "cp": ("CP", "phi"), "cu1": ("CP", "phi"),
    "crx": ("CRX", "theta"), "cry": ("CRY", "theta"), "crz": ("CRZ", "theta"),
    "rxx": ("RXX", "theta"), "ryy": ("RYY", "theta"), "rzz": ("RZZ", "theta"),
}

SUPPORTED_BASIS = sorted(set(_DIRECT) | set(_ANGLED) | {"u", "u2", "u3"})


def qiskit_to_dict(qc) -> dict:
    """Convert a qiskit QuantumCircuit to a circuit dict.

    Barriers and measurements are skipped; unsupported ops raise
    (transpile to ``SUPPORTED_BASIS`` first if needed).
    """
    if not HAVE_QISKIT:
        raise ImportError("qiskit is not installed")
    gates = []
    qubit_index = {q: i for i, q in enumerate(qc.qubits)}
    for inst in qc.data:
        op = inst.operation
        name = op.name.lower()
        if name in ("barrier", "measure", "delay", "id"):
            continue
        qubits = [qubit_index[q] for q in inst.qubits]
        if name in _DIRECT:
            gates.append({"qubits": qubits, "gate": _DIRECT[name]})
        elif name in _ANGLED:
            gname, pname = _ANGLED[name]
            gates.append({"qubits": qubits, "gate": gname,
                          "params": {pname: float(op.params[0])}})
        elif name in ("u", "u3"):
            t, p, l = (float(v) for v in op.params)
            gates.append({"qubits": qubits, "gate": "U",
                          "params": {"theta": t, "phi": p, "lam": l}})
        elif name == "u2":
            p, l = (float(v) for v in op.params)
            gates.append({"qubits": qubits, "gate": "U2",
                          "params": {"phi": p, "lam": l}})
        else:
            raise ValueError(
                f"unsupported qiskit op {name!r}; transpile to {SUPPORTED_BASIS}"
            )
    return {"number_of_qubits": qc.num_qubits, "gates": gates}


def overlap_with_qiskit(circuit_dict: dict, psi) -> float:
    """|<qiskit_statevector | psi>| — the external dual-oracle metric.

    (``wenbo_engine/tests/test_qiskit_oracle.py`` semantics.)
    """
    if not HAVE_QISKIT:
        raise ImportError("qiskit is not installed")
    import numpy as np
    from qiskit import QuantumCircuit
    from qiskit.quantum_info import Statevector

    qc = dict_to_qiskit(circuit_dict)
    ref = Statevector.from_instruction(qc).data
    return float(abs(np.vdot(ref, np.asarray(psi))))


def dict_to_qiskit(circuit_dict: dict):
    """Inverse direction (for the dual-oracle tests)."""
    if not HAVE_QISKIT:
        raise ImportError("qiskit is not installed")
    from qiskit import QuantumCircuit

    from .contract import parse_name_encoded

    inv_direct = {v: k for k, v in _DIRECT.items()}
    qc = QuantumCircuit(circuit_dict["number_of_qubits"])
    for g in circuit_dict["gates"]:
        name, qubits = g["gate"], g["qubits"]
        params = g.get("params") or {}
        if not params:  # "CR2"/"R3" name-encoded form (contract.py:41)
            name, params = parse_name_encoded(name)
        if name in inv_direct:
            getattr(qc, inv_direct[name])(*qubits)
        elif name == "RY":
            qc.ry(params["theta"], *qubits)
        elif name == "R":
            qc.p(2 * math.pi / (1 << params["k"]), *qubits)
        elif name == "CR":
            qc.cp(2 * math.pi / (1 << params["k"]), *qubits)
        elif name == "G":
            import numpy as np
            p = params["p"]
            theta = 2 * math.atan2(math.sqrt(1 - 1 / p), math.sqrt(1 / p))
            qc.ry(theta, *qubits)
        elif name in ("RX", "RZ"):
            getattr(qc, name.lower())(params["theta"], *qubits)
        elif name == "P":
            qc.p(params["phi"], *qubits)
        elif name == "CP":
            qc.cp(params["phi"], *qubits)
        elif name == "RZZ":
            qc.rzz(params["theta"], *qubits)
        elif name == "RXX":
            qc.rxx(params["theta"], *qubits)
        elif name == "RYY":
            qc.ryy(params["theta"], *qubits)
        elif name == "U":
            qc.u(params["theta"], params["phi"], params["lam"], *qubits)
        elif name == "CU":
            import numpy as np
            from qiskit.circuit.library import UnitaryGate
            U = np.linalg.matrix_power(
                np.asarray(params["U"], dtype=complex), params["exponent"]
            )
            qc.append(UnitaryGate(U).control(1), qubits)
        else:
            raise ValueError(f"no qiskit mapping for {name!r}")
    return qc
