"""Circuit-dict contract: validation, name-encoded parsing, levelization.

A copy of ``quantum_simulations_tpu/circuit/contract.py``: the port
imports nothing of the JAX package.  The contract is shared with the
reference framework (``wenbo_engine/docs/circuit_contract.md``,
``wenbo_engine/circuit/io.py``):

.. code-block:: python

    {"number_of_qubits": int,
     "gates": [{"qubits": [int, ...], "gate": str, "params": {...}}, ...]}

* **Endianness: little-endian.** Qubit 0 is bit 0 (LSB) of the
  statevector index: |q_{n-1} ... q_1 q_0> has index
  q_0 + 2 q_1 + ... + 2^{n-1} q_{n-1}.
* Name-encoded params: ``"CR3"`` means CR with k=3, ``"R3"`` means R
  with k=3 (``RY`` is never name-decoded).
* ``validate_circuit_dict`` raises ``ValueError`` on any malformed
  input and returns a normalised deep copy.

Extended gates (RX/RZ/P/RZZ/CCX/...) are accepted by default; pass
``core_only=True`` to restrict validation to the reference's 15-gate
contract.
"""
from __future__ import annotations

import hashlib
import json
import re
from typing import Any

from ..utils import timing
from . import gates as G

ENDIANNESS = "little"

_RE_CR = re.compile(r"^CR(\d+)$")
_RE_R = re.compile(r"^R(\d+)$")

_NUMERIC = (int, float)


def parse_name_encoded(raw: str) -> tuple[str, dict]:
    """``CR3`` -> ('CR', {'k': 3}); ``R3`` -> ('R', {'k': 3}); else (raw, {})."""
    m = _RE_CR.match(raw)
    if m:
        return "CR", {"k": int(m.group(1))}
    if raw not in ("RY", "RX", "RZ", "RXX", "RYY", "RZZ"):
        m = _RE_R.match(raw)
        if m:
            return "R", {"k": int(m.group(1))}
    return raw, {}


_TOP_KEYS = ("number_of_qubits", "gates")
_GATE_KEYS = ("qubits", "gate", "params")
_GATE_KEYS_NONUNITARY = ("qubits", "gate", "params", "cond")
_INT_PARAMS = frozenset({"k", "p", "exponent", "cbit"})

#: Non-unitary instructions (trajectory tier only; the reference's QASM
#: driver silently DROPS ``reset`` — ``qasm_assembler_standalone.py:525``
#: prints "is not supported" — and cannot parse ``if(...)`` at all).
NONUNITARY_OPS = frozenset({"RESET", "MEASURE"})


def _strict_int(v: Any) -> bool:
    return isinstance(v, int) and not isinstance(v, bool)


def has_nonunitary(d: dict[str, Any]) -> bool:
    """True if the circuit contains RESET/MEASURE or conditional gates
    (requires the trajectory tier)."""
    for g in d.get("gates", ()):
        if not isinstance(g, dict):
            continue
        if g.get("gate") in NONUNITARY_OPS or "cond" in g:
            return True
    return False


@timing.spanned("qst.contract.validate")
def validate_circuit_dict(d: dict[str, Any], *, core_only: bool = False,
                          allow_nonunitary: bool = False) -> dict:
    """Validate and normalise a circuit dict.  Raises ValueError on bad input.

    ``allow_nonunitary=True`` additionally accepts the trajectory-tier
    instructions: ``RESET`` (1 qubit), ``MEASURE`` (1 qubit, params
    ``creg``/``cbit``) and a ``cond`` key ``{"creg": str, "value": int}``
    on any unitary gate (classically-controlled execution).
    """
    if not isinstance(d, dict):
        raise ValueError(f"circuit must be a dict, not {type(d).__name__}")
    absent = [k for k in _TOP_KEYS if k not in d]
    if absent:
        raise ValueError(f"circuit is missing required keys {absent}")
    stray = [k for k in d if k not in _TOP_KEYS]
    if stray:
        raise ValueError(
            f"unknown top-level keys {stray}; the contract allows exactly "
            f"{list(_TOP_KEYS)}")
    n, gates = d["number_of_qubits"], d["gates"]
    if not _strict_int(n) or n < 1:
        raise ValueError(f"number_of_qubits must be a positive int, got {n!r}")
    if not isinstance(gates, list):
        raise ValueError(f"gates must be a list, not {type(gates).__name__}")
    return {
        "number_of_qubits": n,
        "gates": [_validate_gate(g, n, i, core_only, allow_nonunitary)
                  for i, g in enumerate(gates)],
    }


def _validate_cond(cond: Any, bad) -> dict:
    if not isinstance(cond, dict):
        bad(f"cond must be a dict, not {type(cond).__name__}")
    stray = [k for k in cond if k not in ("creg", "value")]
    if stray:
        bad(f"cond: unknown keys {set(stray)}; allowed: ['creg', 'value']")
    if not isinstance(cond.get("creg"), str):
        bad("cond.creg must be a string")
    if not _strict_int(cond.get("value")) or cond["value"] < 0:
        bad("cond.value must be a non-negative int")
    return {"creg": cond["creg"], "value": cond["value"]}


def _validate_gate(g: Any, nq: int, idx: int, core_only: bool,
                   allow_nonunitary: bool = False) -> dict:
    def bad(problem: str):
        raise ValueError(f"gate[{idx}]: {problem}")

    if not isinstance(g, dict):
        bad(f"each gate must be a dict, not {type(g).__name__}")
    if "qubits" not in g or "gate" not in g:
        bad("a gate needs both 'qubits' and 'gate'")
    allowed = _GATE_KEYS_NONUNITARY if allow_nonunitary else _GATE_KEYS
    stray = [k for k in g if k not in allowed]
    if stray:
        bad(f"unknown keys {set(stray)}; allowed: {list(allowed)}")

    raw = g["gate"]
    if not isinstance(raw, str):
        bad(f"gate name must be a string, not {type(raw).__name__}")

    if allow_nonunitary and raw in NONUNITARY_OPS:
        qubits = g["qubits"]
        if not (isinstance(qubits, list) and len(qubits) == 1
                and _strict_int(qubits[0]) and 0 <= qubits[0] < nq):
            bad(f"{raw} takes exactly one in-range qubit")
        if "cond" in g:
            bad(f"{raw} cannot itself be conditional")
        out = {"qubits": list(qubits), "gate": raw, "params": {}}
        if raw == "MEASURE":
            p = g.get("params") or {}
            if not isinstance(p.get("creg"), str):
                bad("MEASURE requires params.creg (classical register name)")
            if not _strict_int(p.get("cbit")) or p["cbit"] < 0:
                bad("MEASURE requires params.cbit (non-negative bit index)")
            out["params"] = {"creg": p["creg"], "cbit": p["cbit"]}
        return out

    base, name_params = parse_name_encoded(raw)
    if base not in (G.CORE_GATES if core_only else G.ALL_GATES):
        bad(f"unsupported gate {raw!r}")

    qubits = g["qubits"]
    if not (isinstance(qubits, list) and all(_strict_int(q) for q in qubits)):
        bad(f"{base}: qubits must be list[int]")
    want = G.arity(base)
    if len(qubits) != want:
        bad(f"{base} needs {want} qubit(s), got {len(qubits)}")
    bogus = [q for q in qubits if not 0 <= q < nq]
    if bogus:
        bad(f"qubit {bogus[0]} out of range [0, {nq})")
    if len(set(qubits)) < len(qubits):
        bad(f"duplicate qubits {qubits}")

    params = {**name_params, **(g.get("params") or {})}
    for key in G.PARAM_SPEC.get(base, ()):
        if key not in params:
            bad(f"{base} requires param {key!r}")
        v = params[key]
        if key == "U":
            continue  # array-valued; shape-checked by gate_matrix
        if key in _INT_PARAMS:
            if not _strict_int(v):
                bad(f"param {key!r} must be int, got {v!r}")
        elif not isinstance(v, _NUMERIC) or isinstance(v, bool):
            bad(f"param {key!r} must be numeric, got {v!r}")

    out = {"qubits": list(qubits), "gate": base, "params": params}
    if "cond" in g:
        out["cond"] = _validate_cond(g["cond"], bad)
    return out


# ---------------------------------------------------------------------------
# Levelization
# ---------------------------------------------------------------------------

def levelize(circuit_dict: dict) -> list[list[dict]]:
    """Group gates into dependency-free levels (ASAP scheduling).

    Two gates that share a qubit land in different levels; gate order
    within the original list is preserved inside each level.  Same
    semantics as the reference contract
    (``wenbo_engine/circuit/io.py:106-117``); computed here as an
    explicit two-pass: per-gate depth first, then bucketing.
    """
    gates = circuit_dict["gates"]
    frontier: dict[int, int] = {}  # qubit -> first level free for it
    depth_of = []
    for g in gates:
        lvl = max((frontier.get(q, 0) for q in g["qubits"]), default=0)
        depth_of.append(lvl)
        for q in g["qubits"]:
            frontier[q] = lvl + 1
    levels: list[list[dict]] = [[] for _ in range(max(depth_of, default=-1) + 1)]
    for g, lvl in zip(gates, depth_of):
        levels[lvl].append(g)
    return levels


def circuit_depth(circuit_dict: dict) -> int:
    return len(levelize(circuit_dict))


@timing.spanned("qst.contract.hash")
def circuit_hash(circuit_dict: dict) -> str:
    """Stable SHA-256 of a circuit dict (WAL identity, jit-cache key).

    Complex/array params (e.g. CU's U) are serialised via repr so the
    hash is deterministic for any contract-valid circuit.
    """
    blob = json.dumps(circuit_dict, sort_keys=True, default=repr)
    return hashlib.sha256(blob.encode()).hexdigest()


def gate_counts(circuit_dict: dict) -> dict[str, int]:
    counts: dict[str, int] = {}
    for g in circuit_dict["gates"]:
        counts[g["gate"]] = counts.get(g["gate"], 0) + 1
    return counts
