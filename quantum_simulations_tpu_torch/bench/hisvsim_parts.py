"""Score the staging scheduler against HiSVSIM's precomputed partitions.

The port of ``quantum_simulations_tpu/bench/hisvsim_parts.py``: host-only
planning through the port's ``circuit/staging``, no device work.  The
reference ships per-circuit partition files produced by its partitioner
(strategies smart/dfs/nat) next to the QASMBench corpus circuits
(``QST_QASMBENCH``): ``cluster/<name>/<name>_part_{smart,dfs,nat}`` — one
row per DAG node, ``<seq> <gate>_<id> <partition>`` (qubit input/output
pseudo-nodes are interleaved and skipped here; the ``_<id>`` suffix is the
DAG insertion id, i.e. statement order).

Comparison method: both plans are costed under the SAME execution
model — k-local stages with one bit-permutation reshard per stage
transition (the sharded execution; k = n - d device bits).

* **theirs**: gates grouped by partition, partitions sequenced by a
  topological order of the partition DAG, then the strict-order greedy
  stage packer (``stage_circuit(..., 'greedy')``) counts the k-local
  stages that plan needs.
* **ours**: ``stage_circuit(cd, k, 'heuristic')`` on the original
  circuit.

Reported per (circuit, strategy, d): stage counts + estimated reshard
bytes (stages-1 transitions x state bytes, the all_to_all volume), and
whether the scheduler is at parity or better.

    python -m quantum_simulations_tpu_torch.bench.hisvsim_parts --devices 8,16
"""
from __future__ import annotations

import argparse
import json
import os
import re

import numpy as np

from .corpus import CLUSTER, parse_one

_ROW = re.compile(r"^\s*(\d+)\s+(\S+)_(\d+)\s+(\d+)\s*$")
# DAG qubit input/exit pseudo-nodes: "qr3", "q12", "qr3_exit" (inputs
# have no _id suffix so they miss _ROW; exits parse as name "qr3_exit")
_PSEUDO = re.compile(r"^qr?\d+(_exit)?$")

_TYPE_MAP = {"h": "H", "x": "X", "cx": "CNOT", "u1": ("RZ", "P"),
             "cz": "CZ", "t": "T", "s": "S"}


def partition_files() -> list[tuple[str, str, str]]:
    """(circuit, strategy, path) for every shipped partition file."""
    out = []
    for root, _dirs, files in os.walk(CLUSTER):
        base = os.path.basename(root)
        for f in files:
            m = re.match(r"^(.*)_part_(smart|dfs|nat)$", f)
            if m:
                out.append((m.group(1), m.group(2),
                            os.path.join(root, f)))
        # q_0_25_1 style: bare smart/dfs/nat files in the circuit dir
        for f in files:
            if f in ("smart", "dfs", "nat"):
                out.append((base, f, os.path.join(root, f)))
    return sorted(out)


def load_partition(path: str, gates: list[dict]) -> list[int] | None:
    """Per-gate partition ids (statement order), or None on mismatch."""
    rows = []
    with open(path) as f:
        for line in f:
            m = _ROW.match(line)
            if not m:
                continue
            name, suffix, part = m.group(2), int(m.group(3)), int(m.group(4))
            if _PSEUDO.match(name.lower()):
                continue
            rows.append((suffix, name.lower(), part))
    rows.sort()  # DAG insertion id == statement order
    if len(rows) != len(gates):
        return None
    for (_suf, name, _part), g in zip(rows, gates):
        want = _TYPE_MAP.get(name)
        if want is None:
            continue
        ok = g["gate"] in want if isinstance(want, tuple) else g["gate"] == want
        if not ok:
            return None
    return [part for _suf, _name, part in rows]


def sequence_partitions(gates: list[dict], parts: list[int]):
    """Gates reordered partition-by-partition (partitions in a
    topological order of the partition dependency DAG).  Returns None
    if the partition graph is cyclic (not sequentially executable)."""
    ids = sorted(set(parts))
    # partition DAG: edge a->b if some gate in a precedes a dependent
    # gate in b (shared qubit), a != b
    edges: dict[int, set[int]] = {p: set() for p in ids}
    last_on_qubit: dict[int, int] = {}
    for i, g in enumerate(gates):
        for q in g["qubits"]:
            if q in last_on_qubit:
                j = last_on_qubit[q]
                if parts[j] != parts[i]:
                    edges[parts[j]].add(parts[i])
            last_on_qubit[q] = i
    order, seen, mark = [], set(), set()

    def visit(p):
        if p in seen:
            return True
        if p in mark:
            return False  # cycle
        mark.add(p)
        for nxt in sorted(edges[p]):
            if not visit(nxt):
                return False
        mark.discard(p)
        seen.add(p)
        order.append(p)
        return True

    for p in ids:
        if not visit(p):
            return None
    order.reverse()
    pos = {p: t for t, p in enumerate(order)}
    idx = sorted(range(len(gates)), key=lambda i: (pos[parts[i]], i))
    return [gates[i] for i in idx]


def score(cd: dict, gate_order: list[dict], k: int) -> dict:
    """k-local stage count for an explicit gate order (the strict-order
    greedy packer, applied to their plan)."""
    from ..circuit import staging as S

    sub = {"number_of_qubits": cd["number_of_qubits"], "gates": gate_order}
    _, _, stats = S.stage_circuit(sub, k, "greedy")
    return stats


def run(devices=(8,), strategies=("smart", "dfs", "nat")) -> dict:
    from ..circuit import staging as S

    rows = []
    circuits: dict[str, dict] = {}
    for name, strat, path in partition_files():
        if strat not in strategies:
            continue
        if name not in circuits:
            qasm = os.path.join(CLUSTER, name, f"{name}.qasm")
            if not os.path.exists(qasm):
                continue
            cd, mode, _err = parse_one(qasm)
            circuits[name] = cd if mode == "unitary" else None
        cd = circuits[name]
        if cd is None:
            continue
        parts = load_partition(path, cd["gates"])
        if parts is None:
            rows.append({"circuit": name, "strategy": strat,
                         "status": "row/gate mismatch"})
            continue
        seq = sequence_partitions(cd["gates"], parts)
        n = cd["number_of_qubits"]
        for D in devices:
            d = int(np.log2(D))
            k = n - d
            if seq is None:
                rows.append({"circuit": name, "strategy": strat,
                             "n": n, "devices": D,
                             "status": "partition graph cyclic "
                                       "(not sequentially executable)"})
                continue
            theirs = score(cd, seq, k)
            _, _, ours = S.stage_circuit(cd, k, "heuristic")
            state_gib = (1 << n) * 8 / 2**30  # c64
            resh = state_gib * (1 - 1 / D)
            row = {
                "circuit": name, "strategy": strat, "n": n,
                "devices": D, "partitions_in_file": len(set(parts)),
                "their_stages": theirs["stages"],
                "our_stages": ours["stages"],
                "their_reshard_GiB": round(
                    max(0, theirs["stages"] - 1) * resh, 2),
                "our_reshard_GiB": round(
                    max(0, ours["stages"] - 1) * resh, 2),
                "verdict": ("win" if ours["stages"] < theirs["stages"]
                            else "parity" if ours["stages"] == theirs["stages"]
                            else "LOSS"),
            }
            rows.append(row)
            print(json.dumps(row), flush=True)

    wins = sum(r.get("verdict") == "win" for r in rows)
    par = sum(r.get("verdict") == "parity" for r in rows)
    loss = sum(r.get("verdict") == "LOSS" for r in rows)
    out = {"rows": rows, "wins": wins, "parity": par, "losses": loss,
           "model": "k-local stages, one all_to_all reshard per "
                    "transition; their plan packed by the same greedy "
                    "packer in partition-topological order"}
    print(json.dumps({k: v for k, v in out.items() if k != "rows"}))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m quantum_simulations_tpu_torch.bench.hisvsim_parts")
    ap.add_argument("--devices", default="8")
    a = ap.parse_args(argv)
    run(devices=tuple(int(x) for x in a.devices.split(",")))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
