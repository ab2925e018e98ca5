"""Circuit dependency DAG and gate partitioning (a copy of
``quantum_simulations_tpu/circuit/dag.py``: the port imports nothing of
the JAX package).

Capability parity with v2's pure-python DAG
(``v2_spark/src/circuit_graph.py``: dependencies via shared qubits,
topological levels, acyclicity) and the partitioning strategies of
v2/v3 (``v2_spark/src/circuit_partitioner.py`` level_based / greedy /
balanced; ``v3_hisvsim_spark/src/hisvsim/partition_adapter.py``
load_balanced / locality / hybrid) — implemented without networkx.

``locality`` is the strategy ``runtime.simulator.simulate(segment_gates=...)``
cuts by, and the CLI's ``export --format dot --partitions k`` clusters
by; it is this copy's default (the reference's callers pass it by name,
its signature defaults to ``level_based``).
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field

from .contract import validate_circuit_dict


@dataclass
class CircuitGraph:
    """Dependency DAG: gate i -> gate j if they share a qubit and i < j
    with no intervening gate on that qubit (direct dependency edges)."""

    n_qubits: int
    gates: list = field(default_factory=list)
    edges: list = field(default_factory=list)          # (i, j)
    preds: dict = field(default_factory=dict)          # j -> [i]
    succs: dict = field(default_factory=dict)          # i -> [j]

    @classmethod
    def from_circuit(cls, circuit_dict: dict) -> "CircuitGraph":
        cd = validate_circuit_dict(circuit_dict)
        g = cls(n_qubits=cd["number_of_qubits"], gates=cd["gates"])
        g.preds = defaultdict(list)
        g.succs = defaultdict(list)
        last_on: dict[int, int] = {}
        for j, gate in enumerate(g.gates):
            for q in gate["qubits"]:
                if q in last_on:
                    i = last_on[q]
                    if j not in g.succs[i]:
                        g.edges.append((i, j))
                        g.succs[i].append(j)
                        g.preds[j].append(i)
                last_on[q] = j
        return g

    def topological_levels(self) -> list[list[int]]:
        """ASAP levels of gate indices (level = longest path depth)."""
        depth = [0] * len(self.gates)
        for i, gate in enumerate(self.gates):
            for p in self.preds.get(i, ()):
                depth[i] = max(depth[i], depth[p] + 1)
        levels: list[list[int]] = [[] for _ in range(max(depth, default=-1) + 1)]
        for i, d in enumerate(depth):
            levels[d].append(i)
        return levels

    def is_acyclic(self) -> bool:
        """Always true by construction (edges go forward); verified anyway."""
        return all(i < j for i, j in self.edges)

    def critical_path_length(self) -> int:
        return len(self.topological_levels())

    def gate_qubit_counts(self) -> dict[int, int]:
        counts: dict[int, int] = defaultdict(int)
        for g in self.gates:
            for q in g["qubits"]:
                counts[q] += 1
        return dict(counts)


def partition(
    circuit_dict: dict,
    n_partitions: int,
    strategy: str = "locality",
) -> list[list[int]]:
    """Split gate indices into ``n_partitions`` dependency-respecting groups.

    Strategies (reference parity):
      * ``level_based``  — contiguous runs of whole topological levels
      * ``greedy``       — fill partitions to equal gate counts in order
      * ``balanced``     — like greedy but weighting 2q gates double
      * ``locality``     — cut where consecutive gates share no qubits
                           (minimises cross-partition qubit traffic)
    """
    graph = CircuitGraph.from_circuit(circuit_dict)
    n_gates = len(graph.gates)
    if n_gates == 0:
        return [[] for _ in range(n_partitions)]
    n_partitions = max(1, min(n_partitions, n_gates))

    if strategy == "level_based":
        levels = graph.topological_levels()
        per = max(1, (len(levels) + n_partitions - 1) // n_partitions)
        parts = [
            [g for lv in levels[i:i + per] for g in lv]
            for i in range(0, len(levels), per)
        ]
        parts += [[] for _ in range(n_partitions - len(parts))]
        return parts

    if strategy in ("greedy", "balanced"):
        def weight(i: int) -> int:
            return len(graph.gates[i]["qubits"]) if strategy == "balanced" else 1
        total = sum(weight(i) for i in range(n_gates))
        target = total / n_partitions
        parts, cur, acc = [], [], 0.0
        for i in range(n_gates):
            cur.append(i)
            acc += weight(i)
            if acc >= target and len(parts) < n_partitions - 1:
                parts.append(cur)
                cur, acc = [], 0.0
        parts.append(cur)
        while len(parts) < n_partitions:
            parts.append([])
        return parts

    if strategy == "locality":
        # Score cut points by qubit-set overlap between neighbours; cut
        # at the n-1 lowest-overlap boundaries (ties -> earlier).
        overlaps = []
        for i in range(1, n_gates):
            a = set(graph.gates[i - 1]["qubits"])
            b = set(graph.gates[i]["qubits"])
            overlaps.append((len(a & b), i))
        cuts = sorted(i for _, i in sorted(overlaps)[: n_partitions - 1])
        parts = []
        prev = 0
        for c in cuts:
            parts.append(list(range(prev, c)))
            prev = c
        parts.append(list(range(prev, n_gates)))
        return parts

    raise ValueError(f"unknown strategy {strategy!r}")


def to_dot(circuit_dict: dict, parts: list[list[int]] | None = None) -> str:
    """Render the dependency DAG as Graphviz dot text.

    Parity with the reference's partition-file bridge (v3's adapter
    emits HiSVSIM dot partition files,
    ``v3_hisvsim_spark/src/hisvsim/partition_adapter.py:34-180``; the
    QASMBench corpus ships ``*_part_*`` dot files).  When ``parts`` is
    given (from :func:`partition`), each partition becomes a cluster
    subgraph so cut quality is visible at a glance.
    """
    graph = CircuitGraph.from_circuit(circuit_dict)

    def node(i: int) -> str:
        g = graph.gates[i]
        qs = ",".join(str(q) for q in g["qubits"])
        return f'  g{i} [label="{i}: {g["gate"]} q{qs}"];'

    lines = ["digraph circuit {", "  rankdir=LR;"]
    if parts is None:
        lines += [node(i) for i in range(len(graph.gates))]
    else:
        for pi, p in enumerate(parts):
            if not p:
                continue
            lines.append(f"  subgraph cluster_{pi} {{")
            lines.append(f'    label="partition {pi}";')
            lines += ["  " + node(i) for i in p]
            lines.append("  }")
    lines += [f"  g{i} -> g{j};" for i, j in graph.edges]
    lines.append("}")
    return "\n".join(lines) + "\n"


def partition_stats(circuit_dict: dict, parts: list[list[int]]) -> dict:
    graph = CircuitGraph.from_circuit(circuit_dict)
    sizes = [len(p) for p in parts]
    cross = 0
    part_of = {}
    for pi, p in enumerate(parts):
        for g in p:
            part_of[g] = pi
    for i, j in graph.edges:
        if part_of.get(i) != part_of.get(j):
            cross += 1
    return {
        "sizes": sizes,
        "imbalance": (max(sizes) - min(sizes)) if sizes else 0,
        "cross_edges": cross,
        "total_edges": len(graph.edges),
    }
