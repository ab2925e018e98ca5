"""Qubit-reordering scheduler ("staging") — keep hot qubits local (a
copy of ``quantum_simulations_tpu/circuit/staging.py``: the same plans,
``log2phys`` and costs; :func:`permute_state` transposes merged axes and
:func:`permute_state_inplace` moves whole blocks in place).

Capability parity with the reference's Atlas-style staging
(``wenbo_engine/circuit/staging.py``) and HiSVSIM's hierarchical
partitioning (``hisvsim_repo/execute.hpp``): when a circuit keeps
touching qubits above the shard boundary k, it is cheaper to SWAP those
logical qubits into the local index range once and run many gates
locally than to pay an exchange per gate.

TPU-native formulation: the scheduler rewrites the circuit in
*physical* index space — gates are remapped through a logical->physical
QubitMap and explicit SWAP ops are inserted at stage boundaries (each
boundary-crossing SWAP costs exactly one ``ppermute`` in the exchange
tier).  The final state is read back through ``permute_state``.

A qubit is **insular** for a gate if the unitary never flips it
(block-diagonal in that subspace bit — controls and diagonal gates).
The runtime exchange planner already applies such gates with zero
traffic when the insular qubit sits on a device bit, so the scheduler
only requires *non-insular* qubits to be local — the same relaxation
the reference applies to its sparse-gate set, derived here from the
matrix structure instead of a hard-coded name list.

Methods:
  * ``heuristic`` — dependency-aware: executes every DAG-ready gate
    whose non-insular qubits are local, chooses the next local set by
    discounted lookahead scoring (default).
  * ``greedy``    — frequency lookahead without DAG reordering.
  * ``ilp``       — optimal stage count via PuLP if available
    (gracefully falls back to ``heuristic`` otherwise).
"""
from __future__ import annotations

from collections import defaultdict

import numpy as np

from . import gates as G
from .contract import validate_circuit_dict

LOOKAHEAD_WINDOW = 64
LOOKAHEAD_GAMMA = 0.9


# ---------------------------------------------------------------------------
# QubitMap
# ---------------------------------------------------------------------------

class QubitMap:
    """Bidirectional logical <-> physical qubit map."""

    def __init__(self, n: int):
        self.n = n
        self.log2phys = list(range(n))
        self.phys2log = list(range(n))

    def phys(self, logical: int) -> int:
        return self.log2phys[logical]

    def log(self, physical: int) -> int:
        return self.phys2log[physical]

    def swap_phys(self, pa: int, pb: int) -> None:
        la, lb = self.phys2log[pa], self.phys2log[pb]
        self.phys2log[pa], self.phys2log[pb] = lb, la
        self.log2phys[la], self.log2phys[lb] = pb, pa

    def copy(self) -> "QubitMap":
        qm = QubitMap(self.n)
        qm.log2phys = list(self.log2phys)
        qm.phys2log = list(self.phys2log)
        return qm


# ---------------------------------------------------------------------------
# Insularity
# ---------------------------------------------------------------------------

def non_insular_qubits(g: dict) -> list[int]:
    """Logical qubits this gate must have local (it flips them)."""
    U = G.gate_matrix(g["gate"], g.get("params") or {})
    m = len(g["qubits"])
    out = []
    for j, q in enumerate(g["qubits"]):
        if not G.block_diagonal_in(U, m - 1 - j):
            out.append(q)
    return out


# ---------------------------------------------------------------------------
# Core scheduling
# ---------------------------------------------------------------------------

def _dag_ready_sets(gates: list[dict]):
    """Per-qubit FIFO of gate indices (dependency structure)."""
    per_qubit: dict[int, list[int]] = defaultdict(list)
    for i, g in enumerate(gates):
        for q in g["qubits"]:
            per_qubit[q].append(i)
    return per_qubit


def _score_qubits(gates, pending, window, gamma):
    """Discounted future demand per logical qubit (non-insular uses)."""
    scores: dict[int, float] = defaultdict(float)
    cnt = 0
    for i in pending:
        if cnt >= window:
            break
        g = gates[i]
        w = gamma ** cnt
        for q in non_insular_qubits(g):
            scores[q] += w
        for q in g["qubits"]:
            scores[q] += 0.1 * w  # mild pull for insular uses too
        cnt += 1
    return scores


def _emit_swaps(qm: QubitMap, want_local: list[int], k: int,
                out_gates: list[dict], *, bit_costs=None, scores=None):
    """SWAP wanted logical qubits into physical slots < k.

    With ``bit_costs`` (per-device-bit link costs,
    ``parallel.distributed.device_bit_costs``) the EVICTION pairing is
    cost-aware: each fetch evicts a currently-local qubit to the
    fetched qubit's device slot, so the most expensive slots (DCN)
    receive the least-soon-needed evictees (lowest future ``scores``)
    — bringing an evicted hot qubit back from a DCN bit costs 20x an
    ICI bit.
    """
    wanted = set(want_local)
    free = [p for p in range(k) if qm.log(p) not in wanted]
    fetches = [(lq, qm.phys(lq)) for lq in want_local if qm.phys(lq) >= k]
    if bit_costs is not None:
        # Most expensive fetch slot first; free list ordered so pop()
        # yields the LOWEST-future-demand evictee.
        fetches.sort(key=lambda t: -bit_costs[t[1] - k])
        sc = scores or {}
        free.sort(key=lambda p: sc.get(qm.log(p), 0.0), reverse=True)
    for lq, p in fetches:
        if qm.phys(lq) < k:  # an earlier swap may have moved it
            continue
        p = qm.phys(lq)
        if not free:
            raise RuntimeError("no free local slot — want_local larger than k")
        dst = free.pop()
        out_gates.append({"qubits": [dst, p], "gate": "SWAP"})
        qm.swap_phys(dst, p)


def _rank_candidates(scores, qm: QubitMap, k: int, bit_costs, cost_weight):
    """Candidate local-set qubits by future demand, fetch-cost-adjusted.

    Fetching a qubit parked at device slot p costs one boundary SWAP
    crossing device bit (p - k); with ``bit_costs`` the score is
    discounted by ``cost_weight * cost`` so cold DCN-parked qubits are
    deferred until their gates can be batched into one crossing.
    """
    def adj(q, s):
        if bit_costs is None:
            return s
        p = qm.phys(q)
        if p < k:
            return s
        return s - cost_weight * bit_costs[p - k]

    return [q for q, _ in sorted(
        ((q, adj(q, s)) for q, s in scores.items()), key=lambda kv: -kv[1])]


def stage_circuit(
    circuit_dict: dict,
    k: int,
    method: str = "heuristic",
    *,
    window: int = LOOKAHEAD_WINDOW,
    gamma: float = LOOKAHEAD_GAMMA,
    bit_costs: list[float] | None = None,
    cost_weight: float = 0.15,
) -> tuple[dict, list[int], dict]:
    """Rewrite a circuit into physical index space with staged locality.

    Returns ``(physical_circuit_dict, log2phys_final, stats)``.
    ``log2phys_final[q]`` is the physical bit that carries logical
    qubit q in the *output* state (undo with :func:`permute_state`).

    ``bit_costs`` makes the schedule MESH-AWARE (SURVEY §7 hard part —
    the reference's unit is "1 I/O pass", ours is the link a transfer
    actually crosses): stage-set selection discounts candidates by the
    cost of the device bit they'd be fetched across (a qubit parked
    behind DCN needs ``cost_weight * cost`` more future demand to
    justify fetching now instead of batching its gates later), and
    evictions send cold qubits to the expensive slots
    (see :func:`_emit_swaps`).
    """
    cd = validate_circuit_dict(circuit_dict)
    n = cd["number_of_qubits"]
    gates = cd["gates"]
    if k >= n or not gates:
        return cd, list(range(n)), {"stages": 1, "swaps": 0,
                                    "method": "none", "gates": len(gates)}

    if method == "ilp":
        try:
            import pulp  # noqa: F401
            return _stage_ilp(cd, k, window=window, gamma=gamma)
        except ImportError:
            # No solver in the image: exact pure-python branch-and-bound
            # over frontier states (same objective, same output shape).
            sets = _stage_bb(cd, k)
            if sets is not None:
                out = _sets_to_schedule(cd, k, sets)
                out[2]["method"] = "ilp-bb"
                return out
            method = "heuristic"
    if method not in ("heuristic", "greedy"):
        raise ValueError(f"unknown staging method {method!r}")
    reorder = method == "heuristic"  # greedy keeps strict gate order

    qm = QubitMap(n)
    per_qubit = _dag_ready_sets(gates)
    next_in_queue = {q: 0 for q in per_qubit}
    executed = [False] * len(gates)
    out_gates: list[dict] = []
    n_stages = 0
    n_swaps = 0
    pending = list(range(len(gates)))

    def is_ready(i: int) -> bool:
        return all(
            per_qubit[q][next_in_queue[q]] == i for q in gates[i]["qubits"]
        )

    def mark_executed(i: int) -> None:
        executed[i] = True
        for q in gates[i]["qubits"]:
            next_in_queue[q] += 1

    def executable(i: int) -> bool:
        return all(qm.phys(q) < k for q in non_insular_qubits(gates[i]))

    def emit(i: int) -> None:
        g = gates[i]
        entry = {"qubits": [qm.phys(q) for q in g["qubits"]],
                 "gate": g["gate"]}
        if g.get("params"):
            entry["params"] = g["params"]
        out_gates.append(entry)
        mark_executed(i)

    while pending:
        n_stages += 1
        # Choose this stage's local set.
        scores = _score_qubits(gates, pending, window, gamma)
        first = gates[pending[0]]
        required = non_insular_qubits(first) or list(first["qubits"])[:1]
        chosen = list(dict.fromkeys(required))[:k]
        ranked = _rank_candidates(scores, qm, k, bit_costs, cost_weight)
        for q in ranked:
            if len(chosen) >= k:
                break
            if q not in chosen:
                chosen.append(q)
        before = len(out_gates)
        _emit_swaps(qm, chosen, k, out_gates, bit_costs=bit_costs,
                    scores=scores)
        n_swaps += len(out_gates) - before

        # Execute everything the new layout allows.
        progress = True
        while progress:
            progress = False
            still: list[int] = []
            blocked_qubits: set[int] = set()
            for i in pending:
                g = gates[i]
                if reorder:
                    ok = is_ready(i) and executable(i)
                else:
                    ok = not still and executable(i)
                # Strict-order mode: only the head of the queue may run.
                if ok and not (set(g["qubits"]) & blocked_qubits if reorder else False):
                    emit(i)
                    progress = True
                else:
                    still.append(i)
                    if reorder:
                        blocked_qubits.update(g["qubits"])
            pending = still

    out_cd = {"number_of_qubits": n, "gates": out_gates}
    stats = {
        "stages": n_stages,
        "swaps": n_swaps,
        "method": method,
        "gates": len(gates),
    }
    return out_cd, list(qm.log2phys), stats


def _stage_ilp(cd, k, *, window, gamma):
    """ILP stage minimisation (optional, requires PuLP).

    Binary-searches the stage count; within the budget, assigns each
    gate to a stage and each stage a <=k local-qubit set such that
    every gate's non-insular qubits are in its stage's set (classic
    Atlas formulation).  Falls back to the heuristic schedule for the
    SWAP emission once the stage sets are chosen.
    """
    import pulp

    n = cd["number_of_qubits"]
    gates = cd["gates"]
    needs = [non_insular_qubits(g) for g in gates]
    lo, hi = 1, max(1, len(gates))
    best_sets = None

    def try_s(S: int):
        prob = pulp.LpProblem("stages", pulp.LpMinimize)
        x = {}  # gate i in stage s
        y = {}  # qubit q local in stage s
        for i in range(len(gates)):
            for s in range(S):
                x[i, s] = pulp.LpVariable(f"x_{i}_{s}", cat="Binary")
        for q in range(n):
            for s in range(S):
                y[q, s] = pulp.LpVariable(f"y_{q}_{s}", cat="Binary")
        for i in range(len(gates)):
            prob += pulp.lpSum(x[i, s] for s in range(S)) == 1
            for q in needs[i]:
                for s in range(S):
                    prob += x[i, s] <= y[q, s]
        for s in range(S):
            prob += pulp.lpSum(y[q, s] for q in range(n)) <= k
        # Order: gate i before j sharing a qubit => stage(i) <= stage(j)
        last = {}
        for j, g in enumerate(gates):
            for q in g["qubits"]:
                if q in last:
                    i = last[q]
                    prob += (
                        pulp.lpSum(s * x[i, s2] for s2, s in ((t, t) for t in range(S)))
                        <= pulp.lpSum(s * x[j, s2] for s2, s in ((t, t) for t in range(S)))
                    )
                last[q] = j
        prob += 0
        status = prob.solve(pulp.PULP_CBC_CMD(msg=0, timeLimit=20))
        if pulp.LpStatus[status] != "Optimal":
            return None
        sets = []
        for s in range(S):
            sets.append([q for q in range(n) if pulp.value(y[q, s]) > 0.5])
        return sets

    while lo < hi:
        mid = (lo + hi) // 2
        sets = try_s(mid)
        if sets is not None:
            best_sets = sets
            hi = mid
        else:
            lo = mid + 1
    if best_sets is None:
        # The search shrank to lo == hi without ever evaluating the
        # upper bound (possible when only S == len(gates) is feasible):
        # try it before falling back to the heuristic.
        best_sets = try_s(lo)
    if best_sets is None:
        return stage_circuit(cd, k, method="heuristic",
                             window=window, gamma=gamma)
    out = _sets_to_schedule(cd, k, best_sets)
    out[2]["method"] = "ilp"
    return out


# ---------------------------------------------------------------------------
# Stage-set realisation + exact search (no-solver path)
# ---------------------------------------------------------------------------

def _sets_to_schedule(cd: dict, k: int, stage_sets: list[list[int]]):
    """Realise explicit per-stage local-qubit sets as a physical circuit.

    The counterpart of the reference's ``_local_sets_to_steps``
    (``wenbo_engine/circuit/staging.py:447-519``): per stage, SWAP the
    set's qubits local, then execute every DAG-ready gate whose
    non-insular qubits are local.  Trailing gates the sets failed to
    cover (possible with truncated searches) are finished by extra
    heuristic stages so the schedule is always complete.
    """
    cd = validate_circuit_dict(cd)
    n = cd["number_of_qubits"]
    gates = cd["gates"]
    qm = QubitMap(n)
    per_qubit = _dag_ready_sets(gates)
    next_in_queue = {q: 0 for q in per_qubit}
    out_gates: list[dict] = []
    n_swaps = 0
    pending = list(range(len(gates)))

    def is_ready(i: int) -> bool:
        return all(
            per_qubit[q][next_in_queue[q]] == i for q in gates[i]["qubits"]
        )

    def executable(i: int) -> bool:
        return all(qm.phys(q) < k for q in non_insular_qubits(gates[i]))

    def emit(i: int) -> None:
        g = gates[i]
        entry = {"qubits": [qm.phys(q) for q in g["qubits"]],
                 "gate": g["gate"]}
        if g.get("params"):
            entry["params"] = g["params"]
        out_gates.append(entry)
        for q in g["qubits"]:
            next_in_queue[q] += 1

    def drain() -> None:
        nonlocal pending
        progress = True
        while progress:
            progress = False
            still: list[int] = []
            blocked: set[int] = set()
            for i in pending:
                g = gates[i]
                if (not (set(g["qubits"]) & blocked)
                        and is_ready(i) and executable(i)):
                    emit(i)
                    progress = True
                else:
                    still.append(i)
                    blocked.update(g["qubits"])
            pending = still

    n_stages = 0
    for want in stage_sets:
        if not pending:
            break
        n_stages += 1
        before = len(out_gates)
        _emit_swaps(qm, list(want)[:k], k, out_gates)
        n_swaps += len(out_gates) - before
        drain()

    # Safety net: finish anything the sets didn't cover.
    while pending:
        n_stages += 1
        first = gates[pending[0]]
        required = non_insular_qubits(first) or list(first["qubits"])[:1]
        scores = _score_qubits(gates, pending, LOOKAHEAD_WINDOW,
                               LOOKAHEAD_GAMMA)
        chosen = list(dict.fromkeys(required))[:k]
        for q, _ in sorted(scores.items(), key=lambda kv: -kv[1]):
            if len(chosen) >= k:
                break
            if q not in chosen:
                chosen.append(q)
        before = len(out_gates)
        _emit_swaps(qm, chosen, k, out_gates)
        n_swaps += len(out_gates) - before
        drain()

    out_cd = {"number_of_qubits": n, "gates": out_gates}
    stats = {"stages": n_stages, "swaps": n_swaps, "method": "sets",
             "gates": len(gates)}
    return out_cd, list(qm.log2phys), stats


def _stage_bb(
    cd: dict, k: int, *, cand_extra: int = 4, max_states: int = 4096,
    max_gates: int = 512,
) -> list[list[int]] | None:
    """Minimal-stage search by BFS over execution frontiers.

    A frontier is the per-qubit count of executed gates (downward
    closed under the per-qubit FIFO dependency order).  Each BFS level
    adds one stage: for every frontier, branch over candidate <=k
    local-qubit sets drawn from the next pending gates' non-insular
    demands, executing greedily under each set.  The first level whose
    expansion completes the circuit is the minimum stage count (over
    the candidate family).  Returns the stage sets, or None when the
    instance exceeds the search caps (caller falls back to heuristic).
    """
    from itertools import combinations

    n = cd["number_of_qubits"]
    gates = cd["gates"]
    if len(gates) > max_gates:
        return None
    needs = [non_insular_qubits(g) for g in gates]
    per_qubit = _dag_ready_sets(gates)
    qubit_list = sorted(per_qubit)
    q_index = {q: j for j, q in enumerate(qubit_list)}

    def initial() -> tuple:
        return tuple(0 for _ in qubit_list)

    def pending_of(front: tuple) -> list[int]:
        done = set()
        for j, q in enumerate(qubit_list):
            done.update(per_qubit[q][: front[j]])
        return [i for i in range(len(gates)) if i not in done]

    def advance(front: tuple, local: frozenset) -> tuple:
        heads = list(front)

        def ready(i: int) -> bool:
            return all(
                per_qubit[q][heads[q_index[q]]] == i
                for q in gates[i]["qubits"]
            )

        done = set()
        for j, q in enumerate(qubit_list):
            done.update(per_qubit[q][: heads[j]])
        pend = [i for i in range(len(gates)) if i not in done]
        progress = True
        while progress:
            progress = False
            still = []
            for i in pend:
                if ready(i) and all(q in local for q in needs[i]):
                    for q in gates[i]["qubits"]:
                        heads[q_index[q]] += 1
                    progress = True
                else:
                    still.append(i)
            pend = still
        return tuple(heads)

    goal = tuple(len(per_qubit[q]) for q in qubit_list)

    def candidates(front: tuple) -> list[frozenset]:
        pend = pending_of(front)
        # Useful qubits in demand order over the pending horizon.
        order: list[int] = []
        for i in pend:
            for q in needs[i]:
                if q not in order:
                    order.append(q)
            if len(order) >= k + cand_extra:
                break
        if not order:
            # All remaining gates are fully insular: one stage finishes.
            return [frozenset()]
        pool = order[: k + cand_extra]
        if len(pool) <= k:
            return [frozenset(pool)]
        head_req = frozenset(needs[pend[0]]) if pend else frozenset()
        cands = []
        for combo in combinations(pool, k):
            s = frozenset(combo)
            cands.append(s)
        # Prefer sets covering the head gate first (cheap ordering).
        cands.sort(key=lambda s: (not head_req <= s, sorted(s)))
        return cands[:256]

    frontier = {initial(): []}
    for _depth in range(len(gates) + 1):
        nxt: dict[tuple, list] = {}
        for front, sets in frontier.items():
            for cand in candidates(front):
                new = advance(front, cand)
                if new == front:
                    continue
                if new == goal:
                    return sets + [sorted(cand)]
                if new not in nxt:
                    nxt[new] = sets + [sorted(cand)]
                if len(nxt) > max_states:
                    return None
        if not nxt:
            return None
        frontier = nxt
    return None


# ---------------------------------------------------------------------------
# Final-state permutation
# ---------------------------------------------------------------------------

def _bit_runs(log2phys: list[int]) -> list[tuple[int, int, int]]:
    """Maximal runs of logical bits whose physical bits are consecutive
    and ascending: ``(logical_lo, physical_lo, width)``, in logical
    order.  Each run is one axis of a transpose (a bit field that moves
    as a whole)."""
    runs = []
    q, n = 0, len(log2phys)
    while q < n:
        w = 1
        while q + w < n and log2phys[q + w] == log2phys[q] + w:
            w += 1
        runs.append((q, log2phys[q], w))
        q += w
    return runs


def permute_state(psi: np.ndarray, log2phys: list[int]) -> np.ndarray:
    """Undo the physical layout: return amplitudes in logical qubit order.

    ``psi`` is indexed by physical bits; logical qubit q sits at
    physical bit log2phys[q].  Output index bit q = input bit
    log2phys[q].

    The reference transposes ``(2,) * n`` axes; here each run of bits
    that stays in order (:func:`_bit_runs`) is one axis, so a staged
    n = 33 layout is a transpose of about a dozen axes (numpy before
    2.0 allows at most 32) with the same result.
    """
    n = len(log2phys)
    if log2phys == list(range(n)):
        return psi
    runs = _bit_runs(log2phys)
    # Input axes in C order: the most significant physical field first.
    by_phys = sorted(range(len(runs)), key=lambda i: -runs[i][1])
    axis = {r: a for a, r in enumerate(by_phys)}
    shape = [1 << runs[r][2] for r in by_phys]
    perm = [axis[r] for r in reversed(range(len(runs)))]
    return np.ascontiguousarray(
        np.asarray(psi).reshape(shape).transpose(perm).reshape(-1)
    )


# :func:`permute_state_inplace` walks at most this many blocks in Python,
# each of at least this many amplitudes (else a copy is as cheap).
INPLACE_MAX_BLOCKS = 1 << 20
INPLACE_MIN_BLOCK = 1 << 10


def permute_state_inplace(psi: np.ndarray,
                          log2phys: list[int]) -> np.ndarray:
    """:func:`permute_state` in ``psi``'s own memory, when it can: returns
    the permuted state (``psi`` itself, overwritten) with no second copy
    of the state, which at n = 33 (64 GiB in complex64) a host may not
    hold.

    When the low f bits stay in place (``log2phys[:f] == range(f)``),
    the permutation moves whole blocks of 2^f amplitudes; it is walked
    cycle by cycle through one spare block.  With more than
    ``INPLACE_MAX_BLOCKS`` blocks, or blocks of fewer than
    ``INPLACE_MIN_BLOCK`` amplitudes, it falls back to
    :func:`permute_state` (a new array).  Either way the values equal the
    reference's."""
    n = len(log2phys)
    if log2phys == list(range(n)):
        return psi
    f = 0
    while f < n and log2phys[f] == f:
        f += 1
    nb = 1 << (n - f)
    if (nb > INPLACE_MAX_BLOCKS or (1 << f) < INPLACE_MIN_BLOCK
            or psi.ndim != 1 or not psi.flags.c_contiguous):
        return permute_state(psi, log2phys)
    # out block j = in block src[j]: the block index's own permutation.
    src = permute_state(np.arange(nb), [p - f for p in log2phys[f:]])
    blocks = psi.reshape(nb, 1 << f)
    spare = np.empty(1 << f, dtype=psi.dtype)
    done = src == np.arange(nb)
    for start in range(nb):
        if done[start]:
            continue
        spare[:] = blocks[start]
        j = start
        while True:
            done[j] = True
            k = int(src[j])
            if k == start:
                blocks[j] = spare
                break
            blocks[j] = blocks[k]
            j = k
    return psi


def plan_cost(circuit_dict: dict, k: int,
              bit_costs: list[float] | None = None,
              itemsize: int = 8) -> float:
    """Total (link-cost-weighted) exchange bytes per device of a plan.

    The objective the scheduler optimizes — identical to what
    :func:`staging_stats` reports, so "reported" and "optimized" are
    the same number.  Boundary-SWAP runs are charged at their
    COLLAPSED all_to_all volume (``parallel/reshard``: r disjoint
    boundary SWAPs in a run ship (1 - 2^-r) of the shard once, not r
    half-shards), priced at the most expensive device bit the run
    crosses — matching what the executor actually lowers.
    """
    from ..ops.exchange import exchange_bytes, weighted_exchange_bytes
    from .contract import validate_circuit_dict as _v

    cd = _v(circuit_dict)
    shard_bytes = (1 << k) * itemsize
    total = 0.0
    run_bits: list[int] = []
    run_qubits: set[int] = set()

    def flush_run():
        nonlocal total
        if not run_bits:
            return
        r = len(run_bits)
        vol = shard_bytes - (shard_bytes >> r)
        w = max((bit_costs[b] for b in run_bits), default=1.0) \
            if bit_costs is not None else 1.0
        total += w * vol
        run_bits.clear()
        run_qubits.clear()

    for g in cd["gates"]:
        U = G.gate_matrix(g["gate"], g.get("params") or {})
        qs = tuple(g["qubits"])
        is_boundary_swap = (
            g["gate"] == "SWAP" and len(qs) == 2
            and min(qs) < k <= max(qs)
            and not (set(qs) & run_qubits)
        )
        if is_boundary_swap:
            run_bits.append(max(qs) - k)
            run_qubits.update(qs)
            continue
        if any(q in run_qubits for q in qs) or any(q >= k for q in qs):
            flush_run()
        if bit_costs is not None:
            total += weighted_exchange_bytes(U, qs, k, bit_costs, itemsize)
        else:
            total += exchange_bytes(U, qs, k, itemsize)
    flush_run()
    return total


def choose_staging(
    circuit_dict: dict, k: int,
    *, bit_costs: list[float] | None = None,
    methods: tuple = ("heuristic", "greedy", "ilp"),
    itemsize: int = 8,
) -> tuple[dict, list[int] | None, dict]:
    """Pick the cheapest plan by the weighted-bytes objective.

    Candidates: the UNSTAGED circuit plus each staging method, each
    realized both cost-blind and cost-aware (when ``bit_costs`` is
    given).  The winner minimizes :func:`plan_cost` — the scheduler
    optimizes exactly the objective it reports, the way the reference's
    ILP optimizes the stage objective it executes
    (``wenbo_engine/circuit/staging.py:176-315``), but with the
    mesh-aware cost (SURVEY §7 hard part).

    Returns ``(plan_cd, log2phys_or_None, stats)`` — log2phys is None
    when the unstaged circuit wins.
    """
    cd = validate_circuit_dict(circuit_dict)
    cands: list[tuple[float, dict, list[int] | None, dict]] = []
    base = plan_cost(cd, k, bit_costs, itemsize)
    cands.append((base, cd, None, {"method": "unstaged"}))
    for m in methods:
        variants = [(None, 0.0)]
        if bit_costs is not None and m in ("heuristic", "greedy"):
            variants.append((bit_costs, 0.15))
        for bc, lam in variants:
            try:
                staged, l2p, st = stage_circuit(
                    cd, k, m, bit_costs=bc, cost_weight=lam)
            except Exception:
                continue
            c = plan_cost(staged, k, bit_costs, itemsize)
            st = dict(st, cost_aware=bc is not None)
            cands.append((c, staged, l2p, st))
    cands.sort(key=lambda t: t[0])
    cost, plan, l2p, st = cands[0]
    st = dict(st, plan_cost=cost, unstaged_cost=base)
    return plan, l2p, st


def staging_stats(
    circuit_dict: dict, k: int, method: str = "heuristic",
    *, bit_costs: list[float] | None = None, itemsize: int = 8,
) -> dict:
    """Exchange accounting with and without staging.

    Counts ppermute rounds AND bytes shipped per device; with
    ``bit_costs`` (``parallel.distributed.device_bit_costs``) bytes
    are weighted by the link each offset crosses (ICI vs DCN on a
    pod mesh) — the mesh-aware transition cost of SURVEY §6.
    """
    from ..ops.exchange import (
        exchange_bytes, exchange_cost, weighted_exchange_bytes,
    )
    from .contract import validate_circuit_dict as _v

    cd = _v(circuit_dict)

    def cost(c):
        rounds, bts, wbts = 0, 0.0, 0.0
        for g in c["gates"]:
            U = G.gate_matrix(g["gate"], g.get("params") or {})
            qs = tuple(g["qubits"])
            rounds += exchange_cost(U, qs, k)
            bts += exchange_bytes(U, qs, k, itemsize)
            if bit_costs is not None:
                wbts += weighted_exchange_bytes(U, qs, k, bit_costs, itemsize)
        return rounds, bts, wbts

    r0, b0, w0 = cost(cd)
    staged, _, st = stage_circuit(cd, k, method)
    r1, b1, w1 = cost(staged)
    out = {
        **st,
        "exchanges_unstaged": r0,
        "exchanges_staged": r1,
        "bytes_unstaged": int(b0),
        "bytes_staged": int(b1),
    }
    if bit_costs is not None:
        out["weighted_bytes_unstaged"] = round(w0, 1)
        out["weighted_bytes_staged"] = round(w1, 1)
    return out
