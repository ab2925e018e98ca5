"""Standard circuit generators.

Covers the reference's fixture/benchmark families
(``v1_implementation/src/circuits.py``, ``wenbo_engine/tests/fixtures``)
plus the BASELINE configs: GHZ, W, QFT, inverse QFT, QPE, Hadamard
wall, GHZ+QFT composites, random non-stabilizer circuits, QAOA MaxCut
(RZZ/RX Trotter layers), and a Sycamore-style random circuit for
sampling benchmarks.

All builders return plain circuit dicts (the shared contract).
A copy of ``quantum_simulations_tpu/circuit/library.py``: the port
imports nothing of the JAX package.
"""
from __future__ import annotations

import math
import random as _random

import numpy as np


def _c(n: int, gates: list[dict]) -> dict:
    return {"number_of_qubits": n, "gates": gates}


def _g(name: str, qubits: list[int], params: dict | None = None) -> dict:
    out: dict = {"qubits": qubits, "gate": name}
    if params:
        out["params"] = params
    return out


# ---------------------------------------------------------------------------
# Fixtures
# ---------------------------------------------------------------------------

def bell() -> dict:
    return _c(2, [_g("H", [0]), _g("CNOT", [0, 1])])


def ghz(n: int) -> dict:
    gates = [_g("H", [0])] + [_g("CNOT", [i, i + 1]) for i in range(n - 1)]
    return _c(n, gates)


def w_state(n: int) -> dict:
    """W state via cascaded G(p) rotations + CNOTs (reference family).

    |W_n> = (|10...0> + |010...0> + ... + |0...01>) / sqrt(n).
    Construction: X on q0, then for each step a controlled-G rotation
    realised as G + CNOT pairs (standard linear W preparation).
    """
    gates = [_g("X", [0])]
    for i in range(1, n):
        p = n - i + 1
        # Controlled-G(p) from qubit i-1 to i, then CNOT back.
        gates.append(_g("CU", [i - 1, i], {
            "U": _g_matrix_entries(p), "exponent": 1,
        }))
        gates.append(_g("CNOT", [i, i - 1]))
    return _c(n, gates)


def _g_matrix_entries(p: int) -> list[list[float]]:
    a = math.sqrt(1.0 / p)
    b = math.sqrt(1.0 - 1.0 / p)
    return [[a, -b], [b, a]]


def hadamard_wall(n: int) -> dict:
    return _c(n, [_g("H", [i]) for i in range(n)])


def qft(n: int) -> dict:
    """Textbook QFT: H + controlled binary phases CR(k), then SWAPs."""
    gates: list[dict] = []
    for i in range(n - 1, -1, -1):
        gates.append(_g("H", [i]))
        for j in range(i - 1, -1, -1):
            gates.append(_g(f"CR{i - j + 1}", [j, i]))
    for i in range(n // 2):
        gates.append(_g("SWAP", [i, n - 1 - i]))
    return _c(n, gates)


def ghz_qft(n: int) -> dict:
    g1, g2 = ghz(n), qft(n)
    return _c(n, g1["gates"] + g2["gates"])


def w_qft(n: int) -> dict:
    """W preparation followed by QFT (v1 family,
    ``v1_implementation/src/circuits.py:69``)."""
    return _c(n, w_state(n)["gates"] + qft(n)["gates"])


def ghz_proned(n: int, depth: int) -> dict:
    """Depth-truncated alternating GHZ cascades (v1 family,
    ``v1_implementation/src/circuits.py:81``): repeat the GHZ ladder,
    flipping its qubit order each pass, and cut at ``depth`` gates —
    a fixed-length entangling workload for depth sweeps."""
    gates: list[dict] = []
    flip = False
    while len(gates) < depth:
        ladder = ghz(n)["gates"]
        if flip:
            ladder = [{**g, "qubits": [n - 1 - q for q in g["qubits"]]}
                      for g in ladder]
        gates.extend(ladder)
        flip = not flip
    return _c(n, gates[:depth])


def qpe(n_counting: int, theta: float | None = None) -> dict:
    """Quantum phase estimation on a phase gate with eigenphase theta.

    Register layout: counting qubits 0..n_counting-1, eigenstate qubit
    n_counting (prepared in |1>).  Uses CU with U = P(2*pi*theta) and
    exponents 2^j, followed by the inverse QFT on the counting register.
    """
    n = n_counting + 1
    if theta is None:
        theta = 1.0 / 8.0
    phase = 2.0 * math.pi * theta
    u_entries = [[1.0, 0.0], [0.0, complex(math.cos(phase), math.sin(phase))]]
    gates: list[dict] = [_g("X", [n_counting])]
    for q in range(n_counting):
        gates.append(_g("H", [q]))
    for j in range(n_counting):
        gates.append(_g("CU", [j, n_counting], {"U": u_entries, "exponent": 1 << j}))
    gates.extend(_inverse_qft_gates(n_counting))
    return _c(n, gates)


def _inverse_qft_gates(n: int) -> list[dict]:
    fwd = qft(n)["gates"]
    inv: list[dict] = []
    for g in reversed(fwd):
        name = g["gate"]
        if name == "H" or name == "SWAP":
            inv.append(dict(g))
        elif name.startswith("CR"):
            k = int(name[2:])
            # inverse of phase 2pi/2^k is phase -2pi/2^k = CP(-2pi/2^k)
            inv.append(_g("CP", g["qubits"], {"phi": -2.0 * math.pi / (1 << k)}))
        else:
            raise AssertionError(f"unexpected gate in QFT: {name}")
    return inv


def random_circuit(
    n: int,
    n_gates: int,
    seed: int = 0,
    *,
    gate_pool: tuple[str, ...] = (
        "H", "X", "Y", "Z", "S", "T", "RY", "CNOT", "CZ", "SWAP", "CR",
    ),
) -> dict:
    """Random non-stabilizer circuit over the core gate set."""
    rng = _random.Random(seed)
    gates: list[dict] = []
    for _ in range(n_gates):
        name = rng.choice(gate_pool)
        if name in ("CNOT", "CZ", "SWAP", "CY"):
            qa, qb = rng.sample(range(n), 2)
            gates.append(_g(name, [qa, qb]))
        elif name == "CR":
            qa, qb = rng.sample(range(n), 2)
            gates.append(_g("CR", [qa, qb], {"k": rng.randint(1, 5)}))
        elif name == "RY":
            gates.append(_g("RY", [rng.randrange(n)],
                           {"theta": rng.uniform(0, 2 * math.pi)}))
        else:
            gates.append(_g(name, [rng.randrange(n)]))
    return _c(n, gates)


def non_stabilizer(n: int, depth: int = 4, seed: int = 7) -> dict:
    """H+T+CNOT layers (the reference's scaling-benchmark family)."""
    rng = _random.Random(seed)
    gates: list[dict] = []
    for _ in range(depth):
        for q in range(n):
            gates.append(_g("H", [q]))
            if rng.random() < 0.5:
                gates.append(_g("T", [q]))
        order = list(range(n - 1))
        rng.shuffle(order)
        for q in order[: n // 2]:
            gates.append(_g("CNOT", [q, q + 1]))
    return _c(n, gates)


# ---------------------------------------------------------------------------
# BASELINE workload configs
# ---------------------------------------------------------------------------

def qaoa_maxcut(n: int, p: int = 2, seed: int = 3) -> dict:
    """QAOA MaxCut on a random 3-regular-ish graph: RZZ cost + RX mixer layers."""
    rng = _random.Random(seed)
    edges: set[tuple[int, int]] = set()
    for i in range(n):
        for _ in range(2):
            j = rng.randrange(n)
            if i != j:
                edges.add((min(i, j), max(i, j)))
    gates: list[dict] = [_g("H", [q]) for q in range(n)]
    for layer in range(p):
        gamma = rng.uniform(0, math.pi)
        beta = rng.uniform(0, math.pi)
        for (i, j) in sorted(edges):
            gates.append(_g("RZZ", [i, j], {"theta": gamma}))
        for q in range(n):
            gates.append(_g("RX", [q], {"theta": 2 * beta}))
    return _c(n, gates)


def sycamore_like(n: int, depth: int = 8, seed: int = 11) -> dict:
    """Sycamore-style random circuit: random sqrt-gates + brick-pattern CZ.

    Uses sqrt(X), sqrt(Y) (= RY(pi/2) up to phase), and T as the 1Q pool
    and CZ entanglers in an alternating linear brick pattern — dense,
    non-stabilizer, the standard random-circuit-sampling benchmark shape.
    """
    rng = _random.Random(seed)
    gates: list[dict] = []
    last: dict[int, int] = {}
    for d in range(depth):
        for q in range(n):
            choice = rng.randrange(3)
            while last.get(q) == choice:
                choice = rng.randrange(3)
            last[q] = choice
            if choice == 0:
                gates.append(_g("SX", [q]))
            elif choice == 1:
                gates.append(_g("RY", [q], {"theta": math.pi / 2}))
            else:
                gates.append(_g("T", [q]))
        start = d % 2
        for q in range(start, n - 1, 2):
            gates.append(_g("CZ", [q, q + 1]))
    return _c(n, gates)


def bernstein_vazirani(n: int, secret: int | None = None) -> dict:
    """BV oracle circuit on n qubits (data n-1, ancilla = qubit n-1).

    Measuring the data register yields ``secret`` with certainty —
    the matrix runner checks that analytically.  Reference analogue:
    the bv family of the MQT matrix (``bench/mqt_bench_runner.py``).
    """
    if secret is None:
        secret = (1 << (n - 1)) - 1 if n % 2 else 0b101 % (1 << (n - 1))
    a = n - 1
    gates = [_g("X", [a]), _g("H", [a])]
    gates += [_g("H", [q]) for q in range(n - 1)]
    for q in range(n - 1):
        if (secret >> q) & 1:
            gates.append(_g("CNOT", [q, a]))
    gates += [_g("H", [q]) for q in range(n - 1)]
    return _c(n, gates)


def deutsch_jozsa(n: int, balanced: bool = True) -> dict:
    """DJ on n qubits (ancilla = qubit n-1); balanced oracle = parity."""
    a = n - 1
    gates = [_g("X", [a]), _g("H", [a])]
    gates += [_g("H", [q]) for q in range(n - 1)]
    if balanced:
        for q in range(n - 1):
            gates.append(_g("CNOT", [q, a]))
    gates += [_g("H", [q]) for q in range(n - 1)]
    return _c(n, gates)


def graph_state(n: int, seed: int = 5) -> dict:
    """Random graph state: H wall + CZ on each edge."""
    rng = _random.Random(seed)
    gates = [_g("H", [q]) for q in range(n)]
    for qa in range(n):
        for qb in range(qa + 1, n):
            if rng.random() < min(1.0, 3.0 / n):
                gates.append(_g("CZ", [qa, qb]))
    return _c(n, gates)


def hidden_shift(n: int, shift: int | None = None) -> dict:
    """Hidden-shift for the bent function f(x)=prod of CZ pairs.

    The output state is |shift> exactly (n even uses all pairs).
    """
    if shift is None:
        shift = 0b0110 % (1 << n)
    gates = [_g("H", [q]) for q in range(n)]
    gates += [_g("X", [q]) for q in range(n) if (shift >> q) & 1]
    gates += [_g("CZ", [q, q + 1]) for q in range(0, n - 1, 2)]
    gates += [_g("X", [q]) for q in range(n) if (shift >> q) & 1]
    gates += [_g("H", [q]) for q in range(n)]
    gates += [_g("CZ", [q, q + 1]) for q in range(0, n - 1, 2)]
    gates += [_g("H", [q]) for q in range(n)]
    return _c(n, gates)


def grover(n: int, iterations: int | None = None) -> dict:
    """Grover amplification on n qubits (no ancillas).

    The phase oracle is an exact multi-controlled Z for n <= 3
    (Z/CZ/CCZ); for n >= 4 it marks the subspace whose top three bits
    are 1 (one CCZ) — a well-defined amplification benchmark that
    exercises the CCZ/X/H diffuser structure at any size without
    ancilla-based MCX decompositions.
    """
    import math as _m

    if iterations is None:
        k = min(n, 3)  # marked fraction is 2^-min(n,3)
        iterations = max(1, int(_m.pi / 4 * _m.sqrt(2 ** k)))

    def oracle() -> list[dict]:
        if n == 1:
            return [_g("Z", [0])]
        if n == 2:
            return [_g("CZ", [0, 1])]
        return [_g("CCZ", [n - 3, n - 2, n - 1])]

    gates = [_g("H", [q]) for q in range(n)]
    for _ in range(iterations):
        gates += oracle()
        gates += [_g("H", [q]) for q in range(n)]
        gates += [_g("X", [q]) for q in range(n)]
        gates += oracle() if n <= 3 else [_g("CCZ", [n - 3, n - 2, n - 1])]
        gates += [_g("X", [q]) for q in range(n)]
        gates += [_g("H", [q]) for q in range(n)]
    return _c(n, gates)


def trotter_ising(n: int, steps: int = 3, dt: float = 0.15) -> dict:
    """First-order Trotter of the transverse-field Ising chain."""
    gates: list[dict] = []
    for _ in range(steps):
        for q in range(0, n - 1, 2):
            gates.append(_g("RZZ", [q, q + 1], {"theta": 2 * dt}))
        for q in range(1, n - 1, 2):
            gates.append(_g("RZZ", [q, q + 1], {"theta": 2 * dt}))
        for q in range(n):
            gates.append(_g("RX", [q], {"theta": 2 * dt}))
    return _c(n, gates)


def vqe_ansatz(n: int, layers: int = 3, seed: int = 9) -> dict:
    """Hardware-efficient ansatz: RY/RZ walls + CNOT ladders."""
    rng = _random.Random(seed)
    gates: list[dict] = []
    for _ in range(layers):
        for q in range(n):
            gates.append(_g("RY", [q], {"theta": rng.uniform(-1.5, 1.5)}))
            gates.append(_g("RZ", [q], {"theta": rng.uniform(-1.5, 1.5)}))
        for q in range(n - 1):
            gates.append(_g("CNOT", [q, q + 1]))
    for q in range(n):
        gates.append(_g("RY", [q], {"theta": rng.uniform(-1.5, 1.5)}))
    return _c(n, gates)


def qft_adder(n: int, addend: int | None = None) -> dict:
    """Draper QFT adder: |x> -> |x + addend mod 2^n>.

    QFT, per-qubit P rotations encoding the addend, inverse QFT —
    applied to |0> it produces |addend> exactly (matrix-checkable).
    """
    import math as _m

    if addend is None:
        addend = 0b1011 % (1 << n)
    gates = list(qft(n)["gates"])
    for j in range(n):
        theta = 0.0
        for k in range(n - j):
            if (addend >> k) & 1:
                theta += 2 * _m.pi / (1 << (n - j - k))
        theta %= 2 * _m.pi
        if theta:
            gates.append(_g("P", [j], {"phi": theta}))
    gates += _inverse_qft_gates(n)
    return _c(n, gates)


def su2_random(n: int, layers: int = 2, seed: int = 13) -> dict:
    """EfficientSU2-style ansatz: RY+RZ walls, circular CNOT entangler."""
    rng = _random.Random(seed)
    gates: list[dict] = []
    for _ in range(layers):
        for q in range(n):
            gates.append(_g("RY", [q], {"theta": rng.uniform(-3.1, 3.1)}))
            gates.append(_g("RZ", [q], {"theta": rng.uniform(-3.1, 3.1)}))
        for q in range(n):
            gates.append(_g("CNOT", [q, (q + 1) % n]))
    for q in range(n):
        gates.append(_g("RY", [q], {"theta": rng.uniform(-3.1, 3.1)}))
    return _c(n, gates)


def two_local_random(n: int, layers: int = 2, seed: int = 21) -> dict:
    """TwoLocal-style ansatz: RY walls + full CZ entangling blocks."""
    rng = _random.Random(seed)
    gates: list[dict] = []
    for _ in range(layers):
        for q in range(n):
            gates.append(_g("RY", [q], {"theta": rng.uniform(-3.1, 3.1)}))
        for qa in range(n - 1):
            gates.append(_g("CZ", [qa, qa + 1]))
            if qa + 2 < n:
                gates.append(_g("CZ", [qa, qa + 2]))
    for q in range(n):
        gates.append(_g("RY", [q], {"theta": rng.uniform(-3.1, 3.1)}))
    return _c(n, gates)


def portfolio_qaoa(n: int, p: int = 2, seed: int = 17) -> dict:
    """QAOA on a FULLY-CONNECTED RZZ cost (portfolio-optimization style)."""
    rng = _random.Random(seed)
    gates = [_g("H", [q]) for q in range(n)]
    for _ in range(p):
        gamma = rng.uniform(0.1, 1.0)
        for qa in range(n):
            for qb in range(qa + 1, n):
                gates.append(_g("RZZ", [qa, qb],
                               {"theta": gamma * rng.uniform(0.2, 1.0)}))
        beta = rng.uniform(0.1, 1.0)
        for q in range(n):
            gates.append(_g("RX", [q], {"theta": 2 * beta}))
    return _c(n, gates)


def _on(qs: list[int], gates: list[dict]) -> list[dict]:
    """Remap a register-local gate list onto circuit qubits ``qs``."""
    return [{**g, "qubits": [qs[q] for q in g["qubits"]]} for g in gates]


def _ccp_gates(qa: int, qb: int, qt: int, theta: float) -> list[dict]:
    """Doubly-controlled phase exp(i*theta) on |qa=qb=qt=1>, decomposed
    into CP/CNOT (theta/2 ladder): phase theta/2*(a + b - (a^b)) = theta*ab."""
    return [
        _g("CP", [qb, qt], {"phi": theta / 2.0}),
        _g("CNOT", [qa, qb]),
        _g("CP", [qb, qt], {"phi": -theta / 2.0}),
        _g("CNOT", [qa, qb]),
        _g("CP", [qa, qt], {"phi": theta / 2.0}),
    ]


def qpe_inexact(n_counting: int) -> dict:
    """QPE with eigenphase 1/3 — NOT representable in n_counting bits,
    so the output is a concentration (not a delta) around the nearest
    grid values (MQT-Bench's ``qpeinexact`` family,
    ``wenbo_engine/bench/mqt_bench_runner.py:38``)."""
    return qpe(n_counting, theta=1.0 / 3.0)


def amplitude_estimation(n_counting: int, a: float | None = None) -> dict:
    """Canonical QAE (MQT's ``ae``): estimate a = P(good) of a 1-qubit
    state preparation via phase estimation on its Grover operator.

    The target qubit is prepared RY(2*theta), theta = asin(sqrt(a)); the
    Grover iterate is the planar rotation by 2*theta whose eigenphases
    are +-2*theta, driven through the CU gate with exponents 2^j.
    Default a = sin^2(5*pi/16): eigenphase exactly 5/16, so 4 counting
    bits resolve it exactly.
    """
    theta = math.asin(math.sqrt(a)) if a is not None else 5.0 * math.pi / 16.0
    n = n_counting + 1
    c, s = math.cos(2.0 * theta), math.sin(2.0 * theta)
    q_entries = [[c, -s], [s, c]]
    gates: list[dict] = [_g("RY", [n_counting], {"theta": 2.0 * theta})]
    for q in range(n_counting):
        gates.append(_g("H", [q]))
    for j in range(n_counting):
        gates.append(_g("CU", [j, n_counting],
                        {"U": q_entries, "exponent": 1 << j}))
    gates.extend(_inverse_qft_gates(n_counting))
    return _c(n, gates)


def quantum_walk(n: int, steps: int = 3) -> dict:
    """Coined discrete-time quantum walk on a cycle of 2^(n-1) nodes
    (MQT's ``qwalk``).  Coin = qubit 0, position = qubits 1..n-1.

    The conditional +-1 shift is diagonal in the position register's
    Fourier basis, so the whole walk is QFT(pos) . [H(coin) . phases]^t
    . iQFT(pos): per step, CP(+2*pi*2^j/2^m) on each Fourier bit when
    coin=1 (step right) and CP(-...) when coin=0 (step left, via X
    conjugation of the coin).
    """
    m = n - 1
    pos = list(range(1, n))
    gates = _on(pos, qft(m)["gates"])
    for _ in range(steps):
        gates.append(_g("H", [0]))
        for j in range(m):
            phi = 2.0 * math.pi * (1 << j) / (1 << m)
            gates.append(_g("CP", [0, pos[j]], {"phi": phi}))
        gates.append(_g("X", [0]))
        for j in range(m):
            phi = -2.0 * math.pi * (1 << j) / (1 << m)
            gates.append(_g("CP", [0, pos[j]], {"phi": phi}))
        gates.append(_g("X", [0]))
    gates.extend(_on(pos, _inverse_qft_gates(m)))
    return _c(n, gates)


def half_adder() -> dict:
    """1-bit half adder over superposed inputs (MQT's ``half_adder``):
    a=q0, b=q1, sum=q2 (a XOR b via CNOTs), carry=q3 (a AND b via CCX)."""
    gates = [_g("H", [0]), _g("H", [1]),
             _g("CNOT", [0, 2]), _g("CNOT", [1, 2]),
             _g("CCX", [0, 1, 3])]
    return _c(4, gates)


def full_adder() -> dict:
    """1-bit full adder (MQT's ``full_adder``): a=q0, b=q1, cin=q2,
    sum=q3 = a^b^cin, cout=q4 = majority(a,b,cin) = ab ^ ac ^ bc."""
    gates = [_g("H", [q]) for q in range(3)]
    gates += [_g("CNOT", [q, 3]) for q in range(3)]
    gates += [_g("CCX", [0, 1, 4]), _g("CCX", [0, 2, 4]), _g("CCX", [1, 2, 4])]
    return _c(5, gates)


def ripple_adder(n: int, a_val: int | None = None,
                 b_val: int | None = None) -> dict:
    """Cuccaro ripple-carry adder |a>|b> -> |a>|a+b> (MQT's
    ``cdkm_ripple_carry_adder``): m = (n-2)//2 bits per register.

    Layout: cin=q0, a=q1..qm, b=q(m+1)..q2m, cout=q(2m+1).  MAJ chain
    forward (CNOT/CNOT/CCX), carry tap to cout, UMA chain backward.
    Classical operands are X-prepared when given, else superposed by H.
    """
    m = max(1, (n - 2) // 2)
    a = [1 + i for i in range(m)]
    b = [1 + m + i for i in range(m)]
    cin, cout = 0, 2 * m + 1
    gates: list[dict] = []
    for regs, val in ((a, a_val), (b, b_val)):
        for i, q in enumerate(regs):
            if val is None:
                gates.append(_g("H", [q]))
            elif (val >> i) & 1:
                gates.append(_g("X", [q]))
    carries = [cin] + a[:-1]
    for i in range(m):
        gates += [_g("CNOT", [a[i], b[i]]), _g("CNOT", [a[i], carries[i]]),
                  _g("CCX", [carries[i], b[i], a[i]])]
    gates.append(_g("CNOT", [a[m - 1], cout]))
    for i in range(m - 1, -1, -1):
        gates += [_g("CCX", [carries[i], b[i], a[i]]),
                  _g("CNOT", [a[i], carries[i]]),
                  _g("CNOT", [carries[i], b[i]])]
    return _c(n if n >= 2 * m + 2 else 2 * m + 2, gates)


def qft_multiplier(n: int, x_val: int | None = None,
                   y_val: int | None = None) -> dict:
    """Fourier-space multiplier |x>|y>|0> -> |x>|y>|x*y mod 2^mo>
    (MQT's ``rg_qft_multiplier``): each partial product x_i*y_j*2^(i+j)
    is a doubly-controlled phase ladder on the QFT'd output register,
    with CCP decomposed into CP/CNOT.
    """
    mx = max(1, n // 4)
    mo = n - 2 * mx
    x = list(range(mx))
    y = list(range(mx, 2 * mx))
    out = list(range(2 * mx, n))
    gates: list[dict] = []
    for regs, val in ((x, x_val), (y, y_val)):
        for i, q in enumerate(regs):
            if val is None:
                gates.append(_g("H", [q]))
            elif (val >> i) & 1:
                gates.append(_g("X", [q]))
    gates += _on(out, qft(mo)["gates"])
    for i in range(mx):
        for j in range(mx):
            for k in range(mo):
                theta = (2.0 * math.pi * (1 << (i + j)) * (1 << k)
                         / (1 << mo)) % (2.0 * math.pi)
                if theta:
                    gates += _ccp_gates(x[i], y[j], out[k], theta)
    gates += _on(out, _inverse_qft_gates(mo))
    return _c(n, gates)


def qnn(n: int, seed: int = 29) -> dict:
    """QNN-style circuit (MQT's ``qnn``): ZZ feature map (H wall +
    P encodings + CNOT-conjugated pair phases) followed by a
    RealAmplitudes variational block."""
    rng = _random.Random(seed)
    xs = [rng.uniform(0.1, 2.0) for _ in range(n)]
    gates: list[dict] = []
    for rep in range(2):
        for q in range(n):
            gates.append(_g("H", [q]))
            gates.append(_g("P", [q], {"phi": 2.0 * xs[q]}))
        for q in range(n - 1):
            phi = 2.0 * (math.pi - xs[q]) * (math.pi - xs[q + 1])
            gates += [_g("CNOT", [q, q + 1]),
                      _g("P", [q + 1], {"phi": phi % (2.0 * math.pi)}),
                      _g("CNOT", [q, q + 1])]
    for _ in range(2):
        for q in range(n):
            gates.append(_g("RY", [q], {"theta": rng.uniform(-3.1, 3.1)}))
        for q in range(n - 1):
            gates.append(_g("CNOT", [q, q + 1]))
    return _c(n, gates)


def shor15(n_counting: int = 3) -> dict:
    """Order finding for a=7, N=15 — the canonical Shor demo (MQT's
    ``shor``): counting register + 4-qubit work register in |1>,
    controlled mult-by-7^(2^j) mod 15, inverse QFT.

    mult-by-8 mod 15 is a right-rotation of the 4 work bits and
    7 == -8 (mod 15) with 15-y = NOT y, so controlled mult-by-7 is
    3 CSWAPs + 4 CNOTs; 7^2 = 4 is a 2-bit rotation (2 CSWAPs);
    7^(2^j) = 1 for j >= 2 (order r=4 -> exact peaks at s*2^m/4).
    """
    n = n_counting + 4
    w = [n_counting + i for i in range(4)]
    gates: list[dict] = [_g("X", [w[0]])]
    gates += [_g("H", [q]) for q in range(n_counting)]
    for j in range(min(n_counting, 2)):
        c = j
        if j == 0:  # controlled mult by 7 = rot-right-1 then NOT all
            gates += [_g("CSWAP", [c, w[0], w[1]]),
                      _g("CSWAP", [c, w[1], w[2]]),
                      _g("CSWAP", [c, w[2], w[3]])]
            gates += [_g("CNOT", [c, q]) for q in w]
        else:  # controlled mult by 4 = rotate left 2
            gates += [_g("CSWAP", [c, w[0], w[2]]),
                      _g("CSWAP", [c, w[1], w[3]])]
    gates += _inverse_qft_gates(n_counting)
    return _c(n, gates)


FAMILIES = {
    "bell": lambda n=2: bell(),
    "ghz": ghz,
    "w": w_state,
    "qft": qft,
    "ghz_qft": ghz_qft,
    "w_qft": w_qft,
    "ghz_proned": lambda n: ghz_proned(n, 3 * n),
    "qpe": lambda n: qpe(max(n - 1, 1)),
    "hwall": hadamard_wall,
    "random": lambda n: random_circuit(n, 5 * n, seed=1),
    "nonstab": non_stabilizer,
    "qaoa": qaoa_maxcut,
    "sycamore": sycamore_like,
    "bv": bernstein_vazirani,
    "dj": deutsch_jozsa,
    "graph_state": graph_state,
    "hidden_shift": hidden_shift,
    "grover": grover,
    "trotter_ising": trotter_ising,
    "vqe": vqe_ansatz,
    "qft_adder": qft_adder,
    "su2": su2_random,
    "two_local": two_local_random,
    "portfolio_qaoa": portfolio_qaoa,
    "qpe_inexact": lambda n: qpe_inexact(max(n - 1, 1)),
    "ae": lambda n: amplitude_estimation(max(n - 1, 1)),
    "qwalk": lambda n: quantum_walk(n, steps=max(1, (n - 1) // 2)),
    "half_adder": lambda n=4: half_adder(),
    "full_adder": lambda n=5: full_adder(),
    "ripple_adder": ripple_adder,
    "qft_mult": qft_multiplier,
    "qnn": qnn,
    "shor15": lambda n: shor15(max(n - 4, 1)),
}
