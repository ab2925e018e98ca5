"""OpenQASM 2.0 frontend -> circuit dict (a copy of
``quantum_simulations_tpu/circuit/import_qasm.py``, which imports
nothing of JAX; the port keeps its own copy, so the CLI reads ``.qasm``).

Capability parity with the reference's QASM path
(``hisvsim_repo/qasm_assembler_standalone.py``: a standalone parser
feeding its C++ engine; QASMBench corpus).  This is an independent
recursive parser for the OpenQASM 2.0 subset those benchmarks use:

* ``qreg``/``creg`` declarations (multiple qregs are concatenated in
  declaration order, little-endian within each register),
* built-in gates (qelib1): h x y z s t sdg tdg sx rx ry rz p u1 u2 u3 u
  id, cx cy cz swap ch crx cry crz cp cu1 rxx ryy rzz, ccx ccz cswap,
* ``gate`` definitions (custom gates are inlined recursively),
* constant parameter expressions (pi arithmetic: + - * / ( ) unary),
* ``barrier`` and ``measure`` are skipped (statevector semantics),
  ``reset``/``if`` raise — unless ``nonunitary="trajectory"`` is
  passed, in which case ``reset``/``measure``/``if(creg==val)`` are
  emitted as trajectory-tier instructions (RESET / MEASURE / ``cond``;
  the JAX package's ``runtime/trajectory.py`` runs them, the port's
  ``api`` raises ``NotImplementedError`` for that tier so far).  The
  reference's QASM driver silently DROPS reset
  (``qasm_assembler_standalone.py:525``) and cannot parse ``if`` at all.
"""
from __future__ import annotations

import ast
import math
import re

_GATE_MAP_0 = {
    "h": "H", "x": "X", "y": "Y", "z": "Z", "s": "S", "t": "T",
    "sdg": "SDG", "tdg": "TDG", "sx": "SX",
    "cx": "CNOT", "cy": "CY", "cz": "CZ", "swap": "SWAP",
    "ccx": "CCX", "ccz": "CCZ", "cswap": "CSWAP",
}
_GATE_MAP_1 = {  # one angle param
    "rx": ("RX", "theta"), "ry": ("RY", "theta"), "rz": ("RZ", "theta"),
    "p": ("P", "phi"), "u1": ("P", "phi"),
    "cp": ("CP", "phi"), "cu1": ("CP", "phi"),
    "crx": ("CRX", "theta"), "cry": ("CRY", "theta"), "crz": ("CRZ", "theta"),
    "rxx": ("RXX", "theta"), "ryy": ("RYY", "theta"), "rzz": ("RZZ", "theta"),
}

_TOKEN_STRIP = re.compile(r"//.*?$|/\*.*?\*/", re.S | re.M)


class QasmError(ValueError):
    pass


def _eval_expr(expr: str, bindings: dict[str, float]) -> float:
    """Safely evaluate a constant angle expression (pi arithmetic)."""
    node = ast.parse(expr, mode="eval")

    def ev(n):
        if isinstance(n, ast.Expression):
            return ev(n.body)
        if isinstance(n, ast.Constant) and isinstance(n.value, (int, float)):
            return float(n.value)
        if isinstance(n, ast.Name):
            if n.id == "pi":
                return math.pi
            if n.id in bindings:
                return bindings[n.id]
            raise QasmError(f"unknown symbol {n.id!r}")
        if isinstance(n, ast.BinOp):
            ops = {ast.Add: lambda a, b: a + b, ast.Sub: lambda a, b: a - b,
                   ast.Mult: lambda a, b: a * b, ast.Div: lambda a, b: a / b,
                   ast.Pow: lambda a, b: a ** b}
            fn = ops.get(type(n.op))
            if fn is None:
                raise QasmError("unsupported operator")
            return fn(ev(n.left), ev(n.right))
        if isinstance(n, ast.UnaryOp):
            v = ev(n.operand)
            if isinstance(n.op, ast.USub):
                return -v
            if isinstance(n.op, ast.UAdd):
                return v
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Name):
            fns = {"sin": math.sin, "cos": math.cos, "tan": math.tan,
                   "exp": math.exp, "ln": math.log, "sqrt": math.sqrt}
            if n.func.id in fns and len(n.args) == 1:
                return fns[n.func.id](ev(n.args[0]))
        raise QasmError(f"unsupported expression: {expr!r}")

    return ev(node)


def _split_statements(src: str) -> list[str]:
    """Statements, with gate-definition bodies kept as single units."""
    src = _TOKEN_STRIP.sub("", src)
    stmts: list[str] = []
    buf: list[str] = []
    depth = 0
    for ch in src:
        if ch == "{":
            depth += 1
            buf.append(ch)
        elif ch == "}":
            depth -= 1
            buf.append(ch)
            if depth == 0:
                stmts.append("".join(buf).strip())
                buf = []
        elif ch == ";" and depth == 0:
            s = "".join(buf).strip()
            if s:
                stmts.append(s)
            buf = []
        else:
            buf.append(ch)
    tail = "".join(buf).strip()
    if tail:
        stmts.append(tail)
    return [s for s in stmts if s]


_QREG = re.compile(r"^qreg\s+(\w+)\s*\[\s*(\d+)\s*\]$")
_CREG = re.compile(r"^creg\s+(\w+)\s*\[\s*(\d+)\s*\]$")
_GATEDEF = re.compile(
    r"^gate\s+(\w+)\s*(?:\(([^)]*)\))?\s*([\w\s,]+?)\s*\{(.*)\}$", re.S
)
_APPLY = re.compile(r"^(\w+)\s*(?:\(([^)]*)\))?\s+(.+)$", re.S)
_OPERAND = re.compile(r"^(\w+)(?:\[\s*(\d+)\s*\])?$")


def _split_args(s: str) -> list[str]:
    """Split on top-level commas (parentheses-aware)."""
    out, buf, depth = [], [], 0
    for ch in s:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        if ch == "," and depth == 0:
            out.append("".join(buf).strip())
            buf = []
        else:
            buf.append(ch)
    tail = "".join(buf).strip()
    if tail:
        out.append(tail)
    return out


_MEASURE = re.compile(
    r"^measure\s+(\w+)(?:\[\s*(\d+)\s*\])?\s*->\s*(\w+)(?:\[\s*(\d+)\s*\])?$")
_IF = re.compile(r"^if\s*\(\s*(\w+)\s*==\s*(\d+)\s*\)\s*(.+)$", re.S)


def qasm_to_dict(src: str, *, nonunitary: str = "error") -> dict:
    """Parse OpenQASM 2.0 source into a circuit dict.

    ``nonunitary``: ``"error"`` (default) raises on reset/if and skips
    measure; ``"trajectory"`` emits RESET/MEASURE instructions and
    ``cond`` gate annotations for the trajectory tier.
    """
    if nonunitary not in ("error", "trajectory"):
        raise ValueError(f"nonunitary must be 'error' or 'trajectory', "
                         f"got {nonunitary!r}")
    trajectory = nonunitary == "trajectory"
    stmts = _split_statements(src)
    qregs: dict[str, tuple[int, int]] = {}  # name -> (offset, size)
    cregs: dict[str, int] = {}  # name -> size
    n_total = 0
    gates_out: list[dict] = []
    custom: dict[str, dict] = {}
    cond_ctx: dict | None = None  # active if(creg==val) condition

    def resolve_operand(tok: str, subst: dict[str, int] | None):
        tok = tok.strip()
        m = _OPERAND.match(tok)
        if not m:
            raise QasmError(f"bad operand {tok!r}")
        name, idx = m.group(1), m.group(2)
        if subst is not None and name in subst and idx is None:
            return [subst[name]]
        if name not in qregs:
            raise QasmError(f"unknown register {name!r}")
        off, size = qregs[name]
        if idx is None:
            return list(range(off, off + size))  # broadcast over register
        i = int(idx)
        if i >= size:
            raise QasmError(f"index {i} out of range for {name}[{size}]")
        return [off + i]

    def emit(name: str, params_src: str | None, operand_toks: list[str],
             bindings: dict[str, float], subst: dict[str, int] | None):
        lname = name.lower()
        args = _split_args(params_src) if params_src else []
        vals = [_eval_expr(a, bindings) for a in args]

        if lname in custom:
            _expand_custom(lname, vals, operand_toks, subst)
            return
        # Resolve operands (with register broadcast for 1q gates).
        resolved = [resolve_operand(t, subst) for t in operand_toks]
        if lname in ("barrier",):
            return
        if lname == "id" or lname == "u0":
            return
        lengths = {len(r) for r in resolved}
        if len(resolved) > 1 and lengths == {1}:
            combos = [[r[0] for r in resolved]]
        elif len(resolved) == 1:
            combos = [[q] for q in resolved[0]]
        else:
            sizes = [len(r) for r in resolved]
            # OpenQASM requires all broadcast (multi-element) operands
            # to have equal length; scalars broadcast against them.
            multi = {s for s in sizes if s > 1}
            if len(multi) > 1:
                raise QasmError(
                    f"{name}: mismatched register widths {sorted(multi)} "
                    "in broadcast statement"
                )
            width = max(sizes)
            combos = []
            for i in range(width):
                combos.append([r[i] if len(r) > 1 else r[0] for r in resolved])

        for qubits in combos:
            if lname in _GATE_MAP_0:
                gd = {"qubits": qubits, "gate": _GATE_MAP_0[lname]}
            elif lname in _GATE_MAP_1:
                gname, pname = _GATE_MAP_1[lname]
                gd = {"qubits": qubits, "gate": gname,
                      "params": {pname: vals[0]}}
            elif lname in ("u3", "u"):
                gd = {"qubits": qubits, "gate": "U", "params": {
                    "theta": vals[0], "phi": vals[1], "lam": vals[2]}}
            elif lname == "u2":
                gd = {"qubits": qubits, "gate": "U2", "params": {
                    "phi": vals[0], "lam": vals[1]}}
            elif lname == "ch":
                # controlled-H via CU.
                s2 = 1 / math.sqrt(2)
                gd = {"qubits": qubits, "gate": "CU", "params": {
                    "U": [[s2, s2], [s2, -s2]], "exponent": 1}}
            elif lname == "reset" and trajectory:
                gd = {"qubits": qubits, "gate": "RESET"}
            else:
                raise QasmError(f"unsupported gate {name!r}")
            if cond_ctx is not None:
                gd = {**gd, "cond": dict(cond_ctx)}
            gates_out.append(gd)

    def _expand_custom(lname, vals, operand_toks, outer_subst):
        d = custom[lname]
        if len(operand_toks) != len(d["qubits"]):
            raise QasmError(f"{lname}: arity mismatch")
        qmap: dict[str, int] = {}
        for formal, actual in zip(d["qubits"], operand_toks):
            r = resolve_operand(actual, outer_subst)
            if len(r) != 1:
                raise QasmError("register broadcast into custom gate")
            qmap[formal] = r[0]
        bindings = dict(zip(d["params"], vals))
        for st in d["body"]:
            m = _APPLY.match(st)
            if not m:
                raise QasmError(f"bad statement in gate body: {st!r}")
            emit(m.group(1), m.group(2),
                 _split_args(m.group(3)), bindings, qmap)

    def emit_measure(st: str):
        m = _MEASURE.match(st)
        if not m:
            raise QasmError(f"cannot parse measure: {st!r}")
        qname, qidx, cname, cidx = m.groups()
        if cname not in cregs:
            raise QasmError(f"unknown classical register {cname!r}")
        qs = resolve_operand(qname if qidx is None else f"{qname}[{qidx}]",
                             None)
        if cidx is None:
            cbits = list(range(len(qs))) if len(qs) > 1 else [0]
            if len(qs) > cregs[cname]:
                raise QasmError(f"measure: {cname} too small")
        else:
            cbits = [int(cidx)]
            if len(qs) != 1:
                raise QasmError("measure: register -> single bit")
            if cbits[0] >= cregs[cname]:
                raise QasmError(f"measure: bit {cbits[0]} out of range "
                                f"for {cname}[{cregs[cname]}]")
        for q, cb in zip(qs, cbits):
            gates_out.append({"qubits": [q], "gate": "MEASURE",
                              "params": {"creg": cname, "cbit": cb}})

    for st in stmts:
        low = st.lower()
        if low.startswith("openqasm") or low.startswith("include"):
            continue
        m = _QREG.match(st)
        if m:
            qregs[m.group(1)] = (n_total, int(m.group(2)))
            n_total += int(m.group(2))
            continue
        m = _CREG.match(st)
        if m:
            cregs[m.group(1)] = int(m.group(2))
            continue
        m = _GATEDEF.match(st)
        if m:
            name, params, qargs, body = m.groups()
            custom[name.lower()] = {
                "params": [p.strip() for p in _split_args(params)] if params else [],
                "qubits": [q.strip() for q in qargs.split(",")],
                "body": _split_statements(body),
            }
            continue
        if low.startswith("barrier"):
            continue
        if low.startswith("measure"):
            if trajectory:
                emit_measure(st)
            continue
        if low.startswith("if"):
            if not trajectory:
                raise QasmError(f"unsupported statement: {st!r}")
            m = _IF.match(st)
            if not m:
                raise QasmError(f"cannot parse if-statement: {st!r}")
            cname, val, inner = m.groups()
            if cname not in cregs:
                raise QasmError(f"unknown classical register {cname!r}")
            inner = inner.strip()
            if inner.lower().startswith("measure"):
                raise QasmError("conditional measure is not supported")
            mi = _APPLY.match(inner)
            if not mi:
                raise QasmError(f"cannot parse conditional body: {inner!r}")
            cond_ctx = {"creg": cname, "value": int(val)}
            try:
                emit(mi.group(1), mi.group(2), _split_args(mi.group(3)),
                     {}, None)
            finally:
                cond_ctx = None
            continue
        if low.startswith("reset") and not trajectory:
            raise QasmError(f"unsupported statement: {st!r}")
        m = _APPLY.match(st)
        if m:
            emit(m.group(1), m.group(2), _split_args(m.group(3)), {}, None)
            continue
        raise QasmError(f"cannot parse statement: {st!r}")

    if n_total == 0:
        raise QasmError("no qreg declared")
    return {"number_of_qubits": n_total, "gates": gates_out}


def load_qasm(path, *, nonunitary: str = "error") -> dict:
    with open(path) as f:
        return qasm_to_dict(f.read(), nonunitary=nonunitary)
