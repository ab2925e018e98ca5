"""The comparison that decides ``correct``.

Once the window has closed, the reference (``reference/statevector``,
complex128) works out again what the timed requests returned, from
their circuit dicts:

* ``state_err``: ||psi - psi_ref||_2 of the final state of the last
  request of the window, as the port handed it to the readout;
* the request kind's own number (``kinds/<kind>.py``'s ``NUMBER``): the
  largest ``error`` over the answers compared, such as ``z_err`` =
  |<Z_S> - <Z_S>_ref|, ``energy_err`` = |E - E_ref| or ``sample_z``.

Where every request runs one circuit the reference runs it once and
every answer is compared.  Where each request has its own circuit it
runs the last request's and ``requests - 1`` more drawn from the seed.
A check with ``"answers": "light_cone"`` runs the whole state only for
those (``state_err``) and holds every answer of the window to its
light cone instead (``reference/lightcone``, the kind's ``cone_error``).
Each number has its limit in ``checks/<workload>.json``; a request that
raised, or a window with none, is not correct.

A configuration with ``"reference": {"kind": "cut", "cut": c}`` is held
to ``reference/cut`` instead (:func:`compare_cut`), whose tensors are
never as large as the state: ``state_err`` a chunk of 2^24 amplitudes at
a time against the captured state, a tensor or planes (``.re`` /
``.im``), and the kind's number by its ``cut_error``.  Every other
configuration is held to the full state as above.
"""
from __future__ import annotations

import math

import torch

from . import kinds
from . import stream as st
from .reference import cut as cr
from .reference import statevector as sv


def state_err(psi: torch.Tensor, ref: torch.Tensor,
              chunk: int = 1 << 24) -> float:
    """||psi - ref||_2, the port's state widened to the reference's type,
    a chunk at a time."""
    psi = psi.reshape(-1)
    acc = torch.zeros((), dtype=torch.float64, device=ref.device)
    for s in range(0, ref.numel(), chunk):
        d = ref[s:s + chunk] - psi[s:s + chunk].to(ref.device, ref.dtype)
        acc += d.abs().square().sum()
    return math.sqrt(float(acc))


def chosen(records, new_instance: bool, requests: int, seed: int) -> list:
    """The records whose circuits the reference runs: the last completed,
    then (one circuit per request) ``requests - 1`` others drawn from the
    seed."""
    done = [r for r in records if r.answer is not None]
    if not done:
        return []
    if not new_instance:
        return done
    rest = done[:-1]
    k = min(requests - 1, len(rest))
    picks = st.check_rng(seed).choice(len(rest), k, replace=False)
    return [rest[i] for i in sorted(picks)] + [done[-1]]


def reference_cut(config: dict) -> int | None:
    """The cut a configuration's ``reference`` names, else None (the
    full-state reference)."""
    ref = config.get("reference")
    if ref is None:
        return None
    if ref.get("kind") != "cut":
        raise ValueError(f"unknown reference {ref!r}")
    return int(ref["cut"])


def state_err_cut(state, ref: cr.CutReference, chunk: int = 1 << 24) -> float:
    """||psi - ref||_2 against the cut reference's amplitudes, a chunk at a
    time with float64 sums; ``state`` a tensor or planes (``.re``/``.im``)."""
    planes = hasattr(state, "re")
    flat = None if planes else state.reshape(-1)
    acc = torch.zeros((), dtype=torch.float64, device=ref.device)
    for s, amps in ref.chunks(chunk):
        e = s + amps.numel()
        if planes:
            got = torch.complex(state.re[s:e].to(ref.device, torch.float64),
                                state.im[s:e].to(ref.device, torch.float64))
        else:
            got = flat[s:e].to(ref.device, amps.dtype)
        acc += (amps - got).abs().square().sum()
    return math.sqrt(float(acc))


def compare(kind, records, last_state, config: dict, traffic: dict,
            check: dict, seed: int, device) -> dict:
    """{name: value} of every number the cell compares; ``kind`` is the
    request kind's module."""
    if reference_cut(config) is not None:
        return compare_cut(kind, records, last_state, config, traffic,
                           check, seed, device)
    n = config["params"]["n"]
    out = {"state_err": math.inf}
    worst = 0.0
    cone = check.get("answers") == "light_cone"
    recs = chosen(records, traffic.get("new_instance", False),
                  check.get("requests", 1), seed)
    by_circuit: dict[int, list] = {}
    for r in recs:
        by_circuit.setdefault(id(r.request.circuit), []).append(r)
    last = recs[-1] if recs else None
    for group in by_circuit.values():
        ref = sv.simulate(group[0].request.circuit, device)
        if last in group and last_state is not None:
            out["state_err"] = state_err(last_state, ref)
        if cone:
            del ref
            continue
        probs = sv.probabilities(ref)
        del ref
        for r in group:
            worst = max(worst, kind.error(r.answer, r.request, probs, n,
                                          config))
        del probs
    if cone:
        worst = max((kind.cone_error(r.answer, r.request, device)
                     for r in records if r.answer is not None), default=0.0)
    out[kind.NUMBER] = worst if recs else math.inf
    return out


def compare_cut(kind, records, last_state, config: dict, traffic: dict,
                check: dict, seed: int, device) -> dict:
    """:func:`compare` against ``reference/cut``: the same records, each
    circuit's halves instead of its state."""
    error = kinds.cut_fn(kind, "cut_error")
    out = {"state_err": math.inf}
    worst = 0.0
    recs = chosen(records, traffic.get("new_instance", False),
                  check.get("requests", 1), seed)
    by_circuit: dict[int, list] = {}
    for r in recs:
        by_circuit.setdefault(id(r.request.circuit), []).append(r)
    last = recs[-1] if recs else None
    for group in by_circuit.values():
        ref = cr.CutReference(group[0].request.circuit, reference_cut(config),
                              device)
        if last in group and last_state is not None:
            out["state_err"] = state_err_cut(last_state, ref)
        for r in group:
            worst = max(worst, error(r.answer, r.request, ref))
        del ref
    out[kind.NUMBER] = worst if recs else math.inf
    return out


def verdict(numbers: dict, limits: dict, attempted: int, failed: int):
    """(correct, [(name, value, limit)]) with every number beside its limit."""
    rows = [(k, numbers.get(k, math.inf), limits[k]) for k in sorted(limits)]
    ok = (attempted > 0 and failed == 0
          and all(math.isfinite(v) and v <= lim for _, v, lim in rows))
    return ok, rows
