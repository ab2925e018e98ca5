"""Request kinds: how one request calls the port, how the control answers
it in the port's place, and how its answer is held to the reference.

A traffic mix's ``kind`` names a module here, ``kinds/<kind>.py``, found
by that name.  Each defines:

* ``NUMBER``: the name of the number the check compares (``checks/``);
* ``draw(stream, rng)``: the request's arguments, drawn from the seed
  (``stream`` has the configuration, the traffic's parameters, ``n`` and
  the MaxCut ``edges``);
* ``call(port, req, cfg, spanning)``: the request as a user makes it
  through ``systems.Port``; its answer on the host;
* ``control(ctl, req, cfg, spanning)``: the same answer from
  ``systems.Control``, the reference with TF32 products;
* ``error(answer, req, probs, n, config)``: the answer's distance from
  the reference, whose probabilities ``probs`` are of the request's
  circuit.

A kind may also define, for a configuration held to the cut reference
(``reference/cut``, which never holds the state):

* ``cut_control(ctl, req, cfg, spanning)``: the control's answer from
  its TF32 halves (``ctl.halves()``), after ``ctl.run``;
* ``cut_error(answer, req, ref)``: the answer's distance from the
  ``CutReference`` of the request's circuit.

and, for a check that holds every answer to its light cone
(``"answers": "light_cone"``, ``reference/lightcone``):

* ``cone_error(answer, req, device)``: the answer's distance from the
  reference worked out on the light cone of what it reads.

Each request's final state goes through ``system.run`` (``port.run`` or
``ctl.run``), where ``systems.Capture`` sees it.
"""
from __future__ import annotations

import importlib

REQUIRED = ("NUMBER", "draw", "call", "control", "error")


def load(name: str):
    """The module ``kinds/<name>.py``."""
    if not name.isidentifier():
        raise ValueError(f"unknown request kind {name!r}")
    try:
        mod = importlib.import_module(f"{__name__}.{name}")
    except ModuleNotFoundError as e:
        raise ValueError(f"unknown request kind {name!r}") from e
    missing = [k for k in REQUIRED if not hasattr(mod, k)]
    if missing:
        raise ValueError(f"request kind {name!r} lacks {missing}")
    return mod


def cut_fn(kind, name: str):
    """The kind's ``cut_control`` or ``cut_error``; a clear error for a
    kind that has none yet."""
    fn = getattr(kind, name, None)
    if fn is None:
        raise NotImplementedError(
            f"request kind {kind.__name__.rsplit('.', 1)[-1]!r} has no cut "
            f"reference yet (no {name})")
    return fn
