"""The one request generator: a traffic mix's parameters and a
configuration, drawn from the seed.

One client runs a closed loop: it sends request i + 1 when request i
has returned, as a user's script or a variational optimiser does (the
next angles depend on the last energy).  Request i is the same for a
given seed however many requests the window completes.  The warm-up
requests come from a stream of their own, so they never change the
window's.

Traffic parameters (``traffic/<name>.json``):

* ``kind``: how one request calls the port, the module
  ``kinds/<kind>.py``, which also draws the request's arguments;
* ``simulator``: the ``SimulatorConfig`` fields the request passes;
* ``new_instance``: whether each request redraws the configuration's
  ``fresh`` parameters (new angles: a new circuit, so a new schedule);
* whatever the kind reads: ``z_weight`` (``expectation_z``), ``shots``
  (``sample``).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from . import circuits, kinds

_WINDOW, _WARM, _CHECK = 0, 1, 2


@dataclasses.dataclass
class Request:
    index: int
    circuit: dict
    args: dict


def rng_for(seed: int, purpose: int) -> np.random.Generator:
    """A generator fixed by ``seed`` (any whole number) and ``purpose``."""
    return np.random.default_rng(
        np.random.SeedSequence(seed % (1 << 64), spawn_key=(purpose,)))


def _draw(spec: dict, rng: np.random.Generator):
    if "uniform" in spec:
        lo, hi = spec["uniform"]
        return [float(x) for x in rng.uniform(lo, hi, spec["size"])]
    if "integers" in spec:
        lo, hi = spec["integers"]
        return int(rng.integers(lo, hi))
    raise ValueError(f"unknown draw {spec}")


def edges(config: dict) -> list[tuple[int, int]]:
    """The graph a MaxCut configuration names, else []."""
    spec = config.get("edges")
    if spec is None:
        return []
    return [tuple(e) for e in circuits.maker(spec["maker"])(**spec["params"])]


class Stream:
    """Requests of one traffic mix on one configuration."""

    def __init__(self, config: dict, traffic: dict, seed: int,
                 purpose: int = _WINDOW):
        self.config, self.traffic = config, traffic
        self.kind = kinds.load(traffic["kind"])
        self.rng = rng_for(seed, purpose)
        self.n = config["params"]["n"]
        self.make = circuits.maker(config["maker"])
        self.fixed = None if traffic.get("new_instance") else self.make(
            **config["params"])
        self.edges = edges(config)
        self.count = 0

    @classmethod
    def warm(cls, config, traffic, seed):
        return cls(config, traffic, seed, _WARM)

    def next(self) -> Request:
        rng = self.rng
        cd = self.fixed
        if cd is None:
            params = dict(self.config["params"])
            for key, spec in self.config["fresh"].items():
                params[key] = _draw(spec, rng)
            cd = self.make(**params)
        req = Request(self.count, cd, self.kind.draw(self, rng))
        self.count += 1
        return req


def check_rng(seed: int) -> np.random.Generator:
    """Draws of the correctness check (which requests it re-simulates)."""
    return rng_for(seed, _CHECK)
