"""What a request calls: the port through its public entry points, or the
control (the reference with TF32 products) in the port's place.

Both offer ``config``, ``run``, ``answer`` (one request, as its kind's
module makes it: ``kinds/<kind>.py``) and ``counter`` (a host counter of
the port by name), and an ``entry`` whose ``run`` every request's final
state goes through, so that :class:`Capture` sees it.
"""
from __future__ import annotations

import importlib
import time

import torch

from . import check, kinds
from .reference import cut as cr
from .reference import statevector as sv
from .trace import span


PACKAGE = "quantum_simulations_tpu_torch"


class Port:
    """``quantum_simulations_tpu_torch`` through ``api`` and its other public
    modules; its host counters, read by name."""

    def __init__(self, device: torch.device):
        from quantum_simulations_tpu_torch import api
        from quantum_simulations_tpu_torch.utils.config import SimulatorConfig

        self.api, self.entry = api, api
        self.Config = SimulatorConfig
        self.device = device

    def prepare(self) -> None:
        """Build (the first time in a checkout) and load every kernel."""
        if self.device.type == "cuda":
            self.module("ops.cuda_build").build_all()

    @staticmethod
    def module(name: str):
        """The port's module ``<package>.<name>``, such as ``ops.observables``."""
        return importlib.import_module(f"{PACKAGE}.{name}")

    def config(self, fields: dict):
        return self.Config(**fields)

    def run(self, cd, cfg):
        return self.api.run(cd, cfg, device=self.device)

    def answer(self, kind, req, cfg, spanning):
        return kind.call(self, req, cfg, spanning)

    def counter(self, spec: str) -> int:
        """``"<module>:<NAME>"``: the port's counter ``NAME`` in
        ``<package>.<module>``, a number or the sum of a dict's values."""
        mod, name = spec.split(":")
        value = getattr(self.module(mod), name)
        return int(sum(value.values()) if isinstance(value, dict) else value)


class Planes:
    """A state as two float planes on the device, as the check reads one."""

    def __init__(self, re: torch.Tensor, im: torch.Tensor):
        self.re, self.im = re, im


class Control:
    """The reference with TF32 products (``statevector.simulate(...,
    tf32=True)``) in the port's place: the check has to find it wrong.
    Its readouts are the reference's, in float64, on the TF32 state; a
    circuit met again is not simulated again.  It has no counters.

    For a configuration held to the cut reference (``config`` names
    ``"reference": {"kind": "cut", "cut": c}``) it is the cut
    reference with TF32 rounding: its state is written a chunk at a time
    into two float32 planes (:class:`Planes`, never a complex copy), and
    its answers come from the TF32 halves (``kinds.cut_fn(kind,
    "cut_control")``).  Only ``gpubench.control`` runs it."""

    CHUNK = 1 << 24

    def __init__(self, device: torch.device, config: dict | None = None):
        self.entry = self
        self.device = device
        self.cut = None if config is None else check.reference_cut(config)
        self._last = (None, None, None)

    def prepare(self) -> None:
        pass

    def config(self, fields: dict):
        return dict(fields)

    def run(self, cd, cfg):
        if self._last[0] is not cd:
            self._last = (None, None, None)
            if self.cut is None:
                psi = sv.simulate(cd, self.device, tf32=True)
                self._last = (cd, psi, None)
            else:
                ref = cr.CutReference(cd, self.cut, self.device, tf32=True)
                self._last = (cd, self._planes(ref), ref)
        return self._last[1]

    def _planes(self, ref) -> Planes:
        n = 1 << ref.n
        re = torch.empty(n, dtype=torch.float32, device=self.device)
        im = torch.empty(n, dtype=torch.float32, device=self.device)
        for s, amps in ref.chunks(self.CHUNK):
            e = s + amps.numel()
            re[s:e] = amps.real
            im[s:e] = amps.imag
        return Planes(re, im)

    def halves(self) -> cr.CutReference:
        """The TF32 cut reference of the circuit last run."""
        return self._last[2]

    def probs(self, psi):
        cd, last, probs = self._last
        if last is not psi or probs is None:
            probs = sv.probabilities(psi)
            if last is psi:
                self._last = (cd, psi, probs)
        return probs

    def answer(self, kind, req, cfg, spanning):
        if self.cut is None:
            return kind.control(self, req, cfg, spanning)
        return kinds.cut_fn(kind, "cut_control")(self, req, cfg, spanning)

    def counter(self, spec: str) -> int:
        return 0


class Capture:
    """While open, wraps ``system.entry.run``: keeps the state the last
    request ran to (the check compares it with the reference).  With
    ``traced`` it also opens the span ``gpubench.run`` around the call,
    waits for the state and notes when it was ready, which starts the
    readout's span.  Untraced runs neither sync nor span: their window is
    the port's own."""

    def __init__(self, system, traced: bool):
        self.entry = system.entry
        self.traced = traced
        self.sync = traced and system.device.type == "cuda"
        self.state = None
        self.ready_at = None

    def __enter__(self):
        self._own = "run" in vars(self.entry)
        self._orig = self.entry.run
        orig = self._orig

        def run(*args, **kwargs):
            if self.traced:
                with span("gpubench.run"):
                    out = orig(*args, **kwargs)
            else:
                out = orig(*args, **kwargs)
            self.state = out
            if self.sync:
                torch.cuda.synchronize()
            self.ready_at = time.perf_counter()
            return out

        self.entry.run = run
        return self

    def __exit__(self, *exc):
        if self._own:
            self.entry.run = self._orig
        else:
            del self.entry.run
        return False

    def clear(self) -> None:
        self.state = None
        self.ready_at = None
