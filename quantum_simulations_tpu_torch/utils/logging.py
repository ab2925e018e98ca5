"""Structured logging (a copy of
``quantum_simulations_tpu/utils/logging.py``).

Namespaced loggers under ``qst.*`` with console + optional file
handlers (parity with the reference's logging subsystem,
``v3_hisvsim_spark/src/utils/logging_config.py``), plus a JSON-lines
event emitter for machine-readable run telemetry.
"""
from __future__ import annotations

import json
import logging
import sys
import time
from pathlib import Path

ROOT = "qst"
_configured = False


def setup_logging(level=logging.INFO, log_file=None) -> logging.Logger:
    """Configure the root framework logger (idempotent)."""
    global _configured
    root = logging.getLogger(ROOT)
    if _configured:
        return root
    root.setLevel(level)
    fmt = logging.Formatter(
        "%(asctime)s %(name)s %(levelname)s %(message)s", "%H:%M:%S"
    )
    h = logging.StreamHandler(sys.stderr)
    h.setFormatter(fmt)
    root.addHandler(h)
    if log_file:
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        root.addHandler(fh)
    root.propagate = False
    _configured = True
    return root


def get_logger(name: str) -> logging.Logger:
    return logging.getLogger(f"{ROOT}.{name}")


class EventLog:
    """Append-only JSON-lines event stream (telemetry / run trace)."""

    def __init__(self, path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)

    def emit(self, kind: str, **fields) -> None:
        rec = {"ts": time.time(), "kind": kind, **fields}
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def read(self) -> list[dict]:
        if not self.path.exists():
            return []
        return [json.loads(line) for line in self.path.read_text().splitlines()]
