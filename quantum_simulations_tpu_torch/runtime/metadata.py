"""SQLite metadata store: run registry, WAL rows, checkpoint catalog (a
copy of ``quantum_simulations_tpu/runtime/metadata.py``).

Capability parity with the reference's relational metadata tier (v2's
DuckDB ``MetadataStore`` with PENDING/COMMITTED/FAILED WAL rows and
checkpoint records, ``v2_spark/src/metadata_store.py``; v1's SQLite
wal/checkpoint tables).  Uses stdlib sqlite3 (WAL journal mode) — this
is the queryable, multi-run ledger on top of the per-run JSON WAL the
hot path uses.
"""
from __future__ import annotations

import json
import sqlite3
import time
from pathlib import Path

SCHEMA = """
CREATE TABLE IF NOT EXISTS runs (
  run_id TEXT PRIMARY KEY,
  circuit_hash TEXT NOT NULL,
  n_qubits INTEGER NOT NULL,
  n_gates INTEGER NOT NULL,
  config_json TEXT,
  created_ts REAL NOT NULL,
  status TEXT NOT NULL DEFAULT 'RUNNING'
);
CREATE TABLE IF NOT EXISTS wal (
  run_id TEXT NOT NULL,
  step INTEGER NOT NULL,
  status TEXT NOT NULL,               -- PENDING | COMMITTED | FAILED
  buf TEXT,
  ts REAL NOT NULL,
  PRIMARY KEY (run_id, step)
);
CREATE TABLE IF NOT EXISTS checkpoints (
  run_id TEXT NOT NULL,
  step INTEGER NOT NULL,
  path TEXT NOT NULL,
  sha256 TEXT,
  size_bytes INTEGER,
  ts REAL NOT NULL,
  PRIMARY KEY (run_id, step)
);
"""


class MetadataStore:
    def __init__(self, path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._conn = sqlite3.connect(self.path)
        self._conn.execute("PRAGMA journal_mode=WAL")
        self._conn.executescript(SCHEMA)
        self._conn.commit()

    def close(self) -> None:
        self._conn.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- runs ---------------------------------------------------------------

    def create_run(self, run_id: str, circuit_hash: str, n_qubits: int,
                   n_gates: int, config: dict | None = None) -> None:
        self._conn.execute(
            "INSERT OR REPLACE INTO runs VALUES (?,?,?,?,?,?,?)",
            (run_id, circuit_hash, n_qubits, n_gates,
             json.dumps(config or {}), time.time(), "RUNNING"),
        )
        self._conn.commit()

    def finish_run(self, run_id: str, status: str = "DONE") -> None:
        self._conn.execute(
            "UPDATE runs SET status=? WHERE run_id=?", (status, run_id)
        )
        self._conn.commit()

    def get_run(self, run_id: str) -> dict | None:
        row = self._conn.execute(
            "SELECT run_id, circuit_hash, n_qubits, n_gates, config_json,"
            " created_ts, status FROM runs WHERE run_id=?", (run_id,)
        ).fetchone()
        if row is None:
            return None
        return {
            "run_id": row[0], "circuit_hash": row[1], "n_qubits": row[2],
            "n_gates": row[3], "config": json.loads(row[4] or "{}"),
            "created_ts": row[5], "status": row[6],
        }

    def list_runs(self) -> list[dict]:
        rows = self._conn.execute(
            "SELECT run_id FROM runs ORDER BY created_ts"
        ).fetchall()
        return [self.get_run(r[0]) for r in rows]

    # -- WAL ----------------------------------------------------------------

    def wal_pending(self, run_id: str, step: int) -> None:
        self._conn.execute(
            "INSERT OR REPLACE INTO wal VALUES (?,?,?,?,?)",
            (run_id, step, "PENDING", None, time.time()),
        )
        self._conn.commit()

    def wal_commit(self, run_id: str, step: int, buf: str) -> None:
        self._conn.execute(
            "INSERT OR REPLACE INTO wal VALUES (?,?,?,?,?)",
            (run_id, step, "COMMITTED", buf, time.time()),
        )
        self._conn.commit()

    def wal_fail(self, run_id: str, step: int) -> None:
        self._conn.execute(
            "UPDATE wal SET status='FAILED', ts=? WHERE run_id=? AND step=?",
            (time.time(), run_id, step),
        )
        self._conn.commit()

    def wal_pending_steps(self, run_id: str) -> list[int]:
        rows = self._conn.execute(
            "SELECT step FROM wal WHERE run_id=? AND status='PENDING'"
            " ORDER BY step", (run_id,)
        ).fetchall()
        return [r[0] for r in rows]

    def wal_last_committed(self, run_id: str) -> tuple[int, str] | None:
        row = self._conn.execute(
            "SELECT step, buf FROM wal WHERE run_id=? AND status='COMMITTED'"
            " ORDER BY step DESC LIMIT 1", (run_id,)
        ).fetchone()
        return (row[0], row[1]) if row else None

    def reconcile(self, run_id: str) -> list[int]:
        """Recovery: mark all PENDING steps FAILED; return them."""
        stale = self.wal_pending_steps(run_id)
        for s in stale:
            self.wal_fail(run_id, s)
        return stale

    # -- checkpoints ----------------------------------------------------------

    def add_checkpoint(self, run_id: str, step: int, path: str,
                       sha256: str | None = None,
                       size_bytes: int | None = None) -> None:
        self._conn.execute(
            "INSERT OR REPLACE INTO checkpoints VALUES (?,?,?,?,?,?)",
            (run_id, step, path, sha256, size_bytes, time.time()),
        )
        self._conn.commit()

    def latest_checkpoint(self, run_id: str) -> dict | None:
        row = self._conn.execute(
            "SELECT step, path, sha256, size_bytes FROM checkpoints"
            " WHERE run_id=? ORDER BY step DESC LIMIT 1", (run_id,)
        ).fetchone()
        if row is None:
            return None
        return {"step": row[0], "path": row[1], "sha256": row[2],
                "size_bytes": row[3]}
