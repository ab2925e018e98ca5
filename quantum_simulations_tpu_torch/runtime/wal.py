"""Write-ahead log + fencing lock — the durability tier (a copy of
``quantum_simulations_tpu/runtime/wal.py``: the same record, byte for
byte, for the same circuit and plan).

Semantics match the reference's step-WAL design
(``wenbo_engine/wal/wal.py``, ``wal/fencing.py``): a tiny JSON record
``{circuit_hash, committed_buf, done_steps}`` written atomically
(tmp + fsync + rename) after each committed step; the double-buffer
scheme means the previous committed state is never touched while the
next step writes, so crash recovery is simply "resume from the last
committed step".  A fencing lock prevents two runners from sharing a
work dir (split-brain), with same-host liveness via kill(pid, 0) and a
staleness window for cross-host locks.

The out-of-core tier (``runtime/spill.py``) commits one step at a time;
its "buffers" are the a/b chunk directories of ``chunk_store.DiskBuffer``.
"""
from __future__ import annotations

import json
import os
import socket
import time
from pathlib import Path

from ..circuit.contract import circuit_hash


def atomic_write_bytes(path: Path, data: bytes) -> None:
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def atomic_write_json(path: Path, obj: dict) -> None:
    atomic_write_bytes(path, json.dumps(obj, indent=1).encode())


class WALMismatchError(RuntimeError):
    """The work dir belongs to a different circuit."""


class WALCorruptError(RuntimeError):
    """The WAL record is unreadable (disk corruption / manual edit).

    Atomic tmp+fsync+rename means a crash can never leave a partial
    WAL, so an unparseable record is external damage.  Fail-stop is the
    only safe response — silently restarting from step 0 could mask
    having lost committed work (the reference's WAL has the same
    posture: ``wenbo_engine/wal/wal.py`` load raises on bad records).
    """


class WAL:
    """Step-granular write-ahead log for one circuit run.

    ``plan`` captures anything that changes step indexing (fusion
    flags, shard width, step count): resuming the same circuit with a
    different compilation plan would mis-align ``done_steps``, so it
    is folded into the WAL identity and mismatches raise.
    """

    def __init__(self, path: Path, circuit_dict: dict, plan: str = ""):
        self.path = Path(path)
        self.hash = circuit_hash(circuit_dict) + (f"|{plan}" if plan else "")
        if self.path.exists():
            try:
                rec = json.loads(self.path.read_text())
                if not isinstance(rec, dict):
                    raise ValueError("WAL record is not an object")
                done = int(rec["done_steps"])
            except (ValueError, KeyError, TypeError) as e:
                raise WALCorruptError(
                    f"WAL at {self.path} is unreadable ({e}); refusing to "
                    f"guess progress — inspect the work dir, or delete it "
                    f"to rerun from scratch"
                ) from e
            if rec.get("circuit_hash") != self.hash:
                raise WALMismatchError(
                    f"WAL at {self.path} was written by a different circuit"
                )
            self.done_steps = done
            self.committed_buf = rec["committed_buf"]
        else:
            self.done_steps = 0
            self.committed_buf = None
            self._flush()

    def _flush(self) -> None:
        atomic_write_json(self.path, {
            "circuit_hash": self.hash,
            "done_steps": self.done_steps,
            "committed_buf": self.committed_buf,
        })

    def commit_step(self, step_idx: int, buf_name: str) -> None:
        """Durably record that steps [0, step_idx] live in `buf_name`."""
        if step_idx != self.done_steps:
            raise ValueError(
                f"out-of-order commit: expected step {self.done_steps}, "
                f"got {step_idx}"
            )
        self.done_steps = step_idx + 1
        self.committed_buf = buf_name
        self._flush()


class FencingError(RuntimeError):
    """Another live runner holds the work dir."""


class FencingLock:
    """Exclusive work-dir lock with liveness/staleness takeover.

    Same-host stale locks (dead pid) are broken immediately; cross-host
    locks are broken only after ``stale_after_s`` (default 24 h).
    """

    def __init__(self, work_dir: Path, stale_after_s: float = 24 * 3600.0):
        self.path = Path(work_dir) / "runner.lock"
        self.stale_after_s = stale_after_s
        self._held = False

    def _read(self) -> dict | None:
        try:
            return json.loads(self.path.read_text())
        except (FileNotFoundError, json.JSONDecodeError):
            return None

    def _holder_alive(self, rec: dict) -> bool:
        if rec.get("host") == socket.gethostname():
            try:
                os.kill(int(rec["pid"]), 0)
                return True
            except (ProcessLookupError, ValueError):
                return False
            except PermissionError:
                return True
        return (time.time() - float(rec.get("ts", 0))) < self.stale_after_s

    def acquire(self) -> "FencingLock":
        payload = json.dumps({
            "pid": os.getpid(), "host": socket.gethostname(), "ts": time.time(),
        }).encode()
        for _ in range(2):
            try:
                fd = os.open(self.path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                with os.fdopen(fd, "wb") as f:
                    f.write(payload)
                    f.flush()
                    os.fsync(f.fileno())
                self._held = True
                return self
            except FileExistsError:
                rec = self._read()
                if rec is not None and self._holder_alive(rec):
                    raise FencingError(
                        f"work dir locked by pid {rec.get('pid')}@{rec.get('host')}"
                    )
                # Stale: break it and retry once.
                try:
                    os.unlink(self.path)
                except FileNotFoundError:
                    pass
        raise FencingError("could not acquire fencing lock")

    def release(self) -> None:
        if self._held:
            try:
                os.unlink(self.path)
            except FileNotFoundError:
                pass
            self._held = False

    def __enter__(self) -> "FencingLock":
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()
