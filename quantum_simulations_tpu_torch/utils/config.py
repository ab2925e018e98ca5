"""Run configuration (a copy of ``quantum_simulations_tpu/utils/config.py``).

Parity with the reference's config tier (v2/v3 ``SimulatorConfig``
dataclass + wenbo's runner kwargs): one dataclass capturing every
execution knob, serialisable to/from JSON for reproducible runs.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path


@dataclass
class SimulatorConfig:
    # Execution
    dtype: str = "complex64"
    # 'fused'    step compiler: packed low panels and single gates
    # 'panel'    rotating-panel schedule: lane panels and bit rotations
    # 'window'   fixed-window schedule, no rotations
    # 'capacity' the window schedule in place, planar readout
    # 'auto'     window when panels dominate (else fused), capacity at
    #            n >= 29
    mode: str = "fused"
    use_fusion: bool = True
    panel_width: int | None = 7
    n_devices: int | None = None     # mesh size (None = all available)
    segment_gates: int | None = None  # split deep circuits into
    # locality-partitioned sub-programs of <= this many gates each
    # (bounds per-program compile time; None = one program)

    # Scheduling
    use_staging: bool = False
    staging_method: str = "auto"     # 'auto' | 'heuristic' | 'greedy' | 'ilp'

    # Durability
    use_wal: bool = True
    use_fencing: bool = False
    checkpoint_every: int = 1
    max_levels_per_step: int | None = None  # bound circuit levels per
    # durable step so deep all-local runs commit progress at real
    # intervals (single-chip, unbounded fusion = one giant step)

    # Out-of-core
    stripe_qubits: int | None = None   # None = in-HBM
    spill_backend: str = "host"        # 'host' | 'disk'
    spill_transfer: str = "native"     # 'native' | 'f32' (interleaved-
    # float stripe I/O for backends without complex/large DMA paths)

    # Sparse: False | True | "auto" (adaptive sparse->dense switching
    # driven by the intermediate-nnz profile)
    sparse: bool | str = False
    sparse_threshold: float = 1e-15

    # Trajectory tier (RESET / mid-circuit MEASURE / conditional gates):
    # seed for the measurement-outcome draws.
    trajectory_seed: int = 0

    # Observability
    log_level: str = "INFO"
    event_log: str | None = None

    extra: dict = field(default_factory=dict)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=1, sort_keys=True)

    @classmethod
    def from_json(cls, blob: str) -> "SimulatorConfig":
        data = json.loads(blob)
        extra = {k: v for k, v in data.items()
                 if k not in {f.name for f in dataclasses.fields(cls)}}
        known = {k: v for k, v in data.items()
                 if k in {f.name for f in dataclasses.fields(cls)}}
        cfg = cls(**known)
        cfg.extra.update(extra)
        return cfg

    def save(self, path) -> None:
        Path(path).write_text(self.to_json())

    @classmethod
    def load(cls, path) -> "SimulatorConfig":
        return cls.from_json(Path(path).read_text())
