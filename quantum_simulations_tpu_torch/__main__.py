"""Command-line interface of the port (the JAX package's ``run``,
``sample``, ``stats`` and ``export``, with the same flags, defaults and
output).

    python -m quantum_simulations_tpu_torch run circuit.json [--mode panel] ...
    python -m quantum_simulations_tpu_torch run circuit.json --sparse [auto]
    python -m quantum_simulations_tpu_torch run circuit.qasm --trajectory
    python -m quantum_simulations_tpu_torch run circuit.json --stripe-qubits 24 \
        [--spill-backend disk --work-dir wd] [--staging]
    python -m quantum_simulations_tpu_torch sample circuit.qasm --shots 100
    python -m quantum_simulations_tpu_torch stats circuit.json
    python -m quantum_simulations_tpu_torch export circuit.json --format qasm|dot|json
    python -m quantum_simulations_tpu_torch run circuit.json --devices 8 [--mode window]
    python -m quantum_simulations_tpu_torch run circuit.json --work-dir wd \
        [--checkpoint-every 2] [--step-levels 1]
    python -m quantum_simulations_tpu_torch placement [--devices 8] [--qubits 30]
    python -m quantum_simulations_tpu_torch bench e2e [--set 'sizes=[20]']

Circuit files are contract JSON dicts or OpenQASM 2.0 (.qasm).  Runs on
the card; ``--device cpu`` runs the kernels' plain torch twins on the
CPU.  ``--stripe-qubits`` runs the out-of-core spill tier (host DRAM, or
with ``--spill-backend disk`` chunk files under ``--work-dir``, which it
then needs, as in the reference).  ``--devices`` > 1 runs the sharded
tier over that many cards (positions on the CPU with ``--device cpu``;
fewer cards than asked: exit status 1, naming the cards found);
``--work-dir`` alone runs the WAL runner (a rerun resumes).
``placement`` prints the mesh's placement report and exits 0 when its
invariants and the check of a state placed on it hold, else 1.
``bench <which>`` runs one of the JAX package's nine CLI benches
(``bench/``) on the card and prints its JSON; ``--set KEY=JSON`` changes
one keyword of its ``run()`` (the defaults are the JAX package's).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


BENCHES = ["kernel_bw", "e2e", "sweep", "suite", "spill_bw",
           "baseline_configs", "capacity", "matrix", "projection"]


def _bench(which: str, overrides: list) -> dict:
    """``bench.<which>.run()`` with each ``KEY=JSON`` of ``overrides`` as a
    keyword; a malformed item or a keyword ``run`` does not take exits."""
    import importlib
    import inspect

    mod = importlib.import_module(f".bench.{which}", __package__)
    params = inspect.signature(mod.run).parameters
    kw = {}
    for item in overrides:
        key, _, value = item.partition("=")
        if key not in params:
            raise SystemExit(f"--set {item!r}: bench {which} takes "
                             f"{', '.join(params)}")
        try:
            kw[key] = json.loads(value)
        except json.JSONDecodeError as e:
            raise SystemExit(f"--set {item!r}: the value is not JSON ({e})")
    return mod.run(**kw)


def _load_circuit(path: str, trajectory: bool = False) -> dict:
    p = Path(path)
    if p.suffix == ".qasm":
        from .circuit.import_qasm import load_qasm

        return load_qasm(
            p, nonunitary="trajectory" if trajectory else "error")
    return json.loads(p.read_text())


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="quantum_simulations_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("circuit", help="circuit JSON or .qasm file")
    common.add_argument("--dtype", default="complex64")
    common.add_argument("--mode", default="panel",
                        choices=["panel", "fused", "window", "capacity",
                                 "auto"])
    common.add_argument("--device", default="cuda",
                        help="'cuda' (the card, the default) or 'cpu' (the "
                             "kernels' plain torch twins)")
    common.add_argument("--devices", type=int, default=None)
    common.add_argument("--stripe-qubits", type=int, default=None)
    common.add_argument("--spill-backend", default="host",
                        choices=["host", "disk"])
    common.add_argument(
        "--sparse", nargs="?", const=True, default=False,
        choices=[True, "auto"], metavar="auto",
        help="sparse tier; '--sparse auto' switches to dense adaptively")
    common.add_argument("--no-fusion", action="store_true")
    common.add_argument("--staging", action="store_true")
    common.add_argument("--work-dir", default=None)
    common.add_argument("--segment-gates", type=int, default=None,
                        help="run as locality-cut sub-circuits of <= N "
                             "gates")
    common.add_argument("--checkpoint-every", type=int, default=1,
                        help="WAL runner: checkpoint cadence in steps")
    common.add_argument(
        "--trajectory", action="store_true",
        help="accept RESET / mid-circuit measure / if(creg==v) (QASM) "
             "and run one seeded trajectory")
    common.add_argument("--trajectory-seed", type=int, default=0,
                        help="seed for trajectory measurement draws")
    common.add_argument("--step-levels", type=int, default=None,
                        help="WAL runner: bound circuit levels per "
                             "durable step")

    p_run = sub.add_parser("run", parents=[common],
                           help="simulate; print state summary")
    p_run.add_argument("--top", type=int, default=8,
                       help="print the k largest amplitudes")

    p_sample = sub.add_parser("sample", parents=[common])
    p_sample.add_argument("--shots", type=int, default=100)
    p_sample.add_argument("--seed", type=int, default=0)

    sub.add_parser("stats", parents=[common],
                   help="compile statistics (fusion/panel)")

    p_export = sub.add_parser(
        "export", parents=[common],
        help="serialise the circuit (qasm to stdout, dot for the DAG)")
    p_export.add_argument("--format", default="qasm",
                          choices=["qasm", "dot", "json"])
    p_export.add_argument("--partitions", type=int, default=None,
                          help="dot only: cluster by partition()")

    p_bench = sub.add_parser(
        "bench", help="run one bench and print its JSON (on the card; "
                      "QST_BENCH_PLATFORM=cpu runs it on the CPU)")
    p_bench.add_argument("which", choices=BENCHES)
    p_bench.add_argument(
        "--set", action="append", default=[], metavar="KEY=JSON",
        help="override one keyword of the bench's run(), the value as "
             "JSON (e.g. --set 'sizes=[8, 12]'); repeatable")

    p_place = sub.add_parser(
        "placement",
        help="shard-placement report + invariant checks over the device "
             "mesh (distribution verifier)")
    p_place.add_argument("--devices", type=int, default=None)
    p_place.add_argument("--qubits", type=int, default=None)
    p_place.add_argument("--device", default="cuda",
                         help="'cuda' (the cards) or 'cpu' (positions on "
                              "the CPU)")
    return ap


def _export(cd: dict, fmt: str, partitions) -> None:
    if fmt == "qasm":
        from .circuit.export_qasm import to_qasm

        sys.stdout.write(to_qasm(cd))
    elif fmt == "dot":
        from .circuit.dag import partition, to_dot

        parts = (partition(cd, partitions, "locality")
                 if partitions else None)
        sys.stdout.write(to_dot(cd, parts))
    else:
        print(json.dumps(cd, indent=1))


def _stats(cd: dict) -> dict:
    from .circuit.contract import circuit_depth, gate_counts
    from .circuit.fusion import fusion_stats
    from .circuit.panelize import panel_stats

    n = cd["number_of_qubits"]
    return {
        "n_qubits": n,
        "n_gates": len(cd["gates"]),
        "depth": circuit_depth(cd),
        "gate_counts": gate_counts(cd),
        "fusion": fusion_stats(cd, k=n),
        "panel": panel_stats(cd),
    }


def _dense_summary(psi, top: int) -> dict:
    """The reference's dense-tier ``run`` output, computed on the state's
    device: ``|psi|^2``, its sum and its ``top`` largest entries (ties
    by index)."""
    import torch

    probs = psi.abs() ** 2
    vals, idx = torch.topk(probs, min(top, probs.numel()))
    best = sorted(zip(idx.tolist(), vals.tolist()), key=lambda t: (-t[1], t[0]))
    return {
        "n_amplitudes": int(probs.numel()),
        "norm2": float(probs.sum(dtype=torch.float64)),
        "top": [[hex(int(i)), float(p)] for i, p in best],
    }


def _sparse_summary(st, top: int) -> dict:
    """The reference's ``run`` output of a run that stayed sparse."""
    return {
        "nonzero": len(st),
        "norm": st.norm(),
        "top": [[hex(i), [complex(a).real, complex(a).imag]]
                for i, a in st.top_amplitudes(top)],
    }


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    from .parallel.mesh import MeshError

    if args.cmd == "placement":
        from .parallel.placement import main as placement_main

        try:
            rep = placement_main(n_devices=args.devices, n=args.qubits,
                                 device=args.device)
        except MeshError as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
        print(json.dumps(rep, indent=1))
        return 0 if (rep["invariants"]["ok"]
                     and rep["sharded_array_check"]["ok"]) else 1

    if args.cmd == "bench":
        print(json.dumps(_bench(args.which, args.set), indent=1))
        return 0

    cd = _load_circuit(args.circuit, trajectory=args.trajectory)
    if args.cmd == "export":
        _export(cd, args.format, args.partitions)
        return 0
    if args.cmd == "stats":
        print(json.dumps(_stats(cd), indent=1))
        return 0

    from . import api
    from .utils.config import SimulatorConfig

    cfg = SimulatorConfig(
        dtype=args.dtype, mode=args.mode, n_devices=args.devices,
        stripe_qubits=args.stripe_qubits, spill_backend=args.spill_backend,
        sparse=args.sparse, use_fusion=not args.no_fusion,
        use_staging=args.staging, segment_gates=args.segment_gates,
        checkpoint_every=args.checkpoint_every,
        max_levels_per_step=args.step_levels,
        trajectory_seed=args.trajectory_seed,
    )
    try:
        if args.cmd == "sample":
            bits = api.sample(cd, args.shots, seed=args.seed, config=cfg,
                              device=args.device)
            for row in bits:
                print("".join(str(int(b)) for b in row[::-1]))  # q_{n-1}...q_0
            return 0
        result = api.run(cd, cfg, work_dir=args.work_dir, device=args.device)
    except MeshError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if hasattr(result, "summary"):  # capacity tier: planar readout
        print(json.dumps(result.summary(args.top), indent=1))
    elif hasattr(result, "top_amplitudes"):  # stayed sparse (incl. auto)
        print(json.dumps(_sparse_summary(result, args.top), indent=1))
    else:  # a dense state: a tensor, or a host array (spill, sharded, runner)
        print(json.dumps(_dense_summary(_summary_tensor(result, args.device),
                                        args.top), indent=1))
    return 0


def _summary_tensor(result, device):
    """The state to summarise: a tensor as it is; a host array moved to
    the card when the card has room for it and its probabilities (the
    summary of 2^28 amplitudes takes seconds on the host's cores), else
    left on the host."""
    import torch

    if isinstance(result, torch.Tensor):
        return result
    psi = torch.from_numpy(result)
    dev = torch.device(device)
    if dev.type == "cuda" and 2 * psi.nbytes < torch.cuda.mem_get_info(dev)[0]:
        return psi.to(dev)
    return psi


if __name__ == "__main__":
    sys.exit(main())
