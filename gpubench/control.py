"""Readings of the check on several seeds in one process, for setting
and testing its limits on the card:

    python3 -m gpubench.control --workload <cell> --seeds 1,2,3 \
        --seconds <s> --system control|port [--fault <name>]

``--system control`` puts the reference with TF32 products in the port's
place (``systems.Control``): every seed has to come out not correct.
``--system port`` reads the port itself on each seed, as a run does;
with ``--fault`` (one of ``faults.FAULTS``) planted underneath.
Each seed runs the cell's set-up, window and check as ``run.py`` does,
and prints one JSON line of its numbers; the benchmark's own runs never
run this.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

from . import run as R
from .faults import FAULTS


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--system", choices=("control", "port"), required=True)
    ap.add_argument("--fault", choices=sorted(FAULTS), default=None)
    args = ap.parse_args(argv)
    R.set_environment()

    import torch

    from .systems import Control, Port

    if not torch.cuda.is_available():
        R.log("gpubench.control: no CUDA card")
        return 2
    cell = R.load_cell(R.load_json(R.ROOT / "BENCHMARK.json"), args.workload)
    dev = torch.device("cuda:0")
    system = (Control(dev, cell.config)
              if args.system == "control" else Port(dev))
    for seed in (int(s) for s in args.seeds.split(",")):
        with FAULTS[args.fault]() if args.fault else contextlib.nullcontext():
            res = R.run_cell(cell, seed, args.seconds, False, dev,
                             system=system, t_start=time.perf_counter())
        line = json.dumps({"workload": args.workload, "system": args.system,
                           "fault": args.fault, "seed": seed, "correct": res["correct"],
                           "attempted": res["attempted"],
                           "failed": res["failed"], "checks": res["checks"]})
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
