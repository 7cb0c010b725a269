"""Readings of a cell's compared numbers over many seeds, in one process:
the system as the cell runs it or, with `--control`, the control (the
cell's traffic mix names it: the lower precision the check has to fail).
The limits in `benchmark/limits/<cell>.json` are set from these readings
(PERF.md gives them). One JSON line per seed and side.

    python -m benchmark.readings --workload <cell> --seeds 1,2,3 [--control] [--seconds 3]
    python -m benchmark.readings --workload <cell> --seeds 1,2,3 --fault half_batch
    python -m benchmark.readings --workload <cell> --seeds 1,2,3 --look

With `--look` (train cells) the lines also give `benchmark/look.py`'s look:
step by step, the share of the discrete choices in which the reference
chose otherwise than the program, and the readings again with the
reference made to choose as the program did.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

from benchmark import faults, look, run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", action="store_true", help="the control's readings")
    ap.add_argument("--fault", default=None, help="a fault of `benchmark/faults.py` planted")
    ap.add_argument("--look", action="store_true", help="take `benchmark/look.py`'s look")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("readings need a CUDA card", file=sys.stderr)
        return 2
    bench = run.load_benchmark()
    for seed in (int(s) for s in args.seeds.split(",")):
        cell = run.make_cell(bench, args.workload, seed, args.seconds, False,
                             torch.device("cuda", 0), time.perf_counter(), control=args.control)
        fault = (faults.FAULTS[cell.traffic["loop"]][args.fault]() if args.fault
                 else contextlib.nullcontext())
        if args.look:
            cell.look = look.Look()
        with fault, cell.look.install() if args.look else contextlib.nullcontext():
            result = run.run_cell(bench, cell)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": args.control,
                          "fault": args.fault, "correct": result["correct"],
                          "checks": result["checks"], "notes": cell.notes,
                          "metrics": result["metrics"]}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
