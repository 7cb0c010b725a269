"""Run one cell of the benchmark once and print its result line.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration, its traffic mix and the metrics come from
`BENCHMARK.json` at the root of the repository; the files they name are
found under `benchmark/` by name (see `benchmark/__init__.py`). The last
line of standard output is one JSON object: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics, or with `--trace 1` its
per-layer metrics), `device`, with `--trace 1` `breakdown`, and last
`checks`, each number compared with its limit; the same numbers end
standard error. It exits non-zero without a result when there is no CUDA
card, when the cell asks for more cards than there are, or when the JAX
package or JAX itself is loaded in this process once the window has closed.

Caches of the program's builds stay inside the checkout: the CUDA kernels
under `graphecho_torch/_build/` (the program's own fixed directory) and
Triton's and Inductor's under `benchmark/.cache/`.
"""

from __future__ import annotations

import time

_T_MODULE = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Any, Dict, List, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
CACHE = ROOT / ".cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "graphecho_tpu")


def process_start() -> float:
    """This process's start on the `perf_counter` clock, from /proc; the
    import of this module where /proc says nothing."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        return time.perf_counter() - age if 0 <= age < 60 else _T_MODULE
    except (OSError, ValueError, IndexError):
        return _T_MODULE


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, float]
    seed: int
    seconds: float
    trace: bool
    device: Any
    t_start: float
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)
    control: bool = False
    notes: List[Any] = dataclasses.field(default_factory=list)
    look: Any = None  # a `benchmark.look.Look` where the readings take a look


def load_benchmark() -> Dict[str, Any]:
    with open(REPO / "BENCHMARK.json") as f:
        return json.load(f)


def make_cell(bench: Dict[str, Any], workload: str, seed: int, seconds: float, trace: bool,
              device, t_start: float, extra=None, control: bool = False) -> Cell:
    from benchmark import experiment

    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    return Cell(name=workload, config_name=entry["config"],
                config=experiment.load_json("configs", entry["config"]),
                traffic=experiment.load_json("traffic", entry["traffic"]),
                limits=experiment.load_json("limits", workload), seed=seed,
                seconds=seconds, trace=trace, device=device, t_start=t_start,
                extra=dict(extra or {}), control=control)


def _applies(metric: Dict[str, Any], workload: str, reported: List[str]) -> bool:
    if "workloads" in metric:
        return workload in metric["workloads"]
    return metric.get("moves") in reported if "moves" in metric else True


def run_cell(bench: Dict[str, Any], cell: Cell) -> Dict[str, Any]:
    """Drive the cell's loop and build the result (not yet printed)."""
    loop = importlib.import_module(f"benchmark.loops.{cell.traffic['loop']}")
    out = loop.run(cell)
    e2e = [m for m in bench["end_to_end"] if _applies(m, cell.name, [])]
    reported = [m["name"] for m in e2e]
    metrics: Dict[str, Dict[str, Any]] = {}
    breakdown = None
    if cell.trace:
        from benchmark import trace

        summary = out["summary"]
        for m in bench["per_layer"]:
            if not _applies(m, cell.name, reported):
                continue
            path = ROOT / "metrics" / f"{m['name']}.py"
            spec = importlib.util.spec_from_file_location(f"benchmark_metric_{m['name']}", path)
            reader = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(reader)
            value = reader.read(summary)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        breakdown = trace.breakdown(summary)
    else:
        for m in e2e:
            metrics[m["name"]] = {"value": out["end_to_end"][m["name"]], "unit": m["unit"]}
    checks = out["checks"]
    correct = all(math.isfinite(v) and v <= limit for _, v, limit in checks)
    device = cell.device
    dev: Dict[str, Any] = {"platform": "gpu" if device.type == "cuda" else device.type,
                           "kind": _device_name(device), "count": 1,
                           "memory_peak_bytes": out["memory_peak_bytes"]}
    if cell.trace:
        dev["busy_s"] = out["summary"]["busy_s"]
        dev["window_s"] = out["summary"]["window_s"]
    dev["power_limit"] = power_limit() if device.type == "cuda" else None
    result: Dict[str, Any] = {"correct": correct, "attempted": out["attempted"],
                              "failed": out["failed"], "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {name: {"value": v, "limit": limit} for name, v, limit in checks}
    return result


def _device_name(device) -> str:
    import torch

    return torch.cuda.get_device_name(device) if device.type == "cuda" else device.type


def power_limit() -> Optional[str]:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0] if lines else None


def forbidden_modules() -> List[str]:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def main(argv=None) -> int:
    t_start = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(CACHE / sub)
    bench = load_benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"{args.workload} needs {entry['chips']} CUDA card(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    cell = make_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                     torch.device("cuda", 0), t_start)
    result = run_cell(bench, cell)
    found = forbidden_modules()
    if found:
        print(f"JAX or the JAX package is loaded in this process: {found}", file=sys.stderr)
        return 3
    for note in cell.notes:
        print(f"note {json.dumps(note)}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
