"""Data parallelism across several GPUs against one, on one global batch.

    python -m graphecho_torch.dp_check --world 4

The recipe is `cardiac_uda_config(temporal_graph=True, cyc_loss=True)` at full
width, its synthetic global batch (8 + 8 frames, clips 4 + 4 of 8 frames, one
64-frame cycle clip). Rank 0 first runs the plain step alone on the whole
global batch, from the seeded state, and times further steps; then every
rank joins an NCCL process group (`tcp://127.0.0.1`), keeps its row block of
the same batches (`parallel.mesh.shard_batch`) and runs the data-parallel
step from the same weights. Rank 0 prints one JSON line: the losses of the
first step of both and their largest relative difference, the spread of the
state over the ranks after the steps (the FPN, the replicated components'
parameters and buffers, the seed banks and queues), the steady step ms of
both (host clock, synchronised, median), the peak memory of each, and the
card with its power limit. It fails when a loss differs by more than
`LOSS_RTOL` or the state is not equal on every rank. The two-process CPU
case (gloo) is `tests/test_torch_parallel.py`.
"""

from __future__ import annotations

import argparse
import json
import socket
import statistics
import subprocess
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

LOSS_RTOL = 1e-3  # rounding: per-rank batch sizes change the kernels' sums


def _config():
    from graphecho_torch import config as C

    return C.cardiac_uda_config(temporal_graph=True, cyc_loss=True)


def _sync(device: torch.device) -> None:
    torch.cuda.synchronize(device)


def _steps(cfg, device, batches, mesh=None):
    """The first step's losses and the median ms of the others, from the
    seeded state; returns (losses, ms, state)."""
    from graphecho_torch.train.state import create_train_state
    from graphecho_torch.train.steps import build_models, make_train_step

    state = create_train_state(cfg, build_models(cfg), device, seed=0)
    step = make_train_step(cfg, mesh)
    losses = {k: float(v) for k, v in step(state, batches[0]).items()}
    times = []
    for batch in batches[1:]:
        _sync(device)
        t0 = time.perf_counter()
        step(state, batch)
        _sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return losses, statistics.median(times), state


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _rank(rank: int, world: int, port: int, steps: int) -> None:
    from graphecho_torch.data.synthetic import SyntheticEchoData
    from graphecho_torch.parallel.mesh import create_mesh, max_abs_spread, shard_batch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(rank)
    device = torch.device("cuda", rank)
    cfg = _config()
    data = SyntheticEchoData(cfg, seed=123)
    batches = [data.train_batch() for _ in range(steps)]
    out = {}
    if rank == 0:
        torch.cuda.reset_peak_memory_stats(device)
        out["plain_losses"], out["plain_step_ms"], state = _steps(cfg, device, batches)
        out["plain_peak_memory_gib"] = torch.cuda.max_memory_allocated(device) / 2 ** 30
        del state
        torch.cuda.empty_cache()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                            rank=rank)
    try:
        mesh = create_mesh(world)
        local = [shard_batch(mesh, b) for b in batches]
        torch.cuda.reset_peak_memory_stats(device)
        losses, ms, state = _steps(cfg, device, local, mesh)
        replicated = [c for c in state.components() if c is not state.net]
        spread = {
            "fpn": max_abs_spread(mesh, [*state.net.module.parameters(),
                                         *state.net.module.buffers()]),
            "replicated_parameters": max_abs_spread(
                mesh, [p for c in replicated for p in c.module.parameters()]),
            "replicated_buffers": max_abs_spread(
                mesh, [b for c in replicated for b in c.module.buffers()]),
            "seeds_and_queues": max_abs_spread(
                mesh, [state.sr_seed, state.tg_seed, state.queue_source, state.queue_target])}
        peaks = [None] * world
        dist.all_gather_object(peaks, torch.cuda.max_memory_allocated(device) / 2 ** 30)
        if rank == 0:
            worst = max(abs(losses[k] - v) / max(abs(v), 1e-30)
                        for k, v in out["plain_losses"].items())
            line = {"dp_check": "cardiac_full", "world": world,
                    "backend": dist.get_backend(), "losses": losses, **out,
                    "max_rel_loss_diff": worst, "spread": spread,
                    "dp_step_ms": ms, "speedup": out["plain_step_ms"] / ms,
                    "dp_peak_memory_gib": peaks,
                    "card": _card()}
            print(json.dumps(line), flush=True)
            if worst > LOSS_RTOL or any(spread.values()):
                raise SystemExit(f"dp_check: loss difference {worst} or state spread {spread}")
    finally:
        dist.destroy_process_group()


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--world", type=int, default=4)
    parser.add_argument("--steps", type=int, default=4, help="the first and the timed steps")
    args = parser.parse_args()
    if torch.cuda.device_count() < args.world:
        raise SystemExit(f"dp_check: {args.world} ranks need {args.world} GPUs, "
                         f"{torch.cuda.device_count()} found")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mp.spawn(_rank, args=(args.world, port, args.steps),
             nprocs=args.world, join=True)


if __name__ == "__main__":
    main()
