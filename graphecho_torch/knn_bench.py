"""Where the kNN-graph kernel's time goes, at the pvig_s Grapher shapes.

    python -m graphecho_torch.knn_bench [--source NAME=FILE.cu ...]

Builds `csrc/knn.cu` as it is and three ablations of it, each with one part
of the work cut out of the source text: `no_selection` (the warps write no
neighbours), `no_products` (no dot products) and `neither`. What remains of
an ablation is staging, norms and the distance pass, so the differences
estimate what selection and products cost. `--source` adds other versions of
the file with the same C interface. Each build is timed through its C entry
point, without the Python wrapper, at the five Grapher shapes of pvig_s at
batch 32 (with the Grapher's relative-position bias): CUDA events around 50
back-to-back launches after 3 warm-up ones, the smaller of two rounds, the
versions taken in turns. Prints one JSON line per shape, the host time of
one `launch_knn` call at a tiny shape, and a last line with the card's name
and power limit. Needs a CUDA device and `nvcc`.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict

import torch

from graphecho_torch.models.vig import relative_pos_buffer
from graphecho_torch.ops import cuda_build

BATCH = 32
# (Graphers, N queries, M keys, C, k * dilation), as in chip_smoke.py
SHAPES = (("0-1", 3136, 196, 80, 9), ("2-3", 784, 196, 160, 9), ("4-7", 196, 196, 400, 18),
          ("8-9", 196, 196, 400, 27), ("10-11", 49, 49, 640, 27))
# the text each ablation replaces, and by what
SELECTION = ("if (tile > 0 || !select_by_threshold(row, nk, j0, k, scratch + warp * 64, lane, "
             "o0, o1)) {", "if (false) {")
PRODUCTS = ("            if (32 * (2 * j + half) >= nk) continue;",
            "            if (true) continue;")


def ablations(src: str) -> Dict[str, str]:
    def cut(text, *edits):
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"knn_bench: csrc/knn.cu no longer holds {old!r}")
            text = text.replace(old, new)
        return text

    return {"kernel": src, "no_selection": cut(src, SELECTION),
            "no_products": cut(src, PRODUCTS), "neither": cut(src, SELECTION, PRODUCTS)}


def build(sources: Dict[str, str], workdir: Path) -> Dict[str, ctypes.CDLL]:
    def one(item):
        name, text = item
        src, lib = workdir / f"{name}.cu", workdir / f"lib{name}.so"
        src.write_text(text)
        cuda_build.nvcc_compile(src, lib)
        handle = ctypes.CDLL(str(lib))
        p, i = ctypes.c_void_p, ctypes.c_int
        handle.knn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, p]
        handle.knn.restype = ctypes.c_int
        return name, handle

    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        return dict(pool.map(one, sources.items()))


def time_ms(call, reps: int = 50, warmup: int = 3) -> float:
    for _ in range(warmup):
        cuda_build.check(call(), "knn")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        call()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def wrapper_host_us(calls: int = 500) -> float:
    """Host time of one `launch_knn` call at a shape too small to keep the card
    busy (one query, 196 keys, C = 400), launches queued without a sync."""
    from graphecho_torch.ops import knn

    x = torch.randn(1, 1, 400, device="cuda")
    y = torch.randn(1, 196, 400, device="cuda")
    rel = torch.randn(1, 1, 196, device="cuda")
    for _ in range(20):
        knn.launch_knn(x, y, 18, True, rel)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        knn.launch_knn(x, y, 18, True, rel)
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / calls * 1e6


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--source", action="append", default=[], metavar="NAME=FILE.cu",
                        help="another version of csrc/knn.cu to time beside it")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("knn_bench needs a CUDA device")
    sources = ablations((cuda_build.CSRC / "knn.cu").read_text())
    for item in args.source:
        name, path = item.split("=", 1)
        sources[name] = Path(path).read_text()
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(sources, Path(tmp))
        gen = torch.Generator(device="cuda").manual_seed(0)
        stream = torch.cuda.current_stream().cuda_stream
        for group, n, m, c, k in SHAPES:
            x = torch.randn(BATCH, n, c, device="cuda", generator=gen)
            y = x if n == m else torch.randn(BATCH, m, c, device="cuda", generator=gen)
            rel = relative_pos_buffer(c, n, m, x.device).contiguous()
            out = torch.empty(BATCH, n, k, device="cuda", dtype=torch.int32)
            ms: Dict[str, float] = {}
            for _ in range(2):
                for name, lib in libs.items():
                    def call(lib=lib):
                        return lib.knn(x.data_ptr(), y.data_ptr(), rel.data_ptr(),
                                       out.data_ptr(), BATCH, n, m, c, k, 1, 1, stream)
                    ms[name] = min(ms.get(name, float("inf")), time_ms(call))
            print(json.dumps({"graphers": group, "b": BATCH, "n": n, "m": m, "c": c, "k": k,
                              "ms": ms}), flush=True)
    print(json.dumps({"launch_knn_host_us": wrapper_host_us()}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)


if __name__ == "__main__":
    main()
