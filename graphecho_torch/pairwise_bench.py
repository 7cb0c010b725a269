"""Where the pairwise-MLP backward's time goes, at the paper's two shapes.

    python -m graphecho_torch.pairwise_bench [--source NAME=FILE.cu ...]

Builds `csrc/pairwise_mlp.cu` as it is, an ablation of it without the loop
over (i, j, k) triples (`no_triples`: staging, partial sums, epilogue and the
finishing pass remain, so the difference estimates the loop), and any other
version of the file given with `--source`. Each is timed through its C entry
point `pairwise_mlp_bwd`, without the Python wrapper, at 112x112x512 (camus)
and 560x560x512 (cardiac): CUDA events around 50 back-to-back launches after
3 warm-up ones, the smaller of two rounds, the versions taken in turns (the
`--source` versions first, then this tree's, then the second round in the
reverse order: parent, PR, PR, parent). A version whose backward is the older pair of entry points
(`pairwise_mlp_bwd_da` and `pairwise_mlp_bwd_db`) is timed through a small
adapter appended to its text, which calls the two in turn. Each version's
outputs are held against the plain version first (largest abs error per
output). Then `torch.profiler` gives each version's device ms per call by
kernel name (the main pass against the finishing pass), and the host time of
one `launch_bwd` call, and of its C entry point alone, is taken at a shape too
small to keep the card busy.
Prints one JSON line per build (registers and spills from `ptxas -v`), per
shape and for the host time, and last the card's name and power limit.
Needs a CUDA device and `nvcc`.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Tuple

import torch

from graphecho_torch.ops import cuda_build
from graphecho_torch.ops import pairwise_mlp as pm
from graphecho_torch.profile_step import kernel_base_name

SHAPES = ((112, 112, 512), (560, 560, 512))
# the text `no_triples` replaces, and by what
TRIPLES = ("      for (int r = 0; r < TI; ++r) {\n        const float4 gv",
           "      for (int r = 0; r < 0; ++r) {\n        const float4 gv")
# the backward entry point of a version that has only the older pair
ADAPTER = """
extern "C" long long pairwise_mlp_bwd_scratch_floats(int n1, int n2, int k) {
  return (long long)n1 * k;
}
extern "C" int pairwise_mlp_bwd(const float* a, const float* b, const float* w2,
                                const float* g, float* da, float* db, float* dw2,
                                float* db2, float* scratch, int n1, int n2, int k,
                                void* stream) {
  const int err = pairwise_mlp_bwd_da(a, b, w2, g, da, scratch, dw2, db2, n1, n2, k, stream);
  return err ? err : pairwise_mlp_bwd_db(a, b, w2, g, db, n1, n2, k, stream);
}
"""


def with_entry_point(text: str) -> str:
    """The source as it is if it has `pairwise_mlp_bwd`, else with the adapter."""
    if re.search(r"\bpairwise_mlp_bwd\s*\(", text):
        return text
    if "pairwise_mlp_bwd_da(" not in text or "pairwise_mlp_bwd_db(" not in text:
        raise ValueError("pairwise_bench: the source has no backward entry point")
    return text + ADAPTER


def build(sources: Dict[str, str], workdir: Path) -> Dict[str, Tuple[ctypes.CDLL, List[str]]]:
    """{name: (library, ptxas lines on registers and spills)}, built in parallel."""
    def one(item):
        name, text = item
        src, lib = workdir / f"{name}.cu", workdir / f"lib{name}.so"
        src.write_text(with_entry_point(text))
        stderr = cuda_build.nvcc_compile(src, lib, "-Xptxas", "-v")
        handle = ctypes.CDLL(str(lib))
        p, i = ctypes.c_void_p, ctypes.c_int
        handle.pairwise_mlp_bwd.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, p]
        handle.pairwise_mlp_bwd.restype = ctypes.c_int
        handle.pairwise_mlp_bwd_scratch_floats.argtypes = [i, i, i]
        handle.pairwise_mlp_bwd_scratch_floats.restype = ctypes.c_longlong
        info = [ln.strip() for ln in stderr.splitlines()
                if "Compiling entry" in ln or "registers" in ln or "spill" in ln]
        return name, (handle, info)

    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        return dict(pool.map(one, sources.items()))


def time_ms(call, reps: int = 50, warmup: int = 3) -> float:
    for _ in range(warmup):
        cuda_build.check(call(), "pairwise_mlp_bwd")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        call()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms_by_kernel(call, reps: int = 20) -> Dict[str, float]:
    """Device ms per call of each kernel the call launches, from the profiler."""
    cuda_build.check(call(), "pairwise_mlp_bwd")
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    out: Dict[str, float] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = kernel_base_name(e.name)
            out[name] = out.get(name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3 / reps
    return out


def host_us(call, calls: int = 500) -> float:
    """Host time of one call, launches queued without a sync."""
    for _ in range(20):
        call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        call()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / calls * 1e6


def wrapper_host_us() -> Dict[str, float]:
    """Host µs of one `launch_bwd` call, and of its C entry point alone with
    the arguments made beforehand, at a shape too small to keep the card busy
    (16 x 16 x 32)."""
    a, b = torch.randn(16, 32, device="cuda"), torch.randn(16, 32, device="cuda")
    w2, g = torch.randn(32, device="cuda"), torch.randn(16, 16, device="cuda")
    outs = [torch.empty_like(a), torch.empty_like(b), torch.empty(33, device="cuda")]
    scratch = torch.empty(pm._scratch_floats(16, 16, 32), device="cuda")
    args = (a.data_ptr(), b.data_ptr(), w2.data_ptr(), g.data_ptr(), outs[0].data_ptr(),
            outs[1].data_ptr(), outs[2].data_ptr(), outs[2].data_ptr() + 128,
            scratch.data_ptr(), 16, 16, 32, torch.cuda.current_stream().cuda_stream)
    lib = pm._lib()
    return {"launch_bwd_host_us": host_us(lambda: pm.launch_bwd(a, b, w2, g)),
            "c_entry_host_us": host_us(lambda: lib.pairwise_mlp_bwd(*args))}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--source", action="append", default=[], metavar="NAME=FILE.cu",
                        help="another version of csrc/pairwise_mlp.cu to time beside it")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("pairwise_bench needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    sources = {}
    for item in args.source:
        name, path = item.split("=", 1)
        sources[name] = Path(path).read_text()
    sources["kernel"] = (cuda_build.CSRC / "pairwise_mlp.cu").read_text()
    if TRIPLES[0] not in sources["kernel"]:
        raise RuntimeError(f"pairwise_bench: csrc/pairwise_mlp.cu no longer holds {TRIPLES[0]!r}")
    sources["no_triples"] = sources["kernel"].replace(*TRIPLES)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(sources, Path(tmp))
        for name, (_, info) in libs.items():
            print(json.dumps({"build": name, "ptxas": info}), flush=True)
        stream = torch.cuda.current_stream().cuda_stream
        for n1, n2, k in SHAPES:
            gen = torch.Generator(device="cuda").manual_seed(n1 + k)
            a, b = (torch.randn(n, k, device="cuda", generator=gen) for n in (n1, n2))
            w2 = torch.randn(k, device="cuda", generator=gen)
            g = torch.randn(n1, n2, device="cuda", generator=gen)
            want = pm.pairwise_mlp_backward_reference(a, b, w2, g)
            calls, errs = {}, {}
            for name, (lib, _) in libs.items():
                outs = [torch.empty_like(a), torch.empty_like(b), torch.empty_like(w2),
                        torch.empty(1, device="cuda")]
                scratch = torch.empty(lib.pairwise_mlp_bwd_scratch_floats(n1, n2, k),
                                      device="cuda")

                def call(lib=lib, outs=outs, scratch=scratch):
                    return lib.pairwise_mlp_bwd(
                        a.data_ptr(), b.data_ptr(), w2.data_ptr(), g.data_ptr(),
                        *(o.data_ptr() for o in outs), scratch.data_ptr(), n1, n2, k, stream)
                cuda_build.check(call(), name)
                torch.cuda.synchronize()
                errs[name] = {out: (got.reshape(w.shape) - w).abs().max().item()
                              for out, got, w in zip(("dA", "dB", "dw2", "db2"), outs, want)}
                calls[name] = call
            ms: Dict[str, float] = {}
            for order in (list(calls), list(calls)[::-1]):
                for name in order:
                    ms[name] = min(ms.get(name, float("inf")), time_ms(calls[name]))
            by_kernel = {name: device_ms_by_kernel(call) for name, call in calls.items()}
            print(json.dumps({"shape": [n1, n2, k], "ms": ms, "device_ms_by_kernel": by_kernel,
                              "max_abs_err": errs}), flush=True)
    print(json.dumps(wrapper_host_us()), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)


if __name__ == "__main__":
    main()
