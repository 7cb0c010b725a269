"""Where the pairwise-MLP kernels' time goes, at the paper's two shapes.

    python -m graphecho_torch.pairwise_bench [--source NAME=FILE.cu ...]
    python -m graphecho_torch.pairwise_bench --wrapper-only

Builds `csrc/pairwise_mlp.cu` as it is (`kernel`), variants of it, and any
other version of the file given with `--source`, all at once. The variants:
for the backward, `no_triples`, the loop over (i, j, k) triples cut (staging,
partial sums, epilogue and the finishing pass remain, so the difference
estimates the loop); for the forward, `three_ops` (each triple an add, a max
and an FMA, `PAIRWISE_FWD_THREE_OPS`) and `fwd_big`, `fwd_split`
(one shape class forced, `PAIRWISE_FWD_CONFIG`).

Each version is timed through its C entry points, without the Python wrapper,
at 112x112x512 (camus) and 560x560x512 (cardiac): `pairwise_mlp_bwd` and
`pairwise_mlp_fwd` (b2 included). CUDA events around 50 back-to-back launches
after 3 warm-up ones, the smaller of two rounds, the versions taken in turns
(the `--source` versions first, then this tree's, then the second round in the
reverse order: parent, PR, PR, parent). Older interfaces get a small adapter
appended to their text: a backward with only the `pairwise_mlp_bwd_da` /
`_db` pair is called through one entry point that runs both; a forward
without a b2 argument is renamed and called through a `pairwise_mlp_fwd` that
drops b2 (that tree's wrapper added b2 in a separate PyTorch kernel, so its
`call_ms` below adds it the same way). Each version's outputs are held
against the plain version first (largest abs error per output). Then
`torch.profiler` gives each version's device ms per call by kernel name, and
`call_ms` is the median of 20 CUDA-event timings of one call that allocates
the output and launches, as `chip_smoke.py` times a wrapper. Last, the host
time of one `launch_bwd` and one `launch_fwd` call, and of each C entry point
alone, at a shape too small to keep the card busy; and the forward as the main
path calls it, `PairwiseMLPFunction.apply` (b2 included), timed as
`chip_smoke.py` times a wrapper at both shapes, with the host time of one call.
`--wrapper-only` prints only that last line and builds nothing else, from the
package it is run in: a copy of this file in an older tree measures that tree.
Prints one JSON line per build (registers and spills from `ptxas -v`), per
shape and direction and for the host times, and last the card's name and
power limit. Needs a CUDA device and `nvcc`.
"""

from __future__ import annotations

import argparse
import ctypes
import inspect
import json
import re
import statistics
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Dict, List, Tuple

import torch

from graphecho_torch.ops import cuda_build
from graphecho_torch.ops import pairwise_mlp as pm
from graphecho_torch.profile_step import kernel_base_name

SHAPES = ((112, 112, 512), (560, 560, 512))
# the text `no_triples` replaces, and by what
TRIPLES = ("      for (int r = 0; r < TI; ++r) {\n        const float4 gv",
           "      for (int r = 0; r < 0; ++r) {\n        const float4 gv")
# forward variants of this tree's file: the lines put in front of its text
FWD_VARIANTS = {"three_ops": "#define PAIRWISE_FWD_THREE_OPS\n",
                "fwd_big": "#define PAIRWISE_FWD_CONFIG 0\n",
                "fwd_split": "#define PAIRWISE_FWD_CONFIG 1\n"}
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
# the forward entry point of a version whose forward takes no b2; b2 is dropped
FWD_ADAPTER = """
extern "C" int pairwise_mlp_fwd(const float* a, const float* b, const float* w2,
                                const float* b2, float* out, int n1, int n2, int k,
                                void* stream) {
  return pairwise_mlp_fwd_without_b2(a, b, w2, out, n1, n2, k, stream);
}
"""
_FWD_DEF = re.compile(r"int\s+pairwise_mlp_fwd\s*\(([^)]*)\)")


def with_entry_point(text: str) -> str:
    """The source as it is if it has `pairwise_mlp_bwd`, else with the adapter."""
    if re.search(r"\bpairwise_mlp_bwd\s*\(", text):
        return text
    if "pairwise_mlp_bwd_da(" not in text or "pairwise_mlp_bwd_db(" not in text:
        raise ValueError("pairwise_bench: the source has no backward entry point")
    return text + ADAPTER


def adds_b2(text: str) -> bool:
    """Whether the source's `pairwise_mlp_fwd` takes b2."""
    found = _FWD_DEF.search(text)
    if found is None:
        raise ValueError("pairwise_bench: the source has no forward entry point")
    return re.search(r"\bb2\b", found.group(1)) is not None


def with_fwd_entry_point(text: str) -> str:
    """The source as it is if its forward takes b2, else its forward renamed
    and called through the adapter."""
    if adds_b2(text):
        return text
    return _FWD_DEF.sub(lambda m: f"int pairwise_mlp_fwd_without_b2({m.group(1)})", text,
                        count=1) + FWD_ADAPTER


def build(sources: Dict[str, str], workdir: Path) -> Dict[str, Tuple[ctypes.CDLL, List[str]]]:
    """{name: (library, ptxas lines on registers and spills)}, built in parallel."""
    def one(item):
        name, text = item
        src, lib = workdir / f"{name}.cu", workdir / f"lib{name}.so"
        src.write_text(with_fwd_entry_point(with_entry_point(text)))
        stderr = cuda_build.nvcc_compile(src, lib, "-Xptxas", "-v")
        handle = ctypes.CDLL(str(lib))
        p, i = ctypes.c_void_p, ctypes.c_int
        handle.pairwise_mlp_bwd.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, p]
        handle.pairwise_mlp_bwd.restype = ctypes.c_int
        handle.pairwise_mlp_bwd_scratch_floats.argtypes = [i, i, i]
        handle.pairwise_mlp_bwd_scratch_floats.restype = ctypes.c_longlong
        handle.pairwise_mlp_fwd.argtypes = [p, p, p, p, p, i, i, i, p]
        handle.pairwise_mlp_fwd.restype = ctypes.c_int
        info = [ln.strip() for ln in stderr.splitlines()
                if "Compiling entry" in ln or "registers" in ln or "spill" in ln]
        return name, (handle, info)

    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        return dict(pool.map(one, sources.items()))


def time_ms(call, reps: int = 50, warmup: int = 3) -> float:
    for _ in range(warmup):
        cuda_build.check(call(), "pairwise_mlp")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        call()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def call_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of `reps` CUDA-event timings of one call, as `chip_smoke.py`'s
    `cuda_ms` times a wrapper."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms_by_kernel(call, reps: int = 20) -> Dict[str, float]:
    """Device ms per call of each kernel the call launches, from the profiler."""
    cuda_build.check(call(), "pairwise_mlp")
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


def in_turns(calls: Dict[str, Callable[[], int]]) -> Dict[str, float]:
    """ms of each call, the smaller of two rounds, the second in reverse order."""
    ms: Dict[str, float] = {}
    for order in (list(calls), list(calls)[::-1]):
        for name in order:
            ms[name] = min(ms.get(name, float("inf")), time_ms(calls[name]))
    return ms


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
    """Host µs of one `launch_bwd` call, and of the backward's and the
    forward's C entry points alone with the arguments made beforehand, at a
    shape too small to keep the card busy (16 x 16 x 32); `function_numbers`
    has `launch_fwd`'s."""
    a, b = torch.randn(16, 32, device="cuda"), torch.randn(16, 32, device="cuda")
    w2, g = torch.randn(32, device="cuda"), torch.randn(16, 16, device="cuda")
    b2 = torch.tensor(0.2, device="cuda")
    outs = [torch.empty_like(a), torch.empty_like(b), torch.empty(33, device="cuda")]
    scratch = torch.empty(pm._scratch_floats(16, 16, 32), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    args = (a.data_ptr(), b.data_ptr(), w2.data_ptr(), g.data_ptr(), outs[0].data_ptr(),
            outs[1].data_ptr(), outs[2].data_ptr(), outs[2].data_ptr() + 128,
            scratch.data_ptr(), 16, 16, 32, stream)
    out = torch.empty(16, 16, device="cuda")
    fwd_args = (a.data_ptr(), b.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
                16, 16, 32, stream)
    lib = pm._lib()
    return {"launch_bwd_host_us": host_us(lambda: pm.launch_bwd(a, b, w2, g)),
            "c_entry_host_us": host_us(lambda: lib.pairwise_mlp_bwd(*args)),
            "fwd_c_entry_host_us": host_us(lambda: lib.pairwise_mlp_fwd(*fwd_args))}


def function_numbers() -> Dict:
    """`PairwiseMLPFunction.apply(a, b, w2, b2)`, the forward the main path
    calls: `call_ms` of one call at each shape, and the host µs of one call
    and of one `launch_fwd` call (b2 passed where it takes it) at 16 x 16 x 32."""
    out: Dict = {"function_ms": {}}
    for n1, n2, k in SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(n1 + 2 * k)
        a, b = (torch.randn(n, k, device="cuda", generator=gen) for n in (n1, n2))
        w2, b2 = torch.randn(k, device="cuda", generator=gen), torch.tensor(0.2, device="cuda")
        out["function_ms"][f"{n1}x{n2}x{k}"] = call_ms(
            lambda: pm.PairwiseMLPFunction.apply(a, b, w2, b2))
    a, b = torch.randn(16, 32, device="cuda"), torch.randn(16, 32, device="cuda")
    w2, b2 = torch.randn(32, device="cuda"), torch.tensor(0.2, device="cuda")
    out["function_host_us"] = host_us(lambda: pm.PairwiseMLPFunction.apply(a, b, w2, b2))
    takes_b2 = "b2" in inspect.signature(pm.launch_fwd).parameters
    out["launch_fwd_takes_b2"] = takes_b2
    out["launch_fwd_host_us"] = host_us(
        (lambda: pm.launch_fwd(a, b, w2, b2)) if takes_b2 else (lambda: pm.launch_fwd(a, b, w2)))
    return out


def bench_backward(libs, shape, stream) -> Dict:
    n1, n2, k = shape
    gen = torch.Generator(device="cuda").manual_seed(n1 + k)
    a, b = (torch.randn(n, k, device="cuda", generator=gen) for n in (n1, n2))
    w2 = torch.randn(k, device="cuda", generator=gen)
    g = torch.randn(n1, n2, device="cuda", generator=gen)
    want = pm.pairwise_mlp_backward_reference(a, b, w2, g)
    calls, errs = {}, {}
    for name, lib in libs.items():
        outs = [torch.empty_like(a), torch.empty_like(b), torch.empty_like(w2),
                torch.empty(1, device="cuda")]
        scratch = torch.empty(lib.pairwise_mlp_bwd_scratch_floats(n1, n2, k), device="cuda")

        def call(lib=lib, outs=outs, scratch=scratch):
            return lib.pairwise_mlp_bwd(
                a.data_ptr(), b.data_ptr(), w2.data_ptr(), g.data_ptr(),
                *(o.data_ptr() for o in outs), scratch.data_ptr(), n1, n2, k, stream)
        cuda_build.check(call(), name)
        torch.cuda.synchronize()
        errs[name] = {out: (got.reshape(w.shape) - w).abs().max().item()
                      for out, got, w in zip(("dA", "dB", "dw2", "db2"), outs, want)}
        calls[name] = call
    return {"direction": "backward", "shape": list(shape), "ms": in_turns(calls),
            "device_ms_by_kernel": {name: device_ms_by_kernel(c) for name, c in calls.items()},
            "max_abs_err": errs}


def bench_forward(libs, b2_in_kernel, shape, stream) -> Dict:
    n1, n2, k = shape
    gen = torch.Generator(device="cuda").manual_seed(n1 + 2 * k)
    a, b = (torch.randn(n, k, device="cuda", generator=gen) for n in (n1, n2))
    w2 = torch.randn(k, device="cuda", generator=gen)
    b2 = torch.tensor(0.2, device="cuda")
    want = pm.pairwise_mlp(a, b, w2, b2)
    calls, wrapped, errs = {}, {}, {}
    for name, lib in libs.items():
        out = torch.empty(n1, n2, device="cuda")

        def call(lib=lib, out=out):
            return lib.pairwise_mlp_fwd(a.data_ptr(), b.data_ptr(), w2.data_ptr(),
                                        b2.data_ptr(), out.data_ptr(), n1, n2, k, stream)

        def one(lib=lib, adds=b2_in_kernel[name]):
            # what a wrapper does: allocate, launch, and add b2 where the kernel does not
            res = torch.empty(n1, n2, device="cuda")
            lib.pairwise_mlp_fwd(a.data_ptr(), b.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                                 res.data_ptr(), n1, n2, k, stream)
            return res if adds else res + b2
        cuda_build.check(call(), name)
        errs[name] = (one() - want).abs().max().item()
        calls[name], wrapped[name] = call, one
    return {"direction": "forward", "shape": list(shape), "ms": in_turns(calls),
            "call_ms": {name: call_ms(fn) for name, fn in wrapped.items()},
            "device_ms_by_kernel": {name: device_ms_by_kernel(c) for name, c in calls.items()},
            "b2_in_kernel": b2_in_kernel, "max_abs_err": errs}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--source", action="append", default=[], metavar="NAME=FILE.cu",
                        help="another version of csrc/pairwise_mlp.cu to time beside it")
    parser.add_argument("--wrapper-only", action="store_true",
                        help="time only the forward as the main path calls it")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("pairwise_bench needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.wrapper_only:
        print(json.dumps(function_numbers()), flush=True)
        print(nvidia_smi(), flush=True)
        return
    sources = {}
    for item in args.source:
        name, path = item.split("=", 1)
        sources[name] = Path(path).read_text()
    given = list(sources)
    kernel = sources["kernel"] = (cuda_build.CSRC / "pairwise_mlp.cu").read_text()
    if TRIPLES[0] not in kernel:
        raise RuntimeError(f"pairwise_bench: csrc/pairwise_mlp.cu no longer holds {TRIPLES[0]!r}")
    sources["no_triples"] = kernel.replace(*TRIPLES)
    for name, head in FWD_VARIANTS.items():
        sources[name] = head + kernel
    b2_in_kernel = {name: adds_b2(text) for name, text in sources.items()}
    with tempfile.TemporaryDirectory() as tmp:
        built = build(sources, Path(tmp))
        for name, (_, info) in built.items():
            print(json.dumps({"build": name, "ptxas": info}), flush=True)
        libs = {name: lib for name, (lib, _) in built.items()}
        stream = torch.cuda.current_stream().cuda_stream
        bwd = {name: libs[name] for name in given + ["kernel", "no_triples"]}
        fwd = {name: libs[name] for name in given + ["kernel", *FWD_VARIANTS]}
        fwd_b2 = {name: b2_in_kernel[name] for name in fwd}
        for shape in SHAPES:
            print(json.dumps(bench_backward(bwd, shape, stream)), flush=True)
            print(json.dumps(bench_forward(fwd, fwd_b2, shape, stream)), flush=True)
    print(json.dumps(wrapper_host_us()), flush=True)
    print(json.dumps(function_numbers()), flush=True)
    print(nvidia_smi(), flush=True)


def nvidia_smi() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


if __name__ == "__main__":
    main()
