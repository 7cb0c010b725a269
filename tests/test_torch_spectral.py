"""The spectral seed split's dispatch on the CPU: a CPU tensor takes the
plain version (`ops/spectral.py`), never builds or loads `csrc/spectral.cu`
and leaves the launch counter at 0; the kernel's wrapper refuses CPU
tensors before it loads anything. `tests/test_torch_graph_head.py` holds the
plain version to the JAX package; `tests/test_torch_spectral_card.py` holds
the kernel to the plain version on a card. The last case holds the
benchmark's `train.spectral_calls` reader to synthetic trace summaries."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from graphecho_torch.ops import cuda_build, spectral

READER = Path(__file__).resolve().parents[1] / "benchmark" / "metrics" / "train.spectral_calls.py"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def no_build(monkeypatch):
    """Any build or load of a CUDA source fails the test."""
    def refuse(name, *args, **kwargs):
        raise AssertionError(f"csrc/{name}.cu built or loaded for a CPU tensor")

    monkeypatch.setattr(cuda_build, "build", refuse)
    monkeypatch.setattr(cuda_build, "load", refuse)
    spectral.reset_launch_counts()


def _classes(b, nodes, seed, channels=16):
    rng = np.random.RandomState(seed)
    pts = rng.randn(b, nodes, channels).astype(np.float32)
    pts[:, : nodes // 3] += 4.0  # two clusters
    valid = rng.rand(b, nodes) < 0.8
    seed_row = pts[:, 0] + 0.1 * rng.randn(b, channels).astype(np.float32)
    return (torch.from_numpy(seed_row), torch.from_numpy(pts), torch.from_numpy(valid))


@pytest.mark.parametrize("b,nodes", [(5, 112), (1, 112), (3, 9), (2, 1)])
def test_cpu_tensor_takes_the_plain_version(no_build, b, nodes):
    seed, pts, valid = _classes(b, nodes, 40 + b + nodes)
    all_pts = torch.cat([seed[:, None], pts], 1)
    val = torch.cat([torch.ones_like(valid[:, :1]), valid], 1)
    k = (valid.to(torch.int64).sum(-1) // 2).clamp_min(1)
    assign, ok = spectral.spectral_bipartition(all_pts, val, k=k, with_quality=True)

    # the plain pieces composed by hand
    fvalid = val.float()
    lap, deg = spectral._laplacian(all_pts, val, fvalid, k)
    fiedler, residual, missed = spectral._fiedler_lanczos(
        lap, deg, fvalid, m=min(24, max(nodes, 1)), probe_margin=0.05)
    want = spectral._two_means(fiedler, val, 10)
    assert torch.equal(assign, want)
    assert torch.equal(ok, (residual <= 0.05) & ~missed)

    mean, mean_ok = spectral.seed_consistent_mean(seed, pts, valid)
    assert mean.shape == seed.shape and mean_ok.shape == (b,)
    assert spectral.LAUNCHES == {"spectral": 0}


def test_unbatched_cpu_call_takes_the_plain_version(no_build):
    seed, pts, valid = _classes(1, 40, 3)
    mean, ok = spectral.seed_consistent_mean(seed[0], pts[0], valid[0])
    mean_b, ok_b = spectral.seed_consistent_mean(seed, pts, valid)
    assert torch.equal(mean, mean_b[0]) and bool(ok) == bool(ok_b[0])
    assert spectral.LAUNCHES == {"spectral": 0}


def test_two_means_splits_the_valid_values_and_marks_the_rest():
    f = torch.tensor([[0.0, 0.1, 0.9, 1.0, 0.5], [0.3, 0.3, 0.3, 0.3, 7.0]])
    valid = torch.tensor([[True, True, True, True, False], [True, True, True, True, False]])
    # from (0, 1) the first round puts 0.45 on the left; the centers then move
    f2 = torch.tensor([[0.0, 0.45, 0.55, 0.6, 1.0]])
    assert spectral._two_means(f, valid, 10).tolist() == [[0, 0, 1, 1, -1], [0, 0, 0, 0, -1]]
    assert spectral._two_means(f2, torch.ones_like(f2, dtype=torch.bool), 10).tolist() == [
        [0, 0, 1, 1, 1]]


@pytest.mark.parametrize("bad", ["lap", "deg", "fvalid"])
def test_kernel_wrapper_refuses_cpu_tensors_before_loading(no_build, bad):
    lap = torch.eye(6)[None].repeat(2, 1, 1)
    args = {"lap": lap, "deg": torch.ones(2, 6), "fvalid": torch.ones(2, 6)}
    args[bad] = args[bad].double()
    with pytest.raises(ValueError, match="CUDA"):
        spectral.launch_spectral(args["lap"], args["deg"], args["fvalid"], 5)
    assert spectral.LAUNCHES == {"spectral": 0}


def _spectral_calls_reader():
    spec = importlib.util.spec_from_file_location("reader_train_spectral_calls", READER)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def test_spectral_calls_reader_counts_the_spectral_kernels_calls_per_step():
    read = _spectral_calls_reader()
    calls = {"spectral_bipartition_kernel": 12, "knn_kernel": 24, "pairwise_mlp_fwd": 6}
    assert read({"kernel_calls": calls, "units": 3}) == pytest.approx(4.0)
    # a program whose seed split is plain PyTorch launches no such kernel
    assert read({"kernel_calls": {"knn_kernel": 24, "elementwise_kernel": 900},
                 "units": 3}) is None
    assert read({}) is None
    assert read({"kernel_calls": calls, "units": 0}) is None
