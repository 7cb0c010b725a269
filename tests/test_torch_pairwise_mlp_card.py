"""The CUDA pairwise-MLP kernels (`csrc/pairwise_mlp.cu`) against their plain
version on a GPU; every test skips without one. This file imports no JAX, so
it runs on a card where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_pairwise_mlp_card.py

Forward atol 1e-4 and gradients rtol/atol 1e-3, the JAX package's own bounds
for its interpret-vs-XLA test; two runs of each are bit-identical in every
output. On integer inputs, where every version's sums are exact, the forward
and the backward equal the plain version bit for bit. A NaN in a or b gives
NaN in the forward exactly where the plain version (and `jnp.maximum` in the
JAX package) has it. The forward's shape classes are each run with ragged
rows and columns, and on both sides of the plan's switch points.
`tests/test_torch_pairwise_mlp.py` holds the plain version to the JAX package
on the CPU.
"""

import numpy as np
import pytest
import torch

from graphecho_torch.ops import pairwise_mlp as pm


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and torch's default of a thread per core oversubscribes the machine
    (tens of times slower under load)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


pytestmark = pytest.mark.cuda

NAMES = ("dA", "dB", "dw2", "db2")


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


def _inputs(n1, n2, k, seed=11):
    rng = np.random.RandomState(seed)
    return (rng.randn(n1, k).astype(np.float32), rng.randn(n2, k).astype(np.float32),
            rng.randn(k).astype(np.float32), np.float32(0.2),
            rng.randn(n1, n2).astype(np.float32))


def _check_backward(a, b, w2, g, exact=False):
    """`launch_bwd` against the plain formulas, and a second run bit-identical."""
    got = pm.launch_bwd(a, b, w2, g)
    want = pm.pairwise_mlp_backward_reference(a, b, w2, g)
    for name, x, w in zip(NAMES, got, want):
        x, w = x.cpu().numpy(), w.reshape(x.shape).cpu().numpy()
        if exact:
            np.testing.assert_array_equal(x, w, err_msg=name)
        else:
            np.testing.assert_allclose(x, w, rtol=1e-3, atol=1e-3, err_msg=name)
    again = pm.launch_bwd(a, b, w2, g)
    for name, x, y in zip(NAMES, got, again):
        assert torch.equal(x, y), f"{name}: two runs differ in their bits"
    return got


@pytest.mark.parametrize("n1,n2,k", [(70, 50, 40), (112, 112, 512), (560, 560, 512),
                                     (112, 112, 1), (112, 112, 513), (1, 112, 512),
                                     (112, 1, 512), (560, 112, 512)])
def test_kernels_match_plain_on_card(n1, n2, k):
    _need_card()
    a, b, w2, b2, g = (torch.from_numpy(np.asarray(x)).cuda() for x in _inputs(n1, n2, k))
    got = pm.PairwiseMLPFunction.apply(a, b, w2, b2)
    np.testing.assert_allclose(got.cpu().numpy(), pm.pairwise_mlp(a, b, w2, b2).cpu().numpy(),
                               atol=1e-4)
    _check_backward(a, b, w2, g)


@pytest.mark.parametrize("case", ["zero_g", "zeros_in_w2"])
def test_backward_on_zero_inputs(case):
    _need_card()
    a, b, w2, _, g = (torch.from_numpy(np.asarray(x)).cuda() for x in _inputs(112, 112, 512))
    if case == "zero_g":
        g = torch.zeros_like(g)
    else:
        w2 = torch.where(torch.arange(512, device="cuda") % 3 == 0, 0.0, w2)
    da, db, dw2, db2 = _check_backward(a, b, w2, g)
    if case == "zero_g":
        assert not any(bool(x.any()) for x in (da, db, dw2, db2))
    else:  # dw2 does not go through w2, so its zero columns lose nothing
        zero = torch.arange(512, device="cuda") % 3 == 0
        assert not bool(da[:, zero].any()) and not bool(db[:, zero].any())
        assert bool((dw2[zero] != 0).all())


@pytest.mark.parametrize("n1,n2,k", [(560, 560, 512), (70, 50, 40), (1, 112, 513)])
def test_backward_exact_on_integer_inputs(n1, n2, k):
    """Integer a, b in [-4, 4] (many a+b exactly 0), g in [-3, 3], w2 in
    [-2, 2]: every sum stays below 2^24, so the kernel must equal the plain
    version bit for bit, the mask at a+b = 0 included."""
    _need_card()
    rng = np.random.RandomState(5)
    a, b = (torch.from_numpy(rng.randint(-4, 5, (n, k)).astype(np.float32)).cuda()
            for n in (n1, n2))
    w2 = torch.from_numpy(rng.randint(-2, 3, k).astype(np.float32)).cuda()
    g = torch.from_numpy(rng.randint(-3, 4, (n1, n2)).astype(np.float32)).cuda()
    assert bool(((a[:, None, :] + b[None, :, :]) == 0).any())
    _check_backward(a, b, w2, g, exact=True)


def _integer_inputs(n1, n2, k, seed=5):
    """a, b in [-4, 4] (many a+b exactly 0), w2 in [-2, 2], b2 = 0.25: every
    sum is below 2^24, so each version computes it exactly."""
    rng = np.random.RandomState(seed)
    a, b = (torch.from_numpy(rng.randint(-4, 5, (n, k)).astype(np.float32)).cuda()
            for n in (n1, n2))
    w2 = torch.from_numpy(rng.randint(-2, 3, k).astype(np.float32)).cuda()
    return a, b, w2, torch.tensor(0.25, device="cuda")


def _check_forward(a, b, w2, b2, exact=False):
    """`launch_fwd` (b2 added in the kernel) against the plain version, and a
    second run bit-identical."""
    got = pm.launch_fwd(a, b, w2, b2)
    want = pm.pairwise_mlp(a, b, w2, b2)
    if exact:
        assert torch.equal(got, want), f"max abs err {(got - want).abs().max().item()}"
    else:
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=1e-4)
    assert torch.equal(got, pm.launch_fwd(a, b, w2, b2)), "two runs differ in their bits"
    return got


def _plan(n1, n2, k):
    return pm._lib().pairwise_mlp_fwd_plan(n1, n2, k)


@pytest.mark.parametrize("n1,n2,k", [(560, 560, 512), (70, 50, 40), (1, 112, 513)])
def test_forward_exact_on_integer_inputs(n1, n2, k):
    _need_card()
    a, b, w2, b2 = _integer_inputs(n1, n2, k)
    assert bool(((a[:, None, :] + b[None, :, :]) == 0).any())
    _check_forward(a, b, w2, b2, exact=True)


@pytest.mark.parametrize("n1,n2,k", [(112, 112, 512), (560, 560, 512)])
def test_forward_keeps_nan_where_the_plain_version_does(n1, n2, k):
    """NaN in one row of a and one row of b: NaN in that row and that column of
    the output, nowhere else, and equal values within atol 1e-4 elsewhere (the
    fault this repairs: `fmaxf(nan, 0)` is 0, so the NaN dropped out)."""
    _need_card()
    a, b, w2, b2, _ = (torch.from_numpy(np.asarray(x)).cuda() for x in _inputs(n1, n2, k))
    a[5, 7] = float("nan")
    b[n2 - 3, 11] = float("nan")
    got = pm.PairwiseMLPFunction.apply(a, b, w2, b2)
    want = pm.pairwise_mlp(a, b, w2, b2)
    nan = torch.isnan(want)
    assert bool(nan[5].all()) and bool(nan[:, n2 - 3].all()) and int(nan.sum()) == n1 + n2 - 1
    assert torch.equal(torch.isnan(got), nan)
    np.testing.assert_allclose(got[~nan].cpu().numpy(), want[~nan].cpu().numpy(), atol=1e-4)


# (n1, n2, k, the class the plan picks: 0 for 48 x 56 tiles, 1 for 16 x 8):
# each side of the switch point of square shapes at k = 512, and each class
# with ragged rows and a ragged k (a multiple of 4, and not: the 16-byte and
# the 4-byte copies)
PLAN_CASES = [(312, 312, 512, 1), (313, 313, 512, 0), (450, 430, 516, 0), (449, 431, 515, 0),
              (150, 161, 260, 1), (150, 161, 259, 1), (70, 50, 40, 1), (33, 17, 1, 1),
              (560, 112, 512, 1)]


@pytest.mark.parametrize("n1,n2,k,cls", PLAN_CASES,
                         ids=[f"{n1}x{n2}x{k}" for n1, n2, k, _ in PLAN_CASES])
def test_forward_in_every_shape_class(n1, n2, k, cls):
    _need_card()
    assert _plan(n1, n2, k) == cls
    a, b, w2, b2, _ = (torch.from_numpy(np.asarray(x)).cuda() for x in _inputs(n1, n2, k))
    _check_forward(a, b, w2, b2)
    _check_forward(*_integer_inputs(n1, n2, k), exact=True)


def test_forward_is_one_launch_with_b2():
    """`PairwiseMLPFunction.forward` launches the kernel once and nothing else:
    b2 is added in its epilogue."""
    _need_card()
    a, b, w2, b2, _ = (torch.from_numpy(np.asarray(x)).cuda() for x in _inputs(112, 112, 512))
    pm.PairwiseMLPFunction.apply(a, b, w2, b2)  # built and warm
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        got = pm.PairwiseMLPFunction.apply(a, b, w2, b2)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 1 and "pairwise_fwd_kernel" in kernels[0], kernels
    np.testing.assert_allclose(got.cpu().numpy(), pm.pairwise_mlp(a, b, w2, b2).cpu().numpy(),
                               atol=1e-4)
