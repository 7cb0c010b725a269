"""The CUDA pairwise-MLP kernels (`csrc/pairwise_mlp.cu`) against their plain
version on a GPU; every test skips without one. This file imports no JAX, so
it runs on a card where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_pairwise_mlp_card.py

Forward atol 1e-4 and gradients rtol/atol 1e-3, the JAX package's own bounds
for its interpret-vs-XLA test; two backward runs are bit-identical in all
four outputs. On integer inputs, where every version's sums are exact, the
backward equals the plain version bit for bit.
`tests/test_torch_pairwise_mlp.py` holds the plain version to the JAX package
on the CPU.
"""

import numpy as np
import pytest
import torch

from graphecho_torch.ops import pairwise_mlp as pm

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
