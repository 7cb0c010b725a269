"""The CUDA pairwise-MLP kernels (`csrc/pairwise_mlp.cu`) against their plain
version on a GPU; every test skips without one. This file imports no JAX, so
it runs on a card where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_pairwise_mlp_card.py

Forward atol 1e-4 and gradients rtol/atol 1e-3, the JAX package's own bounds
for its interpret-vs-XLA test; two backward runs are bit-identical.
`tests/test_torch_pairwise_mlp.py` holds the plain version to the JAX package
on the CPU.
"""

import numpy as np
import pytest
import torch

from graphecho_torch.ops import pairwise_mlp as pm

pytestmark = pytest.mark.cuda


def _inputs(n1, n2, k, seed=11):
    rng = np.random.RandomState(seed)
    return (rng.randn(n1, k).astype(np.float32), rng.randn(n2, k).astype(np.float32),
            rng.randn(k).astype(np.float32), np.float32(0.2),
            rng.randn(n1, n2).astype(np.float32))


@pytest.mark.parametrize("n1,n2,k", [(70, 50, 40), (112, 112, 512), (560, 560, 512)])
def test_kernels_match_plain_on_card(n1, n2, k):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    a, b, w2, b2, g = (torch.from_numpy(np.asarray(x)).cuda() for x in _inputs(n1, n2, k))
    got = pm.PairwiseMLPFunction.apply(a, b, w2, b2)
    np.testing.assert_allclose(got.cpu().numpy(), pm.pairwise_mlp(a, b, w2, b2).cpu().numpy(),
                               atol=1e-4)
    da, dw2, db2 = pm.launch_bwd_da(a, b, w2, g)
    db = pm.launch_bwd_db(a, b, w2, g)
    want = pm.pairwise_mlp_backward_reference(a, b, w2, g)
    for name, x, w in zip(("dA", "dB", "dw2", "db2"), (da, db, dw2, db2[0]), want):
        np.testing.assert_allclose(x.cpu().numpy(), w.cpu().numpy(), rtol=1e-3, atol=1e-3,
                                   err_msg=name)
    again = pm.launch_bwd_da(a, b, w2, g)
    assert all(torch.equal(x, y) for x, y in zip((da, dw2, db2), again))
