"""Port of the pairwise-MLP affinity op against the JAX package.

The port's plain version (`graphecho_torch.ops.pairwise_mlp.pairwise_mlp`)
and its backward formulas run here on the CPU against the JAX XLA path
(`graphecho_tpu.ops.pairwise_mlp.pairwise_mlp`) and the Pallas kernel in
interpret mode, on the same numpy inputs. The CUDA kernels themselves run
only on a GPU: `tests/test_torch_pairwise_mlp_card.py` holds them to the
plain version there and skips elsewhere; `chip_smoke.py` does the same at the
paper's shapes.

Tolerances: forward atol 1e-4, gradients rtol/atol 1e-3, those of the JAX
package's own interpret-vs-XLA test (`tests/test_graph_matching.py:487,495`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphecho_tpu.ops.pairwise_mlp import pairwise_mlp as jax_pairwise_mlp
from graphecho_tpu.ops.pallas.pairwise_mlp_kernel import pallas_pairwise_mlp

from graphecho_torch.ops import pairwise_mlp as pm

SHAPES = [(70, 50, 40), (112, 112, 128)]


def report_parity(what, got, want):
    """One line for the parity table in PERF.md (`pytest -s ... | grep PARITY`)."""
    err = np.max(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)))
    print(f"PARITY {what} max_abs_err={err:.3g}")


def _inputs(n1, n2, k, seed=11):
    rng = np.random.RandomState(seed)
    return (rng.randn(n1, k).astype(np.float32), rng.randn(n2, k).astype(np.float32),
            rng.randn(k).astype(np.float32), np.float32(0.2),
            rng.randn(n1, n2).astype(np.float32))


@pytest.mark.parametrize("n1,n2,k", SHAPES)
def test_plain_forward_matches_jax_and_pallas_interpret(n1, n2, k):
    a, b, w2, b2, _ = _inputs(n1, n2, k)
    got = pm.pairwise_mlp(*(torch.from_numpy(np.asarray(x)) for x in (a, b, w2, b2)))
    want_xla = jax_pairwise_mlp(a, b, w2, b2)
    want_pallas = pallas_pairwise_mlp(jnp.asarray(a), jnp.asarray(b), jnp.asarray(w2),
                                      jnp.asarray(b2), True)
    report_parity(f"pairwise_mlp fwd {n1}x{n2}x{k} vs XLA", got.numpy(), want_xla)
    report_parity(f"pairwise_mlp fwd {n1}x{n2}x{k} vs Pallas interpret", got.numpy(), want_pallas)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_xla), atol=1e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_pallas), atol=1e-4)


@pytest.mark.parametrize("n1,n2,k", SHAPES)
def test_backward_reference_and_autograd_match_jax_grad(n1, n2, k):
    a, b, w2, b2, g = _inputs(n1, n2, k, seed=3)
    _, vjp = jax.vjp(jax_pairwise_mlp, jnp.asarray(a), jnp.asarray(b), jnp.asarray(w2),
                     jnp.asarray(b2))
    want = [np.asarray(x) for x in vjp(jnp.asarray(g))]

    ta, tb, tw2, tb2 = (torch.tensor(np.asarray(x), requires_grad=True)
                        for x in (a, b, w2, b2))
    tg = torch.from_numpy(g)
    formulas = pm.pairwise_mlp_backward_reference(ta.detach(), tb.detach(), tw2.detach(), tg)
    pm.pairwise_mlp(ta, tb, tw2, tb2).backward(tg)
    autograd = (ta.grad, tb.grad, tw2.grad, tb2.grad)
    for name, f, ag, w in zip(("dA", "dB", "dw2", "db2"), formulas, autograd, want):
        report_parity(f"pairwise_mlp {name} {n1}x{n2}x{k} vs jax.vjp", f.numpy(), w)
        np.testing.assert_allclose(f.numpy(), w, rtol=1e-3, atol=1e-3, err_msg=name)
        np.testing.assert_allclose(ag.numpy(), w, rtol=1e-3, atol=1e-3, err_msg=name)


def test_cpu_tensor_takes_the_plain_version_and_launches_nothing():
    a, b, w2, b2, g = _inputs(70, 50, 40)
    pm.reset_launch_counts()
    ta, tb, tw2, tb2 = (torch.tensor(np.asarray(x), requires_grad=True)
                        for x in (a, b, w2, b2))
    out = pm.pairwise_mlp_auto(ta, tb, tw2, tb2)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jax_pairwise_mlp(a, b, w2, b2)),
                               atol=1e-4)
    assert ta.grad is not None and tb2.grad is not None
    assert pm.LAUNCHES == {"pairwise_mlp_fwd": 0, "pairwise_mlp_bwd_da": 0,
                           "pairwise_mlp_bwd_db": 0}


def test_kernel_wrappers_refuse_cpu_tensors():
    a, b, w2, _, g = (torch.from_numpy(np.asarray(x)) for x in _inputs(8, 8, 8))
    with pytest.raises(ValueError, match="CUDA"):
        pm.launch_fwd(a, b, w2)
    with pytest.raises(ValueError, match="CUDA"):
        pm.launch_bwd_db(a, b, w2, g)

