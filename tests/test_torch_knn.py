"""kNN graph ops of the port against the JAX package, on the CPU.

The port's plain versions (`graphecho_torch.ops.knn`) run on the same numpy
inputs as the JAX XLA path (`graphecho_tpu.ops.knn`) and the Pallas kernel
`pallas_knn` in interpret mode. Neighbour indices must agree exactly and in
order, ties included (lowest column first), because the dilated graph picks
candidates by rank. Distances agree within atol 1e-5 (f32 sums of 16-32
products). The CUDA kernel (`csrc/knn.cu`) runs only on a GPU:
`tests/test_torch_knn_card.py` holds it to the plain version there and skips
elsewhere; `chip_smoke.py` does the same at the pvig_s shapes. The exact-tie
inputs of that file go through the JAX package here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphecho_tpu.ops import knn as jknn
from graphecho_tpu.ops.pallas.knn_kernel import pallas_knn

from test_torch_knn_card import check_copies_of_key_3, tie_inputs
from test_torch_pairwise_mlp import report_parity

from graphecho_torch.ops import knn as tknn


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and torch's default of a thread per core oversubscribes the machine
    (tens of times slower under load)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(x):
    return torch.from_numpy(np.array(x))


def _nodes(b, n, c, seed):
    return np.random.RandomState(seed).randn(b, n, c).astype(np.float32)


def _rel(n, m, seed, batch=1):
    return (np.random.RandomState(seed).randn(batch, n, m) * 0.1).astype(np.float32)


@pytest.mark.parametrize("self_graph", [True, False], ids=["self", "xy"])
def test_pairwise_distance_and_normalize_match_jax(self_graph):
    # unit-scale rows, as the normalized ViG nodes are: distances O(1)
    x = _nodes(2, 30, 16, 0) * 0.25
    y = None if self_graph else _nodes(2, 20, 16, 1) * 0.25
    got = tknn.pairwise_sq_distance(_t(x), None if y is None else _t(y))
    want = jknn.pairwise_sq_distance(jnp.asarray(x), None if y is None else jnp.asarray(y))
    report_parity(f"pairwise_sq_distance {'self' if self_graph else 'xy'}", got.numpy(), want)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)

    x[0, 3] = 0.0  # a zero row: the 1e-12 floor keeps it zero
    got_n = tknn.l2_normalize(_t(x))
    want_n = jknn.l2_normalize(jnp.asarray(x))
    report_parity("l2_normalize", got_n.numpy(), want_n)
    np.testing.assert_allclose(got_n.numpy(), np.asarray(want_n), atol=1e-6)
    assert not got_n[0, 3].any()


@pytest.mark.parametrize("n_part", [10000, 7], ids=["whole", "chunked"])
@pytest.mark.parametrize("with_rel", [False, True], ids=["no_rel", "rel"])
def test_dense_knn_matches_jax_in_order(n_part, with_rel):
    x = _nodes(2, 30, 8, 2)
    y = _nodes(2, 24, 8, 3)
    rel = _rel(30, 24, 4) if with_rel else None
    got = tknn.dense_knn(_t(x), _t(y), 6, None if rel is None else _t(rel), n_part=n_part)
    want = jknn.dense_knn(jnp.asarray(x), jnp.asarray(y), 6,
                          None if rel is None else jnp.asarray(rel), n_part=n_part)
    assert got.dtype == torch.int32 and got.shape == (2, 30, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dilation", [1, 2, 3])
@pytest.mark.parametrize("with_rel", [False, True], ids=["no_rel", "rel"])
@pytest.mark.parametrize("self_graph", [True, False], ids=["self", "xy"])
def test_dilated_knn_graph_matches_jax_and_pallas_interpret(dilation, with_rel, self_graph):
    k = 4
    x = _nodes(2, 40, 16, 10 + dilation)
    y = None if self_graph else _nodes(2, 24, 16, 20 + dilation)
    m = 40 if self_graph else 24
    rel = _rel(40, m, 30 + dilation) if with_rel else None
    jy = None if y is None else jnp.asarray(y)
    jrel = None if rel is None else jnp.asarray(rel)
    got = tknn.dilated_knn_graph(_t(x), None if y is None else _t(y), k, dilation,
                                 None if rel is None else _t(rel))
    want = jknn.dilated_knn_graph(jnp.asarray(x), jy, k, dilation, jrel)
    pallas = pallas_knn(jnp.asarray(x), jy, k=k * dilation, normalize=True,
                        relative_pos=jrel, block_q=8, interpret=True)[..., ::dilation]
    assert got.shape == (2, 40, k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))
    # the plain version of the kernel, undilated, is the Pallas kernel's output
    full = tknn.knn_reference(_t(x), None if y is None else _t(y), k * dilation, True,
                              None if rel is None else _t(rel))
    np.testing.assert_array_equal(full[..., ::dilation].numpy(), got.numpy())


def test_exact_ties_go_to_the_lowest_column():
    rng = np.random.RandomState(5)
    y = rng.randn(1, 12, 4).astype(np.float32)
    y[0, 7] = y[0, 3]
    y[0, 9] = y[0, 3]
    x = rng.randn(1, 6, 4).astype(np.float32)
    got = tknn.dense_knn(_t(x), _t(y), 12)
    want = jknn.dense_knn(jnp.asarray(x), jnp.asarray(y), 12)
    pallas = pallas_knn(jnp.asarray(x), jnp.asarray(y), k=12, normalize=False, block_q=8,
                        interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))
    for row in got[0].tolist():  # the duplicates come together, lowest column first
        at = row.index(3)
        assert row[at:at + 3] == [3, 7, 9]

    # all distances equal: the first k columns in order, in all three
    zeros = np.zeros((2, 10, 4), np.float32)
    want = np.broadcast_to(np.arange(5, dtype=np.int32), (2, 10, 5))
    for idx in (tknn.dilated_knn_graph(_t(zeros), k=5),
                jknn.dilated_knn_graph(jnp.asarray(zeros), k=5),
                pallas_knn(jnp.asarray(zeros), k=5, block_q=8, interpret=True)):
        np.testing.assert_array_equal(np.asarray(idx), want)


def test_stochastic_graph_takes_one_permutation_for_the_batch():
    x = _t(_nodes(3, 20, 8, 6))
    full = tknn.dilated_knn_graph(x, k=12)
    perm = torch.randperm(12, generator=torch.Generator().manual_seed(4))[:4]
    got = tknn.dilated_knn_graph(x, k=4, dilation=3, stochastic=True,
                                 generator=torch.Generator().manual_seed(4))
    assert torch.equal(got, full[..., perm])


def test_gather_neighbors_and_reference_format_match_jax():
    y = _nodes(2, 9, 5, 7)
    idx = np.random.RandomState(8).randint(0, 9, (2, 6, 3)).astype(np.int32)
    got = tknn.gather_neighbors(_t(y), _t(idx))
    want = jknn.gather_neighbors(jnp.asarray(y), jnp.asarray(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    x = _nodes(2, 12, 4, 9)
    nn_idx, center = tknn.knn_edges_reference_format(_t(x), None, 3)
    j_idx, j_center = jknn.knn_edges_reference_format(jnp.asarray(x), None, 3)
    np.testing.assert_array_equal(nn_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(center.numpy(), np.asarray(j_center))


def test_cpu_tensor_takes_the_plain_version_and_launches_nothing():
    tknn.reset_launch_counts()
    x = _t(_nodes(2, 20, 8, 12))
    rel = _t(_rel(20, 20, 13))
    got = tknn.dilated_knn_graph(x, k=3, dilation=2, relative_pos=rel)
    want = jknn.dilated_knn_graph(jnp.asarray(x.numpy()), k=3, dilation=2,
                                  relative_pos=jnp.asarray(rel.numpy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tknn.LAUNCHES == {"knn": 0}


def test_kernel_wrapper_refuses_cpu_tensors():
    x = _t(_nodes(1, 8, 4, 14))
    with pytest.raises(ValueError, match="CUDA"):
        tknn.launch_knn(x, k=3)


@pytest.mark.parametrize("kind", ["one-hot", "integer", "zero", "signed-zero"])
def test_exact_tie_inputs_match_jax_and_pallas_interpret(kind):
    k = 12
    x, y, rel, normalize = tie_inputs(kind, 2, 24, None if kind == "integer" else 20, 11, 40)
    jy = None if y is None else jnp.asarray(y)
    jrel = None if rel is None else jnp.asarray(rel)
    got = tknn.knn_reference(_t(x), None if y is None else _t(y), k, normalize,
                             None if rel is None else _t(rel))
    pallas = pallas_knn(jnp.asarray(x), jy, k=k, normalize=normalize, relative_pos=jrel,
                        block_q=8, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))
    if normalize:
        want = jknn.dilated_knn_graph(jnp.asarray(x), jy, k, 1, jrel)
    else:
        want = jknn.dense_knn(jnp.asarray(x), jy, k, jrel)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    check_copies_of_key_3(got)
    if kind == "zero":
        np.testing.assert_array_equal(got.numpy(), np.broadcast_to(np.arange(k), got.shape))
