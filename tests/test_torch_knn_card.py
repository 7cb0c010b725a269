"""The CUDA kNN-graph kernel (`csrc/knn.cu`) against its plain version on a
GPU; every test skips without one. This file imports no JAX, so it runs on a
card where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_knn_card.py

Random inputs: the kernel's neighbours equal the plain version's in order,
and a position where they differ passes only as a near tie (float64 distance
gap <= 1e-5). They cover the pvig shapes and the kernel's edges: k = 1 and
64, M = k, one query of one image, C = 1 and 1024, and M = 1000 over several
key tiles, and the TGCN's frame-to-hidden-state graph (8 x 64 x 64 x 256,
k 9). Exact ties: inputs whose distances both compute exactly, where the
order must equal the plain version's with no allowance, copies of one key in
one tile and in different tiles, a bias of signed zeros, and the TGCN's
first frame, whose hidden state (the keys) is all zeros. NaN: one NaN
feature in a query row and one in a key row, at the TGCN's shape and a
Grapher's, where the NaN query row takes columns 0..k-1 and the NaN key is
never a neighbour, as in the plain version. Two runs are bit-identical. `tests/test_torch_knn.py` holds the same tie inputs to the JAX
package on the CPU.
"""

import numpy as np
import pytest
import torch

from graphecho_torch.models.vig import relative_pos_buffer
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


pytestmark = pytest.mark.cuda


def _t(x):
    return torch.from_numpy(np.array(x))


def _nodes(b, n, c, seed):
    return np.random.RandomState(seed).randn(b, n, c).astype(np.float32)


def _rel(n, m, seed, batch=1):
    return (np.random.RandomState(seed).randn(batch, n, m) * 0.1).astype(np.float32)


def tie_inputs(kind, b, n, m, c, seed, copies=(3, 7, 9)):
    """Inputs whose distances every version computes exactly (see
    `chip_smoke.knn_tie_inputs`): one-hot rows scaled by powers of two
    (normalized), integer rows (not normalized) or zeros (with no bias, the
    Grapher's for "zero-grapher", or steps of 0.5 whose zeros carry a random
    sign for "signed-zero"), with the key rows `copies` one row three times
    and the made-up biases tied across those columns too."""
    rng = np.random.RandomState(seed)
    mm = n if m is None else m

    def rows(count):
        if kind == "one-hot":
            out = np.zeros((b, count, c), np.float32)
            ch = rng.randint(0, min(c, 8), (b, count))
            scale = 2.0 ** rng.randint(-2, 4, (b, count))
            out[np.arange(b)[:, None], np.arange(count)[None], ch] = scale
            return out
        if kind == "integer":
            return rng.randint(-2, 3, (b, count, c)).astype(np.float32)
        return np.zeros((b, count, c), np.float32)

    x = rows(n)
    y = None if m is None else rows(m)
    keys = x if y is None else y
    first, *others = copies
    keys[:, others] = keys[:, [first]]
    rel = None
    if kind == "one-hot":
        rel = (rng.randint(0, 4, (1, n, mm)) * 0.5).astype(np.float32)
    elif kind == "integer":
        rel = (rng.randint(0, 5, (b, n, mm)) * 0.25).astype(np.float32)
    elif kind == "signed-zero":
        rel = (rng.randint(0, 3, (1, n, mm)) * 0.5).astype(np.float32)
        rel[(rel == 0) & (rng.rand(1, n, mm) < 0.5)] = -0.0
    if rel is not None:
        rel[..., others] = rel[..., [first]]
    if kind == "zero-grapher":
        rel = relative_pos_buffer(c, n, mm, torch.device("cpu")).numpy()
    return x, y, rel, kind != "integer"


def check_copies_of_key_3(idx, copies=(3, 7, 9)):
    """Wherever the three copies of key 3 are all neighbours, they come in
    column order, with nothing between them but keys tied with them, in
    ascending columns."""
    seen = 0
    first, middle, last = copies
    for row in np.asarray(idx).reshape(-1, idx.shape[-1]).tolist():
        if set(copies) <= set(row):
            run = row[row.index(first):row.index(last) + 1]
            assert middle in run and run == sorted(run), row
            seen += 1
    assert seen > 0


@pytest.mark.parametrize("kind,b,n,m,c,k,copies", [
    ("one-hot", 2, 300, 200, 37, 45, (3, 7, 9)),
    ("integer", 2, 500, None, 24, 16, (3, 7, 9)),
    ("zero", 2, 196, None, 400, 18, (3, 7, 9)),
    ("zero-grapher", 2, 196, None, 400, 18, (3, 7, 9)),
    ("integer", 2, 300, 1000, 24, 64, (3, 500, 999)),  # copies in three key tiles
    ("signed-zero", 2, 196, None, 40, 27, (3, 7, 9)),
])
def test_kernel_keeps_exact_ties_on_card(kind, b, n, m, c, k, copies):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the knn kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    x, y, rel, normalize = tie_inputs(kind, b, n, m, c, 41, copies)
    x = _t(x).cuda()
    y = None if y is None else _t(y).cuda()
    rel = None if rel is None else _t(rel).cuda()
    got = tknn.launch_knn(x, y, k, normalize, rel)
    # exact ties: the same order as the plain version, with no near-tie allowance
    assert torch.equal(got, tknn.knn_reference(x, y, k, normalize, rel))
    assert torch.equal(got, tknn.launch_knn(x, y, k, normalize, rel))
    if kind == "zero":
        assert bool((got == torch.arange(k, device=got.device, dtype=torch.int32)).all())
    if kind != "zero-grapher":  # the Grapher's bias unties the copies
        check_copies_of_key_3(got.cpu().numpy(), copies)


@pytest.mark.parametrize("b,n,m,c,k,normalize,rel_batch", [
    (2, 300, None, 37, 16, True, 0),       # ragged self graph, no bias
    (2, 300, 70, 80, 9, True, 1),          # pooled keys, shared bias
    (3, 49, None, 640, 27, False, 3),      # last pvig stage, per-image bias
    (2, 300, 196, 80, 1, True, 1),         # k = 1
    (2, 300, 196, 80, 64, True, 2),        # k = 64, the largest
    (2, 200, 27, 64, 27, True, 0),         # M = k
    (1, 1, 196, 400, 18, True, 1),         # one query of one image
    (2, 300, 196, 1, 9, False, 0),         # C = 1
    (2, 49, None, 1024, 27, True, 1),      # C = 1024, pvig_b's last stage
    (1, 300, 1000, 37, 16, True, 1),       # M = 1000: several key tiles
    (8, 64, 64, 256, 9, True, 0),          # the TGCN: frame nodes to the hidden state
])
def test_kernel_matches_plain_on_card(b, n, m, c, k, normalize, rel_batch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the knn kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    x = (torch.from_numpy(_nodes(b, n, c, 15)) * 0.1).cuda()
    y = None if m is None else (torch.from_numpy(_nodes(b, m, c, 16)) * 0.1).cuda()
    rel = None if rel_batch == 0 else _t(_rel(n, m or n, 17, rel_batch)).cuda()
    got = tknn.launch_knn(x, y, k, normalize, rel)
    want = tknn.knn_reference(x, y, k, normalize, rel)
    assert torch.equal(got, tknn.launch_knn(x, y, k, normalize, rel))
    # positions that differ must be near ties in float64
    _, gap = tknn.knn_tie_gap(x, y, rel, normalize, got, want)
    assert gap <= 1e-5


def test_kernel_on_the_tgcn_first_frame_takes_the_first_k_keys():
    """Frame 0 of the TGCN: the hidden state is all zeros, so every distance
    of a row ties and the neighbours are columns 0..8 in order, exactly as
    the plain version gives them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the knn kernel has no CPU mode")
    x = torch.from_numpy(_nodes(8, 64, 256, 18)).cuda()
    y = torch.zeros(8, 64, 256, device="cuda")
    got = tknn.launch_knn(x, y, 9, True, None)
    assert torch.equal(got, tknn.knn_reference(x, y, 9, True, None))
    assert bool((got == torch.arange(9, device="cuda", dtype=torch.int32)).all())


@pytest.mark.parametrize("b,n,m,c,k,grapher", [
    (8, 64, 64, 256, 9, False),     # the TGCN's graph
    (2, 3136, 196, 80, 9, True),    # pvig_s Graphers 0-1, with their bias
])
def test_kernel_on_nan_input_matches_plain_on_card(b, n, m, c, k, grapher):
    """One NaN feature in query row (0, 5) and one in key row (b - 1, 11):
    the NaN query row gets columns 0..k-1 and key 11 of the last image is
    never a neighbour, as in the plain version (NaN sorts last, stably);
    every other row within the near-tie rule."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the knn kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    x = torch.from_numpy(_nodes(b, n, c, 19)).cuda()
    y = torch.from_numpy(_nodes(b, m, c, 20)).cuda()
    x[0, 5, 7] = float("nan")
    y[b - 1, 11, 3] = float("nan")
    rel = relative_pos_buffer(c, n, m, x.device) if grapher else None
    got = tknn.launch_knn(x, y, k, True, rel)
    want = tknn.knn_reference(x, y, k, True, rel)
    assert torch.equal(got[0, 5], torch.arange(k, device="cuda", dtype=torch.int32))
    assert torch.equal(got[0, 5], want[0, 5])
    assert not bool((got[b - 1] == 11).any()) and not bool((want[b - 1] == 11).any())
    _, gap = tknn.knn_tie_gap(x, y, rel, True, got, want)
    assert gap <= 1e-5
