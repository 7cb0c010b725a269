"""The CUDA spectral seed split (`csrc/spectral.cu`) against its plain
version on a GPU; every test skips without one. This file imports no JAX, so
it runs on a card where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_spectral_card.py

The plain version (`ops/spectral.py::_fiedler_lanczos` and `_two_means`)
runs on the same card tensors. Random classes at both recipes' shapes
(B = 5 and B = 1, n = 1 seed + 112 nodes) over 200 seeds each, and B = 5 at
n = 300 (the Laplacian read from L2): two Gaussian clusters of random
separation and sizes, random validity (full, partial, a handful). On every
row whose 2-means margin, Paige-residual margin and probe margin all exceed
1e-4, the kernel's partition equals the plain one up to a label swap and its
`solve_ok` equals the plain one. On every row the Ritz value is within 1e-5
relative (1e-6 absolute near 0) of the plain float32 `eigh`'s, and the
Fiedler vector within 1e-4 of the plain one up to its sign. Edge cases:
only the seed valid, 1-5 valid nodes, n - 1 < 24 (the probe is then not
live), a complete graph (Lanczos breaks down after one step), invalid rows.
Two launches are bit-identical; `spectral_bipartition` on a card is one
kernel and no `eigh` and no synchronisation; `seed_consistent_mean` on the
card equals the plain one on the CPU.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from graphecho_torch.ops import spectral

pytestmark = pytest.mark.cuda

TOL = 0.05           # ritz_tol, the probe's margin too
MARGIN = 1e-4        # rows closer than this to a decision are not compared
NODES = 112          # nodes_per_class of both recipes
SEEDS = 200


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the spectral kernel has no CPU mode")
    return torch.device("cuda")


def classes(b, nodes, seed, channels=64):
    """(seed (B, C), nodes (B, nodes, C), valid (B, nodes)) as the GModule
    hands them to `seed_consistent_mean`: per class two Gaussian clusters
    of random separation and sizes, the seed near one of them, and a random
    number of valid nodes (all, most, a handful)."""
    rng = np.random.RandomState(seed)
    pts = rng.randn(b, nodes, channels).astype(np.float32)
    seeds = rng.randn(b, channels).astype(np.float32) * 0.3
    valid = np.ones((b, nodes), bool)
    for i in range(b):
        # |x - y|^2 within a cluster is 2C +- (8C)^(1/2): a shift of (8C)^(1/4)
        # begins to part the kNN ranks
        shift = rng.randn(channels).astype(np.float32)
        shift *= rng.uniform(0.0, 3.0) * (8.0 * channels) ** 0.25 / np.linalg.norm(shift)
        side = rng.rand(nodes) < rng.uniform(0.2, 0.8)
        pts[i, side] += shift
        seeds[i] += shift if rng.rand() < 0.5 else 0.0
        kind = rng.randint(6)
        if kind == 0:
            valid[i] = rng.rand(nodes) < rng.uniform(0.3, 0.9)
        elif kind == 1:
            valid[i] = False
            valid[i, rng.choice(nodes, rng.randint(0, 6), replace=False)] = True
    return (torch.from_numpy(seeds), torch.from_numpy(pts), torch.from_numpy(valid))


def laplacians(seed, nodes, valid, device):
    """What `spectral_bipartition` hands the solve for `seed_consistent_mean`'s
    call: (lap, deg, fvalid, valid) of [seed; nodes] on `device`."""
    seed, nodes, valid = seed.to(device), nodes.to(device), valid.to(device)
    pts = torch.cat([seed[:, None, :], nodes], dim=1)
    val = torch.cat([torch.ones_like(valid[:, :1]), valid], dim=1)
    k = (valid.to(torch.int64).sum(-1) // 2).clamp_min(1)
    fvalid = val.to(torch.float32)
    lap, deg = spectral._laplacian(pts, val, fvalid, k)
    return lap, deg, fvalid, val


def steps(n):
    return min(24, max(n - 1, 1))


def plain(lap, deg, fvalid, valid, monkeypatch):
    """The plain version on the same tensors, with the two `eigh` calls'
    smallest eigenvalues recorded (theta, and the probe's theta2)."""
    seen = []
    eigh = torch.linalg.eigh

    def recording(t):
        out = eigh(t)
        seen.append(out[0][:, 0])
        return out

    with monkeypatch.context() as mp:
        mp.setattr(torch.linalg, "eigh", recording)
        fiedler, residual, missed = spectral._fiedler_lanczos(
            lap, deg, fvalid, m=steps(lap.shape[-1]), probe_margin=TOL)
    theta, theta2 = seen
    return {"fiedler": fiedler, "residual": residual, "missed": missed,
            "ok": (residual <= TOL) & ~missed, "assign": spectral._two_means(fiedler, valid, 10),
            "theta": theta, "theta2": theta2, "probe_live": theta2 < 0.5 * spectral._BIG_RITZ}


def kernel(lap, deg, fvalid):
    assign, ok, fiedler, detail = spectral.launch_spectral(
        lap, deg, fvalid, steps(lap.shape[-1]), 10, TOL, detail=True)
    return {"assign": assign, "ok": ok, "fiedler": fiedler, "theta": detail[:, 0],
            "residual": detail[:, 1], "theta2": detail[:, 2], "probe_live": detail[:, 3] > 0,
            "missed": detail[:, 4] > 0, "live": detail[:, 5]}


def two_means_margin(f, valid, iters=10):
    """Per row: how near a valid node comes to the midpoint of the two centers
    in any of the 2-means rounds' decisions, the last one included (a small
    class often has a node at the midpoint of (min, max) in the first)."""
    c = torch.stack([torch.where(valid, f, float("inf")).amin(-1),
                     torch.where(valid, f, float("-inf")).amax(-1)], -1)
    margin = torch.full_like(f[:, 0], float("inf"))
    for it in range(iters + 1):
        gap = ((f - c[:, :1]).abs() - (f - c[:, 1:]).abs()).abs()
        margin = torch.minimum(margin, torch.where(valid, gap, float("inf")).amin(-1))
        if it == iters:
            return margin
        member = [((f[:, :, None] - c[:, None, :]).abs().argmin(-1) == k) & valid
                  for k in (0, 1)]
        sums = torch.stack([torch.where(mb, f, 0.0).sum(-1) for mb in member], -1)
        cnts = torch.stack([mb.to(f.dtype).sum(-1) for mb in member], -1)
        c = torch.where(cnts > 0, sums / cnts.clamp_min(1.0), c)


def clear_rows(p, valid):
    """Rows whose 2-means, residual and probe decisions all lie farther than
    MARGIN from their thresholds in the plain version."""
    kmeans = two_means_margin(p["fiedler"], valid)
    resid = (p["residual"] - TOL).abs()
    probe = torch.where(p["probe_live"], (p["theta2"] - (p["theta"] - TOL)).abs(),
                        float("inf"))
    return (kmeans > MARGIN) & (resid > MARGIN) & (probe > MARGIN)


def same_partition(a, b):
    """Per row: equal, or equal with the labels 0 and 1 swapped (-1 stays)."""
    swapped = torch.where(b >= 0, 1 - b, b)
    return (a == b).all(-1) | (a == swapped).all(-1)


def fiedler_gap(a, b):
    return torch.minimum((a - b).abs().amax(-1), (a + b).abs().amax(-1))


def compare(k, p, valid):
    """{what: rows that fail}, over the rows of one call."""
    clear = clear_rows(p, valid)
    theta_gap = (k["theta"] - p["theta"]).abs()
    return {
        "partition": (clear & ~same_partition(k["assign"], p["assign"])).nonzero().flatten(),
        "solve_ok": (clear & (k["ok"] != p["ok"])).nonzero().flatten(),
        "theta": (theta_gap > 1e-5 * p["theta"].abs() + 1e-6).nonzero().flatten(),
        "fiedler": (fiedler_gap(k["fiedler"], p["fiedler"]) > 1e-4).nonzero().flatten(),
    }


@pytest.mark.parametrize("b,nodes,seeds", [(5, NODES, SEEDS), (1, NODES, SEEDS), (5, 299, 20)])
def test_kernel_matches_plain_on_card(card, monkeypatch, b, nodes, seeds):
    bad, clear, rows = {}, 0, 0
    for seed in range(seeds):
        lap, deg, fvalid, valid = laplacians(*classes(b, nodes, 1000 * b + seed), card)
        k, p = kernel(lap, deg, fvalid), plain(lap, deg, fvalid, valid, monkeypatch)
        for what, where in compare(k, p, valid).items():
            if len(where):
                bad.setdefault(what, []).append((seed, where.tolist()))
        clear += int(clear_rows(p, valid).sum())
        rows += b
    assert not bad, f"rows that differ (seed, rows): {bad}"
    assert clear >= 0.8 * rows, f"only {clear} of {rows} rows clear of every margin"


@pytest.mark.parametrize("case", ["seed only", "1 node", "2 nodes", "5 nodes", "n = 10",
                                  "n = 2", "n = 25", "complete graph", "invalid rows"])
def test_kernel_edge_cases_match_plain_on_card(card, monkeypatch, case):
    nodes, b = {"n = 10": 9, "n = 2": 1, "n = 25": 24}.get(case, NODES), 5
    seed, pts, valid = classes(b, nodes, 7, channels=16)
    valid = torch.ones_like(valid) if case.startswith("n = ") or case == "complete graph" \
        else valid
    if case == "seed only":
        valid[:] = False
    elif case.endswith("node") or case.endswith("nodes"):
        valid[:] = False
        valid[:, 3:3 + int(case.split()[0])] = True
    elif case == "invalid rows":
        valid[:, ::3] = False
    lap, deg, fvalid, val = laplacians(seed, pts, valid, card)
    if case == "complete graph":  # every node every other's neighbour: L has 2 eigenvalues
        n = nodes + 1
        a = 1.0 - torch.eye(n, device=card)
        deg = a.sum(-1).expand(b, n).contiguous()
        lap = (torch.eye(n, device=card) - a / (n - 1)).expand(b, n, n).contiguous()
    k, p = kernel(lap, deg, fvalid), plain(lap, deg, fvalid, val, monkeypatch)
    assert all(len(v) == 0 for v in compare(k, p, val).values()), (case, compare(k, p, val))
    assert torch.equal(k["probe_live"], p["probe_live"]), case
    assert torch.equal((k["assign"] < 0), ~val), case
    n = lap.shape[-1]
    spans = k["live"] == n - 1  # the primary basis spans the complement of v0
    assert not (spans & k["probe_live"]).any(), case
    if case in ("n = 10", "n = 2"):
        assert spans.any(), (case, k["live"])
    if case == "complete graph":  # the Krylov space is exhausted after one step
        assert (k["live"] == 1).all(), k["live"]
    if case in ("seed only", "1 node"):
        assert (k["live"] < steps(n)).all() and torch.equal(k["ok"], p["ok"]), case


def test_two_launches_are_bit_identical(card):
    for b, nodes in ((5, NODES), (1, NODES), (5, 299)):
        lap, deg, fvalid, _ = laplacians(*classes(b, nodes, 31), card)
        one = spectral.launch_spectral(lap, deg, fvalid, 24, 10, TOL, detail=True)
        two = spectral.launch_spectral(lap, deg, fvalid, 24, 10, TOL, detail=True)
        assert all(torch.equal(x, y) for x, y in zip(one, two)), (b, nodes)


# one call of the kernel under the profiler, in a fresh process: a second
# profiler session in one process has been seen to report no kernels on the card
PROFILE_ONE_CALL = """
import json, sys
import torch
sys.path.insert(0, {tests!r})
import test_torch_spectral_card as T
from benchmark.trace import kernel_base_name
from graphecho_torch.ops import spectral
lap, deg, fvalid, _ = T.laplacians(*T.classes(5, T.NODES, 3), torch.device("cuda"))
spectral.launch_spectral(lap, deg, fvalid, 24, 10, T.TOL)  # built and warm
torch.cuda.synchronize()
with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
    spectral.launch_spectral(lap, deg, fvalid, 24, 10, T.TOL)
    torch.cuda.synchronize()
print(json.dumps([kernel_base_name(e.name) for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]))
"""


def test_bipartition_on_card_is_one_launch_without_eigh_or_sync(card, monkeypatch):
    here = Path(__file__).resolve().parent
    proc = subprocess.run([sys.executable, "-c", PROFILE_ONE_CALL.format(tests=str(here))],
                          cwd=here.parent, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == ["spectral_bipartition_kernel"]

    def no_eigh(*args, **kwargs):
        raise AssertionError("torch.linalg.eigh called on the kernel path")

    monkeypatch.setattr(torch.linalg, "eigh", no_eigh)
    seed, pts, valid = classes(5, NODES, 3)
    pts_c = torch.cat([seed[:, None], pts], 1).to(card)
    val_c = torch.cat([torch.ones_like(valid[:, :1]), valid], 1).to(card)
    spectral.spectral_bipartition(pts_c, val_c)  # built and warm
    torch.cuda.synchronize()
    spectral.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        assign, ok = spectral.spectral_bipartition(pts_c, val_c, with_quality=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert spectral.LAUNCHES == {"spectral": 1} and assign.is_cuda and ok.dtype == torch.bool


def test_seed_consistent_mean_on_card_equals_plain(card):
    rng = np.random.RandomState(5)
    b, c = 5, 64
    centre = rng.randn(b, 2, c).astype(np.float32) * 6.0
    side = rng.rand(b, NODES) < 0.5
    nodes = centre[np.arange(b)[:, None], side.astype(int)] + rng.randn(b, NODES, c) * 0.5
    seed = centre[:, 0] + rng.randn(b, c).astype(np.float32) * 0.5
    valid = rng.rand(b, NODES) < 0.9
    valid[4] = False  # a class with no valid node: not ok, the plain mean is 0
    args = [torch.from_numpy(np.asarray(x, np.float32 if x.dtype != bool else bool))
            for x in (seed, nodes, valid)]
    mean_cpu, ok_cpu = spectral.seed_consistent_mean(*args)
    mean_card, ok_card = spectral.seed_consistent_mean(*(a.to(card) for a in args))
    assert torch.equal(ok_card.cpu(), ok_cpu) and ok_cpu[:4].all() and not ok_cpu[4]
    torch.testing.assert_close(mean_card.cpu(), mean_cpu, rtol=1e-5, atol=1e-5)
