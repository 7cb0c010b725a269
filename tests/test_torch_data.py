"""The port's data modules (`graphecho_torch/data/`) against the JAX package's
(`graphecho_tpu/data/`), bit for bit, on the same fixture files and seeds:

  * `.mhd` and NIfTI files written by one package and read by the other;
  * the transforms under the same `RandomState` (the port's resize indices
    are the JAX package's native C++ ones, floor(i * in / out) exactly);
  * `collate`, `cycled`, `rebatched` and the per-process index split;
  * `DataLoaderCamus`, `SegCardiacUDADataset` (single frame, clip and
    `fill_mask`) and `Echo`, item by item, one item at a time in index order
    (the order a dataset's rng is read in);
  * `build_infos` and its CLI;
  * `fill_poly` pixel for pixel against `cv2.fillPoly`, on filled blobs,
    rings, scattered and single points (as argwhere lists) and random
    polygons, square and not, and `contour_to_mask` against the JAX
    package's, which calls cv2.
"""

import random

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from graphecho_tpu.data import camus as jcamus
from graphecho_tpu.data import cardiac_uda as jcardiac
from graphecho_tpu.data import echo as jecho
from graphecho_tpu.data import formats as jformats
from graphecho_tpu.data import infos as jinfos
from graphecho_tpu.data import loader as jloader
from graphecho_tpu.data import transforms as jtransforms

from graphecho_torch.data import camus as tcamus
from graphecho_torch.data import cardiac_uda as tcardiac
from graphecho_torch.data import echo as techo
from graphecho_torch.data import formats as tformats
from graphecho_torch.data import infos as tinfos
from graphecho_torch.data import loader as tloader
from graphecho_torch.data import transforms as ttransforms


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and torch's default of a thread per core oversubscribes the machine
    (tens of times slower under load)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


cv2 = pytest.importorskip("cv2")


def _assert_items_equal(got, want, what):
    assert type(got) is type(want) or (np.isscalar(got) and np.isscalar(want)), what
    if isinstance(want, tuple):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_items_equal(g, w, f"{what}[{i}]")
        return
    g, w = np.asarray(got), np.asarray(want)
    assert g.dtype == w.dtype and g.shape == w.shape, (what, g.dtype, w.dtype, g.shape, w.shape)
    np.testing.assert_array_equal(g, w, err_msg=what)


# -------------------------------------------------------------------- formats
VOLUMES = {"uint8": np.uint8, "int16": np.int16, "float32": np.float32, "uint16": np.uint16}


@pytest.mark.parametrize("fmt", ["mhd", "nifti"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_files_written_by_one_package_read_by_the_other(tmp_path, fmt, writer):
    rng = np.random.RandomState(0)
    write_pkg, read_pkg = (tformats, jformats) if writer == "port" else (jformats, tformats)
    for name, dtype in VOLUMES.items():
        for shape in ((7, 9), (5, 6, 4)):
            arr = (rng.rand(*shape) * 200).astype(dtype)
            path = str(tmp_path / f"{name}_{len(shape)}.{'mhd' if fmt == 'mhd' else 'nii.gz'}")
            getattr(write_pkg, f"write_{fmt}")(path, arr)
            for reader in (read_pkg, write_pkg):
                got = getattr(reader, f"read_{fmt}")(path)
                assert got.dtype == arr.dtype and got.shape == arr.shape
                np.testing.assert_array_equal(got, arr)


# ----------------------------------------------------------------- transforms
@pytest.mark.parametrize("shape,out", [((60, 70, 1), (124, 124)), ((48, 52, 12), (140, 140)),
                                       ((300, 400, 3), (328, 328)), ((35, 35, 2), (35, 35)),
                                       ((129, 57), (112, 112))])
def test_transforms_equal_the_jax_package(shape, out):
    rng = np.random.RandomState(1)
    arr = (rng.rand(*shape) * 255).astype(np.float32)
    masks = (rng.rand(*shape[:2], 2) > 0.5).astype(np.float32)
    _assert_items_equal(ttransforms.nearest_resize(arr, out),
                        jtransforms.nearest_resize(arr, out), "nearest_resize")
    crop = (min(out[0], 112), min(out[1], 112))
    _assert_items_equal(ttransforms.center_crop(arr, crop), jtransforms.center_crop(arr, crop),
                        "center_crop")
    _assert_items_equal(ttransforms.rand_crop(arr, crop, np.random.RandomState(4)),
                        jtransforms.rand_crop(arr, crop, np.random.RandomState(4)), "rand_crop")
    for train in (True, False):
        got = ttransforms.resize_and_crop(arr, masks, out, crop, train, np.random.RandomState(5))
        want = jtransforms.resize_and_crop(arr, masks, out, crop, train, np.random.RandomState(5))
        _assert_items_equal(got, want, f"resize_and_crop train={train}")
    ys, xs = rng.uniform(-5, shape[0] + 5, 9), rng.uniform(-5, shape[1] + 5, 9)
    _assert_items_equal(ttransforms.polygon_mask(ys, xs, shape[:2]),
                        jtransforms.polygon_mask(ys, xs, shape[:2]), "polygon_mask")


# --------------------------------------------------------------------- loader
class _Items:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return (np.full((2, 3), i, np.float32), np.array([i, -i]), 0, i)


@pytest.mark.parametrize("count", [1, 2, 3])
def test_loader_collate_cycle_rebatch_and_process_split_equal_the_jax_package(count):
    ds = _Items(23)
    for index in range(count):
        for drop_last in (True, False):
            kw = dict(batch_size=4, seed=9, num_workers=2, drop_last=drop_last,
                      process_index=index, process_count=count)
            t, j = tloader.DataLoader(ds, **kw), jloader.DataLoader(ds, **kw)
            assert len(t) == len(j)
            for epoch in range(2):
                assert t._batches_of_indices() == j._batches_of_indices()
            t, j = tloader.DataLoader(ds, **kw), jloader.DataLoader(ds, **kw)
            got, want = list(t), list(j)
            assert len(got) == len(want)
            for g, w in zip(got, want):
                _assert_items_equal(g, w, "batch")
            ti = tloader.rebatched(tloader.cycled(tloader.DataLoader(ds, **kw)), 5)
            ji = jloader.rebatched(jloader.cycled(jloader.DataLoader(ds, **kw)), 5)
            for _ in range(7):
                _assert_items_equal(next(ti), next(ji), "rebatched")
    samples = [ds[i] for i in (3, 1, 4)]
    _assert_items_equal(tloader.collate(samples), jloader.collate(samples), "collate")


# ------------------------------------------------------------------- datasets
@pytest.fixture(scope="module")
def camus_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("camus")
    rng = np.random.RandomState(0)
    for i in range(10):
        pid = f"patient{i:04d}"
        d = root / "training" / pid
        d.mkdir(parents=True)
        gt = np.zeros((60, 70), np.uint8)
        gt[10:35, 15:45] = 1
        gt[38:52, 15:45] = 3
        tformats.write_mhd(str(d / f"{pid}_4CH_ED.mhd"), (rng.rand(60, 70) * 255).astype(np.uint8))
        tformats.write_mhd(str(d / f"{pid}_4CH_ED_gt.mhd"), gt)
    return str(root)


@pytest.mark.parametrize("stage,kw", [("train", {}), ("train", {"single_frame": False,
                                                               "clip_length": 3}),
                                      ("valid", {}), ("test", {"seg_parts": False})])
def test_camus_items_equal_the_jax_package(camus_root, stage, kw):
    t = tcamus.DataLoaderCamus(camus_root, stage=stage, **kw)
    j = jcamus.DataLoaderCamus(camus_root, stage=stage, **kw)
    assert t.data_list == j.data_list and len(t) == len(j) > 0
    for i in range(len(t)):
        _assert_items_equal(t[i], j[i], f"camus {stage} item {i}")


def _ring_labels(rng, h, w, t, n_organs, contour):
    """(h, w, t) label volumes: one ellipse per organ, moving a little over
    time, filled or as its outline."""
    yy, xx = np.mgrid[:h, :w]
    lab = np.zeros((h, w, t), np.uint8)
    for c in range(1, n_organs + 1):
        cy, cx = rng.uniform(0.25, 0.75) * h, rng.uniform(0.25, 0.75) * w
        ry, rx = rng.uniform(0.08, 0.2) * h, rng.uniform(0.08, 0.2) * w
        for f in range(t):
            d = ((yy - cy - f * 0.3) / ry) ** 2 + ((xx - cx) / rx) ** 2
            lab[..., f][(d <= 1) & ((d >= 0.75) if contour else True)] = c
    return lab


@pytest.fixture(scope="module")
def cardiac(tmp_path_factory):
    """View-4 volumes on non-square frames: Site_G/Site_R filled labels,
    Site_R_full contour labels."""
    root = tmp_path_factory.mktemp("cardiac")
    rng = np.random.RandomState(2)
    infos = {}
    for site, n in (("Site_G", 8), ("Site_R", 4), ("Site_R_full", 2)):
        for i in range(n):
            d = root / site / f"p{i}"
            d.mkdir(parents=True)
            h, w, t = (50, 62, 12) if i % 2 else (61, 47, 12)
            img = (rng.rand(h, w, t) * 255).astype(np.uint8)
            lab = _ring_labels(rng, h, w, t, 4, contour=site == "Site_R_full")
            tformats.write_nifti(str(d / f"p{i}_4.nii.gz"), img)
            tformats.write_nifti(str(d / f"p{i}_4_gt.nii.gz"), lab)
    infos, warnings = tinfos.build_infos(str(root))
    assert not warnings
    return str(root), infos


CARDIAC_CASES = {
    "single_frame": dict(is_train=True, set_select=("Site_G",)),
    "clip": dict(is_train=True, set_select=("Site_R",), repeat=2, single_frame=False,
                 clip_length=4, total_length=8, source_domain=False),
    "fill_mask": dict(is_train=False, set_select=("Site_R_full",), single_frame=False,
                      clip_length=4, total_length=8, fill_mask=True, seed=0),
}


@pytest.mark.parametrize("case", list(CARDIAC_CASES))
def test_cardiac_uda_items_equal_the_jax_package(cardiac, case):
    root, infos = cardiac
    kw = dict(spatial_size=72, crop_size=64, view_num=("4",), **CARDIAC_CASES[case])
    if not kw["is_train"]:
        kw["data_list"] = [k for k, v in infos.items() if v["dataset_name"] == "Site_R_full"]
    t = tcardiac.SegCardiacUDADataset(infos, root, **kw)
    j = jcardiac.SegCardiacUDADataset(infos, root, **kw)
    assert t.id_list == j.id_list and len(t) == len(j) > 0
    if kw["is_train"]:
        assert (t.valid_list, t.test_list) == (j.valid_list, j.test_list)
    for i in range(len(t)):
        _assert_items_equal(t[i], j[i], f"cardiac {case} item {i}")
    if case == "fill_mask":  # the filled organs reach the masks' channels
        img, masks, _, _ = t[0]
        assert masks[..., 1:].sum() > 0


@pytest.fixture(scope="module")
def echo_root(tmp_path_factory):
    from graphecho_torch.data.video import savevideo

    root = tmp_path_factory.mktemp("echo")
    rng = np.random.RandomState(1)
    (root / "Videos").mkdir()
    rows, split_rows = ["FileName,X1,Y1,X2,Y2,Frame"], ["FileName,Split,EF,EDV"]
    for i in range(4):
        name = f"vid{i}.avi"
        savevideo(str(root / "Videos" / name), (rng.rand(10, 40, 48) * 255).astype(np.uint8))
        split_rows.append(f"{name[:-4]},{'VAL' if i == 3 else 'TRAIN'},{50 + i},{100 + i}")
        for frame in (2, 7):
            for k in range(6):
                rows.append(f"{name[:-4]},{8+k},{6+5*k},{36-k},{6+5*k},{frame}")
    (root / "FileList.csv").write_text("\n".join(split_rows) + "\n")
    (root / "VolumeTracings.csv").write_text("\n".join(rows))
    return str(root)


@pytest.mark.parametrize("kw", [
    dict(split="train"),
    dict(split="train", single_frame=False, length=4, target_type=["EF", "SmallTrace"]),
    dict(split="all", single_frame=False, length=3, clips=2, pad=2, noise=0.05),
    dict(split="val", target_type="LargeFrame", single_frame=False, clips="all",
         validation=False, length=4),
], ids=["single_frame", "clip_targets", "clips_pad_noise", "all_windows"])
def test_echo_items_equal_the_jax_package(echo_root, kw):
    t, j = techo.Echo(echo_root, **kw), jecho.Echo(echo_root, **kw)
    assert t.fnames == j.fnames and len(t) == len(j) > 0
    for i in range(len(t)):
        _assert_items_equal(t[i], j[i], f"echo item {i}")


def test_build_infos_and_its_cli_equal_the_jax_package(cardiac, tmp_path):
    root, infos = cardiac
    assert tinfos.build_infos(root) == jinfos.build_infos(root)
    kw = dict(sites=["Site_G", "Site_X"], mask_tokens=("gt",))
    assert tinfos.build_infos(root, **kw) == jinfos.build_infos(root, **kw)
    outs = []
    for pkg in (tinfos, jinfos):
        out = str(tmp_path / f"{pkg.__name__}.npy")
        assert pkg.main(["--root", root, "--out", out]) == 0
        outs.append(np.load(out, allow_pickle=True).item())
    assert outs[0] == outs[1] == infos


# -------------------------------------------------------------------- fill_poly
def _cv_fill(points, shape):
    img = np.zeros(shape + (3,), np.uint8)
    cv2.fillPoly(img, [np.asarray(points, np.int32)], (255, 255, 255))
    return img[:, :, 0] == 255


def _shape_points(kind, rng, h, w):
    """(n, 2) points: argwhere lists of a label map (read as (x, y), the
    reference's transpose), or the vertices of a random polygon."""
    yy, xx = np.mgrid[:h, :w]
    cy, cx = rng.uniform(0, h), rng.uniform(0, w)
    ry, rx = rng.uniform(1, h / 2), rng.uniform(1, w / 2)
    d = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2
    if kind == "filled":
        lab = d <= 1
    elif kind == "ring":
        lab = (d <= 1) & (d >= 0.7)
    elif kind == "scattered":
        lab = rng.rand(h, w) < rng.uniform(0.001, 0.1)
    elif kind == "single":
        lab = np.zeros((h, w), bool)
        lab[rng.randint(h), rng.randint(w)] = True
    else:  # a polygon of 3-6 vertices, some outside the image
        k = rng.randint(3, 7)
        return np.stack([rng.randint(-5, w + 5, k), rng.randint(-5, h + 5, k)], 1)
    return np.argwhere(lab)


KINDS = ["filled", "ring", "scattered", "single", "polygon"]


@pytest.mark.parametrize("square", [True, False], ids=["square", "non_square"])
@pytest.mark.parametrize("kind", KINDS)
def test_fill_poly_equals_cv2_fillpoly(kind, square):
    rng = np.random.RandomState(2 * KINDS.index(kind) + square)
    checked = 0
    for case in range(60):
        h = rng.randint(8, 80)
        w = h if square else rng.choice([v for v in range(8, 80) if v != h])
        pts = _shape_points(kind, rng, h, w)
        if len(pts) == 0:
            continue
        got, want = tcardiac.fill_poly(pts, (h, w)), _cv_fill(pts, (h, w))
        assert (got != want).sum() == 0, f"case {case}: {h}x{w}, {len(pts)} points"
        checked += 1
    assert checked >= 50


@settings(max_examples=400, deadline=None, derandomize=True)
@given(h=st.integers(1, 40), w=st.integers(1, 40),
       pts=st.lists(st.tuples(st.integers(-30, 70), st.integers(-30, 70)), min_size=1,
                    max_size=12))
def test_fill_poly_equals_cv2_fillpoly_on_any_points(h, w, pts):
    np.testing.assert_array_equal(tcardiac.fill_poly(np.array(pts), (h, w)),
                                  _cv_fill(np.array(pts), (h, w)))


def test_contour_to_mask_equals_the_jax_package():
    rng = np.random.RandomState(7)
    worst = 0
    for h, w in ((61, 47), (50, 62), (40, 40), (300, 400)):
        lab = _ring_labels(rng, h, w, 3, 4, contour=True).astype(np.float32)
        kw = dict(infos={}, root="", is_train=False, view_num=("4",))
        got = tcardiac.SegCardiacUDADataset(**kw).contour_to_mask(lab)
        want = jcardiac.SegCardiacUDADataset(**kw).contour_to_mask(lab)
        assert got.dtype == want.dtype and got.shape == want.shape
        worst = max(worst, int((got != want).sum()))
        assert set(np.unique(want)) - {0} and worst == 0
    print(f"PARITY contour_to_mask: {worst} pixels differ from the JAX package (cv2)")


def test_python_random_streams_match():
    """The split and frame choices use python's `random.Random(seed)`; the
    port does not reseed the global generator either."""
    state = random.getstate()
    tcardiac.SegCardiacUDADataset({}, "", is_train=True)
    assert random.getstate() == state
