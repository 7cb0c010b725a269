"""The port's host C++ data kernels (`graphecho_torch/csrc/dataops.cpp`
through `graphecho_torch/data/native.py`) against the JAX package's
(`native/dataops.cpp` through `graphecho_tpu/data/native.py`), bit for bit
on the same seeded arrays, and against the port's numpy versions:

  * `nearest_resize` of float32 and uint8, up and down, odd sizes, trailing
    (T) and (P) dims, a 288x352x64 clip to 256x256; `nearest_resize_batch`;
  * the index rule: the C++ floor(x * (double)w / ow) and numpy's exact
    integer x * w // ow agree for every size pair a loader meets;
  * `polygon_mask` on seeded and hypothesis polygons, with fewer than three
    vertices and with vertices outside the image; `normalize_u8`;
  * the transforms, the CAMUS and the CardiacUDA loaders go through the
    C++ kernels (counted) and their items still equal the JAX package's;
  * a library that cannot be built: `native.available()` raises, naming the
    command; the transforms and `serve.prep_frames` give the numpy versions'
    bytes, the same as the library's, and warn once; the failure is kept,
    so that no later call (from any thread) starts g++ again.
"""

import subprocess
import sys
import threading
import warnings

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from graphecho_tpu.data import camus as jcamus
from graphecho_tpu.data import cardiac_uda as jcardiac
from graphecho_tpu.data import native as jnative
from graphecho_tpu.data import transforms as jtransforms

from test_torch_data import CARDIAC_CASES, _assert_items_equal, camus_root, cardiac  # noqa: F401

from graphecho_torch.data import camus as tcamus
from graphecho_torch.data import cardiac_uda as tcardiac
from graphecho_torch.data import native
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


def test_both_libraries_build():
    assert native.available() and jnative.available()
    assert native.library_path().parent.name == "_build"


# (H, W, ...) -> (oh, ow): up, down, odd, trailing (T) and (P), the cardiac clip
RESIZES = [((60, 70), (124, 124)), ((37, 53, 2), (124, 124)), ((129, 57, 3), (112, 112)),
           ((301, 299, 5), (41, 73)), ((7, 9, 8, 3), (13, 5)), ((48, 52, 12), (140, 140)),
           ((1, 1, 4), (3, 2)), ((288, 352, 64), (256, 256)), ((288, 352, 64), (328, 328))]


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
@pytest.mark.parametrize("shape,out", RESIZES, ids=lambda v: "x".join(map(str, v)))
def test_nearest_resize_equals_the_jax_package(shape, out, dtype):
    rng = np.random.RandomState(sum(shape))
    arr = (rng.rand(*shape) * 255).astype(dtype)
    got = native.nearest_resize(arr, *out)
    want = jnative.nearest_resize(arr, *out)
    _assert_items_equal(got, want, "native.nearest_resize")
    _assert_items_equal(ttransforms.nearest_resize(arr, out), want, "transforms.nearest_resize")
    _assert_items_equal(ttransforms.nearest_resize_plain(arr, out), want, "nearest_resize_plain")
    # a strided view goes through as its contents
    view = np.asfortranarray(arr)
    _assert_items_equal(native.nearest_resize(view, *out), want, "Fortran-ordered input")


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_nearest_resize_batch_equals_the_jax_package(dtype):
    rng = np.random.RandomState(3)
    for shape, out in (((5, 61, 47, 2), (72, 72)), ((3, 50, 62, 1), (33, 90)),
                       ((1, 9, 9, 7), (9, 9))):
        arr = (rng.rand(*shape) * 255).astype(dtype)
        got = native.nearest_resize_batch(arr, *out)
        _assert_items_equal(got, jnative.nearest_resize_batch(arr, *out), "batch")
        for i in range(shape[0]):
            _assert_items_equal(got[i], ttransforms.nearest_resize_plain(arr[i], out), "item")


def test_the_index_rules_agree_for_every_size_a_loader_meets():
    """floor(x * (double)w / ow), the C++ rule (the same IEEE operations in
    numpy), against x * w // ow: every pair up to 400, and every source size
    up to 2048 to the loaders' sizes."""
    pairs = [(w, ow) for w in range(1, 401) for ow in range(1, 401)]
    pairs += [(w, ow) for w in range(401, 2049) for ow in (112, 124, 128, 140, 256, 328)]
    for w, ow in pairs:
        x = np.arange(ow, dtype=np.int64)
        exact = x * w // ow
        double = np.floor(x.astype(np.float64) * float(w) / float(ow)).astype(np.int64)
        assert np.array_equal(exact, np.minimum(double, w - 1)), (w, ow)


@pytest.mark.parametrize("dtype", [np.float64, np.int16, bool])
def test_other_dtypes_take_the_numpy_route(dtype):
    arr = (np.random.RandomState(4).rand(30, 21, 3) * 100).astype(dtype)
    with pytest.raises(TypeError, match="float32 or uint8"):
        native.nearest_resize(arr, 40, 40)
    _assert_items_equal(ttransforms.nearest_resize(arr, (40, 17)),
                        jtransforms.nearest_resize(arr, (40, 17)), "numpy route")


def _polygons(rng):
    """Float and integer vertices, inside and outside the image, n 0 to 40."""
    for trial in range(300):
        n = [0, 1, 2][trial] if trial < 3 else rng.randint(3, 41)
        h, w = rng.randint(1, 70, 2)
        if trial % 2:
            ys, xs = rng.randint(-8, h + 8, n).astype(float), rng.randint(-8, w + 8, n).astype(float)
        else:
            ys, xs = rng.uniform(-8, h + 8, n), rng.uniform(-8, w + 8, n)
        yield ys, xs, (int(h), int(w))


def _check_polygon(ys, xs, shape):
    got = native.polygon_mask(ys, xs, shape)
    want = jnative.polygon_mask(ys, xs, shape)
    _assert_items_equal(got, want, "native.polygon_mask")
    _assert_items_equal(ttransforms.polygon_mask(ys, xs, shape), want, "polygon_mask")
    _assert_items_equal(ttransforms.polygon_mask_plain(ys, xs, shape), want, "polygon_mask_plain")
    return got


def test_polygon_mask_equals_the_jax_package():
    rng = np.random.RandomState(5)
    filled = 0
    for ys, xs, shape in _polygons(rng):
        got = _check_polygon(ys, xs, shape)
        if len(ys) < 3:
            assert not got.any()
        filled += bool(got.any())
    assert filled > 100
    # an EchoNet trace: rounded vertices of a 112x112 frame
    t = np.linspace(0, 2 * np.pi, 42, endpoint=False)
    ys, xs = np.rint(56 + 30 * np.sin(t)), np.rint(50 + 20 * np.cos(t) ** 3)
    assert _check_polygon(ys, xs, (112, 112)).sum() > 500
    with pytest.raises(ValueError, match="length mismatch"):
        native.polygon_mask([1, 2, 3], [1, 2], (5, 5))


@settings(max_examples=150, deadline=None, derandomize=True)
@given(h=st.integers(1, 30), w=st.integers(1, 30),
       pts=st.lists(st.tuples(st.integers(-6, 36), st.integers(-6, 36)), max_size=12),
       scale=st.sampled_from([1.0, 0.5, 0.3]))
def test_polygon_mask_equals_the_jax_package_on_any_polygon(h, w, pts, scale):
    ys = np.array([p[0] for p in pts], np.float64) * scale
    xs = np.array([p[1] for p in pts], np.float64) * scale
    _check_polygon(ys, xs, (h, w))


def test_normalize_u8_equals_the_jax_package():
    rng = np.random.RandomState(6)
    for shape in ((0,), (7,), (3, 5, 2), (1 << 20) + 3):
        arr = rng.randint(0, 256, shape).astype(np.uint8)
        got = native.normalize_u8(arr)
        _assert_items_equal(got, jnative.normalize_u8(arr), "normalize_u8")
        _assert_items_equal(got, arr.astype(np.float32) * np.float32(1 / 255), "u8 * 1/255")
    with pytest.raises(TypeError, match="uint8"):
        native.normalize_u8(np.zeros(3, np.float32))


class _Counted:
    def __init__(self, monkeypatch):
        self.calls = {"nearest_resize": 0, "polygon_mask": 0}
        for name in self.calls:
            monkeypatch.setattr(native, name, self._wrap(name, getattr(native, name)))

    def _wrap(self, name, fn):
        def counted(*args):
            self.calls[name] += 1
            return fn(*args)
        return counted


def test_the_transforms_reach_the_native_kernels(monkeypatch):
    counted = _Counted(monkeypatch)
    rng = np.random.RandomState(7)
    arr = rng.rand(50, 60, 3).astype(np.float32)
    masks = (rng.rand(50, 60, 2) > 0.5).astype(np.float32)
    ttransforms.resize_and_crop(arr, masks, (72, 72), (64, 64), True, np.random.RandomState(0))
    ttransforms.nearest_resize(arr, (50, 60))  # the same size: no resize at all
    ttransforms.nearest_resize(arr.astype(np.float64), (40, 40))  # the numpy route
    ttransforms.polygon_mask([1, 9, 9], [1, 1, 9], (10, 10))
    assert counted.calls == {"nearest_resize": 2, "polygon_mask": 1}


@pytest.mark.parametrize("stage,kw", [("train", {}), ("train", {"single_frame": False,
                                                               "clip_length": 3}),
                                      ("test", {"seg_parts": False})])
def test_camus_items_through_the_native_path_equal_the_jax_package(camus_root, stage, kw,  # noqa: F811
                                                                   monkeypatch):
    counted = _Counted(monkeypatch)
    t = tcamus.DataLoaderCamus(camus_root, stage=stage, **kw)
    j = jcamus.DataLoaderCamus(camus_root, stage=stage, **kw)
    for i in range(len(t)):
        _assert_items_equal(t[i], j[i], f"camus {stage} item {i}")
    assert counted.calls["nearest_resize"] >= 2 * len(t)


@pytest.mark.parametrize("case", list(CARDIAC_CASES))
def test_cardiac_uda_items_through_the_native_path_equal_the_jax_package(cardiac, case,  # noqa: F811
                                                                         monkeypatch):
    counted = _Counted(monkeypatch)
    root, infos = cardiac
    kw = dict(spatial_size=72, crop_size=64, view_num=("4",), **CARDIAC_CASES[case])
    if not kw["is_train"]:
        kw["data_list"] = [k for k, v in infos.items() if v["dataset_name"] == "Site_R_full"]
    t = tcardiac.SegCardiacUDADataset(infos, root, **kw)
    j = jcardiac.SegCardiacUDADataset(infos, root, **kw)
    for i in range(len(t)):
        _assert_items_equal(t[i], j[i], f"cardiac {case} item {i}")
    assert counted.calls["nearest_resize"] >= 2 * len(t)


@pytest.fixture
def failed_builds(monkeypatch):
    """An empty failure cache, restored afterwards."""
    monkeypatch.setattr(native, "_FAILED", {})


def _fallbacks(record):
    return [w for w in record if issubclass(w.category, native.FallbackWarning)]


# an EchoNet trace: rounded vertices of a 112x112 frame
_T = np.linspace(0, 2 * np.pi, 42, endpoint=False)
TRACE = (np.rint(56 + 30 * np.sin(_T)), np.rint(50 + 20 * np.cos(_T) ** 3))


@pytest.mark.parametrize("what", ["flag", "compiler"])
def test_a_failed_build_raises_and_names_the_command(monkeypatch, failed_builds, what):
    """`available()` raises; the transforms fall back to the numpy versions'
    bytes, which are the library's, with one warning naming the command."""
    if what == "flag":
        monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ("-fno-such-flag",))
        match = "-fno-such-flag"
    else:
        monkeypatch.setattr(native, "CXX", "no-such-compiler-g++")
        match = "no-such-compiler-g\\+\\+"
    arr = (np.random.RandomState(8).rand(64, 64, 1) * 255).astype(np.float32)
    with pytest.raises(RuntimeError, match=match):
        native.available()
    with pytest.warns(native.FallbackWarning, match=match) as record:
        resized = ttransforms.nearest_resize(arr, (112, 112))
        mask = ttransforms.polygon_mask(*TRACE, (112, 112))
    assert len(_fallbacks(record)) == 1
    _assert_items_equal(resized, ttransforms.nearest_resize_plain(arr, (112, 112)), "fallback")
    _assert_items_equal(mask, ttransforms.polygon_mask_plain(*TRACE, (112, 112)), "fallback")
    monkeypatch.undo()
    _assert_items_equal(ttransforms.nearest_resize(arr, (112, 112)), resized, "library")
    _assert_items_equal(ttransforms.polygon_mask(*TRACE, (112, 112)), mask, "library")
    assert mask.sum() > 500


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_prep_frames_without_the_library_gives_the_same_bytes(monkeypatch, failed_builds, dtype):
    """Frames at another size than the model's, prepared with the library and
    on a host where it cannot be built."""
    from graphecho_torch import serve

    frames = np.random.RandomState(9).rand(3, 64, 72)
    frames = (frames * 255).astype(np.uint8) if dtype == np.uint8 else frames.astype(np.float32)
    counted = _Counted(monkeypatch)
    want = serve.prep_frames(frames, (112, 112))
    assert counted.calls["nearest_resize"] == 3
    monkeypatch.setattr(native, "CXX", "no-such-compiler-g++")
    with pytest.warns(native.FallbackWarning) as record:
        got = serve.prep_frames(frames, (112, 112))
    assert len(_fallbacks(record)) == 1 and counted.calls["nearest_resize"] == 3
    assert got.shape == (3, 112, 112, 1) and got.dtype == np.float32
    _assert_items_equal(got, want, "prep_frames without the library")


def test_a_failure_is_kept_and_g_plus_plus_not_started_again(monkeypatch, failed_builds):
    monkeypatch.setattr(native, "CXX", "no-such-compiler-g++")
    arr = np.ones((5, 6, 2), np.uint8)
    with pytest.warns(native.FallbackWarning):
        ttransforms.nearest_resize(arr, (8, 8))
    runs = []
    run = subprocess.run
    monkeypatch.setattr(native.subprocess, "run", lambda *a, **kw: runs.append(a) or run(*a, **kw))
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # a second warning would raise
        assert ttransforms.nearest_resize(arr, (8, 8)).shape == (8, 8, 2)
        assert ttransforms.polygon_mask(*TRACE, (112, 112)).sum() > 500
        assert native.try_load() is None
    assert runs == []
    # `load()` is not cached: it asks the compiler again, and raises
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        native.load()
    assert len(runs) == 1


def test_threads_that_meet_a_failed_build_start_g_plus_plus_once(monkeypatch, failed_builds):
    """The loaders' threads resize at once: one of them asks the compiler,
    one warning is given, every thread gets the numpy bytes."""
    monkeypatch.setattr(native, "CXX", "no-such-compiler-g++")
    runs = []
    run = subprocess.run
    monkeypatch.setattr(native.subprocess, "run", lambda *a, **kw: runs.append(a) or run(*a, **kw))
    arr = (np.random.RandomState(10).rand(33, 47, 3) * 255).astype(np.uint8)
    want = ttransforms.nearest_resize_plain(arr, (64, 64))
    results, start = [], threading.Barrier(16)

    def work():
        start.wait(timeout=30)
        for _ in range(20):
            results.append(ttransforms.nearest_resize(arr, (64, 64)))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with pytest.warns(native.FallbackWarning) as record:
            threads = [threading.Thread(target=work) for _ in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len(runs) == 1 and len(_fallbacks(record)) == 1 and len(results) == 16 * 20
    assert all(np.array_equal(r, want) for r in results)
