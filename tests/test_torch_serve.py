"""The port's serving surface on the CPU: `serve.Predictor` and
`ExportedPredictor`, `parallel/video_infer.py`, the bf16 FPN and
`python -m graphecho_torch.bench`, against the JAX package where it has a
counterpart.

Weights: the flax tree shaped with `jax.eval_shape` and filled from a seed
(`test_torch_quant.flax_fpn_variables`), carried into the port by
`convert.from_flax`; a VGG16 with the paper's conv counts at widths 8-32,
32-channel heads, five classes, 64² frames.

  * f32: the Predictor's masks (batch 4, a ragged last batch) equal JAX's
    `fpn.apply` -> sigmoid > 0.5 wherever |logit| > 1e-3; the logits agree
    within 2e-4.
  * bf16: the port FPN with `dtype=torch.bfloat16` against
    `FPN(dtype=jnp.bfloat16)`. Both round every conv output to bf16 (JAX
    its resize weights too), so they differ by about what bf16 costs each of
    them against f32: the logits within 2% relative RMS and 0.25 absolute of
    JAX's bf16 logits (|logits| reach ~12 here), and the port's bf16 error
    against its f32 logits at most 1.5x JAX's against its own. The masks are
    equal wherever |logit_f32| clears that 0.25 (a 5e-2 margin is inside
    bf16's own error at these logits: JAX's bf16 logits are up to ~0.18 off
    its f32 ones), and on at least 99% of pixels.
  * The Predictor's contract: uint8 and resized input (`_prep` bit-equal to
    the JAX Predictor's), an empty request, `from_checkpoint`, a hot swap,
    the int8 refusal of one, `quantize` with `devices` refused, the video
    split over ["cpu", "cpu"] equal to `predict`, export -> load -> predict
    bit-equal (bf16, f32 and int8), and the artifact served by a process in
    which `graphecho_torch.models` cannot be imported.
  * bf16 builds for inference; the bf16 train step and Trainer refuse.
  * `graphecho_torch.bench` at batch 2 on the CPU prints its JSON lines.
"""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphecho_tpu.serve import Predictor as JaxPredictor

from test_torch_pairwise_mlp import report_parity
from test_torch_quant import BACKBONES, FAST_COMPILE, VGG_SPEC, flax_fpn_variables, port_fpn

from graphecho_torch import bench
from graphecho_torch import config as C
from graphecho_torch.convert import from_flax
from graphecho_torch.parallel import make_video_infer
from graphecho_torch.serve import Predictor, load_exported, prep_frames
from graphecho_torch.train.checkpoint import CheckpointManager
from graphecho_torch.train.state import create_train_state
from graphecho_torch.train.steps import build_models, make_train_step
from graphecho_torch.train.trainer import Trainer

ROOT = Path(__file__).resolve().parent.parent
HW = 64


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and torch's default of a thread per core oversubscribes the machine
    (tens of times slower under load)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def small_cfg(**model):
    """The cardiac recipe at the test's widths and frame size, without the
    graph head (the Predictor serves only the FPN)."""
    cfg = C.cardiac_uda_config()
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, fpn_channels=32, semantic_channels=16,
                                       vgg_spec=VGG_SPEC, **model),
        data=dataclasses.replace(cfg.data, img_crop=(HW, HW)),
        train=dataclasses.replace(cfg.train, graph_matching=False, discriminator=False))


@pytest.fixture(scope="module")
def shared():
    kw, hw = BACKBONES["vgg"]
    assert hw == HW
    jm, variables = flax_fpn_variables(kw, hw, seed=1)
    sd = from_flax({"net_params": variables["params"],
                    "net_batch_stats": variables["batch_stats"]})["fpn"]
    x = np.random.RandomState(7).rand(5, HW, HW, 1).astype(np.float32)
    return kw, jm, variables, sd, x


def _jax_logits(jm, variables, x, dtype=None):
    fn = jax.jit(lambda v, x: jm.clone(dtype=dtype).apply(v, x, train=False)[0],
                 compiler_options=FAST_COMPILE)
    return np.asarray(fn(variables, x).astype(jnp.float32))


def test_f32_predictor_matches_jax(shared):
    kw, jm, variables, sd, x = shared
    logits_j = _jax_logits(jm, variables, x)
    pred = Predictor(small_cfg(), sd, batch_size=4, compute_dtype="float32", device="cpu")
    masks = pred.predict(x[..., 0])
    assert masks.shape == (5, HW, HW, kw["num_classes"]) and masks.dtype == np.int8
    want = (1 / (1 + np.exp(-logits_j.astype(np.float64))) > 0.5).astype(np.int8)
    clear = np.abs(logits_j) > 1e-3
    print(f"PARITY serve f32 masks equal where |logit|>1e-3: "
          f"{(masks == want)[clear].mean():.6f} of {clear.mean():.4f} of pixels")
    np.testing.assert_array_equal(masks[clear], want[clear])
    with torch.no_grad():
        logits_t, _ = port_fpn(kw, variables)(torch.from_numpy(x).permute(0, 3, 1, 2))
    logits_t = logits_t.permute(0, 2, 3, 1).numpy()
    report_parity("serve f32 FPN logits", logits_t, logits_j)
    np.testing.assert_allclose(logits_t, logits_j, atol=2e-4)


def _rel_rms(got, want):
    return float(np.sqrt(((got - want) ** 2).mean() / (want ** 2).mean()))


def test_bf16_fpn_matches_jax_bf16(shared):
    kw, jm, variables, sd, x = shared
    logits_j32 = _jax_logits(jm, variables, x)
    logits_j = _jax_logits(jm, variables, x, jnp.bfloat16)
    model = port_fpn(kw, variables, dtype=torch.bfloat16)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        logits_t, feats = model(xt)
        logits_t32 = port_fpn(kw, variables)(xt)[0].permute(0, 2, 3, 1).numpy()
    assert logits_t.dtype == torch.bfloat16 and all(f.dtype == torch.bfloat16 for f in feats)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    logits_t = logits_t.float().permute(0, 2, 3, 1).numpy()
    report_parity("serve bf16 FPN logits", logits_t, logits_j)
    err, own, jax_own = (_rel_rms(logits_t, logits_j), _rel_rms(logits_t, logits_t32),
                         _rel_rms(logits_j, logits_j32))
    print(f"PARITY serve bf16 logits rel_rms vs JAX bf16={err:.3g}, port bf16 vs f32="
          f"{own:.3g}, JAX bf16 vs f32={jax_own:.3g}")
    assert err <= 0.02 and np.abs(logits_t - logits_j).max() <= 0.25
    assert own <= 1.5 * jax_own
    masks = Predictor(small_cfg(), sd, batch_size=4, device="cpu").predict(x)
    want = np.asarray(jax.nn.sigmoid(jnp.asarray(logits_j, jnp.bfloat16)) > 0.5)
    clear = np.abs(logits_j32) > 0.25
    agree = (masks == want).mean()
    print(f"PARITY serve bf16 masks agreement={agree:.6f}, where |logit_f32|>0.25: "
          f"{(masks == want)[clear].mean():.6f}; largest |logit_f32| where they differ "
          f"{np.abs(logits_j32)[masks != want].max():.3g}")
    np.testing.assert_array_equal(masks[clear], want[clear])
    assert agree >= 0.99, agree


def test_prep_matches_the_jax_predictor():
    rng = np.random.RandomState(3)

    class Shape:
        _hw = (HW, HW)

    for imgs in ((rng.rand(3, 70, 50) * 255).astype(np.uint8),
                 rng.rand(2, 100, 90, 1).astype(np.float32),
                 rng.rand(2, HW, HW).astype(np.float32)):
        got = prep_frames(imgs, (HW, HW))
        want = JaxPredictor._prep(Shape(), imgs)
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_predictor_requests(shared):
    _, _, _, sd, x = shared
    pred = Predictor(small_cfg(), sd, batch_size=4, compute_dtype="float32", device="cpu")
    u8 = (np.random.RandomState(4).rand(3, 70, 50) * 255).astype(np.uint8)
    np.testing.assert_array_equal(pred.predict(u8), pred.predict(prep_frames(u8, (HW, HW))))
    for empty in (pred.predict(np.zeros((0, HW, HW), np.float32)),
                  pred.predict_video(np.zeros((0, 30, 30), np.uint8))):
        assert empty.shape == (0, HW, HW, 5) and empty.dtype == np.int8
    # a ragged request pads its last batch: each frame's masks as alone
    alone = np.concatenate([pred.predict(x[i:i + 1]) for i in range(len(x))])
    np.testing.assert_array_equal(pred.predict(x), alone)


def test_from_checkpoint(tmp_path):
    cfg = small_cfg()
    state = create_train_state(cfg, build_models(cfg), torch.device("cpu"), seed=3)
    CheckpointManager(str(tmp_path / "ckpt")).save(7, state)
    x = np.random.RandomState(5).rand(3, HW, HW).astype(np.float32)
    got = Predictor.from_checkpoint(cfg, str(tmp_path / "ckpt"), batch_size=2,
                                    compute_dtype="float32", device="cpu")
    want = Predictor(cfg, state.net.module.state_dict(), batch_size=2,
                     compute_dtype="float32", device="cpu")
    np.testing.assert_array_equal(got.predict(x), want.predict(x))
    with pytest.raises(FileNotFoundError):
        Predictor.from_checkpoint(cfg, str(tmp_path / "none"), device="cpu")


def test_hot_swap_and_refusals(shared):
    _, _, _, sd, x = shared
    cfg = small_cfg()
    pred = Predictor(cfg, sd, batch_size=4, compute_dtype="float32", device="cpu",
                     devices=["cpu"])
    before = pred.predict(x)
    swapped = {k: v.clone() for k, v in sd.items()}
    swapped["conv3.bias"] += 50.0
    pred.variables = swapped
    assert pred.variables is swapped
    assert pred.predict(x).all() and pred.predict_video(x).all() and not before.all()
    pred.variables = sd
    np.testing.assert_array_equal(pred.predict(x), before)
    quant = Predictor(cfg, sd, batch_size=4, quantize=True, calib_batches=[x], device="cpu")
    with pytest.raises(ValueError, match="frozen"):
        quant.variables = swapped
    with pytest.raises(ValueError, match="float-only"):
        Predictor(cfg, sd, quantize=True, devices=["cpu"], device="cpu")


def test_video_split_over_two_devices(shared):
    kw, _, variables, sd, x = shared
    frames = np.concatenate([x, x[:2]])  # 7 frames: the split pads one
    pred = Predictor(small_cfg(), sd, batch_size=4, compute_dtype="float32", device="cpu",
                     devices=["cpu", "cpu"])
    np.testing.assert_array_equal(pred.predict_video(frames), pred.predict(frames))
    run = make_video_infer(port_fpn(kw, variables), ["cpu", "cpu"])
    masks, t = run(torch.from_numpy(frames))
    assert t == 7 and masks.shape == (7, HW, HW, 5) and masks.dtype == torch.int8


@pytest.mark.parametrize("kind", ["bfloat16", "float32", "int8"])
def test_export_and_reload_bit_equal(shared, tmp_path, kind):
    _, _, _, sd, x = shared
    quant = kind == "int8"
    pred = Predictor(small_cfg(), sd, batch_size=4, quantize=quant, device="cpu",
                     calib_batches=[x] if quant else None,
                     compute_dtype="bfloat16" if quant else kind)
    pred.export_compiled(str(tmp_path / "artifact"))
    loaded = load_exported(str(tmp_path / "artifact"))
    assert (loaded.batch_size, loaded.num_classes, loaded.meta["quantized"]) == (4, 5, quant)
    assert ("int8" in loaded.meta["leaf_dtypes"]) == quant
    np.testing.assert_array_equal(loaded.predict(x), pred.predict(x))
    if quant:
        np.save(tmp_path / "x.npy", x)
        np.save(tmp_path / "want.npy", pred.predict(x))
        code = (
            "import sys\n"
            "sys.modules['graphecho_torch.models'] = None\n"
            "import numpy as np, torch\n"
            "torch.set_num_threads(1)\n"
            "from graphecho_torch.serve import load_exported\n"
            f"d = {str(tmp_path)!r}\n"
            "got = load_exported(d + '/artifact').predict(np.load(d + '/x.npy'))\n"
            "assert (got == np.load(d + '/want.npy')).all()\n"
            "assert not any(m.startswith('graphecho_torch.models.') for m in sys.modules)\n"
            "print('served', got.shape)\n")
        proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                              text=True, timeout=300)
        assert proc.returncode == 0 and "served" in proc.stdout, proc.stdout + proc.stderr


def test_bf16_builds_for_inference_and_the_train_step_refuses():
    cfg = small_cfg(compute_dtype="bfloat16")
    fpn = build_models(cfg)["fpn"]
    assert fpn.dtype == torch.bfloat16
    for build in (lambda: make_train_step(cfg), lambda: Trainer(cfg, device="cpu")):
        with pytest.raises(NotImplementedError, match="bf16 train step"):
            build()


def test_bench_prints_json_lines(monkeypatch, capsys):
    monkeypatch.setattr(bench, "REPS", 1)
    monkeypatch.setattr(bench, "FORWARDS", 1)
    monkeypatch.setattr(bench, "WARMUP", 0)
    assert bench.main(["--device", "cpu", "--batches", "2", "--dtypes", "float32"]) == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    row, head = lines
    assert (row["dtype"], row["batch"], row["timer"], row["device"]) == (
        "float32", 2, "host clock", "cpu")
    assert row["frames_per_s"] > 0 and row["request_frames_per_s"] > 0
    assert row["weight_bytes"] > 0 and 5.9 < row["gflop_per_frame"] < 5.95 and row["bound_ms"] > 0
    assert head == {"metric": "echonet_seg_inference_frames_per_sec",
                    "value": row["frames_per_s"], "unit": "frames/s", "dtype": "float32",
                    "batch": 2, "device": "cpu", "power_limit": None}
