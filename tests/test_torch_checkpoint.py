"""Full-state checkpoints, resume and preemption of the port's Trainer
(`graphecho_torch/train/checkpoint.py`, `train/trainer.py`,
`utils/preemption.py`), on the CPU:

  * exact resume: with every branch on (graph matching, discriminators, the
    momentum-queue TGCN, the cycle loss), N steps straight equal k steps, a
    save, a fresh Trainer that restores, and N - k steps, in every parameter,
    buffer, optimizer tensor, seed bank, queue, counter and the generator's
    state, across an LR milestone;
  * `max_to_keep`, `latest_step`, `save_every` and the dice tags;
  * the summary writer's scalars (the loader's wait among them) and the
    `record_params` histograms;
  * a SIGKILL in the middle of a save leaves the previous checkpoint
    readable and no trace of the new one;
  * `tests/test_dress_rehearsal.py` ported: a real SIGTERM mid-epoch, the
    emergency save at step 3 of 5, the handler uninstalled, the restored
    state bit-equal, and continued progress after resume.
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from graphecho_torch import config as C
from graphecho_torch.data.synthetic import SyntheticEchoData
from graphecho_torch.train.checkpoint import COMPONENTS, TENSORS, CheckpointManager
from graphecho_torch.train.trainer import Trainer

ROOT = Path(__file__).resolve().parent.parent
NARROW = dict(fpn_channels=32, semantic_channels=16,
              vgg_spec=((8, 1), (16, 1), (16, 1), (32, 1), (32, 1)))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and torch's default of a thread per core oversubscribes the machine
    (tens of times slower under load)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _every_branch_cfg():
    """The cardiac recipe with every branch, shrunk (64², widths 32, clips
    2 + 2 of 4 frames, a 24-frame cycle clip), momentum-queue clustering so
    the queues move, and an LR schedule that changes at updates 1 and 2."""
    cfg = C.cardiac_uda_config(temporal_graph=True, cyc_loss=True)
    sch = C.ScheduleConfig(steps=(2,), warmup_iters=1, gamma=0.1)
    t = cfg.train
    return dataclasses.replace(
        cfg,
        train=dataclasses.replace(t, **{n: dataclasses.replace(getattr(t, n), sch=sch)
                                        for n in ("net", "gmn", "dis", "tgcn")}),
        data=dataclasses.replace(cfg.data, img_crop=(64, 64), batch_size=4),
        model=dataclasses.replace(cfg.model, **NARROW),
        gmodule=dataclasses.replace(cfg.gmodule, in_channels=32, nodes_per_class=16),
        dis=dataclasses.replace(cfg.dis, in_channels=32),
        tgcn=dataclasses.replace(cfg.tgcn, input_dim=32, hidden_dim=32, clip_shape=(4, 4, 4),
                                 cluster_method="momentum_queue", queue_size=6,
                                 source_class=6, target_class=6),
        cycle=dataclasses.replace(cfg.cycle, clip_length=24))


def _main_cfg(narrow=False):
    """The dress rehearsal's config: cardiac main branch, 64², batch 2;
    `narrow`: widths 32."""
    width = 32 if narrow else 256
    return C.ExperimentConfig(
        train=C.TrainConfig(graph_matching=True, discriminator=True),
        data=C.DataConfig(img_crop=(64, 64), batch_size=2, target_batch_mult=1),
        model=C.ModelConfig(backbone="VGG16", in_channels=1, num_classes=2,
                            **(NARROW if narrow else {})),
        gmodule=C.GModuleConfig(in_channels=width, num_classes=2, nodes_per_class=16,
                                sampler=C.NodeSamplerConfig(pos_budget_per_level=16)),
        dis=C.DiscriminatorConfig(in_channels=width))


def _snapshot(state):
    """Every tensor and counter of a TrainState, as CPU copies by name."""
    out = {"step": state.step, "epoch": state.epoch,
           "generator": state.generator.get_state().clone()}
    for name in COMPONENTS:
        comp = getattr(state, name)
        if comp is None:
            continue
        for k, v in comp.module.state_dict().items():
            out[f"{name}.module.{k}"] = v.detach().cpu().clone()
        for pid, st in comp.opt.state_dict()["state"].items():
            for k, v in st.items():
                out[f"{name}.opt.{pid}.{k}"] = (v.detach().cpu().clone()
                                                if torch.is_tensor(v) else v)
    for name in TENSORS:
        if getattr(state, name) is not None:
            out[name] = getattr(state, name).detach().cpu().clone()
    return out


def _assert_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if torch.is_tensor(a[k]):
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


def test_interrupted_and_resumed_run_equals_a_straight_run(tmp_path):
    cfg = _every_branch_cfg()
    data = SyntheticEchoData(cfg, seed=3)
    batches = [data.train_batch() for _ in range(4)]
    k = 2

    straight = Trainer(cfg, device="cpu")
    straight.init_state()
    straight.train_epoch(batches[:k], 0)
    straight.train_epoch(batches[k:], 1)

    first = Trainer(cfg, device="cpu", checkpoint_dir=str(tmp_path))
    first.init_state()
    first.train_epoch(batches[:k], 0)
    first.ckpt.save(first.state.step, first.state)
    before = _snapshot(first.state)
    del first
    resumed = Trainer(cfg, device="cpu", checkpoint_dir=str(tmp_path))
    resumed.init_state()
    _assert_equal(_snapshot(resumed.state), before)
    resumed.train_epoch(batches[k:], 1)

    want, got = _snapshot(straight.state), _snapshot(resumed.state)
    assert got["step"] == 4 and len(want) > 100
    _assert_equal(got, want)
    # the queues and the seed banks moved, so their continuity was tested
    init = Trainer(cfg, device="cpu")
    init.init_state()
    assert not torch.equal(init.state.queue_source, resumed.state.queue_source)
    assert not torch.equal(init.state.sr_seed, resumed.state.sr_seed)
    # the LR after resume follows the schedule from the restored step
    assert resumed.state.net.opt.param_groups[0]["lr"] == pytest.approx(cfg.train.net.opt.lr * 0.1)


def _tiny_state(tmp_path):
    trainer = Trainer(_every_branch_cfg(), device="cpu", checkpoint_dir=str(tmp_path))
    trainer.init_state()
    return trainer


def test_max_to_keep_latest_step_and_restore_of_an_older_step(tmp_path):
    trainer = _tiny_state(tmp_path / "a")
    mgr = CheckpointManager(str(tmp_path / "b"), max_to_keep=2)
    assert mgr.latest_step() is None and mgr.restore(trainer.state) is None
    for step in (3, 7, 11, 15):
        trainer.state.step = step
        mgr.save(step, trainer.state, metrics={"dice": step / 100})
    assert mgr.all_steps() == [11, 15] and mgr.latest_step() == 15
    assert sorted(os.listdir(mgr.directory)) == ["11.json", "11.pt", "15.json", "15.pt"]
    assert mgr.metrics() == {"dice": 0.15} and mgr.metrics(11) == {"dice": 0.11}
    mgr.restore(trainer.state, step=11)
    assert trainer.state.step == 11


def test_checkpoints_are_tagged_with_the_selected_dice(tmp_path):
    cfg = _main_cfg(narrow=True)
    data = SyntheticEchoData(cfg, seed=1)
    eval_fns = {"A": lambda: SyntheticEchoData(cfg, seed=5).eval_batches(1),
                "Video": (lambda: SyntheticEchoData(cfg, seed=6).eval_batches(
                    1, video=True, clip_len=2), True),
                "B": lambda: SyntheticEchoData(cfg, seed=7).eval_batches(1)}
    for select, save_every, want_steps in (("Video", 2, [1, 3]), (None, 1, [1, 2, 3])):
        ckpt_dir = tmp_path / str(select)
        trainer = Trainer(cfg, device="cpu", checkpoint_dir=str(ckpt_dir))
        trainer.init_state()
        trainer.train(lambda: [data.train_batch()], num_epochs=3, eval_fns=eval_fns,
                      save_every=save_every, select_metric=select)
        assert trainer.ckpt.all_steps() == want_steps
        tags = trainer.ckpt.metrics()
        sel = select or "B"  # default: the last eval set
        assert tags["dice_metric"] == sel and tags["dice"] == trainer.last_dices[sel]
        assert {k: tags[f"dice/{k}"] for k in eval_fns} == trainer.last_dices


def test_summaries_record_scalars_and_parameter_histograms(tmp_path):
    cfg = _main_cfg(narrow=True)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, record_params=True))
    data = SyntheticEchoData(cfg, seed=1)
    trainer = Trainer(cfg, device="cpu", summary_dir=str(tmp_path))
    trainer.init_state()
    trainer.train(lambda: [data.train_batch()], num_epochs=2,
                  eval_fns={"A": lambda: SyntheticEchoData(cfg, seed=5).eval_batches(1)})
    records = [json.loads(line) for line in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    names = {(r["name"], r["step"]) for r in records}
    assert {("train/seg_loss", 1), ("train/loader_wait_seconds", 2), ("val/A/dice", 2)} <= names
    hists = [r for r in records if r["name"].startswith("params/")]
    n_params = len(list(trainer.state.net.module.parameters()))
    assert len(hists) == 2 * n_params and all(r["hist"]["count"] > 0 for r in hists)


def test_a_kill_during_a_save_leaves_the_previous_checkpoint(tmp_path):
    """A process saves step 1, then is SIGKILLed halfway through writing step
    2: step 1 stays the latest and restores whole."""
    code = f"""
import os, signal, sys
sys.path.insert(0, {str(ROOT)!r})
sys.path.insert(0, {str(ROOT / "tests")!r})
from graphecho_torch.train import checkpoint
from test_torch_checkpoint import _tiny_state
trainer = _tiny_state({str(tmp_path)!r})
trainer.state.step = 1
trainer.ckpt.save(1, trainer.state, metrics={{"dice": 0.5}})

def dying_save(obj, f):
    f.write(b"half a checkpoint" * 1000)
    f.flush()
    os.kill(os.getpid(), signal.SIGKILL)

checkpoint.torch.save = dying_save
trainer.state.step = 2
trainer.ckpt.save(2, trainer.state, metrics={{"dice": 0.9}})
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == -signal.SIGKILL, proc.stderr
    trainer = _tiny_state(tmp_path)  # init_state restored step 1
    assert trainer.ckpt.all_steps() == [1] and trainer.state.step == 1
    assert trainer.ckpt.metrics(1) == {"dice": 0.5}
    assert not (tmp_path / "2.pt").exists()


# ---------------------------------------------------------------- dress rehearsal
STEPS_PER_EPOCH = 5


def _epoch_batches(cfg, epoch_seed):
    data = SyntheticEchoData(cfg, seed=epoch_seed)
    return [data.train_batch() for _ in range(STEPS_PER_EPOCH)]


def _video_batches(cfg):
    return SyntheticEchoData(cfg, seed=999).eval_batches(3, video=True, clip_len=4)


def test_preempt_resume_continuity(tmp_path):
    cfg = _main_cfg()
    ckpt_dir = str(tmp_path / "ckpt")
    handler = signal.getsignal(signal.SIGTERM)

    # ---------------- phase A: train, SIGTERM after 2 steps of epoch 0
    trainer_a = Trainer(cfg, steps_per_epoch=STEPS_PER_EPOCH, device="cpu",
                        checkpoint_dir=ckpt_dir)
    trainer_a.init_state()

    def interrupted_batches():
        for i, b in enumerate(_epoch_batches(cfg, 0)):
            if i == 2:
                os.kill(os.getpid(), signal.SIGTERM)  # real preemption signal
            yield b

    trainer_a.train(interrupted_batches, num_epochs=4,
                    eval_fns={"Video Test": (lambda: _video_batches(cfg), True)})
    # the signal arrived while batch 2 was being produced; that step still
    # runs, the flag is checked after it -> emergency save at step 3 of 5
    saved_step = trainer_a.ckpt.latest_step()
    assert saved_step == 3 and trainer_a.state.step == 3
    # the preemption handler is uninstalled again (train()'s finally)
    assert signal.getsignal(signal.SIGTERM) == handler
    a_state = _snapshot(trainer_a.state)

    # ---------------- phase B: a fresh trainer resumes
    trainer_b = Trainer(cfg, steps_per_epoch=STEPS_PER_EPOCH, device="cpu",
                        checkpoint_dir=ckpt_dir)
    trainer_b.init_state()
    assert trainer_b.state.step == saved_step, "did not resume"
    _assert_equal(_snapshot(trainer_b.state), a_state)

    # ---------------- continued progress after resume
    dices, seg_losses = [], []
    for epoch in range(3):
        m = trainer_b.train_epoch(_epoch_batches(cfg, epoch), epoch)
        seg_losses.append(m["seg_loss"])
        dices.append(trainer_b.validation(_video_batches(cfg), "Video Test", is_video=True))
    assert trainer_b.state.step == saved_step + 3 * STEPS_PER_EPOCH
    assert all(np.isfinite(v) for v in seg_losses)
    # supervised seg on a fixed synthetic distribution must make progress
    assert seg_losses[-1] < seg_losses[0], seg_losses
    assert all(np.isfinite(d) for d in dices)
    assert dices[-1] >= dices[0] - 0.05, dices
