"""The training rehearsal (`graphecho_torch/train_rehearsal.py`) and its
report (`graphecho_torch/rehearsal_report.py`) on the CPU, at a tiny size:

  * `run` for 3 epochs of 4 steps uninterrupted, and again SIGTERMed after
    global step 6 (it stops with a checkpoint after step 7) and re-invoked:
    the resumed run says so, ends at step 12, and every row it shares with
    the uninterrupted curve equals it to the printed digit (the split
    epoch's loss means alone may differ); the report's check passes;
  * the same check fails on a copy with one dice changed in its last digit,
    with a second loss-only row, and with no overlap;
  * the CLI refuses to run without a card unless `--device cpu` is given;
  * on CUDA, `main` turns deterministic algorithms on and sets
    `CUBLAS_WORKSPACE_CONFIG` before `run` (a foreign workspace value
    raises), on the CPU it changes neither, and `run` on CUDA refuses to
    start with them off; `profile_step --deterministic` turns them on before
    it profiles.
"""

import dataclasses
import json
import os
import signal

import pytest
import torch

from graphecho_torch import config as C
from graphecho_torch import profile_step, rehearsal_report, train_rehearsal


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and torch's default of a thread per core oversubscribes the machine
    (tens of times slower under load)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


NARROW = dict(fpn_channels=32, semantic_channels=16,
              vgg_spec=((8, 1), (16, 1), (16, 1), (32, 1), (32, 1)))


def _tiny_cfg():
    """cardiac_full shrunk: every branch (graph matching, discriminators, the
    momentum-queue TGCN, the cycle loss) at 64², widths 32, batch 4 + 4."""
    cfg = C.cardiac_uda_config(temporal_graph=True, cyc_loss=True)
    return dataclasses.replace(
        cfg,
        data=dataclasses.replace(cfg.data, img_crop=(64, 64), batch_size=4),
        model=dataclasses.replace(cfg.model, **NARROW),
        gmodule=dataclasses.replace(cfg.gmodule, in_channels=32, nodes_per_class=16),
        dis=dataclasses.replace(cfg.dis, in_channels=32),
        tgcn=dataclasses.replace(cfg.tgcn, input_dim=32, hidden_dim=32, clip_shape=(4, 4, 4),
                                 cluster_method="momentum_queue", queue_size=6,
                                 source_class=6, target_class=6),
        cycle=dataclasses.replace(cfg.cycle, clip_length=24))


RUN = dict(recipe="cardiac_full", bf16=False, epochs=3, steps_per_epoch=4, eval_samples=4,
           device="cpu")


@pytest.fixture(scope="module")
def curves(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("rehearsal")
    handler = signal.getsignal(signal.SIGTERM)
    straight = train_rehearsal.run(_tiny_cfg(), ckpt=str(tmp / "a"), out=str(tmp / "a.jsonl"),
                                   **RUN)
    stopped = train_rehearsal.run(_tiny_cfg(), ckpt=str(tmp / "b"), out=str(tmp / "b.jsonl"),
                                  sigterm_at_step=6, **RUN)
    stopped_at = stopped.state.step
    resumed = train_rehearsal.run(_tiny_cfg(), ckpt=str(tmp / "b"), out=str(tmp / "b.jsonl"),
                                  **RUN)
    assert signal.getsignal(signal.SIGTERM) == handler
    return tmp, straight, stopped_at, resumed


def test_the_resumed_curve_overlays_the_uninterrupted_one(curves, capsys):
    tmp, straight, stopped_at, resumed = curves
    assert stopped_at == 7 and resumed.ckpt.latest_step() == 7 + 5
    assert straight.state.step == resumed.state.step == 12
    rows = rehearsal_report.load(str(tmp / "a.jsonl"))
    res = rehearsal_report.load(str(tmp / "b.jsonl"))
    assert [r["step"] for r in rows] == [4, 8, 12] and [r["step"] for r in res] == [4, 8, 12]
    assert set(rows[0]) == {"recipe", "bf16", "step", "total_loss", "seg_loss", "dice",
                            "step_seconds"}
    # epoch 0 ran before the stop, epoch 2 after the resume: equal in every key
    keys = ("total_loss", "seg_loss", "dice")
    for i in (0, 2):
        assert {k: rows[i][k] for k in keys} == {k: res[i][k] for k in keys}
    # the split epoch: its dice equal, its loss means over step 8 alone
    assert rows[1]["dice"] == res[1]["dice"] and rows[1]["seg_loss"] != res[1]["seg_loss"]
    assert rehearsal_report.overlay(rows, res) == (2, 1, [])
    assert rehearsal_report.main([str(tmp / "a.jsonl"), "--resume", str(tmp / "b.jsonl")]) == 0
    out = capsys.readouterr().out
    assert "| step | 4 | 12 |" in out and "2 rows equal, 1 equal in dice alone" in out


def _write(path, rows):
    path.write_text("".join(json.dumps(r) + "\n" for r in rows))
    return str(path)


def test_the_report_fails_on_a_one_digit_change(curves, capsys):
    tmp = curves[0]
    rows = rehearsal_report.load(str(tmp / "a.jsonl"))
    res = rehearsal_report.load(str(tmp / "b.jsonl"))
    a = _write(tmp / "copy_a.jsonl", rows)

    changed = [dict(r) for r in res]
    changed[-1]["dice"] = round(changed[-1]["dice"] + 1e-6, 6)
    assert rehearsal_report.main([a, "--resume", _write(tmp / "dice.jsonl", changed)]) == 1
    assert "step 12: uninterrupted" in capsys.readouterr().out

    two_loss_only = [dict(r) for r in res]
    two_loss_only[2]["total_loss"] = round(two_loss_only[2]["total_loss"] + 1e-6, 6)
    assert rehearsal_report.main([a, "--resume", _write(tmp / "loss.jsonl", two_loss_only)]) == 1
    assert "2 rows equal in dice alone" in capsys.readouterr().out

    elsewhere = [dict(r, step=r["step"] + 1) for r in res]
    assert rehearsal_report.main([a, "--resume", _write(tmp / "none.jsonl", elsewhere)]) == 1
    assert "not in the uninterrupted curve" in capsys.readouterr().out


def test_the_cli_needs_a_card_unless_told_otherwise(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    args = ["--ckpt", str(tmp_path / "c"), "--out", str(tmp_path / "c.jsonl")]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_rehearsal.main(args)
    assert not (tmp_path / "c.jsonl").exists() and not (tmp_path / "c").exists()
    # with --device cpu it runs: the recipe and the flags reach `run`
    seen = {}
    monkeypatch.setattr(train_rehearsal, "run", lambda cfg, **kw: seen.update(cfg=cfg, **kw))
    train_rehearsal.main(args + ["--device", "cpu", "--recipe", "cardiac_full", "--bf16",
                                 "--sigterm-at-step", "5", "--epochs", "2"])
    assert seen["cfg"].model.compute_dtype == "bfloat16" and seen["cfg"].train.cyc_loss
    assert (seen["device"].type, seen["sigterm_at_step"], seen["epochs"], seen["bf16"]) == (
        "cpu", 5, 2, True)
    assert seen["cfg"].data.batch_size == 8 and seen["steps_per_epoch"] == 30


@pytest.fixture
def switch_off(monkeypatch):
    """Deterministic algorithms off and CUBLAS_WORKSPACE_CONFIG unset, each
    restored to what it was afterwards."""
    on = torch.are_deterministic_algorithms_enabled()
    warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", "")  # recorded, so restored at teardown
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG")
    torch.use_deterministic_algorithms(False)
    yield
    torch.use_deterministic_algorithms(on, warn_only=warn_only)


def _seen_by_run(monkeypatch):
    seen = {}
    monkeypatch.setattr(train_rehearsal, "run", lambda cfg, **kw: seen.update(
        deterministic=torch.are_deterministic_algorithms_enabled(),
        workspace=os.environ.get("CUBLAS_WORKSPACE_CONFIG"), device=kw["device"]))
    return seen


@pytest.mark.parametrize("workspace", [None, ":16:8"])
def test_main_on_cuda_turns_deterministic_algorithms_on(tmp_path, monkeypatch, switch_off,
                                                        workspace):
    if workspace is not None:
        monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", workspace)
    seen = _seen_by_run(monkeypatch)
    train_rehearsal.main(["--ckpt", str(tmp_path / "c"), "--out", str(tmp_path / "c.jsonl"),
                          "--device", "cuda"])
    assert seen == {"deterministic": True, "workspace": workspace or ":4096:8",
                    "device": torch.device("cuda")}


def test_main_on_the_cpu_changes_neither(tmp_path, monkeypatch, switch_off):
    seen = _seen_by_run(monkeypatch)
    train_rehearsal.main(["--ckpt", str(tmp_path / "c"), "--out", str(tmp_path / "c.jsonl"),
                          "--device", "cpu"])
    assert seen == {"deterministic": False, "workspace": None, "device": torch.device("cpu")}


def test_a_foreign_cublas_workspace_raises(tmp_path, monkeypatch, switch_off):
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":0:0")
    seen = _seen_by_run(monkeypatch)
    with pytest.raises(RuntimeError, match="CUBLAS_WORKSPACE_CONFIG=':0:0'"):
        train_rehearsal.main(["--ckpt", str(tmp_path / "c"), "--out",
                              str(tmp_path / "c.jsonl"), "--device", "cuda"])
    assert seen == {} and not torch.are_deterministic_algorithms_enabled()


def test_run_on_cuda_refuses_to_start_without_deterministic_algorithms(tmp_path, monkeypatch,
                                                                       switch_off):
    class Built(Exception):
        pass

    def trainer(*args, **kwargs):
        raise Built
    monkeypatch.setattr(train_rehearsal, "Trainer", trainer)
    kw = dict(RUN, device="cuda", ckpt=str(tmp_path / "c"), out=str(tmp_path / "c.jsonl"))
    with pytest.raises(RuntimeError, match="deterministic_algorithms"):
        train_rehearsal.run(None, **kw)
    torch.use_deterministic_algorithms(True)
    with pytest.raises(Built):  # switched on, it goes on to build its Trainer
        train_rehearsal.run(None, **kw)
    assert not (tmp_path / "c.jsonl").exists()


@pytest.mark.parametrize("flag", [[], ["--deterministic"]])
def test_profile_step_turns_deterministic_algorithms_on_when_asked(monkeypatch, capsys,
                                                                   switch_off, flag):
    args = profile_step.build_parser().parse_args(["--recipe", "cardiac_full", "--bf16", *flag])
    assert args.deterministic == bool(flag)
    monkeypatch.setattr(profile_step, "profile", lambda recipe, steps, warmup, **options: {
        "recipe": recipe, "options": options,
        "deterministic": torch.are_deterministic_algorithms_enabled(),
        "workspace": os.environ.get("CUBLAS_WORKSPACE_CONFIG")})
    profile_step.main(["--recipe", "cardiac_full", "--bf16", *flag])
    assert json.loads(capsys.readouterr().out) == {
        "recipe": "cardiac_full", "options": {"compute_dtype": "bfloat16"},
        "deterministic": bool(flag), "workspace": ":4096:8" if flag else None}
