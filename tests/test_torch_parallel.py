"""Data parallelism of the port (`graphecho_torch/parallel/mesh.py`) on the
CPU: two gloo processes against one process on the same global batch.

The JAX package's GSPMD step on a sharded batch computes what one device
computes on the whole batch (`tests/test_multihost.py:118-123` holds it to
rtol 1e-4 / atol 1e-6). The port keeps those semantics by hand: global
BatchNorm statistics in the FPN, the FPN's outputs gathered with autograd,
the rest of the step replicated, the FPN's gradients summed. Held here:

  * two processes (each a subprocess with its own timeout, this file run as
    a script), for a base step (graph matching and discriminators) and a
    step with every branch (temporal TGCN with its dropouts on, the cycle
    loss, a clip split across the ranks): every loss, every post-step
    parameter, buffer and seed bank and queue within rtol 1e-4 / atol 1e-6
    of the one-process step, equal on both ranks, and the eval step's
    counts and loss over an uneven split (three rows on two ranks);
  * `shard_batch`'s refusals;
  * a world of one: the data-parallel step equals the plain step bit for
    bit.
"""

import dataclasses
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:  # run as a script by the two-process test
    sys.path.insert(0, str(ROOT))

from graphecho_torch import config as C  # noqa: E402
from graphecho_torch.parallel.mesh import Mesh, create_mesh, shard_batch  # noqa: E402
from graphecho_torch.train.state import create_train_state  # noqa: E402
from graphecho_torch.train.steps import build_models, make_eval_step, make_train_step  # noqa: E402


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and torch's default of a thread per core oversubscribes the machine
    (tens of times slower under load)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


B, HW, T, CYC = 4, 64, 2, 24
RTOL, ATOL = 1e-4, 1e-6


def _cfg(branch: str) -> C.ExperimentConfig:
    """The cardiac recipe at the port tests' widths: tiny VGG16, two
    classes, 64^2 frames; with `every`, the TGCN on a 4x4 grid and a
    24-frame cycle clip. Every component steps with the recipe's SGD
    (lr 2.5e-3), whose update is linear in the gradient: Adam's first step
    is lr * sign(g), which turns the rounding noise of a gradient that is 0
    in exact arithmetic (a conv bias in front of a train-mode BatchNorm)
    into a full +-lr step."""
    sch = C.ScheduleConfig(steps=(2,), warmup_iters=1, gamma=0.1)
    comp = {name: C.ComponentConfig(opt=C.OptimizerConfig("SGD", 2.5e-3), sch=sch)
            for name in ("net", "gmn", "dis", "tgcn")}
    every = branch == "every"
    return C.ExperimentConfig(
        train=C.TrainConfig(temporal_graph=every, cyc_loss=every, **comp),
        data=C.DataConfig(img_crop=(HW, HW), batch_size=B, target_batch_mult=1),
        model=C.ModelConfig(backbone="VGG16", num_classes=2, fpn_channels=32,
                            semantic_channels=16,
                            vgg_spec=((8, 1), (16, 1), (16, 1), (32, 1), (32, 1))),
        gmodule=C.GModuleConfig(in_channels=32, num_classes=2, nodes_per_class=64,
                                dropout=0.0),
        dis=C.DiscriminatorConfig(in_channels=32),
        tgcn=C.TGCNConfig(input_dim=32, hidden_dim=32, clip_shape=(T, 4, 4), knn_k=3,
                          cluster_method="momentum_queue", queue_size=6, source_class=6,
                          target_class=6),
        cycle=C.CycleConfig(clip_length=CYC))


def _global_batch(branch: str):
    """One global batch: channel 1 a rectangle, channel 0 its complement."""
    rng = np.random.RandomState(11)
    masks = np.zeros((B, HW, HW, 2), np.float32)
    masks[:, 8:40, 8:40, 1] = 1.0
    masks[..., 0] = 1.0 - masks[..., 1]
    frames = lambda n: (rng.rand(n, HW, HW, 1) * 0.6).astype(np.float32)  # noqa: E731
    batch = {"imgs_source": frames(B), "imgs_target": frames(B), "masks": masks}
    if branch == "every":
        batch.update(
            temp_imgs_source=frames(2 * T).reshape(2, T, HW, HW, 1),
            temp_imgs_target=frames(2 * T).reshape(2, T, HW, HW, 1),
            temp_masks=np.repeat(masks[:2, None], T, axis=1),
            update_idx_source=np.array([2, 2], np.int32),
            update_idx_target=np.array([5, 1], np.int32),
            cyc_imgs=frames(CYC))
    return batch


def _eval_batch():
    rng = np.random.RandomState(12)
    imgs = (rng.rand(3, HW, HW, 1) * 0.6).astype(np.float32)
    masks = np.zeros((3, HW, HW, 2), np.float32)
    masks[:, 16:48, 10:30, 1] = 1.0
    masks[..., 0] = 1.0 - masks[..., 1]
    return imgs, masks


def _state_tensors(state):
    """Every tensor a step writes, by name."""
    out = {f"{name}.{k}": v.detach().clone()
           for name in ("net", "gmn", "dis", "tgcn") if getattr(state, name) is not None
           for k, v in getattr(state, name).module.state_dict().items()}
    for name in ("sr_seed", "tg_seed", "queue_source", "queue_target"):
        if getattr(state, name) is not None:
            out[name] = getattr(state, name).clone()
    return out


def _run(branch: str, mesh=None, batch=None):
    """One train step and one eval pass from the seed-0 state; returns
    (losses, post-step tensors, eval counts and loss)."""
    cfg = _cfg(branch)
    state = create_train_state(cfg, build_models(cfg), torch.device("cpu"), seed=0)
    batch = _global_batch(branch) if batch is None else batch
    metrics = make_train_step(cfg, mesh)(state, batch)
    counts, per_part, loss = make_eval_step(cfg, True, mesh)(state, *_eval_batch())
    evals = {**counts, **{f"{p}.{k}": v for p, c in per_part.items() for k, v in c.items()},
             "loss": loss}
    return ({k: float(v) for k, v in metrics.items()}, _state_tensors(state),
            {k: float(v) for k, v in evals.items()}, state)


def _worker(rank: int, world: int, port: int, branch: str, out: str) -> None:
    """One rank of the two-process run (this file run as a script)."""
    import torch.distributed as dist

    from graphecho_torch.parallel.mesh import all_reduce_grads, max_abs_spread

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                            rank=rank)
    try:
        mesh = create_mesh(world)
        local = shard_batch(mesh, _global_batch(branch))
        losses, tensors, evals, state = _run(branch, mesh, local)
        replicated = [t for name, c in (("gmn", state.gmn), ("dis", state.dis),
                                        ("tgcn", state.tgcn)) if c is not None
                      for t in c.module.parameters()]
        spread = {"fpn": max_abs_spread(mesh, list(state.net.module.parameters())),
                  "replicated": max_abs_spread(mesh, replicated)}
        # replicated state that drifted apart (rank r holding r) is averaged
        drift = torch.full((3,), float(rank))
        all_reduce_grads(mesh, (), (), [drift])
        torch.save({"losses": losses, "tensors": tensors, "evals": evals, "spread": spread,
                    "drift": drift}, out)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("branch", ["base", "every"])
def test_two_gloo_processes_equal_one_process(branch, tmp_path):
    port = _free_port()
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(rank), "2", str(port), branch,
         str(tmp_path / f"rank{rank}.pt")], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for rank in range(2)]
    try:
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(2)]
    want_losses, want_tensors, want_evals, _ = _run(branch)
    for r, got in enumerate(ranks):
        assert got["spread"] == {"fpn": 0.0, "replicated": 0.0}, got["spread"]
        assert got["drift"].tolist() == [0.5] * 3
        assert set(got["losses"]) == set(want_losses)
        for k, v in want_losses.items():
            np.testing.assert_allclose(got["losses"][k], v, rtol=RTOL, atol=ATOL,
                                       err_msg=f"rank {r} {k}")
        assert set(got["tensors"]) == set(want_tensors)
        worst = 0.0
        for k, v in want_tensors.items():
            np.testing.assert_allclose(got["tensors"][k].numpy(), v.numpy(), rtol=RTOL,
                                       atol=ATOL, err_msg=f"rank {r} {k}")
            worst = max(worst, float((got["tensors"][k] - v).abs().max()))
        for k, v in want_evals.items():
            np.testing.assert_allclose(got["evals"][k], v, rtol=RTOL, atol=ATOL,
                                       err_msg=f"rank {r} eval {k}")
        print(f"PARITY data parallel {branch} rank {r}: largest post-step error {worst:.3g}")
    for k in ranks[0]["tensors"]:
        assert torch.equal(ranks[0]["tensors"][k], ranks[1]["tensors"][k]), k


def test_shard_batch_refuses_what_does_not_divide():
    batch = {"a": np.arange(12).reshape(6, 2), "b": np.arange(4)}
    got = shard_batch(Mesh(None, 2, 1), batch)
    np.testing.assert_array_equal(got["a"], batch["a"][3:])
    np.testing.assert_array_equal(got["b"], [2, 3])
    for bad in ({"c": np.zeros((3, 2))}, {"d": np.float32(1.0)}):
        with pytest.raises(ValueError, match="cannot be sharded"):
            shard_batch(Mesh(None, 2, 0), {**batch, **bad})
    assert create_mesh() == Mesh(None, 1, 0)
    with pytest.raises(ValueError, match="mesh_data"):
        create_mesh(2)


@pytest.mark.parametrize("branch", ["base", "every"])
def test_a_world_of_one_equals_the_plain_step_bit_for_bit(branch, tmp_path):
    import torch.distributed as dist

    want_losses, want_tensors, want_evals, _ = _run(branch)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", world_size=1,
                            rank=0)
    try:
        mesh = create_mesh(1)
        assert mesh.group is not None and mesh.size == 1
        losses, tensors, evals, _ = _run(branch, mesh)
    finally:
        dist.destroy_process_group()
    assert losses == want_losses
    assert all(torch.equal(tensors[k], want_tensors[k]) for k in want_tensors)
    assert evals.keys() == want_evals.keys()
    for k, v in want_evals.items():
        # the data-parallel eval divides a summed loss; the counts are exact
        assert evals[k] == v if k != "loss" else abs(evals[k] - v) <= 1e-6 * abs(v), k


def test_a_world_of_one_trainer_trains_validates_and_saves(tmp_path):
    """`Trainer(use_mesh=True)` over a world of one: the state broadcast from
    rank 0, one epoch and a validation equal the plain Trainer's; rank 0
    writes the checkpoint."""
    import torch.distributed as dist

    from graphecho_torch.train.trainer import Trainer

    cfg = _cfg("base")

    def run(**kw):
        trainer = Trainer(cfg, device="cpu", **kw)
        trainer.init_state(seed=0)
        trainer.train(lambda: iter([_global_batch("base")]), num_epochs=1,
                      eval_fns={"val": lambda: iter([_eval_batch()])})
        return trainer

    plain = run()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", world_size=1,
                            rank=0)
    try:
        dp = run(use_mesh=True, checkpoint_dir=str(tmp_path / "ckpt"))
    finally:
        dist.destroy_process_group()
    assert dp.mesh.size == 1 and dp.is_chief
    losses = [k for k in plain.last_epoch_metrics if k.endswith("loss")]
    assert losses and all(dp.last_epoch_metrics[k] == plain.last_epoch_metrics[k]
                          for k in losses)
    assert abs(dp.last_dices["val"] - plain.last_dices["val"]) <= 1e-6
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["1.json", "1.pt"]


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
