"""Training entry points, port of `graphecho_tpu/entrypoints.py`.

`train_camus_echo(...)` / `train_cardiac_uda(...)` correspond to the
reference's `python train_camus_echo.py` / `python train_cardiac_uda.py`
(`train_camus_echo.py:517-653`): build the experiment config, the trainer and
the (synthetic) data, then run the epoch loop with per-epoch validation.
They run on CUDA unless `device` names another device; with no GPU and no
`device` they raise. `cfg` replaces the paper's configuration as a whole (the
tests run a shrunken one). With `checkpoint_dir` a run saves its whole state
after each epoch and resumes from the latest checkpoint there. With
`use_mesh` the run is data parallel over the process group
(`parallel/mesh.py`): every rank draws the same global synthetic batch and
trains its row block of it (`shard_batch`). `torch_init` names an upstream
`.pth` for the FPN. The CardiacUDA recipe's masks carry a background
channel, which its evaluation leaves out (`train_cardiac_uda.py:72-73,
399-400`); `backbone` sets `ModelConfig.backbone` of the recipe's
configuration (VGG16-BN, or `pvig_s`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from graphecho_torch.config import ExperimentConfig, camus_echo_config, cardiac_uda_config
from graphecho_torch.data.synthetic import SyntheticEchoData
from graphecho_torch.parallel.mesh import shard_batch
from graphecho_torch.train.trainer import Trainer


def _run(cfg: ExperimentConfig, steps_per_epoch: int, num_epochs: Optional[int],
         checkpoint_dir: Optional[str], log_path: Optional[str], use_mesh: bool,
         seed: int, n_eval: int, torch_init: Optional[str], device,
         bg_channel: bool) -> Trainer:
    trainer = Trainer(cfg, steps_per_epoch=steps_per_epoch, device=device,
                      use_mesh=use_mesh, log_path=log_path,
                      checkpoint_dir=checkpoint_dir, drop_bg_channel_in_eval=bg_channel)
    data = SyntheticEchoData(cfg, seed=seed, bg_channel=bg_channel)
    trainer.init_state(torch_init=torch_init)

    def batches():
        for _ in range(steps_per_epoch):
            batch = data.train_batch()
            yield batch if trainer.mesh is None else shard_batch(trainer.mesh, batch)

    eval_fns = {"Inner-Val": lambda: data.eval_batches(n_eval),
                "Target Domain - Valid": lambda: data.eval_batches(n_eval)}
    trainer.train(batches, num_epochs=num_epochs, eval_fns=eval_fns)
    return trainer


def train_camus_echo(num_epochs: Optional[int] = 1, steps_per_epoch: int = 4,
                     checkpoint_dir: Optional[str] = None,
                     log_path: Optional[str] = None, use_mesh: bool = False,
                     seed: int = 123, n_eval: int = 4,
                     torch_init: Optional[str] = None, device=None,
                     cfg: Optional[ExperimentConfig] = None,
                     **cfg_overrides) -> Trainer:
    """CAMUS→EchoNet UDA (reference `train_camus_echo.py:546-637` defaults)."""
    cfg = cfg or camus_echo_config(**cfg_overrides)
    return _run(cfg, steps_per_epoch, num_epochs, checkpoint_dir, log_path,
                use_mesh, seed, n_eval, torch_init, device, False)


def train_cardiac_uda(num_epochs: Optional[int] = 1, steps_per_epoch: int = 4,
                      checkpoint_dir: Optional[str] = None,
                      log_path: Optional[str] = None, use_mesh: bool = False,
                      seed: int = 123, n_eval: int = 4,
                      torch_init: Optional[str] = None, device=None,
                      cfg: Optional[ExperimentConfig] = None, backbone: str = "VGG16",
                      **cfg_overrides) -> Trainer:
    """CardiacUDA Site_G→Site_R (reference `train_cardiac_uda.py:645-736`)."""
    if cfg is None:
        cfg = cardiac_uda_config(**cfg_overrides)
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, backbone=backbone))
    return _run(cfg, steps_per_epoch, num_epochs, checkpoint_dir, log_path,
                use_mesh, seed, n_eval, torch_init, device, True)
