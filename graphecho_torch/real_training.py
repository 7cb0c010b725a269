"""Real-data training wiring: datasets → batch dicts → Trainer, port of
`graphecho_tpu/real_training.py`.

Mirrors the reference trainers' data plumbing (`train_camus_echo.py:155-177`,
`train_cardiac_uda.py:167-194`), with ALL branches wired:

  * source loader (CAMUS / Site_G) + target loader (EchoNet / Site_R) cycled
    alongside (`train_camus_echo.py:162-165`);
  * temporal-graph clip loaders at batch 4 per domain
    (`train_camus_echo.py:96-100`, `train_cardiac_uda.py:107-112`), feeding
    `temp_imgs_source/target` + `temp_masks` plus `update_idx_*` queue
    columns;
  * the 64-frame cycle-consistency clip loader
    (`train_cardiac_uda.py:179-182`, consumed at `:245-253`);
  * per-epoch validation incl. the `Site_R_full` video test with
    `fill_mask=True` (`train_cardiac_uda.py:193-194,376-426`) and the inner
    90/10 valid split (`:185-188`).

update_idx mapping: the reference passes raw dataset indices into the TGCN
momentum queue / clustering CE, sizing the classifier heads by `num_data`
(`train_camus_echo.py:102-108`). Since EchoNet's num_data (~10k) dwarfs the
K=150 queue (`TGCN.py:194`), indices here map onto queue columns with a ring
`% K` (deterministic per video — clips of the same video always hit the same
column; a collision between two videos only perturbs the contrastive bank, as
any finite queue does).

Both entry points run on CUDA unless `device` names another device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

from graphecho_torch.config import ExperimentConfig, camus_echo_config, cardiac_uda_config
from graphecho_torch.data.loader import DataLoader, cycled, rebatched
from graphecho_torch.train.trainer import Trainer

# reference temporal-clip loader batch size (`train_camus_echo.py:99-100`,
# `train_cardiac_uda.py:111-112`)
TEMPORAL_BATCH = 4


def _f32(x) -> np.ndarray:
    return np.asarray(x).astype(np.float32)


def _proc() -> Dict[str, int]:
    """Per-process shard kwargs for train DataLoaders: the rank and world size
    of `torch.distributed` when it is initialised, else 0 and 1. Eval loaders
    stay global — dice is reported from full sets."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return {"process_index": dist.get_rank(), "process_count": dist.get_world_size()}
    return {"process_index": 0, "process_count": 1}


def _check_multihost(cfg: ExperimentConfig, use_mesh: bool) -> None:
    """Multi-process data parallelism covers every branch: each rank's
    loaders give its row block of every entry, the clip halves travel as
    separate source and target keys, and the step gathers the FPN's outputs
    into the global batch before the losses (`train/steps.py`), so no entry
    has to hold whole clips per rank. What has to hold (the JAX package's
    rule, `graphecho_tpu/real_training.py:59-80`, for one device per
    process): several processes train one model only through the mesh, and
    a `mesh_data` names the whole world."""
    n = _proc()["process_count"]
    if n <= 1:
        return
    if not use_mesh:
        raise ValueError(
            f"{n} processes without --use-mesh would each train their own model on their "
            "shard; pass --use-mesh (one process per device)")
    if cfg.train.mesh_data not in (None, n):
        raise ValueError(f"mesh_data={cfg.train.mesh_data} but {n} processes: the port runs "
                         "one process per device")


def _batches(source_loader: DataLoader, cfg: ExperimentConfig,
             target_iter=None, temp_src_iter=None, temp_tgt_iter=None,
             cyc_iter=None) -> Iterator[Dict[str, np.ndarray]]:
    """One epoch of train-step batch dicts (contract: `train/steps.py:66-76`)."""
    t = cfg.train
    for imgs, masks, _, _ in source_loader:
        batch = {"imgs_source": _f32(imgs), "masks": _f32(masks)}
        if t.graph_matching:
            batch["imgs_target"] = _f32(next(target_iter)[0])
        if t.temporal_graph:
            # the clip iterators are `rebatched(...)` to exactly
            # TEMPORAL_BATCH rows, so every step sees identical shapes and
            # the source/target halves match
            s_clip, s_masks, _, s_idx = next(temp_src_iter)
            t_clip, _, _, t_idx = next(temp_tgt_iter)
            # source and target clip halves stay SEPARATE keys; the step
            # concatenates them source-first (`train_camus_echo.py:246`)
            batch["temp_imgs_source"] = _f32(s_clip)
            batch["temp_imgs_target"] = _f32(t_clip)
            batch["temp_masks"] = _f32(s_masks)
            k_src = min(cfg.tgcn.queue_size, cfg.tgcn.source_class)
            k_tgt = min(cfg.tgcn.queue_size, cfg.tgcn.target_class)
            batch["update_idx_source"] = (
                np.asarray(s_idx) % k_src).astype(np.int32)
            batch["update_idx_target"] = (
                np.asarray(t_idx) % k_tgt).astype(np.int32)
        if t.cyc_loss:
            # (1, T64, H, W, 1) -> (T64, H, W, 1); the step takes the loss
            # per whole clip
            clip = _f32(next(cyc_iter)[0])
            batch["cyc_imgs"] = clip.reshape(-1, *clip.shape[2:])
        yield batch


def _eval_pairs(loader: DataLoader, first_channel_only: bool):
    for imgs, masks, _, _ in loader:
        masks = masks.astype(np.float32)
        if first_channel_only:
            masks = masks[..., :1]
        yield imgs.astype(np.float32), masks


def run_camus_echo(args, cfg: Optional[ExperimentConfig] = None, device=None) -> Trainer:
    from graphecho_torch.data.camus import DataLoaderCamus
    from graphecho_torch.data.echo import Echo

    if cfg is None:
        cfg = camus_echo_config(
            view_num=args.view_num,
            graph_matching=not args.no_graph_matching,
            discriminator=not args.no_discriminator,
            temporal_graph=args.temporal_graph)
    _check_multihost(cfg, args.use_mesh)
    d = cfg.data
    src_train = DataLoaderCamus(args.camus_root, stage="train",
                                img_res=d.img_res, img_crop=d.img_crop)
    tgt_train = Echo(args.echonet_root, split="train", validation=False)
    src_loader = DataLoader(src_train, args.batch_size,
                            num_workers=d.num_workers, **_proc())
    # reference target batch = bs * 21 (`train_camus_echo.py:165`); rebatched
    # to a constant leading dim
    tgt_loader = DataLoader(tgt_train, args.batch_size * d.target_batch_mult,
                            num_workers=d.num_workers, drop_last=False,
                            **_proc())
    tgt_iter = rebatched(cycled(tgt_loader),
                         args.batch_size * d.target_batch_mult)

    temp_src_iter = temp_tgt_iter = None
    if cfg.train.temporal_graph:
        # clip loaders, bs=4 each (`train_camus_echo.py:96-100`); CAMUS stills
        # tile into clips, EchoNet supplies real traced-start clips
        temp_src = DataLoaderCamus(args.camus_root, stage="train",
                                   img_res=d.img_res, img_crop=d.img_crop,
                                   single_frame=False,
                                   clip_length=d.clip_length)
        temp_tgt = Echo(args.echonet_root, split="train", validation=False,
                        single_frame=False, length=d.clip_length)
        temp_src_iter = rebatched(cycled(DataLoader(
            temp_src, TEMPORAL_BATCH, num_workers=4, drop_last=False,
            **_proc())),
            TEMPORAL_BATCH)
        temp_tgt_iter = rebatched(cycled(DataLoader(
            temp_tgt, TEMPORAL_BATCH, num_workers=4, drop_last=False,
            **_proc())),
            TEMPORAL_BATCH)

    val_camus = DataLoader(DataLoaderCamus(args.camus_root, stage="valid",
                                           img_res=d.img_res,
                                           img_crop=d.img_crop),
                           1, shuffle=False, drop_last=False)
    val_echo = DataLoader(Echo(args.echonet_root, split="val"),
                          1, shuffle=False, drop_last=False)

    trainer = Trainer(cfg, steps_per_epoch=len(src_loader), device=device,
                      use_mesh=args.use_mesh, log_path=_log(args),
                      checkpoint_dir=args.save_dir, summary_dir=args.log_dir)

    def batches():
        return _batches(src_loader, cfg, target_iter=tgt_iter,
                        temp_src_iter=temp_src_iter,
                        temp_tgt_iter=temp_tgt_iter)

    trainer.init_state(next(batches()),
                       torch_init=getattr(args, "pretrained_backbone", None))
    trainer.train(
        batches,
        num_epochs=args.epochs,
        eval_fns={
            "Inner-Val": lambda: _eval_pairs(val_camus, True),
            "Target Domain - Valid": lambda: _eval_pairs(val_echo, True),
        })
    return trainer


def run_cardiac_uda(args, cfg: Optional[ExperimentConfig] = None, device=None) -> Trainer:
    from graphecho_torch.data.cardiac_uda import SegCardiacUDADataset

    infos = np.load(args.infos, allow_pickle=True).item()
    if cfg is None:
        cfg = cardiac_uda_config(
            view_num=args.view_num,
            graph_matching=not args.no_graph_matching,
            discriminator=not args.no_discriminator,
            temporal_graph=args.temporal_graph,
            cyc_loss=args.cyc_loss)
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, backbone=getattr(args, "backbone", "VGG16")))
    _check_multihost(cfg, args.use_mesh)
    d = cfg.data
    view = (d.view_num,)
    dims = dict(spatial_size=d.img_res[0], crop_size=d.img_crop[0],
                view_num=view, seg_parts=d.seg_parts)
    src_train = SegCardiacUDADataset(infos, args.root, is_train=True,
                                     set_select=("Site_G",), **dims)
    tgt_train = SegCardiacUDADataset(infos, args.root, is_train=True,
                                     set_select=("Site_R",),
                                     source_domain=False, **dims)
    # reference: source bs*2, target bs (`train_cardiac_uda.py:174-177`)
    src_loader = DataLoader(src_train, args.batch_size * 2,
                            num_workers=d.num_workers, **_proc())
    tgt_loader = DataLoader(tgt_train, args.batch_size,
                            num_workers=d.num_workers, drop_last=False,
                            **_proc())
    tgt_iter = rebatched(cycled(tgt_loader), args.batch_size)

    temp_src_iter = temp_tgt_iter = cyc_iter = None
    if cfg.train.temporal_graph:
        # clip loaders bs=4, target oversampled 2x
        # (`train_cardiac_uda.py:107-112`; the reference's set_select names
        # 'gy'/'rmyy' are the authors' internal site ids for Site_G/Site_R)
        temp_src = SegCardiacUDADataset(infos, args.root, is_train=True,
                                        set_select=("Site_G",),
                                        single_frame=False,
                                        clip_length=d.clip_length,
                                        total_length=d.total_length, **dims)
        temp_tgt = SegCardiacUDADataset(infos, args.root, is_train=True,
                                        set_select=("Site_R",), repeat=2,
                                        source_domain=False,
                                        single_frame=False,
                                        clip_length=d.clip_length,
                                        total_length=d.total_length, **dims)
        temp_src_iter = rebatched(cycled(DataLoader(
            temp_src, TEMPORAL_BATCH, num_workers=4, drop_last=False,
            **_proc())),
            TEMPORAL_BATCH)
        temp_tgt_iter = rebatched(cycled(DataLoader(
            temp_tgt, TEMPORAL_BATCH, num_workers=4, drop_last=False,
            **_proc())),
            TEMPORAL_BATCH)
    if cfg.train.cyc_loss:
        # 64-frame clips, bs=1 (`train_cardiac_uda.py:179-182`). Deviation:
        # the reference loads a separate hardcoded `save_infos_reg.npy` from
        # the author's home dir; we reuse the experiment's own infos dict.
        cyc_ds = SegCardiacUDADataset(
            infos, args.root, is_train=True, set_select=("Site_G",),
            single_frame=False, clip_length=cfg.cycle.clip_length,
            total_length=cfg.cycle.clip_length, **dims)
        cyc_iter = cycled(DataLoader(cyc_ds, 1, num_workers=2,
                                     drop_last=False, **_proc()))

    # inner 90/10 valid split (`train_cardiac_uda.py:185-188`). Deviation: the
    # reference selects set_select=['Site_R'] for these Site_G patient ids,
    # which cannot resolve (the ids aren't in the Site_R dict); we look them
    # up in Site_G where they exist.
    val_loader = DataLoader(
        SegCardiacUDADataset(infos, args.root, is_train=False,
                             data_list=src_train.valid_list,
                             set_select=("Site_G",), **dims),
        1, shuffle=False, drop_last=False)
    test_target = DataLoader(
        SegCardiacUDADataset(infos, args.root, is_train=False,
                             data_list=tgt_train.test_list,
                             set_select=("Site_R",), **dims),
        1, shuffle=False, drop_last=False)
    # Site_R_full video test with filled contour masks
    # (`train_cardiac_uda.py:193-194`), flattened (B,T,...)->(B*T,...) in eval
    video_sites = {v["dataset_name"] for v in infos.values()}
    video_select = ("Site_R_full",) if "Site_R_full" in video_sites else ("Site_R",)
    video_test = DataLoader(
        SegCardiacUDADataset(infos, args.root, is_train=False,
                             set_select=video_select, single_frame=False,
                             clip_length=d.clip_length,
                             total_length=d.total_length, fill_mask=True,
                             seed=0, **dims),
        1, shuffle=False, drop_last=False)

    trainer = Trainer(cfg, steps_per_epoch=len(src_loader), device=device,
                      use_mesh=args.use_mesh, log_path=_log(args),
                      checkpoint_dir=args.save_dir, summary_dir=args.log_dir,
                      drop_bg_channel_in_eval=True)

    def batches():
        return _batches(src_loader, cfg, target_iter=tgt_iter,
                        temp_src_iter=temp_src_iter,
                        temp_tgt_iter=temp_tgt_iter, cyc_iter=cyc_iter)

    trainer.init_state(next(batches()),
                       torch_init=getattr(args, "pretrained_backbone", None))
    trainer.train(
        batches,
        num_epochs=args.epochs,
        eval_fns={
            "Inner-Val": lambda: _eval_pairs(val_loader, False),
            "Target Domain - Test": lambda: _eval_pairs(test_target, False),
            "Target Domain - Video Test":
                (lambda: _eval_pairs(video_test, False), True),
        },
        # checkpoints tagged with the VIDEO test dice, like the reference's
        # dice-named saves (`train_cardiac_uda.py:371-372,572-587`)
        select_metric="Target Domain - Video Test")
    return trainer


def _log(args):
    import os

    if args.log_dir:
        os.makedirs(args.log_dir, exist_ok=True)
        return os.path.join(args.log_dir, "train.log")
    return None
