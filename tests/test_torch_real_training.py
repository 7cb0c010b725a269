"""The port's real-data path (`graphecho_torch/real_training.py` and its two
CLIs) on synthesized on-disk fixtures (.mhd/.avi/.nii.gz), on the CPU:

  * `tests/test_real_training.py` ported: both recipes with every branch on
    (graph matching, discriminators, the temporal graph, the cycle loss, the
    Site_R_full-style video validation), narrow widths;
  * `real_training._batches` bit-equal to the JAX package's on the same
    fixture, every branch's keys, one loader thread (the thread pool makes
    the draw order of a dataset's rng nondeterministic in both packages);
  * each port CLI accepts every flag of its JAX parser, and the flags whose
    code paths come with later slices raise `NotImplementedError`.
"""

import argparse
import dataclasses

import numpy as np
import pytest
import torch

from graphecho_torch import config as C
from graphecho_torch import real_training, train_camus_echo, train_cardiac_uda
from graphecho_torch.data.formats import write_mhd, write_nifti
from graphecho_torch.ops import knn
from graphecho_torch.ops import pairwise_mlp as pm

LOSSES = {"seg_loss", "dis_loss", "node_loss", "mat_loss_aff", "mat_loss_qu",
          "loss_adv_p2", "loss_adv_p3", "loss_adv_p4", "loss_adv_p5",
          "temporal_graph_loss", "total_loss"}
NARROW = dict(fpn_channels=32, semantic_channels=16)
VGG_SPEC = ((8, 1), (16, 1), (16, 1), (32, 1), (32, 1))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and torch's default of a thread per core oversubscribes the machine
    (tens of times slower under load)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _args(**kw):
    base = dict(epochs=1, batch_size=2, view_num="2", camus_root=None,
                echonet_root=None, root=None, infos=None, save_dir=None,
                log_dir=None, use_mesh=False, seed=0, no_graph_matching=False,
                no_discriminator=False, temporal_graph=True, cyc_loss=True,
                steps_per_epoch=2)
    base.update(kw)
    return argparse.Namespace(**base)


def _tiny_tgcn(pkg=C, frames=4):
    # 128² images -> levels 32/16/8/4, pool r=(8,4,2,1) -> 4x4 nodes per frame
    return pkg.TGCNConfig(input_dim=32, hidden_dim=32, clip_shape=(frames, 4, 4),
                          pool_ratios=(8, 4, 2, 1), knn_k=4, queue_size=10,
                          cluster_method="momentum_queue")


def _camus_cfg(pkg=C):
    return pkg.ExperimentConfig(
        train=pkg.TrainConfig(graph_matching=True, discriminator=True, temporal_graph=True),
        data=pkg.DataConfig(img_res=(140, 140), img_crop=(128, 128), clip_length=2,
                            view_num="2", batch_size=2, target_batch_mult=2, num_workers=1),
        model=pkg.ModelConfig(backbone="resnet", in_channels=1, num_classes=1, **NARROW),
        gmodule=pkg.GModuleConfig(in_channels=32, num_classes=1, nodes_per_class=16,
                                  sampler=pkg.NodeSamplerConfig(pos_budget_per_level=16)),
        dis=pkg.DiscriminatorConfig(in_channels=32),
        tgcn=_tiny_tgcn(pkg, frames=2))


def _cardiac_cfg(pkg=C):
    return pkg.ExperimentConfig(
        train=pkg.TrainConfig(graph_matching=True, discriminator=True, temporal_graph=True,
                              cyc_loss=True),
        data=pkg.DataConfig(img_res=(140, 140), img_crop=(128, 128), clip_length=4,
                            total_length=8, view_num="1", batch_size=2,
                            target_batch_mult=1, num_workers=1),
        model=pkg.ModelConfig(backbone="VGG16", in_channels=1, num_classes=3,
                              vgg_spec=VGG_SPEC, **NARROW),
        gmodule=pkg.GModuleConfig(in_channels=32, num_classes=3, nodes_per_class=16,
                                  sampler=pkg.NodeSamplerConfig(pos_budget_per_level=16)),
        dis=pkg.DiscriminatorConfig(in_channels=32),
        tgcn=_tiny_tgcn(pkg),
        cycle=pkg.CycleConfig(target_region=4, cyc_off=1, chunk_size=2, temperature=10.0,
                              clip_length=8))


@pytest.fixture
def camus_root(tmp_path):
    rng = np.random.RandomState(0)
    for i in range(10):
        pid = f"patient{i:04d}"
        d = tmp_path / "camus" / "training" / pid
        d.mkdir(parents=True)
        img = (rng.rand(60, 70) * 255).astype(np.uint8)
        gt = np.zeros((60, 70), np.uint8)
        gt[10:35, 15:45] = 1  # LV
        gt[38:52, 15:45] = 3  # LA
        write_mhd(str(d / f"{pid}_4CH_ED.mhd"), img)
        write_mhd(str(d / f"{pid}_4CH_ED_gt.mhd"), gt)
    return str(tmp_path / "camus")


@pytest.fixture
def echo_root(tmp_path):
    from graphecho_torch.data.video import savevideo

    rng = np.random.RandomState(1)
    root = tmp_path / "echo"
    (root / "Videos").mkdir(parents=True)
    rows = ["FileName,X1,Y1,X2,Y2,Frame"]
    split_rows = ["FileName,Split"]
    for i in range(5):
        name = f"vid{i}.avi"
        vid = (rng.rand(12, 128, 128) * 255).astype(np.uint8)
        savevideo(str(root / "Videos" / name), vid)
        split_rows.append(f"{name},{'VAL' if i == 4 else 'TRAIN'}")
        for frame in (2, 7):  # two traced frames (ES, ED)
            for k in range(6):
                rows.append(f"{name[:-4]},{28+2*k},{24+10*k},{100-2*k},{24+10*k},{frame}")
    (root / "FileList.csv").write_text("\n".join(split_rows) + "\n")
    (root / "VolumeTracings.csv").write_text("\n".join(rows))
    return str(root)


@pytest.fixture
def cardiac_root(tmp_path):
    """Site_G/Site_R volumes with filled labels and Site_R_full volumes with
    contour labels (the video test fills them), non-square frames."""
    rng = np.random.RandomState(2)
    root = tmp_path / "cardiac"
    root.mkdir()
    infos = {}

    def add(pid, site):
        img = (rng.rand(48, 52, 12) * 255).astype(np.int16)
        mask = np.zeros((48, 52, 12), np.int16)
        mask[8:28, 8:30, :] = 1
        mask[30:42, 28:44, :] = 2
        if site == "Site_R_full":
            mask[10:26, 10:28, :] = 0  # rings: contour labels
            mask[32:40, 30:42, :] = 0
        ip, mp = str(root / f"{pid}_img.nii.gz"), str(root / f"{pid}_mask.nii.gz")
        write_nifti(ip, img)
        write_nifti(mp, mask)
        infos[pid] = {"dataset_name": site,
                      "views_images": {"1": ip}, "views_labels": {"1": mp}}

    for i in range(12):
        add(f"g{i}", "Site_G")
    for i in range(4):
        add(f"r{i}", "Site_R")
    for i in range(2):
        add(f"rf{i}", "Site_R_full")
    infos_path = str(root / "infos.npy")
    np.save(infos_path, infos, allow_pickle=True)
    return str(root), infos_path


def _check_run(trainer, want):
    assert trainer.state.step > 0
    m = trainer.last_epoch_metrics
    assert want <= set(m), sorted(m)
    for k in want:
        assert np.isfinite(m[k]), k
    assert trainer.ckpt.latest_step() == trainer.state.step
    assert all(np.isfinite(d) for d in trainer.last_dices.values())
    # on the CPU every kernel's plain version runs
    assert knn.LAUNCHES["knn"] == 0 and not any(pm.LAUNCHES.values())


def test_run_camus_echo_all_branches(camus_root, echo_root, tmp_path):
    args = _args(camus_root=camus_root, echonet_root=echo_root,
                 save_dir=str(tmp_path / "ckpt_camus"))
    trainer = real_training.run_camus_echo(args, cfg=_camus_cfg(), device="cpu")
    _check_run(trainer, LOSSES)
    assert set(trainer.last_dices) == {"Inner-Val", "Target Domain - Valid"}


def test_run_cardiac_uda_all_branches(cardiac_root, tmp_path):
    root, infos_path = cardiac_root
    args = _args(root=root, infos=infos_path, view_num="1",
                 save_dir=str(tmp_path / "ckpt_cardiac"), log_dir=str(tmp_path / "log"))
    trainer = real_training.run_cardiac_uda(args, cfg=_cardiac_cfg(), device="cpu")
    _check_run(trainer, LOSSES | {"cyc_loss"})
    m = trainer.last_epoch_metrics
    # graph path active (BG + organ channels -> positive nodes)
    assert m["node_loss"] > 0 and m["cyc_loss"] != 0
    # the checkpoint is tagged with the video test's dice
    tags = trainer.ckpt.metrics()
    assert tags["dice_metric"] == "Target Domain - Video Test"
    assert tags["dice"] == trainer.last_dices["Target Domain - Video Test"]
    assert (tmp_path / "log" / "metrics.jsonl").exists()


def _cardiac_iters(pkg_loader, pkg_cardiac, cfg, root, infos):
    """The cardiac recipe's train iterators as `run_cardiac_uda` wires them,
    built from one package's modules, one loader thread each."""
    DataLoader, cycled, rebatched = pkg_loader.DataLoader, pkg_loader.cycled, pkg_loader.rebatched
    Seg = pkg_cardiac.SegCardiacUDADataset
    d = cfg.data
    dims = dict(spatial_size=d.img_res[0], crop_size=d.img_crop[0], view_num=(d.view_num,),
                seg_parts=d.seg_parts)
    clip = dict(single_frame=False, clip_length=d.clip_length, total_length=d.total_length)
    src = DataLoader(Seg(infos, root, is_train=True, set_select=("Site_G",), **dims),
                     4, num_workers=1)
    tgt = rebatched(cycled(DataLoader(
        Seg(infos, root, is_train=True, set_select=("Site_R",), source_domain=False, **dims),
        2, num_workers=1, drop_last=False)), 2)
    ts = rebatched(cycled(DataLoader(
        Seg(infos, root, is_train=True, set_select=("Site_G",), **clip, **dims),
        4, num_workers=1, drop_last=False)), 4)
    tt = rebatched(cycled(DataLoader(
        Seg(infos, root, is_train=True, set_select=("Site_R",), repeat=2,
            source_domain=False, **clip, **dims), 4, num_workers=1, drop_last=False)), 4)
    cyc = cycled(DataLoader(
        Seg(infos, root, is_train=True, set_select=("Site_G",), single_frame=False,
            clip_length=cfg.cycle.clip_length, total_length=cfg.cycle.clip_length, **dims),
        1, num_workers=1, drop_last=False))
    return dict(source_loader=src, target_iter=tgt, temp_src_iter=ts, temp_tgt_iter=tt,
                cyc_iter=cyc)


def test_batches_equal_the_jax_package_batches(cardiac_root):
    from graphecho_tpu import config as jconfig
    from graphecho_tpu import real_training as jrt
    from graphecho_tpu.data import cardiac_uda as jcardiac
    from graphecho_tpu.data import loader as jloader

    from graphecho_torch.data import cardiac_uda as tcardiac
    from graphecho_torch.data import loader as tloader

    root, infos_path = cardiac_root
    infos = np.load(infos_path, allow_pickle=True).item()
    got, want = [], []
    for pkg_rt, pkg_cfg, pkg_loader, pkg_cardiac, out in (
            (real_training, C, tloader, tcardiac, got),
            (jrt, jconfig, jloader, jcardiac, want)):
        cfg = _cardiac_cfg(pkg_cfg)
        iters = _cardiac_iters(pkg_loader, pkg_cardiac, cfg, root, infos)
        for epoch in range(2):
            out.extend(pkg_rt._batches(cfg=cfg, **iters))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert set(g) == set(w) == {
            "imgs_source", "masks", "imgs_target", "temp_imgs_source", "temp_imgs_target",
            "temp_masks", "update_idx_source", "update_idx_target", "cyc_imgs"}
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    print(f"PARITY real_training._batches: {len(got)} batches x {len(got[0])} keys bit-equal")


def _parser_flags(parser):
    return {s for a in parser._actions for s in a.option_strings} - {"-h", "--help"}


@pytest.mark.parametrize("name", ["train_camus_echo", "train_cardiac_uda"])
def test_cli_accepts_every_flag_of_the_jax_parser(name):
    import importlib

    jax_cli = importlib.import_module(f"graphecho_tpu.{name}")
    port_cli = {"train_camus_echo": train_camus_echo, "train_cardiac_uda": train_cardiac_uda}[name]
    jax_flags = _parser_flags(jax_cli.build_parser())
    assert jax_flags <= _parser_flags(port_cli.build_parser())
    argv = []
    for a in jax_cli.build_parser()._actions:
        if not a.option_strings or a.option_strings[0] == "-h":
            continue
        argv.append(a.option_strings[0])
        if a.nargs != 0:
            argv.append(a.choices[0] if a.choices else "1")
    want = vars(jax_cli.build_parser().parse_args(argv))
    got = vars(port_cli.build_parser().parse_args(argv))
    assert {k: got[k] for k in want} == want
    assert got["device"] is None


DEFERRED = [(["--use-mesh"], "data-parallel"), (["--num-processes", "2"], "data-parallel"),
            (["--coordinator", "localhost:1234"], "data-parallel"),
            (["--pretrained-backbone", "w.pth"], "tooling")]


@pytest.mark.parametrize("cli", [train_camus_echo, train_cardiac_uda],
                         ids=["train_camus_echo", "train_cardiac_uda"])
@pytest.mark.parametrize("flags,slice_", DEFERRED, ids=[d[0][0] for d in DEFERRED])
def test_deferred_flags_raise(cli, flags, slice_, monkeypatch):
    """The flags the port once refused now reach their run: the process-group
    flags `initialize_distributed`, `--use-mesh` and `--pretrained-backbone`
    the entry point (as `use_mesh` and `torch_init`)."""
    from graphecho_torch import entrypoints
    from graphecho_torch.parallel import mesh

    init, run = {}, {}
    monkeypatch.setattr(mesh, "initialize_distributed", lambda **kw: init.update(kw))
    monkeypatch.setattr(entrypoints, cli.__name__.rsplit(".", 1)[-1],
                        lambda **kw: run.update(kw))
    cli.main(flags + ["--device", "cpu"])
    flag = flags[0]
    assert init == {"coordinator": "localhost:1234" if flag == "--coordinator" else None,
                    "num_processes": 2 if flag == "--num-processes" else None,
                    "process_id": None}, slice_
    assert run["use_mesh"] is (flag == "--use-mesh")
    assert run["torch_init"] == ("w.pth" if flag == "--pretrained-backbone" else None)
    assert run["device"] == "cpu"


def test_cli_without_roots_runs_the_synthetic_entry_point(monkeypatch, tmp_path):
    from graphecho_torch import entrypoints

    seen = {}
    monkeypatch.setattr(entrypoints, "train_cardiac_uda", lambda **kw: seen.update(kw))
    train_cardiac_uda.main(["--epochs", "2", "--device", "cpu", "--temporal-graph",
                            "--cyc-loss", "--save-dir", str(tmp_path)])
    assert seen["device"] == "cpu" and seen["checkpoint_dir"] == str(tmp_path)
    assert seen["temporal_graph"] and seen["cyc_loss"] and seen["num_epochs"] == 2


def test_proc_reads_torch_distributed(monkeypatch):
    """`_proc` reads the process group; `_check_multihost` lets several
    processes train only through the mesh, whose `mesh_data` must be the
    whole world."""
    import torch.distributed as dist

    cfg = C.cardiac_uda_config(temporal_graph=True, cyc_loss=True)
    assert real_training._proc() == {"process_index": 0, "process_count": 1}
    real_training._check_multihost(cfg, use_mesh=False)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: 1)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    assert real_training._proc() == {"process_index": 1, "process_count": 2}
    with pytest.raises(ValueError, match="--use-mesh"):
        real_training._check_multihost(cfg, use_mesh=False)
    real_training._check_multihost(cfg, use_mesh=True)
    for n in (1, 4):
        bad = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, mesh_data=n))
        with pytest.raises(ValueError, match="one process per device"):
            real_training._check_multihost(bad, use_mesh=True)