"""The port's tooling modules against the JAX package's, on the CPU:
`utils/tools.py` (rank discovery from the environment), `utils/profiling.py`
(`profile_trace`, `annotate`), `utils/metric_wrappers.py` and
`utils/visualize.py` (equal to the JAX package's numpy helpers), and
`utils/torch_import.py`: upstream-keyed `.pth` files built here from the
port's FPN (no checkpoint can be downloaded) load into the port bit-equal to
what the JAX package's importer loads, carried over by `convert.from_flax`.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from graphecho_tpu.utils import metric_wrappers as jmw
from graphecho_tpu.utils import visualize as jvis
from graphecho_tpu.utils.torch_import import load_reference_checkpoint as jax_load

from test_torch_quant import BACKBONES, flax_fpn_variables, port_fpn

from graphecho_torch import config as C
from graphecho_torch.convert import from_flax
from graphecho_torch.models.fpn import FPN
from graphecho_torch.train.trainer import Trainer
from graphecho_torch.utils import metric_wrappers as tmw
from graphecho_torch.utils import tools
from graphecho_torch.utils import visualize as tvis
from graphecho_torch.utils.profiling import annotate, profile_trace
from graphecho_torch.utils.torch_import import fpn_state_from_torch, load_reference_checkpoint


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and torch's default of a thread per core oversubscribes the machine
    (tens of times slower under load)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------- tools
ENV = ("PMI_SIZE", "PMI_RANK", "OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_RANK",
       "OMPI_COMM_WORLD_LOCAL_RANK", "MPI_LOCALRANKID", "WORLD_SIZE", "RANK", "LOCAL_RANK",
       "MASTER_ADDR", "MASTER_PORT", "AZ_BATCH_MASTER_NODE", "AZ_BATCHAI_MPI_MASTER_NODE")


@pytest.mark.parametrize("env,want", [
    ({}, (1, 0, 0, "127.0.0.1", 29500)),
    ({"WORLD_SIZE": "4", "RANK": "2", "LOCAL_RANK": "0", "MASTER_ADDR": "10.0.0.9",
      "MASTER_PORT": "1234"}, (4, 2, 0, "10.0.0.9", 1234)),
    ({"WORLD_SIZE": "4", "RANK": "3"}, (4, 3, 3, "127.0.0.1", 29500)),
    ({"OMPI_COMM_WORLD_SIZE": "8", "OMPI_COMM_WORLD_RANK": "5",
      "OMPI_COMM_WORLD_LOCAL_RANK": "1", "WORLD_SIZE": "2", "RANK": "0"},
     (8, 5, 1, "127.0.0.1", 29500)),
    ({"PMI_SIZE": "16", "PMI_RANK": "9", "MPI_LOCALRANKID": "1", "OMPI_COMM_WORLD_SIZE": "8",
      "AZ_BATCH_MASTER_NODE": "10.1.2.3:6000", "MASTER_ADDR": "x"},
     (16, 9, 1, "10.1.2.3", 6000)),
    ({"AZ_BATCHAI_MPI_MASTER_NODE": "node7", "MASTER_ADDR": "x"}, (1, 0, 0, "node7", 29500)),
], ids=["none", "torchrun", "no_local_rank", "ompi", "pmi_azure", "azure_batchai"])
def test_tools_reads_the_launchers_environment(env, want, monkeypatch):
    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got = (tools.get_world_size(), tools.get_global_rank(), tools.get_local_rank(),
           tools.get_master_ip(), tools.get_master_port())
    assert got == want


# ------------------------------------------------------------------ profiling
def test_profile_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    x = torch.randn(64, 64)
    with profile_trace(str(tmp_path / "trace")) as prof:
        with annotate("step.matmul"):
            (x @ x).sum()
    with open(tmp_path / "trace" / "trace.json") as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "step.matmul" in names
    assert any(e.key == "step.matmul" for e in prof.key_averages())


# ------------------------------------------------------ metrics and drawing
def test_metric_wrappers_equal_the_jax_packages():
    rng = np.random.RandomState(0)
    y, p = rng.randn(50), rng.randn(50)
    for name in ("mse", "mae", "rmse", "r2_score"):
        assert getattr(tmw, name)(y, p) == getattr(jmw, name)(y, p), name
    assert tmw.r2_score(np.ones(3), np.ones(3)) == jmw.r2_score(np.ones(3), np.ones(3)) == 0.0
    logits, onehot = rng.randn(2, 8, 8, 3), np.eye(3)[rng.randint(0, 3, (2, 8, 8))]
    for bg in (True, False):
        assert (tmw.dice_score_onehot(logits, onehot, bg)
                == jmw.dice_score_onehot(logits, onehot, bg))


def test_render_node_sampling_equals_the_jax_packages(tmp_path):
    masks = np.zeros((32, 40, 3), np.uint8)
    masks[4:20, 6:30, 0] = 1
    masks[10:12, 2:5, 2] = 1  # channel 1 empty: its full-image box is not drawn
    image = (np.random.RandomState(1).rand(32, 40) * 255).astype(np.uint8)
    for backdrop in (None, image):
        got = tvis.render_node_sampling(masks, backdrop)
        np.testing.assert_array_equal(got, jvis.render_node_sampling(masks, backdrop))
    boxes = np.array([[1, 2, 30, 20], [5, 5, 5, 5], [-3, -3, 100, 100]], np.float32)
    np.testing.assert_array_equal(tvis.draw_boxes(image, boxes, width=2),
                                  jvis.draw_boxes(image, boxes, width=2))
    np.testing.assert_array_equal(tvis.draw_boxes(image, boxes, colors=(1, 2, 3)),
                                  jvis.draw_boxes(image, boxes, colors=(1, 2, 3)))
    with pytest.raises(ValueError):
        tvis.draw_boxes(image.astype(np.float32), boxes)


# --------------------------------------------------------------- torch import
@dataclasses.dataclass
class _JaxState:
    """The two fields of the JAX TrainState its importer reads and replaces."""

    net_params: dict
    net_batch_stats: dict

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def _jax_loaded(variables, path):
    state, skipped = jax_load(_JaxState(variables["params"], variables["batch_stats"]), path)
    return from_flax({"net_params": state.net_params,
                      "net_batch_stats": state.net_batch_stats})["fpn"], skipped


def _upstream_checkpoint(kw, seed):
    """A GraphEcho `net_{epoch}.pth` as upstream saves it: a port FPN's
    weights under `network`, with DDP's `module.` prefix and BatchNorm's
    `num_batches_tracked`."""
    model = FPN(**kw)
    gen = torch.Generator().manual_seed(seed)
    sd = {k: torch.randn(v.shape, generator=gen) for k, v in model.state_dict().items()}
    sd = {f"module.{k}": v for k, v in sd.items()}
    sd.update({f"{k[:-len('running_mean')]}num_batches_tracked": torch.tensor(7)
               for k in list(sd) if k.endswith("running_mean")})
    return {"network": sd}, {k.removeprefix("module."): v for k, v in sd.items()
                             if "num_batches" not in k}


@pytest.mark.parametrize("backbone", ["vgg", "resnet"])
def test_a_graphecho_checkpoint_loads_as_the_jax_importer_loads_it(backbone, tmp_path):
    kw, hw = BACKBONES[backbone]
    _, variables = flax_fpn_variables(kw, hw, seed=2)
    ckpt, plain = _upstream_checkpoint(kw, seed=3)
    path = str(tmp_path / "net_10.pth")
    torch.save(ckpt, path)
    model = port_fpn(kw, variables)
    skipped = load_reference_checkpoint(model, path)
    want, jax_skipped = _jax_loaded(variables, path)
    assert skipped == jax_skipped == []
    got = model.state_dict()
    assert got.keys() == want.keys() == plain.keys()
    for k in got:
        assert torch.equal(got[k], want[k]) and torch.equal(got[k], plain[k]), k


def test_a_torchvision_resnet_initialises_the_backbone_only(tmp_path):
    """The zoo's RGB ResNet50 ([3, 4, 6, 3], an `fc` head): the RGB stem is
    summed to grey, the blocks and the head the reference's [3, 4, 5, 3] FPN
    lacks are skipped, the pyramid keeps its weights; as in the JAX
    package."""
    kw, hw = BACKBONES["resnet"]
    _, variables = flax_fpn_variables(kw, hw, seed=4)
    before = port_fpn(kw, variables).state_dict()
    gen = torch.Generator().manual_seed(5)
    zoo = {k.removeprefix("back_bone."): torch.randn(v.shape, generator=gen)
           for k, v in before.items() if k.startswith("back_bone.")}
    zoo["conv1.weight"] = torch.randn(64, 3, 7, 7, generator=gen)
    zoo.update({"layer3.5.conv1.weight": torch.randn(256, 1024, 1, 1, generator=gen),
                "fc.weight": torch.randn(1000, 2048, generator=gen),
                "fc.bias": torch.randn(1000, generator=gen),
                "bn1.num_batches_tracked": torch.tensor(3)})
    path = str(tmp_path / "resnet50.pth")
    torch.save(zoo, path)
    model = port_fpn(kw, variables)
    skipped = load_reference_checkpoint(model, path)
    want, jax_skipped = _jax_loaded(variables, path)
    assert sorted(skipped) == sorted(jax_skipped) == ["fc.bias", "fc.weight",
                                                      "layer3.5.conv1.weight"]
    got = model.state_dict()
    for k in got:
        assert torch.equal(got[k], want[k]), k
    assert torch.equal(got["back_bone.conv1.weight"], zoo["conv1.weight"].sum(1, keepdim=True))
    assert torch.equal(got["toplayer.weight"], before["toplayer.weight"])
    assert torch.equal(got["back_bone.layer4.2.bn3.running_var"],
                       zoo["layer4.2.bn3.running_var"])


def test_trainer_torch_init_loads_the_fpn(tmp_path):
    cfg = C.cardiac_uda_config()
    kw, _ = BACKBONES["vgg"]
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, num_classes=kw["num_classes"],
                                       fpn_channels=32, semantic_channels=16,
                                       vgg_spec=kw["vgg_spec"]),
        train=dataclasses.replace(cfg.train, graph_matching=False, discriminator=False))
    ckpt, plain = _upstream_checkpoint(kw, seed=6)
    path = str(tmp_path / "net.pth")
    torch.save(ckpt, path)
    state = Trainer(cfg, device="cpu").init_state(torch_init=path)
    got = state.net.module.state_dict()
    assert all(torch.equal(got[k], plain[k]) for k in plain)
    sd, skipped = fpn_state_from_torch(ckpt["network"], state.net.module)
    assert skipped == [] and all(torch.equal(sd[k], plain[k]) for k in plain)
    assert os.path.exists(path)
