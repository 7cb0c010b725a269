"""`tests/test_convergence.py` on the port: a short synthetic training run
learns. The JAX test's tiny config (`test_train_step.tiny_config`, graph
matching and discriminators off, batch 8), rebuilt field by field from the
port's config classes; a pool of 4 batches revisited for 40 steps. The seg
loss must fall below half its first value and the eval dice on held-out
synthetic frames must exceed 0.5, the JAX test's bars.

Synthetic frames paint bright ellipses where the masks are
(`data/synthetic.py`), so a working step and optimizer drive the dice up
from random weights within a few dozen steps."""

import dataclasses

import numpy as np
import pytest
import torch

from test_train_step import tiny_config

from graphecho_torch import config as tconfig
from graphecho_torch.data.synthetic import SyntheticEchoData
from graphecho_torch.train.metrics import overlap_metrics_from_counts
from graphecho_torch.train.state import create_train_state
from graphecho_torch.train.steps import build_models, make_eval_step, make_train_step


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and torch's default of a thread per core oversubscribes the machine
    (tens of times slower under load)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def port_config(obj):
    """The port's config with every field of the JAX package's `obj`."""
    if dataclasses.is_dataclass(obj):
        cls = getattr(tconfig, type(obj).__name__)
        return cls(**{f.name: port_config(getattr(obj, f.name))
                      for f in dataclasses.fields(obj) if f.init})
    return obj


def test_seg_loss_halves_and_dice_rises():
    jcfg = tiny_config(graph_matching=False, discriminator=False)
    jcfg = dataclasses.replace(jcfg, data=dataclasses.replace(jcfg.data, batch_size=8))
    cfg = port_config(jcfg)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    state = create_train_state(cfg, build_models(cfg), torch.device("cpu"))
    step = make_train_step(cfg)
    data = SyntheticEchoData(cfg, seed=0)

    # a small fixed pool of batches (epoch-style revisits, like real training)
    pool = [data.train_batch() for _ in range(4)]
    losses = [step(state, pool[i % len(pool)])["seg_loss"].item() for i in range(40)]
    assert np.all(np.isfinite(losses))
    assert losses[-1] < 0.5 * losses[0], (losses[0], losses[-1])

    # eval dice on held-out synthetic frames
    evaluate = make_eval_step(cfg)
    totals = {}
    for imgs, masks in data.eval_batches(8):
        counts, _, _ = evaluate(state, torch.as_tensor(imgs), torch.as_tensor(masks))
        for k, v in counts.items():
            totals[k] = totals.get(k, 0.0) + v
    dice = float(overlap_metrics_from_counts(totals).dice)
    print(f"PARITY convergence: seg_loss {losses[0]:.4f} -> {losses[-1]:.4f}, eval dice {dice:.4f}")
    assert dice > 0.5, dice
