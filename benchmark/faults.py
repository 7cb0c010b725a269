"""Faults planted underneath the timed path, to show that `correct` comes
out false on them: the benchmark's tests use them on the CPU, and
`python -m benchmark.readings --fault <name>` reads them on the card at a
cell's own size. Each is a context manager that patches the system under
test and restores it on exit. By loop:

  * train: `unchanged` (the optimizers' step does nothing: the state comes
    back as it went in), `half_batch` (every batch entry's first half of
    rows goes through the step, so its loss is the mean over those alone;
    the cycle clip is one item and stays whole).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator


def _half(batch):
    return {k: v if k == "cyc_imgs" else v[:max(len(v) // 2, 1)] for k, v in batch.items()}


@contextlib.contextmanager
def _patched(owner, name: str, value) -> Iterator[None]:
    old = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, old)


def unchanged():
    from graphecho_torch.train import state

    return _patched(state.Component, "apply_gradients", lambda self, count: None)


def train_half_batch():
    from graphecho_torch.train import trainer

    make = trainer.make_train_step

    def halved(cfg, mesh=None):
        step = make(cfg, mesh)
        return lambda state, batch: step(state, _half(batch))

    return _patched(trainer, "make_train_step", halved)


FAULTS: Dict[str, Dict[str, object]] = {
    "train": {"unchanged": unchanged, "half_batch": train_half_batch},
}
