"""Full-state checkpoints, port of `graphecho_tpu/train/checkpoint.py`.

The reference saves only the FPN weights, rank-0, via `torch.save` + an
`os.system('echo ...')` latest-pointer (`train_camus_echo.py:447-488`);
optimizer state, discriminators, GModule, TGCN and the seed banks are lost on
restart. Here the WHOLE `TrainState` round-trips: every component's module
`state_dict` (parameters and BatchNorm buffers) and optimizer `state_dict`,
the seed banks, the TGCN queues, the step and epoch counters and the state
of the generator the step draws its noise from. The LR schedules read the
update count from `state.step`, so they continue where the run stopped.

One file per step, `<directory>/<step>.pt`, written as orbax commits a step:
under a temporary name, flushed to disk, then renamed with `os.replace`, so a
kill during a save leaves the previous checkpoint whole and the new one
absent. The metrics a save is tagged with sit beside it in `<step>.json`,
written the same way before the state. At most `max_to_keep` steps stay.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, List, Optional

import torch

from graphecho_torch.train.state import TrainState

COMPONENTS = ("net", "gmn", "dis", "tgcn")
TENSORS = ("sr_seed", "tg_seed", "queue_source", "queue_target")
_STEP_FILE = re.compile(r"^(\d+)\.pt$")


def _atomic_write(path: str, write) -> None:
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def state_dict(state: TrainState) -> Dict[str, Any]:
    """Everything a step reads and writes, as one dict `torch.save` takes."""
    comps = {name: getattr(state, name) for name in COMPONENTS
             if getattr(state, name) is not None}
    return {
        "step": int(state.step),
        "epoch": int(state.epoch),
        "modules": {name: c.module.state_dict() for name, c in comps.items()},
        "optimizers": {name: c.opt.state_dict() for name, c in comps.items()},
        "tensors": {name: getattr(state, name) for name in TENSORS
                    if getattr(state, name) is not None},
        "generator": state.generator.get_state(),
    }


def load_state_dict(state: TrainState, saved: Dict[str, Any]) -> TrainState:
    """Load `saved` (from `state_dict`) into `state` in place; the components
    present must match."""
    comps = {name for name in COMPONENTS if getattr(state, name) is not None}
    if comps != set(saved["modules"]):
        raise ValueError(f"checkpoint holds components {sorted(saved['modules'])}, "
                         f"the state has {sorted(comps)}")
    for name in comps:
        comp = getattr(state, name)
        comp.module.load_state_dict(saved["modules"][name])
        comp.opt.load_state_dict(saved["optimizers"][name])
    for name, t in saved["tensors"].items():
        setattr(state, name, t.to(state.device))
    # the generator's state is a CPU byte tensor for a CUDA generator too
    state.generator.set_state(saved["generator"])
    state.step, state.epoch = int(saved["step"]), int(saved["epoch"])
    return state


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int, ext: str = "pt") -> str:
        return os.path.join(self.directory, f"{step}.{ext}")

    def all_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(_STEP_FILE.match, os.listdir(self.directory))
                      if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: TrainState, metrics: Optional[dict] = None) -> None:
        if metrics is not None:
            _atomic_write(self._path(step, "json"),
                          lambda f: f.write(json.dumps(metrics).encode()))
        saved = state_dict(state)
        _atomic_write(self._path(step), lambda f: torch.save(saved, f))
        for old in self.all_steps()[:-self.max_to_keep]:
            for ext in ("pt", "json"):
                if os.path.exists(self._path(old, ext)):
                    os.remove(self._path(old, ext))

    def metrics(self, step: Optional[int] = None) -> Optional[dict]:
        """The metrics step `step` (default: the latest) was saved with."""
        step = self.latest_step() if step is None else step
        if step is None or not os.path.exists(self._path(step, "json")):
            return None
        with open(self._path(step, "json")) as f:
            return json.load(f)

    def restore(self, state_like: TrainState, step: Optional[int] = None
                ) -> Optional[TrainState]:
        """Load step `step` (default: the latest) into `state_like`, an
        initialised state, onto its own device; returns it, or None when
        there is no checkpoint."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        device = state_like.device
        # tensors saved on a device come back on the state's device; those
        # saved on the CPU stay there, as torch.optim keeps Adam's step
        # counters and torch.Generator its state
        saved = torch.load(self._path(step), weights_only=True,
                           map_location=lambda storage, loc: (
                               storage if loc == "cpu" else storage.to(device=device)))
        return load_state_dict(state_like, saved)

    def close(self) -> None:
        """Nothing stays open between saves; kept for the JAX interface."""
