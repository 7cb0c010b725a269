"""A look at where the program's first train steps and the plain reference's
part ways: the discrete choices each side makes, and what is left of the
gaps once the reference is made to choose as the program did.

The choices are the TGCN's kNN indices (each row's neighbour set), the
GModule's matching argmax (each row's same-class partner), the node
sampler's boxes (from thresholded predictions) and the seed update's
spectral split (which of a class's nodes fall on the seed's side).
`Look.install()` wraps the functions that make them on both sides and
records every call of the three checked steps; `report()` gives, step by step, the share of rows in which
the reference chose otherwise than the program. Under `replaying()` the
reference's calls return the program's choice of the same call instead of
their own, so a second reference run follows the program's choices and
nothing else of the program's.

This is a diagnostic, run by `python -m benchmark.readings --look`; the
benchmark's own runs never install it, and the comparison that decides
`correct` never takes the program's choices.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch

SIDES = ("program", "reference")
KINDS = ("knn", "argmax", "boxes", "split")


def _rows(kind: str, t: torch.Tensor) -> torch.Tensor:
    """The tensor as rows that are one choice each: a kNN row's neighbour
    set (sorted, so order within the set is no choice), an argmax entry, a
    box, a class's split as each node's side against the seed's (so the
    labels' order is no choice)."""
    if kind == "knn":
        return torch.sort(t.long(), dim=-1).values.reshape(-1, t.shape[-1])
    if kind == "split":
        t = t.reshape(-1, t.shape[-1])
        return t == t[:, :1]
    if kind == "boxes":
        return t.reshape(-1, t.shape[-1])
    return t.reshape(-1, 1)


class Look:
    def __init__(self, steps: int = 3):
        self.steps = steps
        self.step = {side: 0 for side in SIDES}
        # side -> kind -> [(step, tensor, counts)], in call order
        self.calls: Dict[str, Dict[str, List[Tuple[int, torch.Tensor, bool]]]] = {
            side: defaultdict(list) for side in SIDES}
        self.replay = False
        self.swapped: Dict[str, int] = defaultdict(int)
        self._replayed: Dict[str, int] = defaultdict(int)

    def end_step(self, side: str) -> None:
        self.step[side] += 1

    def _seen(self, side: str, kind: str, out: torch.Tensor, counts: bool = True) -> torch.Tensor:
        """Record one call's choice; on the reference under replay, return
        the program's choice of the same call."""
        if self.step[side] >= self.steps:
            return out
        if side == "reference" and self.replay:
            i = self._replayed[kind]
            self._replayed[kind] += 1
            theirs = self.calls["program"][kind][i][1].to(out.device, out.dtype)
            if not torch.equal(_rows(kind, theirs), _rows(kind, out)):
                self.swapped[kind] += 1
            return theirs.reshape(out.shape)
        self.calls[side][kind].append((self.step[side], out.detach().clone(), counts))
        return out

    def report(self) -> List[Dict[str, Any]]:
        """Step by step and kind by kind: rows compared, rows in which the
        reference chose otherwise, and their share."""
        out = []
        for step in range(self.steps):
            row: Dict[str, Any] = {"step": step + 1}
            for kind in KINDS:
                mine = [c for c in self.calls["program"][kind] if c[0] == step]
                ref = [c for c in self.calls["reference"][kind] if c[0] == step]
                if not mine and not ref:
                    continue
                if len(mine) != len(ref):
                    row[kind] = {"calls": [len(mine), len(ref)]}
                    continue
                n = differ = 0
                for (_, a, counts), (_, b, _) in zip(mine, ref):
                    if not counts:
                        continue
                    ra, rb = _rows(kind, a), _rows(kind, b.to(a.device))
                    n += ra.shape[0]
                    differ += int((ra != rb).any(dim=-1).sum())
                row[kind] = {"rows": n, "differ": differ, "share": differ / max(n, 1)}
            out.append(row)
        return out

    @contextlib.contextmanager
    def replaying(self) -> Iterator[None]:
        self.replay = True
        self.step["reference"] = 0
        self._replayed.clear()
        self.swapped.clear()
        try:
            yield
        finally:
            self.replay = False

    @contextlib.contextmanager
    def install(self) -> Iterator["Look"]:
        """Wrap the choosing functions of both sides for as long as the
        context lasts."""
        from graphecho_torch.models import graph_matching as program_gm, tgcn as program_tgcn
        from graphecho_torch.ops import spectral as program_spectral
        from graphecho_torch.train import steps as program_steps

        from benchmark.reference.uda import graph_matching as ref_gm, spectral as ref_spectral
        from benchmark.reference.uda import step as ref_step, tgcn as ref_tgcn

        def knn(side: str, fn: Callable) -> Callable:
            def wrapped(x, y=None, *args, **kwargs):
                # against an all-zero hidden state every key ties: no choice
                counts = y is not None and bool(y.detach().abs().amax() > 0)
                return self._seen(side, "knn", fn(x, y, *args, **kwargs), counts)
            return wrapped

        def plain(side: str, kind: str, fn: Callable) -> Callable:
            def wrapped(*args, **kwargs):
                return self._seen(side, kind, fn(*args, **kwargs))
            return wrapped

        def split(side: str, fn: Callable) -> Callable:
            def wrapped(*args, **kwargs):
                out = fn(*args, **kwargs)
                if isinstance(out, tuple):  # (assign, solve_ok)
                    return (self._seen(side, "split", out[0]),) + out[1:]
                return self._seen(side, "split", out)
            return wrapped

        def matching(side: str, method: Callable) -> Callable:
            def wrapped(module, *args, **kwargs):
                real = torch.argmax
                torch.argmax = plain(side, "argmax", real)
                try:
                    return method(module, *args, **kwargs)
                finally:
                    torch.argmax = real
            return wrapped

        patches: List[Tuple[Any, str, Optional[Any]]] = [
            (program_tgcn, "dilated_knn_graph", knn("program", program_tgcn.dilated_knn_graph)),
            (ref_tgcn, "knn_graph", knn("reference", ref_tgcn.knn_graph)),
            (program_steps, "masks_to_boxes",
             plain("program", "boxes", program_steps.masks_to_boxes)),
            (ref_step, "masks_to_boxes", plain("reference", "boxes", ref_step.masks_to_boxes)),
            (program_spectral, "spectral_bipartition",
             split("program", program_spectral.spectral_bipartition)),
            (ref_spectral, "spectral_bipartition",
             split("reference", ref_spectral.spectral_bipartition)),
            (program_gm.GModule, "_matching_losses",
             matching("program", program_gm.GModule._matching_losses)),
            (ref_gm.GModule, "_matching_losses",
             matching("reference", ref_gm.GModule._matching_losses)),
        ]
        old = [(owner, name, getattr(owner, name)) for owner, name, _ in patches]
        for owner, name, value in patches:
            setattr(owner, name, value)
        try:
            yield self
        finally:
            for owner, name, value in old:
                setattr(owner, name, value)
