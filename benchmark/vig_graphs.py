"""The program's Grapher graphs, which the plain Pyramid ViG follows where
they are a kNN graph of its own distances up to near ties.

A Grapher's graph is a discrete choice: each node's k·d nearest keys, every
d-th kept. Where two keys' distances lie within rounding of each other, the
program's kernel and the reference may rank them otherwise; one node's other
neighbour moves its features, the batch statistics of every BatchNorm after
it and so the distances of the next Grapher. Over 12 Graphers and four
backbone calls a step the two sides' graphs part in about a tenth of the
rows by the first step's end, and every reading of the comparison spreads
as widely on a sound float32 run as on a broken one (PERF.md §2).

So the reference takes the program's choice wherever it is one that the
reference could have made itself: in each row, each chosen key's distance,
by the reference's own distances from its own features, lies within `TIE`
of the distance at that key's rank (0, d, 2d, ...) in the reference's sorted
row, and no key is chosen twice. Elsewhere, and wherever the calls do not
line up (another count or shape), it keeps its own choice. A graph built
without the relative-position bias, at another dilation or from features
that a lower precision moved is not within `TIE`, is not followed, and the
two sides part as they do without following.

`GRAPHS.arm(n)` wraps the program's `graphecho_torch.models.vig.dilated_knn_graph`
(where the program has imported it; this module imports nothing of the
program) and keeps a host copy of the graphs of its next `n` calls: the
checked steps' calls. `GRAPHS.follow()` hands the last such record to the
reference, call by call, through `GRAPHS.choose`; `report()` gives what
happened to each step's rows.
"""

from __future__ import annotations

import sys
from typing import Any, Dict, List, Optional

import torch

TIE = 1e-2  # of a distance: an L2-normalised squared distance (0 to 4) plus the bias
OVER = (1e-4, 1e-3, 1e-2, 1e-1)  # the gaps `report` counts rows above
PROGRAM = "graphecho_torch.models.vig"
NAME = "dilated_knn_graph"


class Graphs:
    def __init__(self):
        self.recording: Optional[List[torch.Tensor]] = None
        self.limit = 0
        self.recorded: List[torch.Tensor] = []
        self.cursor = 0
        self.calls: List[Dict[str, Any]] = []  # what `choose` did, call by call

    def arm(self, n: int) -> None:
        """Record the program's next `n` Grapher graphs."""
        self.recording, self.limit = [], n
        vig = sys.modules.get(PROGRAM)
        fn = getattr(vig, NAME, None)
        if fn is None or getattr(fn, "_graphs", None) is self:
            return

        def recorded(*args, **kwargs):
            out = fn(*args, **kwargs)
            if self.recording is not None and len(self.recording) < self.limit:
                host = torch.empty(out.shape, dtype=out.dtype, pin_memory=out.is_cuda)
                self.recording.append(host.copy_(out, non_blocking=True))
            return out

        recorded._graphs = self
        setattr(vig, NAME, recorded)

    def follow(self) -> None:
        """Start a reference run on the last record (the one being made, if
        it has any call)."""
        if self.recording:
            self.recorded, self.recording = self.recording, None
        if self.recorded and self.recorded[0].is_pinned():
            torch.cuda.synchronize()  # the copies were queued behind the program's steps
        self.cursor = 0
        self.calls = []

    def choose(self, dist: torch.Tensor, k: int, dilation: int) -> torch.Tensor:
        """(B, N, k) int32: every `dilation`-th of the k·dilation nearest
        keys by `dist` (B, N, M), ascending, ties to the lowest column;
        in each row the program's choice of this call instead where it is
        within `TIE` of that."""
        kd = k * dilation
        values, order = torch.sort(dist, dim=-1, stable=True)
        own = order[..., :kd:dilation]
        if dist.is_meta:
            return own.to(torch.int32)
        theirs = self.recorded[self.cursor] if self.cursor < len(self.recorded) else None
        self.cursor += 1
        note: Dict[str, Any] = {"rows": own.shape[0] * own.shape[1]}
        self.calls.append(note)
        if theirs is None or theirs.shape != own.shape:
            note.update(missing=True, rejected=note["rows"], gap=float("inf"))
            return own.to(torch.int32)
        theirs = theirs.to(dist.device, torch.int64)
        inside = ((theirs >= 0) & (theirs < dist.shape[-1])).all(dim=-1)
        picked = dist.gather(-1, theirs.clamp(0, dist.shape[-1] - 1))
        gap = (picked - values[..., :kd:dilation]).abs().amax(dim=-1)
        distinct = (theirs.sort(dim=-1).values.diff(dim=-1) != 0).all(dim=-1)
        ok = inside & distinct & (gap <= TIE)  # a NaN gap is not within
        gap = torch.where(inside & distinct, gap, torch.full_like(gap, float("inf")))
        gap = gap.nan_to_num(float("inf"))
        note.update(missing=False, rejected=int((~ok).sum()),
                    followed=int((ok & (theirs != own).any(dim=-1)).sum()),
                    gap=float(gap.max()), over=[int((gap > g).sum()) for g in OVER])
        return torch.where(ok[..., None], theirs, own).to(torch.int32)

    def report(self, steps: int) -> List[Dict[str, Any]]:
        """Step by step over the last reference run (its calls split evenly
        into `steps`): rows, rows where the reference took the program's
        other choice within `TIE` (`followed`), rows it did not follow
        (`rejected`), calls with no record to follow (`missing`), the
        largest gap of a row to its own choice, and the rows whose gap is
        above each of `OVER` (a missing call's rows count above all)."""
        per = max(len(self.calls) // max(steps, 1), 1)
        out = []
        for s in range(0, len(self.calls), per):
            part = self.calls[s:s + per]
            out.append({"step": s // per + 1, "calls": len(part),
                        "rows": sum(c["rows"] for c in part),
                        "followed": sum(c.get("followed", 0) for c in part),
                        "rejected": sum(c["rejected"] for c in part),
                        "missing": sum(c["missing"] for c in part),
                        "gap_max": max(c["gap"] for c in part),
                        "over": [sum(c.get("over", [c["rows"]] * len(OVER))[i] for c in part)
                                 for i in range(len(OVER))]})
        return out


GRAPHS = Graphs()
