"""Summarize `train_rehearsal` curves and check that an interrupted and
resumed run continues the uninterrupted one; the counterpart of
`scripts/rehearsal_report.py`.

    python -m graphecho_torch.rehearsal_report runs/camus.jsonl \\
        [--resume runs/camus_preempted.jsonl] [--every 2]

Prints a markdown table (step / seg_loss / eval dice) and a summary line.
With `--resume`, every row of the resumed curve must have a row at the same
step in the uninterrupted one and equal it to every printed digit. One row
may differ in its losses alone: the epoch the stop split, whose train-loss
means average only the steps after the resume (its dice, computed from the
state, must still be equal). Any other difference, a second such row, a
resumed row at a step the uninterrupted curve lacks, or no overlap at all
exits non-zero.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List, Tuple


def load(path: str) -> List[Dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def table(rows: List[Dict], every: int = 2) -> str:
    """The markdown rows of every `every`-th epoch and the last."""
    shown = rows[::every]
    if shown[-1] is not rows[-1]:
        shown.append(rows[-1])
    return "\n".join([
        "| step | " + " | ".join(str(r["step"]) for r in shown) + " |",
        "|---" * (len(shown) + 1) + "|",
        "| seg_loss | " + " | ".join(f"{r['seg_loss']:.4f}" for r in shown) + " |",
        "| eval dice | " + " | ".join(f"{r['dice']:.4f}" for r in shown) + " |"])


def overlay(rows: List[Dict], resumed: List[Dict]) -> Tuple[int, int, List[str]]:
    """(rows equal, rows equal in dice alone, the faults) of the resumed
    curve against the uninterrupted one."""
    by_step = {r["step"]: r for r in rows}
    exact, dice_only, faults = 0, 0, []
    for r in resumed:
        a = by_step.get(r["step"])
        if a is None:
            faults.append(f"step {r['step']}: not in the uninterrupted curve")
        elif all(a[k] == r[k] for k in ("total_loss", "seg_loss", "dice")):
            exact += 1
        elif a["dice"] == r["dice"]:
            dice_only += 1
        else:
            faults.append(f"step {r['step']}: uninterrupted {a} vs resumed {r}")
    if dice_only > 1:
        faults.append(f"{dice_only} rows equal in dice alone; only the split epoch may be")
    if not exact:
        faults.append("no row of the resumed curve equals the uninterrupted one")
    return exact, dice_only, faults


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("curve")
    ap.add_argument("--resume", default=None, help="the interrupted and resumed curve")
    ap.add_argument("--every", type=int, default=2, help="print every Nth epoch row")
    args = ap.parse_args(argv)

    rows = load(args.curve)
    if not rows:
        raise SystemExit(f"no epoch rows in {args.curve}: the rehearsal died before its "
                         "first epoch")
    print(table(rows, args.every))
    mean_s = sum(r["step_seconds"] for r in rows) / len(rows)
    print(f"\n{len(rows)} epochs, final dice {rows[-1]['dice']:.6f}, mean wall "
          f"step_seconds {mean_s:.4f} (host clock, synthetic data made in the step)")
    if args.resume:
        exact, dice_only, faults = overlay(rows, load(args.resume))
        print(f"\noverlap with {args.resume}: {exact} rows equal, {dice_only} equal in dice "
              f"alone (the split epoch's loss means), {len(faults)} faults")
        for fault in faults:
            print(f"  {fault}")
        if faults:
            return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
