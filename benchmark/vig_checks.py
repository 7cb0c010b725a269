"""The Pyramid ViG cell's own checks, beside `faults.py`: two faults
planted in the program's Graphers, which `correct` has to catch, and what
the reference did with the program's Grapher graphs.

  * `vig_no_bias`: every Grapher builds its graph without the
    relative-position bias;
  * `vig_dilation_1`: every Grapher keeps its k nearest keys, whatever its
    dilation.

`python -m benchmark.vig_checks` takes `benchmark.readings`' arguments and
runs it with these faults added to the train loop's; each seed's line
carries, among its notes, `vig_graphs`: step by step, the Grapher rows in
which the reference took the program's other choice within the tie, those
it did not follow, and the largest gap (`benchmark/vig_graphs.py`):

    python -m benchmark.vig_checks --workload cardiac_pvig_s.full-f32 --seeds 1,2
    python -m benchmark.vig_checks --workload cardiac_pvig_s.full-f32 --seeds 1,2 --fault vig_no_bias
"""

from __future__ import annotations

from benchmark import faults, readings, run
from benchmark.loops.train import CHECKED_STEPS
from benchmark.vig_graphs import GRAPHS


def no_bias():
    from graphecho_torch.models import vig

    return faults._patched(vig, "relative_pos_buffer", lambda *args, **kwargs: None)


def dilation_1():
    from graphecho_torch.models import vig

    graph = vig.dilated_knn_graph

    def undilated(x, y=None, k=9, dilation=1, *args, **kwargs):
        return graph(x, y, k, 1, *args, **kwargs)

    return faults._patched(vig, "dilated_knn_graph", undilated)


FAULTS = {"vig_no_bias": no_bias, "vig_dilation_1": dilation_1}


def run_cell(bench, cell):
    """`run.run_cell`, with what the reference did with the program's
    Grapher graphs (`vig_graphs.GRAPHS.report`) among the cell's notes."""
    result = _run_cell(bench, cell)
    cell.notes.append({"vig_graphs": GRAPHS.report(CHECKED_STEPS)})
    return result


_run_cell = run.run_cell


def main(argv=None) -> int:
    with faults._patched(faults, "FAULTS", {loop: dict(f, **FAULTS) if loop == "train" else f
                                            for loop, f in faults.FAULTS.items()}), \
            faults._patched(run, "run_cell", run_cell):
        return readings.main(argv)


if __name__ == "__main__":
    raise SystemExit(main())
