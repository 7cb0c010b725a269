"""The plain reference against the system under test on the CPU at tiny
widths, and what the harness's processes import."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import experiment, weights
from benchmark.tests.tiny import TINY, tiny_cell

REPO = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "graphecho_tpu"}


@pytest.mark.parametrize("config_name, workload", [("cardiac", "cardiac.full-f32"),
                                                   ("camus", "camus.paper-f32")])
def test_fpn_forward_matches_the_system(config_name, workload):
    from graphecho_torch import config as program_config
    from graphecho_torch.train.steps import build_fpn

    conf = experiment.load_json("configs", config_name)
    traffic = experiment.load_json("traffic", workload.split(".", 1)[1])
    ref_mod = experiment.reference(config_name)
    ours = build_fpn(experiment.build(program_config, conf, traffic, TINY[workload]))
    ref = ref_mod.TrainReference.build_fpn(experiment.build(ref_mod.config, conf, traffic, TINY[workload]))
    for m in (ours, ref):
        m.load_state_dict(weights.make({"fpn": m}, 5, torch.device("cpu"))["fpn"])
    x = torch.rand(2, 1, 64, 64, generator=torch.Generator().manual_seed(0))
    (a, fa), (b, fb) = ours(x), ref(x)
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    for u, v in zip(fa, fb):
        torch.testing.assert_close(u, v, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("workload", ["cardiac.full-f32", "camus.paper-f32",
                                      "camus.temporal-f32"])
def test_three_train_steps_follow_the_system(workload):
    """Every branch of the step, its random draws and both optimizers: the
    first step's loss and gradients to rounding, the three steps close.
    (The cells' limits are set for their own sizes on the card.)"""
    from benchmark import run

    bench, cell = tiny_cell(workload)
    result = run.run_cell(bench, cell)
    got = next(n["readings"] for n in cell.notes if "readings" in n)
    print(got)
    # the first step to rounding; later steps drift where Adam meets a
    # gradient element near zero (PERF.md)
    assert got["loss1_gap"] < 1e-5 and got["loss_gap"] < 1e-2
    assert got["grad_gap"] < 1e-4 and got["delta_med_gap"] < 1e-2
    assert got["delta_comp_med_gap"] < 1e-2 and got["seed_gap"] < 1e-2
    if "queue_gap" in got:
        assert got["queue_gap"] < 1e-2 and got["loss_steady_gap"] < 1e-3
    assert result["attempted"] >= 1 and result["failed"] == 0


def _top_level_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=REPO, capture_output=True, text=True, timeout=600, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_nothing_the_harness_runs_imports_jax():
    """A traced tiny run imports every module a run does: the loop, the
    trace reduction, the metric readers, the work counts, the reference."""
    code = ("import torch\ntorch.set_num_threads(1)\nfrom benchmark import run\n"
            "from benchmark.tests.tiny import tiny_cell\n"
            "bench, cell = tiny_cell('cardiac.full-f32', trace=True)\n"
            "run.run_cell(bench, cell)\n")
    names = _top_level_after(code)
    assert "graphecho_torch" in names  # the system was driven
    assert not names & FORBIDDEN, names & FORBIDDEN


def test_the_reference_imports_nothing_of_the_system():
    code = ("import benchmark.reference.cardiac, benchmark.reference.camus\n"
            "import pkgutil, importlib, benchmark.reference.uda as u\n"
            "for m in pkgutil.iter_modules(u.__path__):\n"
            "    importlib.import_module('benchmark.reference.uda.' + m.name)\n")
    names = _top_level_after(code)
    assert "graphecho_torch" not in names
    assert not names & FORBIDDEN
