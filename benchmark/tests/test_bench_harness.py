"""The harness: found by name, its result line, its refusals, and
`BENCHMARK.json` against the contract it is written to."""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark.tests.tiny import TINY, tiny_cell

REPO = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _copy(tmp_path: Path) -> Path:
    dst = tmp_path / "checkout"
    shutil.copytree(REPO / "benchmark", dst / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(REPO / "BENCHMARK.json", dst / "BENCHMARK.json")
    return dst


def test_a_new_config_mix_and_metric_are_found_without_an_edit(tmp_path):
    """Added as files and entries in a copy, a configuration, a traffic mix
    and a metric reader drive a run; no file of the copy is edited."""
    dst = _copy(tmp_path)
    b = dst / "benchmark"
    before = {p: p.read_bytes() for p in b.rglob("*") if p.is_file()}
    conf = json.loads((b / "configs" / "camus.json").read_text())
    conf.update(name="mini", factory_args={"temporal_graph": True})
    (b / "configs" / "mini.json").write_text(json.dumps(conf))
    (b / "reference" / "mini.py").write_text((b / "reference" / "camus.py").read_text())
    mix = json.loads((b / "traffic" / "paper-f32.json").read_text())
    mix["overrides"]["data"] = {"target_batch_mult": 1}
    (b / "traffic" / "mini-temporal-f32.json").write_text(json.dumps(mix))
    (b / "limits" / "mini.temporal-f32.json").write_text(
        (b / "limits" / "camus.paper-f32.json").read_text())
    (b / "metrics" / "train.traced_steps.py").write_text(
        "def read(s):\n    return float(s['units'])\n")
    bench = json.loads((dst / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "mini", "source": "https://arxiv.org/abs/2309.11145",
                             "file": "benchmark/configs/mini.json", "reduced": [],
                             "why": "test"})
    bench["workloads"].append({"name": "mini.temporal-f32", "config": "mini",
                               "traffic": "mini-temporal-f32", "chips": 1, "why": "test"})
    bench["end_to_end"][0]["workloads"].append("mini.temporal-f32")
    bench["per_layer"].append({"name": "train.traced_steps", "unit": "steps",
                               "better": "lower", "source": "program_counter",
                               "layer": "train step", "moves": "step_ms",
                               "workloads": ["mini.temporal-f32"]})
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    tiny = dict(TINY["camus.paper-f32"],
                tgcn={"input_dim": 32, "hidden_dim": 32, "clip_shape": [4, 4, 4]})
    code = (
        "import json, time, torch\ntorch.set_num_threads(1)\nfrom benchmark import run\n"
        "bench = run.load_benchmark()\n"
        "for trace in (False, True):\n"
        "    cell = run.make_cell(bench, 'mini.temporal-f32', 7, 0.3, trace,\n"
        "        torch.device('cpu'), time.perf_counter(), extra=json.loads(%r))\n"
        "    print(json.dumps(run.run_cell(bench, cell)))\n" % json.dumps(tiny))
    env = dict(os.environ, PYTHONPATH=f"{dst}{os.pathsep}{REPO}")
    out = subprocess.run([sys.executable, "-c", code], cwd=dst, env=env, capture_output=True,
                         text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    plain, traced = (json.loads(line) for line in out.stdout.strip().splitlines()[-2:])
    assert set(plain["metrics"]) == {"step_ms", "setup_s"}
    assert traced["metrics"]["train.traced_steps"]["value"] == mix["trace_steps"]
    assert all(before[p] == p.read_bytes() for p in before)


@pytest.mark.parametrize("trace", [False, True])
def test_the_result_line_has_the_contract_keys(trace):
    from benchmark import run

    bench, cell = tiny_cell("camus.paper-f32", trace=trace)
    result = run.run_cell(bench, cell)
    keys = list(result)
    assert keys[:5] == KEYS and keys[-1] == "checks"
    assert set(keys) - set(KEYS) == ({"checks", "breakdown"} if trace else {"checks"})
    for name, c in result["checks"].items():
        assert set(c) == {"value", "limit"}
    if trace:
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(result["metrics"]) == {"step_ms", "setup_s"}


def _run_cli(cwd: Path, env=None):
    return subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                           "camus.paper-f32", "--seed", str(2 ** 31 + 3), "--seconds", "1",
                           "--trace", "0"], cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


def test_without_a_card_there_is_no_result(monkeypatch):
    """The measurement path never falls back to the CPU."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _run_cli(REPO, env)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_the_benchmark_alone_gives_no_result(tmp_path):
    dst = _copy(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = _run_cli(dst, env)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_benchmark_json_keeps_to_the_contract():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"] and 1 <= bench["run_seconds"] <= 51
    configs = {c["name"]: c for c in bench["configs"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and (REPO / c["file"]).is_file()
        assert c["file"].startswith("benchmark/")
        assert (REPO / "benchmark" / "reference" / f"{c['name']}.py").is_file()
    cells = {w["name"]: w for w in bench["workloads"]}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in configs and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
        for kind, name in (("traffic", w["traffic"]), ("limits", w["name"])):
            assert (REPO / "benchmark" / kind / f"{name}.json").is_file()
    assert {w["config"] for w in bench["workloads"]} == set(configs)
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in (
            "lower", "higher")
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for cell in cells:
        reported = [n for n, m in e2e.items() if cell in m.get("workloads", cells)]
        assert "setup_s" in reported and len(reported) >= 2
        layer = [m for m in bench["per_layer"] if cell in m["workloads"]]
        assert layer and all(m["moves"] in reported for m in layer)
    for m in bench["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert (REPO / "benchmark" / "metrics" / f"{m['name']}.py").is_file()
        if m["name"].endswith("_roofline") or "mfu" in m["name"].split("."):
            assert m["unit"] == "%"


def test_a_program_configuration_apart_from_the_reference_stops_the_run(monkeypatch):
    """The cell's sizes are the reference's: where the program's factory
    gives another clip length, the run stops before a step."""
    import dataclasses

    from graphecho_torch import config as program_config

    from benchmark import run

    factory = program_config.camus_echo_config

    def smaller(**kwargs):
        cfg = factory(**kwargs)
        return dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, clip_length=4))

    monkeypatch.setattr(program_config, "camus_echo_config", smaller)
    bench, cell = tiny_cell("camus.paper-f32")
    with pytest.raises(SystemExit, match="data.clip_length"):
        run.run_cell(bench, cell)
