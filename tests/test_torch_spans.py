"""The train step's spans (`utils/profiling.py::annotate`) on the CPU: a tiny
step with every branch traced under `torch.profiler` opens each span of the
graph head and of the batch copies, nested where it belongs; every span name
in the port keeps the naming rules, and none opens inside a loop; the
profiler leaves the step's losses bit-equal; and the attribution of idle
time, launches and synchronisations to the innermost span
(`innermost_spans`, `profile_step.by_span`) on synthetic traces."""

import ast
import dataclasses
from pathlib import Path

import pytest
import torch

from graphecho_torch import config as C
from graphecho_torch.data.synthetic import SyntheticEchoData
from graphecho_torch.profile_step import by_span
from graphecho_torch.train.state import create_train_state
from graphecho_torch.train.steps import build_models, make_train_step
from graphecho_torch.utils.profiling import OUTSIDE, innermost_spans

PACKAGE = Path(__file__).resolve().parents[1] / "graphecho_torch"
# the graph head's phases, opened by the train step alone; readers sum the
# host time of every name that begins with the first two or is the last
HEAD_PREFIXES = ("step.sampling", "step.gmodule")
HEAD_PHASES = ("step.sampling", "step.sampling_temporal", "step.gmodule",
               "step.gmodule_temporal", "step.tgcn")
GM_PARTS = ("step.gm.group", "step.gm.intra_graph", "step.gm.seed_update",
            "step.gm.cross_graph", "step.gm.node_cls", "step.gm.matching")
# span -> the spans that must enclose each of its openings (any one of them)
PARENTS = {
    **{n: ("step.gmodule", "step.gmodule_temporal") for n in GM_PARTS},
    "step.gm.affinity": ("step.gm.matching",),
    "step.gm.sinkhorn": ("step.gm.matching",),
    "step.gm.laplacian": ("step.gm.seed_update",),
    "step.gm.fiedler": ("step.gm.seed_update",),
    "step.gm.kmeans": ("step.gm.seed_update",),
    **{f"step.tg.{n}": ("step.tgcn",)
       for n in ("fuse", "recurrence", "head", "attention", "transport")},
    "step.nodes.boxes": ("step.sampling", "step.sampling_temporal"),
    "step.nodes.sample": ("step.sampling", "step.sampling_temporal"),
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and torch's default of a thread per core oversubscribes the machine
    (tens of times slower under load)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tiny_cfg():
    """cardiac_full shrunk: every branch (graph matching, discriminators, the
    momentum-queue TGCN, the cycle loss) at 32², widths 32, batch 2 + 2."""
    cfg = C.cardiac_uda_config(temporal_graph=True, cyc_loss=True)
    return dataclasses.replace(
        cfg,
        data=dataclasses.replace(cfg.data, img_crop=(32, 32), batch_size=2,
                                 target_batch_mult=1),
        model=dataclasses.replace(cfg.model, fpn_channels=32, semantic_channels=16,
                                  vgg_spec=((8, 1), (16, 1), (16, 1), (32, 1), (32, 1))),
        gmodule=dataclasses.replace(cfg.gmodule, in_channels=32, nodes_per_class=8),
        dis=dataclasses.replace(cfg.dis, in_channels=32),
        tgcn=dataclasses.replace(cfg.tgcn, input_dim=32, hidden_dim=32, clip_shape=(2, 4, 4),
                                 cluster_method="momentum_queue", queue_size=6,
                                 source_class=6, target_class=6),
        cycle=dataclasses.replace(cfg.cycle, clip_length=24))


def _step_metrics(cfg, batch, traced: bool):
    state = create_train_state(cfg, build_models(cfg), torch.device("cpu"), seed=3)
    step = make_train_step(cfg)
    if not traced:
        return step(state, batch), []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        metrics = step(state, batch)
    spans = [(e.time_range.start, e.time_range.end, e.thread, e.name) for e in prof.events()
             if e.name.startswith("step.")]
    return metrics, spans


@pytest.fixture(scope="module")
def steps():
    """One step traced and the same step untraced, from the same state."""
    cfg = _tiny_cfg()
    batch = SyntheticEchoData(cfg, seed=4).train_batch()
    traced, spans = _step_metrics(cfg, batch, traced=True)
    plain, _ = _step_metrics(cfg, batch, traced=False)
    return batch, traced, plain, spans


def _program_spans():
    """name -> [(file, line, inside a loop)] of every `annotate(...)` in the
    port, found in its source."""
    sites = {}
    for path in sorted(PACKAGE.rglob("*.py")):
        tree = ast.parse(path.read_text())
        loops = (ast.For, ast.While, ast.ListComp, ast.SetComp, ast.DictComp,
                 ast.GeneratorExp)

        def visit(node, in_loop):
            if (isinstance(node, ast.Call) and getattr(node.func, "id", None) == "annotate"
                    and path.name != "profiling.py"):
                arg = node.args[0]
                name = arg.value if isinstance(arg, ast.Constant) else None
                sites.setdefault(name, []).append((path.name, node.lineno, in_loop))
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                in_loop = False
            for child in ast.iter_child_nodes(node):
                visit(child, in_loop or (isinstance(node, loops) and child is not getattr(
                    node, "iter", None)))

        visit(tree, False)
    return sites


SITES = _program_spans()


def test_a_traced_step_opens_every_span_where_it_belongs(steps):
    batch, _, _, spans = steps
    opened = {}
    for s, e, thread, name in spans:
        opened.setdefault(name, []).append((s, e, thread))
    assert set(PARENTS) | set(HEAD_PHASES) | {"step.h2d"} <= set(opened), sorted(opened)
    # nothing the step opens is missing from the names the source opens
    assert set(opened) <= set(SITES), sorted(set(opened) - set(SITES))
    for child, parents in PARENTS.items():
        for s, e, thread in opened[child]:
            assert any(ps <= s and e <= pe and thread == pt
                       for p in parents for ps, pe, pt in opened[p]), (child, parents)
    # once or twice a GModule call (two calls a step), once a TGCN call
    assert len(opened["step.gm.seed_update"]) == len(opened["step.gm.fiedler"]) == 4
    assert len(opened["step.gm.sinkhorn"]) == len(opened["step.gm.group"]) == 2
    assert all(len(opened[f"step.tg.{n}"]) == 1 for n in ("fuse", "recurrence", "head"))
    # one copy to the card a batch entry
    assert len(opened["step.h2d"]) == len(batch) == 9


@pytest.mark.parametrize("name", sorted(SITES, key=str))
def test_span_names_keep_the_rules(name):
    where = SITES[name]
    assert isinstance(name, str), f"a span name that is not a literal at {where}"
    assert name.startswith("step."), where
    assert not any(loop for _, _, loop in where), f"{name} opens inside a loop body: {where}"
    if name in HEAD_PHASES:
        assert {f for f, _, _ in where} == {"steps.py"}, where
    else:
        assert not name.startswith(HEAD_PREFIXES) and name != "step.tgcn", where


def test_the_profiler_leaves_the_losses_bit_equal(steps):
    _, traced, plain, _ = steps
    assert set(traced) == set(plain)
    for k in plain:
        assert torch.equal(traced[k], plain[k]), k


# ----------------------------------------------------------- attribution
SPANS = [(0, 100, "step.gmodule"), (10, 40, "step.gm.seed_update"),
         (15, 30, "step.gm.fiedler"), (50, 60, "step.gm.matching"),
         (120, 200, "step.backward")]


def test_innermost_spans_takes_the_shortest_span_holding_each_instant():
    times = [20, 12, 45, 55, 100, 110, 150, -5, 15, 30]
    assert innermost_spans(times, SPANS) == [
        "step.gm.fiedler", "step.gm.seed_update", "step.gmodule", "step.gm.matching",
        OUTSIDE, OUTSIDE, "step.backward", OUTSIDE, "step.gm.fiedler", "step.gm.seed_update"]
    assert innermost_spans([], SPANS) == [] and innermost_spans([3], []) == [OUTSIDE]


def test_by_span_gives_idle_time_launches_and_syncs_to_the_innermost_span():
    busy = [(-20, 5), (32, 48), (62, 118), (130, 150), (190, 230)]
    calls = [(-10, -9, "cudaDeviceSynchronize"),  # before the first span: left out
             (16, 17, "cudaLaunchKernel"), (18, 19, "cudaMemcpyAsync"),
             (20, 26, "cudaStreamSynchronize"), (21, 22, "cuLaunchKernel"),
             (52, 53, "cudaMemsetAsync"), (55, 56, "cudaGetDevice"),
             (105, 106, "cudaLaunchKernel"),  # between spans
             # autograd's device thread: its calls fall in the span open then
             (140, 141, "cudaLaunchKernelExC"), (142, 143, "cudaLaunchCooperativeKernel"),
             (145, 149, "cudaEventSynchronize"),
             (205, 260, "cudaDeviceSynchronize")]  # after the last span: left out
    got = by_span(SPANS, calls, busy)
    assert got["launches"] == {"step.gm.fiedler": 3, "step.gm.matching": 1, OUTSIDE: 1,
                               "step.backward": 2}
    assert got["syncs"] == {"step.gm.fiedler": [1, 6.0], "step.backward": [1, 4.0]}
    # gaps 5-32 (middle 18.5: fiedler), 48-62 (55: matching), 118-130 (124:
    # backward), 150-190 (170: backward); the window ends at 200
    assert got["idle_us"] == {"step.gm.fiedler": 27.0, "step.gm.matching": 14.0,
                              "step.backward": 52.0}
    assert by_span([], calls, busy) == {"idle_us": {}, "launches": {}, "syncs": {}}
