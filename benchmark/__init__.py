"""The benchmark of graphecho_torch, the PyTorch and CUDA package, on one
NVIDIA H100.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

`BENCHMARK.json` at the root of the repository names the cells. Each cell is
a configuration (`configs/<name>.json`, with its plain reference in
`reference/<name>.py`) under a traffic mix (`traffic/<name>.json`), whose
`loop` names the loop in `loops/<loop>.py`; each per-layer metric is read
by `metrics/<name>.py`. Adding a cell, a mix or a metric adds files and
entries and edits none.

A configuration's reference module is its whole model, and the harness
takes from it only these names:

  * `config`: the factories its `configs/<name>.json` names;
  * `TrainReference`: the plain train step (`reference/uda/step.py`'s, or a
    subclass that sets `build_fpn` to the configuration's own builder). Its
    `build_fpn(cfg)` is the FPN it trains and the one on which
    `work.train_step_flops` counts the model FLOPs; a backbone the uda FPN
    does not name is passed to `reference/uda/fpn.py::FPN` as a module with
    `out_channels`;
  * `kernel_call_shapes(cfg)`: the calls one train step makes to each
    hand-written kernel, by the program's launch counter, one shape per call
    (`reference/uda/step.py` has the uda model's). A traced run's summary
    carries it as `kernel_call_shapes` beside `kernel_shapes`, and a reader
    takes the traced calls through `work.traced_calls`, which gives nothing
    where their number is not the launches the wrapper counted.
"""
