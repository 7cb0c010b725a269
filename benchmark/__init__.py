"""The benchmark of graphecho_torch, the PyTorch and CUDA package, on one
NVIDIA H100.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

`BENCHMARK.json` at the root of the repository names the cells. Each cell is
a configuration (`configs/<name>.json`, with its plain reference in
`reference/<name>.py`) under a traffic mix (`traffic/<name>.json`), whose
`loop` names the loop in `loops/<loop>.py`; each per-layer metric is read
by `metrics/<name>.py`. Adding a cell, a mix or a metric adds files and
entries and edits none.
"""
