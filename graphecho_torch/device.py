"""Device resolution shared by every entry point of the port, and the switch
that makes a run on the card repeat bit for bit."""

from __future__ import annotations

import os
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names another.

    With no `device` argument and no CUDA device this raises instead of
    quietly running on the CPU: a CPU run is only ever asked for explicitly
    (`device="cpu"`, as the tests do)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "graphecho_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run on the CPU explicitly")
    return torch.device("cuda")


# the values of CUBLAS_WORKSPACE_CONFIG under which cuBLAS is deterministic
# (the cuBLAS documentation, "Results reproducibility")
DETERMINISTIC_CUBLAS_WORKSPACES = (":4096:8", ":16:8")


def deterministic_algorithms(device: Union[str, torch.device]) -> None:
    """On a CUDA device, make every op take a deterministic algorithm
    (`torch.use_deterministic_algorithms(True)`: cuDNN's, index_add's,
    scatter's) and give cuBLAS a fixed workspace (`CUBLAS_WORKSPACE_CONFIG`,
    set to ":4096:8" where it is unset), so that two runs from one seed give
    the same bits. cuBLAS reads the variable when the process first uses it:
    call this before any CUDA work. A workspace value cuBLAS is not
    deterministic under raises. On any other device nothing changes (the
    port's ops on the CPU are deterministic already)."""
    if torch.device(device).type != "cuda":
        return
    workspace = os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG",
                                      DETERMINISTIC_CUBLAS_WORKSPACES[0])
    if workspace not in DETERMINISTIC_CUBLAS_WORKSPACES:
        raise RuntimeError(
            f"CUBLAS_WORKSPACE_CONFIG={workspace!r} makes cuBLAS non-deterministic; unset it "
            f"or set one of {', '.join(DETERMINISTIC_CUBLAS_WORKSPACES)}")
    torch.use_deterministic_algorithms(True)
