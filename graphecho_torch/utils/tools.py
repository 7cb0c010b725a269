"""Rank and cluster discovery from the environment, port of
`graphecho_tpu/utils/tools.py` (reference `utils/tools.py:5-47`).

MPI launchers (PMI, Open MPI) and Azure Batch set their own variables;
`torchrun` and the port's own launches set `WORLD_SIZE`, `RANK`,
`LOCAL_RANK`, `MASTER_ADDR` and `MASTER_PORT`, which take the place of the
JAX package's `JAX_*` variables. `parallel/mesh.py::initialize_distributed`
reads these when its arguments are unset.
"""

from __future__ import annotations

import os

DEFAULT_PORT = 29500  # torch.distributed's customary rendezvous port


def _first(names, default):
    for name in names:
        if name in os.environ:
            return os.environ[name]
    return default


def get_world_size() -> int:
    return int(_first(("PMI_SIZE", "OMPI_COMM_WORLD_SIZE", "WORLD_SIZE"), 1))


def get_global_rank() -> int:
    return int(_first(("PMI_RANK", "OMPI_COMM_WORLD_RANK", "RANK"), 0))


def get_local_rank() -> int:
    local = _first(("MPI_LOCALRANKID", "OMPI_COMM_WORLD_LOCAL_RANK", "LOCAL_RANK"), None)
    return get_global_rank() if local is None else int(local)


def get_master_ip() -> str:
    """Process 0's address: Azure Batch's convention, then `MASTER_ADDR`,
    then loopback (the reference's default, `tools.py:41-47`)."""
    if "AZ_BATCH_MASTER_NODE" in os.environ:
        return os.environ["AZ_BATCH_MASTER_NODE"].split(":")[0]
    if "AZ_BATCHAI_MPI_MASTER_NODE" in os.environ:
        return os.environ["AZ_BATCHAI_MPI_MASTER_NODE"]
    return os.environ.get("MASTER_ADDR", "127.0.0.1")


def get_master_port() -> int:
    """Process 0's port: Azure Batch's `host:port`, then `MASTER_PORT`."""
    node = os.environ.get("AZ_BATCH_MASTER_NODE", "")
    if ":" in node:
        return int(node.split(":")[1])
    return int(os.environ.get("MASTER_PORT", DEFAULT_PORT))
