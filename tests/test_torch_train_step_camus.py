"""The camus branch of the train step (ResNet50 with the [3,4,5,3] quirk, one
class, the camus seg supervision) against the JAX package, on the CPU.

Same start and checks as `test_torch_train_step.py`, in a file of its own
because the JAX whole-step program of the ResNet50 is the costly compile of
the port's tests. With one class the FCOS labels (box indices) leave no
positive node, so both packages gate the graph losses to 0: the discriminators
behind gradient reversal and the seg loss carry the gradient.
"""

import pytest
import torch

from test_torch_train_step import (_assert_losses, _batches, _check_deltas,
                                   _port_snapshot, _shared_start, make_train_step)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and torch's default of a thread per core oversubscribes the machine
    (tens of times slower under load)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_one_step_matches_jax():
    batch = _batches(1, 1)[0]
    _, j0, step, tcfg, tstate = _shared_start("camus", batch)
    t0 = _port_snapshot(tstate)
    j1, jm = step(j0, batch)
    tm = make_train_step(tcfg)(tstate, batch)
    for k in ("dis_loss", "node_loss", "mat_loss_aff", "mat_loss_qu"):
        assert float(jm[k]) == 0.0 and float(tm[k]) == 0.0, k
    _assert_losses({k: float(v) for k, v in jm.items()}, tm, "camus step 0")
    _check_deltas("camus", j0, j1, t0, _port_snapshot(tstate), "back_bone.layer4.2.conv3.weight")
