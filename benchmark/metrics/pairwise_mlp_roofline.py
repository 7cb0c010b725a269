"""The pairwise-MLP kernels' share of their roofline, in %: the least time
the card could take for the forward and backward calls traced (each call's
operations and bytes at the configuration's affinity shape, `work.py`),
over the device time of every `pairwise_*` kernel."""

from benchmark import work


def read(s):
    calls = s.get("kernel_launches", {})
    shape = s.get("kernel_shapes", {}).get("pairwise_mlp")
    us = sum(v for k, v in s.get("kernel_us", {}).items() if k.startswith("pairwise_"))
    n_fwd, n_bwd = calls.get("pairwise_mlp_fwd", 0), calls.get("pairwise_mlp_bwd", 0)
    if shape is None or not us or not (n_fwd or n_bwd):
        return None
    bound = (n_fwd * work.bound_s(*work.pairwise_fwd_work(*shape))
             + n_bwd * work.bound_s(*work.pairwise_bwd_work(*shape)))
    return 100.0 * bound / (us / 1e6)
