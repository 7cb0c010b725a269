"""The kNN kernel's share of its roofline over every traced call, in %: the
least time the card could take for each call at its own shape (the
configuration's `kernel_call_shapes`: the Graphers' graphs and the TGCN's,
`work.traced_calls`), over the device time of every kernel whose function
name holds `knn`. None where the traced calls are not the launches counted."""

from benchmark import work


def read(s):
    calls = work.traced_calls(s, "knn")
    us = sum(v for k, v in s.get("kernel_us", {}).items() if "knn" in k)
    if calls is None or not us:
        return None
    return 100.0 * sum(work.bound_s(*work.knn_work(*c)) for c in calls) / (us / 1e6)
