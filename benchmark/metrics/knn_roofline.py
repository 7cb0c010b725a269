"""The kNN kernel's share of its roofline, in %: the least time the card
could take for the calls traced (each at the TGCN's shape, `work.py`), over
the device time of every kernel whose function name holds `knn`."""

from benchmark import work


def read(s):
    calls = s.get("kernel_launches", {}).get("knn", 0)
    shape = s.get("kernel_shapes", {}).get("knn")
    us = sum(v for k, v in s.get("kernel_us", {}).items() if "knn" in k)
    if shape is None or not us or not calls:
        return None
    return 100.0 * calls * work.bound_s(*work.knn_work(*shape)) / (us / 1e6)
