"""The most device memory the run held at once (`max_memory_allocated`),
before the reference ran, in GiB."""


def read(s):
    if not s.get("memory_peak_bytes"):
        return None
    return s["memory_peak_bytes"] / 2 ** 30
