"""Launches per train step of the GModule's spectral seed split kernel: the
traced calls of every kernel function whose name holds `spectral`."""


def read(s):
    calls = [n for name, n in s.get("kernel_calls", {}).items() if "spectral" in name]
    if not calls or not s.get("units"):
        return None
    return sum(calls) / s["units"]
