"""The share of the traced train steps' window in which no device event ran, in %."""


def read(s):
    if not s.get("window_s") or not s.get("device_events"):
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
