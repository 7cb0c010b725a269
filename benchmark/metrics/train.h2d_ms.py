"""Host ms per train step inside the program's `step.h2d` spans: the batch
entries' copies to the card."""


def read(s):
    us = s.get("span_host_us", {}).get("step.h2d")
    if us is None or not s.get("units"):
        return None
    return us / s["units"] / 1e3
