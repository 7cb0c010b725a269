"""Device events (kernels, copies, fills) per train step in the trace."""


def read(s):
    if not s.get("units") or not s.get("device_events"):
        return None
    return s["device_events"] / s["units"]
