"""Host ms per train step inside the program's graph-head spans:
`step.sampling*`, `step.gmodule*` and `step.tgcn`."""


def read(s):
    names = [n for n in s.get("span_host_us", {})
             if n.startswith(("step.sampling", "step.gmodule")) or n == "step.tgcn"]
    if not names or not s.get("units"):
        return None
    return sum(s["span_host_us"][n] for n in names) / s["units"] / 1e3
