"""Device ms idle per train step while the host was inside the GModule:
`step.gmodule`, `step.gmodule_temporal` and the `step.gm.*` spans inside
them, each idle stretch given to the innermost span open at its middle
(`idle_us_by_span`)."""


def read(s):
    idle = s.get("idle_us_by_span", {})
    names = [n for n in idle if n.startswith(("step.gmodule", "step.gm."))]
    if not names or not s.get("units"):
        return None
    return sum(idle[n] for n in names) / s["units"] / 1e3
