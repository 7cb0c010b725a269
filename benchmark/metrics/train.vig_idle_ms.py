"""Device ms idle per train step while the host was inside the Pyramid
ViG: the `step.vig.*` spans (stem, downsamples, Graphers with their graph
build and graph conv, FFNs), each idle stretch given to the innermost span
open at its middle (`idle_us_by_span`). None where the trace holds no
`step.vig.*` span."""


def read(s):
    if not s.get("units") or not any(n.startswith("step.vig.") for n in s.get("span_host_us", {})):
        return None
    idle = s.get("idle_us_by_span", {})
    return sum(v for n, v in idle.items() if n.startswith("step.vig.")) / s["units"] / 1e3
