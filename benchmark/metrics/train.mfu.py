"""The train step's model FLOPs (`work.train_step_flops`) over the step time
of the untraced window times the peak of the precision the step computes
in, in %."""


def read(s):
    if not s.get("step_s") or not s.get("model_flops"):
        return None
    return 100.0 * s["model_flops"] / (s["step_s"] * s["peak_ops"])
