"""Device ms per train step of the kernels that `aten::cudnn_convolution`
and `aten::convolution_backward` launch, their children's included."""

OPS = ("aten::cudnn_convolution", "aten::convolution_backward")


def read(s):
    us = sum(s.get("op_device_us", {}).get(op, 0.0) for op in OPS)
    if not us or not s.get("units"):
        return None
    return us / s["units"] / 1e3
