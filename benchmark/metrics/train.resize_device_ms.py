"""Device ms per train step of the FPN's bilinear resize: every kernel whose
function name holds `upsample_bilinear2d` (PyTorch's) or `resize_bilinear`
(the program's own, `csrc/resize.cu`)."""

NAMES = ("upsample_bilinear2d", "resize_bilinear")


def read(s):
    us = sum(v for k, v in s.get("kernel_us", {}).items() if any(n in k for n in NAMES))
    if not us or not s.get("units"):
        return None
    return us / s["units"] / 1e3
