"""Run summaries: JSONL scalar stream + optional TensorBoard, a copy of
`graphecho_tpu/utils/summary.py`.

Replaces the reference's tensorboardX SummaryWriter usage
(`train_camus_echo.py:180-181,490-499`): scalars and
histogram stats go to an append-only `metrics.jsonl` (machine-readable,
dependency-free), images to PNGs with JSONL pointer records; if tensorboardX
happens to be importable everything mirrors there. Covers all three
`sum_type` branches of the reference's `add_summary` (scalar/image/histogram).
"""

from __future__ import annotations

import json
import os
import time


class SummaryWriter:
    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self._f = open(self.path, "a")
        self._tb = None
        try:
            from tensorboardX import SummaryWriter as TBWriter  # type: ignore

            self._tb = TBWriter(log_dir)
        except ImportError:
            pass

    def add_scalar(self, name: str, value: float, step: int) -> None:
        self._f.write(json.dumps({"ts": time.time(), "step": step,
                                  "name": name, "value": float(value)}) + "\n")
        self._f.flush()
        if self._tb is not None:
            self._tb.add_scalar(name, value, step)

    def add_scalars(self, scalars, step: int, prefix: str = "") -> None:
        for k, v in scalars.items():
            try:
                self.add_scalar(prefix + k, float(v), step)
            except (TypeError, ValueError):
                continue

    def add_image(self, name: str, image, step: int) -> None:
        """Image summary (the reference's `sum_type='image'` branch of
        `add_summary`, `train_camus_echo.py:490-499` → tensorboardX
        `add_image`). Writes a PNG under `<log_dir>/images/` plus a JSONL
        pointer record; mirrors to TB when importable. Accepts (H, W),
        (H, W, 1) or (H, W, 3), uint8 or float in [0, 1] (NHWC convention —
        tensorboardX's default is CHW)."""
        import numpy as np

        img = np.asarray(image)
        if img.ndim == 3 and img.shape[-1] == 1:
            img = img[..., 0]
        if img.dtype != np.uint8:
            img = (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
        img_dir = os.path.join(os.path.dirname(self.path), "images")
        os.makedirs(img_dir, exist_ok=True)
        fname = f"{name.replace('/', '_')}_{step:06d}.png"
        from PIL import Image

        Image.fromarray(img).save(os.path.join(img_dir, fname))
        self._f.write(json.dumps({"ts": time.time(), "step": step,
                                  "name": name,
                                  "image": os.path.join("images", fname)})
                      + "\n")
        self._f.flush()
        if self._tb is not None:
            tb_img = img[None] if img.ndim == 2 else img.transpose(2, 0, 1)
            self._tb.add_image(name, tb_img, step)

    def add_histogram(self, name: str, values, step: int) -> None:
        self._f.write(json.dumps({"ts": time.time(), "step": step,
                                  "name": name, "hist": histogram_summary(values)})
                      + "\n")
        self._f.flush()
        if self._tb is not None:
            self._tb.add_histogram(name, values, step)

    def close(self) -> None:
        self._f.close()
        if self._tb is not None:
            self._tb.close()


def histogram_summary(values) -> dict:
    """Compact histogram record (replaces tensorboardX add_histogram in the
    reference's record_params path, `train_camus_echo.py:307-310`)."""
    import numpy as np

    v = np.asarray(values).ravel()
    return {"count": int(v.size), "mean": float(v.mean()),
            "std": float(v.std()), "min": float(v.min()),
            "max": float(v.max()),
            "p5": float(np.percentile(v, 5)),
            "p95": float(np.percentile(v, 95))}
