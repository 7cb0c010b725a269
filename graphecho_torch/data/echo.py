"""EchoNet-Dynamic dataset (.avi videos + trace CSVs), port of
`graphecho_tpu/data/echo.py`. pandas (the CSVs) and cv2 (the videos) are
imported when a dataset is built or a video decoded, never at import time.

Re-implements the full reference `Echo` surface
(`datasets/echo.py:19-292`):
  * `FileList.csv` split filtering (train/val/test/all) + `VolumeTracings.csv`
    LV trace parsing (`:106-152`), dropping videos with < 2 traced frames
    (`:149-152`); `external_test` split listing videos straight from
    `external_test_location` (`:102-103,156-157`) and `clinical_test` from
    `<root>/ProcessedStrainStudyA4c` (`:158-159`);
  * cv2 AVI grayscale decode, `/255` normalization (`:164,189`) or
    mean/std normalization under `normalized=True` (`:177-187`);
  * `target_type` as a string or list over {Filename, EF, EDV, ESV,
    LargeIndex, SmallIndex, LargeFrame, SmallFrame, LargeTrace, SmallTrace}
    (`:226-263`) — scalar outcomes come from the FileList columns, traces
    rasterize to binary LV masks via scanline polygon fill (`:243-255`,
    replacing skimage.draw.polygon);
  * clip sampling pinned at the traced ED (LargeTrace -> last traced frame)
    or ES (SmallTrace -> first) frame (`:210-224`), `clips="all"` enumerating
    every window when validation=False (`:210-212`), zero-padding short
    videos (`:204-208`), optional noise / pad augmentation
    (`:167-175,274-282`).

Contract notes (deliberate cleanup of reference bugs): the reference returns a
(C, L, H, W) clip that downstream code indexes inconsistently (its target
loader feeds 5-D clips into a 2-D conv). Here (NHWC layouts):
  * `single_frame=True` (default — what the CAMUS→EchoNet target loader
    actually needs) returns the traced frame: (H, W, 1) image, (H, W, 1) mask;
  * `single_frame=False` returns ((T, H, W, 1) clip — or (clips, T, H, W, 1)
    when `clips != 1` — target, mask_index, index), where `target` follows
    the reference's tuple semantics: the single value when one target_type is
    given, else a tuple in target_type order.
"""

from __future__ import annotations

import collections
import os
from typing import List, Optional, Sequence, Union

import numpy as np

from graphecho_torch.data.transforms import polygon_mask
from graphecho_torch.data.video import loadvideo

TRACE_TARGETS = ("LargeTrace", "SmallTrace")
FRAME_TARGETS = ("LargeFrame", "SmallFrame")
INDEX_TARGETS = ("LargeIndex", "SmallIndex")


class Echo:
    def __init__(self, root: str, split: str = "train",
                 target_type: Union[str, Sequence[str]] = "LargeTrace",
                 validation: bool = True,
                 normalized: bool = False, mean: float = 0.0, std: float = 1.0,
                 length: Optional[int] = 8, period: int = 1,
                 max_length: Optional[int] = 8,
                 clips: Union[int, str] = 1, grey: bool = True,
                 pad: Optional[int] = None, noise: Optional[float] = None,
                 target_transform=None,
                 external_test_location: Optional[str] = None,
                 single_frame: bool = True, seed: int = 0):
        import pandas

        self.root = root
        self.split = split.upper()
        if isinstance(target_type, str):
            target_type = [target_type]
        self.target_type = list(target_type)
        self.validation = validation
        self.normalized = normalized
        self.mean = mean
        self.std = std
        self.length = length
        self.period = period
        self.max_length = max_length
        self.clips = clips
        self.grey = grey
        self.pad = pad
        self.noise = noise
        self.target_transform = target_transform
        self.external_test_location = external_test_location
        self.single_frame = single_frame
        self._rng = np.random.RandomState(seed)

        self.fnames: List[str] = []
        self.outcome: List[list] = []
        self.header: List[str] = []
        self.frames = collections.defaultdict(list)
        self.trace = collections.defaultdict(dict)

        if self.split == "EXTERNAL_TEST":
            # videos listed straight from the external location; no FileList
            # columns, traces, or missing-file checks (`echo.py:102-103`)
            if external_test_location is None:
                raise ValueError(
                    "split='external_test' requires external_test_location")
            self.fnames = sorted(os.listdir(external_test_location))
            self.num_data = len(self.fnames)
            return

        with open(os.path.join(root, "FileList.csv")) as f:
            data = pandas.read_csv(f)
        data["Split"] = data["Split"].map(lambda x: str(x).upper())
        if self.split != "ALL":
            data = data[data["Split"] == self.split]
        self.fnames = data["FileName"].tolist()
        # Deviation: the stock EchoNet-Dynamic FileList.csv carries
        # extension-less names while VolumeTracings keys get ".avi" appended
        # below; the reference's own normalization is commented out
        # (`datasets/echo.py:115`), so it crashes on the stock release. We
        # normalize so both CSV flavors load.
        self.fnames = [f if f.endswith(".avi") else f + ".avi"
                       for f in self.fnames]
        self.outcome = data.values.tolist()
        self.header = data.columns.tolist()

        missing = set(self.fnames) - set(os.listdir(os.path.join(root, "Videos")))
        if missing:
            raise FileNotFoundError(
                os.path.join(root, "Videos", sorted(missing)[0]))

        with open(os.path.join(root, "VolumeTracings.csv")) as f:
            header = f.readline().strip().split(",")
            assert header == ["FileName", "X1", "Y1", "X2", "Y2", "Frame"]
            for line in f:
                filename, x1, y1, x2, y2, frame = line.strip().split(",")
                filename = filename + ".avi" if not filename.endswith(".avi") \
                    else filename
                frame = int(frame)
                if frame not in self.trace[filename]:
                    self.frames[filename].append(frame)
                    self.trace[filename][frame] = []
                self.trace[filename][frame].append(
                    (float(x1), float(y1), float(x2), float(y2)))
        for filename in self.frames:
            for frame in self.frames[filename]:
                self.trace[filename][frame] = np.asarray(
                    self.trace[filename][frame])

        keep = [len(self.frames.get(f, [])) >= 2 for f in self.fnames]
        self.fnames = [f for f, k in zip(self.fnames, keep) if k]
        self.outcome = [o for o, k in zip(self.outcome, keep) if k]
        self.num_data = len(self.fnames)

    def __len__(self) -> int:
        return len(self.fnames)

    def _traced_frame(self, key: str) -> int:
        # traces are sorted by cross-sectional area; largest (ED) is last
        frames = self.frames[key]
        if not frames:
            raise ValueError(
                f"no traces for {key!r} (trace-pinned sampling and "
                "Large/Small targets need VolumeTracings; the "
                "external_test/clinical_test splits carry none)")
        return int(frames[-1] if self.target_type[0] == "LargeTrace"
                   else frames[0])

    def _trace_mask(self, key: str, frame: int, h: int, w: int) -> np.ndarray:
        t = self.trace[key][frame]
        x1, y1, x2, y2 = t[:, 0], t[:, 1], t[:, 2], t[:, 3]
        # reference drops the first segment and walks down one side, back up
        # the other (`echo.py:248-250`)
        x = np.concatenate((x1[1:], np.flip(x2[1:])))
        y = np.concatenate((y1[1:], np.flip(y2[1:])))
        return polygon_mask(np.rint(y).astype(int), np.rint(x).astype(int),
                            (h, w))

    def _video_path(self, index: int) -> str:
        if self.split == "EXTERNAL_TEST":
            return os.path.join(self.external_test_location, self.fnames[index])
        if self.split == "CLINICAL_TEST":
            return os.path.join(self.root, "ProcessedStrainStudyA4c",
                                self.fnames[index])
        return os.path.join(self.root, "Videos", self.fnames[index])

    def _gather_targets(self, index: int, video: np.ndarray):
        """One value per requested target type (`echo.py:226-263`); video is
        (F, H, W, C)."""
        key = self.fnames[index]
        f, h, w, _ = video.shape
        out = []
        for t in self.target_type:
            if t == "Filename":
                out.append(key)
            elif t == "LargeIndex":
                out.append(int(self.frames[key][-1]))
            elif t == "SmallIndex":
                out.append(int(self.frames[key][0]))
            elif t == "LargeFrame":
                out.append(video[min(int(self.frames[key][-1]), f - 1)])
            elif t == "SmallFrame":
                out.append(video[min(int(self.frames[key][0]), f - 1)])
            elif t in TRACE_TARGETS:
                frame = (self.frames[key][-1] if t == "LargeTrace"
                         else self.frames[key][0])
                out.append(self._trace_mask(key, int(frame), h, w)[..., None])
            else:
                # scalar outcome column (EF / EDV / ESV / ...); external and
                # clinical test sets have no outcome table (`echo.py:257-258`)
                if self.split in ("EXTERNAL_TEST", "CLINICAL_TEST"):
                    out.append(np.float32(0))
                else:
                    out.append(np.float32(
                        self.outcome[index][self.header.index(t)]))
        return out

    def __getitem__(self, index: int):
        video = loadvideo(self._video_path(index),
                          self.grey).astype(np.float32)  # (F, H, W, C)

        if self.noise is not None:  # simulated dropout noise (`:167-175`)
            f, h, w, c = video.shape
            n = f * h * w
            ind = self._rng.choice(n, round(self.noise * n), replace=False)
            fi = ind % f
            ind //= f
            hi = ind % h
            wi = ind // h
            video[fi, hi, wi, :] = 0

        if self.normalized:  # mean/std normalization (`:177-187`)
            video = (video - self.mean) / self.std
        else:
            video /= 255.0
        f, h, w, c = video.shape
        length = self.length if self.length is not None else f // self.period
        if self.max_length is not None:
            length = min(length, self.max_length)
        if f < length * self.period:
            pad_frames = np.zeros((length * self.period - f, h, w, c),
                                  video.dtype)
            video = np.concatenate([video, pad_frames], axis=0)
            f = video.shape[0]

        targets = self._gather_targets(index, video)
        target = tuple(targets) if len(targets) > 1 else targets[0]
        if self.target_transform is not None:
            target = self.target_transform(target)

        if self.single_frame:
            start = self._traced_frame(self.fnames[index])
            frame = video[min(start, f - 1)]
            mask = target if len(targets) == 1 else targets[0]
            return frame, mask, 0, index

        # clip starts: every window under clips="all" at train time
        # (`:210-212`), else pinned at the traced ED/ES frame (`:213-224`)
        if self.clips == "all" and not self.validation:
            starts = np.arange(f - (length - 1) * self.period)
        else:
            starts = [self._traced_frame(self.fnames[index])]

        def window(s):
            idx = s + self.period * np.arange(length)
            return video[np.clip(idx, 0, f - 1)]  # (T, H, W, C)

        if self.clips == 1:
            clip = window(starts[0])
        else:
            n_clips = len(starts) if self.clips == "all" else int(self.clips)
            clip = np.stack([window(starts[i % len(starts)])
                             for i in range(n_clips)])

        if self.pad is not None:  # random shift augmentation (`:274-282`)
            h, w = clip.shape[-3], clip.shape[-2]
            pad_spec = [(0, 0)] * (clip.ndim - 3) + [
                (self.pad, self.pad), (self.pad, self.pad), (0, 0)]
            tmp = np.pad(clip, pad_spec)
            i, j = self._rng.randint(0, 2 * self.pad, 2)
            clip = tmp[..., i:i + h, j:j + w, :]

        return clip, target, 0, index
