"""CAMUS dataset (.mhd echo stills), port of `graphecho_tpu/data/camus.py`.

Re-implements the reference `DataLoaderCamus` (`datasets/camus.py:39-159`):
  * glob `<root>/training/*` patient dirs, skip empty, seeded shuffle
    (seed 123) and the reference's train/valid/test split arithmetic
    (`:61-68`);
  * read `{patient}_{input_name}.mhd` and `{patient}_{condition_name}.mhd`
    via our own MetaImage reader;
  * `seg_parts` splits GT label values into LV(=1)/LA(=3) channels (`:98-101`);
  * transform: nearest resize to `img_res` then random (train) / center crop
    to `img_crop` (`:142-158`);
  * returns (image/255 (H, W, 1), masks (H, W, P), mask_index=0, index) —
    channel-LAST (the reference is channel-first; our batch contract is NHWC).

Clip mode (`single_frame=False`): the reference's temporal-graph source loader
is this same still dataset (`train_camus_echo.py:96-99` — CAMUS 4CH_ED is one
frame; the reference's 5-D unpack of it at `:247` could never run). As in
the JAX package, the still is tiled into a `clip_length`-frame clip:
(T, H, W, 1) image, (T, H, W, P) masks — matching the
`Seg_Cardiac_UDA_Dataset` 2-D-input tiling behavior
(`datasets/cardiac_uda.py:216-221`).
"""

from __future__ import annotations

import glob
import os
import random
from typing import Tuple

import numpy as np

from graphecho_torch.data.formats import read_mhd
from graphecho_torch.data.transforms import resize_and_crop

RANDOM_SEED = 123


class DataLoaderCamus:
    def __init__(self, dataset_path: str, input_name: str = "4CH_ED",
                 target_name: str = "4CH_ED",
                 condition_name: str = "4CH_ED_gt", stage: str = "train",
                 img_res: Tuple[int, int] = (124, 124),
                 img_crop: Tuple[int, int] = (112, 112),
                 seg_parts: bool = True, train_ratio: float = 1.0,
                 valid_ratio: float = 0.2, seed: int = RANDOM_SEED,
                 single_frame: bool = True, clip_length: int = 8):
        self.dataset_path = dataset_path
        self.input_name = input_name
        self.condition_name = condition_name
        self.img_res = img_res
        self.img_crop = img_crop
        self.seg_parts = seg_parts
        self.single_frame = single_frame
        self.clip_length = clip_length
        self.is_train = stage == "train"
        self._rng = np.random.RandomState(seed)

        patients = [d for d in sorted(glob.glob(
            os.path.join(dataset_path, "training", "*"))) if os.listdir(d)]
        random.Random(seed).shuffle(patients)
        num = len(patients)
        num_train = int(num * train_ratio)
        num_valid = int(num_train * valid_ratio)
        splits = {
            "train": patients[num_valid:num_train],
            "valid": patients[: num_valid // 2],
            "test": patients[num_valid // 2: num_valid],
        }
        self.data_list = splits[stage]
        self.num_data = len(self.data_list)

    def __len__(self) -> int:
        return len(self.data_list)

    def _paths(self, patient_dir: str) -> Tuple[str, str]:
        pid = os.path.basename(patient_dir)
        return (os.path.join(patient_dir, f"{pid}_{self.input_name}.mhd"),
                os.path.join(patient_dir, f"{pid}_{self.condition_name}.mhd"))

    def __getitem__(self, index: int):
        path = self.data_list[index]
        input_path, condition_path = self._paths(path)
        while not os.path.exists(input_path):
            index = self._rng.randint(0, self.num_data)
            path = self.data_list[index]
            input_path, condition_path = self._paths(path)

        img = read_mhd(input_path).astype(np.float32)  # (H, W)
        gt = read_mhd(condition_path)

        if self.seg_parts:
            lv = (gt == 1).astype(np.float32)
            la = (gt == 3).astype(np.float32)
            masks = np.stack([lv, la], axis=-1)  # (H, W, 2)
        else:
            masks = gt.astype(np.float32)[..., None]

        img = img[..., None]
        img, masks = resize_and_crop(img, masks, self.img_res, self.img_crop,
                                     self.is_train, self._rng)
        img = img / 255.0
        if not self.single_frame:
            # tile the still into a clip (see module docstring)
            t = self.clip_length
            return (np.broadcast_to(img, (t,) + img.shape).copy(),
                    np.broadcast_to(masks, (t,) + masks.shape).copy(), 0, index)
        return img, masks, 0, index
