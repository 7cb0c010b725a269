"""Generate the CardiacUDA ``infos.npy`` index from a dataset directory (a
copy of `graphecho_tpu/data/infos.py`).

The reference assumes a pre-built ``infos.npy``
(`train_cardiac_uda.py:36-49`) whose effective layout after
``get_dict`` (`datasets/cardiac_uda.py:179-189`) is::

    {pid: {"dataset_name": site,
           "views_images": {view: nii_path},
           "views_labels": {view: nii_path}}}

but it ships no script that creates the file (the README only sketches the
nesting). This module is that missing script: it scans::

    root/<site>/<patient>/**.nii[.gz]

pairing each label file (a stem containing one of ``mask_tokens``, e.g.
``0001_2_gt.nii.gz``) with the image whose stem matches once the token is
stripped, and inferring the view id ('1'-'4') as the LAST standalone 1-4
digit in the stem. Site directory names become ``dataset_name`` verbatim, so
``--set-select Site_G`` etc. keep working unchanged downstream
(`graphecho_torch/data/cardiac_uda.py`). Layouts that differ only need other
``mask_tokens``; anything stranger can assemble the dict by hand — it is a
plain pickled dict via ``np.save``.

CLI::

    python -m graphecho_torch.data.infos --root /data/cardiac_uda \
        --out /data/cardiac_uda/infos.npy [--sites Site_G Site_R] [--dry-run]
"""

from __future__ import annotations

import argparse
import os
import re
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

DEFAULT_MASK_TOKENS = ("gt", "label", "mask", "seg")
_VIEW_RE = re.compile(r"(?<![0-9])([1-4])(?![0-9])")


def _stem(filename: str) -> str:
    base = os.path.basename(filename)
    for ext in (".nii.gz", ".nii"):
        if base.lower().endswith(ext):
            return base[: -len(ext)]
    return os.path.splitext(base)[0]


def _parts(stem: str) -> List[str]:
    return [p for p in re.split(r"[^0-9A-Za-z]+", stem) if p]


def _classify(stem: str, mask_tokens: Tuple[str, ...]):
    """-> (is_mask, normalized_key, view). The key is the stem with mask
    tokens removed, so `0001_2_gt` pairs with image `0001_2`."""
    parts = _parts(stem)
    kept = [p for p in parts if p.lower() not in mask_tokens]
    is_mask = len(kept) != len(parts)
    key = "_".join(kept).lower()
    views = _VIEW_RE.findall(" ".join(kept))
    view = views[-1] if views else None
    return is_mask, key, view


def _nii_files(patient_dir: str) -> List[str]:
    out = []
    for dirpath, _, files in os.walk(patient_dir):
        for f in files:
            if f.lower().endswith((".nii", ".nii.gz")):
                out.append(os.path.join(dirpath, f))
    return sorted(out)


def build_infos(root: str, sites: Optional[Iterable[str]] = None,
                mask_tokens: Tuple[str, ...] = DEFAULT_MASK_TOKENS,
                ) -> Tuple[Dict, List[str]]:
    """Scan ``root/<site>/<patient>/**.nii[.gz]`` into the infos dict the
    CardiacUDA loaders consume. Returns (infos, warnings): every image/label
    that could not be paired or assigned a view produces a warning line
    instead of a silent drop."""
    mask_tokens = tuple(t.lower() for t in mask_tokens)
    infos: Dict = {}
    warnings: List[str] = []
    site_names = sorted(
        d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
    if sites is not None:
        wanted = set(sites)
        missing = wanted - set(site_names)
        if missing:
            warnings.append(f"sites not found under {root}: {sorted(missing)}")
        site_names = [s for s in site_names if s in wanted]

    for site in site_names:
        site_dir = os.path.join(root, site)
        for patient in sorted(os.listdir(site_dir)):
            pdir = os.path.join(site_dir, patient)
            if not os.path.isdir(pdir):
                continue
            images: Dict[str, Tuple[str, Optional[str]]] = {}
            masks: Dict[str, Tuple[str, Optional[str]]] = {}
            for path in _nii_files(pdir):
                is_mask, key, view = _classify(_stem(path), mask_tokens)
                bucket = masks if is_mask else images
                if key in bucket:
                    warnings.append(f"duplicate key '{key}' in {pdir}; "
                                    f"keeping {bucket[key][0]}")
                    continue
                bucket[key] = (path, view)
            views_images: Dict[str, str] = {}
            views_labels: Dict[str, str] = {}
            for key, (ipath, iview) in images.items():
                if key not in masks:
                    warnings.append(f"image without label: {ipath}")
                    continue
                mpath, _ = masks.pop(key)
                if iview is None:
                    warnings.append(f"no view digit (1-4) in stem: {ipath}")
                    continue
                if iview in views_images:
                    warnings.append(f"duplicate view '{iview}' in {pdir}: "
                                    f"{ipath} (kept {views_images[iview]})")
                    continue
                views_images[iview] = os.path.abspath(ipath)
                views_labels[iview] = os.path.abspath(mpath)
            for key, (mpath, _) in masks.items():
                warnings.append(f"label without image: {mpath}")
            if not views_images:
                warnings.append(f"patient with no usable view pairs: {pdir}")
                continue
            infos[f"{site}/{patient}"] = {
                "dataset_name": site,
                "views_images": views_images,
                "views_labels": views_labels,
            }
    return infos, warnings


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True,
                    help="dataset root: root/<site>/<patient>/**.nii[.gz]")
    ap.add_argument("--out", default=None,
                    help="output .npy path (default: <root>/infos.npy)")
    ap.add_argument("--sites", nargs="*", default=None,
                    help="restrict to these site dirs (default: all)")
    ap.add_argument("--mask-tokens", nargs="*", default=None,
                    help=f"stem tokens marking label files "
                         f"(default: {' '.join(DEFAULT_MASK_TOKENS)})")
    ap.add_argument("--dry-run", action="store_true",
                    help="print the summary, write nothing")
    args = ap.parse_args(argv)

    # `--mask-tokens` with zero values means "no stems are labels" — only an
    # OMITTED flag (None) falls back to the defaults.
    tokens = (DEFAULT_MASK_TOKENS if args.mask_tokens is None
              else tuple(args.mask_tokens))
    infos, warnings = build_infos(args.root, sites=args.sites,
                                  mask_tokens=tokens)
    for w in warnings:
        print(f"[make-infos] WARN: {w}")
    per_site: Dict[str, int] = {}
    n_views = 0
    for v in infos.values():
        per_site[v["dataset_name"]] = per_site.get(v["dataset_name"], 0) + 1
        n_views += len(v["views_images"])
    print(f"[make-infos] {len(infos)} patients, {n_views} view pairs, "
          f"per site: {per_site}")
    if not args.dry_run:
        out = args.out or os.path.join(args.root, "infos.npy")
        np.save(out, infos)  # np.load(out, allow_pickle=True).item() restores
        print(f"[make-infos] wrote {out}")
    return 0 if infos else 1


if __name__ == "__main__":
    raise SystemExit(main())
