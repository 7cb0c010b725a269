"""Medical image format readers (dependency-free numpy implementations), a
copy of `graphecho_tpu/data/formats.py`.

The reference delegates decoding to SimpleITK (`datasets/camus.py:110-112`,
CAMUS `.mhd`/`.raw` MetaImage) and nibabel (`datasets/cardiac_uda.py:81-97`,
CardiacUDA `.nii.gz` NIfTI-1). Both formats are simple enough to read
directly — a text header plus a raw binary blob — so we parse them with
numpy, gzip and zlib and need neither library. Writers are provided for test
fixtures.
"""

from __future__ import annotations

import gzip
import os
import struct
import zlib
from typing import Dict

import numpy as np

# ------------------------------------------------------------------ MetaImage
_MET_TYPES = {
    "MET_UCHAR": np.uint8, "MET_CHAR": np.int8,
    "MET_USHORT": np.uint16, "MET_SHORT": np.int16,
    "MET_UINT": np.uint32, "MET_INT": np.int32,
    "MET_FLOAT": np.float32, "MET_DOUBLE": np.float64,
}
_MET_NAMES = {v: k for k, v in _MET_TYPES.items()}


def read_mhd(path: str) -> np.ndarray:
    """Read a MetaImage (.mhd + .raw / .zraw) volume.

    Returns the array with axes (z, y, x) for 3-D / (y, x) for 2-D, matching
    `skimage.io.imread(..., plugin='simpleitk')` as used by the reference
    (`camus.py:110-112` then `.squeeze()`)."""
    header: Dict[str, str] = {}
    with open(path, "r") as f:
        for line in f:
            if "=" not in line:
                continue
            k, v = line.split("=", 1)
            header[k.strip()] = v.strip()

    ndims = int(header["NDims"])
    dims = [int(x) for x in header["DimSize"].split()][:ndims]  # x y [z]
    dtype = _MET_TYPES[header["ElementType"]]
    n_channels = int(header.get("ElementNumberOfChannels", "1"))
    data_file = header.get("ElementDataFile", "LOCAL")
    compressed = header.get("CompressedData", "False").lower() == "true"

    if data_file == "LOCAL":
        raise ValueError("inline MetaImage data not supported")
    raw_path = os.path.join(os.path.dirname(path), data_file)
    with open(raw_path, "rb") as f:
        blob = f.read()
    if compressed:
        blob = zlib.decompress(blob)
    arr = np.frombuffer(blob, dtype=dtype)
    shape = list(reversed(dims))  # file order is x-fastest -> numpy (z, y, x)
    if n_channels > 1:
        shape = shape + [n_channels]
    return arr.reshape(shape).squeeze()


def write_mhd(path: str, arr: np.ndarray) -> None:
    """Write a (z, y, x) / (y, x) array as .mhd + .raw (test fixtures)."""
    arr = np.ascontiguousarray(arr)
    dims = list(reversed(arr.shape))
    base = os.path.splitext(os.path.basename(path))[0]
    raw_name = base + ".raw"
    with open(path, "w") as f:
        f.write("ObjectType = Image\n")
        f.write(f"NDims = {arr.ndim}\n")
        f.write(f"DimSize = {' '.join(str(d) for d in dims)}\n")
        f.write(f"ElementType = {_MET_NAMES[arr.dtype.type]}\n")
        f.write(f"ElementDataFile = {raw_name}\n")
    arr.tofile(os.path.join(os.path.dirname(path), raw_name))


# -------------------------------------------------------------------- NIfTI-1
_NIFTI_DTYPES = {2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32,
                 64: np.float64, 256: np.int8, 512: np.uint16, 768: np.uint32}
_NIFTI_CODES = {np.dtype(v): k for k, v in _NIFTI_DTYPES.items()}


def read_nifti(path: str) -> np.ndarray:
    """Read a .nii / .nii.gz volume; returns data in (x, y, z, ...) axis order
    like `np.array(nib.load(p).dataobj)` in the reference
    (`cardiac_uda.py:81-82`)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        blob = f.read()
    sizeof_hdr = struct.unpack("<i", blob[:4])[0]
    if sizeof_hdr != 348:
        raise ValueError(f"not a NIfTI-1 file: sizeof_hdr={sizeof_hdr}")
    dim = struct.unpack("<8h", blob[40:56])
    ndim = dim[0]
    shape = dim[1:1 + ndim]
    datatype = struct.unpack("<h", blob[70:72])[0]
    vox_offset = int(struct.unpack("<f", blob[108:112])[0])
    scl_slope = struct.unpack("<f", blob[112:116])[0]
    scl_inter = struct.unpack("<f", blob[116:120])[0]
    dtype = _NIFTI_DTYPES[datatype]
    count = int(np.prod(shape))
    arr = np.frombuffer(blob, dtype=dtype, count=count, offset=vox_offset)
    # NIfTI stores x-fastest; numpy C-order reshape of reversed dims then
    # transpose gives (x, y, z) indexing like nibabel's dataobj
    arr = arr.reshape(tuple(reversed(shape))).transpose(
        tuple(range(ndim - 1, -1, -1)))
    if scl_slope not in (0.0, 1.0):
        arr = arr * scl_slope + scl_inter
    return np.asarray(arr)


def write_nifti(path: str, arr: np.ndarray) -> None:
    """Write an (x, y, z)-indexed array as .nii.gz (test fixtures)."""
    arr = np.asarray(arr)
    hdr = bytearray(352)  # 348 header + 4 extension bytes
    struct.pack_into("<i", hdr, 0, 348)
    dims = [arr.ndim] + list(arr.shape) + [1] * (7 - arr.ndim)
    struct.pack_into("<8h", hdr, 40, *dims)
    struct.pack_into("<h", hdr, 70, _NIFTI_CODES[arr.dtype])
    struct.pack_into("<h", hdr, 72, arr.dtype.itemsize * 8)
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)  # scl_slope
    hdr[344:348] = b"n+1\x00"
    # data in x-fastest order: transpose to reversed axes then C-ravel
    data = arr.transpose(tuple(range(arr.ndim - 1, -1, -1))).tobytes()
    with gzip.open(path, "wb") as f:
        f.write(bytes(hdr) + data)
