"""Synthetic on-disk zero-shot eval datasets, without pandas: the port's copy
of tools/synthetic_eval_data.py.

One builder per dataset of the eval registry and of the merger table (OpenI,
PadChest, ChestXray14, Chexpert, ChestXDet10, MS-CXR, SIIM, RSNA and
CheXpert-5x200), each writing the file names and column / JSON schemas the
reference's harness reads. At their defaults they write byte for byte what
the JAX package's builders write (miniatures: RGB PNGs of (70 + i) x 60).
Given ``sizes`` they write grayscale studies at those sizes with labels,
boxes and masks scaled to them, and SIIM's images can be uncompressed 8-bit
DICOMs (``write_dicom``, a byte-level writer: pydicom is not needed).
``build_all`` writes every dataset over one pool of studies.
"""

from __future__ import annotations

import concurrent.futures as cf
import json
import os
import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np

from radzero_torch.eval._table import write_csv
from radzero_torch.eval.grounding import FINDING_MAPPING
from radzero_torch.eval.mergers import (
    CHESTXDET10_CLASSES,
    CHESTXRAY14_CLASSES,
    CHEXPERT5_CLASSES,
    OPENI_PATHOLOGIES,
)

XDET10_PROMPTS = list(FINDING_MAPPING)  # prompt text -> annotation class
XDET10_CLASSES = CHESTXDET10_CLASSES
SIIM_SIZE = 1024  # SIIM-ACR's DICOMs are 1024 x 1024


def chest_sizes(n: int, seed: int = 0) -> List[Tuple[int, int]]:
    """n distinct non-square (height, width) pairs of chest-film size,
    2000-3000 px a side."""
    rng = np.random.default_rng(seed)
    sizes: List[Tuple[int, int]] = []
    while len(sizes) < n:
        h, w = (int(v) for v in rng.integers(2000, 3001, 2))
        if h != w and (h, w) not in sizes:
            sizes.append((h, w))
    return sizes


def prompt_json(path: str, names) -> None:
    with open(path, "w") as f:
        json.dump({str(i): [f"There is {n}"] for i, n in enumerate(names)}, f)


def image_csv(path: str, n: int) -> None:
    write_csv(path, {"Path": [f"imgs/{i}.png" for i in range(n)]})


def build_images(root: str, n: int = 8, seed: int = 0,
                 sizes: Optional[Sequence[Tuple[int, int]]] = None,
                 compress_level: int = 6, threads: int = 1) -> None:
    """imgs/{i}.png: without ``sizes``, RGB noise of (70+i, 60) (non-square,
    per-image distinct: the inverse-geometry paths see real shapes); with
    ``sizes``, 8-bit grayscale noise of those (height, width). The pixels
    are drawn in order, then encoded on ``threads`` threads."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    d = os.path.join(root, "imgs")
    os.makedirs(d, exist_ok=True)
    arrays = [rng.integers(0, 256, (70 + i, 60, 3) if sizes is None else tuple(sizes[i]),
                           dtype=np.uint8) for i in range(n)]

    def save(i):
        Image.fromarray(arrays[i]).save(os.path.join(d, f"{i}.png"),
                                        compress_level=compress_level)

    with cf.ThreadPoolExecutor(threads) as pool:
        list(pool.map(save, range(n)))


def build_chexpert(root: str, n: int = 8, label_seed: int = 1) -> None:
    d = os.path.join(root, "Chexpert")
    os.makedirs(d, exist_ok=True)
    image_csv(os.path.join(d, "chexpert5_test_image.csv"), n)
    prompt_json(os.path.join(d, "chexpert5_test_text.json"), CHEXPERT5_CLASSES)
    labels = np.random.default_rng(label_seed).integers(0, 2, (n, 5))
    labels[0] = 1  # both classes present in every column (AUC well-defined)
    labels[1] = 0
    write_csv(os.path.join(d, "test_labels.csv"),
              {c: labels[:, j] for j, c in enumerate(CHEXPERT5_CLASSES)})


def build_chestxdet10(root: str, n: int = 8, boxes_per_image: int = 1,
                      scale: int = 1) -> None:
    """Boxes of (5 + 5k, 5 + 5k, 40 - 10k, 40 - 10k), times ``scale``."""
    d = os.path.join(root, "ChestXDet10")
    os.makedirs(d, exist_ok=True)
    image_csv(os.path.join(d, "chestXDet10_test_image.csv"), n)
    prompt_json(os.path.join(d, "chestXDet10_test_text.json"), XDET10_PROMPTS)
    rows = [
        {
            "file_name": f"imgs/{i}.png",
            "syms": [XDET10_CLASSES[(i + 3 * k) % 10] for k in range(boxes_per_image)],
            "boxes": [[scale * v for v in (5 + 5 * k, 5 + 5 * k, 40 - 10 * k, 40 - 10 * k)]
                      for k in range(boxes_per_image)],
        }
        for i in range(n)
    ]
    with open(os.path.join(d, "test.json"), "w") as f:
        json.dump(rows, f)


def build_mscxr(root: str, n: int = 4,
                sizes: Optional[Sequence[Tuple[int, int]]] = None) -> None:
    """Every box covers the whole image ((0, 0, 59, 69) for the default
    miniatures; (0, 0, w - 1, h - 1) of each of ``sizes``), so the pointing
    accuracy must be exactly 1.0."""
    d = os.path.join(root, "MS-CXR")
    os.makedirs(d, exist_ok=True)
    boxes = [[0, 0, 59, 69] if sizes is None else [0, 0, sizes[i][1] - 1, sizes[i][0] - 1]
             for i in range(n)]
    rows = [
        {"image": f"imgs/{i}.png",
         "det": [{"name": f"left lung opacity {i}", "label": [boxes[i]]}]}
        for i in range(n)
    ]
    with open(os.path.join(d, "test.json"), "w") as f:
        json.dump(rows, f)


# --------------------------------------------------------------------------
# DICOM (explicit VR little endian, uncompressed, PS3.5)
# --------------------------------------------------------------------------

_EXPLICIT_LE = "1.2.840.10008.1.2.1"
_LONG_VRS = {b"OB", b"OW", b"SQ", b"UN", b"UT"}


def _element(group: int, elem: int, vr: bytes, value: bytes) -> bytes:
    if len(value) % 2:
        value += b" " if vr in (b"CS", b"IS") else b"\x00"
    head = struct.pack("<HH", group, elem) + vr
    if vr in _LONG_VRS:
        return head + b"\x00\x00" + struct.pack("<I", len(value)) + value
    return head + struct.pack("<H", len(value)) + value


def write_dicom(path: str, pixels: np.ndarray) -> None:
    """A Part-10 file of one uncompressed 8-bit MONOCHROME2 frame."""
    if pixels.dtype != np.uint8 or pixels.ndim != 2:
        raise ValueError(f"want a 2-D uint8 array, got {pixels.dtype} {pixels.shape}")
    rows, cols = pixels.shape
    meta = _element(0x0002, 0x0010, b"UI", _EXPLICIT_LE.encode())
    meta = _element(0x0002, 0x0000, b"UL", struct.pack("<I", len(meta))) + meta
    us = lambda v: struct.pack("<H", v)  # noqa: E731
    body = (_element(0x0028, 0x0002, b"US", us(1))
            + _element(0x0028, 0x0004, b"CS", b"MONOCHROME2")
            + _element(0x0028, 0x0010, b"US", us(rows))
            + _element(0x0028, 0x0011, b"US", us(cols))
            + _element(0x0028, 0x0100, b"US", us(8))
            + _element(0x0028, 0x0103, b"US", us(0))
            + _element(0x7FE0, 0x0010, b"OB", np.ascontiguousarray(pixels).tobytes()))
    with open(path, "wb") as f:
        f.write(b"\x00" * 128 + b"DICM" + meta + body)


def _rect_rle(height: int, width: int, top: int, left: int, h: int, w: int) -> str:
    """SIIM's relative-start, column-major RLE of one rectangle."""
    pairs, pos = [], 0
    for col in range(left, left + w):
        start = col * height + top
        pairs += [start - pos, h]
        pos = start + h
    return " ".join(map(str, pairs))


def build_siim(root: str, n: int = 8, size: Optional[int] = None, seed: int = 0) -> None:
    """SIIM/test.csv (ImageId, dicom_path, " EncodedPixels"; negatives
    " -1"). Without ``size``: the miniatures' imgs/{i}.png and a 6-pixel
    run. With ``size``: SIIM/dcm/{i}.dcm, 8-bit DICOMs of size x size, and
    each positive (even i) has two rows, two rectangles of the image."""
    d = os.path.join(root, "SIIM")
    os.makedirs(d, exist_ok=True)
    if size is None:
        rows = [(f"id{i}", f"imgs/{i}.png", "10 6" if i % 2 == 0 else " -1") for i in range(n)]
    else:
        rng = np.random.default_rng(seed)
        os.makedirs(os.path.join(d, "dcm"), exist_ok=True)
        rows = []
        for i in range(n):
            path = f"SIIM/dcm/{i}.dcm"
            write_dicom(os.path.join(root, path),
                        rng.integers(0, 256, (size, size), dtype=np.uint8))
            if i % 2:
                rows.append((f"id{i}", path, " -1"))
                continue
            for k in range(2):
                top, left = (size // 8) * (1 + k + i % 3), (size // 8) * (1 + 2 * k)
                rows.append((f"id{i}", path, _rect_rle(size, size, top, left,
                                                        size // 8, size // 6)))
    ids, paths, rles = zip(*rows)
    write_csv(os.path.join(d, "test.csv"),
              {"ImageId": ids, "dicom_path": paths, " EncodedPixels": rles})


def build_rsna(root: str, n: int = 8, scale: int = 1) -> None:
    """RSNA/test.csv (img_path, boxes "x;y;w;h", empty for negatives):
    5;5;20;20 times ``scale`` on even i."""
    d = os.path.join(root, "RSNA")
    os.makedirs(d, exist_ok=True)
    box = ";".join(str(scale * v) for v in (5, 5, 20, 20))
    write_csv(os.path.join(d, "test.csv"),
              {"img_path": [f"imgs/{i}.png" for i in range(n)],
               "boxes": [box if i % 2 == 0 else np.nan for i in range(n)]})


def _long_tail_freqs(n: int, per_bucket: int) -> List[int]:
    """Positives per class: head 20 n / 24, medium 13 n / 24, tail 6 (the
    JAX builders' 20 / 13 / 6 at n = 24): every bucket of
    ``long_tail_multi_label_split`` (head above the 65th percentile, tail
    at most 10) holds ``per_bucket`` classes at any n >= 24."""
    return ([round(20 * n / 24)] * per_bucket + [round(13 * n / 24)] * per_bucket
            + [6] * per_bucket)


def build_openi(root: str, n: int = 24) -> None:
    """18 scored pathologies via substring match on labels_automatic
    (eval/mergers.py merge_openi). Frequencies per class index
    (``_long_tail_freqs``): 0-5 head, 6-11 medium, 12-17 tail; substring
    collisions (Granuloma in "calcified granuloma") only add positives,
    never a degenerate all-positive column."""
    d = os.path.join(root, "OpenI")
    os.makedirs(d, exist_ok=True)
    image_csv(os.path.join(d, "openi_multi_label_image.csv"), n)
    prompt_json(os.path.join(d, "openi_multi_label_text.json"), OPENI_PATHOLOGIES[:-1])
    freqs = _long_tail_freqs(n, 6)
    rows = []
    for i in range(n):
        labs = [
            p.lower()
            for j, p in enumerate(OPENI_PATHOLOGIES[:-1])
            if (i + j) % n < freqs[j]
        ]
        rows.append(";".join(labs) if labs else "normal")
    write_csv(os.path.join(d, "custom.csv"), {"labels_automatic": rows})


def build_padchest(root: str, n: int = 24) -> None:
    """Sorted unique label space minus 'normal' (eval/mergers.py
    merge_padchest); prompts follow that sorted order, and 'normal' exists
    in the label space (the merger indexes it)."""
    d = os.path.join(root, "PadChest")
    os.makedirs(d, exist_ok=True)
    image_csv(os.path.join(d, "padchest_multi_label_image.csv"), n)
    pc_classes = [f"c{k:02d}" for k in range(12)]  # sorted by construction
    pc_freqs = _long_tail_freqs(n, 4)
    manual = {}
    for i in range(n):
        labs = [c for j, c in enumerate(pc_classes) if (i + j) % n < pc_freqs[j]]
        manual[f"imgs/{i}.png"] = labs if labs else ["normal"]
    manual["imgs/0.png"] = manual["imgs/0.png"] + ["normal"]
    with open(os.path.join(d, "manual_image.json"), "w") as f:
        json.dump(manual, f)
    prompt_json(os.path.join(d, "padchest_multi_label_text.json"), pc_classes)


def build_chestxray14(root: str, n: int = 8) -> None:
    d = os.path.join(root, "ChestXray14")
    os.makedirs(d, exist_ok=True)
    image_csv(os.path.join(d, "chestxray14_test_image.csv"), n)
    prompt_json(os.path.join(d, "chestxray14_test_text.json"), CHESTXRAY14_CLASSES)
    with open(os.path.join(d, "test_list.txt"), "w") as f:
        for i in range(n):
            labels = [(i + j) % 2 for j in range(len(CHESTXRAY14_CLASSES))]
            f.write(f"imgs/{i}.png " + " ".join(map(str, labels)) + "\n")


def build_chexpert5x200(root: str, n: int = 10) -> None:
    """Chexpert_5x200/chexpert_5x200_newpath.csv (the merger's label file):
    Path and one-hot labels of the five classes (class i % 5)."""
    d = os.path.join(root, "Chexpert_5x200")
    os.makedirs(d, exist_ok=True)
    onehot = np.eye(5, dtype=np.int64)[np.arange(n) % 5]
    write_csv(os.path.join(d, "chexpert_5x200_newpath.csv"),
              {"Path": [f"imgs/{i}.png" for i in range(n)],
               **{c: onehot[:, j] for j, c in enumerate(CHEXPERT5_CLASSES)}})


def build_all(root: str, n: int = 24, seed: int = 0,
              sizes: Optional[Sequence[Tuple[int, int]]] = None,
              siim_size: Optional[int] = None, compress_level: int = 6,
              threads: int = 1) -> str:
    """Every dataset over one imgs/ pool of n studies. With ``sizes`` the
    ChestXDet10 and RSNA boxes scale by the narrowest width over the
    miniatures' 60 and the MS-CXR boxes cover each image; ``siim_size``
    makes SIIM's images DICOMs of that side."""
    scale = 1 if sizes is None else max(1, min(w for _, w in sizes) // 60)
    build_images(root, n=n, seed=seed, sizes=sizes, compress_level=compress_level,
                 threads=threads)
    build_chexpert(root, n=n)
    build_chestxdet10(root, n=n, scale=scale)
    build_mscxr(root, n=n, sizes=sizes)
    build_siim(root, n=n, size=siim_size, seed=seed + 1)
    build_rsna(root, n=n, scale=scale)
    build_openi(root, n=n)
    build_padchest(root, n=n)
    build_chestxray14(root, n=n)
    build_chexpert5x200(root, n=n)
    return root

