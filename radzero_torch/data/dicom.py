"""Medical image decoding (DICOM + generic) for scoring: the port's copy of
radzero_tpu/data/dicom.py.

Rebuilds inference/dataset.py:19-51 and segmentation_utils.py:125-133:
- DICOM: pixel array scaled so max -> 255 (convertScaleAbs semantics),
  MONOCHROME1 photometric inversion, RGB conversion;
- generic decode + cv2 min-max normalisation to uint8 (the 'PadChest
  fix' every inference collate applies).

DICOM parsing uses pydicom when installed, else the built-in pure-
Python reader (data/dicom_parse.py: explicit/implicit VR LE +
JPEG-baseline encapsulated — the syntaxes the SIIM/RSNA CXR sets use).
"""

from __future__ import annotations

import numpy as np
from PIL import Image


def _read_pixels(img_path: str):
    """-> (pixel_array, photometric_interpretation str)."""
    try:
        import pydicom

        dcm = pydicom.dcmread(img_path)
        return dcm.pixel_array, getattr(dcm, "PhotometricInterpretation", "")
    except ImportError:
        from radzero_torch.data.dicom_parse import dicom_read

        arr, attrs = dicom_read(img_path)
        return arr, attrs.get("PhotometricInterpretation", "")


def read_from_dicom(img_path: str) -> Image.Image:
    x, photometric = _read_pixels(img_path)
    # cv2.convertScaleAbs(x, alpha=255/max): scale, round, clip to uint8
    alpha = 255.0 / float(x.max()) if x.max() > 0 else 1.0
    x = np.clip(np.round(np.abs(x.astype(np.float64) * alpha)), 0, 255).astype(np.uint8)
    if photometric == "MONOCHROME1":
        x = 255 - x  # bitwise_not on uint8
    return Image.fromarray(x).convert("RGB")


def load_eval_image(path: str) -> Image.Image:
    """dcm -> DICOM reader, else PIL (ref inference/dataset.py:19-25)."""
    if path.endswith("dcm"):
        return read_from_dicom(path)
    return Image.open(path)


def minmax_normalize_uint8(image) -> Image.Image:
    """cv2.NORM_MINMAX to [0, 255] uint8 (ref inference/dataset.py:36-43)."""
    arr = np.asarray(image).astype(np.float64)
    lo, hi = arr.min(), arr.max()
    if hi > lo:
        arr = (arr - lo) * (255.0 / (hi - lo))
    else:
        arr = np.zeros_like(arr)
    return Image.fromarray(np.round(arr).astype(np.uint8))
