"""Host-side image processors (decode -> resize -> normalize): the port's
copy of radzero_tpu/data/processing.py (numpy + PIL), so that scoring
imports nothing of the JAX package. The fused C++ resize (``use_native``)
is not carried over; the registry decorator is a local dict.

Rebuilds the reference's processor zoo (exp/cxr_pt/model/processing.py)
without HF processor classes, keeping bit-level semantics where the
similarity-map geometry depends on them (SURVEY.md §7 hard part #1):

- :class:`BlipStyleImageProcessor` — plain bicubic resize to (size,
  size), rescale 1/255, mean/std normalize. This is the XrayDINOv2 path:
  AutoProcessor for the DINOv2 checkpoint adapted to 518x518
  (processing.py:90-91). Resize runs on host PIL (same backend HF uses),
  so outputs match the reference byte-for-byte for uint8 inputs.
- :class:`AspectRatioImageProcessor` — zero-pad to square, then Blip
  path (processing.py:232-259).
- :class:`BitStyleImageProcessor` — shortest-edge resize + center crop
  (BitImageProcessor semantics, processing.py:86-88).
- :class:`M3AEImageProcessor` — CARZero-style grayscale aspect resize +
  pad (cv2 INTER_AREA) + center crop + single-channel normalize
  (processing.py:108-228).

Each processor records its ``geometry`` tag, which the eval harness uses
to invert the mapping when projecting similarity maps back to original
image coordinates (grounding_utils.py:166-261,
segmentation_utils.py:36-122).

Outputs are NHWC float32, the layout the port's towers take.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Union

import numpy as np
from PIL import Image, ImageOps

# BlipImageProcessor defaults (OPENAI CLIP statistics)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

ImageLike = Union[Image.Image, np.ndarray]


def _to_pil_rgb(image: ImageLike) -> Image.Image:
    if isinstance(image, np.ndarray):
        image = Image.fromarray(image)
    return image.convert("RGB")


def _normalize(arr: np.ndarray, mean: Sequence[float], std: Sequence[float]) -> np.ndarray:
    arr = arr.astype(np.float32) / 255.0
    return (arr - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


@dataclass
class BlipStyleImageProcessor:
    """Bicubic resize to (size, size) + rescale + normalize (NHWC out),
    on host PIL: the reference-parity eval path."""

    size: int = 518
    mean: Sequence[float] = CLIP_MEAN
    std: Sequence[float] = CLIP_STD
    geometry: str = "resize"  # inverse: plain bilinear back to (H, W)

    def __call__(self, images: Union[ImageLike, List[ImageLike]]) -> dict:
        if not isinstance(images, list):
            images = [images]
        out = []
        for im in images:
            im = _to_pil_rgb(im).resize((self.size, self.size), Image.Resampling.BICUBIC)
            out.append(_normalize(np.asarray(im), self.mean, self.std))
        return {"pixel_values": np.stack(out)}

    def resize_u8(self, image: ImageLike) -> np.ndarray:
        """The host half of the split pipeline: decode+resize to
        (size, size, 3) u8; rescale+normalise happens ON DEVICE
        (radzero_torch.ops.layers.normalize_pixels). Because the reference pipeline
        also round-trips through u8 after the PIL resize
        (BlipImageProcessor: PIL resize -> u8 -> rescale -> normalize),
        u8-upload + device normalise is bit-identical to __call__ while
        moving 4x fewer bytes host->device."""
        im = _to_pil_rgb(image)
        im = im.resize((self.size, self.size), Image.Resampling.BICUBIC)
        return np.asarray(im, np.uint8)


@dataclass
class AspectRatioImageProcessor(BlipStyleImageProcessor):
    """Zero-pad to square (centered) before the Blip path
    (ref AspectRatioBlipImageProcessor, processing.py:232-259)."""

    geometry: str = "aspect_pad"  # inverse: upsample to padded square, crop

    def __call__(self, images: Union[ImageLike, List[ImageLike]]) -> dict:
        if not isinstance(images, list):
            images = [images]
        padded = [self._pad_to_square(_to_pil_rgb(im)) for im in images]
        return super().__call__(padded)

    @staticmethod
    def _pad_to_square(image: Image.Image, fill=(0, 0, 0)) -> Image.Image:
        w, h = image.size
        if w == h:
            return image
        target = max(w, h)
        left = (target - w) // 2
        top = (target - h) // 2
        return ImageOps.expand(
            image, border=(left, top, target - w - left, target - h - top), fill=fill
        )


@dataclass
class BitStyleImageProcessor:
    """Shortest-edge bicubic resize + center crop (BitImageProcessor
    adapted per processing.py:86-88)."""

    size: int = 518
    mean: Sequence[float] = IMAGENET_MEAN
    std: Sequence[float] = IMAGENET_STD
    geometry: str = "center_crop"  # inverse: -999-filled uncrop

    def __call__(self, images: Union[ImageLike, List[ImageLike]]) -> dict:
        if not isinstance(images, list):
            images = [images]
        out = []
        for im in images:
            im = _to_pil_rgb(im)
            w, h = im.size
            short = min(w, h)
            nw, nh = round(w * self.size / short), round(h * self.size / short)
            im = im.resize((nw, nh), Image.Resampling.BICUBIC)
            left = (nw - self.size) // 2
            top = (nh - self.size) // 2
            im = im.crop((left, top, left + self.size, top + self.size))
            out.append(_normalize(np.asarray(im), self.mean, self.std))
        return {"pixel_values": np.stack(out)}


def aspect_resize_pad(img: np.ndarray, scale: int) -> np.ndarray:
    """CARZero-style grayscale resize: long side -> scale (cv2 INTER_AREA),
    short side zero-padded centered (ref processing.py:182-228)."""
    import cv2

    h, w = img.shape[:2]
    if h >= w:
        new_h, new_w = scale, int(w * (scale / float(h)))
    else:
        new_h, new_w = int(h * (scale / float(w))), scale
    resized = cv2.resize(img, (new_w, new_h), interpolation=cv2.INTER_AREA)
    pad_h, pad_w = scale - new_h, scale - new_w
    top, left = pad_h // 2, pad_w // 2
    return np.pad(
        resized,
        [(top, pad_h - top), (left, pad_w - left)],
        "constant",
        constant_values=0,
    )


@dataclass
class M3AEImageProcessor:
    """CARZero/M3AE path: grayscale -> aspect resize+pad to resize_size ->
    center crop crop_size -> 1-channel normalize, replicated to 3 channels
    (ref processing.py:108-178; augmentation disabled as in :170-174)."""

    resize_size: int = 256
    crop_size: int = 224
    mean: Sequence[float] = (0.4978,)
    std: Sequence[float] = (0.2449,)
    geometry: str = "m3ae"  # inverse: pad+crop composite (seg_utils.py:92-121)

    def __call__(self, images: Union[ImageLike, List[ImageLike]]) -> dict:
        out = []
        if not isinstance(images, list):
            images = [images]
        for im in images:
            if isinstance(im, Image.Image):
                arr = np.asarray(im.convert("L"), np.uint8)
            else:
                arr = im.astype(np.uint8)
                if arr.ndim == 3:
                    arr = np.asarray(Image.fromarray(arr).convert("L"))
            arr = aspect_resize_pad(arr, self.resize_size)
            # to RGB then center crop (inference_transform, processing.py:147-153)
            rgb = np.asarray(Image.fromarray(arr).convert("RGB"))
            top = (self.resize_size - self.crop_size) // 2
            left = (self.resize_size - self.crop_size) // 2
            rgb = rgb[top : top + self.crop_size, left : left + self.crop_size]
            norm = (rgb.astype(np.float32) / 255.0 - self.mean[0]) / self.std[0]
            out.append(norm)
        return {"pixel_values": np.stack(out)}


# name -> processor class, the counterpart of the JAX package's registry
IMAGE_PROCESSORS = {
    "blip": BlipStyleImageProcessor,
    "aspect_ratio_blip": AspectRatioImageProcessor,
    "bit": BitStyleImageProcessor,
    "m3ae": M3AEImageProcessor,
}


def build_image_processor(vision_config: dict):
    """Map vision model_type -> processor (ref load_processor,
    processing.py:17-101): dinov2/XrayDINOv2 -> Blip@img_size (or the
    aspect-ratio variant under keep_aspect_ratio), m3ae -> M3AE."""
    model_type = vision_config.get("model_type", "dinov2")
    img_size = vision_config.get("img_size", 518)
    mean = tuple(vision_config.get("image_mean", CLIP_MEAN))
    std = tuple(vision_config.get("image_std", CLIP_STD))
    if model_type == "m3ae":
        return M3AEImageProcessor()
    if vision_config.get("keep_aspect_ratio", False):
        return AspectRatioImageProcessor(size=img_size, mean=mean, std=std)
    if model_type in ("dinov2", "siglip", "clip", "xrayclip", "sam", "raddino"):
        return BlipStyleImageProcessor(size=img_size, mean=mean, std=std)
    if model_type == "biomedclip":
        return BitStyleImageProcessor(size=img_size, mean=mean, std=std)
    raise NotImplementedError(model_type)
