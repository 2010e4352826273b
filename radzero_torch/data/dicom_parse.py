"""Minimal pure-Python DICOM reader (the port's copy of
radzero_tpu/data/dicom_parse.py, so that scoring imports nothing of the JAX
package; JPEG fragments decode through PIL only).

Covers the subset the reference's eval datasets actually use
(segmentation_utils.py:125-133 reads SIIM/RSNA CXR DICOMs):

- Part-10 files (128-byte preamble + ``DICM``) and headerless streams
- Explicit & Implicit VR Little Endian transfer syntaxes
- JPEG-Baseline encapsulated pixel data (1.2.840.10008.1.2.4.50),
  decoded through PIL
- JPEG 2000 (1.2.840.10008.1.2.4.90/.91) via PIL's OpenJPEG binding
- RLE Lossless (1.2.840.10008.1.2.5): built-in PackBits plane decode
- MONOCHROME1/2 photometric interpretation, 8/16-bit, signed/unsigned,
  defined- and undefined-length sequences (skipped)

Exposes :func:`dicom_read` -> (pixel_array, attrs dict). Higher-level
display semantics (convertScaleAbs scaling, MONOCHROME1 inversion) live
in data/dicom.py, matching the reference reader.
"""

from __future__ import annotations

import struct
from typing import BinaryIO, Dict, Tuple

import numpy as np

_IMPLICIT_LE = "1.2.840.10008.1.2"
_EXPLICIT_LE = "1.2.840.10008.1.2.1"
_JPEG_BASELINE = "1.2.840.10008.1.2.4.50"
_J2K_LOSSLESS = "1.2.840.10008.1.2.4.90"
_J2K = "1.2.840.10008.1.2.4.91"
_RLE = "1.2.840.10008.1.2.5"
_SUPPORTED = (
    _IMPLICIT_LE, _EXPLICIT_LE, _JPEG_BASELINE, _J2K_LOSSLESS, _J2K, _RLE
)

# VRs with a 2-byte reserved field and 4-byte length in explicit VR
_LONG_VRS = {b"OB", b"OW", b"OF", b"OL", b"OD", b"SQ", b"UC", b"UR", b"UT", b"UN"}

_UNDEFINED = 0xFFFFFFFF

# tags we keep (group, element) -> name
_KEEP = {
    (0x0002, 0x0010): "TransferSyntaxUID",
    (0x0028, 0x0002): "SamplesPerPixel",
    (0x0028, 0x0004): "PhotometricInterpretation",
    (0x0028, 0x0008): "NumberOfFrames",
    (0x0028, 0x0010): "Rows",
    (0x0028, 0x0011): "Columns",
    (0x0028, 0x0100): "BitsAllocated",
    (0x0028, 0x0103): "PixelRepresentation",
    (0x7FE0, 0x0010): "PixelData",
}


def _read_exact(f: BinaryIO, n: int) -> bytes:
    b = f.read(n)
    if len(b) != n:
        raise ValueError("truncated DICOM stream")
    return b


def _skip_undefined_sq(f: BinaryIO) -> None:
    """Skip an undefined-length sequence: walk items to (FFFE, E0DD)."""
    while True:
        group, elem, length = struct.unpack("<HHI", _read_exact(f, 8))
        if (group, elem) == (0xFFFE, 0xE0DD):  # sequence delimiter
            return
        if (group, elem) == (0xFFFE, 0xE000) and length == _UNDEFINED:
            # undefined-length item: recurse until item delimiter
            while True:
                g2, e2, l2 = struct.unpack("<HHI", _read_exact(f, 8))
                if (g2, e2) == (0xFFFE, 0xE00D):
                    break
                f.seek(l2, 1)
        else:
            f.seek(length, 1)


def _read_encapsulated(f: BinaryIO) -> list:
    """Undefined-length pixel data: Basic Offset Table + fragments."""
    frags = []
    while True:
        group, elem, length = struct.unpack("<HHI", _read_exact(f, 8))
        if (group, elem) == (0xFFFE, 0xE0DD):
            return frags
        if (group, elem) != (0xFFFE, 0xE000):
            raise ValueError(f"unexpected tag in encapsulated data: {group:04x},{elem:04x}")
        frags.append(_read_exact(f, length))


def _parse_elements(f: BinaryIO, explicit: bool, stop_at_pixeldata: bool,
                    attrs: Dict) -> None:
    while True:
        head = f.read(8)
        if len(head) < 8:
            return
        group, elem = struct.unpack("<HH", head[:4])

        if group == 0xFFFE:  # delimiters at top level: shouldn't happen
            continue

        use_explicit = explicit or group == 0x0002  # meta is always explicit
        if use_explicit:
            vr = head[4:6]
            if vr in _LONG_VRS:
                length = struct.unpack("<I", _read_exact(f, 4))[0]
            else:
                vr_len = struct.unpack("<H", head[6:8])[0]
                length = vr_len
        else:
            vr = b"UN"
            length = struct.unpack("<I", head[4:8])[0]

        tag = (group, elem)
        name = _KEEP.get(tag)

        if tag == (0x7FE0, 0x0010):
            if length == _UNDEFINED:
                attrs["PixelDataFragments"] = _read_encapsulated(f)
            else:
                attrs["PixelData"] = _read_exact(f, length)
            if stop_at_pixeldata:
                return
            continue

        if length == _UNDEFINED:  # undefined-length SQ (or UN parsed as SQ)
            _skip_undefined_sq(f)
            continue

        if name is None:
            f.seek(length, 1)
            continue

        data = _read_exact(f, length)
        if name in ("Rows", "Columns", "BitsAllocated", "SamplesPerPixel",
                    "PixelRepresentation"):
            attrs[name] = struct.unpack("<H", data[:2])[0]
        else:
            attrs[name] = data.rstrip(b"\x00 ").decode("ascii", "replace")


def _decode_jpeg_fragment(data: bytes) -> np.ndarray:
    import io

    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(data)))


def _decode_j2k_fragment(data: bytes) -> np.ndarray:
    """JPEG 2000 codestream/JP2 via PIL's OpenJPEG binding (the SIIM/RSNA
    sets are conventionally J2K-heavy in the wild; ref
    segmentation_utils.py:125-133 reads them through pydicom)."""
    import io

    from PIL import Image, features

    if not features.check("jpg_2000"):  # pragma: no cover - env-dependent
        raise NotImplementedError(
            "JPEG 2000 pixel data needs PIL built with OpenJPEG "
            "(pip install pillow with libopenjp2), or install "
            "pydicom + pylibjpeg-openjpeg and read via pydicom"
        )
    return np.asarray(Image.open(io.BytesIO(data)))


def _packbits(data: bytes) -> bytes:
    """PackBits decode (DICOM PS3.5 Annex G.3.1)."""
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        ctrl = data[i]
        i += 1
        if ctrl < 128:                       # literal run of ctrl+1 bytes
            out += data[i : i + ctrl + 1]
            i += ctrl + 1
        elif ctrl > 128:                     # replicate next byte 257-ctrl
            if i < n:
                out += bytes([data[i]]) * (257 - ctrl)
                i += 1
        # ctrl == 128: no-op
    return bytes(out)


def _decode_rle_frame(frag: bytes, rows: int, cols: int, bits: int,
                      spp: int, signed: bool) -> np.ndarray:
    """RLE Lossless frame (PS3.5 Annex G): a 64-byte header of up to 15
    segment offsets, each segment a PackBits-compressed byte plane;
    planes compose big-endian per sample."""
    header = struct.unpack("<16I", frag[:64])
    nseg = header[0]
    bps = bits // 8
    if nseg != spp * bps:
        raise ValueError(f"RLE header advertises {nseg} segments, "
                         f"expected {spp}*{bps}")
    offsets = list(header[1 : 1 + nseg]) + [len(frag)]
    npix = rows * cols
    out = np.zeros((spp, npix), np.uint16 if bps == 2 else np.uint8)
    for s in range(spp):
        for b in range(bps):  # b=0 is the most significant byte plane
            seg = np.frombuffer(
                _packbits(frag[offsets[s * bps + b] : offsets[s * bps + b + 1]]),
                np.uint8, count=npix,
            )
            out[s] |= seg.astype(out.dtype) << (8 * (bps - 1 - b))
    if signed:
        out = out.astype(np.int16 if bps == 2 else np.int8)
    arr = out.reshape(spp, rows, cols)
    return arr[0] if spp == 1 else np.moveaxis(arr, 0, -1)


def dicom_read(path: str) -> Tuple[np.ndarray, Dict]:
    """Parse a DICOM file -> (pixel array (H, W) or (H, W, C), attrs)."""
    attrs: Dict = {}
    with open(path, "rb") as f:
        start = f.read(132)
        if len(start) >= 132 and start[128:132] == b"DICM":
            # file meta group: explicit VR LE until group changes from 0002
            # parse meta by peeking group ids
            while True:
                pos = f.tell()
                head = f.read(8)
                if len(head) < 8:
                    break
                group = struct.unpack("<H", head[:2])[0]
                f.seek(pos)
                if group != 0x0002:
                    break
                _parse_elements_one_meta(f, attrs)
        else:
            f.seek(0)

        ts = attrs.get("TransferSyntaxUID", _IMPLICIT_LE)
        if ts not in _SUPPORTED:
            raise NotImplementedError(
                f"transfer syntax {ts!r} unsupported by the built-in reader "
                "(handles LE, JPEG-baseline, JPEG 2000, RLE); install "
                "pydicom + pylibjpeg plugins for other syntaxes"
            )
        explicit = ts != _IMPLICIT_LE
        _parse_elements(f, explicit, stop_at_pixeldata=True, attrs=attrs)

    # (0028,0008) is authoritative for frame count across ALL syntaxes —
    # fragment counting can't see multi-frame JPEG/J2K (codestreams may
    # span fragments) or multi-frame native data. Fail loudly rather
    # than silently decode frame 0 of a cine/tomo study.
    try:
        n_frames = int(str(attrs.get("NumberOfFrames", "1")).strip() or "1")
    except ValueError:
        n_frames = 1
    if n_frames > 1:
        raise NotImplementedError(
            f"multi-frame DICOM (NumberOfFrames={n_frames}) unsupported "
            "by the built-in reader; install pydicom"
        )

    if "PixelDataFragments" in attrs:
        frags = attrs["PixelDataFragments"]
        # first fragment is the Basic Offset Table (may be empty)
        if ts == _RLE:
            # RLE mandates exactly one fragment per frame (PS3.5 G.2):
            # >1 data fragment means a multi-frame file — fail loudly
            # rather than silently return frame 0
            if len(frags) > 2:
                raise NotImplementedError(
                    f"multi-frame RLE DICOM ({len(frags) - 1} frames) "
                    "unsupported by the built-in reader; install pydicom"
                )
            arr = _decode_rle_frame(
                frags[1] if len(frags) > 1 else frags[0],
                attrs["Rows"], attrs["Columns"],
                attrs.get("BitsAllocated", 8),
                attrs.get("SamplesPerPixel", 1),
                attrs.get("PixelRepresentation", 0) == 1,
            )
        else:
            # JPEG/J2K codestreams may span fragments: join them (only
            # here — the RLE branch never reads the joined payload)
            payload = b"".join(frags[1:]) if len(frags) > 1 else frags[0]
            if ts in (_J2K_LOSSLESS, _J2K):
                arr = _decode_j2k_fragment(payload)
            else:
                arr = _decode_jpeg_fragment(payload)
        if arr.ndim == 3 and attrs.get("SamplesPerPixel", 1) == 1:
            arr = arr[..., 0]
        return arr, attrs

    if "PixelData" not in attrs:
        raise ValueError("no PixelData element found")
    rows, cols = attrs["Rows"], attrs["Columns"]
    bits = attrs.get("BitsAllocated", 8)
    signed = attrs.get("PixelRepresentation", 0) == 1
    spp = attrs.get("SamplesPerPixel", 1)
    if bits == 8:
        dt = np.int8 if signed else np.uint8
    elif bits == 16:
        dt = np.dtype("<i2") if signed else np.dtype("<u2")
    else:
        raise NotImplementedError(f"BitsAllocated={bits}")
    arr = np.frombuffer(attrs["PixelData"], dt, count=rows * cols * spp)
    arr = arr.reshape((rows, cols) if spp == 1 else (rows, cols, spp))
    return arr, attrs


def _parse_elements_one_meta(f: BinaryIO, attrs: Dict) -> None:
    """Parse exactly one file-meta element (always explicit VR LE)."""
    head = _read_exact(f, 8)
    group, elem = struct.unpack("<HH", head[:4])
    vr = head[4:6]
    if vr in _LONG_VRS:
        length = struct.unpack("<I", _read_exact(f, 4))[0]
    else:
        length = struct.unpack("<H", head[6:8])[0]
    data = _read_exact(f, length)
    name = _KEEP.get((group, elem))
    if name:
        attrs[name] = data.rstrip(b"\x00 ").decode("ascii", "replace")
