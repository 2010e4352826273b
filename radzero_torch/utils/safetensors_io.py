"""The safetensors format, read and written without the ``safetensors``
package (the card's host does not have it).

A file is an 8-byte little-endian header length N, then N bytes of JSON,
``{name: {"dtype": "F32", "shape": [...], "data_offsets": [begin, end]},
"__metadata__": {str: str}}`` (padded with spaces), then the tensors' raw
little-endian bytes, each at its offsets into that data block.

:func:`iter_tensors` streams a file: one tensor's bytes are read at a
time into a buffer that the returned tensor then owns, so a reader that
keeps what it is given holds one copy of each tensor. numpy has no
bfloat16, so every dtype is decoded with ``torch.frombuffer``.
"""

from __future__ import annotations

import json
import struct
from typing import Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}
_NAMES = {v: k for k, v in DTYPES.items()}


def _read_header(f) -> Tuple[dict, int]:
    """-> (header without ``__metadata__``, file offset of the data block)."""
    (n,) = struct.unpack("<Q", f.read(8))
    header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    return header, 8 + n


def iter_tensors(path: str) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, CPU tensor in its stored dtype), in the order of the data."""
    with open(path, "rb") as f:
        header, start = _read_header(f)
        for name, info in sorted(header.items(), key=lambda kv: kv[1]["data_offsets"][0]):
            if info["dtype"] not in DTYPES:
                raise ValueError(f"{path}: tensor {name!r} has dtype {info['dtype']!r}, "
                                 f"not one of {sorted(DTYPES)}")
            begin, end = info["data_offsets"]
            dtype, shape = DTYPES[info["dtype"]], info["shape"]
            if end == begin:
                yield name, torch.empty(shape, dtype=dtype)
                continue
            buf = bytearray(end - begin)
            f.seek(start + begin)
            if f.readinto(buf) != len(buf):
                raise ValueError(f"{path}: tensor {name!r} runs past the end of the file")
            yield name, torch.frombuffer(buf, dtype=dtype).reshape(shape)


def load_file(path: str) -> Dict[str, torch.Tensor]:
    return dict(iter_tensors(path))


def save_file(tensors: Mapping[str, object], path: str,
              metadata: Optional[Dict[str, str]] = None) -> None:
    """Write torch tensors or numpy arrays, in name order, one after another."""
    items = []
    header: dict = {"__metadata__": dict(metadata)} if metadata else {}
    offset = 0
    for name in sorted(tensors):
        t = tensors[name]
        t = torch.from_numpy(np.ascontiguousarray(t)) if isinstance(t, np.ndarray) else t
        t = t.detach().cpu().contiguous()
        if t.dtype not in _NAMES:
            raise ValueError(f"tensor {name!r}: dtype {t.dtype} has no safetensors name")
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        items.append(t)
        offset += n
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for t in items:
            if t.numel():
                # the tensor's own buffer; bfloat16 (no numpy dtype) viewed as int16
                f.write((t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().data)
