"""Small JSON helpers (copy of radzero_tpu/utils/json_io.py; ref
common/utils.py:118-130)."""

from __future__ import annotations

import json
from typing import Any


def load_json(file_path: str, encoding: str = "utf-8") -> Any:
    with open(file_path, "r", encoding=encoding) as f:
        return json.load(f)


def save_json(data: Any, file_path: str, encoding: str = "utf-8", indent: int = 2) -> None:
    with open(file_path, "w", encoding=encoding) as f:
        json.dump(data, f, indent=indent, default=_default)


def _default(o):
    import numpy as np

    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not JSON serializable: {type(o)}")
