"""Component registries (the port's own copy of radzero_tpu/utils/registry.py).

The reference instantiates loss/model classes via ``eval(name)``
(exp/cxr_pt/model/modeling.py:88, model/__init__.py:17-20) — a quirk
SURVEY.md §7 flags to fix. Here the vision and text encoder factories
register into a named :class:`Registry` and are looked up by string key
(``models/encoders.py``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator


class Registry:
    def __init__(self, name: str):
        self.name = name
        self._entries: Dict[str, Any] = {}

    def register(self, key: str) -> Callable[[Any], Any]:
        def deco(fn):
            self._entries[key] = fn
            return fn

        return deco

    def get(self, key: str) -> Any:
        if key not in self._entries:
            raise KeyError(
                f"Unknown {self.name} component {key!r}; available: {sorted(self._entries)}"
            )
        return self._entries[key]

    def __contains__(self, key: str) -> bool:
        return key in self._entries

    def __iter__(self) -> Iterator[str]:
        return iter(self._entries)

    def keys(self):
        return self._entries.keys()


VISION_ENCODERS = Registry("vision_encoder")
TEXT_ENCODERS = Registry("text_encoder")
