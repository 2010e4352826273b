"""Process-0-gated experiment logging (port of radzero_tpu/utils/logging.py).

Rebuilds the behavior of the reference logger (common/utils.py:65-115):
a stdout logger whose records carry a ``[timestamp LEVEL]`` prefix, that
only emits on the main process, and that can additionally mirror to a
per-experiment ``output.log`` file.

The multi-process gate reads the rank that ``torch.distributed``
launchers export (``RANK``, else ``LOCAL_RANK``; 0 when neither is set),
so it needs no initialised process group.
"""

from __future__ import annotations

import logging
import os
import sys
from datetime import datetime


def _is_main_process() -> bool:
    for var in ("RANK", "LOCAL_RANK"):
        value = os.environ.get(var)
        if value is not None:
            try:
                return int(value) == 0
            except ValueError:
                return True
    return True


class TimestampPrefixFilter(logging.Filter):
    """Prefix every record with '[YYYY-mm-dd HH:MM:SS LEVEL]' (ref common/utils.py:65-73)."""

    def filter(self, record: logging.LogRecord) -> bool:
        now = datetime.now().strftime("%Y-%m-%d %H:%M:%S")
        record.msg = f"[{now} {record.levelname}] {record.msg}"
        record.args = ()
        return True


class MainProcessFilter(logging.Filter):
    """Drop records on non-zero processes (ref common/utils.py:77-85)."""

    def filter(self, record: logging.LogRecord) -> bool:
        return _is_main_process()


def load_logger(name: str = "radzero_torch", level: int = logging.INFO) -> logging.Logger:
    logger = logging.getLogger(name)
    if getattr(logger, "_radzero_configured", False):
        return logger
    logger.setLevel(level)
    logger.propagate = False
    handler = logging.StreamHandler(sys.stdout)
    handler.setFormatter(logging.Formatter("%(message)s"))
    logger.addHandler(handler)
    logger.addFilter(TimestampPrefixFilter())
    logger.addFilter(MainProcessFilter())
    logger._radzero_configured = True  # type: ignore[attr-defined]
    return logger


def set_logger_file(filepath: str, logger: logging.Logger) -> None:
    """Mirror the logger to a file (ref common/utils.py:109-115)."""
    os.makedirs(os.path.dirname(filepath), exist_ok=True)
    logger.addHandler(logging.FileHandler(filepath, mode="a"))


logger = load_logger()
