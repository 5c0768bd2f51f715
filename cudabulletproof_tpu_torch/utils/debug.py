"""Protocol tracing: step banners and values, off unless asked for, the
port's copy of ``cudabulletproof_tpu/utils/debug.py``.

On with ``BP_TRACE=1`` (``config.TRACE``) or a logger named
``cudabulletproof_tpu_torch`` at DEBUG; the lines go through ``logging``
with the prefix ``[bp]``.  A scalar or point shows its first 8 bytes.
"""
from __future__ import annotations

import logging

import torch

from .. import config

logger = logging.getLogger("cudabulletproof_tpu_torch")


def enabled() -> bool:
    return config.TRACE or logger.isEnabledFor(logging.DEBUG)


def _ensure_handler():
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter("[bp] %(message)s"))
        logger.addHandler(h)
        logger.setLevel(logging.DEBUG)


def banner(title: str) -> None:
    """A step banner, e.g. '=== PROOF GENERATION STEPS ==='."""
    if enabled():
        _ensure_handler()
        logger.debug("=== %s ===", title)


def _head8(data: bytes) -> str:
    return data[:8].hex()


def trace_scalar(label: str, s: int) -> None:
    if enabled():
        _ensure_handler()
        logger.debug("%s: %s...", label,
                     _head8((s % (1 << 256)).to_bytes(32, "little")))


def trace_point(label: str, compressed: bytes) -> None:
    if enabled():
        _ensure_handler()
        logger.debug("%s: %s... (compressed)", label, _head8(compressed))


def trace_vector(label: str, xs, limit: int = 4) -> None:
    if enabled():
        _ensure_handler()
        shown = [hex(x % (1 << 64)) for x in xs[:limit]]
        logger.debug("%s[%d]: %s%s", label, len(xs), ", ".join(shown),
                     ", ..." if len(xs) > limit else "")


def describe_field(a) -> str:
    """The first four elements of a limb tensor [..., 20] (on any device)
    as values mod p."""
    from ..ops import field as F
    arr = torch.as_tensor(a).detach().cpu().numpy()
    flat = arr.reshape(-1, F.L)
    vals = [sum(int(v) << (F.W * i) for i, v in enumerate(row)) % F.P
            for row in flat[:4]]
    return f"fe25519{list(arr.shape[:-1])}: " + ", ".join(hex(v) for v in vals)
