"""The check that the measured process loaded nothing of JAX or of the
JAX package: top-level module names compared whole, so ``repro_torch``
passes and ``repro`` does not."""

from __future__ import annotations

import sys

__all__ = ["FORBIDDEN", "forbidden_modules"]

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names=None) -> list[str]:
    """The forbidden top-level names among ``names`` (default: every
    module this process has loaded)."""
    names = list(sys.modules) if names is None else names
    tops = {n.split(".", 1)[0] for n in names}
    return sorted(tops.intersection(FORBIDDEN))
