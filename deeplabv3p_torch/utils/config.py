"""Class lists (copy of deeplabv3p_tpu/utils/config.py:get_classes).

Copied rather than imported: importing any `deeplabv3p_tpu` module pulls
in flax and JAX through the package `__init__`.
"""

from __future__ import annotations


def get_classes(classes_path: str) -> list[str]:
    """Load class names, one per line (reference common/utils.py:152-157)."""
    with open(classes_path) as f:
        return [c.strip() for c in f.readlines()]
