"""Class lists, data lists and class-weight files (copy of
deeplabv3p_tpu/utils/config.py, pinned equal to it by the port's tests).

Copied rather than imported: importing any `deeplabv3p_tpu` module pulls
in flax and JAX through the package `__init__`.
"""

from __future__ import annotations

import numpy as np


def get_classes(classes_path: str) -> list[str]:
    """Load class names, one per line (reference common/utils.py:152-157)."""
    with open(classes_path) as f:
        return [c.strip() for c in f.readlines()]


def get_data_list(data_list_file: str, shuffle: bool = True) -> list[str]:
    """Load sample-id list; deterministic shuffle with seed 10101
    (reference common/utils.py:160-170)."""
    with open(data_list_file) as f:
        lines = [line.strip() for line in f.readlines()]
    if shuffle:
        rng = np.random.RandomState(10101)
        rng.shuffle(lines)
    return lines


def calculate_weights_labels(dataset, num_classes: int, save_path=None):
    """Static 'balanced' class weights over a whole dataset:
    total / (num_classes * bincount) (reference common/utils.py:92-126).
    `dataset` yields (images, labels, ...) host batches."""
    class_counts = np.zeros((num_classes,), np.float64)
    for batch in dataset.epoch_batches():
        y = batch[1]
        mask = (y >= 0) & (y < num_classes)
        class_counts += np.bincount(
            y[mask].astype(np.int64), minlength=num_classes
        )
    total_count = class_counts.sum()
    with np.errstate(divide="ignore"):
        class_weights = total_count / (num_classes * class_counts)
    if save_path:
        save_class_weights(save_path, class_weights)
    return class_weights


def save_class_weights(save_path: str, class_weights) -> None:
    """(reference common/utils.py:129-137)"""
    with open(save_path, "w") as f:
        for w in list(class_weights):
            f.write(f"{w}\n")


def load_class_weights(classes_weights_path: str) -> np.ndarray:
    """(reference common/utils.py:140-149)"""
    with open(classes_weights_path) as f:
        return np.array([float(c.strip()) for c in f.readlines()])
