"""Checkpoint files and their retention (deeplabv3p_tpu/utils/checkpoint.py).

The port writes `.npz` files of the JAX variables tree
(`utils/weights.py`: `to_jax_variables` / `save_npz`), so a checkpoint of
the port loads into `DeepLab` and, through `load_npz`, into the JAX model.
Names encode the metrics (reference `ep{epoch:03d}-loss..-Jaccard..
-val_Jaccard...h5`, train.py:54), and the manager keeps the last 5 epoch
checkpoints, the 2 best-mIOU eval checkpoints and the final one (reference
CheckpointCleanCallBack, common/callbacks.py:11-30). "Last" and "best" are
read off the epoch in the file name, not the file's mtime: two saves within
one timestamp tick would sort in no defined order. Reading flax msgpack
`.ckpt` files is not ported (ROADMAP Queue A item 5).
"""

from __future__ import annotations

import glob
import os
import re
from typing import Any

from deeplabv3p_torch.utils.weights import save_npz


def checkpoint_name(epoch: int, loss: float, jaccard: float, val_metric: float) -> str:
    """Metrics-encoded filename (JAX checkpoint.py:46-53, `.npz` here)."""
    return (
        f"ep{epoch:03d}-loss{loss:.3f}-Jaccard{jaccard:.3f}"
        f"-val_Jaccard{val_metric:.3f}.npz"
    )


class CheckpointManager:
    """Save and retain checkpoints like the reference's callback stack.
    `variables` is a JAX-layout `{'params', 'batch_stats'}` tree."""

    def __init__(self, log_dir: str, max_val_keep: int = 5, max_eval_keep: int = 2):
        self.log_dir = log_dir
        self.max_val_keep = max_val_keep
        self.max_eval_keep = max_eval_keep
        os.makedirs(log_dir, exist_ok=True)

    def save_epoch(self, variables: Any, epoch: int, record: dict) -> str:
        name = checkpoint_name(
            epoch,
            record.get("loss", 0.0),
            record.get("jaccard", 0.0),
            record.get("val_miou", record.get("jaccard", 0.0)),
        )
        path = os.path.join(self.log_dir, name)
        save_npz(path, variables)
        self._clean("ep*.npz", self.max_val_keep)
        return path

    def save_eval_best(self, variables: Any, epoch: int, miou: float) -> str:
        """Best-mIOU eval checkpoint (reference callbacks.py:50-53)."""
        path = os.path.join(self.log_dir, f"eval_ep{epoch:03d}-mIOU{miou:.3f}.npz")
        save_npz(path, variables)
        self._clean("eval_ep*.npz", self.max_eval_keep)
        return path

    def save_final(self, variables: Any) -> str:
        """trained_final (reference train.py:247)."""
        path = os.path.join(self.log_dir, "trained_final.npz")
        save_npz(path, variables)
        return path

    def _clean(self, pattern: str, keep: int) -> None:
        """Keep the `keep` files of `pattern` with the latest epochs. An
        eval-best file is written only when the mIoU improves, so its latest
        epochs are its best."""
        files = sorted(glob.glob(os.path.join(self.log_dir, pattern)), key=_epoch_of)
        for f in files[:-keep] if keep else files:
            os.remove(f)


def _epoch_of(path: str) -> int:
    """The epoch in a checkpoint's name (`ep007-...`, `eval_ep012-...`)."""
    return int(re.match(r"(?:eval_)?ep(\d+)-", os.path.basename(path)).group(1))
