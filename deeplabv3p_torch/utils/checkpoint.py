"""Checkpoint files and their retention (deeplabv3p_tpu/utils/checkpoint.py).

The port writes `.npz` files of the JAX variables tree
(`utils/weights.py`: `to_jax_variables` / `save_npz`), so a checkpoint of
the port loads into `DeepLab` and, through `load_npz`, into the JAX model.
Names encode the metrics (reference `ep{epoch:03d}-loss..-Jaccard..
-val_Jaccard...h5`, train.py:54), and the manager keeps the last 5 epoch
checkpoints, the 2 best-mIOU eval checkpoints and the final one (reference
CheckpointCleanCallBack, common/callbacks.py:11-30). "Last" and "best" are
read off the epoch in the file name, not the file's mtime: two saves within
one timestamp tick would sort in no defined order.

Weights in the other packages' formats load and save too:
`load_variables` / `save_variables` read and write the JAX package's
`.ckpt` (flax msgpack of the variables tree, deeplabv3p_tpu/utils/
checkpoint.py:29-43) through the port's own codec (`utils/msgpack.py`), and
`load_weights(path, model)` loads any of `.npz`, `.ckpt` and Keras `.h5`
(`utils/keras_import.py`, h5py imported there) into a model.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Any

import torch.nn as nn

from deeplabv3p_torch.utils import msgpack
from deeplabv3p_torch.utils.weights import (
    from_jax_variables,
    load_npz,
    save_npz,
    to_jax_variables,
)

WEIGHT_SUFFIXES = (".npz", ".ckpt", ".h5")
# model files of the JAX package that the port does not read (its own
# exported program is a `.pt2`, `export/pt2.py`)
UNPORTED_SUFFIXES = {
    ".shlo": "Queue A item 12: a StableHLO artifact needs JAX to run; the port's is .pt2",
    ".tflite": "Queue A item 12",
    ".pb": "Queue A item 12",
}
# an `.onnx` is a program with its weights inside: where the JAX package takes
# none (DeepLab, the deeplab CLI, Runner, train's --weights_path), neither
# does the port
ONNX_REFUSAL = ("an ONNX file is an exported program, not weights, and the JAX package's "
                "DeepLab, deeplab CLI, Runner and train take none either; run it with "
                "deeplabv3p_torch.eval or deeplabv3p_torch.tools.validate_deeplab")


def _sorted_keys(tree: Any) -> Any:
    """The tree with every dict's keys in sorted order, as JAX's
    `tree_map` leaves them, and every named tuple (`export.quantize.
    QuantizedTensor`) a dict of its fields in their order, as flax's
    `to_state_dict` writes one."""
    if isinstance(tree, dict):
        return {k: _sorted_keys(tree[k]) for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {k: _sorted_keys(getattr(tree, k)) for k in tree._fields}
    return tree


def save_variables(path: str, variables: Any) -> None:
    """Write a `{'params', 'batch_stats'}` tree (numpy leaves) as the JAX
    package's `.ckpt`: the bytes its `save_variables` writes, which are
    `flax.serialization.to_bytes` of the tree with its keys sorted (its
    `tree_map` sorts them), whatever order the model's tree has."""
    with open(path, "wb") as f:
        f.write(msgpack.packb(_sorted_keys(variables)))


def load_variables(path: str) -> dict:
    """Read a `.ckpt` into its nested dict (numpy leaves; bfloat16 leaves as
    torch.bfloat16 tensors)."""
    with open(path, "rb") as f:
        tree = msgpack.unpackb(f.read())
    if not isinstance(tree, dict):
        raise msgpack.MsgpackError(f"{path}: a {type(tree).__name__}, not a variables tree")
    return tree


def check_weights_path(path: str) -> None:
    """Raise unless `path` is a weights file the port reads: `.npz`, `.ckpt`
    or `.h5`. The JAX package's exported formats name their ROADMAP item; an
    `.onnx` says where it runs."""
    suffix = os.path.splitext(path)[1]
    if suffix == ".onnx":
        raise NotImplementedError(f"{path}: {ONNX_REFUSAL}")
    if suffix in UNPORTED_SUFFIXES:
        raise NotImplementedError(
            f"{path}: {suffix} is not ported yet (ROADMAP {UNPORTED_SUFFIXES[suffix]}); "
            f"the port reads {', '.join(WEIGHT_SUFFIXES)}")
    if suffix not in WEIGHT_SUFFIXES:
        raise ValueError(f"{path}: expected one of {', '.join(WEIGHT_SUFFIXES)}")


def load_weights(path: str, model: nn.Module) -> None:
    """Load `path` into `model`, strictly: every leaf of an `.npz` or
    `.ckpt` must map to the model and back (`from_jax_variables`). A Keras
    `.h5` loads by layer name into the model's own weights, as the JAX
    package loads it into `model.init`'s variables: a layer the file lacks
    keeps its value (Keras `load_weights(by_name=True)`)."""
    check_weights_path(path)
    suffix = os.path.splitext(path)[1]
    if suffix == ".npz":
        variables = load_npz(path)
    elif suffix == ".ckpt":
        variables = load_variables(path)
    else:
        from deeplabv3p_torch.utils.keras_import import load_keras_h5_weights

        variables = load_keras_h5_weights(path, to_jax_variables(model))
    model.load_state_dict(from_jax_variables(variables, model), strict=True)


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
