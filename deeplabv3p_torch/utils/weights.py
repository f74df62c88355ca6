"""Weight bridge between the JAX variables tree and the port's modules.

The JAX package keeps `{'params': ..., 'batch_stats': ...}` as nested
dicts keyed by flax scope. `from_jax_variables` turns that tree (numpy
leaves) into the port's `state_dict`:

* conv kernel HWIO -> OIHW, depthwise (kh,kw,1,C) -> (C,1,kh,kw), and a
  transpose conv's flax kernel (kh,kw,in,out) -> the (out,in,kh,kw) weight
  of its correlation (`layers.ConvTransposeK`): all `transpose(3, 2, 0, 1)`;
* BN scale/bias/mean/var -> weight/bias/running_mean/running_var;
* LayerNorm scale/bias -> weight/bias;
* Dense and DenseGeneral kernels ((in, out), (C, H, Dk) or (H, Dk, C)) and
  biases as they are: the port keeps them in flax's layout;
* flax's wrapper scopes `dw`, `bn` and `ct` are dropped from the names
  (`up6/ct/kernel` is `up6.weight`); `SeparableConv`'s `sep_dw/dw` and
  `sep_pw` and `Subpixel`'s `c` are modules of their own, so
  `down0_conv0/sep_dw/dw/kernel` is `down0_conv0.sep_dw.weight` and
  `subpixel/c/kernel` is `subpixel.c.weight`.

The mapping is built from the model's own modules and is strict: a leaf
left over on either side, or a shape that differs, raises.

`save_npz` / `load_npz` store the tree flattened to `params/.../kernel`
paths in a numpy `.npz`, so weights travel between the packages without
h5py.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any

import numpy as np
import torch
import torch.nn as nn

from deeplabv3p_torch.models.layers import (
    BatchNorm,
    Conv,
    ConvTransposeK,
    Dense,
    DepthwiseConv,
    LayerNorm,
)

_BN_LEAVES = (
    ("params", "scale", "weight"),
    ("params", "bias", "bias"),
    ("batch_stats", "mean", "running_mean"),
    ("batch_stats", "var", "running_var"),
)


def flatten(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dict -> {'a/b/c': array}."""
    flat = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, Mapping):
            flat.update(flatten(value, path))
        else:  # torch tensors stay (a `.ckpt`'s bfloat16 leaves, utils/msgpack.py)
            flat[path] = value if isinstance(value, torch.Tensor) else np.asarray(value)
    return flat


def unflatten(flat: Mapping[str, Any]) -> dict:
    """{'a/b/c': array} -> nested dict."""
    tree: dict = {}
    for path, value in flat.items():
        node = tree
        *scopes, leaf = path.split("/")
        for s in scopes:
            node = node.setdefault(s, {})
        node[leaf] = value
    return tree


def jax_path_table(model: nn.Module) -> dict[str, tuple[str, bool]]:
    """flax leaf path -> (state_dict key, is a conv kernel to transpose)."""
    table = {}
    for name, m in model.named_modules():
        scope = name.replace(".", "/")
        if isinstance(m, BatchNorm):
            for coll, flax_leaf, torch_leaf in _BN_LEAVES:
                table[f"{coll}/{scope}/bn/{flax_leaf}"] = (f"{name}.{torch_leaf}", False)
        elif isinstance(m, Conv):
            wrapper = ("dw" if isinstance(m, DepthwiseConv) else
                       "ct" if isinstance(m, ConvTransposeK) else "")
            inner = f"{scope}/{wrapper}" if wrapper else scope
            table[f"params/{inner}/kernel"] = (f"{name}.weight", True)
            if m.bias is not None:
                table[f"params/{inner}/bias"] = (f"{name}.bias", False)
        elif isinstance(m, (Dense, LayerNorm)):
            leaf = "kernel" if isinstance(m, Dense) else "scale"
            table[f"params/{scope}/{leaf}"] = (f"{name}.weight", False)
            table[f"params/{scope}/bias"] = (f"{name}.bias", False)
    return table


def flax_module_paths(model: nn.Module) -> dict[str, str]:
    """flax path of each module that holds parameters (`nn.Conv`, the
    `bn` inside a BatchNorm scope, `dw` inside a depthwise one, `Dense`,
    `LayerNorm`) -> the name of the port's module that holds them, from
    `jax_path_table`."""
    return {path.split("/", 1)[1].rsplit("/", 1)[0]: key.rsplit(".", 1)[0]
            for path, (key, _) in jax_path_table(model).items()}


def _strict(what: str, left: set, right: set, lname: str, rname: str) -> None:
    only_l, only_r = sorted(left - right), sorted(right - left)
    if only_l or only_r:
        raise KeyError(
            f"{what}: {len(only_l)} only in {lname} {only_l[:5]}, "
            f"{len(only_r)} only in {rname} {only_r[:5]}"
        )


def from_jax_variables(variables: Mapping, model: nn.Module) -> dict[str, torch.Tensor]:
    """JAX `{'params', 'batch_stats'}` tree (numpy leaves, or torch tensors
    such as a `.ckpt`'s bfloat16 ones) -> f32 `state_dict` for `model`.
    Raises on any leaf missing or left over on either side, or any shape
    mismatch."""
    table = jax_path_table(model)
    flat = flatten(variables)
    _strict("JAX variables vs port model", set(flat), set(table), "JAX", "port")
    target = model.state_dict()
    _strict("port mapping vs state_dict", {k for k, _ in table.values()},
            set(target), "mapping", "state_dict")
    out = {}
    for path, (key, is_kernel) in table.items():
        a = flat[path]
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
        if is_kernel:
            t = t.permute(3, 2, 0, 1)
        if tuple(t.shape) != tuple(target[key].shape):
            raise ValueError(
                f"{path} -> {key}: shape {tuple(t.shape)} != "
                f"{tuple(target[key].shape)}"
            )
        # a copy: the state dict shares no memory with the caller's arrays
        out[key] = t.to(torch.float32, memory_format=torch.contiguous_format, copy=True)
    return out


def to_jax_variables(model: nn.Module) -> dict:
    """The model's weights as a JAX-layout `{'params', 'batch_stats'}` tree
    of numpy arrays (the inverse of `from_jax_variables`). The arrays are
    copies: for f32 CPU tensors `.numpy()` shares the parameters' memory, so
    a later write to the model (`Trainer.eval_variables` swapping averaged
    weights back out) would show through."""
    sd = model.state_dict()
    flat = {}
    for path, (key, is_kernel) in jax_path_table(model).items():
        a = sd[key].detach().float().cpu().numpy()
        flat[path] = np.array(a.transpose(2, 3, 1, 0) if is_kernel else a)
    return unflatten(flat)


def inverted_residual_kernel_args(
    variables: Mapping, block_id: int, epsilon: float = 1e-3
) -> tuple[np.ndarray, ...]:
    """(we, se, be, wd, sd, bd, wp, sp, bp) of `fused_inverted_residual`
    from the JAX variables of one MobileNetV2 block (`block_id` >= 1, the
    blocks that have an expand conv): the flax 1x1 kernels (1,1,Cin,Cout)
    as (Cin, Cout) matrices, the depthwise kernel (3,3,1,C) as (3,3,C), and
    each BN folded to scale = gamma / sqrt(var + epsilon), bias = beta -
    mean * scale, in f32. The port's `InvertedResBlock.kernel_args` gives
    the same numbers from the same weights."""
    prefix = f"expanded_conv_{block_id}_"
    params = variables["params"]["backbone"][f"block_{block_id}"]
    stats = variables["batch_stats"]["backbone"][f"block_{block_id}"]

    def fold(name):
        p, s = params[prefix + name]["bn"], stats[prefix + name]["bn"]
        scale = np.asarray(p["scale"], np.float32) / np.sqrt(
            np.asarray(s["var"], np.float32) + np.float32(epsilon))
        return scale, np.asarray(p["bias"], np.float32) - np.asarray(s["mean"], np.float32) * scale

    we = np.asarray(params[prefix + "expand"]["kernel"], np.float32)[0, 0]
    wd = np.asarray(params[prefix + "depthwise"]["dw"]["kernel"], np.float32)[:, :, 0, :]
    wp = np.asarray(params[prefix + "project"]["kernel"], np.float32)[0, 0]
    return (we, *fold("expand_BN"), wd, *fold("depthwise_BN"), wp, *fold("project_BN"))


def save_npz(path: str, variables: Mapping) -> None:
    """Save a variables tree as an .npz of flattened `params/.../kernel` paths."""
    np.savez(path, **flatten(variables))


def load_npz(path: str) -> dict:
    """Load an .npz written by `save_npz` back into a nested tree."""
    with np.load(path) as data:
        return unflatten({k: data[k] for k in data.files})
