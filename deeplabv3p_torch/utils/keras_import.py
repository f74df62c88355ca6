"""Keras `.h5` weights <-> the JAX variables tree
(deeplabv3p_tpu/utils/keras_import.py:54-294).

The port's modules carry the flax scopes (`utils/weights.py`), so a Keras
checkpoint of the reference ecosystem maps onto the numpy `{'params',
'batch_stats'}` tree that `to_jax_variables(model)` gives, and back, by the
JAX package's rules: structural containers (`backbone`, `aspp`, `decoder`,
`block_i`, ...) are dropped, the wrapper scopes `bn` / `dw` are stripped,
the rest joins with '_', and a '--' in a scope is a '/' in the Keras name
(MobileNetV3's `expanded_conv_N/squeeze_excite/Conv`).

Weight-level mapping:
  Conv2D          kernel:0 (H,W,Ci,Co)          <-> kernel (same layout)
                  bias:0                        <-> bias
  DepthwiseConv2D depthwise_kernel:0 (H,W,C,1)  <-> dw kernel (H,W,1,C)
  SeparableConv2D depthwise_kernel:0 (H,W,C,1)  <-> sep_dw/dw kernel (H,W,1,C)
                  pointwise_kernel:0 (1,1,Ci,Co) <-> sep_pw kernel
                  bias:0                        <-> sep_pw bias
  Conv2DTranspose kernel:0 (H,W,Co,Ci), flipped <-> ct kernel (H,W,Ci,Co):
                  `k[::-1, ::-1].transpose(0, 1, 3, 2)`, its own inverse
  BatchNorm       gamma/beta <-> scale/bias (params);
                  moving_mean/moving_variance <-> mean/var (batch_stats)
  LayerNorm       gamma/beta <-> scale/bias
  Dense, EinsumDense (MultiHeadAttention's query/key/value/attention_output)
                  kernel:0, bias:0              <-> kernel, bias (same layout)

Files of Keras 3 (no ':0' suffix) and doubled scopes
(`<layer>/<layer>/<sub>/<w>`) read too. h5py is imported inside the
functions: the port imports without it.
"""

from __future__ import annotations

import re
from collections.abc import Mapping
from typing import Any, Iterator

import numpy as np

# the containers and wrapper scopes of the ported models: ResNet's stages
# (`stage2a`) and MobileViT's blocks (`mvit_0`) are containers too
_CONTAINER_RE = re.compile(
    r"^(backbone|aspp|decoder|image_pool_branch|block_\d+|stage\d+[a-z]|se_\d+|mvit_\d+)$")
# 'bn'/'dw' are structural wrapper scopes inside BatchNorm/DepthwiseConv
# modules, 'c' inside MobileViT's ConvBlock and the subpixel head, 'mha'
# around the attention (whose '<block>_attention/query' Keras names come from
# the '--' scopes), 'ct' inside a transpose conv, and 'sep' / 'sep_dw' /
# 'sep_pw' around a SeparableConv2D's halves, which Keras keeps in one layer;
# PeleeNet's 'conv' stays
_WRAPPER_NAMES = frozenset({"bn", "dw", "c", "mha", "ct", "sep", "sep_dw", "sep_pw"})

_PARAM_TO_KERAS = {
    # leaf name -> candidate Keras weight names, in priority order
    "kernel": ("kernel:0", "depthwise_kernel:0"),
    "bias": ("bias:0",),
    "scale": ("gamma:0",),
    "mean": ("moving_mean:0",),
    "var": ("moving_variance:0",),
}
_BN_BIAS = ("beta:0",)
_LEAF_TO_KERAS = {"scale": "gamma:0", "mean": "moving_mean:0", "var": "moving_variance:0"}
# the pointwise half of a SeparableConv2D
_SEP_PW_KERNEL = ("pointwise_kernel:0", "kernel:0")
# Keras `layer.weights` order: the legacy by-name loader is positional
# within a layer, so the datasets and `weight_names` follow it
_KERAS_ORDER = {
    "kernel:0": 0,
    "depthwise_kernel:0": 0,
    "gamma:0": 0,
    "pointwise_kernel:0": 0.5,  # SeparableConv2D: depthwise, pointwise, bias
    "bias:0": 1,
    "beta:0": 1,
    "moving_mean:0": 2,
    "moving_variance:0": 3,
}


def keras_layer_name(path: tuple[str, ...]) -> str:
    """The Keras layer name of a flax module path (without the leaf):
    containers and wrapper scopes dropped, the rest joined with '_', and
    '--' written '/' ('expanded_conv_1--squeeze_excite--Conv' ->
    'expanded_conv_1/squeeze_excite/Conv'). A plain '__' stays."""
    parts = [p for p in path if not _CONTAINER_RE.match(p) and p not in _WRAPPER_NAMES]
    return "_".join(parts).replace("--", "/")


def _flip_transpose_kernel(k: np.ndarray) -> np.ndarray:
    """A Keras Conv2DTranspose kernel (H,W,Co,Ci), stored flipped, <-> the
    flax ConvTranspose kernel (H,W,Ci,Co), unflipped: the same map both ways."""
    return np.ascontiguousarray(k[::-1, ::-1].transpose(0, 1, 3, 2))


def _leaves(tree: Mapping, keys: tuple = ()) -> Iterator[tuple[tuple, Any]]:
    """(key path, leaf) of a nested dict, depth first in insertion order."""
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, (*keys, k))
        else:
            yield (*keys, k), v


def _siblings(variables: Mapping, keys: tuple) -> set:
    node = variables
    for k in keys[:-1]:
        node = node[k]
    return set(node.keys())


def _h5_weight_groups(h5file) -> dict[str, dict[str, np.ndarray]]:
    """{layer name: {weight name: array}} of a Keras h5 file, a whole model's
    (`model_weights`) or `save_weights`' bare one.

    Layer names may hold '/' (h5 nests them), so each dataset
    `<scope...>/<weight>:0` is registered under every '/'-joined prefix of
    its scope, and, where Keras doubled the layer name
    (`<layer>/<layer>/<sub>/<w>`), under the de-doubled scope too."""
    import h5py

    root = h5file["model_weights"] if "model_weights" in h5file else h5file
    layers: dict[str, dict[str, np.ndarray]] = {}

    def collect(name, obj):
        if not isinstance(obj, h5py.Dataset):
            return
        *scope, weight = name.split("/")
        # Keras 3's legacy writer drops the ':0' graph-tensor suffix
        if not weight.endswith(":0"):
            weight += ":0"
        arr = np.asarray(obj)
        for i in range(1, len(scope) + 1):
            layers.setdefault("/".join(scope[:i]), {}).setdefault(weight, arr)
        for i in range(1, len(scope) // 2 + 1):
            if scope[:i] == scope[i:2 * i] and len(scope) > 2 * i:
                key = "/".join(scope[:i] + scope[2 * i:])
                layers.setdefault(key, {}).setdefault(weight, arr)

    root.visititems(collect)
    return layers


def load_keras_h5_weights(h5_path: str, variables: Mapping, strict: bool = False,
                          verbose: bool = False) -> dict:
    """Keras h5 weights into a copy of `variables` (the numpy `{'params',
    'batch_stats'}` tree). strict=False is Keras `load_weights(by_name=True)`:
    a layer missing from the file keeps its value; strict=True raises
    KeyError naming what is missing. A shape mismatch raises ValueError."""
    import h5py

    with h5py.File(h5_path, "r") as f:
        layer_weights = _h5_weight_groups(f)

    replacements: dict[tuple, np.ndarray] = {}
    missing: list[str] = []
    for keys, leaf in _leaves(variables):
        # keys[0] is the collection ('params' | 'batch_stats')
        module_path, leaf_name = keys[1:-1], keys[-1]
        lname = keras_layer_name(module_path)
        group = layer_weights.get(lname)
        if group is None:
            missing.append(f"{lname} ({'/'.join(keys)})")
            continue
        if leaf_name == "bias" and "scale" in _siblings(variables, keys):
            candidates = _BN_BIAS
        elif leaf_name == "kernel" and "sep_pw" in module_path:
            candidates = _SEP_PW_KERNEL
        else:
            candidates = _PARAM_TO_KERAS.get(leaf_name, ())
        src = next((c for c in candidates if c in group), None)
        if src is None:
            missing.append(f"{lname}:{leaf_name}")
            continue
        value = group[src]
        leaf_shape = np.shape(leaf)
        last = module_path[-1] if module_path else None
        if last == "ct" and leaf_name == "kernel":
            value = _flip_transpose_kernel(value)
        if src == "depthwise_kernel:0" or (
            # Keras 3 names the DepthwiseConv2D kernel plain 'kernel' but keeps
            # its (H,W,C,1) layout: transpose on the shapes' evidence
            last == "dw" and src == "kernel:0" and value.ndim == 4
            and value.shape[-1] == 1 and leaf_shape[-2] == 1
            and value.shape != leaf_shape
        ):
            value = value.transpose(0, 1, 3, 2)  # (H,W,C,1) -> (H,W,1,C)
        if value.shape != leaf_shape:
            raise ValueError(f"shape mismatch for {lname}:{leaf_name}: "
                             f"h5 {value.shape} vs model {leaf_shape}")
        replacements[keys] = value.astype(np.asarray(leaf).dtype)
        if verbose:
            print(f"loaded {lname}/{src} -> {'/'.join(keys)}")

    if strict and missing:
        raise KeyError(f"missing weights for: {missing}")

    def rebuild(tree: Mapping, keys: tuple = ()) -> dict:
        return {k: rebuild(v, (*keys, k)) if isinstance(v, Mapping)
                else replacements.get((*keys, k), v) for k, v in tree.items()}

    return rebuild(variables)


def save_keras_h5_weights(h5_path: str, variables: Mapping) -> None:
    """Write the variables tree as a Keras-layout h5, the inverse of
    `load_keras_h5_weights`: `model_weights/<layer>/<layer>/<weight>:0` with
    Keras's weight names and layouts (depthwise kernels back to
    (H,W,C,1)), and the `layer_names` / `weight_names` attributes in the
    order Keras's legacy h5 reader walks."""
    import h5py

    layers: dict[str, dict[str, np.ndarray]] = {}
    for keys, leaf in _leaves(variables):
        module_path, leaf_name = keys[1:-1], keys[-1]
        lname = keras_layer_name(module_path)
        last = module_path[-1] if module_path else None
        if leaf_name == "kernel":
            wname = ("depthwise_kernel:0" if last == "dw" else
                     "pointwise_kernel:0" if "sep_pw" in module_path else "kernel:0")
        elif leaf_name == "bias":
            wname = "beta:0" if "scale" in _siblings(variables, keys) else "bias:0"
        elif leaf_name in _LEAF_TO_KERAS:
            wname = _LEAF_TO_KERAS[leaf_name]
        else:
            continue  # not a Keras weight
        value = np.asarray(leaf)
        if wname == "depthwise_kernel:0":
            value = value.transpose(0, 1, 3, 2)  # (H,W,1,C) -> (H,W,C,1)
        if last == "ct" and leaf_name == "kernel":
            value = _flip_transpose_kernel(value)
        layers.setdefault(lname, {}).setdefault(wname, value)

    with h5py.File(h5_path, "w") as f:
        mw = f.create_group("model_weights")
        mw.attrs["layer_names"] = [n.encode("utf8") for n in layers]
        mw.attrs["backend"] = b"tensorflow"
        # without it Keras's legacy reader takes the file for Keras 1's and
        # converts the layouts
        mw.attrs["keras_version"] = b"2.15.0"
        for lname, weights in layers.items():
            # require_group: a '/' layer name may already be another's group
            g = mw.require_group(lname)
            ordered = sorted(weights, key=lambda w: _KERAS_ORDER.get(w, 9))
            g.attrs["weight_names"] = [f"{lname}/{w}".encode("utf8") for w in ordered]
            for wname in ordered:
                g.create_dataset(f"{lname}/{wname}", data=weights[wname])
