"""Every module's output under flax's name, in flax's order.

The port's counterpart of flax's `model.apply(..., capture_intermediates=
True, mutable=["intermediates"])` followed by
`jax.tree_util.tree_flatten_with_path`, which the diagnostics tools
(`tools/featuremap_check.py`, `tools/convkernel_check.py`) read:

* each module's output is taken by a forward hook on every entry of
  `named_modules()`, the root included;
* its path is the module's name split at the dots, then `__call__`, then
  the index of the call (`[0]` for the first; a module called twice has a
  `[1]`), then the index inside a tuple output (`backbone/__call__/[0]/[1]`
  is the body's skip map);
* flax's wrapper scopes, which the port's modules drop (utils/weights.py),
  come back as children that carry their parent's output, since they
  compute the whole of it: `bn` under a `BatchNorm`, `dw` under a
  `DepthwiseConv`, `ct` under a `ConvTransposeK`;
* flax names a dropout, which has no name in the JAX models, by its class
  and its count in its parent: the port's `dropout`, `dropout4` and
  `dropout5`, `ff_0_dropout` and `ff_1_dropout` come out `Dropout_0` and
  `Dropout_1` in the order the parent made them;
* the order is `tree_flatten_with_path`'s: dict keys sorted at each level,
  so `__call__` comes after capitals and before small letters, and
  `block_10` before `block_2`;
* 4-D maps come out NHWC (the port computes NCHW); inside MobileViT's
  `MultiHeadAttention` the 4-D tensors are tokens by heads, in flax's
  layout already, and every tensor of fewer or more dimensions comes out
  as the module returned it.
"""

from __future__ import annotations

import contextlib
from collections.abc import Iterator

import torch
import torch.nn as nn

from deeplabv3p_torch.models.layers import BatchNorm, ConvTransposeK, DepthwiseConv, Dropout
from deeplabv3p_torch.models.mobilevit import MultiHeadAttention


def _wrapper_scope(module: nn.Module):
    if isinstance(module, BatchNorm):
        return "bn"
    if isinstance(module, DepthwiseConv):
        return "dw"
    if isinstance(module, ConvTransposeK):
        return "ct"
    return None


def _flax_scopes(model: nn.Module) -> dict[str, tuple[str, ...]]:
    """Module name -> its flax scopes, dropouts renamed."""
    scopes = {"": ()}
    for name, module in model.named_modules():
        dropouts = 0
        for child_name, child in module.named_children():
            scope = child_name
            if isinstance(child, Dropout):
                scope, dropouts = f"Dropout_{dropouts}", dropouts + 1
            scopes[f"{name}.{child_name}" if name else child_name] = (*scopes[name], scope)
    return scopes


def _token_modules(model: nn.Module) -> set[str]:
    """Names of the attention modules and of everything inside them."""
    return {f"{name}.{inner}" if inner else name
            for name, m in model.named_modules() if isinstance(m, MultiHeadAttention)
            for inner, _ in m.named_modules()}


def _nhwc(value, maps: bool):
    if isinstance(value, torch.Tensor):
        return value.permute(0, 2, 3, 1) if maps and value.ndim == 4 else value
    if isinstance(value, (tuple, list)):
        return tuple(_nhwc(v, maps) for v in value)
    return value


def _leaves(path: tuple, value) -> Iterator[tuple[tuple, torch.Tensor]]:
    if isinstance(value, torch.Tensor):
        yield path, value
    elif isinstance(value, tuple):
        for i, v in enumerate(value):
            yield from _leaves((*path, f"[{i}]"), v)


def _flatten(tree: dict, path: tuple = ()) -> Iterator[tuple[tuple, torch.Tensor]]:
    for key in sorted(tree):
        node = tree[key]
        if isinstance(node, dict):
            yield from _flatten(node, (*path, key))
        else:  # the module's calls
            for i, out in enumerate(node):
                yield from _leaves((*path, key, f"[{i}]"), out)


@contextlib.contextmanager
def captured(model: nn.Module):
    """Within the block, every forward of `model` records its modules'
    outputs; the list it yields gets `[(path tuple, NHWC tensor), ...]` in
    flax's order when the block ends. Outputs that need a gradient keep it
    (`tools/convkernel_check.py` differentiates through one)."""
    calls: dict[tuple, list] = {}
    order: list[tuple] = []

    def hook_for(scopes: tuple, wrapper, maps: bool):
        def hook(_module, _args, output):
            value = _nhwc(output, maps)
            for path in (scopes, (*scopes, wrapper)) if wrapper else (scopes,):
                if path not in calls:
                    calls[path] = []
                    order.append(path)
                calls[path].append(value)
        return hook

    scopes, tokens = _flax_scopes(model), _token_modules(model)
    handles = [m.register_forward_hook(hook_for(scopes[name], _wrapper_scope(m),
                                                name not in tokens))
               for name, m in model.named_modules()]
    result: list = []
    try:
        yield result
    finally:
        for h in handles:
            h.remove()
        tree: dict = {}
        for path in order:
            node = tree
            for scope in path:
                node = node.setdefault(scope, {})
            node["__call__"] = calls[path]
        result.extend(_flatten(tree))


def intermediates(model: nn.Module, x: torch.Tensor, **kwargs):
    """(model(x, **kwargs), [(path, NHWC tensor), ...] in flax's order)."""
    with captured(model) as flat:
        out = model(x, **kwargs)
    return out, flat
