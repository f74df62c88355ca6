"""Post-training int8 quantization (deeplabv3p_tpu/export/quantize.py; the
reference's tools/model_converter/post_train_quant_convert.py:20-57).

Storage: `post_train_quantize` turns every conv and dense kernel of the
JAX-layout params tree (numpy leaves, `utils.weights.to_jax_variables`)
into a `QuantizedTensor` of symmetric per-output-channel int8 values and
f32 scales, with the JAX package's numpy arithmetic, so the two give the
same bits; `dequantize_params` maps back to f32.

Calibration: `calibrate_activations` records each parameter-holding
module's output (min, max) and `calibrate_conv_inputs` each eligible
pointwise conv's input absmax over representative batches, by forward
hooks, under the flax module paths the JAX package uses as keys
(`utils.weights.flax_module_paths`).

Execution: `make_int8_apply` returns a copy of the model whose eligible
convs (ungrouped 1x1, stride 1, undilated, calibrated) are
`Int8PointwiseConv`s: the input rounded to int8 at its calibrated static
scale, the weights to int8 once at their per-output-channel scales, the
product int8 x int8 -> int32 in `torch._int_mm`, then rescaled in f32 and
biased, as quantize.py:201-231 computes it. `torch._int_mm` on the card
wants more than 16 rows and inner and output sizes that are multiples of
8; the rows, the channels and the weights are padded with zeros to that,
which adds nothing to the product. A conv that the fused ASPP or decoder
calls functionally (`models.layers._fold_pointwise`) is not called as a
module, is not calibrated, and stays in float, as the JAX interceptor
leaves the functional `jnp.dot` of its fused paths.
"""

from __future__ import annotations

import copy
from collections.abc import Mapping
from typing import Any, Iterable, NamedTuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from deeplabv3p_torch.models.layers import Conv, ConvTransposeK, DepthwiseConv
from deeplabv3p_torch.utils.weights import flax_module_paths


class QuantizedTensor(NamedTuple):
    values: Any  # int8 values
    scale: Any  # f32 per-channel scale


def _quantize_kernel(kernel) -> QuantizedTensor:
    """Symmetric per-output-channel int8 quant for (H, W, Ci, Co)."""
    k = np.asarray(kernel, np.float32)
    axes = tuple(range(k.ndim - 1))
    absmax = np.maximum(np.abs(k).max(axis=axes), 1e-8)
    scale = (absmax / 127.0).astype(np.float32)
    values = np.clip(np.round(k / scale), -127, 127).astype(np.int8)
    return QuantizedTensor(values=values, scale=scale)


def _dequantize_kernel(q: QuantizedTensor) -> np.ndarray:
    return q.values.astype(np.float32) * q.scale


def _as_array(leaf) -> np.ndarray:
    """A leaf as numpy (a `.ckpt`'s bfloat16 leaves are torch tensors)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().float().cpu().numpy()
    return np.asarray(leaf)


def post_train_quantize(params: Mapping) -> tuple[dict, dict]:
    """Quantize all conv/dense kernels (leaves named `kernel` of 2 or more
    dimensions) to int8; other leaves pass through.

    Returns (params with QuantizedTensor leaves, stats dict)."""
    stats = {"quantized_kernels": 0, "fp32_bytes": 0, "int8_bytes": 0}

    def visit(tree):
        out = {}
        for key in sorted(tree):
            leaf = tree[key]
            if isinstance(leaf, Mapping):
                out[key] = visit(leaf)
                continue
            arr = _as_array(leaf)
            if key == "kernel" and arr.ndim >= 2:
                q = _quantize_kernel(arr)
                stats["quantized_kernels"] += 1
                stats["fp32_bytes"] += arr.size * 4
                stats["int8_bytes"] += q.values.size + q.scale.size * 4
                leaf = q
            out[key] = leaf
        return out

    qparams = visit(params)
    stats["compression"] = (stats["fp32_bytes"] / stats["int8_bytes"]
                            if stats["int8_bytes"] else 1.0)
    return qparams, stats


def dequantize_params(qparams: Mapping) -> dict:
    """Reverse of post_train_quantize for accuracy evaluation."""
    return {key: (_dequantize_kernel(leaf) if isinstance(leaf, QuantizedTensor)
                  else dequantize_params(leaf) if isinstance(leaf, Mapping) else leaf)
            for key, leaf in qparams.items()}


def _is_pointwise_conv(module: nn.Module) -> bool:
    """Eligible for int8: an ungrouped 1x1 stride-1 undilated conv, a pure
    channel-mixing product (quantize.py:136-147)."""
    return (isinstance(module, Conv)
            and not isinstance(module, (DepthwiseConv, ConvTransposeK))
            and tuple(module.weight.shape[-2:]) == (1, 1)
            and module.strides == 1 and module.groups == 1 and module.rate == 1)


def _run(model: nn.Module, batches: Iterable, hooks: dict) -> None:
    """One inference forward a batch with `hooks` ({module: (pre, hook)})
    attached, the model's mode put back after."""
    device = next(model.parameters()).device
    handles = []
    for module, (pre, hook) in hooks.items():
        handles.append(module.register_forward_pre_hook(pre) if pre
                       else module.register_forward_hook(hook))
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            for batch in batches:
                model(torch.as_tensor(batch, dtype=torch.float32).to(device))
    finally:
        model.train(was_training)
        for h in handles:
            h.remove()


def calibrate_activations(model: nn.Module, batches: Iterable) -> dict[str, tuple[float, float]]:
    """Each parameter-holding module's output (min, max) over `batches`
    (the model's own input, (N, 3, H, W) normalized images), keyed as the
    JAX package's `capture_intermediates` keys the same module:
    `<flax module path>/__call__/[0]`."""
    ranges: dict[str, list[float]] = {}

    def hook_for(key):
        def hook(module, args, out):
            lo, hi = out.min().item(), out.max().item()
            if key in ranges:
                ranges[key] = [min(ranges[key][0], lo), max(ranges[key][1], hi)]
            else:
                ranges[key] = [lo, hi]
        return hook

    hooks = {model.get_submodule(name): (None, hook_for(f"{path}/__call__/[0]"))
             for path, name in flax_module_paths(model).items()}
    _run(model, batches, hooks)
    return {k: (v[0], v[1]) for k, v in ranges.items()}


def calibrate_conv_inputs(model: nn.Module, batches: Iterable) -> dict[str, float]:
    """Per-pointwise-conv input absmax over `batches` (the model's own
    input), keyed by the flax path of the conv (quantize.py:163-198); feed to
    `make_int8_apply`. Only convs called as modules are seen."""
    ranges: dict[str, float] = {}

    def pre_for(key):
        def pre(module, args):
            ranges[key] = max(ranges.get(key, 0.0), args[0].float().abs().max().item())
        return pre

    hooks = {}
    for path, name in flax_module_paths(model).items():
        m = model.get_submodule(name)
        if _is_pointwise_conv(m):
            hooks[m] = (pre_for(path), None)
    _run(model, batches, hooks)
    return ranges


def _round_up(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


class Int8PointwiseConv(Conv):
    """A calibrated pointwise `Conv` run as int8 x int8 -> int32. It keeps
    the float conv's parameters (so `to_jax_variables` and a functional
    caller still see them) and adds the int8 weights, padded to
    `torch._int_mm`'s multiples of 8, and the output scale
    `w_scale * s_x`. `calls` counts its forwards."""

    def __init__(self, conv: Conv, act_absmax: float):
        nn.Module.__init__(self)
        self.strides, self.rate, self.groups = conv.strides, conv.rate, conv.groups
        self.padding, self.dtype = conv.padding, conv.dtype
        self.weight, self.bias = conv.weight, conv.bias
        co, ci = conv.weight.shape[:2]
        self.ci, self.co = ci, co
        with torch.no_grad():
            w = conv.weight.detach().float()[:, :, 0, 0].t()  # (Ci, Co)
            w_scale = torch.clamp_min(w.abs().amax(dim=0), 1e-8) / 127.0
            w_i8 = torch.clamp(torch.round(w / w_scale), -127, 127).to(torch.int8)
        # (Co8, Ci8) rows, handed to the product transposed: (Ci8, Co8) column-major
        w_pad = torch.zeros((_round_up(co, 8), _round_up(ci, 8)), dtype=torch.int8,
                            device=w.device)
        w_pad[:co, :ci] = w_i8.t()
        self.s_x = max(act_absmax, 1e-8) / 127.0
        self.register_buffer("w_i8", w_pad, persistent=False)
        self.register_buffer("out_scale", w_scale * self.s_x, persistent=False)
        self.calls = 0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, _, h, w = x.shape
        m = n * h * w
        x_i8 = torch.clamp(torch.round(x.float() * (1.0 / self.s_x)), -127, 127).to(torch.int8)
        rows = x_i8.permute(0, 2, 3, 1).reshape(m, self.ci)  # a view for channels_last x
        pad_rows, pad_k = max(0, 17 - m), self.w_i8.shape[1] - self.ci
        if pad_rows or pad_k:
            rows = F.pad(rows, (0, pad_k, 0, pad_rows))
        y = torch._int_mm(rows, self.w_i8.t())[:m, :self.co]
        y = y.float() * self.out_scale
        if self.bias is not None:
            y = y + self.bias.float()
        self.calls += 1
        # (N, H, W, Co) -> channels_last NCHW, a view
        return y.to(x.dtype).reshape(n, h, w, self.co).permute(0, 3, 1, 2)


def make_int8_apply(model: nn.Module, act_absmax: dict[str, float]) -> nn.Module:
    """A copy of `model` (the model itself is not touched) in eval mode whose
    eligible convs with a key in `act_absmax` are `Int8PointwiseConv`s;
    call it on the model's own input. Uncalibrated and non-pointwise convs
    run as before."""
    int8 = copy.deepcopy(model).eval()
    for path, name in flax_module_paths(int8).items():
        conv = int8.get_submodule(name)
        if path in act_absmax and _is_pointwise_conv(conv):
            parent, _, attr = name.rpartition(".")
            setattr(int8.get_submodule(parent), attr, Int8PointwiseConv(conv, act_absmax[path]))
    return int8


def int8_convs(model: nn.Module) -> list[Int8PointwiseConv]:
    """The `Int8PointwiseConv`s of a model made by `make_int8_apply`."""
    return [m for m in model.modules() if isinstance(m, Int8PointwiseConv)]
