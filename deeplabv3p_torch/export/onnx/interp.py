"""An executor of ONNX ModelProtos in torch ops on a device (the port's
counterpart of deeplabv3p_tpu/export/onnx/interp.py, a numpy interpreter).

It runs the opset-13 op set of JAX's interpreter, so it runs the files of
both exporters: the port's (NCHW body, `convert.ENGINE_OPS`) and JAX's (NHWC
with a Transpose pair around each conv, Softmax, ArgMax, Pow, comparisons),
with the attribute subsets they write, plus ReduceMean, which the native
engine has too. Every node is one or a few eager torch ops: no kernel here
computes an ONNX graph.

`OnnxProgram(model, device)` decodes the initializers onto the device once;
calling it with `{input name: array or tensor}` returns `{output name:
tensor on the device}`. Its calls run in full f32 (TF32 off for cuDNN and
cuBLAS), as the JAX interpreter's numpy does. The device is the card unless
the caller asks for the CPU: without a card, `cuda` raises.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from deeplabv3p_torch.export.onnx import proto

DTYPES = {
    proto.TensorProto.FLOAT: torch.float32, proto.TensorProto.DOUBLE: torch.float64,
    proto.TensorProto.FLOAT16: torch.float16, proto.TensorProto.INT64: torch.int64,
    proto.TensorProto.INT32: torch.int32, proto.TensorProto.INT8: torch.int8,
    proto.TensorProto.UINT8: torch.uint8, proto.TensorProto.BOOL: torch.bool,
}
_NP = {torch.float32: np.float32, torch.float64: np.float64, torch.float16: np.float16,
       torch.int64: np.int64, torch.int32: np.int32, torch.int8: np.int8,
       torch.uint8: np.uint8, torch.bool: np.bool_}


def tensor_of(t: proto.TensorProto) -> torch.Tensor:
    """A TensorProto's value on the CPU: `raw_data`, else the typed fields."""
    dtype = DTYPES[t.data_type]
    if t.raw_data:
        arr = np.frombuffer(t.raw_data, _NP[dtype]).copy()
    else:
        arr = np.asarray(t.float_data or t.int64_data or t.int32_data or t.double_data,
                         _NP[dtype])
    return torch.from_numpy(arr.reshape(tuple(t.dims)))


def attributes(node: proto.NodeProto) -> dict:
    out = {}
    for a in node.attribute:
        A = proto.AttributeProto
        if a.type == A.INT:
            out[a.name] = a.i
        elif a.type == A.FLOAT:
            out[a.name] = a.f
        elif a.type == A.STRING:
            out[a.name] = a.s.decode()
        elif a.type == A.INTS:
            out[a.name] = list(a.ints)
        elif a.type == A.FLOATS:
            out[a.name] = list(a.floats)
        else:
            raise NotImplementedError(f"{node.op_type}: attribute {a.name} of type {a.type}")
    return out


def _ints(t: torch.Tensor) -> list[int]:
    return [int(v) for v in t.reshape(-1).tolist()]


def _spatial_pad(x: torch.Tensor, pads, value: float = 0.0) -> torch.Tensor:
    """ONNX 2-D pads [top, left, bottom, right] applied to NCHW x."""
    if not any(pads):
        return x
    return F.pad(x, (pads[1], pads[3], pads[0], pads[2]), value=value)


def _conv(x, w, b=None, strides=(1, 1), pads=(0, 0, 0, 0), dilations=(1, 1), group=1, **_):
    if pads[0] == pads[2] and pads[1] == pads[3]:
        return F.conv2d(x, w, b, strides, (pads[0], pads[1]), dilations, group)
    return F.conv2d(_spatial_pad(x, pads), w, b, strides, 0, dilations, group)


def _conv_transpose(x, w, b=None, strides=(1, 1), pads=(0, 0, 0, 0), dilations=(1, 1), group=1,
                    output_padding=(0, 0), **_):
    """The full scatter (no padding), then each axis cut to ONNX's
    [pad_begin, pad_begin + out), with zeros past the scatter's end where
    output_padding reaches beyond it; the bias on every output."""
    full = F.conv_transpose2d(x, w, None, strides, 0, 0, group, dilations)
    for axis in range(2):
        n = full.shape[2 + axis]
        out = n + output_padding[axis] - pads[axis] - pads[2 + axis]
        if pads[axis] + out > n:
            tail = pads[axis] + out - n
            full = F.pad(full, (0, tail) if axis == 1 else (0, 0, 0, tail))
        full = full.narrow(2 + axis, pads[axis], out)
    return full if b is None else full + b.view(1, -1, 1, 1)


def _pool(x, kind, kernel_shape, strides=None, pads=(0, 0, 0, 0), count_include_pad=0, **_):
    strides = strides or [1, 1]
    if kind == "max":
        return F.max_pool2d(_spatial_pad(x, pads, -math.inf), kernel_shape, strides)
    total = F.avg_pool2d(_spatial_pad(x, pads), kernel_shape, strides, divisor_override=1)
    if count_include_pad:
        return total / (kernel_shape[0] * kernel_shape[1])
    ones = torch.ones_like(x[:1, :1])
    count = F.avg_pool2d(_spatial_pad(ones, pads), kernel_shape, strides, divisor_override=1)
    return total / count


def _slice(x, starts, ends, axes=None, steps=None):
    starts, ends = _ints(starts), _ints(ends)
    axes = _ints(axes) if axes is not None else list(range(len(starts)))
    steps = _ints(steps) if steps is not None else [1] * len(starts)
    idx = [slice(None)] * x.dim()
    for s, e, ax, st in zip(starts, ends, axes, steps):
        if st <= 0:
            raise NotImplementedError("Slice with a step below 1")
        idx[ax] = slice(s, e, st)
    return x[tuple(idx)]


def _pad(x, pads, value=None, mode="constant", **_):
    if mode != "constant":
        raise NotImplementedError(f"Pad mode {mode}")
    pads = _ints(pads)
    n = x.dim()
    torch_pads = []
    for ax in reversed(range(n)):
        torch_pads += [pads[ax], pads[ax + n]]
    fill = 0.0 if value is None or value.numel() == 0 else value.reshape(()).item()
    return F.pad(x, torch_pads, value=fill)


def _gather(x, idx, axis=0):
    axis %= x.dim()
    flat = idx.reshape(-1).long()
    flat = torch.where(flat < 0, flat + x.shape[axis], flat)
    out = x.index_select(axis, flat)
    return out.reshape(*x.shape[:axis], *idx.shape, *x.shape[axis + 1:])


def _reduce(fn):
    def run(x, axes_input=None, axes=None, keepdims=1, **_):
        if axes_input is not None:
            axes = _ints(axes_input)
        axes = list(range(x.dim())) if not axes else [a % x.dim() for a in axes]
        out = x
        for ax in sorted(axes, reverse=True):
            out = fn(out, ax)
            out = out.unsqueeze(ax) if keepdims else out
        return out
    return run


def _arg(fn):
    def run(x, axis=0, keepdims=1, **_):
        out = fn(x, dim=axis)
        return out.unsqueeze(axis) if keepdims else out
    return run


def _softmax(x, axis=-1, **_):
    e = torch.exp(x - x.amax(dim=axis, keepdim=True))
    return e / e.sum(dim=axis, keepdim=True)


def _variadic(fn):
    def run(*xs, **_):
        out = xs[0]
        for x in xs[1:]:
            out = fn(out, x)
        return out
    return run


def _elementwise(fn):
    return lambda *xs, **_: fn(*xs)


# op type -> fn(*input tensors, **attributes)
OPS: dict[str, Callable] = {
    "Add": _elementwise(torch.add), "Sub": _elementwise(torch.sub),
    "Mul": _elementwise(torch.mul), "Div": _elementwise(torch.div),
    "Max": _variadic(torch.maximum), "Min": _variadic(torch.minimum),
    "Pow": _elementwise(torch.pow), "And": _elementwise(torch.logical_and),
    "Or": _elementwise(torch.logical_or), "Xor": _elementwise(torch.logical_xor),
    "Abs": _elementwise(torch.abs), "Exp": _elementwise(torch.exp),
    "Log": _elementwise(torch.log), "Tanh": _elementwise(torch.tanh),
    "Sigmoid": _elementwise(torch.sigmoid), "Sqrt": _elementwise(torch.sqrt),
    "Reciprocal": _elementwise(torch.reciprocal), "Neg": _elementwise(torch.neg),
    "Sign": _elementwise(torch.sign), "Floor": _elementwise(torch.floor),
    "Ceil": _elementwise(torch.ceil), "Not": _elementwise(torch.logical_not),
    "Erf": _elementwise(torch.erf), "Greater": _elementwise(torch.gt),
    "GreaterOrEqual": _elementwise(torch.ge), "Less": _elementwise(torch.lt),
    "LessOrEqual": _elementwise(torch.le), "Equal": _elementwise(torch.eq),
    "Where": _elementwise(torch.where), "Identity": _elementwise(lambda x: x),
    "Cast": lambda x, to: x.to(DTYPES[to]),
    "Reshape": lambda x, shape, **_: x.reshape(_ints(shape)),
    "Expand": lambda x, shape: x.expand(torch.broadcast_shapes(x.shape, tuple(_ints(shape)))),
    "Transpose": lambda x, perm: x.permute(perm),
    "Concat": lambda *xs, axis: torch.cat(xs, dim=axis),
    "Slice": _slice, "Pad": _pad, "Gather": _gather,
    "ReduceSum": _reduce(lambda x, ax: x.sum(dim=ax)),
    "ReduceMean": _reduce(lambda x, ax: x.mean(dim=ax)),
    "ReduceMax": _reduce(lambda x, ax: x.amax(dim=ax)),
    "ReduceMin": _reduce(lambda x, ax: x.amin(dim=ax)),
    "ReduceProd": _reduce(lambda x, ax: x.prod(dim=ax)),
    "ArgMax": _arg(torch.argmax), "ArgMin": _arg(torch.argmin),
    "Einsum": lambda *xs, equation: torch.einsum(equation, *xs),
    "Conv": _conv, "ConvTranspose": _conv_transpose,
    "MaxPool": lambda x, **a: _pool(x, "max", **a),
    "AveragePool": lambda x, **a: _pool(x, "avg", **a),
    "Softmax": _softmax,
}


class OnnxProgram:
    """A decoded ModelProto ready to run on `device`: its initializers on
    the device, each node's function and attributes looked up once."""

    def __init__(self, model: proto.ModelProto, device: str | torch.device = "cuda"):
        from deeplabv3p_torch.eval import resolve_device

        self.device = torch.device(device)
        resolve_device(self.device.type)  # a cuda device without a card raises
        graph = model.graph
        self.consts = {t.name: tensor_of(t).to(self.device) for t in graph.initializer}
        self.inputs = [vi.name for vi in graph.input if vi.name not in self.consts]
        self.outputs = [vi.name for vi in graph.output]
        self.steps = []
        last_use: dict[str, int] = {}
        for i, node in enumerate(graph.node):
            fn = OPS.get(node.op_type)
            if fn is None:
                raise NotImplementedError(f"ONNX executor: op {node.op_type} (node {node.name})")
            attrs = attributes(node)
            ins = list(node.input)
            if node.op_type == "ReduceSum" and len(ins) > 1:  # opset 13: axes as an input
                ins, attrs = ins[:1], dict(attrs, axes_input=ins[1])
            self.steps.append((fn, ins, node.output[0], attrs))
            for name in node.input:
                last_use[name] = i
        # the values each step reads for the last time, freed after it
        self.frees = [[n for n in dict.fromkeys(ins + [a.get("axes_input")])
                       if n and last_use.get(n) == i and n not in self.consts
                       and n not in self.outputs]
                      for i, (_, ins, _, a) in enumerate(self.steps)]

    def __call__(self, inputs: dict) -> dict[str, torch.Tensor]:
        from deeplabv3p_torch.postprocess import _full_f32

        env = dict(self.consts)
        for name in self.inputs:
            env[name] = torch.as_tensor(np.asarray(inputs[name]) if not isinstance(
                inputs[name], torch.Tensor) else inputs[name]).to(self.device)
        with torch.no_grad(), _full_f32():
            for (fn, ins, out, attrs), frees in zip(self.steps, self.frees):
                if "axes_input" in attrs:
                    attrs = dict(attrs, axes_input=env[attrs["axes_input"]])
                env[out] = fn(*[env[n] for n in ins], **attrs)
                for name in frees:
                    del env[name]
        return {name: env[name] for name in self.outputs}


def run_model(model: proto.ModelProto, inputs: dict,
              device: str | torch.device = "cuda") -> dict[str, torch.Tensor]:
    """Execute `model` once on `device`; {output name: tensor on the device}
    (JAX interp.py:131)."""
    return OnnxProgram(model, device)(inputs)
