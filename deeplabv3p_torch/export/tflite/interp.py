"""An executor of TFLite files in torch ops on a device (the port's
`TFLiteRunner` runs on it; the JAX package's runs the file in TensorFlow's
interpreter).

It runs the float builtins `export/tflite/lower.py` writes and those of the
JAX package's own `.tflite` files (jax2tf, then TF's converter: fused
activations, `SAME` padding, `FULLY_CONNECTED`, `SOFTMAX`, float16 weights
behind `DEQUANTIZE`), in the manner of `export/tf/interp.py`: each operator
is one or a few eager torch ops on NHWC tensors, and no kernel here computes
a file. There is no fallback to TensorFlow, even where it is installed: any
other builtin, a custom operator, an option value it does not run or a
quantized tensor raises `NotImplementedError` naming it (int8 files are
ROADMAP item 12c). The fused activations it runs are those TF's float
kernels apply (`NONE`, `RELU`, `RELU_N1_TO_1`, `RELU6`): TF leaves a `TANH`
unapplied or refuses it, and applies none after a `CONCATENATION`, so those
raise here rather than compute what TF does not.

`TFLiteProgram(content, device)` decodes a file's bytes, takes its one
subgraph, puts its constants on the device once, folds each `DEQUANTIZE` of
a constant into an f32 constant, lays each filter out for torch once and
keeps the constants read as shapes, axes or pads on the host;
calling it with a tensor or array of the input's shape returns the output on
the device. Its calls run in full f32 (TF32 off for cuDNN and cuBLAS). The
device is the card unless the caller asks for the CPU: without a card,
`cuda` raises. `run_batched` runs any batch in chunks of the file's static
one.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from deeplabv3p_torch.export.tf.interp import GraphProgram
from deeplabv3p_torch.export.tflite import schema
from deeplabv3p_torch.export.tflite.schema import Activation, Padding

_TORCH = {schema.TensorType.FLOAT32: torch.float32, schema.TensorType.FLOAT16: torch.float16,
          schema.TensorType.FLOAT64: torch.float64, schema.TensorType.INT32: torch.int32,
          schema.TensorType.INT64: torch.int64, schema.TensorType.BOOL: torch.bool,
          schema.TensorType.UINT8: torch.uint8, schema.TensorType.INT16: torch.int16}
ITEM_12C = "int8 .tflite files are not ported yet (ROADMAP Queue A item 12c)"


def _activation(y: torch.Tensor, opts) -> torch.Tensor:
    act = getattr(opts, "fused_activation_function", Activation.NONE)
    if act == Activation.RELU:
        return torch.relu(y)
    if act == Activation.RELU6:
        return y.clamp(0.0, 6.0)
    if act == Activation.RELU_N1_TO_1:
        return y.clamp(-1.0, 1.0)
    return y


def same_pads(size: int, kernel: int, stride: int, dilation: int = 1) -> tuple[int, int]:
    """TF's SAME padding of one axis: (before, after), the smaller half before."""
    out = -(-size // stride)
    total = max((out - 1) * stride + (kernel - 1) * dilation + 1 - size, 0)
    return total // 2, total - total // 2


def _nchw(x: torch.Tensor, opts, kernel, dilation=(1, 1), value: float = 0.0) -> torch.Tensor:
    """An NHWC tensor as NCHW (a view), padded as the options' SAME asks."""
    x = x.permute(0, 3, 1, 2)
    if opts.padding == Padding.VALID:
        return x
    (t, b), (l, r) = (same_pads(n, k, s, d) for n, k, s, d in zip(
        x.shape[2:], kernel, (opts.stride_h, opts.stride_w), dilation))
    return F.pad(x, (l, r, t, b), value=value) if t or b or l or r else x


def _conv(x, w, b, opts, depthwise=False):
    dil = (opts.dilation_h_factor, opts.dilation_w_factor)
    groups = x.shape[3] if depthwise else x.shape[3] // w.shape[1]
    y = F.conv2d(_nchw(x, opts, w.shape[2:], dil), w, b, (opts.stride_h, opts.stride_w), 0,
                 dil, groups)
    return _activation(y.permute(0, 2, 3, 1), opts)


def _transpose_conv(shape, w, x, b, opts):
    """The full scatter of `x` by the (C_in, C_out, kh, kw) weight, then the
    rows TFLite's reference kernel keeps: from the pad its padding rule gives
    the output size, zero past the scatter's end, the bias added to all."""
    full = F.conv_transpose2d(x.permute(0, 3, 1, 2), w, None, (opts.stride_h, opts.stride_w))
    pads = []
    for n, k, s, have in reversed(list(zip([int(v) for v in shape[1:3]], w.shape[2:],
                                           (opts.stride_h, opts.stride_w), full.shape[2:]))):
        steps = -(-n // s) if opts.padding == Padding.SAME else (n + s - k) // s
        pad = max((steps - 1) * s + k - n, 0) // 2
        pads += [-pad, n + pad - have]
    y = F.pad(full, pads)
    y = y if b is None else y + b.reshape(1, -1, 1, 1)
    return _activation(y.permute(0, 2, 3, 1), opts)


def _pool(kind):
    def run(x, opts):
        k = (opts.filter_height, opts.filter_width)
        s = (opts.stride_h, opts.stride_w)
        if kind == "max":
            y = F.max_pool2d(_nchw(x, opts, k, value=-math.inf), k, s)
        elif opts.padding == Padding.VALID:
            y = F.avg_pool2d(x.permute(0, 3, 1, 2), k, s)
        else:  # TFLite averages over the window's valid cells only
            total = F.avg_pool2d(_nchw(x, opts, k), k, s, divisor_override=1)
            ones = torch.ones_like(x[:1, :, :, :1])
            y = total / F.avg_pool2d(_nchw(ones, opts, k), k, s, divisor_override=1)
        return _activation(y.permute(0, 2, 3, 1), opts)
    return run


def _reshape(x, shape, opts, out_shape):
    if shape is None:
        shape = opts.new_shape if opts is not None and opts.new_shape else out_shape
    return x.reshape([int(v) for v in np.asarray(shape).reshape(-1)])


def _strided_slice(x, begin, end, strides, opts):
    if opts.ellipsis_mask or opts.new_axis_mask or opts.shrink_axis_mask or opts.offset:
        raise NotImplementedError("TFLite executor: STRIDED_SLICE with an ellipsis, new-axis or "
                                  "shrink mask, or offset")
    idx = []
    for ax, (b, e, s) in enumerate(zip(begin.tolist(), end.tolist(), strides.tolist())):
        if s <= 0:
            raise NotImplementedError("TFLite executor: STRIDED_SLICE with a stride below 1")
        idx.append(slice(None if opts.begin_mask >> ax & 1 else b,
                         None if opts.end_mask >> ax & 1 else e, s))
    return x[tuple(idx)]


def _reduce(fn):
    def run(x, axes, opts):
        out = x
        for d in sorted({int(a) % x.dim() for a in np.asarray(axes).reshape(-1)}, reverse=True):
            out = fn(out, d)
            out = out.unsqueeze(d) if opts.keep_dims else out
        return out
    return run


def _fully_connected(x, w, b, opts):
    if opts.weights_format:
        raise NotImplementedError(f"TFLite executor: FULLY_CONNECTED weights_format "
                                  f"{opts.weights_format}")
    y = F.linear(x if opts.keep_num_dims else x.reshape(-1, w.shape[1]), w, b)
    return _activation(y, opts)


def _matmul(a, b, opts):
    a = a.transpose(-1, -2) if opts.adj_x else a
    b = b.transpose(-1, -2) if opts.adj_y else b
    return torch.matmul(a, b)


def _gather(x, idx, opts):
    if opts.batch_dims:
        raise NotImplementedError("TFLite executor: GATHER with batch_dims")
    ax = opts.axis % x.dim()
    out = x.index_select(ax, idx.reshape(-1).long())
    return out.reshape(*x.shape[:ax], *idx.shape, *x.shape[ax + 1:])


def _binary(fn):
    return lambda a, b, opts: _activation(fn(a, b), opts)


class Builtin(NamedTuple):
    """How a builtin runs: fn(*inputs, options[, output shape]); the input
    positions read as host arrays; the input read as a filter and the
    layout that turns its TFLite array into the torch weight."""
    fn: Callable
    static: tuple = ()
    filter: int = -1
    layout: Callable = None
    options: type = None  # its options table (None: it takes none)
    wants_shape: bool = False


def _ohwi(w):
    """CONV_2D's (O, kh, kw, I) filter as torch's (O, I, kh, kw)."""
    return w.permute(0, 3, 1, 2).contiguous()


def _last_first(w):
    """DEPTHWISE_CONV_2D's (1, kh, kw, C m) as (C m, 1, kh, kw), and
    TRANSPOSE_CONV's (C_out, kh, kw, C_in) as (C_in, C_out, kh, kw)."""
    return w.permute(3, 0, 1, 2).contiguous()


S = schema
BUILTINS: dict[str, Builtin] = {
    "ADD": Builtin(_binary(torch.add), options=S.AddOptions),
    "SUB": Builtin(_binary(torch.sub), options=S.SubOptions),
    "MUL": Builtin(_binary(torch.mul), options=S.MulOptions),
    "DIV": Builtin(_binary(torch.div), options=S.DivOptions),
    "MAXIMUM": Builtin(lambda a, b, o: torch.maximum(a, b)),
    "MINIMUM": Builtin(lambda a, b, o: torch.minimum(a, b)),
    "EXP": Builtin(lambda x, o: torch.exp(x)), "SQRT": Builtin(lambda x, o: torch.sqrt(x)),
    "LOGISTIC": Builtin(lambda x, o: torch.sigmoid(x)),
    "TANH": Builtin(lambda x, o: torch.tanh(x)),
    "CONCATENATION": Builtin(lambda *xs: torch.cat(xs[:-1], xs[-1].axis),
                             options=S.ConcatenationOptions),
    "RESHAPE": Builtin(lambda x, shape=None, o=None, out_shape=None:
                       _reshape(x, shape, o, out_shape), static=(1,),
                       options=S.ReshapeOptions, wants_shape=True),
    "TRANSPOSE": Builtin(lambda x, perm, o: x.permute([int(p) for p in perm]), static=(1,)),
    "PAD": Builtin(lambda x, p, o: _pad(x, p), static=(1,)),
    "PADV2": Builtin(lambda x, p, v, o: _pad(x, p, float(np.asarray(v).reshape(()))),
                     static=(1, 2)),
    "BROADCAST_TO": Builtin(lambda x, shape, o: x.expand([int(d) for d in shape]), static=(1,)),
    "CAST": Builtin(lambda x, o, out_dtype=None: x.to(out_dtype)),
    "DEQUANTIZE": Builtin(lambda x, o, out_dtype=None: x.to(out_dtype)),
    "GATHER": Builtin(_gather, options=S.GatherOptions),
    "STRIDED_SLICE": Builtin(_strided_slice, static=(1, 2, 3), options=S.StridedSliceOptions),
    "SUM": Builtin(_reduce(lambda x, d: x.sum(dim=d)), static=(1,), options=S.ReducerOptions),
    "REDUCE_MAX": Builtin(_reduce(lambda x, d: x.amax(dim=d)), static=(1,),
                          options=S.ReducerOptions),
    "REDUCE_MIN": Builtin(_reduce(lambda x, d: x.amin(dim=d)), static=(1,),
                          options=S.ReducerOptions),
    "BATCH_MATMUL": Builtin(_matmul, options=S.BatchMatMulOptions),
    "FULLY_CONNECTED": Builtin(_fully_connected, options=S.FullyConnectedOptions),
    "SOFTMAX": Builtin(lambda x, o: torch.softmax(x * o.beta, dim=-1), options=S.SoftmaxOptions),
    "ARG_MAX": Builtin(lambda x, axis, o, out_dtype=None: torch.argmax(
        x, dim=int(np.asarray(axis).reshape(-1)[0])).to(out_dtype), static=(1,),
        options=S.ArgMaxOptions),
    "CONV_2D": Builtin(lambda x, w, b, o: _conv(x, w, b, o), filter=1, layout=_ohwi,
                       options=S.Conv2DOptions),
    "DEPTHWISE_CONV_2D": Builtin(lambda x, w, b, o: _conv(x, w, b, o, depthwise=True),
                                 filter=1, layout=_last_first,
                                 options=S.DepthwiseConv2DOptions),
    "TRANSPOSE_CONV": Builtin(_transpose_conv, static=(0,), filter=1, layout=_last_first,
                              options=S.TransposeConvOptions),
    "MAX_POOL_2D": Builtin(_pool("max"), options=S.Pool2DOptions),
    "AVERAGE_POOL_2D": Builtin(_pool("avg"), options=S.Pool2DOptions),
}
# the builtins whose outputs take the output tensor's dtype
_TO_DTYPE = ("CAST", "DEQUANTIZE", "ARG_MAX")
# the inputs each builtin may leave out (-1), filled with None
_OPTIONAL = {"CONV_2D": 3, "DEPTHWISE_CONV_2D": 3, "TRANSPOSE_CONV": 4, "FULLY_CONNECTED": 3,
             "RESHAPE": 2}
# the fused activations TF's float kernels apply: they leave a TANH unapplied
# (ADD, CONV_2D) or refuse it (FULLY_CONNECTED), and a CONCATENATION's any
_ACTIVATIONS = (Activation.NONE, Activation.RELU, Activation.RELU_N1_TO_1, Activation.RELU6)


def _pad(x, paddings, value: float = 0.0):
    pads = []
    for before, after in reversed(np.asarray(paddings).reshape(-1, 2).tolist()):
        pads += [int(before), int(after)]
    return F.pad(x, pads, value=value)


def _check_options(name: str, opts, where: str) -> None:
    padding = getattr(opts, "padding", Padding.VALID)
    if padding not in (Padding.SAME, Padding.VALID):
        raise NotImplementedError(f"TFLite executor: {name} padding {padding} ({where})")
    act = getattr(opts, "fused_activation_function", Activation.NONE)
    if act not in _ACTIVATIONS or (name == "CONCATENATION" and act != Activation.NONE):
        raise NotImplementedError(f"TFLite executor: {name} fused activation {act} ({where})")


def _array(t, buffers) -> np.ndarray:
    """A constant tensor's value, from its buffer's little-endian bytes."""
    data = buffers[t.buffer].data
    dtype = np.dtype(schema.NP_OF_TYPE[t.type]).newbyteorder("<")
    shape = tuple(t.shape or ())
    if data.size != dtype.itemsize * int(np.prod(shape)):
        raise ValueError(f"tensor {t.name}: a buffer of {data.size} bytes for shape {shape} "
                         f"of {dtype}")
    return np.frombuffer(data.tobytes(), dtype).astype(dtype.newbyteorder("=")).reshape(shape)


class TFLiteProgram:
    """A decoded TFLite file ready to run on `device`: its operators in the
    file's order, their constants on the device, each filter in its torch
    layout, each `DEQUANTIZE` of a constant folded."""

    def __init__(self, content: bytes, device: str | torch.device = "cuda"):
        from deeplabv3p_torch.eval import resolve_device

        model = schema.decode_model(content)
        self.device = torch.device(device)
        resolve_device(self.device.type)  # a cuda device without a card raises
        if len(model.subgraphs) != 1:
            raise NotImplementedError(f"TFLite executor: {len(model.subgraphs)} subgraphs; it "
                                      "runs a file of one")
        g = model.subgraphs[0]
        if len(g.inputs) != 1 or len(g.outputs) != 1:
            raise ValueError(f"TFLite executor: a subgraph of one input and one output, not "
                             f"{len(g.inputs)} and {len(g.outputs)}")
        tensors = g.tensors
        for t in tensors:
            q = t.quantization
            if q is not None and (q.scale or q.zero_point):
                raise NotImplementedError(f"TFLite executor: quantized tensor {t.name}; "
                                          f"{ITEM_12C}")
            if t.type not in _TORCH:
                raise NotImplementedError(f"TFLite executor: tensor {t.name} of TensorType "
                                          f"{t.type}")
        arrays = {i: _array(t, model.buffers) for i, t in enumerate(tensors)
                  if model.buffers[t.buffer].data is not None}
        (self.input,), (self.output,) = g.inputs, g.outputs
        self.input_shape = tuple(tensors[self.input].shape)
        self.input_name = tensors[self.input].name
        self.output_name = tensors[self.output].name
        self.steps = []
        for i, op in enumerate(g.operators):
            code = model.operator_codes[op.opcode_index]
            builtin = schema.builtin_of(code)
            name = schema.BUILTIN_NAMES.get(builtin, str(builtin))
            where = f"operator {i}, output tensor {tensors[op.outputs[0]].name}" \
                if op.outputs else f"operator {i}"
            if name == "CUSTOM":
                raise NotImplementedError(f"TFLite executor: custom operator "
                                          f"{code.custom_code} ({where})")
            spec = BUILTINS.get(name)
            if spec is None:
                raise NotImplementedError(f"TFLite executor: builtin {name} ({where}); it runs "
                                          f"{', '.join(sorted(BUILTINS))}")
            if op.builtin_options_2_type or op.custom_options is not None:
                raise NotImplementedError(f"TFLite executor: {name} with options it does not "
                                          f"read ({where})")
            opts = op.builtin_options
            if op.builtin_options_type and (spec.options is None or opts is None or
                                            not isinstance(opts, spec.options)):
                raise NotImplementedError(f"TFLite executor: {name} with BuiltinOptions type "
                                          f"{op.builtin_options_type} ({where})")
            if opts is None and spec.options is not None:
                opts = spec.options()
            _check_options(name, opts, where)
            if len(op.outputs) != 1:
                raise NotImplementedError(f"TFLite executor: {name} with {len(op.outputs)} "
                                          f"outputs ({where})")
            out = op.outputs[0]
            if name == "DEQUANTIZE" and op.inputs[0] in arrays:  # folded at load
                arrays[out] = arrays[op.inputs[0]].astype(np.float32)
                continue
            self.steps.append([name, spec, list(op.inputs), out, opts])
        # the constants: host arrays where read as shapes or axes, the torch
        # layout where read as a filter, else on the device once
        self.consts: dict = {}
        for name, spec, ins, out, _ in self.steps:
            for k, t in enumerate(ins):
                if t < 0 or t not in arrays:
                    if t >= 0 and k == spec.filter:
                        raise NotImplementedError(f"TFLite executor: {name} with a computed "
                                                  "filter")
                    continue
                host = k in spec.static
                key = f"{t}@host" if host else f"{t}@{name}" if k == spec.filter else f"{t}"
                if key not in self.consts:
                    if host:
                        self.consts[key] = arrays[t]
                    else:
                        value = torch.from_numpy(arrays[t]).to(self.device)
                        self.consts[key] = spec.layout(value) if k == spec.filter else value
                ins[k] = key
        for step in self.steps:
            name, spec, ins, out, opts = step
            ins += [-1] * (_OPTIONAL.get(name, len(ins)) - len(ins))
            extra = {}
            if name in _TO_DTYPE:
                extra["out_dtype"] = _TORCH[tensors[out].type]
            if spec.wants_shape:
                extra["out_shape"] = tuple(tensors[out].shape)
            step[4] = (opts, extra)
        last_use: dict = {}
        for i, (_, _, ins, _, _) in enumerate(self.steps):
            for t in ins:
                last_use[t] = i
        self.frees = [[t for t in dict.fromkeys(ins) if last_use.get(t) == i
                       and t not in self.consts and t != self.output and t != -1]
                      for i, (_, _, ins, _, _) in enumerate(self.steps)]

    batch = GraphProgram.batch  # the file's static batch, and the chunks over it
    run_batched = GraphProgram.run_batched

    def __call__(self, x) -> torch.Tensor:
        from deeplabv3p_torch.postprocess import _full_f32

        x = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
        x = x.to(self.device, torch.float32)
        if self.input_shape and tuple(x.shape) != self.input_shape:
            raise ValueError(f"the file takes {self.input_shape}, not {tuple(x.shape)}")
        env = dict(self.consts)
        env[self.input] = x
        env[-1] = None
        with torch.no_grad(), _full_f32():
            for (name, spec, ins, out, (opts, extra)), frees in zip(self.steps, self.frees):
                env[out] = spec.fn(*[env[t] for t in ins], opts, **extra)
                for t in frees:
                    del env[t]
        return env[self.output]
