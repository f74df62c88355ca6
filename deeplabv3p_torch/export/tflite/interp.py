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
quantized tensor of another kind than below raises `NotImplementedError`
naming it. The fused activations it runs are those TF's float kernels apply
(`NONE`, `RELU`, `RELU_N1_TO_1`, `RELU6`): TF leaves a `TANH` unapplied or
refuses it, and applies none after a `CONCATENATION`, so those raise here
rather than compute what TF does not.

Full-integer files (`export/tflite/quantize.py`'s, and TF's converter's with
a representative dataset, as the JAX package writes them) run as TFLite's
reference int8 kernels compute them (`INT8_BUILTINS`): int8 activations per
tensor, int8 weights per channel with zero point 0, int32 biases, f32 in
through `QUANTIZE` and out through `DEQUANTIZE`, with f32 islands between
them. A conv, a matmul or a fully connected layer sums (x - zp_x) * w and
the bias exactly (float64, or f32 on the CPU where every sum stays below
2^24, then rounded to int64), requantizes each channel with
`fixed_point.Requantizer`, adds the output zero point and clamps to its
fused activation's range; `ADD`/`SUB` rescale both inputs by 2^20 first,
`MUL` the product, `SUM` the sum less its zero points, `AVERAGE_POOL_2D`
rounds its mean half away from zero. `SOFTMAX`, `LOGISTIC` and `TANH`
dequantize, apply the float form and requantize at their fixed scales. The
ops that compare or move data run their float forms on the int8 values
(those that compare or join them at one scale); a `PAD` fills with the zero
point. A uint8 or int16 quantized tensor,
per-channel activations, or an int8 builtin missing from `INT8_BUILTINS`
raises `NotImplementedError` naming the builtin and the tensor's type.

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

import dataclasses
import math
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from deeplabv3p_torch.export.tf.interp import GraphProgram
from deeplabv3p_torch.export.tflite import fixed_point as fp
from deeplabv3p_torch.export.tflite import schema
from deeplabv3p_torch.export.tflite.schema import Activation, Padding

_TORCH = {schema.TensorType.FLOAT32: torch.float32, schema.TensorType.FLOAT16: torch.float16,
          schema.TensorType.FLOAT64: torch.float64, schema.TensorType.INT32: torch.int32,
          schema.TensorType.INT64: torch.int64, schema.TensorType.BOOL: torch.bool,
          schema.TensorType.UINT8: torch.uint8, schema.TensorType.INT16: torch.int16,
          schema.TensorType.INT8: torch.int8}
_TYPE_NAMES = {v: k.lower() for k, v in vars(schema.TensorType).items() if k.isupper()}


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


# -- int8 -----------------------------------------------------------------------------


class _Int8Op:
    """What an int8 builtin's preparation reads: its tensors' scales and
    zero points, its constants (host arrays), its options and the device."""

    def __init__(self, name, op, opts, tensors, arrays, device, where):
        self.name, self.op, self.opts, self.device, self.where = name, op, opts, device, where
        self.tensors, self.arrays = tensors, arrays

    def tensor(self, k: int):
        return self.tensors[self.op.inputs[k]] if k >= 0 else self.tensors[self.op.outputs[0]]

    def q(self, k: int) -> tuple[float, int]:
        """(scale, zero point) of input k (-1: the output), one for the tensor."""
        qp = self.tensor(k).quantization
        if qp is None or not qp.scale:
            raise NotImplementedError(f"TFLite executor: int8 {self.name} with an unquantized "
                                      f"tensor {self.tensor(k).name} ({self.where})")
        if len(qp.scale) != 1:
            raise NotImplementedError(f"TFLite executor: int8 {self.name} with per-channel "
                                      f"activations ({self.tensor(k).name}, {self.where})")
        return float(np.float32(qp.scale[0])), int(qp.zero_point[0]) if qp.zero_point else 0

    @property
    def out(self) -> tuple[float, int]:
        return self.q(-1)

    def const(self, k: int):
        i = self.op.inputs[k] if k < len(self.op.inputs) else -1
        return None if i < 0 else self.arrays.get(i)

    def channel_scales(self, k: int, channels: int, axis: int) -> np.ndarray:
        """A constant weight's scales, one per output channel (a single one
        broadcast), float64; its zero points must be 0."""
        qp = self.tensor(k).quantization
        if qp is None or not qp.scale:
            raise NotImplementedError(f"TFLite executor: int8 {self.name} with unquantized "
                                      f"weights {self.tensor(k).name} ({self.where})")
        if any(qp.zero_point or []):
            raise NotImplementedError(f"TFLite executor: int8 {self.name} weights "
                                      f"{self.tensor(k).name} with a nonzero zero point")
        scales = np.asarray(qp.scale, np.float32).astype(np.float64)
        if len(scales) not in (1, channels) or (len(scales) > 1 and
                                                qp.quantized_dimension != axis):
            raise NotImplementedError(f"TFLite executor: int8 {self.name} weights "
                                      f"{self.tensor(k).name} quantized on axis "
                                      f"{qp.quantized_dimension} ({len(scales)} scales); it "
                                      f"runs {channels} on axis {axis}")
        return np.broadcast_to(scales, (channels,))

    def act(self) -> tuple[int, int]:
        return fp.activation_range(getattr(self.opts, "fused_activation_function", 0),
                                   *self.out)


def _requantizer(c: _Int8Op, real, axis_shape=(-1,)):
    """acc (int64) -> the output's int8 values: times the multipliers `real`
    (one per channel, laid out as `axis_shape`), plus the zero point,
    clamped to the fused activation's range."""
    requantize = fp.Requantizer.of(real, c.device, axis_shape)
    zp, (lo, hi) = c.out[1], c.act()
    return lambda acc: (requantize(acc) + zp).clamp(lo, hi).to(torch.int8)


def _float64_bias(c: _Int8Op, k: int, channels: int) -> torch.Tensor:
    """Input k, an int32 bias (zeros where absent), as float64 on the device:
    added inside the float64 sum, it stays exact."""
    bias = c.const(k)
    return torch.from_numpy(np.zeros(channels) if bias is None else
                            bias.astype(np.float64)).to(c.device)


def _exact(acc: torch.Tensor) -> torch.Tensor:
    """A float sum of integers (exact below 2^53 in float64, 2^24 in f32) as
    int64."""
    return torch.round(acc).to(torch.int64)


def _sum_dtype(c: _Int8Op, zero_point: int, weight: np.ndarray, terms: int, bias) -> torch.dtype:
    """float32 where every partial sum of a conv is an integer below 2^24 (at
    most `terms` products of |x - zp| by |w|, plus the bias) and the device
    is the CPU, whose f32 convolutions sum directly: each sum is then exact
    in any order, and a depthwise conv runs 10x faster than in float64.
    float64 otherwise: a 1x1 conv over 2048 channels passes 2^24, and cuDNN
    may pick an f32 algorithm (Winograd, FFT) whose sums are not exact."""
    bound = terms * max(127 - zero_point, zero_point + 128) * float(np.abs(weight).max(
        initial=0)) + float(np.abs(bias).max(initial=0) if bias is not None else 0)
    return torch.float32 if c.device.type == "cpu" and bound < 2 ** 24 else torch.float64


def _int8_conv(depthwise: bool):
    def prepare(c: _Int8Op):
        w = c.const(1)
        if w is None:
            raise NotImplementedError(f"TFLite executor: int8 {c.name} with a computed filter")
        channels = w.shape[3] if depthwise else w.shape[0]
        s_in, z_in = c.q(0)
        real = s_in * c.channel_scales(1, channels, 3 if depthwise else 0) / c.out[0]
        terms = int(np.prod(w.shape[1:3])) * (1 if depthwise else w.shape[3])
        dtype = _sum_dtype(c, z_in, w, terms, c.const(2))
        weight = torch.from_numpy(w.astype(np.float64)).to(c.device, dtype)
        weight = _last_first(weight) if depthwise else _ohwi(weight)
        bias = _float64_bias(c, 2, channels).to(dtype)
        requant = _requantizer(c, real, (-1, 1, 1))
        opts = c.opts
        dil = (opts.dilation_h_factor, opts.dilation_w_factor)

        def run(x, *_):
            groups = x.shape[3] if depthwise else x.shape[3] // weight.shape[1]
            xin = x.to(dtype) - z_in  # a SAME pad adds zeros of (x - zp)
            acc = F.conv2d(_nchw(xin, opts, weight.shape[2:], dil), weight, bias,
                           (opts.stride_h, opts.stride_w), 0, dil, groups)
            return requant(_exact(acc)).permute(0, 2, 3, 1)
        return run
    return prepare


def _int8_transpose_conv(c: _Int8Op):
    w = c.const(1)  # (C_out, kh, kw, C_in)
    s_in, z_in = c.q(2)
    real = s_in * c.channel_scales(1, w.shape[0], 0) / c.out[0]
    weight = _last_first(torch.from_numpy(w.astype(np.float64)).to(c.device))
    bias = _float64_bias(c, 3, w.shape[0])
    requant = _requantizer(c, real)
    plain = dataclasses.replace(c.opts, fused_activation_function=Activation.NONE)

    def run(shape, _w, x, *_):
        return requant(_exact(_transpose_conv(shape, weight, x.to(torch.float64) - z_in, bias,
                                              plain)))
    return run


def _int8_fully_connected(c: _Int8Op):
    w = c.const(1)  # (O, I)
    if c.opts.weights_format:
        raise NotImplementedError(f"TFLite executor: FULLY_CONNECTED weights_format "
                                  f"{c.opts.weights_format}")
    s_in, z_in = c.q(0)
    real = s_in * c.channel_scales(1, w.shape[0], 0) / c.out[0]
    weight = torch.from_numpy(w.astype(np.float64)).to(c.device)
    bias = _float64_bias(c, 2, w.shape[0])
    requant = _requantizer(c, real)
    keep = c.opts.keep_num_dims

    def run(x, *_):
        xin = x.to(torch.float64) - z_in
        return requant(_exact(F.linear(xin if keep else xin.reshape(-1, weight.shape[1]),
                                       weight, bias)))
    return run


def _int8_batch_matmul(c: _Int8Op):
    (s_a, z_a), (s_b, z_b) = c.q(0), c.q(1)
    requant = _requantizer(c, s_a * s_b / c.out[0], ())
    opts = c.opts

    def run(a, b, *_):
        acc = _matmul(a.to(torch.float64) - z_a, b.to(torch.float64) - z_b, opts)
        return requant(_exact(acc))
    return run


def _int8_add(sign: int):
    """`ADD` / `SUB`: each input less its zero point, times 2^20, rescaled to
    twice the larger input scale, summed, then rescaled to the output."""
    def prepare(c: _Int8Op):
        (s1, z1), (s2, z2), (s_out, z_out) = c.q(0), c.q(1), c.out
        twice = 2 * max(s1, s2)
        r1, r2, r_out = (fp.Requantizer(*fp.quantize_multiplier_smaller_than_one(real),
                                        c.device)
                         for real in (s1 / twice, s2 / twice, twice / ((1 << 20) * s_out)))
        lo, hi = c.act()

        def run(a, b, *_):
            sa = r1((a.to(torch.int64) - z1) * (1 << 20))
            sb = r2((b.to(torch.int64) - z2) * (1 << 20))
            return (r_out(sa + sign * sb) + z_out).clamp(lo, hi).to(torch.int8)
        return run
    return prepare


def _int8_mul(c: _Int8Op):
    (s1, z1), (s2, z2) = c.q(0), c.q(1)
    requant = _requantizer(c, s1 * s2 / c.out[0], ())
    return lambda a, b, *_: requant((a.to(torch.int64) - z1) * (b.to(torch.int64) - z2))


def _same_params(c: _Int8Op, inputs) -> None:
    """The builtins whose int8 kernels compare or copy values: every input
    at the output's scale and zero point (TF's int8 kernels refuse or
    ignore any other)."""
    for k in inputs:
        if c.q(k) != c.out:
            raise NotImplementedError(f"TFLite executor: int8 {c.name} with input "
                                      f"{c.tensor(k).name} at {c.q(k)} and output at {c.out} "
                                      f"({c.where}); it runs them at one scale")


def _int8_pool(kind: str):
    def prepare(c: _Int8Op):
        _same_params(c, (0,))
        opts = dataclasses.replace(c.opts, fused_activation_function=Activation.NONE)
        lo, hi = c.act()
        k, s = (opts.filter_height, opts.filter_width), (opts.stride_h, opts.stride_w)

        def run(x, *_):
            if kind == "max":
                y = _pool("max")(x.to(torch.float32), opts)
                return y.clamp(lo, hi).to(torch.int8)
            xin = x.to(torch.float64)
            total = F.avg_pool2d(_nchw(xin, opts, k), k, s, divisor_override=1)
            count = F.avg_pool2d(_nchw(torch.ones_like(xin[:1, :, :, :1]), opts, k), k, s,
                                 divisor_override=1)
            acc, n = _exact(total), _exact(count)
            half = n // 2  # the mean rounded half away from zero, as C's truncating division
            mean = torch.where(acc > 0, (acc + half) // n, -((half - acc) // n))
            return mean.clamp(lo, hi).to(torch.int8).permute(0, 2, 3, 1)
        return run
    return prepare


def _int8_sum(c: _Int8Op):
    (s_in, z_in), (s_out, z_out) = c.q(0), c.out
    requantize = fp.Requantizer.of(s_in / s_out, c.device)
    keep = c.opts.keep_dims

    def run(x, axes, *_):
        dims = sorted({int(a) % x.dim() for a in np.asarray(axes).reshape(-1)})
        count = int(np.prod([x.shape[d] for d in dims]))
        total = x.to(torch.int64).sum(dim=dims, keepdim=keep) - z_in * count
        return (requantize(total) + z_out).clamp(fp.INT8_MIN, fp.INT8_MAX).to(torch.int8)
    return run


def _int8_float_function(c: _Int8Op):
    """`SOFTMAX`, `LOGISTIC`, `TANH`: dequantize, the float form, then
    quantize at the output's (fixed) scale and zero point."""
    (s_in, z_in), (s_out, z_out), fn, opts = c.q(0), c.out, BUILTINS[c.name].fn, c.opts
    return lambda x, *_: fp.quantize(fn(fp.dequantize(x, s_in, z_in), opts), s_out,
                                     z_out).to(torch.int8)


def _int8_quantize(c: _Int8Op):
    s_out, z_out = c.out
    if c.tensor(0).type == schema.TensorType.FLOAT32:
        return lambda x, *_: fp.quantize(x, s_out, z_out).to(torch.int8)
    if c.tensor(0).type != schema.TensorType.INT8:
        raise NotImplementedError(f"TFLite executor: QUANTIZE of a "
                                  f"{_TYPE_NAMES.get(c.tensor(0).type)} tensor ({c.where})")
    s_in, z_in = c.q(0)
    requantize = fp.Requantizer.of(s_in / s_out, c.device)
    return lambda x, *_: (requantize(x.to(torch.int64) - z_in) + z_out).clamp(
        fp.INT8_MIN, fp.INT8_MAX).to(torch.int8)


def _int8_dequantize(c: _Int8Op):
    s_in, z_in = c.q(0)
    return lambda x, *_: fp.dequantize(x, s_in, z_in)


def _int8_on_values(c: _Int8Op):
    """A builtin that compares or moves int8 values (an arg max too): its
    float form on them, every int8 input at the output's scale where it
    compares or joins them; a pad fills with the zero point."""
    opts, fn = c.opts, BUILTINS[c.name].fn
    if c.name in ("MAXIMUM", "MINIMUM", "CONCATENATION", "PAD", "PADV2"):
        _same_params(c, [k for k, t in enumerate(c.op.inputs)
                         if t >= 0 and c.tensors[t].type == schema.TensorType.INT8])
    if c.name in ("PAD", "PADV2"):
        zp = c.out[1]
        return lambda x, p, v=None, *_: _pad(x, p, zp if v is None else
                                             int(np.asarray(v).reshape(())))
    return lambda *xs, **extra: fn(*xs, opts, **extra)


class Int8(NamedTuple):
    """An int8 builtin: prepare(_Int8Op) -> fn(*inputs) -> output; the input
    positions the prepared fn holds itself (passed as None)."""
    prepare: Callable
    held: tuple = ()


INT8_BUILTINS: dict[str, Int8] = {
    "QUANTIZE": Int8(_int8_quantize), "DEQUANTIZE": Int8(_int8_dequantize),
    "CONV_2D": Int8(_int8_conv(False), (1, 2)),
    "DEPTHWISE_CONV_2D": Int8(_int8_conv(True), (1, 2)),
    "TRANSPOSE_CONV": Int8(_int8_transpose_conv, (1, 3)),
    "FULLY_CONNECTED": Int8(_int8_fully_connected, (1, 2)),
    "BATCH_MATMUL": Int8(_int8_batch_matmul),
    "ADD": Int8(_int8_add(1)), "SUB": Int8(_int8_add(-1)), "MUL": Int8(_int8_mul),
    "MAX_POOL_2D": Int8(_int8_pool("max")), "AVERAGE_POOL_2D": Int8(_int8_pool("avg")),
    "SUM": Int8(_int8_sum),
    **{name: Int8(_int8_float_function) for name in ("SOFTMAX", "LOGISTIC", "TANH")},
    **{name: Int8(_int8_on_values) for name in (
        "MAXIMUM", "MINIMUM", "CONCATENATION", "RESHAPE", "TRANSPOSE", "PAD", "PADV2",
        "BROADCAST_TO", "GATHER", "STRIDED_SLICE", "ARG_MAX")},
}


def _quantized(t) -> bool:
    return t.quantization is not None and bool(t.quantization.scale)


def _check_int8_tensors(name: str, op, tensors, arrays, where: str) -> bool:
    """Whether `op` runs in int8; raises for a quantized tensor of another
    kind than the executor runs (module text)."""
    int8 = False
    for i in [*op.inputs, *op.outputs]:
        if i < 0:
            continue
        t = tensors[i]
        if t.type == schema.TensorType.INT8:
            int8 = True
        if not _quantized(t):
            if t.type == schema.TensorType.INT8:
                raise NotImplementedError(f"TFLite executor: {name} with an int8 tensor "
                                          f"{t.name} that holds no scale ({where})")
            continue
        kind = _TYPE_NAMES.get(t.type, str(t.type))
        constant = i in arrays
        if t.type not in (schema.TensorType.INT8, schema.TensorType.INT32) or \
                (t.type == schema.TensorType.INT32 and not constant):
            raise NotImplementedError(f"TFLite executor: {name} with a quantized {kind} tensor "
                                      f"{t.name} ({where}); it runs int8 activations, int8 "
                                      f"weights and int32 biases")
        if len(t.quantization.scale) > 1 and not constant:
            raise NotImplementedError(f"TFLite executor: {name} with per-channel {kind} "
                                      f"activations ({t.name}, {where})")
    if int8 and name not in INT8_BUILTINS:
        raise NotImplementedError(f"TFLite executor: int8 {name} ({where}); its int8 builtins "
                                  f"are {', '.join(sorted(INT8_BUILTINS))}")
    return int8


def _dequantized(t, a: np.ndarray) -> np.ndarray:
    """A quantized constant's f32 values (per channel on its quantized axis)."""
    qp = t.quantization
    shape = [1] * a.ndim
    if len(qp.scale) > 1:
        shape[qp.quantized_dimension] = -1
    scale = np.asarray(qp.scale, np.float32).reshape(shape)
    zp = np.asarray(qp.zero_point or [0], np.int64).reshape(shape if len(qp.zero_point or [0])
                                                             > 1 else [1] * a.ndim)
    return ((a.astype(np.int64) - zp).astype(np.float32) * scale).astype(np.float32)


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
            int8 = _check_int8_tensors(name, op, tensors, arrays, where)
            spec = BUILTINS.get(name)
            if spec is None and not int8:
                raise NotImplementedError(f"TFLite executor: builtin {name} ({where}); it runs "
                                          f"{', '.join(sorted(BUILTINS))}")
            if op.builtin_options_2_type or op.custom_options is not None:
                raise NotImplementedError(f"TFLite executor: {name} with options it does not "
                                          f"read ({where})")
            opts = op.builtin_options
            options = spec.options if spec is not None else None
            if op.builtin_options_type and (options is None or opts is None or
                                            not isinstance(opts, options)):
                raise NotImplementedError(f"TFLite executor: {name} with BuiltinOptions type "
                                          f"{op.builtin_options_type} ({where})")
            if opts is None and options is not None:
                opts = options()
            _check_options(name, opts, where)
            if len(op.outputs) != 1:
                raise NotImplementedError(f"TFLite executor: {name} with {len(op.outputs)} "
                                          f"outputs ({where})")
            out = op.outputs[0]
            if name == "DEQUANTIZE" and op.inputs[0] in arrays:  # folded at load
                t = tensors[op.inputs[0]]
                arrays[out] = _dequantized(t, arrays[op.inputs[0]]) if _quantized(t) else \
                    arrays[op.inputs[0]].astype(np.float32)
                continue
            ins = list(op.inputs)
            if int8:
                spec = self._int8_spec(name, op, opts, tensors, arrays, where)
                ins = [-1 if k in INT8_BUILTINS[name].held else t for k, t in enumerate(ins)]
            self.steps.append([name, spec, ins, out, opts])
        for i in (self.input, self.output):
            if _quantized(tensors[i]) or tensors[i].type == schema.TensorType.INT8:
                raise NotImplementedError(
                    f"TFLite executor: a quantized {_TYPE_NAMES.get(tensors[i].type)} input or "
                    f"output ({tensors[i].name}); it runs files with float I/O, as TF's "
                    f"converter writes them from a representative dataset")
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

    def _int8_spec(self, name, op, opts, tensors, arrays, where) -> Builtin:
        """The int8 form of one operator, prepared (its weights laid out on
        the device, its multipliers computed) as a `Builtin` whose inputs
        are read as the float form reads them (shapes and axes on the host)."""
        fn = INT8_BUILTINS[name].prepare(_Int8Op(name, op, opts, tensors, arrays, self.device,
                                                 where))
        float_form = BUILTINS.get(name)
        moves = name in ("RESHAPE", "ARG_MAX")  # they read the output's shape or dtype
        return Builtin(lambda *xs, **extra: fn(*xs[:-1], **(extra if moves else {})),
                       static=float_form.static if float_form else (),
                       wants_shape=bool(float_form and float_form.wants_shape))

    batch = GraphProgram.batch  # the file's static batch, and the chunks over it
    run_batched = GraphProgram.run_batched

    def __call__(self, x, observe: Callable | None = None) -> torch.Tensor:
        """The output on the device; `observe(tensor index, value)`, where
        given, sees the input and every tensor an operator computes."""
        from deeplabv3p_torch.postprocess import _full_f32

        x = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
        x = x.to(self.device, torch.float32)
        if self.input_shape and tuple(x.shape) != self.input_shape:
            raise ValueError(f"the file takes {self.input_shape}, not {tuple(x.shape)}")
        env = dict(self.consts)
        env[self.input] = x
        env[-1] = None
        if observe is not None:
            observe(self.input, x)
        with torch.no_grad(), _full_f32():
            for (name, spec, ins, out, (opts, extra)), frees in zip(self.steps, self.frees):
                env[out] = spec.fn(*[env[t] for t in ins], opts, **extra)
                if observe is not None:
                    observe(out, env[out])
                for t in frees:
                    del env[t]
        return env[self.output]
