"""`torch.export` ATen graph -> ONNX ModelProto (the port's counterpart of
deeplabv3p_tpu/export/onnx/convert.py, which converts a jaxpr).

`torch.onnx.export` needs the `onnx` package (and, for its dynamo route,
`onnxscript`), which neither this repository's machines nor its users'
deployment boxes are assumed to have, so the port converts the program that
`export.pt2.export_model` already captures:

1. `pt2.Inference` (NHWC f32 images in, softmax probabilities, logits or the
   int32 mask out) is exported by `pt2.export_model`, which runs one eager
   forward first: on the card that forward launches the model's kernels;
2. `run_decompositions` lowers it to core ATen, and expands the three
   `deeplabv3p::` operators (`ops/kernels/_build.LIB`) into their plain
   versions, the operators' CPU implementations: ONNX has no such op, and no
   `deeplabv3p` node reaches the file;
3. each node whose inputs are all constants, parameters or buffers is
   evaluated and becomes an initializer (the JAX design point: BN folds,
   weight casts, the kernels' prepared arguments and index arithmetic fold
   away);
4. the rest becomes opset-13 nodes of the op types in `ENGINE_OPS`, the table
   of the native engine (`inference/onnx_engine.cc`), which both Python
   executors also run. Softmax is ReduceMax, Sub, Exp, ReduceSum, Div; ReLU
   and ReLU6 are Max and Min against constants; a mean is a ReduceSum and a
   Div; `mm` and `bmm` are Einsums; a bilinear resize is one Einsum an axis
   with a constant matrix, made by applying the graph's own resize op to an
   identity basis, so the file keeps the port's half-pixel and antialias
   sampling exactly; a nearest resize is a Gather with constant indices made
   the same way. With `with_argmax` the graph ends in ArgMax, which only the
   Python executors run (as JAX's).

The body stays NCHW, as the port's models compute: kernels go out as OIHW
constants, and only the two permutes of `Inference` are Transposes (JAX's
NHWC graphs wrap every conv in a Transpose pair). TF-SAME padding, which
the port applies as a `constant_pad_nd` before the conv where it is
asymmetric (ops/conv.py), is folded into the Conv's `pads` ([top, left,
bottom, right]). bf16 is exported as f32, as JAX's exporter does. An op with
no lowering raises `NotImplementedError` naming it.
"""

from __future__ import annotations

import math
import operator
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.nn as nn

from deeplabv3p_torch.export.onnx import proto

OPSET_VERSION = 13
IR_VERSION = 8
# the op types of the native engine's table (inference/onnx_engine.cc, OpTable)
ENGINE_OPS = frozenset({
    "Add", "Sub", "Mul", "Div", "Max", "Min", "Exp", "Sqrt", "Reciprocal", "Sigmoid", "Erf",
    "Tanh", "Identity", "Equal", "Not", "Where", "Cast", "Reshape", "Transpose", "Concat",
    "Expand", "Gather", "Slice", "Pad", "ReduceSum", "ReduceMax", "ReduceMin", "ReduceProd",
    "ReduceMean", "Einsum", "Conv", "ConvTranspose", "MaxPool", "AveragePool"})

_ONNX_DTYPE = {
    torch.float32: proto.TensorProto.FLOAT, torch.float64: proto.TensorProto.DOUBLE,
    torch.float16: proto.TensorProto.FLOAT16, torch.bfloat16: proto.TensorProto.FLOAT,
    torch.int64: proto.TensorProto.INT64, torch.int32: proto.TensorProto.INT32,
    torch.int8: proto.TensorProto.INT8, torch.uint8: proto.TensorProto.UINT8,
    torch.bool: proto.TensorProto.BOOL,
}
_FLOATS = (torch.float32, torch.float16, torch.bfloat16)
_NP_ONNX = {np.dtype(np.float32): proto.TensorProto.FLOAT,
            np.dtype(np.int64): proto.TensorProto.INT64,
            np.dtype(np.int32): proto.TensorProto.INT32,
            np.dtype(np.int8): proto.TensorProto.INT8, np.dtype(np.uint8): proto.TensorProto.UINT8,
            np.dtype(np.bool_): proto.TensorProto.BOOL}
_TORCH_NP = {torch.int64: np.int64, torch.int32: np.int32, torch.bool: np.bool_}

aten = torch.ops.aten


def _expansions() -> dict:
    """The `deeplabv3p::` operators -> their plain versions (each operator's
    CPU implementation), for `run_decompositions`."""
    from deeplabv3p_torch.ops.kernels import aspp, decoder, mbconv

    ops = torch.ops.deeplabv3p
    return {ops.multirate_atrous_depthwise.default: aspp._plain,
            ops.fused_decoder_frontend.default: decoder._plain,
            ops.fused_inverted_residual.default: mbconv._plain}


class _Sym:
    """A value computed by the ONNX graph: its name, static shape and torch
    dtype (bf16 stands as f32)."""

    __slots__ = ("name", "shape", "dtype")

    def __init__(self, name: str, shape, dtype):
        self.name, self.shape = name, tuple(int(d) for d in shape)
        self.dtype = torch.float32 if dtype in _FLOATS else dtype


def _np_of(t: torch.Tensor) -> np.ndarray:
    t = t.detach().to("cpu")
    if t.dtype in (torch.bfloat16, torch.float16, torch.float64):
        t = t.float()
    return np.ascontiguousarray(t.numpy())


def tensor_proto(name: str, arr: np.ndarray) -> proto.TensorProto:
    return proto.TensorProto(dims=list(arr.shape), data_type=_NP_ONNX[arr.dtype], name=name,
                             raw_data=arr.tobytes())


def make_attribute(name: str, value) -> proto.AttributeProto:
    a = proto.AttributeProto(name=name)
    if isinstance(value, (bool, int, np.integer)):
        a.type, a.i = proto.AttributeProto.INT, int(value)
    elif isinstance(value, float):
        a.type, a.f = proto.AttributeProto.FLOAT, value
    elif isinstance(value, str):
        a.type, a.s = proto.AttributeProto.STRING, value.encode()
    elif all(isinstance(v, (int, np.integer)) for v in value):
        a.type, a.ints = proto.AttributeProto.INTS, [int(v) for v in value]
    else:
        a.type, a.floats = proto.AttributeProto.FLOATS, [float(v) for v in value]
    return a


def value_info(name: str, shape, elem_type: int) -> proto.ValueInfoProto:
    dims = [proto.TensorShapeProto.Dimension(dim_value=int(d)) for d in shape]
    return proto.ValueInfoProto(name=name, type=proto.TypeProto(
        tensor_type=proto.TypeProto.Tensor(elem_type=elem_type,
                                           shape=proto.TensorShapeProto(dim=dims))))


class _Builder:
    """Nodes and initializers, unique names, and each emitted value's
    producing node."""

    def __init__(self):
        self.nodes: list[proto.NodeProto] = []
        self.initializers: dict[str, proto.TensorProto] = {}
        self.producer: dict[str, proto.NodeProto] = {}
        self._count = 0
        self._consts: dict = {}
        self._held: list = []

    def fresh(self, hint: str) -> str:
        self._count += 1
        return f"{hint}_{self._count}"

    def node(self, op_type: str, inputs: list[str], like: _Sym | tuple, **attrs) -> _Sym:
        """Emit one node; its output is a value shaped like `like`, a _Sym
        or a (shape, dtype) pair."""
        shape, dtype = (like.shape, like.dtype) if isinstance(like, _Sym) else like
        out = _Sym(self.fresh(op_type.lower()), shape, dtype)
        n = proto.NodeProto(input=list(inputs), output=[out.name], name=self.fresh(op_type),
                            op_type=op_type,
                            attribute=[make_attribute(k, v) for k, v in attrs.items()])
        self.nodes.append(n)
        self.producer[out.name] = n
        return out

    def constant(self, value: torch.Tensor | np.ndarray, hint: str = "const") -> str:
        """An initializer's name: small constants shared by content, large
        ones by identity (the tensor held, so its id cannot be reused)."""
        arr = value if isinstance(value, np.ndarray) else _np_of(value)
        if arr.size <= 1024:
            key = (arr.tobytes(), arr.shape, arr.dtype.str)
        else:
            self._held.append(value)
            key = ("id", id(value))
        if key not in self._consts:
            name = self.fresh(hint)
            self.initializers[name] = tensor_proto(name, arr)
            self._consts[key] = name
        return self._consts[key]

    def ints(self, values, hint: str) -> str:
        return self.constant(np.asarray(values, np.int64).reshape(-1), hint)


def _meta(node) -> tuple:
    """(shape, dtype) of the node's (first) output."""
    val = node.meta["val"]
    if isinstance(val, (tuple, list)):
        val = val[0]
    return tuple(val.shape), val.dtype


class _Converter:
    def __init__(self):
        self.b = _Builder()
        # emitted Transposes: output name -> (input value, perm), composed
        # with a Transpose of their output
        self.transposed: dict[str, tuple[_Sym, list]] = {}
        # emitted zero Pads of H and W: output name -> (input value, pads as
        # Conv pads, the fx node), folded into a Conv that is their one user
        self.zero_pads: dict[str, tuple[_Sym, list, Any]] = {}

    def name(self, v, dtype=torch.float32) -> str:
        """The graph name of a value: a _Sym's own, or a constant's (a
        Python number becomes a 0-d constant of `dtype`)."""
        if isinstance(v, _Sym):
            return v.name
        if isinstance(v, torch.Tensor):
            return self.b.constant(v)
        return self.b.constant(np.asarray(v, np.float32 if dtype in _FLOATS
                                          else _TORCH_NP[dtype]))

    def binary(self, op_type: str, a, b, node) -> _Sym:
        like = a if isinstance(a, _Sym) else b
        return self.b.node(op_type, [self.name(a, like.dtype), self.name(b, like.dtype)],
                           (_meta(node)[0], like.dtype))

    def reshape(self, x: _Sym, shape) -> _Sym:
        shape = tuple(int(d) for d in shape)
        if shape == x.shape:
            return x
        return self.b.node("Reshape", [x.name, self.b.ints(shape, "shape")], (shape, x.dtype))

    def transpose(self, x: _Sym, perm) -> _Sym:
        perm = [p % len(x.shape) for p in perm]
        if x.name in self.transposed:
            x, inner = self.transposed[x.name]
            perm = [inner[p] for p in perm]
        if perm == list(range(len(perm))):
            return x
        out = self.b.node("Transpose", [x.name], ([x.shape[p] for p in perm], x.dtype),
                          perm=perm)
        self.transposed[out.name] = (x, perm)
        return out

    def reduce(self, op_type: str, x: _Sym, axes, keepdims: bool, node) -> _Sym:
        axes = [a % len(x.shape) for a in axes]
        like = (_meta(node)[0], x.dtype) if node is not None else (
            [1 if i in axes else d for i, d in enumerate(x.shape)], x.dtype)
        if op_type == "ReduceSum":  # opset 13: axes as an input
            return self.b.node(op_type, [x.name, self.b.ints(axes, "axes")], like,
                               keepdims=int(keepdims))
        return self.b.node(op_type, [x.name], like, axes=axes, keepdims=int(keepdims))

    def run(self, ep: torch.export.ExportedProgram, input_names: list[str]) -> list:
        from deeplabv3p_torch.postprocess import _full_f32

        placeholders = {n.name: n for n in ep.graph.nodes if n.op == "placeholder"}
        env: dict = {}
        inputs = iter(input_names)
        for spec in ep.graph_signature.input_specs:
            if spec.kind == torch.export.graph_signature.InputKind.USER_INPUT:
                env[spec.arg.name] = _Sym(next(inputs), *_meta(placeholders[spec.arg.name]))
            elif spec.target in ep.state_dict:
                env[spec.arg.name] = ep.state_dict[spec.target]
            else:
                env[spec.arg.name] = ep.constants[spec.target]
        outputs = None
        with torch.no_grad(), _full_f32():
            for node in ep.graph.nodes:
                if node.op == "placeholder":
                    continue
                if node.op == "output":
                    outputs = [env[a.name] if isinstance(a, torch.fx.Node) else a
                               for a in node.args[0]]
                    break
                args, kwargs = torch.fx.node.map_arg((node.args, node.kwargs),
                                                     lambda a: env[a.name])
                symbolic = any(isinstance(env[n.name], _Sym) for n in node.all_input_nodes)
                env[node.name] = self.call(node, args, kwargs, symbolic)
        return outputs

    def call(self, node, args, kwargs, symbolic: bool):
        if node.target is operator.getitem:  # of a multi-output node's tuple
            return args[0][args[1]]
        if not symbolic:  # constant folding
            return node.target(*args, **kwargs)
        handler = _HANDLERS.get(node.target)
        if handler is None:
            raise NotImplementedError(f"ONNX export: no lowering for {node.target} "
                                      f"(node {node.name})")
        return handler(self, node, *args, **kwargs)


_HANDLERS: dict = {}


def _lower(*targets):
    def deco(fn: Callable) -> Callable:
        for t in targets:
            _HANDLERS[t] = fn
        return fn
    return deco


@_lower(aten.add.Tensor, aten.sub.Tensor)
def _add_sub(cv, node, a, b, alpha=1):
    if alpha != 1:
        b = b * alpha if not isinstance(b, _Sym) else cv.binary("Mul", b, alpha, node)
    return cv.binary("Add" if node.target is aten.add.Tensor else "Sub", a, b, node)


@_lower(aten.mul.Tensor, aten.div.Tensor, aten.maximum.default, aten.minimum.default)
def _binary(cv, node, a, b, rounding_mode=None):
    if rounding_mode is not None:
        raise NotImplementedError(f"ONNX export: division with rounding_mode={rounding_mode}")
    op_type = {aten.mul.Tensor: "Mul", aten.div.Tensor: "Div", aten.maximum.default: "Max",
               aten.minimum.default: "Min"}[node.target]
    return cv.binary(op_type, a, b, node)


@_lower(aten.relu.default, aten.clamp.default, aten.clamp_min.default, aten.clamp_max.default,
        aten.hardtanh.default)
def _clamp(cv, node, x, lo=None, hi=None):
    if node.target is aten.relu.default:
        lo = 0.0
    elif node.target is aten.clamp_max.default:
        lo, hi = None, lo
    elif node.target is aten.hardtanh.default:
        lo = -1.0 if lo is None else lo
        hi = 1.0 if hi is None else hi
    if lo is not None:
        x = cv.binary("Max", x, float(lo), node)
    if hi is not None:
        x = cv.binary("Min", x, float(hi), node)
    return x


@_lower(aten.sigmoid.default, aten.tanh.default, aten.exp.default, aten.sqrt.default,
        aten.erf.default, aten.reciprocal.default, aten.rsqrt.default, aten.neg.default)
def _unary(cv, node, x):
    if node.target is aten.neg.default:
        return cv.binary("Mul", x, -1.0, node)
    if node.target is aten.rsqrt.default:
        return cv.b.node("Reciprocal", [cv.b.node("Sqrt", [x.name], x).name], x)
    op_type = {aten.sigmoid.default: "Sigmoid", aten.tanh.default: "Tanh",
               aten.exp.default: "Exp", aten.sqrt.default: "Sqrt", aten.erf.default: "Erf",
               aten.reciprocal.default: "Reciprocal"}[node.target]
    return cv.b.node(op_type, [x.name], x)


@_lower(aten.gelu.default)
def _gelu(cv, node, x, approximate="none"):
    if approximate == "tanh":  # 0.5 x (1 + tanh(sqrt(2 / pi) (x + 0.044715 x^3)))
        cube = cv.b.node("Mul", [cv.b.node("Mul", [x.name, x.name], x).name, x.name], x)
        inner = cv.binary("Add", x, cv.binary("Mul", cube, 0.044715, node), node)
        t = cv.b.node("Tanh", [cv.binary("Mul", inner, math.sqrt(2 / math.pi), node).name], x)
    else:  # 0.5 x (1 + erf(x / sqrt(2)))
        t = cv.b.node("Erf", [cv.binary("Mul", x, 1 / math.sqrt(2), node).name], x)
    half = cv.binary("Mul", x, 0.5, node)
    return cv.b.node("Mul", [half.name, cv.binary("Add", t, 1.0, node).name], x)


@_lower(aten.pow.Tensor_Scalar)
def _pow(cv, node, x, exponent):
    if exponent == 2:
        return cv.b.node("Mul", [x.name, x.name], x)
    if exponent == 0.5:
        return cv.b.node("Sqrt", [x.name], x)
    raise NotImplementedError(f"ONNX export: pow with exponent {exponent} (no Pow in the engine)")


@_lower(aten._softmax.default)
def _softmax(cv, node, x, dim, half_to_float=False):
    m = cv.reduce("ReduceMax", x, [dim], True, None)
    e = cv.b.node("Exp", [cv.b.node("Sub", [x.name, m.name], x).name], x)
    s = cv.reduce("ReduceSum", e, [dim], True, None)
    return cv.b.node("Div", [e.name, s.name], x)


@_lower(aten.mean.dim, aten.sum.dim_IntList, aten.amax.default, aten.amin.default)
def _reduce(cv, node, x, dims=None, keepdim=False, dtype=None):
    axes = list(range(len(x.shape))) if not dims else list(dims)
    if node.target is aten.amax.default or node.target is aten.amin.default:
        op_type = "ReduceMax" if node.target is aten.amax.default else "ReduceMin"
        return cv.reduce(op_type, x, axes, keepdim, node)
    out = cv.reduce("ReduceSum", x, axes, keepdim, node)
    if node.target is aten.mean.dim:  # no ReduceMean in JAX's interpreter
        count = math.prod(x.shape[a % len(x.shape)] for a in axes)
        out = cv.binary("Div", out, float(count), node)
    return out


@_lower(aten._native_batch_norm_legit_no_training.default)
def _batch_norm(cv, node, x, weight, bias, mean, var, momentum, eps):
    if any(isinstance(t, _Sym) for t in (weight, bias, mean, var)):
        raise NotImplementedError("ONNX export: batch norm with computed statistics")
    scale = torch.rsqrt(var.float() + eps) * (1.0 if weight is None else weight.float())
    shift = (0.0 if bias is None else bias.float()) - mean.float() * scale
    shape = (1, -1, *([1] * (len(x.shape) - 2)))  # (1, C, 1, 1): the engine folds it into a Conv
    y = cv.b.node("Mul", [x.name, cv.b.constant(scale.reshape(shape), "bn_scale")], x)
    y = cv.b.node("Add", [y.name, cv.b.constant(shift.reshape(shape), "bn_shift")], x)
    return y, None, None


@_lower(aten.convolution.default)
def _convolution(cv, node, x, w, b, stride, padding, dilation, transposed, output_padding,
                 groups):
    if len(x.shape) != 4:
        raise NotImplementedError(f"ONNX export: {len(x.shape) - 2}-D convolution")
    pads = [padding[0], padding[1], padding[0], padding[1]]
    shape, dtype = _meta(node)
    if transposed:
        y = cv.b.node("ConvTranspose", [x.name, cv.name(w)], (shape, x.dtype),
                      strides=list(stride), pads=pads, dilations=list(dilation), group=groups,
                      output_padding=list(output_padding))
        if b is None:
            return y
        return cv.b.node("Add", [y.name, cv.b.constant(b.reshape(1, -1, 1, 1), "bias")], y)
    pad = cv.zero_pads.get(x.name)
    if pad is not None and len(pad[2].users) == 1:  # the TF-SAME pad before this conv
        x, extra, _ = pad
        pads = [p + e for p, e in zip(pads, extra)]
    inputs = [x.name, cv.name(w)] + ([cv.b.constant(b, "bias")] if b is not None else [])
    return cv.b.node("Conv", inputs, (shape, x.dtype), kernel_shape=list(w.shape[2:]),
                     strides=list(stride), pads=pads, dilations=list(dilation), group=groups)


@_lower(aten.constant_pad_nd.default)
def _pad(cv, node, x, pad, value=0.0):
    rank = len(x.shape)
    begins, ends = [0] * rank, [0] * rank
    for i in range(len(pad) // 2):  # torch lists the last axis first
        begins[rank - 1 - i], ends[rank - 1 - i] = pad[2 * i], pad[2 * i + 1]
    if min(begins + ends) < 0:
        raise NotImplementedError("ONNX export: a negative pad (a crop)")
    out = cv.b.node("Pad", [x.name, cv.b.ints(begins + ends, "pads"), cv.name(float(value))],
                    (_meta(node)[0], x.dtype), mode="constant")
    if rank == 4 and value == 0 and begins[:2] == ends[:2] == [0, 0]:
        cv.zero_pads[out.name] = (x, [begins[2], begins[3], ends[2], ends[3]], node)
    return out


@_lower(aten.cat.default)
def _cat(cv, node, tensors, dim=0):
    shape, dtype = _meta(node)
    return cv.b.node("Concat", [cv.name(t, dtype) for t in tensors], (shape, dtype),
                     axis=dim % len(shape))


@_lower(aten.slice.Tensor)
def _slice(cv, node, x, dim=0, start=None, end=None, step=1):
    size = x.shape[dim]
    start = 0 if start is None else (start + size if start < 0 else min(start, size))
    end = size if end is None else (end + size if end < 0 else min(end, size))
    if (start, end, step) == (0, size, 1):
        return x
    args = [x.name] + [cv.b.ints([v], h) for v, h in (
        (start, "starts"), (end, "ends"), (dim % len(x.shape), "axes"), (step, "steps"))]
    return cv.b.node("Slice", args, (_meta(node)[0], x.dtype))


@_lower(aten.select.int)
def _select(cv, node, x, dim, index):
    idx = cv.b.constant(np.asarray(index % x.shape[dim], np.int64), "index")
    return cv.b.node("Gather", [x.name, idx], (_meta(node)[0], x.dtype), axis=dim % len(x.shape))


@_lower(aten.flip.default)
def _flip(cv, node, x, dims):
    for d in dims:
        idx = cv.b.constant(np.arange(x.shape[d] - 1, -1, -1, dtype=np.int64), "indices")
        x = cv.b.node("Gather", [x.name, idx], x, axis=d % len(x.shape))
    return x


@_lower(aten.permute.default)
def _permute(cv, node, x, dims):
    return cv.transpose(x, dims)


@_lower(aten.view.default, aten._unsafe_view.default, aten.reshape.default,
        aten.squeeze.dims, aten.squeeze.dim, aten.squeeze.default, aten.unsqueeze.default)
def _reshape(cv, node, x, *_):
    return cv.reshape(x, _meta(node)[0])


@_lower(aten.expand.default)
def _expand(cv, node, x, *_):
    shape, _dtype = _meta(node)
    if shape == x.shape:
        return x
    return cv.b.node("Expand", [x.name, cv.b.ints(shape, "shape")], (shape, x.dtype))


@_lower(aten.clone.default, aten.alias.default, aten._to_copy.default, aten.detach.default)
def _copy(cv, node, x, **kwargs):
    dtype = kwargs.get("dtype")
    if dtype is None or dtype in _FLOATS or dtype == x.dtype:  # bf16 goes out as f32
        return x
    return cv.b.node("Cast", [x.name], (x.shape, dtype), to=_ONNX_DTYPE[dtype])


@_lower(aten._assert_tensor_metadata.default)
def _assert_metadata(cv, node, *args, **kwargs):
    return None


@_lower(aten.mm.default, aten.bmm.default)
def _matmul(cv, node, a, b):
    eq = "ij,jk->ik" if node.target is aten.mm.default else "bij,bjk->bik"
    return cv.b.node("Einsum", [cv.name(a), cv.name(b)], (_meta(node)[0], torch.float32),
                     equation=eq)


def _axis_maps(node, x: _Sym, args, out_hw) -> list:
    """Per spatial axis, the resize op of `node` applied to an identity
    basis along that axis, the other axis 2 -> 2 (an identity; along an
    axis of size 1 torch's antialiased kernel gives every output the first
    output's weights): (in, out) matrices for bilinear, whose column o holds
    the weights of output o, or (1, out) source rows for nearest."""
    maps = []
    for axis, (n_in, n_out) in enumerate(zip(x.shape[2:], out_hw)):
        if node.target is aten.upsample_nearest2d.vec:
            basis = torch.arange(n_in, dtype=torch.float32).reshape(1, n_in)
        else:
            basis = torch.eye(n_in, dtype=torch.float32)
        rows = basis.shape[0]
        if axis == 0:
            basis, size = basis.reshape(rows, 1, n_in, 1).expand(rows, 1, n_in, 2), [n_out, 2]
        else:
            basis, size = basis.reshape(rows, 1, 1, n_in).expand(rows, 1, 2, n_in), [2, n_out]
        rest = list(args[2:])
        if node.target is aten._upsample_bilinear2d_aa.default:
            rest = [rest[0]]  # align_corners; no scales: the size is given
        else:
            rest[-1] = None  # no scale factors: the size is given
        out = node.target(basis.contiguous(), size, *rest)
        maps.append(out[:, 0, :, 0] if axis == 0 else out[:, 0, 0, :])
    return maps


@_lower(aten.upsample_bilinear2d.vec, aten._upsample_bilinear2d_aa.default)
def _resize_bilinear(cv, node, x, output_size, *rest):
    if output_size is None or any(r is not None for r in rest[1:]):
        raise NotImplementedError("ONNX export: a bilinear resize by scale factors")
    out_hw = _meta(node)[0][2:]
    if tuple(x.shape[2:]) == (1, 1):
        return cv.b.node("Expand", [x.name, cv.b.ints(_meta(node)[0], "shape")],
                         (_meta(node)[0], x.dtype))
    for (n_in, n_out), m, eq in zip(zip(x.shape[2:], out_hw),
                                    _axis_maps(node, x, (x, output_size, *rest), out_hw),
                                    ("nchw,hy->ncyw", "nchw,wx->nchx")):
        if n_in == n_out and torch.equal(m, torch.eye(n_in)):
            continue
        shape = list(x.shape)
        shape[2 if eq.endswith("yw") else 3] = n_out
        x = cv.b.node("Einsum", [x.name, cv.b.constant(m.contiguous(), "resize")],
                      (shape, x.dtype), equation=eq)
    return x


@_lower(aten.upsample_nearest2d.vec)
def _resize_nearest(cv, node, x, output_size, scale_factors=None):
    if output_size is None:
        raise NotImplementedError("ONNX export: a nearest resize by scale factors")
    out_hw = _meta(node)[0][2:]
    for axis, (n_in, idx) in enumerate(zip(x.shape[2:], _axis_maps(
            node, x, (x, output_size, scale_factors), out_hw))):
        idx = idx.reshape(-1).round().to(torch.int64)
        if torch.equal(idx, torch.arange(n_in)):
            continue
        shape = list(x.shape)
        shape[2 + axis] = len(idx)
        x = cv.b.node("Gather", [x.name, cv.b.constant(idx, "indices")], (shape, x.dtype),
                      axis=2 + axis)
    return x


def _pool_args(x, kernel, stride, padding, ceil_mode, node):
    stride = list(stride) or list(kernel)
    padding = [padding] * 2 if isinstance(padding, int) else list(padding)
    if len(padding) == 1:
        padding = padding * 2
    if ceil_mode:
        floor_hw = [(n + 2 * p - k) // s + 1
                    for n, p, k, s in zip(x.shape[2:], padding, kernel, stride)]
        if list(_meta(node)[0][2:]) != floor_hw:
            raise NotImplementedError("ONNX export: a ceil_mode pool that adds a window")
    return dict(kernel_shape=list(kernel), strides=stride,
                pads=[padding[0], padding[1], padding[0], padding[1]])


@_lower(aten.max_pool2d_with_indices.default)
def _max_pool(cv, node, x, kernel, stride=(), padding=0, dilation=1, ceil_mode=False):
    if any(d != 1 for d in ([dilation] if isinstance(dilation, int) else dilation)):
        raise NotImplementedError("ONNX export: dilated max pool")
    attrs = _pool_args(x, kernel, stride, padding, ceil_mode, node)
    return cv.b.node("MaxPool", [x.name], (_meta(node)[0], x.dtype), **attrs), None


@_lower(aten.avg_pool2d.default)
def _avg_pool(cv, node, x, kernel, stride=(), padding=0, ceil_mode=False,
              count_include_pad=True, divisor_override=None):
    if divisor_override is not None:
        raise NotImplementedError("ONNX export: avg pool with divisor_override")
    attrs = _pool_args(x, kernel, stride, padding, ceil_mode, node)
    return cv.b.node("AveragePool", [x.name], (_meta(node)[0], x.dtype),
                     count_include_pad=int(count_include_pad), **attrs)


@_lower(aten.adaptive_avg_pool2d.default, aten._adaptive_avg_pool2d.default)
def _adaptive_avg_pool(cv, node, x, output_size):
    out_hw = list(_meta(node)[0][2:])
    if out_hw == [1, 1]:
        return cv.binary("Div", cv.reduce("ReduceSum", x, [2, 3], True, node),
                         float(x.shape[2] * x.shape[3]), node)
    if any(n % m for n, m in zip(x.shape[2:], out_hw)):
        raise NotImplementedError("ONNX export: adaptive pooling to a size that does not "
                                  "divide the input's")
    kernel = [n // m for n, m in zip(x.shape[2:], out_hw)]
    return cv.b.node("AveragePool", [x.name], (_meta(node)[0], x.dtype), kernel_shape=kernel,
                     strides=kernel, pads=[0, 0, 0, 0], count_include_pad=1)


@_lower(aten.argmax.default)
def _argmax(cv, node, x, dim=None, keepdim=False):
    if dim is None:
        raise NotImplementedError("ONNX export: argmax over all axes")
    return cv.b.node("ArgMax", [x.name], (_meta(node)[0], torch.int64),
                     axis=dim % len(x.shape), keepdims=int(keepdim))


def _live(graph: proto.GraphProto) -> None:
    """Drop the nodes no output needs, then the initializers no node reads."""
    needed = {vi.name for vi in graph.output}
    kept = []
    for n in reversed(graph.node):
        if any(o in needed for o in n.output):
            kept.append(n)
            needed.update(n.input)
    graph.node = kept[::-1]
    graph.initializer = [t for t in graph.initializer if t.name in needed]


def export_onnx(
    model: nn.Module,
    input_shape: tuple[int, int],
    batch_size: int = 1,
    with_softmax: bool = True,
    with_argmax: bool = False,
    *,
    model_name: str = "deeplabv3p_torch",
    input_names: Optional[list[str]] = None,
    output_names: Optional[list[str]] = None,
    doc_string: str = "",
) -> proto.ModelProto:
    """`model` (on its device) as an opset-13 ModelProto for static
    (batch_size, *input_shape, 3) f32 NHWC inputs: the softmax probabilities
    (B, H, W, C) f32 out, or the logits, or with `with_argmax` the int32
    mask (JAX convert.py:734, whose `fn` is this `Inference`).

    The tool's IO names are the reference's: input 'image_input', output
    'pred_mask/Softmax' (tensorflow_to_rknn.py:40-41); by default
    'input_0' / 'output_0' as JAX's."""
    from deeplabv3p_torch.export.pt2 import export_model

    ep = export_model(model, input_shape, batch_size, with_softmax, with_argmax)
    table = torch.export.default_decompositions()
    table.pop(aten.adaptive_avg_pool2d.default, None)  # lowered whole, not as strided views
    table.update(_expansions())
    ep = ep.run_decompositions(table)
    input_names = input_names or ["input_0"]
    cv = _Converter()
    outs = cv.run(ep, input_names)
    output_names = output_names or [f"output_{i}" for i in range(len(outs))]

    graph = proto.GraphProto(name=model_name, doc_string=doc_string)
    graph.input = [value_info(input_names[0], (batch_size, *input_shape, 3),
                              proto.TensorProto.FLOAT)]
    for name, val in zip(output_names, outs):
        if not isinstance(val, _Sym):
            raise ValueError("ONNX export: an output that does not depend on the input")
        src = cv.b.producer.get(val.name)
        if src is not None and val.name not in {i for n in cv.b.nodes for i in n.input}:
            src.output[0] = name  # the last node writes the output itself
        else:
            cv.b.nodes.append(proto.NodeProto(input=[val.name], output=[name],
                                              name=cv.b.fresh("Identity"), op_type="Identity"))
        graph.output.append(value_info(name, val.shape, _ONNX_DTYPE[val.dtype]))
    graph.node = cv.b.nodes
    graph.initializer = list(cv.b.initializers.values())
    _live(graph)
    return proto.ModelProto(ir_version=IR_VERSION, producer_name="deeplabv3p_torch",
                            producer_version="1.0", doc_string=doc_string, graph=graph,
                            opset_import=[proto.OperatorSetIdProto(domain="",
                                                                   version=OPSET_VERSION)])


def save_onnx(model: proto.ModelProto, path: str) -> None:
    with open(path, "wb") as f:
        f.write(model.encode())


def load_onnx(path: str) -> proto.ModelProto:
    with open(path, "rb") as f:
        return proto.ModelProto.decode(f.read())
