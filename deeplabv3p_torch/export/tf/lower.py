"""The port's ONNX ModelProto (`export/onnx/convert.export_onnx`) -> a frozen
TensorFlow GraphDef of plain TF ops (the port's counterpart of the frozen
graph `deeplabv3p_tpu/export/tf_export.py:export_frozen_pb` writes through
jax2tf, whose network is one `XlaCallModule` node of serialized StableHLO).

The graph reads a `Placeholder` (f32, the ONNX input's static NHWC shape),
and its one terminal node apart from constants is an `Identity` of the
ONNX output, so the reference's terminal-node rule
(`tf_export.py:227-248`) finds it unaided. Initializers become `Const` nodes
with little-endian `tensor_content`, laid out for the op that reads them.

The body stays NCHW, as the ONNX graph has it, so that reshapes reading NCHW
axes (MobileViT's) stay right untouched. Only the ops TensorFlow's CPU
kernels take in NHWC alone are wrapped in a Transpose pair: `Conv2D`,
`DepthwiseConv2dNative`, `Conv2DBackpropInput`, `MaxPool`, `AvgPool`. A
conv's ONNX pads become a `Pad` node and `VALID` padding (TFLite's converter
takes no `EXPLICIT`); a max pool pads with -inf. A depthwise conv (group =
C_in) is `DepthwiseConv2dNative` with a (kh, kw, C, multiplier) filter,
another grouped conv a `Conv2D` whose filter holds C_in / group input
channels (TensorFlow's CPU kernel runs those). A transposed conv is
`Conv2DBackpropInput` of the full scatter, then a `StridedSlice` of ONNX's
pads. The resize and attention Einsums are `MatMul` / `BatchMatMulV2`.
Every other op of the ONNX converter maps one to one (`LOWERED`); any other
op raises `NotImplementedError` naming it.
"""

from __future__ import annotations

import re

import numpy as np

from deeplabv3p_torch.export.onnx import proto
from deeplabv3p_torch.export.onnx.interp import attributes, tensor_of
from deeplabv3p_torch.export.tf import graph_pb as pb
from deeplabv3p_torch.export.tf.graph_pb import DType, Shape

# ONNX TensorProto elem type -> numpy dtype
_ONNX_NP = {proto.TensorProto.FLOAT: np.float32, proto.TensorProto.DOUBLE: np.float64,
            proto.TensorProto.FLOAT16: np.float16, proto.TensorProto.INT64: np.int64,
            proto.TensorProto.INT32: np.int32, proto.TensorProto.INT8: np.int8,
            proto.TensorProto.UINT8: np.uint8, proto.TensorProto.BOOL: np.bool_}
_I32 = DType(pb.DT_INT32)


def _dt(dtype) -> DType:
    return DType(pb.DT_OF[np.dtype(dtype)])


class _Value:
    """An ONNX value in the GraphDef: the TF node computing it (None for an
    initializer not yet emitted), its static shape, dtype and, for an
    initializer, its array."""

    __slots__ = ("ref", "shape", "dtype", "const")

    def __init__(self, ref, shape, dtype, const=None):
        self.ref, self.shape, self.dtype, self.const = ref, tuple(shape), np.dtype(dtype), const


class _Writer:
    """The GraphDef's nodes with unique, valid names."""

    def __init__(self):
        self.nodes: list[pb.NodeDef] = []
        self.taken: set[str] = set()

    def unique(self, hint: str) -> str:
        name = re.sub(r"[^A-Za-z0-9_.\-/>]", "_", hint)
        name = name if re.match(r"[A-Za-z0-9.]", name) else "n" + name
        out, k = name, 0
        while out in self.taken:
            k += 1
            out = f"{name}_{k}"
        self.taken.add(out)
        return out

    def add(self, op: str, inputs: list[str], hint: str, **attrs) -> str:
        name = self.unique(hint)
        self.nodes.append(pb.NodeDef(name=name, op=op, input=list(inputs),
                                     attr={k: pb.attr_value(v) for k, v in attrs.items()}))
        return name

    def const(self, arr, hint: str, dtype=None) -> str:
        arr = np.asarray(arr, dtype, order="C")
        return self.add("Const", [], hint, dtype=_dt(arr.dtype), value=arr)

    def ints(self, values, hint: str) -> str:
        return self.const(np.asarray(values, np.int32), hint)


def _ints(v: _Value, what: str) -> list[int]:
    if v.const is None:
        raise NotImplementedError(f"TF lowering: {what} computed by the graph, not a constant")
    return [int(x) for x in np.asarray(v.const).reshape(-1)]


class _Lowering:
    def __init__(self):
        self.w = _Writer()

    def ref(self, v: _Value) -> str:
        if v.ref is None:
            v.ref = self.w.const(v.const, "const")
        return v.ref

    def nhwc(self, x: _Value, hint: str) -> str:
        return self.w.add("Transpose", [self.ref(x), self.w.ints([0, 2, 3, 1], hint + "/perm")],
                          hint + "/to_nhwc", T=_dt(x.dtype), Tperm=_I32)

    def nchw(self, y: str, dtype, hint: str) -> str:
        return self.w.add("Transpose", [y, self.w.ints([0, 3, 1, 2], hint + "/perm_back")],
                          hint, T=_dt(dtype), Tperm=_I32)

    def pad_nhwc(self, t: str, pads, dtype, hint: str, value: float = 0.0) -> str:
        """ONNX 2-D pads [top, left, bottom, right] on an NHWC tensor."""
        if not any(pads):
            return t
        paddings = self.w.ints([[0, 0], [pads[0], pads[2]], [pads[1], pads[3]], [0, 0]],
                               hint + "/paddings")
        if value == 0:
            return self.w.add("Pad", [t, paddings], hint + "/pad", T=_dt(dtype), Tpaddings=_I32)
        fill = self.w.const(np.asarray(value, dtype), hint + "/pad_value")
        return self.w.add("PadV2", [t, paddings, fill], hint + "/pad", T=_dt(dtype),
                          Tpaddings=_I32)


def _window_out(n: int, k: int, s: int, d: int, before: int, after: int) -> int:
    return (n + before + after - ((k - 1) * d + 1)) // s + 1


_BINARY = {"Add": "AddV2", "Sub": "Sub", "Mul": "Mul", "Div": "RealDiv", "Max": "Maximum",
           "Min": "Minimum"}
_UNARY = {"Exp": "Exp", "Sqrt": "Sqrt", "Reciprocal": "Reciprocal", "Sigmoid": "Sigmoid",
          "Erf": "Erf", "Tanh": "Tanh"}
_REDUCE = {"ReduceSum": "Sum", "ReduceMax": "Max", "ReduceMin": "Min"}


def _binary(lw, node, ins, a, hint):
    if node.op_type == "Div" and not np.issubdtype(ins[0].dtype, np.floating):
        raise NotImplementedError("TF lowering: an integer Div")
    out = ins[0]
    for b in ins[1:]:
        ref = lw.w.add(_BINARY[node.op_type], [lw.ref(out), lw.ref(b)], hint, T=_dt(out.dtype))
        out = _Value(ref, np.broadcast_shapes(out.shape, b.shape), out.dtype)
    return out


def _unary(lw, node, ins, a, hint):
    x = ins[0]
    return _Value(lw.w.add(_UNARY[node.op_type], [lw.ref(x)], hint, T=_dt(x.dtype)), x.shape,
                  x.dtype)


def _identity(lw, node, ins, a, hint):
    return ins[0]


def _cast(lw, node, ins, a, hint):
    x, dtype = ins[0], np.dtype(_ONNX_NP[a["to"]])
    if dtype == x.dtype:
        return x
    return _Value(lw.w.add("Cast", [lw.ref(x)], hint, SrcT=_dt(x.dtype), DstT=_dt(dtype),
                           Truncate=False), x.shape, dtype)


def _reshape(lw, node, ins, a, hint):
    x = ins[0]
    shape = _ints(ins[1], "a Reshape's shape")
    if -1 in shape:
        known = int(np.prod([d for d in shape if d != -1]))
        shape[shape.index(-1)] = int(np.prod(x.shape)) // known
    return _Value(lw.w.add("Reshape", [lw.ref(x), lw.w.ints(shape, hint + "/shape")], hint,
                           T=_dt(x.dtype), Tshape=_I32), shape, x.dtype)


def _transpose(lw, node, ins, a, hint):
    x = ins[0]
    perm = a.get("perm", list(range(len(x.shape)))[::-1])
    return _Value(lw.w.add("Transpose", [lw.ref(x), lw.w.ints(perm, hint + "/perm")], hint,
                           T=_dt(x.dtype), Tperm=_I32), [x.shape[p] for p in perm], x.dtype)


def _concat(lw, node, ins, a, hint):
    rank = len(ins[0].shape)
    axis = a["axis"] % rank
    shape = list(ins[0].shape)
    shape[axis] = sum(v.shape[axis] for v in ins)
    ref = lw.w.add("ConcatV2", [lw.ref(v) for v in ins] + [lw.w.ints(axis, hint + "/axis")],
                   hint, N=len(ins), T=_dt(ins[0].dtype), Tidx=_I32)
    return _Value(ref, shape, ins[0].dtype)


def _expand(lw, node, ins, a, hint):
    x = ins[0]
    shape = np.broadcast_shapes(x.shape, tuple(_ints(ins[1], "an Expand's shape")))
    return _Value(lw.w.add("BroadcastTo", [lw.ref(x), lw.w.ints(shape, hint + "/shape")], hint,
                           T=_dt(x.dtype), Tidx=_I32), shape, x.dtype)


def _gather(lw, node, ins, a, hint):
    x, idx = ins
    axis = a.get("axis", 0) % len(x.shape)
    if idx.const is not None and idx.ref is None:  # TF's CPU kernel takes no negative index
        idx = _Value(None, idx.shape, idx.dtype,
                     np.where(idx.const < 0, idx.const + x.shape[axis], idx.const))
    ref = lw.w.add("GatherV2", [lw.ref(x), lw.ref(idx), lw.w.ints(axis, hint + "/axis")], hint,
                   Tparams=_dt(x.dtype), Tindices=_dt(idx.dtype), Taxis=_I32, batch_dims=0)
    return _Value(ref, x.shape[:axis] + idx.shape + x.shape[axis + 1:], x.dtype)


def _slice(lw, node, ins, a, hint):
    x = ins[0]
    starts, ends = _ints(ins[1], "Slice starts"), _ints(ins[2], "Slice ends")
    axes = _ints(ins[3], "Slice axes") if len(ins) > 3 else list(range(len(starts)))
    steps = _ints(ins[4], "Slice steps") if len(ins) > 4 else [1] * len(starts)
    begin, end = [0] * len(x.shape), list(x.shape)
    strides = [1] * len(x.shape)
    for s, e, ax, st in zip(starts, ends, axes, steps):
        if st <= 0:
            raise NotImplementedError("TF lowering: a Slice with a step below 1")
        ax %= len(x.shape)
        begin[ax], end[ax], strides[ax] = slice(s, e, st).indices(x.shape[ax])
    shape = [len(range(b, e, s)) for b, e, s in zip(begin, end, strides)]
    return _Value(_strided_slice(lw, lw.ref(x), begin, end, strides, x.dtype, hint), shape,
                  x.dtype)


def _strided_slice(lw, ref, begin, end, strides, dtype, hint) -> str:
    return lw.w.add("StridedSlice", [ref, lw.w.ints(begin, hint + "/begin"),
                                     lw.w.ints(end, hint + "/end"),
                                     lw.w.ints(strides, hint + "/strides")], hint,
                    T=_dt(dtype), Index=_I32, begin_mask=0, end_mask=0, ellipsis_mask=0,
                    new_axis_mask=0, shrink_axis_mask=0)


def _pad(lw, node, ins, a, hint):
    if a.get("mode", "constant") != "constant":
        raise NotImplementedError(f"TF lowering: Pad mode {a['mode']}")
    x = ins[0]
    pads = _ints(ins[1], "Pad pads")
    rank = len(x.shape)
    if min(pads) < 0:
        raise NotImplementedError("TF lowering: a negative pad (a crop)")
    value = 0.0
    if len(ins) > 2 and ins[2] is not None and ins[2].const is not None and ins[2].const.size:
        value = ins[2].const.reshape(()).item()
    paddings = lw.w.ints([[pads[i], pads[i + rank]] for i in range(rank)], hint + "/paddings")
    shape = [d + pads[i] + pads[i + rank] for i, d in enumerate(x.shape)]
    if value == 0:
        ref = lw.w.add("Pad", [lw.ref(x), paddings], hint, T=_dt(x.dtype), Tpaddings=_I32)
    else:
        fill = lw.w.const(np.asarray(value, x.dtype), hint + "/value")
        ref = lw.w.add("PadV2", [lw.ref(x), paddings, fill], hint, T=_dt(x.dtype),
                       Tpaddings=_I32)
    return _Value(ref, shape, x.dtype)


def _reduce(lw, node, ins, a, hint):
    x = ins[0]
    rank = len(x.shape)
    axes = _ints(ins[1], "reduction axes") if len(ins) > 1 else a.get("axes", [])
    axes = sorted(ax % rank for ax in axes) if axes else list(range(rank))
    keep = bool(a.get("keepdims", 1))
    ref = lw.w.add(_REDUCE[node.op_type], [lw.ref(x), lw.w.ints(axes, hint + "/axes")], hint,
                   T=_dt(x.dtype), Tidx=_I32, keep_dims=keep)
    shape = [1 if i in axes else d for i, d in enumerate(x.shape) if keep or i not in axes]
    return _Value(ref, shape, x.dtype)


def _einsum(lw, node, ins, a, hint):
    eq = a["equation"].replace(" ", "")
    x, m = ins
    T = _dt(x.dtype)
    if eq == "nchw,hy->ncyw":  # a resize of H: (Y, H) @ (N, C, H, W)
        if m.const is None:
            raise NotImplementedError("TF lowering: a resize whose matrix the graph computes")
        matrix = lw.w.const(np.asarray(m.const).T, hint + "/matrix")
        ref = lw.w.add("BatchMatMulV2", [matrix, lw.ref(x)], hint, T=T)
        return _Value(ref, (*x.shape[:2], m.shape[1], x.shape[3]), x.dtype)
    if eq == "nchw,wx->nchx":  # a resize of W: (N, C, H, W) @ (W, X)
        ref = lw.w.add("BatchMatMulV2", [lw.ref(x), lw.ref(m)], hint, T=T)
        return _Value(ref, (*x.shape[:3], m.shape[1]), x.dtype)
    if eq == "ij,jk->ik":
        return _Value(lw.w.add("MatMul", [lw.ref(x), lw.ref(m)], hint, T=T),
                      (x.shape[0], m.shape[1]), x.dtype)
    if eq == "bij,bjk->bik":
        return _Value(lw.w.add("BatchMatMulV2", [lw.ref(x), lw.ref(m)], hint, T=T),
                      (x.shape[0], x.shape[1], m.shape[2]), x.dtype)
    raise NotImplementedError(f"TF lowering: Einsum equation {eq!r}")


def _conv(lw, node, ins, a, hint):
    x, w = ins[0], ins[1]
    b = ins[2] if len(ins) > 2 else None
    if a.get("auto_pad", "NOTSET") != "NOTSET" or len(x.shape) != 4:
        raise NotImplementedError("TF lowering: a Conv that is not 2-D with explicit pads")
    kw = w.const if w.ref is None else None
    if kw is None:
        raise NotImplementedError("TF lowering: a Conv whose weights the graph computes")
    o, i_g, kh, kwid = kw.shape
    group = a.get("group", 1)
    strides, dil = a.get("strides", [1, 1]), a.get("dilations", [1, 1])
    pads = a.get("pads", [0, 0, 0, 0])
    t = lw.pad_nhwc(lw.nhwc(x, hint), pads, x.dtype, hint)
    common = dict(T=_dt(x.dtype), strides=[1, *strides, 1], padding="VALID",
                  dilations=[1, *dil, 1], data_format="NHWC")
    if group == x.shape[1] and i_g == 1 and group > 1:  # depthwise: (kh, kw, C, multiplier)
        filt = kw.reshape(group, o // group, kh, kwid).transpose(2, 3, 0, 1)
        y = lw.w.add("DepthwiseConv2dNative", [t, lw.w.const(filt, hint + "/filter")],
                     hint + "/depthwise", **common)
    else:  # HWIO, I = C_in / group: TF's CPU Conv2D runs a grouped conv from it
        y = lw.w.add("Conv2D", [t, lw.w.const(kw.transpose(2, 3, 1, 0), hint + "/filter")],
                     hint + "/conv", **common)
    if b is not None:
        y = lw.w.add("BiasAdd", [y, lw.ref(b)], hint + "/bias", T=_dt(x.dtype),
                     data_format="NHWC")
    shape = (x.shape[0], o, *(_window_out(n, k, s, d, pads[i], pads[i + 2]) for i, (n, k, s, d)
                              in enumerate(zip(x.shape[2:], (kh, kwid), strides, dil))))
    return _Value(lw.nchw(y, x.dtype, hint), shape, x.dtype)


def _conv_transpose(lw, node, ins, a, hint):
    x, w = ins[0], ins[1]
    b = ins[2] if len(ins) > 2 else None
    if w.const is None or w.ref is not None:
        raise NotImplementedError("TF lowering: a ConvTranspose whose weights the graph computes")
    if a.get("group", 1) != 1 or any(d != 1 for d in a.get("dilations", [1, 1])) \
            or "output_shape" in a or a.get("auto_pad", "NOTSET") != "NOTSET":
        raise NotImplementedError("TF lowering: a grouped, dilated or output_shape "
                                  "ConvTranspose (TF's CPU Conv2DBackpropInput takes none)")
    c_in, c_out, kh, kwid = w.const.shape
    strides = a.get("strides", [1, 1])
    pads = a.get("pads", [0, 0, 0, 0])
    out_pad = a.get("output_padding", [0, 0])
    full = [(n - 1) * s + k for n, s, k in zip(x.shape[2:], strides, (kh, kwid))]
    out = [f + op - pads[i] - pads[i + 2] for i, (f, op) in enumerate(zip(full, out_pad))]
    # the scatter's size, with the zero rows past its end that output_padding reaches
    # (fewer than a stride: TF's forward conv of that size still gives x's)
    sizes = [max(f, pads[i] + o) for i, (f, o) in enumerate(zip(full, out))]
    t = lw.nhwc(x, hint)
    y = lw.w.add("Conv2DBackpropInput",
                 [lw.w.ints([x.shape[0], *sizes, c_out], hint + "/input_sizes"),
                  lw.w.const(w.const.transpose(2, 3, 1, 0), hint + "/filter"), t],
                 hint + "/conv_transpose", T=_dt(x.dtype), strides=[1, *strides, 1],
                 padding="VALID", dilations=[1, 1, 1, 1], data_format="NHWC")
    if sizes != out or pads[0] or pads[1]:
        y = _strided_slice(lw, y, [0, pads[0], pads[1], 0],
                           [x.shape[0], pads[0] + out[0], pads[1] + out[1], c_out],
                           [1, 1, 1, 1], x.dtype, hint + "/crop")
    if b is not None:
        y = lw.w.add("BiasAdd", [y, lw.ref(b)], hint + "/bias", T=_dt(x.dtype),
                     data_format="NHWC")
    return _Value(lw.nchw(y, x.dtype, hint), (x.shape[0], c_out, *out), x.dtype)


def _pool(lw, node, ins, a, hint):
    x = ins[0]
    kernel = a["kernel_shape"]
    strides = a.get("strides", [1, 1])
    pads = a.get("pads", [0, 0, 0, 0])
    if a.get("ceil_mode", 0) or any(d != 1 for d in a.get("dilations", [1, 1])) \
            or a.get("auto_pad", "NOTSET") != "NOTSET":
        raise NotImplementedError(f"TF lowering: a {node.op_type} with ceil_mode, dilations "
                                  "or auto_pad")
    is_max = node.op_type == "MaxPool"
    if not is_max and any(pads) and not a.get("count_include_pad", 0):
        raise NotImplementedError("TF lowering: an AveragePool over a pad with "
                                  "count_include_pad 0 (TF's AvgPool counts the pad)")
    t = lw.pad_nhwc(lw.nhwc(x, hint), pads, x.dtype, hint, -np.inf if is_max else 0.0)
    y = lw.w.add("MaxPool" if is_max else "AvgPool", [t], hint + "/pool", T=_dt(x.dtype),
                 ksize=[1, *kernel, 1], strides=[1, *strides, 1], padding="VALID",
                 data_format="NHWC")
    shape = (*x.shape[:2], *(_window_out(n, k, s, 1, pads[i], pads[i + 2])
                             for i, (n, k, s) in enumerate(zip(x.shape[2:], kernel, strides))))
    return _Value(lw.nchw(y, x.dtype, hint), shape, x.dtype)


def _argmax(lw, node, ins, a, hint):
    x = ins[0]
    if a.get("select_last_index", 0):
        raise NotImplementedError("TF lowering: ArgMax with select_last_index")
    axis = a.get("axis", 0) % len(x.shape)
    ref = lw.w.add("ArgMax", [lw.ref(x), lw.w.ints(axis, hint + "/axis")], hint,
                   T=_dt(x.dtype), Tidx=_I32, output_type=DType(pb.DT_INT64))
    shape = list(x.shape)
    if a.get("keepdims", 1):
        ref = lw.w.add("ExpandDims", [ref, lw.w.ints(axis, hint + "/dim")], hint + "/keepdims",
                       T=DType(pb.DT_INT64), Tdim=_I32)
        shape[axis] = 1
    else:
        del shape[axis]
    return _Value(ref, shape, np.int64)


LOWERED = {
    **{op: _binary for op in _BINARY}, **{op: _unary for op in _UNARY},
    **{op: _reduce for op in _REDUCE},
    "Identity": _identity, "Cast": _cast, "Reshape": _reshape, "Transpose": _transpose,
    "Concat": _concat, "Expand": _expand, "Gather": _gather, "Slice": _slice, "Pad": _pad,
    "Einsum": _einsum, "Conv": _conv, "ConvTranspose": _conv_transpose, "MaxPool": _pool,
    "AveragePool": _pool, "ArgMax": _argmax,
}


def lower(model: proto.ModelProto, input_name: str = "image_input",
          output_name: str = "Identity") -> pb.GraphDef:
    """The frozen GraphDef of `model`, an ONNX ModelProto with one input
    (static shape) and one output: a Placeholder `input_name`, plain TF ops,
    and an Identity `output_name` of the output."""
    graph = model.graph
    lw = _Lowering()
    lw.w.taken.update({input_name, output_name})
    inits = {t.name: tensor_of(t).numpy() for t in graph.initializer}
    inputs = [vi for vi in graph.input if vi.name not in inits]
    if len(inputs) != 1 or len(graph.output) != 1:
        raise ValueError(f"TF lowering: a graph of one input and one output, not "
                         f"{len(inputs)} and {len(graph.output)}")
    vi = inputs[0]
    dtype = _ONNX_NP[vi.type.tensor_type.elem_type]
    shape = [d.dim_value for d in vi.type.tensor_type.shape.dim]
    lw.w.nodes.append(pb.NodeDef(name=input_name, op="Placeholder", attr={
        "dtype": pb.attr_value(_dt(dtype)), "shape": pb.attr_value(Shape(tuple(shape)))}))
    env = {vi.name: _Value(input_name, shape, dtype)}
    for name, arr in inits.items():
        env[name] = _Value(None, arr.shape, arr.dtype, arr)
    for node in graph.node:
        fn = LOWERED.get(node.op_type)
        if fn is None:
            raise NotImplementedError(f"TF lowering: no lowering for ONNX op {node.op_type} "
                                      f"(node {node.name})")
        ins = [env[n] if n else None for n in node.input]
        env[node.output[0]] = fn(lw, node, ins, attributes(node), node.output[0])
    out = env[graph.output[0].name]
    lw.w.nodes.append(pb.NodeDef(name=output_name, op="Identity", input=[lw.ref(out)],
                                 attr={"T": pb.attr_value(_dt(out.dtype))}))
    return pb.GraphDef(node=lw.w.nodes, versions=pb.VersionDef(producer=pb.PRODUCER))
