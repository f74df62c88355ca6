"""The port's frozen GraphDef (`export/tf/lower.py`'s plain TF ops) -> one
TFLite subgraph of builtins (the port's counterpart of the file TF's
converter writes from the JAX package's jax2tf function,
`deeplabv3p_tpu/export/tf_export.py:export_tflite`).

The map is one to one where TFLite has the builtin, and keeps the GraphDef's
layout: the body stays NCHW with the Transpose pairs around each conv and
pool, and no activation is fused. Constants become buffers (`buffers[0]` is
the empty sentinel every computed tensor points at). The `Placeholder` is
the input, named `image_input`; the terminal `Identity` is the output, the
tensor its input computes, renamed (an alias, with no operator). Each
tensor's static shape and dtype come from one run of the graph on the meta
device (`GraphProgram.value_types`).

- `AddV2`/`Sub`/`Mul`/`RealDiv`/`Maximum`/`Minimum` -> `ADD`/`SUB`/`MUL`/
  `DIV`/`MAXIMUM`/`MINIMUM`; `Exp`/`Sqrt`/`Sigmoid`/`Tanh` -> `EXP`/`SQRT`/
  `LOGISTIC`/`TANH`; `Reciprocal` -> `DIV` of a constant 1.
- `ConcatV2` -> `CONCATENATION`; `Reshape`, `ExpandDims` -> `RESHAPE`;
  `Transpose`, `Pad`, `PadV2`, `BroadcastTo`, `Cast` -> `TRANSPOSE`, `PAD`,
  `PADV2`, `BROADCAST_TO`, `CAST` (a `Cast` to the type its input already
  has is an alias); `GatherV2` -> `GATHER`; `StridedSlice` ->
  `STRIDED_SLICE`; `Sum`/`Max`/`Min` -> `SUM`/`REDUCE_MAX`/`REDUCE_MIN`;
  `MatMul`, `BatchMatMulV2` -> `BATCH_MATMUL`; `ArgMax` -> `ARG_MAX`, int32
  out; a `BiasAdd` not folded into its conv -> `ADD`.
- `Conv2D` -> `CONV_2D` (filter HWIO -> OHWI; a grouped one, whose filter
  holds C_in / groups input channels, as it is); `DepthwiseConv2dNative` ->
  `DEPTHWISE_CONV_2D` (filter (kh, kw, C, m) -> (1, kh, kw, C m),
  `depth_multiplier` m); the `BiasAdd` that alone reads a conv becomes its
  bias input, else the bias is zeros (TFLite's conv kernels want one);
  `Conv2DBackpropInput` -> `TRANSPOSE_CONV` (output shape, weights (C_out,
  kh, kw, C_in), input); `MaxPool`/`AvgPool` -> `MAX_POOL_2D`/
  `AVERAGE_POOL_2D`. Every padding is `VALID`: the GraphDef pads with `Pad`.

`Erf` has no TFLite builtin (no registry model reaches it); it raises
`NotImplementedError` naming the op and the node, as any unmapped op does.

With `float16=True` each f32 constant a conv, a matmul or a `GATHER` reads
as its weights is stored as float16, behind a `DEQUANTIZE` to f32, as TF's
converter writes a float16 file; every other tensor stays f32.
"""

from __future__ import annotations

import numpy as np
import torch

from deeplabv3p_torch.export.tf import graph_pb as pb
from deeplabv3p_torch.export.tflite import schema as S

_TYPE = {torch.float32: S.TensorType.FLOAT32, torch.float16: S.TensorType.FLOAT16,
         torch.float64: S.TensorType.FLOAT64, torch.int32: S.TensorType.INT32,
         torch.int64: S.TensorType.INT64, torch.bool: S.TensorType.BOOL,
         torch.uint8: S.TensorType.UINT8}
_BINARY = {"AddV2": ("ADD", S.AddOptions), "Sub": ("SUB", S.SubOptions),
           "Mul": ("MUL", S.MulOptions), "RealDiv": ("DIV", S.DivOptions),
           "Maximum": ("MAXIMUM", None), "Minimum": ("MINIMUM", None),
           "BiasAdd": ("ADD", S.AddOptions)}
_UNARY = {"Exp": "EXP", "Sqrt": "SQRT", "Sigmoid": "LOGISTIC", "Tanh": "TANH"}
_REDUCE = {"Sum": "SUM", "Max": "REDUCE_MAX", "Min": "REDUCE_MIN"}
_CONVS = ("Conv2D", "DepthwiseConv2dNative")


class _Writer:
    """The subgraph's tensors, buffers and operators as they are written."""

    def __init__(self, float16: bool):
        self.float16 = float16
        self.tensors: list = []
        self.buffers = [S.Buffer()]  # the empty sentinel
        self.ops: list = []
        self.codes: dict[str, int] = {}
        self.cache: dict = {}

    def tensor(self, name: str, shape, ttype: int, data=None) -> int:
        buffer = 0
        if data is not None:
            buffer = len(self.buffers)
            self.buffers.append(S.Buffer(data=np.frombuffer(data, np.uint8)))
        self.tensors.append(S.Tensor(shape=[int(d) for d in shape], type=ttype, buffer=buffer,
                                     name=name))
        return len(self.tensors) - 1

    def const(self, arr, name: str) -> int:
        arr = np.asarray(arr, order="C")
        return self.tensor(name, arr.shape, S.TYPE_OF_NP[arr.dtype],
                           arr.astype(arr.dtype.newbyteorder("<")).tobytes())

    def ints(self, values, name: str) -> int:
        return self.const(np.asarray(values, np.int32), name)

    def op(self, builtin: str, inputs, outputs, options=None) -> None:
        if builtin not in self.codes:
            self.codes[builtin] = len(self.codes)
        self.ops.append(S.Operator(
            opcode_index=self.codes[builtin], inputs=list(inputs), outputs=list(outputs),
            builtin_options_type=S.OPTIONS[type(options)] if options is not None else 0,
            builtin_options=options))

    def weight(self, arr, name: str, key) -> int:
        """A constant a conv, matmul or GATHER reads as its weights: f32, or
        float16 behind a DEQUANTIZE (one for all its readers)."""
        if key not in self.cache:
            arr = np.asarray(arr)
            if self.float16 and arr.dtype == np.float32:
                half = self.const(arr.astype(np.float16), name + "/float16")
                out = self.tensor(name, arr.shape, S.TensorType.FLOAT32)
                self.op("DEQUANTIZE", [half], [out])
                self.cache[key] = out
            else:
                self.cache[key] = self.const(arr, name)
        return self.cache[key]


class _Lowering:
    def __init__(self, graph: pb.GraphDef, types: dict, float16: bool):
        self.w = _Writer(float16)
        self.types = types
        self.consts = {n.name: np.asarray(pb.python_attr(n.attr["value"]))
                       for n in graph.node if n.op == "Const"}
        self.env: dict[str, int] = {}

    def value(self, name: str) -> int:
        """The tensor of a node's output: a constant becomes a buffer once."""
        if name not in self.env:
            if name not in self.consts:
                raise ValueError(f"TFLite lowering: node {name} read before it is computed")
            self.env[name] = self.w.const(self.consts[name], name)
        return self.env[name]

    def static(self, name: str, what: str) -> np.ndarray:
        if name not in self.consts:
            raise NotImplementedError(f"TFLite lowering: {what} computed by the graph")
        return self.consts[name]

    def operand(self, name: str) -> int:
        """A matmul's or GATHER's operand: a constant is its weights."""
        if name in self.consts and name not in self.env:
            return self.w.weight(self.consts[name], name, name)
        return self.value(name)

    def out(self, name: str, like: str | None = None, ttype: int | None = None) -> int:
        """The tensor of a node's output, of the graph's type, or of the type
        of the tensor `like` (an op that only moves data keeps its input's:
        ARG_MAX writes int32 where the graph's ArgMax has int64)."""
        shape, dtype = self.types[name]
        if ttype is None:
            ttype = self.ttype(like) if like is not None else _TYPE[dtype]
        self.env[name] = self.w.tensor(name, shape, ttype)
        return self.env[name]

    def ttype(self, name: str) -> int:
        if name in self.env:
            return self.w.tensors[self.env[name]].type
        return S.TYPE_OF_NP[self.consts[name].dtype] if name in self.consts \
            else _TYPE[self.types[name][1]]

    def rank(self, name: str) -> int:
        return self.consts[name].ndim if name in self.consts else len(self.types[name][0])


def _hw(values) -> tuple[int, int]:
    return int(values[1]), int(values[2])


def _conv(lw: _Lowering, node, ins, a, bias, out_name):
    x, filt = ins[0], lw.static(ins[1], f"the filter of {node.op} {node.name}")
    (sh, sw), (dh, dw) = _hw(a["strides"]), _hw(a.get("dilations", [1, 1, 1, 1]))
    kh, kwid, c, m = filt.shape
    if node.op == "Conv2D":
        weights = filt.transpose(3, 0, 1, 2)  # HWIO -> OHWI
        builtin, options = "CONV_2D", S.Conv2DOptions(
            padding=S.Padding.VALID, stride_w=sw, stride_h=sh, dilation_w_factor=dw,
            dilation_h_factor=dh)
    else:
        weights = filt.reshape(1, kh, kwid, c * m)
        builtin, options = "DEPTHWISE_CONV_2D", S.DepthwiseConv2DOptions(
            padding=S.Padding.VALID, stride_w=sw, stride_h=sh, depth_multiplier=m,
            dilation_w_factor=dw, dilation_h_factor=dh)
    if bias is None:
        b = lw.w.const(np.zeros(weights.shape[0] if node.op == "Conv2D" else c * m, np.float32),
                       node.name + "/zero_bias")
    else:
        b = lw.value(bias)
    w = lw.w.weight(weights, ins[1], (ins[1], builtin))
    lw.w.op(builtin, [lw.value(x), w, b], [lw.out(out_name)], options)


def _conv_transpose(lw: _Lowering, node, ins, a):
    sizes = lw.static(ins[0], "Conv2DBackpropInput's input_sizes")
    filt = lw.static(ins[1], f"the filter of {node.op} {node.name}")  # (kh, kw, C_out, C_in)
    sh, sw = _hw(a["strides"])
    if any(d != 1 for d in a.get("dilations", [1, 1, 1, 1])):
        raise NotImplementedError(f"TFLite lowering: a dilated {node.op} ({node.name})")
    w = lw.w.weight(filt.transpose(2, 0, 1, 3), ins[1], (ins[1], "TRANSPOSE_CONV"))
    lw.w.op("TRANSPOSE_CONV", [lw.w.ints(sizes, node.name + "/output_shape"), w,
                               lw.value(ins[2])], [lw.out(node.name)],
            S.TransposeConvOptions(padding=S.Padding.VALID, stride_w=sw, stride_h=sh))


def _pool(lw: _Lowering, node, ins, a):
    (kh, kw), (sh, sw) = _hw(a["ksize"]), _hw(a["strides"])
    lw.w.op("MAX_POOL_2D" if node.op == "MaxPool" else "AVERAGE_POOL_2D", [lw.value(ins[0])],
            [lw.out(node.name)], S.Pool2DOptions(padding=S.Padding.VALID, stride_w=sw,
                                                 stride_h=sh, filter_width=kw,
                                                 filter_height=kh))


def _one_builtin(lw: _Lowering, node, ins, a) -> None:
    """Every op but the convs, the pools and the output's Identity."""
    op, w, name = node.op, lw.w, node.name
    if op in _BINARY:
        builtin, options = _BINARY[op]
        w.op(builtin, [lw.value(ins[0]), lw.value(ins[1])], [lw.out(name)],
             options() if options else None)
    elif op in _UNARY:
        w.op(_UNARY[op], [lw.value(ins[0])], [lw.out(name)])
    elif op == "Reciprocal":
        w.op("DIV", [w.const(np.float32(1.0), name + "/one"), lw.value(ins[0])],
             [lw.out(name)], S.DivOptions())
    elif op == "Cast":
        if lw.ttype(ins[0]) == _TYPE[lw.types[name][1]]:
            lw.env[name] = lw.value(ins[0])  # already of that type (ARG_MAX writes int32)
        else:
            w.op("CAST", [lw.value(ins[0])], [lw.out(name)])
    elif op in ("Reshape", "ExpandDims"):
        w.op("RESHAPE", [lw.value(ins[0]), w.ints(lw.types[name][0], name + "/shape")],
             [lw.out(name, ins[0])])
    elif op == "Transpose":
        w.op("TRANSPOSE", [lw.value(ins[0]), w.ints(lw.static(ins[1], "a Transpose's perm"),
                                                    name + "/perm")], [lw.out(name, ins[0])])
    elif op == "BroadcastTo":
        w.op("BROADCAST_TO", [lw.value(ins[0]), w.ints(lw.static(ins[1], "a BroadcastTo's "
                                                                 "shape"), name + "/shape")],
             [lw.out(name, ins[0])])
    elif op == "ConcatV2":
        axis = int(lw.static(ins[-1], "a ConcatV2's axis"))
        w.op("CONCATENATION", [lw.value(n) for n in ins[:-1]], [lw.out(name, ins[0])],
             S.ConcatenationOptions(axis=axis % lw.rank(ins[0])))
    elif op in ("Pad", "PadV2"):
        inputs = [lw.value(ins[0]), w.ints(lw.static(ins[1], "pads"), name + "/paddings")]
        if op == "PadV2":
            inputs.append(lw.value(ins[2]))
        w.op("PAD" if op == "Pad" else "PADV2", inputs, [lw.out(name, ins[0])])
    elif op == "GatherV2":
        if a.get("batch_dims", 0):
            raise NotImplementedError(f"TFLite lowering: GatherV2 with batch_dims ({name})")
        params, idx = lw.operand(ins[0]), ins[1]
        indices = (w.ints(lw.consts[idx], idx) if idx in lw.consts and idx not in lw.env
                   else lw.value(idx))
        axis = int(lw.static(ins[2], "a GatherV2's axis")) % lw.rank(ins[0])
        w.op("GATHER", [params, indices], [lw.out(name, ins[0])], S.GatherOptions(axis=axis))
    elif op == "StridedSlice":
        for mask in ("begin_mask", "end_mask", "ellipsis_mask", "new_axis_mask",
                     "shrink_axis_mask"):
            if a.get(mask, 0):
                raise NotImplementedError(f"TFLite lowering: StridedSlice with {mask} ({name})")
        w.op("STRIDED_SLICE", [lw.value(ins[0])] + [
            w.ints(lw.static(n, "StridedSlice bounds"), f"{name}/{k}")
            for n, k in zip(ins[1:], ("begin", "end", "strides"))], [lw.out(name, ins[0])],
            S.StridedSliceOptions())
    elif op in _REDUCE:
        w.op(_REDUCE[op], [lw.value(ins[0]), w.ints(lw.static(ins[1], "reduction axes"),
                                                    name + "/axes")],
             [lw.out(name)], S.ReducerOptions(keep_dims=bool(a.get("keep_dims", False))))
    elif op in ("MatMul", "BatchMatMulV2"):
        adj_x = bool(a.get("transpose_a", False) or a.get("adj_x", False))
        adj_y = bool(a.get("transpose_b", False) or a.get("adj_y", False))
        w.op("BATCH_MATMUL", [lw.operand(ins[0]), lw.operand(ins[1])], [lw.out(name)],
             S.BatchMatMulOptions(adj_x=adj_x, adj_y=adj_y))
    elif op == "ArgMax":
        axis = int(np.asarray(lw.static(ins[1], "an ArgMax's axis")).reshape(()))
        w.op("ARG_MAX", [lw.value(ins[0]), w.ints([axis], name + "/axis")],
             [lw.out(name, ttype=S.TensorType.INT32)],
             S.ArgMaxOptions(output_type=S.TensorType.INT32))
    elif op == "Identity":
        lw.env[name] = lw.value(ins[0])
    else:
        raise NotImplementedError(f"TFLite lowering: no TFLite builtin for TF op {op} "
                                  f"(node {name})")


def lower(graph: pb.GraphDef, float16: bool = False) -> S.Model:
    """The TFLite model of `graph` between the input and the output that the
    reference runner's naming rules find (`export/tf/interp.py`)."""
    from deeplabv3p_torch.export.tf.interp import GraphProgram, _node_of

    program = GraphProgram(graph, device="meta")
    lw = _Lowering(graph, program.value_types(), float16)
    if program.input_shape is None or any(d < 1 for d in program.input_shape):
        raise ValueError(f"TFLite lowering: the input's shape must be static, not "
                         f"{program.input_shape}")
    lw.env[program.input] = lw.w.tensor(program.input, program.input_shape,
                                        S.TensorType.FLOAT32)
    readers: dict[str, list] = {}
    for node, _, _, _ in program.steps:
        for i in node.input:
            readers.setdefault(_node_of(i), []).append(node)
    folded: set[str] = set()  # the BiasAdds that became their conv's bias
    for node, _, _, attrs in program.steps:
        ins = [_node_of(i) for i in node.input if not i.startswith("^")]
        if node.name in folded:
            continue
        if node.op in _CONVS:
            users = readers.get(node.name, [])
            bias = out_name = None
            if len(users) == 1 and users[0].op == "BiasAdd" and \
                    _node_of(users[0].input[1]) in lw.consts:
                bias, out_name = _node_of(users[0].input[1]), users[0].name
                folded.add(out_name)
            _conv(lw, node, ins, attrs, bias, out_name or node.name)
        elif node.op == "Conv2DBackpropInput":
            _conv_transpose(lw, node, ins, attrs)
        elif node.op in ("MaxPool", "AvgPool"):
            _pool(lw, node, ins, attrs)
        else:
            _one_builtin(lw, node, ins, attrs)
    out = lw.value(program.output)
    if out != lw.env[program.input]:
        lw.w.tensors[out].name = program.output  # the output's Identity: an alias
    w = lw.w
    subgraph = S.SubGraph(tensors=w.tensors, inputs=[lw.env[program.input]], outputs=[out],
                          operators=w.ops, name="main")
    return S.Model(version=S.SCHEMA_VERSION,
                   operator_codes=[S.operator_code(b) for b in w.codes],
                   subgraphs=[subgraph], description="deeplabv3p_torch", buffers=w.buffers)
