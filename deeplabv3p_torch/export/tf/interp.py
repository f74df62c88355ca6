"""An executor of frozen TensorFlow GraphDefs in torch ops on a device (the
port's `FrozenGraphRunner` runs on it; the JAX package's runs the graph in
TensorFlow).

It runs the op set `export/tf/lower.py` writes, with the attributes it
writes, in the manner of `export/onnx/interp.py`: each node is one or a few
eager torch ops, and no kernel here computes a graph. There is no fallback to
TensorFlow, even where it is installed: a node of any other op raises
`NotImplementedError` naming the op and the node. A graph the JAX package
writes (jax2tf) holds its whole network in one `XlaCallModule` node, which
only TensorFlow with XLA runs.

`GraphProgram(graph, input_name, output_name, device)` takes the graph
between one input and one output (the reference's naming rules fill either
when it is None), puts its constants on the device once, and lays each
conv's filter out for torch once; calling it with a tensor or array of the
input's shape returns the output on the device. Its calls run in full f32
(TF32 off for cuDNN and cuBLAS). The device is the card unless the caller
asks for the CPU: without a card, `cuda` raises.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from deeplabv3p_torch.export.tf import graph_pb as pb

_TORCH = {pb.DT_FLOAT: torch.float32, pb.DT_DOUBLE: torch.float64, pb.DT_INT32: torch.int32,
          pb.DT_UINT8: torch.uint8, pb.DT_INT16: torch.int16, pb.DT_INT8: torch.int8,
          pb.DT_INT64: torch.int64, pb.DT_BOOL: torch.bool, pb.DT_HALF: torch.float16}
XLA_REFUSAL = ("the graph holds serialized StableHLO (the JAX package's jax2tf export), which "
               "only TensorFlow with XLA runs; the root eval.py scores such a file")


def _ints(t: torch.Tensor) -> list[int]:
    return [int(v) for v in t.reshape(-1).tolist()]


def _check_layout(node: pb.NodeDef, a: dict) -> None:
    """The NHWC ops run as the port writes them: NHWC and VALID."""
    for name, want in (("padding", "VALID"), ("data_format", "NHWC")):
        if a.get(name, want) != want:
            raise NotImplementedError(f"TF executor: {node.op} {name} {a[name]} (node "
                                      f"{node.name}); the port writes {want}")


def _hw(values):
    """The H and W entries of an NHWC strides / dilations / ksize list."""
    return tuple(values[1:3])


def _conv2d(x, w, a):
    """Conv2D; `w` is the torch (O, I, kh, kw) weight (laid out once when the
    filter is a constant). TF's groups are C_in over the filter's I."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w, None, _hw(a["strides"]), 0,
                 _hw(a.get("dilations", [1, 1, 1, 1])), x.shape[3] // w.shape[1])
    return y.permute(0, 2, 3, 1)


def _depthwise(x, w, a):
    y = F.conv2d(x.permute(0, 3, 1, 2), w, None, _hw(a["strides"]), 0,
                 _hw(a.get("dilations", [1, 1, 1, 1])), x.shape[3])
    return y.permute(0, 2, 3, 1)


def _conv_backprop_input(sizes, w, x, a):
    """Conv2DBackpropInput: the transposed conv of `x` by the (C_in, C_out,
    kh, kw) weight, to the input_sizes given (the rows past the scatter's
    end, fewer than a stride, are zero)."""
    strides, want = _hw(a["strides"]), _hw(_ints(sizes))
    full = [(n - 1) * s + k for n, s, k in zip(x.shape[1:3], strides, w.shape[2:])]
    extra = [n - f for n, f in zip(want, full)]
    if any(e < 0 or e >= s for e, s in zip(extra, strides)):
        raise NotImplementedError(f"Conv2DBackpropInput to {want} from {tuple(x.shape[1:3])}")
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), w, None, strides, 0, tuple(extra), 1,
                           _hw(a.get("dilations", [1, 1, 1, 1])))
    return y.permute(0, 2, 3, 1)


def _pool(kind):
    def run(x, a):
        pool = F.max_pool2d if kind == "max" else F.avg_pool2d
        return pool(x.permute(0, 3, 1, 2), _hw(a["ksize"]), _hw(a["strides"])).permute(0, 2, 3, 1)
    return run


def _pad(x, paddings, value=None, a=None):
    pads = _ints(paddings)
    torch_pads = []
    for ax in reversed(range(x.dim())):
        torch_pads += [pads[2 * ax], pads[2 * ax + 1]]
    fill = 0.0 if value is None else value.reshape(()).item()
    return F.pad(x, torch_pads, value=fill)


def _strided_slice(x, begin, end, strides, a):
    if any(a.get(m, 0) for m in ("begin_mask", "end_mask", "ellipsis_mask", "new_axis_mask",
                                 "shrink_axis_mask")):
        raise NotImplementedError("TF executor: StridedSlice with masks")
    idx = tuple(slice(b, e, s) for b, e, s in zip(_ints(begin), _ints(end), _ints(strides)))
    if any(s.step <= 0 for s in idx):
        raise NotImplementedError("TF executor: StridedSlice with a stride below 1")
    return x[idx]


def _gather(x, idx, axis, a):
    if a.get("batch_dims", 0):
        raise NotImplementedError("TF executor: GatherV2 with batch_dims")
    ax = _ints(axis)[0] % x.dim()
    out = x.index_select(ax, idx.reshape(-1).long())
    return out.reshape(*x.shape[:ax], *idx.shape, *x.shape[ax + 1:])


def _reduce(fn):
    def run(x, axes, a):
        dims = [d % x.dim() for d in _ints(axes)]  # none: TF reduces nothing
        out = x
        for d in sorted(dims, reverse=True):
            out = fn(out, d)
            out = out.unsqueeze(d) if a.get("keep_dims", False) else out
        return out
    return run


def _matmul(x, y, a):
    if a.get("transpose_a", False) or a.get("adj_x", False):
        x = x.transpose(-1, -2)
    if a.get("transpose_b", False) or a.get("adj_y", False):
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


def _argmax(x, axis, a):
    return torch.argmax(x, dim=_ints(axis)[0]).to(_TORCH[a.get("output_type", pb.DT_INT64)])


def _elementwise(fn):
    return lambda *xs: fn(*xs[:-1])  # the last argument is the node's attributes


# op -> fn(*input tensors, attributes); the convs take their torch weight
OPS: dict[str, Callable] = {
    "AddV2": _elementwise(torch.add), "Sub": _elementwise(torch.sub),
    "Mul": _elementwise(torch.mul), "RealDiv": _elementwise(torch.div),
    "Maximum": _elementwise(torch.maximum),
    "Minimum": _elementwise(torch.minimum), "Exp": _elementwise(torch.exp),
    "Sqrt": _elementwise(torch.sqrt), "Reciprocal": _elementwise(torch.reciprocal),
    "Sigmoid": _elementwise(torch.sigmoid), "Erf": _elementwise(torch.erf),
    "Tanh": _elementwise(torch.tanh), "Identity": _elementwise(lambda x: x),
    "Cast": lambda x, a: x.to(_TORCH[a["DstT"]]),
    "Reshape": lambda x, shape, a: x.reshape(_ints(shape)),
    "Transpose": lambda x, perm, a: x.permute(_ints(perm)),
    "ConcatV2": lambda *xs: torch.cat(xs[:-2], dim=_ints(xs[-2])[0]),
    "BroadcastTo": lambda x, shape, a: x.expand(_ints(shape)),
    "ExpandDims": lambda x, dim, a: x.unsqueeze(_ints(dim)[0]),
    "GatherV2": _gather, "StridedSlice": _strided_slice,
    "Pad": lambda x, p, a: _pad(x, p), "PadV2": lambda x, p, v, a: _pad(x, p, v),
    "Sum": _reduce(lambda x, d: x.sum(dim=d)), "Max": _reduce(lambda x, d: x.amax(dim=d)),
    "Min": _reduce(lambda x, d: x.amin(dim=d)),
    "MatMul": _matmul, "BatchMatMulV2": _matmul, "ArgMax": _argmax,
    "BiasAdd": lambda x, b, a: x + b,  # NHWC: the channels last
    "Conv2D": _conv2d, "DepthwiseConv2dNative": _depthwise,
    "Conv2DBackpropInput": _conv_backprop_input,
    "MaxPool": _pool("max"), "AvgPool": _pool("avg"),
}
_NHWC = ("Conv2D", "DepthwiseConv2dNative", "Conv2DBackpropInput", "MaxPool", "AvgPool",
         "BiasAdd")
_FILTERED = ("Conv2D", "DepthwiseConv2dNative", "Conv2DBackpropInput")  # the filter: input 1
# op -> the positions of its inputs read as Python values (ConcatV2: its last)
_STATIC = {"Reshape": (1,), "Transpose": (1,), "BroadcastTo": (1,), "ExpandDims": (1,),
           "GatherV2": (2,), "StridedSlice": (1, 2, 3), "Pad": (1,), "PadV2": (1, 2),
           "Sum": (1,), "Max": (1,), "Min": (1,), "ArgMax": (1,), "Conv2DBackpropInput": (0,)}


def _torch_filter(op: str, hwio: torch.Tensor) -> torch.Tensor:
    """A TF filter as the torch weight its conv takes: Conv2D's (kh, kw, I,
    O) as (O, I, kh, kw); DepthwiseConv2dNative's (kh, kw, C, m) as (C m, 1,
    kh, kw); Conv2DBackpropInput's (kh, kw, C_out, C_in) as (C_in, C_out, kh,
    kw)."""
    if op == "Conv2D":
        return hwio.permute(3, 2, 0, 1).contiguous()
    if op == "DepthwiseConv2dNative":
        kh, kw, c, m = hwio.shape
        return hwio.permute(2, 3, 0, 1).reshape(c * m, 1, kh, kw).contiguous()
    return hwio.permute(3, 2, 0, 1).contiguous()


def _node_of(tensor_name: str) -> str:
    name, _, index = tensor_name.lstrip("^").partition(":")
    if index not in ("", "0"):
        raise NotImplementedError(f"TF executor: output {index} of node {name}")
    return name


def input_tensor_name(graph: pb.GraphDef) -> str:
    """The reference's input rule (tf_export.py:213-226): `image_input:0`,
    else the unique Placeholder."""
    names = {n.name for n in graph.node}
    if "image_input" in names:
        return "image_input:0"
    placeholders = [n.name for n in graph.node if n.op == "Placeholder"]
    if len(placeholders) != 1:
        raise ValueError(f"cannot infer the input tensor (placeholders: {placeholders}); "
                         "pass input_name explicitly")
    return placeholders[0] + ":0"


def output_tensor_name(graph: pb.GraphDef) -> str:
    """The reference's output rule (tf_export.py:227-248): the terminal
    nodes (no consumers; not a Placeholder, Const, NoOp or Assert),
    preferring `pred_mask` / `Softmax` / `Identity` names; ambiguity raises."""
    consumed = {i.lstrip("^").split(":")[0] for n in graph.node for i in n.input}
    terminals = [n.name for n in graph.node if n.name not in consumed
                 and n.op not in ("Placeholder", "Const", "NoOp", "Assert")]
    preferred = [n for n in terminals if "pred_mask" in n or "Softmax" in n
                 or n.split("/")[-1].startswith("Identity")]
    pick = preferred or terminals
    if len(pick) != 1:
        raise ValueError(f"cannot infer the output tensor (terminal nodes: {terminals}); "
                         "pass output_name explicitly")
    return pick[0] + ":0"


class GraphProgram:
    """A decoded GraphDef ready to run on `device` from `input_name` to
    `output_name` (tensor names, `node:0`; None applies the reference's
    rules): the nodes the output needs, in an order that computes each input
    first, their constants on the device, each conv's constant filter in its
    torch layout."""

    def __init__(self, graph: pb.GraphDef, input_name: Optional[str] = None,
                 output_name: Optional[str] = None, device: str | torch.device = "cuda"):
        from deeplabv3p_torch.eval import resolve_device

        self.device = torch.device(device)
        if self.device.type != "meta":  # the meta device only traces shapes (`value_types`)
            resolve_device(self.device.type)  # a cuda device without a card raises
        self.input_name = input_name or input_tensor_name(graph)
        self.output_name = output_name or output_tensor_name(graph)
        by_name = {n.name: n for n in graph.node}
        self.input = _node_of(self.input_name)
        out = _node_of(self.output_name)
        for name in (self.input, out):
            if name not in by_name:
                raise ValueError(f"no node {name} in the graph")
        order = self._needed(by_name, out, self.input)
        for node in order:
            if node.op == "XlaCallModule":
                raise NotImplementedError(f"TF executor: op XlaCallModule (node {node.name}): "
                                          f"{XLA_REFUSAL}")
            if node.op not in OPS and node.op != "Const" and node.name != self.input:
                raise NotImplementedError(f"TF executor: op {node.op} (node {node.name}); "
                                          "it runs the ops export/tf/lower.py writes")
        ph = by_name[self.input]
        self.input_shape = pb.python_attr(ph.attr["shape"]) if "shape" in ph.attr else None
        self.output = out
        arrays: dict[str, np.ndarray] = {}
        self.steps = []
        for node in order:
            if node.name == self.input:
                continue
            attrs = {k: pb.python_attr(v) for k, v in node.attr.items()}
            if node.op == "Const":
                arrays[node.name] = np.array(attrs["value"])
                continue
            ins = [_node_of(i) for i in node.input if not i.startswith("^")]
            if node.op in _NHWC:
                _check_layout(node, attrs)
            self.steps.append([node, OPS[node.op], ins, attrs])
        # a constant read as a shape, an axis or pads stays on the host (read
        # with no sync); a conv's filter is laid out for torch once
        self.consts: dict[str, torch.Tensor] = {}
        for node, _, ins, _ in self.steps:
            static = _STATIC.get(node.op, ()) if node.op != "ConcatV2" else (len(ins) - 1,)
            for k, name in enumerate(ins):
                if name not in arrays:
                    if k == 1 and node.op in _FILTERED:
                        raise NotImplementedError(f"TF executor: {node.op} {node.name} with a "
                                                  "computed filter")
                    continue
                host = k in static
                filt = not host and k == 1 and node.op in _FILTERED
                key = name + ("@host" if host else f"@{node.op}" if filt else "")
                if key not in self.consts:
                    t = torch.from_numpy(arrays[name])
                    t = t if host else t.to(self.device)
                    self.consts[key] = _torch_filter(node.op, t) if filt else t
                ins[k] = key
        last_use: dict[str, int] = {}
        for i, (_, _, ins, _) in enumerate(self.steps):
            for name in ins:
                last_use[name] = i
        # the values each step reads for the last time, freed after it
        self.frees = [[n for n in dict.fromkeys(ins) if last_use.get(n) == i
                       and n not in self.consts and n != self.output]
                      for i, (_, _, ins, _) in enumerate(self.steps)]

    @staticmethod
    def _needed(by_name: dict, out: str, feed: str) -> list:
        """The nodes `out` depends on (control inputs too) up to the fed node
        `feed`, each after its inputs: an iterative depth-first walk (graphs
        run deeper than Python's recursion limit)."""
        order, state, stack = [], {}, [(out, False)]
        while stack:
            name, done = stack.pop()
            if done:
                state[name] = 2
                order.append(by_name[name])
                continue
            if state.get(name):
                if state[name] == 1:
                    raise ValueError(f"the graph has a cycle through {name}")
                continue
            if name not in by_name:
                raise ValueError(f"no node {name} in the graph")
            state[name] = 1
            stack.append((name, True))
            for i in ([] if name == feed else reversed(by_name[name].input)):
                dep = i.lstrip("^").split(":")[0]
                if state.get(dep) != 2:
                    stack.append((dep, False))
        return order

    @property
    def batch(self) -> int:
        """The graph's static batch; 1 when it is unknown."""
        if not self.input_shape or self.input_shape[0] is None or self.input_shape[0] < 1:
            return 1
        return int(self.input_shape[0])

    def __call__(self, x) -> torch.Tensor:
        from deeplabv3p_torch.postprocess import _full_f32

        x = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
        x = x.to(self.device, torch.float32)
        if self.input_shape and any(d >= 0 and d != n for d, n in zip(self.input_shape, x.shape)):
            raise ValueError(f"the graph takes {self.input_shape}, not {tuple(x.shape)}")
        env = dict(self.consts)
        env[self.input] = x
        with torch.no_grad(), _full_f32():
            for (node, fn, ins, attrs), frees in zip(self.steps, self.frees):
                env[node.name] = fn(*[env[n] for n in ins], attrs)
                for name in frees:
                    del env[name]
        return env[self.output]

    def value_types(self) -> dict[str, tuple[tuple, torch.dtype]]:
        """Each computed node's static shape and dtype, from one run on the
        meta device (the program built with `device="meta"`: no data is
        read or written)."""
        if self.device.type != "meta" or not self.input_shape:
            raise ValueError("value_types needs a program on the meta device and a static input")
        env = dict(self.consts)
        env[self.input] = torch.empty(self.input_shape, device="meta")
        out = {self.input: (tuple(self.input_shape), torch.float32)}
        with torch.no_grad():
            for node, fn, ins, attrs in self.steps:
                y = env[node.name] = fn(*[env[n] for n in ins], attrs)
                out[node.name] = (tuple(y.shape), y.dtype)
        return out

    def run_batched(self, images: torch.Tensor) -> torch.Tensor:
        """`images` of any batch through the graph's static batch: chunks of
        it, the last one padded with zeros and its padding dropped from the
        output (the reference runner's loop, tf_export.py:271-285)."""
        mb = self.batch
        outs = []
        for i in range(0, images.shape[0], mb):
            chunk = images[i:i + mb]
            pad = mb - chunk.shape[0]
            if pad:
                chunk = torch.cat([chunk, chunk.new_zeros((pad, *chunk.shape[1:]))])
            got = self(chunk)
            outs.append(got[:mb - pad] if pad else got)
        return torch.cat(outs)
