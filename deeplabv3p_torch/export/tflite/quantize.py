"""Full-integer post-training quantization of the port's float TFLite model
(`lower.lower`), with float I/O: the file TF's converter writes for the JAX
package with `Optimize.DEFAULT` and a representative dataset
(`deeplabv3p_tpu/export/tf_export.py:export_tflite(quantize="int8")`),
made here without tensorflow. `quantize(model, batches)` runs three passes;
every constant it writes is made in numpy on the host, so the card's file is
byte-equal to the CPU's.

1. Fold (`fold`). Through the `TRANSPOSE` pair around it, each conv's
   (`CONV_2D`, `DEPTHWISE_CONV_2D`, `TRANSPOSE_CONV`) following `MUL`,
   `ADD` and `SUB` by per-channel constants (the BatchNorm the lowering
   writes as `[1, C, 1, 1]` constants) go into its weights and bias: int8
   `MUL` takes one scale a tensor, so a per-channel scale quantized on its
   own would lose its small channels, and each unfolded op would
   requantize. A following `MAXIMUM(., 0)` and `MINIMUM(., 6)` become the
   conv's or the `ADD`'s fused `RELU`/`RELU6` where each output has one
   reader; a `DIV` by a constant becomes a `MUL` by its reciprocal; the
   softmax tail (`REDUCE_MAX`, `SUB`, `EXP`, `SUM`, `DIV` over the last
   axis) one `SOFTMAX`; a `TRANSPOSE` pair that composes to the identity
   goes. The folded float model computes the unfolded one's function (within
   1e-5).
2. Calibrate (`calibrate`): the folded float model runs in `TFLiteProgram`
   on the CPU over the representative batches; the min and max of every
   computed tensor are kept, as TF's calibrator keeps them.
3. Quantize (`_Quantizer`): activations int8 per tensor, asymmetric,
   the range widened to hold 0, scale (max - min) / 255 (TF's
   `GetAsymmetricQuantizationParams`); weights symmetric per channel in
   [-127, 127] with zero point 0, on axis 0 for `CONV_2D` and
   `TRANSPOSE_CONV` and axis 3 for `DEPTHWISE_CONV_2D`; biases int32 at
   scale s_in * s_w[c] (a weight scale raised where a bias would not fit).
   The spec's fixed scales (https://www.tensorflow.org/lite/performance/
   quantization_spec): `SOFTMAX` and `LOGISTIC` out at 1/256 and -128,
   `TANH` at 1/128 and 0; `RESHAPE`, `TRANSPOSE`, `PAD`/`PADV2` (which then
   fill with the zero point), `BROADCAST_TO`, `GATHER`, `STRIDED_SLICE`,
   `MAX_POOL_2D`, `AVERAGE_POOL_2D`, `MAXIMUM` and `MINIMUM` out at their
   input's scale and zero point; the inputs and output of a `CONCATENATION`
   (and the two of a `MAXIMUM`/`MINIMUM`) at one shared scale: the tensors
   they meet through such ops take the union of their ranges, and an input
   whose scale is fixed elsewhere is requantized by a `QUANTIZE`. Other
   constants an int8 builtin reads are quantized per tensor from their own
   range. `QUANTIZE` comes in after the f32 input and `DEQUANTIZE` out
   before the f32 output.

The builtins written as int8 (`INT8_WRITTEN`): `CONV_2D`,
`DEPTHWISE_CONV_2D`, `TRANSPOSE_CONV`, `FULLY_CONNECTED`, `BATCH_MATMUL`,
`ADD`, `SUB`, `MUL`, `MAXIMUM`, `MINIMUM`, `CONCATENATION`, `RESHAPE`,
`TRANSPOSE`, `PAD`, `PADV2`, `BROADCAST_TO`, `GATHER`, `STRIDED_SLICE`,
`MAX_POOL_2D`, `AVERAGE_POOL_2D`, `SUM`, `SOFTMAX`, `LOGISTIC`, `TANH` and
`ARG_MAX`, with `QUANTIZE` and `DEQUANTIZE` around them. Any other builtin
(a `DIV` by a tensor, an `EXP` outside the softmax, `SQRT`, `REDUCE_MAX`,
`CAST`, ...) stays f32 between a `DEQUANTIZE` and a `QUANTIZE`, as TF's converter
keeps an op with no int8 kernel when no `supported_ops` is set, so every
registry entry exports. `export/tflite/interp.py` runs the file.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

import numpy as np

from deeplabv3p_torch.export.tflite import schema as S

F32, I8 = S.TensorType.FLOAT32, S.TensorType.INT8
A = S.Activation

INT8_WRITTEN = ("CONV_2D", "DEPTHWISE_CONV_2D", "TRANSPOSE_CONV", "FULLY_CONNECTED",
                "BATCH_MATMUL", "ADD", "SUB",
                "MUL", "MAXIMUM", "MINIMUM", "CONCATENATION", "RESHAPE", "TRANSPOSE", "PAD",
                "PADV2", "BROADCAST_TO", "GATHER", "STRIDED_SLICE", "MAX_POOL_2D",
                "AVERAGE_POOL_2D", "SUM", "SOFTMAX", "LOGISTIC", "TANH", "ARG_MAX")
# out at their (first computed) input's scale and zero point
_TAKES_INPUT = ("RESHAPE", "TRANSPOSE", "PAD", "PADV2", "BROADCAST_TO", "GATHER",
                "STRIDED_SLICE", "MAX_POOL_2D", "AVERAGE_POOL_2D", "MAXIMUM", "MINIMUM",
                "CONCATENATION")
# the inputs and output at one scale
_SHARED = ("CONCATENATION", "MAXIMUM", "MINIMUM")
_FIXED = {"SOFTMAX": (1.0 / 256, -128), "LOGISTIC": (1.0 / 256, -128), "TANH": (1.0 / 128, 0)}
# builtin -> (filter input, bias input, output-channel axis of the filter)
_WEIGHTED = {"CONV_2D": (1, 2, 0), "DEPTHWISE_CONV_2D": (1, 2, 3), "TRANSPOSE_CONV": (1, 3, 0),
             "FULLY_CONNECTED": (1, 2, 0)}
# the versions TF's converter writes for the int8 forms (its op_version.cc)
INT8_VERSIONS = {"CONV_2D": 3, "DEPTHWISE_CONV_2D": 3, "TRANSPOSE_CONV": 3, "FULLY_CONNECTED": 5,
                 "ADD": 2, "SUB": 2,
                 "MUL": 2, "MAXIMUM": 2, "MINIMUM": 2, "CONCATENATION": 2, "TRANSPOSE": 2,
                 "PAD": 2, "PADV2": 2, "BROADCAST_TO": 3, "GATHER": 2, "STRIDED_SLICE": 2,
                 "MAX_POOL_2D": 2, "AVERAGE_POOL_2D": 2, "SUM": 2, "SOFTMAX": 2, "LOGISTIC": 2,
                 "TANH": 2, "ARG_MAX": 2, "BATCH_MATMUL": 2, "DEQUANTIZE": 2}
_ACTIVATED = ("CONV_2D", "DEPTHWISE_CONV_2D", "ADD")  # those a relu / relu6 is fused into


@dataclasses.dataclass(eq=False)  # operators compare by identity
class _Op:
    name: str
    inputs: list
    outputs: list
    options: object = None
    version: Optional[int] = None


class _Graph:
    """One subgraph as mutable lists: tensors (schema tables), constants'
    arrays by tensor, operators in order, the input and the output."""

    def __init__(self, model: Optional[S.Model] = None):
        self.tensors, self.arrays, self.ops = [], {}, []
        self.input = self.output = -1
        if model is None:
            return
        from deeplabv3p_torch.export.tflite.interp import _array

        g = model.subgraphs[0]
        self.tensors = [dataclasses.replace(t) for t in g.tensors]
        self.arrays = {i: _array(t, model.buffers) for i, t in enumerate(g.tensors)
                       if model.buffers[t.buffer].data is not None}
        for op in g.operators:
            name = S.BUILTIN_NAMES[S.builtin_of(model.operator_codes[op.opcode_index])]
            self.ops.append(_Op(name, list(op.inputs), list(op.outputs), op.builtin_options))
        (self.input,), (self.output,) = g.inputs, g.outputs

    def tensor(self, name: str, shape, ttype: int, quant=None, array=None) -> int:
        self.tensors.append(S.Tensor(shape=[int(d) for d in shape], type=ttype, name=name,
                                     quantization=quant))
        if array is not None:
            self.arrays[len(self.tensors) - 1] = np.ascontiguousarray(array)
        return len(self.tensors) - 1

    def const(self, array: np.ndarray, name: str, quant=None) -> int:
        array = np.asarray(array)
        return self.tensor(name, array.shape, S.TYPE_OF_NP[array.dtype], quant, array)

    def readers(self) -> dict:
        out: dict = {}
        for op in self.ops:
            for t in dict.fromkeys(op.inputs):
                out.setdefault(t, []).append(op)
        return out

    def producers(self) -> dict:
        return {t: op for op in self.ops for t in op.outputs}

    def replace(self, old: int, new: int) -> None:
        """Every read of tensor `old` reads `new`; the output keeps its name."""
        for op in self.ops:
            op.inputs = [new if t == old else t for t in op.inputs]
        if self.output == old:
            self.tensors[new].name = self.tensors[old].name
            self.output = new

    def drop_dead(self) -> None:
        while True:
            used = {t for op in self.ops for t in op.inputs} | {self.output}
            live = [op for op in self.ops if any(t in used for t in op.outputs)]
            if len(live) == len(self.ops):
                return
            self.ops = live

    def model(self) -> S.Model:
        """The schema model of the operators' tensors, renumbered; one buffer
        a constant (buffers[0] the empty sentinel); an operator code a
        builtin and version."""
        used = [self.input]
        for op in self.ops:
            used += [t for t in (*op.inputs, *op.outputs) if t >= 0]
        index = {t: i for i, t in enumerate(dict.fromkeys(used + [self.output]))}
        buffers, tensors = [S.Buffer()], []
        for t in index:
            tensor = dataclasses.replace(self.tensors[t], buffer=0)
            if t in self.arrays:
                a = self.arrays[t]
                data = a.astype(a.dtype.newbyteorder("<")).tobytes()
                tensor.buffer = len(buffers)
                buffers.append(S.Buffer(data=np.frombuffer(data, np.uint8)))
            tensors.append(tensor)
        codes: dict = {}
        operators = []
        for op in self.ops:
            key = (op.name, op.version)
            if key not in codes:
                codes[key] = len(codes)
            operators.append(S.Operator(
                opcode_index=codes[key], inputs=[index[t] if t >= 0 else -1 for t in op.inputs],
                outputs=[index[t] for t in op.outputs],
                builtin_options_type=S.OPTIONS[type(op.options)] if op.options is not None else 0,
                builtin_options=op.options))
        operator_codes = []
        for name, version in codes:
            code = S.operator_code(name)
            if version is not None:
                code.version = version
            operator_codes.append(code)
        graph = S.SubGraph(tensors=tensors, inputs=[index[self.input]],
                           outputs=[index[self.output]], operators=operators, name="main")
        return S.Model(version=S.SCHEMA_VERSION, operator_codes=operator_codes,
                       subgraphs=[graph], description="deeplabv3p_torch", buffers=buffers)


# -- 1. fold ---------------------------------------------------------------------------


def _activation(op) -> int:
    return getattr(op.options, "fused_activation_function", A.NONE) or A.NONE


def _only_reader(g: _Graph, t: int):
    """The one operator that reads `t`, or None (none, several, or the output)."""
    readers = g.readers().get(t, [])
    return readers[0] if len(readers) == 1 and t != g.output else None


def _other(g: _Graph, op, t: int):
    """The constant operand of a binary `op` whose other operand is `t`."""
    if len(op.inputs) != 2 or op.inputs.count(t) != 1:
        return None, None
    k = 1 - op.inputs.index(t)
    c = op.inputs[k]
    if c not in g.arrays or g.tensors[c].type != F32:
        return None, None
    return k, g.arrays[c]


def _per_channel(c: np.ndarray, rank: int, axis: int, channels: int):
    """`c`, broadcast against a rank-`rank` tensor, as one value per channel
    on `axis`; None when it varies along another axis."""
    if c.ndim > rank:
        return None
    shape = (1,) * (rank - c.ndim) + c.shape
    if any(d != 1 for i, d in enumerate(shape) if i != axis) or shape[axis] not in (1, channels):
        return None
    return np.broadcast_to(c.reshape(-1), (channels,)) if shape[axis] == channels else \
        np.full(channels, c.reshape(()), np.float32)


def _through_transposes(g: _Graph, t: int, axis: int):
    """From tensor `t` (channel axis `axis`), down the chain of TRANSPOSEs
    each read alone: the last tensor, its channel axis and the next reader."""
    while True:
        r = _only_reader(g, t)
        if r is None or r.name != "TRANSPOSE" or r.inputs[1] not in g.arrays:
            return t, axis, r
        perm = [int(p) for p in g.arrays[r.inputs[1]]]
        axis = perm.index(axis) if axis in perm else -1
        t = r.outputs[0]


def _div_to_mul(g: _Graph) -> None:
    for op in g.ops:
        if op.name == "DIV" and op.inputs[1] in g.arrays and g.tensors[op.inputs[1]].type == F32:
            c = g.arrays[op.inputs[1]]
            op.inputs[1] = g.const((np.float32(1) / c).astype(np.float32),
                                   g.tensors[op.inputs[1]].name + "/reciprocal")
            op.name, op.options = "MUL", S.MulOptions(fused_activation_function=_activation(op))


def _last_axis(g: _Graph, op, x: int) -> bool:
    axes = g.arrays.get(op.inputs[1])
    rank = len(g.tensors[x].shape)
    return axes is not None and op.options is not None and op.options.keep_dims and \
        [int(a) % rank for a in axes.reshape(-1)] == [rank - 1]


def _softmax(g: _Graph) -> None:
    for div in [op for op in g.ops if op.name == "DIV"]:
        prod = g.producers()
        e, s = div.inputs
        ps, pe = prod.get(s), prod.get(e)
        if ps is None or ps.name != "SUM" or ps.inputs[0] != e or pe is None or \
                pe.name != "EXP" or _activation(div) != A.NONE:
            continue
        sub = prod.get(pe.inputs[0])
        if sub is None or sub.name != "SUB" or _activation(sub) != A.NONE:
            continue
        x, m = sub.inputs
        pm = prod.get(m)
        readers = g.readers()
        if pm is None or pm.name != "REDUCE_MAX" or pm.inputs[0] != x or \
                not (_last_axis(g, pm, x) and _last_axis(g, ps, e)) or \
                [len(readers.get(t, [])) for t in (m, sub.outputs[0], s)] != [1, 1, 1] or \
                {id(r) for r in readers.get(e, [])} != {id(ps), id(div)}:
            continue
        div.name, div.inputs, div.options = "SOFTMAX", [x], S.SoftmaxOptions(beta=1.0)
        g.ops = [op for op in g.ops if op not in (pm, sub, pe, ps)]


def _fold_affine(g: _Graph) -> None:
    """Each conv's per-channel MUL / ADD / SUB by constants, into its weights
    and bias."""
    for conv in [op for op in g.ops if op.name in _WEIGHTED]:
        w_in, b_in, w_axis = _WEIGHTED[conv.name]
        bias = conv.inputs[b_in] if b_in < len(conv.inputs) else -1
        if conv.inputs[w_in] not in g.arrays or (bias >= 0 and bias not in g.arrays) or \
                _activation(conv) != A.NONE:
            continue
        w = g.arrays[conv.inputs[w_in]].astype(np.float32)
        channels = w.shape[w_axis]
        b = g.arrays[bias].astype(np.float32) if bias >= 0 else np.zeros(channels, np.float32)
        folded = False
        t = conv.outputs[0]
        axis = len(g.tensors[t].shape) - 1  # the output's channels are its last axis
        while True:
            t, axis, r = _through_transposes(g, t, axis)
            if r is None or r.name not in ("MUL", "ADD", "SUB") or _activation(r) != A.NONE:
                break
            k, c = _other(g, r, t)
            if c is None or (r.name == "SUB" and k == 0) or \
                    g.tensors[r.outputs[0]].shape != g.tensors[t].shape:
                break
            per = _per_channel(c, len(g.tensors[t].shape), axis, channels) if axis >= 0 else None
            if per is None:
                break
            per = per.astype(np.float32)
            if r.name == "MUL":
                shape = [1] * w.ndim
                shape[w_axis] = channels
                w, b = w * per.reshape(shape), b * per
            else:
                b = b + per if r.name == "ADD" else b - per
            g.replace(r.outputs[0], t)
            g.ops.remove(r)
            folded = True
        if folded:
            name = g.tensors[conv.outputs[0]].name
            conv.inputs[w_in] = g.const(w, name + "/folded_filter")
            conv.inputs += [-1] * (b_in + 1 - len(conv.inputs))
            conv.inputs[b_in] = g.const(b, name + "/folded_bias")


def _is_const(g: _Graph, t: int, value: float) -> bool:
    return t in g.arrays and g.tensors[t].type == F32 and bool(np.all(g.arrays[t] == value))


def _fuse_activations(g: _Graph) -> None:
    for op in [op for op in g.ops if op.name in _ACTIVATED]:
        if _activation(op) != A.NONE:
            continue
        act = A.NONE
        for extremum, value, new in (("MAXIMUM", 0.0, A.RELU), ("MINIMUM", 6.0, A.RELU6)):
            t, _, r = _through_transposes(g, op.outputs[0], 3)
            if r is None or r.name != extremum or len(r.inputs) != 2 or \
                    r.inputs.count(t) != 1 or not _is_const(g, r.inputs[1 - r.inputs.index(t)],
                                                            value):
                break
            g.replace(r.outputs[0], t)
            g.ops.remove(r)
            act = new
        if act != A.NONE:
            op.options = dataclasses.replace(op.options or S.AddOptions(),
                                             fused_activation_function=act)


def _drop_transpose_pairs(g: _Graph) -> None:
    prod = g.producers()
    for t2 in [op for op in g.ops if op.name == "TRANSPOSE"]:
        t1 = prod.get(t2.inputs[0])
        if t1 is None or t1.name != "TRANSPOSE" or t1.inputs[1] not in g.arrays or \
                t2.inputs[1] not in g.arrays:
            continue
        p1, p2 = ([int(v) for v in g.arrays[op.inputs[1]]] for op in (t1, t2))
        x = t1.inputs[0]
        if [p1[i] for i in p2] == list(range(len(p1))) and \
                not (x == g.input and t2.outputs[0] == g.output):
            g.replace(t2.outputs[0], x)
            g.ops.remove(t2)
    g.drop_dead()


def fold(model: S.Model) -> S.Model:
    """The float model with its BatchNorms, relus, divisions by constants
    and softmax folded (module text, pass 1)."""
    g = _Graph(model)
    _div_to_mul(g)
    _softmax(g)
    _fold_affine(g)
    _fuse_activations(g)
    _drop_transpose_pairs(g)
    return g.model()


# -- 2. calibrate ----------------------------------------------------------------------


def calibrate(model: S.Model, batches: Iterable[np.ndarray]) -> dict:
    """{tensor index: (min, max)} of the input and every f32 tensor the model
    computes, over `batches` (NHWC f32 arrays whose batch is a multiple of
    the file's), run on the CPU."""
    import torch

    from deeplabv3p_torch.export.tflite.interp import TFLiteProgram

    program = TFLiteProgram(S.encode_model(model), "cpu")
    ranges: dict = {}

    def observe(t: int, value: torch.Tensor) -> None:
        if value.dtype != torch.float32 or value.numel() == 0:
            return
        lo, hi = float(value.min()), float(value.max())
        old = ranges.get(t)
        ranges[t] = (lo, hi) if old is None else (min(old[0], lo), max(old[1], hi))

    count = 0
    for batch in batches:
        batch = torch.from_numpy(np.asarray(batch, np.float32))
        if batch.shape[0] % program.batch or tuple(batch.shape[1:]) != program.input_shape[1:]:
            raise ValueError(f"a representative batch of shape {tuple(batch.shape)}; the file "
                             f"takes {program.input_shape}")
        for i in range(0, batch.shape[0], program.batch):
            program(batch[i:i + program.batch], observe)
            count += 1
    if not count:
        raise ValueError("int8 quantization needs at least one representative batch")
    return ranges


# -- 3. quantize -----------------------------------------------------------------------


def asymmetric_params(lo: float, hi: float) -> tuple[float, int]:
    """TF's `GetAsymmetricQuantizationParams` for int8: the range widened to
    hold 0, scale (max - min) / 255, the zero point from the end whose terms
    are smaller, rounded and clamped."""
    lo, hi = min(float(np.float32(lo)), 0.0), max(float(np.float32(hi)), 0.0)
    if lo == hi:
        return 1.0, 0
    scale = (hi - lo) / 255.0
    from_min, from_max = -128 - lo / scale, 127 - hi / scale
    zp = from_min if 128 + abs(lo / scale) < 127 + abs(hi / scale) else from_max
    zp = -128 if zp < -128 else 127 if zp > 127 else int(np.copysign(np.floor(abs(zp) + 0.5), zp))
    return float(np.float32(scale)), zp


def _qp(scale, zero_point, axis: int = 0) -> S.QuantizationParameters:
    return S.QuantizationParameters(scale=[float(np.float32(s)) for s in np.atleast_1d(scale)],
                                    zero_point=[int(z) for z in np.atleast_1d(zero_point)],
                                    quantized_dimension=axis)


def _round(x: np.ndarray) -> np.ndarray:
    """TfLiteRound, in float64 (in f32, x + 0.5 itself can round up)."""
    x = np.asarray(x, np.float64)
    return np.where(x >= 0, np.floor(x + 0.5), np.ceil(x - 0.5))


def _quantize_array(a: np.ndarray, scale: float, zp: int) -> np.ndarray:
    q = _round(np.asarray(a, np.float32) / np.float32(scale)) + zp
    return np.clip(q, -128, 127).astype(np.int8)


def _weights(w: np.ndarray, axis: int, b: np.ndarray, s_in: float):
    """Per-channel symmetric int8 weights and int32 bias: (q_w, scales,
    q_b, bias scales). A channel whose bias over s_in * s_w would pass int32
    takes a larger weight scale."""
    moved = np.moveaxis(w.astype(np.float32), axis, 0)
    flat = moved.reshape(moved.shape[0], -1)
    peak = np.abs(flat).max(1) if flat.shape[1] else np.zeros(flat.shape[0], np.float32)
    scales = np.where(peak > 0, peak / np.float32(127), np.float32(1)).astype(np.float32)
    limit = np.abs(b.astype(np.float64)) / (np.float64(s_in) * (2 ** 31 - 1))
    scales = np.maximum(scales, (limit * (1 + 1e-6)).astype(np.float32))
    q = np.clip(_round(flat / scales[:, None]), -127, 127).astype(np.int8)
    q = np.moveaxis(q.reshape(moved.shape), 0, axis)
    bias_scales = (np.float32(s_in) * scales).astype(np.float32)
    q_b = np.clip(_round(b.astype(np.float64) / bias_scales), -(2 ** 31), 2 ** 31 - 1)
    return np.ascontiguousarray(q), scales, q_b.astype(np.int32), bias_scales


class _Find:
    """Union-find over tensor indices (the tensors that share one scale)."""

    def __init__(self):
        self.parent: dict = {}

    def __call__(self, t):
        while self.parent.get(t, t) != t:
            t = self.parent[t]
        return t

    def union(self, a, b) -> None:
        a, b = self(a), self(b)
        if a != b:
            self.parent[b] = a


class _Quantizer:
    def __init__(self, g: _Graph, ranges: dict):
        self.g, self.ranges = g, dict(ranges)
        self.out = _Graph()
        self.f32: dict = {}  # old tensor -> its new tensor of the old type
        self.i8: dict = {}  # old tensor -> its new int8 tensor
        self.params: dict = {}  # new int8 tensor -> (scale, zero point)
        self.requantized: dict = {}
        self.shared: dict = {}  # a shared-scale operator -> its scale and zero point

    # which ops are written as int8 -----------------------------------------------------

    def data_inputs(self, op) -> list:
        """The positions of the f32 inputs an int8 form quantizes as
        activations (the weights and bias of a conv are its own)."""
        held = _WEIGHTED.get(op.name, (None, None))[:2]
        return [k for k, t in enumerate(op.inputs) if t >= 0 and k not in held
                and self.g.tensors[t].type == F32]

    def is_int8(self, op) -> bool:
        if op.name not in INT8_WRITTEN:
            return False
        data = self.data_inputs(op)
        return any(op.inputs[k] not in self.g.arrays for k in data)

    def anchor(self, op) -> int:
        """The first computed data input: the one whose scale a
        `_TAKES_INPUT` builtin's output takes."""
        return next(op.inputs[k] for k in self.data_inputs(op)
                    if op.inputs[k] not in self.g.arrays)

    def share_ranges(self) -> None:
        """The tensors a shared-scale builtin meets, through the builtins that
        keep their input's scale, take the union of their ranges."""
        g, prod, find = self.g, self.g.producers(), _Find()

        def root(t):
            while True:
                p = prod.get(t)
                if p is None or p.name not in _TAKES_INPUT or not self.is_int8(p):
                    return t
                t = self.anchor(p)

        groups = []
        for op in g.ops:
            if op.name in _SHARED and self.is_int8(op):
                members = [op.inputs[k] for k in self.data_inputs(op)
                           if op.inputs[k] not in g.arrays]
                roots = [root(t) for t in members]
                for r in roots[1:]:
                    find.union(roots[0], r)
                groups.append((op, roots, roots + members + [op.outputs[0]]))
        union: dict = {}
        for _, roots, members in groups:
            key = find(roots[0])
            for t in members:
                if t in self.ranges:
                    lo, hi = union.get(key, self.ranges[t])
                    union[key] = (min(lo, self.ranges[t][0]), max(hi, self.ranges[t][1]))
        for op, roots, _ in groups:
            self.shared[op] = asymmetric_params(*union[find(roots[0])])
            for r in roots:  # a root whose scale is fixed keeps it, and is requantized
                self.ranges[r] = union[find(r)]

    # tensors of the new graph -----------------------------------------------------------

    def like(self, t: int, ttype: int, name: str, quant=None) -> int:
        return self.out.tensor(name, self.g.tensors[t].shape, ttype, quant)

    def plain(self, t: int) -> int:
        """The new tensor of `t` of its own type (an f32 one DEQUANTIZEd from
        its int8 form where only that exists)."""
        if t not in self.f32:
            src = self.g.tensors[t]
            if t in self.g.arrays:
                self.f32[t] = self.out.const(self.g.arrays[t], src.name)
            elif t in self.i8:
                self.f32[t] = self.like(t, F32, src.name + "/dequantized")
                self.out.ops.append(_Op("DEQUANTIZE", [self.i8[t]], [self.f32[t]],
                                        version=INT8_VERSIONS["DEQUANTIZE"]))
            else:
                raise ValueError(f"int8 quantization: tensor {src.name} read before it is "
                                 "computed")
        return self.f32[t]

    def params_of(self, t: int) -> tuple[float, int]:
        if t not in self.ranges:
            raise ValueError(f"int8 quantization: no calibrated range for tensor "
                             f"{self.g.tensors[t].name}")
        return asymmetric_params(*self.ranges[t])

    def int8(self, t: int, want: Optional[tuple] = None) -> int:
        """The new int8 tensor of `t` (at `want`'s scale and zero point where
        given): a constant quantized, an f32 tensor through QUANTIZE, an int8
        one at another scale through a requantizing QUANTIZE."""
        src = self.g.tensors[t]
        if t in self.g.arrays:
            scale, zp = want or asymmetric_params(float(self.g.arrays[t].min()),
                                                  float(self.g.arrays[t].max()))
            q = self.out.const(_quantize_array(self.g.arrays[t], scale, zp), src.name,
                               _qp(scale, zp))
            self.params[q] = (scale, zp)
            return q
        if t not in self.i8:
            scale, zp = self.params_of(t)
            q = self.like(t, I8, src.name + "/int8", _qp(scale, zp))
            self.out.ops.append(_Op("QUANTIZE", [self.plain(t)], [q], version=1))
            self.i8[t], self.params[q] = q, (scale, zp)
        q = self.i8[t]
        if want is None or self.params[q] == want:
            return q
        if (t, want) not in self.requantized:
            r = self.like(t, I8, f"{src.name}/requantized", _qp(*want))
            self.out.ops.append(_Op("QUANTIZE", [q], [r], version=1))
            self.params[r] = want
            self.requantized[(t, want)] = r
        return self.requantized[(t, want)]

    # operators --------------------------------------------------------------------------

    def float_op(self, op) -> None:
        ins = [self.plain(t) if t >= 0 else -1 for t in op.inputs]
        outs = []
        for t in op.outputs:
            self.f32[t] = self.like(t, self.g.tensors[t].type, self.g.tensors[t].name)
            outs.append(self.f32[t])
        self.out.ops.append(_Op(op.name, ins, outs, op.options))

    def int8_op(self, op) -> None:
        g, (t_out,) = self.g, op.outputs
        data = self.data_inputs(op)
        if op.name in _SHARED:
            out_params = self.shared[op]
        elif op.name in _TAKES_INPUT:
            out_params = self.params[self.int8(self.anchor(op))]
        elif op.name in _FIXED:
            out_params = _FIXED[op.name]
        elif g.tensors[t_out].type == F32:
            out_params = self.params_of(t_out)
        else:
            out_params = None  # ARG_MAX: int32 out
        ins = []
        for k, t in enumerate(op.inputs):
            if t < 0:
                ins.append(-1)
            elif k in data:
                shared = op.name in _TAKES_INPUT and (op.name in _SHARED or t in g.arrays)
                ins.append(self.int8(t, out_params if shared else None))
            elif op.name in _WEIGHTED and k in _WEIGHTED[op.name][:2]:
                ins.append(-1)  # below
            else:
                ins.append(self.plain(t))
        if op.name in _WEIGHTED:
            self.weighted(op, ins)
        name = g.tensors[t_out].name
        if out_params is None:
            self.f32[t_out] = new = self.like(t_out, g.tensors[t_out].type, name)
        else:
            new = self.like(t_out, I8, name, _qp(*out_params))
            self.i8[t_out], self.params[new] = new, out_params
        self.out.ops.append(_Op(op.name, ins, [new], op.options,
                                INT8_VERSIONS.get(op.name, 1)))
        if op.name == "TRANSPOSE_CONV" and ins[3] < 0:
            self.out.ops[-1].version = 2

    def weighted(self, op, ins: list) -> None:
        w_in, b_in, axis = _WEIGHTED[op.name]
        x = op.inputs[2 if op.name == "TRANSPOSE_CONV" else 0]
        s_in = self.params[self.int8(x)][0]
        w = self.g.arrays[op.inputs[w_in]]
        bias = op.inputs[b_in] if b_in < len(op.inputs) else -1
        b = self.g.arrays[bias] if bias >= 0 else np.zeros(w.shape[axis], np.float32)
        q_w, scales, q_b, b_scales = _weights(w, axis, b, s_in)
        name = self.g.tensors[op.inputs[w_in]].name
        ins[w_in] = self.out.const(q_w, name, _qp(scales, np.zeros(len(scales)), axis))
        if bias >= 0 or op.name != "TRANSPOSE_CONV":
            ins += [-1] * (b_in + 1 - len(ins))
            ins[b_in] = self.out.const(q_b, (self.g.tensors[bias].name if bias >= 0 else
                                             name + "/bias"), _qp(b_scales, np.zeros(len(q_b))))

    def run(self) -> _Graph:
        g, out = self.g, self.out
        self.share_ranges()
        out.input = self.f32[g.input] = out.tensor(
            g.tensors[g.input].name, g.tensors[g.input].shape, F32)
        for op in g.ops:
            (self.int8_op if self.is_int8(op) else self.float_op)(op)
        if g.output in self.f32:
            out.output = self.f32[g.output]
        else:
            name = g.tensors[g.output].name
            out.tensors[self.i8[g.output]].name = name + "/int8"
            out.output = self.like(g.output, F32, name)
            out.ops.append(_Op("DEQUANTIZE", [self.i8[g.output]], [out.output],
                               version=INT8_VERSIONS["DEQUANTIZE"]))
        return out


def quantize(model: S.Model, representative_data: Iterable[np.ndarray]) -> S.Model:
    """The full-integer model (f32 in and out) of the float model `lower.lower`
    writes, calibrated on `representative_data`: NHWC f32 image batches,
    normalized as the model's input (module text: fold, calibrate, then
    quantize)."""
    folded = fold(model)
    ranges = calibrate(folded, representative_data)
    return _Quantizer(_Graph(folded), ranges).run().model()
