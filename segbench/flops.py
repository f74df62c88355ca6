"""FLOPs of a cell's model, counted on the reference model.

`torch.utils.flop_counter.FlopCounterMode` over one forward of
`reference.deeplab` on the meta device at the cell's shapes, its
convolutions alone: two operations a multiply-add, a grouped conv by its
groups. The element-wise work, the resizes and the losses are left out, as
a model FLOP count leaves them out. A training step's backward is the two
gradients of every convolution, each as large as its forward, but the
first convolution's input gradient, which nothing asks for: 3 x forward
less that. (The counter's own formula for a grouped convolution's backward
counts it as if dense, hundreds of times over for a depthwise one, so the
backward is not taken from it.) The program's own model is not read: its
custom operators (the ASPP, decoder and inverted-residual kernels) hide
their work from the counter.
"""

from __future__ import annotations

import math

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from segbench.reference.deeplab import logits
from segbench.reference.nn import Leaves


class _FirstConv(TorchDispatchMode):
    """FLOPs of the first convolution dispatched."""

    def __init__(self):
        super().__init__()
        self.flops = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self.flops is None and func is torch.ops.aten.convolution.default:
            w = args[1].shape
            self.flops = 2.0 * math.prod(out.shape) * math.prod(w[1:])
        return out


def conv_flops(cfg: dict, batch: int, train: bool) -> float:
    """Convolution FLOPs of a forward of `batch` images at cfg's input size,
    and with `train` of its backward too."""
    h, w = cfg["input_hw"]
    x = torch.empty((batch, 3, h, w), device="meta")
    counter, first = FlopCounterMode(display=False), _FirstConv()
    with counter, first:
        logits(Leaves(record=True, train=train), x, cfg)
    counts = counter.get_flop_counts().get("Global", {})
    forward = float(sum(v for op, v in counts.items()
                        if str(op).split(".")[1] == "convolution"))
    return 3.0 * forward - first.flops if train else forward
