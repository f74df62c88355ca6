"""`torch.export` artifacts (`.pt2`), the port's counterpart of
deeplabv3p_tpu/export/stablehlo.py.

`export_model` captures the inference program (NHWC normalized images ->
the model -> softmax, or the int32 mask) with its weights inside, at a
static batch and size, as a `torch.export.ExportedProgram`;
`save_exported` / `load_exported` write and read it as a `.pt2` file.

The hand-written kernels on a model's forward are operators of the
`deeplabv3p` namespace (`ops/kernels/_build.LIB`), so each stays one node of
the graph, and the loaded program launches the same kernels as the eager
model. The arguments that the ASPP and inverted-residual kernels read
prepared from the weights (stacked kernels, folded BNs, the inverted
residual's blob) are constants of the graph, taken from the eager forward
that `export_model` runs first (`models.layers.KeepsPrepared`); the
decoder's BN fold is computed in the graph. Export on the device the
artifact will run on: the program's tensors stay on it.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn as nn

from deeplabv3p_torch.postprocess import mask_argmax


class Inference(nn.Module):
    """The exported signature of stablehlo.py:20-48: (B, H, W, 3) f32
    normalized images in, (B, H, W, C) f32 softmax probabilities (or the
    logits, or the (B, H, W) int32 mask) out."""

    def __init__(self, model: nn.Module, with_softmax: bool, with_argmax: bool):
        super().__init__()
        self.model = model
        self.with_softmax, self.with_argmax = with_softmax, with_argmax

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        logits = self.model(images.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        if self.with_argmax:
            return mask_argmax(logits)
        if self.with_softmax:
            return torch.softmax(logits, dim=-1)
        return logits


def export_model(
    model: nn.Module,
    input_shape: tuple[int, int],
    batch_size: int = 1,
    with_softmax: bool = True,
    with_argmax: bool = False,
) -> torch.export.ExportedProgram:
    """Export `model` (in eval mode, on its device) for (batch_size, *input_shape,
    3) f32 inputs. One eager forward on zeros comes first, so that the kernels'
    prepared arguments are those of the weights as they are now."""
    device = next(model.parameters()).device
    was_training = model.training
    model.eval()
    try:
        program = Inference(model, with_softmax, with_argmax)
        x = torch.zeros((batch_size, *input_shape, 3), dtype=torch.float32, device=device)
        with torch.no_grad():
            program(x)
            return torch.export.export(program, (x,), strict=False)
    finally:
        model.train(was_training)


def save_exported(exported: torch.export.ExportedProgram, path: str) -> None:
    torch.export.save(exported, path)


def load_exported(path: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """Load a `.pt2` written by `save_exported`; returns the program as a
    callable on the exported input, on the device it was exported on, its
    weights taking no gradient (an inference program)."""
    import deeplabv3p_torch.ops.kernels  # noqa: F401  (the deeplabv3p:: operators)

    return torch.export.load(path).module().requires_grad_(False)
