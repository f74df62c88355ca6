"""Embedded runner (deeplabv3p_tpu/runtime.py): the model-execution side of
a native caller that owns image IO, preprocessing and post-processing.
`Runner.run_bytes` takes the raw normalized f32 NHWC buffer and returns the
softmax probabilities' bytes.

Accepted model files:
* `.pt2`: a program of `export/pt2.py` (weights inside; it runs on the
  device it was exported on);
* weights (`.npz`, `.ckpt`, `.h5`, `utils/checkpoint.load_weights`): the
  model is built from `model_type` and `num_classes` in bf16, with the fused
  ASPP kernel where it has an ASPP, as `DeepLab` builds it, and its logits
  go through a softmax.

`inference/deeplabSegment.cpp` embeds the JAX package's runner in its
Python engine; the port's models reach that binary through its C++ ONNX
engine instead (`--engine onnx` on a file of `tools/export_onnx.py`), which
needs no Python. An `.onnx` is not taken here, as the JAX runner takes none.
"""

from __future__ import annotations

import numpy as np
import torch


class Runner:
    def __init__(
        self,
        model_path: str,
        model_type: str = "mobilenetv2_lite",
        num_classes: int = 21,
        input_height: int = 512,
        input_width: int = 512,
        device: str = "cuda",
    ):
        from deeplabv3p_torch.eval import resolve_device
        from deeplabv3p_torch.export.pt2 import Inference, load_exported

        self.device = resolve_device(device)
        self.input_hw = (input_height, input_width)
        self.num_classes = num_classes
        if model_path.endswith(".pt2"):
            self._fn = load_exported(model_path)
        else:
            from deeplabv3p_torch.models.factory import build_segmentation_model
            from deeplabv3p_torch.models.layers import init_parameters
            from deeplabv3p_torch.utils.checkpoint import load_weights

            model = build_segmentation_model(model_type, num_classes, fused_aspp=True,
                                             dtype=torch.bfloat16, device=self.device)
            # an .h5 loads by layer name: what it lacks keeps this init
            init_parameters(model, torch.Generator().manual_seed(0), bn_identity=True)
            load_weights(model_path, model)
            self._fn = Inference(model.eval(), with_softmax=True, with_argmax=False)

    def run_bytes(self, data: bytes, batch: int, h: int, w: int):
        """data: float32 normalized NHWC image buffer. Returns
        (probs_bytes, out_h, out_w, num_classes)."""
        x = np.frombuffer(data, np.float32).reshape(batch, h, w, 3)
        with torch.no_grad():
            probs = self._fn(torch.from_numpy(x.copy()).to(self.device))
        probs = probs.float().cpu().numpy()
        return probs.tobytes(), probs.shape[1], probs.shape[2], probs.shape[3]
