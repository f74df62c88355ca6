"""Activation functions (deeplabv3p_tpu/ops/activations.py).

hard_sigmoid / hard_swish follow the reference MobileNetV3 definitions
(reference deeplabv3p/models/deeplabv3p_mobilenetv3.py:98-103):
    hard_sigmoid(x) = relu6(x + 3) / 6
    hard_swish(x)   = x * hard_sigmoid(x)
"""

import torch


def relu6(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0.0, 6.0)


def hard_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return relu6(x + 3.0) * (1.0 / 6.0)


def hard_swish(x: torch.Tensor) -> torch.Tensor:
    return x * hard_sigmoid(x)
