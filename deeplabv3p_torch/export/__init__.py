"""Model export and int8 post-training quantization
(deeplabv3p_tpu/export/): `torch.export` artifacts (`.pt2`, the port's
counterpart of the StableHLO artifact), ONNX files (`onnx/`: the converter,
the protobuf codec and a torch executor) and per-channel int8 weights with
calibrated int8 x int8 -> int32 pointwise convolutions.
"""

from deeplabv3p_torch.export.onnx import (  # noqa: F401
    OnnxProgram,
    export_onnx,
    load_onnx,
    run_model,
    save_onnx,
)
from deeplabv3p_torch.export.pt2 import (  # noqa: F401
    export_model,
    load_exported,
    save_exported,
)
from deeplabv3p_torch.export.quantize import post_train_quantize  # noqa: F401
