"""Model export and int8 post-training quantization
(deeplabv3p_tpu/export/): `torch.export` artifacts (`.pt2`, the port's
counterpart of the StableHLO artifact), ONNX files (`onnx/`: the converter,
the protobuf codec and a torch executor), frozen TensorFlow graphs of plain
TF ops, fp32, float16 and full-integer int8 `.tflite` files and SavedModels
(`tf_export.py`, `tf/`, `tflite/`, `flatbuf.py`: written and run with no
tensorflow) and
per-channel int8 weights with calibrated int8 x int8 -> int32 pointwise
convolutions.
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
from deeplabv3p_torch.export.tf_export import (  # noqa: F401
    FrozenGraphRunner,
    TFLiteRunner,
    export_frozen_pb,
    export_saved_model,
    export_tflite,
    save_tflite,
)
