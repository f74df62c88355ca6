"""ONNX export and execution (deeplabv3p_tpu/export/onnx/): the ONNX
messages with a protobuf codec of the port's own (`proto.py`; no `onnx` or
`protobuf` package needed), the `torch.export` -> ONNX converter
(`convert.py`) and an executor of ONNX graphs in torch ops on a device
(`interp.py`). Files written here run in the native C++ engine
(`inference/onnx_engine.cc`, `deeplabSegment --engine onnx`) and in the JAX
package's numpy interpreter.
"""

from deeplabv3p_torch.export.onnx.convert import export_onnx, load_onnx, save_onnx  # noqa: F401
from deeplabv3p_torch.export.onnx.interp import OnnxProgram, run_model  # noqa: F401
