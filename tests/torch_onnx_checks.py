"""Checks shared by the port's ONNX files of the zoo
(tests/test_torch_onnx_zoo_*.py), one file a group of families, together
every entry of the registry (22):

- `check_representative`: one representative of a family
  (tests/test_onnx_registry.py:27-39) with the JAX model's numpy-seeded
  weights through `utils/weights.from_jax_variables` (21 classes, OS16, f32,
  the ASPP and decoder kernels' plain versions) at 64x64: the file, parsed
  with the vendored `onnx_pb2` and run by the JAX package's numpy
  interpreter, matches JAX's jitted `softmax(model.apply)` at 1e-4, and so
  does the port's executor on the CPU.
- `check_converts`: any other entry, seeded (`init_parameters`), at its
  smallest legal input: the port's executor on the CPU equal to the eager
  f32 model it came from at 1e-5. `mobilenetv2` is exported with the
  inverted-residual kernel's operator too: its bf16 roundings go out as
  f32, so its file is held to the model without them.
- Both: op types inside the native engine's table (`convert.ENGINE_OPS`,
  inference/onnx_engine.cc:1409-1425), no `deeplabv3p` node, the bytes
  parsed by `onnx_pb2`, the reference's IO names.
"""

import jax
import numpy as np
import torch

from deeplabv3p_torch.export.onnx import export_onnx, run_model
from deeplabv3p_torch.export.onnx.convert import ENGINE_OPS
from deeplabv3p_torch.export.pt2 import Inference
from deeplabv3p_torch.models.factory import build_segmentation_model as port_build
from deeplabv3p_torch.models.layers import init_parameters
from deeplabv3p_tpu.export.onnx import onnx_pb2 as pb
from deeplabv3p_tpu.export.onnx.interp import run_model as jax_run_model
from deeplabv3p_tpu.models.factory import build_segmentation_model
from test_torch_model import port_model
from torch_zoo_checks import PX, model_variables

# group -> (family representatives, the other entries)
GROUPS = {
    "mobilenet": (["mobilenetv2_lite", "mobilenetv3small_lite"],
                  ["mobilenetv2", "mobilenetv3large", "mobilenetv3large_lite",
                   "mobilenetv3small"]),
    "mobilevit": (["mobilevit_xxs_lite"],
                  ["mobilevit_s", "mobilevit_s_lite", "mobilevit_xs", "mobilevit_xs_lite",
                   "mobilevit_xxs"]),
    "pelee_ghost": (["peleenet_lite", "ghostnet_lite"], ["peleenet", "ghostnet"]),
    "rest": (["resnet50", "xception", "unet_standard", "unet_lite", "unet_simple",
              "fast_scnn"], []),
}
TOL = 1e-4
SMALLEST = 32  # OS16 leaves a 2x2 map; Fast-SCNN and MobileViT take multiples of 32


def check_registry_file(onnx_model) -> pb.ModelProto:
    """The file's op types inside the engine's table, no custom node, its
    IO names, and its bytes parsed by `onnx_pb2`; returns the parse."""
    ops = {n.op_type for n in onnx_model.graph.node}
    assert ops <= ENGINE_OPS, ops - ENGINE_OPS
    assert not [n for n in onnx_model.graph.node if n.domain or "deeplabv3p" in n.op_type]
    parsed = pb.ModelProto()
    parsed.ParseFromString(onnx_model.encode())
    assert len(parsed.graph.node) == len(onnx_model.graph.node)
    assert parsed.graph.input[0].name == "image_input"
    assert parsed.graph.output[0].name == "pred_mask/Softmax"
    return parsed


def check_representative(model_type: str) -> None:
    variables = model_variables(model_type)
    x = np.random.default_rng(5).uniform(-1, 1, (1, PX, PX, 3)).astype(np.float32)
    jm = build_segmentation_model(model_type, 21, output_stride=16)
    want = np.asarray(jax.jit(
        lambda v, a: jax.nn.softmax(jm.apply(v, a, train=False), -1))(variables, x))

    model = port_model(model_type, 16, variables, fused=True).eval()
    onnx_model = export_onnx(model, (PX, PX), input_names=["image_input"],
                             output_names=["pred_mask/Softmax"])
    parsed = check_registry_file(onnx_model)
    by_jax = jax_run_model(parsed, {"image_input": x})["pred_mask/Softmax"]
    by_port = run_model(onnx_model, {"image_input": x}, "cpu")["pred_mask/Softmax"].numpy()
    assert by_jax.shape == by_port.shape == want.shape == (1, PX, PX, 21)
    np.testing.assert_allclose(by_jax, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(by_port, want, rtol=TOL, atol=TOL)


def check_converts(model_type: str) -> None:
    fused_mbconv = model_type == "mobilenetv2"
    model = port_build(model_type, 4, output_stride=16, fused_aspp=True, fused_decoder=True,
                       fused_mbconv=fused_mbconv, device="cpu")
    init_parameters(model, torch.Generator().manual_seed(0))
    model.eval()
    onnx_model = export_onnx(model, (SMALLEST, SMALLEST), input_names=["image_input"],
                             output_names=["pred_mask/Softmax"])
    check_registry_file(onnx_model)
    x = np.random.default_rng(2).uniform(-1, 1, (1, SMALLEST, SMALLEST, 3)).astype(np.float32)
    got = run_model(onnx_model, {"image_input": x}, "cpu")["pred_mask/Softmax"].numpy()
    if fused_mbconv:
        for block in model.modules():
            if hasattr(block, "fused_inference"):
                block.fused_inference = False
    with torch.no_grad():
        want = Inference(model, True, False)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
