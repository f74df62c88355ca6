"""Export a 512px inference .onnx for native-engine benchmarking.

The port's copy of tools/misc/export_native_bench_model.py. The native
CLI benchmark target: the reference publishes on-device CPU invoke times
for its C++ apps at 512x512x21 (reference inference/README.md:137,301).
This writes the matching artifact for the pure-C++ engine
(`deeplabSegment --engine onnx`): the model in f32 at OS16 with 21
classes and seeded weights, NHWC images in, softmax probabilities out,
through the port's ONNX converter (`export/onnx`), with the JAX tool's IO
names (`input_0`, `output_0`). The model runs on `--device` (the card
unless `--device cpu`); the file is the same either way.

Usage: python -m deeplabv3p_torch.tools.export_native_bench_model [out.onnx] [model] [size]
       [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import tempfile

import torch


def build_model(name: str, device, variables=None):
    """f32 eval model of 21 classes at OS16 on `device`: `variables` (a JAX
    `{'params', 'batch_stats'}` tree) when given, else seeded weights with
    flax's BN init."""
    from deeplabv3p_torch.models.factory import build_segmentation_model
    from deeplabv3p_torch.models.layers import init_parameters
    from deeplabv3p_torch.utils.weights import from_jax_variables

    model = build_segmentation_model(name, 21, output_stride=16, device=device)
    if variables is None:
        init_parameters(model, torch.Generator().manual_seed(0), bn_identity=True)
    else:
        model.load_state_dict(from_jax_variables(variables, model))
    return model.eval()


def export(out: str, name: str = "mobilenetv2_lite", size: int = 512, device="cuda",
           variables=None):
    """Write `out`; returns the ModelProto."""
    from deeplabv3p_torch.eval import resolve_device
    from deeplabv3p_torch.export.onnx import export_onnx, save_onnx

    model = build_model(name, resolve_device(str(device)), variables)
    onnx_model = export_onnx(model, (size, size), 1)
    save_onnx(onnx_model, out)
    print("saved", out)
    return onnx_model


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("out", nargs="?",
                   default=os.path.join(tempfile.gettempdir(), "native_bench_512.onnx"))
    p.add_argument("model", nargs="?", default="mobilenetv2_lite")
    p.add_argument("size", nargs="?", type=int, default=512)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    return export(args.out, args.model, args.size, args.device)


if __name__ == "__main__":
    main()
