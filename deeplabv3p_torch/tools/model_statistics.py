"""Model FLOPs / parameter statistics.

The port's copy of tools/evaluation/model_statistics.py (reference
tools/evaluation/model_statistics.py:52-72, which uses tf.profiler):
parameters from the module (BatchNorm's running statistics are buffers,
not counted, as the JAX tool counts `variables["params"]` alone); FLOPs
from `torch.utils.flop_counter.FlopCounterMode` over one forward of a
batch of 1 on `--device` (the card unless `--device cpu`; `meta` counts
without computing), every model of the registry. FlopCounterMode counts
the convolutions' and matrix products' multiply-adds (2 operations each);
XLA's cost analysis, which the JAX tool prints, also counts element-wise
work, so this count is lower than the JAX tool's.

Usage:
  python -m deeplabv3p_torch.tools.model_statistics --model_type=mobilenetv2_lite \\
      --model_input_shape=512 [--output_stride=16] [--num_classes=21] [--device cpu]
"""

import argparse

import torch


def model_statistics(model_type, num_classes=21, input_shape=(512, 512),
                     output_stride=16, device="cuda"):
    from torch.utils.flop_counter import FlopCounterMode

    from deeplabv3p_torch.models.factory import build_segmentation_model

    model = build_segmentation_model(model_type, num_classes, output_stride=output_stride,
                                     device=device)
    n_params = sum(p.numel() for p in model.parameters())
    x = torch.zeros((1, 3, *input_shape), device=device)
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        model(x)
    flops = counter.get_total_flops()

    print(f"model_type: {model_type}")
    print(f"input_shape: {input_shape}, output_stride: {output_stride}")
    print(f"params: {n_params / 1e6:.2f} M")
    print(f"flops:  {flops / 1e9:.2f} G")
    return n_params, flops


def main(argv=None):
    from deeplabv3p_torch.eval import resolve_device

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model_type", default="mobilenetv2_lite")
    p.add_argument("--num_classes", type=int, default=21)
    p.add_argument("--model_input_shape", type=int, default=512)
    p.add_argument("--output_stride", type=int, default=16)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu", "meta"])
    args = p.parse_args(argv)
    device = "meta" if args.device == "meta" else resolve_device(args.device)
    return model_statistics(
        args.model_type, args.num_classes,
        (args.model_input_shape, args.model_input_shape), args.output_stride, device,
    )


if __name__ == "__main__":
    main()
