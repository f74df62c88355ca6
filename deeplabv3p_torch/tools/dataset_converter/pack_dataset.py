"""Pack a segmentation dataset into pre-decoded uint8 shards.

Decode + resize every image/label pair ONCE into mmap-friendly .npy
shards (deeplabv3p_torch/data/shards.py) so training epochs stream memcpy
instead of per-step JPEG decode. The port's copy of
tools/dataset_converter/pack_dataset.py: the same shards, byte for byte.

Usage:
  python -m deeplabv3p_torch.tools.dataset_converter.pack_dataset \
      --dataset_path VOC2012 --dataset_file VOC2012/train.txt \
      --model_input_shape 512 --output VOC2012_packed_512
Then train with:
  python -m deeplabv3p_torch.train --dataset_path VOC2012_packed_512 ...
"""

import argparse
import os
import time


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset_path", required=True)
    p.add_argument("--dataset_file", required=True)
    p.add_argument("--model_input_shape", default="512",
                   help="HxW or single int — the packed resolution")
    p.add_argument("--output", required=True)
    p.add_argument("--shard_size", type=int, default=256)
    args = p.parse_args(argv)

    from deeplabv3p_torch.data.pipeline import SegmentationDataset
    from deeplabv3p_torch.data.shards import pack_shards
    from deeplabv3p_torch.utils.config import get_data_list

    parts = str(args.model_input_shape).lower().split("x")
    shape = (
        (int(parts[0]), int(parts[0]))
        if len(parts) == 1
        else (int(parts[0]), int(parts[1]))
    )
    ids = get_data_list(args.dataset_file)
    ds = SegmentationDataset(
        args.dataset_path, ids, batch_size=1, input_shape=shape,
        augment=False, shuffle=False,
    )
    t0 = time.time()
    out = pack_shards(ds, args.output, shard_size=args.shard_size)
    dt = time.time() - t0
    print(
        f"packed {ds.num_samples} samples at {shape[0]}x{shape[1]} "
        f"into {out} in {dt:.1f}s ({ds.num_samples / dt:.1f} img/s)"
    )


if __name__ == "__main__":
    main()
