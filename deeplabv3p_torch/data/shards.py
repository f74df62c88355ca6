"""Copy of deeplabv3p_tpu/data/shards.py (packed pre-decoded shards),
pinned equal to it by tests/test_torch_train.py. numpy and PIL only, so
the port reads and writes the same files without importing JAX. With a
data-parallel `mesh`, `ShardedDataset` reads only this rank's rows of each
global batch (`pipeline.rank_rows`).
"""

from __future__ import annotations

import json
import os
from typing import Iterator

import numpy as np

from deeplabv3p_torch.data.pipeline import rank_rows


def pack_shards(
    dataset,
    out_dir: str,
    shard_size: int = 256,
) -> str:
    """Pack a SegmentationDataset (or any object with `_load_sample(i)`,
    `num_samples`, `input_shape`) into shards under `out_dir`.

    Decode order is the dataset's file order (ids recorded in meta.json);
    shuffling happens at read time over the global index space.
    """
    os.makedirs(out_dir, exist_ok=True)
    n = dataset.num_samples
    h, w = dataset.input_shape
    shard_sizes = []
    k = 0
    i = 0
    while i < n:
        m = min(shard_size, n - i)
        images = np.empty((m, h, w, 3), np.uint8)
        labels = np.empty((m, h, w), np.uint8)
        for j in range(m):
            img, lbl, _ = dataset._load_sample(i + j)
            images[j], labels[j] = img, lbl
        np.save(os.path.join(out_dir, f"shard_{k}_images.npy"), images)
        np.save(os.path.join(out_dir, f"shard_{k}_labels.npy"), labels)
        shard_sizes.append(m)
        i += m
        k += 1
    ids = [
        os.path.splitext(os.path.basename(p))[0] for p in dataset.image_paths
    ]
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(
            {"input_shape": [h, w], "shard_sizes": shard_sizes, "ids": ids},
            f,
        )
    return out_dir


def is_packed_dataset(path: str) -> bool:
    return os.path.isfile(os.path.join(path, "meta.json")) and os.path.isfile(
        os.path.join(path, "shard_0_images.npy")
    )


class ShardedDataset:
    """Reader over packed shards with the same host-batch protocol as
    SegmentationDataset: epoch_batches() yields
    (images u8 (B,H,W,3), labels u8 (B,H,W), orig_hw (B,2)).

    Shards are memory-mapped; a batch is a gather of B rows — the OS page
    cache keeps hot shards resident, so steady-state epochs cost memcpy
    only. orig_hw is the packed resolution (original sizes are consumed
    at pack time; device-side random-crop uses orig_hw only to decide
    crop legality, which is a no-op for pre-resized data).
    """

    def __init__(
        self,
        shard_dir: str,
        batch_size: int = 16,
        shuffle: bool = True,
        seed: int = 0,
        drop_remainder: bool = True,
        mesh=None,
    ):
        if mesh is not None:
            from deeplabv3p_torch.parallel.mesh import check_batch

            check_batch(batch_size, mesh.data_size)
        self.mesh = mesh
        with open(os.path.join(shard_dir, "meta.json")) as f:
            meta = json.load(f)
        self.input_shape = tuple(meta["input_shape"])
        self.ids = meta["ids"]
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_remainder = drop_remainder
        self._rng = np.random.RandomState(seed)
        self._images = []
        self._labels = []
        for k, _ in enumerate(meta["shard_sizes"]):
            self._images.append(
                np.load(
                    os.path.join(shard_dir, f"shard_{k}_images.npy"),
                    mmap_mode="r",
                )
            )
            self._labels.append(
                np.load(
                    os.path.join(shard_dir, f"shard_{k}_labels.npy"),
                    mmap_mode="r",
                )
            )
        self._offsets = np.cumsum([0] + meta["shard_sizes"])

    @property
    def num_samples(self) -> int:
        return int(self._offsets[-1])

    def __len__(self) -> int:
        n = self.num_samples
        if self.drop_remainder:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _gather(self, idx: np.ndarray):
        h, w = self.input_shape
        images = np.empty((len(idx), h, w, 3), np.uint8)
        labels = np.empty((len(idx), h, w), np.uint8)
        shard_of = np.searchsorted(self._offsets, idx, side="right") - 1
        for j, (i, s) in enumerate(zip(idx, shard_of)):
            r = i - self._offsets[s]
            images[j] = self._images[s][r]
            labels[j] = self._labels[s][r]
        return images, labels

    def epoch_batches(
        self, prefetch: int = 2
    ) -> Iterator[tuple[np.ndarray, np.ndarray, np.ndarray]]:
        order = np.arange(self.num_samples)
        if self.shuffle:
            self._rng.shuffle(order)
        h, w = self.input_shape
        for b in range(len(self)):
            idx = order[b * self.batch_size : (b + 1) * self.batch_size]
            # this rank's rows; rows padding the final partial batch repeat
            # its last sample with ignore-only labels (as SegmentationDataset)
            srcs, pads = rank_rows(idx, self.batch_size, self.mesh)
            images, labels = self._gather(srcs)
            labels[pads] = 255
            orig_hw = np.tile(np.asarray([h, w], np.float32), (len(srcs), 1))
            yield images, labels, orig_hw
