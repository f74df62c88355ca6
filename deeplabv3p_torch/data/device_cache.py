"""Device-resident dataset (deeplabv3p_tpu/data/device_cache.py), one device.

The whole uint8 train set is copied to the device once; each step gathers
its batch there (`index_select`) from an index permutation, so the only
per-step host -> device traffic is B int64 indices. A 512x512 pair is
0.79 MB, so 10k VOC-scale images take ~8 GB of the card's memory.

The permutations come from `np.random.RandomState(seed)`, as in JAX, so
the batches come in the JAX order. `orig_hw` is the INPUT shape, as in
JAX (device_cache.py:145-148): under the cache the random crop never
fires. The mesh-sharded variant is ROADMAP Queue A item 11 and raises.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch


def _refuse_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "a device-cached dataset sharded over a mesh is not ported yet (ROADMAP "
            "Queue A item 11)")


class DeviceCachedDataset:
    """Resident feeder with the host-batch protocol of
    SegmentationDataset / ShardedDataset: `epoch_batches()` yields (images
    u8 (B,H,W,3), labels u8 (B,H,W), orig_hw f32 (B,2)), here as tensors
    already on `device`, which `pipeline.to_device` passes through."""

    def __init__(
        self,
        images: np.ndarray,
        labels: np.ndarray,
        *,
        batch_size: int = 16,
        device="cuda",
        shuffle: bool = True,
        seed: int = 0,
        mem_limit_bytes: int = 8 << 30,
        mesh=None,
    ):
        _refuse_mesh(mesh)
        n, h, w, _ = images.shape
        if labels.shape != (n, h, w):
            raise ValueError(f"labels shape {labels.shape} != images' {(n, h, w)}")
        nbytes = int(n) * h * w * 4  # 3 B image + 1 B label a pixel
        if nbytes > mem_limit_bytes:
            raise ValueError(
                f"dataset needs ~{nbytes / 2**30:.1f} GiB resident on the device "
                f"(> limit {mem_limit_bytes / 2**30:.1f} GiB); use the streaming "
                "ShardedDataset path instead")
        self.input_shape = (h, w)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_samples = int(n)
        self.device = torch.device(device)
        self._rng = np.random.RandomState(seed)
        # at least one full batch: wrap around with real samples (JAX :90-98)
        self._n = max(int(n), batch_size)
        if self._n != n:
            sel = np.arange(self._n) % n
            images, labels = images[sel], labels[sel]
        self._images = torch.from_numpy(np.ascontiguousarray(images)).to(self.device)
        self._labels = torch.from_numpy(np.ascontiguousarray(labels)).to(self.device)
        self._orig_hw = torch.tensor([[h, w]], dtype=torch.float32,
                                     device=self.device).repeat(batch_size, 1)

    @classmethod
    def from_source(cls, source, *, device="cuda", seed: int = 0, shuffle: bool = True,
                    mem_limit_bytes: int = 8 << 30, mesh=None) -> "DeviceCachedDataset":
        """Materialise a dataset with the epoch_batches() protocol
        (SegmentationDataset / ShardedDataset) once, in file order (JAX
        :153-176); augmentation stays on the device, a step at a time."""
        _refuse_mesh(mesh)
        h, w = source.input_shape
        n = source.num_samples
        if hasattr(source, "_gather"):  # ShardedDataset: bulk memmap reads
            images, labels = source._gather(np.arange(n))
        else:
            images = np.empty((n, h, w, 3), np.uint8)
            labels = np.empty((n, h, w), np.uint8)
            for i in range(n):
                img, lbl, _ = source._load_sample(i)
                images[i], labels[i] = img, lbl
        return cls(images, labels, batch_size=source.batch_size, device=device,
                   shuffle=shuffle, seed=seed, mem_limit_bytes=mem_limit_bytes)

    def __len__(self) -> int:
        return self._n // self.batch_size

    def epoch_batches(self) -> Iterator[tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
        order = self._rng.permutation(self._n) if self.shuffle else np.arange(self._n)
        b = self.batch_size
        for i in range(len(self)):
            idx = torch.from_numpy(order[i * b:(i + 1) * b].astype(np.int64)).to(self.device)
            yield (self._images.index_select(0, idx), self._labels.index_select(0, idx),
                   self._orig_hw)
