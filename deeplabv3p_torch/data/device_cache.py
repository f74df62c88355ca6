"""Device-resident dataset (deeplabv3p_tpu/data/device_cache.py).

The whole uint8 train set is copied to the device once; each step gathers
its batch there (`index_select`) from an index permutation, so the only
per-step host -> device traffic is B int64 indices. A 512x512 pair is
0.79 MB, so 10k VOC-scale images take ~8 GB of the card's memory.

The permutations come from `np.random.RandomState(seed)`, as in JAX, so
the batches come in the JAX order. `orig_hw` is the INPUT shape, as in
JAX (device_cache.py:145-148): under the cache the random crop never
fires.

Over a data-parallel `parallel.Mesh` of nd ranks (JAX :85-198): N is padded
to a multiple of nd, and to at least one batch, with wrap-around samples;
rank d holds only the contiguous block `[d * local_n, (d + 1) * local_n)`
on its device. Each epoch every rank draws the nd per-device permutations
from the one `RandomState(seed)`, in the order d = 0..nd-1, and keeps its
own; its rows of global batch b are `p_d[b * pb:(b + 1) * pb]`, so the
global batch is JAX's, sample for sample.

On a ('data', 'spatial') mesh (JAX :21-27, :200-206, `P('data',
'spatial')`), d is the data index and the S ranks of a data group hold the
group's block split by height: rank s keeps only its rows
`parallel.spatial.block(H, S, s)` of each sample. The augmentation and the
adaptive weights need whole samples, so a step first gathers each
sample's uint8 rows over the spatial group (`spatial.gather_rows`, one
`all_reduce` of the batch) and yields them whole, as every dataset does;
the train step then keeps its rows again.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from deeplabv3p_torch.parallel.mesh import Mesh, check_batch
from deeplabv3p_torch.parallel.spatial import block, gather_rows, partition_of


def _layout(n: int, batch_size: int, mesh) -> tuple[int, int, int]:
    """(nd, data index, local_n) of a set of n samples (JAX :85-98)."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a deeplabv3p_torch.parallel.Mesh, not "
                        f"{type(mesh).__name__}")
    nd, rank = (1, 0) if mesh is None else (mesh.data_size, mesh.data_index)
    check_batch(batch_size, nd)
    padded_n = max(-(-n // nd) * nd, batch_size)
    return nd, rank, padded_n // nd


def _block(a: np.ndarray, start: int, stop: int) -> np.ndarray:
    """Samples start:stop of `a`, wrapping around past its end."""
    if stop <= len(a):
        return a[start:stop]
    return a[np.arange(start, stop) % len(a)]


class DeviceCachedDataset:
    """Resident feeder with the host-batch protocol of
    SegmentationDataset / ShardedDataset: `epoch_batches()` yields (images
    u8 (B,H,W,3), labels u8 (B,H,W), orig_hw f32 (B,2)), here as tensors
    already on `device`, which `pipeline.to_device` passes through. Over a
    mesh, B is this rank's share of the global batch."""

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
        n, h, w, _ = images.shape
        if labels.shape != (n, h, w):
            raise ValueError(f"labels shape {labels.shape} != images' {(n, h, w)}")
        nd, rank, local_n = _layout(n, batch_size, mesh)
        start = rank * local_n
        self._place(_block(images, start, start + local_n),
                    _block(labels, start, start + local_n), n, batch_size, device, shuffle,
                    seed, mem_limit_bytes, nd, rank, mesh)

    def _place(self, images, labels, n: int, batch_size: int, device, shuffle: bool,
               seed: int, mem_limit_bytes: int, nd: int, rank: int, mesh) -> None:
        """Keep this rank's block (images, labels) of a set of n samples,
        and on a spatial mesh only its rows of them."""
        h, w = images.shape[1:3]
        self._mesh = mesh if mesh is not None and mesh.spatial > 1 else None
        if self._mesh is not None:
            lo, hi = block(h, mesh.spatial, mesh.spatial_index)
            images, labels = images[:, lo:hi], labels[:, lo:hi]
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
        self._nd, self._rank, self._local_n = nd, rank, len(images)
        self._images = torch.from_numpy(np.ascontiguousarray(images)).to(self.device)
        self._labels = torch.from_numpy(np.ascontiguousarray(labels)).to(self.device)
        self._orig_hw = torch.tensor([[h, w]], dtype=torch.float32,
                                     device=self.device).repeat(batch_size // nd, 1)

    @classmethod
    def from_source(cls, source, *, device="cuda", seed: int = 0, shuffle: bool = True,
                    mem_limit_bytes: int = 8 << 30, mesh=None) -> "DeviceCachedDataset":
        """Materialise a dataset with the epoch_batches() protocol
        (SegmentationDataset / ShardedDataset) once, in file order (JAX
        :153-176), reading only this rank's block; augmentation stays on the
        device, a step at a time."""
        h, w = source.input_shape
        n = source.num_samples
        nd, rank, local_n = _layout(n, source.batch_size, mesh)
        idx = np.arange(rank * local_n, (rank + 1) * local_n) % n
        if hasattr(source, "_gather"):  # ShardedDataset: bulk memmap reads
            images, labels = source._gather(idx)
        else:
            images = np.empty((local_n, h, w, 3), np.uint8)
            labels = np.empty((local_n, h, w), np.uint8)
            for j, i in enumerate(idx):
                img, lbl, _ = source._load_sample(i)
                images[j], labels[j] = img, lbl
        ds = cls.__new__(cls)
        ds._place(images, labels, n, source.batch_size, device, shuffle, seed,
                  mem_limit_bytes, nd, rank, mesh)
        return ds

    def __len__(self) -> int:
        return self._local_n * self._nd // self.batch_size

    def epoch_batches(self) -> Iterator[tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
        if self.shuffle:  # every rank draws all nd permutations, in order
            perms = [self._rng.permutation(self._local_n) for _ in range(self._nd)]
            order = perms[self._rank]
        else:
            order = np.arange(self._local_n)
        b = self.batch_size // self._nd
        for i in range(len(self)):
            idx = torch.from_numpy(order[i * b:(i + 1) * b].astype(np.int64)).to(self.device)
            images, labels = self._images.index_select(0, idx), self._labels.index_select(0, idx)
            if self._mesh is not None:  # each sample's rows from the spatial group
                part, h = partition_of(self._mesh), self.input_shape[0]
                images, labels = gather_rows(images, h, part), gather_rows(labels, h, part)
            yield images, labels, self._orig_hw
