"""Host-side dataset: decode + resize + prefetch (copy of
deeplabv3p_tpu/data/pipeline.py, pinned equal to it by
tests/test_torch_train.py), and `device_feed`, which here copies batches to
the device from a worker thread.

Layout: `<dataset>/images/<id>.jpg` + `<dataset>/labels/<id>.png`. The
host decodes (cv2 or PIL), optionally applies CLAHE, and resizes to the
model input; everything else runs on the device
(`deeplabv3p_torch.data.augment`).

Given a data-parallel `mesh` (`parallel.Mesh`: `rank`, `size`), a dataset
walks the global batches in the order one process walks them (same seed)
and decodes only this rank's block of rows of each (`rank_rows`). The CLAHE
coin of each sample is tossed in the producer, in sample order, for the
whole global batch, so the epoch's draws and the next epoch's shuffle are
those of one process.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
import queue
import threading
from typing import Iterator

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover - cv2 is present in the image
    cv2 = None

from PIL import Image


def _apply_clahe(image: np.ndarray, grid_size: int = 8) -> np.ndarray:
    """CLAHE on the luma plane (reference random_histeq,
    data_utils.py:127-149 — including its RGB-array-through-BGR2YUV
    channel convention, kept bug-for-bug)."""
    if cv2 is None:
        return image
    clahe = cv2.createCLAHE(clipLimit=2.0, tileGridSize=(grid_size, grid_size))
    img_yuv = cv2.cvtColor(image, cv2.COLOR_BGR2YUV)
    img_yuv[:, :, 0] = clahe.apply(img_yuv[:, :, 0])
    return cv2.cvtColor(img_yuv, cv2.COLOR_YUV2BGR)


def _resize_pair(
    image: np.ndarray, label: np.ndarray, input_shape: tuple[int, int]
) -> tuple[np.ndarray, np.ndarray]:
    h, w = input_shape
    if cv2 is not None:
        image = cv2.resize(image, (w, h))  # INTER_LINEAR (data.py:110)
        label = cv2.resize(label, (w, h), interpolation=cv2.INTER_NEAREST)
    else:
        image = np.asarray(
            Image.fromarray(image).resize((w, h), Image.BILINEAR)
        )
        label = np.asarray(
            Image.fromarray(label).resize((w, h), Image.NEAREST)
        )
    return image, label


def rank_rows(idx: np.ndarray, batch_size: int, mesh=None):
    """This rank's rows of a global batch of sample indices `idx` (a last
    batch may be short): (the sample each row reads, whether the row pads
    the batch). A padding row repeats the batch's last sample with its
    labels set to ignore (255). The rows are those of the rank's data group:
    on a 2-D mesh every rank of a spatial group reads the group's samples
    whole, and the train and eval steps keep its rows (augmentation and the
    adaptive weights need the whole sample)."""
    rank, world = (0, 1) if mesh is None else (mesh.data_index, mesh.data_size)
    b = batch_size // world
    rows = np.arange(rank * b, (rank + 1) * b)
    return idx[np.minimum(rows, len(idx) - 1)], rows >= len(idx)


class SegmentationDataset:
    """File-list dataset with threaded decode and batch prefetch."""

    def __init__(
        self,
        dataset_path: str,
        data_list: list[str],
        batch_size: int = 1,
        num_classes: int = 21,
        input_shape: tuple[int, int] = (512, 512),
        ignore_index: int = 255,
        augment: bool = True,
        histeq_prob: float = 0.2,
        shuffle: bool = True,
        num_workers: int = 8,
        seed: int = 0,
        drop_remainder: bool = True,
        mesh=None,
    ):
        if mesh is not None:
            from deeplabv3p_torch.parallel.mesh import check_batch

            check_batch(batch_size, mesh.data_size)
        self.mesh = mesh
        dataset_realpath = os.path.realpath(dataset_path)
        self.image_paths = [
            os.path.join(dataset_realpath, "images", i.strip() + ".jpg")
            for i in data_list
        ]
        self.label_paths = [
            os.path.join(dataset_realpath, "labels", i.strip() + ".png")
            for i in data_list
        ]
        self.batch_size = batch_size
        self.num_classes = num_classes
        self.input_shape = tuple(input_shape)
        self.ignore_index = ignore_index
        self.augment = augment
        self.histeq_prob = histeq_prob
        self.shuffle = shuffle
        self.num_workers = num_workers
        # drop_remainder=False pads the final partial batch by repeating
        # its last sample with labels set to ignore (255) — shapes stay
        # static and the padding is excluded from metrics/losses. The
        # reference avoids the problem by evaluating at batch 1
        # (eval.py:380-386); training matches its floor-division drop
        # (data.py:52-53).
        self.drop_remainder = drop_remainder
        self._rng = np.random.RandomState(seed)
        self._order = np.arange(len(self.image_paths))
        # persistent decode pool: per-epoch executor spin-up costs real
        # latency on short epochs
        self._pool = cf.ThreadPoolExecutor(num_workers)

    def __len__(self) -> int:
        n = len(self.image_paths)
        if self.drop_remainder:
            return n // self.batch_size  # reference data.py:52-53
        return -(-n // self.batch_size)

    @property
    def num_samples(self) -> int:
        return len(self.image_paths)

    def _load_sample(self, idx: int, histeq=None):
        # images: cv2 JPEG decode is ~2x faster than PIL (3.0 vs 5.7 ms
        # for a VOC-sized image) — this is the pipeline's hot path.
        # labels: must stay PIL — cv2 expands palette PNGs to RGB colors
        # and loses the class indices.
        if cv2 is not None:
            image = cv2.cvtColor(
                cv2.imread(self.image_paths[idx], cv2.IMREAD_COLOR),
                cv2.COLOR_BGR2RGB,
            )
        else:
            image = np.array(
                Image.open(self.image_paths[idx]).convert("RGB"),
                dtype=np.uint8,
            )
        lbl = Image.open(self.label_paths[idx])
        label = np.array(lbl)
        if label.ndim == 3:  # color label PNGs: take first channel
            label = label[..., 0]
        label = label.astype(np.uint8)
        orig_hw = np.array(image.shape[:2], np.float32)

        if histeq is None:  # the coin tossed here, in the decoding thread
            histeq = self.augment and self._rng.rand() < self.histeq_prob
        if histeq:
            image = _apply_clahe(image)

        image, label = _resize_pair(image, label, self.input_shape)
        return image, label, orig_hw

    def epoch_batches(
        self, prefetch: int = 2
    ) -> Iterator[tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Yield (images u8 (B,H,W,3), labels u8 (B,H,W), orig_hw (B,2))
        with background prefetch. Shuffles at epoch start (reference
        shuffles at epoch end, data.py:156-160 — same distribution). With a
        mesh, B is this rank's share of the batch.

        Sample decodes for up to `prefetch + 1` batches are in flight at
        once (windowed futures over the persistent pool), so decoding of
        batch b+1 overlaps the consumer's device work on batch b.
        """
        order = self._order.copy()
        if self.shuffle:
            self._rng.shuffle(order)
        n_batches = len(self)
        q: queue.Queue = queue.Queue(maxsize=prefetch)
        stop = threading.Event()

        def _put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            window = prefetch + 1
            pending: list[list] = []
            next_submit = 0

            def submit(b):
                idx = order[b * self.batch_size : (b + 1) * self.batch_size]
                histeq = [self.augment and self._rng.rand() < self.histeq_prob
                          for _ in idx]
                srcs, pads = rank_rows(np.arange(len(idx)), self.batch_size, self.mesh)
                futures = {}
                for j in srcs:  # a sample once, however many rows read it
                    if j not in futures:
                        futures[j] = self._pool.submit(self._load_sample, idx[j], histeq[j])
                return [(futures[j], pad) for j, pad in zip(srcs, pads)]

            while next_submit < min(window, n_batches):
                pending.append(submit(next_submit))
                next_submit += 1
            emitted = 0
            while emitted < n_batches and not stop.is_set():
                samples = []
                for f, pad in pending.pop(0):
                    img, lbl, hw = f.result()
                    # a row padding the final partial batch: labels forced to
                    # 255, so it is invisible to losses and confusion metrics
                    samples.append((img, np.full_like(lbl, 255) if pad else lbl, hw))
                batch = (
                    np.stack([s[0] for s in samples]),
                    np.stack([s[1] for s in samples]),
                    np.stack([s[2] for s in samples]),
                )
                if not _put(batch):
                    return
                emitted += 1
                if next_submit < n_batches:
                    pending.append(submit(next_submit))
                    next_submit += 1
            _put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                yield item
        finally:
            stop.set()

    def batch_image_paths(self, batch_index: int) -> list[str]:
        """Paths for a (non-shuffled) batch — reference
        get_batch_image_path (data.py:43-44), used by eval result dumps."""
        i = batch_index
        return self.image_paths[i * self.batch_size : (i + 1) * self.batch_size]


class _FeedError:
    def __init__(self, exc: BaseException):
        self.exc = exc


def to_device(batch, device) -> tuple:
    """numpy arrays -> tensors on `device`. For CUDA the host copy is pinned
    and the copy is non_blocking, on the current stream: the consumer's
    work on that stream runs after it. Tensors already on `device` (a
    `DeviceCachedDataset`'s batches) pass through as they are, uncopied."""
    import torch

    device = torch.device(device)
    out = []
    for a in batch:
        if isinstance(a, torch.Tensor):
            out.append(a if _on(a, device) else a.to(device))
            continue
        t = torch.from_numpy(np.ascontiguousarray(a))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out.append(t)
    return tuple(out)


def _on(t, device) -> bool:
    """t lies on `device` (an index-less 'cuda' means the current card)."""
    if t.device.type != device.type:
        return False
    if device.index is None or t.device.index is None:
        return True
    return t.device.index == device.index


def device_feed(batches, device, depth: int = 2):
    """Background-thread device feeder (JAX pipeline.py:244-291): a worker
    thread pins each host batch and starts its copy to `device` up to
    `depth` batches ahead of the consumer, so decode and transfer overlap
    the device's work. Yields tuples of tensors; exceptions from the worker
    re-raise in the consumer; closing the generator stops the worker."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    sentinel = object()

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for batch in batches:
                if not _put(to_device(batch, device)):
                    return
        except BaseException as e:  # propagate to consumer
            _put(_FeedError(e))
            return
        _put(sentinel)

    thread = threading.Thread(target=worker, daemon=True, name="device-feed")
    thread.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                return
            if isinstance(item, _FeedError):
                raise item.exc
            yield item
    finally:
        stop.set()
