"""The port's DeviceCachedDataset (deeplabv3p_torch/data/device_cache.py)
against the JAX one on the CPU: the same arrays and seed give the same
batches in the same order, epoch after epoch; `orig_hw` is the input shape
(so the random crop never fires under the cache); the memory limit and a
mesh raise; `from_source` reads both dataset forms as JAX does; and the
feed passes resident tensors through without a copy."""

import os

import numpy as np
import pytest
import torch

from deeplabv3p_tpu.data import pipeline as jpipe
from deeplabv3p_tpu.data import shards as jshards
from deeplabv3p_tpu.data import toy as jtoy
from deeplabv3p_tpu.data.device_cache import DeviceCachedDataset as JaxCached
from deeplabv3p_torch.data import augment as taug
from deeplabv3p_torch.data import pipeline as tpipe
from deeplabv3p_torch.data import shards as tshards
from deeplabv3p_torch.data.device_cache import DeviceCachedDataset
from test_torch_model import one_torch_thread  # noqa: F401 (a fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def toy_arrays(n=10, h=16, w=12, seed=0):
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, (n, h, w, 3), dtype=np.uint8)
    labels = np.broadcast_to(np.arange(n, dtype=np.uint8)[:, None, None], (n, h, w)).copy()
    return images, labels


def epochs(ds, n):
    return [[tuple(np.asarray(a) if not isinstance(a, torch.Tensor) else a.numpy()
                   for a in batch) for batch in ds.epoch_batches()] for _ in range(n)]


@pytest.mark.parametrize("n,batch,shuffle,seed", [
    (10, 4, True, 0), (10, 4, True, 7), (12, 4, False, 0), (3, 4, True, 1)])
def test_batches_and_order_equal_jax(n, batch, shuffle, seed):
    images, labels = toy_arrays(n)
    want_ds = JaxCached(images, labels, batch_size=batch, shuffle=shuffle, seed=seed)
    got_ds = DeviceCachedDataset(images, labels, batch_size=batch, device="cpu",
                                 shuffle=shuffle, seed=seed)
    assert len(got_ds) == len(want_ds) and got_ds.input_shape == want_ds.input_shape
    want, got = epochs(want_ds, 3), epochs(got_ds, 3)
    assert len(got) == 3 and all(len(e) == len(got_ds) for e in got)
    for we, ge in zip(want, got):
        for wb, gb in zip(we, ge):
            for w, g in zip(wb, gb):
                assert g.dtype == w.dtype and g.shape == w.shape
                np.testing.assert_array_equal(g, w)
    if shuffle:  # the epochs differ: the seeded generator advances
        assert any(not np.array_equal(a[1], b[1]) for a, b in zip(got[0], got[1]))


def test_orig_hw_is_the_input_shape_so_the_crop_never_fires():
    images, labels = toy_arrays(8, 20, 24)
    ds = DeviceCachedDataset(images, labels, batch_size=4, device="cpu", seed=3)
    bi, bl, hw = next(iter(ds.epoch_batches()))
    assert hw.dtype == torch.float32 and torch.equal(hw, torch.tensor([[20.0, 24.0]] * 4))
    params = taug.draw_augment_params(torch.Generator().manual_seed(0), 4, 20, 24,
                                      taug.AugmentConfig(crop_prob=1.0))
    assert params.crop.all()
    got = taug.apply_crop_zoom(bi.float(), bl.int(), hw, params.crop, params.crop_y,
                               params.crop_x)
    assert torch.equal(got[0], bi.float()) and torch.equal(got[1], bl.int())
    # where the original were larger, the same parameters would crop
    bigger = hw * 2
    moved = taug.apply_crop_zoom(bi.float(), bl.int(), bigger, params.crop, params.crop_y,
                                 params.crop_x)
    assert not torch.equal(moved[0], bi.float())


def test_memory_limit_and_mesh_raise():
    images, labels = toy_arrays(10)
    with pytest.raises(ValueError, match="GiB resident"):
        DeviceCachedDataset(images, labels, batch_size=4, device="cpu",
                            mem_limit_bytes=10 * 16 * 12 * 4 - 1)
    DeviceCachedDataset(images, labels, batch_size=4, device="cpu",
                        mem_limit_bytes=10 * 16 * 12 * 4)
    with pytest.raises(ValueError, match="labels shape"):
        DeviceCachedDataset(images, labels[:, :-1], batch_size=4, device="cpu")
    # a mesh that is not the port's (the spatial form runs since it was
    # ported: test_torch_spatial_train.py)
    with pytest.raises(TypeError, match="parallel.Mesh"):
        DeviceCachedDataset(images, labels, batch_size=4, device="cpu", mesh=object())


@pytest.fixture(scope="module")
def toy_dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("toy"))
    list_path = jtoy.build_overfit_dataset(root, source_dir=os.path.join(REPO, "example"))
    return root, list_path


def test_from_source_reads_both_forms_as_jax(toy_dataset, tmp_path):
    root, list_path = toy_dataset
    ids = [line.strip() for line in open(list_path) if line.strip()]
    kw = dict(batch_size=3, num_classes=4, input_shape=(24, 32), augment=False, shuffle=False)
    want = JaxCached.from_source(jpipe.SegmentationDataset(root, ids, **kw), seed=2)
    got = DeviceCachedDataset.from_source(tpipe.SegmentationDataset(root, ids, **kw),
                                          device="cpu", seed=2)
    for w, g in zip(epochs(want, 2), epochs(got, 2)):
        for wb, gb in zip(w, g):
            for a, b in zip(wb, gb):
                np.testing.assert_array_equal(b, a)
    packed = str(tmp_path / "packed")
    tshards.pack_shards(tpipe.SegmentationDataset(root, ids, **kw), packed)
    want = JaxCached.from_source(jshards.ShardedDataset(packed, batch_size=3), seed=5)
    got = DeviceCachedDataset.from_source(tshards.ShardedDataset(packed, batch_size=3),
                                          device="cpu", seed=5)
    for w, g in zip(epochs(want, 2), epochs(got, 2)):
        for wb, gb in zip(w, g):
            for a, b in zip(wb, gb):
                np.testing.assert_array_equal(b, a)


def test_to_device_and_the_feed_pass_resident_tensors_through():
    images, labels = toy_arrays(8)
    ds = DeviceCachedDataset(images, labels, batch_size=4, device="cpu", shuffle=False)
    batch = next(iter(ds.epoch_batches()))
    moved = tpipe.to_device(batch, "cpu")
    assert all(a is b for a, b in zip(moved, batch))
    fed = list(tpipe.device_feed(ds.epoch_batches(), "cpu"))
    assert len(fed) == 2 and fed[0][2] is ds._orig_hw
    np.testing.assert_array_equal(fed[1][0].numpy(), images[4:])
    # numpy batches are still copied to tensors
    host = tpipe.to_device((images[:2], labels[:2]), "cpu")
    assert isinstance(host[0], torch.Tensor) and np.array_equal(host[0].numpy(), images[:2])
