"""Data parallelism (deeplabv3p_torch/parallel, `Trainer(mesh=...)`) on the
CPU: two gloo ranks spawned once for the module (tests/torch_parallel_workers.py,
which imports no JAX), each on its half of a global batch, against one process
on the whole batch and against JAX `Trainer(mesh=make_mesh(2))`.

`mobilenetv2_lite` unfused and `mobilenetv2` with the fused loss tail, 32x32,
a global batch of 4, 5 classes, SGD, L2 2e-5, per-pixel sample weights, an
ignore band, dropout off; f32 parameters and f64 activations, as in
tests/test_torch_train_step.py (a random-init stack of training-mode BNs is too
ill-conditioned in f32 to compare two implementations).

Bounds: two ranks against one process, the loss and jaccard at rtol 1e-5, BN
buffers and parameters at rtol 1e-4 / atol 1e-5 (those of
tests/test_parallel.py:185-215); against JAX, those of
tests/test_torch_train_step.py: the loss at rtol 1e-4, jaccard at atol 1e-3,
every variable at rtol and atol 1e-4.
"""

import os

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplabv3p_tpu.data.device_cache import DeviceCachedDataset as JaxCached
from deeplabv3p_tpu.losses import get_loss_fn as jax_loss_fn
from deeplabv3p_tpu.models.factory import build_segmentation_model
from deeplabv3p_tpu.parallel.mesh import make_mesh as jax_make_mesh
from deeplabv3p_tpu.train import StageConfig as JaxStageConfig
from deeplabv3p_tpu.train import Trainer as JaxTrainer
from deeplabv3p_torch.data import augment as taug
from deeplabv3p_torch.data import toy as ttoy
from deeplabv3p_torch.data.device_cache import DeviceCachedDataset
from deeplabv3p_torch.data.pipeline import SegmentationDataset
from deeplabv3p_torch.data.shards import ShardedDataset, pack_shards
from deeplabv3p_torch.parallel import Mesh, local_rows, shard_batch, spawn
from deeplabv3p_torch.utils.weights import flatten, load_npz
from test_torch_model import one_torch_thread, random_variables  # noqa: F401 (a fixture)
from test_torch_train import no_dropout
from torch_parallel_workers import RowsDataset, build_model, run_case, run_cases

PX, B, C, LR = 32, 4, 5, 0.05
RANKS = 2
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_variables(model_type, seed):
    model = build_segmentation_model(model_type, C, output_stride=16)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, PX, PX, 3)))
    return random_variables(shapes, seed=seed)


@pytest.fixture(scope="module")
def cases():
    rng = np.random.RandomState(0)
    images = rng.uniform(-1, 1, (B, PX, PX, 3)).astype(np.float32)
    labels = rng.randint(0, C, (B, PX, PX)).astype(np.int32)
    labels[:, :4] = 255
    sw = rng.uniform(0.2, 2.0, (B, PX, PX)).astype(np.float32)
    val = (rng.randint(0, 256, (2 * B, PX, PX, 3)).astype(np.uint8),
           rng.randint(0, C, (2 * B, PX, PX)).astype(np.uint8))
    data = dict(images=images, labels=labels, sw=sw, num_classes=C)
    lite = dict(data, model_type="mobilenetv2_lite", variables=jax_variables("mobilenetv2_lite", 3),
                fused=False, lr=LR)
    return {
        "lite": dict(lite, val=val, val_batch=B),
        "full_fused": dict(data, model_type="mobilenetv2", fused=True, lr=LR,
                           variables=jax_variables("mobilenetv2", 4)),
        # each block checkpointed: the recompute's BN all-reduce over the ranks
        "full_fused_remat_block": dict(data, model_type="mobilenetv2", fused=True, lr=LR,
                                       variables=jax_variables("mobilenetv2", 4),
                                       remat="block"),
        "lite_local_bn": dict(lite, global_bn=False),
        "accum": dict(lite, optimizer="adam", lr=1e-3, grad_accum=2, steps=2),
    }


@pytest.fixture(scope="module")
def ranks(cases, tmp_path_factory):
    """{case: [rank 0's result, rank 1's]} from one spawn of two gloo ranks."""
    log_dir = str(tmp_path_factory.mktemp("ranks"))
    out = spawn(run_cases, RANKS, list(cases.values()), log_dir, device="cpu",
                join_timeout=300)
    return {name: [r[i] for r in out] for i, name in enumerate(cases)}


@pytest.fixture(scope="module")
def one_process(cases, tmp_path_factory):
    log_dir = str(tmp_path_factory.mktemp("one"))
    return {name: run_case(Mesh(), case, log_dir) for name, case in cases.items()
            if name != "lite_local_bn"}


def mismatches(got: dict, want: dict, rtol=1e-4, atol=1e-5) -> list:
    assert got.keys() == want.keys()
    return [k for k in want if not np.allclose(got[k], want[k], rtol=rtol, atol=atol)]


@pytest.mark.parametrize("name", ["lite", "full_fused", "full_fused_remat_block"])
def test_two_ranks_equal_one_process(ranks, one_process, name):
    (got0, got1), want = ranks[name], one_process[name]
    (a,), (b,), (w,) = got0["steps"], got1["steps"], want["steps"]
    # the ranks log the global batch's numbers and hold the same variables
    assert (a["loss"], a["jaccard"]) == (b["loss"], b["jaccard"])
    for k in a["variables"]:
        np.testing.assert_array_equal(a["variables"][k], b["variables"][k], err_msg=k)
    np.testing.assert_allclose(a["loss"], w["loss"], rtol=1e-5)
    np.testing.assert_allclose(a["jaccard"], w["jaccard"], rtol=1e-5)
    assert mismatches(a["variables"], w["variables"]) == []
    assert sum("batch_stats" in k for k in a["variables"]) > 0


def test_per_rank_batchnorm_statistics_fail_the_check(ranks, one_process):
    """Each rank normalising with its own half's statistics (the BNs' group
    removed) is seen: the BN statistics and the parameters leave the bounds."""
    (got, _), want = ranks["lite_local_bn"], one_process["lite"]
    bad = mismatches(got["steps"][0]["variables"], want["steps"][0]["variables"])
    assert sum("batch_stats" in k for k in bad) > 10 and sum("params" in k for k in bad) > 10


def jax_mesh_step(case, tmp_path):
    """One step of JAX `Trainer(mesh=make_mesh(2))` in f64 activations."""
    with jax.enable_x64(True):
        model = build_segmentation_model(case["model_type"], C, output_stride=16,
                                         dtype=jnp.float64)
        trainer = JaxTrainer(model, C, jax_loss_fn("crossentropy"), use_sample_weights=True,
                             l2_factor=2e-5, mesh=jax_make_mesh(RANKS), log_dir=str(tmp_path),
                             fused_loss=case["fused"])
        stage = JaxStageConfig(freeze_level=0, optim_type="sgd", learning_rate=case["lr"])
        params = jax.tree.map(jnp.asarray, case["variables"]["params"])
        state, tx = trainer.build_stage_state(params, case["variables"]["batch_stats"], stage)
        step = trainer.compile_train_step(tx, stage)
        with nn.intercept_methods(no_dropout):
            state, out = step(state, case["images"], case["labels"], case["sw"], 1.0)
        return float(out["loss"]), float(out["jaccard"]), flatten(jax.tree.map(
            np.asarray, {"params": state.params, "batch_stats": state.batch_stats}))


@pytest.mark.parametrize("name", ["lite", "full_fused"])
def test_two_ranks_equal_jax_on_a_two_device_mesh(ranks, cases, name, tmp_path):
    loss, jac, want = jax_mesh_step(cases[name], tmp_path)
    got = ranks[name][0]["steps"][0]
    np.testing.assert_allclose(got["loss"], loss, rtol=1e-4)
    np.testing.assert_allclose(got["jaccard"], jac, atol=1e-3)
    assert mismatches(got["variables"], want, rtol=1e-4, atol=1e-4) == []


def test_grad_accum_rides_the_ranks(ranks, one_process, cases):
    """k = 2 on two ranks (tests/test_grad_accum.py:121): the parameters are
    frozen after micro-step 1, moved after micro-step 2, equal to one process."""
    before = flatten(cases["accum"]["variables"])
    (got, _), want = ranks["accum"], one_process["accum"]
    first, second = got["steps"]
    params = [k for k in before if k.startswith("params/")]
    assert first["updates"] == 0 and second["updates"] == 1
    for k in params:
        np.testing.assert_array_equal(first["variables"][k], before[k], err_msg=k)
    assert sum(not np.array_equal(second["variables"][k], before[k]) for k in params) > 0
    for g, w in zip(got["steps"], want["steps"]):
        assert mismatches(g["variables"], w["variables"]) == []
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5)


def test_rank0_checkpoint_restores_in_one_process_and_in_jax(ranks, one_process, cases,
                                                              tmp_path):
    """The checkpoint rank 0 wrote holds its variables bit for bit; restored
    in one process it evaluates the validation set to the confusion matrix
    the two ranks summed, and so does JAX (tests/test_parallel.py:307)."""
    (got0, got1) = ranks["lite"]
    assert "checkpoint" not in got1
    restored = load_npz(got0["checkpoint"])
    flat = flatten(restored)
    for k, v in got0["steps"][0]["variables"].items():
        np.testing.assert_array_equal(flat[k], v, err_msg=k)
    np.testing.assert_array_equal(got0["confusion"], got1["confusion"])
    assert got0["confusion"].sum() == 2 * B * PX * PX

    case = cases["lite"]
    from deeplabv3p_torch.losses import get_loss_fn
    from deeplabv3p_torch.train import StageConfig, Trainer

    model = build_model("mobilenetv2_lite", C, restored)
    trainer = Trainer(model, C, get_loss_fn("crossentropy"), device="cpu",
                      log_dir=str(tmp_path / "one"))
    state = trainer.build_stage_state(StageConfig())
    one = trainer.evaluate(state, RowsDataset(*case["val"], B, Mesh())).confusion
    np.testing.assert_array_equal(one, got0["confusion"])

    with jax.enable_x64(True):
        jmodel = build_segmentation_model("mobilenetv2_lite", C, output_stride=16,
                                          dtype=jnp.float64)
        jtrainer = JaxTrainer(jmodel, C, jax_loss_fn("crossentropy"), mesh=jax_make_mesh(1),
                              log_dir=str(tmp_path / "jax"))
        jstate, _ = jtrainer.build_stage_state(restored["params"], restored["batch_stats"],
                                               JaxStageConfig())
        jcm = jtrainer.evaluate(jstate, RowsDataset(*case["val"], B, Mesh())).confusion
    np.testing.assert_array_equal(jcm, got0["confusion"])


def test_recalibration_on_rank0_reaches_every_rank(ranks, one_process):
    """`recalibrate_batch_stats` over a mesh: rank 0's pass over the whole
    set, broadcast, leaves both ranks with the same statistics, those of one
    process on the (within bounds) same weights."""
    (got0, got1), want = ranks["lite"], one_process["lite"]
    for k, v in got0["recalibrated"].items():
        np.testing.assert_array_equal(got1["recalibrated"][k], v, err_msg=k)
    assert mismatches(got0["recalibrated"], want["recalibrated"]) == []


def toy_arrays(n, h=6, w=5):
    rng = np.random.RandomState(n)
    images = rng.randint(0, 256, (n, h, w, 3), dtype=np.uint8)
    labels = np.broadcast_to(np.arange(n, dtype=np.uint8)[:, None, None], (n, h, w)).copy()
    return images, labels


@pytest.mark.parametrize("n,batch,shuffle,seed", [
    (10, 4, True, 0), (7, 4, True, 3), (3, 4, True, 1), (12, 6, False, 0)])
def test_sharded_device_cache_yields_jax_sample_order(n, batch, shuffle, seed):
    """Two ranks' device caches, side by side, give the global batches of
    JAX's `DeviceCachedDataset(mesh=make_mesh(2))`, epoch after epoch,
    wrap-around padding included; each rank holds only its block."""
    images, labels = toy_arrays(n)
    want = JaxCached(images, labels, batch_size=batch, mesh=jax_make_mesh(RANKS),
                     shuffle=shuffle, seed=seed)
    got = [DeviceCachedDataset(images, labels, batch_size=batch, device="cpu", shuffle=shuffle,
                               seed=seed, mesh=Mesh(rank, RANKS))
           for rank in range(RANKS)]
    local_n = want._local_n
    assert all(len(g) == len(want) and g._images.shape[0] == local_n for g in got)
    for r, g in enumerate(got):  # rank r holds samples [r * local_n, (r + 1) * local_n) mod n
        np.testing.assert_array_equal(
            g._labels[:, 0, 0].numpy(), np.arange(r * local_n, (r + 1) * local_n) % n)
    for _ in range(3):
        epochs = [list(g.epoch_batches()) for g in got]
        wanted = [tuple(np.asarray(a) for a in b) for b in want.epoch_batches()]
        assert len(wanted) == len(epochs[0]) == len(epochs[1])
        for b, w in enumerate(wanted):
            for i in range(3):
                np.testing.assert_array_equal(
                    np.concatenate([epochs[r][b][i].numpy() for r in range(RANKS)]), w[i])


def test_shard_batch_keeps_this_ranks_rows():
    x = np.arange(12).reshape(6, 2)
    assert shard_batch(Mesh(1, 3), (x, x[:, 0]))[1].tolist() == [4, 6]
    assert local_rows(x, None) is x
    with pytest.raises(ValueError, match="must divide over the mesh's data axis"):
        shard_batch(Mesh(0, 4), x)
    with pytest.raises(ValueError, match="must divide over the mesh's data axis"):
        DeviceCachedDataset(*toy_arrays(8), batch_size=3, device="cpu", mesh=Mesh(0, 2))
    assert torch.equal(local_rows(torch.arange(4), Mesh(1, 2)), torch.tensor([2, 3]))


@pytest.mark.parametrize("form", ["files", "packed"])
def test_host_datasets_give_each_rank_its_rows_of_the_global_batches(form, tmp_path):
    """Both host datasets walk the global batches in one process's order
    (same seed) and hand each rank its rows: the two ranks' batches side by
    side are one process's, epoch after epoch, the padded last batch and
    the CLAHE coins included (tossed in sample order for the whole batch)."""
    root = str(tmp_path / "toy")
    ids = [line.strip() for line in open(ttoy.build_overfit_dataset(
        root, source_dir=os.path.join(REPO, "example")))][:7]  # a short last batch

    def make(mesh):
        ds = SegmentationDataset(root, ids, batch_size=4, num_classes=4, input_shape=(24, 32),
                                 augment=True, histeq_prob=0.5, seed=3, drop_remainder=False,
                                 num_workers=2, mesh=mesh)
        if form == "files":
            return ds
        packed = str(tmp_path / "packed")
        if not os.path.exists(packed):
            pack_shards(ds, packed, shard_size=3)
        return ShardedDataset(packed, batch_size=4, seed=3, drop_remainder=False, mesh=mesh)

    one, ranks = make(None), [make(Mesh(r, RANKS)) for r in range(RANKS)]
    for _ in range(2):
        want = list(one.epoch_batches())
        got = [list(ds.epoch_batches()) for ds in ranks]
        assert len(want) == len(got[0]) == len(got[1]) == 2
        for b, w in enumerate(want):
            for i in range(3):
                np.testing.assert_array_equal(np.concatenate([g[b][i] for g in got]), w[i])
        assert (want[-1][1][3] == 255).all() and (want[-1][1][2] != 255).any()


def test_a_samples_augmentation_does_not_depend_on_the_ranks():
    """`augment_batch(mesh=...)` draws the parameters for the global batch
    and applies this rank's rows: the ranks' outputs side by side equal one
    process's, bit for bit (every op of the chain, the crop included)."""
    rng = np.random.RandomState(2)
    images = torch.from_numpy(rng.randint(0, 256, (4, 24, 32, 3)).astype(np.uint8))
    labels = torch.from_numpy(rng.randint(0, 6, (4, 24, 32)).astype(np.uint8))
    orig_hw = torch.tensor([[48.0, 64.0]] * 4)  # larger than the input: the crop can fire
    cfg = taug.AugmentConfig(crop_prob=0.5)
    want = taug.augment_batch(torch.Generator().manual_seed(5), images, labels, orig_hw, cfg,
                              num_classes=4)
    got = [taug.augment_batch(torch.Generator().manual_seed(5),
                              *shard_batch(Mesh(r, RANKS), (images, labels, orig_hw)), cfg,
                              num_classes=4, mesh=Mesh(r, RANKS)) for r in range(RANKS)]
    for i in range(3):
        assert torch.equal(torch.cat([g[i] for g in got]), want[i])
