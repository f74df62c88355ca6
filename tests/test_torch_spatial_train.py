"""Spatial partitioning's training, evaluation and data on the CPU
(`Trainer(mesh=<2-D>)`, the H-split device cache; the train CLI's
`--spatial_partition` runs in tests/test_torch_parallel_cli.py): four gloo ranks spawned once for the module on a
('data', 'spatial') mesh of (2, 2), and two once on (1, 2)
(tests/torch_parallel_workers.py, which imports no JAX), against one
process on the global batch and against JAX `Trainer(mesh=make_mesh(4,
('data', 'spatial'), (2, 2)))`.

`mobilenetv2_lite`, `mobilenetv2`, `mobilevit_xxs`, `unet_simple` (32x32,
and 68x64 with its 80-row logits) and `fast_scnn` (32x64), 5 classes, SGD, L2 2e-5,
per-pixel sample weights, an ignore band, dropout off; f32 parameters and
f64 activations, as tests/test_torch_parallel.py. Bounds as there: against
one process the loss and jaccard at rtol 1e-5, every variable at rtol 1e-4
/ atol 1e-5; against JAX the loss at rtol 1e-4, jaccard at atol 1e-3,
every variable at rtol and atol 1e-4. The ranks' variables bit-equal.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deeplabv3p_tpu.data.device_cache import DeviceCachedDataset as JaxCached
from deeplabv3p_tpu.losses import get_loss_fn as jax_loss_fn
from deeplabv3p_tpu.models.factory import build_segmentation_model
from deeplabv3p_tpu.parallel.mesh import make_mesh as jax_make_mesh
from deeplabv3p_tpu.train import StageConfig as JaxStageConfig
from deeplabv3p_tpu.train import Trainer as JaxTrainer
from deeplabv3p_torch.parallel import Mesh, spawn
from deeplabv3p_torch.utils.weights import flatten, load_npz
from test_torch_model import one_torch_thread, random_variables  # noqa: F401 (a fixture)
from test_torch_train import no_dropout
from torch_parallel_workers import WholeSamples, build_model, run_all, spatial_train

PX, C, LR = 32, 5, 0.05


def jax_variables(model_type, seed, hw=(PX, PX)):
    model = build_segmentation_model(model_type, C, output_stride=16)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, *hw, 3)))
    return random_variables(shapes, seed=seed)


def batch(n, seed, hw=(PX, PX)):
    rng = np.random.RandomState(seed)
    images = rng.uniform(-1, 1, (n, *hw, 3)).astype(np.float32)
    labels = rng.randint(0, C, (n, *hw)).astype(np.int32)
    labels[:, 13:17] = 255  # an ignore band across the (1, 2) blocks' edge
    sw = rng.uniform(0.2, 2.0, (n, *hw)).astype(np.float32)
    return dict(images=images, labels=labels, sw=sw, num_classes=C, lr=LR)


def cache_arrays(n, h=6, w=5):
    rng = np.random.RandomState(n)
    images = rng.randint(0, 256, (n, h, w, 3), dtype=np.uint8)
    labels = (np.arange(n, dtype=np.uint8)[:, None, None] * 10
              + np.arange(h, dtype=np.uint8)[None, :, None]).repeat(w, axis=2)
    return images, labels


CACHE = [(10, 4, True, 0), (7, 4, True, 3), (12, 6, False, 0)]


@pytest.fixture(scope="module")
def cases():
    lite = jax_variables("mobilenetv2_lite", 3)
    full = jax_variables("mobilenetv2", 4)
    val = (np.random.RandomState(9).randint(0, 256, (8, PX, PX, 3)).astype(np.uint8),
           np.random.RandomState(8).randint(0, C, (8, PX, PX)).astype(np.uint8))
    b4, b2 = batch(4, 0), batch(2, 1)
    b68 = batch(2, 11, (80, 64))
    unet68 = dict(batch(2, 10, (68, 64)), model_type="unet_simple",
                  variables=jax_variables("unet_simple", 12, (68, 64)))
    return {
        "lite": dict(b4, model_type="mobilenetv2_lite", variables=lite, val=val, val_batch=4),
        "lite_no_halo_backward": dict(b4, model_type="mobilenetv2_lite", variables=lite,
                                      mutation="halo_no_backward"),
        "full_1x2": dict(b2, model_type="mobilenetv2", variables=full),
        # the other families' own row-block forms: MobileViT's gathered
        # attention, UNet's pools and 2x upsamples, Fast-SCNN's pyramid pooling
        "mobilevit_xxs_1x2": dict(b2, model_type="mobilevit_xxs",
                                  variables=jax_variables("mobilevit_xxs", 5)),
        "unet_simple_1x2": dict(b2, model_type="unet_simple",
                                variables=jax_variables("unet_simple", 6)),
        "fast_scnn_1x2": dict(batch(2, 2, (PX, 2 * PX)), model_type="fast_scnn",
                              variables=jax_variables("fast_scnn", 7, (PX, 2 * PX))),
        # 68x64 images, logits 80 rows high (its SAME pools round up, its
        # decoder doubles): labels at the logits' height train as in one
        # process; labels at the image's height raise, as in one process
        "unet_simple68_1x2": dict(unet68, labels=b68["labels"], sw=b68["sw"]),
        "unet_simple68_labels68_1x2": dict(unet68, raises=True),
    }


@pytest.fixture(scope="module")
def ranks(cases, tmp_path_factory):
    """{case: [each rank's result]} on (2, 2), the (1, 2) case on (1, 2);
    with the device cache's batches on (2, 2)."""
    log_dir = str(tmp_path_factory.mktemp("ranks"))
    names = [n for n in cases if not n.endswith("_1x2")]
    on_1x2 = [n for n in cases if n.endswith("_1x2")]
    calls = [("spatial_train", ([cases[n] for n in names], log_dir))]
    calls += [("spatial_device_cache", (*cache_arrays(n), b, shuffle, seed))
              for n, b, shuffle, seed in CACHE]
    out = spawn(run_all, 4, calls, device="cpu", axis_names=("data", "spatial"),
                mesh_shape=(2, 2), join_timeout=400)
    got = {n: [r[0][i] for r in out] for i, n in enumerate(names)}
    got["cache"] = [[r[1 + i] for r in out] for i in range(len(CACHE))]
    two = spawn(spatial_train, 2, [cases[n] for n in on_1x2], log_dir, device="cpu",
                axis_names=("data", "spatial"), mesh_shape=(1, 2), join_timeout=300)
    got.update({n: [r[i] for r in two] for i, n in enumerate(on_1x2)})
    return got


@pytest.fixture(scope="module")
def one_process(cases, tmp_path_factory):
    log_dir = str(tmp_path_factory.mktemp("one"))
    return {n: spatial_train(Mesh(), [case], log_dir)[0] for n, case in cases.items()
            if "mutation" not in case and "raises" not in case}


def mismatches(got: dict, want: dict, rtol=1e-4, atol=1e-5) -> list:
    assert got.keys() == want.keys()
    return [k for k in want if not np.allclose(got[k], want[k], rtol=rtol, atol=atol)]


@pytest.mark.parametrize("name", ["lite", "full_1x2", "mobilevit_xxs_1x2", "unet_simple_1x2",
                                  "fast_scnn_1x2", "unet_simple68_1x2"])
def test_spatial_ranks_equal_one_process(ranks, one_process, name):
    got, want = ranks[name], one_process[name]
    a = got[0]
    for b in got[1:]:  # every rank logs the global batch's numbers, holds the same variables
        assert (a["loss"], a["jaccard"]) == (b["loss"], b["jaccard"])
        for k in a["variables"]:
            np.testing.assert_array_equal(a["variables"][k], b["variables"][k], err_msg=k)
    np.testing.assert_allclose(a["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(a["jaccard"], want["jaccard"], rtol=1e-5)
    assert mismatches(a["variables"], want["variables"]) == []


def test_labels_of_another_height_than_the_logits_raise(ranks, cases, tmp_path):
    """`unet_simple`'s 80-row logits of 68-row images against 68-row
    labels: one process fails in the metric, every rank of the mesh before
    its loss."""
    for got in ranks["unet_simple68_labels68_1x2"]:
        assert got == {"error": "logits 80x64 for labels 68x64"}
    with pytest.raises(RuntimeError, match="4352"):
        spatial_train(Mesh(), [cases["unet_simple68_labels68_1x2"]], str(tmp_path))


def test_a_halo_exchange_without_its_backward_fails_the_check(ranks, one_process):
    """Each halo row's gradient dropped instead of sent to its owner: the
    forward (loss) is still right, the parameters leave the bounds."""
    got, want = ranks["lite_no_halo_backward"][0], one_process["lite"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    bad = mismatches(got["variables"], want["variables"])
    assert sum("params" in k for k in bad) > 10


def jax_2d_step(case, tmp_path):
    """One step of JAX `Trainer` on a (2, 2) ('data', 'spatial') mesh in f64
    activations."""
    with jax.enable_x64(True):
        model = build_segmentation_model(case["model_type"], C, output_stride=16,
                                         dtype=jnp.float64)
        mesh = jax_make_mesh(4, axis_names=("data", "spatial"), mesh_shape=(2, 2))
        trainer = JaxTrainer(model, C, jax_loss_fn("crossentropy"), use_sample_weights=True,
                             l2_factor=2e-5, mesh=mesh, log_dir=str(tmp_path))
        stage = JaxStageConfig(freeze_level=0, optim_type="sgd", learning_rate=case["lr"])
        params = jax.tree.map(jnp.asarray, case["variables"]["params"])
        state, tx = trainer.build_stage_state(params, case["variables"]["batch_stats"], stage)
        step = trainer.compile_train_step(tx, stage)
        with nn.intercept_methods(no_dropout):
            state, out = step(state, case["images"], case["labels"], case["sw"], 1.0)
        return float(out["loss"]), float(out["jaccard"]), flatten(jax.tree.map(
            np.asarray, {"params": state.params, "batch_stats": state.batch_stats}))


def test_spatial_ranks_equal_jax_on_a_2x2_mesh(ranks, cases, tmp_path):
    loss, jac, want = jax_2d_step(cases["lite"], tmp_path)
    got = ranks["lite"][0]
    np.testing.assert_allclose(got["loss"], loss, rtol=1e-4)
    np.testing.assert_allclose(got["jaccard"], jac, atol=1e-3)
    assert mismatches(got["variables"], want, rtol=1e-4, atol=1e-4) == []


def test_rank0_checkpoint_restores_in_one_process_and_in_jax(ranks, cases, tmp_path):
    """The confusion matrix the four ranks summed (each counting the pixels
    of its rows) is one process's on rank 0's checkpoint, and JAX's."""
    got = ranks["lite"]
    assert all("checkpoint" not in g for g in got[1:])
    restored = load_npz(got[0]["checkpoint"])
    flat = flatten(restored)
    for k, v in got[0]["variables"].items():
        np.testing.assert_array_equal(flat[k], v, err_msg=k)
    for g in got[1:]:
        np.testing.assert_array_equal(g["confusion"], got[0]["confusion"])
    val = cases["lite"]["val"]
    assert got[0]["confusion"].sum() == val[1].size

    from deeplabv3p_torch.losses import get_loss_fn
    from deeplabv3p_torch.train import StageConfig, Trainer

    trainer = Trainer(build_model("mobilenetv2_lite", C, restored), C,
                      get_loss_fn("crossentropy"), device="cpu", log_dir=str(tmp_path / "one"))
    one = trainer.evaluate(trainer.build_stage_state(StageConfig()),
                           WholeSamples(*val, 4, Mesh())).confusion
    np.testing.assert_array_equal(one, got[0]["confusion"])
    with jax.enable_x64(True):
        jmodel = build_segmentation_model("mobilenetv2_lite", C, output_stride=16,
                                          dtype=jnp.float64)
        jtrainer = JaxTrainer(jmodel, C, jax_loss_fn("crossentropy"), mesh=jax_make_mesh(1),
                              log_dir=str(tmp_path / "jax"))
        jstate, _ = jtrainer.build_stage_state(restored["params"], restored["batch_stats"],
                                               JaxStageConfig())
        jcm = jtrainer.evaluate(jstate, WholeSamples(*val, 4, Mesh())).confusion
    np.testing.assert_array_equal(jcm, got[0]["confusion"])


@pytest.mark.parametrize("i", range(len(CACHE)), ids=[f"{n}-{b}-{s}-{seed}"
                                                      for n, b, s, seed in CACHE])
def test_spatial_device_cache_yields_jax_sample_order(ranks, i):
    """`test_sharded_device_cache_yields_jax_sample_order`'s spatial cases:
    on (2, 2) each rank holds only its rows of its data block (GSPMD's
    blocks of the 6 rows: 3 + 3), and after the gather over its spatial
    group yields its data group's whole samples, which side by side are
    JAX's global batches of `DeviceCachedDataset(mesh=(2, 2))`."""
    n, b, shuffle, seed = CACHE[i]
    images, labels = cache_arrays(n)
    got = ranks["cache"][i]
    want = JaxCached(images, labels, batch_size=b, shuffle=shuffle, seed=seed,
                     mesh=jax_make_mesh(4, axis_names=("data", "spatial"), mesh_shape=(2, 2)))
    local_n = want._local_n
    for rank, g in enumerate(got):
        d, s = divmod(rank, 2)
        assert g["len"] == len(want)
        rows = np.arange(d * local_n, (d + 1) * local_n) % n
        np.testing.assert_array_equal(g["resident"], labels[rows][:, 3 * s:3 * s + 3])
    for e in range(2):
        wanted = [tuple(np.asarray(a) for a in bt) for bt in want.epoch_batches()]
        assert len(wanted) == len(got[0]["epochs"][e])
        for k, w in enumerate(wanted):
            for j in range(3):
                for s in range(2):  # both ranks of a data group hold the whole samples
                    np.testing.assert_array_equal(np.concatenate(
                        [got[2 * d + s]["epochs"][e][k][j] for d in range(2)]), w[j])
