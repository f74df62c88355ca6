"""The port's training path on the CPU (deeplabv3p_torch.models training
mode, data/, utils/checkpoint.py, train.py), against the JAX package where
it has a counterpart:

* BatchNorm in training mode against flax (f32 and bf16), in a layer and
  in the whole model at 64 px: outputs and updated `batch_stats`, rtol 1e-4;
* dropout: the statistics of its mask, its generator, eval mode;
* the fused ASPP and decoder kernels stay off in training mode;
* the data copies (pipeline, shards, toy, config) equal their originals, and
  the identity `augment_batch` equals the JAX one;
* `python -m deeplabv3p_torch.train` end to end on the toy dataset at 64 px
  with `--fused_loss --no_augment`, both stages, with its own defaults
  (`mobilenetv3large_lite`, the stochastic augmentation), with
  `--device_cache`, and the flags that raise.

The stochastic ops against the JAX ones are in test_torch_augment.py.

The one-step parity of the whole train step is in test_torch_train_step.py.
"""

import json
import os

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplabv3p_tpu.data import augment as jaug
from deeplabv3p_tpu.data import pipeline as jpipe
from deeplabv3p_tpu.data import shards as jshards
from deeplabv3p_tpu.data import toy as jtoy
from deeplabv3p_tpu.models.factory import build_segmentation_model
from deeplabv3p_tpu.models.layers import BatchNorm as JaxBatchNorm
from deeplabv3p_tpu.utils import config as jconfig
from deeplabv3p_torch.data import augment as taug
from deeplabv3p_torch.data import pipeline as tpipe
from deeplabv3p_torch.data import shards as tshards
from deeplabv3p_torch.data import toy as ttoy
from deeplabv3p_torch.models.factory import build_deeplab_model, set_train_mode
from deeplabv3p_torch.models.layers import BatchNorm, Dropout, init_parameters
from deeplabv3p_torch.ops.kernels import aspp as kaspp
from deeplabv3p_torch.ops.kernels import decoder as kdec
from deeplabv3p_torch.losses import get_loss_fn
from deeplabv3p_torch.train import StageConfig, Trainer, main, parse_args
from deeplabv3p_torch.utils import config as tconfig
from deeplabv3p_torch.utils.weights import (
    flatten,
    from_jax_variables,
    jax_path_table,
    load_npz,
)
from test_torch_model import one_torch_thread, random_variables  # noqa: F401 (a fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def no_dropout(next_fun, args, kwargs, context):
    if isinstance(context.module, nn.Dropout) and context.method_name == "__call__":
        return args[0]
    return next_fun(*args, **kwargs)


# -- BatchNorm -----------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 9, 7, 6), (1, 1, 1, 6)], ids=["map", "pooled_n1"])
def test_batchnorm_training_matches_flax(shape, dtype):
    """Biased fast variance in f32, momentum 0.999, the output in the
    compute dtype; at N=1 on a 1x1 map (the image-pooling branch) the
    variance is 0, as in flax."""
    rng = np.random.RandomState(0)
    x = (rng.randn(*shape) * 2.0 + 1.5).astype(np.float32)
    c = shape[-1]
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.normal(0, 0.2, c).astype(np.float32)
    mean = rng.normal(0, 0.3, c).astype(np.float32)
    var = rng.uniform(0.5, 1.5, c).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else None
    bn = JaxBatchNorm(momentum=0.999, epsilon=1e-3, dtype=jdt)
    variables = {"params": {"bn": {"scale": scale, "bias": bias}},
                 "batch_stats": {"bn": {"mean": mean, "var": var}}}
    xj = jnp.asarray(x, jdt or jnp.float32)
    want, upd = bn.apply(variables, xj, train=True, mutable=["batch_stats"])

    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    tbn = BatchNorm(c, 1e-3, dtype=tdt, momentum=0.999)
    with torch.no_grad():
        for t, a in ((tbn.weight, scale), (tbn.bias, bias), (tbn.running_mean, mean),
                     (tbn.running_var, var)):
            t.copy_(torch.from_numpy(a))
    tbn.train()
    got = tbn(torch.from_numpy(x).permute(0, 3, 1, 2).to(tdt))
    assert got.dtype == tdt
    tol = 1e-4 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got.detach().float().permute(0, 2, 3, 1).numpy(),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)
    for key, buf in (("mean", tbn.running_mean), ("var", tbn.running_var)):
        np.testing.assert_allclose(buf.numpy(), np.asarray(upd["batch_stats"]["bn"][key]),
                                   rtol=1e-4, atol=1e-6)
    if shape[0] == 1:  # var 0: running var decays toward 0, output is bias
        np.testing.assert_allclose(tbn.running_var.numpy(), 0.999 * var, rtol=1e-6)


@pytest.fixture(scope="module")
def model_variables():
    model = build_segmentation_model("mobilenetv2", 21, output_stride=16, dtype=jnp.float64)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    return model, random_variables(shapes, seed=2)


def test_model_training_forward_matches_flax(model_variables):
    """The whole model in training mode (freeze level 0, dropout off) at
    64 px, b=2: logits and every updated BN statistic, rtol 1e-4. In f64
    activations (f32 parameters and logits, as in training): at b=2 the
    image-pooling BN normalises two nearly equal pooled vectors, so its f32
    variance is mostly rounding in either framework."""
    jm, variables = model_variables
    x = np.random.RandomState(1).uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    with jax.enable_x64(True), nn.intercept_methods(no_dropout):
        want, upd = jax.jit(lambda v, a: jm.apply(v, a, train=True, mutable=["batch_stats"]))(
            variables, x)
        want = np.asarray(want)
        want_stats = flatten({"batch_stats": jax.tree.map(np.asarray, upd["batch_stats"])})
    model = build_deeplab_model("mobilenetv2", 21, dtype=torch.float64, device="cpu")
    model.load_state_dict(from_jax_variables(variables, model), strict=True)
    set_train_mode(model, 0)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    got_sd = model.state_dict()
    moved = 0
    for path, (key, _) in jax_path_table(model).items():
        if path.startswith("batch_stats/"):
            assert got_sd[key].dtype == torch.float32
            np.testing.assert_allclose(got_sd[key].numpy(), want_stats[path], rtol=1e-4,
                                       atol=1e-6, err_msg=path)
            moved += not np.array_equal(want_stats[path], flatten(variables)[path])
    assert moved == len([p for p in want_stats if p.startswith("batch_stats/")])


# BN scales of the mobilenetv2 head whose output reaches a training-mode BN
# through per-channel ops only (ReLU, dropout, resize, concat, a depthwise
# conv): that BN normalises their scale away but for its epsilon
NEARLY_SCALE_INVARIANT_BN = ("aspp.concat_projection_BN.weight",
                             "decoder.feature_projection0_BN.weight",
                             "decoder.decoder_conv0.pointwise_BN.weight")


def test_nearly_scale_invariant_head_bn_scales_get_almost_no_gradient():
    """From the trainer's init (flax's identity BN) in training mode, those
    three BN scales get gradients below 1e-4 of the head's largest (f64
    activations; measured 6e-7 to 1.5e-5 at 128 px) and every other head
    weight above 1e-3 (measured >= 5e-3): after two f32 SGD steps the three
    move by a few ulps or not at all, so chip_smoke.py's training check
    holds them apart."""
    model = build_deeplab_model("mobilenetv2", 21, dtype=torch.float64, device="cpu")
    init_parameters(model, torch.Generator().manual_seed(0), bn_identity=True)
    set_train_mode(model, 0)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
    x = torch.from_numpy(np.random.RandomState(4).uniform(-1, 1, (2, 3, 128, 128)))
    labels = torch.from_numpy(np.random.RandomState(5).randint(0, 21, (2, 128, 128)))
    torch.nn.functional.cross_entropy(model(x).double(), labels.long()).backward()
    head = {n: p.grad.abs().max().item() for n, p in model.named_parameters()
            if not n.startswith("backbone.") and n.endswith(".weight")}
    top = max(head.values())
    for name in NEARLY_SCALE_INVARIANT_BN:
        assert head[name] < 1e-4 * top, name
    others = {n: g for n, g in head.items() if n not in NEARLY_SCALE_INVARIANT_BN}
    assert min(others.values()) > 1e-3 * top, min(others, key=others.get)


def test_freeze_levels_set_the_modes():
    model = build_deeplab_model("mobilenetv2", 5, device="cpu")
    for level, backbone, head in ((0, True, True), (1, False, True), (2, False, False)):
        set_train_mode(model, level)
        assert model.backbone.Conv_BN.training is backbone
        assert model.aspp.aspp0_BN.training is head
        assert model.aspp.dropout.training is head
        assert model.decoder.decoder_conv1.pointwise_BN.training is head
    bns = [m.momentum for n, m in model.named_modules()
           if isinstance(m, BatchNorm) and n.startswith("backbone.")]
    assert bns and set(bns) == {0.999}
    heads = [m.momentum for n, m in model.named_modules()
             if isinstance(m, BatchNorm) and not n.startswith("backbone.")]
    assert heads and set(heads) == {0.99}


# -- dropout ---------------------------------------------------------------------


def test_dropout_statistics_generator_and_eval_mode():
    x = torch.randn(8, 256, 16, 16).contiguous(memory_format=torch.channels_last)
    drop = Dropout(0.5)
    drop.generator = torch.Generator().manual_seed(3)
    drop.train()
    y = drop(x)
    zero = (y == 0).float().mean().item()
    assert 0.49 < zero < 0.51
    kept = y != 0
    torch.testing.assert_close(y[kept], 2.0 * x[kept])
    drop.generator = torch.Generator().manual_seed(3)
    assert torch.equal(drop(x), y)  # the same seed draws the same mask
    yb = drop(x.bfloat16())
    assert yb.dtype == torch.bfloat16
    drop.eval()
    assert drop(x) is x
    # in the model, after the ASPP projection, ASPP-Lite's too
    for model_type in ("mobilenetv2", "mobilenetv2_lite"):
        m = build_deeplab_model(model_type, 5, device="cpu")
        assert isinstance(m.aspp.dropout, Dropout) and m.aspp.dropout.rate == 0.5


def test_fused_kernels_are_not_used_in_training(monkeypatch):
    """The ASPP and decoder kernels carry no gradient: a model built with
    both on takes the standard path in training mode (JAX layers.py:340-345,
    :469-476), and the kernels again in eval mode."""
    calls = []

    def spy(name, fn):
        def wrapped(*args, **kw):
            calls.append(name)
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(kaspp, "multirate_atrous_depthwise",
                        spy("aspp", kaspp.multirate_atrous_depthwise))
    monkeypatch.setattr(kdec, "fused_decoder_frontend",
                        spy("decoder", kdec.fused_decoder_frontend))
    model = build_deeplab_model("mobilenetv2", 5, fused_aspp=True, fused_decoder=True,
                                device="cpu")
    init_parameters(model, torch.Generator().manual_seed(0))
    x = torch.randn(2, 3, 64, 64)
    for level in (0, 1):
        set_train_mode(model, level)
        logits = model(x, skip_final_resize=True)
        logits.float().square().mean().backward()
        assert calls == [], level
    model.eval()
    with torch.no_grad():
        model(x)
    assert calls == ["aspp", "decoder"]


# -- data ------------------------------------------------------------------------


@pytest.fixture(scope="module")
def toy_dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("toy"))
    list_path = ttoy.build_overfit_dataset(root, source_dir=os.path.join(REPO, "example"))
    return root, list_path


def test_toy_copy_writes_the_same_files(toy_dataset, tmp_path):
    root, _ = toy_dataset
    jtoy.build_overfit_dataset(str(tmp_path), source_dir=os.path.join(REPO, "example"))
    names = sorted(os.path.relpath(os.path.join(d, f), root)
                   for d, _, fs in os.walk(root) for f in fs)
    assert len(names) == 2 * 8 + 2
    for name in names:
        with open(os.path.join(root, name), "rb") as a, \
                open(os.path.join(tmp_path, name), "rb") as b:
            assert a.read() == b.read(), name


def test_pipeline_and_config_copies_equal_the_originals(toy_dataset):
    root, list_path = toy_dataset
    assert tconfig.get_data_list(list_path) == jconfig.get_data_list(list_path)
    ids = tconfig.get_data_list(list_path)
    # one decode worker: the CLAHE draws come from the dataset's RandomState
    # inside the workers, so with more than one their order is the threads'
    kw = dict(batch_size=3, num_classes=4, input_shape=(48, 40), augment=True,
              histeq_prob=0.5, seed=5, drop_remainder=False, num_workers=1)
    for a, b in zip(tpipe.SegmentationDataset(root, ids, **kw).epoch_batches(),
                    jpipe.SegmentationDataset(root, ids, **kw).epoch_batches(), strict=True):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    ds = tpipe.SegmentationDataset(root, ids, batch_size=2, num_classes=4,
                                   input_shape=(32, 32), augment=False, shuffle=False)
    w_t = tconfig.calculate_weights_labels(ds, 4)
    w_j = jconfig.calculate_weights_labels(ds, 4)
    np.testing.assert_array_equal(w_t, w_j)


def test_shards_copy_packs_and_reads_the_same(toy_dataset, tmp_path):
    root, list_path = toy_dataset
    ds = tpipe.SegmentationDataset(root, tconfig.get_data_list(list_path), batch_size=2,
                                   num_classes=4, input_shape=(32, 32), augment=False,
                                   shuffle=False)
    tshards.pack_shards(ds, str(tmp_path / "t"), shard_size=3)
    jshards.pack_shards(ds, str(tmp_path / "j"), shard_size=3)
    assert sorted(os.listdir(tmp_path / "t")) == sorted(os.listdir(tmp_path / "j"))
    for name in os.listdir(tmp_path / "t"):
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()
    assert tshards.is_packed_dataset(str(tmp_path / "t"))
    kw = dict(batch_size=3, seed=2, drop_remainder=False)
    for a, b in zip(tshards.ShardedDataset(str(tmp_path / "t"), **kw).epoch_batches(),
                    jshards.ShardedDataset(str(tmp_path / "j"), **kw).epoch_batches(),
                    strict=True):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_device_feed_yields_in_order_and_reraises():
    batches = [(np.full((2, 3), i, np.uint8),) for i in range(5)]
    got = [t[0] for t in tpipe.device_feed(iter(batches), "cpu")]
    assert [int(t[0, 0]) for t in got] == list(range(5))
    assert all(isinstance(t, torch.Tensor) for t in got)

    def broken():
        yield batches[0]
        raise OSError("decode failed")

    with pytest.raises(OSError, match="decode failed"):
        list(tpipe.device_feed(broken(), "cpu"))


def test_identity_augment_and_eval_preprocess_match_jax():
    rng = np.random.RandomState(3)
    images = rng.randint(0, 256, (3, 20, 24, 3)).astype(np.uint8)
    labels = rng.randint(0, 6, (3, 20, 24)).astype(np.uint8)
    labels[0, :4] = 255
    labels[2, 5] = 9  # above C-1: becomes the ignore index
    orig_hw = np.tile(np.float32([20, 24]), (3, 1))
    cfg = jaug.AugmentConfig.identity()
    wi, wl, ww = jaug.augment_batch(jax.random.PRNGKey(0), images, labels, orig_hw, cfg,
                                    num_classes=6)
    ti, tl, tw = taug.augment_batch(None, torch.from_numpy(images), torch.from_numpy(labels),
                                    None, taug.AugmentConfig.identity(), num_classes=6)
    # JAX's identity blends (gray + 1 * (x - gray)) may round by an ulp of 255
    np.testing.assert_allclose(ti.numpy(), np.asarray(wi), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(wl))
    np.testing.assert_allclose(tw.numpy(), np.asarray(ww), rtol=1e-6)
    for i in range(3):  # the batched bincount equals the per-image one
        np.testing.assert_allclose(
            tw[i].numpy(), np.asarray(jaug.adaptive_class_weights(jnp.asarray(wl[i]))),
            rtol=1e-6)
    pi, pl = taug.preprocess_eval_batch(torch.from_numpy(images), torch.from_numpy(labels), 6)
    qi, ql = jaug.preprocess_eval_batch(images, labels, num_classes=6)
    np.testing.assert_allclose(pi.numpy(), np.asarray(qi), rtol=0, atol=2.4e-7)  # XLA's FMA
    np.testing.assert_array_equal(pl.numpy(), np.asarray(ql))
    # the default config runs the stochastic chain (held op by op against JAX in
    # test_torch_augment.py): same shapes and types, labels in range
    di, dl, dw = taug.augment_batch(torch.Generator().manual_seed(0), torch.from_numpy(images),
                                    torch.from_numpy(labels), None, taug.AugmentConfig(),
                                    num_classes=6)
    assert di.shape == ti.shape and di.dtype == torch.float32
    assert -1.0 <= di.min() and di.max() <= 1.0
    assert dl.dtype == torch.int32 and set(dl.unique().tolist()) <= {*range(6), 255}
    torch.testing.assert_close(dw, taug.adaptive_class_weights(dl), rtol=0, atol=0)


# -- the CLI -----------------------------------------------------------------------


def cli_args(toy, log_dir, *extra):
    root, list_path = toy
    return parse_args([
        "--model_type", "mobilenetv2", "--model_input_shape", "64", "--batch_size", "4",
        "--no_augment", "--transfer_epoch", "1", "--total_epoch", "2",
        "--freeze_level", "1", "--optimizer", "sgd", "--decay_type", "cosine",
        "--dataset_path", root, "--dataset_file", list_path,
        "--classes_path", os.path.join(root, "classes.txt"), "--device", "cpu",
        "--log_dir", str(log_dir), *extra])


def test_cli_trains_both_stages_with_the_fused_loss(toy_dataset, tmp_path):
    from deeplabv3p_torch.inference import DeepLab

    log_dir = tmp_path / "logs"
    trainer = main(cli_args(toy_dataset, log_dir, "--fused_loss", "--seed", "7"))
    records = [json.loads(line) for line in (log_dir / "history.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in records] == [0, 1]
    assert all(np.isfinite(r["loss"]) and r["steps"] == 2 for r in records)
    assert trainer.history == records

    # stage 1 (freeze level 1): backbone parameters and BN statistics as
    # initialised, the head moved; stage 2 moved the backbone
    init = build_deeplab_model("mobilenetv2", 4, dtype=torch.bfloat16, device="cpu")
    init_parameters(init, torch.Generator().manual_seed(7), bn_identity=True)
    start = {k: v.clone().numpy() for k, v in init.state_dict().items()}
    m = build_deeplab_model("mobilenetv2", 4, device="cpu")
    (stage1,) = [p for p in os.listdir(log_dir) if p.startswith("ep000-")]
    m.load_state_dict(from_jax_variables(load_npz(str(log_dir / stage1)), m))
    after1 = {k: v.clone().numpy() for k, v in m.state_dict().items()}
    m.load_state_dict(from_jax_variables(load_npz(str(log_dir / "trained_final.npz")), m))
    final = {k: v.clone().numpy() for k, v in m.state_dict().items()}
    for k in start:
        if k.startswith("backbone."):
            np.testing.assert_array_equal(after1[k], start[k], err_msg=k)
    assert not np.array_equal(after1["aspp.aspp0.weight"], start["aspp.aspp0.weight"])
    assert not np.array_equal(after1["aspp.aspp0_BN.running_mean"],
                              start["aspp.aspp0_BN.running_mean"])
    assert not np.array_equal(final["backbone.Conv.weight"], start["backbone.Conv.weight"])
    assert not np.array_equal(final["backbone.Conv_BN.running_var"],
                              start["backbone.Conv_BN.running_var"])

    deeplab = DeepLab(device="cpu", dtype=torch.float32, model_type="mobilenetv2",
                      classes_path=os.path.join(toy_dataset[0], "classes.txt"),
                      model_input_shape=(64, 64), weights_path=str(log_dir / "trained_final.npz"))
    x = np.random.RandomState(0).uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    mask = deeplab.predict(x, (50, 70))
    assert mask.shape == (50, 70) and 0 <= mask.min() and mask.max() < 4


def test_cli_unfused_with_val_and_eval_online(toy_dataset, tmp_path):
    """The unfused loss, adaptive weights, a val set and online eval:
    the records carry val/eval mIoU and the eval checkpoint is kept."""
    log_dir = tmp_path / "logs"
    main(cli_args(toy_dataset, log_dir, "--transfer_epoch", "0", "--total_epoch", "1",
                  "--weighted_type", "adaptive", "--val_dataset_file", toy_dataset[1],
                  "--eval_online", "--eval_epoch_interval", "1",
                  "--weights_average_type", "ema"))
    (rec,) = [json.loads(line) for line in (log_dir / "history.jsonl").read_text().splitlines()]
    assert 0.0 <= rec["val_miou"] <= 1.0 and rec["eval_miou"] == rec["val_miou"]
    assert any(p.startswith("eval_ep000-") for p in os.listdir(log_dir))


def default_cli_args(toy, log_dir, *extra):
    """Only what a user must give (data, classes), the size cut to 64 px and
    b4, two one-epoch stages: the default model and --augment."""
    root, list_path = toy
    return parse_args([
        "--dataset_path", root, "--dataset_file", list_path,
        "--classes_path", os.path.join(root, "classes.txt"), "--model_input_shape", "64",
        "--batch_size", "4", "--transfer_epoch", "1", "--total_epoch", "2",
        "--device", "cpu", "--log_dir", str(log_dir), *extra])


@pytest.mark.parametrize("extra", [(), ("--fused_loss",), ("--device_cache",)])
def test_cli_runs_with_its_defaults(toy_dataset, tmp_path, extra, monkeypatch):
    """mobilenetv3large_lite with the stochastic augmentation (the defaults),
    alone and with --fused_loss or --device_cache: both stages train, the
    augmentation ran on every batch, and the final weights load strictly
    into the default model. Under --device_cache the batches come from the
    resident set, whose orig_hw is the input shape."""
    calls = []
    real = taug.apply_augment

    def spy(params, images, labels, orig_hw, cfg=taug.AugmentConfig()):
        calls.append((images.shape, orig_hw.clone()))
        return real(params, images, labels, orig_hw, cfg)

    monkeypatch.setattr(taug, "apply_augment", spy)
    log_dir = tmp_path / "logs"
    args = default_cli_args(toy_dataset, log_dir, *extra)
    assert (args.model_type, args.augment) == ("mobilenetv3large_lite", True)
    trainer = main(args)
    records = [json.loads(line) for line in (log_dir / "history.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in records] == [0, 1] and trainer.history == records
    assert all(np.isfinite(r["loss"]) and r["steps"] == 2 for r in records)
    assert len(calls) == 4 and all(shape == (4, 64, 64, 3) for shape, _ in calls)
    if "--device_cache" in extra:
        assert all(torch.equal(hw, torch.tensor([[64.0, 64.0]] * 4)) for _, hw in calls)
    else:  # the toy pairs keep their original sizes
        assert any(not torch.equal(hw, torch.tensor([[64.0, 64.0]] * 4)) for _, hw in calls)
    m = build_deeplab_model("mobilenetv3large_lite", 4, device="cpu")
    m.load_state_dict(from_jax_variables(load_npz(str(log_dir / "trained_final.npz")), m),
                      strict=True)


class SameBatch:
    """A dataset whose every epoch is one fixed host batch."""

    def __init__(self, images, labels):
        self.batch = (images, labels, np.tile(np.float32(images.shape[1:3]), (len(images), 1)))

    def epoch_batches(self):
        yield self.batch


def test_fit_reduces_lr_on_plateau_and_stops_early_or_on_nan(tmp_path):
    """At LR 0 without dropout the train jaccard never improves: the LR
    scale halves after each plateau of `reduce_lr_patience` epochs and the
    stage stops at `early_stop_patience` (JAX train.py:655-672). A NaN loss
    ends the whole run after its epoch (TerminateOnNaN)."""
    model = build_deeplab_model("mobilenetv2_lite", 3, device="cpu")
    init_parameters(model, torch.Generator().manual_seed(0), bn_identity=True)
    model.aspp.dropout.rate = 0.0
    rng = np.random.RandomState(0)
    data = SameBatch(rng.randint(0, 256, (2, 32, 32, 3)).astype(np.uint8),
                     rng.randint(0, 3, (2, 32, 32)).astype(np.uint8))
    trainer = Trainer(model, 3, get_loss_fn("crossentropy"), device="cpu",
                      log_dir=str(tmp_path))
    stage = StageConfig(learning_rate=0.0, epochs=10)
    trainer.fit(data, [stage], reduce_lr_patience=1, early_stop_patience=3)
    assert [r["lr_scale"] for r in trainer.history] == [1.0, 1.0, 0.5, 0.25]
    assert trainer.history[-1]["terminated"] == "early_stop"

    trainer.history.clear()
    with torch.no_grad():
        model.conv_upsample.weight.fill_(float("nan"))
    trainer.fit(data, [stage, stage])
    assert len(trainer.history) == 1 and trainer.history[0]["terminated"] == "nan"


@pytest.mark.parametrize("flags,match", [
    (["--no_augment", "--spatial_partition", "2"], "spatial_partition"),
    (["--no_augment", "--num_devices", "2"], "num_devices"),
    (["--no_augment", "--remat"], "remat"),
])
def test_unported_flags_raise(flags, match, tmp_path):
    args = parse_args(["--device", "cpu", "--log_dir", str(tmp_path), *flags])
    with pytest.raises(NotImplementedError, match=f"{match}.*ROADMAP"):
        main(args)


def test_cuda_device_without_a_card_is_an_error(toy_dataset, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    args = cli_args(toy_dataset, tmp_path)
    args.device = "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        main(args)
