"""What each rank of tests/test_torch_parallel.py runs. Spawned ranks import
this module, so it imports torch and the port only, never JAX (the conftest,
which imports JAX, is not imported by a spawned rank)."""

from __future__ import annotations

import numpy as np
import torch

from deeplabv3p_torch.losses import get_loss_fn
from deeplabv3p_torch.models.factory import build_segmentation_model
from deeplabv3p_torch.models.layers import Dropout
from deeplabv3p_torch.parallel import Mesh, set_batchnorm_group, shard_batch
from deeplabv3p_torch.train import StageConfig, Trainer, recalibrate_batch_stats
from deeplabv3p_torch.utils.checkpoint import CheckpointManager
from deeplabv3p_torch.utils.weights import flatten, from_jax_variables, to_jax_variables


class RowsDataset:
    """In-memory host batches of a global set: this rank's rows of each."""

    def __init__(self, images_u8, labels_u8, batch_size: int, mesh: Mesh):
        self.images, self.labels = images_u8, labels_u8
        self.batch_size, self.mesh = batch_size, mesh

    def epoch_batches(self):
        for i in range(0, len(self.images), self.batch_size):
            images, labels = shard_batch(self.mesh, (self.images[i:i + self.batch_size],
                                                     self.labels[i:i + self.batch_size]))
            hw = np.tile(np.asarray(images.shape[1:3], np.float32), (len(images), 1))
            yield images, labels, hw


def build_model(model_type: str, num_classes: int, variables, remat=False) -> torch.nn.Module:
    """f32 parameters from a JAX variables tree, f64 activations, dropout off."""
    model = build_segmentation_model(model_type, num_classes, output_stride=16, remat=remat,
                                     dtype=torch.float64, device="cpu")
    model.load_state_dict(from_jax_variables(variables, model), strict=True)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
    return model


def run_case(mesh: Mesh, case: dict, log_dir: str) -> dict:
    """Train `case['steps']` micro-steps on this rank's rows of the case's
    global batch; the loss, jaccard and JAX-layout variables after each,
    and, when the case has val data, the evaluation's confusion matrix, the
    checkpoint rank 0 saved, and the BN statistics after
    `recalibrate_batch_stats` over the val set (which rank 0 reads whole)."""
    c = case["num_classes"]
    model = build_model(case["model_type"], c, case["variables"], case.get("remat", False))
    trainer = Trainer(model, c, get_loss_fn("crossentropy"), device=mesh.device,
                      use_sample_weights=True, l2_factor=2e-5, log_dir=log_dir,
                      fused_loss=case["fused"], mesh=mesh)
    if not case.get("global_bn", True):  # the fault: per-rank statistics
        set_batchnorm_group(model, None)
    stage = StageConfig(freeze_level=0, optim_type=case.get("optimizer", "sgd"),
                        learning_rate=case["lr"], grad_accum=case.get("grad_accum", 1))
    state = trainer.build_stage_state(stage)
    step = trainer.make_train_step(stage)
    images, labels, sw = (torch.from_numpy(a) for a in shard_batch(
        mesh, (case["images"], case["labels"], case["sw"])))
    steps = []
    for _ in range(case.get("steps", 1)):
        m = step(state, images, labels, sw)
        steps.append({"loss": m["loss"].item(), "jaccard": m["jaccard"].item(),
                      "variables": flatten(to_jax_variables(model)),
                      "updates": state.updates})
    out = {"steps": steps}
    if "val" in case:
        val = RowsDataset(*case["val"], case["val_batch"], mesh)
        out["confusion"] = trainer.evaluate(state, val).confusion
        if mesh.rank == 0:
            out["checkpoint"] = CheckpointManager(log_dir).save_final(to_jax_variables(model))
        whole = RowsDataset(*case["val"], case["val_batch"], Mesh())
        recalibrate_batch_stats(model, whole.epoch_batches() if mesh.rank == 0 else None, c,
                                mesh.device, mesh=mesh)
        out["recalibrated"] = flatten(to_jax_variables(model)["batch_stats"])
    return out


def run_cases(mesh: Mesh, cases: list, log_dir: str) -> list:
    """Every case in turn on this rank (one spawn for the module)."""
    torch.set_num_threads(1)
    return [run_case(mesh, case, f"{log_dir}/rank{mesh.rank}_{i}")
            for i, case in enumerate(cases)]


# -- spatial partitioning (tests/test_torch_spatial*.py) ---------------------------------


def data_rows(x, mesh: Mesh):
    """The rank's data group's block of a global batch, whole samples."""
    b = len(x) // mesh.data_size
    return x[mesh.data_index * b:(mesh.data_index + 1) * b]


def spatial_model(case: dict) -> torch.nn.Module:
    """A case's model in eval mode: the JAX `variables` when given, else
    the port's seeded init; f32 or the case's `dtype`; dropout off. `fused`
    True routes the ASPP, the decoder and the inverted residuals through
    the kernels' wrappers, "head" the first two only."""
    from deeplabv3p_torch.models.layers import init_parameters

    fused = case.get("fused", False)
    model = build_segmentation_model(
        case["model_type"], case["num_classes"], output_stride=16,
        use_subpixel=case.get("subpixel", False), fused_aspp=bool(fused),
        fused_decoder=bool(fused), fused_mbconv=fused is True,
        dtype=case.get("dtype", torch.float32), device="cpu")
    if "variables" in case:
        model.load_state_dict(from_jax_variables(case["variables"], model), strict=True)
    else:
        init_parameters(model, torch.Generator().manual_seed(case.get("seed", 0)))
    for m in model.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
    return model.eval()


class _Mutated:
    """A deliberate fault in the spatial code for the length of a case, to
    show that the checks see it: 'halo_no_backward' (each halo row's
    gradient is dropped, never sent back to its owner) or 'block_clamp'
    (the bilinear resize upsamples the rank's block alone, clamping at the
    block's edges)."""

    def __init__(self, kind):
        self.kind = kind

    def __enter__(self):
        import torch.nn.functional as F

        from deeplabv3p_torch.ops import resize
        from deeplabv3p_torch.parallel import spatial

        self.saved = (spatial._Halo.backward, resize._resize_rows)
        if self.kind == "halo_no_backward":
            def backward(ctx, g):
                gx = torch.zeros(ctx.shape, dtype=g.dtype)
                (_, tn), (m0, mn), _ = ctx.plan.top, ctx.plan.mid, ctx.plan.bottom
                gx[:, :, m0:m0 + mn] = g[:, :, tn:tn + mn]
                return gx, None, None

            spatial._Halo.backward = staticmethod(backward)
        elif self.kind == "block_clamp":
            def rows(x, size, part):
                lo, hi = part.block(size[0])
                return F.interpolate(x, size=(hi - lo, size[1]), mode="bilinear",
                                     align_corners=False)

            resize._resize_rows = rows
        return self

    def __exit__(self, *exc):
        from deeplabv3p_torch.ops import resize
        from deeplabv3p_torch.parallel import spatial

        spatial._Halo.backward, resize._resize_rows = (staticmethod(self.saved[0]),
                                                       self.saved[1])


def spatial_forwards(mesh: Mesh, cases: list) -> list:
    """Each case's f32 logits (N, C, H, W) of its `images` (NHWC), this
    rank's block of rows through the model on the spatial group, the rows
    gathered: what every rank holds after the forward."""
    from contextlib import nullcontext

    from deeplabv3p_torch.parallel.spatial import gather_rows, height_of, own_rows, partitioned

    torch.set_num_threads(1)
    out = []
    for case in cases:
        model = spatial_model(case)
        x = torch.from_numpy(data_rows(case["images"], mesh))
        h, w = x.shape[1:3]
        with torch.no_grad(), (_Mutated(case["mutation"]) if "mutation" in case
                               else nullcontext()):
            with partitioned(mesh, (h, w)) as part:
                y = model(own_rows(x, mesh).permute(0, 3, 1, 2)).float()
                h_out = height_of(y)  # UNet's own off multiples of 16
            out.append(gather_rows(y.contiguous(), h_out, part, dim=2).numpy())
    return out


def spatial_train(mesh: Mesh, cases: list, log_dir: str) -> list:
    """`run_case`'s step on a 2-D mesh: the data group's whole samples go
    to the step, which keeps its rows; also, per case flags, the
    evaluation's confusion matrix, rank 0's checkpoint, a DeepLab request's
    mask and the device cache's batches."""
    from contextlib import nullcontext

    torch.set_num_threads(1)
    results = []
    for i, case in enumerate(cases):
        c = case["num_classes"]
        model = build_model(case["model_type"], c, case["variables"], case.get("remat", False))
        tdir = f"{log_dir}/rank{mesh.rank}_{i}"
        trainer = Trainer(model, c, get_loss_fn("crossentropy"), device=mesh.device,
                          use_sample_weights=True, l2_factor=2e-5, log_dir=tdir, mesh=mesh)
        stage = StageConfig(freeze_level=0, optim_type="sgd", learning_rate=case["lr"])
        state = trainer.build_stage_state(stage)
        step = trainer.make_train_step(stage)
        images, labels, sw = (torch.from_numpy(data_rows(a, mesh))
                              for a in (case["images"], case["labels"], case["sw"]))
        if case.get("raises"):  # each rank raises at the same check, after the forward
            try:
                step(state, images, labels, sw)
            except ValueError as e:
                results.append({"error": str(e)})
                continue
        with _Mutated(case["mutation"]) if "mutation" in case else nullcontext():
            m = step(state, images, labels, sw)
        out = {"loss": m["loss"].item(), "jaccard": m["jaccard"].item(),
               "variables": flatten(to_jax_variables(model))}
        if "val" in case:
            val = WholeSamples(*case["val"], case["val_batch"], mesh)
            out["confusion"] = trainer.evaluate(state, val).confusion
            if mesh.rank == 0:
                out["checkpoint"] = CheckpointManager(tdir).save_final(to_jax_variables(model))
        results.append(out)
    return results


class WholeSamples(RowsDataset):
    """In-memory host batches: the rank's data group's whole samples."""

    def epoch_batches(self):
        for i in range(0, len(self.images), self.batch_size):
            images, labels = (data_rows(a[i:i + self.batch_size], self.mesh)
                              for a in (self.images, self.labels))
            hw = np.tile(np.asarray(images.shape[1:3], np.float32), (len(images), 1))
            yield images, labels, hw


def spatial_serving(mesh: Mesh, image, class_names, weights_path: str) -> np.ndarray:
    """`DeepLab(mesh=...)`'s mask of one request, bf16 and f32 kernels'
    plain versions on the CPU."""
    from deeplabv3p_torch.inference import DeepLab

    torch.set_num_threads(1)
    dl = DeepLab(device="cpu", dtype=torch.float32, model_type="mobilenetv2",
                 class_names=class_names, model_input_shape=image.shape[1:3],
                 weights_path=weights_path, fused_decoder=True, fused_mbconv=True, mesh=mesh)
    return dl.predict(image, (image.shape[1] + 9, image.shape[2] - 5))


def spatial_device_cache(mesh: Mesh, images, labels, batch: int, shuffle: bool, seed: int,
                         epochs: int = 2) -> dict:
    """The device cache's resident rows and its batches, epoch after epoch."""
    from deeplabv3p_torch.data.device_cache import DeviceCachedDataset

    ds = DeviceCachedDataset(images, labels, batch_size=batch, device="cpu", shuffle=shuffle,
                             seed=seed, mesh=mesh)
    return {"resident": ds._labels.numpy().copy(), "len": len(ds),
            "epochs": [[tuple(t.numpy().copy() for t in b) for b in ds.epoch_batches()]
                       for _ in range(epochs)]}


def run_all(mesh: Mesh, calls: list) -> list:
    """Each `(function name, args)` of this module in turn on this rank (one
    spawn for several checks)."""
    return [globals()[name](mesh, *args) for name, args in calls]


def batchnorm_group_cases(mesh: Mesh, cases: list) -> list:
    """For each case (x, dy, weight, bias, running mean, running var, each
    rank's index into the global (N, C, H, W) batch): the eager BatchNorm's
    training forward with `group` set, and the kernel pair's plain versions
    with the same group (ops/kernels/batchnorm.py), each as (y, dx,
    dweight, dbias, running mean, running var) on this rank's slice
    (`slices[rank]`, an index of the global batch)."""
    from deeplabv3p_torch.models.layers import BatchNorm
    from deeplabv3p_torch.ops.kernels.batchnorm import batchnorm_train

    out = []
    for x, dy, weight, bias, mean, var, slices in cases:
        rows = slices[mesh.rank]
        x, dy = torch.from_numpy(x[rows].copy()), torch.from_numpy(dy[rows].copy())
        sides = []
        for eager in (True, False):
            bn = BatchNorm(x.shape[1], epsilon=1e-3, dtype=x.dtype, momentum=0.9)
            with torch.no_grad():
                for t, v in ((bn.weight, weight), (bn.bias, bias), (bn.running_mean, mean),
                             (bn.running_var, var)):
                    t.copy_(torch.from_numpy(v))
            bn.group = mesh.group
            xr = x.clone().requires_grad_(True)
            y = (bn._train_forward(xr) if eager else batchnorm_train(
                xr, bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.epsilon,
                bn.momentum, group=mesh.group))
            y.backward(dy)
            sides.append([t.detach().numpy().copy() for t in (
                y, xr.grad, bn.weight.grad, bn.bias.grad, bn.running_mean, bn.running_var)])
        out.append(sides)
    return out
