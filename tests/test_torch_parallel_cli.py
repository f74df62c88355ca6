"""`python -m deeplabv3p_torch.train --device cpu --num_devices 2` on the toy
set (data/toy.py, 8 pairs at 64 px, b4: two steps an epoch), with and without
`--device_cache` (with `--bn_recalibrate`: rank 0's pass, broadcast), and the
same CLI as two ranks of a torchrun launch (with `--weighted_type balanced`:
rank 0's class weights, broadcast): rank 0 alone writes one history.jsonl
(the loss falls over the two epochs) and the final checkpoint, which loads.
A `jax` module that raises when imported sits first on the ranks' path, so a
rank that imported JAX would fail the run. Then the arguments that raise (a
batch that does not divide over the ranks, `--device cuda` without a card,
`--fused_loss` with `--spatial_partition 2`), and `--spatial_partition 2`
itself, refused before spatial partitioning was ported, now two ranks of a
(1, 2) mesh that train."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from deeplabv3p_torch.data import toy as ttoy
from deeplabv3p_torch.models.factory import build_segmentation_model
from deeplabv3p_torch.train import main, parse_args
from deeplabv3p_torch.utils.weights import from_jax_variables, load_npz
from test_torch_model import one_torch_thread  # noqa: F401 (a fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("toy"))
    list_path = ttoy.build_overfit_dataset(root, source_dir=os.path.join(REPO, "example"))
    return root, list_path


@pytest.fixture(scope="module")
def no_jax_env(tmp_path_factory):
    """The environment of a CLI run whose processes cannot import JAX."""
    guard = tmp_path_factory.mktemp("nojax")
    (guard / "jax").mkdir()
    (guard / "jax" / "__init__.py").write_text(
        "raise RuntimeError('a data-parallel rank imported jax')\n")
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = os.pathsep.join([str(guard), REPO])
    return env


def argv(toy, log_dir, *extra):
    root, list_path = toy
    return ["--model_type", "mobilenetv2_lite", "--model_input_shape", "64",
            "--batch_size", "4", "--no_augment", "--transfer_epoch", "0", "--total_epoch", "2",
            "--optimizer", "adam", "--learning_rate", "1e-3", "--dataset_path", root,
            "--dataset_file", list_path, "--classes_path", os.path.join(root, "classes.txt"),
            "--device", "cpu", "--log_dir", str(log_dir), *extra]


@pytest.mark.parametrize("launch,extra", [
    ("spawn", ()), ("spawn", ("--device_cache", "--bn_recalibrate")),
    ("torchrun", ("--weighted_type", "balanced"))],
    ids=["spawn", "spawn-device_cache", "torchrun"])
def test_two_ranks_train_the_toy_set(toy, no_jax_env, tmp_path, launch, extra):
    log_dir = tmp_path / "logs"
    if launch == "spawn":
        cmd = [sys.executable, "-m", "deeplabv3p_torch.train", "--num_devices", "2"]
    else:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", "2", "-m", "deeplabv3p_torch.train"]
    r = subprocess.run([*cmd, *argv(toy, log_dir, *extra)], env=no_jax_env, cwd=str(tmp_path),
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "imported jax" not in r.stderr
    # rank 0 alone prints and writes: one line an epoch, one final save
    assert r.stdout.count("saved final model") == 1
    records = [json.loads(line) for line in (log_dir / "history.jsonl").read_text().splitlines()]
    assert [rec["epoch"] for rec in records] == [0, 1]
    assert all(rec["steps"] == 2 and np.isfinite(rec["loss"]) for rec in records)
    assert records[1]["loss"] < records[0]["loss"]
    model = build_segmentation_model("mobilenetv2_lite", 4, device="cpu")
    model.load_state_dict(from_jax_variables(load_npz(str(log_dir / "trained_final.npz")),
                                             model), strict=True)


@pytest.mark.parametrize("extra,error,match", [
    (["--num_devices", "3"], ValueError,
     r"batch_size 4 must divide over the mesh's data axis \(3\)"),
    # a spatial split of two ranks trains since spatial partitioning was ported
    (["--num_devices", "2", "--spatial_partition", "2"], None, None),
    (["--num_devices", "2", "--device", "cuda"], RuntimeError, "cuda"),
    (["--num_devices", "2", "--spatial_partition", "2", "--fused_loss"], SystemExit,
     r"--fused_loss supports data-parallel meshes only \(--spatial_partition 1\); the "
     r"in-kernel upsample would need a halo exchange under an H-split"),
], ids=["batch", "spatial", "cuda", "fused_loss-spatial"])
def test_arguments_that_raise(toy, no_jax_env, tmp_path, extra, error, match):
    """What the CLI refuses, as the root CLI words it; and the case that no
    longer raises: `python -m deeplabv3p_torch.train` spawns two ranks on a
    (1, 2) mesh that train the toy set with the augmentation on
    (tests/test_parallel.py:372-410), rank 0 alone writing the history and
    the final weights."""
    if "cuda" in extra and torch.cuda.is_available():
        pytest.skip("this machine has a card")
    if error is None:
        cmd = [sys.executable, "-m", "deeplabv3p_torch.train",
               *(a for a in argv(toy, tmp_path, *extra) if a != "--no_augment")]
        r = subprocess.run(cmd, env=no_jax_env, cwd=str(tmp_path), capture_output=True,
                           text=True, timeout=240)
        assert r.returncode == 0, r.stderr[-3000:]
        assert r.stdout.count("saved final model") == 1
        records = [json.loads(line) for line in (tmp_path / "history.jsonl").read_text()
                   .splitlines()]
        assert [rec["epoch"] for rec in records] == [0, 1]
        assert all(rec["steps"] == 2 and np.isfinite(rec["loss"]) for rec in records)
        assert os.path.exists(tmp_path / "trained_final.npz")
        return
    with pytest.raises(error, match=match):
        main(parse_args(argv(toy, tmp_path, *extra)))
    assert not os.path.exists(tmp_path / "history.jsonl")
