"""Spatial partitioning's forward (deeplabv3p_torch/parallel/spatial.py and
the row-block forms of the operators) on the CPU: four gloo ranks spawned
once for the module on a ('data', 'spatial') mesh of (1, 4), each running the model on its block of every map's rows
(tests/torch_parallel_workers.py, which imports no JAX), against one
process on the whole image and against JAX's forward on the same mesh
(GSPMD's halo exchanges, tests/test_parallel.py:225-250).

At 64 px over 4 ranks the OS16 map has one row a rank, thinner than ASPP's
halo of 18; at 32 px over 4 ranks two ranks' OS16 blocks are empty (JAX's
own case, 64 px over 8, spawns twice the ranks for the same property), and
at 12 px one rank's block of the decoder's skip map too. The kernels' wrappers run their plain versions here (fused
ASPP, decoder and inverted residual on the blocks' slabs). `unet_simple` at
68x64 gives maps of one width two heights and logits 80 rows high,
gathered at that height.

Bounds: f32 logits at rtol/atol 1e-4 of one process and of JAX, as
tests/test_parallel.py:250 holds JAX's own; the decoder's row-block form
against the whole map at 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplabv3p_tpu.models.factory import build_segmentation_model as jax_build
from deeplabv3p_tpu.parallel.mesh import _auto_shape, batch_arg_sharding, replicated_sharding
from deeplabv3p_tpu.parallel.mesh import make_mesh as jax_make_mesh
from deeplabv3p_torch.inference import DeepLab
from deeplabv3p_torch.ops.kernels.decoder import fused_decoder_frontend
from deeplabv3p_torch.ops.resize import source_rows
from deeplabv3p_torch.parallel import Mesh, local_rows, spawn
from deeplabv3p_torch.parallel.mesh import auto_shape
from deeplabv3p_torch.parallel.spatial import Partition, block
from deeplabv3p_torch.utils.weights import save_npz
from test_torch_model import one_torch_thread, random_variables  # noqa: F401 (a fixture)
from torch_parallel_workers import spatial_forwards, spatial_model, spatial_serving

C = 5
# one logits case a registry entry (and the subpixel head), 32 px over (1, 4); Fast-SCNN
# at 32x64 (its 1/32 map 1x2 rows: two blocks empty)
FAMILIES = ["mobilenetv3large", "mobilenetv3small_lite", "xception", "resnet50", "ghostnet",
            "peleenet_lite", "mobilevit_xxs", "unet_simple", "unet_lite", "fast_scnn",
            "mobilenetv2+subpixel",
            # ... and the registry's other entries, one case each
            "mobilenetv3large_lite", "mobilenetv3small", "ghostnet_lite", "peleenet",
            "mobilevit_s", "mobilevit_s_lite", "mobilevit_xs", "mobilevit_xs_lite",
            "mobilevit_xxs_lite"]


def jax_variables(model_type, px, seed, w=None):
    model = jax_build(model_type, C, output_stride=16)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, px, w or px, 3)))
    return random_variables(shapes, seed=seed)


def image(px, n=1, seed=0, w=None):
    return np.random.RandomState(seed).uniform(-1, 1, (n, px, w or px, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def cases():
    full = dict(model_type="mobilenetv2", num_classes=C, images=image(64),
                variables=jax_variables("mobilenetv2", 64, 1))
    out = {
        "lite64": dict(full, model_type="mobilenetv2_lite", images=image(64, seed=2),
                       variables=jax_variables("mobilenetv2_lite", 64, 2)),
        "full64": full,
        "full64_fused_head": dict(full, fused="head"),
        "full64_fused": dict(full, images=image(64, n=2, seed=4), fused=True),
        "full32_empty": dict(full, images=image(32, seed=3)),
        "full32_empty_fused": dict(full, images=image(32, seed=3), fused=True),
        # 12 px: the skip map's 3 rows leave rank 3's decoder block empty
        "full12_empty_fused": dict(full, images=image(12, seed=3), fused=True),
        "full64_block_clamp": dict(full, mutation="block_clamp"),
        # 68x64: the encoder's SAME pools round 68 -> 34 -> 17 -> 9 -> 5, the
        # decoder doubles 5 -> 10 -> 20 -> 40 -> 80, so widths 8-64 each
        # have two heights and the logits are 80 rows high
        "unet_simple68": dict(model_type="unet_simple", num_classes=C,
                              images=image(68, seed=31, w=64),
                              variables=jax_variables("unet_simple", 68, 31, w=64)),
    }
    for i, name in enumerate(FAMILIES):
        x = image(32, seed=10 + i)
        if name == "fast_scnn":
            x = np.concatenate([x, x[:, :, ::-1]], axis=2)
        out[name] = dict(model_type=name.split("+")[0], num_classes=C, images=x, seed=i,
                         subpixel=name.endswith("+subpixel"))
    out["unet_standard"] = dict(model_type="unet_standard", num_classes=C,
                                images=image(32, seed=30), seed=30)
    return out


@pytest.fixture(scope="module")
def four(cases):
    """{case: logits} gathered on rank 0 of a (1, 4) mesh (all four ranks
    checked equal)."""
    out = spawn(spatial_forwards, 4, list(cases.values()), device="cpu",
                axis_names=("data", "spatial"), mesh_shape=(1, 4), join_timeout=300)
    for r in out[1:]:
        for a, b in zip(out[0], r):
            np.testing.assert_array_equal(a, b)
    return dict(zip(cases, out[0]))


def one_process(case):
    model = spatial_model(case)
    with torch.no_grad():
        return model(torch.from_numpy(case["images"]).permute(0, 3, 1, 2)).float().numpy()


def jax_on_mesh(case, shape):
    """The case's logits from JAX's forward jitted over a (data, spatial)
    mesh with the image's height sharded (GSPMD's halo exchanges)."""
    model = jax_build(case["model_type"], C, output_stride=16)
    mesh = jax_make_mesh(shape[0] * shape[1], axis_names=("data", "spatial"), mesh_shape=shape)
    fwd = jax.jit(lambda x: model.apply(case["variables"], x, train=False),
                  in_shardings=(batch_arg_sharding(mesh, 4),),
                  out_shardings=replicated_sharding(mesh))
    return np.asarray(fwd(jnp.asarray(case["images"]))).transpose(0, 3, 1, 2)


@pytest.mark.parametrize("name", ["lite64", "full64", "full64_fused_head", "full64_fused",
                                  "full32_empty", "full32_empty_fused", "full12_empty_fused",
                                  *FAMILIES,
                                  "unet_standard", "unet_simple68"])
def test_four_ranks_equal_one_process(four, cases, name):
    """With the inverted-residual kernel's plain version on, 2e-3: it rounds
    its expanded maps to bf16 (as the kernel does), and its f32 products on
    a block's slab sum in another order than on the whole map (the CPU
    GEMM's blocking follows the row count), so a few elements round to the
    neighbouring bf16 value."""
    tol = 2e-3 if cases[name].get("fused") is True else 1e-4
    np.testing.assert_allclose(four[name], one_process(cases[name]), rtol=tol, atol=tol)


@pytest.mark.parametrize("name", ["full64", "full32_empty", "unet_simple68"])
def test_four_ranks_equal_jax_on_a_spatial_mesh(four, cases, name):
    np.testing.assert_allclose(four[name], jax_on_mesh(cases[name], (1, 4)), rtol=1e-4,
                               atol=1e-4)


def test_a_resize_that_clamps_at_the_block_edge_fails_the_check(four, cases):
    """The classic bug, upsampling each block alone: the logits leave the
    bounds (the check above would see it)."""
    bad = four["full64_block_clamp"]
    assert not np.allclose(bad, one_process(cases["full64"]), rtol=1e-4, atol=1e-4)


def test_deeplab_on_a_spatial_mesh_gives_one_process_mask(cases, tmp_path):
    """`DeepLab(mesh=...)` on (1, 4) and (2, 2): every rank returns the whole
    mask, that of one process (the fused kernels' plain versions on)."""
    case = cases["full64"]
    path = str(tmp_path / "w.npz")
    save_npz(path, case["variables"])
    names = [f"c{i}" for i in range(C)]
    want = spatial_serving(Mesh(), case["images"], names, path)
    for shape in [(1, 4), (2, 2)]:
        got = spawn(spatial_serving, 4, case["images"], names, path, device="cpu",
                    axis_names=("data", "spatial"), mesh_shape=shape, join_timeout=300)
        for g in got:
            np.testing.assert_array_equal(g, want)


def test_deeplab_rejects_a_mesh_without_a_spatial_axis():
    """tests/test_parallel.py:280-290, in the port."""
    with pytest.raises(ValueError, match="spatial"):
        DeepLab(device="cpu", class_names=["a", "b"], model_input_shape=(64, 64),
                mesh=Mesh(0, 2))


@pytest.mark.parametrize("index,rows", [(0, 3), (2, 3), (3, 1)])
def test_a_map_is_read_at_the_latest_height_of_its_width(index, rows):
    """Maps 8 wide 9 rows high, then 10 (`unet_simple` at 68 px over 4
    ranks): a map is read at the latest height of its width."""
    part = Partition(4, index, None, {})
    part.record(8, 9)
    part.record(8, 10)
    assert part.height(torch.zeros((1, 2, rows, 8))) == 10


def test_a_map_read_at_a_wrong_height_raises():
    """Rank 3's block of a 9-row map is empty, of a 10-row one a row: read
    at the latest height, 10, the empty block raises, as does a width no
    map has. (Ranks 0-2 hold 3 rows of either; every wrong height differs
    in some rank's block, so it fails on a rank.)"""
    part = Partition(4, 3, None, {})
    part.record(8, 9)
    part.record(8, 10)
    with pytest.raises(ValueError, match="no block"):
        part.height(torch.zeros((1, 2, 0, 8)))
    with pytest.raises(ValueError, match="no map 16 wide"):
        part.height(torch.zeros((1, 2, 1, 16)))


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8, 12])
def test_mesh_shape_is_jaxs(n):
    assert auto_shape(n, 2) == _auto_shape(n, 2) and auto_shape(n, 1) == (n,)


def test_shard_batch_splits_height_over_the_spatial_axis():
    """JAX `batch_arg_sharding`: arrays of rank >= 3 split (data, spatial),
    lower ranks by data only; blocks as GSPMD lays them (the last short or
    empty)."""
    x = np.arange(4 * 5 * 2).reshape(4, 5, 2)
    mesh = Mesh(rank=3, size=4, axis_names=("data", "spatial"), spatial=2)
    np.testing.assert_array_equal(local_rows(x, mesh), x[2:4, 3:5])
    np.testing.assert_array_equal(local_rows(x[:, 0], mesh), x[2:4, 0])
    assert [block(5, 4, s) for s in range(4)] == [(0, 2), (2, 4), (4, 5), (5, 5)]


@pytest.mark.parametrize("hs,he,lo,hi", [(16, 4, 4, 12), (17, 5, 6, 11), (15, 8, 0, 9),
                                         (16, 4, 13, 16)])
def test_decoder_row_block_equals_the_whole_map(hs, he, lo, hi):
    """`fused_decoder_frontend` on a block of skip rows [lo - 1, hi + 1)
    with its global rows and sizes passed in, cropped, equals the whole
    map's rows [lo, hi): at scale 4 and at odd, non-integer scales (the
    plain version here; tests/test_torch_kernels_cuda.py holds the kernel
    to it)."""
    rng = np.random.RandomState(hs + he)
    x = torch.from_numpy(rng.standard_normal((2, he, 7, 8)).astype(np.float32))
    skip = torch.from_numpy(rng.standard_normal((2, hs, 25, 4)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((3, 3, 12)).astype(np.float32))
    s, b = torch.ones(12) * 0.7, torch.full((12,), 0.1)
    whole = fused_decoder_frontend(x, skip, k, s, b)
    s0, s1 = max(lo - 1, 0), min(hi + 1, hs)
    e0, e1 = source_rows(s0, s1, he, hs)  # the encoder rows the skip rows sample
    got = fused_decoder_frontend(x[:, e0:e1], skip[:, s0:s1].contiguous(), k, s, b,
                                 s0, hs, e0, he)[:, lo - s0:hi - s0]
    np.testing.assert_allclose(got.numpy(), whole[:, lo:hi].numpy(), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="miss rows"):
        fused_decoder_frontend(x[:, he - 1:], skip[:, s0:s1].contiguous(), k, s, b, s0, hs,
                               he - 1, he)
