"""The port's dataset tools (deeplabv3p_torch/tools/dataset_converter/)
against the root tools they copy (tools/dataset_converter/), on tiny
fixtures (2-8 images, 6-64 px; the toy set of data/toy.py at its own
size): each root tool runs in this process through `runpy` with its
`sys.argv`, each port through `main(argv)`, into directories of their own,
and every file the two write is byte-equal (PNG, JPEG, `.npy`, JSON, list
files), their printed lines too (the output directory's name aside). Then
the shards of `pack_dataset` train the port for one step, `mscoco2017`'s
gate and its run on a `pycocotools` stand-in built on `MiniCOCO`, the RLE
codec's cases of tests/test_instance_segment.py on both copies of
`coco_mask`, and one subprocess that imports every module of
deeplabv3p_torch/tools/dataset_converter and the three evaluation tools
and runs each tool's `--help` with `jax`,
`deeplabv3p_tpu` and the root `tools` package raising when imported."""

import contextlib
import importlib
import io
import json
import os
import runpy
import subprocess
import sys
import types

import numpy as np
import pytest
import scipy.io
from PIL import Image

from deeplabv3p_torch.data import toy as ttoy
from deeplabv3p_torch.data.shards import is_packed_dataset
from deeplabv3p_torch.tools.dataset_converter.instance_segment import coco_mask as port_mask
from deeplabv3p_torch.tools.dataset_converter.label_utils import label_load, label_save
from test_torch_model import one_torch_thread  # noqa: F401 (a fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from tools.dataset_converter import label_utils as root_label_utils  # noqa: E402
from tools.dataset_converter.instance_segment import coco_mask as root_mask  # noqa: E402

CONVERTER = "deeplabv3p_torch.tools.dataset_converter."


def run_root(script: str, argv) -> str:
    """The root tool `script` (a path under tools/) run as `__main__` with
    `argv`; what it printed."""
    buf, saved = io.StringIO(), (sys.argv, list(sys.path))
    sys.argv = [script, *map(str, argv)]
    try:
        with contextlib.redirect_stdout(buf):
            runpy.run_path(os.path.join(REPO, "tools", script), run_name="__main__")
    finally:
        sys.argv, sys.path[:] = saved[0], saved[1]
    return buf.getvalue()


def run_port(module: str, argv) -> str:
    """The port's tool `module` through `main(argv)`; what it printed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        importlib.import_module(module).main([str(a) for a in argv])
    return buf.getvalue()


def tree(root: str) -> dict:
    """{relative path: bytes} of every file under root."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def save_png(path, array, mode=None):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(np.asarray(array, np.uint8), mode=mode).save(path)


def save_jpg(path, rng, hw):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(rng.randint(0, 256, (*hw, 3)).astype(np.uint8)).save(path)


def coco_json(path):
    """tests/test_instance_segment.py's `tiny_coco`: a polygon and an RLE
    instance on image 1, a polygon on image 2, 1-based ids."""
    m2 = np.zeros((8, 10), np.uint8)
    m2[5:8, 6:9] = 1
    data = {
        "images": [{"id": 1, "file_name": "img_a.jpg", "height": 8, "width": 10},
                   {"id": 2, "file_name": "img_b.jpg", "height": 6, "width": 6}],
        "categories": [{"supercategory": "none", "id": 1, "name": "person"},
                       {"supercategory": "none", "id": 2, "name": "dog"}],
        "annotations": [
            {"id": 1, "image_id": 1, "category_id": 1, "iscrowd": 0,
             "segmentation": [[1, 1, 4, 1, 4, 4, 1, 4]], "area": 16.0, "bbox": [1, 1, 3, 3]},
            {"id": 2, "image_id": 1, "category_id": 2, "iscrowd": 0,
             "segmentation": root_mask.encode(m2), "area": float(m2.sum()),
             "bbox": [6, 5, 2, 2]},
            {"id": 3, "image_id": 2, "category_id": 1, "iscrowd": 0,
             "segmentation": [[0, 0, 3, 0, 3, 3, 0, 3]], "area": 16.0, "bbox": [0, 0, 3, 3]}],
    }
    with open(path, "w") as f:
        json.dump(data, f)


def sbd_mat(path, segmentation, categories=None):
    """An SBD `.mat`: a 'GTcls' struct (semantic) or, with `categories`, a
    'GTinst' struct."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    seg = np.asarray(segmentation, np.uint8)
    if categories is None:
        scipy.io.savemat(path, {"GTcls": {"Segmentation": seg}})
    else:
        scipy.io.savemat(path, {"GTinst": {"Segmentation": seg,
                                           "Categories": np.asarray(categories, np.uint8)}})


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Every tool's input, tiny."""
    root = tmp_path_factory.mktemp("inputs")
    rng = np.random.RandomState(0)
    d = {}
    # the toy set (8 pairs from example/) for pack, statistics and visualize
    d["toy"] = str(root / "toy")
    d["toy_list"] = ttoy.build_overfit_dataset(d["toy"], source_dir=os.path.join(REPO, "example"))
    d["toy_classes"] = os.path.join(d["toy"], "classes.txt")
    # labelme: two JSON files, every shape type, an unknown label
    lm = root / "labelme"
    lm.mkdir()
    shapes = [[{"label": "car", "shape_type": "rectangle", "points": [[2, 2], [8, 6]]},
               {"label": "person", "shape_type": "polygon",
                "points": [[10, 1], [14, 1], [14, 5], [10, 5]]}],
              [{"label": "person", "shape_type": "circle", "points": [[8, 8], [11, 8]]},
               {"label": "car", "shape_type": "line", "points": [[0, 0], [15, 3]]},
               {"label": "car", "shape_type": "point", "points": [[3, 12]]},
               {"label": "tree", "shape_type": "linestrip", "points": [[1, 1], [5, 9], [9, 2]]},
               {"label": "person", "shape_type": "linestrip",
                "points": [[2, 14], [7, 10], [12, 14]]}]]
    for i, s in enumerate(shapes):
        (lm / f"s{i}.json").write_text(json.dumps(
            {"imageHeight": 16, "imageWidth": 18, "shapes": s}))
    d["labelme"] = str(lm)
    d["labelme_classes"] = str(root / "labelme_classes.txt")
    (root / "labelme_classes.txt").write_text("background\ncar\nperson\n")
    # SBD: semantic and instance .mat files, images, the split lists
    sbd = root / "sbd"
    cls = [rng.randint(0, 21, (12, 10)), np.zeros((9, 7), np.uint8)]
    inst = [np.array([[0, 1, 1, 0], [2, 2, 1, 0], [0, 2, 0, 0]]), np.pad(np.ones((3, 2)), 2)]
    cats = [[[15], [12]], 7]  # two instances (a column, as MATLAB writes it), then one
    for i in range(2):
        sbd_mat(str(sbd / "cls" / f"2008_00000{i}.mat"), cls[i])
        sbd_mat(str(sbd / "inst" / f"2008_00000{i}.mat"), inst[i], cats[i])
        save_jpg(str(sbd / "img" / f"2008_00000{i}.jpg"), rng, inst[i].shape)
    (sbd / "train.txt").write_text("2008_000000\n2008_000001\n")
    (sbd / "val.txt").write_text("2008_000001\n")
    (sbd / "voc_train.txt").write_text("2007_000039\n2008_000001\n")
    d["sbd"] = str(sbd)
    # CamVid: colour labels (the dictionary's colours and one that is not in it)
    cam = root / "camvid"
    colors = np.array([[128, 64, 128], [128, 128, 128], [64, 0, 128], [64, 128, 64],
                       [0, 0, 0], [1, 2, 3]], np.uint8)
    for i in range(2):
        save_png(str(cam / f"0001TP_00{i}.png"), colors[rng.randint(0, 6, (6, 8))])
    (root / "camvid_classes.txt").write_text("void\nroad\nsky\ncar\n")
    d["camvid"], d["camvid_classes"] = str(cam), str(root / "camvid_classes.txt")
    # Cityscapes: leftImg8bit + gtFine, one image in train and one in val
    city = root / "cityscapes"
    for split, frame in (("train", "000019"), ("val", "000042")):
        stem = f"aachen_000000_{frame}"
        save_jpg(str(city / "leftImg8bit" / split / "aachen" / f"{stem}_leftImg8bit.png"),
                 rng, (8, 16))
        save_png(str(city / "gtFine" / split / "aachen" / f"{stem}_gtFine_labelIds.png"),
                 rng.randint(0, 34, (8, 16)))
    d["cityscapes"] = str(city)
    # ADE20K and CIHP / ATR: gray index labels beside jpgs
    ade = root / "ade20k"
    for split in ("training", "validation"):
        for i in range(2):
            save_jpg(str(ade / "images" / split / f"ADE_{split}_{i}.jpg"), rng, (6, 9))
            save_png(str(ade / "annotations" / split / f"ADE_{split}_{i}.png"),
                     rng.randint(0, 151, (6, 9)))
    d["ade20k"] = str(ade)
    cihp, atr = root / "cihp", root / "atr"
    for split in ("Training", "Validation"):
        for i in range(2):
            save_jpg(str(cihp / split / "Images" / f"{split}{i}.jpg"), rng, (7, 5))
            save_png(str(cihp / split / "Category_ids" / f"{split}{i}.png"),
                     rng.randint(0, 20, (7, 5)))
    for i in range(2):
        save_jpg(str(atr / "JPEGImages" / f"atr{i}.jpg"), rng, (7, 5))
        save_png(str(atr / "SegmentationClassAug" / f"atr{i}.png"), rng.randint(0, 18, (7, 5)))
    d["cihp"], d["atr"] = str(cihp), str(atr)
    # COCO: the instances json, its images, the class lists; a converted
    # instance set (images, instance PNGs, the bbox list) to visualize
    coco = root / "coco"
    coco.mkdir()
    coco_json(str(coco / "instances_tiny.json"))
    save_jpg(str(coco / "images" / "img_a.jpg"), rng, (8, 10))
    save_jpg(str(coco / "images" / "img_b.jpg"), rng, (6, 6))
    (coco / "classes.txt").write_text("person\ndog\n")
    (coco / "semantic_classes.txt").write_text("background\nperson\ndog\n")
    d["coco"] = str(coco)
    inst_set = root / "instance_set"
    save_jpg(str(inst_set / "images" / "img_a.jpg"), rng, (8, 10))
    label_a = np.zeros((8, 10), np.uint8)
    label_a[1:4, 1:4], label_a[5:8, 6:9] = 1, 2
    save_png(str(inst_set / "labels" / "img_a.png"), label_a)
    (inst_set / "set.txt").write_text("img_a 1,1,4,4,0 6,5,8,7,1\n")
    d["instance_set"] = str(inst_set)
    return d


def _cases():
    """(id, root script under tools/, port module, argv of (inputs, output dir))."""
    return [
        ("label_statistics", "dataset_converter/label_statistics.py", "label_statistics",
         lambda d, o: ["--label_path", os.path.join(d["toy"], "labels"), "--dataset_file",
                       d["toy_list"], "--classes_path", d["toy_classes"]]),
        ("label_statistics_glob", "dataset_converter/label_statistics.py", "label_statistics",
         lambda d, o: ["--label_path", os.path.join(d["toy"], "labels"), "--classes_path",
                       d["toy_classes"]]),
        ("dataset_visualize", "dataset_converter/dataset_visualize.py", "dataset_visualize",
         lambda d, o: ["--dataset_path", d["toy"], "--dataset_file", d["toy_list"],
                       "--classes_path", d["toy_classes"], "--dump", o]),
        ("labelme_convert", "dataset_converter/labelme_convert.py", "labelme_convert",
         lambda d, o: ["--json_file_path", d["labelme"], "--png_label_path", o,
                       "--classes_path", d["labelme_classes"]]),
        ("labelme_convert_polygon_only", "dataset_converter/labelme_convert.py",
         "labelme_convert",
         lambda d, o: ["--json_file_path", d["labelme"], "--png_label_path", o,
                       "--classes_path", d["labelme_classes"], "--polygon_only"]),
        ("voc_augment_semantic", "dataset_converter/voc_augment.py", "voc_augment",
         lambda d, o: ["convert", "--mat_label_path", os.path.join(d["sbd"], "cls"),
                       "--png_label_path", o]),
        ("voc_augment_instance", "dataset_converter/voc_augment.py", "voc_augment",
         lambda d, o: ["convert", "--mat_label_path", os.path.join(d["sbd"], "inst"),
                       "--png_label_path", o, "--label_type", "instance"]),
        ("voc_augment_merge", "dataset_converter/voc_augment.py", "voc_augment",
         lambda d, o: ["merge", "--voc_set_file", os.path.join(d["sbd"], "voc_train.txt"),
                       "--sbd_set_file", os.path.join(d["sbd"], "train.txt"),
                       "--output_file", os.path.join(o, "train.txt")]),
        ("camvid", "dataset_converter/camvid.py", "camvid",
         lambda d, o: ["--label_path", d["camvid"], "--output_path", o]),
        ("camvid_subset", "dataset_converter/camvid.py", "camvid",
         lambda d, o: ["--label_path", d["camvid"], "--classes_path", d["camvid_classes"],
                       "--output_path", o]),
        ("cityscapes_convert", "dataset_converter/cityscapes.py", "cityscapes",
         lambda d, o: ["convert", "--input_path", os.path.join(d["cityscapes"], "gtFine"),
                       "--output_path", o]),
        ("cityscapes_prepare", "dataset_converter/cityscapes.py", "cityscapes",
         lambda d, o: ["prepare", "--cityscapes_root", d["cityscapes"], "--output_path", o]),
        ("ade20k_convert_shift", "dataset_converter/ade20k.py", "ade20k",
         lambda d, o: ["convert", "--input_path",
                       os.path.join(d["ade20k"], "annotations", "training"),
                       "--output_path", o, "--shift"]),
        ("ade20k_prepare", "dataset_converter/ade20k.py", "ade20k",
         lambda d, o: ["prepare", "--ade20k_root", d["ade20k"], "--output_path", o]),
        ("cihp", "dataset_converter/cihp_atr.py", "cihp_atr",
         lambda d, o: ["--cihp_root", d["cihp"], "--output_path", o]),
        ("atr", "dataset_converter/cihp_atr.py", "cihp_atr",
         lambda d, o: ["--atr_root", d["atr"], "--output_path", o]),
        ("coco_annotation", "dataset_converter/instance_segment/coco_annotation.py",
         "instance_segment.coco_annotation",
         lambda d, o: ["--json_path", os.path.join(d["coco"], "instances_tiny.json"),
                       "--output_path", o, "--classes_path",
                       os.path.join(d["coco"], "classes.txt"), "--customize_coco"]),
        ("coco_annotation_all_classes", "dataset_converter/instance_segment/coco_annotation.py",
         "instance_segment.coco_annotation",
         lambda d, o: ["--json_path", os.path.join(d["coco"], "instances_tiny.json"),
                       "--output_path", o, "--customize_coco"]),
        ("coco_visualize", "dataset_converter/instance_segment/coco_visualize.py",
         "instance_segment.coco_visualize",
         lambda d, o: ["--image_path", os.path.join(d["coco"], "images"), "--json_path",
                       os.path.join(d["coco"], "instances_tiny.json"), "--output_path", o,
                       "--classes_path", os.path.join(d["coco"], "classes.txt"),
                       "--customize_coco"]),
        ("instance_segment_visualize",
         "dataset_converter/instance_segment/instance_segment_visualize.py",
         "instance_segment.instance_segment_visualize",
         lambda d, o: ["--dataset_file", os.path.join(d["instance_set"], "set.txt"),
                       "--dataset_path", d["instance_set"], "--classes_path",
                       os.path.join(d["coco"], "classes.txt"), "--output_path", o]),
        ("voc_sbd_annotation", "dataset_converter/instance_segment/voc_sbd_annotation.py",
         "instance_segment.voc_sbd_annotation",
         lambda d, o: ["--dataset_path", d["sbd"], "--output_path", o]),
        ("voc_sbd_to_coco", "dataset_converter/instance_segment/voc_sbd_to_coco.py",
         "instance_segment.voc_sbd_to_coco",
         lambda d, o: ["--dataset_path", d["sbd"], "--output_path", o, "--sets", "train,val"]),
    ]


CASES = _cases()


def run_both(data, tmp_path, script, module, args, port_prefix=CONVERTER):
    """(root's files, port's files, root's print, port's print), each
    tool writing under a directory of its own (its name replaced in what it
    printed)."""
    out = {}
    for who in ("root", "port"):
        o = tmp_path / who
        o.mkdir()
        argv = args(data, str(o))
        text = (run_root(script, argv) if who == "root"
                else run_port(port_prefix + module, argv))
        out[who] = (tree(str(o)), text.replace(str(o), "<out>"))
    return out["root"][0], out["port"][0], out["root"][1], out["port"][1]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_the_port_writes_and_prints_what_the_root_tool_does(data, tmp_path, case):
    _, script, module, args = case
    want, got, want_text, got_text = run_both(data, tmp_path, script, module, args)
    if case[0].startswith("label_statistics"):  # it prints only
        assert want == {} and "total images: 8, total pixels: " in want_text
    else:
        assert want
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name
    assert got_text == want_text


def test_dataset_visualize_without_matplotlib_blends_the_colour_map(data, tmp_path,
                                                                    monkeypatch):
    """The card machine has no matplotlib: --dump writes the label's
    colours blended over each image at the tool's alpha, at its size."""
    from deeplabv3p_torch.utils.visualize import label_to_color_image

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    out = tmp_path / "dump"
    run_port(CONVERTER + "dataset_visualize", [
        "--dataset_path", data["toy"], "--dataset_file", data["toy_list"],
        "--classes_path", data["toy_classes"], "--dump", out])
    for i in open(data["toy_list"]).read().split():
        image = np.array(Image.open(os.path.join(data["toy"], "images", f"{i}.jpg")))
        label = np.array(Image.open(os.path.join(data["toy"], "labels", f"{i}.png")))
        want = (image * 0.5 + label_to_color_image(label) * 0.5).astype(np.uint8)
        Image.fromarray(want).save(tmp_path / "want.jpg")
        assert (out / f"{i}.jpg").read_bytes() == (tmp_path / "want.jpg").read_bytes()


def test_the_sbd_fixture_exercises_both_category_layouts(data, tmp_path):
    """The .mat fixtures hold a two-instance column and a scalar category
    (squeeze_me's two shapes): the instance list has both."""
    from deeplabv3p_torch.tools.dataset_converter.instance_segment.voc_sbd_to_coco import (
        voc_sbd_to_coco,
    )

    with contextlib.redirect_stdout(io.StringIO()):
        (path,) = voc_sbd_to_coco(data["sbd"], str(tmp_path), sets=("train",))
    with open(path) as f:
        anns = json.load(f)["annotations"]
    assert [a["category_id"] for a in anns] == [15, 12, 7]


def test_pack_dataset_shards_are_byte_equal_and_train_the_port(data, tmp_path):
    """The toy set packed at 64 px in shards of 3 (8 samples: 3 + 3 + 2) by
    both tools: every `.npy` byte-equal, `meta.json` equal; then the port's
    train CLI reads the port's shards (`is_packed_dataset`) for one step."""
    from deeplabv3p_torch.train import main, parse_args

    args = ["--dataset_path", data["toy"], "--dataset_file", data["toy_list"],
            "--model_input_shape", "64", "--shard_size", "3"]
    want, got = tmp_path / "root", tmp_path / "port"
    run_root("dataset_converter/pack_dataset.py", [*args, "--output", want])
    printed = run_port(CONVERTER + "pack_dataset", [*args, "--output", got])
    assert printed.startswith(f"packed 8 samples at 64x64 into {got} in ")
    want_files, got_files = tree(str(want)), tree(str(got))
    assert sorted(got_files) == sorted(want_files) == sorted(
        [f"shard_{k}_{a}.npy" for k in range(3) for a in ("images", "labels")] + ["meta.json"])
    for name, blob in want_files.items():
        assert got_files[name] == blob, name
    assert json.loads(got_files["meta.json"])["shard_sizes"] == [3, 3, 2]

    assert is_packed_dataset(str(got))
    log_dir = tmp_path / "logs"
    main(parse_args(["--model_type", "mobilenetv2_lite", "--model_input_shape", "64",
                     "--batch_size", "8", "--no_augment", "--transfer_epoch", "0",
                     "--total_epoch", "1", "--dataset_path", str(got), "--dataset_file",
                     data["toy_list"], "--classes_path", data["toy_classes"], "--device", "cpu",
                     "--log_dir", str(log_dir)]))
    (rec,) = [json.loads(line) for line in (log_dir / "history.jsonl").read_text().splitlines()]
    assert rec["steps"] == 1 and np.isfinite(rec["loss"])


@pytest.mark.parametrize("save", [root_label_utils.label_save, label_save],
                         ids=["root_saves", "port_saves"])
def test_label_save_and_load_agree_with_the_root_helpers(tmp_path, save):
    """A label saved by either copy is the root helper's file and loads
    equal through both."""
    label = np.random.RandomState(1).randint(0, 256, (9, 13)).astype(np.uint8)
    path, root = tmp_path / "l.png", tmp_path / "root.png"
    save(str(path), label)
    root_label_utils.label_save(str(root), label)
    assert path.read_bytes() == root.read_bytes() and Image.open(path).mode == "P"
    for load in (label_load, root_label_utils.label_load):
        np.testing.assert_array_equal(load(str(path)), label)
    with pytest.raises(ValueError, match="out of PNG range"):
        save(str(path), label.astype(np.int32) + 1)


def test_mscoco2017_exits_without_pycocotools(data, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "pycocotools", None)
    argv = ["--annotation_file", os.path.join(data["coco"], "instances_tiny.json"),
            "--output_label_path", str(tmp_path), "--classes_path",
            os.path.join(data["coco"], "semantic_classes.txt")]
    for run in (lambda: run_root("dataset_converter/mscoco2017.py", argv),
                lambda: run_port(CONVERTER + "mscoco2017", argv)):
        with pytest.raises(SystemExit, match="pycocotools is required"):
            run()


def test_mscoco2017_on_a_pycocotools_stand_in(data, tmp_path, monkeypatch):
    """`pycocotools.coco.COCO` stood in for by the root tools' `MiniCOCO`
    (the same query surface): the semantic PNGs and the set file equal."""
    coco = types.ModuleType("pycocotools.coco")
    coco.COCO = root_mask.MiniCOCO
    monkeypatch.setitem(sys.modules, "pycocotools", types.ModuleType("pycocotools"))
    monkeypatch.setitem(sys.modules, "pycocotools.coco", coco)

    def args(d, o):
        return ["--annotation_file", os.path.join(d["coco"], "instances_tiny.json"),
                "--output_label_path", os.path.join(o, "labels"), "--classes_path",
                os.path.join(d["coco"], "semantic_classes.txt"),
                "--output_set_file", os.path.join(o, "set.txt")]

    want, got, want_text, got_text = run_both(
        data, tmp_path, "dataset_converter/mscoco2017.py", "mscoco2017", args)
    assert sorted(want) == ["labels/img_a.png", "labels/img_b.png", "set.txt"]
    assert got == want and got_text == want_text
    label = np.array(Image.open(tmp_path / "port" / "labels" / "img_a.png"))
    assert set(np.unique(label)) == {0, 1, 2}


# -- the RLE codec of tests/test_instance_segment.py, on both copies ---------------------

MASKS = [root_mask, port_mask]
MASK_IDS = ["root", "port"]


@pytest.mark.parametrize("cm", MASKS, ids=MASK_IDS)
def test_rle_counts_fortran_order(cm):
    assert cm.mask_to_rle_counts(np.array([[1, 0], [0, 1]], np.uint8)) == [0, 1, 2, 1]


@pytest.mark.parametrize("cm", MASKS, ids=MASK_IDS)
def test_rle_mask_roundtrip_random(cm):
    rng = np.random.RandomState(0)
    for shape in [(1, 1), (7, 5), (32, 33), (64, 64)]:
        mask = (rng.rand(*shape) > 0.5).astype(np.uint8)
        rle = cm.encode(mask)
        assert rle == root_mask.encode(mask)  # the same counts string
        np.testing.assert_array_equal(cm.decode(rle), mask)


@pytest.mark.parametrize("cm", MASKS, ids=MASK_IDS)
def test_rle_string_codec_known_values(cm):
    for counts in [[0, 1, 2, 1], [5], [100, 3, 1000, 2, 7], [0, 4096, 17, 4096, 1]]:
        s = cm.rle_counts_to_string(counts)
        assert s == root_mask.rle_counts_to_string(counts)
        assert cm.rle_string_to_counts(s) == counts


@pytest.mark.parametrize("cm", MASKS, ids=MASK_IDS)
def test_uncompressed_rle_decode_polygon_and_bbox(cm):
    np.testing.assert_array_equal(cm.decode({"size": [2, 2], "counts": [0, 1, 2, 1]}),
                                  np.array([[1, 0], [0, 1]], np.uint8))
    mask = cm.polygons_to_mask([[1, 1, 4, 1, 4, 4, 1, 4]], 6, 6)
    assert mask[2, 2] == 1 and mask[1, 1] == 1 and mask[4, 4] == 1
    assert mask[0, 0] == 0 and mask[5, 5] == 0
    box = np.zeros((10, 12), np.uint8)
    box[2:5, 3:9] = 1
    assert cm.mask_to_bbox(box) == (3, 2, 8, 4)


# -- no JAX, no JAX package, no root tools -------------------------------------------------

def test_every_port_tool_runs_its_help_without_jax_or_the_root_tools(tmp_path):
    """One subprocess with a `jax`, a `deeplabv3p_tpu` and a `tools` package
    that raise when imported first on its path: every module of
    deeplabv3p_torch/tools/dataset_converter, the three evaluation tools and
    the five diagnostics tools import, and each with a `main` prints its
    `--help`."""
    guard = tmp_path / "guard"
    for name in ("jax", "deeplabv3p_tpu", "tools"):
        (guard / name).mkdir(parents=True)
        (guard / name / "__init__.py").write_text(f"raise RuntimeError('imported {name}')\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(guard), REPO]))
    named = (*chip_smoke.EVAL_TOOLS, *chip_smoke.DIAGNOSTICS_TOOLS)
    r = subprocess.run([sys.executable, "-c", chip_smoke.TOOLS_HELP, *named],
                       env=env, cwd=str(tmp_path), capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    counts, ran = r.stdout.splitlines()
    tools = {f"{CONVERTER}{c[2]}" for c in CASES} | {
        CONVERTER + "pack_dataset", CONVERTER + "mscoco2017",
        *(f"deeplabv3p_torch.tools.{t}" for t in named)}
    assert set(ran.split()) == tools and len(named) == 8
    # and four modules without a main: label_utils, coco_mask, _viz, instance_segment
    assert counts == f"{len(tools) + 4} modules, {len(tools)} tools"


def test_every_root_dataset_tool_has_its_port_but_voc_visualize():
    """`instance_segment/voc_visualize.py` imports no package and runs
    where JAX is not installed, so it has no copy."""
    def files(root):
        return {os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root)
                for f in fs if f.endswith(".py")}

    root = files(os.path.join(REPO, "tools", "dataset_converter"))
    port = files(os.path.join(REPO, "deeplabv3p_torch", "tools", "dataset_converter"))
    assert root - port == {os.path.join("instance_segment", "voc_visualize.py")}
    assert port - root == {"__init__.py"}
