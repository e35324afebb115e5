"""The port's dataset modules (`data/voc.py`, `data/semi_split.py`,
`data/pseudo_coco.py`) and their CLIs against the JAX package's.

The JSON each writes equals the JAX module's output, on a generated VOC
XML tree (difficult objects, an unknown class, an ids file) and a
synthetic COCO JSON; the two CLIs run tiny with `python -m`; none of the
new modules imports JAX.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from semi_detr_tpu.data import pseudo_coco as jax_pseudo
from semi_detr_tpu.data import semi_split as jax_split
from semi_detr_tpu.data import voc as jax_voc
from semi_detr_tpu_torch.data import pseudo_coco, semi_split, voc
from semi_detr_tpu_torch.data.synthetic import write_synthetic_coco

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOC_NAMES = ("dog", "person", "car", "chair", "unicorn")


def _voc_tree(root, n=6, seed=0):
    """n VOC annotation files: 1-3 objects each, some difficult, one of a
    class VOC does not have; returns (Annotations dir, ids file)."""
    rs = np.random.RandomState(seed)
    ann_dir = os.path.join(root, "Annotations")
    os.makedirs(ann_dir)
    stems = [f"{2007_000000 + 17 * i:06d}" for i in range(n)]
    k = 0
    for stem in stems:
        objs = []
        for _ in range(rs.randint(1, 4)):
            x0, y0 = rs.randint(1, 200, 2)
            x1, y1 = x0 + rs.randint(5, 150), y0 + rs.randint(5, 150)
            # no difficult tag, difficult 0 and difficult 1 in turn
            diff = ("", "<difficult>0</difficult>",
                    "<difficult>1</difficult>")[k % 3]
            k += 1
            objs.append(
                f"<object><name>{VOC_NAMES[rs.randint(len(VOC_NAMES))]}"
                f"</name>{diff}<bndbox><xmin>{x0}</xmin><ymin>{y0}</ymin>"
                f"<xmax>{x1}</xmax><ymax>{y1}</ymax></bndbox></object>")
        with open(os.path.join(ann_dir, f"{stem}.xml"), "w") as f:
            f.write(f"<annotation><filename>{stem}.jpg</filename><size>"
                    f"<width>{rs.randint(300, 500)}</width><height>"
                    f"{rs.randint(200, 400)}</height><depth>3</depth></size>"
                    + "".join(objs) + "</annotation>")
    ids = os.path.join(root, "trainval.txt")
    with open(ids, "w") as f:
        f.write("\n".join(stems[::2]) + "\n")
    return ann_dir, ids


@pytest.fixture(scope="module")
def voc_tree(tmp_path_factory):
    return _voc_tree(str(tmp_path_factory.mktemp("voc")))


@pytest.fixture(scope="module")
def coco_json(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("coco"))
    path, _ = write_synthetic_coco(root, n=40, hw=(40, 56), seed=5,
                                   n_classes=3, max_boxes=3)
    return path


def test_voc_to_coco_equals_jax(voc_tree, tmp_path):
    ann_dir, ids_file = voc_tree
    for f in sorted(os.listdir(ann_dir)):
        assert voc.parse_voc_xml(os.path.join(ann_dir, f)) == \
            jax_voc.parse_voc_xml(os.path.join(ann_dir, f))
    got, ref = voc.voc_to_coco(ann_dir), jax_voc.voc_to_coco(ann_dir)
    assert got == ref and len(got["images"]) == 6
    assert any(a["ignore"] for a in got["annotations"])
    for ids in (None, ids_file):
        a = voc.convert_and_save(ann_dir, str(tmp_path / "port.json"), ids)
        b = jax_voc.convert_and_save(ann_dir, str(tmp_path / "jax.json"),
                                     ids)
        with open(a) as fa, open(b) as fb:
            assert json.load(fa) == json.load(fb)


def test_semi_splits_equal_jax(coco_json, tmp_path):
    with open(coco_json) as f:
        coco = json.load(f)
    for percent, seed in ((10, 1), (25, 3), (50.0, 5)):
        assert semi_split.split_coco(coco, percent, seed) == \
            jax_split.split_coco(coco, percent, seed)
    kw = dict(percents=(10, 30), folds=(1, 2))
    semi_split.generate_splits(coco_json, str(tmp_path / "port"), **kw)
    jax_split.generate_splits(coco_json, str(tmp_path / "jax"), **kw)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names and len(names) == 8
    for name in names:
        with open(tmp_path / "port" / name) as a, \
                open(tmp_path / "jax" / name) as b:
            assert json.load(a) == json.load(b), name
    a = semi_split.unlabeled_from_image_info(coco_json,
                                             str(tmp_path / "u_port.json"))
    b = jax_split.unlabeled_from_image_info(coco_json,
                                            str(tmp_path / "u_jax.json"))
    with open(a) as fa, open(b) as fb:
        assert json.load(fa) == json.load(fb)


def test_pseudo_coco_equals_jax(coco_json):
    rs = np.random.RandomState(2)
    with open(coco_json) as f:
        ids = [im["id"] for im in json.load(f)["images"]]
    dets = [{"image_id": int(rs.choice(ids)),
             "bbox": [float(v) for v in rs.uniform(0, 20, 2)]
             + [float(v) for v in rs.uniform(2, 15, 2)],
             "score": float(rs.rand()), "category_id": int(rs.randint(1, 4))}
            for _ in range(60)]
    for thr in (0.5, 0.9):
        assert pseudo_coco.build_pseudo_coco(coco_json, dets, thr) == \
            jax_pseudo.build_pseudo_coco(coco_json, dets, thr)
    names = ("person", "class1", "class2")
    got = pseudo_coco.PseudoCocoDataset(coco_json, dets, 0.5, classes=names)
    ref = jax_pseudo.PseudoCocoDataset(coco_json, dets, 0.5, classes=names)
    assert len(got) == len(ref) > 0
    for a, b in zip(got.records, ref.records):
        assert (a.id, a.file_name) == (b.id, b.file_name)
        np.testing.assert_array_equal(a.boxes, b.boxes)
        np.testing.assert_array_equal(a.labels, b.labels)


def _run(module, *args):
    res = subprocess.run([sys.executable, "-m", module, *args], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    return res.stdout


def test_clis_with_python_m(voc_tree, coco_json, tmp_path):
    ann_dir, ids_file = voc_tree
    out = str(tmp_path / "voc.json")
    assert "wrote" in _run("semi_detr_tpu_torch.tools.voc_to_coco",
                           "--ann-dir", ann_dir, "--ids-file", ids_file,
                           "--out", out)
    with open(out) as f, open(ids_file) as ids:
        assert json.load(f) == jax_voc.voc_to_coco(ann_dir, ids.read().split())
    split_dir = str(tmp_path / "splits")
    _run("semi_detr_tpu_torch.tools.semi_coco", "--ann", coco_json, "--out",
         split_dir, "--percents", "10", "--folds", "1", "2")
    jax_split.generate_splits(coco_json, str(tmp_path / "ref"), [10.0],
                              [1, 2])
    names = sorted(os.listdir(tmp_path / "ref"))
    assert sorted(os.listdir(split_dir)) == names and len(names) == 4
    for name in names:
        with open(os.path.join(split_dir, name)) as a, \
                open(tmp_path / "ref" / name) as b:
            assert json.load(a) == json.load(b)


def test_new_modules_import_no_jax():
    code = ("import sys, semi_detr_tpu_torch.native, "
            "semi_detr_tpu_torch.data.voc, "
            "semi_detr_tpu_torch.data.semi_split, "
            "semi_detr_tpu_torch.data.pseudo_coco, "
            "semi_detr_tpu_torch.tools.voc_to_coco, "
            "semi_detr_tpu_torch.tools.semi_coco, "
            "semi_detr_tpu_torch.tools.image_demo, "
            "semi_detr_tpu_torch.tools.av1_table\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'semi_detr_tpu', 'cv2', "
            "'PIL')]\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
