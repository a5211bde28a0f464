"""The port's data layer against the JAX package's (mine_tpu/data).

COLMAP: the same model written by both packages' binary writers is the same
bytes, and both packages read it (binary and text) to equal arrays.

Loaders: for each of the 8 registered families, the JAX package's fixture
writer lays down its 64x64 fixture; both packages build the train and val
datasets from the same shipped yaml plus `conformance_overrides` (128x128,
B=2), and every batch of train epochs 0 and 1 and of the val epoch is
`np.array_equal` key by key, `eval_weight` included (tolerance 0: the
loaders are numpy and Pillow on both sides); `len()` and
`num_eval_examples` agree; `host_slice=(1, 1)` and the two-host split
(0, 1) + (1, 1) give exactly the rows of the global build.

The loud failures of tests/test_data.py and tests/test_conformance.py raise
(or warn) with the same exception type and message in both packages. An
unregistered name raises UnknownDatasetError listing every name.
"""

import os
import types

import numpy as np
import pytest
from PIL import Image

import mine_tpu.data.colmap as j_colmap
import mine_tpu.data.dtu as j_dtu
import mine_tpu.data.kitti as j_kitti
import mine_tpu.data.llff as j_llff
import mine_tpu.data.realestate as j_realestate
import mine_tpu.data.registry as j_registry
import mine_tpu.data.synthetic as j_synthetic
import mine_tpu_torch.data.colmap as t_colmap
import mine_tpu_torch.data.dtu as t_dtu
import mine_tpu_torch.data.kitti as t_kitti
import mine_tpu_torch.data.llff as t_llff
import mine_tpu_torch.data.realestate as t_realestate
import mine_tpu_torch.data.registry as t_registry
import mine_tpu_torch.data.synthetic as t_synthetic
from mine_tpu.config import Config as JConfig
from mine_tpu.data.conformance.fixtures import write_fixture
from mine_tpu.data.conformance.runner import _load_cfg as j_load_cfg
from mine_tpu.data.conformance.runner import conformance_overrides
from mine_tpu_torch.config import Config as TConfig
from mine_tpu_torch.data.conformance.runner import _load_cfg as t_load_cfg
from torch_threads import one_torch_thread  # noqa: F401

PKGS = {
    "jax": types.SimpleNamespace(
        colmap=j_colmap, llff=j_llff, realestate=j_realestate, kitti=j_kitti, dtu=j_dtu,
        registry=j_registry, write_colmap_scene=j_synthetic.write_colmap_scene,
        Config=JConfig),
    "torch": types.SimpleNamespace(
        colmap=t_colmap, llff=t_llff, realestate=t_realestate, kitti=t_kitti, dtu=t_dtu,
        registry=t_registry, write_colmap_scene=t_synthetic.write_colmap_scene,
        Config=TConfig),
}
# registered family -> the shipped yaml that names it
FAMILY_CONFIGS = {
    "llff": "llff", "nocs_llff": "nocs_llff", "objectron": "objectron",
    "realestate10k": "realestate", "kitti_raw": "kitti_raw", "dtu": "dtu",
    "flowers": "flowers", "synthetic": "synthetic",
}


# -- COLMAP ------------------------------------------------------------------


def _model(pkg):
    c = pkg.colmap
    cams = {3: c.Camera(3, "SIMPLE_RADIAL", 640, 480, np.array([500.0, 320.0, 240.0, 0.01])),
            5: c.Camera(5, "PINHOLE", 64, 48, np.array([50.0, 51.0, 32.0, 24.0]))}
    imgs = {7: c.ImageMeta(7, np.array([0.9, 0.1, -0.2, 0.3]), np.array([1.0, -2.0, 3.0]), 3,
                           "img_007.png", np.array([[1.5, 2.5], [3.0, 4.0]]),
                           np.array([11, -1], dtype=np.int64)),
            8: c.ImageMeta(8, np.array([1.0, 0.0, 0.0, 0.0]), np.zeros(3), 5, "b.jpg",
                           np.zeros((0, 2)), np.zeros(0, np.int64))}
    pts = {11: c.Point3D(11, np.array([0.1, 0.2, 0.3]), np.array([1, 2, 3], np.uint8), 0.7),
           12: c.Point3D(12, np.array([-4.0, 5.5, 1e-3]), np.array([9, 8, 7], np.uint8), 0.25)}
    return cams, imgs, pts


def _assert_models_equal(a, b):
    for ta, tb in zip(a, b):
        assert sorted(ta) == sorted(tb)
        for key in ta:
            for field in vars(ta[key]):
                va, vb = getattr(ta[key], field), getattr(tb[key], field)
                if isinstance(va, np.ndarray):
                    assert va.dtype == vb.dtype and np.array_equal(va, vb), field
                else:
                    assert va == vb, field


def test_colmap_writers_byte_equal_and_readers_agree(tmp_path):
    for name, pkg in PKGS.items():
        cams, imgs, pts = _model(pkg)
        d = tmp_path / name
        d.mkdir()
        pkg.colmap.write_cameras_binary(cams, str(d / "cameras.bin"))
        pkg.colmap.write_images_binary(imgs, str(d / "images.bin"))
        pkg.colmap.write_points3d_binary(pts, str(d / "points3D.bin"))
    for f in ("cameras.bin", "images.bin", "points3D.bin"):
        assert (tmp_path / "jax" / f).read_bytes() == (tmp_path / "torch" / f).read_bytes(), f
    # each package reads the other's files to the same arrays
    _assert_models_equal(j_colmap.read_model(str(tmp_path / "torch")),
                         t_colmap.read_model(str(tmp_path / "jax")))
    # the text format, one camera / image / point a line
    txt = tmp_path / "txt"
    txt.mkdir()
    (txt / "cameras.txt").write_text("# comment\n1 SIMPLE_PINHOLE 64 48 50.5 32 24\n")
    (txt / "images.txt").write_text(
        "# id qw qx qy qz tx ty tz cam name\n"
        "2 1 0 0 0 0.5 -0.25 2 1 a.png\n10.5 20.25 7 3.0 4.0 -1\n")
    (txt / "points3D.txt").write_text("7 0.1 0.2 3.5 255 0 9 0.125 2 0\n")
    _assert_models_equal(j_colmap.read_model(str(txt), ".txt"),
                         t_colmap.read_model(str(txt), ".txt"))
    q = np.array([0.9, 0.1, -0.2, 0.3]) / np.linalg.norm([0.9, 0.1, -0.2, 0.3])
    assert np.array_equal(j_colmap.qvec2rotmat(q), t_colmap.qvec2rotmat(q))
    r = t_colmap.qvec2rotmat(q)
    assert np.array_equal(j_colmap.rotmat2qvec(r), t_colmap.rotmat2qvec(r))
    with pytest.raises(ValueError, match="extension"):
        t_colmap.read_model(str(txt), ".bad")


# -- every family, batch for batch -------------------------------------------


def _assert_batches_equal(want: dict, got: dict, rows=slice(None)) -> None:
    assert sorted(want) == sorted(got)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert np.array_equal(want[key][rows], got[key]), key


@pytest.mark.parametrize("family", sorted(FAMILY_CONFIGS))
def test_family_batches_bit_equal_to_jax(family, tmp_path):
    path = write_fixture(family, str(tmp_path))
    overrides = conformance_overrides(path)
    config = FAMILY_CONFIGS[family]
    jcfg, tcfg = j_load_cfg(config, overrides), t_load_cfg(config, overrides)
    b = 2
    for split, epochs in (("train", (0, 1)), ("val", (0,))):
        want_ds = j_registry.build_dataset(jcfg, split, b)
        got_ds = t_registry.build_dataset(tcfg, split, b)
        halves = [t_registry.build_dataset(tcfg, split, b, host_slice=(i, 1)) for i in range(b)]
        assert len(got_ds) == len(want_ds) == len(halves[0]) > 0
        if hasattr(want_ds, "num_eval_examples"):
            assert got_ds.num_eval_examples == want_ds.num_eval_examples
        else:  # the JAX synthetic scene has no audit count; the port's is exact
            assert got_ds.num_eval_examples == len(want_ds) * b
        for epoch in epochs:
            want = list(want_ds.epoch(epoch))
            got = list(got_ds.epoch(epoch))
            assert len(got) == len(want) == len(want_ds)
            for w, g in zip(want, got):
                _assert_batches_equal(w, g)
            # host_slice (1, 1) alone, and with (0, 1) the two-host split
            for i, half in enumerate(halves):
                for w, g in zip(want, half.epoch(epoch), strict=True):
                    _assert_batches_equal(w, g, slice(i, i + 1))
        if split == "val" and family != "synthetic":
            weights = np.concatenate([g["eval_weight"] for g in got])
            assert weights.sum() == got_ds.num_eval_examples


def test_llff_ratio_folder_and_tgt_views_bit_equal(tmp_path):
    """The `images_<ratio>` folder naming at a pre-downsample ratio, and two
    target views per source, through both packages."""
    for pkg in PKGS.values():
        pkg.write_colmap_scene(str(tmp_path / "a"), "scene_a", n_views=6, hw=(40, 56),
                               n_val_views=3)
    scene = tmp_path / "a" / "scene_a"
    os.rename(scene / "images", scene / "images_2.0")
    os.rename(scene / "images_val", scene / "images_2.0_val")
    over = {"data.name": "llff", "data.img_h": 128, "data.img_w": 128,
            "data.img_pre_downsample_ratio": 2.0, "data.num_tgt_views": 2,
            "data.training_set_path": str(tmp_path / "a"), "data.visible_point_count": 24}
    for split in ("train", "val"):
        want = list(j_llff.LLFFDataset(JConfig().replace(**over), split, 4).epoch(3))
        got_ds = t_llff.LLFFDataset(TConfig().replace(**over), split, 4)
        assert got_ds.images is got_ds.frames
        got = list(got_ds.epoch(3))
        assert len(got) == len(want) > 0
        for w, g in zip(want, got):
            _assert_batches_equal(w, g)


# -- loud failures, the same in both packages --------------------------------


def _llff_scene(pkg, root, n_views=3):
    pkg.write_colmap_scene(str(root), "scene_a", n_views=n_views)
    scene = os.path.join(root, "scene_a")
    sparse = os.path.join(scene, "sparse/0")
    return scene, sparse, pkg.colmap.read_model(sparse)


def _camera_model(pkg, root):
    scene, sparse, (cams, _, _) = _llff_scene(pkg, root)
    cam = cams[1]
    cams[1] = pkg.colmap.Camera(cam.id, "PINHOLE", cam.width, cam.height,
                                np.array([cam.params[0], cam.params[0], *cam.params[1:3]]))
    pkg.colmap.write_cameras_binary(cams, os.path.join(sparse, "cameras.bin"))
    return lambda: pkg.llff.load_scene(scene, "images", (64, 64), 1.0)


def _track(pkg, root, corrupt: bool):
    scene, sparse, (_, imgs, _) = _llff_scene(pkg, root)
    m = imgs[1]
    if corrupt:
        imgs[1] = pkg.colmap.ImageMeta(m.id, m.qvec, m.tvec, m.camera_id, m.name,
                                       np.concatenate([m.xys, [[1.0, 1.0]]]),
                                       np.concatenate([m.point3d_ids, [987654]]))
    else:
        imgs[1] = pkg.colmap.ImageMeta(m.id, m.qvec, m.tvec, m.camera_id, m.name, m.xys,
                                       np.full_like(m.point3d_ids, -1))
    pkg.colmap.write_images_binary(imgs, os.path.join(sparse, "images.bin"))
    return lambda: pkg.llff.load_scene(scene, "images", (64, 64), 1.0)


def _distortion(pkg, root):
    scene, sparse, (cams, _, _) = _llff_scene(pkg, root, n_views=4)
    cam = cams[1]
    cams[1] = pkg.colmap.Camera(cam.id, cam.model, cam.width, cam.height,
                                np.concatenate([cam.params[:3], [0.12]]))
    pkg.colmap.write_cameras_binary(cams, os.path.join(sparse, "cameras.bin"))
    cfg = pkg.Config().replace(**{
        "data.name": "llff", "data.img_h": 64, "data.img_w": 64,
        "data.img_pre_downsample_ratio": 1.0, "data.training_set_path": str(root),
        "data.visible_point_count": 16})
    return lambda: len(pkg.llff.LLFFDataset(cfg, "train", 2).images)


def _fixture_build(pkg, root, family, edit, **cfg_extra):
    path = write_fixture(family, str(root))
    edit(path)
    cfg = pkg.Config().replace(**{
        "data.name": family, "data.img_h": 48, "data.img_w": 64,
        "data.img_pre_downsample_ratio": 1.0, "data.training_set_path": path,
        "data.visible_point_count": 16, **cfg_extra})
    return lambda: pkg.registry.build_dataset(cfg, "train", 2)


def _text_file(root, text):
    p = os.path.join(root, "seq.txt")
    with open(p, "w") as fh:
        fh.write(text)
    return p


def _truncate_poses(path):
    p = os.path.join(path, "2011_09_26_drive_0001_sync", "poses.txt")
    with open(p) as fh:
        rows = fh.read().splitlines()
    with open(p, "w") as fh:
        fh.write("\n".join(rows[:2]) + "\n")  # 4 frames, 2 pose rows


def _retile(path):
    p = os.path.join(path, "grids", "sample_0.png")
    Image.open(p).resize((191, 191)).save(p)  # not divisible by the 3x3 grid


FAILURES = {
    "llff_camera_model": (ValueError, "PINHOLE.*cannot read", _camera_model),
    "llff_corrupt_track": (ValueError, "987654.*absent from points3D",
                           lambda pkg, root: _track(pkg, root, corrupt=True)),
    "llff_empty_track": (ValueError, "0 usable points",
                         lambda pkg, root: _track(pkg, root, corrupt=False)),
    "llff_distortion_warns": (UserWarning, "distortion.*IGNORED", _distortion),
    "realestate_malformed_line": (
        ValueError, r"seq\.txt:2.*19 fields",
        lambda pkg, root: lambda: pkg.realestate.parse_camera_file(
            _text_file(root, "https://example.test/x\n123 1.0 1.0 0.5\n"))),
    "realestate_missing_cloud": (
        FileNotFoundError, "no SfM point cloud",
        lambda pkg, root: _fixture_build(
            pkg, root, "realestate10k",
            lambda p: os.remove(os.path.join(p, "points", "seq_train.npz")))),
    "kitti_no_p2": (
        ValueError, "no P2 row",
        lambda pkg, root: lambda: pkg.kitti.parse_calib(
            _text_file(root, "P0: " + " ".join(["0"] * 12) + "\n"))),
    "kitti_truncated_poses": (
        ValueError, "beyond the 2 rows",
        lambda pkg, root: _fixture_build(pkg, root, "kitti_raw", _truncate_poses)),
    "dtu_cam_without_sections": (
        ValueError, "extrinsic.*intrinsic",
        lambda pkg, root: lambda: pkg.dtu.parse_cam_file(_text_file(root, "1 0 0 0\n0 1 0 0\n"))),
    "flowers_bad_tiling": (
        ValueError, "not a 3x3 tiling",
        lambda pkg, root: _fixture_build(pkg, root, "flowers", _retile, **{"data.img_w": 48})),
}


@pytest.mark.parametrize("case", sorted(FAILURES))
def test_loud_failures_match_jax(case, tmp_path):
    kind, match, make = FAILURES[case]
    results = {}
    for name, pkg in PKGS.items():
        root = tmp_path / name
        root.mkdir()
        run = make(pkg, str(root))
        if issubclass(kind, Warning):
            with pytest.warns(kind, match=match):
                results[name] = run()
        else:
            with pytest.raises(kind, match=match) as exc:
                run()
            results[name] = (type(exc.value), str(exc.value).replace(str(root), "<root>"))
    assert results["jax"] == results["torch"]


def test_unknown_dataset_lists_every_registered_name():
    assert t_registry.registered_names() == j_registry.registered_names()
    assert len(t_registry.registered_names()) == 8
    cfg = TConfig().replace(**{"data.name": "imagenet"})
    with pytest.raises(t_registry.UnknownDatasetError) as exc:
        t_registry.build_dataset(cfg, "train", 2)
    assert isinstance(exc.value, KeyError)
    for name in t_registry.registered_names():
        assert name in str(exc.value)
