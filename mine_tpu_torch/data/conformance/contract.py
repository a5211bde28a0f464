"""LoaderContract: the declarative per-family dataset contract (the port's
own copy of mine_tpu/data/conformance/contract.py; the tables are equal).

  * every loader yields the training-step batch (BASE_KEYS, plus the pt3d
    pair when `sparse_depth`; families without SfM tracks are the
    NO_DISP_SUPERVISION set in training/step.py and their batches carry NO
    pt3d keys);
  * K is always PIXELS AT THE TARGET (img_h, img_w); `intrinsics` names
    where it came from (COLMAP rescale, normalized txt, calib P2, ...);
  * poses compose as `g_tgt_src = G_tgt_world @ inv(G_src_world)`;
  * `ragged_val_tail`: how a val epoch's short tail keeps static shapes
    ("wrap_pad": duplicated slots masked by eval_weight 0; "fixed_steps":
    procedurally sized epochs, no tail exists);
  * `host_slice`: the loader materializes only (start, count) rows of each
    global batch, bit-equal to slicing a global build;
  * `zoo_shape`: the pretrained-zoo capability envelope (H, W, S).

`runner.check_contract` verifies each flag against the live loader.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

# the training-step batch pytree (training/step.py module docstring)
BASE_KEYS = ("src_img", "tgt_img", "k_src", "k_tgt", "g_tgt_src")
SPARSE_KEYS = ("pt3d_src", "pt3d_tgt")


@dataclass(frozen=True)
class LoaderContract:
    family: str  # the registry name (data/registry.py)
    loader: str  # implementing class, for humans and the README matrix
    sparse_depth: bool  # pt3d supervision present (else NO_DISP_SUPERVISION)
    intrinsics: str  # where pixels-at-target K comes from
    # loaders whose per-frame points are guaranteed to project INSIDE the
    # image (per-image COLMAP tracks; in-view-culled clouds) — the
    # reprojection conformance check only applies where this holds
    points_in_view: bool = True
    pose: str = "g_tgt_src = G_tgt_world @ inv(G_src_world)"
    ragged_val_tail: str = "wrap_pad"  # or "fixed_steps"
    host_slice: bool = True
    zoo_shape: tuple[int, int, int] | None = None  # (H, W, S), BASELINE.md
    notes: str = ""
    extra_keys: tuple[str, ...] = field(default=())

    @property
    def required_keys(self) -> tuple[str, ...]:
        keys = BASE_KEYS + (SPARSE_KEYS if self.sparse_depth else ())
        return keys + self.extra_keys


CONTRACTS: dict[str, LoaderContract] = {c.family: c for c in (
    LoaderContract(
        family="synthetic",
        loader="data.synthetic.SyntheticDataset",
        sparse_depth=True,
        intrinsics="analytic (fov-fixed, generated at target)",
        ragged_val_tail="fixed_steps",
        notes="procedural; zero disk footprint",
    ),
    LoaderContract(
        family="llff",
        loader="data.llff.LLFFDataset",
        sparse_depth=True,
        intrinsics="COLMAP SIMPLE_* camera, per-axis rescale to target",
        zoo_shape=(384, 512, 32),  # the reference LLFF recipe shape
    ),
    LoaderContract(
        family="nocs_llff",
        loader="data.llff.LLFFDataset",
        sparse_depth=True,
        intrinsics="COLMAP SIMPLE_* camera, center-crop-shifted principal "
                   "point, per-axis rescale to target",
        notes="384x640 center crop + first-51-images cap",
    ),
    LoaderContract(
        family="objectron",
        loader="data.objectron.ObjectronDataset",
        sparse_depth=True,
        intrinsics="per-frame metadata focal/c, crop-shifted",
        # one shared world cloud per scene transformed per frame — a point
        # may sit outside a given frame's view frustum
        points_in_view=False,
        notes="±10-frame target window; 90° CCW rotate + crop",
    ),
    LoaderContract(
        family="realestate10k",
        loader="data.realestate.RealEstateDataset",
        sparse_depth=True,
        intrinsics="normalized txt intrinsics x (img_w, img_h) — exact at "
                   "any target size",
        zoo_shape=(256, 384, 64),  # RealEstate10K 384x256 N=64 (BASELINE)
        notes="camera-txt protocol of arxiv 2004.11364; per-frame points "
              "are the sequence SfM cloud culled to in-view",
    ),
    LoaderContract(
        family="kitti_raw",
        loader="data.kitti.KittiRawDataset",
        sparse_depth=False,
        intrinsics="calib.txt P2 (rectified left color), per-axis rescale "
                   "to target",
        zoo_shape=(256, 768, 64),  # KITTI 768x256 N=64 (BASELINE)
        notes="±10-frame target window; poses.txt cam-to-world rows",
    ),
    LoaderContract(
        family="dtu",
        loader="data.dtu.DTUDataset",
        sparse_depth=False,
        intrinsics="MVSNet cam.txt intrinsic, per-axis rescale to target",
        notes="per-view <id>_cam.txt extrinsic/intrinsic pairs",
    ),
    LoaderContract(
        family="flowers",
        loader="data.flowers.FlowersDataset",
        sparse_depth=False,
        intrinsics="shared focal_px from meta.json, per-axis rescale to "
                   "target, centered principal point",
        zoo_shape=(384, 512, 64),  # Flowers 512x384 N=64 (BASELINE)
        notes="G x G sub-aperture tiles; planar camera array poses",
    ),
)}

# shipped recipe yaml (mine_tpu/configs/<name>.yaml) -> contract family.
# This IS "the nine configs": every non-default yaml must appear here.
CONFIG_FAMILIES: dict[str, str] = {
    "llff": "llff",
    "llff_highres": "llff",
    "nocs_llff": "nocs_llff",
    "objectron": "objectron",
    "realestate": "realestate10k",
    "kitti_raw": "kitti_raw",
    "dtu": "dtu",
    "flowers": "flowers",
    "synthetic": "synthetic",
}

# the pretrained-zoo shape set (BASELINE.md capability envelope), deduped
# in a stable order. Every shape satisfies the model's 128-multiple
# constraint.
ZOO_BUCKETS: tuple[tuple[int, int, int], ...] = tuple(sorted(
    {c.zoo_shape for c in CONTRACTS.values() if c.zoo_shape is not None}
))


def contract_for_config(config_name: str) -> LoaderContract:
    """Shipped recipe name ('realestate', 'llff_highres', ...) -> its
    family contract; unknown names list what exists."""
    try:
        return CONTRACTS[CONFIG_FAMILIES[config_name]]
    except KeyError:
        raise KeyError(
            f"config {config_name!r} is not in the conformance matrix; "
            f"known configs: {', '.join(sorted(CONFIG_FAMILIES))}"
        ) from None


def configs_dir() -> str:
    """The shipped recipes, mine_tpu/configs/ beside this package (read as
    data files only)."""
    return os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))), "mine_tpu", "configs")


def all_config_names() -> tuple[str, ...]:
    """Every shipped recipe yaml except the defaults layer — the matrix
    the conformance runner sweeps."""
    names = sorted(
        os.path.splitext(f)[0] for f in os.listdir(configs_dir())
        if f.endswith(".yaml") and f != "default.yaml"
    )
    return tuple(names)
