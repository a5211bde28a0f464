"""Eval's TensorBoard image grids in the port (mine_tpu_torch/utils/logging.py
MetricWriter.image_grid and normalize_disparity_for_vis, written by
training/loop.py run_evaluation) against the JAX package's
(mine_tpu/utils/logging.py, mine_tpu/training/loop.py run_evaluation).

  * On the same seeded numpy inputs the port's normaliser equals the JAX
    function's, and the grid that image_grid hands TensorBoard equals the
    JAX writer's, array for array (a recording stand-in takes add_image).
  * The video's depth normaliser is that one function, clipped, as the JAX
    video module's is.
  * run_evaluation, given a writer, writes the val/ scalars and the three
    grids (val/tgt_syn, val/src_syn, val/tgt_disparity) of the last batch's
    first four examples into the event file: one row of four 128x128 images.
"""

from __future__ import annotations

import numpy as np
import torch
from torch_threads import one_torch_thread  # noqa: F401


class _Recorder:
    def __init__(self):
        self.images = []

    def add_image(self, tag, img, step, dataformats):
        self.images.append((tag, np.array(img), step, dataformats))


def _inputs():
    rng = np.random.default_rng(11)
    disp = rng.uniform(0.01, 2.0, (4, 16, 24, 1)).astype(np.float32)
    disp[2] = 0.5  # a constant image: the 1e-8 floor
    images = rng.uniform(-0.2, 1.2, (4, 16, 24, 3)).astype(np.float32)  # clipped to [0, 1]
    return disp, images


def test_normalize_disparity_for_vis_matches_jax():
    from mine_tpu.inference.video import normalize_disparity as jax_video_normalize
    from mine_tpu.utils.logging import normalize_disparity_for_vis as jax_normalize
    from mine_tpu_torch.inference.video import normalize_disparity
    from mine_tpu_torch.utils.logging import normalize_disparity_for_vis

    disp, _ = _inputs()
    np.testing.assert_array_equal(normalize_disparity_for_vis(disp), jax_normalize(disp))
    np.testing.assert_array_equal(normalize_disparity(disp), jax_video_normalize(disp))


def test_image_grid_matches_jax(tmp_path):
    from mine_tpu.utils.logging import MetricWriter as JaxWriter
    from mine_tpu.utils.logging import normalize_disparity_for_vis as jax_normalize
    from mine_tpu_torch.utils.logging import MetricWriter, normalize_disparity_for_vis

    disp, images = _inputs()
    got, want = MetricWriter(None), JaxWriter(None)
    got._tb, want._tb = _Recorder(), _Recorder()
    for writer, norm in ((got, normalize_disparity_for_vis), (want, jax_normalize)):
        writer.image_grid("val/tgt_syn", images, 7)
        writer.image_grid("val/tgt_disparity", norm(disp), 7)
    assert len(got._tb.images) == len(want._tb.images) == 2
    for (tag, img, step, fmt), (jtag, jimg, jstep, jfmt) in zip(got._tb.images,
                                                               want._tb.images):
        assert (tag, step, fmt) == (jtag, jstep, jfmt) and fmt == "HWC"
        assert img.shape == (16, 4 * 24, img.shape[-1])
        np.testing.assert_array_equal(img, jimg)
    # without an event writer (tensorboardX absent) nothing is written
    MetricWriter(None).image_grid("val/tgt_syn", images, 7)


def test_run_evaluation_writes_the_three_grids(tmp_path):
    from mine_tpu_torch.config import Config
    from mine_tpu_torch.data.registry import build_dataset
    from mine_tpu_torch.models.mpi import init_weights
    from mine_tpu_torch.training.loop import run_evaluation
    from mine_tpu_torch.training.step import build_model
    from mine_tpu_torch.utils.logging import MetricWriter, event_summaries

    cfg = Config().replace(**{
        "data.name": "synthetic", "data.img_h": 128, "data.img_w": 128,
        "model.num_layers": 18, "model.dtype": "float32", "mpi.num_bins_coarse": 2,
        "data.per_gpu_batch_size": 4, "data.num_workers": 0})
    model = init_weights(build_model(cfg), torch.Generator().manual_seed(0))
    writer = MetricWriter(str(tmp_path))
    result = run_evaluation(cfg, model, build_dataset(cfg, "val", 4), torch.device("cpu"),
                            global_step=5, writer=writer)
    writer.close()
    found = event_summaries(str(tmp_path))
    for tag in ("val/tgt_syn", "val/src_syn", "val/tgt_disparity"):
        assert found[tag]["kind"] == "image" and found[tag]["steps"] == [5], found.get(tag)
        assert found[tag]["hw"] == (128, 4 * 128)
    assert found["val/loss"]["kind"] == "simple_value"
    assert np.isfinite(result["loss"])
