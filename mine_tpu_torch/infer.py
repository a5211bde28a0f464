"""Inference CLI: one image -> camera-path novel-view videos.

    python -m mine_tpu_torch.infer --checkpoint workspace/run \
        --image photo.png --output_dir out/
    python -m mine_tpu_torch.infer --weights vars.npz \
        --config mine_tpu/configs/llff.yaml --image photo.png --output_dir out/

--checkpoint is a training workspace of the port (params.yaml +
checkpoints/<step>/state.pt): the config and the newest checkpoint's model
weights are read from it. --weights is the JAX package's flat variables
.npz (the layout tools/convert_resnet.py and tools/convert_mine_checkpoint.py
write and mine_tpu/models/pretrained.py reads), with its --config;
models/convert.py carries it across. The run is on the CUDA device unless
--device cpu is given. A config with mpi.num_bins_fine > 0 predicts
coarse-to-fine (inference/video.py predict_blended_mpi_c2f: two passes, the
fine draws from a generator seeded 1) and renders the merged planes.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from mine_tpu_torch.config import load_config
from mine_tpu_torch.inference.video import VideoGenerator, load_video_generator
from mine_tpu_torch.models.convert import jax_variables_to_torch
from mine_tpu_torch.models.mpi import init_weights
from mine_tpu_torch.training.step import build_model


def load_image(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def main(argv: list[str] | None = None) -> list[str]:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--checkpoint",
                        help="training workspace of the port (params.yaml + checkpoints/)")
    parser.add_argument("--weights", help="flat JAX variables .npz (with --config)")
    parser.add_argument("--config", help="flat dot-key YAML config (with --weights)")
    parser.add_argument("--image", required=True, help="input rgb image")
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--fov", type=float, default=90.0,
                        help="assumed horizontal field of view in degrees")
    parser.add_argument("--allow-random-init", action="store_true",
                        help="without --weights or a checkpoint in the workspace, render "
                             "with seeded random weights (smoke runs only)")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    image = load_image(args.image)
    if args.checkpoint:
        if args.weights or args.config:
            parser.error("--checkpoint reads the config and weights from the workspace; "
                         "drop --weights/--config")
        generator = load_video_generator(args.checkpoint, image, fov_deg=args.fov,
                                         allow_random_init=args.allow_random_init,
                                         device=args.device)
    else:
        if not args.config:
            parser.error("--config is required with --weights (or pass --checkpoint)")
        cfg = load_config(args.config)
        if args.weights:
            with np.load(args.weights) as npz:
                flat = {key: npz[key] for key in npz.files}
            state_dict = jax_variables_to_torch(flat, cfg.model.num_layers)
        elif args.allow_random_init:
            model = init_weights(build_model(cfg), torch.Generator().manual_seed(0))
            state_dict = model.state_dict()
        else:
            parser.error("--checkpoint or --weights is required "
                         "(or --allow-random-init for a smoke run)")
        generator = VideoGenerator(cfg, state_dict, image, fov_deg=args.fov,
                                   device=args.device)
    basename = os.path.splitext(os.path.basename(args.image))[0]
    written = generator.render_videos(args.output_dir, basename)
    for path in written:
        print(path)
    return written


if __name__ == "__main__":
    main()
