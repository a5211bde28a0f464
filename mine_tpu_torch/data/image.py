"""Image files for the dataset loaders: the one module that reads or writes
them.

Every loader decodes to 8-bit RGB, optionally rotates and center-crops, and
resizes bicubically to (img_h, img_w) before scaling to float32 in [0, 1],
exactly as the JAX package's loaders do with Pillow (data/llff.py,
objectron.py, realestate.py, kitti.py, dtu.py, flowers.py there). Every step
is the same Pillow call, so a batch equals the JAX package's bit for bit.
"""

from __future__ import annotations

import numpy as np
from PIL import Image


def open_rgb(path: str) -> Image.Image:
    """Decode an image file to an 8-bit RGB Pillow image (for `crop`)."""
    return Image.open(path).convert("RGB")


def read_rgb(path: str) -> np.ndarray:
    """Decode an image file to (H, W, 3) uint8 RGB."""
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def as_image(pixels: np.ndarray) -> Image.Image:
    """(H, W) gray or (H, W, 3|4) uint8 pixels as a Pillow image."""
    if pixels.dtype != np.uint8:
        raise TypeError(f"8-bit pixels expected, got {pixels.dtype}")
    return Image.fromarray(pixels)


def save_png(img: np.ndarray | Image.Image, path: str) -> None:
    """Write uint8 pixels (as_image) or a Pillow image as a PNG."""
    if isinstance(img, np.ndarray):
        img = as_image(img)
    img.save(path, format="PNG")


def rotate_ccw(img: Image.Image) -> Image.Image:
    """90° counter-clockwise."""
    return img.transpose(Image.ROTATE_90)


def rotate_cw(img: Image.Image) -> Image.Image:
    """90° clockwise."""
    return img.transpose(Image.ROTATE_270)


def resize_bicubic(img: np.ndarray | Image.Image, hw: tuple[int, int]) -> Image.Image:
    """Bicubic resample of uint8 RGB pixels or a Pillow image to (h, w),
    antialiased when it shrinks."""
    if isinstance(img, np.ndarray):
        img = as_image(img)
    h, w = hw
    return img.resize((w, h), Image.BICUBIC)


def to_unit_float(img: np.ndarray | Image.Image) -> np.ndarray:
    """uint8 pixels -> float32 in [0, 1]."""
    return np.asarray(img, dtype=np.float32) / 255.0
