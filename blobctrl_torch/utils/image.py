"""One entry point for the image bytes a user sends or a state directory
holds: PNG (``utils/png.py``) or JPEG (``utils/jpeg.py``), chosen by the
file's signature, as PIL's ``Image.open`` chooses in the JAX package."""

from __future__ import annotations

import numpy as np

from blobctrl_torch.utils import jpeg, png


def decode_image(data: bytes) -> np.ndarray:
    """PNG or JPEG bytes -> (H, W, 3) uint8, PIL's ``convert("RGB")``.
    Raises ValueError for any other format and for what either decoder
    does not support."""
    data = bytes(data)
    if data[:4] == b"\x89PNG":
        return png.decode_png(data)
    if data[:2] == b"\xff\xd8":
        return jpeg.decode_jpeg(data)
    raise ValueError("not PNG or JPEG data (unknown signature)")


def read_image(path: str) -> np.ndarray:
    """A PNG or JPEG file -> (H, W, 3) uint8."""
    with open(path, "rb") as f:
        return decode_image(f.read())
