"""Write the JPEG fixtures of tests/data/jpeg/ with PIL, each beside PIL's
own decode of it (``convert("RGB")``) as a PNG.

    python scripts/torch_jpeg_fixtures.py [--out tests/data/jpeg]
        [--timing_out assets/jpeg_timing]

The port's decoder (``blobctrl_torch/utils/jpeg.py``) must give each PNG's
pixels bit for bit: the CPU tests check that against PIL, and
``chip_smoke.py`` checks it on the card's host, which has no PIL. The
4032x3024 file (``--timing_out``, no PNG beside it) is for timing the
decoder at a phone camera's size and entropy: textured at quality 90,
about 2.5 bits a pixel (3.8 MB), where phone photos run at 2 to 4; the
entropy decoder's time grows with the coded symbols, so a smooth file
would understate it.
"""

from __future__ import annotations

import argparse
import io
import os

import numpy as np
from PIL import Image


def photo(h: int, w: int, seed: int, noise: float) -> np.ndarray:
    """Smooth colour fields with a little texture: a photo's statistics
    without a photo."""
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    a = np.stack([np.sin(xx * 9 + yy * 3) * 90 + 128,
                  np.cos(yy * 7 - xx * 2) * 80 + 120,
                  np.sin((xx + yy) * 13) * 60 + 110], -1)
    a += rs.normal(0, noise, a.shape)
    return a.clip(0, 255).astype(np.uint8)


def textured_photo(h: int, w: int, seed: int) -> np.ndarray:
    """``photo`` with texture at four scales (64, 16, 4 and 1 pixels), so
    that every block carries AC detail, as a camera photo does."""
    rs = np.random.RandomState(seed)
    a = photo(h, w, seed, 0.0).astype(np.float64)
    for scale, amp in ((64, 30.0), (16, 18.0), (4, 10.0), (1, 6.0)):
        f = rs.normal(0, amp, (-(-h // scale) + 1, -(-w // scale) + 1, 3))
        a += np.repeat(np.repeat(f, scale, 0), scale, 1)[:h, :w]
    return a.clip(0, 255).astype(np.uint8)


# name -> (height, width, gray, PIL save options)
FIXTURES = {
    "gray": (33, 65, True, dict(quality=75)),
    "444": (17, 9, False, dict(quality=90, subsampling=0)),
    "422": (33, 65, False, dict(quality=50, subsampling=1)),
    "420": (33, 65, False, dict(quality=75, subsampling=2)),
    "progressive": (40, 57, False, dict(quality=100, subsampling=2,
                                        progressive=True)),
    "restart": (48, 40, False, dict(quality=75, subsampling=2,
                                    restart_marker_blocks=3, optimize=True)),
    "photo_512_420": (512, 512, False, dict(quality=75, subsampling=2)),
}
TIMING = ("photo_4032x3024_420", 3024, 4032, dict(quality=90, subsampling=2))


def write(out: str, name: str, img: np.ndarray, opts: dict, png: bool):
    pil = Image.fromarray(img)
    buf = io.BytesIO()
    pil.save(buf, "JPEG", **opts)
    data = buf.getvalue()
    with open(os.path.join(out, name + ".jpg"), "wb") as f:
        f.write(data)
    if png:
        dec = Image.open(io.BytesIO(data)).convert("RGB")
        dec.save(os.path.join(out, name + ".png"), optimize=True)


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default="tests/data/jpeg")
    p.add_argument("--timing_out", default="assets/jpeg_timing")
    args = p.parse_args()
    os.makedirs(args.out, exist_ok=True)
    for i, (name, (h, w, gray, opts)) in enumerate(FIXTURES.items()):
        img = photo(h, w, i, 6.0)
        if gray:
            img = np.asarray(Image.fromarray(img).convert("L"))
        write(args.out, name, img, opts, True)
    name, h, w, opts = TIMING
    os.makedirs(args.timing_out, exist_ok=True)
    write(args.timing_out, name, textured_photo(h, w, 99), opts, False)


if __name__ == "__main__":
    main()
