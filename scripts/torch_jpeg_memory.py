"""Peak host memory and seconds of the port's JPEG decoder on a large
frame of DC-only blocks (a 2048^2 4:2:0 file of 66 KB, written with PIL).

    python scripts/torch_jpeg_memory.py [--side 2048]

Prints the traced peak (``tracemalloc``: numpy's buffers and the Python
objects), the peak in bytes a pixel and the decode seconds, and checks
the output against PIL's decode. PIL holds about 3 bytes a pixel.
"""

from __future__ import annotations

import argparse
import io
import os
import sys
import time
import tracemalloc

import numpy as np
from PIL import Image

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from blobctrl_torch.utils import jpeg  # noqa: E402


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--side", type=int, default=2048)
    side = p.parse_args().side
    buf = io.BytesIO()
    Image.fromarray(np.full((side, side, 3), (90, 140, 200), np.uint8)).save(
        buf, "JPEG", quality=75, subsampling=2)
    data = buf.getvalue()
    jpeg.decode_jpeg(data)          # the Huffman tables, built once
    tracemalloc.start()
    t0 = time.perf_counter()
    out = jpeg.decode_jpeg(data)
    secs = time.perf_counter() - t0
    peak = tracemalloc.get_traced_memory()[1]
    tracemalloc.stop()
    same = np.array_equal(out, np.asarray(Image.open(io.BytesIO(data))
                                          .convert("RGB")))
    print(f"{side}x{side} 4:2:0, {len(data)} bytes: peak {peak / 2 ** 20:.1f}"
          f" MiB, {peak / side ** 2:.2f} bytes a pixel, {secs:.3f} s, "
          f"equal to PIL: {same}")


if __name__ == "__main__":
    main()
