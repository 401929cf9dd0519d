"""zarr v2 arrays in an OCDBT store (``params/ocdbt.py``), as the JAX
package's orbax checkpoints hold them: ``<name>/.zarray`` (JSON) and one
key a chunk, ``<name>/<i>.<j>...`` (``<name>/0`` for a scalar), each chunk
zstd-compressed, in C order.

``read_array`` decodes each chunk straight into its slice of one host
buffer (through a scratch chunk only where the slice is not contiguous
or the chunk overhangs the array's edge); a missing chunk is
``fill_value`` (null reads as zeros, as tensorstore reads it).
``to_torch`` views it in its saved dtype (``bfloat16``, stored as its
16 bits, becomes ``torch.bfloat16``). ``array_items`` writes an array as
one chunk, zstd in raw blocks.
"""

from __future__ import annotations

import itertools
import json
import math
import threading
from typing import List, Optional, Tuple

import numpy as np
import torch

from blobctrl_torch.params import ocdbt

# zarr dtype -> (numpy dtype of the stored bytes, torch dtype)
DTYPES = {
    "<f4": (np.float32, torch.float32), "<f2": (np.float16, torch.float16),
    "bfloat16": (np.uint16, torch.bfloat16), "<i4": (np.int32, torch.int32),
    "<u4": (np.uint32, torch.uint32), "|u1": (np.uint8, torch.uint8),
    "|b1": (np.bool_, torch.bool),
}
ZARR_DTYPE = {t: z for z, (_, t) in DTYPES.items()}
COMPRESSOR = {"id": "zstd", "level": 1}


def _meta(store: ocdbt.Store, name: str) -> dict:
    key = f"{name}/.zarray".encode()
    if key not in store:
        raise KeyError(f"no zarr array {name!r} in the checkpoint")
    meta = json.loads(store.get(key))
    if meta.get("zarr_format") != 2:
        raise ValueError(f"{name}: zarr format {meta.get('zarr_format')}, "
                         f"2 expected")
    if meta.get("order", "C") != "C" or meta.get("filters"):
        raise ValueError(f"{name}: only C-order zarr arrays without "
                         f"filters are read")
    if (meta.get("compressor") or {}).get("id") != "zstd":
        raise ValueError(f"{name}: compressor {meta.get('compressor')!r} "
                         f"(orbax's zstd is read)")
    if meta["dtype"] not in DTYPES:
        raise ValueError(f"{name}: zarr dtype {meta['dtype']!r} is not "
                         f"one of {sorted(DTYPES)}")
    return meta


def read_array(store: ocdbt.Store, name: str, alloc=np.empty
               ) -> Tuple[np.ndarray, str]:
    """-> (the array on the host, its zarr dtype). ``alloc(shape, dtype)``
    gives the host buffer (a fresh array by default; a view of pinned
    memory for a copy to the card)."""
    meta = _meta(store, name)
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    np_dtype = DTYPES[meta["dtype"]][0]
    out = alloc(shape, np_dtype)
    if out.size == 0:
        return out, meta["dtype"]
    sep = meta.get("dimension_separator", ".")
    fill = meta.get("fill_value")
    grid = [range(math.ceil(s / c)) for s, c in zip(shape, chunks)]
    for idx in itertools.product(*grid):
        key = f"{name}/{sep.join(map(str, idx)) if idx else '0'}".encode()
        sl = tuple(slice(i * c, min((i + 1) * c, s))
                   for i, c, s in zip(idx, chunks, shape))
        region = out[sl] if sl else out    # a scalar: the 0-d array
        if key not in store:
            region[...] = 0 if fill is None else fill
            continue
        direct = region.shape == chunks and region.flags.c_contiguous
        dst = region if direct else np.empty(chunks, np_dtype)
        with store.mapped(key) as data:
            ocdbt.zstd_decompress(data, out=dst)
            del data
        if not direct:
            region[...] = dst[tuple(slice(0, r) for r in region.shape)]
    return out, meta["dtype"]


def to_torch(arr: np.ndarray, zdtype: str, device) -> torch.Tensor:
    """The host array as a tensor of its saved dtype on ``device``."""
    t = torch.from_numpy(arr) if arr.ndim else torch.from_numpy(
        arr.reshape(1)).reshape(())
    if zdtype == "bfloat16":
        t = t.view(torch.bfloat16)
    return t.to(device)


class Staging(threading.local):
    """A pinned host buffer per thread, grown as needed, through which
    arrays cross between the card and the host (pageable copies are
    several times slower)."""
    buf = None

    def take(self, nbytes: int) -> torch.Tensor:
        if self.buf is None or self.buf.numel() < nbytes:
            self.buf = torch.empty(max(nbytes, 1), dtype=torch.uint8,
                                   pin_memory=True)
        return self.buf[:nbytes]

    def alloc(self, shape, dtype) -> np.ndarray:
        """``read_array``'s ``alloc``: an array over this thread's buffer,
        valid until the thread's next ``alloc`` or ``take``."""
        n = int(np.prod(shape, dtype=np.int64)) * np.dtype(dtype).itemsize
        return self.take(n).numpy().view(dtype).reshape(shape)


def host_bytes(t: torch.Tensor, staging: Optional[Staging] = None
               ) -> Tuple[np.ndarray, str]:
    """A tensor as (its bytes in a host numpy array, its zarr dtype). A
    card's tensor is copied into ``staging``'s pinned buffer when given
    (the array then lives until that buffer's next use)."""
    if t.dtype not in ZARR_DTYPE:
        raise TypeError(f"no zarr dtype for {t.dtype}")
    c = t.detach().contiguous()
    if c.dtype == torch.bfloat16:
        c = c.view(torch.int16)
    if c.device.type != "cpu":
        if staging is not None:
            host = staging.take(c.numel() * c.element_size())
            host.view(c.dtype).view(c.shape).copy_(c)
            c = host.view(c.dtype).view(c.shape)
        else:
            c = c.cpu()
    arr = c.numpy()
    if t.dtype == torch.bfloat16:
        return arr.view(np.uint16), "bfloat16"
    return arr, ZARR_DTYPE[t.dtype]


def array_items(name: str, arr: np.ndarray, zdtype: str
                ) -> List[Tuple[bytes, object]]:
    """The OCDBT (key, value) pairs of one array: its ``.zarray`` and its
    one chunk (none for a zero-size array), zstd in raw blocks."""
    shape = list(arr.shape)
    meta = {"chunks": [max(s, 1) for s in shape], "compressor": COMPRESSOR,
            "dimension_separator": ".", "dtype": zdtype,
            "fill_value": None, "filters": None, "order": "C",
            "shape": shape, "zarr_format": 2}
    items = [(f"{name}/.zarray".encode(),
              json.dumps(meta, sort_keys=True, separators=(",", ":"))
              .encode())]
    if arr.size:
        chunk = ".".join("0" * arr.ndim) if arr.ndim else "0"
        items.append((f"{name}/{chunk}".encode(), ocdbt.zstd_raw_frame(
            np.ascontiguousarray(arr).reshape(-1))))
    return items
