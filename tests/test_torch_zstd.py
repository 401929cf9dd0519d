"""The port's two zstd decoders, the plain one (``utils/zstd.py``) and the
compiled one (``csrc/zstd_decode.cpp`` through ``params/ocdbt.
zstd_decompress``, built by the host C++ compiler), against ``zstandard``
(libzstd) on frames it writes: levels -5 to 19, with and without a checksum
and a content size, zeros, random bytes, fp32 and bf16 weights, text,
repeats farther back than the window, sizes from 0 bytes to 4 MiB,
concatenated and skippable frames, a hypothesis case; truncated, corrupt and
dictionary frames refused with ValueError (a corrupt frame that libzstd
accepts must decode to what libzstd gives); a failed build of the compiled
decoder raises, with no fallback."""

import numpy as np
import pytest
import zstandard
from hypothesis import given, settings
from hypothesis import strategies as st

from blobctrl_torch.ops import _build
from blobctrl_torch.params import ocdbt
from blobctrl_torch.utils import zstd

LEVELS = (-5, 1, 3, 9, 19)


def _inputs():
    rng = np.random.RandomState(0)
    text = (b"BlobCtrl edits an element of an image by its blob: move, "
            b"resize, remove. ") * 300
    w = rng.randn(40000).astype(np.float32)
    return {
        "zeros": bytes(70000), "random": rng.bytes(50000),
        "fp32": w.tobytes(),
        "bf16": (w.view(np.uint32) >> 16).astype(np.uint16).tobytes(),
        "text": text, "repeats": rng.bytes(3000) * 40,
    }


INPUTS = _inputs()


def compiled(frame: bytes) -> bytes:
    return ocdbt.zstd_decompress(frame).tobytes()


def both(frame: bytes, want: bytes):
    assert zstd.decompress(frame) == want
    assert compiled(frame) == want


@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("checksum", [False, True])
@pytest.mark.parametrize("content_size", [False, True])
def test_levels_and_flags(level, checksum, content_size):
    c = zstandard.ZstdCompressor(level=level, write_checksum=checksum,
                                 write_content_size=content_size)
    for name, data in INPUTS.items():
        frame = c.compress(data)
        assert zstandard.decompress(frame, max_output_size=1 << 24) == data
        both(frame, data)


@pytest.mark.parametrize("size", [0, 1, 7, 255, 4096, 131071, 131072, 131073,
                                  1 << 20, 4 << 20])
def test_sizes(size):
    rng = np.random.RandomState(size)
    cases = [bytes(size), rng.bytes(size)]
    if size >= 4:
        cases.append(rng.randn(size // 4).astype(np.float32).tobytes())
    for data in cases:
        for level in (1, 19) if size <= (1 << 20) else (1,):
            frame = zstandard.ZstdCompressor(level=level).compress(data)
            both(frame, data)


def test_streamed_frames_reach_back_across_blocks():
    """A frame written by the streaming API (no content size, window 2^20)
    whose matches reach into earlier blocks, and one whose repeats lie
    farther back than its window (2^10), so they cannot be matches."""
    rng = np.random.RandomState(1)
    data = rng.bytes(150000) * 5
    obj = zstandard.ZstdCompressor(level=3).compressobj()
    frame = obj.compress(data[:300000]) + obj.compress(data[300000:]) + \
        obj.flush()
    both(frame, data)
    params = zstandard.ZstdCompressionParameters.from_level(9, window_log=10)
    far = rng.bytes(5000) * 30
    frame = zstandard.ZstdCompressor(compression_params=params).compress(far)
    both(frame, far)


def test_concatenated_and_skippable_frames():
    a = zstandard.ZstdCompressor(level=3).compress(INPUTS["text"])
    b = zstandard.ZstdCompressor(level=1, write_checksum=True).compress(
        INPUTS["fp32"])
    skip = (0x184D2A5A).to_bytes(4, "little") + (6).to_bytes(4, "little") + \
        b"ignore"
    both(a + skip + b + a, INPUTS["text"] + INPUTS["fp32"] + INPUTS["text"])
    both(skip + a, INPUTS["text"])


@settings(max_examples=40, deadline=None)
@given(st.binary(max_size=6000), st.integers(-5, 19), st.booleans())
def test_hypothesis(data, level, checksum):
    frame = zstandard.ZstdCompressor(level=level, write_checksum=checksum
                                     ).compress(data * 3)
    both(frame, data * 3)


def _refused(frame: bytes):
    for fn in (zstd.decompress, compiled):
        with pytest.raises(ValueError):
            fn(frame)


def test_truncated_frames_are_refused():
    frame = zstandard.ZstdCompressor(level=3, write_checksum=True).compress(
        INPUTS["text"] + INPUTS["fp32"][:20000])
    for n in list(range(0, 40)) + list(range(40, len(frame) - 1, 97)):
        _refused(frame[:n])


def test_corrupt_frames_are_refused():
    """Single bit flips of a checksummed frame: wherever libzstd refuses
    the frame both decoders refuse it, and wherever it accepts one (an
    unused header bit) both give its output."""
    frame = zstandard.ZstdCompressor(level=9, write_checksum=True).compress(
        INPUTS["text"][:6000] + INPUTS["fp32"][:6000])
    rng = np.random.RandomState(2)
    refused = 0
    for _ in range(150):
        bad = bytearray(frame)
        i = rng.randint(len(bad))
        bad[i] ^= 1 << rng.randint(8)
        try:
            want = zstandard.ZstdDecompressor().decompress(
                bytes(bad), max_output_size=1 << 20)
        except zstandard.ZstdError:
            _refused(bytes(bad))
            refused += 1
            continue
        both(bytes(bad), want)
    assert refused > 140
    _refused(b"\x00\x01\x02\x03" + frame[4:])        # not a zstd magic
    _refused(frame[:4] + bytes([frame[4] | 8]) + frame[5:])  # reserved bit


def test_dictionary_frames_are_refused():
    samples = [f"prompt {i}: a red ball on a table".encode() * (1 + i % 4)
               for i in range(200)]
    d = zstandard.train_dictionary(1024, samples)
    frame = zstandard.ZstdCompressor(dict_data=d).compress(samples[3])
    assert zstandard.ZstdDecompressor(dict_data=d).decompress(frame) == \
        samples[3]
    for fn in (zstd.decompress, compiled):
        with pytest.raises(ValueError, match="dictionary"):
            fn(frame)


def test_xxh64_is_the_frames_checksum():
    for data in (b"", b"a", INPUTS["text"][:37], INPUTS["random"]):
        frame = zstandard.ZstdCompressor(write_checksum=True).compress(data)
        assert int.from_bytes(frame[-4:], "little") == \
            zstd.xxh64(data) & 0xFFFFFFFF
    assert zstd.xxh64(b"") == 0xEF46DB3751D8E999


def test_a_failed_build_raises_with_no_fallback(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "_host_entry", {})
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_host_cmd",
                        lambda name, out: ["false", name, out])
    frame = zstandard.ZstdCompressor().compress(b"abc" * 100)
    with pytest.raises(RuntimeError, match="build failed"):
        ocdbt.zstd_decompress(frame)
    assert not _build._host_entry
