"""The port's JPEG decoder (``blobctrl_torch.utils.jpeg``) against PIL, which
the JAX package decodes through (libjpeg-turbo at its defaults): PIL
writes every file here, and ``decode_jpeg`` must give
``np.asarray(Image.open(f).convert("RGB"))`` bit for bit over gray, 4:4:4,
4:2:2 and 4:2:0, qualities 10 to 100, odd sizes (partial MCUs, edge
upsampling, planes of one and two samples), progressive, optimized and
restart-interval files. Every unsupported file raises ValueError: CMYK,
4:1:1 and 4:4:0, Adobe and RGB-coded files, arithmetic, lossless,
hierarchical and 12-bit frames, DNL, truncated and corrupt data, a frame
header above the decompression-bomb bound, and a progressive file whose
refinement scans are cut (libjpeg would smooth it). The committed fixtures
under tests/data/jpeg/ still equal PIL's decode. ``decode_image`` routes
by signature; the server answers a JPEG request with the edit of the PNG
of the same pixels and a bad JPEG with 400; the CLI reads a JPEG object
image and a gray JPEG mask."""

import base64
import io
import os
import pathlib
import struct
import tracemalloc

import numpy as np
import pytest
import torch
from PIL import Image

from blobctrl_torch.utils import image, jpeg, png

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "data" / "jpeg"

torch.set_num_threads(2)


def _content(h, w, seed, gray=False):
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    a = np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1),
                  (xx + yy) * 7 % 256], -1)
    a = (a + rs.randint(-40, 40, a.shape)).clip(0, 255).astype(np.uint8)
    im = Image.fromarray(a)
    return im.convert("L") if gray else im


def _encode(im, **opts) -> bytes:
    buf = io.BytesIO()
    im.save(buf, "JPEG", **opts)
    return buf.getvalue()


def _pil(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


SIZES = [(1, 1), (2, 2), (2, 7), (7, 2), (3, 5), (17, 9), (9, 17), (33, 65),
         (16, 16)]
QUALITIES = [10, 50, 75, 95, 100]
LAYOUTS = {"gray": dict(), "444": dict(subsampling=0),
           "422": dict(subsampling=1), "420": dict(subsampling=2)}
CODINGS = {"baseline": dict(), "progressive": dict(progressive=True),
           "optimize": dict(optimize=True),
           "restart": dict(restart_marker_blocks=1),
           "progressive_restart": dict(progressive=True,
                                       restart_marker_rows=1)}


@pytest.mark.parametrize("coding", list(CODINGS))
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_decode_bit_equal_to_pil(layout, coding):
    for i, (h, w) in enumerate(SIZES):
        for q in QUALITIES:
            im = _content(h, w, seed=i * 7 + q, gray=layout == "gray")
            data = _encode(im, quality=q, **LAYOUTS[layout], **CODINGS[coding])
            got = jpeg.decode_jpeg(data)
            assert got.dtype == np.uint8 and got.shape == (h, w, 3)
            np.testing.assert_array_equal(got, _pil(data),
                                          err_msg=f"{h}x{w} q{q}")


def test_restart_markers_present_in_the_restart_files():
    data = _encode(_content(40, 48, 0), quality=75, restart_marker_blocks=1)
    assert sum(data.count(bytes([0xFF, 0xD0 + i])) for i in range(8)) > 4
    np.testing.assert_array_equal(jpeg.decode_jpeg(data), _pil(data))


def test_photo_sized_progressive_and_baseline():
    """A 256x192 photo-like image, baseline and progressive at quality
    100 (every refinement scan carries data)."""
    rs = np.random.RandomState(3)
    yy, xx = np.mgrid[0:192, 0:256] / 256.0
    a = np.stack([np.sin(xx * 9 + yy * 3) * 90 + 128,
                  np.cos(yy * 7 - xx * 2) * 80 + 120,
                  np.sin((xx + yy) * 13) * 60 + 110], -1)
    a = (a + rs.normal(0, 12, a.shape)).clip(0, 255).astype(np.uint8)
    for opts in (dict(quality=100), dict(quality=100, progressive=True),
                 dict(quality=90, progressive=True, subsampling=1)):
        data = _encode(Image.fromarray(a), **opts)
        np.testing.assert_array_equal(jpeg.decode_jpeg(data), _pil(data))


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_banded_output_bit_equal_to_pil(layout, monkeypatch):
    """Bands of two to four rows and IDCT chunks of three blocks: every
    band seam of the upsampling and every chunk seam of the IDCT falls
    inside the image, and the output is still PIL's."""
    monkeypatch.setattr(jpeg, "_IDCT_BLOCKS", 3)
    for band in (64, 130):
        monkeypatch.setattr(jpeg, "_BAND_PIXELS", band)
        for i, (h, w) in enumerate([(33, 17), (40, 31), (9, 65)]):
            im = _content(h, w, seed=90 + i, gray=layout == "gray")
            for coding in ("baseline", "progressive"):
                data = _encode(im, quality=90, **LAYOUTS[layout],
                               **CODINGS[coding])
                np.testing.assert_array_equal(
                    jpeg.decode_jpeg(data), _pil(data),
                    err_msg=f"{h}x{w} {coding} band {band}")


def test_large_frame_decodes_in_a_few_bytes_a_pixel():
    """A 2048^2 4:2:0 frame of DC-only blocks (a 66 KB file): the decoder
    holds the coefficients, the planes and the output, about 4.5 bytes a
    pixel, plus bands and IDCT chunks of bounded size, not int64 planes
    of the whole image."""
    side = 2048
    data = _encode(Image.fromarray(np.full((side, side, 3), (90, 140, 200),
                                           np.uint8)),
                   quality=75, subsampling=2)
    assert len(data) < 1 << 17
    jpeg._huffman.cache_clear()     # the tables' build is traced too
    tracemalloc.start()
    try:
        got = jpeg.decode_jpeg(data)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert peak < 6 * side * side + (16 << 20), peak / side ** 2
    np.testing.assert_array_equal(got, _pil(data))


def test_huffman_tables_share_equal_entries():
    """A 16-bit lookahead table is 65536 references to far fewer tuples
    (a few MB each otherwise), and at most 8 tables stay cached."""
    data = _encode(_content(64, 64, 5), quality=75, optimize=True)
    head = data[:data.index(b"\xff\xda")]
    dcs, acs = {}, {}
    pos = head.find(b"\xff\xc4")
    while pos >= 0:
        jpeg._parse_dht(jpeg._segment(head, pos)[0], dcs, acs)
        pos = head.find(b"\xff\xc4", pos + 2)
    tables = [h.dc for h in dcs.values()] + [h.ac for h in acs.values()]
    assert len(dcs) == len(acs) == 2
    for t in tables:
        assert len(t) == 65536
        assert len({id(e) for e in t}) == len(set(t)) < 4096
    assert jpeg._huffman.cache_info().maxsize == 8


def test_idct_islow_range_limit_table():
    """Flat blocks from DC alone: the IDCT output is the level-shifted,
    range-limited DC/8, as libjpeg's table gives it."""
    coef = np.zeros((5, 64), np.int64)
    coef[:, 0] = [-2000, -1024, 0, 1016, 2000]
    out = jpeg.idct_islow(coef, np.ones(64, np.int64))
    np.testing.assert_array_equal(out[:, 0, 0], [0, 0, 128, 255, 255])
    assert (out == out[:, :1, :1]).all()


# ---------------------------------------------------------------------------
# committed fixtures
# ---------------------------------------------------------------------------

FIXTURE_NAMES = ["gray", "444", "422", "420", "progressive", "restart",
                 "photo_512_420"]


@pytest.mark.parametrize("name", FIXTURE_NAMES)
def test_committed_fixture_equals_pil_and_port(name):
    data = (FIXTURES / f"{name}.jpg").read_bytes()
    with open(FIXTURES / f"{name}.png", "rb") as f:
        committed = png.decode_png(f.read())
    np.testing.assert_array_equal(committed, _pil(data))
    np.testing.assert_array_equal(jpeg.decode_jpeg(data), committed)
    np.testing.assert_array_equal(image.decode_image(data), committed)


def test_fixture_set_is_small():
    total = sum(p.stat().st_size for p in FIXTURES.iterdir())
    assert total < 600_000, total


# ---------------------------------------------------------------------------
# what is refused
# ---------------------------------------------------------------------------

def _patch(data: bytes, marker: int, offset: int, value: bytes) -> bytes:
    """Overwrite ``value`` at ``offset`` into the body of the first
    segment with this marker."""
    i = data.index(bytes([0xFF, marker]))
    j = i + 4 + offset
    return data[:j] + value + data[j + len(value):]


def _sof(data):
    for m in (0xC0, 0xC1, 0xC2):
        if bytes([0xFF, m]) in data:
            return m
    raise AssertionError("no SOF")


BASE = _encode(_content(24, 32, 1), quality=75, subsampling=0)


def _sampling(data, factors):
    m = _sof(data)
    out = data
    for ci, hv in enumerate(factors):
        out = _patch(out, m, 6 + 3 * ci + 1, bytes([hv]))
    return out


def _smoothing_file():
    """A progressive file cut after its DC and first AC scans, with EOI
    appended: the refinement scans never arrive."""
    data = _encode(_content(32, 32, 2), quality=90, progressive=True)
    sos = [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"]
    return data[:sos[2]] + b"\xff\xd9"


UNSUPPORTED = {
    "cmyk": (lambda: _encode(Image.fromarray(np.full((8, 8, 4), 90, np.uint8),
                                             "CMYK")), "CMYK"),
    "411": (lambda: _sampling(BASE, [0x41, 0x11, 0x11]), "sampling"),
    "440": (lambda: _sampling(BASE, [0x12, 0x11, 0x11]), "sampling"),
    "adobe": (lambda: BASE[:2] + b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00"
              b"\x00\x00\x01" + BASE[2:], "Adobe"),
    "arithmetic": (lambda: BASE.replace(b"\xff\xc0", b"\xff\xc9", 1),
                   "arithmetic"),
    "lossless": (lambda: BASE.replace(b"\xff\xc0", b"\xff\xc3", 1),
                 "lossless"),
    "hierarchical": (lambda: BASE.replace(b"\xff\xc0", b"\xff\xc5", 1),
                     "hierarchical"),
    "12bit": (lambda: _patch(BASE, 0xC0, 0, b"\x0c"), "12-bit"),
    "dnl": (lambda: _patch(BASE, 0xC0, 1, b"\x00\x00"), "DNL"),
    "bomb": (lambda: _patch(BASE, 0xC0, 1, struct.pack(">HH", 65000, 65000)),
             "decompression-bomb"),
    "truncated_scan": (lambda: BASE[:len(BASE) // 2], "truncated"),
    "truncated_header": (lambda: BASE[:40], "truncated"),
    "no_eoi": (lambda: BASE[:-2], "truncated"),
    "smoothing": (_smoothing_file, "smoothing"),
    "bad_huffman_code": (lambda: BASE[:BASE.index(b"\xff\xda") + 14]
                         + b"\xff\x00" * 64 + b"\xff\xd9", "Huffman"),
    "not_jpeg": (lambda: b"GIF89a" + bytes(20), "not JPEG"),
}


@pytest.mark.parametrize("case", list(UNSUPPORTED))
def test_unsupported_raise_value_error(case):
    make, word = UNSUPPORTED[case]
    data = make()
    with pytest.raises(ValueError, match=word):
        jpeg.decode_jpeg(data)


def test_smoothing_file_is_smoothed_by_pil():
    """The cut progressive file decodes in PIL (with libjpeg's smoothing),
    so raising is the only way not to return a different image."""
    data = _smoothing_file()
    assert _pil(data).shape == (32, 32, 3)


def test_bomb_refused_before_entropy_decoding(monkeypatch):
    called = []
    monkeypatch.setattr(jpeg, "_scan", lambda *a, **k: called.append(1))
    with pytest.raises(ValueError, match="bomb"):
        jpeg.decode_jpeg(UNSUPPORTED["bomb"][0]())
    assert not called


def test_decode_image_dispatch():
    arr = np.random.RandomState(0).randint(0, 255, (9, 11, 3)).astype(
        np.uint8)
    np.testing.assert_array_equal(image.decode_image(png.encode_png(arr)), arr)
    np.testing.assert_array_equal(image.decode_image(BASE), _pil(BASE))
    with pytest.raises(ValueError, match="PNG or JPEG"):
        image.decode_image(b"BM" + bytes(40))
    with pytest.raises(ValueError):
        image.decode_image(BASE[:30])


# ---------------------------------------------------------------------------
# the server and the CLI take JPEG
# ---------------------------------------------------------------------------

from tests.test_torch_server import (SIZE as SERVER_SIZE, _payload,  # noqa: E402
                                     _post, _start, pipes)  # noqa: F401
from blobctrl_torch.apps import server as tserver  # noqa: E402


def _jpeg_b64(arr, **opts):
    return base64.b64encode(_encode(Image.fromarray(arr), **opts)).decode()


def test_server_jpeg_request_equals_png_request(pipes):  # noqa: F811
    _, tpipe = pipes
    url, _, httpd = _start(tserver, tpipe)
    try:
        rs = np.random.RandomState(5)
        fg = rs.randint(0, 255, (SERVER_SIZE, SERVER_SIZE, 3)).astype(np.uint8)
        bg = rs.randint(0, 255, (SERVER_SIZE, SERVER_SIZE, 3)).astype(np.uint8)
        req = _payload(seed=3)
        fj, bj = _jpeg_b64(fg, quality=80), _jpeg_b64(bg, quality=60,
                                                      progressive=True)
        pj = dict(req, fg_image=fj, bg_image=bj)
        fg_px = _pil(base64.b64decode(fj))
        bg_px = _pil(base64.b64decode(bj))
        pp = dict(req, fg_image=base64.b64encode(png.encode_png(fg_px))
                  .decode(), bg_image=base64.b64encode(png.encode_png(bg_px))
                  .decode())
        s1, r1 = _post(url + "/v1/edit", pj)
        s2, r2 = _post(url + "/v1/edit", pp)
        assert s1 == 200 and s2 == 200, (r1, r2)
        assert r1["images"] == r2["images"]
        bad = base64.b64encode(base64.b64decode(fj)[:300]).decode()
        s3, r3 = _post(url + "/v1/edit", dict(req, fg_image=bad))
        assert s3 == 400 and "fg_image" in r3["error"], r3
        cmyk = base64.b64encode(UNSUPPORTED["cmyk"][0]()).decode()
        s4, r4 = _post(url + "/v1/edit", dict(req, bg_image=cmyk))
        assert s4 == 400 and "CMYK" in r4["error"], r4
    finally:
        httpd.shutdown()
        httpd.server_close()


from tests.test_torch_cli import _direct, models_root  # noqa: E402,F401
from tests.test_torch_cli import pipe as cli_pipe  # noqa: E402,F401
from blobctrl_torch.apps import cli  # noqa: E402
from blobctrl_torch.blob import math as tmath  # noqa: E402


def test_cli_reads_jpeg_object_and_gray_jpeg_mask(models_root, cli_pipe,  # noqa: F811
                                                  tmp_path):
    rs = np.random.RandomState(8)
    obj = rs.randint(0, 255, (64, 64, 3)).astype(np.uint8)
    orig = rs.randint(0, 255, (64, 64, 3)).astype(np.uint8)
    yy, xx = np.mgrid[:64, :64]
    mask = np.where(((xx - 32) / 12.0) ** 2 + ((yy - 30) / 8.0) ** 2 <= 1.0,
                    255, 0).astype(np.uint8)
    paths = {}
    for name, arr in (("object", obj), ("original", orig), ("mask", mask)):
        paths[name] = str(tmp_path / f"{name}.jpg")
        Image.fromarray(arr).save(paths[name], "JPEG", quality=85)
    assert Image.open(paths["mask"]).mode == "L"
    # the gray mask comes back unchanged through to_luma, as PIL's
    # convert("L") leaves a mode-L image
    luma = np.asarray(Image.open(paths["mask"]).convert("L"))
    np.testing.assert_array_equal(cli.to_luma(cli.read_image(paths["mask"])),
                                  luma)
    args = cli.build_parser().parse_args([
        "--models_root", models_root, "--device", "cpu",
        "--object_image", paths["object"], "--original_image",
        paths["original"], "--ellipse_mask", paths["mask"],
        "--scene_prompt", "an empty table", "--ellipse", "32,30,14,22,35",
        "--remove", "--num_inference_steps", "2", "--dtype", "f32",
        "--scheduler", "ddim", "--output_dir", str(tmp_path / "out")])
    outs = cli.run(args)
    obj_px = np.asarray(Image.open(paths["object"]).convert("RGB"))
    orig_px = np.asarray(Image.open(paths["original"]).convert("RGB"))
    bg = np.where((luma > 0)[..., None], 255, orig_px).astype(np.uint8)
    want = _direct(cli_pipe, prompt=["an empty table"], negative_prompt=None,
                   fg_image=obj_px, bg_image=bg,
                   gs_score=tmath.removal_score((8, 8)).numpy(),
                   blobnet_conditioning_scale=0.0, scheduler="ddim")
    with open(outs[0], "rb") as f:
        np.testing.assert_array_equal(png.decode_png(f.read()), want[0])
    assert os.path.getsize(outs[0]) > 0
