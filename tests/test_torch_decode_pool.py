"""The port's server decodes request images in worker processes
(``apps.server.DecodePool``), not on the handler thread.

* The handler thread's CPU time (``time.thread_time``) across ``_parse`` of
  a request whose fg_image is a 2048^2 JPEG (written by PIL here) stays
  below 10 % of the CPU time of the same decode in-process: the pure-Python
  decoder would otherwise hold the interpreter lock for that long. A CPU
  time, not a wall time, so the bar holds on a loaded machine.
* Every file of ``tests/data/jpeg`` (the JPEG fixtures and the PNGs beside
  them) decodes through the workers bit-equal to the in-process decode; a
  truncated JPEG and a decompression bomb are still ValueErrors (400s)
  with the in-process message.
* A worker that dies fails its request with a 500 over HTTP, the pool is
  replaced, and the next request decodes; nothing decodes in-process."""

import base64
import io
import json
import os
import signal
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

from blobctrl_torch.apps import server
from blobctrl_torch.utils import image, png
from tests.test_torch_png import bomb

FIXTURES = os.path.join(os.path.dirname(__file__), "data", "jpeg")
STUB = types.SimpleNamespace(
    unet_cfg=types.SimpleNamespace(cross_attention_dim=16))
SMALL = base64.b64encode(png.encode_png(
    np.full((8, 8, 3), 200, np.uint8))).decode()


def big_jpeg(size=2048) -> bytes:
    """A textured size^2 photo-like JPEG (PIL, quality 90)."""
    from PIL import Image
    yy, xx = np.mgrid[:size, :size]
    base = np.stack([xx * 255 // (size - 1), yy * 255 // (size - 1),
                     (xx + yy) % 256], -1).astype(np.float32)
    noise = np.random.RandomState(0).randn(size, size, 3) * 12
    img = np.clip(base + noise, 0, 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", quality=90)
    return buf.getvalue()


def request(fg_b64, bg_b64=SMALL):
    return {"fg_image": fg_b64, "bg_image": bg_b64, "size": 64,
            "ellipse": [32, 32, 20, 28, 0]}


@pytest.fixture(scope="module")
def service():
    svc = server.EditService(STUB, size=64)
    # both workers up, and _parse's one-time module imports done, before
    # anything is timed
    assert svc.decoder.start() > 0
    svc._parse(request(SMALL))
    yield svc
    svc.close()


def test_handler_thread_does_not_decode(service):
    data = big_jpeg()
    c0 = time.thread_time()
    want = image.decode_image(data)
    in_process = time.thread_time() - c0
    req = request(base64.b64encode(data).decode())
    c0 = time.thread_time()
    per, _, _ = service._parse(req)
    handler = time.thread_time() - c0
    assert np.array_equal(per["fg_image"], want)
    assert handler < 0.1 * in_process, (handler, in_process)
    assert service.last_decode[0] <= handler


def test_fixtures_decode_bit_equal_through_the_workers(service):
    names = sorted(os.listdir(FIXTURES))
    assert sum(n.endswith(".jpg") for n in names) >= 7
    assert sum(n.endswith(".png") for n in names) >= 7
    items = []
    for n in names:
        with open(os.path.join(FIXTURES, n), "rb") as f:
            items.append((base64.b64encode(f.read()).decode(), n))
    got = service.decoder.decode(items)
    for (_, n), arr in zip(items, got):
        want = image.read_image(os.path.join(FIXTURES, n))
        assert arr.dtype == np.uint8 and np.array_equal(arr, want), n


@pytest.mark.parametrize("kind", ["truncated", "bomb"])
def test_decoder_errors_keep_their_message(service, kind):
    if kind == "truncated":
        with open(os.path.join(FIXTURES, "photo_512_420.jpg"), "rb") as f:
            data = f.read()
        data = data[:len(data) // 2]
    else:
        data = bomb("header")
    b64 = base64.b64encode(data).decode()
    with pytest.raises(ValueError) as want:
        server._decode_image(b64, "fg_image")
    with pytest.raises(ValueError) as got:
        service._parse(request(b64))
    assert str(got.value) == str(want.value)
    assert str(got.value).startswith("fg_image is not decodable")


def _post(url, payload):
    req = urllib.request.Request(url, json.dumps(payload).encode(),
                                 {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_a_dead_worker_answers_500_and_is_replaced():
    svc, httpd = server.serve(STUB, host="127.0.0.1", port=0, size=64,
                              warmup_steps=None)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}/v1/edit"
    try:
        svc.decoder.start()
        pool = svc.decoder._pool
        out = {}
        sender = threading.Thread(target=lambda: out.update(r=_post(
            url, request(base64.b64encode(big_jpeg()).decode()))))
        sender.start()
        deadline = time.monotonic() + 60
        while not pool._pending_work_items:  # the decode is in a worker
            assert time.monotonic() < deadline
            time.sleep(0.005)
        for proc in list(pool._processes.values()):
            os.kill(proc.pid, signal.SIGKILL)
        sender.join(120)
        assert not sender.is_alive()
        code, resp = out["r"]
        assert code == 500 and "decoder process died" in resp["error"]
        assert svc.decoder.replaced == 1 and svc.decoder._pool is not pool
        # the next request decodes in the new pool (then stops at its
        # missing blob, which is checked after the decode)
        svc.last_decode = None
        req = request(SMALL)
        del req["ellipse"]
        code, resp = _post(url, req)
        assert code == 400 and "ellipse" in resp["error"]
        assert svc.last_decode is not None
    finally:
        httpd.shutdown()
        httpd.server_close()
        svc.close()
