"""``--mesh`` in the port's CLI and server on the CPU (gloo ranks spawned by
the entry point itself; this process is rank 0), on the tiny models root of
``test_torch_cli``:

  * ``apps.cli --mesh data=2`` and ``--mesh data=1,model=2`` write the
    images the unsharded CLI writes, within the uint8 bar (PERF.md §2);
  * a server at data=2 reports its mesh in ``/v1/info``, answers a solo
    request (``__call__`` replicated over the data ranks) and a batch of 2
    whose rows run one on each rank (rank 0 denoises one row, the images
    are gathered), each within the bar of an unsharded server's answer;
    ``close()`` joins the followers;
  * a request the pipeline refuses by its arguments (an unknown scheduler
    on a server that takes cold shapes) is a 400 on the mesh as it is
    unsharded, solo or batched, and the mesh serves the next request;
  * a follower that stops answering turns the edit in flight into a 500
    within the group timeout, and every later edit into a 500 at once."""

import base64
import json
import os
import signal
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from blobctrl_torch.apps import cli, server
from blobctrl_torch.parallel import collectives
from blobctrl_torch.params import io as tio
from blobctrl_torch.utils import png
from tests.test_torch_cli import SIZE, _read, inputs, models_root  # noqa: F401
from tests.test_torch_session import _assert_u8_close

torch.set_num_threads(2)

# the mesh servers' collective timeouts: the healthy one's leaves room for
# a follower that lags behind rank 0 on a loaded host (its replicated solo
# edits have no collective to wait at); the stalled one's is what the
# test waits for
HEALTHY_TIMEOUT_S = 300.0
TIMEOUT_S = 10.0


def _cli_args(models_root, paths, out):
    return ["--models_root", models_root, "--object_image", paths["object"],
            "--edited_background", paths["background"], "--scene_prompt",
            "a red ball", "--ellipse", "30,32,20,26,15", "--device", "cpu",
            "--dtype", "f32", "--num_inference_steps", "2", "--output_dir",
            out]


@pytest.mark.parametrize("mesh", ["data=2", "data=1,model=2"])
def test_cli_mesh_writes_the_unsharded_image(models_root, inputs,  # noqa: F811
                                             tmp_path, mesh):
    paths, _ = inputs
    plain = cli.run(cli.build_parser().parse_args(
        _cli_args(models_root, paths, str(tmp_path / "plain"))))
    sharded = cli.run(cli.build_parser().parse_args(
        _cli_args(models_root, paths, str(tmp_path / "mesh"))
        + ["--mesh", mesh]))
    assert [os.path.basename(p) for p in sharded] == ["edit_0.png"]
    want, got = _read(plain[0]), _read(sharded[0])
    assert got.shape == want.shape == (SIZE, SIZE, 3)
    _assert_u8_close(got / 255.0, want / 255.0, f"cli --mesh {mesh}")


def _b64(arr):
    return base64.b64encode(png.encode_png(arr)).decode()


def _post(url, payload):
    req = urllib.request.Request(url + "/v1/edit",
                                 data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _payload(arrays, seed, **kw):
    return dict(prompt="a red ball", fg_image=_b64(arrays["object"]),
                bg_image=_b64(arrays["background"]),
                ellipse=[30, 32, 20, 26, 15], seed=seed, size=SIZE,
                num_inference_steps=2, **kw)


def _serve(pipe):
    svc, httpd = server.serve(pipe, "127.0.0.1", 0, size=SIZE,
                              warmup_steps=None, max_batch=2,
                              batch_window_ms=500.0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return svc, httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def _images(resp):
    return np.stack([png.decode_png(base64.b64decode(b)) / 255.0
                     for b in resp["images"]])


def _run(url, arrays):
    """-> (the solo remove request's images, the two batched requests'
    images in request order, their batch sizes)."""
    code, solo = _post(url, _payload(arrays, 3, remove=True))
    assert code == 200, solo
    out = [None, None]

    def one(i):
        out[i] = _post(url, _payload(arrays, 10 + i))
    threads = [threading.Thread(target=one, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    assert all(c == 200 for c, _ in out), out
    return (_images(solo), [_images(r) for _, r in out],
            [r["batch_size"] for _, r in out])


def test_server_at_data_2(models_root, inputs):  # noqa: F811
    _, arrays = inputs
    plain_pipe = tio.load_pipeline(models_root, dtype=torch.float32,
                                   device="cpu")
    svc, httpd, url = _serve(plain_pipe)
    try:
        want_solo, want_batch, _ = _run(url, arrays)
    finally:
        httpd.shutdown()
        svc.close()

    pipe = server.start_mesh(models_root, "cpu", "data=2", False,
                             dtype=torch.float32,
                             timeout_s=HEALTHY_TIMEOUT_S)
    rows = []
    denoise = pipe.pipeline._denoise

    def spy(sched, latents, *a, **k):
        rows.append(latents.shape[0])
        return denoise(sched, latents, *a, **k)
    pipe.pipeline._denoise = spy
    svc, httpd, url = _serve(pipe)
    try:
        with urllib.request.urlopen(url + "/v1/info", timeout=30) as r:
            info = json.loads(r.read())
        assert info["mesh"] == {"data": 2, "model": 1}
        assert info["hybrid_cfg_data"] is False
        mark = collectives.mark()
        got_solo, got_batch, sizes = _run(url, arrays)
        log = collectives.counts(collectives.since(mark))
    finally:
        httpd.shutdown()
        svc.close()
    procs = pipe.followers.procs
    assert all(not p.is_alive() and p.exitcode == 0 for p in procs)
    _assert_u8_close(got_solo, want_solo, "solo on the mesh")
    for i in (0, 1):
        _assert_u8_close(got_batch[i], want_batch[i], f"batched row {i}")
    # the solo edit ran whole (one row); the batch of 2 split its rows: one
    # here, one on rank 1, the images gathered
    assert sizes == [2, 2] and rows == [1, 1], (sizes, rows)
    assert log == {"pipeline": {"all_gather": 1}}, log


def test_a_refused_request_leaves_the_mesh_serving(models_root,  # noqa: F811
                                                  inputs):  # noqa: F811
    _, arrays = inputs
    pipe = server.start_mesh(models_root, "cpu", "data=2", False,
                             dtype=torch.float32,
                             timeout_s=HEALTHY_TIMEOUT_S)
    svc, httpd, url = _serve(pipe)   # no warmup: cold shapes are taken
    try:
        code, resp = _post(url, _payload(arrays, 3, scheduler="nope"))
        assert code == 400 and "unknown scheduler" in resp["error"], resp
        # two at once (a batch of 2 through edit_batch), their seeds left
        # for the ranks to agree on
        out = [None, None]

        def one(i):
            out[i] = _post(url, _payload(arrays, None, scheduler="nope"))
        threads = [threading.Thread(target=one, args=(i,)) for i in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        assert [c for c, _ in out] == [400, 400], out
        assert pipe.failed is None
        code, resp = _post(url, _payload(arrays, 3, remove=True))
        assert code == 200, resp
        assert all(p.is_alive() for p in pipe.followers.procs)
    finally:
        httpd.shutdown()
        svc.close()
    assert all(p.exitcode == 0 for p in pipe.followers.procs)


def test_a_stalled_follower_fails_the_edit_within_the_timeout(
        models_root, inputs):  # noqa: F811
    _, arrays = inputs
    pipe = server.start_mesh(models_root, "cpu", "data=2", False,
                             dtype=torch.float32, timeout_s=TIMEOUT_S)
    svc, httpd, url = _serve(pipe)
    follower = pipe.followers.procs[0]
    try:
        code, _ = _post(url, _payload(arrays, 3, remove=True))
        assert code == 200
        os.kill(follower.pid, signal.SIGSTOP)  # alive, but answers nothing
        # a batch of 2 splits its rows: rank 0 waits in the images' gather
        out = [None, None]

        def one(i):
            out[i] = _post(url, _payload(arrays, 10 + i))
        t0 = time.monotonic()
        threads = [threading.Thread(target=one, args=(i,)) for i in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT_S + 60.0)
        took = time.monotonic() - t0
        assert [c for c, _ in out] == [500, 500], out
        assert took < TIMEOUT_S + 45.0, took
        os.kill(follower.pid, signal.SIGKILL)
        t0 = time.monotonic()
        code, resp = _post(url, _payload(arrays, 5, remove=True))
        assert code == 500 and "mesh failed" in resp["error"], resp
        assert time.monotonic() - t0 < 5.0
    finally:
        if follower.is_alive():
            os.kill(follower.pid, signal.SIGKILL)
        httpd.shutdown()
        svc.close()
    assert not follower.is_alive()
