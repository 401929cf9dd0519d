"""The port's HTTP server (``blobctrl_torch.apps.server``) against the JAX
package's, fp32 on the CPU: both serve the same tiny weights (the JAX
server test's ``flagship.tiny_configs(dino_c=16, ctx=16)`` and VAE, BlobNet's
taps drawn nonzero, size 64) on port 0 of 127.0.0.1 and take the same
request suite: health, info keys, 404, 413, the validation 400s, the
cold-shape and cold-graph 400s, a preview refused when disabled, and one
edit and one remove edit each, whose decoded images meet the uint8 bar
(<= 1 level at >= 99.9 % of pixels, <= 2 everywhere). Both draw their
noise from each request's seed, each package by its own code.

Then the port alone: a ``max_batch=4`` server runs four concurrent
compatible requests as one batch, each equal to its solo edit to the bar;
an error inside a batch reaches every waiter and the batcher survives; a
preview request returns its thumbnails and ``/v1/progress`` shows the
edit's steps while it runs; ``main`` refuses a ``--mesh`` of more ranks
than cards and, without CUDA, the card."""

import base64
import dataclasses
import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from blobctrl_tpu.apps import flagship as jflagship
from blobctrl_tpu.apps import server as jserver
from blobctrl_tpu.models import blobnet as jblobnet
from blobctrl_tpu.models import unet as junet
from blobctrl_tpu.models import vae as jvae
from blobctrl_tpu.pipeline import BlobNetPipeline as JPipeline
from blobctrl_torch.apps import server as tserver
from blobctrl_torch.models import blobnet as tblobnet
from blobctrl_torch.models import unet as tunet
from blobctrl_torch.models import vae as tvae
from blobctrl_torch.params.from_jax import from_jax
from blobctrl_torch.pipeline import BlobNetPipeline as TPipeline
from blobctrl_torch.utils import png
from tests.test_torch_png import bomb
from tests.test_torch_session import _assert_u8_close, _with_taps

torch.set_num_threads(2)

SIZE = 64


@pytest.fixture(scope="module")
def pipes():
    key = jax.random.PRNGKey(0)
    ju, jb = jflagship.tiny_configs(dino_c=16, ctx=16)
    jv = jvae.VAEConfig(block_out_channels=(8, 16, 16, 16),
                        layers_per_block=1, norm_num_groups=4)
    p = dict(unet=junet.init_unet(key, ju),
             blobnet=_with_taps(jblobnet.init_blobnet(key, jb)),
             vae=jvae.init_vae(key, jv))
    jpipe = JPipeline(unet_cfg=ju, unet_params=p["unet"], blobnet_cfg=jb,
                      blobnet_params=p["blobnet"], vae_cfg=jv,
                      vae_params=p["vae"])
    t = {k: from_jax(v, device="cpu") for k, v in p.items()}
    tpipe = TPipeline(
        unet_cfg=tunet.UNetConfig(**dataclasses.asdict(ju)),
        unet_params=t["unet"],
        blobnet_cfg=tblobnet.BlobNetConfig(**dataclasses.asdict(jb)),
        blobnet_params=t["blobnet"],
        vae_cfg=tvae.VAEConfig(**dataclasses.asdict(jv)), vae_params=t["vae"],
        device="cpu")
    return jpipe, tpipe


def _start(lib, pipe, **kw):
    service, httpd = lib.serve(pipe, host="127.0.0.1", port=0, size=SIZE,
                               warmup_steps=None, **kw)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{httpd.server_address[1]}", service, httpd


@pytest.fixture(scope="module")
def servers(pipes):
    jpipe, tpipe = pipes
    started = {"jax": _start(jserver, jpipe), "port": _start(tserver, tpipe)}
    yield {k: v[:2] for k, v in started.items()}
    for _, _, httpd in started.values():
        httpd.shutdown()
        httpd.server_close()


def _b64(arr):
    return base64.b64encode(png.encode_png(arr)).decode()


def _get(url):
    try:
        with urllib.request.urlopen(url) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _post(url, payload, headers=None):
    body = payload if isinstance(payload, bytes) else json.dumps(
        payload).encode()
    req = urllib.request.Request(url, body, {
        "Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _payload(seed=7, angle=15.0, steps=2, img_seed=0):
    rng = np.random.RandomState(img_seed)
    img = rng.randint(0, 255, (SIZE, SIZE, 3)).astype(np.uint8)
    bg = rng.randint(0, 255, (SIZE, SIZE, 3)).astype(np.uint8)
    return {"fg_image": _b64(img), "bg_image": _b64(bg),
            "ellipse": [32, 32, 20, 28, angle], "num_inference_steps": steps,
            "seed": seed, "size": SIZE,
            "prompt_embeds": rng.randn(1, 7, 16).tolist(),
            "negative_prompt_embeds": rng.randn(1, 7, 16).tolist(),
            "fg_dino_feats": rng.randn(1, 16).tolist()}


def _image(b64):
    return png.decode_png(base64.b64decode(b64)).astype(np.float32) / 255.0


IMG = _b64(np.random.RandomState(0).randint(0, 255, (SIZE, SIZE, 3))
           .astype(np.uint8))
EMB = {"prompt_embeds": np.zeros((1, 7, 16)).tolist(),
       "negative_prompt_embeds": np.zeros((1, 7, 16)).tolist(),
       "fg_dino_feats": np.zeros((1, 16)).tolist()}
# name -> (request, expected status, a word the error names)
SUITE = {
    "empty body": ({}, 400, "fg_image"),
    "short ellipse": ({"fg_image": IMG, "bg_image": IMG, "size": SIZE,
                       "ellipse": [1, 2, 3]}, 400, "ellipse"),
    "no blob": ({"fg_image": IMG, "bg_image": IMG, "size": SIZE}, 400,
                "ellipse"),
    "unknown scheduler": (dict(EMB, fg_image=IMG, bg_image=IMG, size=SIZE,
                               ellipse=[32, 32, 20, 28, 0],
                               scheduler="dpmsolver"), 400, "dpm"),
    "garbage image": ({"fg_image": base64.b64encode(b"not an image").decode(),
                       "bg_image": IMG, "size": SIZE, "remove": True}, 400,
                      "fg_image"),
    "bad base64": ({"fg_image": "%%%", "bg_image": IMG, "size": SIZE,
                    "remove": True}, 400, "fg_image"),
    "too many samples": ({"fg_image": IMG, "bg_image": IMG, "size": SIZE,
                          "remove": True, "num_samples": 99}, 400,
                         "num_samples"),
    "zero steps": ({"fg_image": IMG, "bg_image": IMG, "size": SIZE,
                    "remove": True, "num_inference_steps": 0}, 400,
                   "num_inference_steps"),
    "bad embeds": ({"fg_image": IMG, "bg_image": IMG, "size": SIZE,
                    "ellipse": [32, 32, 20, 28, 0],
                    "prompt_embeds": np.zeros((1, 7, 5)).tolist()}, 400,
                   "prompt_embeds"),
    "bad dino feats": (dict(EMB, fg_image=IMG, bg_image=IMG, size=SIZE,
                            ellipse=[32, 32, 20, 28, 0],
                            fg_dino_feats=np.zeros((3, 16)).tolist()), 400,
                       "fg_dino_feats"),
    "preview disabled": (dict(_payload(), preview=True), 400, "preview"),
}
# with warm pinning at 2 steps
COLD = {
    "cold steps": ({"num_inference_steps": 7}, "warm-compiled"),
    "cold size": ({"size": 32}, "size"),
    "cold scheduler": ({"scheduler": "ddim"}, "scheduler"),
    "cold samples": ({"num_samples": 2}, "num_samples"),
    "cold encoder cache": ({"encoder_cache_interval": 3},
                           "encoder_cache_interval"),
    "cold preview+remove": ({"preview": True}, "preview+remove"),
}


def test_health_info_and_not_found(servers):
    infos = {}
    for name, (base, _) in servers.items():
        assert _get(base + "/healthz") == (200, b"ok")
        code, body = _get(base + "/v1/info")
        assert code == 200
        infos[name] = json.loads(body)
        assert _get(base + "/nope")[0] == 404
        assert _post(base + "/v1/bogus", {})[0] == 404
        code, prog = _get(base + "/v1/progress")
        assert json.loads(prog) == {"active": False, "step": None,
                                    "total": None}
    assert set(infos["port"]) == set(infos["jax"])
    for k in ("size", "schedulers", "warm", "warm_steps", "strict_shapes",
              "max_body_bytes", "max_samples", "max_batch", "preview_every",
              "mesh", "hybrid_cfg_data"):
        assert infos["port"][k] == infos["jax"][k], k
    assert infos["port"]["device"] == "cpu"


def test_body_limit_413(servers):
    for base, service in servers.values():
        code, resp = _post(base + "/v1/edit", b"x" * 64, {
            "Content-Length": str(service.max_body_bytes + 1)})
        assert code == 413 and "limit" in resp["error"]


@pytest.mark.parametrize("name", list(SUITE))
def test_validation_matches_jax(servers, name):
    payload, status, word = SUITE[name]
    for base, _ in servers.values():
        code, resp = _post(base + "/v1/edit", payload)
        assert code == status and word in resp["error"], (name, resp)


@pytest.mark.parametrize("kind", ["data", "header"])
def test_port_server_refuses_image_bombs_with_400(servers, kind):
    """The port's decoder refuses a decompression bomb, so the request is a
    400 (the JAX server's PIL raises DecompressionBombError on the header
    bomb, which its handler does not map to a 400)."""
    base, _ = servers["port"]
    code, resp = _post(base + "/v1/edit", {
        "fg_image": base64.b64encode(bomb(kind)).decode(), "bg_image": IMG,
        "size": SIZE, "remove": True})
    assert code == 400 and "fg_image" in resp["error"], resp


@pytest.mark.parametrize("name", list(COLD))
def test_cold_shapes_and_graphs_refused(servers, name):
    change, word = COLD[name]
    payload = dict(EMB, fg_image=IMG, bg_image=IMG, size=SIZE, remove=True,
                   num_inference_steps=2)
    payload.update(change)
    for base, service in servers.values():
        service.warm_steps = 2     # as after a warmup at 2 steps
        try:
            code, resp = _post(base + "/v1/edit", payload)
        finally:
            service.warm_steps = None
        assert code == 400 and word in resp["error"], (name, resp)


@pytest.fixture(scope="module")
def edits(servers):
    out = {}
    for name, (base, _) in servers.items():
        out[name] = {}
        for kind, payload in (("edit", _payload()),
                              ("remove", {k: v for k, v in dict(
                                  _payload(), remove=True).items()
                                  if k != "ellipse"})):
            code, resp = _post(base + "/v1/edit", payload)
            assert code == 200, resp
            out[name][kind] = resp
    return out


@pytest.mark.parametrize("kind", ["edit", "remove"])
def test_edits_match_jax(edits, kind):
    j, t = edits["jax"][kind], edits["port"][kind]
    assert set(t) == set(j) == {"images", "seconds"}
    assert len(t["images"]) == len(j["images"]) == 1
    got, want = _image(t["images"][0]), _image(j["images"][0])
    assert got.shape == want.shape == (SIZE, SIZE, 3)
    _assert_u8_close(got, want, kind)


@pytest.fixture(scope="module")
def batch_server(pipes):
    _, tpipe = pipes
    base, service, httpd = _start(tserver, tpipe, max_batch=4,
                                  batch_window_ms=3000.0)
    yield base, service
    httpd.shutdown()
    httpd.server_close()


def _concurrent(url, payloads):
    results = [None] * len(payloads)

    def worker(i):
        results[i] = _post(url, payloads[i])
    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(payloads))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    return results


def test_four_concurrent_requests_run_as_one_batch(batch_server, servers):
    base, service = batch_server
    payloads = [_payload(seed=40 + i, angle=10.0 * i, img_seed=i)
                for i in range(4)]
    results = _concurrent(base + "/v1/edit", payloads)
    for code, resp in results:
        assert code == 200, resp
        assert resp["batch_size"] == 4
    assert service.batches_run == 1 and service.batched_requests == 4
    assert len({r[1]["images"][0] for r in results}) == 4
    solo_base = servers["port"][0]
    for i, (payload, (_, resp)) in enumerate(zip(payloads, results)):
        code, solo = _post(solo_base + "/v1/edit", payload)
        assert code == 200 and "batch_size" not in solo
        _assert_u8_close(_image(resp["images"][0]), _image(solo["images"][0]),
                         f"batched row {i}")


def test_batch_error_reaches_every_waiter(batch_server):
    base, service = batch_server
    real = service.pipeline.edit_batch

    def boom(*a, **k):
        raise RuntimeError("synthetic device failure")
    service.pipeline.edit_batch = boom
    try:
        results = _concurrent(base + "/v1/edit",
                              [_payload(seed=1), _payload(seed=2)])
    finally:
        del service.pipeline.edit_batch
    assert service.pipeline.edit_batch == real
    for code, resp in results:
        assert code == 500 and "synthetic device failure" in resp["error"]
    code, resp = _post(base + "/v1/edit", _payload(seed=1))
    assert code == 200 and resp["batch_size"] == 1


def test_preview_and_progress(pipes):
    _, tpipe = pipes
    base, service, httpd = _start(tserver, tpipe, preview_every=2)
    seen = []
    real = TPipeline._emit_step_callback

    def probing(pipe_self, cb, i, t, latents):
        real(pipe_self, cb, i, t, latents)
        code, body = _get(base + "/v1/progress")
        seen.append(json.loads(body))
    try:
        TPipeline._emit_step_callback = probing
        code, plain = _post(base + "/v1/edit", _payload(steps=4))
        assert code == 200 and "previews" not in plain and not seen
        code, resp = _post(base + "/v1/edit", dict(_payload(steps=4),
                                                   preview=True))
    finally:
        TPipeline._emit_step_callback = real
        httpd.shutdown()
        httpd.server_close()
    assert code == 200, resp
    assert resp["images"] == plain["images"]
    assert resp["preview_steps"] == [0, 2, 3]
    for b64 in resp["previews"]:
        assert png.decode_png(base64.b64decode(b64)).shape == (16, 16, 3)
    assert [s["step"] for s in seen] == [1, 3, 4]
    assert all(s["active"] and s["total"] == 4 for s in seen)
    assert service.progress == {"active": False, "step": None, "total": None}


def test_main_refuses_mesh_and_needs_the_card(monkeypatch):
    if torch.cuda.device_count() < 2:
        with pytest.raises(SystemExit, match="needs 2 cards"):
            tserver.main(["--mesh", "data=2,model=1"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tserver.main(["--models_root", "nowhere", "--no_warmup"])
