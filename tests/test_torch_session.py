"""The interactive editing session of the port against the JAX package's,
on the CPU in fp32 at size 64: the same non-square image, mask and edits
drive both, through tiny random nets with tiny CLIP text and DINOv2, a
byte-level tokenizer, string prompts and object images.

Each session's pipeline is wrapped: the wrapper records the kwargs the
session builds and runs the real pipeline on them, which draws its noise
from the session's seed (the port draws JAX's numbers for it). The test
then holds (1) the editor state, masks and backgrounds, (2) the recorded
kwargs, and (3) the edits, at the exact bar."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from blobctrl_tpu.apps import flagship as jflagship
from blobctrl_tpu.apps import session as jsession
from blobctrl_tpu.blob import viz as jviz
from blobctrl_tpu.models import blobnet as jblobnet
from blobctrl_tpu.models import clip_text as jclip
from blobctrl_tpu.models import dinov2 as jdino
from blobctrl_tpu.models import unet as junet
from blobctrl_tpu.models import vae as jvae
from blobctrl_tpu.pipeline import BlobNetPipeline as JPipeline
from blobctrl_tpu.tokenizer import clip_bpe as jbpe
from blobctrl_torch.apps import flagship as tflagship
from blobctrl_torch.apps import session as tsession
from blobctrl_torch.models import blobnet as tblobnet
from blobctrl_torch.models import unet as tunet
from blobctrl_torch.models import vae as tvae
from blobctrl_torch.params.from_jax import from_jax
from blobctrl_torch.pipeline import BlobNetPipeline as TPipeline
from blobctrl_torch.utils import benchkit

pytest.importorskip("cv2")
pytest.importorskip("PIL")
torch.set_num_threads(2)

SIZE = 64
STEPS = 3
PROMPT = "a red ball on a table"


def _with_taps(tree, seed=7):
    """BlobNet's zero-initialized taps drawn small and nonzero, so its
    residuals reach the UNet."""
    rng = np.random.RandomState(seed)

    def f(x):
        x = np.asarray(x)
        if x.ndim == 4 and not x.any():
            return (rng.randn(*x.shape) * 0.05).astype(np.float32)
        return x
    return jax.tree_util.tree_map(f, tree)


@pytest.fixture(scope="module")
def pipelines():
    keys = jax.random.split(jax.random.PRNGKey(0), 5)
    ju, jb = jflagship.tiny_configs(dino_c=16, ctx=16)
    jv = jvae.VAEConfig(block_out_channels=(8, 16, 16, 16),
                        layers_per_block=1, norm_num_groups=4)
    tc, td = tflagship.tiny_encoder_configs()
    jc = jclip.CLIPTextConfig(**dataclasses.asdict(tc))
    jd = jdino.DINOv2Config(**dataclasses.asdict(td))
    tok = benchkit.byte_level_tokenizer()
    jtok = jbpe.CLIPTokenizer(tok.encoder,
                              sorted(tok.bpe_ranks, key=tok.bpe_ranks.get))
    p = dict(unet=junet.init_unet(keys[0], ju),
             blobnet=_with_taps(jblobnet.init_blobnet(keys[1], jb)),
             vae=jvae.init_vae(keys[2], jv), clip=jclip.init(keys[3], jc),
             dino=jdino.init(keys[4], jd))
    jpipe = JPipeline(unet_cfg=ju, unet_params=p["unet"], blobnet_cfg=jb,
                      blobnet_params=p["blobnet"], vae_cfg=jv,
                      vae_params=p["vae"], clip_cfg=jc, clip_params=p["clip"],
                      dino_cfg=jd, dino_params=p["dino"], tokenizer=jtok,
                      dino_image_size=28)
    t = {k: from_jax(v, device="cpu") for k, v in p.items()}
    tpipe = TPipeline(
        unet_cfg=tunet.UNetConfig(**dataclasses.asdict(ju)),
        unet_params=t["unet"],
        blobnet_cfg=tblobnet.BlobNetConfig(**dataclasses.asdict(jb)),
        blobnet_params=t["blobnet"],
        vae_cfg=tvae.VAEConfig(**dataclasses.asdict(jv)), vae_params=t["vae"],
        clip_cfg=tc, clip_params=t["clip"], dino_cfg=td,
        dino_params=t["dino"], tokenizer=tok, dino_image_size=28,
        device="cpu")
    return jpipe, tpipe


class Recorded:
    """A pipeline that records each call's kwargs and runs the real one
    on them."""

    def __init__(self, pipe):
        self.pipe = pipe
        self.device = getattr(pipe, "device", None)
        self.calls = []

    def __call__(self, **kw):
        self.calls.append(kw)
        return self.pipe(**kw)


def drive(session_lib, pipe):
    """One interactive session; returns what it showed and made."""
    rec = Recorded(pipe)
    s = session_lib.BlobCtrlSession(rec, size=SIZE)
    rng = np.random.RandomState(1)
    img = rng.randint(0, 256, (80, 120, 3)).astype(np.uint8)  # 3:2, resized
    seen = {"image": s.set_image(img)}
    # the mask from the JAX package's raster on both sides (the port's
    # own is held bit-equal to it in test_torch_raster_resample.py)
    s.set_mask(jviz.ellipse_mask(((30.0, 34.0), (22.0, 30.0), 15.0),
                                 SIZE, SIZE))
    seen["blob"] = s.generate_blob()
    seen["fg_image"] = s.fg_image
    s.move(8, -4)
    s.resize(1.2)
    s.rotate(20)
    seen["view"] = s.blob_visualization()
    seen["bg"] = s.build_edited_background()
    seen["ori"] = s.ori_preview_gallery()
    seen["edited"] = s.edited_preview_gallery()
    seen["runs"] = [s.run(PROMPT, num_inference_steps=STEPS)]
    s.move(-3, 2)
    seen["runs"].append(s.run(PROMPT, num_inference_steps=STEPS))
    seen["remove_start"] = s.set_remove_mode(True)
    seen["removal_bg"] = s.build_removal_background()
    seen["runs"].append(s.run(PROMPT, num_inference_steps=STEPS,
                              remove=True))
    s.set_remove_mode(False)
    seen["entries"] = list(s.editor.entries)
    s.undo()
    s.resize_start_blob(1.1)
    seen["after_undo"] = list(s.editor.entries)
    s.reset()
    blobs = [(((20.0, 24.0), (16.0, 24.0), 30.0), s.fg_image),
             (((44.0, 40.0), (18.0, 20.0), 100.0),
              np.full_like(s.fg_image, 255) // 2)]
    seen["runs"].append(s.run_multi(PROMPT, blobs, num_inference_steps=STEPS))
    seen["target"] = s.set_init_ellipse((0.5, 0.4, 0.2, 0.3, 45.0))
    seen["object"] = s.set_object_image(
        rng.randint(0, 256, (70, 50, 3)).astype(np.uint8))
    seen["compositional"] = list(s.editor.entries)
    seen["mask"] = s.mask
    return seen, rec.calls


@pytest.fixture(scope="module")
def sessions(pipelines):
    jpipe, tpipe = pipelines
    return drive(jsession, jpipe), drive(tsession, tpipe)


def _assert_u8_close(a, b, name):
    """The exact bar: <= 1 level at >= 99.9 % of pixels, <= 2 everywhere
    (the two sides sum in other orders in fp32)."""
    qa = np.round(np.asarray(a) * 255).astype(np.int32)
    qb = np.round(np.asarray(b) * 255).astype(np.int32)
    diff = np.abs(qa - qb)
    assert diff.max() <= 2, (name, int(diff.max()))
    assert (diff <= 1).mean() >= 0.999, (name, float((diff <= 1).mean()))


def _ellipses_close(a, b):
    np.testing.assert_allclose(np.hstack([a[0], a[1], a[2]]),
                               np.hstack([b[0], b[1], b[2]]), atol=1e-9,
                               rtol=0)


def test_editor_state_and_images_match(sessions):
    (jseen, _), (tseen, _) = sessions
    np.testing.assert_array_equal(tseen["image"], jseen["image"])
    np.testing.assert_array_equal(tseen["fg_image"], jseen["fg_image"])
    for key in ("entries", "after_undo", "compositional"):
        assert len(tseen[key]) == len(jseen[key])
        for (te, tp, tt), (je, jp, jt) in zip(tseen[key], jseen[key]):
            _ellipses_close(te, je)
            np.testing.assert_allclose(tp, jp, atol=1e-9, rtol=0)
            assert tt == jt
    for key in ("blob", "remove_start", "target"):
        _ellipses_close(tseen[key], jseen[key])
    for key in ("bg", "removal_bg", "object", "mask"):
        np.testing.assert_array_equal(tseen[key], jseen[key], err_msg=key)
    for key in ("ori", "edited"):
        for t, j in zip(tseen[key], jseen[key]):
            np.testing.assert_array_equal(t, j, err_msg=key)
    # the blob view: float truncation to uint8 can flip one level
    diff = np.abs(tseen["view"].astype(int) - jseen["view"].astype(int))
    assert diff.max() <= 1


def test_pipeline_kwargs_equal(sessions):
    (_, jcalls), (_, tcalls) = sessions
    assert len(tcalls) == len(jcalls) == 4
    for tkw, jkw in zip(tcalls, jcalls):
        assert set(tkw) == set(jkw)
        for k, jv in jkw.items():
            tv = tkw[k]
            if k == "gs_score":
                # XLA's and torch's splat of the same Gaussians
                np.testing.assert_allclose(tv, jv, atol=1e-6, rtol=0)
            elif k == "fg_image" and isinstance(jv, list):
                for a, b in zip(tv, jv):
                    np.testing.assert_array_equal(a, b)
            elif isinstance(jv, np.ndarray):
                np.testing.assert_array_equal(tv, jv, err_msg=k)
            else:
                assert tv == jv, (k, tv, jv)


@pytest.mark.parametrize("i,name", [(0, "edit"), (1, "edit after a move"),
                                    (2, "remove"), (3, "two-blob run_multi")])
def test_edits_match_at_the_exact_bar(sessions, i, name):
    (jseen, _), (tseen, _) = sessions
    jr, tr = jseen["runs"][i], tseen["runs"][i]
    assert tr.images.shape == jr.images.shape == (1, SIZE, SIZE, 3)
    _assert_u8_close(tr.images, jr.images, name)
    _ellipses_close(tr.final_ellipse, jr.final_ellipse)
    for t, j in zip(tr.images_with_ellipse, jr.images_with_ellipse):
        diff = np.abs(t.astype(int) - j.astype(int))
        assert diff.max() <= 2 and (diff <= 1).mean() >= 0.999, name


def test_memos_hit_on_repeated_prompt_and_object(pipelines, sessions):
    """The session repeats its prompt and object across rounds: each is
    encoded once."""
    _, tpipe = pipelines
    # one prompt memo entry serves every round (all share prompt and CFG)
    assert len(tpipe._prompt_cache) == 1
    # one object (three rounds) and the two-object run_multi
    assert len(tpipe._dino_cache) == 2
