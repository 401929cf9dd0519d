"""The port's boundaries: it imports neither JAX nor the JAX package, its
kernel modules import without nvcc, and its entry points refuse to fall
back to the CPU on their own."""

import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "blobctrl_torch"
# the package's Python sources (csrc/ holds CUDA sources and build output)
SOURCES = sorted(p for p in PORT.rglob("*.py") if "csrc" not in p.parts)
MODULES = [".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(
    ".__init__") for p in SOURCES]

torch.set_num_threads(2)


def _needs_cpu_only():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")


def test_import_without_jax_or_nvcc():
    """Every module imports with ``jax`` unimportable and no nvcc on PATH;
    neither jax nor blobctrl_tpu gets loaded, and no kernel is built."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import importlib\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "from blobctrl_torch.ops import _build\n"
        "assert not _build._entry\n"
        "bad = [m for m in sys.modules if m == 'blobctrl_tpu'"
        " or m.startswith(('blobctrl_tpu.', 'jax.'))]\n"
        "assert not bad, bad\n"
        "assert sys.modules['jax'] is None\n"
        "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PATH="/nonexistent", PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
    assert len(MODULES) >= 20


@pytest.mark.parametrize("path", [str(p.relative_to(ROOT)) for p in SOURCES]
                         + ["chip_smoke.py"])
def test_sources_name_no_jax(path):
    text = (ROOT / path).read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|flax)\b", text, re.M)
    assert "blobctrl_tpu" not in text.replace(
        "blobctrl_tpu/", "")  # file paths in comments are references only


def test_entry_points_raise_without_cuda():
    _needs_cpu_only()
    import numpy as np
    from blobctrl_torch.apps import flagship, session
    from blobctrl_torch.blob import viz
    from blobctrl_torch.models import clip_text, dinov2, unet
    from blobctrl_torch.params import io
    from blobctrl_torch.params.from_jax import from_jax
    from blobctrl_torch.pipeline import BlobNetPipeline
    from blobctrl_torch.train import toy
    ucfg, bcfg = flagship.tiny_configs()
    with pytest.raises(RuntimeError):
        unet.init_unet(ucfg)
    with pytest.raises(RuntimeError):
        from_jax({"w": [1.0]})
    with pytest.raises(RuntimeError):
        toy.load_toy(str(ROOT / "assets/toy_ckpt"))
    for load in (io.load_pipeline, io.load_vae, io.load_lora_dir):
        with pytest.raises(RuntimeError):
            load(str(ROOT / "models"))
    up = unet.init_unet(ucfg, device="cpu")
    with pytest.raises(RuntimeError):
        BlobNetPipeline(unet_cfg=ucfg, unet_params=up, blobnet_cfg=bcfg,
                        blobnet_params={}, vae_cfg=None, vae_params={})
    pipe = BlobNetPipeline(unet_cfg=ucfg, unet_params=up, blobnet_cfg=bcfg,
                           blobnet_params={}, vae_cfg=None, vae_params={},
                           device="cpu")
    ccfg, dcfg = flagship.tiny_encoder_configs()
    with pytest.raises(RuntimeError):
        clip_text.init(ccfg)
    with pytest.raises(RuntimeError):
        dinov2.init(dcfg)
    with pytest.raises(RuntimeError):
        flagship.production_encoder_params()
    e = ((32.0, 32.0), (20.0, 30.0), 10.0)
    with pytest.raises(RuntimeError):
        viz.blob_vis_from_ellipse(e, 64, 64)
    # the session runs where its pipeline runs
    sess = session.BlobCtrlSession(pipe, size=64)
    sess.editor.init_from_ellipse(e)
    assert sess.device.type == "cpu"
    assert sess.blob_visualization().shape == (64, 64, 3)
    assert np.array_equal(sess.blob_visualization(),
                          viz.blob_vis_from_ellipse(e, 64, 64, device="cpu"))


def test_pipeline_rejects_what_is_not_ported():
    """What stays unported or unsupported raises (IP-adapter inputs and
    return_sample, as in the JAX package; a scheduler name the JAX package
    does not know); a text prompt on a pipeline without a tokenizer and
    CLIP raises a clear ValueError; an image that needs a resize, a
    scheduler other than UniPC and a safety checker with blackout_nsfw,
    which are ported, run."""
    from blobctrl_torch.pipeline import BlobNetPipeline
    from blobctrl_torch.train import toy
    from blobctrl_torch.utils import benchkit
    pipe, _ = toy.load_toy(str(ROOT / "assets/toy_ckpt"), device="cpu")
    emb = toy.class_embeddings()
    kw = benchkit.make_edit_inputs(128)
    kw.update(prompt_embeds=emb["text"][:1],
              negative_prompt_embeds=emb["text"][:1],
              fg_dino_feats=emb["appearance"][:1], height=128, width=128,
              num_inference_steps=1)
    with pytest.raises(NotImplementedError):
        pipe(**{**kw, "ip_adapter_image": kw["fg_image"]})
    with pytest.raises(NotImplementedError):
        pipe(**{**kw, "return_sample": True})
    screened = BlobNetPipeline(
        unet_cfg=pipe.unet_cfg, unet_params=pipe.unet_params,
        blobnet_cfg=pipe.blobnet_cfg, blobnet_params=pipe.blobnet_params,
        vae_cfg=pipe.vae_cfg, vae_params=pipe.vae_params, device="cpu",
        safety_checker=lambda images: np.ones(len(images), bool),
        blackout_nsfw=True)
    out = screened(**kw)
    assert out.nsfw_content_detected.tolist() == [True]
    assert out.images.shape == (1, 128, 128, 3) and not out.images.any()
    with pytest.raises(ValueError, match="unknown scheduler"):
        pipe(**{**kw, "scheduler": "euler"})
    with pytest.raises(ValueError, match="tokenizer"):
        pipe(**{**kw, "prompt": "a red ball", "prompt_embeds": None})
    out = pipe(**{**kw, "fg_image": kw["fg_image"][:64]})  # resized
    assert out.images.shape == (1, 128, 128, 3)
    out = pipe(**{**kw, "scheduler": "ddim"})
    assert out.images.shape == (1, 128, 128, 3)


FORBIDDEN = ("cv2", "PIL", "regex", "ftfy", "jax", "flax", "safetensors",
             "transformers")


@pytest.mark.parametrize("path", [str(p.relative_to(ROOT)) for p in SOURCES]
                         + ["chip_smoke.py"])
def test_sources_import_no_host_image_or_text_library(path):
    """The card's machine has no cv2, PIL, regex, ftfy, safetensors or
    transformers: no source of the port imports them, at the top or inside
    a function."""
    text = (ROOT / path).read_text()
    pat = r"^\s*(import|from)\s+(" + "|".join(FORBIDDEN) + r")\b"
    assert not re.search(pat, text, re.M), path


@pytest.mark.parametrize("path", [str(p.relative_to(ROOT)) for p in SOURCES]
                         + ["chip_smoke.py"])
def test_gradio_imported_only_inside_functions(path):
    """gradio is on neither machine: the Gradio app imports it inside
    ``build_demo`` alone, so every module imports without it."""
    text = (ROOT / path).read_text()
    assert not re.search(r"^(import|from)\s+gradio\b", text, re.M), path
