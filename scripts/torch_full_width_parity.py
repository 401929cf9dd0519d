"""The port against the JAX package at production geometry, fp32 on the
CPU, on JAX's init trees for fixed keys (carried into the port by
``params/from_jax``): CLIP ViT-L/14 text on 2 x 77 tokens, DINOv2-large at
224^2, the SD-1.5 VAE's encode (a 128^2 image) and decode (a 16^2 latent),
and one BlobNet (1029 channels in) -> right-half crop -> UNet (5-ch
conv_in) step at a 16 x 32 double-width latent, CFG batch 2, with the
BlobNet's 1x1 taps drawn non-zero so that every injection matters. The
tests hold the same functions at toy widths; this script holds them at
the widths a user runs.

Each part prints max |port - JAX| / max |JAX| of its outputs against a
bar of 1e-4 (fp32 on both sides, sums in other orders), and the script
exits 1 if any passes it. The JAX side runs on XLA (its Pallas kernels
off), eagerly. About 2-4 minutes on 8 cores and ~12 GB of host memory,
the UNet and BlobNet trees in both packages the most of it. It runs every
part, in the order of PARTS:

    JAX_PLATFORMS=cpu python scripts/torch_full_width_parity.py
"""

from __future__ import annotations

import gc
import os
import sys
import time

import jax
import numpy as np

jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from blobctrl_tpu.apps import flagship as jflag  # noqa: E402
from blobctrl_tpu.models import blobnet as jblob  # noqa: E402
from blobctrl_tpu.models import clip_text as jclip  # noqa: E402
from blobctrl_tpu.models import dinov2 as jdino  # noqa: E402
from blobctrl_tpu.models import unet as junet  # noqa: E402
from blobctrl_tpu.models import vae as jvae  # noqa: E402
from blobctrl_tpu.nn import attention as jattn  # noqa: E402
from blobctrl_tpu.nn import resnet as jres  # noqa: E402
from blobctrl_torch.apps import flagship as tflag  # noqa: E402
from blobctrl_torch.models import blobnet as tblob  # noqa: E402
from blobctrl_torch.models import clip_text as tclip  # noqa: E402
from blobctrl_torch.models import dinov2 as tdino  # noqa: E402
from blobctrl_torch.models import unet as tunet  # noqa: E402
from blobctrl_torch.models import vae as tvae  # noqa: E402
from blobctrl_torch.params.from_jax import from_jax  # noqa: E402

BAR = 1e-4
T = 421.0          # the step's timestep
LATENT = (16, 32)  # the step's double-width latent (H, W)
KEYS = {"clip": 3, "dino": 4, "vae": 2, "unet": 0, "blobnet": 1}


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape:
        raise AssertionError(f"shapes {got.shape} against {want.shape}")
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def clip_part():
    cfg = jflag.clip_vit_l_config()
    jp = jclip.init(jax.random.PRNGKey(KEYS["clip"]), cfg)
    ids = np.random.RandomState(0).randint(
        0, cfg.vocab_size, (2, 77)).astype(np.int32)
    want = np.asarray(jclip.apply(jp, cfg, jnp.asarray(ids)))
    got = tclip.apply(from_jax(jp, device="cpu"), tflag.clip_vit_l_config(),
                      torch.from_numpy(ids)).numpy()
    return {"last hidden state (2, 77, 768)": rel(got, want)}


def dino_part():
    cfg = jflag.dinov2_large_config()
    jp = jdino.init(jax.random.PRNGKey(KEYS["dino"]), cfg)
    x = np.random.RandomState(1).randn(1, 224, 224, 3).astype(np.float32)
    jh, jpool = jdino.apply(jp, cfg, jnp.asarray(x))
    th, tpool = tdino.apply(from_jax(jp, device="cpu"),
                            tflag.dinov2_large_config(), torch.from_numpy(x))
    return {"hidden states": rel(th.numpy(), jh),
            "pooled": rel(tpool.numpy(), jpool)}


def vae_part():
    cfg = jflag.sd15_vae_config()
    jp = jvae.init_vae(jax.random.PRNGKey(KEYS["vae"]), cfg)
    tp, tcfg = from_jax(jp, device="cpu"), tflag.sd15_vae_config()
    rng = np.random.RandomState(2)
    img = rng.uniform(-1, 1, (1, 128, 128, 3)).astype(np.float32)
    lat = rng.randn(1, 16, 16, 4).astype(np.float32)
    enc_want = np.asarray(jvae.encode(jp, cfg, jnp.asarray(img)))
    enc_got = tvae.encode(tp, tcfg, torch.from_numpy(img)).numpy()
    dec_want = np.asarray(jvae.decode(jp, cfg, jnp.asarray(lat)))
    dec_got = tvae.decode(tp, tcfg, torch.from_numpy(lat)).numpy()
    return {"encode: moments of a 128^2 image": rel(enc_got, enc_want),
            "decode: a 16^2 latent to 128^2": rel(dec_got, dec_want)}


def _crop_bcast(r, batch, cat):
    """The right (square) half of a BlobNet residual, for every CFG row."""
    return cat([r[:, :, r.shape[2] - r.shape[1]:, :]] * batch, 0)


def step_part():
    ucfg, bcfg = jflag.sd15_unet_config(), jflag.blobctrl_blobnet_config()
    up = junet.init_unet(jax.random.PRNGKey(KEYS["unet"]), ucfg)
    bp = jblob.init_blobnet(jax.random.PRNGKey(KEYS["blobnet"]), bcfg)
    rng = np.random.RandomState(3)

    def draw(tap):  # a 1x1 tap as init_conv would scale it
        fan_in = tap["kernel"].shape[-2]
        return {k: jnp.asarray(rng.randn(*v.shape).astype(np.float32)
                               * fan_in ** -0.5) for k, v in tap.items()}

    bp["zero_down"] = [draw(p) for p in bp["zero_down"]]
    bp["zero_mid"] = draw(bp["zero_mid"])
    bp["zero_up"] = [draw(p) for p in bp["zero_up"]]
    h, w = LATENT
    cond = bcfg.in_channels + bcfg.conditioning_channels
    blob_in = rng.randn(1, h, w, cond).astype(np.float32)
    unet_in = rng.randn(2, h, h, ucfg.in_channels).astype(np.float32)
    ctx = (rng.randn(2, 77, 768) * 0.5).astype(np.float32)
    d, m, u = jblob.blobnet_apply(bp, bcfg, jnp.asarray(blob_in),
                                  jnp.asarray(T), 1.0)
    want = np.asarray(junet.unet_apply(
        up, ucfg, jnp.asarray(unet_in), jnp.asarray(T), jnp.asarray(ctx),
        [_crop_bcast(r, 2, jnp.concatenate) for r in d],
        _crop_bcast(m, 2, jnp.concatenate),
        [_crop_bcast(r, 2, jnp.concatenate) for r in u]))
    want_res = [np.asarray(r) for r in list(d) + [m] + list(u)]
    del d, m, u
    tup, tbp = from_jax(up, device="cpu"), from_jax(bp, device="cpu")
    del up, bp
    gc.collect()
    tucfg, tbcfg = tflag.sd15_unet_config(), tflag.blobctrl_blobnet_config()
    with torch.no_grad():
        d, m, u = tblob.blobnet_apply(tbp, tbcfg, torch.from_numpy(blob_in),
                                      T, 1.0)
        got = tunet.unet_apply(
            tup, tucfg, torch.from_numpy(unet_in), T, torch.from_numpy(ctx),
            [_crop_bcast(r, 2, torch.cat) for r in d],
            _crop_bcast(m, 2, torch.cat),
            [_crop_bcast(r, 2, torch.cat) for r in u]).numpy()
        plain = tunet.unet_apply(tup, tucfg, torch.from_numpy(unet_in), T,
                                 torch.from_numpy(ctx)).numpy()
    got_res = [r.numpy() for r in list(d) + [m] + list(u)]
    return {f"UNet output {tuple(want.shape)} with the injections":
            rel(got, want),
            f"BlobNet residuals ({len(want_res)}), worst":
            max(rel(g, w_) for g, w_ in zip(got_res, want_res)),
            "the injections' share: UNet without them against with them "
            "(must be far above the bar)": rel(plain, want)}


PARTS = {"clip": clip_part, "dino": dino_part, "vae": vae_part,
         "step": step_part}   # run in this order


def main() -> int:
    jattn.set_attention_backend("xla")
    jres.set_conv_backend("xla")
    failed = []
    t_all = time.perf_counter()
    for name, part in PARTS.items():
        t0 = time.perf_counter()
        got = part()
        gc.collect()
        print(f"{name} ({time.perf_counter() - t0:.1f} s):", flush=True)
        for what, r in got.items():
            check = "injections' share" not in what
            ok = r <= BAR if check else r > 100 * BAR
            print(f"  {what}: rel {r:.3e} "
                  f"({'bar' if check else 'floor'} "
                  f"{BAR if check else 100 * BAR:.0e}) "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                failed.append(f"{name}: {what}")
    print(f"{time.perf_counter() - t_all:.1f} s on "
          f"{torch.get_num_threads()} torch threads; "
          f"{'all within the bar' if not failed else f'FAILED: {failed}'}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
