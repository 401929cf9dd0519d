"""The port's checkpoint loaders against the JAX package's, on the
reference layout written without diffusers.

Trees are drawn at the toy geometry (``train/toy.toy_configs``, the UNet at
4 input channels so ``widen_conv_in`` runs) and tiny encoders
(``apps/flagship.tiny_encoder_configs``), every leaf random from a numpy
seed. They become reference-layout state dicts through the JAX package's
own exporters (UNet and BlobNet: ``train/checkpoint.export_blobnet_
safetensors``; LoRA: ``export_lora_safetensors``) and, for the VAE, CLIP
text and DINOv2, through the port's inverse (``params/export.py``), which
is first held against the JAX converters. Each is written as fp32, fp16
and bf16 safetensors and as a torch ``.bin``; the port must load every leaf
bit-equal to the JAX package's loader in fp32. LoRA merges and runtime
rescales agree within 1e-6 relative (the two sum the rank-r product in
other orders)."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors import safe_open
from safetensors.numpy import save_file as np_save_file
from safetensors.torch import save_file as torch_save_file

from blobctrl_tpu.models import clip_text as jclip
from blobctrl_tpu.models import dinov2 as jdino
from blobctrl_tpu.models import blobnet as jblobnet
from blobctrl_tpu.models import lora as jlora
from blobctrl_tpu.models import unet as junet
from blobctrl_tpu.models import vae as jvae
from blobctrl_tpu.params import config_io as jconfig_io
from blobctrl_tpu.params import convert as jconvert
from blobctrl_tpu.params import io as jio
from blobctrl_tpu.pipeline import BlobNetPipeline as JPipe
from blobctrl_tpu.train import checkpoint as jckpt
from blobctrl_tpu.train import toy as jtoy
from blobctrl_torch.apps import flagship as tflagship
from blobctrl_torch.models import lora as tlora
from blobctrl_torch.ops import conv3x3, winograd
from blobctrl_torch.params import config_io as tconfig_io
from blobctrl_torch.params import export as texport
from blobctrl_torch.params import from_jax as tfrom_jax
from blobctrl_torch.params import io as tio
from blobctrl_torch.pipeline import BlobNetPipeline as TPipe
from blobctrl_torch.train import toy as ttoy

torch.set_num_threads(2)

NETS = ("unet", "blobnet", "vae", "clip", "dino")
FORMATS = ("fp32", "fp16", "bf16", "bin")
RANK = 4


def _randomize(tree, rng):
    """The same structure, every leaf drawn N(0, 0.1^2) (norm scales too),
    so no leaf is a constant that a wrong key could still match."""
    return jax.tree_util.tree_map(
        lambda a: (rng.randn(*a.shape) * 0.1).astype(np.float32), tree)


def tiny_trees(seed: int = 0):
    """-> ({net: JAX-side numpy tree}, {net: port config}) at the toy
    geometry with the UNet at 4 input channels."""
    ucfg, bcfg, vcfg = jtoy.toy_configs()
    ucfg = dataclasses.replace(ucfg, in_channels=4)
    ccfg, dcfg = tflagship.tiny_encoder_configs()
    key = jax.random.PRNGKey(seed)
    rng = np.random.RandomState(seed)
    jtrees = {
        "unet": junet.init_unet(key, ucfg),
        "blobnet": jblobnet.init_blobnet(key, bcfg),
        "vae": jvae.init_vae(key, vcfg),
        "clip": jclip.init(key, jclip.CLIPTextConfig(
            **dataclasses.asdict(ccfg))),
        "dino": jdino.init(key, jdino.DINOv2Config(
            **dataclasses.asdict(dcfg))),
    }
    trees = {k: _randomize(v, rng) for k, v in jtrees.items()}
    tcfgs = dict(zip(("unet", "blobnet", "vae"), ttoy.toy_configs()))
    tcfgs["unet"] = dataclasses.replace(tcfgs["unet"], in_channels=4)
    tcfgs.update(clip=ccfg, dino=dcfg)
    return trees, tcfgs


def lora_tree(unet_tree, seed: int = 1, conv: bool = True):
    """Adapters on every attention projection and feed-forward input
    (linear), the transformers' 1x1 proj_in and, with ``conv``, one 3x3
    resnet conv (C = 32, so the Winograd route derives its weights); A and
    B both random."""
    rng = np.random.RandomState(seed)
    out = {}
    flat = jckpt._flatten(unet_tree)
    for path, arr in flat.items():
        if not path.endswith(".kernel"):
            continue
        body = path[:-len(".kernel")]
        last = body.rsplit(".", 1)[-1]
        if last in ("to_q", "to_k", "to_v", "to_out") or body.endswith(
                "ff.proj_in"):
            d_in, d_out = arr.shape
            a = rng.randn(d_in, RANK)
        elif last == "proj_in":
            d_in, d_out = arr.shape[2:]
            a = rng.randn(d_in, RANK)
        elif conv and body == "down_blocks.0.resnets.0.conv1":
            d_in, d_out = arr.shape[2:]
            a = rng.randn(3, 3, d_in, RANK)
        else:
            continue
        out[body.replace(".", "/")] = {
            "A": (a * 0.1).astype(np.float32),
            "B": (rng.randn(RANK, d_out) * 0.1).astype(np.float32)}
    return out


def state_dict(net, tree, scratch):
    """A tree -> its reference-layout state dict (numpy fp32)."""
    if net in ("unet", "blobnet"):
        # the JAX package's exporter (writes fp32 safetensors, returns dict)
        return jckpt.export_blobnet_safetensors(
            tree, os.path.join(scratch, f"{net}.safetensors"))
    fn = {"vae": texport.vae_state_dict, "clip": texport.clip_text_state_dict,
          "dino": texport.dinov2_state_dict}[net]
    return {k: np.ascontiguousarray(v) for k, v in fn(tree).items()}


def write_format(sd, directory, fmt, name="model"):
    os.makedirs(directory, exist_ok=True)
    if fmt == "fp32":
        np_save_file(sd, os.path.join(directory, name + ".safetensors"))
    elif fmt == "fp16":
        np_save_file({k: v.astype(np.float16) if v.dtype == np.float32
                      else v for k, v in sd.items()},
                     os.path.join(directory, name + ".safetensors"))
    elif fmt == "bf16":
        torch_save_file({k: torch.from_numpy(v).to(torch.bfloat16)
                         if v.dtype == np.float32 else torch.from_numpy(v)
                         for k, v in sd.items()},
                        os.path.join(directory, name + ".safetensors"))
    else:
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
                   os.path.join(directory, name + ".bin"))


JLOAD = {"unet": jio.load_sd15_unet, "blobnet": jio.load_blobnet,
         "vae": jio.load_vae, "clip": jio.load_clip_text,
         "dino": jio.load_dinov2}
TLOAD = {"unet": tio.load_sd15_unet, "blobnet": tio.load_blobnet,
         "vae": tio.load_vae, "clip": tio.load_clip_text,
         "dino": tio.load_dinov2}


def assert_trees_equal(got, want, path=""):
    """Same structure; every leaf bit-equal (got: torch, want: JAX)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (
            path, sorted(set(got) ^ set(want)))
        for k in want:
            assert_trees_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_trees_equal(g, w, f"{path}/{i}")
    else:
        g = got.numpy() if torch.is_tensor(got) else np.asarray(got)
        w = np.asarray(want)
        assert g.dtype == w.dtype and g.shape == w.shape, (path, g.dtype,
                                                          w.dtype, g.shape)
        assert np.array_equal(g, w), (path, float(np.abs(g - w).max()))


def assert_trees_close(got, want, rel=1e-6):
    flat_g, flat_w = texport.flatten(got), jckpt._flatten(want)
    assert set(flat_g) == set(flat_w)
    for k, w in flat_w.items():
        g = flat_g[k].numpy()
        w = np.asarray(w)
        tol = rel * max(float(np.abs(w).max()), 1e-30)
        assert np.abs(g - w).max() <= tol, (k, float(np.abs(g - w).max()))


@pytest.fixture(scope="module")
def trees():
    return tiny_trees()


@pytest.fixture(scope="module")
def files(trees, tmp_path_factory):
    """{(net, fmt): directory} of every net in every format."""
    root = str(tmp_path_factory.mktemp("loaders"))
    out = {}
    for net in NETS:
        sd = state_dict(net, trees[0][net], root)
        for fmt in FORMATS:
            d = os.path.join(root, f"{net}_{fmt}")
            write_format(sd, d, fmt)
            out[net, fmt] = d
    return out


@pytest.mark.parametrize("net", ["vae", "clip", "dino"])
def test_inverse_layout_round_trips_through_jax_converters(trees, net,
                                                         tmp_path):
    """The port's inverse (``params/export.py``) is what the JAX package's
    converters read back into the same tree, bit for bit."""
    tree = trees[0][net]
    fn = {"vae": jconvert.convert_vae, "clip": jconvert.convert_clip_text,
          "dino": jconvert.convert_dinov2}[net]
    sd = state_dict(net, tree, str(tmp_path))
    back = fn(sd)
    flat_b, flat_t = jckpt._flatten(back), jckpt._flatten(tree)
    assert set(flat_b) == set(flat_t)
    for k in flat_t:
        assert np.array_equal(np.asarray(flat_b[k]), flat_t[k]), k


@pytest.mark.parametrize("net", ["unet", "blobnet"])
def test_port_unet_layout_matches_jax_exporter(trees, net, tmp_path):
    """The port's UNet / BlobNet inverse (what the card's run writes) gives
    the JAX exporter's keys and arrays."""
    want = jckpt.export_blobnet_safetensors(trees[0][net],
                                            str(tmp_path / "x.safetensors"))
    got = texport.unet_state_dict(trees[0][net])
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(np.asarray(got[k]), want[k]), k


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("net", NETS)
def test_load_matches_jax_bit_for_bit(files, net, fmt):
    """Every leaf bit-equal in fp32, from fp32, fp16, bf16 and .bin."""
    d = files[net, fmt]
    got = TLOAD[net](d, device="cpu")
    want = JLOAD[net](d)
    assert_trees_equal(got, want)
    if net == "unet":  # widened 4 -> 5 input channels, the new one zero
        k = got["conv_in"]["kernel"]
        assert k.shape[2] == 5 and not k[:, :, 4].any()


def test_sharded_and_port_written_files_load_like_jax(trees, tmp_path):
    """Two shards (the later one wins a repeated key) and a file from the
    port's own numpy writer, which the safetensors package reads back."""
    sd = state_dict("vae", trees[0]["vae"], str(tmp_path))
    keys = sorted(sd)
    d = tmp_path / "sharded"
    d.mkdir()
    np_save_file({k: sd[k] for k in keys[: len(keys) // 2]},
                 str(d / "model-00001-of-00002.safetensors"))
    np_save_file({k: sd[k] for k in keys[len(keys) // 2:]},
                 str(d / "model-00002-of-00002.safetensors"))
    assert_trees_equal(tio.load_vae(str(d), device="cpu"),
                       jio.load_vae(str(d)))
    d2 = tmp_path / "port"
    d2.mkdir()
    n = texport.save_safetensors(str(d2 / "m.safetensors"), sd,
                                 float_dtype=torch.float16)
    assert n == os.path.getsize(d2 / "m.safetensors")
    with safe_open(str(d2 / "m.safetensors"), framework="numpy") as f:
        for k in keys:
            assert np.array_equal(f.get_tensor(k), sd[k].astype(np.float16))
    assert_trees_equal(tio.load_vae(str(d2), device="cpu"),
                       jio.load_vae(str(d2)))


def test_safetensors_reader_dtypes_and_toy_checkpoints(tmp_path):
    """The memory-mapped reader gives the safetensors package's arrays for
    every dtype (BF16 decoded bit-exactly to fp32), and the toy checkpoints
    load through it bit-equal to the JAX package's toy loader."""
    rng = np.random.RandomState(0)
    t = {"f32": torch.from_numpy(rng.randn(3, 5).astype(np.float32)),
         "f16": torch.from_numpy(rng.randn(7).astype(np.float16)),
         "bf16": torch.from_numpy(rng.randn(2, 3, 4).astype(np.float32)).to(
             torch.bfloat16),
         "i64": torch.arange(6).reshape(1, 6),
         "u8": torch.from_numpy(rng.randint(0, 255, (4, 4)).astype(np.uint8)),
         "empty": torch.zeros(0, 3)}
    torch_save_file(t, str(tmp_path / "t.safetensors"))
    got = tio.load_safetensors(str(tmp_path / "t.safetensors"))
    assert sorted(got) == sorted(t)
    for k, v in t.items():
        want = v.float().numpy() if v.dtype == torch.bfloat16 else v.numpy()
        assert got[k].dtype == want.dtype and np.array_equal(got[k], want), k
    for ckpt in ("assets/toy_ckpt", "assets/toy_ckpt_256"):
        path = os.path.join(ckpt, "toy.safetensors")
        with safe_open(path, framework="numpy") as f:
            ref = {k: f.get_tensor(k) for k in f.keys()}
        got = tfrom_jax.load_safetensors(path)
        assert set(got) == set(ref)
        assert all(np.array_equal(got[k], v) for k, v in ref.items())
        tpipe, _ = ttoy.load_toy(ckpt, device="cpu")
        jpipe, _ = jtoy.load_toy(ckpt)
        for name in ("unet_params", "blobnet_params", "vae_params"):
            assert_trees_equal(getattr(tpipe, name), getattr(jpipe, name))


def test_configs_match_jax(trees):
    """Each config.json -> the same config, field by field, on both sides;
    the port's inverses are what the JAX package's readers invert."""
    cfgs = trees[1]
    cases = [
        (texport.unet_config_to_diffusers(cfgs["unet"]),
         tconfig_io.unet_config_from_diffusers,
         jconfig_io.unet_config_from_diffusers, cfgs["unet"]),
        (tconfig_io.blobnet_config_to_diffusers(cfgs["blobnet"]),
         tconfig_io.blobnet_config_from_diffusers,
         jconfig_io.blobnet_config_from_diffusers, cfgs["blobnet"]),
        (texport.vae_config_to_diffusers(cfgs["vae"]),
         tconfig_io.vae_config_from_diffusers,
         jconfig_io.vae_config_from_diffusers, cfgs["vae"]),
        (texport.clip_text_config_to_transformers(cfgs["clip"]),
         tconfig_io.clip_text_config_from_transformers,
         jconfig_io.clip_text_config_from_transformers, cfgs["clip"]),
        (texport.dinov2_config_to_transformers(cfgs["dino"]),
         tconfig_io.dinov2_config_from_transformers,
         jconfig_io.dinov2_config_from_transformers, cfgs["dino"]),
        # SD-1.5's own config form: a per-block head list, no head count
        ({"in_channels": 4, "out_channels": 4,
          "block_out_channels": [320, 640, 1280, 1280],
          "down_block_types": ["CrossAttnDownBlock2D"] * 3 + ["DownBlock2D"],
          "up_block_types": ["UpBlock2D"] + ["CrossAttnUpBlock2D"] * 3,
          "layers_per_block": 2, "cross_attention_dim": 768,
          "attention_head_dim": [8, 8, 8, 8]},
         tconfig_io.unet_config_from_diffusers,
         jconfig_io.unet_config_from_diffusers,
         dataclasses.replace(tflagship.sd15_unet_config(), in_channels=4)),
    ]
    for d, tfn, jfn, cfg in cases:
        got, want = tfn(d), jfn(d)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got == cfg
    assert (tconfig_io.blobnet_config_to_diffusers(cfgs["blobnet"])
            == jconfig_io.blobnet_config_to_diffusers(cfgs["blobnet"]))


def test_save_load_config_round_trip(trees, tmp_path):
    for name, cfg in trees[1].items():
        path = str(tmp_path / f"{name}.json")
        tconfig_io.save_config(cfg, path)
        assert tconfig_io.load_config(type(cfg), path) == cfg
        jcfg = jconfig_io.load_config(
            {"unet": junet.UNetConfig, "blobnet": jblobnet.BlobNetConfig,
             "vae": jvae.VAEConfig, "clip": jclip.CLIPTextConfig,
             "dino": jdino.DINOv2Config}[name], path)
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)


def peft_state_dict(lora, scratch, diffusers_form=False):
    """The JAX package's PEFT exporter for the linear adapters; 1x1 and 3x3
    conv adapters in PEFT's 4-D Conv2d form."""
    sd = {}
    lin = {k: v for k, v in lora.items() if v["A"].ndim == 2}
    sd.update(jckpt.export_lora_safetensors(
        lin, os.path.join(scratch, "lora_lin.safetensors")))
    for k, ab in lora.items():
        body = k.replace("/", ".").replace(".blocks.", ".transformer_blocks.")
        a, b = ab["A"], ab["B"]
        if k.endswith("proj_in") and "/ff/" not in k:  # a 1x1 Conv2d
            sd[f"base_model.model.{body}.lora_A.weight"] = a.T[:, :, None,
                                                               None]
            sd[f"base_model.model.{body}.lora_B.weight"] = b.T[:, :, None,
                                                               None]
        elif a.ndim == 4:
            sd[f"base_model.model.{body}.lora_A.weight"] = np.transpose(
                a, (3, 2, 0, 1))
            sd[f"base_model.model.{body}.lora_B.weight"] = b.T[:, :, None,
                                                               None]
    if diffusers_form:
        sd = {k.replace("base_model.model.", "unet.").replace(
            ".lora_A.", ".lora.down.").replace(".lora_B.", ".lora.up."): v
            for k, v in sd.items()}
    return {k: np.ascontiguousarray(v) for k, v in sd.items()}


@pytest.mark.parametrize("alpha", [None, 8.0])
@pytest.mark.parametrize("form", ["peft", "diffusers"])
def test_lora_convert_and_merge_match_jax(trees, alpha, form, tmp_path):
    unet = trees[0]["unet"]
    lora = lora_tree(unet)
    sd = peft_state_dict(lora, str(tmp_path), form == "diffusers")
    got = tlora.convert_lora_state_dict(sd)
    want = jlora.convert_lora_state_dict(sd)
    assert set(got) == set(want) == set(lora)
    for k in want:
        for n in ("A", "B"):
            assert np.array_equal(got[k][n], np.asarray(want[k][n])), (k, n)
    # the port's PEFT writer reads back to the same adapter
    back = jlora.convert_lora_state_dict(texport.lora_state_dict(lora))
    assert all(np.array_equal(np.asarray(back[k][n]), lora[k][n])
               for k in lora for n in ("A", "B"))
    tunet = tfrom_jax.from_jax(unet, "cpu")
    tl = {k: {n: torch.from_numpy(v) for n, v in ab.items()}
          for k, ab in got.items()}
    merged = tlora.merge_lora(tunet, tl, scale=0.7, alpha=alpha)
    jmerged = jlora.merge_lora(jax.tree_util.tree_map(jnp.asarray, unet),
                               want, scale=0.7, alpha=alpha)
    assert_trees_close(merged, jmerged)
    # the input tree is not changed
    assert_trees_equal(tunet, unet)


def _pipes(unet, lora, alpha):
    """A JAX and a port pipeline over the same LoRA-merged UNet (fp32),
    with the adapter recorded as load_pipeline records it."""
    tucfg, tbcfg, _ = ttoy.toy_configs()
    jucfg, jbcfg, _ = jtoy.toy_configs()
    jl = {k: {n: jnp.asarray(v) for n, v in ab.items()}
          for k, ab in lora.items()}
    jp = JPipe(unet_cfg=jucfg, unet_params=jlora.merge_lora(
        jax.tree_util.tree_map(jnp.asarray, unet), jl, 1.0, alpha),
        blobnet_cfg=jbcfg, blobnet_params=None, vae_cfg=None,
        vae_params=None)
    jp._lora_tree, jp._lora_alpha, jp._lora_scale = jl, alpha, 1.0
    tl = {k: {n: torch.from_numpy(v) for n, v in ab.items()}
          for k, ab in lora.items()}
    tp = TPipe(unet_cfg=tucfg, unet_params=tlora.merge_lora(
        tfrom_jax.from_jax(unet, "cpu"), tl, 1.0, alpha), blobnet_cfg=tbcfg,
        blobnet_params={}, vae_cfg=None, vae_params={}, device="cpu")
    tp._lora_tree, tp._lora_alpha, tp._lora_scale = tl, alpha, 1.0
    return jp, tp


def test_set_lora_scale_sequence_matches_jax(trees):
    """1 -> 0.5 -> 0 -> 1 in fp32: each step the increment onto the merged
    weights, every UNet leaf within 1e-6 relative of the JAX package's."""
    unet = trees[0]["unet"]
    jp, tp = _pipes(unet, lora_tree(unet), alpha=2.0)
    for s in (0.5, 0.0, 1.0):
        before = tp.unet_params
        jp.set_lora_scale(s)
        tp.set_lora_scale(s)
        assert tp.unet_params is not before  # a new tree, never in place
        assert_trees_close(tp.unet_params, jp.unet_params)
    with pytest.raises(ValueError, match="no LoRA adapter"):
        TPipe(unet_cfg=tp.unet_cfg, unet_params=tp.unet_params,
              blobnet_cfg=tp.blobnet_cfg, blobnet_params={}, vae_cfg=None,
              vae_params={}, device="cpu").set_lora_scale(0.5)


@pytest.mark.parametrize("mode", ["winograd", "int8"])
def test_rescale_rederives_cached_weights(trees, mode):
    """``_conv_params`` caches derived weights by the tree's identity; a
    rescale replaces the tree, so the next call derives them anew from the
    rescaled kernels (the 3x3 adapter's Winograd ``u``, the projections'
    int8 ``kernel_q``)."""
    unet = trees[0]["unet"]
    _, tp = _pipes(unet, lora_tree(unet), alpha=None)
    switch = (conv3x3.set_winograd if mode == "winograd"
              else conv3x3.set_conv_int8)
    switch(True)
    try:
        first = tp._conv_params("unet_params")
        assert tp._conv_params("unet_params") is first  # cached
        tp.set_lora_scale(0.25)
        second = tp._conv_params("unet_params")
    finally:
        switch(False)
    assert second is not first
    conv = second["down_blocks"][0]["resnets"][0]["conv1"]
    q = second["down_blocks"][0]["attentions"][0]["blocks"][0]["attn1"][
        "to_q"]
    if mode == "winograd":
        want = winograd.transform_weights(conv["kernel"]).to(tp.dtype)
        assert torch.equal(conv["u"], want)
        old = first["down_blocks"][0]["resnets"][0]["conv1"]["u"]
        assert not torch.equal(conv["u"], old)
    else:
        want_q, want_s = conv3x3.quantize_kernel_i8(q["kernel"])
        assert torch.equal(q["kernel_q"], want_q)
        assert torch.equal(q["w_scale"], want_s)
    assert tp._conv_params("unet_params") is tp.unet_params  # modes off


def test_load_sam_loads(tmp_path):
    """A SAM checkpoint written in the original segment_anything layout
    (``export.save_sam``) loads bit-equal to the tree it was written from,
    and the JAX loader reads the same file into the same leaves."""
    from blobctrl_torch.models import sam as tsam
    from blobctrl_torch.params import export
    cfg = tsam.SAMConfig(hidden_size=32, num_layers=3, num_heads=2,
                         mlp_dim=64, image_size=64, window_size=3,
                         global_attn_indexes=(1,), output_channels=16,
                         prompt_dim=16, decoder_heads=2, decoder_mlp_dim=32)
    tree = tsam.init(cfg, key=4, device="cpu")
    path = str(tmp_path / "sam_vit_h_4b8939.pth")
    export.save_sam(path, tree)
    got = export.flatten(tio.load_sam(path, device="cpu"))
    want = export.flatten(tree)
    assert set(got) == set(want)
    jgot = export.flatten(jio.load_sam(path))
    for k, w in want.items():
        assert torch.equal(got[k], w), k
        assert np.array_equal(np.asarray(jgot[k]), w.numpy()), k
    with pytest.raises(RuntimeError, match="CUDA"):
        tio.load_sam(path)
