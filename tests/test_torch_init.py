"""The port's parameter init against the JAX package's, on the CPU, with no
``from_jax`` in between: for a key, ``init_unet``, ``init_blobnet`` (and
``from_unet``), ``init_vae``, ``clip_text.init`` and ``dinov2.init`` give
the tree the JAX functions give. Uniform leaves bit-equal, normal leaves
(the embedding tables) within 4 ulp, constant leaves exact, the BlobNet
taps zero. Configs: ``flagship.tiny_configs`` and
``tiny_encoder_configs``, a 4-level narrow UNet / BlobNet with SD-1.5's
attention pattern and split counts, a 4-level narrow VAE (its 64-key walk
at SD-1.5's block counts); keys: an int seed and a key taken from
``split``. The toy trainers start from JAX's trees for their seed.

Each JAX tree is drawn once per file (module fixtures): a fresh process
pays about 30 s for its first JAX init, most of this file's cost."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from blobctrl_tpu.apps import flagship as jflag
from blobctrl_tpu.models import blobnet as jblob
from blobctrl_tpu.models import clip_text as jclip
from blobctrl_tpu.models import dinov2 as jdino
from blobctrl_tpu.models import unet as junet
from blobctrl_tpu.models import vae as jvae
from blobctrl_tpu.nn import layers as jlayers
from blobctrl_torch.apps import flagship as tflag
from blobctrl_torch.models import blobnet as tblob
from blobctrl_torch.models import clip_text as tclip
from blobctrl_torch.models import dinov2 as tdino
from blobctrl_torch.models import unet as tunet
from blobctrl_torch.models import vae as tvae
from blobctrl_torch.nn import layers as tlayers
from blobctrl_torch.train import toy as ttoy
from blobctrl_torch.utils import threefry

torch.set_num_threads(2)

# the leaves JAX draws with ``normal``; every other drawn leaf is uniform
NORMAL_LEAVES = {"token_embedding", "position_embedding", "cls_token",
                 "position_embeddings"}
TAPS = ("zero_down", "zero_mid", "zero_up")
KEYS = {"seed 0": 0, "split(PRNGKey(5))[1]": ("split", 5)}


def jax_key(k):
    if isinstance(k, int):
        return jax.random.PRNGKey(k)
    return jax.random.split(jax.random.PRNGKey(k[1]))[1]


def torch_key(k):
    if isinstance(k, int):
        return k
    return threefry.split(threefry.key(k[1]))[1]


def narrow(cfg):
    """A 4-level narrow UNet / BlobNet config: SD-1.5's attention pattern,
    layers and split counts at widths 8/16/16/16."""
    return dataclasses.replace(
        cfg, block_out_channels=(8, 16, 16, 16),
        down_block_has_attn=(True, True, True, False),
        up_block_has_attn=(False, True, True, True))


def port_cfg(module, cfg):
    """The port's config of the same name and fields as JAX's ``cfg``."""
    return getattr(module, type(cfg).__name__)(**dataclasses.asdict(cfg))


JU, JB = jflag.tiny_configs()
JVAE = jvae.VAEConfig(block_out_channels=(8, 16, 16, 16), norm_num_groups=4)
JCLIP = jclip.CLIPTextConfig(**dataclasses.asdict(
    tflag.tiny_encoder_configs()[0]))
JDINO = jdino.DINOv2Config(**dataclasses.asdict(
    tflag.tiny_encoder_configs()[1]))
# name -> (JAX init, JAX config, port init, port config)
MODELS = {
    "unet tiny": (junet.init_unet, JU, tunet.init_unet,
                  port_cfg(tunet, JU)),
    "unet narrow": (junet.init_unet, narrow(JU), tunet.init_unet,
                    port_cfg(tunet, narrow(JU))),
    "blobnet tiny": (jblob.init_blobnet, JB, tblob.init_blobnet,
                     port_cfg(tblob, JB)),
    "blobnet narrow": (jblob.init_blobnet, narrow(JB), tblob.init_blobnet,
                       port_cfg(tblob, narrow(JB))),
    "vae narrow": (jvae.init_vae, JVAE, tvae.init_vae,
                   port_cfg(tvae, JVAE)),
    "clip tiny": (jclip.init, JCLIP, tclip.init, port_cfg(tclip, JCLIP)),
    "dinov2 tiny": (jdino.init, JDINO, tdino.init, port_cfg(tdino, JDINO)),
}


@pytest.fixture(scope="module")
def jax_trees():
    """(model, key name) -> JAX's tree, each drawn once."""
    cache = {}

    def get(model, key_name):
        if (model, key_name) not in cache:
            init, cfg = MODELS[model][:2]
            cache[model, key_name] = init(jax_key(KEYS[key_name]), cfg)
        return cache[model, key_name]
    return get


def flat(tree, prefix=()):
    """{path: leaf} of a tree of dicts and lists."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, prefix + (k,)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(flat(v, prefix + (i,)))
        return out
    return {prefix: tree}


def ulps(a, b):
    """|a - b| in float32 units in the last place (ordered bit patterns)."""
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(ordered(a) - ordered(b))


def assert_same_tree(got, want, skip=()):
    """The port's tree equal to JAX's: the same paths, shapes and float32
    leaves, normal leaves within 4 ulp and every other leaf bit-equal.
    Paths under a name in ``skip`` are left out. -> the compared paths."""
    got, want = flat(got), flat(want)
    assert set(got) == set(want)
    compared = []
    for path, w in want.items():
        if any(p in skip for p in path):
            continue
        g = got[path]
        assert g.dtype == torch.float32 and g.device.type == "cpu", path
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape and w.dtype == np.float32, path
        if path[-1] in NORMAL_LEAVES:
            assert ulps(g, w).max() <= 4, path
        else:
            np.testing.assert_array_equal(g.view(np.int32),
                                          w.view(np.int32), err_msg=path)
        compared.append(path)
    return compared


@pytest.mark.parametrize("key_name", list(KEYS))
@pytest.mark.parametrize("model", list(MODELS))
def test_init_draws_the_jax_tree(model, key_name, jax_trees):
    want = jax_trees(model, key_name)
    _, _, init, cfg = MODELS[model]
    got = init(cfg, torch_key(KEYS[key_name]), "cpu")
    compared = assert_same_tree(got, want)
    drawn = [p for p in compared if p[0] not in TAPS
             and p[-1] in ("kernel",) + tuple(NORMAL_LEAVES)]
    assert drawn and all(flat(got)[p].abs().max() > 0 for p in drawn)
    if model.startswith("blobnet"):
        taps = [v for p, v in flat(got).items() if p[0] in TAPS]
        assert taps and all(not v.any() for v in taps)


@pytest.mark.parametrize("model", ["blobnet tiny", "blobnet narrow"])
def test_drawn_taps_change_only_the_taps(model, jax_trees):
    """zero_taps=False: every leaf but the taps JAX's; tap i (down, mid,
    up) JAX's ``init_conv`` of ``split(fold_in(key, TAP_FOLD), taps)[i]``."""
    want = jax_trees(model, "seed 0")
    _, jcfg, init, cfg = MODELS[model]
    got = init(cfg, 0, "cpu", zero_taps=False)
    assert_same_tree(got, want, skip=TAPS)
    paths = [(name,) + ((i,) if name != "zero_mid" else ())
             for name in TAPS for i in range(
                 len(want[name]) if name != "zero_mid" else 1)]
    keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(0),
                                               tblob.TAP_FOLD), len(paths))
    taps = {}
    for path, k in zip(paths, keys):
        node = want
        for p in path:
            node = node[p]
        c = node["kernel"].shape[2]
        taps[path] = jlayers.init_conv(k, 1, 1, c, c)
    assert_same_tree({p: _at(got, p) for p in paths}, taps)
    assert all(_at(got, p)["kernel"].abs().min() > 0 for p in paths)


def _at(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def test_from_unet_matches_jax_without_from_jax(jax_trees):
    """The port's ``from_unet`` of its own UNet draw equals JAX's of JAX's:
    the BlobNet tree from the key, every drawn leaf replaced."""
    _, _, _, ucfg = MODELS["unet tiny"]
    _, jbcfg, _, bcfg = MODELS["blobnet tiny"]
    key = ("split", 5)
    want = jblob.from_unet(jax_trees("unet tiny", "split(PRNGKey(5))[1]"),
                           jbcfg, jax_key(key))
    got = tblob.from_unet(tunet.init_unet(ucfg, torch_key(key), "cpu"),
                          bcfg, torch_key(key))
    assert_same_tree(got, want)


@pytest.mark.parametrize("model", ["vae narrow", "clip tiny"])
def test_a_cast_draw_is_the_jax_tree_cast(model, jax_trees):
    """dtype=bf16: JAX's fp32 tree cast leaf by leaf, as the loaders cast
    it."""
    want = flat(jax_trees(model, "seed 0"))
    _, _, init, cfg = MODELS[model]
    got = flat(init(cfg, 0, "cpu", torch.bfloat16))
    assert set(got) == set(want)
    for path, w in want.items():
        assert got[path].dtype == torch.bfloat16, path
        torch.testing.assert_close(
            got[path], torch.from_numpy(np.array(w)).to(torch.bfloat16),
            rtol=0, atol=0, msg=str(path))


def test_a_jax_key_array_and_its_words_draw_alike(jax_trees):
    """A key passed as JAX's uint32 array, as a torch tensor of its words
    and as threefry's split all draw JAX's tree."""
    want = jax_trees("clip tiny", "split(PRNGKey(5))[1]")
    jk = jax_key(("split", 5))
    _, _, init, cfg = MODELS["clip tiny"]
    for k in (jk, torch.tensor(np.asarray(jk).astype(np.int64)),
              np.asarray(jk)):
        assert_same_tree(init(cfg, k, "cpu"), want)


def test_leaves_drawn_in_blocks_equal_the_whole_draw(monkeypatch,
                                                     jax_trees):
    """``ParamInit`` draws a leaf DRAW_BLOCK elements at a time over its
    flat index; a block that divides no leaf gives the same tree."""
    monkeypatch.setattr(tlayers, "DRAW_BLOCK", 7)
    _, _, init, cfg = MODELS["dinov2 tiny"]
    assert_same_tree(init(cfg, 0, "cpu"), jax_trees("dinov2 tiny", "seed 0"))


def test_a_leaf_key_depends_on_its_place_not_on_the_draws_before_it():
    """Drawing a leaf twice from one ParamInit gives it twice; children of
    one split differ."""
    init = tlayers.ParamInit(3, "cpu")
    a, b = init.split()
    assert torch.equal(a.uniform((5, 4), 0.5), a.uniform((5, 4), 0.5))
    assert not torch.equal(a.uniform((5, 4), 0.5), b.uniform((5, 4), 0.5))
    chain = init.chain()
    k1, k2 = next(chain), next(chain)
    want1 = threefry.split(init.key)[1]
    want2 = threefry.split(threefry.split(init.key)[0])[1]
    assert torch.equal(k1.key, want1) and torch.equal(k2.key, want2)


class _Started(Exception):
    """Raised by a spy once a trainer has made its initial trees."""


def test_train_toy_vae_starts_from_the_jax_init(monkeypatch, jax_trees):
    """``train_toy_vae(seed=0)`` starts from JAX's ``init_vae(PRNGKey(0))``
    (``blobctrl_tpu/train/toy.py`` ``train_toy_vae``); stopped there."""
    seen = {}
    real = ttoy.vae_lib.init_vae

    def spy(*args, **kwargs):
        seen["tree"] = real(*args, **kwargs)
        raise _Started
    monkeypatch.setattr(ttoy.vae_lib, "init_vae", spy)
    images = np.zeros((4, 16, 16, 3), np.uint8)
    with pytest.raises(_Started):
        ttoy.train_toy_vae(images, MODELS["vae narrow"][3], steps=1,
                           batch=2, seed=0, device="cpu")
    assert_same_tree(seen["tree"], jax_trees("vae narrow", "seed 0"))


def test_train_toy_diffusion_starts_from_the_jax_init(monkeypatch):
    """``train_toy_diffusion(seed=3)`` starts from JAX's ``init_unet(k_u)``
    and ``init_blobnet(k_b)``, ``k_u, k_b, _ = split(PRNGKey(3), 3)``
    (``blobctrl_tpu/train/toy.py`` ``train_toy_diffusion``); stopped
    there."""
    seen = {}

    def spy(cfg, blobnet_params, unet_params):
        seen.update(blobnet=blobnet_params, unet=unet_params)
        raise _Started
    monkeypatch.setattr(ttoy.ts, "init_train_state", spy)
    with pytest.raises(_Started):
        ttoy.train_toy_diffusion({}, MODELS["unet tiny"][3],
                                 MODELS["blobnet tiny"][3], steps=1,
                                 batch=2, seed=3, device="cpu")
    k_u, k_b, _ = jax.random.split(jax.random.PRNGKey(3), 3)
    assert_same_tree(seen["unet"], junet.init_unet(k_u, JU))
    assert_same_tree(seen["blobnet"], jblob.init_blobnet(k_b, JB))


def test_the_port_makes_no_torch_generator():
    """Every random number of the package comes from ``utils.threefry``:
    no module makes a ``torch.Generator``."""
    import pathlib
    root = pathlib.Path(tflag.__file__).parents[1]
    users = [str(p.relative_to(root)) for p in root.rglob("*.py")
             if "Generator(" in p.read_text()]
    assert not users, users
