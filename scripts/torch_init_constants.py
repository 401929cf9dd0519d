"""Prints ``chip_smoke.py``'s ``JAX_INIT``: the first 8 float32 bit patterns
of a few leaves that the JAX package's init functions draw at production
geometry, for the keys ``apps/flagship.production_params(0)`` and
``benchkit.add_encoders(pipe, seed=3)`` give them. ``chip_smoke.py`` phase 6
holds the port's draw on the card against them.

Each leaf is drawn alone, with JAX's own ``init_conv`` / ``init_linear`` /
``jax.random.normal``, from the key that its tree hands it: ``splits`` is
the path below the tree's key, child i of ``split(key, n)`` for each (n, i),
as ``blobctrl_tpu/models/unet.py`` ``init_unet`` (4 + 2 * 4 children: conv_in,
the time embedding, 4 down blocks, mid, 4 up blocks, conv_out),
``nn/unet_blocks.py`` ``init_mid_block`` (3), ``nn/transformer_2d.py`` (2 +
layers), ``nn/attention.py`` ``init_transformer_block`` (3) and
``init_attention`` (4), ``nn/layers.py`` ``init_linear`` / ``init_conv`` (2,
the first drawn), ``models/vae.py`` ``init_vae`` (64, taken in order; the
decoder's conv_out is the 42nd at SD-1.5's geometry) and
``models/clip_text.py`` ``init`` (4 + 8 * 12, the token table first) split
it. Before that, each path is checked against the whole JAX init at a
narrow config with the same split counts (4 levels, 2 layers a block): the
leaf drawn alone equals the leaf of the tree. No full-size tree is built.

    python scripts/torch_init_constants.py
"""

import dataclasses
import os
import sys
import textwrap

import jax
import numpy as np

jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from blobctrl_tpu.models import blobnet, clip_text, unet, vae  # noqa: E402
from blobctrl_tpu.nn import layers  # noqa: E402

MID_ATTN1_Q = ((12, 6), (3, 2), (3, 1), (3, 0), (4, 0))
# name -> (tree, seed, path in the tree, splits, draw, production shape)
LEAVES = {
    "unet conv_in": ("unet", 0, ("conv_in", "kernel"), ((12, 0),),
                     "conv", (3, 3, 5, 320)),
    "unet mid attn1 to_q": ("unet", 0, ("mid_block", "attentions", 0,
                                        "blocks", 0, "attn1", "to_q",
                                        "kernel"),
                            MID_ATTN1_Q, "linear", (1280, 1280)),
    "blobnet conv_in": ("blobnet", 1, ("conv_in", "kernel"), ((12, 0),),
                        "conv", (3, 3, 1029, 320)),
    "vae decoder conv_out": ("vae", 2, ("decoder", "conv_out", "kernel"),
                             ((64, 41),), "conv", (3, 3, 128, 3)),
    "clip token_embedding": ("clip", 3, ("token_embedding",), ((100, 0),),
                             "normal", (49408, 768)),
}


def leaf_key(seed, splits):
    key = jax.random.PRNGKey(seed)
    for n, i in splits:
        key = jax.random.split(key, n)[i]
    return key


def draw(seed, splits, kind, shape):
    """The leaf drawn alone, as its init function draws it from its key."""
    key = leaf_key(seed, splits)
    if kind == "conv":
        return layers.init_conv(key, *shape)["kernel"]
    if kind == "linear":
        return layers.init_linear(key, *shape)["kernel"]
    return jax.random.normal(key, shape) * 0.02


def narrow_trees():
    """The JAX inits at 4 levels of 8/16/16/16 channels, 2 layers a block,
    the production split counts."""
    boc = (8, 16, 16, 16)
    ucfg = unet.UNetConfig(in_channels=5, block_out_channels=boc,
                           cross_attention_dim=16, num_heads=2,
                           norm_num_groups=4)
    bcfg = blobnet.BlobNetConfig(conditioning_channels=17,
                                 block_out_channels=boc, num_heads=2,
                                 norm_num_groups=4)
    vcfg = vae.VAEConfig(block_out_channels=boc, norm_num_groups=4)
    ccfg = clip_text.CLIPTextConfig(vocab_size=600, hidden_size=16,
                                    intermediate_size=32, num_heads=2)
    return {"unet": (unet.init_unet, ucfg), "blobnet": (blobnet.init_blobnet,
                                                        bcfg),
            "vae": (vae.init_vae, vcfg), "clip": (clip_text.init, ccfg)}


def main():
    trees = narrow_trees()
    for name, (tree, seed, path, splits, kind, _) in LEAVES.items():
        init, cfg = trees[tree]
        want = init(jax.random.PRNGKey(seed), cfg)
        for p in path:
            want = want[p]
        got = draw(seed, splits, kind, want.shape)
        assert np.array_equal(np.asarray(got), np.asarray(want)), name
        print(f"# {name}: the path checked at {dataclasses.asdict(cfg)}",
              file=sys.stderr)
    print("JAX_INIT = {")
    for name, (tree, seed, path, splits, kind, shape) in LEAVES.items():
        leaf = np.asarray(draw(seed, splits, kind, shape), np.float32)
        bits = ", ".join(f"0x{b:08X}" for b in
                         leaf.reshape(-1)[:8].view(np.uint32))
        print(f"    {name!r}: dict(")
        for field, text in (("tree", f"{tree!r}, seed={seed}"),
                            ("path", repr(path)), ("splits", repr(splits)),
                            ("draw", f"{kind!r}, shape={shape!r}"),
                            ("bits", f"({bits})")):
            end = ")," if field == "bits" else ","
            print(textwrap.fill(f"{field}={text}{end}", width=79,
                                initial_indent=" " * 8,
                                subsequent_indent=" " * (10 + len(field)),
                                break_long_words=False))
    print("}")


if __name__ == "__main__":
    main()
