"""The port's text and appearance encoders against the JAX package, on
the CPU in fp32: the CLIP BPE tokenizer (the port on the standard ``re``,
the JAX package on ``regex`` here), tiny CLIP text with and without
clip_skip, tiny DINOv2 at its native and an interpolated position grid,
DINOv2's uint8 preprocessing, and the weight bridge of both trees."""

import jax
import numpy as np
import pytest
import torch

from blobctrl_tpu.models import clip_text as jclip
from blobctrl_tpu.models import dinov2 as jdino
from blobctrl_tpu.tokenizer import clip_bpe as jbpe
from blobctrl_torch.apps import flagship
from blobctrl_torch.models import clip_text as tclip
from blobctrl_torch.models import dinov2 as tdino
from blobctrl_torch.params.from_jax import from_jax
from blobctrl_torch.tokenizer import clip_bpe as tbpe
from blobctrl_torch.utils import benchkit

torch.set_num_threads(2)

# the prompts of tests/test_tokenizer.py, and the session's
PROMPTS = ["hello world", "Hello,   WORLD!", "hello hello hello", "12 12",
           "a photo of a hello", "it's hello's world", "", "héllo wörld"]


def synthetic_vocab():
    """tests/test_tokenizer.py's vocabulary: byte symbols, each with the
    word-end mark, a few merges, BOS and EOS."""
    base = list(tbpe.bytes_to_unicode().values())
    vocab = {ch: i for i, ch in enumerate(base)}
    for ch in base:
        vocab[ch + "</w>"] = len(vocab)
    merges = [("h", "e"), ("l", "l"), ("he", "ll"), ("o</w>", "!"),
              ("hell", "o</w>"), ("w", "o"), ("r", "l"), ("wo", "rl"),
              ("worl", "d</w>"), ("1", "2</w>")]
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    return vocab, merges


@pytest.mark.parametrize("text", PROMPTS + ["a red ball on a table",
                                            "Ⅻ ½ ٣ 日本 x²!"])
def test_tokenizer_ids_equal(text):
    vocab, merges = synthetic_vocab()
    want = jbpe.CLIPTokenizer(vocab, merges)([text])
    got = tbpe.CLIPTokenizer(vocab, merges)([text])
    assert got.dtype == want.dtype and got.shape == (1, 77)
    np.testing.assert_array_equal(got, want)


def test_token_pattern_splits_like_regex():
    """The spelled-out letter and number classes split as ``\\p{L}`` and
    ``\\p{N}`` do, on letters, digits, other numbers and symbols of several
    scripts."""
    text = "héllo wörld 12 ½ Ⅻ it's, a-photo!! ٣ 日本 x² ǅ"
    assert tbpe.token_pattern().findall(text) == jbpe._PAT.findall(text)


def test_byte_level_tokenizer_matches_jax():
    """The vocabulary built in code for the full-width run."""
    tok = benchkit.byte_level_tokenizer()
    ranks = sorted(tok.bpe_ranks, key=tok.bpe_ranks.get)
    jtok = jbpe.CLIPTokenizer(tok.encoder, ranks)
    texts = ["a red ball on a table", "", "a blue table"]
    np.testing.assert_array_equal(tok(texts), jtok(texts))
    assert tok(texts).max() < flagship.clip_vit_l_config().vocab_size


def _tiny_clip():
    ccfg, _ = flagship.tiny_encoder_configs(vocab_size=99)
    jcfg = jclip.CLIPTextConfig(vocab_size=99, hidden_size=16,
                                intermediate_size=32, num_layers=2,
                                num_heads=2)
    assert (ccfg.hidden_size, ccfg.intermediate_size, ccfg.num_layers,
            ccfg.num_heads) == (16, 32, 2, 2)
    jp = jclip.init(jax.random.PRNGKey(1), jcfg)
    return jcfg, jp, ccfg, from_jax(jp, device="cpu")


@pytest.mark.parametrize("clip_skip", [None, 1])
def test_tiny_clip_matches_jax(clip_skip):
    """fp32, atol 1e-5: the same operations, sums in another order."""
    jcfg, jp, tcfg, tp = _tiny_clip()
    ids = np.random.RandomState(3).randint(0, 99, (2, 77)).astype(np.int32)
    want = np.asarray(jclip.encode_with_clip_skip(jp, jcfg, ids, clip_skip))
    got = tclip.encode_with_clip_skip(tp, tcfg, torch.from_numpy(ids),
                                      clip_skip).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(
        tclip.apply(tp, tcfg, torch.from_numpy(ids)).numpy(),
        np.asarray(jclip.apply(jp, jcfg, ids)), atol=1e-5, rtol=0)


@pytest.mark.parametrize("image_size,px", [(28, 28), (56, 28), (56, 42)])
def test_tiny_dinov2_matches_jax(image_size, px):
    """Native grid (28 -> 2x2 patches), and position tables interpolated
    bicubically from a 4x4 grid to 2x2 and 3x3; fp32, atol 1e-5."""
    jcfg = jdino.DINOv2Config(hidden_size=16, num_layers=2, num_heads=2,
                              intermediate_size=32, patch_size=14,
                              image_size=image_size)
    _, tcfg = flagship.tiny_encoder_configs()
    tcfg = tdino.DINOv2Config(**{**tcfg.__dict__, "image_size": image_size})
    jp = jdino.init(jax.random.PRNGKey(2), jcfg)
    tp = from_jax(jp, device="cpu")
    x = np.random.RandomState(4).randn(2, px, px, 3).astype(np.float32)
    jh, jpool = jdino.apply(jp, jcfg, x)
    th, tpool = tdino.apply(tp, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tpool.numpy(), np.asarray(jpool), atol=1e-5,
                               rtol=0)


def test_bicubic_matrix_matches_jax():
    for src, dst in [(37, 16), (4, 2), (4, 3), (5, 9)]:
        np.testing.assert_array_equal(tdino.torch_bicubic_matrix(src, dst),
                                      jdino._torch_bicubic_matrix(src, dst))


@pytest.mark.parametrize("shape,size", [((512, 512), 224), ((480, 640), 224),
                                        ((64, 64), 28), ((50, 90), 28)])
def test_preprocess_u8_bit_equal(shape, size):
    pytest.importorskip("PIL")
    imgs = np.random.RandomState(5).randint(0, 256, (2,) + shape + (3,)
                                            ).astype(np.uint8)
    want = jdino.preprocess_u8(imgs, size=size)
    got = tdino.preprocess_u8(imgs, size=size)
    np.testing.assert_array_equal(got, want)
    # and the device half, in fp32
    np.testing.assert_array_equal(
        tdino.normalize_pixels(torch.from_numpy(got)).numpy(),
        np.asarray(jdino.normalize_pixels(want)))


def test_from_jax_keeps_encoder_trees():
    """The weight bridge carries the CLIP and DINOv2 trees across with the
    JAX package's names and shapes (token_embedding, cls_token, the
    LayerScale vectors ls1 and ls2)."""
    _, jp, _, tp = _tiny_clip()
    assert tp["token_embedding"].shape == (99, 16)
    np.testing.assert_array_equal(tp["token_embedding"].numpy(),
                                  np.asarray(jp["token_embedding"]))
    jcfg = jdino.DINOv2Config(hidden_size=16, num_layers=2, num_heads=2,
                              intermediate_size=32, image_size=28)
    jd = jdino.init(jax.random.PRNGKey(0), jcfg)
    td = from_jax(jd, device="cpu", dtype=torch.bfloat16)
    assert td["cls_token"].shape == (1, 16)
    assert td["cls_token"].dtype == torch.bfloat16
    for name in ("ls1", "ls2"):
        want = torch.from_numpy(np.array(jd["layers"][1][name],
                                           np.float32)).to(torch.bfloat16)
        assert torch.equal(td["layers"][1][name], want)
    assert set(td["layers"][0]) == set(jd["layers"][0])


def test_encoder_init_matches_jax_structure():
    """The port's random init draws the JAX ``init`` tree: the same keys
    and shapes."""
    ccfg, dcfg = flagship.tiny_encoder_configs()
    for jinit, tinit, jcfg, tcfg in [
            (jclip.init, tclip.init,
             jclip.CLIPTextConfig(**ccfg.__dict__), ccfg),
            (jdino.init, tdino.init, jdino.DINOv2Config(**dcfg.__dict__),
             dcfg)]:
        want = jax.tree_util.tree_map(np.shape, jinit(jax.random.PRNGKey(0),
                                                      jcfg))
        got = jax.tree_util.tree_map(lambda t: tuple(t.shape),
                                     tinit(tcfg, device="cpu"))
        assert got == want
