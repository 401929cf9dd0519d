"""The port's SAM (``blobctrl_torch.models.sam``, ``params.convert_sam``,
``params.io.load_sam``, ``params.export.sam_state_dict``) against the JAX
package, on the CPU in fp32 at tiny configs.

The weights are a transformers ``SamModel`` drawn from a seed, the config
of ``tests/test_sam_parity.py`` (window 2 on the 4-token grid, and window
3, whose grid pads to 6), in both key formats (transformers' and the
original segment_anything checkpoint's, renamed as that test renames
them). Both converters must give bit-equal leaves; the JAX tree goes
across with ``from_jax``. Inputs are numpy-seeded. Bars: embeddings, mask
logits and iou within 1e-4 of max |JAX| (``close``); ``preprocess_image``
bit-equal; post-processed masks equal wherever the JAX logits lie beyond
1e-4 of their max."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blobctrl_tpu.models import sam as jsam
from blobctrl_tpu.nn import layers as jlayers
from blobctrl_tpu.params import convert_sam as jconvert
from blobctrl_torch.models import sam as tsam
from blobctrl_torch.params import convert_sam as tconvert
from blobctrl_torch.params import export
from blobctrl_torch.params import io as tio
from blobctrl_torch.params.from_jax import from_jax

torch.set_num_threads(2)

TOL = 1e-4  # relative to max |JAX|


def close(got, want, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= TOL, f"{name}: {err:.3e} of max |JAX|"


def transformers_sam(window: int, seed: int = 0):
    from transformers import SamConfig, SamModel
    torch.manual_seed(seed)
    cfg = SamConfig(
        vision_config=dict(hidden_size=32, num_hidden_layers=3,
                           num_attention_heads=2, image_size=64,
                           patch_size=16, global_attn_indexes=[1],
                           window_size=window, output_channels=16,
                           mlp_dim=64, num_pos_feats=8),
        prompt_encoder_config=dict(hidden_size=16, image_embedding_size=4,
                                   image_size=64, mask_input_channels=4,
                                   num_pos_feats=8),
        mask_decoder_config=dict(hidden_size=16, num_attention_heads=2,
                                 iou_head_hidden_dim=16, mlp_dim=32))
    sd = SamModel(cfg).eval().state_dict()
    # the model draws some tables as zeros; seeded noise makes every leaf
    # count (a swapped or transposed leaf then shows)
    gen = torch.Generator().manual_seed(seed + 1)
    return {k: v + 0.05 * torch.randn(v.shape, generator=gen)
            if v.is_floating_point() else v for k, v in sd.items()}


def original_keys(sd):
    """transformers' SamModel keys -> the original checkpoint's (the
    renaming of tests/test_sam_parity.py)."""
    orig = {}
    for k, v in sd.items():
        if k == "shared_image_embedding.positional_embedding":
            continue
        nk = (k.replace("vision_encoder.layers.", "image_encoder.blocks.")
              .replace("vision_encoder.patch_embed.projection.",
                       "image_encoder.patch_embed.proj.")
              .replace("vision_encoder.pos_embed", "image_encoder.pos_embed")
              .replace("vision_encoder.neck.conv1.", "image_encoder.neck.0.")
              .replace("vision_encoder.neck.layer_norm1.",
                       "image_encoder.neck.1.")
              .replace("vision_encoder.neck.conv2.", "image_encoder.neck.2.")
              .replace("vision_encoder.neck.layer_norm2.",
                       "image_encoder.neck.3."))
        if nk.startswith(("image_encoder.blocks.",
                          "mask_decoder.transformer.layers.")):
            for i in range(1, 5):
                nk = nk.replace(f".layer_norm{i}.", f".norm{i}.")
        nk = (nk.replace("transformer.layer_norm_final_attn.",
                         "transformer.norm_final_attn.")
              .replace("prompt_encoder.shared_embedding.positional_embedding",
                       "prompt_encoder.pe_layer."
                       "positional_encoding_gaussian_matrix")
              .replace("prompt_encoder.point_embed.",
                       "prompt_encoder.point_embeddings.")
              .replace("mask_decoder.upscale_conv1.",
                       "mask_decoder.output_upscaling.0.")
              .replace("mask_decoder.upscale_layer_norm.",
                       "mask_decoder.output_upscaling.1.")
              .replace("mask_decoder.upscale_conv2.",
                       "mask_decoder.output_upscaling.3."))
        if "hypernetworks" in nk or "iou_prediction_head" in nk:
            if ".proj_in." in nk:
                nk = nk.replace(".proj_in.", ".layers.0.")
            elif ".proj_out." in nk:
                nk = nk.replace(".proj_out.", ".layers.2.")
            elif ".layers." in nk:
                head, tail = nk.split(".layers.", 1)
                idx, leaf = tail.split(".", 1)
                nk = f"{head}.layers.{int(idx) + 1}.{leaf}"
        orig[nk] = v
    return orig


def configs(window: int):
    jcfg = jsam.SAMConfig(
        hidden_size=32, num_layers=3, num_heads=2, mlp_dim=64, patch_size=16,
        image_size=64, window_size=window, global_attn_indexes=(1,),
        output_channels=16, prompt_dim=16, decoder_heads=2,
        decoder_mlp_dim=32)
    return jcfg, tsam.SAMConfig(**dataclasses.asdict(jcfg))


@pytest.fixture(scope="module", params=[2, 3], ids=["window2", "window3pad"])
def tiny(request):
    sd = transformers_sam(request.param)
    jparams = jconvert.convert_sam(sd)
    jcfg, tcfg = configs(request.param)
    return dict(sd=sd, jparams=jparams, tparams=from_jax(jparams, "cpu"),
                jcfg=jcfg, tcfg=tcfg)


def leaves_equal(port_tree, jax_tree):
    """Every leaf of the port's tree bit-equal to the JAX tree's, the same
    structure."""
    flat_t = export.flatten(port_tree)
    flat_j = export.flatten(jax.tree_util.tree_map(np.asarray, jax_tree))
    assert set(flat_t) == set(flat_j), sorted(set(flat_t) ^ set(flat_j))
    for k, want in flat_j.items():
        got = flat_t[k]
        got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
        assert got.dtype == np.float32 and got.shape == want.shape, k
        assert np.array_equal(got, want), k


@pytest.mark.parametrize("fmt", ["transformers", "original"])
def test_converters_give_bit_equal_leaves(tiny, fmt):
    sd = tiny["sd"] if fmt == "transformers" else original_keys(tiny["sd"])
    leaves_equal(tconvert.convert_sam(sd), jconvert.convert_sam(sd))
    leaves_equal(tconvert.convert_sam(sd), tiny["jparams"])


def test_vision_encoder(tiny):
    """At window 3 the 4-token grid pads to 6 after layer_norm1."""
    px = np.random.RandomState(1).randn(2, 64, 64, 3).astype(np.float32)
    want = jsam.vision_encoder(tiny["jparams"]["vision"], tiny["jcfg"],
                               jnp.asarray(px))
    got = tsam.vision_encoder(tiny["tparams"]["vision"], tiny["tcfg"],
                              torch.from_numpy(px))
    close(got, want, "vision_encoder")


@pytest.mark.parametrize("q,k,n", [(4, 4, 7), (6, 6, 11), (4, 4, 5),
                                   (14, 14, 9), (3, 5, 9), (5, 3, 4)],
                         ids=["table", "table6", "interp_down",
                              "interp_up", "q_lt_k", "q_gt_k_interp"])
def test_get_rel_pos(q, k, n):
    """Both branches: a table of the span's length is indexed as it is,
    another is linearly resized first."""
    table = np.random.RandomState(n).randn(n, 8).astype(np.float32)
    want = jsam._get_rel_pos(q, k, jnp.asarray(table))
    got = tsam._get_rel_pos(q, k, torch.from_numpy(table))
    assert got.shape == tuple(want.shape)
    close(got, want, "rel_pos")
    if n == 2 * max(q, k) - 1:
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_prompt_encoder(tiny):
    """Labels 1, 0 and -1, with the padding point appended; the dense
    no-mask embedding and the grid's positional encoding."""
    pts = np.array([[[10.3, 40.0], [55.0, 2.5], [0.0, 0.0]]], np.float32)
    lbs = np.array([[1, 0, -1]], np.int32)
    jp, tp = tiny["jparams"]["prompt"], tiny["tparams"]["prompt"]
    jc, tc = tiny["jcfg"], tiny["tcfg"]
    want = jsam.encode_points(jp, jc, jnp.asarray(pts), jnp.asarray(lbs))
    got = tsam.encode_points(tp, tc, torch.from_numpy(pts),
                             torch.from_numpy(lbs))
    assert got.shape == (1, 4, 16)
    close(got, want, "encode_points")
    close(tsam.dense_no_mask_embedding(tp, tc, 2),
          jsam.dense_no_mask_embedding(jp, jc, 2), "dense")
    close(tsam.image_grid_pe(tp, tc), jsam.image_grid_pe(jp, jc), "grid_pe")


def test_mask_decoder(tiny):
    rng = np.random.RandomState(2)
    emb = rng.randn(2, 4, 4, 16).astype(np.float32)
    sparse = rng.randn(2, 3, 16).astype(np.float32)
    jc, tc = tiny["jcfg"], tiny["tcfg"]
    jd, td = tiny["jparams"], tiny["tparams"]
    jm, ji = jsam.mask_decoder(
        jd["decoder"], jc, jnp.asarray(emb),
        jsam.image_grid_pe(jd["prompt"], jc), jnp.asarray(sparse),
        jsam.dense_no_mask_embedding(jd["prompt"], jc, 2))
    tm, ti = tsam.mask_decoder(
        td["decoder"], tc, torch.from_numpy(emb),
        tsam.image_grid_pe(td["prompt"], tc), torch.from_numpy(sparse),
        tsam.dense_no_mask_embedding(td["prompt"], tc, 2))
    assert tm.shape == (2, 4, 16, 16) and ti.shape == (2, 4)
    close(tm, jm, "masks")
    close(ti, ji, "iou")
    for multi in (True, False):
        for got, want in zip(tsam.select_mask(tm, ti, multi),
                             jsam.select_mask(jm, ji, multi)):
            close(got, want, "select_mask")


def test_conv_transpose_keeps_the_four_taps_apart():
    """A 2x2 stride-2 transposed conv whose four taps differ: each output
    sub-pixel (dy, dx) is its own tap, as torch's ConvTranspose2d (the
    truth, on the torch layout) and the JAX package compute it."""
    rng = np.random.RandomState(3)
    c_in, c_out = 3, 2
    w_torch = np.zeros((c_in, c_out, 2, 2), np.float32)
    for dy in range(2):
        for dx in range(2):
            w_torch[:, :, dy, dx] = (1 + dy * 2 + dx) * 10.0 + rng.randn(
                c_in, c_out)
    bias = rng.randn(c_out).astype(np.float32)
    x = rng.randn(1, 3, 4, c_in).astype(np.float32)
    kernel = w_torch.transpose(2, 3, 1, 0)  # the tree's (kh, kw, out, in)
    truth = torch.nn.functional.conv_transpose2d(
        torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(w_torch),
        torch.from_numpy(bias), stride=2).permute(0, 2, 3, 1)
    got = tsam._conv_transpose({"kernel": torch.from_numpy(kernel),
                                "bias": torch.from_numpy(bias)},
                               torch.from_numpy(x), 2)
    want = jsam._conv_transpose({"kernel": jnp.asarray(kernel),
                                 "bias": jnp.asarray(bias)}, jnp.asarray(x), 2)
    assert got.shape == (1, 6, 8, c_out)
    close(got, truth, "against ConvTranspose2d")
    close(got, want, "against JAX")
    # a single input pixel lights one 2x2 block, tap (dy, dx) at (dy, dx)
    one = np.zeros((1, 1, 1, c_in), np.float32)
    one[..., 0] = 1.0
    block = tsam._conv_transpose({"kernel": torch.from_numpy(kernel)},
                                 torch.from_numpy(one), 2)[0, :, :, 0]
    assert np.array_equal(block.numpy(), w_torch[0, 0])


@pytest.mark.parametrize("hw", [(300, 300), (480, 640), (37, 53)])
def test_preprocess_image_bit_equal(hw):
    img = np.random.RandomState(hw[0]).randint(0, 256, hw + (3,)).astype(
        np.uint8)
    cfg = jsam.SAMConfig.vit_h()
    want = jsam.preprocess_image(img, cfg)
    got = tsam.preprocess_image(img, tsam.SAMConfig.vit_h())
    assert got[1:] == want[1:]
    assert got[0].dtype == np.float32 and np.array_equal(got[0], want[0])


def test_transform_points():
    pts = np.array([[10.5, 3.0], [479.0, 639.0]], np.float32)
    for hw in ((480, 640), (640, 480), (512, 512)):
        assert np.array_equal(
            tsam.transform_points(pts, hw, tsam.SAMConfig.vit_h()),
            jsam.transform_points(pts, hw, jsam.SAMConfig.vit_h()))


def jax_upsampled_logits(low, orig_hw, resized_hw, image_size):
    """JAX's postprocess_masks before the threshold."""
    m = jnp.asarray(low, jnp.float32)
    b, nm, gh, gw = m.shape
    m = jlayers.bilinear_resize(m.reshape(b * nm, gh, gw, 1), image_size,
                                image_size)
    m = m[:, :resized_hw[0], :resized_hw[1], :]
    m = jlayers.bilinear_resize(m, orig_hw[0], orig_hw[1])
    return np.asarray(m.reshape(b, nm, orig_hw[0], orig_hw[1]))


def assert_masks_agree(got, low, orig_hw, resized_hw, image_size):
    """Masks equal wherever the JAX logits lie beyond 1e-4 of their max."""
    logits = jax_upsampled_logits(low, orig_hw, resized_hw, image_size)
    assert got.shape == logits.shape and got.dtype == bool
    sure = np.abs(logits) > TOL * np.abs(logits).max()
    assert sure.mean() > 0.9
    assert np.array_equal(got[sure], (logits > 0)[sure])


@pytest.mark.parametrize("orig_hw", [(48, 40), (64, 64), (30, 90)])
def test_postprocess_masks(orig_hw):
    cfg = jsam.SAMConfig(image_size=64)
    low = np.random.RandomState(4).randn(1, 3, 16, 16).astype(np.float32)
    scale = 64 / max(orig_hw)
    resized = (int(orig_hw[0] * scale + 0.5), int(orig_hw[1] * scale + 0.5))
    got = tsam.postprocess_masks(torch.from_numpy(low), orig_hw, resized,
                                 tsam.SAMConfig(image_size=64))
    assert_masks_agree(got, low, orig_hw, resized, 64)
    want = jsam.postprocess_masks(jnp.asarray(low), orig_hw, resized, cfg)
    assert (got != want).mean() < 1e-3


@pytest.mark.parametrize("multimask", [False, True])
def test_predictor_end_to_end(tiny, multimask):
    img = np.random.RandomState(5).randint(0, 256, (48, 40, 3)).astype(
        np.uint8)
    pts = np.array([[20.0, 10.0], [5.0, 30.0]], np.float32)
    lbs = np.array([1, 0])
    jp = jsam.SamPredictor(tiny["jparams"], tiny["jcfg"])
    tp = tsam.SamPredictor(tiny["tparams"], tiny["tcfg"], device="cpu")
    jp.set_image(img)
    tp.set_image(img)
    close(tp._embedding, jp._embedding, "embedding")
    assert tp._embedding.device.type == "cpu"
    jm, ji, jl = jp.predict(pts, lbs, multimask_output=multimask)
    tm, ti, tl = tp.predict(pts, lbs, multimask_output=multimask)
    n = 3 if multimask else 1
    assert tl.shape == (n, 16, 16) and ti.shape == (n,)
    close(tl, jl, "low-res logits")
    close(ti, ji, "iou")
    assert_masks_agree(tm[None], jl[None], (48, 40), jp._resized_hw, 64)


def test_predictor_needs_the_card_and_its_params_device(tiny):
    with pytest.raises(RuntimeError, match="CUDA"):
        tsam.SamPredictor(tiny["tparams"], tiny["tcfg"])
    with pytest.raises(RuntimeError, match="set_image"):
        tsam.SamPredictor(tiny["tparams"], tiny["tcfg"],
                          device="cpu").predict(np.zeros((1, 2)), [1])


@pytest.mark.parametrize("fmt,wrapped", [("transformers", False),
                                         ("original", False),
                                         ("original", True)])
def test_load_sam(tiny, tmp_path, fmt, wrapped):
    """A ``torch.save``d file in either format, bare or under
    ``state_dict``, loads bit-equal to the JAX converter's tree, on the CPU
    when asked and refused without a card otherwise."""
    sd = tiny["sd"] if fmt == "transformers" else original_keys(tiny["sd"])
    path = str(tmp_path / "sam.pth")
    torch.save({"state_dict": sd} if wrapped else sd, path)
    got = tio.load_sam(path, device="cpu")
    leaves_equal(got, tiny["jparams"])
    assert all(t.device.type == "cpu" for t in export.flatten(got).values())
    with pytest.raises(RuntimeError, match="CUDA"):
        tio.load_sam(path)


def test_sam_state_dict_is_the_original_format(tiny, tmp_path):
    """The exporter writes the original checkpoint's keys: the JAX
    converter reads them into the same tree, they are the keys the renaming
    above gives, and ``save_sam`` then ``load_sam`` round-trips."""
    sd = export.sam_state_dict(tiny["tparams"])
    # all but the mask-input convs, which the point path does not use
    assert set(sd) == {k for k in original_keys(tiny["sd"])
                       if not k.startswith("prompt_encoder.mask_embed.")}
    leaves_equal(tiny["tparams"], jconvert.convert_sam(
        {k: v.contiguous() for k, v in sd.items()}))
    path = str(tmp_path / "sam_vit_h_4b8939.pth")
    assert export.save_sam(path, tiny["tparams"]) > 0
    leaves_equal(tio.load_sam(path, device="cpu"), tiny["jparams"])


def test_init_has_the_converted_structure(tiny):
    """``init`` draws a tree of the converter's structure and shapes."""
    drawn = export.flatten(tsam.init(tiny["tcfg"], key=3, device="cpu"))
    conv = export.flatten(tiny["tparams"])
    assert {k: tuple(v.shape) for k, v in drawn.items()} == {
        k: tuple(v.shape) for k, v in conv.items()}
    with pytest.raises(RuntimeError, match="CUDA"):
        tsam.init(tiny["tcfg"])


def test_session_click_through_the_ported_predictor(tiny):
    """``BlobCtrlSession.click`` with each package's own predictor on the
    same weights: the session's image reaches the encoder, each click
    re-runs the decoder over all points so far, and the mask is the JAX
    session's wherever the JAX logits lie beyond 1e-4 of their max."""
    from blobctrl_tpu.apps import session as jsession
    from blobctrl_torch.apps import session as tsession
    j = jsession.BlobCtrlSession(
        None, sam_predictor=jsam.SamPredictor(tiny["jparams"], tiny["jcfg"]),
        size=64)
    t = tsession.BlobCtrlSession(
        None, sam_predictor=tsam.SamPredictor(tiny["tparams"], tiny["tcfg"],
                                              device="cpu"),
        size=64, device="cpu")
    img = np.random.RandomState(6).randint(0, 256, (80, 90, 3)).astype(
        np.uint8)
    assert np.array_equal(t.set_image(img), j.set_image(img))
    close(t.sam._embedding, j.sam._embedding, "embedding")
    for x, y, lb in ((32, 30, 1), (10, 12, 0), (50, 40, 1)):
        jm, tm = j.click(x, y, lb), t.click(x, y, lb)
        assert tm.dtype == np.uint8 and tm.shape == (64, 64)
        pts = np.asarray([p[:2] for p in j.selected_points], np.float32)
        lbs = np.asarray([p[2] for p in j.selected_points], np.int32)
        _, _, low = j.sam.predict(pts, lbs)
        assert_masks_agree(tm[None, None] > 0, low[None], (64, 64),
                           j.sam._resized_hw, 64)
        assert (tm != jm).mean() < 1e-3
    assert t.selected_points == j.selected_points
