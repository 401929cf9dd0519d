"""The port's blocks on local shards over gloo ranks on the CPU, against
the JAX package's sharded blocks and against the port unsharded.

The JAX side runs as ``tests/test_kernel_sharding.py`` runs it: on the
conftest's 8 virtual CPU devices, the Pallas kernels in interpret mode
inside ``kernel_sharding``'s shard_maps. The port side spawns 2 or 4
ranks (``tests/torch_ranks.py``), each holding its slice of the same
weights: a resnet block (conv1 and time_emb_proj column-parallel, norm2
and conv2 row-parallel on local GroupNorm groups), a transformer block
(local heads of self- and cross-attention, paired GEGLU halves, to_out
and proj_out row-parallel) and the VAE's mid block (its single-head
attention whole). Every rank must return the same output, within 1e-5
of the output's largest magnitude of both references in fp32, and its
collective log must be the block's derived count: one all-reduce per
sharded row-parallel layer, none for a layer left whole."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from blobctrl_tpu.models import vae as jvae
from blobctrl_tpu.nn import attention as jattn
from blobctrl_tpu.nn import resnet as jres
from blobctrl_tpu.parallel import kernel_sharding as jks
from blobctrl_tpu.parallel import mesh as jmesh
from blobctrl_torch.models import vae as tvae
from blobctrl_torch.nn import attention as tattn
from blobctrl_torch.nn import resnet as tres
from blobctrl_torch.params.from_jax import from_jax
from tests import torch_ranks

torch.set_num_threads(2)

# (data, model, the axes the weights spread over)
RECIPES = [(1, 2, ("model",)), (1, 4, ("model",)), (2, 2, ("data", "model"))]


@pytest.fixture
def interpret_kernels():
    jres.set_conv_backend("interpret")
    jattn.set_attention_backend("interpret")
    yield
    jres.set_conv_backend("auto")
    jattn.set_attention_backend("auto")


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _jax_sharded(fn, params, inputs, data, model, axes):
    mesh = jmesh.make_mesh(data=data, model=model)
    ps = jmesh.shard_params(mesh, params, model_parallel=True, axes=axes)
    profiles = {"m": jks.KernelProfile(mesh, model=axes)}

    def run(p, *xs):
        with jks.activate(profiles), jks.scope("m"):
            return fn(p, *xs)
    xs = [None if x is None else jax.device_put(
        x, NamedSharding(mesh, P())) for x in inputs]
    return np.asarray(jax.jit(run)(ps, *xs))


def _check(outs, want_jax, want_port, counts, expected):
    scale = float(np.abs(want_jax).max())
    for out, c in zip(outs, counts):
        assert np.array_equal(out, outs[0])  # every rank holds the result
        assert np.abs(out - want_jax).max() <= 1e-5 * scale
        assert np.abs(out - want_port).max() <= 1e-5 * scale
        assert c == expected, (c, expected)


def _cases():
    """The three blocks: {kind: (JAX fn, params, inputs, heads, groups,
    the port's unsharded fn)}."""
    heads = 8
    res = jres.init_resnet_block(jax.random.PRNGKey(0), 64, 128, 32)
    blk = jattn.init_transformer_block(jax.random.PRNGKey(3), 64, heads, 32)
    vcfg = jvae.VAEConfig(block_out_channels=(32, 64), layers_per_block=1,
                          norm_num_groups=8)
    mid = jvae.init_vae(jax.random.PRNGKey(6), vcfg)["encoder"]["mid_block"]
    return {
        "resnet": (lambda p, x, t: jres.resnet_block(p, x, t), res,
                   [jax.random.normal(jax.random.PRNGKey(1), (2, 16, 16, 64)),
                    jax.random.normal(jax.random.PRNGKey(2), (2, 32))],
                   None, 32, lambda p, x, t: tres.resnet_block(p, x, t, 32)),
        "transformer": (
            lambda p, x, c: jattn.transformer_block(p, x, heads, c), blk,
            [jax.random.normal(jax.random.PRNGKey(4), (2, 128, 64)),
             jax.random.normal(jax.random.PRNGKey(5), (2, 7, 32))],
            heads, None,
            lambda p, x, c: tattn.transformer_block(p, x, heads, c)),
        "vae_mid": (lambda p, x: jvae._mid_block(p, x, 8), mid,
                    [jax.random.normal(jax.random.PRNGKey(7),
                                       (1, 16, 16, 64))],
                    1, 8, lambda p, x: tvae._mid_block(p, x, 8)),
    }


_RUNS = {}


def _sharded_blocks(data, model, axes):
    """{kind: (JAX sharded output, port unsharded output, [(rank output,
    rank counts)])} of the three blocks, on one group of ranks a recipe."""
    key = (data, model, axes)
    if key not in _RUNS:
        cases = _cases()
        ranks = torch_ranks.run_ranks(
            torch_ranks.block_rank, data * model,
            {"data": data, "model": model}, axes,
            [(kind, _np(p), [np.array(x) for x in xs], heads, groups)
             for kind, (_, p, xs, heads, groups, _) in cases.items()])
        out = {}
        for i, (kind, (jfn, p, xs, _, _, tfn)) in enumerate(cases.items()):
            want = _jax_sharded(jfn, p, xs, data, model, axes)
            with torch.no_grad():
                plain = tfn(from_jax(_np(p), device="cpu"),
                            *[torch.as_tensor(np.array(x)) for x in xs])
            out[kind] = (want, plain.numpy(), [r[i] for r in ranks])
        _RUNS[key] = out
    return _RUNS[key]


def _check_block(kind, data, model, axes, expected):
    want, plain, ranks = _sharded_blocks(data, model, axes)[kind]
    _check([r[0] for r in ranks], want, plain, [r[1] for r in ranks],
           expected)


@pytest.mark.parametrize("data,model,axes", RECIPES)
def test_resnet_block_matches_jax_sharded(interpret_kernels, data, model,
                                          axes):
    _check_block("resnet", data, model, axes, {"m": {"all_reduce": 1}})


@pytest.mark.parametrize("data,model,axes", RECIPES)
def test_transformer_block_matches_jax_sharded(interpret_kernels, data,
                                               model, axes):
    # attn1, attn2 and the GEGLU: one all-reduce each
    _check_block("transformer", data, model, axes, {"m": {"all_reduce": 3}})


@pytest.mark.parametrize("data,model,axes", RECIPES)
def test_vae_mid_block_matches_jax_sharded(interpret_kernels, data, model,
                                           axes):
    # two resnets; the single-head attention stays whole (no collective)
    _check_block("vae_mid", data, model, axes, {"m": {"all_reduce": 2}})


@pytest.mark.parametrize("kind", ["resnet", "transformer"])
def test_indivisible_widths_fall_back_to_whole(interpret_kernels, kind):
    """Widths the model axes do not divide run whole, as JAX's do: a resnet
    of 12 channels over 8 ranks, a transformer block whose 2 heads do not
    divide 4 ranks (its GEGLU, 4 * 64 wide, still shards: one all-reduce)."""
    if kind == "resnet":
        p = jres.init_resnet_block(jax.random.PRNGKey(0), 12, 12, None)
        xs = [jax.random.normal(jax.random.PRNGKey(1), (1, 8, 8, 12)), None]
        data, model, heads, groups = 1, 8, None, 4
        want = _jax_sharded(lambda p, x, t: jres.resnet_block(
            p, x, t, norm_groups=4), p, xs, data, model, ("model",))
        expected = {}
    else:
        heads = 2
        p = jattn.init_transformer_block(jax.random.PRNGKey(3), 64, heads,
                                         32)
        xs = [jax.random.normal(jax.random.PRNGKey(4), (1, 128, 64)),
              jax.random.normal(jax.random.PRNGKey(5), (1, 7, 32))]
        data, model, groups = 1, 4, None
        want = _jax_sharded(
            lambda p, x, c: jattn.transformer_block(p, x, heads, c), p, xs,
            data, model, ("model",))
        expected = {"m": {"all_reduce": 1}}
    res = torch_ranks.run_ranks(
        torch_ranks.block_rank, data * model, {"data": data, "model": model},
        ("model",), [(kind, _np(p), [None if x is None else np.array(x)
                                     for x in xs], heads, groups)])
    scale = float(np.abs(want).max())
    for [(out, counts)] in res:
        assert np.abs(out - want).max() <= 1e-5 * scale
        assert counts == expected
