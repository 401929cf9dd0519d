"""The port's Megatron table and rank helpers (``blobctrl_torch.parallel``)
against the JAX package's ``parallel/mesh.py`` and ``multihost.py``, with
no process group: ``parse_mesh_spec`` (equal results and errors), the
placement of every leaf of the tiny UNet, BlobNet and VAE trees (equal to
JAX's ``param_shardings`` but for the four deviations of
``blobctrl_torch/parallel/mesh.py``, each asserted), local slices that
reassemble to the full leaves, the derived collective count, the rows a
rank owns and the bring-up's refusals."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from blobctrl_tpu.parallel import mesh as jmesh
from blobctrl_tpu.parallel import multihost as jmultihost
from blobctrl_torch.models import unet as tunet
from blobctrl_torch.ops import conv3x3 as tconv
from blobctrl_torch.ops import winograd as twino
from blobctrl_torch.params.from_jax import from_jax
from blobctrl_torch.parallel import collectives, multihost
from blobctrl_torch.parallel import mesh as tmesh
from tests.test_torch_loaders import tiny_trees

torch.set_num_threads(2)

# (data, model, the axes the weights spread over)
RECIPES = [(1, 2, ("model",)), (1, 4, ("model",)), (2, 2, ("data", "model"))]


@pytest.fixture(scope="module")
def trees():
    trees_np, cfgs = tiny_trees(seed=3)
    return trees_np, cfgs


def _flat(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{path}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{path}.{i}")
    else:
        yield path, tree


def _heads_groups(net, cfgs):
    if net == "vae":
        return 1, cfgs["vae"].norm_num_groups
    return cfgs[net].num_heads, cfgs[net].norm_num_groups


@pytest.mark.parametrize("spec", [
    "data=2,model=4", "model=2", "data=auto,model=2", "model=2,data=1",
    " data = 3 ", "data=,model=", "", "model=auto"])
def test_parse_mesh_spec_matches_jax(spec):
    assert tmesh.parse_mesh_spec(spec) == jmesh.parse_mesh_spec(spec)


@pytest.mark.parametrize("spec", ["data2", "pipe=2", "model=0", "data=-1",
                                  "data=x"])
def test_parse_mesh_spec_errors_match_jax(spec):
    with pytest.raises(ValueError) as want:
        jmesh.parse_mesh_spec(spec)
    with pytest.raises(ValueError) as got:
        tmesh.parse_mesh_spec(spec)
    assert str(got.value) == str(want.value)


def _deviation(path, jspec, tspec, layout, heads, msz, ax):
    """Which stated deviation explains a difference, or None."""
    keys = path.strip(".").split(".")
    if keys[-2] in ("norm", "norm1", "norm2", "norm3", "conv_norm_out"):
        resnet_norm2 = keys[-2] == "norm2" and "resnets" in keys
        if resnet_norm2:
            assert tspec == (ax,), (path, tspec)
        else:
            assert tspec == () and jspec in ((), (ax,)), (path, jspec)
        return "norms"
    if any(k in ("to_q", "to_k", "to_v", "to_out") for k in keys):
        assert heads % msz, (path, heads, msz)
        assert tspec == () and jspec != (), (path, jspec)
        return "heads"
    return None


@pytest.mark.parametrize("data,model,axes", RECIPES)
@pytest.mark.parametrize("net", ["unet", "blobnet", "vae"])
def test_param_specs_match_jax_but_for_the_deviations(trees, net, data,
                                                      model, axes):
    trees_np, cfgs = trees
    heads, groups = _heads_groups(net, cfgs)
    jm = jmesh.make_mesh(data=data, model=model)
    jspecs = {
        "." + ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path): tuple(sh.spec)
        for path, sh in jax.tree_util.tree_flatten_with_path(
            jmesh.param_shardings(jm, trees_np[net], True, axes))[0]}
    tm = tmesh.Mesh({"data": data, "model": model})
    tree = from_jax(trees_np[net], device="cpu")
    tspecs = _spec_leaves(tmesh.param_specs(tm, tree, True, axes, heads,
                                            groups))
    assert set(tspecs) == set(jspecs)
    ax = axes[0] if len(axes) == 1 else tuple(axes)
    msz = data * model if len(axes) == 2 else model
    seen = set()
    for path, (tspec, layout) in tspecs.items():
        jspec = jspecs[path]
        if ".ff.proj_in." in path and tspec:
            assert layout == "paired" and tspec == jspec, (path, tspec)
            seen.add("paired")
            continue
        assert layout == "contiguous", path
        if tspec != jspec:
            seen.add(_deviation(path, jspec, tspec, layout, heads, msz, ax))
    assert None not in seen, seen
    # every tree has norms; the toy's 2 heads do not divide 4 ranks, the
    # VAE's one head no split at all
    assert "norms" in seen
    assert ("heads" in seen) == (heads % msz != 0), seen
    assert ("paired" in seen) == (net != "vae"), seen


def _spec_leaves(specs, path=""):
    """The (spec, layout) pairs of a ``param_specs`` tree by path."""
    out = {}
    if isinstance(specs, dict):
        for k, v in specs.items():
            out.update(_spec_leaves(v, f"{path}.{k}"))
    elif isinstance(specs, list):
        for i, v in enumerate(specs):
            out.update(_spec_leaves(v, f"{path}.{i}"))
    else:
        out[path] = specs
    return out


def _unslice(parts, spec, layout):
    dim = next(i for i, e in enumerate(spec) if e is not None)
    if layout == "paired":
        halves = [p.chunk(2, dim) for p in parts]
        return torch.cat([h[0] for h in halves] + [h[1] for h in halves],
                         dim)
    return torch.cat(parts, dim)


@pytest.mark.parametrize("data,model,axes", RECIPES)
@pytest.mark.parametrize("net", ["unet", "blobnet", "vae"])
def test_local_slices_reassemble(trees, net, data, model, axes):
    trees_np, cfgs = trees
    heads, groups = _heads_groups(net, cfgs)
    tree = from_jax(trees_np[net], device="cpu")
    meshes = [tmesh.Mesh({"data": data, "model": model}, r)
              for r in range(data * model)]
    specs = _spec_leaves(tmesh.param_specs(meshes[0], tree, True, axes,
                                           heads, groups))
    n = meshes[0].size(axes)
    by_index = {}
    for m in meshes:   # one rank per position along the axes
        by_index.setdefault(m.index(axes), dict(_flat(tmesh.shard_params(
            m, tree, True, axes, heads, groups))))
    assert sorted(by_index) == list(range(n))
    full = dict(_flat(tree))
    sliced = 0
    for path, (spec, layout) in specs.items():
        parts = [by_index[i][path] for i in range(n)]
        if not spec:
            assert all(p is full[path] for p in parts), path
            continue
        sliced += 1
        assert all(p.numel() * n == full[path].numel() for p in parts)
        assert torch.equal(_unslice(parts, spec, layout), full[path]), path
    assert sliced > 0


def test_geglu_halves_pair_up(trees):
    """Deviation 1: each rank's proj_in columns are matching columns of the
    hidden and the gate halves, so h.chunk(2) splits them right; JAX's
    contiguous slice would give rank 0 hidden columns only."""
    trees_np, cfgs = trees
    tree = from_jax(trees_np["unet"], device="cpu")
    ff = tree["down_blocks"][0]["attentions"][0]["blocks"][0]["ff"]
    k = ff["proj_in"]["kernel"]
    inner = k.shape[1] // 2
    m0 = tmesh.Mesh({"data": 1, "model": 2}, 0)
    local = tmesh.shard_params(m0, {"ff": ff}, True, ("model",), 2, 8)
    got = local["ff"]["proj_in"]["kernel"]
    assert torch.equal(got, torch.cat([k[:, :inner // 2],
                                       k[:, inner:inner + inner // 2]], 1))
    assert not torch.equal(got, k[:, :inner])
    assert torch.equal(local["ff"]["proj_out"]["kernel"],
                       ff["proj_out"]["kernel"][:inner // 2])


def test_derived_weights_come_from_the_full_tree(trees):
    """Deviation 3: int8 and Winograd weights derived from the full tree,
    then sliced like their kernel: a row-parallel conv2 keeps the
    per-output-channel scale over ALL its input channels (JAX quantizes the
    global array), which quantizing the local slice would not give."""
    trees_np, _ = trees
    tree = from_jax(trees_np["unet"], device="cpu")
    full = twino.transform_conv_tree(tconv.quantize_conv_tree(tree),
                                     torch.float32)
    m1 = tmesh.Mesh({"data": 1, "model": 2}, 1)
    local = tmesh.shard_params(m1, full, True, ("model",), 2, 8)
    res_full = full["down_blocks"][0]["resnets"][0]
    res = local["down_blocks"][0]["resnets"][0]
    c = res_full["conv2"]["kernel"].shape[2]
    # row-parallel conv2: input channels sliced, w_scale whole
    assert torch.equal(res["conv2"]["kernel_q"],
                       res_full["conv2"]["kernel_q"][:, :, c // 2:])
    assert res["conv2"]["w_scale"] is res_full["conv2"]["w_scale"]
    assert torch.equal(res["conv2"]["u"], res_full["conv2"]["u"][:, c // 2:])
    _, own_scale = tconv.quantize_kernel_i8(res["conv2"]["kernel"])
    assert not torch.equal(own_scale, res["conv2"]["w_scale"])
    # column-parallel conv1: output channels sliced, w_scale with them
    co = res_full["conv1"]["kernel"].shape[3]
    assert torch.equal(res["conv1"]["w_scale"],
                       res_full["conv1"]["w_scale"][co // 2:])
    assert torch.equal(res["conv1"]["u"],
                       res_full["conv1"]["u"][:, :, co // 2:])


def test_indivisible_groups_keep_the_resnets_whole(trees):
    """A resnet block whose GroupNorm groups do not divide the model axes
    stays whole (conv1, time_emb_proj, norm2, conv2), as JAX replicates its
    row conv's call; the attentions still shard."""
    trees_np, _ = trees
    tree = from_jax(trees_np["unet"], device="cpu")
    m = tmesh.Mesh({"data": 1, "model": 2}, 0)
    specs = _spec_leaves(tmesh.param_specs(m, tree, True, ("model",), 2,
                                           groups=3))
    res = [p for p in specs if ".resnets." in p
           and any(f".{k}." in p for k in ("conv1", "conv2", "norm2",
                                           "time_emb_proj"))]
    assert res and all(specs[p][0] == () for p in res)
    assert specs[".down_blocks.0.attentions.0.blocks.0.attn1.to_q.kernel"][
        0] == (None, "model")


def test_sd15_unet_has_seventy_row_parallel_layers():
    """22 resnets and 16 transformer blocks (attn1, attn2, GEGLU): 70
    all-reduces a UNet step at model=2; the gathers: both time-embedding
    linears in the encoder and the decoder, conv_in, conv_out, 3 + 3
    samplers."""
    got = collectives.forward_counts("unet", tunet.UNetConfig(), 2)
    assert got == {"all_reduce": 70, "all_gather": 4 + 1 + 1 + 6}
    assert collectives.forward_counts("unet", tunet.UNetConfig(), 1) == {
        "all_reduce": 0, "all_gather": 0}


def test_local_rows_match_jax(monkeypatch):
    for n, i in [(1, 0), (2, 0), (2, 1), (4, 3)]:
        monkeypatch.setattr(jax, "process_count", lambda n=n: n)
        monkeypatch.setattr(jax, "process_index", lambda i=i: i)
        assert multihost.local_rows(8, n, i) == jmultihost.local_rows(8)
    with pytest.raises(AssertionError):
        multihost.local_rows(3, 2, 0)
    assert multihost.local_rows(5) == range(0, 5)  # one process


def test_replicate_fetch_and_barrier_on_two_ranks():
    """``replicate`` gives every rank rank 0's leaves (one broadcast a
    tensor), ``fetch`` hands them over as numpy, ``local_rows`` splits a
    batch by rank; in one process the three are the identity."""
    from tests import torch_ranks
    res = torch_ranks.run_ranks(torch_ranks.replicate_rank, 2,
                                {"data": 2, "model": 1})
    for rank, (tree, rows, counts) in enumerate(res):
        np.testing.assert_array_equal(tree["a"], np.zeros(3, np.float32))
        np.testing.assert_array_equal(tree["b"][0], np.arange(2))
        assert int(tree["c"]) == 7
        assert rows == [2 * rank, 2 * rank + 1]
        assert counts == {"pipeline": {"broadcast": 2, "barrier": 1}}
    one = {"x": torch.ones(2)}
    assert multihost.replicate(one)["x"] is one["x"]
    assert isinstance(multihost.fetch(one)["x"], np.ndarray)


def test_bring_up_needs_a_named_backend():
    with pytest.raises(ValueError, match="backend must be named"):
        multihost.initialize("127.0.0.1:1", 2, 0, device="cpu")
    with pytest.raises(ValueError, match="nccl runs on the card"):
        multihost.initialize("127.0.0.1:1", 2, 0, device="cpu",
                             backend="nccl")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            multihost.initialize("127.0.0.1:1", 2, 0, device="cuda",
                                 backend="gloo")


@pytest.mark.parametrize("device,rank,want", [
    ("cuda:3", 9, "cuda:3"),      # rank 9 on a host of 8 cards names its card
    ("cuda:0", 1, "cuda:0"),
    ("cuda", 2, "cuda:2"),        # bare cuda: the rank's index
    ("cuda", 9, "several hosts must each name their card"),
    ("cuda:8", 0, "not a card of this host"),
])
def test_nccl_card_rule(device, rank, want, monkeypatch):
    """Under nccl a rank runs on the card its device names; bare ``cuda``
    means ``cuda:rank``, refused only where this host has no such card
    (a host of 8 cards faked)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    if want.startswith("cuda"):
        assert multihost.nccl_card(device, rank) == torch.device(want)
    else:
        with pytest.raises(RuntimeError, match=want):
            multihost.nccl_card(device, rank)


def test_initialize_takes_the_named_card_before_the_group(monkeypatch):
    """``initialize`` applies the card rule before the process group starts:
    rank 9 of 16 with ``cuda:3`` on a host of 8 cards is set to cuda:3 and
    joins; with bare ``cuda`` it is refused and never joins."""
    seen = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    monkeypatch.setattr(torch.cuda, "set_device", seen.append)
    monkeypatch.setattr(multihost.dist, "init_process_group",
                        lambda backend, **kw: seen.append((backend, kw)))
    dev = multihost.initialize("10.0.0.1:29500", 16, 9, device="cuda:3",
                               backend="nccl")
    assert dev == torch.device("cuda:3") and seen[0] == dev
    assert seen[1][0] == "nccl" and seen[1][1]["rank"] == 9
    assert seen[1][1]["device_id"] == dev   # bound: no guess at a barrier
    assert seen[1][1]["init_method"] == "tcp://10.0.0.1:29500"
    seen.clear()
    with pytest.raises(RuntimeError, match="name their card"):
        multihost.initialize("10.0.0.1:29500", 16, 9, device="cuda",
                             backend="nccl")
    assert seen == []


class _Spawned(Exception):
    """Raised where an entry point would spawn its follower ranks."""


def _start_cli(flags, device):
    from blobctrl_torch.apps import cli
    cli.run(cli.build_parser().parse_args(
        ["--models_root", "nowhere", "--object_image", "x.png",
         "--scene_prompt", "x", "--ellipse", "1,2,3,4,5", "--device",
         device] + flags))


def _start_server(flags, device):
    from blobctrl_torch.apps import server
    server.start_mesh("nowhere", device, *flags)


@pytest.mark.parametrize("device", ["cuda:0", "cuda:1", "cuda"])
@pytest.mark.parametrize("start, flags, world", [
    (_start_cli, ["--mesh", "model=2"], 4),      # data fills the cards
    (_start_cli, ["--hybrid_cfg_data"], 4),      # data=2 x the rest of 4
    (_start_server, ("data=2", False), 2),
], ids=["cli-model", "cli-hybrid", "server-data"])
def test_a_mesh_refuses_a_named_card_before_any_rank(start, flags, world,
                                                    device, monkeypatch):
    """``--mesh`` / ``--hybrid_cfg_data`` with ``--device cuda:K`` would
    put every rank on card K over nccl, which nccl refuses only at the
    first collective, after every rank has loaded: the CLI and the server
    refuse it before a follower is spawned or anything loads. Bare
    ``cuda`` (rank r on cuda:r) gets past the check to the spawn (a host
    of 4 cards faked)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    spawned = []

    def followers(target, n, address, args=(), **kw):
        spawned.append(n)
        raise _Spawned

    def initialize(*a, **k):
        spawned.append("initialize")
        raise _Spawned
    monkeypatch.setattr(multihost, "Followers", followers)
    monkeypatch.setattr(multihost, "initialize", initialize)
    if device == "cuda":
        with pytest.raises(_Spawned):
            start(flags, device)
        assert spawned == [world]
    else:
        with pytest.raises(SystemExit, match=f"name --device cuda, not "
                                             f"{device}"):
            start(flags, device)
        assert spawned == []


def test_the_leader_leaves_the_group_before_joining_its_followers(
        tmp_path, monkeypatch):
    """nccl tears a group down with all of its ranks: a follower that
    leaves the group waits for the leader to leave it too. ``close`` must
    leave before it joins, or it kills followers that wait on it (the
    CLI's and the server's followers over nccl)."""
    from tests import torch_ranks
    flag = str(tmp_path / "left")
    monkeypatch.setattr(multihost, "shutdown",
                        lambda: open(flag, "w").close())
    followers = multihost.Followers(torch_ranks.teardown_follower, 3,
                                    "127.0.0.1:1", (flag,),
                                    join_timeout_s=10.0)
    assert followers.close() == [0, 0]


def test_agreed_seeds_cross_on_the_pipelines_device(monkeypatch):
    """A request without a seed on a mesh: rank 0's draw is broadcast on
    the pipeline's device, since nccl takes no CPU tensor (a pipeline on
    a device other than the CPU stood in by ``meta``)."""
    from blobctrl_torch.pipeline.blobnet_pipeline import BlobNetPipeline
    seen = []

    def broadcast(t, src, group):
        seen.append((t.device, src, group))
        return torch.tensor([7, 5], dtype=torch.int64)
    monkeypatch.setattr(collectives, "broadcast", broadcast)

    class Ranks:
        mesh, device = object(), torch.device("meta")

        def _group(self, axes):
            return axes
    assert BlobNetPipeline._agreed_seeds(Ranks(), [None, 5]) == [7, 5]
    assert seen == [(torch.device("meta"), 0, ("data", "model"))]


def test_mesh_flags_on_the_cpu():
    """data=auto and --hybrid_cfg_data without a mesh fill the cards, which
    the CPU does not have: refused; a hybrid mesh needs data >= 2 (JAX's
    message)."""
    assert tmesh.resolve_mesh_shape("data=2,model=2", True, "cpu") == {
        "data": 2, "model": 2}
    for spec, hybrid in [("model=2", False), (None, True)]:
        with pytest.raises(ValueError, match="CPU has none"):
            tmesh.resolve_mesh_shape(spec, hybrid, "cpu")
    with pytest.raises(ValueError, match="need data >= 2"):
        tmesh.resolve_mesh_shape("data=1,model=2", True, "cpu")


def test_mesh_axes_in_jax_order():
    """rank = d * model + m, and two axes together index row-major, as
    JAX's ("data", "model") tuple axes do."""
    m = tmesh.Mesh({"data": 2, "model": 3}, 5)
    assert m.coords == {"data": 1, "model": 2}
    assert m.index(("model",)) == 2 and m.index(("data",)) == 1
    assert m.index(("data", "model")) == 5
    jm = np.asarray(jmesh.make_mesh(data=2, model=3).devices)
    assert [d.id for d in jm.ravel()] == sorted(d.id for d in jm.ravel())
    assert dataclasses.asdict(tmesh.Mesh({"data": 1, "model": 1}))[
        "groups"] is None


def test_collectives_go_through_one_module():
    """No port module but ``parallel/collectives.py`` calls a
    ``torch.distributed`` collective, so the log sees every one."""
    import pathlib
    import re
    root = pathlib.Path(__file__).resolve().parents[1] / "blobctrl_torch"
    call = re.compile(r"\b(dist|distributed)\.(all_reduce|all_gather\w*|"
                      r"broadcast\w*|barrier|reduce_scatter\w*|all_to_all\w*"
                      r"|send|recv|isend|irecv|gather|scatter|reduce)\(")
    offenders = [str(p.relative_to(root)) for p in root.rglob("*.py")
                 if p.name != "collectives.py"
                 and call.search(p.read_text())]
    assert offenders == []
    assert call.search((root / "parallel" / "collectives.py").read_text())
