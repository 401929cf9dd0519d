"""The data x model rank grid and the Megatron table (counterpart of
``blobctrl_tpu/parallel/mesh.py``).

  * ``data`` axis: batch rows (``edit_batch``'s requests; in the hybrid
    recipe the CFG pair).
  * ``model`` axis: weight slices (tensor parallelism): attention heads,
    feed-forward columns, conv channels.

Ranks sit in JAX's row-major order: rank = d * model + m. ``make_mesh``
builds the ``data`` and ``model`` sub-groups (and uses the world for the
two axes together).

``model_spec_for`` is the JAX package's ``_model_spec_for`` with the same
roles (column, row, replicated); ``param_specs`` applies the divisibility
rule to a whole tree, and ``shard_params`` returns each rank's LOCAL slice
of it. Explicit SPMD forces four deviations from the JAX placement, each
covered by a test:

  1. GEGLU's ``ff.proj_in`` (C, 2 * inner) is sliced so that every rank
     holds matching columns of the hidden half and of the gate half
     (``layout == "paired"``): a contiguous slice would give rank 0 only
     hidden columns, which GSPMD repairs with a reshard and
     ``chunk(2)`` cannot.
  2. An attention whose heads do not divide the model axes stays
     replicated, weights too (the VAE's single-head mid attention): JAX
     replicates the kernel call but still shards the weights and lets
     GSPMD gather them.
  3. Derived int8 and Winograd weights (``kernel_q``, ``w_scale``, ``u``)
     are derived from the full tree and then sliced like their kernel
     (a row-parallel conv's per-output-channel ``w_scale`` is over all its
     input channels, as JAX's quantization of the global array gives).
  4. Norm affine parameters follow the activations they normalize: the
     resnet ``norm2`` before the row-parallel ``conv2`` is sliced (scale
     and bias, as JAX's ``shard_map`` in_specs slice them), every other
     norm stays whole. JAX places every 1-D non-row ``bias`` sharded,
     GroupNorm and LayerNorm biases included, and gathers them.

A resnet block is sharded all or nothing: its ``conv1``, ``time_emb_proj``,
``norm2`` and ``conv2`` when its output channels and its GroupNorm groups
divide the model axes, else none of them (JAX replicates the row conv's
call when the groups do not divide). The text and image encoders stay
replicated: the port has no call sites in them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from blobctrl_torch.parallel import multihost

AXES = ("data", "model")
FF_MULT = 4  # GEGLU inner width over the model width (diffusers' mult)


def parse_mesh_spec(spec: str) -> dict:
    """Parse the launch-flag mesh spec ``"data=N,model=M"`` (axis order
    free; either axis may be omitted — ``model`` defaults to 1 and ``data``
    to "fill with the remaining devices"; ``data=auto`` is the explicit
    spelling of that default). Returns kwargs for :func:`make_mesh`."""
    out = {"data": None, "model": 1}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(
                f"bad mesh spec segment {part!r}: expected 'data=N,model=M'")
        k, v = (s.strip() for s in part.split("=", 1))
        if k not in out:
            raise ValueError(
                f"unknown mesh axis {k!r}: expected 'data' and/or 'model'")
        out[k] = None if v in ("auto", "") else int(v)
    if out["model"] is None:
        out["model"] = 1
    if out["model"] < 1 or (out["data"] is not None and out["data"] < 1):
        raise ValueError(f"mesh axis sizes must be >= 1: {spec!r}")
    return out


@dataclasses.dataclass
class Mesh:
    """This rank's place in a data x model grid, with the process groups of
    its axes (None without a process group: a view for slicing)."""
    shape: Dict[str, int]
    rank: int = 0
    groups: Optional[Dict[Tuple[str, ...], object]] = None

    @property
    def coords(self) -> Dict[str, int]:
        m = self.shape["model"]
        return {"data": self.rank // m, "model": self.rank % m}

    def size(self, axes=AXES) -> int:
        n = 1
        for a in axes:
            n *= self.shape[a]
        return n

    def index(self, axes) -> int:
        """This rank's row-major position along ``axes``."""
        i = 0
        for a in axes:
            i = i * self.shape[a] + self.coords[a]
        return i

    def group(self, axes):
        """The process group of ``axes`` (None for one rank or a view)."""
        if self.groups is None or self.size(axes) == 1:
            return None
        return self.groups[tuple(a for a in AXES if a in axes)]


def make_mesh(data: Optional[int] = None, model: int = 1) -> Mesh:
    """The grid over the initialized process group (one process: a 1 x 1
    grid). data=None fills the world. Every rank builds every sub-group, in
    the same order, as ``torch.distributed.new_group`` requires."""
    world = multihost.process_count()
    if data is None:
        data = world // model
    if data < 1 or data * model != world:
        raise ValueError(f"mesh data={data} x model={model} needs "
                         f"{data * model} ranks, the group has {world}")
    mesh = Mesh({"data": data, "model": model}, multihost.process_index())
    if world == 1:
        return mesh
    import torch.distributed as dist
    groups = {AXES: dist.group.WORLD}
    for m in range(model):   # data groups: one per model index
        g = multihost.new_group([d * model + m for d in range(data)])
        if mesh.coords["model"] == m:
            groups[("data",)] = g
    for d in range(data):    # model groups: one per data index
        g = multihost.new_group([d * model + m for m in range(model)])
        if mesh.coords["data"] == d:
            groups[("model",)] = g
    mesh.groups = groups
    return mesh


def resolve_mesh_shape(mesh_spec: Optional[str], hybrid_cfg_data: bool,
                       device) -> Dict[str, int]:
    """The ``--mesh`` / ``--hybrid_cfg_data`` flags -> {"data", "model"}
    before any rank exists: ``data=auto`` fills the visible cards, and
    ``--hybrid_cfg_data`` without a mesh is data=2 x the rest of them. On
    the CPU there is no card count to fill, so both are refused."""
    on_card = torch.device(device).type == "cuda"
    cards = torch.cuda.device_count() if on_card else None
    if mesh_spec:
        kw = parse_mesh_spec(mesh_spec)
    else:
        kw = {"data": 2, "model": None}
    if kw["data"] is None or kw["model"] is None:
        if cards is None:
            raise ValueError("the mesh spec leaves an axis to fill with the "
                             "cards, and the CPU has none: give data=N and "
                             "model=M")
        if kw["model"] is None:
            kw["model"] = max(1, cards // 2)
        else:
            kw["data"] = cards // kw["model"]
    if hybrid_cfg_data and kw["data"] < 2:
        raise ValueError(
            "--hybrid_cfg_data shards the CFG pair over the data axis: "
            f"need data >= 2, got mesh {kw}")
    return kw


def check_mesh_device(device, shape: Dict[str, int]):
    """SystemExit, before any rank is spawned or anything loads, where the
    ranks of a mesh of ``shape`` cannot have a card each over nccl: a card
    named by index (``cuda:K``), which every rank would take (nccl refuses
    one card twice in a group, at the first collective, after every rank
    has loaded), or more ranks than visible cards. ``--device cuda`` puts
    rank r on cuda:r (``multihost.nccl_card``); ``--device cpu`` runs the
    ranks over gloo."""
    dev = torch.device(device)
    world = shape["data"] * shape["model"]
    if dev.type != "cuda":
        return
    if dev.index is not None and world > 1:
        raise SystemExit(f"--mesh {shape} puts rank r on cuda:r, one card "
                         f"a rank: name --device cuda, not {device} "
                         f"(--device cpu runs the ranks over gloo)")
    if world > torch.cuda.device_count():
        raise SystemExit(f"--mesh {shape} needs {world} cards, one a rank; "
                         f"{torch.cuda.device_count()} are visible")


def shard_pipeline_from_flags(pipe, mesh_spec: Optional[str] = None,
                              hybrid_cfg_data: bool = False):
    """Build the mesh from ``--mesh data=N,model=M`` over the initialized
    process group (data=auto fills it) and apply the ``shard_to_mesh``
    recipe. With ``--hybrid_cfg_data`` and no mesh: data=2 x the rest.
    -> the mesh, or None when no sharding was asked for."""
    if not mesh_spec and not hybrid_cfg_data:
        return None
    if mesh_spec:
        kw = parse_mesh_spec(mesh_spec)
    else:
        kw = {"data": 2, "model": max(1, multihost.process_count() // 2)}
    mesh = make_mesh(**kw)
    if hybrid_cfg_data and mesh.shape["data"] < 2:
        raise ValueError(
            "--hybrid_cfg_data shards the CFG pair over the data axis: "
            f"need data >= 2, got mesh {dict(mesh.shape)}")
    pipe.shard_to_mesh(mesh=mesh, model_parallel=mesh.shape["model"] > 1,
                       hybrid_cfg_data=hybrid_cfg_data)
    return mesh


# ---------------------------------------------------------------------------
# the Megatron table
# ---------------------------------------------------------------------------

_NORMS = ("norm", "norm1", "norm2", "norm3", "conv_norm_out")


def _keys(path: str):
    return path.strip(".").split(".")


def model_spec_for(path: str, shape, axes=("model",),
                   resnet: Optional[bool] = None) -> tuple:
    """Partition spec (one entry a dim, () for replicated) of one leaf under
    tensor parallelism, before the divisibility rule: the JAX package's
    ``_model_spec_for`` roles, with deviation 4 (norms) of the module
    docstring.

      * column-parallel (output dim sliced): to_q/k/v, ff.proj_in, resnet
        conv1 and time_emb_proj, and the remaining convs and linears
        (conv_in/out, the samplers, the time embedding), whose consumer
        gathers;
      * row-parallel (input dim sliced, summed after): attention to_out,
        ff.proj_out, resnet conv2; their biases stay whole (added after the
        sum);
      * replicated: conv_shortcut, BlobNet's zero taps, the transformers'
        1x1 proj_in/proj_out, and the norms but a resnet's norm2.

    resnet: whether the leaf's layer belongs to a resnet block (None: read
    off the path, "resnets" in it)."""
    ax = axes[0] if len(axes) == 1 else tuple(axes)
    keys = _keys(path)
    ndim = len(shape)
    if resnet is None:
        resnet = "resnets" in keys
    if len(keys) >= 2 and keys[-2] in _NORMS:
        resnet_norm2 = keys[-2] == "norm2" and resnet
        return (ax,) if resnet_norm2 and ndim == 1 else ()
    is_kernel = path.endswith(".kernel")
    row_parallel = (".to_out." in path or ".proj_out." in path
                    or ".conv2." in path)
    replicate = (".conv_shortcut." in path or ".zero_down." in path
                 or ".zero_mid." in path or ".zero_up." in path
                 or ((".proj_in." in path or ".proj_out." in path)
                     and (ndim == 4 or (ndim == 1 and ".ff." not in path))))
    if replicate:
        return ()
    if is_kernel and ndim == 2:
        return (ax, None) if row_parallel else (None, ax)
    if is_kernel and ndim == 4:
        return ((None, None, ax, None) if row_parallel
                else (None, None, None, ax))
    if path.endswith(".bias") and ndim == 1 and not row_parallel:
        return (ax,)
    return ()


def _layer_ok(keys, msz: int, heads: Optional[int], groups: Optional[int],
              resnet: bool) -> bool:
    """The layer-level rules of the module docstring: a sharded attention
    needs its heads to divide, a resnet block its groups, a GEGLU its inner
    width (paired halves)."""
    attn = any(k in ("to_q", "to_k", "to_v", "to_out") for k in keys)
    if attn and (heads is None or heads % msz):
        return False
    if resnet and keys[-2] in ("conv1", "conv2", "time_emb_proj", "norm2"):
        return groups is not None and groups % msz == 0
    return True


def _leaf_spec(path: str, shape, msz: int, axes, heads, groups,
               resnet: bool):
    """-> (spec, layout) of one base leaf after every rule; layout "paired"
    for GEGLU's proj_in columns, else "contiguous"."""
    spec = model_spec_for(path, shape, axes, resnet)
    if not spec:
        return (), "contiguous"
    for dim, entry in enumerate(spec):
        if entry is not None and shape[dim] % msz:
            return (), "contiguous"
    if not _layer_ok(_keys(path), msz, heads, groups, resnet):
        return (), "contiguous"
    if ".ff.proj_in." in path:
        if (shape[-1] // 2) % msz:
            return (), "contiguous"
        return spec, "paired"
    return spec, "contiguous"


def _derived_spec(name: str, kernel_spec):
    """Deviation 3: a derived leaf is sliced like its kernel. kernel_q has
    the kernel's layout, w_scale (Co,) follows the output dim, u (16, C, Co)
    the two channel dims."""
    spec, layout = kernel_spec
    if not spec:
        return (), "contiguous"
    if name == "w_scale":
        return ((spec[-1],), layout) if spec[-1] is not None else (
            (), "contiguous")
    if name == "u":
        return (None,) + tuple(spec[2:]), layout
    return spec, layout


DERIVED = ("kernel_q", "w_scale", "u")


def param_specs(mesh: Mesh, params, model_parallel: bool = False,
                axes=("model",), heads: Optional[int] = None,
                groups: Optional[int] = None):
    """The tree of (spec, layout) that ``shard_params`` applies: () where a
    leaf stays whole. heads: the attentions' head count (1 for the VAE),
    groups: the resnets' GroupNorm groups."""
    msz = mesh.size(axes)
    off = not model_parallel or msz == 1

    def leaf(path, t, resnet):
        if off or not isinstance(t, torch.Tensor):
            return (), "contiguous"
        return _leaf_spec(path, tuple(t.shape), msz, axes, heads, groups,
                          resnet)

    def walk(node, path, resnet=False):
        if isinstance(node, dict):
            kspec = (leaf(path + ".kernel", node["kernel"], resnet)
                     if "kernel" in node else None)
            # a resnet block (the dict that holds conv1 and conv2) and its
            # layers
            inner = resnet or ("conv1" in node and "conv2" in node)
            return {k: (_derived_spec(k, kspec)
                        if k in DERIVED and kspec is not None
                        else walk(v, f"{path}.{k}", inner))
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, f"{path}.{i}") for i, v in enumerate(node)]
        return leaf(path, node, resnet)
    return walk(params, "")


def _slice(t: torch.Tensor, spec, layout: str, n: int, i: int):
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        size = t.shape[dim]
        if layout == "paired":   # matching columns of both halves
            half = size // 2
            per = half // n
            return torch.cat([t.narrow(dim, i * per, per),
                              t.narrow(dim, half + i * per, per)],
                             dim).contiguous()
        per = size // n
        return t.narrow(dim, i * per, per).clone()
    return t


def shard_params(mesh: Mesh, params, model_parallel: bool = False,
                 axes=("model",), heads: Optional[int] = None,
                 groups: Optional[int] = None, device=None):
    """This rank's local slice of a param tree: sliced leaves are new
    tensors (the full ones can be freed), whole leaves the same objects;
    every leaf moved to ``device`` when one is given (the full tree may stay
    in host memory)."""
    n, i = mesh.size(axes), mesh.index(axes)

    def walk(node, spec):
        if isinstance(node, dict):
            return {k: walk(v, spec[k]) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, s) for v, s in zip(node, spec))
        if not isinstance(node, torch.Tensor):
            return node
        if spec[0]:
            node = _slice(node, spec[0], spec[1], n, i)
        return node if device is None else node.to(device)
    return walk(params, param_specs(mesh, params, model_parallel, axes,
                                    heads, groups))
