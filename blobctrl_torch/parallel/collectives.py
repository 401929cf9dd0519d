"""Every collective of the port, counted (the intent of
``blobctrl_tpu/parallel/compile_audit.py``: each collective, its kind, its
payload bytes and where it lives).

``all_reduce``, ``all_gather``, ``broadcast`` and ``barrier`` are the only
calls of ``torch.distributed`` collectives in the package. Each appends an
``Entry`` to ``LOG``: the op, the payload bytes (the bytes this rank
contributes: its tensor for a reduce or a gather, the source tensor for a
broadcast), the model scope it ran under (``unet``, ``blobnet``, ``vae``,
from ``kernel_sharding.scope``; ``pipeline`` outside every model) and the
host seconds inside the call. Readers take differences (``mark`` /
``since``), as they read the kernels' launch counters.

A group of one rank (or no group at all: an unsharded run) makes every call
the identity and logs nothing. Over gloo, a CUDA tensor goes through host
memory (a pinned copy each way); over nccl it stays on the card, and the
seconds are the host's enqueue time.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List, Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Entry:
    op: str          # "all_reduce" | "all_gather" | "broadcast" | "barrier"
    bytes: int
    scope: str       # "unet" | "blobnet" | "vae" | "pipeline"
    seconds: float


LOG: List[Entry] = []


def _scope() -> str:
    from blobctrl_torch.parallel import kernel_sharding
    return kernel_sharding.scope_name() or "pipeline"


def group_size(group) -> int:
    if group is None or not dist.is_initialized():
        return 1
    return dist.get_world_size(group)


def _staged(t: torch.Tensor, group) -> bool:
    """gloo moves CUDA tensors through host memory."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _buffer(t: torch.Tensor, group) -> torch.Tensor:
    """A contiguous copy of ``t`` for the collective to work in: in pinned
    host memory when gloo stages a CUDA tensor (a pageable copy each way
    takes about as long as gloo itself), else on t's device."""
    if _staged(t, group):
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return buf.copy_(t.detach())
    return t.detach().clone(memory_format=torch.contiguous_format)


@contextlib.contextmanager
def _logged(op: str, nbytes: int):
    """Log the collective in the body, also when it raises (a rank then
    knows it entered one)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        LOG.append(Entry(op, int(nbytes), _scope(),
                         time.perf_counter() - t0))


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over the group, in t's dtype (a new tensor)."""
    if group_size(group) == 1:
        return t
    with _logged("all_reduce", t.numel() * t.element_size()):
        buf = _buffer(t, group)
        dist.all_reduce(buf, group=group)
        return buf.to(t.device)


def all_gather(t: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """The group's tensors concatenated along ``dim`` in group-rank order."""
    n = group_size(group)
    if n == 1:
        return t
    with _logged("all_gather", t.numel() * t.element_size()):
        src = _buffer(t, group)
        parts = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(parts, src, group=group)
        return torch.cat(parts, dim=dim).to(t.device)


def broadcast(t: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """``t`` of global rank ``src`` on every rank of the group (the world
    when group is None)."""
    if not dist.is_initialized():
        return t
    group = group if group is not None else dist.group.WORLD
    if group_size(group) == 1:
        return t
    with _logged("broadcast", t.numel() * t.element_size()):
        buf = _buffer(t, group)
        dist.broadcast(buf, src=src, group=group)
        return buf.to(t.device)


def barrier(group=None):
    """Every rank of the group (the world when None) reaches this point."""
    if not dist.is_initialized():
        return
    group = group if group is not None else dist.group.WORLD
    if group_size(group) == 1:
        return
    with _logged("barrier", 0):
        dist.barrier(group=group)


def mark() -> int:
    """A position in ``LOG``; ``since(mark)`` lists what came after it."""
    return len(LOG)


def since(position: int) -> List[Entry]:
    return LOG[position:]


def reset():
    LOG.clear()


def summary(entries: Optional[List[Entry]] = None) -> Dict[str, Dict]:
    """{scope: {op: {"count", "bytes", "seconds"}}} of ``entries`` (the
    whole log by default)."""
    out: Dict[str, Dict] = {}
    for e in LOG if entries is None else entries:
        cell = out.setdefault(e.scope, {}).setdefault(
            e.op, {"count": 0, "bytes": 0, "seconds": 0.0})
        cell["count"] += 1
        cell["bytes"] += e.bytes
        cell["seconds"] += e.seconds
    return out


def counts(entries: Optional[List[Entry]] = None) -> Dict[str, Dict[str, int]]:
    """{scope: {op: count}} of ``entries`` (the whole log by default)."""
    return {scope: {op: c["count"] for op, c in ops.items()}
            for scope, ops in summary(entries).items()}


def sizes(entries: Optional[List[Entry]] = None) -> Dict[str, Dict]:
    """{scope: {op: {"count", "bytes"}}} of ``entries`` (the whole log by
    default): ``summary`` without the seconds."""
    return {scope: {op: {"count": c["count"], "bytes": c["bytes"]}
                    for op, c in ops.items()}
            for scope, ops in summary(entries).items()}


# ---------------------------------------------------------------------------
# the expected count
# ---------------------------------------------------------------------------

def _splits(c: int, msz: int) -> int:
    return int(msz > 1 and c % msz == 0)


def forward_counts(kind: str, cfg, msz: int) -> Dict[str, int]:
    """Collectives of one forward of a model whose weights are sliced msz
    ways (``parallel.mesh.shard_params``' rules): one all-reduce per
    row-parallel layer that is sharded (resnet conv2, attention to_out,
    GEGLU proj_out) and one all-gather per column-only layer that is
    (conv_in/out, the samplers, the time embedding's two linears, the VAE's
    1x1 quant convs).

    kind: "unet" (one denoising step: the encoder and the decoder, each
    embedding the timestep), "blobnet", "vae_encode" or "vae_decode"."""
    from blobctrl_torch.parallel.mesh import FF_MULT
    boc, n = cfg.block_out_channels, len(cfg.block_out_channels)
    groups_ok = cfg.norm_num_groups % msz == 0 if msz > 1 else False

    def res(c):
        return int(_splits(c, msz) and groups_ok)

    ar = ag = 0
    if kind.startswith("vae"):
        lat, lpb = cfg.latent_channels, cfg.layers_per_block
        if kind == "vae_encode":
            ag += _splits(boc[0], msz)
            for i in range(n):
                ar += lpb * res(boc[i])
                ag += _splits(boc[i], msz) if i < n - 1 else 0
            ar += 2 * res(boc[-1])        # the mid attention: one head
            ag += 2 * _splits(2 * lat, msz)   # conv_out, quant_conv
        else:
            ag += _splits(lat, msz) + _splits(boc[-1], msz)
            ar += 2 * res(boc[-1])
            for i, c in enumerate(reversed(boc)):
                ar += (lpb + 1) * res(c)
                ag += _splits(c, msz) if i < n - 1 else 0
            ag += _splits(cfg.out_channels, msz)
        return {"all_reduce": ar, "all_gather": ag}

    heads_ok = cfg.num_heads % msz == 0
    cross = cfg.cross_attention_dim is not None
    tl, lpb = cfg.transformer_layers_per_block, cfg.layers_per_block

    def block(c):
        attn = int(_splits(c, msz) and heads_ok)
        return tl * (attn * (2 if cross else 1) + _splits(FF_MULT * c, msz))

    embeds = 1 if kind == "blobnet" else 2
    ag += 2 * embeds * _splits(boc[0] * 4, msz) + _splits(boc[0], msz)
    for i in range(n):
        ar += lpb * (res(boc[i]) + (block(boc[i])
                                    if cfg.down_block_has_attn[i] else 0))
        ag += _splits(boc[i], msz) if i < n - 1 else 0
    ar += 2 * res(boc[-1]) + block(boc[-1])
    for i, c in enumerate(reversed(boc)):
        ar += (lpb + 1) * (res(c) + (block(c) if cfg.up_block_has_attn[i]
                                     else 0))
        ag += _splits(c, msz) if i < n - 1 else 0
    if kind == "unet":
        ag += _splits(cfg.out_channels, msz)
    return {"all_reduce": ar, "all_gather": ag}


def expected_counts(unet_cfg, blobnet_cfg, vae_cfg, shape: Dict[str, int],
                    recipe: str, steps: int,
                    blobnet_steps: Optional[int] = None,
                    vae_encodes: int = 1, vae_decodes: int = 1,
                    data_split: bool = False,
                    seed_broadcast: bool = False) -> Dict[str, Dict[str, int]]:
    """{scope: {op: count}} an edit logs under ``recipe`` ("data", "model"
    or "hybrid", ``BlobNetPipeline.shard_to_mesh``) on a mesh of ``shape``:
    ``steps`` UNet steps, ``blobnet_steps`` BlobNet forwards (default:
    every step), the VAE encodes and decodes; the pipeline's own: one
    gather of the noise predictions a step under the hybrid recipe, one
    of the images when edit_batch split its rows, one broadcast of seeds
    drawn on rank 0."""
    model = shape["model"] if recipe in ("model", "hybrid") else 1
    blob = shape["data"] * model if recipe == "hybrid" else model
    blobnet_steps = steps if blobnet_steps is None else blobnet_steps
    parts = {
        "unet": (forward_counts("unet", unet_cfg, model), steps),
        "blobnet": (forward_counts("blobnet", blobnet_cfg, blob),
                    blobnet_steps),
        "vae": (forward_counts("vae_encode", vae_cfg, model), vae_encodes),
        "vae ": (forward_counts("vae_decode", vae_cfg, model), vae_decodes),
    }
    out: Dict[str, Dict[str, int]] = {}
    for scope, (per, times) in parts.items():
        for op, c in per.items():
            if c * times:
                cell = out.setdefault(scope.strip(), {})
                cell[op] = cell.get(op, 0) + c * times
    pipe = {}
    if recipe == "hybrid" and shape["data"] > 1:
        pipe["all_gather"] = steps
    if data_split:
        pipe["all_gather"] = pipe.get("all_gather", 0) + 1
    if seed_broadcast and shape["data"] * shape["model"] > 1:
        pipe["broadcast"] = 1
    if pipe:
        out["pipeline"] = pipe
    return out
