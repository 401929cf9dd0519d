"""Per-model sharding profiles and the kernel call sites on local shards
(counterpart of ``blobctrl_tpu/parallel/kernel_sharding.py``).

The JAX module wraps each Pallas call in a ``shard_map`` because GSPMD
cannot partition Mosaic kernels. Under the port's explicit SPMD every rank
already holds local slices (``parallel.mesh.shard_params``), so the kernels
are called on local tensors as they are, and what remains of the module is
where the ``shard_map`` bodies reduce:

  * flash attention: on the local heads (to_q/k/v are column-parallel, so
    they arrive local); no collective.
  * the attention output projection and GEGLU's proj_out, row-parallel:
    the local contraction, ONE all-reduce over the model group, then the
    bias (``row_linear``).
  * conv3x3, column (resnet conv1): full input, local output channels; no
    collective. The column-only layers (conv_in/out, the samplers, the time
    embedding) gather their output channels over the model group before
    their consumer (``gather_channels``).
  * conv3x3, row (resnet conv2): local input channels; the GroupNorm
    statistics on the local channels with groups // model groups (a group
    never straddles ranks), the kernel with no bias, one all-reduce, the
    bias after (``row_conv``).

The pipeline publishes a ``KernelProfile`` per model (``activate``) for the
duration of an edit, and each model's entry enters its scope (``scoped``):
``current()`` is the profile the call sites below it see. Whether a layer
is sharded is read off its local weights against the full width it must
produce, checked against the profile's model size.

In the int8 modes the activation scales are static, and the int8 flash's
global k scale is taken over the local heads: per shard, as JAX computes it
inside the ``shard_map`` body.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools
from typing import Dict, Optional, Tuple

import torch

from blobctrl_torch.nn import layers
from blobctrl_torch.parallel import collectives


@dataclasses.dataclass(frozen=True)
class KernelProfile:
    """How one model is sharded: ``model``, the mesh axes its weights were
    sliced over (``parallel.mesh.shard_params``). Its activation rows are
    the pipeline's to split."""
    mesh: object
    model: Tuple[str, ...] = ()

    @property
    def multi_device(self) -> bool:
        return self.mesh.size() > 1

    @property
    def model_size(self) -> int:
        return self.mesh.size(self.model)

    @property
    def model_group(self):
        return self.mesh.group(self.model)


_PROFILES: contextvars.ContextVar[Optional[Dict[str, KernelProfile]]] = \
    contextvars.ContextVar("kernel_sharding_profiles", default=None)
_SCOPE: contextvars.ContextVar[Optional[str]] = \
    contextvars.ContextVar("kernel_sharding_scope", default=None)


@contextlib.contextmanager
def activate(profiles: Optional[Dict[str, KernelProfile]]):
    """Publish the per-model profile map for the body of the ``with`` (the
    pipeline wraps each edit): per-context state, not process-global."""
    tok = _PROFILES.set(profiles)
    try:
        yield
    finally:
        _PROFILES.reset(tok)


@contextlib.contextmanager
def scope(name: str):
    """Entered by a model's entry (unet/blobnet/vae): selects the profile
    the call sites below it see, and names its collectives."""
    tok = _SCOPE.set(name)
    try:
        yield
    finally:
        _SCOPE.reset(tok)


def scoped(name: str):
    """Decorator form of :func:`scope` for the models' entries."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with scope(name):
                return fn(*args, **kwargs)
        return wrapper
    return deco


def scope_name() -> Optional[str]:
    return _SCOPE.get()


def current() -> Optional[KernelProfile]:
    """The profile of the active model scope, or None (no profiles, no
    scope, a one-rank mesh, or a model whose weights are whole)."""
    profiles = _PROFILES.get()
    name = _SCOPE.get()
    if not profiles or name is None:
        return None
    prof = profiles.get(name)
    if prof is None or not prof.multi_device or prof.model_size == 1:
        return None
    return prof


def _resolve(prof: KernelProfile, model_dim: int) -> Tuple[str, ...]:
    """The model axes usable for a dim: none when it does not divide their
    size (``parallel.mesh.param_specs``' divisibility rule)."""
    model = tuple(a for a in prof.model if prof.mesh.shape[a] > 1)
    if model and model_dim % prof.mesh.size(model) != 0:
        model = ()
    return model


def split(local: int, full: int) -> int:
    """How many ways a layer with ``local`` of its ``full`` width is split:
    1 for a whole layer, else the size of the model axes that ``_resolve``
    finds the width divisible by (checked against the local width)."""
    if local == full:
        return 1
    prof = current()
    model = _resolve(prof, full) if prof is not None else ()
    if not model or local * prof.mesh.size(model) != full:
        raise ValueError(f"a layer holds {local} of {full} channels under "
                         f"profile {prof}: its weights and the mesh "
                         f"disagree")
    return prof.mesh.size(model)


def all_reduce(y: torch.Tensor) -> torch.Tensor:
    """The sum of the model group's partial results."""
    return collectives.all_reduce(y, current().model_group)


def gather_channels(y: torch.Tensor, full: int) -> torch.Tensor:
    """A column-only layer's output (..., local) -> (..., full), gathered
    over the model group in rank order; whole outputs pass through."""
    if split(y.shape[-1], full) == 1:
        return y
    return collectives.all_gather(y, current().model_group, dim=-1)


def local_heads(heads: int, local: int, full: int) -> int:
    """Heads of an attention whose projections hold ``local`` of ``full``
    columns (to_q/k/v are column-parallel: heads arrive local)."""
    return heads // split(local, full)


def row_linear(params, x: torch.Tensor) -> torch.Tensor:
    """Row-parallel linear (attention to_out, GEGLU proj_out) on this rank's
    input columns: the local product, one all-reduce, then the bias in
    fp32. In the int8 linear path the product is the exact int8 one, its
    rescale before the sum."""
    if layers.linear_int8_enabled() and "kernel_q" in params:
        y = layers.matmul_i8(x, params["kernel_q"], params["w_scale"], None,
                             torch.float32)
    else:
        y = torch.matmul(x, params["kernel"].to(x.dtype))
    y = all_reduce(y)
    if "bias" in params:
        y = y.float() + params["bias"].float()
    return y.to(x.dtype)


def row_conv(conv_fn, conv_params, norm_params, x: torch.Tensor,
             groups: int, eps: float, routed: bool) -> torch.Tensor:
    """Row-parallel resnet conv2 on this rank's input channels: GroupNorm
    statistics over the local channels with groups // model groups,
    SiLU, the 3x3 conv without its bias (``conv_fn(params, x, scale,
    shift)`` with the GroupNorm folded into the prologue when ``routed``,
    else the plain GroupNorm, SiLU and conv), one all-reduce, then the bias
    in fp32."""
    msz = split(x.shape[-1], conv_params["kernel"].shape[3])
    g_local = groups // msz
    no_bias = {k: v for k, v in conv_params.items() if k != "bias"}
    if routed:
        s, sh = layers.group_norm_scale_shift(norm_params, x, g_local, eps)
        y = conv_fn(no_bias, x, s, sh)
    else:
        h = layers.silu(layers.group_norm(norm_params, x, g_local, eps))
        y = layers.conv2d(no_bias, h, padding=1)
    y = all_reduce(y)
    if "bias" in conv_params:
        y = (y.float() + conv_params["bias"].float()).to(y.dtype)
    return y
