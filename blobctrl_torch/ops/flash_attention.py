"""Flash attention: non-causal, unmasked softmax(q k^T * scale) v, exact or
with int8 q k^T.

Counterpart of ``blobctrl_tpu/ops/flash_attention.py``. Two CUDA kernels
serve the long self-attention of the double-width latent layout (8192
tokens at the top level of a 512^2 edit), where the plain version
materializes an S x S fp32 score matrix in device memory:

  * ``csrc/flash_attention.cu`` replaces the Pallas ``_flash_kernel_fixed_max``,
    with ``fixed_max=None`` the running-max ``_flash_kernel``, and with the
    exp2 fold on (``set_exp2_fold``) ``_flash_kernel_fixed_max2``: q arrives
    pre-scaled by scale * log2 e and the shift as one scalar, both rounded
    to q's dtype here in plain torch, as XLA computes them outside the
    Pallas kernel. bf16 runs on the tensor cores (mma.sync, cp.async tiles),
    fp32 on the SIMT kernel; the C entry point picks by dtype and reports
    which ran (``tc_launches``, ``exp2_tc_launches``);
  * ``csrc/flash_attention_int8.cu`` replaces ``_flash_kernel_int8g`` (one
    global k scale, the int8-everything mode) and, with ``global_k=False``,
    ``_flash_kernel_int8`` (per-row k scales). q and k are quantized here in
    plain torch, as the JAX package quantizes them with XLA ops outside its
    kernels, and handed over in rows zero-padded to 16 bytes. bf16 runs on
    the tensor cores (s8 mma.sync for q.k^T, bf16 for P.V), fp32 on the SIMT
    kernel; the C entry point reports which ran (``int8_tc_launches``).

Each public entry (``flash_attention``, ``flash_attention_exp2``,
``flash_attention_int8``) runs through one ``torch.autograd.Function``, on
both devices: its forward is the kernel (the plain version for CPU
tensors), its backward the exact VJP of ``flash_attention_reference``
recomputed from the raw q, k and v (``attention_vjp``), as the JAX
package's custom VJP ``_diff_flash`` does; the int8 and exp2 modes are
differentiated straight through that exact op. There is no backward
kernel: the JAX package's backward is XLA too.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from blobctrl_torch.nn.layers import strict_fp32
from blobctrl_torch.ops import _build
from blobctrl_torch.ops._split import cdiv
from blobctrl_torch.ops.conv3x3 import INV127

MAX_HEAD_DIM = 160
MODE_RUNNING_MAX, MODE_FIXED_MAX, MODE_EXP2_FOLD = 0, 1, 2  # the kernel's modes
LOG2E = 1.4426950408889634
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# The exp2 fold, off by default as in the JAX package. It applies only with
# a numeric fixed_max and without int8.
_EXP2_FOLD = False

launches = 0                               # kernel launches (plain calls excluded)
launch_shapes = collections.Counter()      # (bh, sq, skv, d, dtype, fixed) -> launches
tc_launches = 0                            # of those, on the tensor-core kernel
exp2_launches = 0                          # the same for the exp2-folded mode
exp2_launch_shapes = collections.Counter()  # (bh, sq, skv, d, dtype) -> launches
exp2_tc_launches = 0
int8_launches = 0                          # the same for the int8 kernel
int8_launch_shapes = collections.Counter()  # (bh, sq, skv, d, dtype, global_k) -> launches
int8_tc_launches = 0

# The bf16 int8 kernel's block (csrc/flash_attention_int8.cu): INT8_BLOCK_Q
# query rows, keys in INT8_BLOCK_KV-row tiles through INT8_STAGES stages.
INT8_BLOCK_Q, INT8_BLOCK_KV, INT8_STAGES = 128, 64, 3


def set_exp2_fold(flag: bool):
    global _EXP2_FOLD
    _EXP2_FOLD = bool(flag)


def exp2_fold_enabled() -> bool:
    return _EXP2_FOLD


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, scale: float) -> torch.Tensor:
    """The plain version: fp32 scores and softmax, probabilities cast to the
    input dtype, then P @ V (the JAX package's ``_xla_sdpa_reference``).
    q: (BH, Sq, D); k, v: (BH, Skv, D)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(q.dtype), v)


# The plain versions hold (BH, Sq, Skv) fp32 scores and their softmax: 68.7 GB
# each at a 1024^2 edit's 32,768 tokens and BH = 16, 38.7 GB at a batch of
# four 768x512 edits (BH = 64, 12,288 tokens). A check of more query rows or
# score elements than these compares ``query_rows``' tiles instead of the
# whole output (2^32 elements: a batch of four 512^2 edits, 17.2 GB).
PLAIN_MAX_ROWS = 16384
PLAIN_MAX_SCORES = 2 ** 32
CHECK_TILE = 128   # a multiple of every kernel's query block (64 and 128)


def query_rows(bh: int, sq: int, skv: int) -> list:
    """The query-row slices at which to hold a kernel's output to a plain
    version's: every row, up to ``PLAIN_MAX_ROWS`` rows and
    ``PLAIN_MAX_SCORES`` score elements; above, the first ``CHECK_TILE``
    rows, the tile in the middle and the last tile (ragged where CHECK_TILE
    does not divide sq). A query row's output depends on every key and on
    no other query row, and the int8 modes' global k scale spans k, which
    stays whole: ``plain(q[:, rows], k, v, ...)`` is those rows of the
    whole call, up to the order in which a product sums."""
    if sq <= PLAIN_MAX_ROWS and bh * sq * skv <= PLAIN_MAX_SCORES:
        return [slice(0, sq)]
    starts = sorted({0, sq // 2 // CHECK_TILE * CHECK_TILE,
                     (sq - 1) // CHECK_TILE * CHECK_TILE})
    return [slice(a, min(a + CHECK_TILE, sq)) for a in starts]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float,
                    fixed_max: Optional[float] = 20.0) -> torch.Tensor:
    """q: (BH, Sq, D); k, v: (BH, Skv, D), contiguous, bf16 or fp32 ->
    (BH, Sq, D) in q's dtype, fp32 accumulation.

    fixed_max: a number selects the static softmax shift p = exp(s - FM),
    exact while the logits stay within (FM - 87, FM + 88); None selects the
    running row max with alpha-rescaling. CPU tensors take the plain version
    (exact softmax either way). With the exp2 fold on and a numeric
    fixed_max the call goes to ``flash_attention_exp2``. Differentiable
    (``attention_vjp``)."""
    if _EXP2_FOLD and fixed_max is not None:
        return flash_attention_exp2(q, k, v, scale, fixed_max)
    return _DiffFlash.apply(q, k, v, scale, functools.partial(
        _flash_forward, scale=scale, fixed_max=fixed_max))


def _flash_forward(q, k, v, scale, fixed_max):
    global launches, tc_launches
    if q.device.type == "cpu" and k.device.type == "cpu" \
            and v.device.type == "cpu":
        return flash_attention_reference(q, k, v, scale)
    bh, sq, skv, d = _check_args("flash_attention", q, k, v)
    fn = _build.entry("flash_attention")
    out = torch.empty_like(q)
    fixed = fixed_max is not None
    design = ctypes.c_int(-1)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            bh, sq, skv, d, ctypes.c_float(scale),
            MODE_FIXED_MAX if fixed else MODE_RUNNING_MAX,
            ctypes.c_float(fixed_max if fixed else 0.0), _DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream,
            ctypes.byref(design))
    _build.check("flash_attention", rc)
    launches += 1
    tc_launches += design.value == _build.DESIGN_TENSOR_CORES
    launch_shapes[(bh, sq, skv, d, str(q.dtype), fixed)] += 1
    return out


# Above this many score elements (Sq * Skv) the backward recomputes the
# attention _BWD_CHUNK_Q query rows at a time (the JAX package's
# ``_xla_sdpa_chunked``): differentiating the whole plain version holds the
# (BH, Sq, Skv) fp32 probabilities twice, 8.6 GB at a 512^2 training step's
# level 0. Module constants under the JAX names, so tests can shrink them.
_CHUNKED_BWD_ELEMS = 2048 * 2048
_BWD_CHUNK_Q = 512


def attention_vjp(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: float, g: torch.Tensor):
    """-> (dq, dk, dv): the exact VJP of ``flash_attention_reference`` at
    (q, k, v) for the output cotangent g, recomputed (the JAX package's
    ``_diff_flash`` backward). Up to ``_CHUNKED_BWD_ELEMS`` score elements
    it differentiates the plain version whole; above, chunk by chunk of
    ``_BWD_CHUNK_Q`` query rows, each over the full key length (fp32 scores
    and softmax, p cast to q's dtype before P @ V), dq chunk by chunk and dk,
    dv summed over the chunks in fp32. TF32 is off on the card for the call
    (``strict_fp32``), whatever the process has set."""
    with torch.enable_grad(), strict_fp32(q.device):
        kd = k.detach().requires_grad_()
        vd = v.detach().requires_grad_()
        if q.shape[1] * k.shape[1] <= _CHUNKED_BWD_ELEMS:
            qd = q.detach().requires_grad_()
            return torch.autograd.grad(
                flash_attention_reference(qd, kd, vd, scale), (qd, kd, vd), g)
        dq, dk, dv = [], 0.0, 0.0
        for i in range(0, q.shape[1], _BWD_CHUNK_Q):
            qd = q[:, i:i + _BWD_CHUNK_Q].detach().requires_grad_()
            gq, gk, gv = torch.autograd.grad(
                flash_attention_reference(qd, kd, vd, scale), (qd, kd, vd),
                g[:, i:i + _BWD_CHUNK_Q])
            dq.append(gq)
            dk, dv = dk + gk.float(), dv + gv.float()
        return torch.cat(dq, dim=1), dk.to(k.dtype), dv.to(v.dtype)


class _DiffFlash(torch.autograd.Function):
    """A flash kernel's forward (any mode), the exact plain backward: the
    only way to the flash kernels, so that an output made under grad mode
    has a ``grad_fn`` (a kernel writes a fresh tensor through its data
    pointer, which autograd cannot see)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, forward):
        ctx.scale = scale
        ctx.save_for_backward(q, k, v)
        return forward(q, k, v)

    @staticmethod
    def backward(ctx, g):
        return (*attention_vjp(*ctx.saved_tensors, ctx.scale, g), None,
                None)


def exp2_operands(q: torch.Tensor, scale: float, fixed_max: float):
    """The exp2 fold's pre-pass (XLA ops outside the Pallas kernel in the
    JAX package) -> (q', shift): q' = q * (scale * log2 e) and shift =
    -fixed_max * log2 e, the constants rounded to q's dtype first (JAX's
    weakly typed Python scalars take the array's dtype), q' rounded to q's
    dtype, shift a Python float."""
    c = float(torch.tensor(scale * LOG2E, dtype=q.dtype))
    shift = float(torch.tensor(-fixed_max * LOG2E, dtype=q.dtype))
    return q * c, shift


def flash_attention_exp2_reference(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, scale: float,
                                   fixed_max: float = 20.0) -> torch.Tensor:
    """The plain version of the exp2-folded kernel: s = q'.k^T in fp32 plus
    the shift, p = exp2(s), l = the fp32 row sum of p, p rounded to v's
    dtype for P @ V in fp32, then acc / l in q's dtype."""
    qs, shift = exp2_operands(q, scale, fixed_max)
    p = torch.exp2(torch.matmul(qs.float(), k.float().transpose(-1, -2))
                   + shift)
    acc = torch.matmul(p.to(v.dtype).float(), v.float())
    return (acc / p.sum(dim=-1, keepdim=True)).to(q.dtype)


def flash_attention_exp2(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: float, fixed_max: float = 20.0
                         ) -> torch.Tensor:
    """The exp2-folded fixed-max flash attention. q: (BH, Sq, D); k, v:
    (BH, Skv, D), contiguous, bf16 or fp32 -> (BH, Sq, D) in q's dtype. q is
    pre-scaled here; the kernel takes q' and the shift. CPU tensors take the
    plain version. Differentiated straight through the exact op."""
    return _DiffFlash.apply(q, k, v, scale, functools.partial(
        _exp2_forward, scale=scale, fixed_max=fixed_max))


def _exp2_forward(q, k, v, scale, fixed_max):
    global exp2_launches, exp2_tc_launches
    if q.device.type == "cpu" and k.device.type == "cpu" \
            and v.device.type == "cpu":
        return flash_attention_exp2_reference(q, k, v, scale, fixed_max)
    bh, sq, skv, d = _check_args("flash_attention_exp2", q, k, v)
    qs, shift = exp2_operands(q, scale, fixed_max)
    fn = _build.entry("flash_attention")
    out = torch.empty_like(q)
    design = ctypes.c_int(-1)
    rc = fn(qs.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh,
            sq, skv, d, ctypes.c_float(1.0), MODE_EXP2_FOLD,
            ctypes.c_float(shift), _DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream,
            ctypes.byref(design))
    _build.check("flash_attention_exp2", rc)
    exp2_launches += 1
    exp2_tc_launches += design.value == _build.DESIGN_TENSOR_CORES
    exp2_launch_shapes[(bh, sq, skv, d, str(q.dtype))] += 1
    return out


def _check_args(name, q, k, v):
    """The checks both kernels share. -> (bh, sq, skv, d)."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"{name}: q, k, v must share one CUDA device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name}: dtypes {q.dtype}/{k.dtype}/{v.dtype}; "
                         f"the kernel takes matching bf16 or fp32")
    if q.dim() != 3 or k.shape != v.shape or k.dim() != 3 \
            or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    bh, sq, d = q.shape
    skv = k.shape[1]
    if not 1 <= d <= MAX_HEAD_DIM or sq < 1 or skv < 1 or bh > 65535:
        raise ValueError(f"{name}: bh={bh}, sq={sq}, skv={skv}, d={d} "
                         f"outside the kernel's range (d <= {MAX_HEAD_DIM}, "
                         f"bh <= 65535)")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{name}: q, k, v must be contiguous")
    return bh, sq, skv, d


def quantize_rows(x: torch.Tensor):
    """Per-row symmetric int8 (the JAX package's ``_quantize_rows``):
    (..., S, D) -> (int8 values, (..., S, 1) fp32 scales), scale =
    max(max |row|, 1e-20) / 127, values clip(round(x / scale), +-127)."""
    xf = x.float()
    s = torch.clamp_min(xf.abs().amax(dim=-1, keepdim=True), 1e-20) * INV127
    return torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8), s


def int8_operands(q: torch.Tensor, k: torch.Tensor, scale: float,
                  global_k: bool):
    """The int8 kernels' pre-pass (XLA ops outside the Pallas kernels in the
    JAX package) -> (q8, rq, k8, ks):

      * global_k: k under ONE scale ka = max(max |k|, 1e-20) / 127 over the
        whole tensor (every batch row and head of the call); rq = rm =
        qs * fp32(scale * log2 e) * ka per query row; ks None;
      * per row: rq = qs * scale per query row, ks per key row.
    rq and ks have a trailing unit dim."""
    q8, qs = quantize_rows(q)
    if not global_k:
        k8, ks = quantize_rows(k)
        return q8, qs * scale, k8, ks
    kf = k.float()
    ka = torch.clamp_min(kf.abs().amax(), 1e-20) * INV127
    k8 = torch.clamp(torch.round(kf / ka), -127, 127).to(torch.int8)
    return q8, qs * (scale * LOG2E) * ka, k8, None


def int8_rows(t8: torch.Tensor) -> torch.Tensor:
    """An int8 (BH, S, D) tensor as the kernels take it: rows zero-padded
    to ``row_bytes(D)`` (16-byte aligned rows; zeros add nothing to an
    integer sum)."""
    d = t8.shape[-1]
    pad = row_bytes(d) - d
    return F.pad(t8, (0, pad)) if pad else t8.contiguous()


def row_bytes(d: int) -> int:
    """The padded int8 row length the kernels take for head dim d."""
    return cdiv(d, 16) * 16


def launch_config_int8(bh: int, sq: int, skv: int, d: int) -> dict:
    """The bf16 int8 kernel's launch: its (DK, DN) specialisation (q.k^T
    depth in bytes, P.V columns), the padded row length of q8 and k8, the
    grid (query blocks, bh) and the shared memory, as the kernel computes
    them."""
    dk, dn = (48, 40) if d <= 40 else (80, 80) if d <= 80 else (160, 160)
    qk_ld = dk if (dk // 16) % 2 else dk + 16
    v_ld = cdiv(dn, 16) * 16 + 8
    smem = ((INT8_BLOCK_Q + INT8_STAGES * INT8_BLOCK_KV) * qk_ld
            + 2 * INT8_STAGES * INT8_BLOCK_KV * v_ld)
    return {"dk": dk, "dn": dn, "row_bytes": row_bytes(d),
            "grid": (cdiv(sq, INT8_BLOCK_Q), bh), "smem_bytes": smem}


def _require_fixed_max(fixed_max):
    if fixed_max is None:
        raise ValueError(
            "the int8 flash attention has no running-max mode; pass a "
            "numeric fixed_max (the int8 path always uses the fixed-max "
            "softmax)")


def flash_attention_int8_reference(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, scale: float,
                                   fixed_max: float = 20.0,
                                   global_k: bool = True) -> torch.Tensor:
    """The plain version of the int8 kernels (``_flash_kernel_int8g`` and
    ``_flash_kernel_int8``): integer scores, p = exp2(s * rm - fixed_max *
    log2 e) or exp(s * qs * ks - fixed_max) in fp32, p rounded to v's dtype
    for P @ V in fp32, divided by the fp32 row sum of p."""
    _require_fixed_max(fixed_max)
    q8, rq, k8, ks = int8_operands(q, k, scale, global_k)
    # integer scores, exact in fp32: |s| <= D * 127^2 < 2^24
    s = torch.matmul(q8.float(), k8.float().transpose(-1, -2))
    if global_k:
        p = torch.exp2(s * rq - fixed_max * LOG2E)
    else:
        p = torch.exp(s * rq * ks.transpose(-1, -2) - fixed_max)
    acc = torch.matmul(p.to(v.dtype).float(), v.float())
    return (acc / p.sum(dim=-1, keepdim=True)).to(q.dtype)


def flash_attention_int8(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: float, fixed_max: float = 20.0,
                         global_k: bool = True) -> torch.Tensor:
    """int8 q k^T flash attention. q: (BH, Sq, D); k, v: (BH, Skv, D),
    contiguous, bf16 or fp32 -> (BH, Sq, D) in q's dtype. q and k are
    quantized here; the kernel takes the int8 values and their fp32
    multipliers. global_k selects one k scale for the whole call (the
    int8-everything mode) over per-row k scales. There is no running-max
    mode: fixed_max=None raises. CPU tensors take the plain version.
    Differentiated straight through the exact op, as in the JAX package."""
    _require_fixed_max(fixed_max)
    return _DiffFlash.apply(q, k, v, scale, functools.partial(
        _int8_forward, scale=scale, fixed_max=fixed_max, global_k=global_k))


def _int8_forward(q, k, v, scale, fixed_max, global_k):
    global int8_launches, int8_tc_launches
    if q.device.type == "cpu" and k.device.type == "cpu" \
            and v.device.type == "cpu":
        return flash_attention_int8_reference(q, k, v, scale, fixed_max,
                                              global_k)
    bh, sq, skv, d = _check_args("flash_attention_int8", q, k, v)
    q8, rq, k8, ks = int8_operands(q, k, scale, global_k)
    fm = fixed_max * LOG2E if global_k else fixed_max
    q8, k8 = int8_rows(q8), int8_rows(k8)
    fn = _build.entry("flash_attention_int8")
    out = torch.empty_like(q)
    design = ctypes.c_int(-1)
    rc = fn(q8.data_ptr(), k8.data_ptr(), v.data_ptr(), rq.data_ptr(),
            None if ks is None else ks.data_ptr(), out.data_ptr(), bh, sq,
            skv, d, ctypes.c_float(fm), int(global_k), _DTYPES[q.dtype],
            _build.stream(q.device), ctypes.byref(design))
    _build.check("flash_attention_int8", rc)
    int8_launches += 1
    int8_tc_launches += design.value == _build.DESIGN_TENSOR_CORES
    int8_launch_shapes[(bh, sq, skv, d, str(q.dtype), global_k)] += 1
    return out
