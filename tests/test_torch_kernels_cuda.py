"""The CUDA kernels against their plain versions on the card, and the
wrappers' refusals. Marked ``cuda``; the ``cuda_device`` fixture skips them
where there is no GPU, deciding when the test runs (never at import, so
every pytest worker collects the same tests). This file imports no JAX, so
it runs on a machine with only the port's dependencies:
``python -m pytest -m cuda tests/test_torch_kernels_cuda.py``.
"""

import pytest
import torch

from blobctrl_torch.ops import conv3x3 as tconv
from blobctrl_torch.ops import flash_attention as tfa
from blobctrl_torch.ops import gn_matmul as tgn
from blobctrl_torch.ops import ln_matmul as tln
from blobctrl_torch.ops import winograd as twg


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: runs a CUDA kernel, which has no "
                    "CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("fixed_max", [20.0, None])
def test_flash_kernel_matches_plain_on_card(cuda_device, dtype, tol,
                                            fixed_max):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    # ragged q and kv tails, head dims that are not powers of two
    for bh, sq, skv, d in [(3, 200, 333, 40), (2, 130, 1024, 80),
                           (1, 64, 70, 160), (2, 100, 256, 16)]:
        q, k, v = (torch.randn(bh, s, d, generator=g, device=cuda_device)
                   .to(dtype) for s in (sq, skv, skv))
        got = tfa.flash_attention(q, k, v, d ** -0.5, fixed_max=fixed_max)
        ref = tfa.flash_attention_reference(q, k, v, d ** -0.5)
        err = (got.float() - ref.float()).abs().max() / ref.float().abs().max()
        assert err.item() <= tol, (bh, sq, skv, d, err.item())


@pytest.mark.cuda
def test_flash_kernel_rejects_what_it_cannot_take(cuda_device):
    q = torch.zeros(2, 64, 40, device=cuda_device)
    with pytest.raises(ValueError):
        tfa.flash_attention(q, q.half(), q.half(), 1.0)
    with pytest.raises(ValueError):
        tfa.flash_attention(q[:, :, :20], q[:, :, :20], q[:, :, :20], 1.0)
    big = torch.zeros(1, 64, 192, device=cuda_device)
    with pytest.raises(ValueError):
        tfa.flash_attention(big, big, big, 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("prologue", [False, True])
def test_conv3x3_kernel_matches_plain_on_card(cuda_device, dtype, tol,
                                              prologue):
    torch.backends.cudnn.allow_tf32 = False  # the plain version in full fp32
    g = torch.Generator(device=cuda_device).manual_seed(0)
    for b, h, w, c, co in [(2, 8, 16, 1029, 320), (1, 16, 8, 37, 40),
                           (2, 24, 40, 64, 130)]:
        def rnd(*shape, s=1.0):
            return torch.randn(*shape, generator=g, device=cuda_device) * s
        x = rnd(b, h, w, c).to(dtype)
        k = rnd(3, 3, c, co, s=(9 * c) ** -0.5).to(dtype)
        bias = rnd(co)
        pro = (1 + 0.3 * rnd(b, c), rnd(b, c)) if prologue else (None, None)
        got = tconv.conv3x3(x, k, bias, *pro)
        ref = tconv.conv3x3_reference(x, k, bias, *pro)
        err = (got.float() - ref.float()).abs().max() / ref.float().abs().max()
        assert err.item() <= tol, (b, h, w, c, co, err.item())


@pytest.mark.cuda
def test_conv3x3_kernel_rejects_what_it_cannot_take(cuda_device):
    x = torch.zeros(1, 8, 8, 32, device=cuda_device)
    k = torch.zeros(3, 3, 32, 16, device=cuda_device)
    with pytest.raises(ValueError):
        tconv.conv3x3(x, k.bfloat16())
    with pytest.raises(ValueError):
        tconv.conv3x3(x.permute(0, 2, 1, 3), k)
    with pytest.raises(ValueError):
        tconv.conv3x3(x, k[:, :, :16])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("global_k", [True, False])
def test_flash_int8_kernel_matches_plain_on_card(cuda_device, dtype, tol,
                                                 global_k):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    # ragged q and kv tails, head dims that are not powers of two
    for bh, sq, skv, d in [(3, 200, 333, 40), (2, 130, 1024, 80),
                           (1, 64, 70, 160), (2, 100, 256, 16)]:
        q, k, v = (torch.randn(bh, s, d, generator=g, device=cuda_device)
                   .to(dtype) for s in (sq, skv, skv))
        before = tfa.int8_launches
        got = tfa.flash_attention_int8(q, k, v, d ** -0.5, global_k=global_k)
        assert tfa.int8_launches == before + 1
        ref = tfa.flash_attention_int8_reference(q, k, v, d ** -0.5,
                                                 global_k=global_k)
        err = (got.float() - ref.float()).abs().max() / ref.float().abs().max()
        assert err.item() <= tol, (bh, sq, skv, d, err.item())


@pytest.mark.cuda
def test_flash_int8_kernel_rejects_what_it_cannot_take(cuda_device):
    q = torch.zeros(2, 64, 40, device=cuda_device)
    with pytest.raises(ValueError):
        tfa.flash_attention_int8(q, q, q, 1.0, fixed_max=None)
    with pytest.raises(ValueError):
        tfa.flash_attention_int8(q, q.cpu(), q, 1.0)
    with pytest.raises(ValueError):
        tfa.flash_attention_int8(q, q.half(), q.half(), 1.0)
    big = torch.zeros(1, 64, 192, device=cuda_device)
    with pytest.raises(ValueError):
        tfa.flash_attention_int8(big, big, big, 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("prologue", [False, True])
@pytest.mark.parametrize("act_amax", [12.0, None])
def test_conv3x3_int8_kernel_matches_plain_on_card(cuda_device, dtype, tol,
                                                   prologue, act_amax):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    for b, h, w, c, co in [(2, 8, 16, 1029, 320), (1, 16, 8, 37, 40),
                           (2, 24, 40, 64, 130), (1, 8, 8, 37, 320)]:
        def rnd(*shape, s=1.0):
            return torch.randn(*shape, generator=g, device=cuda_device) * s
        x = rnd(b, h, w, c).to(dtype)
        kq, ws = tconv.quantize_kernel_i8(rnd(3, 3, c, co, s=(9 * c) ** -0.5))
        bias = rnd(co)
        pro = (1 + 0.3 * rnd(b, c), rnd(b, c)) if prologue else (None, None)
        before = tconv.int8_launches
        got = tconv.conv3x3_int8(x, kq, ws, bias, *pro, act_amax=act_amax)
        assert tconv.int8_launches == before + 1
        ref = tconv.conv3x3_int8_reference(x, kq, ws, bias, *pro,
                                           act_amax=act_amax)
        err = (got.float() - ref.float()).abs().max() / ref.float().abs().max()
        assert err.item() <= tol, (b, h, w, c, co, err.item())


@pytest.mark.cuda
def test_conv3x3_int8_kernel_rejects_what_it_cannot_take(cuda_device):
    x = torch.zeros(1, 8, 8, 32, device=cuda_device)
    kq = torch.zeros(3, 3, 32, 16, dtype=torch.int8, device=cuda_device)
    ws = torch.ones(16, device=cuda_device)
    with pytest.raises(ValueError):  # weights that are not int8
        tconv.conv3x3_int8(x, kq.float(), ws)
    with pytest.raises(ValueError):  # weights on another device
        tconv.conv3x3_int8(x, kq.cpu(), ws.cpu())
    with pytest.raises(ValueError):
        tconv.conv3x3_int8(x, kq, ws[:8])
    with pytest.raises(ValueError):
        tconv.conv3x3_int8(x.half(), kq, ws)


def _rel_err(got, ref):
    return ((got.float() - ref.float()).abs().max()
            / ref.float().abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_flash_exp2_kernel_matches_plain_on_card(cuda_device, dtype, tol):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    # ragged q and kv tails, d in {16, 40, 80, 160}
    for bh, sq, skv, d in [(3, 200, 333, 40), (2, 130, 1024, 80),
                           (1, 64, 70, 160), (2, 100, 256, 16)]:
        q, k, v = (torch.randn(bh, s, d, generator=g, device=cuda_device)
                   .to(dtype) for s in (sq, skv, skv))
        before = tfa.exp2_launches
        got = tfa.flash_attention_exp2(q, k, v, d ** -0.5)
        assert tfa.exp2_launches == before + 1
        ref = tfa.flash_attention_exp2_reference(q, k, v, d ** -0.5)
        err = _rel_err(got, ref)
        assert err <= tol, (bh, sq, skv, d, err)


@pytest.mark.cuda
def test_flash_exp2_kernel_rejects_what_it_cannot_take(cuda_device):
    q = torch.zeros(2, 64, 40, device=cuda_device)
    with pytest.raises(ValueError):  # mismatched dtypes
        tfa.flash_attention_exp2(q, q.half(), q.half(), 1.0)
    with pytest.raises(ValueError):  # another device
        tfa.flash_attention_exp2(q, q.cpu(), q, 1.0)
    big = torch.zeros(1, 64, 192, device=cuda_device)
    with pytest.raises(ValueError):
        tfa.flash_attention_exp2(big, big, big, 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("mode", ["plain", "residual", "residual-no-affine"])
def test_affine_matmul_kernel_matches_plain_on_card(cuda_device, dtype, tol,
                                                    mode):
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in fp32
    g = torch.Generator(device=cuda_device).manual_seed(0)
    # h*w = 9 (no multiple of 8), ragged M and N tails, odd C
    for b, h, w, c, n in [(2, 3, 3, 37, 40), (1, 8, 16, 320, 320),
                          (2, 5, 7, 64, 130), (1, 64, 2, 1029, 3)]:
        def rnd(*shape, s=1.0):
            return torch.randn(*shape, generator=g, device=cuda_device) * s
        x = rnd(b, h, w, c).to(dtype)
        wk = rnd(c, n, s=c ** -0.5).to(dtype)
        bias = rnd(n)
        st = ((None, None) if mode == "residual-no-affine"
              else (1 + 0.3 * rnd(b, c), rnd(b, c)))
        res = None if mode == "plain" else rnd(b, h, w, n).to(dtype)
        counter = "launches" if res is None else "res_launches"
        before = getattr(tgn, counter)
        got = tgn.affine_matmul(x, wk, bias, *st, residual=res)
        assert getattr(tgn, counter) == before + 1
        ref = tgn.affine_matmul_reference(x, wk, bias, *st, residual=res)
        err = _rel_err(got, ref)
        assert err <= tol, (b, h, w, c, n, err)


@pytest.mark.cuda
def test_affine_matmul_kernel_rejects_what_it_cannot_take(cuda_device):
    x = torch.zeros(1, 4, 4, 32, device=cuda_device)
    w = torch.zeros(32, 16, device=cuda_device)
    st = torch.ones(1, 32, device=cuda_device)
    with pytest.raises(ValueError):  # mismatched dtypes
        tgn.affine_matmul(x, w.bfloat16())
    with pytest.raises(ValueError):
        tgn.affine_matmul(x, w, residual=torch.zeros(
            1, 4, 4, 16, device=cuda_device, dtype=torch.bfloat16))
    with pytest.raises(ValueError):  # another device
        tgn.affine_matmul(x, w.cpu())
    with pytest.raises(ValueError):  # s without t
        tgn.affine_matmul(x, w, s=st)
    with pytest.raises(ValueError):
        tgn.affine_matmul(x, w[:16])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_ln_matmul_kernel_matches_plain_on_card(cuda_device, dtype, tol):
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in fp32
    g = torch.Generator(device=cuda_device).manual_seed(0)
    # ragged M and N tails, C up to 1280, a batched (B, S, C) input
    for shape, n in [((300, 320), 960), ((2, 77, 64), 128),
                     ((130, 1280), 40), ((33, 37), 3)]:
        c = shape[-1]

        def rnd(*s, sc=1.0):
            return torch.randn(*s, generator=g, device=cuda_device) * sc
        x = (rnd(*shape) * 2 + 0.5).to(dtype)
        gamma, beta = 1 + 0.3 * rnd(c), 0.1 * rnd(c)
        wk = rnd(c, n, sc=c ** -0.5).to(dtype)
        bias = rnd(n)
        before = tln.launches
        got = tln.ln_matmul(x, gamma, beta, wk, bias)
        assert tln.launches == before + 1
        assert got.shape == shape[:-1] + (n,)
        ref = tln.ln_matmul_reference(x, gamma, beta, wk, bias)
        err = _rel_err(got, ref)
        assert err <= tol, (shape, n, err)


@pytest.mark.cuda
def test_ln_matmul_kernel_rejects_what_it_cannot_take(cuda_device):
    x = torch.zeros(8, 32, device=cuda_device)
    gamma = torch.ones(32, device=cuda_device)
    w = torch.zeros(32, 16, device=cuda_device)
    with pytest.raises(ValueError):  # a dtype the kernel does not take
        tln.ln_matmul(x.half(), gamma, None, w)
    with pytest.raises(ValueError):  # another device
        tln.ln_matmul(x, gamma.cpu(), None, w)
    with pytest.raises(ValueError):
        tln.ln_matmul(x, gamma, None, w[:16])
    with pytest.raises(ValueError):
        tln.ln_matmul(x.t(), gamma[:8], None, w[:8])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("prologue", [False, True])
def test_winograd_kernel_matches_plain_on_card(cuda_device, dtype, tol,
                                               prologue):
    torch.backends.cudnn.allow_tf32 = False  # the direct conv in full fp32
    g = torch.Generator(device=cuda_device).manual_seed(0)
    # C in {37, 1029}, Co in {3, 40, 320}, ragged tile and Co tails
    for b, h, w, c, co in [(2, 8, 16, 1029, 320), (1, 16, 8, 37, 40),
                           (2, 6, 10, 64, 3), (2, 24, 40, 64, 130)]:
        def rnd(*shape, s=1.0):
            return torch.randn(*shape, generator=g, device=cuda_device) * s
        x = rnd(b, h, w, c).to(dtype)
        k = rnd(3, 3, c, co, s=(9 * c) ** -0.5).to(dtype)
        bias = rnd(co)
        pro = (1 + 0.3 * rnd(b, c), rnd(b, c)) if prologue else (None, None)
        u = twg.transform_weights(k)
        before = twg.launches
        got = twg.conv3x3_winograd(x, k, bias, *pro, u=u)
        assert twg.launches == before + 1
        ref = twg.conv3x3_winograd_reference(x, u, bias, *pro)
        err = _rel_err(got, ref)
        assert err <= tol, (b, h, w, c, co, err)
        # the same conv as the direct kernel, up to V's rounding to dtype
        direct = tconv.conv3x3_reference(x, k, bias, *pro)
        assert _rel_err(got, direct) <= 10 * tol, (b, h, w, c, co)


@pytest.mark.cuda
def test_winograd_kernel_rejects_what_it_cannot_take(cuda_device):
    x = torch.zeros(1, 8, 8, 32, device=cuda_device)
    k = torch.zeros(3, 3, 32, 16, device=cuda_device)
    with pytest.raises(ValueError):  # odd H
        twg.conv3x3_winograd(x[:, :7].contiguous(), k)
    with pytest.raises(ValueError):  # weights on another device
        twg.conv3x3_winograd(x, k.cpu())
    with pytest.raises(ValueError):  # a dtype the kernel does not take
        twg.conv3x3_winograd(x.half(), k.half())
    with pytest.raises(ValueError):
        twg.conv3x3_winograd(x, k[:, :, :16])


SPLAT_CARD_SHAPES = [(1, 512, 512, 1), (2, 64, 128, 3), (1, 37, 53, 11),
                     (1, 16, 16, 1100)]


def _splat_inputs(device, n, h, w, m):
    """Blobs on the card, a gated one where m >= 2, and (M+1, 3) colours."""
    g = torch.Generator(device=device).manual_seed(0)

    def u(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(*shape, generator=g, device=device)
    xs, ys = u(0.1, 0.9, n, m), u(0.1, 0.9, n, m)
    a, b = u(0.002, 0.05, n, m), u(0.002, 0.05, n, m)
    rho = u(-0.8, 0.8, n, m) * (a * b).sqrt()
    covs = torch.stack([torch.stack([a, rho], -1),
                        torch.stack([rho, b], -1)], -2)
    sizes = torch.ones(n, m, device=device)
    if m >= 2:
        sizes[0, 1] = 0.0
    return (xs, ys, covs, sizes), u(0.0, 1.0, m + 1, 3)


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,m", SPLAT_CARD_SHAPES)
def test_blob_splat_kernel_matches_plain_on_card(cuda_device, n, h, w, m):
    """fp32, atol 1e-5 (outputs in [0, 1]); odd H and W, a gated blob, and
    more blobs than the kernel stages in shared memory at once. The rows
    its prologue computes are bit-equal to ``splat_params``; a second
    launch is bit-equal to the first; the rows-input mode agrees too."""
    from blobctrl_torch.ops import blob_splat as tsplat
    raw, _ = _splat_inputs(cuda_device, n, h, w, m)
    before = tsplat.launches
    got = tsplat.splat_scores(*raw, (h, w))
    params = tsplat.splat_params(*raw, (h, w))
    ref = tsplat.splat_scores_plain(params, h, w)
    torch.cuda.synchronize()
    assert tsplat.launches == before + 1
    assert got.shape == (n, h, w, m + 1)
    assert (got - ref).abs().max().item() <= 1e-5
    assert torch.equal(tsplat.splat_scores(*raw, (h, w)), got)
    assert torch.equal(tsplat.splat_rows(*raw, (h, w)), params)
    assert (tsplat.splat_from_params(params, h, w) - ref).abs().max() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,m", SPLAT_CARD_SHAPES)
def test_blob_view_kernel_bit_equal_to_plain_on_card(cuda_device, n, h, w,
                                                      m):
    """The view mode (image 0, colour sum, clamp, x255, uint8) bit-equal to
    ``blob_view_plain`` on the card, which runs the same operations; one
    launch per view; a second launch bit-equal to the first."""
    from blobctrl_torch.ops import blob_splat as tsplat
    raw, colors = _splat_inputs(cuda_device, n, h, w, m)
    before = tsplat.launches
    got = tsplat.blob_view(*raw, (h, w), colors)
    torch.cuda.synchronize()
    assert tsplat.launches == before + 1
    assert got.dtype == torch.uint8 and got.shape == (h, w, 3)
    assert torch.equal(got, tsplat.blob_view_plain(*raw, (h, w), colors))
    assert torch.equal(tsplat.blob_view(*raw, (h, w), colors), got)


# The bf16 kernels on the tensor cores: every launch below must be reported
# by the C entry point as the tensor-core kernel (``tc_launches``).
FLASH_TC_SHAPES = [
    # the main path: the top level (D = 40) and the second (D = 80), UNet
    # (bh 16) and BlobNet (bh 8)
    (16, 8192, 8192, 40), (8, 8192, 8192, 40),
    (16, 2048, 2048, 80), (8, 2048, 2048, 80),
    # ragged Sq and Skv against the 128-row query and 64-key tiles
    (3, 200, 333, 40), (2, 130, 1000, 80), (1, 129, 65, 40),
    # D in {16, 40, 80, 160}, and D not a multiple of 8 (masked loads)
    (2, 100, 256, 16), (1, 64, 70, 160), (2, 96, 200, 41), (1, 77, 90, 20),
    # a photo's own size (W x H), double width: 640 x 480's top level, 520 x
    # 512's (BlobNet; an odd latent width), 576 x 512's second level
    (16, 9600, 9600, 40), (8, 8320, 8320, 40), (16, 2304, 2304, 80),
]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["running-max", "fixed-max", "exp2-fold"])
def test_flash_tc_kernel_matches_plain_on_card(cuda_device, mode):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    for bh, sq, skv, d in FLASH_TC_SHAPES:
        q, k, v = (torch.randn(bh, s, d, generator=g, device=cuda_device)
                   .bfloat16() for s in (sq, skv, skv))
        scale = d ** -0.5
        if mode == "exp2-fold":
            before = (tfa.exp2_launches, tfa.exp2_tc_launches)
            got = tfa.flash_attention_exp2(q, k, v, scale)
            assert (tfa.exp2_launches, tfa.exp2_tc_launches) == (
                before[0] + 1, before[1] + 1)
            ref = tfa.flash_attention_exp2_reference(q, k, v, scale)
        else:
            fixed = 20.0 if mode == "fixed-max" else None
            before = (tfa.launches, tfa.tc_launches)
            got = tfa.flash_attention(q, k, v, scale, fixed_max=fixed)
            assert (tfa.launches, tfa.tc_launches) == (before[0] + 1,
                                                       before[1] + 1)
            ref = tfa.flash_attention_reference(q, k, v, scale)
        err = _rel_err(got, ref)
        del ref
        assert err <= 2e-2, (bh, sq, skv, d, err)


@pytest.mark.cuda
def test_fp32_kernels_stay_off_the_tensor_cores(cuda_device):
    q = torch.randn(1, 70, 40, device=cuda_device)
    x = torch.randn(1, 8, 16, 32, device=cuda_device)
    k = torch.randn(3, 3, 32, 8, device=cuda_device) * 0.05
    w = torch.randn(32, 24, device=cuda_device) * 0.1
    st = torch.ones(1, 32, device=cuda_device), torch.zeros(1, 32,
                                                            device=cuda_device)
    gamma = torch.ones(32, device=cuda_device)
    counters = [(tfa, "launches", "tc_launches"),
                (twg, "launches", "tc_launches"),
                (tconv, "launches", "tc_launches"),
                (tgn, "launches", "tc_launches"),
                (tgn, "res_launches", "res_tc_launches"),
                (tln, "launches", "tc_launches")]

    def read():
        return [(getattr(m, a), getattr(m, b)) for m, a, b in counters]
    before = read()
    tfa.flash_attention(q, q, q, 0.2)
    twg.conv3x3_winograd(x, k)
    tconv.conv3x3(x, k)
    tgn.affine_matmul(x, w, None, *st)
    tgn.affine_matmul(x, w, residual=torch.zeros(1, 8, 16, 24,
                                                 device=cuda_device))
    tln.ln_matmul(x, gamma, None, w)
    assert read() == [(n + 1, tc) for n, tc in before]


WINOGRAD_TC_SHAPES = [
    # (b, h, w, c, co): the 1029-channel BlobNet conv_in
    (1, 64, 128, 1029, 320),
    # Co of 3, 4 (the 4-channel UNet conv_out, split in two) and 8
    (1, 64, 64, 128, 3), (2, 64, 128, 320, 4), (1, 32, 32, 512, 8),
    # H/2 = 11 and W/2 = 19: ragged 4 x 8 tile patches, Co 320
    (2, 22, 38, 64, 320),
    # an 8 x 16 map at C = 1280: too few blocks, C split across them
    (1, 8, 16, 1280, 1280),
    # the VAE's 512 x 512 x 128 convs
    (1, 512, 512, 128, 128),
    # a photo's own size: 576 x 512's deepest levels, W = 36 and 18
    (1, 16, 36, 1280, 1280), (1, 8, 18, 2560, 1280),
]


@pytest.mark.cuda
@pytest.mark.parametrize("prologue", [False, True])
def test_winograd_tc_kernel_matches_plain_on_card(cuda_device, prologue):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    for b, h, w, c, co in WINOGRAD_TC_SHAPES:
        def rnd(*shape, s=1.0):
            return torch.randn(*shape, generator=g, device=cuda_device) * s
        x = rnd(b, h, w, c).bfloat16()
        k = rnd(3, 3, c, co, s=(9 * c) ** -0.5).bfloat16()
        bias = rnd(co)
        pro = (1 + 0.3 * rnd(b, c), rnd(b, c)) if prologue else (None, None)
        u = twg.transform_weights(k).bfloat16()
        if (h, w, c) == (8, 16, 1280):
            assert twg.launch_config(b, h, w, c, co)["splits"] > 1
        before = (twg.launches, twg.tc_launches)
        got = twg.conv3x3_winograd(x, k, bias, *pro, u=u)
        assert (twg.launches, twg.tc_launches) == (before[0] + 1,
                                                   before[1] + 1)
        ref = twg.conv3x3_winograd_reference(x, u, bias, *pro)
        err = _rel_err(got, ref)
        assert err <= 2e-2, (b, h, w, c, co, err)


CONV_TC_SHAPES = [
    # (b, h, w, c, co): the 1029-channel BlobNet conv_in (2-byte halo loads)
    (1, 64, 128, 1029, 320),
    # an 8 x 16 map at C = 2560: two Co blocks, C split across many blocks
    (1, 8, 16, 2560, 1280),
    # ragged 8 x 16 patches, Co no multiple of 8 (2-byte weight loads) and
    # of the 128-wide block, C no multiple of the 32-channel slice
    (2, 13, 21, 72, 130), (1, 16, 8, 37, 40), (2, 9, 17, 40, 3),
    # the VAE's 512 x 512 x 128 convs
    (1, 512, 512, 128, 128),
    # a photo's own size: 520 x 512's odd widths (the BlobNet conv_in, a
    # level-2 conv with C split, the VAE's), 576 x 512's W = 18
    (1, 64, 130, 1029, 320), (1, 16, 33, 1280, 1280), (1, 128, 130, 512, 512),
    (1, 8, 18, 2560, 1280),
]


@pytest.mark.cuda
@pytest.mark.parametrize("prologue", [False, True])
def test_conv3x3_tc_kernel_matches_plain_on_card(cuda_device, prologue):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    for b, h, w, c, co in CONV_TC_SHAPES:
        def rnd(*shape, s=1.0):
            return torch.randn(*shape, generator=g, device=cuda_device) * s
        x = rnd(b, h, w, c).bfloat16()
        k = rnd(3, 3, c, co, s=(9 * c) ** -0.5).bfloat16()
        bias = rnd(co)
        pro = (1 + 0.3 * rnd(b, c), rnd(b, c)) if prologue else (None, None)
        if (h, w, c) == (8, 16, 2560):
            assert tconv.launch_config(b, h, w, c, co)["splits"] > 1
        before = (tconv.launches, tconv.tc_launches)
        got = tconv.conv3x3(x, k, bias, *pro)
        assert (tconv.launches, tconv.tc_launches) == (before[0] + 1,
                                                       before[1] + 1)
        # a thread reads only what it waited for: launches agree bit for bit
        assert torch.equal(tconv.conv3x3(x, k, bias, *pro), got)
        ref = tconv.conv3x3_reference(x, k, bias, *pro)
        err = _rel_err(got, ref)
        assert err <= 2e-2, (b, h, w, c, co, err)


AFFINE_TC_SHAPES = [
    # (b, h, w, c, n): M = 128 rows at C = 1280 (256-wide blocks, C split),
    # the 8192-row level-1 map of C = 320 (128-wide blocks, N ragged), a
    # wide product (256-wide blocks, no split)
    (1, 8, 16, 1280, 1280), (2, 64, 128, 320, 320), (1, 32, 32, 1280, 2560),
    # h*w = 9 and 63, no multiple of 8; C and N ragged, N % 8 != 0
    (2, 3, 3, 37, 40), (2, 7, 9, 320, 130), (1, 64, 2, 1029, 3),
    # a photo's own size: 520 x 512's h*w = 136 and 2080 (odd W)
    (2, 8, 17, 1280, 1280), (1, 32, 65, 640, 640),
]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["plain", "residual", "residual-no-affine"])
def test_affine_matmul_tc_kernel_matches_plain_on_card(cuda_device, mode):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    for b, h, w, c, n in AFFINE_TC_SHAPES:
        def rnd(*shape, s=1.0):
            return torch.randn(*shape, generator=g, device=cuda_device) * s
        x = rnd(b, h, w, c).bfloat16()
        wk = rnd(c, n, s=c ** -0.5).bfloat16()
        bias = rnd(n)
        st = ((None, None) if mode == "residual-no-affine"
              else (1 + 0.3 * rnd(b, c), rnd(b, c)))
        res = None if mode == "plain" else rnd(b, h, w, n).bfloat16()
        if (b * h * w, c) == (128, 1280):
            assert tgn.launch_config(b * h * w, c, n)["splits"] > 1
        names = (("launches", "tc_launches") if res is None
                 else ("res_launches", "res_tc_launches"))
        before = [getattr(tgn, a) for a in names]
        got = tgn.affine_matmul(x, wk, bias, *st, residual=res)
        assert [getattr(tgn, a) for a in names] == [v + 1 for v in before]
        assert torch.equal(tgn.affine_matmul(x, wk, bias, *st, residual=res),
                           got)
        ref = tgn.affine_matmul_reference(x, wk, bias, *st, residual=res)
        err = _rel_err(got, ref)
        assert err <= 2e-2, (b, h, w, c, n, err)


LN_TC_SHAPES = [
    # (x shape, n): GEGLU's proj_in N = 8C at M = 128 (C split), at the
    # level-3 map (256-wide blocks, no split) and at the level-2 map; fused
    # QKV N = 3C; cross-attention to_q N = C (128-wide blocks)
    ((128, 1280), 10240), ((1024, 1280), 10240), ((2048, 640), 5120),
    ((4096, 640), 1920), ((16384, 320), 320),
    # ragged M, C and N; a batched (B, S, C) input
    ((300, 320), 960), ((33, 37), 3), ((2, 77, 64), 130),
    # a photo's own size: 520 x 512's M = 136 (GEGLU) and 16640 (QKV), 576
    # x 512's M = 1152 (QKV)
    ((136, 1280), 10240), ((16640, 320), 960), ((1152, 1280), 3840),
]


@pytest.mark.cuda
def test_ln_matmul_tc_kernel_matches_plain_on_card(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    for shape, n in LN_TC_SHAPES:
        c = shape[-1]

        def rnd(*s, sc=1.0):
            return torch.randn(*s, generator=g, device=cuda_device) * sc
        x = (rnd(*shape) * 2 + 0.5).bfloat16()
        gamma, beta = 1 + 0.3 * rnd(c), 0.1 * rnd(c)
        wk = rnd(c, n, sc=c ** -0.5).bfloat16()
        bias = rnd(n)
        if shape == (128, 1280):
            assert tgn.launch_config(128, c, n)["splits"] > 1
        before = (tln.launches, tln.tc_launches)
        got = tln.ln_matmul(x, gamma, beta, wk, bias)
        assert (tln.launches, tln.tc_launches) == (before[0] + 1,
                                                   before[1] + 1)
        assert got.shape == shape[:-1] + (n,)
        for _ in range(3):
            assert torch.equal(tln.ln_matmul(x, gamma, beta, wk, bias), got)
        ref = tln.ln_matmul_reference(x, gamma, beta, wk, bias)
        err = _rel_err(got, ref)
        assert err <= 2e-2, (shape, n, err)


# The int8 kernels on the tensor cores: every bf16 launch of the int8 flash
# kernel and every launch of the int8 conv (both dtypes) must be reported by
# the C entry point as the tensor-core kernel (``int8_tc_launches``).
FLASH_INT8_TC_SHAPES = [
    # the main path: the top level (D = 40) and the second (D = 80)
    (16, 8192, 8192, 40), (8, 2048, 2048, 80),
    # ragged Sq and Skv against the 128-row query and 64-key tiles
    (3, 200, 333, 40), (2, 130, 1000, 80), (1, 129, 65, 40),
    # D in {16, 41, 160, 20}: every specialisation, rows padded to 16 bytes,
    # D not a multiple of 8 (masked v loads)
    (2, 100, 256, 16), (1, 64, 70, 160), (2, 96, 200, 41), (1, 77, 90, 20),
    # a photo's own size: 640 x 480's top level, 576 x 512's second
    (16, 9600, 9600, 40), (8, 2304, 2304, 80),
]


@pytest.mark.cuda
@pytest.mark.parametrize("global_k", [True, False])
def test_flash_int8_tc_kernel_matches_plain_on_card(cuda_device, global_k):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    for bh, sq, skv, d in FLASH_INT8_TC_SHAPES:
        q, k, v = (torch.randn(bh, s, d, generator=g, device=cuda_device)
                   .bfloat16() for s in (sq, skv, skv))
        before = (tfa.int8_launches, tfa.int8_tc_launches)
        got = tfa.flash_attention_int8(q, k, v, d ** -0.5, global_k=global_k)
        assert (tfa.int8_launches, tfa.int8_tc_launches) == (before[0] + 1,
                                                             before[1] + 1)
        # integer scores are exact and the rest runs in a fixed order
        assert torch.equal(
            tfa.flash_attention_int8(q, k, v, d ** -0.5, global_k=global_k),
            got)
        ref = tfa.flash_attention_int8_reference(q, k, v, d ** -0.5,
                                                 global_k=global_k)
        err = _rel_err(got, ref)
        del ref
        assert err <= 2e-2, (bh, sq, skv, d, err)


CONV_INT8_TC_SHAPES = [
    # (b, h, w, c, co): the 1029-channel BlobNet conv_in (masked halo loads)
    (1, 64, 128, 1029, 320),
    # the 8 x 16 maps at C = 1280 and 2560: C split across many blocks
    (1, 8, 16, 1280, 1280), (2, 8, 16, 2560, 1280),
    # ragged patches, Co no multiple of 8 nor of the 128-wide block, C no
    # multiple of the 64-channel slice, C = 37 (masked loads in both dtypes)
    (2, 13, 21, 72, 130), (1, 16, 8, 37, 40), (2, 9, 17, 40, 3),
    # the VAE's 512 x 512 x 128 convs
    (1, 512, 512, 128, 128),
    # a photo's own size: 520 x 512's odd widths
    (1, 64, 130, 1029, 320), (1, 16, 33, 1280, 1280),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("prologue", [False, True])
def test_conv3x3_int8_tc_kernel_matches_plain_on_card(cuda_device, dtype, tol,
                                                      prologue):
    """Without a prologue the int32 sum and the epilogue are the plain
    version's, bit for bit; with one, expf may move a quantization level."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    for b, h, w, c, co in CONV_INT8_TC_SHAPES:
        def rnd(*shape, s=1.0):
            return torch.randn(*shape, generator=g, device=cuda_device) * s
        x = (4 * rnd(b, h, w, c)).to(dtype)
        kq, ws = tconv.quantize_kernel_i8(rnd(3, 3, c, co, s=(9 * c) ** -0.5))
        bias = rnd(co)
        pro = (1 + 0.3 * rnd(b, c), rnd(b, c)) if prologue else (None, None)
        if (h, w) == (8, 16):
            assert tconv.launch_config_int8(b, h, w, c, co)["splits"] > 1
        before = (tconv.int8_launches, tconv.int8_tc_launches)
        got = tconv.conv3x3_int8(x, kq, ws, bias, *pro)
        assert (tconv.int8_launches, tconv.int8_tc_launches) == (
            before[0] + 1, before[1] + 1)
        # a thread reads only what it waited for: launches agree bit for bit
        assert torch.equal(tconv.conv3x3_int8(x, kq, ws, bias, *pro), got)
        ref = tconv.conv3x3_int8_reference(x, kq, ws, bias, *pro)
        if prologue:
            err = _rel_err(got, ref)
            assert err <= tol, (b, h, w, c, co, err)
        else:
            assert torch.equal(got, ref), (b, h, w, c, co, _rel_err(got, ref))


@pytest.mark.cuda
def test_int8_kernels_report_their_design(cuda_device):
    """fp32 int8 flash stays on the SIMT kernel; the int8 conv runs on the
    tensor cores in both dtypes."""
    q = torch.randn(1, 70, 40, device=cuda_device)
    x = torch.randn(1, 8, 16, 32, device=cuda_device)
    kq, ws = tconv.quantize_kernel_i8(torch.randn(3, 3, 32, 8,
                                                  device=cuda_device))
    before = (tfa.int8_launches, tfa.int8_tc_launches, tconv.int8_launches,
              tconv.int8_tc_launches)
    tfa.flash_attention_int8(q, q, q, 0.2)
    tfa.flash_attention_int8(q.bfloat16(), q.bfloat16(), q.bfloat16(), 0.2)
    tconv.conv3x3_int8(x, kq, ws)
    tconv.conv3x3_int8(x.bfloat16(), kq, ws)
    assert (tfa.int8_launches, tfa.int8_tc_launches, tconv.int8_launches,
            tconv.int8_tc_launches) == (before[0] + 2, before[1] + 1,
                                        before[2] + 2, before[3] + 2)
