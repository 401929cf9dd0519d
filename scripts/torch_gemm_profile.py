"""Device time of the bf16 kernels on the shared tensor-core GEMM mainloop
(``blobctrl_torch/csrc/gemm_bf16.cuh``): the direct conv3x3 (K6/K7) and the
normalize-prologue GEMM (K10/K11), each with and without its prologue,
against one library call computing the same product (cuDNN's conv, cuBLAS's
matmul, without the prologue), at the main path's largest shapes. Device
times come from ``torch.profiler`` (the sum of the call's kernels, averaged
over 20 calls), so the host's launch overhead is left out; the host time
of a call (its wrapper's checks, allocations and launches) is measured
apart, over 200 calls issued back to back. Each kernel is also launched
three more times and must agree bit for bit.

    python scripts/torch_gemm_profile.py       # on a machine with the card

Prints one line per (shape, variant): device microseconds, TFLOP/s and
host microseconds per call.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from blobctrl_torch.ops import _build  # noqa: E402
from blobctrl_torch.ops import conv3x3 as cv  # noqa: E402
from blobctrl_torch.ops import gn_matmul as gm  # noqa: E402
from blobctrl_torch.ops import ln_matmul as lm  # noqa: E402

# (m, c, n): GEGLU's proj_in at the three UNet levels, the level-1 to_q
GEMM_SHAPES = [(1024, 1280, 10240), (4096, 640, 5120), (16384, 320, 2560),
               (16384, 320, 320)]
# (b, h, w, c, co): the VAE's 512^2 conv, the UNet's level-1, -3 and -4
# resnet convs (batch 2: CFG), BlobNet's 1029-channel conv_in
CONV_SHAPES = [(2, 512, 512, 128, 128), (2, 64, 128, 320, 320),
               (2, 32, 64, 1280, 1280), (2, 8, 16, 1280, 1280),
               (1, 64, 128, 1029, 320)]


def device_us(fn, reps: int = 20) -> float:
    """Mean device time of one call, microseconds (every kernel it runs)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(ev, "device_time_total", None)
                or getattr(ev, "cuda_time_total", 0)
                for ev in prof.key_averages())
    return total / reps


def host_us(fn, reps: int = 200) -> float:
    """Host time of one call issued back to back, microseconds."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def report(label: str, flop: float, cases) -> None:
    for name, fn in cases:
        us = device_us(fn)
        print(f"{label} {name}: device {us:.1f} us, {flop / us / 1e6:.0f} "
              f"TFLOP/s, host {host_us(fn):.1f} us a call", flush=True)


def deterministic(fn) -> bool:
    first = fn()
    return all(torch.equal(fn(), first) for _ in range(3))


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_gemm_profile: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    _build.build_all()
    g = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, device="cuda", generator=g)
    for m, c, n in GEMM_SHAPES:
        x = rnd(m, c).bfloat16()
        w = (rnd(c, n) * c ** -0.5).bfloat16()
        bias, gamma, beta = rnd(n), 1 + 0.3 * rnd(c), 0.1 * rnd(c)
        s, t = 1 + 0.3 * rnd(1, c), rnd(1, c)
        x4 = x.reshape(1, m, 1, c)
        cfg = gm.launch_config(m, c, n)
        cases = [("ln_matmul", lambda: lm.ln_matmul(x, gamma, beta, w, bias)),
                 ("affine_matmul", lambda: gm.affine_matmul(x4, w, bias, s, t)),
                 ("no prologue", lambda: gm.affine_matmul(x4, w, bias)),
                 ("cuBLAS matmul", lambda: torch.matmul(x, w))]
        label = (f"gemm m={m} c={c} n={n} (block_n {cfg['block_n']}, "
                 f"splits {cfg['splits']})")
        report(label, 2.0 * m * c * n, cases)
        print(f"{label} deterministic: "
              f"{all(deterministic(fn) for _, fn in cases[:3])}", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    for b, h, wd, c, co in CONV_SHAPES:
        x = rnd(b, h, wd, c).bfloat16()
        k = (rnd(3, 3, c, co) * (9 * c) ** -0.5).bfloat16()
        bias, sc, sh = rnd(co), 1 + 0.3 * rnd(b, c), rnd(b, c)
        xn = x.permute(0, 3, 1, 2)
        kn = k.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        cases = [("conv3x3 +gn-silu", lambda: cv.conv3x3(x, k, bias, sc, sh)),
                 ("conv3x3", lambda: cv.conv3x3(x, k, bias)),
                 ("cuDNN conv2d", lambda: torch.nn.functional.conv2d(
                     xn, kn, None, padding=1))]
        label = (f"conv b={b} h={h} w={wd} c={c} co={co} (splits "
                 f"{cv.launch_config(b, h, wd, c, co)['splits']})")
        report(label, 2.0 * b * h * wd * co * 9 * c, cases)
        print(f"{label} deterministic: "
              f"{all(deterministic(fn) for _, fn in cases[:2])}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
