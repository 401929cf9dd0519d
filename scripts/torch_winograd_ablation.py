"""Where the bf16 Winograd kernel of the PyTorch port spends its time: an
ablation on one NVIDIA GPU.

    python3 scripts/torch_winograd_ablation.py

Builds ``blobctrl_torch/csrc/winograd.cu`` as it is and in copies with one
phase of the tensor-core kernel disabled (the U copies, the input-halo
copies, the mma products, the input transform, the GN+SiLU prologue), and
times each, with CUDA events (median of 10 after warm-up), at five shapes of
a 512^2 fused edit. A disabled phase leaves wrong results: the copies exist
only for this timing. The time a phase saves when disabled bounds what that
phase costs; the savings may sum to more than the whole where phases
overlap.
"""

from __future__ import annotations

import ctypes
import os
import statistics
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [  # (b, h, w, c, co, GN+SiLU prologue)
    (2, 64, 128, 640, 640, False), (2, 64, 128, 320, 320, True),
    (1, 512, 512, 128, 128, True), (2, 16, 32, 1280, 1280, True),
    (2, 32, 64, 640, 640, True)]
KERNEL = "// grid: (B * patches, Co blocks, splits)"


def variants(src: str) -> dict:
    """name -> source with one phase of the tensor-core kernel disabled."""
    nop_mma = ("__device__ __forceinline__ void mma_nop(float (&)[4], "
               "const uint32_t (&)[4], uint32_t, uint32_t) {}\n")
    loop = "    for (int tile = tid / (TK / 2); tile < TM;"
    pro = "auto prologue = [&](bf16* hs, const float* ss_stage, int c0) {"
    out = {
        "all": src,
        "no U copies": src.replace(KERNEL, "#define load_u(...) ((void)0)\n"
                                   + KERNEL),
        "no halo copies": src.replace(
            KERNEL, "#define load_halo(...) ((void)0)\n" + KERNEL),
        "no products": src.replace(KERNEL, nop_mma + KERNEL).replace(
            "tc::mma_bf16(acc", "mma_nop(acc"),
        "no transform": src.replace(loop, "    if (false)\n" + loop),
        "no prologue": src.replace(pro, pro + " return;"),
    }
    for name, text in out.items():
        if name != "all" and text == src:
            raise RuntimeError(f"{name}: the kernel source changed shape")
    return out


def build(sources: dict, tmp: str) -> dict:
    """Compile every variant in parallel -> name -> C entry point."""
    sys.path.insert(0, ROOT)
    from blobctrl_torch.ops import _build
    procs = {}
    for i, (name, text) in enumerate(sources.items()):
        path = os.path.join(tmp, f"v{i}.cu")
        with open(path, "w") as f:
            f.write(text)
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC, "-o",
             path[:-3] + ".so", path], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), path[:-3] + ".so")
    fns = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        fn = ctypes.CDLL(so).winograd_fwd
        fn.argtypes = _build.SIGNATURES["winograd"][2]
        fns[name] = fn
    return fns


def time_ms(fn, reps: int = 10) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from blobctrl_torch.ops import _build, winograd
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    with open(os.path.join(_build.CSRC, "winograd.cu")) as f:
        src = f.read()
    with tempfile.TemporaryDirectory() as tmp:
        fns = build(variants(src), tmp)
        g = torch.Generator(device="cuda").manual_seed(0)
        for b, h, w, c, co, pro in SHAPES:
            x = torch.randn(b, h, w, c, device="cuda",
                            generator=g).bfloat16()
            u = (torch.randn(16, c, co, device="cuda", generator=g)
                 * 0.01).bfloat16()
            bias = torch.randn(co, device="cuda", generator=g)
            st = [torch.randn(b, c, device="cuda", generator=g)
                  for _ in range(2)] if pro else [None, None]
            splits = winograd.launch_config(b, h, w, c, co)["splits"]
            y = torch.empty(b, h, w, co, device="cuda", dtype=torch.bfloat16)
            ws = (torch.empty(splits, b, h, w, co, device="cuda")
                  if splits > 1 else None)

            def ptr(t):
                return None if t is None else t.data_ptr()
            row = []
            for name, fn in fns.items():
                def call():
                    rc = fn(x.data_ptr(), u.data_ptr(), bias.data_ptr(),
                            ptr(st[0]), ptr(st[1]), y.data_ptr(), b, h, w, c,
                            co, 1, splits, ptr(ws),
                            torch.cuda.current_stream().cuda_stream, None)
                    if rc != 0:
                        raise RuntimeError(f"{name}: cudaError {rc}")
                row.append(f"{name} {time_ms(call):.4f}")
            print(f"b={b} h={h} w={w} c={c} co={co}"
                  f"{' +gn-silu' if pro else ''} splits={splits} ms: "
                  + ", ".join(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
