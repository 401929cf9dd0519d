"""Build and bind the hand-written CUDA kernels in ``blobctrl_torch/csrc``.

Each ``csrc/<name>.cu`` compiles with nvcc into its own shared library with
a plain C interface (no PyTorch headers: seconds per file, not minutes) and
is loaded through ctypes; the sources may include the shared headers
``csrc/*.cuh``. Builds happen at first use, never at import, into
``csrc/build/`` (git-ignored); all sources compile in parallel, one nvcc
process each, so the build takes as long as the slowest file. A library is
named by a digest of its source, the headers and the flags, so an edit
rebuilds and
an unchanged one loads as is.

Host code lives beside the kernels: each ``csrc/<name>.cpp`` of
``HOST_SIGNATURES`` (the zstd decoder of the checkpoint reader) is a
plain C library built the same way by the host C++ compiler, on the
card's machine as on a CPU one, so the CPU tests build and run it too.
``build_all`` compiles it with the kernels, in parallel; ``host_entry``
builds it alone. A failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import math
import os
import shutil
import subprocess
import threading

import torch

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
BUILD_DIR = os.path.join(CSRC, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_IP = ctypes.POINTER(ctypes.c_int)  # an int the entry point writes back
# C entry points: name -> (library, i.e. csrc/<library>.cu, function,
# argtypes). A library may hold several entry points.
SIGNATURES = {
    "flash_attention": ("flash_attention", "flash_attention_fwd",
                        (_P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _F, _I, _P,
                         _IP)),
    "conv3x3": ("conv3x3", "conv3x3_fwd",
                (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P,
                 _IP)),
    "flash_attention_int8": ("flash_attention_int8",
                             "flash_attention_int8_fwd",
                             (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I,
                              _I, _P, _IP)),
    "conv3x3_int8": ("conv3x3_int8", "conv3x3_int8_fwd",
                     (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                      _I, _I, _P, _P, _IP)),
    "affine_matmul": ("norm_matmul", "affine_matmul_fwd",
                      (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                       _P, _P, _IP)),
    "ln_matmul": ("norm_matmul", "ln_matmul_fwd",
                  (_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _P, _P, _P,
                   _IP)),
    "winograd": ("winograd", "winograd_fwd",
                 (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P,
                  _IP)),
    "blob_splat": ("blob_splat", "blob_splat_fwd",
                   (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _I,
                    _P)),
}
LIBRARIES = sorted({lib for lib, _, _ in SIGNATURES.values()})
_SZ = ctypes.c_size_t
# host C entry points: name -> (library, i.e. csrc/<library>.cpp,
# function, restype, argtypes)
HOST_SIGNATURES = {
    "zstd_decompress": ("zstd_decode", "zstd_decompress", ctypes.c_long,
                        (_P, _SZ, _P, _SZ)),
    "zstd_content_size": ("zstd_decode", "zstd_content_size",
                          ctypes.c_longlong, (_P, _SZ)),
    "crc32c": ("zstd_decode", "crc32c", ctypes.c_uint,
               (_P, _SZ, ctypes.c_uint)),
}
HOST_LIBRARIES = sorted({lib for lib, _, _, _ in HOST_SIGNATURES.values()})
HOST_FLAGS = ("-O3", "-std=c++17", "-shared")
# What an entry point with a trailing int* writes back when its tensor-core
# kernel ran (0: a SIMT kernel).
DESIGN_TENSOR_CORES = 1

_lock = threading.Lock()
_entry = {}
_host_entry = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _host_cmd(name: str, out: str):
    """The command that builds csrc/<name>.cpp into ``out`` with the host
    C++ compiler ($CXX, else g++)."""
    cxx = shutil.which(os.environ.get("CXX") or "g++")
    if cxx is None:
        raise RuntimeError(f"no C++ compiler ($CXX or g++) found: {name}.cpp "
                           f"cannot be built")
    return [cxx, *HOST_FLAGS, "-fPIC", "-o", out,
            os.path.join(CSRC, f"{name}.cpp")]


def _target(name: str, host: bool = False) -> str:
    """The library's path, named by a digest of its source, the shared
    headers (``csrc/*.cuh``, kernels only) and the flags (for host code,
    the compiler's too)."""
    if host:
        digest = hashlib.sha1(" ".join(_host_cmd(name, "")).encode())
        paths = [os.path.join(CSRC, f"{name}.cpp")]
    else:
        digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
        paths = [os.path.join(CSRC, f"{name}.cu")] + sorted(
            glob.glob(os.path.join(CSRC, "*.cuh")))
    for path in paths:
        with open(path, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def _compile(jobs):
    """Run the builds [(name, target, cmd taking the temporary output)]
    all at once; each library is renamed into place when its build ends.
    Raises on any failure."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for name, so, cmd in jobs:
        tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
        procs.append((name, subprocess.Popen(
            cmd(tmp), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, so))
    failed = []
    for name, proc, tmp, so in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("build failed:\n" + "\n".join(failed))


def _load_host(libs):
    for name, (lib, fn_name, restype, argtypes) in HOST_SIGNATURES.items():
        fn = getattr(libs[lib], fn_name)
        fn.argtypes = argtypes
        fn.restype = restype
        _host_entry[name] = fn


def _host_jobs():
    return [(f"{lib}.cpp", _target(lib, True),
             lambda tmp, lib=lib: _host_cmd(lib, tmp))
            for lib in HOST_LIBRARIES
            if not os.path.exists(_target(lib, True))]


def host_entry(name: str):
    """The host C entry point ``name`` of ``HOST_SIGNATURES``, built on
    first use by the host C++ compiler."""
    if name not in _host_entry:
        with _lock:
            if name not in _host_entry:
                _compile(_host_jobs())
                _load_host({lib: ctypes.CDLL(_target(lib, True))
                            for lib in HOST_LIBRARIES})
    return _host_entry[name]


def build_all():
    """Compile every kernel library and host library that is missing (all
    compiler processes started together), then load them all. Raises on
    any failure."""
    with _lock:
        if len(_entry) == len(SIGNATURES) and \
                len(_host_entry) == len(HOST_SIGNATURES):
            return
        jobs = [(f"{name}.cu", _target(name),
                 lambda tmp, name=name: [_nvcc(), *NVCC_FLAGS, "-o", tmp,
                                         os.path.join(CSRC, f"{name}.cu")])
                for name in LIBRARIES if not os.path.exists(_target(name))]
        _compile(jobs + _host_jobs())
        _load_host({lib: ctypes.CDLL(_target(lib, True))
                    for lib in HOST_LIBRARIES})
        libs = {name: ctypes.CDLL(_target(name)) for name in LIBRARIES}
        for name, (lib, fn_name, argtypes) in SIGNATURES.items():
            fn = getattr(libs[lib], fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _entry[name] = fn


def entry(name: str):
    """The C entry point ``name`` of ``SIGNATURES``, built on first use."""
    if name not in _entry:
        build_all()
    return _entry[name]


def check(name: str, rc: int):
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


def stream(device: torch.device) -> int:
    """The raw ``cudaStream_t`` of PyTorch's current stream on ``device``:
    the value of ``torch.cuda.current_stream(device).cuda_stream``, without
    building a stream object on every launch."""
    index = device.index
    return torch._C._cuda_getCurrentRawStream(
        torch.cuda.current_device() if index is None else index)


def as_f32(t: torch.Tensor, device: torch.device, *shape: int) -> torch.Tensor:
    """t as a contiguous fp32 tensor of ``shape`` on ``device``, reshaped
    when it holds as many elements, else broadcast: t itself when it
    already is one, as the small per-call parameters (bias, scales) usually
    are."""
    if (t.dtype == torch.float32 and t.device == device
            and t.shape == shape and t.is_contiguous()):
        return t
    t = t.to(device=device, dtype=torch.float32)
    return (t.reshape(shape) if t.numel() == math.prod(shape)
            else t.expand(*shape)).contiguous()


def refuse_grad(name: str, remedy: str, *tensors):
    """Raise when autograd would record a call of a kernel that has no
    backward (the JAX package defines no VJP for it either): grad mode on
    and any input requiring grad. The plain version is not taken instead,
    on either device; ``remedy`` says what the caller does instead."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} has no backward: {remedy} to train, or "
                           f"call it under torch.no_grad()")
