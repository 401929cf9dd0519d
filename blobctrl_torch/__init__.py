"""blobctrl_torch — the BlobCtrl element-level editing stack in PyTorch, for
NVIDIA Hopper (H100).

Mirrors the subpackages of the JAX package (``blobctrl_tpu/``) module by
module (``nn``, ``ops``, ``models``, ``schedulers``, ``blob``, ``pipeline``,
``params``, ``apps``, ``tokenizer``) so each function has an obvious
counterpart:

  * NHWC activations and HWIO conv kernels at every public function;
  * params are plain dicts / lists of tensors with the JAX package's key
    names (``params.from_jax`` carries a JAX pytree across unchanged);
  * every kernel the JAX package writes in Pallas (flash attention, the
    3x3 conv, their int8 and fused variants, the blob splat) is
    hand-written CUDA C++ in ``csrc/``, built with nvcc at first use and
    bound through ctypes (``ops``);
  * host-side image work (resizes, ellipse rasters, the ellipse fit) is
    numpy, bit-equal to the PIL and cv2 calls of the JAX package, which
    the port does not import.

Entry points run on the card: they default to ``device="cuda"`` and raise
``RuntimeError`` when CUDA is unavailable, unless the caller asks for
``device="cpu"``.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"

# MKL's vector math library, behind torch.exp, sin, log, erf ... on the CPU,
# sets itself up lazily at its first call in a process. When that first call
# is split over two or more threads (a float tensor of 4096 elements or
# more), the threads race, and in about one process in fifty the second
# thread computes its half with relative errors near 1e-4. One serial call
# here settles the set-up before any parallel one.
torch.exp(torch.zeros(1))


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. Never falls back to the CPU on its
    own: asking for CUDA on a machine without it raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    return dev

