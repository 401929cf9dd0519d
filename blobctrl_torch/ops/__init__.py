"""Hand-written Hopper kernels, each beside its plain PyTorch version.

A wrapper takes its plain version only for CPU tensors; for a CUDA tensor it
launches its kernel (building it on first use) or raises. ``launches`` on
each module counts kernel launches, and nothing else."""

from blobctrl_torch.ops import conv3x3, flash_attention


def reset_counts():
    """Zero every kernel's launch counter and shape log."""
    for mod in (flash_attention, conv3x3):
        mod.launches = mod.int8_launches = 0
        mod.launch_shapes.clear()
        mod.int8_launch_shapes.clear()
