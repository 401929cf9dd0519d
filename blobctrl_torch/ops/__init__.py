"""Hand-written Hopper kernels, each beside its plain PyTorch version.

A wrapper takes its plain version only for CPU tensors; for a CUDA tensor it
launches its kernel (building it on first use) or raises. ``launches`` on
each module counts kernel launches, and nothing else."""

from blobctrl_torch.ops import (blob_splat, conv3x3, flash_attention,
                                gn_matmul, ln_matmul, winograd)

# kernel name -> (module, launch counter, shape log): every kernel mode a
# wrapper launches
KERNELS = {
    "flash_attention": (flash_attention, "launches", "launch_shapes"),
    "flash_attention_int8": (flash_attention, "int8_launches",
                             "int8_launch_shapes"),
    "flash_attention_exp2": (flash_attention, "exp2_launches",
                             "exp2_launch_shapes"),
    "conv3x3": (conv3x3, "launches", "launch_shapes"),
    "conv3x3_int8": (conv3x3, "int8_launches", "int8_launch_shapes"),
    "affine_matmul": (gn_matmul, "launches", "launch_shapes"),
    "affine_matmul_residual": (gn_matmul, "res_launches",
                               "res_launch_shapes"),
    "ln_matmul": (ln_matmul, "launches", "launch_shapes"),
    "winograd": (winograd, "launches", "launch_shapes"),
    "blob_splat": (blob_splat, "launches", "launch_shapes"),
}


# kernel name -> (module, counter): the launches of that kernel that the C
# entry point reports as run on its tensor-core kernel (bf16, and for the
# int8 conv both dtypes)
TENSOR_CORE = {
    "flash_attention": (flash_attention, "tc_launches"),
    "flash_attention_exp2": (flash_attention, "exp2_tc_launches"),
    "flash_attention_int8": (flash_attention, "int8_tc_launches"),
    "conv3x3": (conv3x3, "tc_launches"),
    "conv3x3_int8": (conv3x3, "int8_tc_launches"),
    "affine_matmul": (gn_matmul, "tc_launches"),
    "affine_matmul_residual": (gn_matmul, "res_tc_launches"),
    "ln_matmul": (ln_matmul, "tc_launches"),
    "winograd": (winograd, "tc_launches"),
}


def reset_counts():
    """Zero every kernel's launch counters and shape log."""
    for mod, count, shapes in KERNELS.values():
        setattr(mod, count, 0)
        getattr(mod, shapes).clear()
    for mod, count in TENSOR_CORE.values():
        setattr(mod, count, 0)
