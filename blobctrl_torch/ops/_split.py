"""The split of K across blocks that the bf16 tensor-core kernels take
where their output blocks alone would leave SMs idle (``csrc/winograd.cu``
and the shared GEMM mainloop of ``csrc/gemm_bf16.cuh``). Pure Python, so
the CPU tests can check each kernel's launch at every main-path shape.

The blocks of a grid spread evenly over the SMs, so a grid of N blocks puts
ceil(N / NUM_SMS) blocks' work on the busiest SM (its "waves"), and the
last wave may leave most SMs idle. Splitting K into s parts gives s times
the blocks, each with 1/s of the K slices; the parts are summed in fp32 by
a second kernel."""

from __future__ import annotations

import functools

NUM_SMS = 132         # the H100 SXM's SMs
MIN_SLICES_PER_SPLIT = 2
SPLIT_OVERHEAD_SLICES = 1.5  # a block's fixed cost (first loads, epilogue) in slices


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def split_k(grid: int, slices: int) -> int:
    """The number of K splits for a grid of ``grid`` output blocks with
    ``slices`` K slices each: it minimizes waves x (slices per split +
    ``SPLIT_OVERHEAD_SLICES``) among the splits whose grid reaches
    ``NUM_SMS`` blocks (or the largest grid, where none does), each split
    at least ``MIN_SLICES_PER_SPLIT`` slices and none empty; 1 wins ties."""
    best = None
    for want in range(1, max(1, slices // MIN_SLICES_PER_SPLIT) + 1):
        per = cdiv(slices, want)
        splits = cdiv(slices, per)  # no empty split
        waves = cdiv(grid * splits, NUM_SMS)
        cost = (grid * splits < NUM_SMS, waves * (per + SPLIT_OVERHEAD_SLICES),
                splits)
        if best is None or cost < best[0]:
            best = (cost, splits)
    return best[1]
