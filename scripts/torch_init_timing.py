"""Times the production-geometry random weights on the card: the seconds of
``apps/flagship.production_params(0)`` in bf16 and in fp32 and of
``production_encoder_params(3)`` in bf16 (until drawn, median of REPS after
one warm-up draw), and the peak device memory each draw adds above what was
allocated before it. ``--root`` names the checkout whose ``blobctrl_torch``
is timed (this one by default), so that two versions can be compared in one
process on one card.

    python scripts/torch_init_timing.py [--root DIR]
"""

import argparse
import os
import statistics
import subprocess
import sys
import time

import torch

REPS = 3


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from blobctrl_torch.apps import flagship
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"{card}; blobctrl_torch from {os.path.abspath(args.root)}")
    draws = (("production_params(0), bf16",
              lambda: flagship.production_params(0, "cuda", torch.bfloat16)),
             ("production_params(0), fp32",
              lambda: flagship.production_params(0, "cuda", torch.float32)),
             ("production_encoder_params(3), bf16",
              lambda: flagship.production_encoder_params(3, "cuda",
                                                         torch.bfloat16)))
    for name, fn in draws:
        secs, peaks = [], []
        for rep in range(REPS + 1):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            trees = fn()
            torch.cuda.synchronize()
            if rep:
                secs.append(time.perf_counter() - t0)
                peaks.append(torch.cuda.max_memory_allocated() - base)
            held = torch.cuda.memory_allocated() - base
            del trees
            torch.cuda.empty_cache()
        print(f"{name}: {statistics.median(secs):.3f} s (median of {REPS}: "
              f"{', '.join(f'{s:.3f}' for s in secs)}), tree "
              f"{held / 2 ** 30:.2f} GiB, peak {max(peaks) / 2 ** 30:.2f} "
              f"GiB above the allocation before it")
    return 0


if __name__ == "__main__":
    sys.exit(main())
