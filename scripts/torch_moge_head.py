#!/usr/bin/env python3
"""Time each convolution of gs_init_tpu_torch's MoGe-2 vitl head on the card,
with cuDNN and without it (PyTorch's own CUDA convolution), in float32 with
TF32 off, at the head's shapes for a 742x476 network input (phase 6c of
chip_smoke.py), then the whole head as the port runs it. Random weights, seed 0.

    python3 scripts/torch_moge_head.py   # from the repo root, on a machine with a card

Prints one line per convolution: its input shape, device ms (CUDA events,
mean of 3 after a warm-up) and peak memory with and without cuDNN, and the
largest difference between the two outputs relative to its max; then the
whole head as the port runs it.
"""
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from gs_init_tpu_torch.models.common import build, full_fp32, init_random_, without_cudnn
    from gs_init_tpu_torch.models.moge import MoGeHead, resize_bilinear

    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)

    def timed(fn, n=3):
        fn()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            out = fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / n, torch.cuda.max_memory_allocated() / 2**30, out

    def both(label, fn):
        ms, peak, ref = timed(fn)
        with without_cudnn():
            ms2, peak2, out = timed(fn)
        err = float((out - ref).abs().max() / ref.abs().max())
        print(f"{label}: cuDNN {ms:.3f} ms, peak {peak:.3f} GiB; without cuDNN {ms2:.3f} ms, "
              f"peak {peak2:.3f} GiB; difference {err:.2e} of max", flush=True)

    head = init_random_(build(MoGeHead, 1024), 0).to(dev).eval()
    g = torch.Generator(dev).manual_seed(0)
    feats = [torch.randn(1, 1024, 34, 53, device=dev, generator=g) for _ in range(4)]
    with torch.inference_mode(), full_fp32(), without_cudnn():
        x = sum(p(f) for p, f in zip(head.projects, feats))
    with torch.inference_mode(), full_fp32():
        for i, (up, blocks) in enumerate(zip(head.upsample, head.res)):
            x = resize_bilinear(x, (x.shape[2] * 2, x.shape[3] * 2))
            both(f"upsample_{i} 3x3 {tuple(x.shape)} -> {up.out_channels}", lambda: up(x))
            with without_cudnn():
                x = up(x)
            for j, blk in enumerate(blocks):
                both(f"  res_{i}_{j} conv1 3x3 {tuple(x.shape)}", lambda: blk.conv1(x))
                with without_cudnn():
                    x = blk(x)
        x = resize_bilinear(x, (238, 371))
        both(f"out 3x3 {tuple(x.shape)}", lambda: head.out[0](x))

        ms, peak, _ = timed(lambda: head(feats, (238, 371)))
        print(f"whole head as the port runs it (without cuDNN): {ms:.3f} ms, peak {peak:.3f} GiB", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
