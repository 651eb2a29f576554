#!/usr/bin/env python3
"""Time the fused SLIC wrapper of one tree on the card, at the superpixel
step of record: (6, 4, 256, 256, 3) frames, 36 segments, compactness 50,
10 rounds.

    python3 chip_slic_probe.py [ROOT] [TAG]

``ROOT`` is the tree whose ``videowalk_tpu_torch`` is timed (default: the
directory of this script), e.g. a parent commit unpacked with ``git archive
<parent> | tar -x -C _archive/parent``, so that two trees can be compared
in one call (parent, change, change, parent). For white-noise and smooth
frames, with and without ``return_centers``, it prints the median of 20
calls by CUDA events, and from ``torch.profiler`` over 10 calls the device
µs a call of each kernel, the device launches a call and the host-to-device
copies a call; then one round alone (``n_iter=1``) without and with its
center sums, and the host's µs a call over 50 calls queued without a
synchronize. Needs a CUDA card; prints lines only, no result.
"""

from __future__ import annotations

import os
import re
import sys
import time


def main() -> int:
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1
                           else os.path.dirname(os.path.abspath(__file__)))
    tag = sys.argv[2] if len(sys.argv) > 2 else root
    sys.path.insert(0, root)
    import torch
    from torch.profiler import ProfilerActivity, profile

    import videowalk_tpu_torch.ops.slic as S

    if not S.__file__.startswith(root):
        print(f"chip_slic_probe: imported {S.__file__}, not {root}",
              file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_slic_probe: CUDA is not available", file=sys.stderr)
        return 1

    g = torch.Generator(device="cuda").manual_seed(11)
    noise = torch.rand((6, 4, 256, 256, 3), generator=g, device="cuda")
    yy, xx = torch.meshgrid(torch.arange(256, device="cuda"),
                            torch.arange(256, device="cuda"), indexing="ij")
    phase = torch.rand((24, 1, 1, 3), generator=g, device="cuda") * 6
    wave = 0.5 + 0.5 * torch.sin(
        yy[None, :, :, None] * 0.03
        + xx[None, :, :, None] * 0.05 * torch.arange(1, 4, device="cuda")
        + phase)
    smooth = (wave + 0.05 * torch.rand(wave.shape, generator=g,
                                       device="cuda")).clamp(0, 1)
    smooth = smooth.reshape(6, 4, 256, 256, 3)
    kw = dict(n_segments=36, compactness=50.0)

    def profiled(fn, n=10):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        us, count, htod = {}, {}, 0
        for e in prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            t = getattr(e, "self_device_time_total", None)
            if t is None:
                t = e.self_cuda_time_total
            if "HtoD" in e.key:
                htod += e.count
            name = re.sub(r"^.*?(slic_\w+).*$", r"\1", e.key)[:50]
            us[name] = us.get(name, 0.0) + t / n
            count[name] = count.get(name, 0.0) + e.count / n
        return us, count, htod / n

    def events_ms(fn, reps=20):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            ts.append(a.elapsed_time(b))
        ts.sort()
        return ts[len(ts) // 2], ts[0], ts[-1]

    for name, x in (("noise", noise), ("smooth", smooth)):
        for rc in (False, True):
            def fn():
                return S.slic_fused(x, return_centers=rc, **kw)
            med, lo, hi = events_ms(fn)
            us, count, htod = profiled(fn)
            print(f"[{tag}] {name} return_centers={rc}: ms a call median "
                  f"{med:.4f} (min {lo:.4f}, max {hi:.4f}); device us a call "
                  f"{sum(us.values()):.1f}; launches {sum(count.values()):.1f};"
                  f" HtoD {htod:.1f}", flush=True)
            for k, v in sorted(us.items(), key=lambda kv: -kv[1]):
                print(f"    {v:9.2f} us  x{count[k]:.1f}  {k}", flush=True)
        for rc in (False, True):
            us, _, _ = profiled(lambda: S.slic_fused(
                x, n_iter=1, return_centers=rc, **kw))
            print(f"[{tag}] {name} one round, sums={rc}: " + ", ".join(
                f"{k} {v:.2f} us"
                for k, v in us.items()), flush=True)

    def call():
        return S.slic_fused(noise, **kw)
    for _ in range(5):
        call()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    a.record()
    for _ in range(50):
        call()
    t1 = time.perf_counter()
    b.record()
    torch.cuda.synchronize()
    print(f"[{tag}] host us a call {(t1 - t0) / 50 * 1e6:.1f}; back-to-back "
          f"ms a call {a.elapsed_time(b) / 50:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
