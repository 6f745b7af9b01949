#!/usr/bin/env python3
"""Time the port's attention kernels B2 and B3 of one checkout on one GPU.

    python3 scripts/attn_kernel_ab.py --src path/to/checkout/src --tag NAME

Imports ``repro_torch`` from ``--src``, so a parent commit unpacked
beside the repository (``git archive``) is timed in the same call as the
working tree: run parent, change, change, parent, each in its own
process. Builds that checkout's kernels, then prints one JSON line at the
serving shapes:

- B2: causal, q [4,192,16,128], k/v [4,192,8,128] bf16 (prefill);
- B3: q [4,1,16,128] over a [4,216,8,128] bf16 cache, python-int length
  216 (a decode step), and the same at batch 32 (the replicated path).

``*_ms`` is device time: the median of CUDA events around one call, with
a cold L2 and the device spinning ~2 ms before the start event, so the
host has enqueued the call before the device reaches it and the events
bracket device work only (one SDPA call on the same inputs is timed the
same way). ``chip_smoke.py`` times with events alone, so a wrapper whose
host time exceeds its kernel's counts there. ``*_host_us`` is the
wrapper's host time per call: the device spins ~50 ms, long enough that
no call waits on it, while the host makes 200 calls.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

SPIN_CYCLES = 4_000_000      # ~2 ms of device spin at the H100's 1.98 GHz
HOST_SPIN_CYCLES = 100_000_000
HOST_CALLS = 200


def device_ms(fn, torch, flush, iters: int = 50) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        flush()
        torch.cuda._sleep(SPIN_CYCLES)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def host_us(fn, torch, reps: int = 5) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(reps):
        torch.cuda._sleep(HOST_SPIN_CYCLES)
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            fn()
        per_call.append((time.perf_counter() - t0) / HOST_CALLS * 1e6)
        torch.cuda.synchronize()
    return statistics.median(per_call)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", required=True, help="a checkout's src directory")
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("attn_kernel_ab.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention

    build.build_all()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    scratch = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)

    def flush():
        scratch.fill_(1)

    def rand(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    def sdpa(q, k, v, causal):
        qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
        return lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True)

    out = {"tag": args.tag, "src": args.src,
           "card": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], capture_output=True, text=True
           ).stdout.strip()}
    q, k, v = rand(4, 192, 16, 128), rand(4, 192, 8, 128), rand(4, 192, 8, 128)

    def b2():
        return flash_attention(q, k, v, causal=True)

    out["b2_ms"] = device_ms(b2, torch, flush)
    out["b2_sdpa_ms"] = device_ms(sdpa(q, k, v, True), torch, flush)
    out["b2_host_us"] = host_us(b2, torch)
    for B in (4, 32):
        q, k, v = rand(B, 1, 16, 128), rand(B, 216, 8, 128), rand(B, 216, 8, 128)

        def b3():
            return decode_attention(q, k, v, kv_len=216)

        out[f"b3_b{B}_ms"] = device_ms(b3, torch, flush)
        out[f"b3_b{B}_sdpa_ms"] = device_ms(sdpa(q, k, v, False), torch,
                                            flush)
        out[f"b3_b{B}_host_us"] = host_us(b3, torch)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
