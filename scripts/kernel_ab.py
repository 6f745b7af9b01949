#!/usr/bin/env python3
"""Time every kernel of the port (B1-B4) of one checkout on one GPU.

    python3 scripts/kernel_ab.py --src path/to/checkout/src --tag NAME

Imports ``repro_torch`` from ``--src``, so a parent commit unpacked
beside the repository (``git archive``) is timed in the same call as the
working tree: run parent, change, change, parent, each in its own
process. Builds that checkout's kernels, then prints one JSON line at the
serving shapes:

- B1: vrmom (K = 8) over an [8, 4, 151936] f32 logit stack (the unfused
  robust tail);
- B4: the same stack, greedy and top-50, without the [B, V] aggregate
  (the fused robust tail), and greedy over [8, 32, 151936]; beside
  them ``stack_sum_*``, one ``torch.sum`` over the stack's worker axis,
  the time a library kernel takes to read the same bytes;
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
no call waits on it, while the host makes 200 calls. ``--only b1b4``
or ``--only attn`` times one group.
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
V = 151936                   # qwen3 vocabulary


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


def time_b1b4(out, torch, dev, g, flush) -> None:
    from repro_torch.kernels.vrmom import aggregate, aggregate_sample

    for B in (4, 32):
        x = 4.0 * torch.randn((8, B, V), generator=g, device=dev)
        calls = {f"b4_b{B}_greedy": lambda x=x: aggregate_sample(
            x, "vrmom", K=8, with_agg=False)}
        if B == 4:
            calls["b1_b4"] = lambda: aggregate(x, "vrmom", K=8)
            calls["b4_b4_top50"] = lambda: aggregate_sample(
                x, "vrmom", K=8, top_k=50, with_agg=False)
        for name, fn in calls.items():
            out[f"{name}_ms"] = device_ms(fn, torch, flush)
            out[f"{name}_host_us"] = host_us(fn, torch)
        # a yardstick of the read alone: one PyTorch reduction of the stack
        out[f"stack_sum_b{B}_ms"] = device_ms(lambda x=x: x.sum(0), torch,
                                              flush)


def time_attn(out, torch, dev, g, flush) -> None:
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention

    def rand(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    def sdpa(q, k, v, causal):
        qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
        return lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True)

    q, k, v = rand(4, 192, 16, 128), rand(4, 192, 8, 128), rand(4, 192, 8, 128)

    def b2():
        return flash_attention(q, k, v, causal=True)

    out["b2_ms"] = device_ms(b2, torch, flush)
    out["b2_sdpa_ms"] = device_ms(sdpa(q, k, v, True), torch, flush)
    out["b2_host_us"] = host_us(b2, torch)
    for B in (4, 32):
        q = rand(B, 1, 16, 128)
        k, v = rand(B, 216, 8, 128), rand(B, 216, 8, 128)

        def b3():
            return decode_attention(q, k, v, kv_len=216)

        out[f"b3_b{B}_ms"] = device_ms(b3, torch, flush)
        out[f"b3_b{B}_sdpa_ms"] = device_ms(sdpa(q, k, v, False), torch,
                                            flush)
        out[f"b3_b{B}_host_us"] = host_us(b3, torch)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", required=True, help="a checkout's src directory")
    ap.add_argument("--tag", default="")
    ap.add_argument("--only", choices=("b1b4", "attn"), default=None)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels import build

    build.build_all()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    scratch = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)

    def flush():
        scratch.fill_(1)

    out = {"tag": args.tag, "src": args.src,
           "card": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], capture_output=True, text=True
           ).stdout.strip()}
    if args.only in (None, "b1b4"):
        time_b1b4(out, torch, dev, g, flush)
    if args.only in (None, "attn"):
        time_attn(out, torch, dev, g, flush)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
