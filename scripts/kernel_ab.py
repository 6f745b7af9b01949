#!/usr/bin/env python3
"""Time every kernel of the port (B1-B4) of one checkout on one GPU.

    python3 scripts/kernel_ab.py --src path/to/checkout/src --tag NAME

Imports ``repro_torch`` from ``--src``, so a parent commit unpacked
beside the repository (``git archive``) is timed in the same call as the
working tree: run parent, change, change, parent, each in its own
process. Builds that checkout's kernels, then prints one JSON line at the
serving shapes:

- B1: vrmom over an [8, 4, 151936] logit stack (the unfused robust tail)
  at K = 8 in f32 and bf16 and at K = 10 and 100 in f32, over a
  [100, 65536] f32 stack at K = 10, and over [101, 250 * 465] at K = 10
  (one chunk's statistics on the paper path);
- B4: the same stack, greedy and top-50, without the [B, V] aggregate
  (the fused robust tail), greedy at K = 100, and greedy over
  [8, 32, 151936]; beside
  them ``stack_sum_*``, one ``torch.sum`` over the stack's worker axis,
  and ``stack_read_b4``, one ``torch.sum`` over all of it (a contiguous
  read), the time a library kernel takes to read the same bytes;
- B2: causal, q [4,192,16,128], k/v [4,192,8,128] bf16 (prefill);
- B3: q [4,1,16,128] over a [4,216,8,128] bf16 cache, python-int length
  216 (a decode step), and the same at batch 32 (the replicated path);
- ``--only configs``: B2 and B3 at the instances that the wider configs
  reach (a checkout before them refuses these shapes): B2 causal at
  phi-3-vision-4.2b's prefill (q/k/v [4,448,32,96]: 256 patches and 192
  tokens) and at dh 112 (q/k/v [4,192,32,112], zamba2-7b's head dim);
  B3 at batch 4 and 32 for phi-3-vision (q [B,1,32,96] over
  [B,472,32,96]), starcoder2-7b (G 9: q [B,1,36,128] over [B,216,4,128]),
  llama3-405b (G 16: q [B,1,128,128] over [B,216,8,128]) and dh 112
  (q [B,1,32,112] over [B,216,32,112]); and, to see what B3's time at
  G 16 grows with, G 16 over a one-chunk cache (T = 32) and G 8 (q
  [B,1,64,128] over [B,216,8,128]).

With B1 it also logs the card's SM clock under B1's load: B1 runs back
to back for ~3 s over a [8, 64 * 151936] f32 stack while ``nvidia-smi``
samples the clock every 50 ms (``b1_load_*``), so a time can be read
against the clock the card held, not its 1.98 GHz boost.

``*_ms`` is device time: the median of CUDA events around one call, with
a cold L2 and the device spinning ~2 ms before the start event, so the
host has enqueued the call before the device reaches it and the events
bracket device work only (one SDPA call on the same inputs is timed the
same way; ``chip_smoke.py`` times the same way). ``--flush read`` (the
default) empties L2 by reading a 128 MB buffer written once at set-up,
which leaves L2 holding clean lines only; ``--flush fill`` writes 64 MB
(the earlier timer), which leaves up to 50 MB of dirty lines that a
kernel's loads may have to write back first. ``*_host_us`` is the
wrapper's host time per call: the device spins ~50 ms, long enough that
no call waits on it, while the host makes 200 calls. ``--only b1b4``
``--only attn`` or ``--only configs`` times one group (the default:
b1b4 and attn).
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


def make_flush(torch, dev, how: str):
    """A callable that leaves L2 cold: ``read`` sums a 128 MB buffer
    written once here (L2 then holds clean lines only); ``fill`` writes
    64 MB (L2 then holds up to 50 MB of dirty lines)."""
    if how == "read":
        buf = torch.ones(32 * 2 ** 20, dtype=torch.float32, device=dev)
        return lambda: buf.sum()
    buf = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    return lambda: buf.fill_(1)


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


def loaded_clock(out, torch, dev, g, seconds: float = 3.0) -> None:
    """B1 back to back over a large stack while nvidia-smi samples the SM
    clock and the power draw; the first and last sixth of the samples
    (ramping) are dropped."""
    from repro_torch.kernels.vrmom import aggregate

    x = 4.0 * torch.randn((8, 64 * V), generator=g, device=dev)
    aggregate(x, "vrmom", K=8)
    torch.cuda.synchronize()
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "50"],
        stdout=subprocess.PIPE, text=True)
    try:
        time.sleep(0.5)
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        t0, n = time.perf_counter(), 0
        while time.perf_counter() - t0 < seconds:
            for _ in range(20):
                aggregate(x, "vrmom", K=8)
            n += 20
            torch.cuda.synchronize()
        e.record()
        torch.cuda.synchronize()
    finally:
        smi.terminate()
    rows = [[float(v) for v in line.split(",")]
            for line in smi.communicate()[0].splitlines()
            if line.strip() and "N/A" not in line]
    rows = rows[len(rows) // 6:len(rows) - len(rows) // 6]
    out["b1_load_us_per_call"] = s.elapsed_time(e) * 1e3 / n
    if not rows:  # nvidia-smi gave no reading
        return
    clk = sorted(r[0] for r in rows)
    out["b1_load_sm_mhz_median"] = statistics.median(clk)
    out["b1_load_sm_mhz_range"] = [clk[0], clk[-1]]
    out["b1_load_sm_mhz_max"] = rows[0][1]
    out["b1_load_power_w_median"] = statistics.median(r[2] for r in rows)


def time_b1b4(out, torch, dev, g, flush) -> None:
    from repro_torch.kernels.vrmom import aggregate, aggregate_sample

    for B in (4, 32):
        x = 4.0 * torch.randn((8, B, V), generator=g, device=dev)
        calls = {f"b4_b{B}_greedy": lambda x=x: aggregate_sample(
            x, "vrmom", K=8, with_agg=False)}
        if B == 4:
            xb = x.to(torch.bfloat16)
            calls["b1_b4"] = lambda: aggregate(x, "vrmom", K=8)
            calls["b1_b4_k10"] = lambda: aggregate(x, "vrmom", K=10)
            calls["b1_b4_bf16"] = lambda: aggregate(xb, "vrmom", K=8)
            calls["b4_b4_top50"] = lambda: aggregate_sample(
                x, "vrmom", K=8, top_k=50, with_agg=False)
        for name, fn in calls.items():
            out[f"{name}_ms"] = device_ms(fn, torch, flush)
            out[f"{name}_host_us"] = host_us(fn, torch)
        # a yardstick of the read alone: one PyTorch reduction of the stack
        out[f"stack_sum_b{B}_ms"] = device_ms(lambda x=x: x.sum(0), torch,
                                              flush)
        if B == 4:
            out["stack_read_b4_ms"] = device_ms(lambda: x.sum(), torch,
                                                flush)
    x = torch.randn((100, 65536), generator=g, device=dev)
    out["b1_m100_k10_ms"] = device_ms(lambda: aggregate(x, "vrmom", K=10),
                                      torch, flush)
    # the paper path: one chunk's statistics, [101, 250 * 465] at K = 10
    xp = torch.randn((101, 250 * 465), generator=g, device=dev)
    out["b1_paper_k10_ms"] = device_ms(lambda: aggregate(xp, "vrmom", K=10),
                                       torch, flush)
    # K = 100 (a checkout whose kernels stop at K = 64 raises: null)
    x = 4.0 * torch.randn((8, 4, V), generator=g, device=dev)
    for name, fn in (("b1_b4_k100", lambda: aggregate(x, "vrmom", K=100)),
                     ("b4_b4_greedy_k100", lambda: aggregate_sample(
                         x, "vrmom", K=100, with_agg=False))):
        try:
            out[f"{name}_ms"] = device_ms(fn, torch, flush)
        except ValueError:
            out[f"{name}_ms"] = None
    loaded_clock(out, torch, dev, g)


# (key, S = T, H, Hkv, dh) of B2, causal; (key, T, H, Hkv, dh) of B3, timed
# at batch 4 and 32
ATTN_SHAPES = {
    "attn": ([("b2", 192, 16, 8, 128)], [("b3", 216, 16, 8, 128)]),
    "configs": ([("b2_phi3v_dh96", 448, 32, 32, 96),
                 ("b2_dh112", 192, 32, 32, 112)],
                [("b3_phi3v_dh96", 472, 32, 32, 96),
                 ("b3_starcoder2_g9", 216, 36, 4, 128),
                 ("b3_llama3_g16", 216, 128, 8, 128),
                 ("b3_dh112", 216, 32, 32, 112),
                 # what B3's time at G 16 grows with: one 32-key chunk
                 # (a one-record merge), and G 8 on the 8-head instance
                 ("b3_g16_t32", 32, 128, 8, 128),
                 ("b3_g8_t216", 216, 64, 8, 128)]),
}


def time_attn(out, torch, dev, g, flush, group: str) -> None:
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention

    def rand(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    def sdpa(q, k, v, causal):
        qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
        return lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True)

    b2_shapes, b3_shapes = ATTN_SHAPES[group]
    for key, S, H, Hkv, dh in b2_shapes:
        q, k, v = rand(4, S, H, dh), rand(4, S, Hkv, dh), rand(4, S, Hkv, dh)

        def b2():
            return flash_attention(q, k, v, causal=True)

        out[f"{key}_ms"] = device_ms(b2, torch, flush)
        out[f"{key}_sdpa_ms"] = device_ms(sdpa(q, k, v, True), torch, flush)
        out[f"{key}_host_us"] = host_us(b2, torch)
    for key, T, H, Hkv, dh in b3_shapes:
        for B in (4, 32):
            q = rand(B, 1, H, dh)
            k, v = rand(B, T, Hkv, dh), rand(B, T, Hkv, dh)

            def b3():
                return decode_attention(q, k, v, kv_len=T)

            out[f"{key}_b{B}_ms"] = device_ms(b3, torch, flush)
            out[f"{key}_b{B}_sdpa_ms"] = device_ms(sdpa(q, k, v, False),
                                                   torch, flush)
            out[f"{key}_b{B}_host_us"] = host_us(b3, torch)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", required=True, help="a checkout's src directory")
    ap.add_argument("--tag", default="")
    ap.add_argument("--only", choices=("b1b4", "attn", "configs"),
                    default=None)
    ap.add_argument("--flush", choices=("read", "fill"), default="read")
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
    flush = make_flush(torch, dev, args.flush)
    out = {"tag": args.tag, "src": args.src, "flush": args.flush,
           "card": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], capture_output=True, text=True
           ).stdout.strip()}
    if args.only in (None, "b1b4"):
        time_b1b4(out, torch, dev, g, flush)
    if args.only in (None, "attn"):
        time_attn(out, torch, dev, g, flush, "attn")
    if args.only == "configs":
        time_attn(out, torch, dev, g, flush, "configs")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
