"""Canonical metric catalog for the telemetry layer (``repro.obs.catalog``'s
port, name for name).

Pure data, stdlib-only: it imports without torch, so tooling can read the
metric vocabulary where only the standard library is installed.

Every metric is registered here with its kind, unit and (for
histograms) fixed bucket edges, as in ``repro``: the serve engine and the
scheduler record under these names, so one JSONL artifact (and one
Prometheus exposition) carries the whole pipeline's telemetry, and a
record of either package reads the same. A ``MetricsRegistry`` accepts
unknown names (the catalog documents, it is not a runtime gate), but
every name the port itself records is listed here.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

__all__ = [
    "MetricInfo",
    "METRICS",
    "LATENCY_EDGES_S",
    "FRACTION_EDGES",
    "ROUND_EDGES",
    "default_edges",
    "info",
]


def _log_edges(decades, mantissas) -> Tuple[float, ...]:
    out = []
    for d in decades:
        for m in mantissas:
            out.append(round(m * 10.0 ** d, 12))
    return tuple(out)


# Log-spaced latency edges, 10 per decade from 10us to 100s: adjacent
# edges are <= 1.34x apart, so a within-bucket linear interpolation
# bounds the percentile error at a few tens of percent of the value —
# tight enough for the p50/p95/p99 fields in BENCH_serve.json while the
# [len(edges)+1] counts vector stays a fixed-shape device tensor (no
# host read inside a captured decode step).
LATENCY_EDGES_S = _log_edges(
    range(-5, 2), (1.0, 1.2, 1.5, 2.0, 2.5, 3.0, 4.0, 5.0, 6.0, 8.0)
) + (100.0,)

# Replica-disagreement rates are multiples of 1/m; 1/16 steps resolve
# every realizable value up to m=16 replicas exactly.
FRACTION_EDGES = tuple(round(i / 16.0, 6) for i in range(17))

# Consensus round counts are small integers bounded by the static
# p_end (tens of rounds at eps=1e-4): exact buckets through 8, then
# ~1.4x-spaced up to the doubled-dropout regime.
ROUND_EDGES = (1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 8.0, 12.0, 16.0, 24.0,
               32.0, 48.0, 64.0)


class MetricInfo(NamedTuple):
    name: str
    kind: str  # 'counter' | 'gauge' | 'histogram'
    unit: str
    description: str
    edges: Optional[Tuple[float, ...]] = None  # histograms only


METRICS = (
    # -- serve path (engine + scheduler boundary) ---------------------------
    MetricInfo("serve.queue_depth", "gauge", "requests",
               "Requests waiting in the scheduler FIFO after admission."),
    MetricInfo("serve.slots_active", "gauge", "slots",
               "Pool slots holding a live, partially-decoded sequence."),
    MetricInfo("serve.admitted", "counter", "requests",
               "Requests prefilled into a pool slot."),
    MetricInfo("serve.rejected", "counter", "requests",
               "Requests refused at admission (prompt + budget exceeds "
               "slot capacity)."),
    MetricInfo("serve.retired", "counter", "requests",
               "Sequences completed (EOS or token budget) and evicted."),
    MetricInfo("serve.tokens_out", "counter", "tokens",
               "Decoded tokens handed back to the host (per decode "
               "block, all active slots)."),
    MetricInfo("serve.ttft_s", "histogram", "s",
               "Time to first token: prefill + first sample, per "
               "request/batch call.", LATENCY_EDGES_S),
    MetricInfo("serve.decode_step_s", "histogram", "s",
               "Per-token decode latency (scanned block wall time / "
               "tokens in block).", LATENCY_EDGES_S),
    MetricInfo("serve.compile_s", "gauge", "s",
               "Set-up time of the first serve call of a shape or sampling "
               "config (eager warm-up and CUDA graph capture on the card)."),
    MetricInfo("serve.replica_disagreement", "histogram", "fraction",
               "Per-token fraction of decode replicas whose argmax "
               "differs from the robustly aggregated token.",
               FRACTION_EDGES),
    MetricInfo("serve.kv_bytes_per_slot", "gauge", "bytes",
               "KV-cache HBM bytes one pool slot costs (quantization "
               "scales and robust replica stacking included)."),
    # -- robust aggregation diagnostics (train path) ------------------------
    MetricInfo("agg.alpha_hat", "gauge", "fraction",
               "Online effective-alpha estimate: fraction of workers "
               "whose deviation score is flagged Byzantine."),
    MetricInfo("agg.suspected_workers", "gauge", "workers",
               "Workers flagged by the suspicion mask this step."),
    MetricInfo("agg.grad_norm_pre", "gauge", "l2",
               "Mean per-worker gradient L2 norm before aggregation."),
    MetricInfo("agg.grad_norm_post", "gauge", "l2",
               "L2 norm of the robustly aggregated gradient."),
    MetricInfo("agg.worker_weight_min", "gauge", "weight",
               "Smallest online per-worker census weight in the adaptive "
               "aggregation state; 1.0 means no worker "
               "is downweighted."),
    # -- decentralized consensus backend ------------------------------------
    MetricInfo("consensus.rounds", "histogram", "rounds",
               "Rounds until the honest-alive spread first reached eps "
               "(the static bound p_end when it never did).",
               ROUND_EDGES),
    MetricInfo("dist.messages_dropped", "counter", "messages",
               "Peer messages between live workers lost to injected "
               "dropout across all consensus rounds."),
    MetricInfo("dist.quorum", "gauge", "fraction",
               "Fraction of (round, live receiver) slots that met the "
               "n-f quorum; 0 means every round stalled (quorum lost)."),
    # -- training loop ------------------------------------------------------
    MetricInfo("train.step_s", "histogram", "s",
               "Wall time per training step (post-compile).",
               LATENCY_EDGES_S),
    MetricInfo("train.loss", "gauge", "nats",
               "Training loss at the last recorded step."),
    # -- launch / compile-time cost (dryrun HLO analysis) -------------------
    MetricInfo("launch.compile_flops", "gauge", "flops",
               "Trip-count-aware HLO FLOPs per chip from the dry-run "
               "cost analysis."),
    MetricInfo("launch.compile_hbm_bytes", "gauge", "bytes",
               "HBM bytes accessed per chip (dry-run HLO analysis)."),
    MetricInfo("launch.compile_collective_bytes", "gauge", "bytes",
               "Collective bytes moved per chip (dry-run HLO analysis)."),
    MetricInfo("launch.compile_peak_memory_bytes", "gauge", "bytes",
               "Compiled peak memory per chip (args + temps + outputs "
               "- aliased)."),
)

_BY_NAME = {m.name: m for m in METRICS}


def info(name: str) -> Optional[MetricInfo]:
    return _BY_NAME.get(name)


def default_edges(name: str) -> Tuple[float, ...]:
    """Bucket edges for a histogram metric: its registered edges, or the
    latency grid for names outside the catalog."""
    m = _BY_NAME.get(name)
    if m is not None and m.edges is not None:
        return m.edges
    return LATENCY_EDGES_S
