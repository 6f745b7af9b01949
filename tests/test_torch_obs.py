"""repro_torch's telemetry (``obs``) against ``repro.obs``.

The stdlib half (histograms, registry, catalog, sinks) is the port's own
copy: on the same inputs its snapshots, percentiles, JSONL records and
Prometheus text equal ``repro``'s, and each package reads the other's
records. The device half (``histogram_counts``, ``serve_diag``,
``replica_disagreement``) equals ``repro``'s bucket for bucket, exactly
(the rates are multiples of 1/m). The engine's drain: greedy tokens
bitwise equal with and without ``obs``; the disagreement histogram counts
(n_tokens - 1) * B rates a ``generate`` and n_steps * the active slots a
``decode_pool``, with mean exactly 0.25 under signflip with 1 of 4
replicas attacked. The scheduler records ``repro``'s counters and gauges.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.obs as JO
from repro.configs import get as j_get_arch
from repro.models import model as JM
from repro.obs import diag as JD
from repro.serve import Request as JRequest
from repro.serve import RobustDecodeConfig as JRobust
from repro.serve import Scheduler as JScheduler
from repro.serve import ServeEngine as JEngine
from repro.serve import robust as JR
from repro_torch import obs as TO
from repro_torch.configs import get as t_get_arch
from repro_torch.convert import params_from_jax
from repro_torch.obs import diag as TD
from repro_torch.serve import (Request, RobustDecodeConfig, Sampling,
                               Scheduler, ServeEngine)
from repro_torch.serve import robust as TR

torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def dense():
    jcfg = j_get_arch("qwen3-1.7b").reduced()
    tcfg = t_get_arch("qwen3-1.7b").reduced()
    jp = JM.init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    prompts = np.random.RandomState(1).randint(0, 512, size=(2, 8))
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp, prompts=prompts)


# -- the stdlib half against repro.obs ---------------------------------------

def test_histogram_record_and_percentiles_match_repro():
    vals = [0.5, 1.5, 1.5, 3.0, 7.0, 20.0, 2.0, 5.0]
    ht, hj = TO.Histogram((1.0, 2.0, 5.0, 10.0)), JO.Histogram(
        (1.0, 2.0, 5.0, 10.0))
    ht.record_many(vals)
    hj.record_many(vals)
    assert ht.snapshot() == hj.snapshot()
    for q in (1, 25, 50, 75, 95, 99):
        assert ht.percentile(q) == hj.percentile(q)
    assert ht.mean == hj.mean and ht.count == len(vals)
    assert 2.0 <= ht.percentile(50) <= 5.0
    for bad in ((1.0, 1.0, 2.0), (2.0, 1.0)):
        with pytest.raises(ValueError):
            TO.Histogram(bad)
    with pytest.raises(ValueError):
        ht.merge_counts([1, 2], 3.0, 2)


def test_histogram_snapshot_merge_roundtrip_across_packages():
    a, b = TO.Histogram((1.0, 10.0)), JO.Histogram((1.0, 10.0))
    a.record_many([0.5, 5.0])
    b.record_many([20.0, 5.0])
    c = TO.Histogram.from_snapshot(b.snapshot())
    c.merge(a)
    both = JO.Histogram((1.0, 10.0))
    both.record_many([20.0, 5.0, 0.5, 5.0])
    assert c.snapshot() == both.snapshot()
    with pytest.raises(ValueError):
        a.merge(TO.Histogram((1.0, 2.0)))


def test_registry_counter_gauge_timer():
    regs = TO.MetricsRegistry(), JO.MetricsRegistry()
    for reg in regs:
        reg.counter("serve.admitted")
        reg.counter("serve.admitted", 2)
        reg.gauge("serve.queue_depth", 5)
        reg.observe("serve.decode_step_s", 0.004)
        with reg.timer("serve.ttft_s"):
            pass
        with reg.timer("serve.compile_s", kind="gauge"):
            pass
    t, j = (r.snapshot() for r in regs)
    assert t["counters"] == j["counters"] == {"serve.admitted": 3.0}
    assert t["gauges"]["serve.queue_depth"] == 5.0
    assert t["gauges"]["serve.compile_s"] >= 0.0
    assert (t["histograms"]["serve.decode_step_s"]
            == j["histograms"]["serve.decode_step_s"])
    assert t["histograms"]["serve.ttft_s"]["count"] == 1
    assert regs[0].histograms["serve.ttft_s"].edges == \
        TO.catalog.LATENCY_EDGES_S
    assert regs[0].histogram("serve.replica_disagreement").edges == \
        TO.catalog.FRACTION_EDGES


def test_catalog_matches_repro():
    """Name for name, kind, unit and edges as ``repro``'s catalog."""
    tc, jc = TO.catalog, JO.catalog
    assert [(m.name, m.kind, m.unit, m.edges) for m in tc.METRICS] == \
        [(m.name, m.kind, m.unit, m.edges) for m in jc.METRICS]
    assert tc.LATENCY_EDGES_S == jc.LATENCY_EDGES_S
    assert tc.FRACTION_EDGES == jc.FRACTION_EDGES
    assert tc.ROUND_EDGES == jc.ROUND_EDGES
    names = {m.name for m in tc.METRICS}
    assert len(names) == len(tc.METRICS)
    for m in tc.METRICS:
        assert (m.edges is not None) == (m.kind == "histogram")
        assert tc.info(m.name) == m
        if m.edges:
            assert tc.default_edges(m.name) == m.edges
    assert tc.default_edges("not.a.metric") == tc.LATENCY_EDGES_S


def test_sinks_jsonl_prometheus_roundtrip(tmp_path):
    """The port's JSONL records read back through either package, merge
    the same, and render the same Prometheus text."""
    path = str(tmp_path / "metrics.jsonl")
    reg = TO.MetricsRegistry()
    reg.counter("serve.admitted", 2)
    reg.gauge("serve.kv_bytes_per_slot", 58720256)
    reg.observe("serve.ttft_s", 0.05)
    reg.histogram("serve.replica_disagreement").merge_counts(
        [0] * 4 + [6] + [0] * 13, 1.5, 6)
    with TO.JsonlSink(path) as sink:
        sink.write_registry(reg, source="test", arch="x")
        sink.write_registry(reg)
    recs = TO.read_jsonl(path)
    assert recs == JO.read_jsonl(path)
    assert len(recs) == 2 and recs[0]["kind"] == "metrics"
    assert recs[0]["meta"] == {"source": "test", "arch": "x"}
    summary = TO.merge_records(recs)
    assert summary == JO.merge_records(recs)
    assert summary["counters"]["serve.admitted"] == 4
    assert summary["histograms"]["serve.ttft_s"]["count"] == 2
    text = TO.prometheus_text(summary)
    assert text == JO.prometheus_text(summary)
    assert "# TYPE serve_admitted_total counter" in text
    assert "serve_admitted_total 4" in text
    assert "serve_kv_bytes_per_slot 58720256" in text
    assert 'serve_ttft_s_bucket{le="+Inf"} 2' in text
    assert "serve_replica_disagreement_count 12" in text


def test_obs_stdlib_half_imports_without_torch():
    """catalog/metrics/sinks work in an interpreter that cannot import
    torch (or JAX): the package and ``obs`` load nothing else."""
    script = """
import sys

class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("torch", "jax", "numpy"):
            raise ImportError(f"blocked: {name}")

sys.meta_path.insert(0, _Block())
import repro_torch.obs as obs
reg = obs.MetricsRegistry()
reg.counter("serve.admitted")
reg.observe("serve.ttft_s", 0.01)
text = obs.prometheus_text(reg.snapshot())
assert "serve_admitted_total 1" in text
assert "serve_ttft_s_count 1" in text
assert obs.now() > 0
assert not {"torch", "jax", "numpy"} & set(sys.modules)
try:
    obs.diag
except ImportError:
    print("NO-TORCH-OK")
"""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(_REPO, "src")
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, env=env, timeout=120)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    assert "NO-TORCH-OK" in r.stdout


# -- the device half against repro.obs.diag ----------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_histogram_counts_matches_repro(masked):
    """Bucket for bucket as ``repro``'s ``histogram_counts`` and the host
    ``Histogram`` (values on the edges included), from a sequence of edges
    or an edges tensor, with and without a mask."""
    edges = (0.0, 0.25, 0.5, 1.0)
    vals = np.asarray([-1.0, 0.0, 0.1, 0.25, 0.3, 0.5, 0.75, 1.0, 2.0,
                       0.25, 0.5], np.float32)
    mask = (np.arange(vals.size) % 3 != 1) if masked else None
    want = np.asarray(JD.histogram_counts(
        jnp.asarray(vals), edges, None if mask is None else jnp.asarray(mask)))
    tm = None if mask is None else torch.from_numpy(mask)
    for e in (edges, torch.tensor(edges)):
        got = TD.histogram_counts(torch.from_numpy(vals), e, mask=tm)
        assert got.dtype == torch.int32
        assert got.tolist() == want.tolist()
    host = TO.Histogram(edges)
    host.record_many(vals[mask] if masked else vals)
    assert got.tolist() == host.counts


def test_serve_diag_matches_repro():
    rs = np.random.RandomState(3)
    rates = (rs.randint(0, 9, size=(5, 6)) / 8.0).astype(np.float32)
    mask = rs.rand(6) > 0.4
    edges = TO.catalog.FRACTION_EDGES
    for m in (None, mask[None, :]):
        j = JD.serve_diag(jnp.asarray(rates), edges,
                          mask=None if m is None else jnp.asarray(m))
        t = TD.serve_diag(torch.from_numpy(rates), edges,
                          mask=None if m is None else torch.from_numpy(m))
        assert t.counts.tolist() == np.asarray(j.counts).tolist()
        assert float(t.total) == float(j.total)
    assert int(t.counts.sum()) == 5 * int(mask.sum())


def test_replica_disagreement_matches_repro():
    """The fraction of replicas whose argmax leaves the aggregate's, on
    the attacked stacks of every deterministic attack, exactly."""
    m, B, V = 8, 3, 16
    honest = np.random.RandomState(0).randn(B, V).astype(np.float32)
    stack = np.broadcast_to(honest[None], (m, B, V)).copy()
    stack[3, 0] = np.roll(honest[0], 5)
    got = TD.replica_disagreement(torch.from_numpy(stack),
                                  torch.from_numpy(honest))
    want = JD.replica_disagreement(jnp.asarray(stack), jnp.asarray(honest))
    assert got.tolist() == np.asarray(want).tolist()
    assert got.tolist() == [0.125, 0.0, 0.0]


@pytest.mark.parametrize("estimator", ["median", "vrmom"])
def test_robust_logits_with_diag_matches_alpha(estimator):
    """signflip at alpha 0.25, m = 8 over identical honest logits: the
    served logits are unchanged by ``with_diag``, equal repro's, and the
    disagreement is exactly 2/8 per token."""
    m, B, V = 8, 3, 16
    honest = np.random.RandomState(0).randn(B, V).astype(np.float32)
    stack = np.broadcast_to(honest[None], (m, B, V)).copy()
    rcfg = RobustDecodeConfig(m=m, estimator=estimator, attack="signflip",
                              alpha=0.25)
    g = torch.Generator().manual_seed(1)
    agg0 = TR.robust_logits(torch.from_numpy(stack), rcfg, g)
    agg1, dis = TR.robust_logits(torch.from_numpy(stack), rcfg, g,
                                 with_diag=True)
    assert torch.equal(agg0, agg1)
    jagg, jdis = JR.robust_logits(
        jnp.asarray(stack), JRobust(m=m, estimator=estimator,
                                    attack="signflip", alpha=0.25),
        jax.random.PRNGKey(1), with_diag=True)
    np.testing.assert_allclose(agg1.numpy(), np.asarray(jagg), rtol=1e-6,
                               atol=1e-6)
    assert dis.tolist() == np.asarray(jdis).tolist() == [0.25] * B


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("sampling", [Sampling(), Sampling("top_k", 1.2, 4),
                                      Sampling("temperature", 1.2)],
                         ids=["greedy", "top_k", "temperature"])
def test_robust_sample_with_diag_keeps_tokens(sampling, fuse):
    """``with_diag`` reads the attacked stack and draws nothing: the same
    seed gives the same tokens as without it, on the fused and unfused
    tails, and the rate is the attack's 0.25."""
    m, B, V = 8, 4, 64
    x = torch.from_numpy(np.random.RandomState(2).randn(B, V)
                         .astype(np.float32))
    stack = x[None].expand(m, B, V)
    rcfg = RobustDecodeConfig(m=m, attack="signflip", alpha=0.25,
                              fuse_tail=fuse)
    t0 = TR.robust_sample(stack, rcfg, torch.Generator().manual_seed(4),
                          sampling)
    t1, dis = TR.robust_sample(stack, rcfg, torch.Generator().manual_seed(4),
                               sampling, with_diag=True)
    assert torch.equal(t0, t1) and t1.dtype == torch.int32
    assert dis.tolist() == [0.25] * B


# -- the engine's drain and the scheduler's metrics --------------------------

SIGNFLIP = dict(m=4, estimator="median", attack="signflip", alpha=0.25)


@pytest.mark.parametrize("share", [True, False], ids=["shared",
                                                      "replicated"])
def test_engine_obs_tokens_bit_identical_and_drain(dense, share):
    """Telemetry on vs off: bitwise the same tokens (and repro's); the
    histogram takes one counts vector a dispatch, (6 - 1) * 2 rates, mean
    exactly 1/4, and accumulates over a second generate."""
    rcfg = RobustDecodeConfig(**SIGNFLIP, share_replica_compute=share)
    batch = {"tokens": dense["prompts"]}
    off = ServeEngine(dense["tcfg"], dense["tp"], max_len=32, robust=rcfg,
                      device="cpu")
    reg = TO.MetricsRegistry()
    on = ServeEngine(dense["tcfg"], dense["tp"], max_len=32, robust=rcfg,
                     obs=reg, device="cpu")
    t_off, t_on = off.generate(batch, 6), on.generate(batch, 6)
    assert torch.equal(t_off, t_on)
    jreg = JO.MetricsRegistry()
    jeng = JEngine(dense["jcfg"], dense["jp"], max_len=32,
                   robust=JRobust(**SIGNFLIP), obs=jreg)
    jt = jeng.generate({"tokens": jnp.asarray(dense["prompts"])}, 6)
    np.testing.assert_array_equal(t_on.numpy(), np.asarray(jt))
    h = reg.histograms["serve.replica_disagreement"]
    assert h.snapshot() == jreg.histograms[
        "serve.replica_disagreement"].snapshot()
    assert h.count == (6 - 1) * 2 and h.mean == 0.25
    on.generate(batch, 6)
    assert h.count == 2 * (6 - 1) * 2 and h.mean == 0.25
    on.generate(batch, 1)  # no decode step: nothing drained
    assert h.count == 2 * (6 - 1) * 2


@pytest.mark.parametrize("share", [True, False], ids=["shared",
                                                      "replicated"])
def test_decode_pool_diag_masks_inactive_slots(dense, share):
    """The pool's drain counts the active slots only: free slots decode
    stale rows, and their rates must not dilute the signal."""
    rcfg = RobustDecodeConfig(**SIGNFLIP, share_replica_compute=share)
    reg = TO.MetricsRegistry()
    eng = ServeEngine(dense["tcfg"], dense["tp"], max_len=32, n_slots=3,
                      robust=rcfg, obs=reg, device="cpu")
    pool = eng.make_pool()
    pool, first = eng.admit(pool, 0, {"tokens": dense["prompts"][:1]})
    pool, _ = eng.decode_pool(pool, np.asarray([first, 0, 0], np.int32), 4)
    h = reg.histograms["serve.replica_disagreement"]
    assert h.count == 4 * 1 and h.mean == 0.25
    pool, second = eng.admit(pool, 2, {"tokens": dense["prompts"][1:]})
    pool, _ = eng.decode_pool(pool, np.asarray([first, 0, second],
                                               np.int32), 3)
    assert h.count == 4 + 3 * 2 and h.mean == 0.25


def test_engine_without_robust_records_nothing(dense):
    reg = TO.MetricsRegistry()
    eng = ServeEngine(dense["tcfg"], dense["tp"], max_len=32, obs=reg,
                      device="cpu")
    eng.generate({"tokens": dense["prompts"]}, 6)
    assert "serve.replica_disagreement" not in reg.histograms
    assert eng.buffers.diag is None


def test_scheduler_records_serve_metrics(dense):
    """repro's counter and gauge contract, on the same requests in both
    packages: the first admission at the (6,) prompt shape and the first
    block are set-up time (``serve.compile_s``), not TTFT or step
    samples."""
    out = {}
    for side in ("port", "repro"):
        reg = (TO if side == "port" else JO).MetricsRegistry()
        if side == "port":
            eng = ServeEngine(dense["tcfg"], dense["tp"], max_len=48,
                              n_slots=2, obs=reg, device="cpu")
            sched, make = Scheduler(eng, decode_block=3), Request
        else:
            eng = JEngine(dense["jcfg"], dense["jp"], max_len=48, n_slots=2,
                          obs=reg)
            sched, make = JScheduler(eng, decode_block=3), JRequest
        rs = np.random.RandomState(0)
        uids = [sched.submit(make(tokens=rs.randint(0, 512, size=(6,)),
                                  max_new_tokens=4)) for _ in range(3)]
        big = sched.submit(make(tokens=rs.randint(0, 512, size=(40,)),
                                max_new_tokens=16))
        done = sched.run()
        assert sorted(done) == sorted(uids + [big])
        assert done[big].finished_by == "rejected"
        out[side] = (reg, [done[u].tokens for u in uids])
    (reg, toks), (jreg, jtoks) = out["port"], out["repro"]
    assert toks == [list(map(int, t)) for t in jtoks]
    c = reg.counters
    assert c == jreg.counters
    assert c["serve.admitted"] == 3 and c["serve.retired"] == 3
    assert c["serve.rejected"] == 1
    assert c["serve.tokens_out"] == sum(len(t) for t in toks)
    assert sorted(reg.gauges) == sorted(jreg.gauges)
    assert reg.histograms["serve.ttft_s"].count == 2
    assert reg.gauges["serve.compile_s"] > 0.0
    assert (reg.histograms["serve.decode_step_s"].count
            == jreg.histograms["serve.decode_step_s"].count >= 1)
    assert reg.gauges["serve.queue_depth"] == 0.0
    assert reg.gauges["serve.kv_bytes_per_slot"] > 0


def test_serve_spans_in_a_profiler_trace(dense):
    """``serve.admit``, ``serve.decode_pool`` and ``serve.decode_scan``
    are named ranges in a ``torch.profiler`` trace."""
    from torch.profiler import ProfilerActivity, profile

    eng = ServeEngine(dense["tcfg"], dense["tp"], max_len=32, n_slots=2,
                      device="cpu")
    pool = eng.make_pool()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pool, first = eng.admit(pool, 1, {"tokens": dense["prompts"][:1]})
        eng.decode_pool(pool, [0, first], 2)
        eng.generate({"tokens": dense["prompts"]}, 3)
    names = {ev.name for ev in prof.events()}
    assert {"serve.admit", "serve.decode_pool", "serve.decode_scan"} <= names
    json.dumps(sorted(names))  # plain strings
