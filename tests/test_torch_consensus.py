"""repro_torch's consensus backend and fault injection against ``repro``'s.

The same numpy stacks go through ``repro.dist.consensus`` and
``repro_torch.dist.consensus`` on the CPU. Where a plan drops messages the
port is handed ``repro``'s own draws (``jax.random.uniform(fold_in(key,
p), (n, n))`` stacked over the rounds), so both packages see the same
reception matrices. Tolerances: the midpoint trim, the reception matrices
and the integer aux fields exactly; the trimmed mean, ``quorum`` and
``spread`` at 1e-6 relative (XLA sums the kept window in its own order,
the port in sorted order); fault-free aggregates bit for bit against the
port's direct aggregate and at 1e-5 against ``repro``'s (XLA rewrites the
mean, ROADMAP.md §C). The CPU cases of ``tests/test_consensus.py`` run on
both packages; its mesh cases (the ``shard_map`` wire, the consensus
train step on 8 devices) are replaced by the blocked wire against
``repro``'s raveled one and the port's train step against ``repro``'s
consensus aggregate of the step's own stack.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as j_get_arch
from repro.core import attacks as JA
from repro.core import rcsl as JR
from repro.core.estimator import Estimator as JE
from repro.dist import robust_reduce as JRR
from repro.dist.consensus import ConsensusConfig as JC
from repro.dist.consensus import consensus_aggregate as j_aggregate
from repro.dist.consensus import consensus_iterate as j_iterate
from repro.dist.faults import FaultPlan as JF
from repro.models import model as JM
from repro_torch.configs import get as t_get_arch
from repro_torch.convert import params_from_jax
from repro_torch.core import attacks as TA
from repro_torch.core import rcsl as TR
from repro_torch.core.estimator import Estimator as TE
from repro_torch.data import lm_batch
from repro_torch.dist import consensus as TCS
from repro_torch.dist import faults as TFM
from repro_torch.dist import robust_reduce as RR
from repro_torch.dist.consensus import ConsensusConfig as TC
from repro_torch.dist.consensus import consensus_aggregate as t_aggregate
from repro_torch.dist.consensus import consensus_iterate as t_iterate
from repro_torch.dist.faults import FaultPlan as TF
from repro_torch.infer import coverage_run
from repro_torch.train.step import make_train_step
from repro_torch.tree import leaves as _leaves

torch.set_num_threads(1)

AUX = ("rounds_run", "rounds_to_eps", "spread", "quorum", "quorum_lost",
       "messages_dropped")
EXACT_AUX = ("rounds_run", "rounds_to_eps", "quorum_lost", "messages_dropped")
# the plans of the parity grid (repro's CPU cases and their composition)
PLANS = {"dropout": dict(dropout=0.1),
         "crash@1": dict(n_crashed=1, crash_round=1),
         "3 crashed@0": dict(n_crashed=3, crash_round=0),
         "stragglers": dict(n_stragglers=2, stale_rounds=2),
         "dropout+crash": dict(dropout=0.1, n_crashed=1, crash_round=2)}


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _stack(n=8, C=37, key=0):
    """repro's ``_stack``: a normal [n, C] stack from a JAX key, as numpy."""
    return np.asarray(jax.random.normal(jax.random.PRNGKey(key), (n, C)))


def _draws(key, n, p_end, reps=None):
    """repro's draws of a run: ``uniform(fold_in(key, p), (n, n))`` stacked
    over the rounds (and over ``reps`` replications' keys)."""
    if reps is not None:
        keys = jax.random.split(key, reps)
        return np.stack([_draws(k, n, p_end) for k in keys])
    return np.stack([np.asarray(jax.random.uniform(jax.random.fold_in(key, p),
                                                   (n, n)))
                     for p in range(p_end)])


def _plans(kw, n=8, cfg=None):
    """(repro plan, port plan, p_end) of one plan's fields."""
    jp, tp = JF(**kw).validate(n), TF(**kw).validate(n)
    return jp, tp, (cfg or TC()).phases(tp)


def _np(x):
    if isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16:
        return x.float().numpy()  # exact
    return np.asarray(x)


def _close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(_np(got).astype(np.float64),
                               _np(want).astype(np.float64),
                               rtol=rtol, atol=atol)


def _same(got, want):
    np.testing.assert_array_equal(_np(got), _np(want))


def _aux_match(jaux, taux, rel=1e-6):
    for name in AUX:
        j, t = np.asarray(getattr(jaux, name)), getattr(taux, name).numpy()
        assert t.shape == j.shape, name
        if name in EXACT_AUX:
            _same(t, j)
        else:
            _close(t, j, rel, 1e-30)


# ---------------------------------------------------------------- the specs

@pytest.mark.parametrize("kw", [
    {}, dict(dropout=0.2), dict(n_crashed=2, crash_round=3),
    dict(n_crashed=1, n_stragglers=3, stale_rounds=2),
    dict(n_stragglers=8, stale_rounds=1)])
def test_fault_plan_masks_and_trivial(kw):
    jp, tp = JF(**kw), TF(**kw)
    assert tp == tuple(jp) and tp.trivial == jp.trivial
    assert hash(tp) == hash(TF(**kw))
    n = 8
    _same(tp.crashed_mask(n), jp.crashed_mask(n))
    _same(tp.straggler_mask(n), jp.straggler_mask(n))
    for p in range(6):
        _same(tp.crashed_at(n, p), jp.crashed_at(n, p))


@pytest.mark.parametrize("kw,n", [
    (dict(dropout=1.0), 8), (dict(dropout=-0.1), 8),
    (dict(n_crashed=-1), 8), (dict(n_crashed=5, n_stragglers=4), 8),
    (dict(n_stragglers=2, stale_rounds=0), 8),
    (dict(n_crashed=2, n_stragglers=2), 3)])
def test_fault_plan_validate_messages(kw, n):
    with pytest.raises(ValueError) as jerr:
        JF(**kw).validate(n)
    with pytest.raises(ValueError) as terr:
        TF(**kw).validate(n)
    assert str(terr.value) == str(jerr.value)


def test_fault_plan_rejects_unhashable_fields():
    with pytest.raises(TypeError, match=r"FaultPlan\.dropout"):
        JF(dropout=[0.1])
    with pytest.raises(TypeError, match=r"FaultPlan\.dropout"):
        TF(dropout=[0.1])
    with pytest.raises(TypeError, match=r"FaultPlan\.n_crashed"):
        TF(0.0, {1: 2})


@pytest.mark.parametrize("name", list(PLANS) + ["trivial"])
@pytest.mark.parametrize("reps", [None, 3])
def test_recv_matrices_equal_repro(name, reps):
    """Every round's reception matrix, from repro's draws, is repro's
    ``recv_matrix`` of that round exactly, per replication."""
    n = 8
    jp, tp, p_end = _plans(PLANS.get(name, {}), n)
    key = jax.random.PRNGKey(5)
    keys = [key] if reps is None else list(jax.random.split(key, reps))
    want = np.stack([np.stack([np.asarray(jp.recv_matrix(k, n, p))
                               for p in range(p_end)]) for k in keys])
    d = _draws(key, n, p_end, reps) if tp.dropout else None
    batch = () if reps is None else (reps,)
    got = tp.recv_matrices(n, p_end, batch=batch, draws=d).numpy()
    if reps is None:
        want = want[0]
    _same(np.broadcast_to(got, want.shape), want)
    if tp.dropout:
        with pytest.raises(ValueError, match="draws of shape"):
            tp.recv_matrices(n, p_end + 1, batch=batch, draws=d)


def test_own_draws_follow_the_generator():
    """Without ``draws`` the uniforms come from the generator, one set of
    every round at once, and a generator seeded alike gives them again."""
    tp = TF(dropout=0.3)
    a = tp.recv_matrices(8, 5, batch=(2,),
                         generator=torch.Generator().manual_seed(3))
    b = tp.recv_matrices(8, 5, batch=(2,),
                         generator=torch.Generator().manual_seed(3))
    assert a.shape == (2, 5, 8, 8) and torch.equal(a, b)
    assert torch.all(a.diagonal(dim1=-2, dim2=-1))
    assert 0.5 < float(a.float().mean()) < 0.9
    assert torch.equal(tp.recv_matrices(8, 5),
                       tp.recv_matrices(8, 5, generator=torch.Generator()
                                        .manual_seed(0)))


@pytest.mark.parametrize("cfg", [
    dict(), dict(f=0), dict(f=2), dict(eps=1e-2), dict(init_range=1.0,
                                                        eps=0.5),
    dict(max_rounds=3), dict(trim="midpoint", max_rounds=50)])
@pytest.mark.parametrize("plan", [
    {}, dict(dropout=0.1), dict(n_stragglers=2, stale_rounds=3),
    dict(dropout=0.2, n_stragglers=1, stale_rounds=1)])
def test_consensus_config_phases(cfg, plan):
    jc, tc = JC(**cfg), TC(**cfg)
    assert tuple(tc) == tuple(jc)
    assert tc.phases(TF(**plan)) == jc.phases(JF(**plan))
    assert tc.phases() == jc.phases()


@pytest.mark.parametrize("cfg,n", [
    (dict(f=2), 8), (dict(f=1), 5), (dict(f=-1), 8), (dict(trim="median"), 8),
    (dict(eps=0.0), 8), (dict(eps=100.0), 8)])
def test_consensus_config_validate_messages(cfg, n):
    with pytest.raises(ValueError) as jerr:
        JC(**cfg).validate(n)
    with pytest.raises(ValueError) as terr:
        TC(**cfg).validate(n)
    assert str(terr.value) == str(jerr.value)


def test_refuses_n_le_5f():
    """tests/test_consensus.py:55, in the port."""
    v = _t(_stack(n=8))
    with pytest.raises(ValueError, match="n > 5f"):
        t_aggregate(v, "vrmom", config=TC(f=2))
    with pytest.raises(ValueError, match="n > 5f"):
        TC(f=1).validate(5)
    TC(f=1).validate(6)
    with pytest.raises(TypeError, match="ConsensusConfig"):
        t_aggregate(v, "vrmom", config=JC(f=1)._asdict())
    with pytest.raises(ValueError, match="whole-vector"):
        t_aggregate(v, "krum", config=TC(f=1))


# ----------------------------------------------------- the emulation vs repro

def _run_both(x, kw, cfg, pin=None, key=9, est="vrmom"):
    """repro's and the port's iterate and aggregate of one stack."""
    n = x.shape[0]
    jp, tp, p_end = _plans(kw, n, TC(**cfg))
    jkey = jax.random.PRNGKey(key)
    d = _draws(jkey, n, p_end) if tp.dropout else None
    jpin = None if pin is None else jnp.asarray(pin)
    tpin = None if pin is None else _t(pin)
    jest = est if isinstance(est, str) else JE(*est)
    test = est if isinstance(est, str) else TE(*est)
    jf, ja = j_iterate(jnp.asarray(x), jest, config=JC(**cfg), plan=jp,
                       key=jkey, pin_mask=jpin)
    jo, _ = j_aggregate(jnp.asarray(x), jest, config=JC(**cfg), plan=jp,
                        key=jkey, pin_mask=jpin)
    tf, ta = t_iterate(_t(x), test, config=TC(**cfg), plan=tp, draws=d,
                       pin_mask=tpin)
    to, ta2 = t_aggregate(_t(x), test, config=TC(**cfg), plan=tp, draws=d,
                          pin_mask=tpin)
    for name in AUX:
        _same(getattr(ta2, name), getattr(ta, name))
    return (jf, ja, jo), (tf, ta, to)


@pytest.mark.parametrize("pinned", [False, True])
@pytest.mark.parametrize("name", list(PLANS))
@pytest.mark.parametrize("trim", ["mean", "midpoint"])
def test_iterate_and_aggregate_match_repro(trim, name, pinned):
    """Finals, the decision and all six aux fields, for both trims, across
    the fault plans, with and without a pinned omniscient row."""
    v = _stack()
    mask = np.arange(8) >= 7
    x = v
    if pinned:
        x = np.asarray(JA.omniscient(jax.random.PRNGKey(3), jnp.asarray(v),
                                     jnp.asarray(mask)))
    (jf, ja, jo), (tf, ta, to) = _run_both(
        x, PLANS[name], dict(f=1, trim=trim), mask if pinned else None)
    assert tf.dtype == to.dtype == torch.float32
    assert tf.shape == (8, 37) and to.shape == (37,)
    assert np.isfinite(tf.numpy()).all() and np.isfinite(to.numpy()).all()
    if trim == "midpoint":
        _same(tf, jf)
        _same(to, jo)
    else:
        scale = float(np.abs(np.asarray(jf)).max())
        _close(tf, jf, 1e-6, 1e-6 * scale)
        _close(to, jo, 1e-6, 1e-6 * scale)
    _aux_match(ja, ta)


@pytest.mark.parametrize("est", ["vrmom", "median", "mean",
                                 ("trimmed_mean", 10, 0.25)])
def test_fault_free_equals_direct_aggregate(est):
    """tests/test_consensus.py:43: no faults, trim='mean', no pin: the
    consensus value is the port's direct aggregate bit for bit, and
    repro's (XLA rewrites the mean: ROADMAP.md §C) within 1e-5."""
    v = _stack()
    test = est if isinstance(est, str) else TE(*est)
    jest = est if isinstance(est, str) else JE(*est)
    got, aux = t_aggregate(_t(v), test, config=TC(f=1).validate(8))
    direct = RR.aggregate_stacked_auto({"g": _t(v)}, test)["g"]
    _same(got, direct)
    want, jaux = j_aggregate(jnp.asarray(v), jest, config=JC(f=1))
    _close(got, want, 1e-5, 1e-5)
    assert not bool(aux.quorum_lost)
    assert float(aux.spread) <= 1e-4
    _aux_match(jaux, aux)


def test_fault_free_rounds_do_not_reaggregate_identical_rows():
    """Fault-free with the mean trim and no pin every row is the round-1
    aggregate from round 1 on; the port does not aggregate the identical
    rows again, since torch's sequential sum rounds the mean of n equal
    values where the trimmed aggregate of equal values is that value. The rounds' aux stays what running them gives:
    every entering spread after round 0 is 0."""
    v = _t(_stack())
    row = torch.mean(v, dim=0)
    rows = row.expand(8, -1).contiguous()
    assert not torch.equal(torch.mean(rows, dim=0), row)
    got, aux = t_aggregate(v, "mean", config=TC(f=1))
    _same(got, row)
    finals, _ = t_iterate(v, "mean", config=TC(f=1))
    _same(finals, rows)
    assert int(aux.rounds_to_eps) == 1 and int(aux.rounds_run) == 20


def test_straggler_fault_pinned_in_both_packages():
    """ROADMAP.md §C: repro's stragglers are stale by one round less than
    ``stale_rounds`` says (``sent = hist[k - 1]`` with ``hist[0]`` the
    current value), so a one-round straggler sends its current value and
    its run's finals equal a run without stragglers, in both packages,
    while two rounds of staleness differ."""
    v = _stack()
    base = dict(n_crashed=1, crash_round=1)
    cfg = dict(f=1, max_rounds=6)
    (jf0, _, _), (tf0, _, _) = _run_both(v, base, cfg)
    (jf1, _, _), (tf1, _, _) = _run_both(
        v, dict(base, n_stragglers=2, stale_rounds=1), cfg)
    (jf2, _, _), (tf2, _, _) = _run_both(
        v, dict(base, n_stragglers=2, stale_rounds=2), cfg)
    _same(jf1, jf0)
    _same(tf1, tf0)
    assert not np.array_equal(np.asarray(jf2), np.asarray(jf0))
    assert not torch.equal(tf2, tf0)
    # the stale plan is not trivial, and its straggler round is counted
    assert TC(**cfg).phases(TF(n_stragglers=2)) == 6
    assert TC(f=1).phases(TF(n_stragglers=2)) == 21


# --------------------------------------- tests/test_consensus.py's CPU cases

def test_convergence_under_dropout_and_byzantine_pin():
    """tests/test_consensus.py:65 in both packages: 10% message loss and a
    persistent Byzantine sender; honest values contract to eps."""
    n = 8
    v = _stack(n=n)
    mask = np.arange(n) >= n - 1
    x = np.asarray(JA.omniscient(jax.random.PRNGKey(3), jnp.asarray(v),
                                 jnp.asarray(mask)))
    cfg = dict(f=1, trim="midpoint")
    (jf, ja, _), (tf, ta, _) = _run_both(x, dict(dropout=0.1), cfg, mask)
    _same(tf, jf)
    _aux_match(ja, ta)
    assert np.isfinite(tf.numpy()).all()
    assert float(ta.spread) <= 1e-4
    assert int(ta.rounds_to_eps) <= int(ta.rounds_run)
    assert int(ta.messages_dropped) > 0
    assert 0.0 < float(ta.quorum) <= 1.0
    assert not bool(ta.quorum_lost)
    honest = tf.numpy()[: n - 1]
    assert np.abs(honest - honest[0]).max() <= 1e-4
    assert np.abs(honest[0] - v[: n - 1].mean(0)).max() < 3.0


@pytest.mark.parametrize("kw,key,lost", [
    (dict(n_crashed=1, crash_round=1), 1, False),       # :90
    (dict(n_crashed=3, crash_round=0), 2, True),        # :101
    (dict(n_stragglers=2, stale_rounds=2), 4, False)])  # :115
def test_crash_quorum_and_straggler_cases(kw, key, lost):
    """tests/test_consensus.py:90, :101 and :115 in both packages: a crash
    within quorum and stragglers converge; crashes beyond n - f flag
    quorum loss and stay finite (never NaN)."""
    v = _stack()
    (_, ja, jo), (_, ta, to) = _run_both(v, kw, dict(f=1), key=key)
    _close(to, jo, 1e-6, 1e-6)
    _aux_match(ja, ta)
    assert np.isfinite(to.numpy()).all()
    assert bool(ta.quorum_lost) == lost
    if lost:
        assert float(ta.quorum) < 0.5 and np.isfinite(float(ta.spread))
    else:
        assert float(ta.spread) <= 1e-4


def _omniscient_case(attack):
    n = 16
    v = _stack(n=n, key=5)
    mask = np.arange(n) >= n - 3
    if attack == "ipm":
        x = JA.ipm(jax.random.PRNGKey(8), jnp.asarray(v), jnp.asarray(mask),
                   eps=100.0)
    else:
        x = JA.mimic(jax.random.PRNGKey(8), jnp.asarray(v), jnp.asarray(mask))
    return v, np.asarray(x), mask


@pytest.mark.parametrize("attack", ["ipm", "mimic"])
def test_omniscient_pin_composition_stays_bounded(attack):
    """tests/test_consensus.py:125 in both packages: pinned omniscient
    payloads (3 of 16) compose with the trim; the value stays inside the
    honest cloud and quorum holds."""
    v, x, mask = _omniscient_case(attack)
    (_, ja, jo), (_, ta, to) = _run_both(x, {}, dict(f=3), mask, key=12)
    _close(to, jo, 1e-5, 1e-5)
    _aux_match(ja, ta)
    assert np.isfinite(to.numpy()).all() and not bool(ta.quorum_lost)
    assert float(ta.spread) <= 1e-4
    assert np.abs(to.numpy() - v[:13].mean(0)).max() < 3.0


def test_omniscient_pin_mean_control_diverges():
    """tests/test_consensus.py:149: the same pinned ipm payload through an
    untrimmed mean consensus (f=0) drags the value far from the honest
    cloud, in both packages."""
    v, x, mask = _omniscient_case("ipm")
    ref = v[:13].mean(0)
    (_, _, jr), (_, _, tr) = _run_both(x, {}, dict(f=3), mask, key=12)
    (_, _, jc), (_, _, tc) = _run_both(x, {}, dict(f=0), mask, key=12,
                                       est="mean")
    _close(tc, jc, 1e-5, 1e-5)
    err_r = np.linalg.norm(tr.numpy() - ref)
    err_c = np.linalg.norm(tc.numpy() - ref)
    assert err_c > 5.0 * err_r + 1.0, (err_c, err_r)


def test_aux_fields_are_scalars_or_batched():
    """tests/test_consensus.py:170; with leading dims each field is
    ``[...]``, with and without dropout."""
    v = _t(_stack())
    _, aux = t_aggregate(v, "vrmom", config=TC(f=1).validate(8))
    for name in AUX:
        assert getattr(aux, name).shape == (), name
    for plan in (None, TF(dropout=0.1)):
        _, aux = t_aggregate(v.expand(2, 3, 8, 37), "vrmom", config=TC(f=1),
                             plan=plan)
        for name in AUX:
            assert getattr(aux, name).shape == (2, 3), name
    assert aux.rounds_run.dtype == aux.messages_dropped.dtype == torch.int32
    assert aux.quorum_lost.dtype == torch.bool


@pytest.mark.parametrize("chunk", [7, 1 << 22])
def test_auto_consensus_backend_roundtrip(chunk, monkeypatch):
    """tests/test_consensus.py:178: the consensus backend returns leaves of
    their shape and dtype, matching the direct backend fault-free (bit for
    bit in the port), on the blocked wire at any block size."""
    monkeypatch.setattr(RR, "WIRE_CHUNK", chunk)
    g = {"w": np.asarray(jax.random.normal(jax.random.PRNGKey(0), (8, 4, 6))),
         "b": np.asarray(jax.random.normal(jax.random.PRNGKey(1), (8, 5)))}
    tg = {"w": _t(g["w"]), "b": _t(g["b"]).to(torch.bfloat16)}
    out, aux = RR.aggregate_stacked_auto(tg, "vrmom",
                                         reduce_backend="consensus",
                                         consensus=TC(f=1).validate(8))
    direct = RR.aggregate_stacked_auto(tg, "vrmom")
    for k in tg:
        assert out[k].shape == tg[k].shape[1:] and out[k].dtype == tg[k].dtype
        assert torch.equal(out[k], direct[k])
    assert not bool(aux.quorum_lost)
    jout, _ = JRR.aggregate_stacked_auto(
        {"w": jnp.asarray(g["w"]),
         "b": jnp.asarray(g["b"]).astype(jnp.bfloat16)}, "vrmom",
        reduce_backend="consensus", consensus=JC(f=1))
    _close(out["w"], jout["w"], 1e-6, 1e-6)


# ------------------------------------------------------------ batched, wire

@pytest.mark.parametrize("trim", ["mean", "midpoint"])
def test_batched_runs_equal_a_loop(trim):
    """A ``[R, n, C]`` stack with per-replication draws is R runs of one:
    finals, decision and every aux field."""
    R, n = 3, 8
    x = np.stack([_stack(n, 11, key=k) for k in range(R)])
    plan = TF(dropout=0.2, n_crashed=1, crash_round=3)
    cfg = TC(f=1, trim=trim)
    d = _draws(jax.random.PRNGKey(4), n, cfg.phases(plan), R)
    pin = np.arange(n) >= 7
    fb, ab = t_iterate(_t(x), "vrmom", config=cfg, plan=plan, draws=d,
                       pin_mask=_t(pin))
    ob, _ = t_aggregate(_t(x), "vrmom", config=cfg, plan=plan, draws=d,
                        pin_mask=_t(pin))
    for r in range(R):
        f1, a1 = t_iterate(_t(x[r]), "vrmom", config=cfg, plan=plan,
                           draws=d[r], pin_mask=_t(pin))
        o1, _ = t_aggregate(_t(x[r]), "vrmom", config=cfg, plan=plan,
                            draws=d[r], pin_mask=_t(pin))
        _same(fb[r], f1)
        _same(ob[r], o1)
        for name in AUX:
            _same(getattr(ab, name)[r], getattr(a1, name))


@pytest.mark.parametrize("trim", ["mean", "midpoint"])
def test_blocked_wire_matches_repro(trim, monkeypatch):
    """The port's consensus wire in column blocks of 5 (a bf16 leaf,
    dropout, stragglers and a pinned omniscient row) against repro's
    raveled f32 wire, on repro's draws; ``aggregate(mode=
    "stacked-consensus")`` is the same path."""
    monkeypatch.setattr(RR, "WIRE_CHUNK", 5)
    n = 8
    g = {"a": _stack(n, 12, key=1).reshape(n, 3, 4),
         "b": {"c": _stack(n, 7, key=2)}}
    mask = np.arange(n) >= 7
    jg = jax.tree.map(lambda x: JA.omniscient(
        jax.random.PRNGKey(3), jnp.asarray(x), jnp.asarray(mask)), g)
    jg["b"]["c"] = jg["b"]["c"].astype(jnp.bfloat16)
    tg = {"a": _t(np.asarray(jg["a"])),
          "b": {"c": _t(np.asarray(jg["b"]["c"], np.float32)).to(
              torch.bfloat16)}}
    kw = dict(dropout=0.1, n_stragglers=2, stale_rounds=2)
    cfg = dict(f=1, trim=trim)
    p_end = TC(**cfg).phases(TF(**kw))
    key = jax.random.PRNGKey(6)
    jout, jaux = JRR.aggregate_stacked_auto(
        jg, "vrmom", reduce_backend="consensus", consensus=JC(**cfg),
        plan=JF(**kw), key=key, pin_mask=jnp.asarray(mask))
    d = _draws(key, n, p_end)
    tout, taux = RR.aggregate_stacked_auto(
        tg, "vrmom", reduce_backend="consensus", consensus=TC(**cfg),
        plan=TF(**kw), draws=d, pin_mask=_t(mask))
    assert tout["b"]["c"].dtype == torch.bfloat16
    for a, b in zip(jax.tree.leaves(jout), _leaves(tout)):
        a = np.asarray(a, np.float32)
        if trim == "midpoint":
            _same(b, a)
        else:  # a bf16 leaf: one rounding of values 1e-6 apart
            tol = 2.0 ** -8 if b.dtype == torch.bfloat16 else 1e-6
            _close(b, a, tol, 1e-6)
    _aux_match(jaux, taux)
    out2, aux2, diag = RR.aggregate(tg, mode="stacked-consensus", est="vrmom",
                                    with_diag=True, consensus=TC(**cfg),
                                    plan=TF(**kw), draws=d,
                                    pin_mask=_t(mask))
    for a, b in zip(_leaves(out2), _leaves(tout)):
        _same(a, b)
    for name in AUX:
        _same(getattr(aux2, name), getattr(taux, name))
    assert diag.scores.shape == (n,)


def test_wire_refusals_and_one_worker():
    """An adaptive estimator raises repro's whole-vector refusal; one worker
    runs the consensus wire with f = 0 (as repro's shard_map wire does)
    and returns its row."""
    g = {"a": torch.randn(8, 5, generator=torch.Generator().manual_seed(0))}
    with pytest.raises(ValueError, match="whole-vector"):
        RR.aggregate_stacked_auto(g, "vrmom_adaptive",
                                  reduce_backend="consensus")
    with pytest.raises(ValueError, match="reduce_backend"):
        RR.aggregate_stacked_auto(g, "vrmom", reduce_backend="gossip")
    one = {"a": g["a"][:1]}
    out, aux = RR.aggregate(one, mode="stacked-consensus", est="vrmom",
                            consensus=TC(f=1))
    _same(out["a"], one["a"][0])
    assert not bool(aux.quorum_lost)


# ---------------------------------------------------------------- the callers

def _lin_data(seed, m1=11, n=150, p=4):
    rng = np.random.RandomState(seed)
    theta = np.linspace(1.0, 0.0, p).astype(np.float32) / np.sqrt(p)
    X = rng.randn(m1, n, p).astype(np.float32)
    Y = (X @ theta + rng.randn(m1, n)).astype(np.float32)
    return X, Y


@pytest.mark.parametrize("attack,agg", [("none", "vrmom"),
                                        ("alie", "vrmom"),
                                        ("signflip", "median")])
def test_rcsl_consensus_trivial_plan_matches_repro(attack, agg):
    """RCSL with the consensus backend and no faults: the trajectory is
    repro's within 1e-5 (deterministic attacks; the pinned rows resend
    their payload every round)."""
    X, Y = _lin_data(11)
    kw = dict(alpha=0.2, attack=attack, aggregator=agg, K=10, rounds=4,
              tol=None, reduce_backend="consensus")
    jt, jtraj = JR.rcsl(JR.LinearRegressionProblem(),
                        JR.Shards(jnp.asarray(X), jnp.asarray(Y)),
                        jax.random.PRNGKey(0), **kw)
    tt, ttraj = TR.rcsl(TR.LinearRegressionProblem(), TR.Shards(_t(X), _t(Y)),
                        None, **kw)
    assert ttraj.shape == (5, 4)
    _close(ttraj, jtraj, 1e-5, 1e-5)
    _close(tt, jt, 1e-5, 1e-5)
    with pytest.raises(ValueError, match="n > 5f"):
        TR.rcsl(TR.LinearRegressionProblem(), TR.Shards(_t(X), _t(Y)),
                None, **dict(kw, consensus=TC(f=3)))


def test_rcsl_consensus_keeps_the_attack_draws(monkeypatch):
    """Under dropout the consensus draws come from their own generator, so
    the gaussian attack draws exactly what the direct backend's does:
    round 0's attacked stacks are the same bits, and the attack generator
    ends in the same state."""
    X, Y = _lin_data(12)
    seen = {"direct": [], "consensus": []}
    orig = TA.attack_stack
    backend = None

    def spy(name, generator, v, mask, axis=0):
        out = orig(name, generator, v, mask, axis)
        seen[backend].append(out.clone())
        return out

    monkeypatch.setattr(TA, "attack_stack", spy)
    states = {}
    for backend in ("direct", "consensus"):
        gen = torch.Generator().manual_seed(3)
        theta, _ = TR.rcsl(TR.LinearRegressionProblem(),
                           TR.Shards(_t(X), _t(Y)), gen, alpha=0.2,
                           attack="gaussian", rounds=3, tol=None,
                           reduce_backend=backend,
                           fault_plan=TF(dropout=0.1),
                           fault_generator=torch.Generator().manual_seed(9))
        assert np.isfinite(theta.numpy()).all()
        states[backend] = gen.get_state()
    _same(seen["consensus"][0], seen["direct"][0])
    assert len(seen["consensus"]) == len(seen["direct"]) == 3
    assert torch.equal(states["consensus"], states["direct"])


def test_coverage_cell_under_consensus():
    """tests/test_consensus.py:291's cell in the port (16 replications in
    chunks of 8): linear, alie at alpha 0.1, vrmom K 5, m 20, n 100, p 3,
    4 rounds, f 2, 10% dropout; the reference's criterion."""
    cell = coverage_run(model="linear", attack="alie", alpha=0.1,
                        estimator="vrmom", K=5, reps=16, N_per_machine=100,
                        m_workers=20, p=3, rounds=4, batch_size=8,
                        reduce_backend="consensus", consensus=TC(f=2),
                        fault_plan=TF(dropout=0.1), device="cpu")
    s = cell.summary()
    assert cell.covered.shape == (16, 3)
    assert np.isfinite(s["rmse"]) and s["coverage"] >= 0.6, s


def _train_setup():
    jcfg = j_get_arch("qwen3-1.7b").reduced()
    tcfg = t_get_arch("qwen3-1.7b").reduced()
    jp = JM.init(jax.random.PRNGKey(0), jcfg)
    return tcfg, params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                 device="cpu")


def test_train_step_aggregate_matches_repro(monkeypatch):
    """The consensus train step at W = 8 (reduced qwen3, alie on one
    pinned row, dropout and a crash): its aggregate is repro's consensus
    aggregate of the step's own stacked gradients on the same draws (the
    port's own draws swapped for repro's). Six rounds (max_rounds) keep
    the test short; the next test runs all 40."""
    tcfg, params = _train_setup()
    plan_kw = dict(dropout=0.1, n_crashed=1, crash_round=2)
    cfg = dict(f=1, max_rounds=6)
    p_end = TC(**cfg).phases(TF(**plan_kw))
    key = jax.random.PRNGKey(21)
    d = _draws(key, 8, p_end)
    monkeypatch.setattr(TFM.FaultPlan, "uniforms",
                        lambda self, n, rounds, *a, **k: _t(d))
    seen = {}
    orig = RR.aggregate

    def spy(grads, **kw):
        seen["stack"] = [g.clone() for g in _leaves(grads)]
        out = orig(grads, **kw)
        seen["agg"], seen["aux"] = list(_leaves(out[0])), out[1]
        return out

    monkeypatch.setattr(RR, "aggregate", spy)
    setup = make_train_step(tcfg, 8, estimator="vrmom", byzantine_frac=0.15,
                            attack="alie", reduce_backend="consensus",
                            consensus=TC(**cfg), fault_plan=TF(**plan_kw),
                            lr=1e-2, device="cpu")
    out = setup.step_fn(params, setup.optimizer.init(params),
                        lm_batch(tcfg, 0, 8, 16, device="cpu"))
    assert len(out) == 4 and isinstance(out[3], TCS.ConsensusAux)
    wire = jnp.concatenate([jnp.asarray(g.numpy()).reshape(8, -1)
                            for g in seen["stack"]], axis=1)
    jagg, jaux = j_aggregate(wire, "vrmom", config=JC(**cfg),
                             plan=JF(**plan_kw), key=key,
                             pin_mask=jnp.arange(8) >= 7)
    got = np.concatenate([a.numpy().reshape(-1) for a in seen["agg"]])
    scale = float(np.abs(np.asarray(jagg)).max())
    _close(got, jagg, 1e-6, 1e-6 * scale)
    _aux_match(jaux, seen["aux"])
    _aux_match(jaux, out[3])


def test_train_step_under_attack_and_dropout_learns():
    """tests/test_consensus.py:246 on one device: alie on one pinned row,
    10% dropout and a crash at round 2; six steps stay finite, keep
    quorum, and the loss falls."""
    tcfg, params = _train_setup()
    assert int(0.15 * (8 - 1)) == 1
    setup = make_train_step(tcfg, 8, estimator="vrmom",
                            reduce_backend="consensus",
                            consensus=TC(f=1),
                            fault_plan=TF(dropout=0.1, n_crashed=1,
                                          crash_round=2),
                            byzantine_frac=0.15, attack="alie", lr=1e-2,
                            device="cpu")
    opt = setup.optimizer.init(params)
    gen = torch.Generator().manual_seed(0)
    losses = []
    for i in range(6):
        params, opt, loss, caux = setup.step_fn(
            params, opt, lm_batch(tcfg, i, 8, 32, device="cpu"), gen)
        losses.append(float(loss))
        assert np.isfinite(losses[-1]) and not bool(caux.quorum_lost)
        assert int(caux.rounds_run) == 40
    assert losses[-1] < losses[0], losses


def test_train_step_consensus_build_refusals():
    tcfg = t_get_arch("qwen3-1.7b").reduced()
    tcfg = dataclasses.replace(tcfg)
    with pytest.raises(ValueError, match="needs the materialized"):
        make_train_step(tcfg, 8, mode="inloop", reduce_backend="consensus",
                        device="cpu")
    with pytest.raises(ValueError, match="n > 5f"):
        make_train_step(tcfg, 8, reduce_backend="consensus",
                        byzantine_frac=0.3, device="cpu")
    # the default f follows the Byzantine fraction, at least 1
    make_train_step(tcfg, 8, reduce_backend="consensus", device="cpu")
    make_train_step(tcfg, 1, reduce_backend="consensus", device="cpu")
