"""Layer-2 auditor (RL201–RL211, ``repro.lint.auditor``'s port).

``repro``'s auditor traces its entry points abstractly
(``jax.eval_shape``); the port has no abstract trace, so each check runs
the port's own entry point on a device at a small size (the reduced
qwen3-1.7b, the reduced family config it needs, a few workers) and
checks the invariants the AST layer cannot see: wire shapes and dtypes,
the guards, the coordinatewise gate, the cache round-trip and capture
stability.

Entry points audited:

1. ``dist.robust_reduce.aggregate_symmetric_stacked``  (RL202)
2. ``core.estimator.Estimator`` gates, the stacked and
   serve wires                                           (RL203)
3. ``aggregate_stacked_auto`` / ``serve.robust.robust_logits``
   dtypes                                                (RL204)
4. ``robust_dot`` / ``robust_backward`` and the inloop
   step's batch guard                                    (RL205)
5. ``train.step.make_train_step`` stacked-auto           (RL206)
6. ``serve.engine.ServeEngine`` prefill + robust pool    (RL207)
7. ``infer.sandwich.infer``                              (RL208)
8. every static spec, and ``generate``/``decode_pool``
   with a fresh equal ``Sampling`` on the card           (RL209)
9. the consensus wire                                    (RL210)
10. ``core.adaptive`` init_state/apply_adaptive carry    (RL211)

RL201 (the multi-rank RRS wire) runs ``aggregate_stacked_rrs`` over the
default process group when one of two or more ranks is initialised, and
reports ``skip`` off a group, as ``repro``'s skips with fewer than two
devices.

``run_audit(device=None)`` runs on the card (``device.resolve_device``:
no card raises); pass ``"cpu"`` for the host. Every check's failure is a
result, never an exception; each result carries the check's wall
seconds.
"""
from __future__ import annotations

import traceback
from typing import Callable, List, Optional

import torch

from ..obs.metrics import now
from .findings import AuditResult

__all__ = ["run_audit", "capture_stability", "divisibility_audit",
           "consensus_validity_audit"]


class _Skip(Exception):
    pass


def _result(check_id: str, entry: str, fn: Callable[[], str]) -> AuditResult:
    """Run one check body; it returns the ok-detail or raises."""
    t0 = now()
    try:
        status, detail = "ok", fn()
    except _Skip as s:
        status, detail = "skip", str(s)
    except Exception as e:  # noqa: BLE001 — every failure is a finding
        status, detail = "fail", f"{type(e).__name__}: {e}"
        if not str(e):
            detail = traceback.format_exc(limit=3)
    return AuditResult(check_id, entry, status, detail, now() - t0)


def _need(ok, what) -> None:
    """A check of the audit: raise ``AssertionError(what)`` unless ``ok``
    (an ``assert`` would vanish under ``python -O``)."""
    if not ok:
        raise AssertionError(what)


def _expect_raises(thunk, exc, must_contain: str, what: str) -> None:
    try:
        thunk()
    except exc as e:
        if must_contain not in str(e):
            raise AssertionError(
                f"{what}: raised {type(e).__name__} but the message "
                f"{str(e)!r} does not mention {must_contain!r}")
        return
    raise AssertionError(f"{what}: expected {exc.__name__}, nothing raised")


def _gen(dev, seed: int = 0) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(seed)


def _randn(dev, shape, dtype=torch.float32, seed: int = 0):
    return torch.randn(shape, generator=_gen(dev, seed), device=dev,
                       dtype=torch.float32).to(dtype)


def _audit_cfg():
    from ..configs import get
    return get("qwen3-1.7b").reduced()


def _same_layout(a, b, what: str) -> None:
    """Two tensors (or NamedTuples of tensors) of one structure, shapes
    and dtypes."""
    if torch.is_tensor(a):
        _need(torch.is_tensor(b), f"{what}: tensor -> {type(b).__name__}")
        _need(a.shape == b.shape and a.dtype == b.dtype, (
            f"{what}: {tuple(a.shape)}/{a.dtype} -> "
            f"{tuple(b.shape)}/{b.dtype}"))
        return
    _need(type(a) is type(b), (
        f"{what}: {type(a).__name__} -> {type(b).__name__}"))
    if isinstance(a, dict):
        _need(a.keys() == b.keys(), f"{what}: keys changed")
        for k in a:
            _same_layout(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, tuple):
        _need(len(a) == len(b), f"{what}: length changed")
        names = getattr(a, "_fields", range(len(a)))
        for n, x, y in zip(names, a, b):
            _same_layout(x, y, f"{what}.{n}")
    else:
        _need(a == b, f"{what}: {a!r} -> {b!r}")


def _layout(tree):
    """A structure-preserving copy of ``tree``'s tensor metadata (meta
    tensors): what a tree held before an in-place step."""
    if torch.is_tensor(tree):
        return torch.empty(tree.shape, dtype=tree.dtype, device="meta")
    if isinstance(tree, dict):
        return {k: _layout(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        vals = [_layout(v) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
    return tree


# ---------------------------------------------------------------------------
# RL201 — the multi-rank RRS wire
# ---------------------------------------------------------------------------

def _check_rrs_wire(dev) -> List[AuditResult]:
    def body():
        import torch.distributed as dist

        from ..core.estimator import Estimator
        from ..dist.robust_reduce import aggregate_stacked_rrs

        nw = (dist.get_world_size()
              if dist.is_available() and dist.is_initialized() else 1)
        if nw < 2:
            raise _Skip(f"needs a process group of >= 2 ranks for the "
                        f"multi-rank wire, have {nw} (run the audit on "
                        f"each rank of one)")
        est = Estimator(method="vrmom", K=3)
        # deliberately wire-unfriendly sizes: 4*6 + 5 = 29 coordinates,
        # coprime with any nw >= 2, so the zero-pad path is exercised;
        # each rank holds one worker's row
        grads = {"w": _randn(dev, (1, 4, 6), torch.bfloat16,
                             seed=dist.get_rank()),
                 "b": _randn(dev, (1, 5), seed=100 + dist.get_rank())}
        out = aggregate_stacked_rrs(grads, dist.group.WORLD, est)
        _need(tuple(out["w"].shape) == (4, 6), tuple(out["w"].shape))
        _need(tuple(out["b"].shape) == (5,), tuple(out["b"].shape))
        _need(out["w"].dtype == torch.bfloat16, (
            f"bf16 leaf upcast to {out['w'].dtype} on the wire"))
        _need(out["b"].dtype == torch.float32, out["b"].dtype)
        return (f"[1, ...] rows on each of {nw} ranks -> worker dim "
                f"removed, dtypes preserved (bf16 stays bf16) across the "
                f"padded f32 wire")

    return [_result("RL201", "dist.aggregate_stacked_rrs", body)]


# ---------------------------------------------------------------------------
# RL202 — §9 upper-triangle wire length
# ---------------------------------------------------------------------------

def _check_symmetric_wire(dev) -> List[AuditResult]:
    def body():
        from ..core.estimator import Estimator
        from ..dist.robust_reduce import aggregate_symmetric_stacked

        W, p = 5, 7
        tri = p * (p + 1) // 2
        seen = []

        class Recording(Estimator):
            """The spec with its wire recorded: the shape each apply
            aggregates."""

            def apply(self, x, axis: int = 0):
                seen.append((tuple(x.shape), axis))
                return super().apply(x, axis)

        a = _randn(dev, (W, p, p), torch.bfloat16, seed=1)
        mats = (a + a.transpose(-1, -2)).to(torch.bfloat16)
        out = aggregate_symmetric_stacked(mats, Recording(method="vrmom",
                                                          K=3))
        _need(tuple(out.shape) == (p, p), tuple(out.shape))
        _need(out.dtype == torch.bfloat16, (
            f"symmetric aggregate upcast to {out.dtype}"))
        _need(seen == [((W, tri), 0)], (
            f"the estimator saw {seen}, not one [W={W}, p(p+1)/2={tri}] "
            f"wire over axis 0"))
        _need(torch.equal(out, out.t()), "aggregate is not symmetric")
        return (f"[{W}, {p}, {p}] stack rides a [{W}, {tri}] upper-triangle "
                f"wire; output [{p}, {p}] {out.dtype}, exactly symmetric")

    return [_result("RL202", "dist.aggregate_symmetric_stacked", body)]


# ---------------------------------------------------------------------------
# RL203 — coordinatewise gate
# ---------------------------------------------------------------------------

def _check_coordinatewise_gate(dev) -> List[AuditResult]:
    def body():
        from ..core.estimator import Estimator
        from ..dist.robust_reduce import aggregate_stacked_auto
        from ..serve.robust import RobustDecodeConfig

        g = {"w": _randn(dev, (8, 12))}
        for method in ("geometric_median", "krum"):
            _expect_raises(
                lambda m=method: aggregate_stacked_auto(g, m),
                ValueError, "whole-vector",
                f"aggregate_stacked_auto({method!r})")
            _expect_raises(
                lambda m=method: Estimator(method=m).require_stackable(),
                ValueError, "whole-vector",
                f"Estimator({method!r}).require_stackable()")
            _expect_raises(
                lambda m=method: RobustDecodeConfig(m=8, estimator=m),
                ValueError, "whole-vector",
                f"RobustDecodeConfig(estimator={method!r})")
        _expect_raises(
            lambda: Estimator(method="trimmed_mean", beta=0.05).validate(8),
            ValueError, "degrade",
            "trimmed_mean beta=0.05 at m=8 (trims 0 rows)")
        return ("GM/Krum refused on the stacked wire and the serve wire "
                "(require_stackable, RobustDecodeConfig); degenerate "
                "trimmed_mean refused at validate()")

    return [_result("RL203", "Estimator.require_stackable/validate", body)]


# ---------------------------------------------------------------------------
# RL204 — wire dtype discipline
# ---------------------------------------------------------------------------

def _check_wire_dtype(dev) -> List[AuditResult]:
    def body():
        from ..dist.robust_reduce import aggregate_stacked_auto
        from ..serve.robust import RobustDecodeConfig, robust_logits

        out = aggregate_stacked_auto({"w": _randn(dev, (8, 33),
                                                  torch.bfloat16)}, "vrmom")
        _need(out["w"].dtype == torch.bfloat16, (
            f"bf16 gradient stack silently upcast to {out['w'].dtype}"))
        _need(tuple(out["w"].shape) == (33,), tuple(out["w"].shape))
        rcfg = RobustDecodeConfig(m=4, estimator="median")
        logits = robust_logits(_randn(dev, (4, 2, 64), torch.bfloat16),
                               rcfg, _gen(dev))
        _need(tuple(logits.shape) == (2, 64), tuple(logits.shape))
        _need(logits.dtype == torch.float32, (
            f"robust decode logits must be f32, got {logits.dtype}"))
        return ("stacked aggregation returns the input dtype (bf16 in, "
                "bf16 out); robust decode logits are exactly f32")

    return [_result("RL204", "dist/serve wire dtypes", body)]


# ---------------------------------------------------------------------------
# RL205 — worker-divisibility guards
# ---------------------------------------------------------------------------

def _check_divisibility_guard(dev) -> List[AuditResult]:
    def body():
        from ..dist.robust_reduce import robust_backward, robust_dot
        from ..models import model as M
        from ..train.step import make_train_step

        nw = 4

        def grad_with_batch(B):
            x = _randn(dev, (B, 2, 4))
            w = _randn(dev, (4, 3), seed=1).requires_grad_(True)
            with robust_backward(nw, "median"):
                torch.sum(robust_dot(x, w)).backward()
            return w.grad

        _expect_raises(lambda: grad_with_batch(nw + 1),
                       ValueError, "not divisible",
                       f"robust_dot with B={nw + 1}, nw={nw}")
        dw = grad_with_batch(2 * nw)
        _need(tuple(dw.shape) == (4, 3), tuple(dw.shape))

        cfg = _audit_cfg()
        params = M.init(cfg, _gen(dev), device=dev)
        inloop = make_train_step(cfg, nw, estimator="median", mode="inloop",
                                 device=dev)
        opt_state = inloop.optimizer.init(params)
        tokens = torch.randint(0, cfg.vocab, (nw + 1, 32), generator=_gen(dev),
                               device=dev)
        _expect_raises(
            lambda: inloop.step_fn(params, opt_state, {"tokens": tokens}),
            ValueError, "divisible",
            f"inloop train step with batch {nw + 1} on {nw} workers")
        return (f"robust_dot refuses B={nw + 1}, and B={2 * nw} gives dW "
                f"[4, 3] aggregated over {nw} workers; the inloop step "
                f"refuses batch {nw + 1}")

    return [_result("RL205", "dist.robust_dot / train inloop", body)]


# ---------------------------------------------------------------------------
# RL206 — the train step keeps its shapes
# ---------------------------------------------------------------------------

def _check_train_step(dev) -> List[AuditResult]:
    def body():
        from ..models import model as M
        from ..train.step import make_train_step

        nw = 4
        cfg = _audit_cfg()
        setup = make_train_step(cfg, nw, estimator="vrmom",
                                mode="stacked-auto", device=dev)
        _need(setup.n_workers == nw, (setup.n_workers, nw))
        params = M.init(cfg, _gen(dev), device=dev)
        opt_state = setup.optimizer.init(params)
        before = _layout((params, opt_state))
        tokens = torch.randint(0, cfg.vocab, (2 * nw, 32),
                               generator=_gen(dev), device=dev)
        p2, o2, loss = setup.step_fn(params, opt_state, {"tokens": tokens},
                                     _gen(dev))
        _same_layout(before, _layout((p2, o2)), "(params, opt_state)")
        _need(loss.shape == (), tuple(loss.shape))
        _need(bool(torch.isfinite(loss)), f"loss {float(loss)}")
        return (f"stacked-auto step on {nw} workers keeps every param and "
                f"opt-state shape and dtype; scalar finite loss")

    return [_result("RL206", "train.make_train_step", body)]


# ---------------------------------------------------------------------------
# RL207 — serve prefill / robust pool decode and the cache round-trip
# ---------------------------------------------------------------------------

def _check_serve_engine(dev) -> List[AuditResult]:
    def body():
        from ..models import model as M
        from ..serve.engine import ServeEngine
        from ..serve.robust import RobustDecodeConfig

        cfg = _audit_cfg()
        params = M.init(cfg, _gen(dev), device=dev)
        engine = ServeEngine(
            cfg, params, max_len=48, n_slots=2,
            robust=RobustDecodeConfig(m=2, estimator="median",
                                      share_replica_compute=False),
            device=dev)
        tokens = torch.randint(0, cfg.vocab, (2, 8), generator=_gen(dev),
                               device=dev)
        logits, _ = engine.prefill({"tokens": tokens})
        _need(tuple(logits.shape) == (2, cfg.vocab), tuple(logits.shape))

        pool = engine.make_pool()
        before = _layout(pool.caches)
        pool, tok = engine.admit(pool, 0, {"tokens": tokens[:1]})
        cur = torch.tensor([tok, 0], dtype=torch.int32).to(dev)
        pool, toks = engine.decode_pool(pool, cur, 3)
        _need(tuple(toks.shape) == (3, 2), tuple(toks.shape))
        _need(toks.dtype == torch.int32, toks.dtype)
        _same_layout(before, _layout(pool.caches), "pool.caches")
        return ("prefill logits [B, V]; a 3-step robust pool decode (m = 2 "
                "replica rows a slot) returns the cache tree with the same "
                "structure, shapes and dtypes")

    return [_result("RL207", "serve.ServeEngine prefill/decode_pool", body)]


# ---------------------------------------------------------------------------
# RL208 — sandwich CI path
# ---------------------------------------------------------------------------

def _check_sandwich(dev) -> List[AuditResult]:
    def body():
        from ..core.rcsl import LinearRegressionProblem, Shards
        from ..infer.sandwich import infer

        m, n, p = 4, 16, 3
        X = _randn(dev, (m + 1, n, p), seed=1)
        theta = _randn(dev, (p,), seed=2)
        Y = X @ theta + 0.1 * _randn(dev, (m + 1, n), seed=3)
        res = infer(LinearRegressionProblem(), Shards(X=X, Y=Y), theta,
                    estimator="vrmom", K=3)
        _need(tuple(res.ci.lower.shape) == (p,), tuple(res.ci.lower.shape))
        _need(tuple(res.ci.upper.shape) == (p,), tuple(res.ci.upper.shape))
        for name in ("cov", "H", "Sigma"):
            got = tuple(getattr(res, name).shape)
            _need(got == (p, p), f"{name}: {got}")
        return (f"machine stats -> robust moments -> Theorem-4 sandwich: "
                f"[p]={p} intervals, [p, p] covariance")

    return [_result("RL208", "infer.sandwich.infer", body)]


# ---------------------------------------------------------------------------
# RL210 — consensus wire shapes + n > 5f refusal
# ---------------------------------------------------------------------------

def _check_consensus(dev) -> List[AuditResult]:
    def body():
        from ..core.estimator import Estimator
        from ..dist.consensus import ConsensusAux, ConsensusConfig
        from ..dist.faults import FaultPlan
        from ..dist.robust_reduce import aggregate_stacked_auto

        nw = 8
        est = Estimator(method="vrmom", K=3)
        f_ok = (nw - 1) // 5
        grads = {"w": _randn(dev, (nw, 4, 6), torch.bfloat16),
                 "b": _randn(dev, (nw, 5), seed=1)}
        for plan in (None, FaultPlan(dropout=0.25, n_crashed=1,
                                     crash_round=1)):
            out, aux = aggregate_stacked_auto(
                grads, est, reduce_backend="consensus",
                consensus=ConsensusConfig(f=f_ok, max_rounds=4), plan=plan,
                generator=_gen(dev))
            _need(tuple(out["w"].shape) == (4, 6), tuple(out["w"].shape))
            _need(tuple(out["b"].shape) == (5,), tuple(out["b"].shape))
            _need(out["w"].dtype == torch.bfloat16, (
                f"bf16 leaf upcast to {out['w'].dtype} through the rounds"))
            _need(out["b"].dtype == torch.float32, out["b"].dtype)
            _need(isinstance(aux, ConsensusAux), type(aux))
            for name, leaf in zip(aux._fields, aux):
                _need(leaf.shape == (), (
                    f"aux field {name} is not a scalar: {tuple(leaf.shape)}"))
        _expect_raises(
            lambda: aggregate_stacked_auto(
                grads, est, reduce_backend="consensus",
                consensus=ConsensusConfig(f=nw)),
            ValueError, "n > 5f", f"consensus with f={nw} on {nw} peers")
        return (f"[{nw}, ...] tree -> worker dim removed, dtypes kept "
                f"through the rounds (fault-free and faulty plans), scalar "
                f"aux; f={nw} refused")

    return [_result("RL210", "dist consensus wire", body)]


# ---------------------------------------------------------------------------
# RL211 — adaptive aggregation state is an explicit carry
# ---------------------------------------------------------------------------

_IMMUTABLE = (type(None), bool, int, float, complex, str, bytes,
              tuple, frozenset)


def _check_adaptive_carry(dev) -> List[AuditResult]:
    def body():
        from ..core import adaptive as AD
        from ..core.estimator import Estimator

        mutable = []
        for gname, val in vars(AD).items():
            if gname.startswith("_") or callable(val):
                continue
            if type(val).__name__ == "module":
                continue
            if type(val).__module__ == "__future__":
                continue  # the `annotations` feature flag
            if not isinstance(val, _IMMUTABLE):
                mutable.append(f"{gname}: {type(val).__name__}")
        _need(not mutable, (
            f"mutable module-level state in repro_torch.core.adaptive: "
            f"{mutable}"))

        nw, dim = 9, 40
        x = _randn(dev, (nw, dim))
        for method in ("auto_gm", "vrmom_adaptive"):
            est = Estimator(method=method, K=4)
            state = est.init_adaptive_state(nw, dim, device=dev)
            before = _layout(state)
            out, new_state = est.apply_adaptive(x, state)
            _need(tuple(out.shape) == (dim,), (method, tuple(out.shape)))
            _need(out.dtype == torch.float32, (method, out.dtype))
            _same_layout(before, _layout(new_state), f"{method} carry")

        _expect_raises(
            lambda: Estimator(method="vrmom", K=4).init_adaptive_state(
                nw, dim, device=dev),
            ValueError, "adaptive",
            "init_adaptive_state on a fixed-K estimator")
        return ("auto_gm/vrmom_adaptive carry round-trips with fixed "
                "shapes and dtypes; module globals immutable; fixed-K "
                "estimators refuse a carry")

    return [_result("RL211", "core.adaptive carry", body)]


# ---------------------------------------------------------------------------
# RL209 — capture stability (public helper, the spec sweep, the engine)
# ---------------------------------------------------------------------------

def capture_stability(name: str, factory: Callable[[], object]
                      ) -> AuditResult:
    """Check a static-spec factory keys a cache stably (``repro``'s
    ``recompile_stability``).

    ``factory()`` must build a *fresh* spec each call. Two fresh specs
    must be equal, hash alike, and find each other's entry in an
    ``OrderedDict`` (as ``ServeEngine.graphs`` is keyed by ``Sampling``):
    a spec whose hash or eq drifts would capture a new step every call.
    """
    def body():
        from collections import OrderedDict

        a, b = factory(), factory()
        _need(a is not b, (
            f"{name}: factory returned the same object twice — the "
            f"check needs freshly constructed specs"))
        _need(a == b, f"{name}: two fresh equal-valued specs are != ")
        _need(hash(a) == hash(b), (
            f"{name}: equal specs hash differently ({hash(a)} vs "
            f"{hash(b)}) — every call would capture anew"))
        cache = OrderedDict([(a, object())])
        _need(cache.get(b) is cache[a], (
            f"{name}: a fresh equal spec misses the cache entry"))
        return "two fresh equal specs -> one cache entry (key stable)"

    return _result("RL209", name, body)


def _specs():
    from ..configs.base import ArchConfig
    from ..core.estimator import Estimator
    from ..dist.consensus import ConsensusConfig
    from ..dist.faults import FaultPlan
    from ..serve.engine import Sampling
    from ..serve.robust import RobustDecodeConfig

    return [
        ("core.Estimator",
         lambda: Estimator(method="vrmom", K=4, backend="cuda")),
        ("core.Estimator[adaptive]",
         lambda: Estimator(method="auto_gm")),
        ("dist.ConsensusConfig",
         lambda: ConsensusConfig(f=1, eps=1e-3, trim="midpoint")),
        ("dist.FaultPlan",
         lambda: FaultPlan(dropout=0.1, n_crashed=1, crash_round=2)),
        ("configs.ArchConfig",
         lambda: ArchConfig(name="audit", family="dense", n_layers=1,
                            d_model=32, n_heads=2, n_kv_heads=1,
                            d_ff=64, vocab=64)),
        ("serve.RobustDecodeConfig",
         lambda: RobustDecodeConfig(m=4, estimator="median")),
        ("serve.Sampling",
         lambda: Sampling(method="top_k", temperature=0.7, top_k=5)),
    ]


def engine_capture_stability(engine, batch, n_tokens: int = 4,
                             sampling=None, pool: bool = True):
    """On the card: ``generate`` three times, the third with a freshly
    built ``Sampling`` equal to the first, and (``pool``) ``decode_pool``
    twice the same way. Passes when each path holds one captured step
    after its first call and the later calls replay that same
    ``StepGraph`` (no new capture), and the third generate's tokens equal
    the first's. Returns ``(detail, first tokens)``; raises on a
    failure."""
    from ..serve.engine import Sampling

    sc = sampling if sampling is not None else Sampling(
        method="top_k", temperature=0.7, top_k=5)

    def fresh():
        return Sampling(*tuple(sc))

    engine.graphs.clear()
    first = engine.generate(batch, n_tokens, fresh(),
                            torch.Generator(engine.device).manual_seed(0))
    _need(len(engine.graphs) == 1, (
        f"{len(engine.graphs)} captured steps after one generate"))
    st = next(iter(engine.graphs.values()))
    replays = st.replays
    engine.generate(batch, n_tokens, fresh(),
                    torch.Generator(engine.device).manual_seed(1))
    third = engine.generate(batch, n_tokens, fresh(),
                            torch.Generator(engine.device).manual_seed(0))
    _need(len(engine.graphs) == 1, (
        f"a fresh equal Sampling captured again: {len(engine.graphs)} "
        f"steps"))
    _need(next(iter(engine.graphs.values())) is st, (
        "a new StepGraph replaced the captured step"))
    _need(st.replays == replays + 2 * (n_tokens - 1), (
        f"replays {replays} -> {st.replays}: the later generates did not "
        f"replay the captured step"))
    _need(torch.equal(first, third), (
        "the third generate (same seed, fresh equal Sampling) gave other "
        "tokens than the first"))
    detail = (f"generate x3 with fresh equal Sampling: 1 capture, "
              f"{st.replays} replays")
    if pool:
        p = engine.make_pool()
        n = p.n_slots
        cur = torch.zeros((n,), dtype=torch.int32, device=engine.device)
        engine.pool_graphs.clear()
        engine.decode_pool(p, cur, n_tokens, fresh())
        _need(len(engine.pool_graphs) == 1, len(engine.pool_graphs))
        pst = next(iter(engine.pool_graphs.values()))
        engine.decode_pool(p, cur, n_tokens, fresh())
        _need(len(engine.pool_graphs) == 1 and \
            next(iter(engine.pool_graphs.values())) is pst, (
                "decode_pool with a fresh equal Sampling captured again"))
        detail += f"; decode_pool x2: 1 capture, {pst.replays} replays"
    return detail, first


def _check_capture(dev) -> List[AuditResult]:
    try:
        results = [capture_stability(name, fac) for name, fac in _specs()]
    except Exception as e:  # noqa: BLE001 — every failure is a finding
        results = [AuditResult("RL209", "static specs", "fail",
                               f"{type(e).__name__}: {e}")]

    def body():
        from ..models import model as M
        from ..serve.engine import ServeEngine
        from ..serve.robust import RobustDecodeConfig

        if dev.type != "cuda":
            return ("no capture on the CPU (the step runs eagerly); the "
                    "specs above key engine.graphs stably")
        cfg = _audit_cfg()
        params = M.init(cfg, _gen(dev), device=dev)
        engine = ServeEngine(cfg, params, max_len=40, n_slots=2,
                             robust=RobustDecodeConfig(m=4), device=dev)
        tokens = torch.randint(0, cfg.vocab, (2, 12), generator=_gen(dev),
                               device=dev)
        return engine_capture_stability(engine, {"tokens": tokens})[0]

    results.append(_result("RL209", "serve.ServeEngine capture", body))
    return results


# ---------------------------------------------------------------------------
# public helpers for config-level audits (used by tests)
# ---------------------------------------------------------------------------

def divisibility_audit(name: str, batch: int, n_workers: int) -> AuditResult:
    """Flag a config whose global batch the worker count cannot divide —
    the static precondition RL205 checks the runtime guards enforce."""
    def body():
        if n_workers > 1 and batch % n_workers:
            raise AssertionError(
                f"global batch {batch} is not divisible by {n_workers} "
                f"workers: per-worker grouping breaks and the robust "
                f"guarantee does not apply")
        return f"batch {batch} / {n_workers} workers divides evenly"

    return _result("RL205", name, body)


def consensus_validity_audit(name: str, n: int, f: int) -> AuditResult:
    """Flag a consensus deployment outside the ``n > 5f`` validity
    region — the static precondition RL210 checks the runtime refusal
    enforces. Pure arithmetic on the config: no device needed."""
    def body():
        from ..dist.consensus import ConsensusConfig

        if n <= 5 * f:
            raise AssertionError(
                f"n={n} peers with f={f} Byzantine faults violates "
                f"n > 5f: approximate consensus loses both validity "
                f"and convergence (need n >= {5 * f + 1})")
        ConsensusConfig(f=f).validate(n)
        return f"n={n}, f={f} satisfies n > 5f (margin {n - 5 * f})"

    return _result("RL210", name, body)


# ---------------------------------------------------------------------------
# the whole audit
# ---------------------------------------------------------------------------

_CHECKS = (_check_rrs_wire, _check_symmetric_wire, _check_coordinatewise_gate,
           _check_wire_dtype, _check_divisibility_guard, _check_train_step,
           _check_serve_engine, _check_sandwich, _check_consensus,
           _check_adaptive_carry, _check_capture)


def run_audit(device: Optional[object] = None) -> List[AuditResult]:
    """Run every RL2xx check on ``device`` (None: the card, which raises
    without one); never raises past that — failures are results."""
    from ..device import resolve_device

    dev = resolve_device(device)
    results: List[AuditResult] = []
    for check in _CHECKS:
        results += check(dev)
    return results
