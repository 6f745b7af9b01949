"""The ranks of ``tests/test_torch_rrs.py``: every check of the multi-rank
wire on one ``gloo`` group of CPU ranks, started by
``torch.multiprocessing``, rendezvous through a ``FileStore`` (no port).

Each rank runs every check in the same order (a check that raises is
recorded, not thrown, so no rank leaves the others waiting in a
collective), writes ``{check: [status, detail]}`` to ``rank<r>.json`` in
the run's directory, and rank 0 saves the RRS wire's output on
``repro``'s RRS test arrays to ``port_rrs.npz`` there (4 ranks) and the
consensus wire's on ``repro``'s consensus test arrays and uniforms to
``port_consensus.npz`` (8 ranks). The module imports neither jax nor
``repro``: a spawned rank imports only what it runs. It holds no test of
its own.
"""
from __future__ import annotations

import datetime
import hashlib
import json
import os
import traceback

import numpy as np
import torch
import torch.distributed as dist

SEED = 31
WIRE_ESTIMATORS = {"vrmom_K3": ("vrmom", dict(K=3)),
                   "vrmom_K10": ("vrmom", dict(K=10)),
                   "mom": ("mom", {}), "median": ("median", {}),
                   "trimmed_mean": ("trimmed_mean", {}),
                   # B1's mean (its plain version here); the default
                   # backend's torch.mean is held apart, "mean_ref"
                   "mean": ("mean", dict(backend="cuda"))}
# the reduced qwen3's leaves every one of whose products rides the wire
WIRE_LEAVES = ("layers/attn/wq", "layers/attn/wk", "layers/attn/wv",
               "layers/attn/wo", "layers/mlp/w_gate", "layers/mlp/w_up",
               "layers/mlp/w_down")
# the inloop step's leaves off the wire: the ranks' f32 partial sums of the
# norms' and the embedding lookup's gradients against the one process's
# single sum (summation order), over SGD at lr 1e-2
INLOOP_TOL = 1e-6
TRAIN_SEQ = 24
# the consensus wire's plans on 8 ranks (f = 1): fault-free,
# tests/test_consensus.py:229's dropout with a crash, stragglers, and a
# pinned omniscient row on the attack's path
CONS_PLANS = {"fault_free": {},
              "dropout_crash": dict(dropout=0.2, n_crashed=1, crash_round=1),
              "stragglers": dict(n_stragglers=2, stale_rounds=2),
              "pinned_omniscient": {}}
CONS_TRIMS = ("mean", "midpoint")
# columns a block in the consensus checks: _tree's 1,925 coordinates in 4
# blocks, each ending mid-leaf
CONS_CHUNK = 512
# the consensus train steps over 8 ranks (reduced qwen3, one Byzantine
# worker, dropout 0.1): (attack, steps, the rank that holds the
# one-process reference, so the three run side by side)
CONS_TRAIN = (("alie", 2, 0), ("mimic", 1, 1), ("gaussian", 1, 2))
CONS_TRAIN_ROUNDS = 6
# the coverage cells over 4 ranks: a reduced cell, two replications a rank
# in chunks of one; and tests/test_infer.py's small-rep cell (40
# replications), held against repro's cell on a 4-device host mesh
COV_REDUCED = dict(model="linear", attack="gaussian", alpha=0.1,
                   estimator="vrmom", K=10, m_workers=20, N_per_machine=100,
                   p=3, rounds=3, reps=8, batch_size=1, seed=5)
COV_CASES = {"direct": {},
             "consensus_dropout": dict(reduce_backend="consensus"),
             "labelflip": dict(model="logistic", attack="none",
                               labelflip=True)}
COV_SMALL_REP = dict(model="linear", attack="gaussian", alpha=0.1,
                     estimator="vrmom", reps=40, N_per_machine=200,
                     m_workers=100, p=5, rounds=6, level=0.95, batch_size=10,
                     seed=0)


def run_ranks(world: int, path: str, timeout: float = 300.0) -> None:
    """Start ``world`` ranks of :func:`rank_main` and wait for them; a rank
    that fails or a run past ``timeout`` raises (every rank is ended)."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(rank_main, args=(world, path), nprocs=world,
                             join=False, start_method="spawn")
    deadline = datetime.datetime.now() + datetime.timedelta(seconds=timeout)
    try:
        while not ctx.join(timeout=1.0):
            if datetime.datetime.now() > deadline:
                raise TimeoutError(f"{world} ranks still running after "
                                   f"{timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()


def _tree(rng, W: int):
    """A stacked tree of f32 and bf16 leaves whose 1,925 coordinates end
    mid-slice on any world size here."""
    bf = lambda *s: torch.from_numpy(rng.standard_normal(s, np.float32)
                                     ).to(torch.bfloat16)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s, np.float32))
    return {"w": bf(W, 4, 6), "b": f(W, 5),
            "big": {"e": f(W, 37, 11), "f": bf(W, 300)},
            "z": {"a": f(W, 3, 7, 9), "c": bf(W, 1000)}}


def _rows(tree, lo: int, hi: int):
    from repro_torch.tree import tree_map

    return tree_map(lambda g: g[lo:hi].contiguous(), tree)


def _equal(a, b) -> bool:
    from repro_torch.tree import leaves

    return all(x.dtype == y.dtype and torch.equal(x, y)
               for x, y in zip(leaves(a), leaves(b)))


def _digest(tree) -> str:
    from repro_torch.tree import paths

    h = hashlib.sha256()
    for p, t in paths(tree):
        h.update("/".join(p).encode())
        h.update(t.detach().contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _same_on_every_rank(value: str) -> bool:
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, value)
    return len(set(out)) == 1


def _raises(fn, exc, text: str) -> str:
    try:
        fn()
    except exc as e:
        if text not in str(e):
            raise AssertionError(f"{type(e).__name__} without {text!r}: "
                                 f"{e}")
        return f"{type(e).__name__}: {str(e)[:80]}"
    raise AssertionError(f"expected {exc.__name__}, nothing raised")


def rank_main(rank: int, world: int, path: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(path, "store"), world),
        rank=rank, world_size=world, timeout=datetime.timedelta(seconds=120))
    results = {}

    def check(name, fn):
        try:
            results[name] = ["ok", str(fn())]
        except Exception:  # noqa: BLE001 — every failure is a result
            results[name] = ["fail", traceback.format_exc()[-3000:]]

    for name, fn in _checks(rank, world, path):
        check(name, fn)
    with open(os.path.join(path, f"rank{rank}.json"), "w") as f:
        json.dump(results, f)
    dist.barrier()
    dist.destroy_process_group()


def _checks(rank: int, world: int, path: str):
    from repro_torch.core import attacks as atk
    from repro_torch.core.estimator import Estimator
    from repro_torch.dist import robust_reduce as RR
    from repro_torch.tree import leaves as _leaves, tree_map

    G = dist.group.WORLD
    W = world
    full = _tree(np.random.default_rng(SEED), W)
    mine = _rows(full, rank, rank + 1)

    def wire(method, kw):
        def fn():
            if method == "trimmed_mean":
                kw["beta"] = 1.0 / W
            est = Estimator(method, **kw)
            got = RR.aggregate_stacked_rrs(mine, G, est)
            want = RR.aggregate_stacked_auto(full, est)
            assert _equal(got, want), "the wire differs from the stack"
            assert _same_on_every_rank(_digest(got))
            return "bitwise"
        return fn

    for name, (method, kw) in WIRE_ESTIMATORS.items():
        yield f"wire[{name}]", wire(method, dict(kw))

    def mean_ref():
        # torch.mean's reduction order follows the stack's layout, so the
        # slice and the leaf sum alike only to f32 rounding
        got = RR.aggregate_stacked_rrs(mine, G, "mean")
        want = RR.aggregate_stacked_auto(full, "mean")
        for x, y in zip(_leaves(got), _leaves(want)):
            torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-6)
        return "f32 rounding"

    yield "wire[mean_ref]", mean_ref

    def wire_29():
        rng = np.random.default_rng(SEED + 1)
        t = {"w": torch.from_numpy(rng.standard_normal((W, 4, 6), np.float32)
                                   ).to(torch.bfloat16),
             "b": torch.from_numpy(rng.standard_normal((W, 5), np.float32))}
        got = RR.aggregate_stacked_rrs(_rows(t, rank, rank + 1), G, "vrmom")
        assert _equal(got, RR.aggregate_stacked_auto(t, "vrmom"))
        return "29 coordinates padded to a multiple of the world size"

    yield "wire[29_coordinates]", wire_29

    def two_rows_a_rank():
        t = _tree(np.random.default_rng(SEED + 2), 2 * W)
        got = RR.aggregate_stacked_rrs(_rows(t, 2 * rank, 2 * rank + 2), G,
                                       "vrmom")
        assert _equal(got, RR.aggregate_stacked_auto(t, "vrmom"))
        return f"W = {2 * W}, two rows a rank"

    yield "wire[two_rows_a_rank]", two_rows_a_rank

    def diag():
        got, d = RR.aggregate_stacked_rrs(mine, G, "vrmom", with_diag=True)
        want, e = RR.aggregate_stacked_auto(full, "vrmom", with_diag=True)
        assert _equal(got, want)
        assert torch.equal(d.suspected, e.suspected)
        for f in ("scores", "alpha_hat", "pre_norms", "post_norm"):
            torch.testing.assert_close(getattr(d, f), getattr(e, f),
                                       rtol=1e-6, atol=1e-6)
        return "aggregate bitwise, moments at 1e-6"

    yield "diag", diag

    mask = torch.arange(W) >= W - 1

    def attack(name):
        def fn():
            a = atk.get(name)
            got = RR.aggregate_stacked_rrs(
                mine, G, "vrmom", attack=lambda v: a(None, v, mask))
            hit = tree_map(lambda g: a(None, g, mask), full)
            assert _equal(got, RR.aggregate_stacked_auto(hit, "vrmom"))
            return "the slice's attack equals the stack's"
        return fn

    for name in atk.COORDINATEWISE:
        yield f"attack[{name}]", attack(name)

    yield from _refusals(world)
    if W == 8:
        yield from _consensus_checks(rank, world, path)
    yield "robust_dot", lambda: _robust_dot(rank, world)
    if W == 4:
        for mode in ("stacked-rrs", "inloop"):
            yield f"train[{mode}]", lambda m=mode: _train(rank, world, m)
        yield "train[inloop_sums]", lambda: _inloop_sums(rank, world)

    def rl201():
        from repro_torch.lint.auditor import _check_rrs_wire

        (r,) = _check_rrs_wire(torch.device("cpu"))
        assert r.status == "ok", r.render()
        return r.detail

    yield "rl201", rl201

    def to_named():
        from torch.distributed.tensor import (Replicate, Shard,
                                              distribute_tensor)

        from repro_torch.configs import get
        from repro_torch.convert import expected_shapes
        from repro_torch.dist import sharding as S
        from repro_torch.launch.mesh import device_mesh, make_host_mesh

        mesh = device_mesh(make_host_mesh(W // 2, 2), "cpu")
        shapes = expected_shapes(get("qwen3-1.7b").reduced())
        named = S.to_named(mesh, S.param_specs(shapes, mesh))
        wq = named["layers"]["attn"]["wq"]
        assert wq.placements == (Shard(1), Shard(2)), wq.placements
        assert named["norm_f"].placements == (Replicate(), Replicate())
        t = distribute_tensor(torch.zeros(shapes["layers"]["attn"]["wq"]),
                              wq.mesh, wq.placements)
        return f"wq local {tuple(t.to_local().shape)}"

    yield "to_named", to_named

    if W == 4:
        yield "port_rrs_saved", lambda: _save_port_rrs(path)
        yield from _coverage_checks(rank, world, path)


def _coverage_checks(rank: int, world: int, path: str):
    """``coverage_run(group=)``: the gathered cell against this rank's
    one-process slice (seeded ``rank_seed``) and the same on every rank,
    under the three kinds of cell; the refusals before any collective; a
    one-rank group; rank 0 saves the small-rep cell for ``repro``."""
    from repro_torch.dist.consensus import ConsensusConfig
    from repro_torch.dist.faults import FaultPlan
    from repro_torch.infer import coverage_run
    from repro_torch.infer.coverage import rank_seed
    from repro_torch.launch.op_cost import counting

    G = dist.group.WORLD

    def kw(case):
        out = dict(COV_REDUCED, device="cpu", **COV_CASES[case])
        if case == "consensus_dropout":
            out.update(consensus=ConsensusConfig(f=2),
                       fault_plan=FaultPlan(dropout=0.1))
        return out

    def cell_digest(cell) -> str:
        return hashlib.sha256(b"".join(
            t.contiguous().view(torch.uint8).numpy().tobytes()
            for t in cell)).hexdigest()

    def split(case):
        def fn():
            a = kw(case)
            got = coverage_run(group=G, **a)
            n = a["reps"] // world
            mine = coverage_run(**dict(a, reps=n,
                                       seed=rank_seed(a["seed"], rank)))
            assert got.covered.shape == (a["reps"], a["p"])
            for x, y in zip(got, mine):
                assert x.dtype == y.dtype and torch.equal(
                    x[rank * n:(rank + 1) * n], y), "a slice differs"
            assert _same_on_every_rank(cell_digest(got)), \
                "the ranks' cells differ"
            return f"rows {rank * n}-{(rank + 1) * n - 1} = the slice"
        return fn

    for case in COV_CASES:
        yield f"coverage[{case}]", split(case)

    def refused(args, exc_text):
        """The refusal's text and the collectives counted before it."""
        with counting("cpu") as oc:
            detail = _raises(lambda: coverage_run(group=G, **args),
                             ValueError, exc_text)
        return detail, dict(oc.cost.coll)

    def not_divisible():
        detail, coll = refused(dict(kw("direct"), reps=9), "not divisible")
        assert coll == {}, f"a collective ran first: {coll}"
        return detail

    yield "coverage[not_divisible]", not_divisible

    def devices_differ():
        dev = "cpu" if rank == 0 else "meta"
        detail, coll = refused(dict(kw("direct"), device=dev),
                               "one kind of device")
        assert set(coll) == {"all-gather"}, coll   # the kinds' gather alone
        return detail

    yield "coverage[devices_differ]", devices_differ

    def one_rank_group():
        groups = [dist.new_group([r]) for r in range(world)]
        got = coverage_run(group=groups[rank], **kw("direct"))
        want = coverage_run(**kw("direct"))
        assert all(torch.equal(x, y) for x, y in zip(got, want))
        return "= group=None"

    yield "coverage[one_rank_group]", one_rank_group

    def small_rep_saved():
        cell = coverage_run(group=G, device="cpu", **COV_SMALL_REP)
        if rank == 0:
            np.savez(os.path.join(path, "port_coverage.npz"),
                     **{k: getattr(cell, k).numpy() for k in cell._fields})
        return str(cell.summary()["coverage"])

    yield "coverage[small_rep_saved]", small_rep_saved


def _refusals(world: int):
    from repro_torch.configs import get
    from repro_torch.core.estimator import Estimator
    from repro_torch.dist import robust_reduce as RR
    from repro_torch.dist.consensus import (ConsensusConfig,
                                            aggregate_stacked_consensus)
    from repro_torch.train.step import make_train_step

    G = dist.group.WORLD
    cfg = get("qwen3-1.7b").reduced()
    R = RR.GroupRefusal

    def mk(**kw):
        args = dict(device="cpu", group=G)
        args.update(kw)
        n = args.pop("n", world)
        return lambda: make_train_step(cfg, n, **args)

    cases = {
        "whole_vector_estimator": (lambda: RR.aggregate_stacked_rrs(
            {"w": torch.zeros(1, 8)}, G, "geometric_median"),
            ValueError, "whole-vector"),
        "workers_not_divided": (mk(n=world + 1), R, "must divide"),
        "robust_backward_not_divided": (
            lambda: RR.robust_backward(world + 1, "vrmom", G).__enter__(),
            R, "must divide"),
        "mode_stacked_auto": (mk(mode="stacked-auto"), R, "stacked-auto"),
        "mode_mean": (mk(mode="mean"), R, "'mean'"),
        "adaptive": (mk(estimator=Estimator("vrmom_adaptive")), R,
                     "census"),
        "consensus_two_rows_a_rank": (
            mk(n=2 * world, reduce_backend="consensus"), R, "fully sharded"),
        "consensus_wire_two_rows": (lambda: aggregate_stacked_consensus(
            {"w": torch.zeros(2, 8)}, G, config=ConsensusConfig(f=0)), R,
            "fully sharded"),
        "consensus_n_le_5f": (
            mk(reduce_backend="consensus",
               consensus=ConsensusConfig(f=(world - 1) // 5 + 1)),
            ValueError, "n > 5f"),
        "consensus_inloop": (mk(mode="inloop", reduce_backend="consensus"),
                             R, "needs the materialized"),
        "aggregate_stacked_auto": (lambda: RR.aggregate(
            {"w": torch.zeros(1, 8)}, mode="stacked-auto", group=G), R,
            "stacked-auto"),
    }
    for name in ("mimic", "bitflip", "gaussian"):
        cases[f"attack_{name}"] = (mk(byzantine_frac=0.5, attack=name), R,
                                   name)
    for name, (fn, exc, text) in cases.items():
        yield f"refuse[{name}]", lambda f=fn, e=exc, t=text: _raises(f, e, t)


def _aux_values(aux) -> list:
    return [getattr(aux, f).tolist() for f in aux._fields]


def _consensus_checks(rank: int, world: int, path: str):
    """The consensus wire over the ranks (f = 1): every plan and trim bit
    for bit against the port's emulation on the gathered stack with the
    same draws (values and the six aux fields), with its ``all_gather``
    calls counted a block; fault-free it equals the RRS wire; ``with_diag``
    against the one-process ``aggregate``; its output on ``repro``'s arrays
    and uniforms saved; the consensus train step over the group against
    one process's."""
    from repro_torch.core import attacks as atk
    from repro_torch.dist import consensus as CS
    from repro_torch.dist import robust_reduce as RR
    from repro_torch.dist.faults import FaultPlan
    from repro_torch.tree import leaves as _leaves, tree_map, unflatten

    G = dist.group.WORLD
    W = world
    full = _tree(np.random.default_rng(SEED + 4), W)
    mine = _rows(full, rank, rank + 1)
    mask = torch.arange(W) >= W - 1
    omni = atk.get("omniscient")
    C = sum(g[0].numel() for g in _leaves(full))

    def raveled(tree):
        return torch.cat([g.reshape(W, -1).float() for g in _leaves(tree)],
                         dim=1)

    def as_tree(flat):
        outs, off = [], 0
        for g in _leaves(full):
            n = g[0].numel()
            outs.append(flat[off:off + n].reshape(g.shape[1:]).to(g.dtype))
            off += n
        return unflatten(full, outs)

    def draws_for(p_end):
        rng = np.random.default_rng(SEED + 5)
        return torch.from_numpy(rng.random((p_end, W, W), dtype=np.float32))

    def counted(fn):
        calls, real = [], RR.all_gather_into

        def counting(out, x, group):
            calls.append(x.numel())
            return real(out, x, group)

        chunk, RR.WIRE_CHUNK = RR.WIRE_CHUNK, CONS_CHUNK
        RR.all_gather_into = counting
        try:
            return fn(), calls
        finally:
            RR.all_gather_into, RR.WIRE_CHUNK = real, chunk

    def wire(trim, name):
        def fn():
            cfg = CS.ConsensusConfig(f=1, trim=trim)
            plan = FaultPlan(**CONS_PLANS[name])
            p_end = cfg.phases(plan)
            draws = draws_for(p_end)
            pinned = name == "pinned_omniscient"
            pin = mask if pinned else None
            (got, aux), calls = counted(
                lambda: CS.aggregate_stacked_consensus(
                    mine, G, "vrmom", config=cfg, plan=plan, draws=draws,
                    pin_mask=pin, attack=(lambda v: omni(None, v, mask))
                    if pinned else None))
            stack = (tree_map(lambda g: omni(None, g, mask), full) if pinned
                     else full)
            want, waux = CS.consensus_aggregate(
                raveled(stack), "vrmom", config=cfg, plan=plan, draws=draws,
                pin_mask=pin)
            assert _equal(got, as_tree(want)), \
                "the wire differs from the emulation"
            for f in aux._fields:
                a, b = getattr(aux, f), getattr(waux, f)
                assert a.dtype == b.dtype and torch.equal(a, b), (f, a, b)
            assert _same_on_every_rank(_digest(got) + str(_aux_values(aux)))
            blocks = -(-C // CONS_CHUNK)
            if pinned:     # the attack's gather is round 0's exchange
                want_calls = 1 + blocks * p_end
            elif plan.trivial and trim == "mean":
                want_calls = blocks             # settled after round 0
            else:
                want_calls = blocks * (p_end + 1)
            assert len(calls) == want_calls, (len(calls), want_calls)
            return (f"bitwise, aux equal; {len(calls)} all_gathers over "
                    f"{blocks} blocks, p_end {p_end}")
        return fn

    for trim in CONS_TRIMS:
        for name in CONS_PLANS:
            yield f"consensus[{trim}_{name}]", wire(trim, name)

    def equals_rrs():
        got, _ = CS.aggregate_stacked_consensus(
            mine, G, "vrmom", config=CS.ConsensusConfig(f=1))
        assert _equal(got, RR.aggregate_stacked_rrs(mine, G, "vrmom"))
        return "fault-free consensus = the RRS wire, bitwise"

    yield "consensus[fault_free_equals_rrs]", equals_rrs

    def diag():
        cfg = CS.ConsensusConfig(f=1)
        plan = FaultPlan(**CONS_PLANS["dropout_crash"])
        draws = draws_for(cfg.phases(plan))
        got, aux, d = RR.aggregate(
            mine, mode="stacked-consensus", est="vrmom", with_diag=True,
            consensus=cfg, plan=plan, draws=draws, pin_mask=mask, group=G,
            attack=lambda v: omni(None, v, mask))
        want, waux, e = RR.aggregate(
            tree_map(lambda g: omni(None, g, mask), full),
            mode="stacked-consensus", est="vrmom", with_diag=True,
            consensus=cfg, plan=plan, draws=draws, pin_mask=mask)
        assert _equal(got, want), "the wire differs from one process"
        assert _aux_values(aux) == _aux_values(waux)
        assert torch.equal(d.suspected, e.suspected)
        for f in ("scores", "alpha_hat", "pre_norms", "post_norm"):
            torch.testing.assert_close(getattr(d, f), getattr(e, f),
                                       rtol=1e-6, atol=1e-6)
        return "aggregate and aux bitwise, moments at 1e-6"

    yield "consensus[diag]", diag

    def repro_saved():
        data = np.load(os.path.join(path, "consensus_input.npz"))
        t = {k: torch.from_numpy(data[k][rank:rank + 1]) for k in ("w", "b")}
        plan = FaultPlan(dropout=0.2, n_crashed=1, crash_round=1)
        out = {}
        for trim in CONS_TRIMS:
            got, aux = CS.aggregate_stacked_consensus(
                t, G, "vrmom", config=CS.ConsensusConfig(f=1, trim=trim),
                plan=plan, draws=torch.from_numpy(data["draws"]))
            for k in ("w", "b"):
                out[f"{trim}/{k}"] = got[k].numpy()
            for f in aux._fields:
                out[f"{trim}/{f}"] = getattr(aux, f).numpy()
        if rank == 0:
            np.savez(os.path.join(path, "port_consensus.npz"), **out)
        return "saved"

    yield "consensus[repro_saved]", repro_saved

    runs = {}

    def train_runs():
        for name, steps, _ in CONS_TRAIN:
            runs[name] = _consensus_train(name, steps, G)
            for params, _, _ in runs[name]:
                h = hashlib.sha256(b"".join(t.numpy().tobytes() for t in
                                            params.values())).hexdigest()
                assert _same_on_every_rank(h), (name, "params differ")
        return "params identical on every rank after each step"

    yield "train[consensus_runs]", train_runs

    def train_vs_one_process(name, steps, holder):
        if rank != holder:
            return f"held on rank {holder}"
        want = _consensus_train(name, steps, None)
        for s, ((gp, gl, ga), (wp, wl, wa)) in enumerate(zip(runs[name],
                                                             want)):
            for k in gp:
                assert torch.equal(gp[k], wp[k]), \
                    (s, k, float((gp[k] - wp[k]).abs().max()))
            assert gl == wl, (s, gl, wl)
            assert ga == wa, (s, ga, wa)
        return f"{steps} step(s) bitwise: params, loss, aux {wa}"

    for name, steps, holder in CONS_TRAIN:
        yield (f"train[consensus_{name}]",
               lambda a=(name, steps, holder): train_vs_one_process(*a))


def _consensus_train(attack: str, steps: int, group):
    """``steps`` consensus train steps (reduced qwen3, 8 workers, one
    Byzantine under ``attack``, dropout 0.1, AdamW) over ``group`` or in
    one process, from one seed: [(params, loss, aux values)] a step."""
    from repro_torch import optim as O
    from repro_torch.configs import get
    from repro_torch.data import lm_batch
    from repro_torch.dist.consensus import ConsensusConfig
    from repro_torch.dist.faults import FaultPlan
    from repro_torch.models import model as M
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import paths

    cfg = get("qwen3-1.7b").reduced()
    params = M.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    opt = O.get("adamw", lr=1e-2)
    st = make_train_step(
        cfg, 8, estimator="vrmom", optimizer=opt, byzantine_frac=0.15,
        attack=attack, reduce_backend="consensus",
        consensus=ConsensusConfig(f=1, max_rounds=CONS_TRAIN_ROUNDS),
        fault_plan=FaultPlan(dropout=0.1), device="cpu", group=group)
    state = opt.init(params)
    gen = torch.Generator().manual_seed(SEED + 6)
    out = []
    for i in range(steps):
        b = lm_batch(cfg, i, 8, TRAIN_SEQ, device="cpu")
        params, state, loss, caux = st.step_fn(params, state, b, gen)
        out.append(({"/".join(p): t.clone() for p, t in paths(params)},
                    float(loss), _aux_values(caux)))
    return out


def _robust_dot(rank: int, world: int) -> str:
    """One product's ``dW`` over the group equals the one-process
    ``_RobustDot`` on the same workers' rows, bit for bit."""
    from repro_torch.dist import robust_reduce as RR

    rng = np.random.default_rng(SEED + 3)
    x = torch.from_numpy(rng.standard_normal((world * 2, 5, 12), np.float32))
    dy = torch.from_numpy(rng.standard_normal((world * 2, 5, 9), np.float32))
    w0 = torch.from_numpy(rng.standard_normal((12, 9), np.float32))

    def dw(xs, dys, group):
        w = w0.clone().requires_grad_(True)
        with RR.robust_backward(world, "vrmom", group):
            y = RR.robust_dot(xs, w)
        y.backward(dys)
        return w.grad

    want = dw(x, dy, None)
    got = dw(x[2 * rank:2 * rank + 2], dy[2 * rank:2 * rank + 2],
             dist.group.WORLD)
    total = got.clone()
    dist.all_reduce(total)        # rank 0 carries it, the rest zeros
    assert torch.equal(total, want), float((total - want).abs().max())
    assert rank == 0 or not torch.any(got)
    return "bitwise (rank 0 carries the aggregate)"


def _train(rank: int, world: int, mode: str) -> str:
    """Two steps of the group's train step against the one-process step on
    the same batches (reduced qwen3, signflip on the last rank's worker),
    the one-process step on rank 0; params identical on every rank."""
    from repro_torch import optim as O
    from repro_torch.configs import get
    from repro_torch.data import lm_batch
    from repro_torch.models import model as M
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import paths

    cfg = get("qwen3-1.7b").reduced()
    opt_name = "adamw" if mode == "stacked-rrs" else "sgd"

    def run(group):
        params = M.init(cfg, torch.Generator().manual_seed(0), device="cpu")
        opt = O.get(opt_name, lr=1e-2)
        st = make_train_step(cfg, world, estimator="vrmom", mode=mode,
                             optimizer=opt, byzantine_frac=1.5 / (world - 1),
                             attack="signflip", device="cpu", group=group)
        state = opt.init(params)
        out = []
        for i in range(2):
            b = lm_batch(cfg, i, world, TRAIN_SEQ, device="cpu")
            params, state, loss = st.step_fn(params, state, b)
            out.append(({"/".join(p): t.clone() for p, t in paths(params)},
                        float(loss)))
        return out

    got = run(dist.group.WORLD)
    for params, _ in got:
        h = hashlib.sha256(b"".join(t.numpy().tobytes() for t in
                                    params.values())).hexdigest()
        assert _same_on_every_rank(h), "params differ across the ranks"
    if rank:
        return "params as rank 0's"
    want = run(None)
    worst = {}
    for s, ((gp, gl), (wp, wl)) in enumerate(zip(got, want)):
        for k in gp:
            d = float((gp[k] - wp[k]).abs().max())
            worst[k] = max(worst.get(k, 0.0), d)
            if mode == "stacked-rrs" or (s == 0 and k in WIRE_LEAVES):
                assert d == 0.0, (s, k, d)
            else:
                assert d <= INLOOP_TOL, (s, k, d)
        if mode == "stacked-rrs":
            assert gl == wl, (s, gl, wl)
        else:
            assert abs(gl - wl) <= 1e-5, (s, gl, wl)
    return json.dumps({k: v for k, v in worst.items() if v})


def _inloop_sums(rank: int, world: int) -> str:
    """One inloop step over the group, each layer checkpointed (``remat``):
    the ``all_reduce`` after the backward sums only the leaves whose
    gradients are not wholly wire products (every product's ``dW`` is
    already the aggregate on every rank), the params are the same on every
    rank, and they match the one-process step as ``_train``'s step 1."""
    import dataclasses

    from repro_torch import optim as O
    from repro_torch.configs import get
    from repro_torch.data import lm_batch
    from repro_torch.models import model as M
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import paths

    cfg = dataclasses.replace(get("qwen3-1.7b").reduced(), remat=True)
    batch = lm_batch(cfg, 0, world, TRAIN_SEQ, device="cpu")

    def run(group):
        params = M.init(cfg, torch.Generator().manual_seed(0), device="cpu")
        opt = O.get("sgd", lr=1e-2)
        st = make_train_step(cfg, world, estimator="vrmom", mode="inloop",
                             optimizer=opt, byzantine_frac=1.5 / (world - 1),
                             attack="signflip", device="cpu", group=group)
        params, _, _ = st.step_fn(params, opt.init(params), batch)
        return {"/".join(p): t for p, t in paths(params)}

    summed, real = [], dist.all_reduce

    def counting(t, *a, **k):
        summed.append(t.numel())
        return real(t, *a, **k)

    dist.all_reduce = counting
    try:
        got = run(dist.group.WORLD)
    finally:
        dist.all_reduce = real
    off = [k for k in got if k not in WIRE_LEAVES]
    assert cfg.tie_embeddings and "embed" in off   # lookup and unembedding
    assert sorted(summed) == sorted(got[k].numel() for k in off), \
        (summed, off)
    h = hashlib.sha256(b"".join(t.numpy().tobytes() for t in
                                got.values())).hexdigest()
    assert _same_on_every_rank(h), "params differ across the ranks"
    if rank:
        return "params as rank 0's"
    want = run(None)
    for k in got:
        d = float((got[k] - want[k]).abs().max())
        assert d == 0.0 if k in WIRE_LEAVES else d <= INLOOP_TOL, (k, d)
    return f"summed {len(off)} of {len(got)} leaves, {sum(summed)} elements"


def _save_port_rrs(path: str) -> str:
    """The wire's output on ``repro``'s RRS test arrays (vrmom, f32) from
    ``rrs_input.npz``; rank 0 writes ``port_rrs.npz``."""
    from repro_torch.dist import robust_reduce as RR

    rank = dist.get_rank()
    data = np.load(os.path.join(path, "rrs_input.npz"))
    t = {"a": {"w_gate": torch.from_numpy(data["w_gate"][rank:rank + 1])},
         "b": torch.from_numpy(data["b"][rank:rank + 1])}
    out = RR.aggregate_stacked_rrs(t, dist.group.WORLD, "vrmom")
    if rank == 0:
        np.savez(os.path.join(path, "port_rrs.npz"),
                 w_gate=out["a"]["w_gate"].numpy(), b=out["b"].numpy())
    return "saved"
