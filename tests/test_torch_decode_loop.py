"""repro_torch's decode loop: per-row device positions and the one-step
``generate`` against ``repro``.

``repro``'s seeded params go through ``convert.params_from_jax``. Caches
whose rows sit at different fill levels (``vectorize_pos``, then per-row
positions) are decoded teacher-forced on both sides, on a linear cache and
on a sliding-window ring that wraps, in f32, bf16 and int8 kv, at the
tolerances of ``tests/test_torch_models.py``: 1e-4 on f32 logits and
caches (sums in another order), one bf16 ulp (2^-8 relative) on a bf16
cache, one int8 step on an int8 cache, 2e-3 on logits read from a
quantized cache. Exact (bitwise) where both sides are the port: a [B]
``pos`` of equal rows against a scalar one, the hoisted rotary tables
against the per-layer formula, and ``generate`` (the step ``generate``
replays on the card, run eagerly on the CPU) against
``generate_python_loop``. Greedy tokens equal ``repro``'s scanned
``generate`` exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as j_get_arch
from repro.models import attention as JA
from repro.models import model as JM
from repro.serve import RobustDecodeConfig as JRobust
from repro.serve import ServeEngine as JEngine
from repro.serve import cache as JC
from repro_torch.configs import get as t_get_arch
from repro_torch.convert import params_from_jax
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT
from repro_torch.serve import RobustDecodeConfig, Sampling, ServeEngine
from repro_torch.serve import cache as TC
from repro_torch.serve import robust as TR

torch.set_num_threads(1)

# (port attention backend, JAX attention backend)
BACKENDS = [("torch", "jnp"), ("flash", "flash")]
KV_DTYPES = [None, "bfloat16", "int8"]
B, S, N_NEW, MAX_LEN = 2, 12, 10, 40
_j_prefill = jax.jit(JM.prefill, static_argnums=1,
                     static_argnames=("window", "cache_len", "last_only"))
_j_decode = jax.jit(JM.decode_step, static_argnums=1,
                    static_argnames=("window",))


@pytest.fixture(scope="module")
def models():
    jcfg = j_get_arch("qwen3-1.7b").reduced()
    tcfg = t_get_arch("qwen3-1.7b").reduced()
    jp = JM.init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    prompts = np.random.RandomState(1).randint(0, jcfg.vocab, size=(B, S))
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp, prompts=prompts,
                repro={})


def _close(got, want, tol=1e-4):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _tokens(S, seed):
    return np.random.RandomState(seed).randint(0, 512, size=(B, S))


# -- per-row positions against repro's vectorize_pos path --------------------

# (cache kind, prompt length, window, per-row start positions, steps): the
# linear cache holds 20 slots; the ring's 8 slots wrap for both rows (row 0
# from 5 past 8 during the steps, row 1 already at 10)
CACHES = {"linear": (10, None, (7, 10), 6), "ring": (10, 8, (5, 10), 6)}


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
@pytest.mark.parametrize("kind", sorted(CACHES))
@pytest.mark.parametrize("backend", BACKENDS, ids=["torch", "flash"])
def test_per_row_decode_matches_repro(models, backend, kind, kv_dtype):
    """Rows at different fill levels: each writes its own slot and masks to
    its own length, on both sides; logits every step and the caches and
    positions after the last."""
    plen, window, starts, steps = CACHES[kind]
    jcfg = dataclasses.replace(models["jcfg"], attn_backend=backend[1],
                               kv_dtype=kv_dtype)
    tcfg = dataclasses.replace(models["tcfg"], attn_backend=backend[0],
                               kv_dtype=kv_dtype)
    jp, tp = models["jp"], models["tp"]
    toks, feed = _tokens(plen, 2), _tokens(steps, 3)
    kw = dict(window=window) if window else dict(cache_len=20)
    _, jc = _j_prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, **kw)
    _, tc = TM.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)}, **kw)
    jc = JC.vectorize_pos(jc, B)
    jc = jc._replace(pos=jnp.broadcast_to(jnp.asarray(starts, jnp.int32),
                                          jc.pos.shape))
    tc = TC.vectorize_pos(tc, B)
    assert tc.pos.dtype == torch.int32 and tc.pos.tolist() == [plen] * B
    tc = tc._replace(pos=torch.tensor(starts, dtype=torch.int32))
    dkw = dict(window=window) if window else {}
    tol = 1e-4 if kv_dtype is None else 2e-3
    for s in range(steps):
        jl, jc = _j_decode(jp, jcfg, jc, jnp.asarray(feed[:, s], jnp.int32),
                           **dkw)
        tl, tc = TM.decode_step(tp, tcfg, tc, torch.from_numpy(feed[:, s]),
                                **dkw)
        _close(tl, jl, tol)
    want = [p + steps for p in starts]
    assert tc.pos.tolist() == want
    assert np.asarray(jc.pos).tolist() == [want] * jcfg.n_layers
    if kv_dtype == "int8":
        for a, b in ((tc.k, jc.k), (tc.v, jc.v)):
            diff = np.abs(a.numpy().astype(np.int32)
                          - np.asarray(b).astype(np.int32))
            assert diff.max() <= 1 and diff.mean() < 1e-3
        _close(tc.k_scale, jc.k_scale, 1e-5)
        _close(tc.v_scale, jc.v_scale, 1e-5)
    elif kv_dtype == "bfloat16":
        _close(tc.k.float(), np.asarray(jc.k).astype(np.float32), 2 ** -8)
        _close(tc.v.float(), np.asarray(jc.v).astype(np.float32), 2 ** -8)
    else:
        _close(tc.k, jc.k)
        _close(tc.v, jc.v)


@pytest.mark.parametrize("pos", ["rows", "scalar"])
@pytest.mark.parametrize("kv_dtype", [None, "int8"])
@pytest.mark.parametrize("kind", sorted(CACHES))
def test_attn_decode_matches_repro(models, kind, kv_dtype, pos):
    """One layer's ``attn_decode`` on both sides, from the same layer-0
    cache: rows at their own positions (or one scalar position) write
    their own slots, attend to their own lengths and advance by one."""
    plen, window, starts, steps = CACHES[kind]
    jcfg = dataclasses.replace(models["jcfg"], attn_backend="jnp",
                               kv_dtype=kv_dtype)
    tcfg = dataclasses.replace(models["tcfg"], attn_backend="torch",
                               kv_dtype=kv_dtype)
    toks = _tokens(plen, 6)
    kw = dict(window=window) if window else dict(cache_len=20)
    _, jc = _j_prefill(models["jp"], jcfg, {"tokens": jnp.asarray(toks)},
                       **kw)
    _, tc = TM.prefill(models["tp"], tcfg, {"tokens": torch.from_numpy(toks)},
                       **kw)
    jc = jax.tree.map(lambda x: x[0], jc)
    tc = TA.KVCache(*(None if x is None else x[0] for x in tc[:2]),
                    tc.pos, *(None if x is None else x[0] for x in tc[3:]))
    if pos == "rows":
        jc = JC.vectorize_pos(jc, B)._replace(
            pos=jnp.asarray(starts, jnp.int32))
        tc = tc._replace(pos=torch.tensor(starts, dtype=torch.int32))
    else:
        jc = jc._replace(pos=jnp.asarray(starts[1], jnp.int32))
        tc = tc._replace(pos=starts[1])
    jlp = jax.tree.map(lambda x: x[0], models["jp"]["layers"]["attn"])
    tlp = TT.unbind_layers(models["tp"]["layers"], tcfg.n_layers)[0]["attn"]
    x1 = np.random.RandomState(8).randn(steps, B, 1, tcfg.d_model
                                        ).astype(np.float32)
    dkw = dict(window=window) if window else {}
    for s in range(steps):
        jo, jc = JA.attn_decode(jlp, jnp.asarray(x1[s]), jcfg, jc, **dkw)
        to, tc = TA.attn_decode(tlp, torch.from_numpy(x1[s]), tcfg, tc,
                                **dkw)
        _close(to, jo, 1e-4 if kv_dtype is None else 2e-3)
    want = ([p + steps for p in starts] if pos == "rows"
            else [starts[1] + steps] * B)
    assert tc.pos.dtype == torch.int32 and tc.pos.tolist() == want
    np.testing.assert_array_equal(np.broadcast_to(np.asarray(jc.pos), (B,)),
                                  want)
    if kv_dtype == "int8":
        for a, b in ((tc.k, jc.k), (tc.v, jc.v)):
            diff = np.abs(a.numpy().astype(np.int32)
                          - np.asarray(b).astype(np.int32))
            assert diff.max() <= 1 and diff.mean() < 1e-3
        _close(tc.k_scale, jc.k_scale, 1e-5)
    else:
        _close(tc.k, jc.k)
        _close(tc.v, jc.v)


@pytest.mark.parametrize("scalar", ["int", "0-d"])
@pytest.mark.parametrize("backend", ["torch", "flash"])
def test_uniform_row_pos_equals_scalar_pos(models, backend, scalar):
    """A [B] pos whose rows are equal gives the logits, caches and next
    positions of a scalar pos, bitwise."""
    tcfg = dataclasses.replace(models["tcfg"], attn_backend=backend)
    tp = models["tp"]
    toks, feed = _tokens(9, 4), _tokens(3, 5)
    _, base = TM.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)},
                         cache_len=16)
    runs = {}
    for what, pos in (("rows", torch.full((B,), 9, dtype=torch.int32)),
                      ("int", 9),
                      ("0-d", torch.tensor(9, dtype=torch.int32))):
        c = base._replace(k=base.k.clone(), v=base.v.clone(), pos=pos)
        logits = []
        for s in range(feed.shape[1]):
            lg, c = TM.decode_step(tp, tcfg, c, torch.from_numpy(feed[:, s]))
            logits.append(lg)
        runs[what] = (torch.stack(logits), c)
    (lr, cr), (ls, cs) = runs["rows"], runs[scalar]
    assert torch.equal(lr, ls)
    assert torch.equal(cr.k, cs.k) and torch.equal(cr.v, cs.v)
    assert torch.equal(cr.pos, cs.pos) and cs.pos.tolist() == [12] * B


def _rope_per_layer(x, positions, theta):
    """The rotary embedding as every layer computed it before the tables
    were hoisted (one layer's q or k at a time)."""
    dh = x.shape[-1]
    half = dh // 2
    exponent = torch.arange(half, dtype=torch.float32, device=x.device) / half
    freqs = 1.0 / (theta ** exponent)
    ang = positions.float()[..., None] * freqs
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hoisted_rotary_tables_bitwise(models, dtype):
    """One set of tables for q and k of every layer gives the bits of the
    per-layer formula, at decode positions [B, 1] and prefill [B, S]."""
    tcfg = models["tcfg"]
    rs = np.random.RandomState(7)
    for positions in (torch.tensor([[5], [17]]),
                      torch.arange(S)[None].expand(B, S)):
        rot = TA.rotary(tcfg, positions)
        n = positions.shape[1]
        for H in (tcfg.n_heads, tcfg.n_kv_heads):
            x = torch.from_numpy(rs.randn(B, n, H, tcfg.head_dim)).to(dtype)
            want = _rope_per_layer(x, positions, tcfg.rope_theta)
            assert torch.equal(TL.apply_rope(x, *rot), want)
            assert torch.equal(TL.rope(x, positions, tcfg.rope_theta), want)
    pos = torch.tensor([3, 11], dtype=torch.int32)
    at = TA.decode_at(tcfg, pos, 20, None)
    assert all(torch.equal(a, b) for a, b in
               zip(at.rot, TL.rope_tables(pos.long()[:, None],
                                          tcfg.head_dim, tcfg.rope_theta)))


def test_decode_at_slots_and_lengths(models):
    """Slots and valid lengths per row: a linear cache clamps to its last
    slot, a ring wraps at T and is whole from T on."""
    tcfg = models["tcfg"]
    pos = torch.tensor([0, 5, 7, 8, 13], dtype=torch.int32)
    lin = TA.decode_at(tcfg, pos, 8, None)
    assert lin.index.tolist() == [0, 8 + 5, 16 + 7, 24 + 7, 32 + 7]
    assert lin.kv_len.dtype == torch.int32
    assert lin.kv_len.tolist() == [1, 6, 8, 9, 14]
    ring = TA.decode_at(tcfg, pos, 8, 8)
    assert ring.index.tolist() == [0, 8 + 5, 16 + 7, 24 + 0, 32 + 5]
    assert ring.kv_len.tolist() == [1, 6, 8, 8, 8]


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_replica_flatten_round_trips_pos(models, kv_dtype):
    """``stack_replicas`` tiles a per-row pos to [m, B], ``flatten`` to
    [m * B] replica-major (each flat row keeps its sequence's length) and
    ``unflatten`` cuts it back; a scalar pos broadcasts first."""
    tcfg = dataclasses.replace(models["tcfg"], kv_dtype=kv_dtype)
    caches = TM.init_cache(tcfg, B, 6, device="cpu")
    caches = caches._replace(pos=torch.tensor([3, 7], dtype=torch.int32))
    m = 3
    rep = TR.stack_replicas(caches, m)
    assert rep.pos.tolist() == [[3, 7]] * m
    flat = TR.flatten_replicas(rep, m)
    assert flat.pos.tolist() == [3, 7] * m
    assert flat.k.shape[1] == m * B
    back = TR.unflatten_replicas(flat, m)
    assert back.pos.tolist() == rep.pos.tolist()
    assert torch.equal(back.k, rep.k)
    if kv_dtype == "int8":
        assert torch.equal(back.k_scale, rep.k_scale)
    scalar = TR.flatten_replicas(
        TR.stack_replicas(caches._replace(pos=4), m), m)
    assert scalar.pos.dtype == torch.int32
    assert scalar.pos.tolist() == [4] * (m * B)


def test_flatten_replicas_of_one_row_owns_its_rows(models):
    """With one sequence the flat rows of broadcast replicas could be
    views of one row; a write into one flat row leaves the others."""
    caches = TM.init_cache(models["tcfg"], 1, 6, device="cpu")
    flat = TR.flatten_replicas(TR.stack_replicas(caches, 3), 3)
    flat.k[:, 0].fill_(1.0)
    flat.pos[0] = 4
    assert flat.k[:, 1:].abs().sum() == 0 and flat.pos.tolist() == [4, 0, 0]
    assert caches.k.abs().sum() == 0 and caches.pos.tolist() == [0]


def test_vectorize_pos_broadcasts_a_scalar(models):
    tcfg = models["tcfg"]
    caches = TM.init_cache(tcfg, 3, 6, device="cpu")
    assert caches.pos.tolist() == [0, 0, 0]
    v = TC.vectorize_pos(caches._replace(pos=5), 3)
    assert v.pos.dtype == torch.int32 and v.pos.tolist() == [5, 5, 5]
    assert TC.vectorize_pos(v, 3).pos is v.pos
    jv = JC.vectorize_pos(JM.init_cache(models["jcfg"], 3, 6), 3)
    assert np.asarray(jv.pos).shape[-1] == 3
    with pytest.raises(ValueError, match="pos of shape"):
        TC.vectorize_pos(v, 4)


# -- the prefill written into given caches (the engine's buffers) ------------

# (prompt length, window): linear, a ring the prompt wraps, a ring it
# does not fill
PREFILLS = {"linear": (10, None), "ring-wrapped": (10, 8),
            "ring-short": (5, 8)}


@pytest.mark.parametrize("m", [1, 3])
@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
@pytest.mark.parametrize("kind", sorted(PREFILLS))
def test_prefill_into_buffers_equals_new_caches(models, kind, kv_dtype, m):
    """``prefill(out=...)`` writes the caches it would make into the given
    ones and returns them, bitwise; with m replicas, the engine's buffers
    after ``replicate`` are the replica-major flatten of those caches."""
    from repro_torch.serve.engine import DecodeBuffers

    plen, window = PREFILLS[kind]
    tcfg = dataclasses.replace(models["tcfg"], kv_dtype=kv_dtype)
    batch = {"tokens": torch.from_numpy(_tokens(plen, 7))}
    kw = dict(window=window, cache_len=20)
    lw, want = TM.prefill(models["tp"], tcfg, batch, last_only=True, **kw)
    buf = DecodeBuffers(tcfg, B, m, 20, window, "cpu")
    buf.caches.k.fill_(7)  # whatever the buffers held before is overwritten
    lg, got = TM.prefill(models["tp"], tcfg, batch, last_only=True,
                         out=buf.rows(), **kw)
    assert torch.equal(lg, lw)
    assert got.k.data_ptr() == buf.caches.k.data_ptr()
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        assert a is None or torch.equal(a, b)
    buf.replicate()
    flat = TR.flatten_replicas(TR.stack_replicas(want, m), m)
    for a, b in zip(buf.caches, flat):
        assert a is None or torch.equal(a, b)


def test_generate_keeps_buffers_per_batch_size(models):
    """``generate`` prefills into buffers it keeps for its batch size and
    makes new ones for another; every generate equals the eager loop."""
    rcfg = RobustDecodeConfig(m=4, attack="signflip", alpha=0.25,
                              share_replica_compute=False)
    eng = ServeEngine(models["tcfg"], models["tp"], max_len=MAX_LEN,
                      robust=rcfg, device="cpu")
    batch = {"tokens": models["prompts"]}
    one = {"tokens": models["prompts"][1:]}
    first = eng.generate(batch, N_NEW)
    buf = eng.buffers
    assert buf.batch == B and buf.caches.k.shape[1] == 4 * B
    assert buf.caches.pos.tolist() == [S + N_NEW - 1] * (4 * B)
    assert torch.equal(eng.generate(batch, N_NEW), first)
    assert eng.buffers is buf
    got = eng.generate(one, N_NEW)
    assert eng.buffers is not buf and eng.buffers.batch == 1
    assert torch.equal(got, eng.generate_python_loop(one, N_NEW))
    assert torch.equal(first, eng.generate_python_loop(batch, N_NEW))


# -- generate (one step, replayed on the card) against the eager loop --------

def _repro_tokens(st, attack):
    """repro's scanned generate, greedy (plain for attack None)."""
    if attack not in st["repro"]:
        robust = None if attack is None else JRobust(
            m=8, estimator="vrmom", K=8, attack=attack, alpha=0.25)
        eng = JEngine(st["jcfg"], st["jp"], max_len=MAX_LEN, robust=robust)
        st["repro"][attack] = np.asarray(eng.generate(
            {"tokens": jnp.asarray(st["prompts"])}, N_NEW,
            key=jax.random.PRNGKey(11)))
    return st["repro"][attack]


@pytest.mark.parametrize("share", [True, False], ids=["shared",
                                                      "replicated"])
@pytest.mark.parametrize("attack", ["none", "signflip", "gaussian", "alie",
                                    "mimic"])
def test_generate_equals_loop_and_repro(models, attack, share):
    """Greedy: ``generate`` equals ``generate_python_loop`` bitwise, and
    both equal ``repro``'s scanned generate (under the gaussian attack the
    noise streams differ, so the tokens are repro's clean ones)."""
    rcfg = RobustDecodeConfig(m=8, estimator="vrmom", K=8, attack=attack,
                              alpha=0.25, share_replica_compute=share)
    eng = ServeEngine(models["tcfg"], models["tp"], max_len=MAX_LEN,
                      robust=rcfg, device="cpu")
    batch = {"tokens": models["prompts"]}
    got = eng.generate(batch, N_NEW,
                       generator=torch.Generator().manual_seed(3))
    loop = eng.generate_python_loop(
        batch, N_NEW, generator=torch.Generator().manual_seed(3))
    assert got.dtype == torch.int32 and got.shape == (B, N_NEW)
    assert torch.equal(got, loop)
    want = _repro_tokens(models, None if attack == "gaussian" else attack)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, _repro_tokens(models, None))


@pytest.mark.parametrize("attack", ["none", "gaussian"])
@pytest.mark.parametrize("sampling", [Sampling("top_k", 1.3, top_k=5),
                                      Sampling("temperature", 1.5)],
                         ids=["top_k", "temperature"])
def test_sampled_generate_equals_loop(models, sampling, attack):
    """Sampling and attack noise draw from one generator in the same order
    in ``generate`` and in the eager loop: one seed, the same tokens, and
    the generator left in the same state."""
    rcfg = RobustDecodeConfig(m=8, attack=attack, alpha=0.25)
    eng = ServeEngine(models["tcfg"], models["tp"], max_len=MAX_LEN,
                      robust=rcfg, device="cpu")
    batch = {"tokens": models["prompts"]}
    ga, gb = torch.Generator().manual_seed(9), torch.Generator().manual_seed(9)
    got = eng.generate(batch, N_NEW, sampling, generator=ga)
    loop = eng.generate_python_loop(batch, N_NEW, sampling, generator=gb)
    assert torch.equal(got, loop)
    assert torch.equal(ga.get_state(), gb.get_state())
    assert ((got >= 0) & (got < models["tcfg"].vocab)).all()


def test_generate_one_token_and_plain_engine(models):
    """n_tokens = 1 samples off the prefill alone; a plain (non-robust)
    engine's generate equals its loop and repro's tokens."""
    eng = ServeEngine(models["tcfg"], models["tp"], max_len=MAX_LEN,
                      device="cpu")
    batch = {"tokens": models["prompts"]}
    full = eng.generate(batch, N_NEW)
    assert torch.equal(full, eng.generate_python_loop(batch, N_NEW))
    np.testing.assert_array_equal(full.numpy(), _repro_tokens(models, None))
    assert torch.equal(eng.generate(batch, 1), full[:, :1])
    assert eng.graphs == {}  # the CPU path captures nothing
