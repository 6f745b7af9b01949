"""repro_torch kernels B1-B4: each plain version against the JAX kernel.

The same numpy inputs go through ``repro``'s Pallas kernel (interpret
mode on the CPU, as ``tests/test_kernels.py`` runs it) and through the
port's wrapper, which runs its plain PyTorch version for a CPU tensor.
Tolerances follow ``tests/test_estimator.py``: 1e-5 in f32 for
attention and for every estimator whose last step rounds. The median and
the tokens must match exactly. The mean and trimmed mean are sums, and
XLA picks their order by the layout of the slice it reduces (row order
for some row counts, two interleaved partial sums for others), so they
are held at 1e-5, about two f32 ulps at these magnitudes.
The CUDA kernels against their plain versions on the card are in
``tests/test_torch_cuda.py``.
"""
import importlib

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ref as JR
from repro.kernels.decode_attention import decode_attention as j_decode
from repro.kernels.flash_attention import flash_attention as j_flash
from repro.kernels.vrmom import aggregate_pallas, aggregate_sample_pallas
from repro_torch import kernels as K
from repro_torch.core.vrmom import deltas, denominator
from repro_torch.kernels import ref as TR
from repro_torch.kernels.decode_attention import (CHUNK, decode_attention,
                                                  decode_attention_plain,
                                                  lengths, plan_splits)
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.vrmom import (_params, aggregate, aggregate_plain,
                                       aggregate_sample,
                                       aggregate_sample_plain, count_table,
                                       plan_tail)

torch.set_num_threads(1)

METHODS = ("median", "vrmom", "trimmed_mean", "mean")
# a trimmed mean needs m >= 3 (one row trimmed per end, one left)
B1_CASES = [(method, m) for method in METHODS
            for m in (2, 3, 4, 5, 8, 9, 100)
            if not (method == "trimmed_mean" and m < 3)]


def _stack(seed, shape):
    return (4.0 * np.random.RandomState(seed).randn(*shape) + 1.5
            ).astype(np.float32)


def _beta(m):
    # int(beta * m) >= 1 and m - 2 * int(beta * m) >= 1 for every m >= 3
    return 0.1 if m >= 10 else 1.0 / m + 1e-6


def _check(method, got, want):
    if method == "median":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.fixture
def no_launch():
    """The wrappers run their plain versions on the CPU: no kernel launch
    may be counted."""
    K.reset_launch_counts()
    yield
    assert K.launch_counts() == {fn.__name__: 0 for fn in K.KERNELS}


# ---------------------------------------------------------------------------
# B1: aggregation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method,m", B1_CASES)
def test_b1_plain_matches_pallas_flat(method, m, no_launch):
    x = _stack(m, (m, 37))
    beta, Kq = _beta(m), 8
    want = np.asarray(aggregate_pallas(jnp.asarray(x), method, K=Kq,
                                       beta=beta, interpret=True))
    got = aggregate(torch.from_numpy(x), method, K=Kq, beta=beta).numpy()
    _check(method, got, want)


@pytest.mark.parametrize("K", [1, 2, 5, 10, 64, 65, 100, 128])
@pytest.mark.parametrize("m", [3, 8])
def test_b1_plain_matches_pallas_across_K(m, K, no_launch):
    """vrmom at the K the kernel takes at run time, odd K (whose middle
    delta is 0) and K above 64 (the paper's Table 1 reaches 100) included:
    the plain version that the card holds B1 to bitwise agrees with the
    Pallas kernel. K = 3 (mod 4) is not among them: its deltas hold
    ndtri(0.75), the MAD constant, and a row at one MAD from the median
    then has z on that delta, where XLA's rewrite of ``mad / _MAD_CONST``
    into a multiply by the reciprocal moves z by an ulp against the IEEE
    division that the port keeps (pinned by
    ``test_b1_mad_reciprocal_fault_at_k3``)."""
    x = _stack(100 + K, (m, 45))
    want = np.asarray(aggregate_pallas(jnp.asarray(x), "vrmom", K=K,
                                       interpret=True))
    got = aggregate(torch.from_numpy(x), "vrmom", K=K).numpy()
    _check("vrmom", got, want)


def _vrmom_oracle(x, K, mad_reciprocal=False):
    """B1's vrmom in numpy f32, one IEEE op at a time; ``mad_reciprocal``
    multiplies the MAD by f32(1 / ndtri(0.75)) instead of dividing, as
    XLA compiles the reference's ``mad / _MAD_CONST``. Returns (out,
    count, s, denom)."""
    f = np.float32
    m = x.shape[0]
    xs = np.sort(x, axis=0)
    med = f(0.5) * (xs[(m - 1) // 2] + xs[m // 2])
    ds = np.sort(np.abs(xs - med), axis=0)
    mad = f(0.5) * (ds[(m - 1) // 2] + ds[m // 2])
    kmad = f(0.6744897501960817)
    s = mad * (f(1) / kmad) if mad_reciprocal else mad / kmad
    z = (xs - med) / np.maximum(s, f(1e-12))
    count = (z[..., None] <= deltas(K)).sum(axis=(0, -1))
    total = f(0.5) * (2 * count - m * K).astype(np.float32)
    denom = denominator(m, K)
    return med - s * total / denom, count, s, denom


def test_b1_mad_reciprocal_fault_at_k3(no_launch):
    """The reference divides by the MAD constant with a reciprocal multiply
    (ROADMAP.md §C). At m = 3, K = 3 (seed 103, 45 columns) the plain
    version equals an IEEE-division oracle bit for bit, and the Pallas
    kernel is one count off it at column 25, where the reciprocal oracle
    reproduces it; every other column agrees to 1e-5."""
    x = _stack(103, (3, 45))
    got = aggregate(torch.from_numpy(x), "vrmom", K=3).numpy()
    want, count, s, denom = _vrmom_oracle(x, 3)
    np.testing.assert_array_equal(got, want)
    pallas = np.asarray(aggregate_pallas(jnp.asarray(x), "vrmom", K=3,
                                         interpret=True))
    recip, count_r, _, _ = _vrmom_oracle(x, 3, mad_reciprocal=True)
    assert np.flatnonzero(count_r != count).tolist() == [25]
    assert abs(int(count_r[25]) - int(count[25])) == 1
    off = np.abs(pallas - got)
    assert off[25] == pytest.approx(float(s[25] / denom), rel=1e-5)
    assert off[25] > 0.02 and np.delete(off, 25).max() < 1e-5
    np.testing.assert_allclose(pallas, recip, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("method", METHODS)
def test_b1_plain_matches_pallas_logit_stack(method, no_launch):
    """[m, B, V] replica-logit stacks: trailing dims are coordinates."""
    x = _stack(7, (8, 3, 41))
    want = np.asarray(aggregate_pallas(jnp.asarray(x), method, K=8,
                                       beta=0.25, interpret=True))
    got = aggregate(torch.from_numpy(x), method, K=8, beta=0.25).numpy()
    assert got.shape == (3, 41)
    _check(method, got, want)


@pytest.mark.parametrize("method", METHODS)
def test_b1_plain_matches_ref_oracles(method):
    """The plain version against ``repro``'s jnp oracles and the port's own
    (``kernels/ref.py``)."""
    x = _stack(11, (9, 53))
    if method == "mean":
        ref_j, ref_t = JR.ref_mean(jnp.asarray(x)), TR.ref_mean(
            torch.from_numpy(x))
        got = aggregate_plain(torch.from_numpy(x), "mean")
    elif method == "median":
        ref_j, ref_t = JR.ref_mom(jnp.asarray(x)), TR.ref_mom(
            torch.from_numpy(x))
        got = aggregate_plain(torch.from_numpy(x), "median")
    elif method == "vrmom":
        ref_j = JR.ref_vrmom(jnp.asarray(x), K=10)
        ref_t = TR.ref_vrmom(torch.from_numpy(x), K=10)
        got = aggregate_plain(torch.from_numpy(x), "vrmom", K=10)
    else:
        ref_j = JR.ref_trimmed_mean(jnp.asarray(x), beta=0.2)
        ref_t = TR.ref_trimmed_mean(torch.from_numpy(x), beta=0.2)
        got = aggregate_plain(torch.from_numpy(x), "trimmed_mean", k_trim=1)
    for ref in (np.asarray(ref_j), ref_t.numpy()):
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("method", ["median", "vrmom"])
def test_b1_bf16_in_bf16_out(method, no_launch):
    x = _stack(5, (8, 64))
    xb = x.astype(ml_dtypes.bfloat16)
    want = np.asarray(aggregate_pallas(jnp.asarray(xb), method, K=8,
                                       interpret=True))
    tb = torch.from_numpy(xb.view(np.uint16).copy()).view(torch.bfloat16)
    got = aggregate(tb, method, K=8)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    want = want.astype(np.float32)
    if method == "median":
        np.testing.assert_array_equal(got, want)
    else:  # one bf16 rounding of a value that agrees to 1e-5 in f32
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-5)


@pytest.mark.parametrize("m", [3, 8])
def test_b1_degenerate_scale_gives_exact_median(m, no_launch):
    """Identical honest rows: MAD = 0 and VRMOM returns the exact median
    (the guard the robust serving contract rests on)."""
    row = _stack(3, (1, 29))
    x = np.repeat(row, m, axis=0)
    x[-1] = -x[-1]  # one corrupted row keeps the honest majority
    got = aggregate(torch.from_numpy(x), "vrmom", K=8).numpy()
    np.testing.assert_array_equal(got, row[0])
    want = np.asarray(aggregate_pallas(jnp.asarray(x), "vrmom", K=8,
                                       interpret=True))
    np.testing.assert_array_equal(got, want)


def test_b1_rejects_unvalidated_trim():
    with pytest.raises(ValueError, match="trims"):
        aggregate(torch.zeros(8, 4), "trimmed_mean", beta=0.1)


def test_b1_meta_tensor_raises():
    """A tensor that is neither on the CPU nor on the card is refused; the
    wrapper never falls back to the plain version for it."""
    with pytest.raises(ValueError, match="meta"):
        aggregate(torch.zeros(8, 4, device="meta"), "median")


# ---------------------------------------------------------------------------
# B4: aggregation + sampling tail
# ---------------------------------------------------------------------------

def _tied_logits(seed, m, B, V):
    # quantized to multiples of 0.25 so equal aggregates (ties) occur
    x = np.round(_stack(seed, (m, B, V)) * 4.0) / 4.0
    return x.astype(np.float32)


@pytest.mark.parametrize("m", [3, 8])
@pytest.mark.parametrize("method", ["median", "vrmom", "trimmed_mean"])
def test_b4_greedy_matches_pallas(method, m, no_launch):
    x = _tied_logits(m, m, 4, 300)
    beta = _beta(m)
    _, want = aggregate_sample_pallas(jnp.asarray(x), method, K=8,
                                      beta=beta, interpret=True)
    agg, got = aggregate_sample(torch.from_numpy(x), method, K=8, beta=beta)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # bit-identical to an argmax over B1's output
    b1 = aggregate(torch.from_numpy(x), method, K=8, beta=beta)
    np.testing.assert_array_equal(got.numpy(),
                                  torch.argmax(b1, dim=-1).numpy())
    np.testing.assert_array_equal(agg.numpy(), b1.numpy())


@pytest.mark.parametrize("m", [3, 8])
def test_b4_greedy_matches_pallas_at_k100(m, no_launch):
    """Greedy over a vrmom aggregate at K = 100, above the 64 the kernels
    took before."""
    x = _stack(300 + m, (m, 4, 300))
    agg_j, want = aggregate_sample_pallas(jnp.asarray(x), "vrmom", K=100,
                                          interpret=True)
    agg, got = aggregate_sample(torch.from_numpy(x), "vrmom", K=100)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(agg.numpy(), np.asarray(agg_j), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("k", [1, 5, 17])
def test_b4_topk_matches_pallas_with_ties(k, no_launch):
    x = _tied_logits(21, 8, 3, 257)
    _, wv, wi = aggregate_sample_pallas(jnp.asarray(x), "median", top_k=k,
                                        interpret=True)
    agg, tv, ti = aggregate_sample(torch.from_numpy(x), "median", top_k=k)
    a = agg.numpy()
    assert any(len(np.unique(r)) < r.size for r in a)  # ties are present
    np.testing.assert_array_equal(ti.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(wv))


def test_b4_with_agg_false_writes_no_aggregate(no_launch):
    x = _stack(2, (5, 2, 64))
    agg, tok = aggregate_sample(torch.from_numpy(x), "vrmom", K=8,
                                with_agg=False)
    assert agg is None and tok.dtype == torch.int32 and tok.shape == (2,)
    agg_p, tok_p = aggregate_sample_plain(torch.from_numpy(x), "vrmom", K=8)
    np.testing.assert_array_equal(tok.numpy(), tok_p.numpy())


def test_b4_validates():
    with pytest.raises(ValueError, match="m, B, V"):
        aggregate_sample(torch.zeros(4, 8), "median")
    with pytest.raises(ValueError, match="top_k"):
        aggregate_sample(torch.zeros(4, 2, 8), "median", top_k=9)


@pytest.mark.parametrize("m,V,top_k,plan", [
    (8, 151936, 0, (2, 512, 1, 297, 1)),     # the serving stack, greedy
    (8, 151936, 50, (2, 512, 1, 297, 50)),
    (8, 512, 512, (2, 512, 1, 1, 512)),      # one whole tile
    (8, 513, 513, (2, 512, 1, 2, 512)),      # k above the tile: whole tiles
    (1, 7, 2, (2, 512, 1, 1, 2)),
    (9, 151936, 0, (1, 256, 1, 594, 1)),     # m > 8: a coordinate a thread
    (128, 257, 50, (1, 256, 1, 2, 50)),
    (128, 262144, 0, (1, 256, 1, 1024, 1)),  # 1,024 tiles: one a block
    (9, 262145, 0, (1, 256, 2, 513, 1)),     # past 1,024: two a block
    (8, 524289, 50, (2, 512, 2, 513, 50)),
    (8, 600000, 0, (2, 512, 2, 586, 1)),
    (8, 2 ** 28, 0, (2, 512, 512, 1024, 1)),
])
def test_b4_plan_tail(m, V, top_k, plan):
    got = plan_tail(m, V, top_k)
    assert tuple(got) == plan
    assert got.tile == got.items * 256


@pytest.mark.parametrize("m", [1, 8, 9, 128])
def test_b4_plan_tail_blocks_cover_the_row(m):
    """Every V: at most 1,024 blocks a row, each starting inside the row,
    together covering it."""
    for V in [1, 2, 255, 256, 257, 511, 512, 513] + [
            t * 1024 * s + d for t in (256, 512) for s in (1, 2, 3, 7)
            for d in (-1, 0, 1)]:
        p = plan_tail(m, V, 0)
        span = p.chunks * p.tile
        assert p.n_blk <= 1024 and p.n_blk * span >= V, (m, V, p)
        assert (p.n_blk - 1) * span < V, (m, V, p)  # no empty block


@pytest.mark.parametrize("method,K,m", [("vrmom", 8, 8), ("vrmom", 64, 100),
                                        ("vrmom", 1, 3), ("vrmom", 100, 101),
                                        ("vrmom", 257, 128),
                                        ("median", 10, 8)])
def test_b4_params_cached(method, K, m):
    cpu = torch.device("cpu")
    first = _params(method, K, m, cpu)
    assert _params(method, K, m, cpu) is first  # computed once per spec
    if method != "vrmom":
        assert first.table is None and first.denom == 0.0
        return
    table, scale, zero_k = count_table(K)
    assert first.denom == float(denominator(m, K))
    assert (first.scale, first.zero_k) == (float(scale), zero_k)
    if K <= 64:  # copied into the launch parameters
        assert isinstance(first.table, np.ndarray)
        np.testing.assert_array_equal(first.table, table)
    else:  # read from device memory
        assert first.table.dtype == torch.float32
        np.testing.assert_array_equal(first.table.numpy(), table)
    assert first.table.shape == (K,)


@pytest.mark.parametrize("K", [1, 3, 8, 10, 64, 65, 100, 128, 257])
def test_b1_count_table_is_exact(K):
    """The count on the FP32 adders (csrc/agg.cuh) needs the scaled deltas
    exact and every float z != Delta_k at least 1 / S from Delta_k: the
    float neighbours of each delta, scaled, lie at least 1 away."""
    table, scale, zero_k = count_table(K)
    d = deltas(K)
    assert table.dtype == np.float32 and np.all(np.isfinite(table))
    assert np.log2(scale) == int(np.log2(scale)) >= 24
    np.testing.assert_array_equal(table / scale, d)  # exact: S = 2^s
    assert np.all(np.diff(table) > 0)
    assert zero_k == (K // 2 if K % 2 else -1)
    nz = d[d != 0]
    for toward in (np.float32(-np.inf), np.float32(np.inf)):
        gap = np.abs(np.nextafter(nz, toward) - nz).astype(np.float64)
        assert np.all(gap * float(scale) >= 1.0)
    if K == 100:  # the least |Delta_k| is |ndtri(50/101)| ~ 0.0124
        assert scale == 2.0 ** 31


def test_b1_refuses_a_count_that_cannot_be_exact():
    """m * K ones must sum exactly in f32: 2^24 at most."""
    cpu = torch.device("cpu")
    _params("vrmom", 2 ** 17, 128, cpu)  # 2^24 exactly: taken
    with pytest.raises(ValueError, match="2\\^24"):
        _params("vrmom", 2 ** 17 + 1, 128, cpu)
    with pytest.raises(ValueError, match="K >= 1"):
        _params("vrmom", 0, 8, cpu)


def test_b4_plain_ranks_nan_first_like_torch():
    """The selection order of the plain tail (and of the kernel): value
    descending, index ascending, NaN above every number, -0 equal to +0."""
    nan, inf = float("nan"), float("inf")
    row = [1.0, nan, inf, -0.0, nan, 0.0, -inf, inf]
    x = torch.tensor([[row]], dtype=torch.float32)  # m = 1, B = 1
    _, tok = aggregate_sample_plain(x, "mean")
    assert tok.tolist() == [1]
    _, tv, ti = aggregate_sample_plain(x, "mean", top_k=8)
    assert ti.tolist() == [[1, 4, 2, 7, 0, 3, 5, 6]]


# ---------------------------------------------------------------------------
# B2: flash attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,T,H,Hkv,causal", [
    (24, 24, 4, 4, True),    # GQA 1:1
    (24, 24, 8, 2, True),    # GQA 4:1
    (24, 24, 8, 2, False),
    (16, 40, 4, 1, False),   # T != S
    (20, 37, 4, 2, False),   # ragged T
    (33, 33, 4, 2, True),    # ragged causal
])
def test_b2_plain_matches_pallas(S, T, H, Hkv, causal, no_launch):
    rs = np.random.RandomState(S * 100 + T)
    q = rs.randn(2, S, H, 32).astype(np.float32)
    k = rs.randn(2, T, Hkv, 32).astype(np.float32)
    v = rs.randn(2, T, Hkv, 32).astype(np.float32)
    want = np.asarray(j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal, blk_q=16, blk_k=16,
                              interpret=True))
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=causal).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_b2_plain_matches_ref_attention():
    rs = np.random.RandomState(0)
    q, k, v = (rs.randn(2, 12, 4, 32).astype(np.float32) for _ in range(3))
    want = TR.ref_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    got = flash_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_b2_validates():
    q = torch.zeros(1, 4, 3, 32)
    with pytest.raises(ValueError, match="multiple"):
        flash_attention(q, torch.zeros(1, 4, 2, 32), torch.zeros(1, 4, 2, 32))


# ---------------------------------------------------------------------------
# B3: decode attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_len", ["none", "scalar", "rows"])
@pytest.mark.parametrize("H,Hkv", [(4, 4), (8, 2)])
def test_b3_plain_matches_pallas(kv_len, H, Hkv, no_launch):
    rs = np.random.RandomState(H + Hkv)
    B, T, dh = 3, 40, 32
    q = rs.randn(B, 1, H, dh).astype(np.float32)
    k = rs.randn(B, T, Hkv, dh).astype(np.float32)
    v = rs.randn(B, T, Hkv, dh).astype(np.float32)
    lens = {"none": None, "scalar": 23,
            "rows": np.array([5, 40, 17], np.int32)}[kv_len]
    want = np.asarray(j_decode(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), kv_len=lens, interpret=True))
    t_lens = torch.from_numpy(lens) if isinstance(lens, np.ndarray) else lens
    got = decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), kv_len=t_lens).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_b3_int8_scales_match_pallas(no_launch):
    rs = np.random.RandomState(8)
    B, T, H, Hkv, dh = 2, 33, 8, 4, 32
    q = rs.randn(B, 1, H, dh).astype(np.float32)
    k8 = rs.randint(-127, 128, size=(B, T, Hkv, dh)).astype(np.int8)
    v8 = rs.randint(-127, 128, size=(B, T, Hkv, dh)).astype(np.int8)
    ks = (rs.rand(B, T) * 0.02 + 1e-3).astype(np.float32)
    vs = (rs.rand(B, T) * 0.02 + 1e-3).astype(np.float32)
    lens = np.array([33, 20], np.int32)
    want = np.asarray(j_decode(jnp.asarray(q), jnp.asarray(k8),
                               jnp.asarray(v8), kv_len=lens,
                               k_scale=jnp.asarray(ks),
                               v_scale=jnp.asarray(vs), interpret=True))
    got = decode_attention(torch.from_numpy(q), torch.from_numpy(k8),
                           torch.from_numpy(v8), kv_len=torch.from_numpy(lens),
                           k_scale=torch.from_numpy(ks),
                           v_scale=torch.from_numpy(vs)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", [1, 31, 32, 33, 40])
def test_b3_scalar_and_vector_lengths_match_pallas(n, no_launch):
    """Lengths around a 32-key chunk edge and the whole cache (T = 40):
    the scalar kv_len and the same length as a [B] vector give the JAX
    kernel's result."""
    rs = np.random.RandomState(n)
    B, T, H, Hkv, dh = 2, 40, 8, 2, 32
    q = rs.randn(B, 1, H, dh).astype(np.float32)
    k = rs.randn(B, T, Hkv, dh).astype(np.float32)
    v = rs.randn(B, T, Hkv, dh).astype(np.float32)
    rows = np.full((B,), n, np.int32)
    for j_len, t_len in ((n, n), (rows, torch.from_numpy(rows))):
        want = np.asarray(j_decode(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), kv_len=j_len,
                                   interpret=True))
        got = decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), kv_len=t_len).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B,Hkv,T,n_split", [
    (4, 8, 216, 7),     # the slice's decode shape: 224 blocks
    (32, 8, 216, 2),    # the replicated path's batch
    (1, 1, 1, 1),
    (4, 8, 4096, 9),
])
def test_b3_plan_splits(B, Hkv, T, n_split):
    """About two waves of blocks on 132 SMs, whole 32-key chunks, at least
    one key in every split at full length, and a scratch record per
    chunk."""
    G, dh = 2, 128
    plan = plan_splits(B, Hkv, T, G, dh)
    assert plan.n_split == n_split
    assert plan.n_chunks == -(-T // CHUNK)
    assert plan.scratch_shape == (B, Hkv, plan.n_chunks, G * (dh + 2))
    span = plan.chunks_per_split * CHUNK
    for s in range(plan.n_split):
        assert min((s + 1) * span, T) - s * span >= 1
    assert plan.n_split * span >= T > (plan.n_split - 1) * span
    assert B * Hkv * plan.n_split <= 2 * 132 + B * Hkv


def test_b3_lengths_clamp_and_forms():
    assert lengths(None, 2, 7, "cpu").tolist() == [7, 7]
    assert lengths(9, 2, 7, "cpu").tolist() == [7, 7]
    assert lengths(torch.tensor([3, 12]), 2, 7, "cpu").tolist() == [3, 7]


def test_b3_validates():
    q = torch.zeros(2, 2, 4, 32)
    kv = torch.zeros(2, 8, 2, 32)
    with pytest.raises(ValueError, match="single-query"):
        decode_attention(q, kv, kv)
    with pytest.raises(ValueError, match="together"):
        decode_attention(q[:, :1], kv, kv, k_scale=torch.ones(2, 8))


def test_b3_empty_row_is_zero():
    """A row with no valid position returns 0 in both versions."""
    q = torch.randn(2, 1, 4, 32)
    kv = torch.randn(2, 8, 2, 32)
    out = decode_attention_plain(q, kv, kv, torch.tensor([0, 8],
                                                         dtype=torch.int32))
    assert torch.all(out[0] == 0) and torch.all(torch.isfinite(out[1]))


# ---------------------------------------------------------------------------
# B2 / B3 at the head dims and query groups of the wider configs: dh 96
# (phi-3-vision), dh 112 (zamba2), G 9 (starcoder2-7b), G 16 (llama3-405b)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dh,H,Hkv", [(96, 4, 4), (112, 8, 2), (96, 18, 2),
                                      (112, 16, 1)])
def test_b2_plain_matches_pallas_wide_heads(dh, H, Hkv, causal, no_launch):
    rs = np.random.RandomState(dh + H)
    S = T = 20  # ragged against the 16-row blocks
    q = rs.randn(2, S, H, dh).astype(np.float32)
    k = rs.randn(2, T, Hkv, dh).astype(np.float32)
    v = rs.randn(2, T, Hkv, dh).astype(np.float32)
    want = np.asarray(j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal, blk_q=16, blk_k=16,
                              interpret=True))
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=causal).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _kv_cache(rs, B, T, Hkv, dh, kv):
    """(k, v, k_scale, v_scale) as numpy for JAX and torch for the port.
    A bf16 cache holds values that bf16 represents exactly, given to JAX
    as ``ml_dtypes.bfloat16``."""
    if kv == "int8":
        k8, v8 = (rs.randint(-127, 128, size=(B, T, Hkv, dh)).astype(np.int8)
                  for _ in range(2))
        ks, vs = ((rs.rand(B, T) * 0.02 + 1e-3).astype(np.float32)
                  for _ in range(2))
        return ((k8, v8, ks, vs),
                tuple(torch.from_numpy(a) for a in (k8, v8, ks, vs)))
    k, v = (torch.from_numpy(rs.randn(B, T, Hkv, dh).astype(np.float32))
            .to(getattr(torch, kv)) for _ in range(2))
    if kv == "float32":
        return (k.numpy(), v.numpy(), None, None), (k, v, None, None)
    return ((k.float().numpy().astype(ml_dtypes.bfloat16),
             v.float().numpy().astype(ml_dtypes.bfloat16), None, None),
            (k, v, None, None))


@pytest.mark.parametrize("kv", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("G", [9, 16])
@pytest.mark.parametrize("dh", [96, 112])
def test_b3_plain_matches_pallas_wide_heads(dh, G, kv, no_launch):
    """f32 queries over an f32, bf16 or int8 cache (both sides widen the
    cache to f32 before the products), per-row lengths around a chunk
    edge."""
    rs = np.random.RandomState(dh + G)
    B, T, Hkv = 3, 40, 2
    q = rs.randn(B, 1, G * Hkv, dh).astype(np.float32)
    (jk, jv, jks, jvs), (tk, tv, tks, tvs) = _kv_cache(rs, B, T, Hkv, dh, kv)
    lens = np.array([5, 40, 33], np.int32)
    want = np.asarray(j_decode(
        jnp.asarray(q), jnp.asarray(jk), jnp.asarray(jv), kv_len=lens,
        k_scale=None if jks is None else jnp.asarray(jks),
        v_scale=None if jvs is None else jnp.asarray(jvs), interpret=True))
    got = decode_attention(torch.from_numpy(q), tk, tv,
                           kv_len=torch.from_numpy(lens), k_scale=tks,
                           v_scale=tvs).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_wrappers_name_their_compiled_instances():
    """What the CUDA instances take, which the card tests hold: dh 96 and
    112 beside 32, 64 and 128, and query groups up to 16."""
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    da = importlib.import_module("repro_torch.kernels.decode_attention")
    assert fa.HEAD_DIMS == da.HEAD_DIMS == (32, 64, 96, 112, 128)
    assert da.MAX_GROUP == 16
