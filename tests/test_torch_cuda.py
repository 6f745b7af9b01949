"""repro_torch on the card: each CUDA kernel against its plain version.

Every test here is marked ``cuda`` and skips without a card (the kernels
have no CPU mode). On a machine with one:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The file imports nothing of JAX, so it runs where only PyTorch is
installed. Tolerances: 0 for the aggregation kernels (they repeat the
plain version's f32 arithmetic op for op, with no multiply-add
contraction); 1e-4 for attention in f32, whose sums run in another order
than the plain version's; 1e-2 + 1e-2 * |ref| for attention in bf16
against the f32 plain version of the same bf16 inputs (one bf16 rounding
of the output, 2^-9 relative, and in B2 the bf16 rounding of each softmax
weight before P.V).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get as get_arch
from repro_torch.core.estimator import Estimator
from repro_torch.device import (device_kernel_counts, kernel_instance,
                                kernels_in_calls)
from repro_torch.kernels import reset_launch_counts, launch_counts
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_plain,
                                                  lengths)
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.vrmom import (aggregate, aggregate_plain,
                                       aggregate_sample,
                                       aggregate_sample_plain,
                                       resolve_method)
from repro_torch.models import model as M
from repro_torch.serve import RobustDecodeConfig, ServeEngine

torch.set_num_threads(1)

METHODS = ("median", "vrmom", "trimmed_mean", "mean")
# the port's device kernels, by a part of their names (csrc/*.cu)
DEVICE_KERNELS = ("flash_fwd", "decode_split_kernel", "tail_kernel",
                  "agg_kernel")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _stack(seed, shape, device):
    x = 4.0 * np.random.RandomState(seed).randn(*shape) + 1.5
    return torch.from_numpy(np.round(x * 4.0) / 4.0).float().to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [3, 8, 100])
@pytest.mark.parametrize("method", METHODS)
def test_cuda_b1_matches_plain(cuda, method, m):
    x = _stack(m, (m, 4, 1000), cuda)
    beta = 0.1 if m >= 10 else 1.0 / m + 1e-6
    got = aggregate(x, method, K=8, beta=beta)
    _, k_trim = resolve_method(method, beta, m)
    want = aggregate_plain(x.reshape(m, -1), method, K=8, k_trim=k_trim)
    torch.testing.assert_close(got.reshape(-1), want, rtol=0, atol=0)


def _b1_same(x2, method, K=8, beta=None):
    """B1 against its plain version on an [m, C] stack, bitwise (NaN at
    the same places)."""
    m = x2.shape[0]
    if beta is None:
        beta = 0.1 if m >= 10 else 1.0 / m + 1e-6
    _, k_trim = resolve_method(method, beta, m)
    got = aggregate(x2, method, K=K, beta=beta)
    assert got.dtype == x2.dtype
    _same(got, aggregate_plain(x2, method, K=K, k_trim=k_trim))
    return got


# C around B1's tiles of 256 coordinates and around widths of 16 bytes
# (4 f32, 8 bf16)
B1_C = (1, 2, 3, 4, 5, 7, 8, 9, 15, 16, 17, 255, 256, 257, 1023, 1024,
        1025, 4 * 151936 - 1, 4 * 151936, 4 * 151936 + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C", B1_C)
def test_cuda_b1_ragged_and_misaligned(cuda, C, dtype):
    """C around 16-byte widths and the tile's span, and the same stacks
    at a base one element past 16-byte alignment, m = 7 and 8, every
    method."""
    dt = getattr(torch, dtype)
    for m in (7, 8):
        buf = _stack(C + m, (m * C + 1,), cuda).to(dt)
        for x2 in (buf[:m * C].view(m, C), buf[1:].view(m, C)):
            for method in METHODS:
                _b1_same(x2, method)
            _b1_same(x2, "vrmom", K=10)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 2, 7, 8, 9, 31, 32, 33, 100, 128])
def test_cuda_b1_worker_counts_and_levels(cuda, m):
    """Every sorting network's width and its edges, K in {1, 8, 10, 64}
    (K = 1: the zero delta of an odd K), every method, f32 and bf16."""
    x = _stack(m, (m, 3001), cuda)
    for dt in (torch.float32, torch.bfloat16):
        xd = x.to(dt)
        for method in METHODS:
            if method == "trimmed_mean" and m < 3:
                continue
            for K in ((1, 8, 10, 64) if method == "vrmom" else (8,)):
                _b1_same(xd, method, K=K)


def _delta_edge_stack(K, C, seed, device):
    """[8, C] stacks whose plain z meet the deltas exactly: rows
    (lo, -kMad, -kMad, -p, p, kMad, kMad, hi) in a shuffled order give
    med = 0 and MAD = kMad, so s = 1 and z = x; p is a positive delta
    below kMad, lo and hi deltas or their neighbours one ulp away."""
    from repro_torch.core.vrmom import _MAD_CONST, deltas

    rng = np.random.RandomState(seed)
    d = deltas(K).astype(np.float32)
    kmad = np.float32(_MAD_CONST)
    p = rng.choice(d[(d > 0) & (d < kmad)], C)

    def near(v):
        step = rng.randint(-1, 2, v.shape)
        return np.where(step < 0, np.nextafter(v, np.float32(-np.inf)),
                        np.where(step > 0, np.nextafter(v, np.float32(
                            np.inf)), v)).astype(np.float32)

    lo = near(rng.choice(d[d < -kmad], C))
    hi = near(rng.choice(d[d > kmad], C))
    rows = np.stack([lo, -kmad + 0 * p, -kmad + 0 * p, -p, p, kmad + 0 * p,
                     kmad + 0 * p, hi]).astype(np.float32)
    for c in range(C):
        rows[:, c] = rows[rng.permutation(8), c]
    return torch.from_numpy(rows).to(device), d


@pytest.mark.cuda
@pytest.mark.parametrize("K", [63, 64, 65, 100, 128, 257])
@pytest.mark.parametrize("m", [8, 101])
def test_cuda_b1_b4_any_K(cuda, m, K):
    """K around the 64 the kernels took before and up to 257 (the deltas'
    table in device memory; the count's scale 2^31 from K = 100 on): B1,
    B4's aggregate and B4's greedy pick bitwise equal to the plain
    versions, f32 and bf16."""
    x = _stack(m * K, (m, 4, 2051), cuda)
    for dt in (torch.float32, torch.bfloat16):
        xd = x.to(dt)
        b1 = _b1_same(xd.reshape(m, -1), "vrmom", K=K)
        agg, tok = aggregate_sample(xd, "vrmom", K=K)
        _same(agg.reshape(-1), b1)
        _, want = aggregate_sample_plain(xd, "vrmom", K=K)
        assert torch.equal(tok, want)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [8, 10, 100, 257])
def test_cuda_b1_count_at_delta_edges(cuda, K):
    """z == Delta_k bit for bit (the <= edge of the count, where the
    saturating add gives 0), at
    the serving instance (K = 8) and the runtime-K one; B4's aggregate
    and greedy pick agree."""
    x2, d = _delta_edge_stack(K, 4096, K, cuda)
    # the plain version's z are the stack itself (med 0, s 1): many meet a
    # delta exactly
    xs = torch.sort(x2.cpu(), dim=0).values
    med = 0.5 * (xs[3] + xs[4])
    assert torch.all(med == 0)
    hits = torch.isin(x2.cpu(), torch.from_numpy(d))
    assert hits.sum() > 4096
    got = _b1_same(x2, "vrmom", K=K)
    agg, tok = aggregate_sample(x2.view(8, 4, 1024), "vrmom", K=K)
    _same(agg.reshape(-1), got)
    assert torch.equal(tok, torch.argmax(got.view(4, 1024), -1).to(
        torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [3, 8, 9])
def test_cuda_b1_infinite_and_nan_medians(cuda, m):
    """Columns whose median is +-inf or NaN, and columns with a finite
    median but an infinite MAD (s = inf: z is +-0 or NaN, and the sign of
    the count decides the output), mixed with ordinary ones."""
    g = torch.Generator(device=cuda).manual_seed(m)
    C = 4000
    x = 4.0 * torch.randn((m, C), device=cuda, generator=g)
    kind = torch.randint(0, 6, (C,), device=cuda, generator=g)
    big = m // 2 + 1                       # more than half the rows
    inf, nan = float("inf"), float("nan")
    rows = torch.rand((m, C), device=cuda, generator=g).argsort(0) < big
    x = torch.where(rows & (kind == 1), inf, x)    # med = +inf
    x = torch.where(rows & (kind == 2), -inf, x)   # med = -inf
    x = torch.where(rows & (kind == 3), nan, x)    # med = NaN
    # kind 4: half the rows -inf, half +inf, the middle finite: s = inf
    lo = torch.rand((m, C), device=cuda, generator=g).argsort(0)
    x = torch.where((kind == 4) & (lo < (m - 1) // 2), -inf, x)
    x = torch.where((kind == 4) & (lo >= m - (m - 1) // 2), inf, x)
    x = torch.where((kind == 5) & (lo == 0), nan, x)
    for method in METHODS:
        for K in ((8, 10) if method == "vrmom" else (8,)):
            _b1_same(x, method, K=K)
            _b1_same(x.to(torch.bfloat16), method, K=K)
    agg, tok = aggregate_sample(x.view(m, 4, C // 4), "vrmom", K=10)
    _same(agg.reshape(-1), aggregate(x, "vrmom", K=10))
    assert torch.equal(tok, torch.argmax(agg, -1).to(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("m,K,dtype", [(8, 8, "float32"), (8, 10, "float32"),
                                       (8, 8, "bfloat16"), (3, 10, "float32"),
                                       (100, 10, "float32")])
def test_cuda_b4_aggregate_equals_b1(cuda, m, K, dtype):
    """B4's with_agg aggregate is B1's bitwise, and its greedy pick is
    argmax(B1), at the serving instance and the runtime-spec ones."""
    x = _stack(m + K, (m, 4, 5003), cuda).to(getattr(torch, dtype))
    b1 = aggregate(x, "vrmom", K=K)
    agg, tok = aggregate_sample(x, "vrmom", K=K)
    _same(agg, b1)
    # in bf16 the pick is made on the f32 aggregate, before it is rounded
    want = (torch.argmax(b1, -1).to(torch.int32) if dtype == "float32"
            else aggregate_sample_plain(x, "vrmom", K=K)[1])
    assert torch.equal(tok, want)


@pytest.mark.cuda
def test_cuda_b1_one_kernel_a_call(cuda):
    """The serving stack, a misaligned ragged stack and m = 100: one
    device kernel a call."""
    g = torch.Generator(device=cuda).manual_seed(11)
    x = 4.0 * torch.randn((8, 4 * 151936), device=cuda, generator=g)
    buf = torch.randn(8 * 1001 + 1, device=cuda, generator=g)
    x100 = torch.randn((100, 4096), device=cuda, generator=g)
    calls = [lambda: aggregate(x, "vrmom", K=8),
             lambda: aggregate(buf[1:].view(8, 1001), "vrmom", K=10),
             lambda: aggregate(x100, "median")]
    for names in kernels_in_calls(calls):
        assert len(names) == 1 and "agg_kernel" in names[0], names


@pytest.mark.cuda
@pytest.mark.parametrize("k", [0, 1, 50])
def test_cuda_b4_matches_plain(cuda, k):
    x = _stack(1, (8, 4, 5000), cuda)
    got = aggregate_sample(x, "vrmom", K=8, top_k=k)
    want = aggregate_sample_plain(x, "vrmom", K=8, top_k=k)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    b1 = aggregate(x, "vrmom", K=8)
    torch.testing.assert_close(got[0], b1, rtol=0, atol=0)


def _same(got, want):
    """Bitwise equal up to NaN payloads and the sign of zero: the same
    shape and dtype, NaN at the same places, equal values elsewhere."""
    assert got.shape == want.shape and got.dtype == want.dtype
    nan = torch.isnan(got) if got.is_floating_point() else None
    if nan is None:
        assert torch.equal(got, want)
        return
    assert torch.equal(nan, torch.isnan(want))
    assert torch.equal(got[~nan], want[~nan])


def _b4_check(x, method="vrmom", K=8, beta=0.1, top_k=0, with_agg=True):
    """B4 against its plain version (and, with the aggregate, B1)."""
    _, k_trim = resolve_method(method, beta, x.shape[0])
    got = aggregate_sample(x, method, K=K, beta=beta, top_k=top_k,
                           with_agg=with_agg)
    want = aggregate_sample_plain(x, method, K=K, k_trim=k_trim,
                                  top_k=top_k, with_agg=with_agg)
    assert len(got) == len(want)
    for g, w in zip(got[1:], want[1:]):
        _same(g, w)
    if with_agg:
        _same(got[0], want[0])
        _same(got[0], aggregate(x, method, K=K, beta=beta))
    else:
        assert got[0] is None
    return got


# B4 tiles: 512 coordinates at m <= 8, 256 above
B4_V = (1, 7, 255, 256, 257, 511, 512, 513, 1023, 1024, 1025, 5000, 151936)


@pytest.mark.cuda
@pytest.mark.parametrize("V", B4_V)
def test_cuda_b4_ragged_vocab(cuda, V):
    """Every V around the tile edges, greedy and top-k for k in {1, 2, 50,
    V}, with and without the aggregate; m = 8 (vector loads when V is
    even) and m = 9 (a coordinate a thread)."""
    for m in (8, 9):
        x = _stack(V + m, (m, 4, V), cuda)
        for k in sorted({0, 1, 2, 50, V} & set(range(V + 1))):
            for with_agg in (True, False):
                if V == 151936 and k == V and (m == 9 or with_agg):
                    continue  # one whole-vocabulary sort is enough
                _b4_check(x, top_k=k, with_agg=with_agg)


@pytest.mark.cuda
@pytest.mark.parametrize("m,V", [(8, 524288), (8, 524289), (8, 600000),
                                 (9, 262144), (9, 262145), (9, 300001)])
def test_cuda_b4_blocks_of_several_tiles(cuda, m, V):
    """Past 1,024 tiles a row (V > 524,288 at m <= 8, V > 262,144 above) a
    block aggregates several tiles in turn; k = 600 keeps more keys than
    one tile holds. Batches of 1 and 2."""
    for B in (1, 2):
        x = _stack(V + m + B, (m, B, V), cuda)
        for k in (0, 1, 2, 50, 600):
            _b4_check(x, top_k=k, with_agg=k in (0, 600))


# a trimmed mean needs m >= 3 (one row trimmed per end, one left)
B4_M_CASES = [(method, m) for method in METHODS
              for m in (1, 2, 3, 8, 9, 32, 33, 100, 128)
              if not (method == "trimmed_mean" and m < 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("method,m", B4_M_CASES)
def test_cuda_b4_worker_counts(cuda, method, m):
    x = _stack(m, (m, 4, 5000), cuda)
    beta = 0.1 if m >= 10 else 1.0 / m + 1e-6
    for k in (0, 50):
        _b4_check(x, method, beta=beta, top_k=k)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 4, 32])
def test_cuda_b4_batches(cuda, B):
    x = 4.0 * torch.randn((8, B, 151936), device=cuda,
                          generator=torch.Generator(device=cuda
                                                    ).manual_seed(B))
    for k in (0, 50):
        _b4_check(x, top_k=k, with_agg=B != 32)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [0, 1, 2, 50])
def test_cuda_b4_ties_span_blocks(cuda, k):
    """Equal aggregates in many tiles: constant rows (every coordinate
    ties: the first k indices win) and coarsely quantised rows."""
    V = 5000
    const = torch.full((8, 2, V), 1.25, device=cuda)
    _, tok = aggregate_sample(const, "vrmom", K=8)
    assert tok.tolist() == [0, 0]
    _b4_check(const, top_k=k)
    g = torch.Generator(device=cuda).manual_seed(k)
    coarse = torch.randint(0, 3, (8, 4, V), device=cuda, generator=g).float()
    for method in ("median", "vrmom"):
        _b4_check(coarse, method, top_k=k)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [3, 8, 9])
def test_cuda_b1_b4_inf_nan(cuda, m):
    """+-inf and NaN rows: the sorts rank NaN above every number, as
    torch.sort does; NaN aggregates rank first in the selection, as in
    torch.argmax and torch.sort."""
    g = torch.Generator(device=cuda).manual_seed(m)
    V = 3000
    x = 4.0 * torch.randn((m, 4, V), device=cuda, generator=g)
    pick = torch.rand((m, 4, V), device=cuda, generator=g)
    x[pick < 0.05] = float("inf")
    x[(pick >= 0.05) & (pick < 0.1)] = -float("inf")
    x[(pick >= 0.1) & (pick < 0.15)] = float("nan")
    x[:, 2] = torch.where(pick[:, 2] < 0.5, x[:, 2], float("nan"))
    x[:, 3, :10] = float("nan")    # NaN aggregates early in row 3
    x[:, 3, 2000:2010] = float("inf")
    x[:, 1, :500] *= 1e38          # x - med overflows to +-inf
    for method in METHODS:
        beta = 1.0 / m + 1e-6
        _, k_trim = resolve_method(method, beta, m)
        _same(aggregate(x, method, K=8, beta=beta),
              aggregate_plain(x.reshape(m, -1), method, K=8,
                              k_trim=k_trim).reshape(4, V))
        for k in (0, 1, 50, V):
            _b4_check(x, method, beta=beta, top_k=k)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [8, 9])
def test_cuda_b4_bf16(cuda, m):
    x = _stack(m, (m, 4, 5001), cuda).to(torch.bfloat16)
    for k in (0, 50):
        agg = _b4_check(x, top_k=k)[0]
        assert agg.dtype == torch.bfloat16


@pytest.mark.cuda
def test_cuda_b4_repeat_and_interleaved_shapes(cuda):
    """Repeat calls give the same bits, and calls of two shapes
    interleaved on one stream stay right: each launch leaves its ticket
    counters at zero."""
    g = torch.Generator(device=cuda).manual_seed(7)
    xa = 4.0 * torch.randn((8, 4, 151936), device=cuda, generator=g)
    xb = 4.0 * torch.randn((9, 2, 5000), device=cuda, generator=g)
    calls = [lambda: aggregate_sample(xa, "vrmom", K=8),
             lambda: aggregate_sample(xb, "vrmom", K=8, top_k=50),
             lambda: aggregate_sample(xa, "vrmom", K=8, top_k=50,
                                      with_agg=False)]
    first = [c() for c in calls]
    for _ in range(3):
        for c, f in zip(calls, first):
            for got, want in zip(c(), f):
                if want is not None:
                    assert torch.equal(got, want)
    _b4_check(xa, top_k=50)
    _b4_check(xb, top_k=50)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [0, 50])
def test_cuda_b4_one_kernel_a_call(cuda, k):
    x = 4.0 * torch.randn((8, 4, 151936), device=cuda)
    [names] = kernels_in_calls([lambda: aggregate_sample(
        x, "vrmom", K=8, top_k=k, with_agg=False)])
    assert len(names) == 1 and "tail_kernel" in names[0], names


HEAD_DIMS = (32, 64, 96, 112, 128)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dh", HEAD_DIMS)
def test_cuda_b2_matches_plain(cuda, causal, dh):
    g = torch.Generator(device=cuda).manual_seed(dh)
    q = torch.randn(2, 50, 8, dh, device=cuda, generator=g)
    k = torch.randn(2, 61, 4, dh, device=cuda, generator=g)
    v = torch.randn(2, 61, 4, dh, device=cuda, generator=g)
    torch.testing.assert_close(flash_attention(q, k, v, causal=causal),
                               flash_attention_plain(q, k, v, causal=causal),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["float32", "bfloat16", "int8"])
def test_cuda_b3_matches_plain(cuda, kv):
    g = torch.Generator(device=cuda).manual_seed(3)
    q = torch.randn(4, 1, 16, 128, device=cuda, generator=g)
    k = torch.randn(4, 90, 8, 128, device=cuda, generator=g)
    v = torch.randn(4, 90, 8, 128, device=cuda, generator=g)
    ks = vs = None
    if kv == "int8":
        ks = torch.rand(4, 90, device=cuda, generator=g) * 0.02
        vs = torch.rand(4, 90, device=cuda, generator=g) * 0.02
        k = torch.randint(-127, 128, k.shape, device=cuda, generator=g,
                          dtype=torch.int8)
        v = torch.randint(-127, 128, v.shape, device=cuda, generator=g,
                          dtype=torch.int8)
    else:
        k, v = k.to(getattr(torch, kv)), v.to(getattr(torch, kv))
    lens = torch.tensor([90, 1, 45, 64], dtype=torch.int32, device=cuda)
    got = decode_attention(q, k, v, kv_len=lens, k_scale=ks, v_scale=vs)
    want = decode_attention_plain(q, k, v, lens, ks, vs)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


# B3's kv split: every length around a 32-key chunk edge, and the ends
SPLIT_LENS = (0, 1, 31, 32, 33, 63, 64, 65, 215, 216)


def _cache(g, B, T, Hkv, dh, kv, device):
    k = torch.randn(B, T, Hkv, dh, device=device, generator=g)
    v = torch.randn(B, T, Hkv, dh, device=device, generator=g)
    if kv != "int8":
        return k.to(getattr(torch, kv)), v.to(getattr(torch, kv)), None, None
    ks = torch.rand(B, T, device=device, generator=g) * 0.02
    vs = torch.rand(B, T, device=device, generator=g) * 0.02
    k8 = torch.randint(-127, 128, k.shape, device=device, generator=g,
                       dtype=torch.int8)
    v8 = torch.randint(-127, 128, v.shape, device=device, generator=g,
                       dtype=torch.int8)
    return k8, v8, ks, vs


@pytest.mark.cuda
@pytest.mark.parametrize("G", [1, 2, 8, 9, 16])
@pytest.mark.parametrize("dh", HEAD_DIMS)
@pytest.mark.parametrize("kv", ["float32", "bfloat16", "int8"])
def test_cuda_b3_split_boundaries(cuda, kv, dh, G):
    """Per-row lengths at every split edge (one row each) and the same
    lengths as a scalar kv_len: against the plain version, f32 q at 1e-4
    and bf16 q at 1e-2 + 1e-2 * |ref|. G 9 and 16 run the instance with
    the 16-head group bound; dh 96 and 112 compute on 128 columns."""
    g = torch.Generator(device=cuda).manual_seed(dh + G)
    B, T, Hkv = len(SPLIT_LENS), 216, 2
    k, v, ks, vs = _cache(g, B, T, Hkv, dh, kv, cuda)
    lens = torch.tensor(SPLIT_LENS, dtype=torch.int32, device=cuda)
    for q_dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
        q = torch.randn(B, 1, G * Hkv, dh, device=cuda, generator=g
                        ).to(q_dtype)
        got = decode_attention(q, k, v, kv_len=lens, k_scale=ks, v_scale=vs)
        want = decode_attention_plain(q.float(), k, v, lens, ks, vs)
        torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol)
        assert torch.all(got[0] == 0)  # length 0
        for n in SPLIT_LENS:
            got = decode_attention(q, k, v, kv_len=n, k_scale=ks, v_scale=vs)
            want = decode_attention_plain(q.float(), k, v,
                                          torch.full_like(lens, n), ks, vs)
            torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol)


@pytest.mark.cuda
def test_cuda_b3_batch32_rows_equal_batch4_rows(cuda):
    """The replicated serving path runs B3 at batch 32 (2 splits) and the
    shared path at batch 4 (7 splits): each row's output must be bitwise
    the same, since greedy tokens must not depend on the path."""
    g = torch.Generator(device=cuda).manual_seed(32)
    q = torch.randn(32, 1, 16, 128, device=cuda, generator=g
                    ).to(torch.bfloat16)
    k, v, _, _ = _cache(g, 32, 216, 8, 128, "bfloat16", cuda)
    lens = torch.randint(0, 217, (32,), device=cuda, generator=g,
                         dtype=torch.int32)
    for kv_len in (200, lens):
        big = decode_attention(q, k, v, kv_len=kv_len)
        small = torch.cat([decode_attention(
            q[i:i + 4], k[i:i + 4], v[i:i + 4],
            kv_len=kv_len if isinstance(kv_len, int) else
            kv_len[i:i + 4].contiguous()) for i in range(0, 32, 4)])
        torch.testing.assert_close(big, small, rtol=0, atol=0)
        want = decode_attention_plain(
            q.float(), k, v, lengths(kv_len, 32, 216, cuda))
        torch.testing.assert_close(big.float(), want, rtol=1e-2, atol=1e-2)


@pytest.mark.cuda
def test_cuda_attention_repeat_calls_bitwise_equal(cuda):
    """B3's ticket counters are left at zero and its merge runs in chunk
    order; B2 has no atomics: a second call gives the same bits."""
    g = torch.Generator(device=cuda).manual_seed(5)
    q = torch.randn(4, 1, 16, 128, device=cuda, generator=g
                    ).to(torch.bfloat16)
    k, v, _, _ = _cache(g, 4, 216, 8, 128, "bfloat16", cuda)
    first = decode_attention(q, k, v, kv_len=150)
    assert torch.equal(first, decode_attention(q, k, v, kv_len=150))
    qp = torch.randn(4, 192, 16, 128, device=cuda, generator=g
                     ).to(torch.bfloat16)
    kp, vp = k[:, :192].contiguous(), v[:, :192].contiguous()
    first = flash_attention(qp, kp, vp, causal=True)
    assert torch.equal(first, flash_attention(qp, kp, vp, causal=True))


@pytest.mark.cuda
@pytest.mark.parametrize("S,T", [(100, 150), (193, 193), (64, 64)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dh", HEAD_DIMS)
def test_cuda_b2_bf16_tensor_cores(cuda, dh, causal, S, T):
    """The wgmma body, ragged S and T: against the f32 plain version of
    the same bf16 inputs at 1e-2 + 1e-2 * |ref| (P is rounded to bf16
    before P.V, 2^-9 relative per weight, and the output once)."""
    g = torch.Generator(device=cuda).manual_seed(S + dh)
    q = torch.randn(2, S, 8, dh, device=cuda, generator=g).to(torch.bfloat16)
    k = torch.randn(2, T, 2, dh, device=cuda, generator=g).to(torch.bfloat16)
    v = torch.randn(2, T, 2, dh, device=cuda, generator=g).to(torch.bfloat16)
    got = flash_attention(q, k, v, causal=causal)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(
        got.float(), flash_attention_plain(q.float(), k.float(), v.float(),
                                           causal=causal),
        rtol=1e-2, atol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dh,H,Hkv", [(96, 32, 32), (112, 32, 32),
                                      (128, 36, 4), (128, 128, 8),
                                      (96, 18, 2), (112, 16, 1)])
def test_cuda_new_instances_launch(cuda, dh, H, Hkv):
    """A CUDA tensor at a head dim or group the first instances refused
    launches its kernel: the counter counts one launch a call, and the
    device kernel that ran is the instance for that head dim (and, in B3,
    the 16-head group bound past G = 8)."""
    g = torch.Generator(device=cuda).manual_seed(dh + H)
    q = torch.randn(2, 40, H, dh, device=cuda, generator=g).bfloat16()
    k, v = (torch.randn(2, 40, Hkv, dh, device=cuda, generator=g).bfloat16()
            for _ in range(2))
    qd = q[:, :1].contiguous()
    calls = [lambda: flash_attention(q, k, v, causal=True),
             lambda: decode_attention(qd, k, v, kv_len=33)]
    reset_launch_counts()
    for call in calls:
        call()
    counts = launch_counts()
    assert counts["flash_attention"] == 1 and counts["decode_attention"] == 1
    names = kernels_in_calls(calls)
    assert [kernel_instance(n, "flash_fwd_wgmma")
            for n in names[0]] == [(dh,)]
    maxg = 8 if H // Hkv <= 8 else 16
    assert [kernel_instance(n, "decode_split_kernel")
            for n in names[1]] == [(dh, maxg)]


@pytest.mark.cuda
def test_cuda_uncompiled_shapes_raise(cuda):
    """A head dim or group with no instance raises, naming ROADMAP, and
    launches nothing."""
    q = torch.zeros(1, 4, 32, 80, device=cuda, dtype=torch.bfloat16)
    kv = torch.zeros(1, 4, 32, 80, device=cuda, dtype=torch.bfloat16)
    reset_launch_counts()
    with pytest.raises(ValueError, match="ROADMAP"):
        flash_attention(q, kv, kv)
    with pytest.raises(ValueError, match="ROADMAP"):
        decode_attention(q[:, :1].contiguous(), kv, kv)
    q32 = torch.zeros(1, 1, 32, 128, device=cuda, dtype=torch.bfloat16)
    kv1 = torch.zeros(1, 4, 1, 128, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="ROADMAP"):
        decode_attention(q32, kv1, kv1)
    assert launch_counts()["flash_attention"] == 0
    assert launch_counts()["decode_attention"] == 0


@pytest.mark.cuda
def test_cuda_b3_group_instances_agree(cuda):
    """G <= 8 run on the 16-head instance would give the same bits as on the
    8-head one: the same group served as 2 kv heads of 8 (the 8 bound) and
    as heads of a G = 16 call whose other half is another query."""
    g = torch.Generator(device=cuda).manual_seed(16)
    k, v, _, _ = _cache(g, 4, 216, 1, 128, "bfloat16", cuda)
    q16 = torch.randn(4, 1, 16, 128, device=cuda, generator=g).bfloat16()
    both = decode_attention(q16, k, v, kv_len=150)
    lo = decode_attention(q16[:, :, :8].contiguous(), k, v, kv_len=150)
    hi = decode_attention(q16[:, :, 8:].contiguous(), k, v, kv_len=150)
    torch.testing.assert_close(both, torch.cat([lo, hi], dim=2), rtol=0,
                               atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_cuda_engine_kernels_match_plain_path(cuda, kv_dtype):
    """The reduced model served on the card: the kernel path (flash
    attention, decode attention, fused tail) gives the same greedy tokens
    as the plain path (torch attention, torch estimator), and every kernel
    ran: the profiler's trace holds each launch, replayed or eager; the
    wrappers count the eager ones (the prefill, token 0 and the step run
    before the capture)."""
    cfg = dataclasses.replace(get_arch("qwen3-1.7b").reduced(),
                              kv_dtype=kv_dtype)
    params = M.init(cfg, torch.Generator(device=cuda).manual_seed(0),
                    device=cuda)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 12), device=cuda)}
    plain = ServeEngine(cfg, params, max_len=40, attn_backend="torch",
                        robust=RobustDecodeConfig(m=8, estimator=Estimator(
                            "vrmom", K=8, backend="torch")), device=cuda)
    reset_launch_counts()
    fused = ServeEngine(cfg, params, max_len=40, attn_backend="flash",
                        robust=RobustDecodeConfig(m=8, attack="signflip"),
                        device=cuda)
    def generate():
        # a trace that lost its spin calls this again: each call counts
        # from 0 and captures anew, as the first did
        fused.graphs.clear()
        reset_launch_counts()
        return fused.generate(batch, 10)

    toks, ran = device_kernel_counts(generate, DEVICE_KERNELS)
    counts = launch_counts()
    assert ran == {"flash_fwd": cfg.n_layers,
                   "decode_split_kernel": cfg.n_layers * 9,
                   "tail_kernel": 10, "agg_kernel": 0}
    assert counts["flash_attention"] == cfg.n_layers
    assert counts["decode_attention"] == cfg.n_layers
    assert counts["aggregate_sample"] == 2
    torch.testing.assert_close(toks, plain.generate(batch, 10), rtol=0,
                               atol=0)


# -- the decode step captured as a CUDA graph and replayed (ServeEngine) -----

def _served(cuda):
    cfg = get_arch("qwen3-1.7b").reduced()
    params = M.init(cfg, torch.Generator(device=cuda).manual_seed(0),
                    device=cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 12), generator=g,
                                     device=cuda)}
    return cfg, params, batch


@pytest.mark.cuda
@pytest.mark.parametrize("share", [True, False], ids=["shared",
                                                      "replicated"])
@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("attack", ["none", "signflip", "gaussian", "alie",
                                    "mimic"])
def test_cuda_replay_equals_eager_greedy(cuda, attack, fuse, share):
    """``generate`` (one eager step on the capture stream, then replays of
    the captured step) gives the eager loop's greedy tokens bitwise, under
    every kind of attack: none, deterministic, random (gaussian) and
    omniscient (alie, mimic: statistics of the honest rows on the
    device)."""
    _replay_equals_eager(cuda, RobustDecodeConfig(
        m=8, attack=attack, fuse_tail=fuse, share_replica_compute=share))


@pytest.mark.cuda
def test_cuda_replay_equals_eager_plain(cuda):
    _replay_equals_eager(cuda, None)


def _replay_equals_eager(cuda, robust):
    cfg, params, batch = _served(cuda)
    eng = ServeEngine(cfg, params, max_len=40, robust=robust, device=cuda)
    got = eng.generate(batch, 10,
                       generator=torch.Generator(device=cuda).manual_seed(5))
    want = eng.generate_python_loop(
        batch, 10, generator=torch.Generator(device=cuda).manual_seed(5))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    (st,) = eng.graphs.values()
    assert st.graph is not None and st.replays == 8


@pytest.mark.cuda
@pytest.mark.parametrize("attack", ["none", "gaussian"])
@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("method", ["top_k", "temperature"])
def test_cuda_replay_equals_eager_sampled(cuda, method, fuse, attack):
    """Top-k and temperature sampling (and the gaussian attack's noise)
    draw from the caller's generator inside the replayed graph as in the
    eager step: one seed, the same tokens, the generator in the same state
    after, and again on a second generate that reuses the graph."""
    from repro_torch.serve import Sampling

    cfg, params, batch = _served(cuda)
    sc = (Sampling("top_k", 1.3, top_k=5) if method == "top_k"
          else Sampling("temperature", 1.5))
    eng = ServeEngine(cfg, params, max_len=40, device=cuda,
                      robust=RobustDecodeConfig(m=8, attack=attack,
                                                fuse_tail=fuse))
    ga = torch.Generator(device=cuda).manual_seed(9)
    gb = torch.Generator(device=cuda).manual_seed(9)
    for _ in range(2):
        got = eng.generate(batch, 10, sc, generator=ga)
        want = eng.generate_python_loop(batch, 10, sc, generator=gb)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        assert torch.equal(ga.get_state(), gb.get_state())
    assert len(eng.graphs) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
def test_cuda_tickets_zero_after_replays(cuda, fuse):
    """B3's and B4's ticket counters, which a replay reuses as captured,
    read zero after 50 replays: the engine's (made on its capture stream,
    which PyTorch may hand out again from its pool) and every other."""
    import sys

    cfg, params, batch = _served(cuda)
    eng = ServeEngine(cfg, params, max_len=64, device=cuda,
                      robust=RobustDecodeConfig(m=8, fuse_tail=fuse))
    eng.generate(batch, 52)  # token 0, one eager step, 50 replays
    (st,) = eng.graphs.values()
    assert st.replays == 50
    torch.cuda.synchronize()
    stream = eng.capture_stream.cuda_stream
    dec = sys.modules["repro_torch.kernels.decode_attention"]._STATE
    tail = sys.modules["repro_torch.kernels.vrmom"]._STATE
    assert any(k[1] == stream for k in dec)
    if fuse:
        assert any(k[1] == stream for k in tail)
    tickets = [v[5] for v in dec.values()] + [v[3] for v in tail.values()]
    for t in tickets:
        assert int(t.abs().sum()) == 0


@pytest.mark.cuda
def test_cuda_second_generate_reuses_graph(cuda):
    """A second generate of the same signature replays the graph it has
    over the same buffers (every step a replay: the trace holds every
    decode kernel, the wrappers count none), on new prompts too, with a
    fresh engine's tokens."""
    cfg, params, batch = _served(cuda)
    other = {"tokens": torch.flip(batch["tokens"], dims=(1,))}
    rc = RobustDecodeConfig(m=8, attack="signflip")
    eng = ServeEngine(cfg, params, max_len=40, robust=rc, device=cuda)
    first = eng.generate(batch, 10)
    (st,) = eng.graphs.values()
    graph, buf = st.graph, eng.buffers
    calls = []

    def generate():
        # a trace that lost its spin calls this again: each call counts
        # from 0, and each replays the graph 9 times
        calls.append(1)
        reset_launch_counts()
        return eng.generate(batch, 10)

    again, ran = device_kernel_counts(generate, DEVICE_KERNELS)
    counts = launch_counts()
    assert ran["decode_split_kernel"] == cfg.n_layers * 9
    assert ran["tail_kernel"] == 10
    assert counts["decode_attention"] == 0
    assert counts["aggregate_sample"] == 1  # token 0, off the prefill
    moved = eng.generate(other, 10)
    (st2,) = eng.graphs.values()
    assert st2 is st and st.graph is graph
    assert st.replays == 8 + 9 * len(calls) + 9
    assert eng.buffers is buf
    torch.testing.assert_close(first, again, rtol=0, atol=0)
    fresh = ServeEngine(cfg, params, max_len=40, robust=rc, device=cuda)
    torch.testing.assert_close(again, fresh.generate(batch, 10), rtol=0,
                               atol=0)
    torch.testing.assert_close(moved, fresh.generate(other, 10), rtol=0,
                               atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("share", [True, False], ids=["shared",
                                                      "replicated"])
def test_cuda_sampling_graphs_share_buffers_and_evict(cuda, share):
    """Each sampling config captures its own step over the one set of
    buffers (and one memory pool); past MAX_GRAPHS the least recently
    used is dropped. Interleaved, every generate gives the eager loop's
    tokens from one seed."""
    from repro_torch.serve import Sampling
    from repro_torch.serve.engine import GREEDY, MAX_GRAPHS

    cfg, params, batch = _served(cuda)
    eng = ServeEngine(cfg, params, max_len=40, device=cuda,
                      robust=RobustDecodeConfig(
                          m=8, attack="gaussian",
                          share_replica_compute=share))
    order = [GREEDY, Sampling("top_k", 1.3, top_k=5),
             Sampling("temperature", 1.5), GREEDY,
             Sampling("temperature", 0.7), Sampling("top_k", 1.0, top_k=3),
             Sampling("top_k", 1.3, top_k=5)]
    buf = None
    for i, sc in enumerate(order):
        got = eng.generate(batch, 10, sc,
                           generator=torch.Generator(device=cuda)
                           .manual_seed(i))
        want = eng.generate_python_loop(
            batch, 10, sc, generator=torch.Generator(device=cuda)
            .manual_seed(i))
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        buf = buf or eng.buffers
        assert eng.buffers is buf and len(eng.graphs) <= MAX_GRAPHS
    assert MAX_GRAPHS == 4
    # top-k 5 went when top-k 3 came in (greedy, used again at step 3,
    # stayed), then temperature 1.5 when top-k 5 was captured again
    assert list(eng.graphs) == [GREEDY, Sampling("temperature", 0.7),
                                Sampling("top_k", 1.0, top_k=3),
                                Sampling("top_k", 1.3, top_k=5)]


@pytest.mark.cuda
def test_cuda_generate_prefills_into_the_buffers(cuda):
    """The prefill writes straight into the engine's buffers: a second
    generate allocates at its peak well under one stacked cache of 8
    layers (a layer's padded K/V passes through; a prefill into new caches
    would hold all layers', then stack them); a new batch size replaces
    the buffers and drops the steps captured over them."""
    cfg, params, batch = _served(cuda)
    cfg = dataclasses.replace(cfg, n_layers=8)
    params = M.init(cfg, torch.Generator(device=cuda).manual_seed(0),
                    device=cuda)
    eng = ServeEngine(cfg, params, max_len=4096, device=cuda)
    eng.generate(batch, 4)
    cache_bytes = sum(x.numel() * x.element_size()
                      for x in eng.buffers.caches if x is not None)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = eng.generate(batch, 4)
    assert torch.cuda.max_memory_allocated() - base < cache_bytes // 2
    torch.testing.assert_close(got, eng.generate_python_loop(batch, 4),
                               rtol=0, atol=0)
    one = {"tokens": batch["tokens"][:1]}
    got1 = eng.generate(one, 4)
    assert eng.buffers.batch == 1 and eng.buffers.tok.shape == (1,)
    (st,) = eng.graphs.values()
    assert st.replays == 2
    torch.testing.assert_close(got1, eng.generate_python_loop(one, 4),
                               rtol=0, atol=0)


@pytest.mark.cuda
def test_cuda_capture_of_a_host_read_raises(cuda, monkeypatch):
    """A step that reads a device value on the host cannot be captured:
    ``generate`` raises and does not fall back to the eager loop (only the
    eager first step ran)."""
    import repro_torch.serve.engine as E

    real = E.sample_tokens

    def reads_host(logits, generator, sc):
        tok = real(logits, generator, sc)
        int(tok[0])  # a device value read on the host
        return tok

    cfg, params, batch = _served(cuda)
    monkeypatch.setattr(E, "sample_tokens", reads_host)
    eng = ServeEngine(cfg, params, max_len=40, device=cuda)
    reset_launch_counts()
    with pytest.raises(RuntimeError, match="capturing the decode step"):
        eng.generate(batch, 10)
    assert launch_counts()["decode_attention"] == cfg.n_layers
    assert not eng.graphs
    monkeypatch.setattr(E, "sample_tokens", real)
    torch.testing.assert_close(eng.generate(batch, 10),
                               eng.generate_python_loop(batch, 10), rtol=0,
                               atol=0)


# -- the slot pool: its step captured and replayed (decode_pool) -------------

def _pool_requests(cfg, n, seed):
    rs = np.random.RandomState(seed)
    return [(rs.randint(0, cfg.vocab, size=(int(rs.randint(4, 20)),)),
             int(rs.randint(3, 12))) for _ in range(n)]


def _eager_decode(eng):
    """``eng``'s ``_decode`` run eagerly on the card, every step a launch of
    each of its kernels: the baseline a replayed pool is held against."""
    def run(buf, steps, generator, sc, graphs):
        for _ in range(steps):
            eng._step(buf, generator, sc)
    return run


def _pool_serve(cuda, cfg, params, reqs, mode, robust, sampling=None,
                obs=None):
    from repro_torch.serve import Request, Sampling, Scheduler

    eng = ServeEngine(cfg, params, max_len=40, n_slots=3, robust=robust,
                      obs=obs, device=cuda)
    if mode == "eager":
        eng._decode = _eager_decode(eng)
    sched = Scheduler(eng, decode_block=3, seed=5,
                      sampling=sampling or Sampling())
    uids = [sched.submit(Request(tokens=p, max_new_tokens=n))
            for p, n in reqs]
    done = sched.run()
    return [done[u].tokens for u in uids], eng


@pytest.mark.cuda
@pytest.mark.parametrize("share", [True, False], ids=["shared",
                                                      "replicated"])
@pytest.mark.parametrize("attack,method", [
    ("none", "greedy"), ("signflip", "greedy"), ("gaussian", "greedy"),
    ("gaussian", "top_k"), ("none", "temperature")])
def test_cuda_pool_replay_equals_eager(cuda, attack, method, share):
    """Seven requests through three slots (admissions between blocks,
    evictions, slots reused): the scheduler over the replayed pool gives
    the tokens of the same scheduler over an eagerly decoded pool, bitwise,
    from one seed; the pool's step was captured once and replayed."""
    from repro_torch.serve import Sampling

    cfg, params, _ = _served(cuda)
    reqs = _pool_requests(cfg, 7, 3)
    sc = {"greedy": Sampling(), "top_k": Sampling("top_k", 1.3, top_k=5),
          "temperature": Sampling("temperature", 1.5)}[method]
    robust = RobustDecodeConfig(m=8, attack=attack,
                                share_replica_compute=share)
    got, eng = _pool_serve(cuda, cfg, params, reqs, "graph", robust, sc)
    want, _ = _pool_serve(cuda, cfg, params, reqs, "eager", robust, sc)
    assert got == want
    assert all(len(t) == n for t, (_, n) in zip(got, reqs))
    (st,) = eng.pool_graphs.values()
    assert st.replays > 3 and not eng.graphs


@pytest.mark.cuda
def test_cuda_pool_admission_leaves_other_slots(cuda):
    """An admission between two blocks, into the pool whose step was
    captured in the first, leaves the other slots' tokens bitwise as they
    are without it: admission writes into the tensors the graph reads."""
    cfg, params, _ = _served(cuda)
    eng = ServeEngine(cfg, params, max_len=48, n_slots=3, device=cuda,
                      robust=RobustDecodeConfig(m=8, attack="signflip"))
    a, b, c = (p for p, _ in _pool_requests(cfg, 3, 8))

    def run(admit_late):
        pool = eng.make_pool()
        pool, fa = eng.admit(pool, 0, {"tokens": a[None]})
        pool, fb = eng.admit(pool, 1, {"tokens": b[None]})
        cur = torch.tensor([fa, fb, 0], dtype=torch.int32, device=cuda)
        pool, t1 = eng.decode_pool(pool, cur, 4)
        cur = t1[-1].clone()
        if admit_late:
            pool, fc = eng.admit(pool, 2, {"tokens": c[None]})
            cur[2] = fc
        pool, t2 = eng.decode_pool(pool, cur, 4)
        assert eng.pool_graphs[next(iter(eng.pool_graphs))].replays == 7
        return torch.cat([t1, t2]), pool

    alone, _ = run(False)
    beside, pool = run(True)
    torch.testing.assert_close(alone[:, :2], beside[:, :2], rtol=0, atol=0)
    assert pool.lengths.tolist() == [len(a) + 8, len(b) + 8, len(c) + 4]


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_cuda_b3_ragged_batch32_matches_plain(cuda, kv):
    """B3 at the pool's shape: 32 rows, each with its own length (1, the
    chunk edges, the whole cache), against the plain version, and each row
    bitwise as at batch 1."""
    g = torch.Generator(device=cuda).manual_seed(32)
    T = 512
    q = torch.randn((32, 1, 16, 128), generator=g, device=cuda).to(
        torch.bfloat16)
    k, v, ks, vs = _cache(g, 32, T, 8, 128, kv, cuda)
    lens = torch.randint(1, T + 1, (32,), generator=g, device=cuda,
                         dtype=torch.int32)
    lens[:6] = torch.tensor([1, 31, 32, 33, T - 1, T], dtype=torch.int32)
    out = decode_attention(q, k, v, kv_len=lens, k_scale=ks, v_scale=vs)
    torch.testing.assert_close(
        out.float(), decode_attention_plain(q.float(), k, v, lens, ks, vs),
        atol=1e-2, rtol=1e-2)
    for i in range(32):
        one = decode_attention(
            q[i:i + 1], k[i:i + 1], v[i:i + 1], kv_len=lens[i:i + 1],
            k_scale=None if ks is None else ks[i:i + 1],
            v_scale=None if vs is None else vs[i:i + 1])
        assert torch.equal(out[i:i + 1], one)


@pytest.mark.cuda
def test_cuda_pool_diag_counts_replay_equal_eager(cuda):
    """The disagreement counts the replayed step adds on the device equal
    the eager step's (the gaussian attack's rates vary token by token);
    the count is the live slots' tokens."""
    from repro_torch.obs import MetricsRegistry

    cfg, params, _ = _served(cuda)
    reqs = _pool_requests(cfg, 7, 4)
    robust = RobustDecodeConfig(m=8, attack="gaussian", alpha=0.25)
    regs = {}
    for mode in ("graph", "eager"):
        regs[mode] = MetricsRegistry()
        _pool_serve(cuda, cfg, params, reqs, mode, robust, obs=regs[mode])
    h = {m: r.histograms["serve.replica_disagreement"].snapshot()
         for m, r in regs.items()}
    assert h["graph"] == h["eager"]
    live = 3 * sum(-(-(n - 1) // 3) for _, n in reqs)
    assert h["graph"]["count"] == live and h["graph"]["sum"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("k", [0, 50])
def test_cuda_b4_with_agg_tokens_in_a_graph(cuda, k):
    """Inside one CUDA graph, B4 with ``with_agg=True`` (the obs path)
    selects the tokens (or top-k lists) of ``with_agg=False`` bitwise, and
    its aggregate equals B1's, replay after replay on new inputs."""
    g = torch.Generator(device=cuda).manual_seed(4)
    x = 4.0 * torch.randn((8, 32, 151936), generator=g, device=cuda)
    s = torch.cuda.Stream(cuda)
    s.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(s):  # the per-stream state, before the capture
        aggregate_sample(x, "vrmom", K=8, top_k=k, with_agg=True)
        aggregate_sample(x, "vrmom", K=8, top_k=k, with_agg=False)
    torch.cuda.current_stream(cuda).wait_stream(s)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=s):
        # reprolint-torch: disable=RL003 x on the card; K 8's table on the host
        on = aggregate_sample(x, "vrmom", K=8, top_k=k, with_agg=True)
        off = aggregate_sample(x, "vrmom", K=8, top_k=k, with_agg=False)
    for seed in range(3):
        x.copy_(4.0 * torch.randn(x.shape, generator=g, device=cuda))
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(on[1:], off[1:]):
            assert torch.equal(a, b)
        assert torch.equal(on[0], aggregate(x, "vrmom", K=8))


@pytest.mark.cuda
def test_cuda_pool_capture_of_a_host_read_raises(cuda, monkeypatch):
    """A pool step that reads the host cannot be captured: ``decode_pool``
    raises, and does not decode the pool eagerly."""
    import repro_torch.serve.engine as E

    real = E.sample_tokens

    def reads_host(logits, generator, sc):
        tok = real(logits, generator, sc)
        int(tok[0])
        return tok

    cfg, params, batch = _served(cuda)
    monkeypatch.setattr(E, "sample_tokens", reads_host)
    eng = ServeEngine(cfg, params, max_len=40, n_slots=2, device=cuda)
    pool = eng.make_pool()
    pool, first = eng.admit(pool, 0, {"tokens": batch["tokens"][:1]})
    reset_launch_counts()
    with pytest.raises(RuntimeError, match="capturing the decode step"):
        eng.decode_pool(pool, [first, 0], 4)
    assert launch_counts()["decode_attention"] == cfg.n_layers
    assert not eng.pool_graphs


# ---------------------------------------------------------------------------
# training: B2 under autograd, B1 on the gradient stacks, the train step
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_b2_at_the_training_length(cuda):
    """B2 at qwen3-1.7b's training shape, S = T = 4096 (the prefills reach
    448), against its plain version at the file's bf16 tolerance."""
    g = torch.Generator(device=cuda).manual_seed(40)
    q = torch.randn((1, 4096, 16, 128), generator=g, device=cuda,
                    dtype=torch.bfloat16)
    k = torch.randn((1, 4096, 8, 128), generator=g, device=cuda,
                    dtype=torch.bfloat16)
    v = torch.randn((1, 4096, 8, 128), generator=g, device=cuda,
                    dtype=torch.bfloat16)
    want = flash_attention_plain(q.float(), k.float(), v.float(), causal=True)
    got = flash_attention(q, k, v, causal=True)
    torch.testing.assert_close(got.float(), want, rtol=1e-2, atol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_b2_autograd_grads_match_the_plain_path(cuda, dtype):
    """FlashAttentionFn (B2 forward, the backward recomputed through
    ``mha``) against ``mha`` under autograd: the output at the file's
    attention tolerance, the gradients at the same (f32) or within 2e-2 of
    the largest (bf16: B2 and ``mha`` round P to bf16 at other places)."""
    from repro_torch.models.attention import mha
    from repro_torch.models.attn_backend import FlashAttentionFn

    g = torch.Generator(device=cuda).manual_seed(41)
    shape_q, shape_kv = (2, 200, 8, 64), (2, 200, 4, 64)
    q, k, v = (torch.randn(s, generator=g, device=cuda).to(dtype)
               for s in (shape_q, shape_kv, shape_kv))
    dout = torch.randn(shape_q, generator=g, device=cuda).to(dtype)
    reset_launch_counts()
    qa, ka, va = (t.clone().requires_grad_(True) for t in (q, k, v))
    out = FlashAttentionFn.apply(qa, ka, va, True, 64)
    got = torch.autograd.grad(out, (qa, ka, va), dout)
    assert launch_counts()["flash_attention"] == 1
    qb, kb, vb = (t.clone().requires_grad_(True) for t in (q, k, v))
    ref = mha(qb, kb, vb, causal=True, window=None, chunk=64)
    want = torch.autograd.grad(ref, (qb, kb, vb), dout)
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    for a, b in zip(got, want):
        if dtype == torch.float32:
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
        else:
            err = float((a.float() - b.float()).abs().max())
            assert err <= 2e-2 * float(b.float().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1_000_003, 28 * 2048 * 6144],
                         ids=["ragged", "w_gate"])
def test_cuda_b1_bf16_equals_f32_then_cast(cuda, C):
    """The stacked train step feeds B1 the bf16 gradient stack itself;
    ``repro`` casts it to f32, aggregates and casts back. Bitwise equal,
    at a ragged width and at qwen3-1.7b's widest leaf
    (``layers.mlp.w_gate``, [8, 352,321,536])."""
    g = torch.Generator(device=cuda).manual_seed(42)
    x = torch.randn((8, C), generator=g, device=cuda, dtype=torch.bfloat16)
    for method in ("vrmom", "median", "trimmed_mean", "mean"):
        got = aggregate(x, method, K=10, beta=0.125)
        want = aggregate(x.float(), method, K=10, beta=0.125).to(
            torch.bfloat16)
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, want), method


@pytest.mark.cuda
def test_cuda_b1_past_2_31_elements(cuda):
    """[8, 300,000,000] bf16 (2.4e9 elements, past 2^31): the 64-bit
    indexing of B1, against the plain version on sampled columns (the
    last ones included)."""
    C = 300_000_000
    g = torch.Generator(device=cuda).manual_seed(43)
    x = torch.randn((8, C), generator=g, device=cuda, dtype=torch.bfloat16)
    out = aggregate(x, "vrmom", K=10)
    cols = torch.cat([torch.randint(0, C, (1 << 20,), generator=g,
                                    device=cuda),
                      torch.arange(C - 4096, C, device=cuda)])
    want = aggregate_plain(x[:, cols], "vrmom", K=10)
    assert torch.equal(out[cols], want)


@pytest.mark.cuda
@pytest.mark.parametrize("method,attack", [("median", "signflip"),
                                           ("trimmed_mean", "omniscient")])
def test_cuda_stacked_steps_match_the_cpu(cuda, method, attack):
    """Two stacked steps of the reduced model (f32) on the card against the
    same steps on the CPU, at 1e-4 (the file's f32 attention tolerance;
    the matmuls sum in other orders). On the card each step launches B1
    once a leaf and B2 twice a layer and worker (remat on: the forward and
    its recompute)."""
    from repro_torch import optim as O
    from repro_torch.data import lm_batch
    from repro_torch.train.step import make_train_step

    cfg = dataclasses.replace(get_arch("qwen3-1.7b").reduced(), remat=True)
    out = {}
    for dev in ("cpu", cuda):
        params = _to(M.init(cfg, torch.Generator().manual_seed(0),
                            device="cpu"), dev)
        opt = O.get("sgd", lr=0.5, momentum=0.9)
        setup = make_train_step(cfg, 4,
                                estimator=Estimator(method, beta=0.25),
                                optimizer=opt,
                                byzantine_frac=0.4, attack=attack,
                                device=dev)
        st = opt.init(params)
        reset_launch_counts()
        for i in range(2):
            params, st, loss = setup.step_fn(
                params, st, lm_batch(cfg, i, 8, 40, device=dev))
        out[str(dev)] = (params, float(loss), launch_counts())
    (p_cpu, l_cpu, _), (p_gpu, l_gpu, counts) = out["cpu"], out[str(cuda)]
    assert abs(l_cpu - l_gpu) <= 1e-4
    from repro_torch.tree import leaves

    for a, b in zip(leaves(p_cpu), leaves(p_gpu)):
        torch.testing.assert_close(b.cpu(), a, rtol=1e-4, atol=1e-4)
    n_leaves = len(list(leaves(p_cpu)))
    assert counts["aggregate"] == 2 * n_leaves
    assert counts["flash_attention"] == 2 * 4 * cfg.n_layers * 2


def _to(tree, dev):
    from repro_torch.tree import tree_map

    return tree_map(lambda v: v.to(dev), tree)


@pytest.mark.cuda
def test_cuda_inloop_step_launches_b1_per_product(cuda):
    """An inloop step of the reduced model on the card: B1 once for each
    product's dW (7 a layer, and the unembedding once a loss chunk: 40
    tokens in chunks of 32), B2 twice a layer."""
    from repro_torch.data import lm_batch
    from repro_torch.train.step import make_train_step

    cfg = dataclasses.replace(get_arch("qwen3-1.7b").reduced(), remat=True)
    params = M.init(cfg, torch.Generator(device=cuda).manual_seed(0),
                    device=cuda)
    setup = make_train_step(cfg, 4, estimator="vrmom", mode="inloop",
                            device=cuda)
    st = setup.optimizer.init(params)
    reset_launch_counts()
    _, _, loss = setup.step_fn(params, st, lm_batch(cfg, 0, 8, 40,
                                                    device=cuda))
    assert np.isfinite(float(loss))
    counts = launch_counts()
    assert counts["aggregate"] == 7 * cfg.n_layers + 2
    assert counts["flash_attention"] == 2 * cfg.n_layers


# -- the adaptive tier (core.adaptive): B1 for the centre and the rungs ------

def _adaptive_stack(cuda, seed, shape, dup_rows=0):
    x = torch.from_numpy(np.random.RandomState(seed).randn(*shape)
                         .astype(np.float32) + 2.0)
    if dup_rows:
        x[-dup_rows:] = -0.05 * x[:-dup_rows].mean(0)
    return x.to(cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,axis", [((8, 4096), 0), ((3, 101, 5), 1),
                                        ((8, 4, 151936), 0)])
def test_cuda_adaptive_honest_bit_identical(cuda, shape, axis):
    """Honest stacks on the card: vrmom_adaptive is B1's vrmom bit for bit
    (one B1 launch for the census centre and one a rung: K 10, 5, 1),
    auto_gm is the geometric median bit for bit, alpha_hat is 0."""
    from repro_torch.core import adaptive as AD

    x = _adaptive_stack(cuda, 0, shape)
    reset_launch_counts()
    got = Estimator("vrmom_adaptive", K=10).apply(x, axis=axis)
    assert launch_counts()["aggregate"] == 4
    want = Estimator("vrmom", K=10).apply(x, axis=0) if axis == 0 else \
        torch.stack([Estimator("vrmom", K=10).apply(x[r])
                     for r in range(x.shape[0])])
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(
        Estimator("auto_gm").apply(x, axis=axis),
        Estimator("geometric_median").apply(x, axis=axis), rtol=0, atol=0)
    assert not bool(AD.estimate_alpha(x, axis=axis, backend="auto").any())


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["vrmom_adaptive", "auto_gm"])
def test_cuda_adaptive_matches_the_cpu(cuda, method):
    """An attacked stack (2 of 8 rows one payload) on the card against the
    same stack on the CPU: the census exactly, the aggregate at 1e-5."""
    from repro_torch.core import adaptive as AD

    x = _adaptive_stack(cuda, 1, (8, 3000), dup_rows=2)
    a = AD.census(x, backend="auto")
    b = AD.census(x.cpu(), backend="auto")
    for f in ("cluster_size", "suspected", "alpha_hat", "weights", "center"):
        torch.testing.assert_close(getattr(a, f).cpu(), getattr(b, f),
                                   rtol=0, atol=0)
    assert a.suspected.tolist() == [False] * 6 + [True] * 2
    torch.testing.assert_close(Estimator(method, K=8).apply(x).cpu(),
                               Estimator(method, K=8).apply(x.cpu()),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["vrmom_adaptive", "auto_gm"])
@pytest.mark.parametrize("attack", ["none", "signflip", "gaussian"])
def test_cuda_adaptive_tail_replay_equals_eager(cuda, attack, method):
    """The adaptive serving tail inside the captured decode step (no host
    read in the census): ``generate``'s replays give the eager loop's
    tokens, which are the plain engine's under every attack."""
    _replay_equals_eager(cuda, RobustDecodeConfig(
        m=8, estimator=Estimator(method, K=8), attack=attack))
    cfg, params, batch = _served(cuda)
    plain = ServeEngine(cfg, params, max_len=40, device=cuda).generate(
        batch, 10)
    eng = ServeEngine(cfg, params, max_len=40, device=cuda,
                      robust=RobustDecodeConfig(
                          m=8, estimator=Estimator(method, K=8),
                          attack=attack))
    got = eng.generate(batch, 10,
                       generator=torch.Generator(device=cuda).manual_seed(5))
    torch.testing.assert_close(got, plain, rtol=0, atol=0)


@pytest.mark.cuda
def test_cuda_chunked_census_equals_unchunked(cuda, monkeypatch):
    """The training wire's block-by-block census of a bf16 tree equals the
    census of its raveled f32 wire (masks, counts, weights, alpha_hat
    exactly; z at 1e-5), and its aggregates at any block size agree
    (vrmom_adaptive bitwise: columns are independent)."""
    from repro_torch.core import adaptive as AD
    from repro_torch.dist import robust_reduce as RR
    from repro_torch.tree import leaves

    g = {"a": _adaptive_stack(cuda, 2, (8, 300, 70), 2),
         "b": _adaptive_stack(cuda, 3, (8, 5000), 2)}
    g = {k: v.to(torch.bfloat16) for k, v in g.items()}
    wire = torch.cat([v.reshape(8, -1).float() for v in leaves(g)], dim=1)
    want = AD.census(wire, backend="auto")
    for chunk in (999, 1 << 22):
        monkeypatch.setattr(RR, "WIRE_CHUNK", chunk)
        got = RR._wire_census(list(leaves(g)), True)
        torch.testing.assert_close(got.z, want.z, rtol=1e-5, atol=1e-5)
        for f in ("cluster_size", "suspected", "alpha_hat", "weights"):
            torch.testing.assert_close(getattr(got, f), getattr(want, f),
                                       rtol=0, atol=0)
    assert want.suspected.tolist() == [False] * 6 + [True] * 2
    outs = {}
    for chunk in (999, 1 << 22):
        monkeypatch.setattr(RR, "WIRE_CHUNK", chunk)
        outs[chunk] = {m: RR.aggregate_stacked_auto(g, m)
                       for m in ("vrmom_adaptive", "auto_gm")}
    for a, b in zip(leaves(outs[999]["vrmom_adaptive"]),
                    leaves(outs[1 << 22]["vrmom_adaptive"])):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for a, b in zip(leaves(outs[999]["auto_gm"]),
                    leaves(outs[1 << 22]["auto_gm"])):
        torch.testing.assert_close(a.float(), b.float(), rtol=1e-2,
                                   atol=1e-2)


# -- the consensus backend (dist.consensus): B1 a fault-free round ------------

def _consensus_same(a, b):
    """Consensus outputs and aux bitwise (aux fields moved to the CPU)."""
    from repro_torch.tree import leaves

    out_a, aux_a = a
    out_b, aux_b = b
    for x, y in zip(leaves(out_a), leaves(out_b)):
        torch.testing.assert_close(x.cpu(), y.cpu(), rtol=0, atol=0,
                                   equal_nan=True)
    for name in aux_a._fields:
        torch.testing.assert_close(getattr(aux_a, name).cpu(),
                                   getattr(aux_b, name).cpu(), rtol=0,
                                   atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_consensus_fault_free_is_the_direct_aggregate(cuda, method,
                                                           dtype):
    """Fault-free consensus on the card (trim mean, no pin) is the port's
    direct aggregate bit for bit, leaf by leaf in its dtype, and launches
    B1 once a column block (rows equal after round 1 are not aggregated
    again); with a pinned row every round runs B1 on each block."""
    from repro_torch.dist import robust_reduce as RR
    from repro_torch.dist.consensus import ConsensusConfig
    from repro_torch.tree import leaves

    est = Estimator(method, beta=0.25)
    g = {"a": _stack(70, (8, 30, 70), cuda).to(dtype),
         "b": _stack(71, (8, 5001), cuda).to(dtype)}
    cfg = ConsensusConfig(f=1)
    reset_launch_counts()
    got = RR.aggregate_stacked_auto(g, est, reduce_backend="consensus",
                                    consensus=cfg)
    n_b1 = launch_counts()["aggregate"]
    direct = RR.aggregate_stacked_auto(g, est)
    for x, y in zip(leaves(got[0]), leaves(direct)):
        assert x.dtype == dtype
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert int(got[1].rounds_to_eps) <= 1
    if method != "mean":  # "auto" runs the mean on the ref backend
        assert n_b1 == 2
        reset_launch_counts()
        RR.aggregate_stacked_auto(g, est, reduce_backend="consensus",
                                  consensus=cfg,
                                  pin_mask=torch.arange(8) >= 7)
        assert launch_counts()["aggregate"] == 2 * cfg.phases()


@pytest.mark.cuda
@pytest.mark.parametrize("trim", ["mean", "midpoint"])
@pytest.mark.parametrize("pinned", [False, True])
def test_cuda_consensus_fault_path_matches_the_cpu(cuda, trim, pinned):
    """The fault path on the card (dropout, a crash and stragglers; the
    per-receiver masked trim by the compare-exchange network) equals the
    CPU plain path on the same draws bit for bit, batched over three
    replications, finals, decision and aux."""
    from repro_torch.core import attacks as TA
    from repro_torch.dist.consensus import (ConsensusConfig,
                                            consensus_aggregate,
                                            consensus_iterate)
    from repro_torch.dist.faults import FaultPlan

    plan = FaultPlan(dropout=0.2, n_crashed=1, crash_round=3,
                     n_stragglers=1, stale_rounds=2)
    cfg = ConsensusConfig(f=1, trim=trim)
    x = _stack(72, (3, 8, 4099), "cpu")
    pin = torch.arange(8) >= 7 if pinned else None
    if pinned:
        x = TA.attack_stack("alie", None, x, pin, axis=1)
    draws = torch.rand((3, cfg.phases(plan), 8, 8),
                       generator=torch.Generator().manual_seed(5))
    out = {}
    for dev in ("cpu", cuda):
        kw = dict(config=cfg, plan=plan, draws=draws.to(dev),
                  pin_mask=None if pin is None else pin.to(dev))
        out[str(dev)] = (consensus_iterate(x.to(dev), "vrmom", **kw),
                         consensus_aggregate(x.to(dev), "vrmom", **kw))
    for a, b in zip(out["cpu"], out[str(cuda)]):
        _consensus_same(({"v": a[0]}, a[1]), ({"v": b[0]}, b[1]))


@pytest.mark.cuda
def test_cuda_consensus_blocked_wire_matches_the_cpu(cuda, monkeypatch):
    """The blocked consensus wire on the card (a bf16 and an f32 leaf,
    blocks of 1000 columns, dropout, stragglers, a pinned row; the draws
    from a generator on the card handed to the CPU run) equals the CPU
    wire bit for bit; at any block size the card's wire gives the same
    bits."""
    from repro_torch.dist import robust_reduce as RR
    from repro_torch.dist.consensus import ConsensusConfig
    from repro_torch.dist.faults import FaultPlan

    plan = FaultPlan(dropout=0.1, n_stragglers=2, stale_rounds=2)
    cfg = ConsensusConfig(f=1)
    g = {"a": _stack(73, (8, 40, 70), "cpu").to(torch.bfloat16),
         "b": _stack(74, (8, 2500), "cpu")}
    pin = torch.arange(8) >= 7
    draws = plan.uniforms(8, cfg.phases(plan), generator=torch.Generator(
        device=cuda).manual_seed(6), device=cuda)
    res = {}
    for chunk in (1000, 1 << 22):
        monkeypatch.setattr(RR, "WIRE_CHUNK", chunk)
        for dev in ("cpu", cuda):
            res[(chunk, str(dev))] = RR.aggregate_stacked_auto(
                _to(g, dev), "vrmom", reduce_backend="consensus",
                consensus=cfg, plan=plan, draws=draws.to(dev),
                pin_mask=pin.to(dev))
    _consensus_same(res[(1000, "cpu")], res[(1000, str(cuda))])
    _consensus_same(res[(1000, str(cuda))], res[(1 << 22, str(cuda))])


# -- the moe family: routing inside the captured steps -----------------------

def _moe_served(cuda, name="granite-moe-3b-a800m", **kw):
    cfg = dataclasses.replace(get_arch(name).reduced(), **kw)
    params = M.init(cfg, torch.Generator(device=cuda).manual_seed(0),
                    device=cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 12), generator=g,
                                     device=cuda)}
    return cfg, params, batch


def _moe_case(cuda, case):
    from repro_torch.configs import MoEConfig

    return {"granite": lambda: _moe_served(cuda),
            "mixtral-ring": lambda: _moe_served(cuda, "mixtral-8x7b"),
            "granite-E40-bf16": lambda: _moe_served(
                cuda, moe=MoEConfig(40, 8), param_dtype="bfloat16",
                compute_dtype="bfloat16")}[case]()


MOE_CASES = ["granite", "mixtral-ring", "granite-E40-bf16"]


@pytest.mark.cuda
@pytest.mark.parametrize("share", [True, False], ids=["shared",
                                                      "replicated"])
@pytest.mark.parametrize("case", MOE_CASES)
def test_cuda_moe_replay_equals_eager(cuda, case, share):
    """A moe decode step (the router, the top-k with its tie order, the
    capacity positions, the gathered dispatch and combine) captured once
    and replayed gives the eager loop's greedy tokens bitwise, under
    signflip and with no robust tail; mixtral's prompt of 12 and 10 new
    tokens run its reduced ring of 16 past its end inside the graph; the
    bf16 case routes over 40 experts, top-8."""
    cfg, params, batch = _moe_case(cuda, case)
    for robust in (RobustDecodeConfig(m=8, attack="signflip",
                                      share_replica_compute=share), None):
        eng = ServeEngine(cfg, params, max_len=40, robust=robust,
                          device=cuda)
        got = eng.generate(batch, 10)
        torch.testing.assert_close(got, eng.generate_python_loop(batch, 10),
                                   rtol=0, atol=0)
        (st,) = eng.graphs.values()
        assert st.graph is not None and st.replays == 8


@pytest.mark.cuda
@pytest.mark.parametrize("case", MOE_CASES)
def test_cuda_moe_pool_replay_equals_eager(cuda, case):
    """Seven requests through three slots of a moe model: the scheduler
    over the replayed pool gives the eagerly decoded pool's tokens."""
    cfg, params, _ = _moe_case(cuda, case)
    reqs = _pool_requests(cfg, 7, 3)
    robust = RobustDecodeConfig(m=8, attack="signflip")
    got, eng = _pool_serve(cuda, cfg, params, reqs, "graph", robust)
    want, _ = _pool_serve(cuda, cfg, params, reqs, "eager", robust)
    assert got == want
    (st,) = eng.pool_graphs.values()
    assert st.replays > 3


@pytest.mark.cuda
def test_cuda_moe_capture_of_a_host_read_raises(cuda, monkeypatch):
    """A routing that reads a device value on the host cannot be captured:
    ``generate`` raises, with no fallback, and serves once it is gone."""
    import repro_torch.models.moe as X

    real = X.route

    def reads_host(x, router, cfg):
        r = real(x, router, cfg)
        int(r.expert[0, 0, 0])  # a device value read on the host
        return r

    cfg, params, batch = _moe_served(cuda)
    monkeypatch.setattr(X, "route", reads_host)
    eng = ServeEngine(cfg, params, max_len=40, device=cuda)
    with pytest.raises(RuntimeError, match="capturing the decode step"):
        eng.generate(batch, 10)
    assert not eng.graphs
    monkeypatch.setattr(X, "route", real)
    torch.testing.assert_close(eng.generate(batch, 10),
                               eng.generate_python_loop(batch, 10), rtol=0,
                               atol=0)


@pytest.mark.cuda
def test_cuda_moe_top_k_ties_match_the_cpu(cuda):
    """Router probabilities in runs of exact ties around the top-k boundary
    (40 experts, top-8): the card picks the CPU's experts, the lower index
    first on a tie."""
    from repro_torch.models.moe import _top_k

    rs = np.random.RandomState(0)
    base = rs.rand(64, 14).astype(np.float32)
    probs = torch.from_numpy(np.repeat(base, 3, axis=1)[:, :40].copy())
    want = _top_k(probs, 8)
    got = _top_k(probs.to(cuda), 8)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0)


@pytest.mark.cuda
def test_cuda_b4_b1_at_granite_vocab(cuda):
    """granite-moe-3b-a800m's serving stack [8, 4, 49155]: V is odd, so B4
    takes its scalar loads; greedy and top-50, with and without the
    aggregate, and B1, bitwise their plain versions."""
    x = _stack(49155, (8, 4, 49155), cuda)
    for k in (0, 50):
        for with_agg in (True, False):
            _b4_check(x, top_k=k, with_agg=with_agg)
    _b1_same(x.reshape(8, -1), "vrmom", K=8)


# -- the ssm and hybrid families: the state written inside the graphs --------

SSM_CASES = ["mamba2-2.7b", "zamba2-7b"]


@pytest.mark.cuda
@pytest.mark.parametrize("share", [True, False], ids=["shared",
                                                      "replicated"])
@pytest.mark.parametrize("case", SSM_CASES)
def test_cuda_ssm_replay_equals_eager(cuda, case, share):
    """A reduced mamba2 (or zamba2) decode step, its SSM states and conv
    tails written in place (and zamba2's shared block through B3), captured
    once and replayed gives the eager loop's greedy tokens bitwise, under
    signflip and with no robust tail; the prompt of 12 pads one chunk of
    16."""
    cfg, params, batch = _moe_served(cuda, case)
    for robust in (RobustDecodeConfig(m=8, attack="signflip",
                                      share_replica_compute=share), None):
        eng = ServeEngine(cfg, params, max_len=40, robust=robust,
                          device=cuda)
        got = eng.generate(batch, 10)
        torch.testing.assert_close(got, eng.generate_python_loop(batch, 10),
                                   rtol=0, atol=0)
        (st,) = eng.graphs.values()
        assert st.graph is not None and st.replays == 8


@pytest.mark.cuda
@pytest.mark.parametrize("case", SSM_CASES)
def test_cuda_ssm_pool_replay_equals_eager(cuda, case):
    """Seven requests through three slots: slots freed and admitted again
    while the others decode; the replayed pool gives the eagerly decoded
    pool's tokens (every admission overwrote its slot's state)."""
    cfg, params, _ = _moe_served(cuda, case)
    reqs = _pool_requests(cfg, 7, 3)
    robust = RobustDecodeConfig(m=8, attack="signflip")
    got, eng = _pool_serve(cuda, cfg, params, reqs, "graph", robust)
    want, _ = _pool_serve(cuda, cfg, params, reqs, "eager", robust)
    assert got == want
    (st,) = eng.pool_graphs.values()
    assert st.replays > 3


@pytest.mark.cuda
@pytest.mark.parametrize("case", SSM_CASES)
def test_cuda_ssm_kernels_match_plain_path(cuda, case):
    """The reduced models on the kernel path and on the plain path (torch
    attention and estimator) give the same greedy tokens; a generate runs
    B2 once and B3 once a step for each application of zamba2's shared
    block, and no attention kernel for mamba2, and B4 every token."""
    cfg, params, batch = _moe_served(cuda, case)
    plain = ServeEngine(cfg, params, max_len=40, attn_backend="torch",
                        robust=RobustDecodeConfig(m=8, estimator=Estimator(
                            "vrmom", K=8, backend="torch")), device=cuda)
    fused = ServeEngine(cfg, params, max_len=40,
                        robust=RobustDecodeConfig(m=8, attack="signflip"),
                        device=cuda)
    fused.generate(batch, 10)  # capture
    toks, ran = device_kernel_counts(lambda: fused.generate(batch, 10),
                                     DEVICE_KERNELS)
    n_attn = 0 if cfg.family == "ssm" \
        else cfg.n_layers // cfg.hybrid_attn_every
    assert ran == {"flash_fwd": n_attn, "decode_split_kernel": n_attn * 9,
                   "tail_kernel": 10, "agg_kernel": 0}
    torch.testing.assert_close(toks, plain.generate(batch, 10), rtol=0,
                               atol=0)


@pytest.mark.cuda
def test_cuda_b2_b3_at_zamba2_shapes(cuda):
    """zamba2-7b's shared block: B2 at q/k/v [4, 192, 32, 112] bf16 causal
    (the prefill) and B3 at q [4, 1, 32, 112] over a [4, 216, 32, 112] bf16
    cache (G 1) at lengths 193..216 (the decode), against the f32 plain
    versions of the same bf16 inputs at 1e-2 + 1e-2 * |ref|; each launches
    its dh-112 instance."""
    g = torch.Generator(device=cuda).manual_seed(112)
    q, k, v = (torch.randn(4, 192, 32, 112, device=cuda, generator=g
                           ).to(torch.bfloat16) for _ in range(3))
    torch.testing.assert_close(
        flash_attention(q, k, v, causal=True).float(),
        flash_attention_plain(q.float(), k.float(), v.float(), causal=True),
        rtol=1e-2, atol=1e-2)
    qd = q[:, :1].contiguous()
    kc, vc = (torch.randn(4, 216, 32, 112, device=cuda, generator=g
                          ).to(torch.bfloat16) for _ in range(2))
    lens = torch.tensor([193, 200, 215, 216], dtype=torch.int32,
                        device=cuda)
    torch.testing.assert_close(
        decode_attention(qd, kc, vc, kv_len=lens).float(),
        decode_attention_plain(qd.float(), kc.float(), vc.float(), lens,
                               None, None),
        rtol=1e-2, atol=1e-2)
    names = kernels_in_calls([
        lambda: flash_attention(q, k, v, causal=True),
        lambda: decode_attention(qd, kc, vc, kv_len=lens)])
    assert [kernel_instance(n, "flash_fwd_wgmma") for n in names[0]] \
        == [(112,)]
    assert [kernel_instance(n, "decode_split_kernel")
            for n in names[1]] == [(112, 8)]


# -- the encdec family: non-causal B2, B3 over the encoder cache -------------

@pytest.mark.cuda
@pytest.mark.parametrize("S,T", [(16, 1500), (192, 1500), (1500, 1500),
                                 (33, 47)])
def test_cuda_b2_noncausal_at_whisper_shapes(cuda, S, T):
    """whisper-medium's non-causal B2 in bf16 at dh 64, G 1: the encoder
    (S = T = 1500, 28 keys past the last 64-key tile), the cross attention
    of a prompt over the 1500 frames, and a ragged small case, against the
    f32 plain version of the same bf16 inputs at 1e-2 + 1e-2 * |ref|; one
    launch of the dh-64 wgmma instance a call."""
    g = torch.Generator(device=cuda).manual_seed(S + T)
    q = torch.randn(4, S, 16, 64, device=cuda, generator=g).bfloat16()
    k, v = (torch.randn(4, T, 16, 64, device=cuda, generator=g).bfloat16()
            for _ in range(2))
    got = flash_attention(q, k, v, causal=False)
    torch.testing.assert_close(
        got.float(), flash_attention_plain(q.float(), k.float(), v.float(),
                                           causal=False),
        rtol=1e-2, atol=1e-2)
    names = kernels_in_calls([lambda: flash_attention(q, k, v,
                                                      causal=False)])
    assert [kernel_instance(n, "flash_fwd_wgmma") for n in names[0]] \
        == [(64,)]


@pytest.mark.cuda
@pytest.mark.parametrize("S,T", [(100, 100), (48, 150), (150, 48)])
def test_cuda_b2_noncausal_autograd_grads_match_the_plain_path(cuda, S, T):
    """FlashAttentionFn non-causal in bf16 at dh 64, G 1, as whisper's
    training runs it (the encoder at S = T, the cross attention over keys
    of another length): one B2 launch, the output against
    ``flash_attention_plain`` of the f32 inputs at 1e-2 + 1e-2 * |ref|,
    the gradients (the ``mha`` recompute) against the plain path's under
    autograd within 2e-2 of the largest."""
    from repro_torch.models.attn_backend import FlashAttentionFn

    g = torch.Generator(device=cuda).manual_seed(S * 1000 + T)
    q, dout = (torch.randn(2, S, 16, 64, device=cuda, generator=g
                           ).bfloat16() for _ in range(2))
    k, v = (torch.randn(2, T, 16, 64, device=cuda, generator=g).bfloat16()
            for _ in range(2))
    reset_launch_counts()
    qa, ka, va = (t.clone().requires_grad_(True) for t in (q, k, v))
    out = FlashAttentionFn.apply(qa, ka, va, False, 64)
    got = torch.autograd.grad(out, (qa, ka, va), dout)
    assert launch_counts()["flash_attention"] == 1
    torch.testing.assert_close(
        out.float(), flash_attention_plain(q.float(), k.float(), v.float(),
                                           causal=False),
        rtol=1e-2, atol=1e-2)
    qb, kb, vb = (t.clone().requires_grad_(True) for t in (q, k, v))
    want = torch.autograd.grad(
        flash_attention_plain(qb, kb, vb, causal=False), (qb, kb, vb), dout)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        err = float((a.float() - b.float()).abs().max())
        assert err <= 2e-2 * float(b.float().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("B", [4, 32])
def test_cuda_b3_cross_over_the_whole_encoder_cache(cuda, B):
    """B3 as the cross attention of a whisper decode step: q [B, 1, 16, 64]
    over a [B, 1500, 16, 64] bf16 cache with no length (``kv_len=None``)
    and with the python-int length 1500, the same bits, against the f32
    plain version at 1e-2 + 1e-2 * |ref|; at 4 and at 32 (replicated)
    rows."""
    g = torch.Generator(device=cuda).manual_seed(B)
    q = torch.randn(B, 1, 16, 64, device=cuda, generator=g).bfloat16()
    k, v = (torch.randn(B, 1500, 16, 64, device=cuda, generator=g
                        ).bfloat16() for _ in range(2))
    got = decode_attention(q, k, v, kv_len=None)
    assert torch.equal(got, decode_attention(q, k, v, kv_len=1500))
    torch.testing.assert_close(
        got.float(), decode_attention_plain(
            q.float(), k.float(), v.float(), lengths(None, B, 1500, cuda)),
        rtol=1e-2, atol=1e-2)


def _whisper_served(cuda, seed=1):
    cfg = get_arch("whisper-medium").reduced()
    params = M.init(cfg, torch.Generator(device=cuda).manual_seed(0),
                    device=cuda)
    g = torch.Generator(device=cuda).manual_seed(seed)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 12), generator=g,
                                     device=cuda),
             "frames": torch.randn(2, cfg.encoder.n_frames, cfg.d_model,
                                   generator=g, device=cuda)}
    return cfg, params, batch


@pytest.mark.cuda
@pytest.mark.parametrize("share", [True, False], ids=["shared",
                                                      "replicated"])
def test_cuda_whisper_replay_equals_eager(cuda, share):
    """A reduced whisper decode step (the per-row sinusoid made on the
    device, the self K/V written in place, the cross K/V read whole by B3)
    captured once and replayed gives the eager loop's greedy tokens
    bitwise, under signflip and with no robust tail."""
    cfg, params, batch = _whisper_served(cuda)
    for robust in (RobustDecodeConfig(m=8, attack="signflip",
                                      share_replica_compute=share), None):
        eng = ServeEngine(cfg, params, max_len=40, robust=robust,
                          device=cuda)
        got = eng.generate(batch, 10)
        torch.testing.assert_close(got, eng.generate_python_loop(batch, 10),
                                   rtol=0, atol=0)
        (st,) = eng.graphs.values()
        assert st.graph is not None and st.replays == 8


@pytest.mark.cuda
def test_cuda_whisper_kernels_match_plain_path(cuda):
    """The reduced whisper on the kernel path and on the plain path (torch
    attention and estimator) give the same greedy tokens; a generate runs
    B2 once an encoder layer and twice a decoder layer (self and cross),
    B3 twice a decoder layer a step, and B4 every token."""
    cfg, params, batch = _whisper_served(cuda)
    plain = ServeEngine(cfg, params, max_len=40, attn_backend="torch",
                        robust=RobustDecodeConfig(m=8, estimator=Estimator(
                            "vrmom", K=8, backend="torch")), device=cuda)
    fused = ServeEngine(cfg, params, max_len=40,
                        robust=RobustDecodeConfig(m=8, attack="signflip"),
                        device=cuda)
    fused.generate(batch, 10)  # capture
    toks, ran = device_kernel_counts(lambda: fused.generate(batch, 10),
                                     DEVICE_KERNELS)
    L = cfg.n_layers
    assert ran == {"flash_fwd": cfg.encoder.n_layers + 2 * L,
                   "decode_split_kernel": 2 * L * 9, "tail_kernel": 10,
                   "agg_kernel": 0}
    torch.testing.assert_close(toks, plain.generate(batch, 10), rtol=0,
                               atol=0)


@pytest.mark.cuda
def test_cuda_whisper_pool_replay_equals_eager(cuda):
    """Seven requests, each with its own frames, through three slots: the
    replayed pool gives the eagerly decoded pool's tokens (every admission
    wrote its slot's self and cross K/V)."""
    from repro_torch.serve import Request, Scheduler

    cfg, params, _ = _whisper_served(cuda)
    rs = np.random.RandomState(4)
    reqs = [(p, n, rs.randn(cfg.encoder.n_frames, cfg.d_model).astype(
        np.float32)) for p, n in _pool_requests(cfg, 7, 3)]
    out = {}
    for mode in ("graph", "eager"):
        eng = ServeEngine(cfg, params, max_len=40, n_slots=3, device=cuda,
                          robust=RobustDecodeConfig(m=8, attack="signflip"))
        if mode == "eager":
            eng._decode = _eager_decode(eng)
        sched = Scheduler(eng, decode_block=3, seed=5)
        uids = [sched.submit(Request(tokens=p, max_new_tokens=n,
                                     extras={"frames": f}))
                for p, n, f in reqs]
        done = sched.run()
        out[mode] = [done[u].tokens for u in uids]
        if mode == "graph":
            (st,) = eng.pool_graphs.values()
            assert st.replays > 3
    assert out["graph"] == out["eager"]


# -- training the moe family: granite's attention shape, one moe layer -------

@pytest.mark.cuda
@pytest.mark.parametrize("S,chunk", [(200, 64), (1024, 1024)])
def test_cuda_b2_gqa3_dh64_causal_autograd_grads_match_the_plain_path(
        cuda, S, chunk):
    """FlashAttentionFn causal in bf16 at granite-moe-3b-a800m's heads (24
    query heads over 8 kv heads of 64, G 3): one B2 launch, the output
    against ``flash_attention_plain`` of the f32 inputs at 1e-2 + 1e-2 *
    |ref|, the gradients (the ``mha`` recompute) against the plain path's
    under autograd within 2e-2 of the largest (``chip_smoke``'s
    ``b2_autograd_record``)."""
    from repro_torch.models.attn_backend import FlashAttentionFn

    g = torch.Generator(device=cuda).manual_seed(S)
    q, dout = (torch.randn(2, S, 24, 64, device=cuda, generator=g
                           ).bfloat16() for _ in range(2))
    k, v = (torch.randn(2, S, 8, 64, device=cuda, generator=g).bfloat16()
            for _ in range(2))
    reset_launch_counts()
    qa, ka, va = (t.clone().requires_grad_(True) for t in (q, k, v))
    out = FlashAttentionFn.apply(qa, ka, va, True, chunk)
    got = torch.autograd.grad(out, (qa, ka, va), dout)
    assert launch_counts()["flash_attention"] == 1
    torch.testing.assert_close(
        out.float(), flash_attention_plain(q.float(), k.float(), v.float(),
                                           causal=True),
        rtol=1e-2, atol=1e-2)
    qb, kb, vb = (t.clone().requires_grad_(True) for t in (q, k, v))
    want = torch.autograd.grad(
        flash_attention_plain(qb, kb, vb, causal=True), (qb, kb, vb), dout)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        err = float((a.float() - b.float()).abs().max())
        assert err <= 2e-2 * float(b.float().abs().max())


@pytest.mark.cuda
def test_cuda_moe_layer_backward_twice_at_granite_width(cuda):
    """One moe layer at granite-moe-3b-a800m's full width (d 1536, 40
    experts top-8 of d_ff 512, bf16) on one 4096-token row (two routing
    groups of 2048, capacity 512), its forward and backward run twice on
    the same inputs: the routing, the output and the load-balance loss are
    bit-equal, and so are the router's and the experts' gradients (cuBLAS
    and the combine's backward, one row a slot). The input's gradient
    sums a token's up to 8 dispatched rows in the dispatch's backward
    (``index_select``'s: bf16 atomic adds in no fixed order): the two
    runs' ``dx`` stay within 8 bf16 roundings (8 * 2^-8) of the largest
    entry (ROADMAP.md §C; on an H100 80GB HBM3 at 700 W, 61,267 of
    6,291,456 entries differed, by at most 0.0156, one bf16 ulp of the
    largest |dx|, 2.906)."""
    from repro_torch.models import moe as X

    cfg = get_arch("granite-moe-3b-a800m")
    g = torch.Generator(device=cuda).manual_seed(27)
    p = X.moe_init(g, cfg, device=cuda)
    x = torch.randn(1, 4096, cfg.d_model, device=cuda, generator=g
                    ).bfloat16()
    dy = torch.randn(x.shape, device=cuda, generator=g).bfloat16()
    names = sorted(p)

    def run():
        real, calls = X.route, []

        def keep(*a):
            calls.append(real(*a))
            return calls[-1]

        X.route = keep
        try:
            xa = x.clone().requires_grad_(True)
            pa = {n: p[n].clone().requires_grad_(True) for n in names}
            y, aux = X.moe_ffn(pa, xa, cfg)
            grads = torch.autograd.grad(
                (y.float() * dy.float()).sum() + aux,
                [xa] + [pa[n] for n in names])
        finally:
            X.route = real
        return calls[0], y, aux, grads

    ra, ya, auxa, ga = run()
    rb, yb, auxb, gb = run()
    assert ra.capacity == 512 and ra.expert.shape == (2, 2048, 8)
    assert torch.equal(ra.expert, rb.expert) and torch.equal(ra.pos, rb.pos)
    assert torch.equal(ya, yb) and torch.equal(auxa, auxb)
    for n, a, b in zip(names, ga[1:], gb[1:]):
        assert torch.equal(a, b), n
    dxa, dxb = ga[0].float(), gb[0].float()
    err = float((dxa - dxb).abs().max())
    print(f"dx: {int((dxa != dxb).sum())} of {dxa.numel()} entries differ, "
          f"largest {err} of |dx| {float(dxa.abs().max())}")
    assert err <= 8 * 2 ** -8 * float(dxa.abs().max())


@pytest.mark.cuda
def test_cuda_moe_train_grads_at_granite_width_match_the_cpu(cuda):
    """granite-moe-3b-a800m at full width, 2 layers, f32, remat as
    configured, one 4096-token row (two routing groups of 2048): the card's
    ``loss_and_grads`` routes every layer as the CPU does, forward and
    recompute, and its loss and every leaf's gradient equal the CPU's
    within 1e-4 of the leaf's largest entry: a backward that drops or
    misroutes a slot parts by far more."""
    from repro_torch.data import lm_batch
    from repro_torch.models import moe as X
    from repro_torch.train.step import loss_and_grads
    from repro_torch.tree import paths, tree_map

    cfg = dataclasses.replace(get_arch("granite-moe-3b-a800m"), n_layers=2,
                              param_dtype="float32", compute_dtype="float32")
    pc = M.init(cfg, torch.Generator().manual_seed(3), device="cpu")
    pg = tree_map(lambda x: x.to(cuda), pc)
    bc = lm_batch(cfg, 0, 1, 4096, device="cpu")
    bg = {k: v.to(cuda) for k, v in bc.items()}

    def run(p, b):
        real, calls = X.route, []

        def keep(*a):
            calls.append(real(*a))
            return calls[-1]

        X.route = keep
        try:
            return loss_and_grads(cfg, p, b), calls
        finally:
            X.route = real

    (lc, gc), rc = run(pc, bc)
    (lg, gg), rg = run(pg, bg)
    assert len(rc) == len(rg) >= 2 * cfg.n_layers
    for a, b in zip(rc, rg):
        assert a.expert.shape == (2, 2048, 8)
        assert torch.equal(a.expert, b.expert.cpu())
        assert torch.equal(a.keep, b.keep.cpu())
    torch.testing.assert_close(lg.cpu(), lc, rtol=1e-5, atol=1e-5)
    for (path, a), (_, b) in zip(paths(gc), paths(gg)):
        err = float((a - b.cpu()).abs().max())
        assert err <= 1e-4 * float(a.abs().max()), (path, err)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 1000, 32, 112), (1, 4096, 32, 112)],
                         ids=["S1000", "zamba2-train"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_b2_dh112_causal_autograd_grads_match_mha(cuda, dtype, shape):
    """FlashAttentionFn causal at zamba2-7b's shared block (32 heads of
    112, G 1), chunk 1024, against ``mha`` under autograd: one B2 launch;
    the output at the file's attention tolerance (f32 against ``mha``,
    bf16 against ``flash_attention_plain`` of the f32 inputs), the
    gradients at 1e-4 (f32) or within 2e-2 of the largest (bf16: B2 and
    ``mha`` round P to bf16 at other places)."""
    from repro_torch.models.attention import mha
    from repro_torch.models.attn_backend import FlashAttentionFn

    g = torch.Generator(device=cuda).manual_seed(shape[1])
    q, k, v, dout = (torch.randn(shape, generator=g, device=cuda).to(dtype)
                     for _ in range(4))
    reset_launch_counts()
    qa, ka, va = (t.clone().requires_grad_(True) for t in (q, k, v))
    out = FlashAttentionFn.apply(qa, ka, va, True, 1024)
    got = torch.autograd.grad(out, (qa, ka, va), dout)
    assert launch_counts()["flash_attention"] == 1
    qb, kb, vb = (t.clone().requires_grad_(True) for t in (q, k, v))
    ref = mha(qb, kb, vb, causal=True, window=None, chunk=1024)
    want = torch.autograd.grad(ref, (qb, kb, vb), dout)
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    else:
        torch.testing.assert_close(
            out.float(), flash_attention_plain(q.float(), k.float(),
                                               v.float(), causal=True),
            rtol=1e-2, atol=1e-2)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        if dtype == torch.float32:
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
        else:
            err = float((a.float() - b.float()).abs().max())
            assert err <= 2e-2 * float(b.float().abs().max())


# the ssm and hybrid families' training cuts: every width as published,
# f32; mamba2-2.7b at 2 layers, zamba2-7b at 7 (one group of 6 and its
# shared-block application, then a tail layer)
SSM_TRAIN_CUTS = {"mamba2-2.7b": 2, "zamba2-7b": 7}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SSM_TRAIN_CUTS))
def test_cuda_ssm_train_grads_at_full_width_match_the_cpu(cuda, name):
    """mamba2-2.7b and zamba2-7b at full width (SSM_TRAIN_CUTS layers),
    f32, remat as configured, one 320-token row (two chunks of 128 and a
    padded third): the card's ``loss_and_grads`` (the chunked SSD scan
    and, for zamba2, B2 at dh 112 under autograd) equals the CPU's, the
    loss at 1e-5 and every leaf's gradient within 1e-4 of its largest
    entry."""
    from repro_torch.data import lm_batch
    from repro_torch.train.step import loss_and_grads
    from repro_torch.tree import paths, tree_map

    cfg = dataclasses.replace(get_arch(name), n_layers=SSM_TRAIN_CUTS[name],
                              param_dtype="float32", compute_dtype="float32")
    pc = M.init(cfg, torch.Generator().manual_seed(5), device="cpu")
    pg = tree_map(lambda x: x.to(cuda), pc)
    bc = lm_batch(cfg, 0, 1, 320, device="cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(8)
    try:
        lc, gc = loss_and_grads(cfg, pc, bc)
    finally:
        torch.set_num_threads(threads)
    reset_launch_counts()
    lg, gg = loss_and_grads(cfg, pg, {k: v.to(cuda) for k, v in bc.items()})
    # B2 once an application (the shared block is not recomputed)
    assert launch_counts()["flash_attention"] == (
        1 if cfg.family == "hybrid" else 0)
    torch.testing.assert_close(lg.cpu(), lc, rtol=1e-5, atol=1e-5)
    for (path, a), (_, b) in zip(paths(gc), paths(gg)):
        err = float((a - b.cpu()).abs().max())
        assert err <= 1e-4 * float(a.abs().max()), (path, err)


@pytest.mark.cuda
def test_cuda_top50_replay_equals_eager_over_20_seeds(cuda):
    """``chip_smoke.py`` phase 3's top-50 call, 20 times: full-width
    qwen3-1.7b, robust m = 8 VRMOM K 8 under the gaussian attack, the
    fused tail, 4 x 192-token prompts, 24 new tokens, seeds 7 to 26; the
    graphs dropped before every fourth pair, so that pair's ``generate``
    runs the eager step on the capture stream and captures anew. Each
    pair's tokens and its generator's state after are bitwise the eager
    loop's (the contract phase 3 checks once)."""
    from repro_torch.serve import Sampling

    cfg = get_arch("qwen3-1.7b")
    params = M.init(cfg, torch.Generator(device=cuda).manual_seed(0),
                    device=cuda)
    tokens = torch.randint(0, cfg.vocab, (4, 192), generator=torch.Generator(
        device=cuda).manual_seed(1), device=cuda)
    eng = ServeEngine(cfg, params, max_len=216, device=cuda,
                      robust=RobustDecodeConfig(m=8, attack="gaussian",
                                                fuse_tail=True))
    sc = Sampling("top_k", 1.0, top_k=50)
    for i in range(20):
        if i % 4 == 0:
            eng.graphs.clear()
        ga = torch.Generator(device=cuda).manual_seed(7 + i)
        gb = torch.Generator(device=cuda).manual_seed(7 + i)
        want = eng.generate_python_loop({"tokens": tokens}, 24, sc,
                                        generator=ga)
        got = eng.generate({"tokens": tokens}, 24, sc, generator=gb)
        assert torch.equal(got, want), i
        assert torch.equal(ga.get_state(), gb.get_state()), i


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["temperature", "top_k"])
def test_cuda_retraced_sampled_generate_keeps_its_seed(cuda, monkeypatch,
                                                       method):
    """``chip_smoke.graph_and_eager`` on phase 3's sampled calls when the
    tracer loses a generate's spin: ``device_kernel_events`` then calls
    the generate again, and that call must run from the seed again. The
    spin of each generate's first trace is dropped here (the 2nd and 4th
    traces: the eager loop's, then two tries of each generate); sampled
    under the gaussian attack, the graph's tokens equal the eager loop's,
    the first generate's re-call captured anew, and both re-calls count
    in ``retraced``. A generator made once per try ran the second call
    from where the first left it, and the tokens parted (ROADMAP.md §C)."""
    import importlib.util
    from pathlib import Path

    from repro_torch import device as D
    from repro_torch import kernels as K
    from repro_torch.serve import Sampling

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent
        / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cfg, params, batch = _served(cuda)
    eng = ServeEngine(cfg, params, max_len=40, device=cuda,
                      robust=RobustDecodeConfig(m=8, attack="gaussian"))
    sc = (Sampling("temperature", 1.0) if method == "temperature"
          else Sampling("top_k", 1.0, top_k=50))
    real, spins = torch.cuda._sleep, []

    def sleep(cycles):
        if cycles == D.TRACE_SPIN_CYCLES:
            spins.append(len(spins) + 1 not in (2, 4))
            if not spins[-1]:
                return
        real(cycles)

    monkeypatch.setattr(torch.cuda, "_sleep", sleep)
    r = smoke.graph_and_eager(torch, K, eng, batch, method, sc, 7)
    assert spins == [True, False, True, False, True]
    assert r["same"] and r["retraced"] == 2
    # the graph the first generate's re-call captured: its own replays and
    # those of the second generate's two calls (the first try's graph was
    # dropped, not replayed again)
    n = smoke.NEW_TOKENS
    assert eng.graphs[sc].replays == (n - 2) + 2 * (n - 1)


# -- the lint's auditor and RL209's capture stability on the card ------------

@pytest.mark.cuda
def test_cuda_run_audit_has_no_failure(cuda):
    """``repro_torch.lint.run_audit`` on the card: every RL2xx check passes
    but RL201, which skips off a process group."""
    from repro_torch.lint import AUDIT_CHECKS, run_audit

    results = run_audit(device="cuda")
    fails = [r.render() for r in results if r.status == "fail"]
    assert not fails, "\n".join(fails)
    assert sorted({r.check_id for r in results
                   if r.status == "skip"}) == ["RL201"]
    assert {c.id for c in AUDIT_CHECKS} <= {r.check_id for r in results}


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["generate", "decode_pool"])
def test_cuda_fresh_equal_sampling_captures_nothing_new(cuda, path):
    """A second call with a freshly built ``Sampling`` equal to the first
    replays the step the first captured: one entry, the same
    ``StepGraph``, and (same seed) the same tokens."""
    from repro_torch.serve import Sampling

    cfg, params, batch = _served(cuda)
    eng = ServeEngine(cfg, params, max_len=40, n_slots=2, device=cuda,
                      robust=RobustDecodeConfig(m=4))

    def fresh():
        return Sampling("top_k", 0.7, top_k=5)

    def seeded():
        return torch.Generator(device=cuda).manual_seed(3)

    if path == "generate":
        def call():
            return eng.generate(batch, 6, fresh(), seeded())
        graphs = eng.graphs
    else:
        pool = eng.make_pool()
        cur = torch.zeros((pool.n_slots,), dtype=torch.int32, device=cuda)
        # the pool's state, put back before each call: same inputs
        state = [t for t in list(pool.caches) + [pool.lengths, pool.active]
                 if torch.is_tensor(t)]
        saved = [t.clone() for t in state]

        def call():
            for t, s in zip(state, saved):
                t.copy_(s)
            return eng.decode_pool(pool, cur, 5, fresh(), seeded())[1]
        graphs = eng.pool_graphs
    first = call()
    assert len(graphs) == 1
    st = graphs[fresh()]
    replays = st.replays
    second = call()
    assert list(graphs.values()) == [st]
    assert st.replays == replays + 5
    torch.testing.assert_close(second, first, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("call", ["prefill", "decode", "train"])
def test_cuda_count_equals_the_meta_count(cuda, call):
    """``launch.op_cost.counting("cuda")`` of a call on the card equals the
    same call's count on the meta device (reduced qwen3-1.7b, f32): FLOPs,
    bytes and calls of every op, and the kernels' calls, which the
    wrappers' launch counters match."""
    from repro_torch import optim as O
    from repro_torch.launch.op_cost import counting
    from repro_torch.train.step import make_train_step

    cfg = get_arch("qwen3-1.7b").reduced()

    def count(dev, params):
        opt = O.get("adamw", lr=1e-3)
        st = opt.init(params)
        setup = make_train_step(cfg, 2, mode="stacked-rrs", optimizer=opt,
                                device=dev)
        zeros = lambda *s: torch.zeros(s, dtype=torch.int32, device=dev)
        toks, batch, tok = zeros(2, 24), {"tokens": zeros(4, 32)}, zeros(2)
        _, caches = M.prefill(params, cfg, {"tokens": toks}, cache_len=32,
                              last_only=True)
        fn = {"prefill": lambda: M.prefill(params, cfg, {"tokens": toks},
                                           cache_len=32, last_only=True),
              "decode": lambda: M.decode_step(params, cfg, caches, tok),
              "train": lambda: setup.step_fn(params, st, batch)}[call]
        if dev.type == "cuda":
            with counting("cuda"):
                fn()        # warm-up: B3's split scratch for this shape
            torch.cuda.synchronize()
        reset_launch_counts()
        with counting("cuda") as oc:
            fn()
        return oc, launch_counts()

    meta, _ = count(torch.device("meta"), M.init(
        cfg, torch.Generator(), device="meta"))
    card, launches = count(cuda, M.init(
        cfg, torch.Generator(device=cuda).manual_seed(0), device=cuda))
    assert card.by_op == meta.by_op
    assert (card.cost.flops, card.cost.bytes) == (meta.cost.flops,
                                                  meta.cost.bytes)
    assert card.kernels == meta.kernels
    calls = {k: v["calls"] for k, v in meta.kernels.items()}
    assert {k: n for k, n in launches.items() if n} == calls
    assert calls == {"prefill": {"flash_attention": 2},
                     "decode": {"decode_attention": 2},
                     "train": {"flash_attention": 4, "aggregate": 13}}[call]
