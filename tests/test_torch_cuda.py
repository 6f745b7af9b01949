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


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dh", [32, 64, 128])
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
@pytest.mark.parametrize("G", [1, 2, 8])
@pytest.mark.parametrize("dh", [32, 64, 128])
@pytest.mark.parametrize("kv", ["float32", "bfloat16", "int8"])
def test_cuda_b3_split_boundaries(cuda, kv, dh, G):
    """Per-row lengths at every split edge (one row each) and the same
    lengths as a scalar kv_len: against the plain version, f32 q at 1e-4
    and bf16 q at 1e-2 + 1e-2 * |ref|."""
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
@pytest.mark.parametrize("dh", [32, 64, 128])
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
@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_cuda_engine_kernels_match_plain_path(cuda, kv_dtype):
    """The reduced model served on the card: the kernel path (flash
    attention, decode attention, fused tail) gives the same greedy tokens
    as the plain path (torch attention, torch estimator), and every kernel
    ran."""
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
    toks = fused.generate(batch, 10)
    counts = launch_counts()
    assert counts["flash_attention"] == cfg.n_layers
    assert counts["decode_attention"] == cfg.n_layers * 9
    assert counts["aggregate_sample"] == 10
    torch.testing.assert_close(toks, plain.generate(batch, 10), rtol=0,
                               atol=0)
