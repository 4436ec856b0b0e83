"""dynamo_tpu_torch ops held against their dynamo_tpu (JAX) originals on the CPU.

Inputs are made with numpy from a seed and fed to both sides; every float
comparison states its tolerance. On the CPU the kernel wrappers run their
plain PyTorch versions (the CUDA kernels themselves are held against those
on the card by chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.ops import attention as jattn
from dynamo_tpu.ops import norm as jnorm
from dynamo_tpu.ops import rope as jrope
from dynamo_tpu.ops import sampling as jsampling
from dynamo_tpu.ops.pallas_paged import _lse_combine, paged_decode_attention as j_decode_kernel
from dynamo_tpu.ops.pallas_prefill import paged_prefill_attention as j_prefill_kernel
from dynamo_tpu_torch.ops import attention as tattn
from dynamo_tpu_torch.ops import build
from dynamo_tpu_torch.ops import norm as tnorm
from dynamo_tpu_torch.ops import paged_decode, paged_prefill
from dynamo_tpu_torch.ops import rope as trope
from dynamo_tpu_torch.ops import sampling as tsampling

# f32 on both sides; results differ only in summation order (~1e-7 relative),
# so 1e-5 absolute on O(1) values is a loose but meaningful bound.
ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("plus_one", [False, True])
def test_rms_norm_matches_jax(plus_one):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    want = np.asarray(jnorm.rms_norm(jnp.asarray(x), jnp.asarray(w), eps=1e-5, plus_one=plus_one))
    got = tnorm.rms_norm(_t(x), _t(w), eps=1e-5, plus_one=plus_one).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("scaling", [
    None,
    {"rope_type": "llama3", "factor": 32.0, "low_freq_factor": 1.0,
     "high_freq_factor": 4.0, "original_max_position_embeddings": 8192},
])
def test_rope_matches_jax(scaling):
    inv_j = jrope.rope_frequencies(64, theta=500000.0, scaling=scaling)
    inv_t = trope.rope_frequencies(64, theta=500000.0, scaling=scaling)
    np.testing.assert_array_equal(inv_t, inv_j)  # same numpy arithmetic: bit-equal
    assert trope.rope_attention_factor({"rope_type": "yarn", "factor": 4.0}) == jrope.rope_attention_factor(
        {"rope_type": "yarn", "factor": 4.0})
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 4, 64)).astype(np.float32)
    pos = rng.integers(0, 5000, (2, 7)).astype(np.int32)
    want = np.asarray(jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos), jnp.asarray(inv_j)))
    got = trope.apply_rope(_t(x), _t(pos), _t(inv_t)).numpy()
    # Angles up to 5000 rad: sin/cos of large f32 arguments differ by a few ulp.
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_write_kv_matches_jax():
    rng = np.random.default_rng(2)
    kc = rng.standard_normal((6, 4, 32)).astype(np.float32)
    vc = rng.standard_normal((6, 4, 32)).astype(np.float32)
    nk = rng.standard_normal((2, 3, 2, 16)).astype(np.float32)
    nv = rng.standard_normal((2, 3, 2, 16)).astype(np.float32)
    slots = np.array([[4, 5, 6], [13, 21, 22]], np.int32)  # distinct live slots
    wk, wv = jattn.write_kv(jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(nk), jnp.asarray(nv), jnp.asarray(slots))
    tk, tv = _t(kc.copy()), _t(vc.copy())
    out = tattn.write_kv(tk, tv, _t(nk), _t(nv), _t(slots))
    assert out[0] is tk and out[1] is tv  # in place
    np.testing.assert_array_equal(tk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(wv))


def _paged_case(seed, *, b, t, h, n_kv, hd, ps, npp, positions):
    rng = np.random.default_rng(seed)
    pages = b * npp + 1
    kc = rng.standard_normal((pages, ps, n_kv * hd)).astype(np.float32)
    vc = rng.standard_normal((pages, ps, n_kv * hd)).astype(np.float32)
    q = rng.standard_normal((b, t, h, hd)).astype(np.float32)
    tables = (1 + rng.permutation(pages - 1)[: b * npp]).reshape(b, npp).astype(np.int32)
    return q, kc, vc, tables, np.asarray(positions, np.int32)


# (T, positions) per case: decode, gappy verify, contiguous prefill chunks
# (one continuing after a cached prefix, one 1-token decode row of a mixed step).
CASES = {
    "decode": (1, [[0], [37], [63]]),
    "verify": (4, [[3, 9, 10, 30], [0, 0, 0, 0], [40, 50, 61, 63]]),
    "prefill": (5, [[20, 21, 22, 23, 24], [63, 0, 0, 0, 0], [0, 1, 2, 3, 4]]),
}


@pytest.mark.parametrize("kind", sorted(CASES))
def test_plain_attention_matches_jax_reference(kind):
    t, pos = CASES[kind]
    q, kc, vc, tables, positions = _paged_case(3, b=3, t=t, h=8, n_kv=2, hd=64, ps=16, npp=4, positions=pos)
    scale = 64**-0.5
    want = np.asarray(jattn.paged_attention_reference(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(tables), jnp.asarray(positions), scale=scale))
    args = (_t(q), _t(kc), _t(vc), _t(tables), _t(positions))
    if kind == "prefill":
        got = paged_prefill.paged_prefill_attention(*args, scale=scale).numpy()
        real = [(0, 5), (1, 1), (2, 5)]  # padding columns are unspecified
        for row, n in real:
            np.testing.assert_allclose(got[row, :n], want[row, :n], rtol=0, atol=ATOL)
    else:
        for num_splits in (1, 3):  # the split-K partials and their combine
            got = paged_decode.paged_decode_attention(*args, scale=scale, num_splits=num_splits).numpy()
            np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    # The dispatch takes the same wrappers for these shapes.
    routed = tattn.paged_attention(*args, scale=scale, contiguous_positions=kind != "verify").numpy()
    if kind == "prefill":
        np.testing.assert_allclose(routed[0], want[0], rtol=0, atol=ATOL)
    else:
        np.testing.assert_allclose(routed, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("fault", ["int64 tables", "strided q", "cache shapes differ", "positions shape"])
def test_kernel_argument_check_refuses(fault):
    """What the CUDA wrappers check before a launch (on the card they raise
    rather than pass the kernel a layout it does not read)."""
    q, kc, vc, tables, positions = (_t(a) for a in _paged_case(12, b=2, t=3, h=4, n_kv=2, hd=64, ps=16, npp=2,
                                                                 positions=[[0, 1, 2], [5, 6, 7]]))
    build.check_paged_args(q, kc, vc, tables, positions)  # the well-formed case passes
    if fault == "int64 tables":
        tables = tables.long()
    elif fault == "strided q":
        q = q.transpose(1, 2).contiguous().transpose(1, 2)
    elif fault == "cache shapes differ":
        vc = vc[:-1]
    else:
        positions = positions[:, :2].contiguous()
    with pytest.raises(ValueError):
        build.check_paged_args(q, kc, vc, tables, positions)


def test_plain_versions_match_pallas_interpret():
    """One tiny shape each against the Pallas kernels in interpret mode, as
    tests/test_pallas_paged.py runs them."""
    scale = 64**-0.5
    q, kc, vc, tables, positions = _paged_case(4, b=2, t=1, h=4, n_kv=2, hd=64, ps=16, npp=2,
                                               positions=[[5], [31]])
    want = np.asarray(j_decode_kernel(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(tables),
                                      jnp.asarray(positions), scale=scale, interpret=True, num_splits=2))
    got = paged_decode.paged_decode_attention(_t(q), _t(kc), _t(vc), _t(tables), _t(positions),
                                              scale=scale, num_splits=2).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    q, kc, vc, tables, positions = _paged_case(5, b=2, t=4, h=4, n_kv=2, hd=64, ps=16, npp=2,
                                               positions=[[10, 11, 12, 13], [20, 21, 0, 0]])
    want = np.asarray(j_prefill_kernel(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(tables),
                                       jnp.asarray(positions), scale=scale, interpret=True))
    got = paged_prefill.paged_prefill_attention(_t(q), _t(kc), _t(vc), _t(tables), _t(positions),
                                                scale=scale).numpy()
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=ATOL)
    np.testing.assert_allclose(got[1, :2], want[1, :2], rtol=0, atol=ATOL)


def test_lse_combine_with_empty_splits_matches_jax():
    rng = np.random.default_rng(6)
    acc = rng.standard_normal((2, 4, 3, 8)).astype(np.float32)
    m = rng.standard_normal((2, 4, 3)).astype(np.float32)
    l = rng.uniform(0.5, 2.0, (2, 4, 3)).astype(np.float32)
    # Splits 2 and 3 of row 0 and split 3 of row 1 are empty.
    for b_, s_ in ((0, 2), (0, 3), (1, 3)):
        m[b_, s_], l[b_, s_], acc[b_, s_] = jattn.NEG_INF, 0.0, 0.0
    want = np.asarray(_lse_combine(jnp.asarray(acc), jnp.asarray(m), jnp.asarray(l)))
    got = paged_decode.lse_combine(_t(acc), _t(m), _t(l)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # One split is exactly acc / l.
    one = paged_decode.lse_combine(_t(acc[:, :1]), _t(m[:, :1]), _t(l[:, :1])).numpy()
    np.testing.assert_array_equal(one, acc[:, 0] / l[:, 0, :, None])


def _sampling_inputs(seed, b=6, vocab=300):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((b, vocab)) * 3).astype(np.float32)
    temperature = np.array([0.0, 0.7, 1.0, 1.3, 0.9, 0.0], np.float32)[:b]
    top_k = np.array([0, 0, 20, 5, 0, 0], np.int32)[:b]
    top_p = np.array([1.0, 0.9, 1.0, 0.8, 0.5, 1.0], np.float32)[:b]
    return logits, temperature, top_k, top_p


def test_greedy_sampling_bitwise():
    logits, _, top_k, top_p = _sampling_inputs(7)
    temp = np.zeros(len(logits), np.float32)
    keys = jax.vmap(lambda c: jax.random.fold_in(jax.random.PRNGKey(0), c))(jnp.arange(len(logits)))
    want = np.asarray(jsampling.sample_tokens(jnp.asarray(logits), keys, jnp.asarray(temp),
                                              jnp.asarray(top_k), jnp.asarray(top_p)))
    got = tsampling.sample_tokens(_t(logits), _t(temp), _t(top_k), _t(top_p)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("penalized", [False, True])
def test_window_sampling_bitwise_with_shared_gumbel(penalized):
    """Both sides draw argmax(scaled + gumbel) over the same window with the
    same noise: jax.random.gumbel from the very keys jax.random.categorical
    uses inside sample_tokens."""
    logits, temperature, top_k, top_p = _sampling_inputs(8)
    b = len(logits)
    seeds = np.arange(b, dtype=np.uint32) + 11
    steps = np.arange(b, dtype=np.int32) * 3
    keys = jax.vmap(lambda s, c: jax.random.fold_in(jax.random.PRNGKey(s), c))(jnp.asarray(seeds), jnp.asarray(steps))
    cand = tsampling.CANDIDATES
    gumbel = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (cand,), jnp.float32))(keys))
    kw_j, kw_t = {}, {}
    if penalized:
        rng = np.random.default_rng(9)
        history = rng.integers(-1, 300, (b, 12)).astype(np.int32)
        freq = np.array([0.0, 0.5, 1.0, 0.0, 2.0, 0.7], np.float32)
        pres = np.array([0.0, 0.3, 0.0, 1.0, 0.0, 0.2], np.float32)
        kw_j = dict(history=jnp.asarray(history), frequency_penalty=jnp.asarray(freq),
                    presence_penalty=jnp.asarray(pres))
        kw_t = dict(history=_t(history), frequency_penalty=_t(freq), presence_penalty=_t(pres))
    want = np.asarray(jsampling.sample_tokens(jnp.asarray(logits), keys, jnp.asarray(temperature),
                                              jnp.asarray(top_k), jnp.asarray(top_p), **kw_j))
    got = tsampling.sample_tokens(_t(logits), _t(temperature), _t(top_k), _t(top_p),
                                  gumbel=_t(gumbel), **kw_t).numpy()
    np.testing.assert_array_equal(got, want)


def test_gumbel_noise_depends_on_seed_and_step_only():
    seeds = np.array([5, 5, 9], np.uint32)
    steps = np.array([2, 2, 2], np.int32)
    temp = np.array([1.0, 1.0, 0.0], np.float32)
    g = tsampling.gumbel_noise(seeds, steps, temp, 16)
    assert torch.equal(g[0], g[1])  # same (seed, step): same noise wherever the row sits
    assert torch.equal(g[2], torch.zeros(16))  # greedy rows read none
    assert torch.equal(tsampling.gumbel_noise(seeds[:1], steps[:1], temp[:1], 16)[0], g[0])


def test_token_logprobs_match_jax():
    logits, *_ = _sampling_inputs(10)
    tokens = np.argmax(logits, -1).astype(np.int32)
    want = jsampling.token_logprobs(jnp.asarray(logits), jnp.asarray(tokens), 5)
    got = tsampling.token_logprobs(_t(logits), _t(tokens), 5)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=ATOL)


def test_block_hashes_match_jax():
    from dynamo_tpu import tokens as jtokens
    from dynamo_tpu_torch import tokens as ttokens

    toks = list(np.random.default_rng(11).integers(0, 128256, 100))
    for bs in (16, 32):
        assert ttokens.compute_block_hashes(toks, bs) == jtokens.compute_block_hashes(toks, bs)
    assert ttokens.TokenBlockSequence(toks, block_size=16).block_hashes == jtokens.compute_block_hashes(toks, 16)
