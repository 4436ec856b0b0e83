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


def _bf16_case(seed, *, b, t, ps, npp, positions):
    """A bf16 paged case (8 heads over 2 KV heads, hd 64), rounded to bf16
    once and handed to both sides."""
    q, kc, vc, tables, pos = _paged_case(seed, b=b, t=t, h=8, n_kv=2, hd=64, ps=ps, npp=npp, positions=positions)
    jx = [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, kc, vc)] + [jnp.asarray(tables), jnp.asarray(pos)]
    tt = [_t(a).to(torch.bfloat16) for a in (q, kc, vc)] + [_t(tables), _t(pos)]
    return jx, tt


# (kind, T, page size, table pages, positions, num_splits, exact). One-block cases: the
# JAX kernel walks the whole history in one block (decode: <= 1024 keys and
# one split; prefill: <= 512 keys), so it and the plain version compute the
# same softmax from the same maximum and round the same p: bitwise equal.
# Multi-block cases: the JAX kernel walks 1024-key (decode) or 512-key
# (prefill) blocks with an online softmax and the plain version takes a
# split at once, so p is rounded to bf16 against different running maxima:
# each element of p moves by up to one bf16 ulp (2**-8 relative), and so does
# the weighted sum; 2**-6 of the row's largest output is four such ulps.
BF16_PARITY = {
    "decode one block": ("decode", 1, 16, 8, [[100], [127]], 1, True),
    "verify one block": ("decode", 4, 16, 8, [[3, 9, 60, 127], [0, 20, 21, 90]], 1, True),
    "prefill one block": ("prefill", 8, 16, 8, [list(range(90, 98)), list(range(120, 128))], None, True),
    "decode two splits": ("decode", 1, 64, 17, [[1050], [700]], 2, False),
    "prefill two blocks": ("prefill", 8, 16, 40, [list(range(600, 608)), list(range(500, 508))], None, False),
}


@pytest.mark.parametrize("case", sorted(BF16_PARITY))
def test_plain_versions_match_pallas_interpret_bf16(case):
    """bf16 caches through the Pallas kernels in interpret mode and the
    port's plain versions: both round the softmax weights p to the cache
    dtype before p.V (pallas_paged.py:388, pallas_prefill.py:210)."""
    kind, t, ps, npp, pos, num_splits, exact = BF16_PARITY[case]
    jx, tt = _bf16_case(13, b=2, t=t, ps=ps, npp=npp, positions=pos)
    scale = 64**-0.5
    if kind == "decode":
        want = j_decode_kernel(*jx, scale=scale, interpret=True, num_splits=num_splits)
        got = paged_decode.paged_decode_attention(*tt, scale=scale, num_splits=num_splits)
    else:
        want = j_prefill_kernel(*jx, scale=scale, interpret=True)
        got = paged_prefill.paged_prefill_attention(*tt, scale=scale)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        for row in range(got.shape[0]):
            for col in range(got.shape[1]):  # per query token, over its heads
                g, w = got[row, col], want[row, col]
                assert np.abs(g - w).max() <= 2**-6 * np.abs(w).max(), (row, col)


def _pr2_decode_smem(t_q, group, head_dim, itemsize):
    """The decode kernel's shared memory before the bf16 kernel kept its rows
    in registers: every row of T_q x G in shared memory (both dtypes)."""
    rows = t_q * group
    return (2 * itemsize * 64 * (2 * head_dim + 16 // itemsize)
            + 4 * (2 * rows * head_dim + rows * 64 + 3 * rows) + 4 * t_q)


@pytest.mark.parametrize("cache_dtype", [torch.bfloat16, torch.float32])
def test_decode_predicate_keeps_every_shape_and_mirrors_the_kernel(cache_dtype):
    """decode_kernel_supported accepts every (T_q <= 32, G in {4, 8}, hd in
    {64, 128}) shape the earlier mirror accepted and refuses any layout over
    227 KB; the bf16 layout does not grow with T_q, so the bf16 form takes
    T_q past 32 up to the grid's y extent, where the f32 form refuses T_q > 32."""
    itemsize = torch.empty((), dtype=cache_dtype).element_size()
    for hd in (64, 128):
        for group in (4, 8):
            for t_q in range(1, paged_decode.MAX_VERIFY_T + 1):
                for q_dtype in (torch.bfloat16, torch.float32):
                    ok = paged_decode.decode_kernel_supported(8 * group, hd, 8 * hd, t_q, q_dtype=q_dtype,
                                                              cache_dtype=cache_dtype)
                    smem = paged_decode._smem_bytes(t_q, group, hd, itemsize)
                    assert ok == (smem <= paged_decode.SMEM_BYTES)
                    if _pr2_decode_smem(t_q, group, hd, itemsize) <= paged_decode.SMEM_BYTES:
                        assert ok, (t_q, group, hd)
            wide = [paged_decode.MAX_VERIFY_T + 1, 2048]
            got = [paged_decode.decode_kernel_supported(8 * group, hd, 8 * hd, t, q_dtype=cache_dtype,
                                                        cache_dtype=cache_dtype) for t in wide]
            assert got == [cache_dtype == torch.bfloat16] * 2
            # Past the grid's y extent (8 KV heads x 16-row tiles): refused by either form.
            t_max = paged_decode.MAX_GRID_Y // 8 * paged_decode.ROW_TILE // group
            assert paged_decode.row_tiles(t_max, group) * 8 <= paged_decode.MAX_GRID_Y
            assert not paged_decode.decode_kernel_supported(8 * group, hd, 8 * hd, t_max + 1, q_dtype=cache_dtype,
                                                            cache_dtype=cache_dtype)
    if cache_dtype == torch.bfloat16:
        # 1 KB alignment slack, a ring of 4 x 64-key K/V stages, one 16-row query tile,
        # 16 mbarriers and 16 positions: 69,056 bytes at hd 64, whatever T_q.
        assert {paged_decode._smem_bytes(t, 8, 64, 2) for t in (1, 32)} == {
            1024 + 4 * 2 * 64 * 64 * 2 + 2 * 16 * 72 + 8 * 16 + 4 * 16}
        # The page ids of a split ride on top: 16-token pages, 7 key blocks -> 29 ids.
        assert paged_decode._page_id_bytes(7, 16) == 4 * 29
    else:
        # The f32 kernel keeps rows in shared memory: 32 x 8 rows at hd 128 is over 227 KB.
        assert paged_decode._smem_bytes(32, 8, 128, 4) > paged_decode.SMEM_BYTES
        assert not paged_decode.decode_kernel_supported(64, 128, 1024, 32, q_dtype=cache_dtype,
                                                        cache_dtype=cache_dtype)


@pytest.mark.parametrize("cache_dtype", [torch.bfloat16, torch.float32])
def test_prefill_predicate_mirrors_the_kernel(cache_dtype):
    """prefill_kernel_supported takes the shapes it took before and, for the
    bf16 (wgmma) kernel, gates on its shared memory: 1 KB of alignment slack,
    a 128-row query tile (16 KB per 64 columns), a ring of 128-key K/V
    stages (32 KB per 64 columns each; 4 at hd 64, 2 at hd 128), barriers,
    and one page id per table entry."""
    assert paged_prefill._smem_bytes(64, 128) == 1024 + 16384 + 4 * 32768 + 64 + 16 + 4 * 128
    assert paged_prefill._smem_bytes(128, 0) == 1024 + 2 * 16384 + 2 * 2 * 32768 + 32 + 16
    kw = dict(q_dtype=torch.bfloat16, cache_dtype=cache_dtype)
    for hd in (64, 128):
        for group in (1, 4, 8, 64):
            assert paged_prefill.prefill_kernel_supported(8 * group, hd, 8 * hd, **kw)
            assert paged_prefill.prefill_kernel_supported(8 * group, hd, 8 * hd, table_width=8192, **kw)
        assert not paged_prefill.prefill_kernel_supported(8 * 65, hd, 8 * hd, **kw)
    # A table whose page ids overflow 227 KB next to the hd-128 tiles.
    huge = (paged_prefill.SMEM_BYTES - paged_prefill._smem_bytes(128, 0)) // 4 + 1
    assert paged_prefill.prefill_kernel_supported(32, 128, 1024, table_width=huge, **kw) == (
        cache_dtype == torch.float32)


@pytest.mark.parametrize("name", sorted(build.SIGNATURES))
def test_ctypes_signature_matches_the_c_entry_point(name):
    """Each library's ctypes argument list mirrors its ``extern "C"`` entry
    point in ``csrc/`` (pointers c_void_p, ints c_int, floats c_float), so
    ctypes never passes an argument in the wrong slot or width."""
    import ctypes
    import re

    fn_name, argtypes = build.SIGNATURES[name]
    src = (build.SRC_DIR / f"{name}.cu").read_text()
    params = re.search(r'extern "C" int ' + fn_name + r"\((.*?)\)\s*\{", src, re.S).group(1)
    want = []
    for param in params.split(","):
        decl = param.strip()
        want.append(ctypes.c_void_p if "*" in decl else ctypes.c_float if decl.startswith("float") else ctypes.c_int)
    assert argtypes == want


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
    seeds = torch.tensor([5, 5, 9], dtype=torch.int32)
    steps = torch.tensor([2, 2, 2], dtype=torch.int32)
    temp = torch.tensor([1.0, 1.0, 0.0])
    g = tsampling.gumbel_noise(seeds, steps, temp, 16)
    assert torch.equal(g[0], g[1])  # same (seed, step): same noise wherever the row sits
    assert torch.equal(g[2], torch.zeros(16))  # greedy rows read none
    assert torch.equal(tsampling.gumbel_noise(seeds[:1], steps[:1], temp[:1], 16)[0], g[0])
    assert not torch.equal(tsampling.gumbel_noise(seeds[:1], steps[:1] + 1, temp[:1], 16)[0], g[0])


# The seeds the runner packs as int32 (uint32 viewed), and sample_steps.
THREEFRY_SEEDS = [0, 1, 2**31, 2**32 - 1]
THREEFRY_STEPS = np.array([0, 1, 1000], np.int32)


@pytest.mark.parametrize("seed", THREEFRY_SEEDS)
def test_threefry_noise_matches_jax_random(seed):
    """The port's threefry-2x32 draw against jax.random on the keys the JAX
    runner folds, fold_in(PRNGKey(seed), step) (runner.py:295): the 32-bit
    words and the uniforms bitwise; the Gumbel noise -log(-log(u)) within 2
    ulps of max(|g|, 1), as each log may differ from XLA's CPU log by an ulp
    (the largest difference seen against jax 0.9's CPU build is 1 such ulp)."""
    seeds = np.full(len(THREEFRY_STEPS), seed, np.uint32).view(np.int32)
    keys = jax.vmap(lambda s, c: jax.random.fold_in(jax.random.PRNGKey(s), c))(
        jnp.asarray(seeds), jnp.asarray(THREEFRY_STEPS))
    width = tsampling.CANDIDATES
    bits = tsampling.random_bits(_t(seeds), _t(THREEFRY_STEPS), width)
    want_bits = np.asarray(jax.vmap(lambda k: jax.random.bits(k, (width,), jnp.uint32))(keys))
    np.testing.assert_array_equal(bits.numpy().astype(np.uint32), want_bits)
    tiny = np.finfo(np.float32).tiny
    want_u = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (width,), jnp.float32, tiny, 1.0))(keys))
    np.testing.assert_array_equal(tsampling.uniform_from_bits(bits).numpy(), want_u)
    want_g = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (width,), jnp.float32))(keys))
    got_g = tsampling.gumbel_noise(_t(seeds), _t(THREEFRY_STEPS), torch.ones(len(seeds)), width).numpy()
    ulp = np.spacing(np.maximum(np.abs(want_g), 1.0).astype(np.float32))
    assert (np.abs(got_g - want_g) <= 2 * ulp).all()


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
