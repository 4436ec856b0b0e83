"""dynamo_tpu_torch's fp8 e4m3 KV cache held against dynamo_tpu (JAX) on the CPU.

The cast that writes the cache, bitwise against JAX's; the launcher's cache
dtype resolution; the three kernels' plain versions (what the wrappers run
for CPU tensors; the CUDA kernels' fp8 forms are held against them on the
card by chip_smoke.py) on the same fp8 cache bytes as the Pallas kernels in
interpret mode; and both engines' greedy tokens with fp8 caches. Inputs are
made with numpy from a seed.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.core import EngineConfig as JEngineConfig, EngineCore as JEngineCore
from dynamo_tpu.engine.runner import ModelRunner
from dynamo_tpu.launch import _kv_cache_dtype as j_kv_cache_dtype
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models.config import PRESETS as JPRESETS
from dynamo_tpu.ops import attention as jattn
from dynamo_tpu.ops.pallas_mla import mla_paged_decode as j_mla_kernel
from dynamo_tpu.ops.pallas_paged import paged_decode_attention as j_decode_kernel
from dynamo_tpu.ops.pallas_prefill import paged_prefill_attention as j_prefill_kernel
from dynamo_tpu.protocols.common import PreprocessedRequest as JRequest
from dynamo_tpu.protocols.common import SamplingOptions as JSampling
from dynamo_tpu.protocols.common import StopConditions as JStop
from dynamo_tpu_torch import launch
from dynamo_tpu_torch.bridge import params_from_jax, tensor_from_numpy
from dynamo_tpu_torch.engine.core import EngineConfig, EngineCore
from dynamo_tpu_torch.engine.runner import TorchModelRunner
from dynamo_tpu_torch.models.config import PRESETS
from dynamo_tpu_torch.ops import attention as tattn
from dynamo_tpu_torch.ops import paged_decode, paged_mla, paged_prefill
from dynamo_tpu_torch.protocols.common import PreprocessedRequest, SamplingOptions, StopConditions

FP8 = torch.float8_e4m3fn


def _jax_fp8_bytes(x: np.ndarray) -> np.ndarray:
    return np.asarray(jnp.asarray(x).astype(jnp.float8_e4m3fn)).view(np.uint8)


def test_fp8_cast_is_jax_cast_on_every_bf16_pattern():
    """All 65,536 bf16 bit patterns (NaNs, infinities, subnormals, and the
    30,512 finite values past 464 where ``.to()`` saturates to 448 and JAX
    writes NaN) cast to the same byte as JAX's ``astype``."""
    pats = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16)
    want = _jax_fp8_bytes(pats.view(ml_dtypes.bfloat16))
    x = torch.from_numpy(pats.view(np.int16).copy()).view(torch.bfloat16)
    got = tattn.to_fp8_like_jax(x)
    assert got.dtype == FP8
    np.testing.assert_array_equal(got.view(torch.uint8).numpy(), want)
    assert (want[np.abs(pats.view(ml_dtypes.bfloat16).astype(np.float32)) >= 466] & 0x7F == 0x7F).all()


def test_fp8_cast_is_jax_cast_around_the_overflow_threshold():
    """f32 values from 440 to 490 on both signs, every f32 next to 448, 464
    and 480, the infinities and NaN: bitwise JAX's bytes."""
    sweep = np.linspace(440.0, 490.0, 2001, dtype=np.float32)
    edges = [np.nextafter(np.float32(v), np.float32(d)) for v in (448, 464, 480) for d in (0, 1e9)]
    x = np.concatenate([sweep, np.float32([448, 464, 480, np.inf, np.nan]), np.float32(edges)])
    x = np.concatenate([x, -x])
    got = tattn.to_fp8_like_jax(torch.from_numpy(x)).view(torch.uint8).numpy()
    np.testing.assert_array_equal(got, _jax_fp8_bytes(x))


def test_write_kv_on_fp8_caches_matches_jax():
    """write_kv into fp8 caches writes JAX's bytes, outliers included, in place."""
    rng = np.random.default_rng(2)
    nk = (rng.standard_normal((2, 3, 2, 16)) * 200).astype(np.float32)
    nv = rng.standard_normal((2, 3, 2, 16)).astype(np.float32)
    nk[0, 0, 0, :3] = [470.0, -np.inf, 463.9]
    slots = np.array([[4, 5, 6], [13, 21, 22]], np.int32)
    kc = np.zeros((6, 4, 32), ml_dtypes.float8_e4m3fn)
    wk, wv = jattn.write_kv(jnp.asarray(kc), jnp.asarray(kc), jnp.asarray(nk), jnp.asarray(nv), jnp.asarray(slots))
    tk, tv = tensor_from_numpy(kc), tensor_from_numpy(kc)
    out = tattn.write_kv(tk, tv, torch.from_numpy(nk), torch.from_numpy(nv), torch.from_numpy(slots))
    assert out[0] is tk and out[1] is tv and tk.dtype == FP8
    np.testing.assert_array_equal(tk.view(torch.uint8).numpy(), np.asarray(wk).view(np.uint8))
    np.testing.assert_array_equal(tv.view(torch.uint8).numpy(), np.asarray(wv).view(np.uint8))


def test_kv_cache_dtype_resolution(monkeypatch):
    """launch._kv_cache_dtype resolves the JAX launcher's names to the same
    choices (tests/test_spec_decode.py:160), and the port's launcher takes
    --kv-cache-dtype and serves with fp8 caches when the environment asks."""
    for env in ("DYN_KV_CACHE_DTYPE", "DYN_WORKER_KV_CACHE_DTYPE"):
        monkeypatch.delenv("DYN_KV_CACHE_DTYPE", raising=False)
        monkeypatch.delenv("DYN_WORKER_KV_CACHE_DTYPE", raising=False)
        assert launch._kv_cache_dtype() is None and j_kv_cache_dtype() is None
        for name in ("fp8", "float8_e4m3fn", "FP8_E4M3 "):
            monkeypatch.setenv(env, name)
            assert launch._kv_cache_dtype() == FP8 and j_kv_cache_dtype() == jnp.float8_e4m3fn
        for name in ("bf16", "bfloat16", ""):
            monkeypatch.setenv(env, name)
            assert launch._kv_cache_dtype() is None and j_kv_cache_dtype() is None
        monkeypatch.setenv(env, "int4")
        with pytest.raises(ValueError, match="unsupported kv cache dtype"):
            launch._kv_cache_dtype()
        with pytest.raises(ValueError, match="unsupported kv cache dtype"):
            j_kv_cache_dtype()
    parser = launch.build_parser()
    assert parser.parse_args([]).kv_cache_dtype == "bf16"
    assert parser.parse_args(["--kv-cache-dtype", "fp8"]).kv_cache_dtype == "fp8"
    with pytest.raises(SystemExit):
        parser.parse_args(["--kv-cache-dtype", "int8"])

    import asyncio

    monkeypatch.setenv("DYN_KV_CACHE_DTYPE", "fp8")

    async def cache_dtype():
        svc = await launch.build_engine_service("test-tiny", device="cpu", num_pages=8)
        try:
            return svc.core.runner.k_cache.dtype, svc.core.runner.v_cache.dtype
        finally:
            await svc.close()

    assert asyncio.run(cache_dtype()) == (FP8, FP8)


def test_runner_refuses_other_cache_dtypes_by_name():
    params = {"unused": torch.zeros(1)}
    with pytest.raises(ValueError, match="float16"):
        TorchModelRunner(PRESETS["test-tiny"], params, num_pages=4, page_size=4, cache_dtype=torch.float16,
                         device="cpu")


@pytest.mark.parametrize("name", ["test-tiny", "test-tiny-mla"])
def test_kv_bytes_per_token_matches_jax_and_the_allocated_cache(name):
    """``kv_bytes_per_token`` equals JAX's at every itemsize (fp8, bf16, f32,
    the model's own) and the bytes a token takes in the caches
    ``init_kv_cache`` allocates at that itemsize."""
    from dynamo_tpu_torch.models import llama as tllama

    cfg = PRESETS[name]
    for itemsize, dtype in ((1, FP8), (2, torch.bfloat16), (4, torch.float32), (None, None)):
        assert cfg.kv_bytes_per_token(itemsize) == JPRESETS[name].kv_bytes_per_token(itemsize)
        kc, vc = tllama.init_kv_cache(cfg, 2, 4, dtype, device="cpu")
        per_token = (kc.numel() * kc.element_size() + vc.numel() * vc.element_size()) // (2 * 4)
        assert cfg.kv_bytes_per_token(itemsize) == per_token


def test_bridge_carries_fp8_bytes():
    codes = np.arange(256, dtype=np.uint8)
    t = tensor_from_numpy(codes.view(ml_dtypes.float8_e4m3fn))
    assert t.dtype == FP8
    np.testing.assert_array_equal(t.view(torch.uint8).numpy(), codes)
    # Every code widens to bf16 exactly (the kernels' on-chip conversion).
    want = codes.view(ml_dtypes.float8_e4m3fn).astype(np.float32)
    got = t.to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got[~np.isnan(got)], want[~np.isnan(want)])


def _earlier_fp8_smem_bytes(kernel: str, *dims) -> int:
    """The fp8 forms' earlier shared-memory layouts (a shallower fp8 ring
    beside the bf16 one; MLA at 32-key stages where its 64-key rings did not
    fit): every geometry those layouts took must stay taken."""
    if kernel == "prefill":
        hd, table_width = dims
        f8 = 2 if hd == 64 else 1
        return paged_prefill._smem_bytes(hd, table_width) + f8 * (2 * 128 * hd + 8)
    r_kv, dr = dims
    na = r_kv // 64 + -(-dr // 64)

    def end(keys):
        head = na * 64 * 128 + 2 * na * keys * 128 + 64 * 128 + 5 * 8 + 4 * 2 * 64 + 4 * 64 + 4 * 2 * 64
        return 1024 + -(-(head + 16) // 128) * 128 + 2 * keys * (r_kv + dr)

    return end(64) if end(64) <= paged_mla.SMEM_BYTES else end(32)


def test_predicates_take_fp8_and_mirror_the_layouts():
    """Each predicate takes fp8 caches with bf16 or f32 queries, and its
    shared-memory mirror gives the fp8 form's layout: decode, a 4-deep ring
    at 1 byte an element for each of two warp groups plus each warp's two
    converted bf16 V slices; prefill, an
    fp8 ring of 4 (hd 64) or 2 (hd 128) stages beside the bf16 one, its page
    ids read from the table (any table width); MLA, the bf16 form's layout,
    its fp8 tiles converted in place in the bf16 ring, so it streams 64-key
    stages at mla-8b-proxy's 512-wide latent. Every geometry the earlier
    fp8 layouts took stays taken: head_dim 64 and 128 over any table, ropes
    of 32, 80, 128 and 512 lanes over latents of 128 and 512, pages of 2 to
    256 (the GQA predicates take any page size: 4, 8, 12, 16 and 24
    included)."""
    for q_dtype in (torch.bfloat16, torch.float32):
        kw = dict(q_dtype=q_dtype, cache_dtype=FP8)
        assert paged_decode.decode_kernel_supported(32, 64, 512, 1, **kw)
        assert paged_decode.decode_kernel_supported(32, 128, 1024, paged_decode.MAX_VERIFY_T, **kw)
        assert paged_prefill.prefill_kernel_supported(32, 64, 512, table_width=256, **kw)
        assert paged_mla.paged_mla_supported(32, 512, 128, 64, 16, **kw)
        assert not paged_decode.decode_kernel_supported(32, 64, 512, 1, q_dtype=FP8, cache_dtype=FP8)
        for hd in (64, 128):
            for table_width in (0, 128, 1024, 8192):
                if _earlier_fp8_smem_bytes("prefill", hd, table_width) <= paged_prefill.SMEM_BYTES:
                    assert paged_prefill.prefill_kernel_supported(32, hd, 8 * hd, table_width=table_width, **kw)
            edge = (paged_prefill.SMEM_BYTES - _earlier_fp8_smem_bytes("prefill", hd, 0)) // 4
            assert paged_prefill.prefill_kernel_supported(32, hd, 8 * hd, table_width=edge, **kw)
        taken = 0
        for r_kv in (128, 512):
            for dr in (32, 64, 80, 128, 512):
                for r_width in (dr, 128, 512):
                    for ps in (2, 4, 8, 16, 32, 256):
                        if dr <= r_width and _earlier_fp8_smem_bytes("mla", r_kv, dr) <= paged_mla.SMEM_BYTES:
                            taken += 1
                            assert paged_mla.paged_mla_supported(32, r_kv, r_width, dr, ps, **kw), (r_kv, dr, ps)
        assert taken > 60
    # decode: a 4-deep fp8 ring for each of 2 warp groups, each of the 8 warps' two bf16 V slices
    # of 16 keys, the query tile, 4 x 8 mbarriers and 16 positions.
    assert paged_decode._smem_bytes(1, 8, 64, 1) == (1024 + 4 * 2 * 2 * 64 * 64 + 8 * 2 * 2 * 16 * 64
                                                     + 2 * 16 * 72 + 8 * 4 * 8 + 4 * 16)
    # hd 128: 3 stages, no more than the earlier layout (an 8-deep ring, one converted stage), so the
    # page ids of every table width it took still fit.
    earlier = 1024 + 8 * 2 * 64 * 128 + 2 * 2 * 64 * 128 + 2 * 16 * 136 + 8 * 8 * 4 + 4 * 16
    assert paged_decode._smem_bytes(32, 8, 128, 1) == (1024 + 3 * 2 * 2 * 64 * 128 + 8 * 2 * 2 * 16 * 128
                                                       + 2 * 16 * 136 + 8 * 3 * 8 + 4 * 16) <= earlier
    # prefill: the page ids come from the table, their room goes to a deeper fp8 ring.
    assert paged_prefill._fp8_stages(64) == 4 and paged_prefill._fp8_stages(128) == 2
    assert paged_prefill._smem_bytes(64, 0, fp8=True) == 1024 + 16384 + 4 * 32768 + 4 * 2 * 128 * 64 + 8 * 12 + 16
    assert paged_prefill._smem_bytes(128, 1 << 20, fp8=True) == (1024 + 32768 + 2 * 65536 + 2 * 2 * 128 * 128
                                                                 + 8 * 6 + 16) <= 232448
    assert paged_prefill.prefill_kernel_supported(32, 128, 1024, table_width=1 << 20, q_dtype=torch.bfloat16,
                                                  cache_dtype=FP8)
    # mla-8b-proxy: 64-key stages on fp8 as on bf16, the budget to within a kilobyte.
    assert paged_mla._tile_keys(512, 64) == 64 and paged_mla._tile_keys(128, 64) == 64
    assert paged_mla._smem_bytes(512, 64, 1) == 1024 + 73728 + 147456 + 8192 + 40 + 512 + 256 + 512 <= 232448


def test_fp8_decode_split_plan_is_static_and_shared_by_the_plain_version(monkeypatch):
    """The fp8 form's split plan, pinned on a 132-SM card: one block a row
    tile per SM, as for bf16, where the fp8 block runs GROUPS_FP8 groups of
    4 warps over an fp8 ring 4 stages deep (3 at hd 128); at the serve's and the timed decode
    shape (batch 8 over 8 KV heads, 128-page tables of 16 tokens) 2 splits
    of 16 key blocks; never more than MAX_SPLITS, auto or asked for. T_q is
    no argument of it: the wrapper (on meta tensors, its launch recorded)
    and ``paged_decode_plain`` ask for the same plan on fp8 caches at T_q
    1, 8 and 32, and the plain version computes with it."""
    monkeypatch.setattr(paged_decode, "_sm_count", lambda index: 132)
    card = torch.device("cuda", 0)
    real = paged_decode.decode_split_plan
    assert paged_decode.GROUPS_FP8 == 2 and paged_decode._fp8_stages(64) == 4 and paged_decode._fp8_stages(128) == 3

    def plan(b, npp=128, ns=0):
        return real(b, 8, npp, 16, ns, card)

    assert plan(8) == (2, 16)
    assert [plan(b)[0] for b in (1, 2, 4, 8, 16, 32)] == [8, 8, 4, 2, 1, 1]
    assert all(plan(b, ns=ns)[0] <= paged_decode.MAX_SPLITS for b in (1, 2, 8) for ns in (0, 9, 64))
    asked = []

    def spy(*args):
        got = real(*args[:5], card)
        asked.append(got)
        return got

    launched = []
    monkeypatch.setattr(paged_decode, "decode_split_plan", spy)
    monkeypatch.setattr(paged_decode.build, "load", lambda name: lambda *a: launched.append(a[14:16]) or 0)
    monkeypatch.setattr(paged_decode.build, "stream_of", lambda t: 0)
    monkeypatch.setattr(paged_decode, "launches_fp8", 0)
    rng = np.random.default_rng(9)
    b, n_kv, hd, ps, npp = 4, 8, 64, 16, 32  # 32-page tables: 8 key blocks, 4 splits of 2
    kc, vc = (torch.from_numpy(rng.standard_normal((b * npp + 1, ps, n_kv * hd)).astype(np.float32)).to(FP8)
              for _ in range(2))
    tables = torch.from_numpy(1 + rng.permutation(b * npp).reshape(b, npp).astype(np.int32))
    for t in (1, 8, paged_decode.MAX_VERIFY_T):
        q = torch.from_numpy(rng.standard_normal((b, t, n_kv, hd)).astype(np.float32)).to(torch.bfloat16)
        pos = torch.from_numpy(np.sort(rng.integers(0, npp * ps, (b, t)), axis=1).astype(np.int32))
        args = (q, kc, vc, tables, pos)
        got = paged_decode.paged_decode_plain(*args, scale=hd**-0.5)
        assert torch.equal(got, paged_decode.paged_decode_plain(*args, scale=hd**-0.5, num_splits=4))
        paged_decode.paged_decode_attention(*(x.to("meta") for x in args), scale=hd**-0.5)
    assert asked == [(4, 2)] * 9  # the plain twice and the wrapper once per T_q
    assert launched == [(4, 2)] * 3 and paged_decode.launches_fp8 == 3


@pytest.mark.parametrize("cache", ["fp8", "bf16"])
def test_share_plans_pick_the_cluster_sizes(cache):
    """The share group ``paged_mla`` launches (``mla_share_plan``): 2 row
    tiles for an fp8 cache with an unsplit walk over at least 2 row tiles,
    else 1 (and always 1 on a bf16 cache). At mla-8b-proxy (32 heads):
    decode (split 8 ways, or one 64-row tile) 1; a 512-token chunk or the
    serve's mixed step (256 row tiles) 2, split 1; verify rows of 4 and 8
    tokens unsplit 2; at 4 heads 16 tokens (one tile) 1, 17 and 20 tokens
    (two tiles) 2. The kernel takes groups of 1 and 2 only."""
    dtype = FP8 if cache == "fp8" else torch.bfloat16
    two = 2 if cache == "fp8" else 1
    assert paged_mla.mla_share_plan(1, 32, 8, dtype) == 1
    assert paged_mla.mla_share_plan(1, 32, 1, dtype) == 1
    assert paged_mla.mla_share_plan(2, 32, 1, dtype) == 1
    assert paged_mla.mla_share_plan(512, 32, 1, dtype) == two
    assert paged_mla.mla_share_plan(512, 32, 2, dtype) == 1
    assert paged_mla.mla_share_plan(4, 32, 1, dtype) == two
    assert paged_mla.mla_share_plan(8, 32, 1, dtype) == two
    assert paged_mla.mla_share_plan(16, 4, 1, dtype) == 1
    assert paged_mla.mla_share_plan(17, 4, 1, dtype) == two
    assert paged_mla.mla_share_plan(20, 4, 1, dtype) == two
    assert {paged_mla.mla_share_plan(t, h, s, dtype) for t in (1, 3, 64, 512, 4096) for h in (1, 16, 128)
            for s in (1, 4)} == {1, two}


# -- the plain versions on fp8 caches against the Pallas kernels ------------------


def _fp8(a: np.ndarray):
    """The same fp8 bytes on both sides: a JAX array and a torch tensor."""
    j = jnp.asarray(a).astype(jnp.float8_e4m3fn)
    return j, tensor_from_numpy(np.asarray(j))


def _q(a: np.ndarray, q_dtype: str):
    if q_dtype == "f32":
        return jnp.asarray(a), torch.from_numpy(a.copy())
    j = jnp.asarray(a).astype(jnp.bfloat16)
    return j, tensor_from_numpy(np.asarray(j))


def _gqa_case(seed, *, b, t, ps, npp, positions, q_dtype):
    """8 heads over 2 KV heads, hd 64; caches of N(0, 4) cast to fp8 once."""
    rng = np.random.default_rng(seed)
    pages = b * npp + 1
    kc = (rng.standard_normal((pages, ps, 128)) * 2).astype(np.float32)
    vc = (rng.standard_normal((pages, ps, 128)) * 2).astype(np.float32)
    q = rng.standard_normal((b, t, 8, 64)).astype(np.float32)
    tables = (1 + rng.permutation(pages - 1)[: b * npp]).reshape(b, npp).astype(np.int32)
    pos = np.asarray(positions, np.int32)
    (jq, tq), (jk, tk), (jv, tv) = _q(q, q_dtype), _fp8(kc), _fp8(vc)
    return [jq, jk, jv, jnp.asarray(tables), jnp.asarray(pos)], [tq, tk, tv, torch.from_numpy(tables),
                                                                 torch.from_numpy(pos)]


# (kind, T, positions, query dtype): decode and a gappy verify (the decode
# kernel), a prefill chunk and a mixed step's chunk beside a 1-token decode
# row (the prefill kernel), bf16 and f32 queries; 16-token pages, 8 a row.
FP8_PARITY = {
    "decode f32 queries": ("decode", 1, [[77], [127]], "f32"),
    "verify": ("decode", 4, [[3, 9, 60, 127], [0, 20, 21, 90]], "bf16"),
    "prefill f32 queries": ("prefill", 8, [list(range(40, 48)), list(range(0, 8))], "f32"),
    "mixed step": ("prefill", 8, [list(range(100, 108)), [127] + [0] * 7], "bf16"),
}


@pytest.mark.parametrize("case", sorted(FP8_PARITY))
def test_plain_versions_match_pallas_interpret_fp8(case):
    """fp8 caches (the same bytes) through the Pallas kernels in interpret
    mode and the port's plain versions (pallas_paged.py:368,
    pallas_prefill.py:189: K/V upcast to bf16, queries staged in bf16, p
    rounded to bf16 before p.V).

    Bitwise: the port's fp8 form equals its bf16 form on the cache upcast to
    bf16 (the upcast is exact, and nothing else differs). Against JAX, per
    query token over its heads, within 2**-6 of the token's largest output
    (four bf16 ulps): XLA's CPU dot and torch's einsum sum the f32 scores in
    different orders, so a p or an output element near a bf16 rounding
    boundary can land one ulp apart (on these inputs some do)."""
    kind, t, pos, q_dtype = FP8_PARITY[case]
    jx, tt = _gqa_case(17, b=2, t=t, ps=16, npp=8, positions=pos, q_dtype=q_dtype)
    scale = 64**-0.5
    if kind == "decode":
        want = j_decode_kernel(*jx, scale=scale, interpret=True, num_splits=1)
        fn = paged_decode.paged_decode_attention
    else:
        want = j_prefill_kernel(*jx, scale=scale, interpret=True)
        fn = paged_prefill.paged_prefill_attention
    got = fn(*tt, scale=scale)
    assert got.dtype == tt[0].dtype
    upcast = fn(tt[0], tt[1].to(torch.bfloat16), tt[2].to(torch.bfloat16), *tt[3:], scale=scale)
    assert torch.equal(got, upcast)
    got, want = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    for row in range(2):
        for col in range(t):
            if kind == "prefill" and col and not pos[row][col]:
                continue  # a padding column: unspecified
            g, w = got[row, col], want[row, col]
            assert np.abs(g - w).max() <= 2**-6 * np.abs(w).max(), (row, col)


# MLA at the kernel geometry at test size (tests/test_torch_mla.py): latent
# 128, rope 64 in a 128-lane stream, 4 heads, 16-token pages.
MLA_CASES = {
    "verify": (4, [[3, 9, 10, 30], [100, 128, 129, 170], [64, 65, 66, 67]], "bf16"),
    "chunk f32 queries": (5, [[150, 151, 152, 153, 154], [40, 0, 0, 0, 0], [0, 1, 2, 3, 4]], "f32"),
}


@pytest.mark.parametrize("kind", sorted(MLA_CASES))
def test_mla_plain_version_matches_pallas_interpret_fp8(kind):
    """paged_mla's plain version on fp8 latent and rope caches against the
    Pallas kernel in interpret mode (pallas_mla.py:200), one split on both
    sides: both round q and p to bf16 and upcast the latents exactly, so
    only f32 summation order differs (well under 1e-5 on O(1) outputs)."""
    t, positions, q_dtype = MLA_CASES[kind]
    rng = np.random.default_rng(7)
    b, pages, r_kv, dr, width, heads, ps, npp = len(positions), 1 + 3 * 12, 128, 64, 128, 4, 16, 12
    c = rng.standard_normal((pages, ps, r_kv)).astype(np.float32)
    r = np.zeros((pages, ps, width), np.float32)
    r[..., :dr] = rng.standard_normal((pages, ps, dr))
    tables = (1 + rng.permutation(b * npp)).reshape(b, npp).astype(np.int32)
    pos = np.asarray(positions, np.int32)
    for i in range(b):
        tables[i, int(pos[i].max()) // ps + 1:] = -1
    (jql, tql), (jqr, tqr) = (_q(rng.standard_normal((b, t, heads, w)).astype(np.float32), q_dtype)
                              for w in (r_kv, dr))
    (jc, tc), (jr, tr) = _fp8(c), _fp8(r)
    scale = (32 + dr) ** -0.5
    jqr_padded = jnp.pad(jqr, ((0, 0), (0, 0), (0, 0), (0, width - dr)))  # the JAX wrapper's lane pad
    want = np.asarray(j_mla_kernel(jql, jqr_padded, jc, jr, jnp.asarray(tables), jnp.asarray(pos), scale=scale,
                                   interpret=True, num_splits=1))
    got = paged_mla.paged_mla(tql, tqr, tc, tr, torch.from_numpy(tables), torch.from_numpy(pos), scale=scale,
                              num_splits=1)
    assert got.dtype == torch.float32 and got.shape == (b, t, heads, r_kv)
    for row in range(b):
        n = int(np.argmax(pos[row])) + 1  # columns past the row's largest position are padding
        np.testing.assert_allclose(got.numpy()[row, :n], want[row, :n], rtol=0, atol=1e-5)


# -- both engines with fp8 caches ---------------------------------------------------

PAGE = 4
ENGINE = dict(num_pages=48, page_size=PAGE, max_batch_size=4, max_prefill_tokens=64,
              max_seq_len=128, chunk_prefill_tokens=8, eos_token_ids=(257,))


def _drive(core, make_request, arrivals):
    """Requests join at their step index; returns tokens per request index."""
    outputs, seq_of = {}, {}
    for step in range(400):
        for i, (at, prompt, n) in enumerate(arrivals):
            if at == step:
                seq_of[core.add_request(make_request(prompt, n)).seq_id] = i
        if step > max(a for a, _, _ in arrivals) and not core.has_work:
            break
        for seq, out in core.step():
            outputs.setdefault(seq_of[seq.seq_id], []).extend(out.token_ids)
    return outputs


# (JAX attention, arrivals (step, prompt, max tokens)). test-tiny: against
# the JAX reference attention, which upcasts fp8 K/V to the query dtype (f32
# here) and keeps p in f32 (ops/attention.py:95) where the port stages
# queries and p in bf16 as the Pallas kernels do; the tokens agree all the
# same, with a prefix-cache hit and 8-token chunks forcing mixed steps.
# test-tiny-mla: the JAX reference rounds p to the cache's fp8
# (models/mla.py:237) and its tokens part from the port's, so the JAX side
# runs its Pallas MLA kernel in interpret mode (DYNAMO_PALLAS_INTERPRET=1),
# whose rounding the port follows; interpret mode costs seconds a step, so
# two short requests (still a mixed step).
FP8_ENGINES = {
    "test-tiny": ("reference", [(0, list(range(3, 23)), 7), (2, [9, 8, 7, 6, 5], 9),
                                (3, list(range(3, 19)) + list(range(40, 55)), 5)]),
    "test-tiny-mla": ("pallas", [(0, list(range(3, 15)), 4), (1, [9, 8, 7, 6, 5], 4)]),
}


@pytest.mark.parametrize("name", sorted(FP8_ENGINES))
def test_engine_greedy_tokens_on_fp8_caches_equal_jax(name, monkeypatch):
    """EngineCore with fp8 caches: greedy tokens equal to the JAX engine's
    with fp8 caches (FP8_ENGINES says which JAX attention and why)."""
    impl, arrivals = FP8_ENGINES[name]
    monkeypatch.setenv("DYNAMO_PALLAS_INTERPRET", "1")
    jparams = jllama.init_params(JPRESETS[name], 0)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    runner_kw = dict(num_pages=ENGINE["num_pages"], page_size=PAGE, max_batch_size=ENGINE["max_batch_size"],
                     prefill_bucket=16)
    jcore = JEngineCore(ModelRunner(JPRESETS[name], jparams, attn_impl=impl, cache_dtype=jnp.float8_e4m3fn,
                                    **runner_kw), JEngineConfig(**ENGINE))
    tcore = EngineCore(TorchModelRunner(PRESETS[name], params, device="cpu", cache_dtype=FP8, **runner_kw),
                       EngineConfig(**ENGINE))
    assert tcore.runner.k_cache.dtype == tcore.runner.v_cache.dtype == FP8
    want = _drive(jcore, lambda p, n: JRequest(token_ids=p, sampling=JSampling(temperature=0.0),
                                                stop=JStop(max_tokens=n)), arrivals)
    got = _drive(tcore, lambda p, n: PreprocessedRequest(token_ids=p, sampling=SamplingOptions(temperature=0.0),
                                                         stop=StopConditions(max_tokens=n)), arrivals)
    assert got == want
    assert [len(got[i]) for i in range(len(arrivals))] == [n for _, _, n in arrivals]
    assert tcore.mixed_steps == jcore.mixed_steps > 0
    if impl == "pallas":
        assert all(path == "pallas" for _, path in jcore.attn_dispatch_counts)
