"""dynamo_tpu_torch MLA held against dynamo_tpu (JAX) on the CPU.

The paged MLA kernel's plain version (what ``ops/paged_mla.paged_mla`` runs
for CPU tensors; the CUDA kernel itself is held against it on the card by
chip_smoke.py) against the JAX Pallas kernel in interpret mode and the
gather formulation; the absorbed ``mla_attention`` against the naive golden
model; and ``EngineCore`` serving test-tiny-mla against the JAX engine,
greedy tokens bitwise. Inputs are made with numpy from a seed.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.core import EngineConfig as JEngineConfig, EngineCore as JEngineCore
from dynamo_tpu.engine.runner import ModelRunner
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models import mla as jmla
from dynamo_tpu.models.config import PRESETS as JPRESETS
from dynamo_tpu.ops.pallas_mla import mla_paged_decode as j_mla_kernel
from dynamo_tpu.ops.rope import rope_frequencies as j_rope_frequencies
from dynamo_tpu.protocols.common import PreprocessedRequest as JRequest
from dynamo_tpu.protocols.common import SamplingOptions as JSampling
from dynamo_tpu.protocols.common import StopConditions as JStop
from dynamo_tpu_torch.bridge import params_from_jax
from dynamo_tpu_torch.engine.core import EngineConfig, EngineCore
from dynamo_tpu_torch.engine.runner import TorchModelRunner
from dynamo_tpu_torch.models import llama as tllama
from dynamo_tpu_torch.models import mla as tmla
from dynamo_tpu_torch.models.config import PRESETS
from dynamo_tpu_torch.ops import paged_mla
from dynamo_tpu_torch.ops.rope import rope_frequencies
from dynamo_tpu_torch.protocols.common import PreprocessedRequest, SamplingOptions, StopConditions

# f32 on both sides; only the summation order differs (~1e-7 relative), so
# 1e-5 absolute on O(1) outputs.
ATOL = 1e-5

# The kernel geometry at test size (tests/test_pallas_mla.py): latent 128,
# rope 64 padded to a 128-lane stream, 4 heads.
R_KV, DR, R_WIDTH, HEADS = 128, 64, 128, 4
PS, NPP = 16, 12  # 16-token pages, 12 per row: three 64-key split blocks


def _t(a):
    return torch.from_numpy(np.array(a))


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _mla_case(seed, *, t, positions):
    """Random f32 latent/rope pages (the rope tail past DR zero, as the
    writers leave it), tables with -1 past each row's used pages."""
    rng = np.random.default_rng(seed)
    b = len(positions)
    pages = 1 + b * NPP
    c = rng.standard_normal((pages, PS, R_KV)).astype(np.float32)
    r = np.zeros((pages, PS, R_WIDTH), np.float32)
    r[..., :DR] = rng.standard_normal((pages, PS, DR))
    tables = (1 + rng.permutation(b * NPP)).reshape(b, NPP).astype(np.int32)
    pos = np.asarray(positions, np.int32)
    for i in range(b):
        tables[i, int(pos[i].max()) // PS + 1:] = -1
    q_lat = rng.standard_normal((b, t, HEADS, R_KV)).astype(np.float32)
    q_rope = rng.standard_normal((b, t, HEADS, DR)).astype(np.float32)
    return q_lat, q_rope, c, r, tables, pos


# T_q 1 decode at ragged lengths (one inside the first page, one at a split
# boundary); T_q 4 gappy verify rows; a contiguous chunk after a cached prefix
# beside a padded 1-token row (a mixed step).
CASES = {
    "decode": (1, [[4], [63], [130], [190]]),
    "verify": (4, [[3, 9, 10, 30], [0, 0, 0, 0], [100, 128, 129, 170], [64, 65, 66, 67]]),
    "chunk": (5, [[150, 151, 152, 153, 154], [40, 0, 0, 0, 0], [0, 1, 2, 3, 4], [186, 187, 188, 189, 190]]),
}


@pytest.mark.parametrize("kind", sorted(CASES))
def test_plain_version_matches_pallas_interpret_and_gather(kind):
    """paged_mla's plain version (CPU tensors), unsplit and in three splits,
    against the JAX Pallas kernel in interpret mode and the gather
    formulation, over every column."""
    t, positions = CASES[kind]
    q_lat, q_rope, c, r, tables, pos = _mla_case(7, t=t, positions=positions)
    scale = (32 + DR) ** -0.5
    q_rope_padded = np.pad(q_rope, ((0, 0), (0, 0), (0, 0), (0, R_WIDTH - DR)))  # the JAX wrapper's lane pad
    want = np.asarray(j_mla_kernel(jnp.asarray(q_lat), jnp.asarray(q_rope_padded), jnp.asarray(c), jnp.asarray(r),
                                   jnp.asarray(tables), jnp.asarray(pos), scale=scale, interpret=True,
                                   num_splits=2))
    args = (_t(q_lat), _t(q_rope), _t(c), _t(r), _t(tables), _t(pos))
    gather = tmla._gather_attention(*args[:5], args[5], scale).numpy()
    np.testing.assert_allclose(gather, want, rtol=0, atol=ATOL)
    for num_splits in (1, 3):
        got = paged_mla.paged_mla(*args, scale=scale, num_splits=num_splits)
        assert got.dtype == torch.float32 and got.shape == (len(positions), t, HEADS, R_KV)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_split_plan_is_static_and_the_predicate_mirrors_the_kernel():
    cpu = torch.device("cpu")
    # Explicit splits clamp to the 64-key blocks of the table and to a
    # cluster's portable size; auto is 1 on the CPU.
    assert paged_mla.mla_split_plan(8, 1, 128, 16, 5, cpu) == (5, 7)
    assert paged_mla.mla_split_plan(8, 4, 128, 16, 50, cpu) == (paged_mla.MAX_SPLITS, 4)
    assert paged_mla.mla_split_plan(8, 512, 128, 16, 0, cpu) == (1, 32)
    kw = dict(q_dtype=torch.bfloat16, cache_dtype=torch.bfloat16)
    assert paged_mla.paged_mla_supported(32, 512, 128, 64, 16, **kw)  # mla-8b-proxy
    assert paged_mla.paged_mla_supported(4, 128, 128, 64, 32, q_dtype=torch.float32, cache_dtype=torch.float32)
    assert paged_mla.paged_mla_supported(128, 512, 128, 128, 16, **kw)
    assert paged_mla.paged_mla_supported(32, 512, 256, 256, 16, **kw)  # 32-key stages
    assert not paged_mla.paged_mla_supported(4, 24, 128, 8, 16, **kw)  # test-tiny-mla: latent off the kernel's widths
    assert not paged_mla.paged_mla_supported(32, 512, 64, 128, 16, **kw)  # rope wider than its stream
    assert not paged_mla.paged_mla_supported(32, 512, 128, 40, 16, **kw)  # rope not a multiple of 16
    assert not paged_mla.paged_mla_supported(32, 512, 128, 64, 1, **kw)  # a tile would span 64 pages
    assert not paged_mla.paged_mla_supported(32, 512, 128, 64, 24, **kw)  # not a power of 2
    assert not paged_mla.paged_mla_supported(32, 512, 512, 512, 16, **kw)  # tiles past the shared memory
    # The bf16 layout: mla-8b-proxy's 64-key stages fill the block's budget to
    # within a kilobyte; a rope of 128 lanes takes 32-key stages.
    assert paged_mla._tile_keys(512, 64) == 64 and paged_mla._tile_keys(512, 128) == 32
    assert paged_mla._smem_bytes(512, 64, 2) == 1024 + 73728 + 147456 + 8192 + 40 + 512 + 256 + 512 <= 232448


def _earlier_smem_bytes(r_kv, dr, itemsize):
    """The shared memory of the kernel the redesign replaced (32-row tiles,
    two 64-key cp.async buffers): the geometries it took must stay taken."""
    if itemsize == 2:
        return 2 * 160 * (r_kv + dr + 8) + 4 * 32 * 65 + 2 * 32 * 72 + 4 * 3 * 32 + 4 * 36
    return 4 * (64 * (r_kv + dr + 4) + 32 * 33 + 3 * 32) + 4 * 36


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_predicate_keeps_every_geometry_the_previous_kernel_took(dtype):
    """Every (latent, rope, rope stream, page size) the earlier kernel took is
    still taken: its predicate, with its shared-memory formula, over a grid."""
    kw = dict(q_dtype=dtype, cache_dtype=dtype)
    itemsize = torch.empty((), dtype=dtype).element_size()
    taken = 0
    for r_kv in (64, 128, 256, 512):
        for dr in range(16, 513, 16):
            for r_width in (dr, 128, 256, 512):
                for ps in (1, 2, 4, 8, 16, 24, 64, 256):
                    before = (r_kv in (128, 512) and ps >= 2 and not ps & (ps - 1) and dr <= r_width
                              and (r_width * itemsize) % 16 == 0
                              and _earlier_smem_bytes(r_kv, dr, itemsize) <= paged_mla.SMEM_BYTES)
                    if before:
                        taken += 1
                        assert paged_mla.paged_mla_supported(32, r_kv, r_width, dr, ps, **kw), (r_kv, dr, r_width, ps)
    assert taken > 100


def test_walk_facts_give_each_rows_walk_end_and_first_padding_token():
    """walk_facts against numpy: max(positions) + 1 is the row's walk length,
    and the first token holding the max marks the padding after it (ties on
    all-zero and repeated-max rows resolve to the first)."""
    pos = np.array([[5, 6, 7, 0, 0], [0, 0, 0, 0, 0], [3, 9, 10, 30, 0], [40, 0, 0, 0, 0], [4, 4, 4, 0, 0],
                    [100, 101, 102, 103, 104]], np.int32)
    walk_max, walk_first = paged_mla.walk_facts(_t(pos))
    assert walk_max.dtype == torch.int32 and walk_first.dtype == torch.int64
    np.testing.assert_array_equal(walk_max.numpy() + 1, pos.max(axis=1) + 1)
    np.testing.assert_array_equal(walk_first.numpy(), [2, 0, 3, 0, 0, 4])
    np.testing.assert_array_equal(walk_first.numpy(), np.argmax(pos == pos.max(axis=1, keepdims=True), axis=1))


@pytest.mark.parametrize("t", [1, 3])
def test_forward_computes_the_walk_facts_once_for_every_layer(monkeypatch, t):
    """The walk facts depend on the step's positions only: the forward
    reduces them once and hands the same pair to every layer's paged_mla
    call (none at T = 1, whose walk is its one position)."""
    cfg = PRESETS["test-tiny-mla"]
    reductions, walks = [], []
    real_walk_facts, real_paged_mla = tllama.walk_facts, tmla.paged_mla

    def counted(positions):
        reductions.append(real_walk_facts(positions))
        return reductions[-1]

    def recorded(*args, walk=None, **kw):
        walks.append(walk)
        return real_paged_mla(*args, walk=walk, **kw)

    monkeypatch.setattr(tllama, "walk_facts", counted)
    monkeypatch.setattr(tmla, "paged_mla", recorded)
    params = tllama.init_params(cfg, 0, device="cpu")
    ps, b = 4, 2
    kc, vc = tllama.init_kv_cache(cfg, 8, ps, device="cpu")
    pos = np.tile(np.arange(5 - t, 5, dtype=np.int32), (b, 1))
    tables = np.array([[1, 2], [3, 4]], np.int32)
    slots = (tables[np.arange(b)[:, None], pos // ps] * ps + pos % ps).astype(np.int32)
    tokens = np.ones((b, t), np.int32)
    tllama.forward(params, cfg, _t(tokens), _t(pos), kc, vc, _t(tables), _t(slots), _t(np.full(b, t - 1, np.int32)))
    assert len(walks) == cfg.num_layers
    if t == 1:
        assert reductions == [] and all(w is None for w in walks)
    else:
        assert len(reductions) == 1 and all(w is reductions[0] for w in walks)
        np.testing.assert_array_equal(reductions[0][0].numpy(), pos.max(axis=1))


@pytest.mark.parametrize("kind", sorted(CASES))
def test_plain_version_matches_pallas_interpret_bf16(kind):
    """The same cases on bf16 caches and queries, one split on both sides:
    the plain version rounds q and p where the Pallas kernel (interpret mode)
    does, so only f32 summation order differs (well under 1e-5 on O(1)
    outputs)."""
    t, positions = CASES[kind]
    arrays = _mla_case(7, t=t, positions=positions)
    q_lat, q_rope, c, r = (jnp.asarray(x).astype(jnp.bfloat16) for x in arrays[:4])
    tables, pos = arrays[4:]
    scale = (32 + DR) ** -0.5
    q_rope_padded = jnp.pad(q_rope, ((0, 0), (0, 0), (0, 0), (0, R_WIDTH - DR)))
    want = np.asarray(j_mla_kernel(q_lat, q_rope_padded, c, r, jnp.asarray(tables), jnp.asarray(pos), scale=scale,
                                   interpret=True, num_splits=1))
    args = [torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16) for x in (q_lat, q_rope, c, r)]
    got = paged_mla.paged_mla(*args, _t(tables), _t(pos), scale=scale, num_splits=1)
    assert got.dtype == torch.float32 and got.shape == (len(positions), t, HEADS, R_KV)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("fault", ["int64 positions", "strided q_rope", "latent width", "rope dtype", "misaligned"])
def test_kernel_argument_check_refuses(fault):
    args = [_t(a) for a in _mla_case(3, t=2, positions=[[5, 6], [40, 41]])]
    paged_mla.check_mla_args(*args)  # the well-formed case passes
    if fault == "int64 positions":
        args[5] = args[5].long()
    elif fault == "strided q_rope":
        args[1] = args[1].transpose(1, 2).contiguous().transpose(1, 2)
    elif fault == "latent width":
        args[2] = args[2][..., :64].contiguous()
    elif fault == "rope dtype":
        args[1] = args[1].double()
    else:  # a contiguous view 4 bytes into its storage
        args[0] = torch.zeros(args[0].numel() + 1)[1:].view(args[0].shape)
    with pytest.raises(ValueError):
        paged_mla.check_mla_args(*args)


def _layer(name, seed=0):
    """One layer of the JAX build's MLA params, and the same in the port."""
    jcfg = JPRESETS[name]
    stacked = jmla.init_mla_params(jcfg, jax.random.PRNGKey(seed), jnp.float32, 1)
    jlp = jax.tree.map(lambda x: x[0], stacked)
    return jlp, {k: v[0] for k, v in params_from_jax(_numpy_tree(stacked), device="cpu").items()}


def test_absorbed_matches_naive():
    """Whole sequences: the port's absorbed mla_attention, through paged_mla
    and through the gather formulation, against its own mla_attention_naive
    and the JAX one."""
    name = "test-tiny-mla"
    cfg = PRESETS[name]
    jlp, lp = _layer(name)
    rng = np.random.default_rng(0)
    b, t, ps, pages = 2, 12, 4, 8
    h = (rng.standard_normal((b, t, cfg.hidden_size)) * 0.3).astype(np.float32)
    pos = np.tile(np.arange(t, dtype=np.int32), (b, 1))
    inv = j_rope_frequencies(cfg.qk_rope_head_dim, theta=cfg.rope_theta)
    want = np.asarray(jmla.mla_attention_naive(jlp, JPRESETS[name], jnp.asarray(h), jnp.asarray(pos),
                                               jnp.asarray(inv)))
    inv_t = torch.from_numpy(rope_frequencies(cfg.qk_rope_head_dim, theta=cfg.rope_theta))
    naive = tmla.mla_attention_naive(lp, cfg, _t(h), _t(pos), inv_t)
    np.testing.assert_allclose(naive.numpy(), want, rtol=0, atol=ATOL)
    tables = np.array([[1, 2, 3], [4, 5, 6]], np.int32)  # page 0 is the null page
    slots = (tables[np.arange(b)[:, None], pos // ps] * ps + pos % ps).astype(np.int32)
    for impl in (None, "reference"):
        kc, vc = tllama.init_kv_cache(cfg, pages, ps, device="cpu")
        got, _, _ = tmla.mla_attention(lp, cfg, _t(h), _t(pos), kc[0], vc[0], _t(tables), _t(slots), inv_t,
                                       impl=impl)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
        # Written through in place, the rope stream's tail left at zero.
        assert bool((kc[0, 1:7] != 0).any(dim=-1).all()) and bool((vc[0, :, :, cfg.qk_rope_head_dim:] == 0).all())


def test_bridge_carries_the_mla_pytree():
    """MLA leaves are plain stacked arrays, 4-D w_uk / w_uv included: the
    bridge needs no code of its own for them."""
    jparams = _numpy_tree(jllama.init_params(JPRESETS["test-tiny-mla"], 0))
    params = params_from_jax(jparams, device="cpu")
    assert params["layers"]["w_uk"].dim() == 4 and params["layers"]["w_uv"].dim() == 4
    flat_j = jax.tree_util.tree_leaves_with_path(jparams)
    assert len(flat_j) == len(jax.tree_util.tree_leaves(params))
    for path, leaf in flat_j:
        node = params
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node.numpy(), leaf)


def test_card_refuses_an_mla_geometry_the_kernel_does_not_take(monkeypatch):
    """On a (faked) card, test-tiny-mla's latent width 24 is outside the
    kernel: refused before anything is allocated."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(NotImplementedError, match="kv_lora_rank=24"):
        TorchModelRunner(PRESETS["test-tiny-mla"], {}, num_pages=4, page_size=4, device="cuda")


def test_mla_with_experts_is_refused():
    """MLA + routed experts (DeepSeek-V2/V3) is served since MoE was ported,
    bf16 experts only: quantizing them is refused by name (ROADMAP B6)."""
    from dynamo_tpu_torch.models.quant import init_params_quantized, quantize_params

    cfg = dataclasses.replace(PRESETS["test-tiny-mla"], num_experts=4, num_experts_per_token=2,
                              moe_intermediate_size=32)
    params = tllama.init_params(cfg, 0, device="cpu")
    assert params["layers"]["w_gate"].shape == (2, 4, 64, 32)
    for mode in ("int8", "int4"):
        with pytest.raises(NotImplementedError, match="MoE.*B6"):
            init_params_quantized(cfg, 0, mode=mode, device="cpu")
        with pytest.raises(NotImplementedError, match="MoE.*B6"):
            quantize_params(params, mode=mode)


# -- engine ---------------------------------------------------------------------

NAME = "test-tiny-mla"
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


def test_engine_core_greedy_tokens_equal_jax():
    """EngineCore on test-tiny-mla, chunked prefill forced (8-token chunks) so
    that mixed steps occur, with a prefix-cache hit: greedy tokens bitwise
    equal to the JAX engine's (gather formulation)."""
    jparams = jllama.init_params(JPRESETS[NAME], 0)
    params = params_from_jax(_numpy_tree(jparams), device="cpu")
    runner_kw = dict(num_pages=ENGINE["num_pages"], page_size=PAGE, max_batch_size=ENGINE["max_batch_size"],
                     prefill_bucket=16)
    jcore = JEngineCore(ModelRunner(JPRESETS[NAME], jparams, attn_impl="reference", **runner_kw),
                        JEngineConfig(**ENGINE))
    tcore = EngineCore(TorchModelRunner(PRESETS[NAME], params, device="cpu", **runner_kw), EngineConfig(**ENGINE))
    arrivals = [(0, list(range(3, 23)), 7), (2, [9, 8, 7, 6, 5], 9), (3, list(range(3, 19)) + list(range(40, 55)), 5)]
    want = _drive(jcore, lambda p, n: JRequest(token_ids=p, sampling=JSampling(temperature=0.0),
                                                stop=JStop(max_tokens=n)), arrivals)
    got = _drive(tcore, lambda p, n: PreprocessedRequest(token_ids=p, sampling=SamplingOptions(temperature=0.0),
                                                         stop=StopConditions(max_tokens=n)), arrivals)
    assert got == want
    assert [len(got[i]) for i in range(3)] == [7, 9, 5]
    assert tcore.mixed_steps == jcore.mixed_steps > 0
    assert tcore.metrics().cache_hit_rate == jcore.metrics().cache_hit_rate > 0
