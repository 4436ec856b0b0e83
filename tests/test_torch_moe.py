"""The port's routed MoE on the CPU (the port's counterpart of ``tests/test_moe.py``).

Every case feeds the same seeded numpy inputs to the JAX function and to its
counterpart in the port: the router's four semantics, the grouped product's
plain version against ``jax.lax.ragged_dot``, the dropless dispatch and the
layer MLP (shared experts, ``DYNAMO_MOE_DISPATCH=dense``) in f32 and bf16,
the tiny MoE models' forward through ``bridge.params_from_jax`` (with
DeepSeek's ``dense_layers``), and greedy EngineCore tokens against the JAX
engine's, the overlapped engine bitwise the synchronous one. The dispatch is
also run with every host read-back made to raise: a MoE step must capture
in a CUDA graph on the card.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.core import EngineConfig as JEngineConfig, EngineCore as JEngineCore
from dynamo_tpu.engine.runner import ModelRunner
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models.config import PRESETS as JPRESETS
from dynamo_tpu.parallel import moe as jmoe
from dynamo_tpu.protocols.common import PreprocessedRequest as JRequest
from dynamo_tpu.protocols.common import SamplingOptions as JSampling
from dynamo_tpu.protocols.common import StopConditions as JStop
from dynamo_tpu_torch.bridge import params_from_jax, tensor_from_numpy
from dynamo_tpu_torch.engine.core import EngineConfig, EngineCore
from dynamo_tpu_torch.engine.runner import TorchModelRunner
from dynamo_tpu_torch.models import llama as tllama
from dynamo_tpu_torch.models.config import PRESETS
from dynamo_tpu_torch.ops import grouped_matmul as gmm
from dynamo_tpu_torch.parallel import moe as tmoe
from dynamo_tpu_torch.protocols.common import PreprocessedRequest, SamplingOptions, StopConditions

D, E, F, K = 32, 8, 24, 2  # hidden, experts, expert width, top-k of the layer cases
# f32: both sides compute the same sums in f32 (in other orders): 1e-5 absolute
# on O(1) outputs. bf16: both round every product and activation to bf16, at
# other points (XLA fuses silu and the gate product, torch does not); 2**-6
# of the output's scale covers two bf16 ulps.
TOL = {"float32": 1e-5, "bfloat16": 2**-6}


def _numpy_tree(tree):
    return {k: _numpy_tree(v) if isinstance(v, dict) else np.asarray(v) for k, v in tree.items()}


def _layer(seed: int, dtype: str = "float32", *, bias: bool = False, shared: int = 0, gated: bool = False,
           e: int = E) -> dict:
    """One MoE layer's leaves as numpy, JAX's names and shapes."""
    rng = np.random.default_rng(seed)
    dt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32

    def w(*shape):
        return (rng.standard_normal(shape) * shape[-2] ** -0.5).astype(dt)

    lp = {"router": w(D, e), "w_gate": w(e, D, F), "w_up": w(e, D, F), "w_down": w(e, F, D)}
    if bias:
        lp["router_bias"] = rng.uniform(-0.2, 0.2, e).astype(np.float32)
    if shared:
        lp.update(w_shared_gate=w(D, shared), w_shared_up=w(D, shared), w_shared_down=w(shared, D))
        if gated:
            lp["shared_gate"] = w(D, 1)
    return lp


def _x(seed: int, n: int, dtype: str = "float32") -> np.ndarray:
    x = np.random.default_rng(seed).standard_normal((n, D))
    return x.astype(ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32)


def _port(tree: dict) -> dict:
    return {k: tensor_from_numpy(v) for k, v in tree.items()}


def _jax(tree: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _close(got: torch.Tensor, want, dtype: str) -> None:
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, atol=TOL[dtype] * max(1.0, float(np.abs(want).max())),
                               rtol=0)


# -- the router ------------------------------------------------------------------

ROUTERS = {
    "softmax-renorm": dict(scoring="softmax", norm_topk=True),  # Mixtral, OLMoE, Qwen3-MoE
    "softmax-raw": dict(scoring="softmax", norm_topk=False),  # Qwen2-MoE
    "sigmoid-bias-top2sum": dict(scoring="sigmoid", norm_topk=True, scaling=2.5, n_group=4, topk_group=2,
                                 group_score="top2sum"),  # DeepSeek-V3 noaux_tc
    "softmax-group-max": dict(scoring="softmax", norm_topk=False, n_group=4, topk_group=2,
                              group_score="max"),  # DeepSeek-V2 group_limited_greedy
}


@pytest.mark.parametrize("semantics", list(ROUTERS))
def test_route_tokens_equals_jax(semantics):
    """Expert ids equal JAX's (the seeded inputs hold no near-tie) and
    weights within 1e-6 in f32, for every router the presets use."""
    lp = _layer(1, bias=semantics.startswith("sigmoid"))
    x = _x(2, 64)
    kw = ROUTERS[semantics]
    jw, ji = jmoe.route_tokens(_jax(lp), jnp.asarray(x), k=3, **kw)
    tw, ti = tmoe.route_tokens(_port(lp), torch.from_numpy(x), k=3, **kw)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6, rtol=0)
    if kw.get("n_group"):  # every token's picks lie within its topk_group eligible groups
        groups = (ti // (E // kw["n_group"])).tolist()
        assert max(len(set(row)) for row in groups) <= kw["topk_group"]


# -- the grouped product ------------------------------------------------------------


@pytest.mark.parametrize("sizes", [[3, 0, 5, 0, 0, 1, 7, 0], [0, 0, 16, 0, 0, 0, 0, 0], [2, 2, 2, 2, 2, 2, 2, 2],
                                   [1, 0, 2, 0, 0, 0, 0, 0]])
def test_grouped_matmul_plain_equals_ragged_dot(sizes):
    """The plain grouped product against ``jax.lax.ragged_dot`` (f32, 1e-5):
    empty groups, one group holding every row, and a group sum short of the
    rows (the rows past it are zeros in both)."""
    rng = np.random.default_rng(sum(sizes))
    m = 16
    x = rng.standard_normal((m, D)).astype(np.float32)
    w = rng.standard_normal((E, D, F)).astype(np.float32)
    want = jax.lax.ragged_dot(jnp.asarray(x), jnp.asarray(w), jnp.asarray(sizes, jnp.int32))
    offsets = torch.tensor(np.concatenate([[0], np.cumsum(sizes)]), dtype=torch.int32)
    got = gmm.grouped_matmul(torch.from_numpy(x), torch.from_numpy(w), offsets)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    assert not got[sum(sizes):].any()


def test_grouped_matmul_refuses_what_the_kernel_does_not_take():
    """Off the CPU the wrapper launches the kernel or raises, naming the
    shape (meta tensors stand in for the card's: the checks run before any
    launch)."""
    offs = torch.zeros(E + 1, dtype=torch.int32, device="meta")
    bf = dict(dtype=torch.bfloat16, device="meta")
    for x, w, what in ((torch.empty(4, 48, **bf), torch.empty(E, 48, 64, **bf), "K=48"),
                       (torch.empty(4, 64, **bf), torch.empty(E, 64, 60, **bf), "N=60"),
                       (torch.empty(4, 64, device="meta"), torch.empty(E, 64, 64, device="meta"), "float32")):
        with pytest.raises(NotImplementedError, match=what):
            gmm.grouped_matmul(x, w, offs)
    with pytest.raises(ValueError, match="int32"):
        gmm.grouped_matmul(torch.empty(4, 64, **bf), torch.empty(E, 64, 64, **bf), offs.long())
    assert gmm.grouped_matmul_supported(2048, 1408, 64) and not gmm.grouped_matmul_supported(2048, 1024, 2048)


# -- the dispatch and the layer MLP -------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_mlp_dropless_equals_jax(dtype):
    lp, x = _layer(3, dtype), _x(4, 40, dtype)
    want = jmoe.moe_mlp_dropless(_jax(lp), jnp.asarray(x), num_experts_per_token=K)
    got = tmoe.moe_mlp_dropless(_port(lp), tensor_from_numpy(x), num_experts_per_token=K)
    assert got.dtype == tensor_from_numpy(x).dtype
    _close(got, want, dtype)


MLP_CASES = {
    "gated-shared": dict(shared=16, gated=True, cfg=dict(shared_expert_size=16, shared_expert_gated=True,
                                                         moe_norm_topk=False)),
    "ungated-shared-v3": dict(shared=16, bias=True, cfg=dict(shared_expert_size=16, moe_scoring="sigmoid",
                                                             moe_router_bias=True, moe_routed_scaling=2.5,
                                                             moe_n_group=4, moe_topk_group=2)),
    "dense-dispatch": dict(env="dense", cfg={}),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(MLP_CASES))
def test_mlp_moe_equals_jax(case, dtype, monkeypatch):
    """``_mlp_moe`` on one layer's leaves against JAX's, and against JAX's
    dense golden model ``_mlp_moe_dense``."""
    spec = MLP_CASES[case]
    if spec.get("env"):
        monkeypatch.setenv("DYNAMO_MOE_DISPATCH", spec["env"])
    base = dict(num_experts=E, num_experts_per_token=K, moe_intermediate_size=F, hidden_size=D, dtype=dtype)
    jcfg = dataclasses.replace(JPRESETS["test-tiny-moe"], **base, **spec["cfg"])
    cfg = dataclasses.replace(PRESETS["test-tiny-moe"], **base, **spec["cfg"])
    lp = _layer(5, dtype, bias=spec.get("bias", False), shared=spec.get("shared", 0), gated=spec.get("gated", False))
    x = _x(6, 2 * 12, dtype).reshape(2, 12, D)
    want = jllama._mlp_moe(_jax(lp), jnp.asarray(x), jcfg)
    got = tllama._mlp_moe(_port(lp), tensor_from_numpy(x), cfg)
    _close(got, want, dtype)
    _close(tllama._mlp_moe_dense(_port(lp), tensor_from_numpy(x), cfg),
           jllama._mlp_moe_dense(_jax(lp), jnp.asarray(x), jcfg), dtype)


@pytest.mark.parametrize("dispatch,tokens", [("capacity", 4), ("dense", 2048)])
def test_capacity_dispatch_is_refused_by_name(dispatch, tokens, monkeypatch):
    """Where the JAX build takes its capacity dispatch (asked for, or the
    dense one past 2048 token-choices) the port raises, naming A8."""
    monkeypatch.setenv("DYNAMO_MOE_DISPATCH", dispatch)
    cfg = dataclasses.replace(PRESETS["test-tiny-moe"], hidden_size=D, num_experts=E, moe_intermediate_size=F)
    with pytest.raises(NotImplementedError, match="capacity dispatch.*A8"):
        tllama._mlp_moe(_port(_layer(7)), torch.zeros(1, tokens, D), cfg)


def test_dispatch_reads_nothing_back_to_the_host(monkeypatch):
    """The dropless dispatch with every device-to-host read made to raise
    (``item``, ``tolist``, ``cpu``, ``numpy``, ``bincount``, ``nonzero``,
    a tensor's truth value): on the card such a read inside ``_mlp_moe``
    would break every MoE graph key. The grouped product is swapped for a
    gather form that needs no host offsets (its plain version reads them)."""
    lp, x = _port(_layer(8)), torch.from_numpy(_x(9, 10))
    want = tmoe.moe_mlp_dropless(lp, x, num_experts_per_token=K)

    def no_host_grouped(xs, w, offsets):
        rows = torch.arange(xs.shape[0], dtype=torch.int32)
        expert = torch.searchsorted(offsets[1:], rows, right=True).clamp(max=w.shape[0] - 1)
        return torch.einsum("mk,mkn->mn", xs, w[expert])

    monkeypatch.setattr(tmoe, "grouped_matmul", no_host_grouped)

    def refuse(*a, **k):
        raise AssertionError("host read-back inside the MoE dispatch")

    for name in ("item", "tolist", "cpu", "numpy", "__bool__", "nonzero"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    monkeypatch.setattr(torch, "bincount", refuse)
    monkeypatch.setattr(torch, "nonzero", refuse)
    got = tmoe.moe_mlp_dropless(lp, x, num_experts_per_token=K)
    monkeypatch.undo()
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


# -- the models ------------------------------------------------------------------------------


def _jparams(name: str) -> dict:
    """JAX init of ``name``; test-tiny-v3's correction bias redrawn so its
    noaux_tc selection is load-bearing."""
    p = jllama.init_params(JPRESETS[name], 0)
    if "router_bias" in p["layers"]:
        p["layers"]["router_bias"] = jnp.asarray(
            np.random.default_rng(1).uniform(-0.2, 0.2, p["layers"]["router_bias"].shape).astype(np.float32))
    return p


@pytest.mark.parametrize("name", ["test-tiny-moe", "test-tiny-v3"])
def test_forward_equals_jax(name):
    """A prefill of two rows and a decode step through ``bridge.params_from_jax``
    (test-tiny-v3 with its ``dense_layers``), f32 logits within 1e-4."""
    jcfg, cfg = JPRESETS[name], PRESETS[name]
    jp = _jparams(name)
    tp = params_from_jax(_numpy_tree(jp), device="cpu")
    assert ("dense_layers" in tp) == (cfg.first_k_dense > 0)
    b, t, ps, npg = 2, 8, 4, 16
    tok = np.random.default_rng(0).integers(0, 256, (b, t)).astype(np.int32)
    tables = np.array([[1, 2, 3], [4, 5, 6]], np.int32)
    jk, jv = jllama.init_kv_cache(jcfg, npg, ps)
    k, v = tllama.init_kv_cache(cfg, npg, ps, device="cpu")

    def step(tokens, pos):
        slots = np.take_along_axis(tables, pos // ps, 1) * ps + pos % ps
        last = np.full(b, tokens.shape[1] - 1, np.int32)
        args = (tokens, pos, tables, slots.astype(np.int32), last)
        nonlocal jk, jv
        jl, jk, jv = jllama.forward(jp, jcfg, *map(jnp.asarray, args[:2]), jk, jv, *map(jnp.asarray, args[2:]),
                                    attn_impl="reference")
        tl, _, _ = tllama.forward(tp, cfg, *map(torch.from_numpy, args[:2]), k, v, *map(torch.from_numpy, args[2:]))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)

    step(tok, np.tile(np.arange(t, dtype=np.int32), (b, 1)))
    step(tok[:, :1], np.full((b, 1), t, np.int32))


PAGE = 4
ENGINE = dict(num_pages=48, page_size=PAGE, max_batch_size=4, max_prefill_tokens=64, max_seq_len=128,
              chunk_prefill_tokens=8, eos_token_ids=(257,))


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


@pytest.mark.parametrize("name", ["test-tiny-moe", "test-tiny-v3"])
def test_engine_core_greedy_tokens_equal_jax(name):
    """EngineCore on a tiny MoE model, 8-token chunks so that mixed steps
    occur, with a prefix-cache hit: greedy tokens bitwise the JAX engine's
    (dropless dispatch, reference attention); the overlapped engine's bitwise
    the synchronous one's."""
    jp = _jparams(name)
    runner_kw = dict(num_pages=ENGINE["num_pages"], page_size=PAGE, max_batch_size=ENGINE["max_batch_size"],
                     prefill_bucket=16)
    jcore = JEngineCore(ModelRunner(JPRESETS[name], jp, attn_impl="reference", **runner_kw), JEngineConfig(**ENGINE))
    runner = TorchModelRunner(PRESETS[name], params_from_jax(_numpy_tree(jp), device="cpu"), device="cpu", **runner_kw)
    arrivals = [(0, list(range(3, 23)), 7), (2, [9, 8, 7, 6, 5], 9), (3, list(range(3, 19)) + list(range(40, 55)), 5)]
    want = _drive(jcore, lambda p, n: JRequest(token_ids=p, sampling=JSampling(temperature=0.0),
                                               stop=JStop(max_tokens=n)), arrivals)

    def port(overlap: bool):
        core = EngineCore(runner, EngineConfig(**ENGINE, overlap=overlap))
        got = _drive(core, lambda p, n: PreprocessedRequest(token_ids=p, sampling=SamplingOptions(temperature=0.0),
                                                            stop=StopConditions(max_tokens=n)), arrivals)
        return core, got

    tcore, got = port(False)
    assert got == want
    assert [len(got[i]) for i in range(3)] == [7, 9, 5]
    assert tcore.mixed_steps == jcore.mixed_steps > 0
    assert tcore.metrics().cache_hit_rate == jcore.metrics().cache_hit_rate > 0
    ocore, overlapped = port(True)
    assert overlapped == got and ocore.overlap_step_counts.get("overlapped", 0) > 0


# -- init and the card's checks ------------------------------------------------------------


def test_init_params_draws_large_leaves_a_slab_at_a_time(monkeypatch):
    """A leaf over DRAW_CHUNK elements is drawn in slabs straight into its
    storage (no f32 copy of a whole expert stack); a leaf under it keeps the
    one draw of before (the same values)."""
    cfg = PRESETS["test-tiny-moe"]
    whole = tllama.init_params(cfg, 3, device="cpu")
    sizes = []
    randn = torch.randn

    def recording(shape, *a, **k):
        sizes.append(int(np.prod(shape)))
        return randn(shape, *a, **k)

    monkeypatch.setattr(torch, "randn", recording)
    monkeypatch.setattr(tllama, "DRAW_CHUNK", 1000)
    sliced = tllama.init_params(cfg, 3, device="cpu")
    assert max(sizes) <= 1000 and len(sizes) > 10
    layers = sliced["layers"]
    assert layers["w_gate"].shape == (2, 4, 64, 64) and layers["router"].shape == (2, 64, 4)
    for leaf, fan_in in (("w_gate", 64), ("w_down", 64)):  # slabs at the fan-in scale
        assert abs(float(layers[leaf].std()) - fan_in**-0.5) < 0.1 * fan_in**-0.5
    monkeypatch.undo()
    again = tllama.init_params(cfg, 3, device="cpu")
    assert all(torch.equal(whole["layers"][k], again["layers"][k]) for k in whole["layers"])


def test_card_refuses_an_expert_geometry_the_kernel_does_not_take(monkeypatch):
    """On a (faked) card, an expert width the grouped kernel does not take is
    refused before anything is allocated."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    cfg = dataclasses.replace(PRESETS["olmoe-1b-7b"], moe_intermediate_size=1020)
    with pytest.raises(NotImplementedError, match="grouped_matmul kernel does not take 64 experts of 2048 x 1020"):
        TorchModelRunner(cfg, {}, num_pages=4, page_size=16, device="cuda")
