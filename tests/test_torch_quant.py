"""The port's weight-only quantization held against dynamo_tpu's (JAX) on the CPU.

Quantization itself (packing, int8 and int4 leaves, the choice of leaves,
the group width) must equal JAX's bit for bit on the same numpy inputs, and
so must the bridge's carrying of quantized trees. The plain ``quant_matmul``
(what a CPU tensor takes; the card runs ``csrc/quant_matmul.cu``) and
quantized forwards are held within stated tolerances, greedy engine tokens
bitwise.
"""

import asyncio
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
from dynamo_tpu.models import quant as jquant
from dynamo_tpu.models.config import PRESETS as JPRESETS
from dynamo_tpu.protocols.common import PreprocessedRequest as JRequest
from dynamo_tpu.protocols.common import SamplingOptions as JSampling
from dynamo_tpu.protocols.common import StopConditions as JStop
from dynamo_tpu_torch import launch
from dynamo_tpu_torch.bridge import params_from_jax, tensor_from_numpy
from dynamo_tpu_torch.engine.core import EngineConfig, EngineCore
from dynamo_tpu_torch.engine.runner import TorchModelRunner
from dynamo_tpu_torch.models import llama, quant
from dynamo_tpu_torch.models.config import PRESETS
from dynamo_tpu_torch.ops import quant_matmul as qmm
from dynamo_tpu_torch.protocols.common import PreprocessedRequest, SamplingOptions, StopConditions
from dynamo_tpu_torch.runtime.engine import Context


def _np(tree):
    return {k: _np(v) if isinstance(v, dict) else np.asarray(v) for k, v in tree.items()}


def _leaves(tree, path=""):
    for k, v in tree.items():
        yield from _leaves(v, f"{path}/{k}") if isinstance(v, dict) else [(f"{path}/{k}", v)]


def _bits(t: torch.Tensor) -> np.ndarray:
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def assert_tree_bitwise(got: dict, want: dict) -> None:
    """Port tensors against JAX (numpy) arrays: same paths, dtypes, shapes, bits."""
    got, want = dict(_leaves(got)), {k: np.asarray(v) for k, v in _leaves(want)}
    assert got.keys() == want.keys()
    for k, w in want.items():
        exp = tensor_from_numpy(w)
        assert got[k].dtype == exp.dtype and got[k].shape == exp.shape, (k, got[k].dtype, exp.dtype)
        np.testing.assert_array_equal(_bits(got[k]), _bits(exp), err_msg=k)


def _weights(shape, seed=0, dtype=np.float32):
    w = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * 0.05
    w.reshape(-1)[:: 97] = 0.0  # zero entries, and below a column of zeros: the scale-1 branch
    w[..., 3] = 0.0
    return w.astype(dtype)


# -- quantization, bit for bit -----------------------------------------------------


def test_pack_and_unpack_int4_equal_jax():
    rng = np.random.default_rng(0)
    q = rng.integers(-8, 8, (3, 10, 5)).astype(np.int8)
    np.testing.assert_array_equal(quant.pack_int4(torch.from_numpy(q)).numpy(),
                                  np.asarray(jquant.pack_int4(jnp.asarray(q))))
    packed = rng.integers(-128, 128, (2, 6, 7)).astype(np.int8)  # every nibble pattern
    np.testing.assert_array_equal(quant.unpack_int4(torch.from_numpy(packed)).numpy(),
                                  np.asarray(jquant.unpack_int4(jnp.asarray(packed))))
    np.testing.assert_array_equal(quant.unpack_int4(quant.pack_int4(torch.from_numpy(q))).numpy(), q)


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
def test_quantize_leaf_equals_jax(dtype):
    """int8 per channel, layer-stacked (the port quantizes one layer at a
    time): codes and bf16 scales bitwise JAX's."""
    w = _weights((2, 64, 48), dtype=dtype)
    got = quant.quantize_leaf(tensor_from_numpy(w))
    assert_tree_bitwise(got, jquant.quantize_leaf(jnp.asarray(w)))


@pytest.mark.parametrize("d_in,group", [(256, 128), (256, 32), (20, 8), (64, None)])
def test_quantize_leaf_int4_equals_jax(d_in, group, monkeypatch):
    """Packed int4 at groups 128 and 32, a group width shrunk to divide d_in
    (20 at a requested 8 -> 4), and the DYN_QUANT_GROUP_SIZE default."""
    monkeypatch.setenv("DYN_QUANT_GROUP_SIZE", "16")
    w = _weights((2, d_in, 40), seed=1)
    got = quant.quantize_leaf_int4(torch.from_numpy(w), group_size=group)
    assert_tree_bitwise(got, jquant.quantize_leaf_int4(jnp.asarray(w), group_size=group))
    assert got["scale"].shape[-2] == d_in // jquant._pick_group_size(d_in, group or 16)


def test_pick_group_size_equals_jax():
    for d_in in range(2, 300):
        for gs in (2, 8, 32, 48, 128, 1000):
            assert quant._pick_group_size(d_in, gs) == jquant._pick_group_size(d_in, gs)


@pytest.mark.parametrize("mode", ["int8", "int4"])
@pytest.mark.parametrize("name", ["test-tiny", "test-tiny-mla"])
def test_quantize_params_equals_jax(name, mode):
    """The same leaves are chosen (an untied head too; embeddings, norms and
    MLA's w_uk/w_uv stay full width) and quantized to the same bits; a
    second pass changes nothing; in place, the input takes the leaves."""
    cfg = dataclasses.replace(JPRESETS[name], tie_embeddings=False)
    jparams = jllama.init_params(cfg, 1)
    want = _np(jquant.quantize_params(jparams, mode=mode))
    params = params_from_jax(_np(jparams), device="cpu")
    got = quant.quantize_params(params, mode=mode)
    assert_tree_bitwise(got, want)
    assert quant.quantize_params(got, mode=mode)["layers"]["w_up"] is got["layers"]["w_up"]
    assert not quant.is_quantized(got["embed"]) and not quant.is_quantized(got["layers"]["attn_norm"])
    assert quant.quantize_params(params, mode=mode, inplace=True) is params
    assert_tree_bitwise(params, want)
    with pytest.raises(ValueError, match="unknown quantization mode"):
        quant.quantize_params(params, mode="int3")


def _with_qbias(tree, seed=5):
    """Every int4 leaf with an f32 qbias (as a GGUF Q4_K import holds one),
    scales made f32 too."""
    rng = np.random.default_rng(seed)

    def walk(node):
        if isinstance(node, dict) and "qw4" in node:
            scale = np.asarray(node["scale"]).astype(np.float32)
            return {"qw4": np.asarray(node["qw4"]), "scale": scale,
                    "qbias": (rng.standard_normal(scale.shape) * 0.01).astype(np.float32)}
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return np.asarray(node)

    return walk(tree)


@pytest.mark.parametrize("fmt", ["int8", "int4", "int4+qbias"])
def test_bridge_carries_quantized_trees_bitwise(fmt):
    jparams = jllama.init_params(dataclasses.replace(JPRESETS["test-tiny"], tie_embeddings=False), 2)
    tree = _np(jquant.quantize_params(jparams, mode=fmt[:4]))
    if fmt == "int4+qbias":
        tree = _with_qbias(tree)
    assert_tree_bitwise(params_from_jax(tree, device="cpu"), tree)


# -- the plain quant_matmul and the dequantization ---------------------------------


def _leaf(fmt: str, k: int = 64, n: int = 48, stacked: bool = False) -> dict:
    w = _weights((2, k, n) if stacked else (k, n), seed=3)
    leaf = _np(jquant.quantize_leaf(w) if fmt == "int8" else jquant.quantize_leaf_int4(w, group_size=32))
    return _with_qbias(leaf) if fmt == "int4+qbias" else leaf


@pytest.mark.parametrize("fmt", ["int8", "int4", "int4+qbias"])
@pytest.mark.parametrize("x_dtype", [np.float32, ml_dtypes.bfloat16])
@pytest.mark.parametrize("out_f32", [False, True])
def test_plain_quant_matmul_matches_jax(fmt, x_dtype, out_f32):
    """``x [B, T, K] @ leaf`` against JAX's quant_matmul. The dequantized
    weights are bitwise equal (maybe_dequant); the products differ by
    summation order only: f32 to 1e-6 of the largest output, bf16 outputs
    within two bf16 ulps of it (2**-7 each; int8 rounds twice)."""
    jleaf = _leaf(fmt)
    leaf = params_from_jax({"w": jleaf}, device="cpu")["w"]
    x = (np.random.default_rng(4).standard_normal((2, 3, 64))).astype(x_dtype)
    pet = jnp.float32 if out_f32 else None
    want = np.asarray(jquant.quant_matmul(jnp.asarray(x), jleaf, preferred_element_type=pet)).astype(np.float32)
    got = quant.quant_matmul(tensor_from_numpy(x), leaf, out_dtype=torch.float32 if out_f32 else None)
    assert got.dtype == (torch.float32 if out_f32 or x_dtype == np.float32 else torch.bfloat16)
    assert got.shape == (2, 3, 48)
    tol = 1e-6 if got.dtype == torch.float32 else 2 * 2**-7
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol * np.abs(want).max())
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        np.testing.assert_array_equal(_bits(quant.maybe_dequant(leaf, dt)),
                                      _bits(tensor_from_numpy(np.asarray(jquant.maybe_dequant(jleaf, jdt)))))


def test_quant_matmul_on_the_cpu_takes_the_plain_version_and_kernel_shapes():
    """A CPU tensor takes the plain version; the kernel's predicate and its
    launch plan (shapes only, so replay and eager agree) as documented."""
    leaf = params_from_jax({"w": _leaf("int4")}, device="cpu")["w"]
    x = torch.randn(5, 64)
    before = qmm.launches_int4
    torch.testing.assert_close(qmm.quant_matmul(x, leaf), qmm.quant_matmul_plain(x, leaf), rtol=0, atol=0)
    assert qmm.launches_int4 == before and qmm.group_size(leaf) == 32
    ok = dict(x_dtype=torch.bfloat16, scale_dtype=torch.bfloat16, out_dtype=torch.bfloat16)
    assert qmm.quant_matmul_supported(4096, 576, mode="int8", **ok)
    assert qmm.quant_matmul_supported(8192, 2048, mode="int4", group=32, **{**ok, "scale_dtype": torch.float32})
    assert qmm.quant_matmul_supported(4096, 128256, mode="int4", group=128, **{**ok, "out_dtype": torch.float32})
    assert not qmm.quant_matmul_supported(4096, 100, mode="int8", **ok)  # N not a multiple of 16
    assert not qmm.quant_matmul_supported(96, 128, mode="int8", **ok)  # K not a multiple of 64
    assert not qmm.quant_matmul_supported(4096, 128, mode="int4", group=96, **ok)
    assert not qmm.quant_matmul_supported(4096, 128, mode="int8", **{**ok, "x_dtype": torch.float32})
    assert not qmm.quant_matmul_supported(4096, 128, mode="int8", **{**ok, "scale_dtype": torch.float32})
    d, p = qmm.FORM_DECODE, qmm.FORM_PREFILL
    assert qmm.plan(8, 14336, 4096) == (d, 1, 4) and qmm.plan(2048, 14336, 4096) == (p, 256, 1)
    assert qmm.plan(8, 14336, 4096, mode="int4") == (d, 1, 4)  # both formats take the same plan
    assert qmm.plan(16, 4096, 14336) == (d, 2, 8) and qmm.plan(17, 4096, 14336) == (p, 128, 4)
    assert qmm.plan(64, 4096, 4096) == (p, 128, 4) and qmm.plan(2048, 4096, 4096) == (p, 256, 1)
    assert qmm.plan(64, 14336, 4096) == (p, 128, 1) and qmm.plan(512, 14336, 4096) == (p, 256, 1)
    assert qmm.plan(8, 128256, 4096) == (d, 1, 2) and qmm.plan(1, 1024, 256) == (d, 1, 1)
    assert qmm.plan(8, 28672, 8192) == (d, 1, 4) and qmm.plan(8, 8192, 28672) == (d, 1, 8)
    assert qmm.plan(512, 4096, 14336) == (p, 128, 1) and qmm.plan(2048, 4096, 14336) == (p, 256, 1)


# -- the kernel's plan and tiling (mirrored from csrc/quant_matmul.cu) ---------------

SMEM_LIMIT = 227 * 1024  # dynamic shared memory a block can take on an H100


def _smem_bytes(form: int, param: int, splits: int, k: int, mode: str, scale_bytes: int) -> int:
    """A block's dynamic shared memory (csrc/quant_matmul.cu WStage,
    DecLayout::bytes with x_chunks, PreLayout::kBytes)."""
    bn = qmm.DECODE_BLOCK_N if form == qmm.FORM_DECODE else qmm.PREFILL_BLOCK_N
    rows = 32 if mode == "int4" else 64
    ks = 2 * bn * scale_bytes if mode == "int4" else 0
    stage = -(-(bn // 128 * rows * 128 + 2 * ks) // 1024) * 1024
    if form == qmm.FORM_PREFILL:
        ring = 5 if param == 256 else 8
        return 1024 + ring * (param * 128 + stage) + 2 * ring * 8
    ring = 6 if mode == "int4" else 4
    mp = 8 * param
    longest = -(-(k // qmm.BLOCK_K) // splits)
    slots = 1 if longest * mp * 128 <= 24 * 1024 else 2
    spc = longest if slots == 1 else 12 * 1024 // (mp * 128)
    return 1024 + ring * stage + slots * spc * mp * 128 + (mp * qmm.DECODE_BLOCK_N * 4 if splits > 1 else 0) + (
        2 * ring + 4) * 8


def _quantized_shapes() -> set[tuple[int, int]]:
    """(K, N) of every quantized leaf of every preset the kernel takes, and
    of chip_smoke.py's QUANT_SHAPES."""
    import importlib.util
    import pathlib

    spec = importlib.util.spec_from_file_location("chip_smoke", pathlib.Path(__file__).parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    shapes = {kn for kns in smoke.QUANT_SHAPES.values() for kn in kns}
    for cfg in PRESETS.values():
        seen = []
        llama.build_params(cfg, lambda name, shape, fan_in: seen.append((name, shape[-2:])), lambda shape, value: None)
        shapes |= {(k, n) for name, (k, n) in seen if name in quant._MATMUL_LEAVES
                   and qmm.quant_matmul_supported(k, n, mode="int8")}
    return shapes


def test_plan_is_a_pure_function_and_every_form_tiles_every_served_shape():
    """``plan`` depends on (M, N, K, format, SMs) alone: the same arguments
    give the same plan in any call order. For every quantized leaf the
    presets and the smoke serve and every M from decode to a mixed step, the
    chosen form's tiles cover M and N, its K splits partition the K stages
    (none empty, at most a cluster's 8, a power of two), the decode form's
    row tiles hold M, and every block fits the card's shared memory at
    either scale width."""
    shapes = sorted(_quantized_shapes())
    assert (4096, 14336) in shapes and (28672, 8192) in shapes and (4096, 576) in shapes
    ms = (1, 5, 8, 9, 16, 17, 40, 64, 65, 128, 256, 512, 2051)
    first = {(m, n, k, sms): qmm.plan(m, n, k, sms) for m in ms for k, n in shapes for sms in (132, 114)}
    for (m, n, k, sms), want in reversed(list(first.items())):
        assert qmm.plan(m, n, k, sms, "int4") == qmm.plan(m, n, k, sms, "int8") == want
    for (m, n, k, sms), (form, param, splits) in first.items():
        nk = k // qmm.BLOCK_K
        assert 1 <= splits <= min(qmm.MAX_SPLITS, nk) and splits & (splits - 1) == 0
        bounds = [s * nk // splits for s in range(splits + 1)]  # the kernel's split ranges
        assert bounds[0] == 0 and bounds[-1] == nk and all(b < e for b, e in zip(bounds, bounds[1:]))
        if form == qmm.FORM_DECODE:
            assert m <= qmm.DECODE_MAX_M and param in qmm.DECODE_TILES and m <= 8 * param
            assert -(-n // qmm.DECODE_BLOCK_N) * qmm.DECODE_BLOCK_N >= n
        else:
            assert m > qmm.DECODE_MAX_M and param in qmm.PREFILL_BLOCK_M
            assert -(-n // qmm.PREFILL_BLOCK_N) * qmm.PREFILL_BLOCK_N >= n and -(-m // param) * param >= m
        for mode in ("int8", "int4"):
            for scale_bytes in ((2,) if mode == "int8" else (2, 4)):
                assert _smem_bytes(form, param, splits, k, mode, scale_bytes) <= SMEM_LIMIT, (m, n, k, mode)


def _supported_before(k, n, *, mode, group=0, x_dtype=torch.bfloat16, scale_dtype=torch.bfloat16,
                      out_dtype=torch.bfloat16):
    """quant_matmul_supported as the first kernel (mma.sync) had it."""
    if x_dtype != torch.bfloat16 or out_dtype not in qmm.OUT_DTYPES or k % 64 or n % 16 or k <= 0 or n <= 0:
        return False
    if mode == "int8":
        return scale_dtype == torch.bfloat16
    if mode != "int4" or scale_dtype not in (torch.bfloat16, torch.float32):
        return False
    return group > 0 and group % 32 == 0 and (64 % group == 0 or group % 64 == 0) and k % group == 0


def test_quant_matmul_supported_takes_exactly_what_it_took_before():
    """The redesign keeps the contract: the same (K, N, format, group,
    dtypes) accepted and refused."""
    dts = (torch.bfloat16, torch.float32, torch.float16)
    for k in (0, 32, 64, 96, 128, 192, 256, 4096, 4160, 14336):
        for n in (0, 8, 16, 24, 48, 100, 128, 576, 4096):
            for mode in ("int8", "int4", "int2"):
                for group in (0, 16, 32, 48, 64, 96, 128, 256):
                    for x_dtype in dts[:2]:
                        for scale_dtype in dts:
                            for out_dtype in dts:
                                kw = dict(mode=mode, group=group, x_dtype=x_dtype, scale_dtype=scale_dtype,
                                          out_dtype=out_dtype)
                                assert qmm.quant_matmul_supported(k, n, **kw) == _supported_before(k, n, **kw), kw


# -- init_params_quantized ---------------------------------------------------------


@pytest.mark.parametrize("mode", ["int8", "int4"])
@pytest.mark.parametrize("name,untied", [("test-tiny", True), ("test-tiny-mla", False)])
def test_init_params_quantized_matches_jax_shapes_dtypes_and_scales(name, untied, mode):
    """The tree, shapes and dtypes of JAX's ``eval_shape``-driven init, and
    its constant fan-in scales bitwise; codes in range; full-width leaves
    (embedding, norms) as ``init_params`` makes them."""
    jcfg = dataclasses.replace(JPRESETS[name], tie_embeddings=not untied and JPRESETS[name].tie_embeddings)
    cfg = dataclasses.replace(PRESETS[name], tie_embeddings=jcfg.tie_embeddings)
    want = _np(jquant.init_params_quantized(jcfg, 0, mode=mode))
    shapes = jax.eval_shape(lambda: jquant.init_params_quantized(jcfg, 0, mode=mode))
    got = quant.init_params_quantized(cfg, 0, mode=mode, device="cpu")
    got_l, want_l, shape_l = dict(_leaves(got)), dict(_leaves(want)), dict(_leaves(shapes))
    assert got_l.keys() == want_l.keys() == shape_l.keys()
    for k, w in want_l.items():
        assert tuple(got_l[k].shape) == tuple(shape_l[k].shape) == w.shape, k
        assert got_l[k].dtype == tensor_from_numpy(w).dtype, k
        if k.endswith("/scale") or "norm" in k:
            np.testing.assert_array_equal(_bits(got_l[k]), _bits(tensor_from_numpy(w)), err_msg=k)
    codes = [v for k, v in got_l.items() if k.endswith(("/qw", "/qw4"))]
    assert codes and all(v.dtype == torch.int8 for v in codes)
    if mode == "int8":
        assert all(int(v.min()) >= -127 for v in codes)
    else:
        nibbles = torch.cat([quant.unpack_int4(v).reshape(-1) for v in codes])
        assert int(nibbles.min()) == -8 and int(nibbles.max()) == 7
    embed = got["embed"].float()
    assert abs(float(embed.std()) - cfg.hidden_size**-0.5) < 0.2 * cfg.hidden_size**-0.5


# -- quantized forwards and engines against JAX -----------------------------------


def _jax_quantized(name: str, fmt: str, monkeypatch) -> dict:
    """JAX's params of ``name`` quantized as ``fmt`` (int4+qbias: group 32
    with a qbias added) as numpy."""
    if fmt == "int4+qbias":
        monkeypatch.setenv("DYN_QUANT_GROUP_SIZE", "32")
    tree = _np(jquant.quantize_params(jllama.init_params(JPRESETS[name], 0), mode=fmt[:4]))
    return _with_qbias(tree) if fmt == "int4+qbias" else tree


@pytest.mark.parametrize("fmt", ["int8", "int4", "int4+qbias"])
@pytest.mark.parametrize("name", ["test-tiny", "test-tiny-mla"])
def test_quantized_forward_matches_jax(name, fmt, monkeypatch):
    """Logits of a prefill and a decode step on the same quantized weights:
    f32 models on both sides, the weights dequantized to the same bits, so
    1e-4 absolute on O(1) logits (summation order) holds, as for the
    unquantized forward (test_torch_model.py)."""
    from tests.test_torch_model import _step_inputs

    jtree = _jax_quantized(name, fmt, monkeypatch)
    jparams = jax.tree.map(jnp.asarray, jtree)
    params = params_from_jax(jtree, device="cpu")
    jcfg, cfg = JPRESETS[name], PRESETS[name]
    ps, npages = 4, 16
    jk, jv = jllama.init_kv_cache(jcfg, npages, ps)
    tk, tv = llama.init_kv_cache(cfg, npages, ps, device="cpu")
    for tokens, pos, tables, slots, last in _step_inputs(cfg, ps, npages):
        jlogits, jk, jv = jllama.forward(jparams, jcfg, jnp.asarray(tokens), jnp.asarray(pos), jk, jv,
                                         jnp.asarray(tables), jnp.asarray(slots), jnp.asarray(last),
                                         attn_impl="reference")
        tlogits, tk, tv = llama.forward(params, cfg, torch.from_numpy(tokens), torch.from_numpy(pos), tk, tv,
                                        torch.from_numpy(tables), torch.from_numpy(slots), torch.from_numpy(last))
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), rtol=0, atol=1e-4)


@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_quantized_engine_greedy_tokens_equal_jax(fmt, monkeypatch):
    """EngineCore on quantized test-tiny (mixed steps through a small chunk
    budget, a prefix-cache hit) against the JAX engine on the same leaves:
    greedy tokens bitwise equal."""
    from tests.test_torch_engine import ENGINE, PAGE, _drive

    jtree = _jax_quantized("test-tiny", fmt, monkeypatch)
    jrunner = ModelRunner(JPRESETS["test-tiny"], jax.tree.map(jnp.asarray, jtree), num_pages=ENGINE["num_pages"],
                          page_size=PAGE, max_batch_size=ENGINE["max_batch_size"], prefill_bucket=16,
                          attn_impl="reference")
    trunner = TorchModelRunner(PRESETS["test-tiny"], params_from_jax(jtree, device="cpu"),
                               num_pages=ENGINE["num_pages"], page_size=PAGE, max_batch_size=ENGINE["max_batch_size"],
                               prefill_bucket=16, device="cpu")
    arrivals = [(0, list(range(3, 23)), 7), (2, [9, 8, 7, 6, 5], 9), (3, list(range(3, 19)) + list(range(40, 55)), 5)]
    want = _drive(JEngineCore(jrunner, JEngineConfig(**ENGINE)),
                  lambda p, n: JRequest(token_ids=p, sampling=JSampling(temperature=0.0), stop=JStop(max_tokens=n)),
                  arrivals)
    got = _drive(EngineCore(trunner, EngineConfig(**ENGINE)),
                 lambda p, n: PreprocessedRequest(token_ids=p, sampling=SamplingOptions(temperature=0.0),
                                                  stop=StopConditions(max_tokens=n)), arrivals)
    assert got == want and all(len(v) for v in got.values())


# -- the launcher -----------------------------------------------------------------


def test_quantize_option_parsing_and_plumbing(monkeypatch):
    """``--quantize`` has the JAX launcher's choices and reaches run_local;
    build_engine_service(quantize=) serves quantized leaves: a preset
    random-inits them directly, given params are quantized where they are
    not already."""
    parser = launch.build_parser()
    assert parser.parse_args(["--quantize", "int4"]).quantize == "int4"
    assert parser.parse_args([]).quantize == ""
    with pytest.raises(SystemExit):
        parser.parse_args(["--quantize", "int3"])
    seen = {}

    async def fake_run_local(model, **kw):
        seen.update(kw, model=model)
        raise KeyboardInterrupt

    monkeypatch.setattr(launch, "run_local", fake_run_local)
    with pytest.raises(KeyboardInterrupt):
        launch.main(["--model", "test-tiny", "--quantize", "int8", "--platform", "cpu"])
    assert seen["quantize"] == "int8" and seen["model"] == "test-tiny"

    async def runner_params(**kw):
        svc = await launch.build_engine_service("test-tiny", device="cpu", num_pages=16, **kw)
        try:
            req = {"token_ids": [5, 9, 11], "sampling": {"temperature": 0.0},
                   "stop": {"max_tokens": 3, "ignore_eos": True}}
            outs = [o async for o in svc.generate(req, Context())]
            assert sum(len(o["token_ids"]) for o in outs) == 3
            return svc.core.runner.params
        finally:
            await svc.close()

    p = asyncio.run(runner_params(quantize="int4"))
    assert set(p["layers"]["wq"]) == {"qw4", "scale"} and p["embed"].dtype == torch.float32
    given = llama.init_params(PRESETS["test-tiny"], 0, device="cpu")
    p = asyncio.run(runner_params(params=given, quantize="int8"))
    assert_tree_bitwise(p["layers"]["w_down"], _np(jquant.quantize_leaf(
        np.asarray(given["layers"]["w_down"].numpy()))))


def test_runner_on_the_card_refuses_a_quantized_geometry_the_kernel_does_not_take(monkeypatch):
    """On a (faked) card, a quantized leaf outside the kernel (here f32
    activations, and K = 96) is refused before anything is allocated."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    cfg = PRESETS["test-kernel"]  # head_dim 64: the attention kernels take it
    params = quant.quantize_params(llama.init_params(cfg, 0, device="cpu"), mode="int8")
    with pytest.raises(NotImplementedError, match="quant_matmul kernel does not take wq"):
        TorchModelRunner(cfg, params, num_pages=4, page_size=16, device="cuda")
    bf16 = dataclasses.replace(cfg, dtype="bfloat16")
    bad = {"layers": {"w_up": {"qw": torch.zeros(2, 96, 128, dtype=torch.int8),
                               "scale": torch.ones(2, 128, dtype=torch.bfloat16)}}}
    with pytest.raises(NotImplementedError, match="w_up: K=96"):
        TorchModelRunner(bf16, bad, num_pages=4, page_size=16, device="cuda")
