"""The port's GGUF support held against dynamo_tpu's (JAX) on the CPU.

Files are written by the JAX build's ``write_gguf``/``save_params_gguf``
into ``tmp_path`` and read by the port, and the reverse: metadata, every
ggml type's dequantization, ``read_q4`` and ``load_gguf_params`` (with and
without ``quantize="int4"``) bit for bit; the writer's encoders byte for
byte; ``config_from_gguf`` field by field; embedded tokenizers id for id;
and a ``.gguf`` served through ``build_engine_service`` with greedy tokens
equal to the JAX engine's on the same file.
"""

import asyncio
import dataclasses
import struct

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.core import EngineConfig as JEngineConfig, EngineCore as JEngineCore
from dynamo_tpu.engine.runner import ModelRunner
from dynamo_tpu.model_card import ModelDeploymentCard as JCard
from dynamo_tpu.models import gguf as jgguf
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models.config import PRESETS as JPRESETS
from dynamo_tpu.models.quant import quantize_params as jquantize_params
from dynamo_tpu.protocols.common import PreprocessedRequest as JRequest
from dynamo_tpu.protocols.common import SamplingOptions as JSampling
from dynamo_tpu.protocols.common import StopConditions as JStop
from dynamo_tpu_torch import launch
from dynamo_tpu_torch.bridge import params_from_jax, tensor_from_numpy
from dynamo_tpu_torch.model_card import ModelDeploymentCard
from dynamo_tpu_torch.models import gguf
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.tokenizer import load_tokenizer


def _np(tree):
    return {k: _np(v) if isinstance(v, dict) else np.asarray(v) for k, v in tree.items()}


def _leaves(tree, path=""):
    for k, v in tree.items():
        yield from _leaves(v, f"{path}/{k}") if isinstance(v, dict) else [(f"{path}/{k}", v)]


def _bits(t: torch.Tensor) -> np.ndarray:
    t = t.cpu()
    return (t.view(torch.int16) if t.dtype in (torch.bfloat16, torch.float16) else t).numpy()


def assert_bitwise(got: torch.Tensor, want, name: str = "") -> None:
    exp = tensor_from_numpy(np.asarray(want))
    assert got.dtype == exp.dtype and tuple(got.shape) == tuple(exp.shape), (name, got.dtype, exp.dtype)
    np.testing.assert_array_equal(_bits(got), _bits(exp), err_msg=name)


def assert_tree_bitwise(got: dict, want: dict) -> None:
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert_bitwise(got[k], w, k)


def _blocks(rng, type_, nb):
    """``nb`` random blocks of a ggml block type, their f16 scale fields
    patched to finite values."""
    bpb = gguf._TYPE_SIZES[type_][0]
    raw = bytearray(rng.integers(0, 256, nb * bpb, dtype=np.uint8).tobytes())
    for i in range(nb):
        vals = rng.uniform(-0.1, 0.1, 2)
        if type_ in (gguf.GGML_Q4_1, gguf.GGML_Q4_K, gguf.GGML_Q5_K):
            struct.pack_into("<ee", raw, i * bpb, *vals)
        elif type_ == gguf.GGML_Q6_K:
            struct.pack_into("<e", raw, i * bpb + 208, vals[0])
    return bytes(raw)


TYPES = {"F32": gguf.GGML_F32, "F16": gguf.GGML_F16, "BF16": gguf.GGML_BF16, "Q8_0": gguf.GGML_Q8_0,
         "Q4_0": gguf.GGML_Q4_0, "Q4_1": gguf.GGML_Q4_1, "Q4_K": gguf.GGML_Q4_K, "Q5_K": gguf.GGML_Q5_K,
         "Q6_K": gguf.GGML_Q6_K}
METADATA = {
    "general.architecture": "llama", "general.name": "mix", "llama.block_count": 3,
    "some.float": 0.25, "some.neg": -7, "some.big": 2**40, "some.flag": True,
    "some.strs": ["a", "bé", ""], "some.ints": [1, 2, 3], "some.floats": [0.5, 1, -2.0], "some.empty": [],
}


@pytest.fixture(scope="module")
def every_type_file(tmp_path_factory):
    """One JAX-written file holding a tensor of each of the nine ggml types
    (Q4_1/Q5_K/Q6_K as raw blocks: the writer encodes only Q8_0/Q4_0/Q4_K),
    with zeros, ties and an all-zero block among the encoded values."""
    rng = np.random.default_rng(0)
    path = tmp_path_factory.mktemp("gguf") / "every.gguf"
    base = rng.standard_normal((4, 512)).astype(np.float32)
    base[0, :256] = 0.0
    base[1, :32] = 0.5  # ties in a block
    tensors = {"F32": base, "F16": base.astype(np.float16), "BF16": base.astype(ml_dtypes.bfloat16),
               "Q8_0": base, "Q4_0": base, "Q4_K": base}
    quant = {"Q8_0": gguf.GGML_Q8_0, "Q4_0": gguf.GGML_Q4_0, "Q4_K": gguf.GGML_Q4_K}
    raw = {name: ((4, 512), TYPES[name], _blocks(rng, TYPES[name], 4 * 512 // gguf._TYPE_SIZES[TYPES[name]][1]))
           for name in ("Q4_1", "Q5_K", "Q6_K")}
    jgguf.write_gguf(path, METADATA, tensors, quant=quant, raw_tensors=raw)
    return path


def test_metadata_and_tensor_index_equal_jax(every_type_file):
    ours, theirs = gguf.GGUFReader(every_type_file), jgguf.GGUFReader(every_type_file)
    try:
        assert ours.metadata == theirs.metadata and ours.version == theirs.version == 3
        assert {n: (t.shape, t.ggml_type, t.offset, t.nbytes) for n, t in ours.tensors.items()} == \
            {n: (t.shape, t.ggml_type, t.offset, t.nbytes) for n, t in theirs.tensors.items()}
    finally:
        ours.close()
        theirs.close()


@pytest.mark.parametrize("name", list(TYPES))
def test_dequant_equals_jax_for_every_type(every_type_file, name):
    ours, theirs = gguf.GGUFReader(every_type_file), jgguf.GGUFReader(every_type_file)
    try:
        got = ours.read(name)
        want = theirs.read(name)
        ours.close()  # the read outlives the mapping
        assert_bitwise(got, want, name)
    finally:
        theirs.close()


@pytest.mark.parametrize("name", ["Q4_0", "Q4_K"])
def test_read_q4_equals_jax(every_type_file, name):
    ours, theirs = gguf.GGUFReader(every_type_file), jgguf.GGUFReader(every_type_file)
    try:
        for got, want in zip(ours.read_q4(name), theirs.read_q4(name)):
            assert (got is None) == (want is None)
            if want is not None:
                assert_bitwise(got, want, name)
        with pytest.raises(ValueError, match="Q4_0/Q4_K only"):
            ours.read_q4("Q8_0")
    finally:
        ours.close()
        theirs.close()


def test_writer_is_byte_for_byte_the_jax_writer(tmp_path):
    """The same metadata and tensors (numpy in, and torch tensors in) at
    every writable type give the same file, encoders included; a tensor the
    block types cannot hold falls back to F16, as in JAX."""
    rng = np.random.default_rng(1)
    t = rng.standard_normal((8, 512)).astype(np.float32) * 0.02
    t[0, :64] = 0.0
    t[1, :32] = -0.25
    tensors = {"a": t, "b": t * 3, "c": t[:, :256], "h": t.astype(np.float16), "g": t.astype(ml_dtypes.bfloat16),
               "odd": rng.standard_normal((3, 5)).astype(np.float32), "v": t[0]}
    quant = {"a": gguf.GGML_Q8_0, "b": gguf.GGML_Q4_0, "c": gguf.GGML_Q4_K, "odd": gguf.GGML_Q4_K}
    jgguf.write_gguf(tmp_path / "j.gguf", METADATA, tensors, quant=quant)
    gguf.write_gguf(tmp_path / "p.gguf", METADATA, tensors, quant=quant)
    gguf.write_gguf(tmp_path / "t.gguf", METADATA, {k: tensor_from_numpy(v) for k, v in tensors.items()}, quant=quant)
    want = (tmp_path / "j.gguf").read_bytes()
    assert (tmp_path / "p.gguf").read_bytes() == want
    assert (tmp_path / "t.gguf").read_bytes() == want
    with pytest.raises(ValueError, match="read-only"):
        gguf.write_gguf(tmp_path / "x.gguf", {}, {"a": t}, quant=gguf.GGML_Q6_K)


# -- parameters ---------------------------------------------------------------------


def _model_file(tmp_path, *, tied=False, quant=gguf.GGML_Q4_K, name="tiny", tok=None):
    """test-tiny (untied unless ``tied``) written by the JAX build's
    save_params_gguf; returns (path, JAX config, JAX params)."""
    cfg = dataclasses.replace(JPRESETS["test-tiny"], tie_embeddings=tied, name=name)
    params = jllama.init_params(cfg, 0)
    path = tmp_path / f"{name}.gguf"
    jgguf.save_params_gguf(path, cfg, params, quant=quant, tokenizer_metadata=tok)
    return path, cfg, params


@pytest.mark.parametrize("quantize", ["", "int4"])
@pytest.mark.parametrize("quant", ["Q4_K", "Q4_0", "mixed"])
def test_load_gguf_params_equals_jax(tmp_path, quant, quantize):
    """Leaf by leaf, bitwise: the dequant path (cast to the model dtype) and
    the packed int4 import (codes, f32 scales, Q4_K's qbias), including the
    rope permutation of Q/K and leaves that fall back (Q8_0 layers, or
    layers mixing Q4_0 with Q4_K)."""
    if quant == "mixed":
        tensors_q = {f"blk.{li}.{s}": t for li in range(2)
                     for s, t in (("attn_q.weight", gguf.GGML_Q4_0), ("attn_k.weight", gguf.GGML_Q8_0),
                                  ("ffn_up.weight", gguf.GGML_Q4_0 if li else gguf.GGML_Q4_K))}
        q = {**tensors_q, "output.weight": gguf.GGML_Q4_0}
    else:
        q = TYPES[quant]
    path, jcfg, _ = _model_file(tmp_path, quant=q)
    cfg = dataclasses.replace(launch.resolve_model(str(path))[0], name=jcfg.name)
    for dtype in ("float32", "bfloat16"):
        jc, c = dataclasses.replace(jcfg, dtype=dtype), dataclasses.replace(cfg, dtype=dtype)
        want = _np(jgguf.load_gguf_params(path, jc, quantize=quantize))
        got = gguf.load_gguf_params(path, c, quantize=quantize, device="cpu")
        assert_tree_bitwise(got, want)
    packed = [k for k, v in got["layers"].items() if isinstance(v, dict)]
    if quantize and quant != "mixed":
        assert sorted(packed) == sorted(["wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"])
        assert set(got["lm_head"]) == ({"qw4", "scale", "qbias"} if quant == "Q4_K" else {"qw4", "scale"})
    if quantize and quant == "mixed":
        assert "wk" not in packed and "w_up" not in packed and "wq" in packed


def test_config_from_gguf_equals_jax_field_by_field(tmp_path):
    """Files of several shapes: llama-3 rope scaling, YaRN, linear, none;
    attention biases; per-head and flat q/k norms; gemma's architecture."""
    from dynamo_tpu.models.config import ModelConfig as JModelConfig

    cases = [
        JPRESETS["llama-3.2-1b"],
        dataclasses.replace(JPRESETS["test-tiny"], rope_scaling={"rope_type": "yarn", "factor": 4.0,
                            "original_max_position_embeddings": 128, "attention_factor": 1.2, "beta_fast": 32.0,
                            "beta_slow": 1.0}),
        dataclasses.replace(JPRESETS["test-tiny"], rope_scaling={"rope_type": "linear", "factor": 2.0},
                            attention_bias=True, qk_norm="head"),
        dataclasses.replace(JPRESETS["test-tiny"], qk_norm="flat", tie_embeddings=False),
    ]
    for i, jcfg in enumerate(cases):
        small = dataclasses.replace(jcfg, vocab_size=64, hidden_size=64, num_layers=1, num_heads=4,
                                    num_kv_heads=2, head_dim=16, intermediate_size=128)
        path = tmp_path / f"c{i}.gguf"
        jgguf.save_params_gguf(path, small, jllama.init_params(small, 0))
        ours, theirs = gguf.GGUFReader(path), jgguf.GGUFReader(path)
        assert dataclasses.asdict(gguf.config_from_gguf(ours)) == dataclasses.asdict(jgguf.config_from_gguf(theirs))
        assert dataclasses.asdict(gguf.config_from_gguf(ours, name="x")) == dataclasses.asdict(
            jgguf.config_from_gguf(theirs, name="x"))
        ours.close()
        theirs.close()
    path = tmp_path / "gemma.gguf"
    jgguf.write_gguf(path, {"general.architecture": "gemma", "gemma.embedding_length": 64,
                            "gemma.attention.head_count": [4, 4], "gemma.block_count": 2}, {})
    assert dataclasses.asdict(gguf.config_from_gguf(gguf.GGUFReader(path))) == dataclasses.asdict(
        jgguf.config_from_gguf(jgguf.GGUFReader(path)))
    assert isinstance(jcfg, JModelConfig)


# -- tokenizers and cards --------------------------------------------------------------


def _tok_metadata(kind):
    """Embedded tokenizers of both kinds: byte-level BPE (gpt2) and a unigram
    (llama) vocabulary with byte fallback and control tokens."""
    if kind == "gpt2":
        vocab = ["h", "e", "l", "o", "Ġ", "he", "ll", "hell", "hello", "Ġhello", "w", "r", "d", "Ġw", "or"]
        merges = ["h e", "l l", "he ll", "hell o", "Ġ hello", "Ġ w", "o r"]
        return {"tokenizer.ggml.model": "gpt2", "tokenizer.ggml.tokens": vocab, "tokenizer.ggml.merges": merges,
                "tokenizer.ggml.bos_token_id": 8, "tokenizer.ggml.eos_token_id": 8}
    tokens = ["<unk>", "<s>", "</s>", "▁hello", "▁world", "▁", "h", "w", "o"] + [f"<0x{i:02X}>" for i in range(256)]
    return {"tokenizer.ggml.model": "llama", "tokenizer.ggml.tokens": tokens,
            "tokenizer.ggml.scores": [0.0, 0.0, 0.0, -1.0, -1.5, -2.0, -3.0, -3.0, -3.0] + [-10.0] * 256,
            "tokenizer.ggml.token_type": [2, 3, 3] + [1] * 6 + [6] * 256,
            "tokenizer.ggml.unknown_token_id": 0, "tokenizer.ggml.bos_token_id": 1,
            "tokenizer.ggml.eos_token_id": 2, "tokenizer.chat_template": "{{ messages }}",
            "llama.context_length": 256}


@pytest.mark.parametrize("kind", ["llama", "gpt2"])
def test_tokenizer_and_card_from_gguf_equal_jax(tmp_path, kind):
    from dynamo_tpu.tokenizer import load_tokenizer as jload_tokenizer

    path = tmp_path / f"tok-{kind}.gguf"
    jgguf.write_gguf(path, {"general.architecture": "llama", **_tok_metadata(kind)}, {})
    ours, theirs = load_tokenizer(path), jload_tokenizer(path)
    for text in ("hello world", "hello hello", "how low", "héllo wörld", "", "world"):
        ids = theirs.encode(text)
        assert ours.encode(text) == ids, text
        assert ours.decode(ids) == theirs.decode(ids)
        assert ours.decode(ids + [2, 1], skip_special_tokens=False) == theirs.decode(ids + [2, 1],
                                                                                   skip_special_tokens=False)
    assert ours.eos_token_ids == theirs.eos_token_ids and ours.bos_token_id == theirs.bos_token_id
    for kw in ({}, {"kv_page_size": 32}):
        card = ModelDeploymentCard.from_gguf("m", path, **kw)
        assert card.to_bytes() == JCard.from_gguf("m", path, **kw).to_bytes()


# -- serving a .gguf ---------------------------------------------------------------------

ENGINE = dict(num_pages=64, page_size=16, max_batch_size=4, max_prefill_tokens=64, max_seq_len=256,
              chunk_prefill_tokens=16, eos_token_ids=(2,))


def test_gguf_served_through_build_engine_service_equals_jax(tmp_path, monkeypatch):
    """A Q4_K test-tiny file with an embedded tokenizer, served by
    ``build_engine_service(path, quantize="int4", device="cpu")``: its
    config, card and packed int4 leaves from the file (bitwise JAX's
    import), and greedy tokens equal to the JAX engine's on the JAX
    launcher's parameters for the same file. Both sides serve the file's
    config in float32 (a GGUF file names no dtype; the launchers take
    bf16, whose products the two frameworks round differently on the CPU)."""
    path, _, _ = _model_file(tmp_path, tok=_tok_metadata("llama"))
    from_file = gguf.config_from_gguf
    monkeypatch.setattr(gguf, "config_from_gguf",
                        lambda reader, name=None: dataclasses.replace(from_file(reader, name=name), dtype="float32"))
    jcfg = dataclasses.replace(jgguf.config_from_gguf(jgguf.GGUFReader(path), name="tiny"), dtype="float32")
    jparams = jquantize_params(jgguf.load_gguf_params(path, jcfg, quantize="int4"), mode="int4")
    cfg, where = launch.resolve_model(str(path))
    assert where == path and cfg.name == "tiny" and not cfg.tie_embeddings
    prompts = [[1, 3, 4, 5, 6, 7, 8, 3, 4, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18], [1, 4, 4, 3], list(range(1, 40))]

    async def serve():
        svc = await launch.build_engine_service(str(path), device="cpu", quantize="int4", **ENGINE)
        try:
            outs = []
            for p in prompts:
                req = {"token_ids": p, "sampling": {"temperature": 0.0}, "stop": {"max_tokens": 8, "ignore_eos": True}}
                outs.append([t for o in [o async for o in svc.generate(req, Context())] for t in o["token_ids"]])
            return outs, svc.core.runner.params, launch.worker_card(str(path), svc.core.config)
        finally:
            await svc.close()

    got, params, card = asyncio.run(serve())
    assert_tree_bitwise(params, _np(jparams))
    assert card.tokenizer == str(path) and card.context_length == 256 and card.eos_token_ids == [2]
    jrunner = ModelRunner(jcfg, jax.tree.map(jnp.asarray, jparams), num_pages=ENGINE["num_pages"],
                          page_size=ENGINE["page_size"], max_batch_size=ENGINE["max_batch_size"],
                          prefill_bucket=16, attn_impl="reference")
    core = JEngineCore(jrunner, JEngineConfig(**ENGINE))
    want = []
    for p in prompts:
        seq = core.add_request(JRequest(token_ids=p, sampling=JSampling(temperature=0.0),
                                        stop=JStop(max_tokens=8, ignore_eos=True)))
        toks = []
        while core.has_work:
            for s, out in core.step():
                if s.seq_id == seq.seq_id:
                    toks += out.token_ids
        want.append(toks)
    assert got == want and all(len(t) == 8 for t in got)


def test_save_params_gguf_writes_the_jax_file(tmp_path):
    """The port's save_params_gguf on the bridged parameters writes the
    bytes JAX's writes (Q/K permuted back to GGML order, matrices encoded,
    norms f32), so JAX reads back what the port exports; quantized leaves
    are refused."""
    path, jcfg, jparams = _model_file(tmp_path, quant=gguf.GGML_Q4_K, tok=_tok_metadata("gpt2"))
    params = params_from_jax(_np(jparams), device="cpu")
    cfg = launch.resolve_model(str(path))[0]
    gguf.save_params_gguf(tmp_path / "p.gguf", dataclasses.replace(cfg, name=jcfg.name), params,
                          quant=gguf.GGML_Q4_K, tokenizer_metadata=_tok_metadata("gpt2"))
    assert (tmp_path / "p.gguf").read_bytes() == path.read_bytes()
    from dynamo_tpu_torch.models.quant import quantize_params

    with pytest.raises(ValueError, match="full-width"):
        gguf.save_params_gguf(tmp_path / "q.gguf", cfg, quantize_params(params, mode="int8"))
