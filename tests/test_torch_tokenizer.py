"""The port's SentencePiece tokenizers, model cards from checkpoint
directories, and serving a checkpoint directory, on the CPU (the port's
counterparts of ``tests/test_sentencepiece.py`` and the checkpoint half of
``tests/test_launch.py``).

SentencePiece ids and text are held against the JAX build's
``sentencepiece.py`` on the unigram, BPE-with-merges and byte-fallback
models its tests write; ``ModelDeploymentCard.from_model_dir`` against the
JAX build's card bytes; a checkpoint directory served through the launcher
against the preset on the same weights.
"""

import asyncio
import dataclasses
import json

import pytest
import torch

from dynamo_tpu.model_card import ModelDeploymentCard as JCard
from dynamo_tpu.sentencepiece import SentencePieceModel as JSentencePieceModel
from dynamo_tpu.sentencepiece import load_sentencepiece as jax_load_sentencepiece
from dynamo_tpu_torch import launch
from dynamo_tpu_torch.model_card import ModelDeploymentCard
from dynamo_tpu_torch.models import llama, loader
from dynamo_tpu_torch.models.config import PRESETS
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.sentencepiece import (
    BYTE,
    CONTROL,
    NORMAL,
    UNKNOWN,
    ProtoError,
    SentencePieceModel,
    load_sentencepiece,
    write_model,
)
from dynamo_tpu_torch.tokenizer import HfTokenizer, load_tokenizer

UNI_PIECES = [
    ("<unk>", 0.0, UNKNOWN),
    ("<s>", 0.0, CONTROL),
    ("</s>", 0.0, CONTROL),
    ("▁hello", -1.0, NORMAL),
    ("▁world", -1.5, NORMAL),
    ("▁", -2.0, NORMAL),
    ("hell", -3.0, NORMAL),
    ("o", -3.5, NORMAL),
]
BPE_PIECES = [
    ("<unk>", 0.0, UNKNOWN),
    ("<s>", 0.0, CONTROL),
    ("</s>", 0.0, CONTROL),
    ("▁", -1.0, NORMAL),
    ("a", -1.1, NORMAL),
    ("b", -1.2, NORMAL),
    ("ab", -0.5, NORMAL),
    ("▁ab", -0.4, NORMAL),
]
MODELS = {
    "unigram": (UNI_PIECES, {}),
    "bpe-merges": (BPE_PIECES, {"model_type": "bpe"}),
    "byte-fallback": (UNI_PIECES + [(f"<0x{i:02X}>", -10.0, BYTE) for i in range(256)], {}),
    "no-dummy-prefix": (UNI_PIECES, {"add_dummy_prefix": False, "eos_id": 1, "bos_id": -1}),
}
TEXTS = ["hello world", "ab ab", "hello", "héllo wörld ✓", "", "  hello  world ", "ababab a b"]


@pytest.mark.parametrize("kind", list(MODELS))
def test_sentencepiece_ids_and_text_equal_jax(kind, tmp_path):
    pieces, kw = MODELS[kind]
    path = tmp_path / "tokenizer.model"
    path.write_bytes(write_model(pieces, **kw))
    ours, ref = load_sentencepiece(path), jax_load_sentencepiece(path)
    assert isinstance(ours, HfTokenizer)
    for text in TEXTS:
        ids = ours.encode(text)
        assert ids == ref.encode(text), text
        assert ours.encode(text, add_bos=True) == ref.encode(text, add_bos=True), text
        assert ours.decode(ids) == ref.decode(ids), text
    assert ours.eos_token_ids == ref.eos_token_ids and ours.bos_token_id == ref.bos_token_id
    parsed, jparsed = SentencePieceModel(path.read_bytes()), JSentencePieceModel(path.read_bytes())
    assert (parsed.pieces, parsed.model_type, parsed.unk_id, parsed.bos_id, parsed.eos_id,
            parsed.add_dummy_prefix) == (jparsed.pieces, jparsed.model_type, jparsed.unk_id, jparsed.bos_id,
                                         jparsed.eos_id, jparsed.add_dummy_prefix)


def test_sentencepiece_writer_is_the_jax_writer_and_refuses_garbage():
    from dynamo_tpu.sentencepiece import write_model as jax_write_model

    for pieces, kw in MODELS.values():
        assert write_model(pieces, **kw) == jax_write_model(pieces, **kw)
    with pytest.raises(ProtoError):
        SentencePieceModel(b"\x0a\xff")  # a length past the end
    with pytest.raises(ProtoError):
        SentencePieceModel(b"")  # no pieces


def test_load_tokenizer_resolves_model_files_and_refuses_gguf(tmp_path):
    (tmp_path / "tokenizer.model").write_bytes(write_model(UNI_PIECES))
    assert load_tokenizer(tmp_path).encode("hello world") == [3, 4]  # the directory -> tokenizer.model
    assert load_tokenizer(tmp_path / "tokenizer.model").decode([1, 3, 4, 2]) == "hello world"
    with pytest.raises(FileNotFoundError):  # a .gguf's embedded tokenizer is read from the file (test_torch_gguf.py)
        load_tokenizer(tmp_path / "model.gguf")


def test_model_card_from_model_dir_equals_jax(tmp_path):
    (tmp_path / "config.json").write_text(json.dumps(
        {"max_position_embeddings": 8192, "eos_token_id": [2, 9], "bos_token_id": 1}))
    (tmp_path / "tokenizer.model").write_bytes(write_model(UNI_PIECES))
    (tmp_path / "tokenizer_config.json").write_text(json.dumps({"chat_template": "{{ messages }}"}))
    for kw in ({}, {"kv_page_size": 32, "router_mode": "kv"}):
        ours = ModelDeploymentCard.from_model_dir("m", tmp_path, **kw)
        assert ours.to_bytes() == JCard.from_model_dir("m", tmp_path, **kw).to_bytes()
        assert ModelDeploymentCard.from_bytes(ours.to_bytes()) == ours
    (tmp_path / "tokenizer.json").write_text("{}")  # a fast tokenizer wins over the SentencePiece one
    assert ModelDeploymentCard.from_model_dir("m", tmp_path).tokenizer.endswith("tokenizer.json")
    (tmp_path / "config.json").write_text(json.dumps({"eos_token_id": 5}))
    assert ModelDeploymentCard.from_model_dir("m", tmp_path).to_bytes() == JCard.from_model_dir(
        "m", tmp_path).to_bytes()


# -- serving a checkpoint directory ---------------------------------------------------


def _checkpoint(tmp_path):
    """test-tiny's random-init parameters (seed 0, bf16: the dtype from_hf
    gives a config.json) saved as a checkpoint directory with an EOS id and
    a byte-fallback SentencePiece tokenizer."""
    cfg = dataclasses.replace(PRESETS["test-tiny"], dtype="bfloat16")
    params = llama.init_params(cfg, 0, device="cpu")
    ckpt = tmp_path / "tiny-ckpt"
    loader.save_params(ckpt, cfg, params, max_shard_bytes=40000)
    cfg_json = json.loads((ckpt / "config.json").read_text())
    (ckpt / "config.json").write_text(json.dumps({**cfg_json, "eos_token_id": 2}))
    (ckpt / "tokenizer.model").write_bytes(write_model(MODELS["byte-fallback"][0]))
    return ckpt, params


def test_engine_service_serves_a_checkpoint_directory(tmp_path):
    """build_engine_service(dir): its config from config.json, its EOS and
    context from the card, its weights loaded from the safetensors, bitwise
    the ones saved; greedy tokens equal those of the same directory served
    on the in-memory weights."""
    ckpt, params = _checkpoint(tmp_path)
    cfg, model_dir = launch.resolve_model(str(ckpt))
    assert model_dir == ckpt and cfg.name == "tiny-ckpt"
    with pytest.raises(ValueError, match="not a preset"):
        launch.resolve_model(str(tmp_path / "missing"))
    with pytest.raises(ValueError, match="gguf"):  # a .gguf model must be a file (test_torch_gguf.py serves one)
        launch.resolve_model(str(tmp_path / "model.gguf"))
    prompt = [5, 9, 11, 3, 7, 200, 14, 60]

    async def tokens(**kw):
        svc = await launch.build_engine_service(str(ckpt), device="cpu", num_pages=64, **kw)
        try:
            req = {"token_ids": prompt, "sampling": {"temperature": 0.0},
                   "stop": {"max_tokens": 12, "ignore_eos": True}}
            outs = [o async for o in svc.generate(req, Context())]
            return [t for o in outs for t in o["token_ids"]], svc.core.config, svc.core.runner.params
        finally:
            await svc.close()

    want, _, _ = asyncio.run(tokens(params=params))
    got, config, loaded = asyncio.run(tokens())
    assert got == want and len(got) == 12
    assert config.eos_token_ids == (2,) and config.max_seq_len == PRESETS["test-tiny"].max_position
    assert all(torch.equal(loaded["layers"][k].view(torch.int16), params["layers"][k].view(torch.int16))
               for k in params["layers"])


def test_run_local_serves_a_checkpoint_directory_over_http(tmp_path):
    """run_local(dir): the frontend lists the directory's model, builds its
    pipeline from the card (SentencePiece tokenizer), and a completion comes
    back whose text the card's tokenizer decodes."""
    import aiohttp

    ckpt, _ = _checkpoint(tmp_path)

    async def run():
        handles = await launch.run_local(str(ckpt), port=0, device="cpu", num_pages=64)
        base = f"http://127.0.0.1:{handles['port']}"
        try:
            async with aiohttp.ClientSession() as session:
                async with session.get(base + "/v1/models") as r:
                    models = [m["id"] for m in (await r.json())["data"]]
                body = {"model": "tiny-ckpt", "prompt": "hello world", "max_tokens": 6, "temperature": 0.0,
                        "nvext": {"ignore_eos": True}}
                async with session.post(base + "/v1/completions", json=body) as r:
                    doc = await r.json()
            return models, doc, handles["services"][0].core.config
        finally:
            await launch.shutdown(handles)

    models, doc, config = asyncio.run(run())
    assert models == ["tiny-ckpt"]
    assert doc["usage"]["completion_tokens"] == 6 and doc["choices"][0]["finish_reason"] == "length"
    tok = load_tokenizer(ckpt / "tokenizer.model")
    assert doc["usage"]["prompt_tokens"] == len(tok.encode("hello world", add_bos=True))
    assert config.eos_token_ids == (2,)
