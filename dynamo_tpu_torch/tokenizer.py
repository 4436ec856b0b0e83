"""Tokenizer abstraction: HF `tokenizers` backend + a hermetic byte tokenizer.

A copy of ``dynamo_tpu/tokenizer.py``. ``ByteTokenizer`` serves the presets;
``HfTokenizer`` imports ``tokenizers`` only when a tokenizer file is loaded
(``tokenizer.json``, a SentencePiece ``.model`` through ``sentencepiece.py``,
or the vocabulary embedded in a ``.gguf`` file through ``models/gguf.py``).
"""

from __future__ import annotations

import abc
import pathlib


class BaseTokenizer(abc.ABC):
    eos_token_ids: frozenset[int] = frozenset()
    bos_token_id: int | None = None

    @abc.abstractmethod
    def encode(self, text: str, *, add_bos: bool = False) -> list[int]: ...

    @abc.abstractmethod
    def decode(self, ids: list[int], *, skip_special_tokens: bool = True) -> str: ...

    @property
    @abc.abstractmethod
    def vocab_size(self) -> int: ...


class ByteTokenizer(BaseTokenizer):
    """UTF-8 bytes as tokens 0..255; BOS=256, EOS=257, PAD=258.

    Hermetic: any text round-trips with no artifacts. Used by CI and the echo/
    debug engines.
    """

    BOS, EOS, PAD = 256, 257, 258

    def __init__(self) -> None:
        self.eos_token_ids = frozenset({self.EOS})
        self.bos_token_id = self.BOS

    def encode(self, text: str, *, add_bos: bool = False) -> list[int]:
        ids = list(text.encode("utf-8"))
        return [self.BOS] + ids if add_bos else ids

    def decode(self, ids: list[int], *, skip_special_tokens: bool = True) -> str:
        data = bytes(i for i in ids if i < 256)
        return data.decode("utf-8", errors="replace")

    @property
    def vocab_size(self) -> int:
        return 259


class HfTokenizer(BaseTokenizer):
    """Wrapper over a `tokenizers.Tokenizer` (tokenizer.json)."""

    def __init__(self, tokenizer, *, eos_token_ids: set[int] | None = None, bos_token_id: int | None = None) -> None:
        self._tok = tokenizer
        self.eos_token_ids = frozenset(eos_token_ids or self._infer_eos())
        self.bos_token_id = bos_token_id

    @classmethod
    def from_file(cls, path: str | pathlib.Path, **kw) -> "HfTokenizer":
        from tokenizers import Tokenizer

        return cls(Tokenizer.from_file(str(path)), **kw)

    def _infer_eos(self) -> set[int]:
        out = set()
        for name in ("</s>", "<|end_of_text|>", "<|eot_id|>", "<|endoftext|>", "<|im_end|>", "<eos>"):
            tid = self._tok.token_to_id(name)
            if tid is not None:
                out.add(tid)
        return out

    def encode(self, text: str, *, add_bos: bool = False) -> list[int]:
        ids = self._tok.encode(text, add_special_tokens=False).ids
        if add_bos and self.bos_token_id is not None:
            ids = [self.bos_token_id] + ids
        return ids

    def decode(self, ids: list[int], *, skip_special_tokens: bool = True) -> str:
        return self._tok.decode(list(ids), skip_special_tokens=skip_special_tokens)

    @property
    def vocab_size(self) -> int:
        return self._tok.get_vocab_size()


def load_tokenizer(spec: str | pathlib.Path) -> BaseTokenizer:
    """Load by spec: "byte" or a path to tokenizer.json / a model directory."""
    if str(spec) == "byte":
        return ByteTokenizer()
    p = pathlib.Path(spec)
    if p.is_dir():
        # Prefer the fast-tokenizer artifact; fall back to SentencePiece.
        if (p / "tokenizer.json").exists():
            p = p / "tokenizer.json"
        elif (p / "tokenizer.model").exists():
            p = p / "tokenizer.model"
        else:
            p = p / "tokenizer.json"
    if p.suffix == ".model" and p.exists():
        from dynamo_tpu_torch.sentencepiece import load_sentencepiece

        return load_sentencepiece(p)
    if p.suffix == ".gguf" and p.exists():
        from dynamo_tpu_torch.models.gguf import shared_reader, tokenizer_from_gguf

        return tokenizer_from_gguf(shared_reader(p))
    if p.exists():
        return HfTokenizer.from_file(p)
    raise FileNotFoundError(f"no tokenizer at {spec}")


class IncrementalDetokenizer:
    """Streams text deltas from a growing token sequence.

    Tokenizers are not prefix-stable (multi-byte codepoints, merge effects),
    so naive per-token decode corrupts output. Standard two-offset algorithm:
    keep a window [prefix_offset, read_offset) of already-emitted tokens and
    emit only the text that extends a re-decode of that window; hold back
    while the tail decodes to a dangling replacement character.
    """

    def __init__(self, tokenizer: BaseTokenizer, *, skip_special_tokens: bool = True) -> None:
        self._tok = tokenizer
        self._ids: list[int] = []
        self._prefix_offset = 0
        self._read_offset = 0
        self._skip_special = skip_special_tokens

    def push(self, token_ids: list[int]) -> str:
        """Add tokens; return newly-stable text (possibly empty)."""
        self._ids.extend(token_ids)
        prefix = self._tok.decode(self._ids[self._prefix_offset : self._read_offset],
                                  skip_special_tokens=self._skip_special)
        full = self._tok.decode(self._ids[self._prefix_offset :],
                                skip_special_tokens=self._skip_special)
        if len(full) <= len(prefix) or full.endswith("�"):
            return ""
        delta = full[len(prefix) :]
        self._prefix_offset = self._read_offset
        self._read_offset = len(self._ids)
        return delta

    @property
    def token_count(self) -> int:
        return len(self._ids)
