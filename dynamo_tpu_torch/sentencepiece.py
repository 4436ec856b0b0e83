"""SentencePiece ``tokenizer.model`` support without the sentencepiece library.

A SentencePiece model file is a serialized ``ModelProto``. This module
implements just enough protobuf wire-format decoding to extract the pieces
(text, score, type), the trainer's model type (unigram vs BPE), and the
normalizer's dummy-prefix flag — then rebuilds an equivalent fast tokenizer
with the ``tokenizers`` library:

- unigram models -> ``tokenizers.models.Unigram`` (same Viterbi semantics)
- BPE models -> ``tokenizers.models.BPE`` with merges reconstructed from the
  vocab (a pair (l, r) is a merge iff l+r is a piece; priority = the merged
  piece's score, ties to shorter pieces), the standard slow->fast conversion.

A copy of ``dynamo_tpu/sentencepiece.py`` whose tokenizer is the port's
``tokenizer.HfTokenizer``; ``write_model`` serializes a model (tests and
artifact tooling).
"""

from __future__ import annotations

import pathlib
import struct
from typing import Any, Iterator

# piece types (sentencepiece_model.proto SentencePiece.Type)
NORMAL, UNKNOWN, CONTROL, USER_DEFINED, UNUSED, BYTE = 1, 2, 3, 4, 5, 6

_UNIGRAM, _BPE = 1, 2


class ProtoError(ValueError):
    pass


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(buf):
            raise ProtoError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise ProtoError("varint too long")


def _fields(buf: bytes) -> Iterator[tuple[int, int, Any]]:
    """Yield (field_number, wire_type, value) triples of one message."""
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 0x7
        if wire == 0:  # varint
            value, pos = _read_varint(buf, pos)
        elif wire == 1:  # 64-bit
            value = buf[pos : pos + 8]
            pos += 8
        elif wire == 2:  # length-delimited
            n, pos = _read_varint(buf, pos)
            value = buf[pos : pos + n]
            if len(value) != n:
                raise ProtoError("truncated length-delimited field")
            pos += n
        elif wire == 5:  # 32-bit
            value = buf[pos : pos + 4]
            pos += 4
        else:
            raise ProtoError(f"unsupported wire type {wire}")
        yield field, wire, value


class SentencePieceModel:
    """Parsed ModelProto: pieces + the handful of specs that matter."""

    def __init__(self, data: bytes) -> None:
        self.pieces: list[tuple[str, float, int]] = []  # (text, score, type)
        self.model_type = _UNIGRAM
        self.unk_id = 0
        self.bos_id = 1
        self.eos_id = 2
        self.add_dummy_prefix = True
        for field, _wire, value in _fields(data):
            if field == 1:  # repeated SentencePiece
                self.pieces.append(self._parse_piece(value))
            elif field == 2:  # TrainerSpec
                self._parse_trainer(value)
            elif field == 3:  # NormalizerSpec
                self._parse_normalizer(value)
        if not self.pieces:
            raise ProtoError("no pieces in SentencePiece model")
        # ids may also be derivable from piece types when TrainerSpec omits them
        for i, (_text, _score, ptype) in enumerate(self.pieces):
            if ptype == UNKNOWN:
                self.unk_id = i
                break

    @staticmethod
    def _parse_piece(buf: bytes) -> tuple[str, float, int]:
        text, score, ptype = "", 0.0, NORMAL
        for field, wire, value in _fields(buf):
            if field == 1 and wire == 2:
                text = value.decode("utf-8")
            elif field == 2 and wire == 5:
                (score,) = struct.unpack("<f", value)
            elif field == 3 and wire == 0:
                ptype = value
        return text, score, ptype

    def _parse_trainer(self, buf: bytes) -> None:
        def signed(v: int) -> int:  # ids are int32; -1 means "disabled"
            return v - (1 << 64) if v >= (1 << 63) else v

        for field, wire, value in _fields(buf):
            if field == 3 and wire == 0:  # model_type
                self.model_type = value
            elif field == 40 and wire == 0:  # unk_id
                self.unk_id = signed(value)
            elif field == 41 and wire == 0:  # bos_id
                self.bos_id = signed(value)
            elif field == 42 and wire == 0:  # eos_id
                self.eos_id = signed(value)

    def _parse_normalizer(self, buf: bytes) -> None:
        for field, wire, value in _fields(buf):
            if field == 3 and wire == 0:  # add_dummy_prefix
                self.add_dummy_prefix = bool(value)


def _bpe_merges(vocab: dict[str, int], scores: dict[str, float]) -> list[tuple[str, str]]:
    """Reconstruct merge order from a BPE-type piece list.

    Every piece that splits into two in-vocab halves was produced by a merge;
    the trainer assigned higher scores to earlier merges, so sorting by
    (-score, len) recovers a priority order equivalent to the original."""
    merges: list[tuple[float, int, str, str]] = []
    for piece in vocab:
        if len(piece) < 2:
            continue
        best = None
        for i in range(1, len(piece)):
            l, r = piece[:i], piece[i:]
            if l in vocab and r in vocab:
                cand = (scores[l] + scores[r], l, r)
                if best is None or cand[0] > best[0]:
                    best = cand
        if best is not None:
            merges.append((scores[piece], len(piece), best[1], best[2]))
    merges.sort(key=lambda m: (-m[0], m[1]))
    return [(l, r) for _s, _n, l, r in merges]


def build_tokenizer(model: SentencePieceModel):
    """SentencePieceModel -> BaseTokenizer (fast tokenizers backend)."""
    from tokenizers import AddedToken, Tokenizer, decoders, models, pre_tokenizers

    from dynamo_tpu_torch.tokenizer import HfTokenizer

    pieces = model.pieces
    prepend = "first" if model.add_dummy_prefix else "never"
    if model.model_type == _BPE:
        vocab = {text: i for i, (text, _s, _t) in enumerate(pieces)}
        scores = {text: s for text, s, _t in pieces}
        unk_text = pieces[model.unk_id][0] if 0 <= model.unk_id < len(pieces) else None
        tk = Tokenizer(
            models.BPE(
                vocab=vocab,
                merges=_bpe_merges(vocab, scores),
                unk_token=unk_text,
                fuse_unk=True,
                byte_fallback=any(t == BYTE for _p, _s, t in pieces),
            )
        )
    else:
        tk = Tokenizer(
            models.Unigram(
                [(text, score) for text, score, _t in pieces],
                unk_id=model.unk_id,
                byte_fallback=any(t == BYTE for _p, _s, t in pieces),
            )
        )
    tk.pre_tokenizer = pre_tokenizers.Metaspace(replacement="▁", prepend_scheme=prepend)
    tk.decoder = decoders.Sequence(
        [decoders.Replace("▁", " "), decoders.ByteFallback(), decoders.Fuse(), decoders.Strip(" ", 1, 0)]
    )
    specials = [
        AddedToken(text, special=True, normalized=False)
        for text, _s, t in pieces
        if t == CONTROL
    ]
    if specials:
        tk.add_special_tokens(specials)
    eos_ids = {model.eos_id} if 0 <= model.eos_id < len(pieces) else None
    bos = model.bos_id if 0 <= model.bos_id < len(pieces) else None
    return HfTokenizer(tk, eos_token_ids=eos_ids, bos_token_id=bos)


def load_sentencepiece(path: str | pathlib.Path):
    """tokenizer.model path -> BaseTokenizer."""
    return build_tokenizer(SentencePieceModel(pathlib.Path(path).read_bytes()))


# ---------------------------------------------------------------------------
# Writer (tests / artifact tooling): pieces -> serialized ModelProto
# ---------------------------------------------------------------------------


def _varint(v: int) -> bytes:
    v &= (1 << 64) - 1  # protobuf encodes negatives as 64-bit two's complement
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        out.append(b | (0x80 if v else 0))
        if not v:
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def write_model(
    pieces: list[tuple[str, float, int]],
    *,
    model_type: str = "unigram",
    unk_id: int = 0,
    bos_id: int = 1,
    eos_id: int = 2,
    add_dummy_prefix: bool = True,
) -> bytes:
    """Serialize a minimal, spec-conformant ModelProto."""
    out = bytearray()
    for text, score, ptype in pieces:
        body = bytearray()
        raw = text.encode("utf-8")
        body += _tag(1, 2) + _varint(len(raw)) + raw
        body += _tag(2, 5) + struct.pack("<f", score)
        body += _tag(3, 0) + _varint(ptype)
        out += _tag(1, 2) + _varint(len(body)) + bytes(body)
    trainer = bytearray()
    trainer += _tag(3, 0) + _varint(_BPE if model_type == "bpe" else _UNIGRAM)
    trainer += _tag(40, 0) + _varint(unk_id)
    trainer += _tag(41, 0) + _varint(bos_id)
    trainer += _tag(42, 0) + _varint(eos_id)
    out += _tag(2, 2) + _varint(len(trainer)) + bytes(trainer)
    normalizer = bytearray()
    normalizer += _tag(3, 0) + _varint(1 if add_dummy_prefix else 0)
    out += _tag(3, 2) + _varint(len(normalizer)) + bytes(normalizer)
    return bytes(out)
