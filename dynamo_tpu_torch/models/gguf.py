"""GGUF checkpoint support: parser, dequantization, writer, params loading
(counterpart of ``dynamo_tpu/models/gguf.py``).

Reads llama.cpp-style GGUF (v2/v3) files — header, typed metadata KV pairs,
tensor index — via mmap; dequantizes the common formats (F32/F16/BF16/Q8_0/
Q4_0/Q4_1/Q4_K/Q5_K/Q6_K); maps GGUF metadata onto :class:`ModelConfig`;
rebuilds the embedded tokenizer; and loads the tensor set into the port's
stacked-layer parameters (``models/llama.py``). With ``quantize="int4"`` the
Q4_0/Q4_K projections import straight into packed int4 leaves
(``models/quant.py``): the file's own 4-bit codes and group scales, repacked
losslessly, which the quant_matmul kernel serves at 0.5 byte a weight.

Where the JAX build decodes blocks with numpy on the host, the port decodes
them with PyTorch on the device it loads to: each tensor's raw bytes cross
once, and the card does the unpacking. Every decode and encode is integer
work or IEEE float32 arithmetic in numpy's order (``read``, ``read_q4`` and
the writer's encoders equal the JAX build's bit for bit, on the CPU and on
the card); divisions divide by tensors, never by Python scalars. bf16 crosses
numpy through a ``uint16`` view.

A writer (:func:`write_gguf`, :func:`save_params_gguf`) round-trips params
to GGUF with optional Q8_0/Q4_0/Q4_K quantization, encoded on the tensors'
device. MoE expert tensors are refused by name (ROADMAP B6).
"""

from __future__ import annotations

import mmap
import os
import pathlib
import struct
import warnings
from typing import Any, BinaryIO

import numpy as np
import torch

from dynamo_tpu_torch.device import resolve_device
from dynamo_tpu_torch.models.config import ModelConfig

MAGIC = b"GGUF"

# Metadata value types (GGUF spec).
T_U8, T_I8, T_U16, T_I16, T_U32, T_I32, T_F32, T_BOOL, T_STR, T_ARR, T_U64, T_I64, T_F64 = range(13)

_SCALAR_FMT = {
    T_U8: "<B", T_I8: "<b", T_U16: "<H", T_I16: "<h", T_U32: "<I", T_I32: "<i",
    T_F32: "<f", T_U64: "<Q", T_I64: "<q", T_F64: "<d",
}

# ggml tensor types (subset we can read/write).
GGML_F32, GGML_F16 = 0, 1
GGML_Q4_0, GGML_Q4_1 = 2, 3
GGML_Q8_0 = 8
GGML_Q4_K, GGML_Q5_K, GGML_Q6_K = 12, 13, 14
GGML_BF16 = 30

_TYPE_NAMES = {GGML_F32: "F32", GGML_F16: "F16", GGML_Q4_0: "Q4_0", GGML_Q4_1: "Q4_1",
               GGML_Q8_0: "Q8_0", GGML_BF16: "BF16",
               GGML_Q4_K: "Q4_K", GGML_Q5_K: "Q5_K", GGML_Q6_K: "Q6_K"}

_BLOCK = 32  # quant block size for Q4_0/Q4_1/Q8_0
_QK_K = 256  # K-quant super-block size

# bytes per block / elements per block
_TYPE_SIZES = {
    GGML_F32: (4, 1),
    GGML_F16: (2, 1),
    GGML_BF16: (2, 1),
    GGML_Q8_0: (2 + _BLOCK, _BLOCK),
    GGML_Q4_0: (2 + _BLOCK // 2, _BLOCK),
    GGML_Q4_1: (4 + _BLOCK // 2, _BLOCK),
    GGML_Q4_K: (2 + 2 + 12 + _QK_K // 2, _QK_K),       # 144
    GGML_Q5_K: (2 + 2 + 12 + _QK_K // 8 + _QK_K // 2, _QK_K),  # 176
    GGML_Q6_K: (_QK_K // 2 + _QK_K // 4 + _QK_K // 16 + 2, _QK_K),  # 210
}


class GGUFTensorInfo:
    __slots__ = ("name", "shape", "ggml_type", "offset", "nbytes")

    def __init__(self, name: str, shape: tuple[int, ...], ggml_type: int, offset: int) -> None:
        self.name = name
        self.shape = shape  # row-major orientation: ggml dims reversed
        self.ggml_type = ggml_type
        self.offset = offset  # relative to data section start
        n = int(np.prod(shape)) if shape else 1
        bpb, epb = _TYPE_SIZES[ggml_type]
        self.nbytes = (n // epb) * bpb


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------


class GGUFReader:
    """mmap-backed GGUF file: ``.metadata`` dict + tensor index + reads that
    decode on a device."""

    def __init__(self, path: str | pathlib.Path) -> None:
        self.path = pathlib.Path(path)
        self._file = open(self.path, "rb")
        try:
            self._mm = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        except Exception:
            self._file.close()
            raise
        try:
            self._parse_header()
        except Exception:
            self.close()
            raise

    def _parse_header(self) -> None:
        path = self.path
        self._pos = 0
        magic = self._take(4)
        if magic != MAGIC:
            raise ValueError(f"{path}: not a GGUF file (magic {magic!r})")
        self.version = self._scalar("<I")
        if self.version not in (2, 3):
            raise ValueError(f"{path}: unsupported GGUF version {self.version}")
        n_tensors = self._scalar("<Q")
        n_kv = self._scalar("<Q")
        self.metadata: dict[str, Any] = {}
        for _ in range(n_kv):
            key = self._string()
            self.metadata[key] = self._value(self._scalar("<I"))
        self.tensors: dict[str, GGUFTensorInfo] = {}
        for _ in range(n_tensors):
            name = self._string()
            n_dims = self._scalar("<I")
            dims = [self._scalar("<Q") for _ in range(n_dims)]
            ggml_type = self._scalar("<I")
            offset = self._scalar("<Q")
            if ggml_type not in _TYPE_SIZES:
                raise ValueError(f"{path}: tensor {name!r} has unsupported ggml type {ggml_type}")
            # ggml lists dims innermost-first; the row-major shape is the reverse.
            self.tensors[name] = GGUFTensorInfo(name, tuple(reversed(dims)), ggml_type, offset)
        align = int(self.metadata.get("general.alignment", 32))
        self._data_start = (self._pos + align - 1) // align * align

    # -- low-level cursor reads ------------------------------------------------

    def _take(self, n: int) -> bytes:
        b = self._mm[self._pos : self._pos + n]
        self._pos += n
        return b

    def _scalar(self, fmt: str) -> int:
        (v,) = struct.unpack(fmt, self._take(struct.calcsize(fmt)))
        return v

    def _string(self) -> str:
        n = self._scalar("<Q")
        return self._take(n).decode("utf-8")

    def _value(self, vtype: int) -> Any:
        if vtype == T_STR:
            return self._string()
        if vtype == T_BOOL:
            return bool(self._scalar("<B"))
        if vtype == T_ARR:
            etype = self._scalar("<I")
            n = self._scalar("<Q")
            if etype in _SCALAR_FMT:  # bulk-read numeric arrays
                fmt = _SCALAR_FMT[etype]
                size = struct.calcsize(fmt)
                arr = np.frombuffer(self._take(n * size), dtype=np.dtype(fmt[1:]).newbyteorder("<"))
                return arr.tolist()
            return [self._value(etype) for _ in range(n)]
        return self._scalar(_SCALAR_FMT[vtype])

    # -- tensor access ---------------------------------------------------------

    def __contains__(self, name: str) -> bool:
        return name in self.tensors

    def keys(self):
        return self.tensors.keys()

    def raw(self, name: str, device: str | torch.device = "cpu") -> torch.Tensor:
        """Tensor ``name``'s stored bytes as ``uint8`` on ``device`` (a copy:
        it outlives :meth:`close`)."""
        info = self.tensors[name]
        start = self._data_start + info.offset
        view = np.frombuffer(memoryview(self._mm)[start : start + info.nbytes], dtype=np.uint8)
        with warnings.catch_warnings():  # the mapping is read-only; the tensor is copied before any write
            warnings.simplefilter("ignore", UserWarning)
            t = torch.from_numpy(view)
        return t.to(device) if torch.device(device).type != "cpu" else t.clone()

    def read(self, name: str, device: str | torch.device = "cpu") -> torch.Tensor:
        """Tensor ``name`` dequantized to float32 (or in its native float
        dtype) on ``device``."""
        info = self.tensors[name]
        return _dequant(self.raw(name, device), info.ggml_type, info.shape)

    def read_q4(self, name: str, device: str | torch.device = "cpu"
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
        """Q4_0/Q4_K tensor ``name`` without dequantizing to full width:
        ``(q, scale, bias)`` with ``q`` int8 in [-8, 7] at the tensor's
        shape, and float32 ``scale``/``bias`` per 32-wide group along the
        innermost (contiguous) axis — ``shape[:-1] + (shape[-1]//32,)``.

        Exact against :meth:`read`'s dequant: Q4_0 is ``d*(q_raw-8)``;
        Q4_K's ``d*sc*q_raw - dmin*mn`` is ``(d*sc)*(q_raw-8) +
        (8*d*sc - dmin*mn)`` (q shifted to the symmetric code range, the
        shift folded into the bias)."""
        info = self.tensors[name]
        shape = info.shape
        gshape = shape[:-1] + (shape[-1] // _BLOCK,)
        if info.ggml_type == GGML_Q4_0:
            raw = self.raw(name, device).reshape(-1, 2 + _BLOCK // 2)
            d, qs = _f16(raw[:, :2]), raw[:, 2:]
            q = torch.cat([(qs & 0x0F).to(torch.int8) - 8, (qs >> 4).to(torch.int8) - 8], dim=1)
            return q.reshape(shape), d.reshape(gshape), None
        if info.ggml_type == GGML_Q4_K:
            raw = self.raw(name, device).reshape(-1, 16 + _QK_K // 2)
            nb = raw.shape[0]
            d, dmin = _f16(raw[:, 0:2])[:, None], _f16(raw[:, 2:4])[:, None]
            sc, mn = _k_scale_min(raw[:, 4:16])
            qs = raw[:, 16:].reshape(nb, 4, 32)
            q = torch.stack([qs & 0xF, qs >> 4], dim=2).reshape(nb, 8, 32).to(torch.int8) - 8
            scale = d * sc.to(torch.float32)  # [nb, 8]
            bias = 8.0 * scale - dmin * mn.to(torch.float32)
            return q.reshape(shape), scale.reshape(gshape), bias.reshape(gshape)
        raise ValueError(
            f"{name}: ggml type {_TYPE_NAMES.get(info.ggml_type, info.ggml_type)} "
            "has no packed int4 read path (Q4_0/Q4_K only)"
        )

    def close(self) -> None:
        self._mm.close()
        self._file.close()


_READER_CACHE: dict[str, tuple[float, GGUFReader]] = {}


def shared_reader(path: str | pathlib.Path) -> GGUFReader:
    """Process-wide cached reader, keyed by resolved path + mtime: config,
    card, tokenizer and weights of a served file come from one parse of its
    header (the embedded vocabulary is decoded eagerly). Borrowers must not
    close it; a stale entry is dropped, not closed, so a borrower in flight
    keeps its mapping."""
    key = str(pathlib.Path(path).resolve())
    mtime = os.path.getmtime(key)
    hit = _READER_CACHE.get(key)
    if hit is not None and hit[0] == mtime:
        return hit[1]
    reader = GGUFReader(key)
    _READER_CACHE[key] = (mtime, reader)
    return reader


def _f16(raw: torch.Tensor) -> torch.Tensor:
    """``[n, 2]`` little-endian bytes -> float32 ``[n]`` of their f16 values."""
    return raw.contiguous().view(torch.float16).reshape(-1).to(torch.float32)


def _dequant(raw: torch.Tensor, ggml_type: int, shape: tuple[int, ...]) -> torch.Tensor:
    """Stored bytes (``uint8`` on any device) -> the tensor: float32 for the
    block formats, the native dtype for F32/F16/BF16."""
    if ggml_type == GGML_F32:
        return raw.view(torch.float32).reshape(shape)
    if ggml_type == GGML_F16:
        return raw.view(torch.float16).reshape(shape)
    if ggml_type == GGML_BF16:
        return raw.view(torch.bfloat16).reshape(shape)
    f32 = torch.float32
    if ggml_type == GGML_Q8_0:
        rec = raw.reshape(-1, 2 + _BLOCK)
        out = rec[:, 2:].view(torch.int8).to(f32) * _f16(rec[:, :2])[:, None]
        return out.reshape(shape)
    if ggml_type == GGML_Q4_0:
        rec = raw.reshape(-1, 2 + _BLOCK // 2)
        qs = rec[:, 2:]
        q = torch.cat([(qs & 0x0F).to(torch.int8) - 8, (qs >> 4).to(torch.int8) - 8], dim=1).to(f32)
        return (q * _f16(rec[:, :2])[:, None]).reshape(shape)
    if ggml_type == GGML_Q4_1:
        rec = raw.reshape(-1, 4 + _BLOCK // 2)
        qs = rec[:, 4:]
        q = torch.cat([(qs & 0x0F), (qs >> 4)], dim=1).to(f32)
        return (q * _f16(rec[:, 0:2])[:, None] + _f16(rec[:, 2:4])[:, None]).reshape(shape)
    if ggml_type in (GGML_Q4_K, GGML_Q5_K):
        width = _TYPE_SIZES[ggml_type][0]
        rec = raw.reshape(-1, width)
        nb = rec.shape[0]
        sc, mn = _k_scale_min(rec[:, 4:16])
        qs = rec[:, width - _QK_K // 2:].reshape(nb, 4, 32)
        if ggml_type == GGML_Q4_K:
            # Sub-block order within each 64-elem chunk: low nibbles then high.
            q = torch.stack([qs & 0xF, qs >> 4], dim=2)
        else:
            qh = rec[:, 16:16 + _QK_K // 8][:, None, :]  # [nb, 1, 32]
            shift = 2 * torch.arange(4, dtype=torch.uint8, device=raw.device)[None, :, None]
            lo = (qs & 0xF) + (((qh >> shift) & 1) << 4)
            hi = (qs >> 4) + (((qh >> (shift + 1)) & 1) << 4)
            q = torch.stack([lo, hi], dim=2)
        q = q.reshape(nb, 8, 32).to(f32)
        d, dmin = _f16(rec[:, 0:2])[:, None, None], _f16(rec[:, 2:4])[:, None, None]
        return (d * sc.to(f32)[:, :, None] * q - dmin * mn.to(f32)[:, :, None]).reshape(shape)
    if ggml_type == GGML_Q6_K:
        rec = raw.reshape(-1, _TYPE_SIZES[GGML_Q6_K][0])
        nb = rec.shape[0]
        ql = rec[:, :128].reshape(nb, 2, 2, 32)  # [nb, half, {l, l+32}, 32]
        qh = rec[:, 128:192].reshape(nb, 2, 32)
        # Quarters within a 128-elem half: (ql[l]&F|h0), (ql[l+32]&F|h1),
        # (ql[l]>>4|h2), (ql[l+32]>>4|h3) with h = 2-bit fields of qh[l].
        q = torch.stack(
            [
                (ql[:, :, 0] & 0xF) | (((qh >> 0) & 3) << 4),
                (ql[:, :, 1] & 0xF) | (((qh >> 2) & 3) << 4),
                (ql[:, :, 0] >> 4) | (((qh >> 4) & 3) << 4),
                (ql[:, :, 1] >> 4) | (((qh >> 6) & 3) << 4),
            ],
            dim=2,
        ).to(torch.int16) - 32  # [nb, 2, 4, 32]
        sc = rec[:, 192:208].view(torch.int8).reshape(nb, 2, 4, 2).to(f32)
        scq = sc.repeat_interleave(16, dim=3)  # scale index l // 16 within a quarter
        d = _f16(rec[:, 208:210])[:, None, None, None]
        return (d * scq * q.to(f32)).reshape(shape)
    raise ValueError(f"unsupported ggml type {ggml_type}")


def _k_scale_min(scales: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Unpack Q4_K/Q5_K 6-bit packed (scale, min) pairs: [nb, 12] u8 ->
    ([nb, 8], [nb, 8]) u8 — ggml's get_scale_min_k4, vectorized."""
    s = scales
    sc = torch.cat([s[:, 0:4] & 63, (s[:, 8:12] & 0xF) | ((s[:, 0:4] >> 6) << 4)], dim=1)
    mn = torch.cat([s[:, 4:8] & 63, (s[:, 8:12] >> 4) | ((s[:, 4:8] >> 6) << 4)], dim=1)
    return sc, mn


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------


def _const(value: float, like: torch.Tensor) -> torch.Tensor:
    """A float32 scalar on ``like``'s device: a divisor PyTorch divides by
    exactly (a Python-scalar divisor may become a multiply by its
    reciprocal on the card)."""
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def _inv(d: torch.Tensor) -> torch.Tensor:
    """``where(d != 0, 1 / d, 0)`` (numpy's ``where(d != 0, 1.0 / where(d ==
    0, 1, d), 0.0)``) in float32."""
    one = torch.ones_like(d)
    return torch.where(d != 0, one / torch.where(d == 0, one, d), torch.zeros_like(d))


def _f16_bytes(d: torch.Tensor) -> torch.Tensor:
    """float32 ``[n]`` -> its f16 values' bytes ``[n, 2]`` (round to nearest even)."""
    return d.to(torch.float16).contiguous().view(torch.uint8).reshape(-1, 2)


def _quantize_q4_0(arr: torch.Tensor) -> torch.Tensor:
    flat = arr.to(torch.float32).reshape(-1, _BLOCK)
    # llama.cpp convention: d = value-at-max-abs / -8, so q=0 hits the
    # negative extreme exactly; round the scale to its stored f16 width first.
    idx = flat.abs().argmax(dim=1)
    vmax = flat.gather(1, idx[:, None])[:, 0]
    d = (vmax / _const(-8.0, flat)).to(torch.float16).to(torch.float32)
    q = torch.clamp(torch.round(flat * _inv(d)[:, None]) + 8, 0, 15).to(torch.uint8)
    return torch.cat([_f16_bytes(d), q[:, :16] | (q[:, 16:] << 4)], dim=1).reshape(-1)


def _quantize_q4_k(arr: torch.Tensor) -> torch.Tensor:
    """Q4_K encoder: 256-elem superblocks, 8 sub-blocks of 32 with 6-bit
    quantized (scale, min) pairs against f16 super-scales — the layout
    ``_dequant``'s Q4_K branch (and ggml) decodes: ``x ≈ d*sc*q - dmin*mn``
    with q in [0, 15]."""
    flat = arr.to(torch.float32).reshape(-1, 8, 32)
    nb = flat.shape[0]
    lo = flat.amin(dim=2)  # [nb, 8]
    hi = flat.amax(dim=2)
    # positive offset subtracted at decode; numpy's maximum(0.0, -lo) (+0.0 where lo is a zero of either sign)
    mins = torch.where(-lo > 0, -lo, torch.zeros_like(lo))
    scales = torch.clamp(hi + mins, min=1e-30) / _const(15.0, flat)
    d = (scales.amax(dim=1) / _const(63.0, flat)).to(torch.float16).to(torch.float32)  # [nb]
    dmin = (mins.amax(dim=1) / _const(63.0, flat)).to(torch.float16).to(torch.float32)
    inv_d = torch.where(d > 0, _inv(d), torch.zeros_like(d))
    inv_dm = torch.where(dmin > 0, _inv(dmin), torch.zeros_like(dmin))
    sc = torch.clamp(torch.round(scales * inv_d[:, None]), 0, 63).to(torch.uint8)
    mn = torch.clamp(torch.round(mins * inv_dm[:, None]), 0, 63).to(torch.uint8)
    eff_scale = d[:, None] * sc.to(torch.float32)  # [nb, 8]
    eff_min = dmin[:, None] * mn.to(torch.float32)
    denom = torch.where(eff_scale > 0, eff_scale, torch.ones_like(eff_scale))
    q = torch.clamp(torch.round((flat + eff_min[:, :, None]) / denom[:, :, None]), 0, 15).to(torch.uint8)
    # Pack 6-bit (sc, mn): inverse of _k_scale_min.
    packed = torch.cat([
        (sc[:, :4] & 63) | ((sc[:, 4:] >> 4) << 6),
        (mn[:, :4] & 63) | ((mn[:, 4:] >> 4) << 6),
        (sc[:, 4:] & 0xF) | ((mn[:, 4:] & 0xF) << 4),
    ], dim=1)
    # Pack nibbles: chunk c holds sub-blocks (2c, 2c+1) as (low, high).
    q4 = q.reshape(nb, 4, 2, 32)
    qs = (q4[:, :, 0] | (q4[:, :, 1] << 4)).reshape(nb, 128)
    return torch.cat([_f16_bytes(d), _f16_bytes(dmin), packed, qs], dim=1).reshape(-1)


def _quantize_q8_0(arr: torch.Tensor) -> torch.Tensor:
    flat = arr.to(torch.float32).reshape(-1, _BLOCK)
    amax = flat.abs().amax(dim=1)
    # Round the scale to its stored f16 width *before* quantizing, so the
    # quants are optimal for the scale the reader will actually use.
    d = (amax / _const(127.0, flat)).to(torch.float16).to(torch.float32)
    inv = torch.where(d > 0, _inv(d), torch.zeros_like(d))
    qs = torch.clamp(torch.round(flat * inv[:, None]), -127, 127).to(torch.int8)
    return torch.cat([_f16_bytes(d), qs.view(torch.uint8)], dim=1).reshape(-1)


def _write_string(f: BinaryIO, s: str) -> None:
    b = s.encode("utf-8")
    f.write(struct.pack("<Q", len(b)))
    f.write(b)


def _write_value(f: BinaryIO, v: Any) -> None:
    if isinstance(v, bool):
        f.write(struct.pack("<I", T_BOOL) + struct.pack("<B", int(v)))
    elif isinstance(v, int):
        f.write(struct.pack("<I", T_U32 if 0 <= v < 2**32 else T_I64))
        f.write(struct.pack("<I" if 0 <= v < 2**32 else "<q", v))
    elif isinstance(v, float):
        f.write(struct.pack("<I", T_F32) + struct.pack("<f", v))
    elif isinstance(v, str):
        f.write(struct.pack("<I", T_STR))
        _write_string(f, v)
    elif isinstance(v, (list, tuple)):
        f.write(struct.pack("<I", T_ARR))
        if not v:
            f.write(struct.pack("<IQ", T_I32, 0))
        elif all(isinstance(e, str) for e in v):
            f.write(struct.pack("<IQ", T_STR, len(v)))
            for s in v:
                _write_string(f, s)
        elif any(isinstance(e, float) for e in v):  # mixed int/float -> f32
            f.write(struct.pack("<IQ", T_F32, len(v)))
            f.write(np.asarray(v, dtype="<f4").tobytes())
        elif all(isinstance(e, (int, bool)) for e in v):
            f.write(struct.pack("<IQ", T_I32, len(v)))
            f.write(np.asarray(v, dtype="<i4").tobytes())
        else:
            raise TypeError(f"cannot serialize mixed-type metadata array: {v[:4]!r}...")
    else:
        raise TypeError(f"cannot serialize metadata value of type {type(v)}")


def _as_tensor(arr: Any) -> torch.Tensor:
    if isinstance(arr, torch.Tensor):
        return arr
    from dynamo_tpu_torch.bridge import tensor_from_numpy

    return tensor_from_numpy(arr)


def write_gguf(
    path: str | pathlib.Path,
    metadata: dict[str, Any],
    tensors: dict[str, Any],
    *,
    quant: dict[str, int] | int | None = None,
    align: int = 32,
    raw_tensors: dict[str, tuple[tuple[int, ...], int, bytes]] | None = None,
) -> None:
    """Write a GGUF v3 file. ``tensors`` are torch tensors (on any device:
    block encoders run there) or numpy arrays. ``quant`` selects ggml
    storage per tensor (a single type for all, or a per-name map); the
    default stores float tensors in their native width (f32/f16/bf16).
    ``raw_tensors`` carries pre-encoded payloads as ``name -> (shape,
    ggml_type, bytes)``."""
    metadata = dict(metadata)
    align = int(metadata.pop("general.alignment", align))

    def ttype(name: str, t: torch.Tensor) -> int:
        if isinstance(quant, int):
            q = quant
        elif isinstance(quant, dict):
            q = quant.get(name, -1)
        else:
            q = -1
        if q >= 0:
            if q in (GGML_Q4_1, GGML_Q5_K, GGML_Q6_K):
                raise ValueError("writer supports Q8_0/Q4_0/Q4_K quantization; Q4_1/Q5_K/Q6_K are read-only")
            n = t.numel()
            if q in (GGML_Q8_0, GGML_Q4_0) and n % _BLOCK:
                q = GGML_F16  # not blockable; fall back
            if q == GGML_Q4_K and n % _QK_K:
                q = GGML_F16  # superblocks need 256-elem multiples
            return q
        if t.dtype == torch.float16:
            return GGML_F16
        if t.dtype == torch.bfloat16:
            return GGML_BF16
        return GGML_F32

    def payload(t: torch.Tensor, ty: int) -> bytes:
        if ty == GGML_F32:
            data = t.to(torch.float32)
        elif ty == GGML_F16:
            data = t.to(torch.float16)
        elif ty == GGML_BF16:
            data = t.to(torch.bfloat16).view(torch.int16)
        elif ty == GGML_Q8_0:
            data = _quantize_q8_0(t)
        elif ty == GGML_Q4_0:
            data = _quantize_q4_0(t)
        elif ty == GGML_Q4_K:
            data = _quantize_q4_k(t)
        else:
            raise ValueError(f"writer does not support ggml type {ty} (readable-only format)")
        return data.contiguous().cpu().numpy().tobytes()

    blobs: list[tuple[str, tuple[int, ...], int, bytes]] = []
    for name, arr in tensors.items():
        t = _as_tensor(arr)
        ty = ttype(name, t)
        blobs.append((name, tuple(t.shape), ty, payload(t, ty)))
    for name, (shape, ty, data) in (raw_tensors or {}).items():
        bpb, epb = _TYPE_SIZES[ty]
        expect = int(np.prod(shape)) // epb * bpb
        if len(data) != expect:
            raise ValueError(f"raw tensor {name}: {len(data)} bytes != {expect} for shape {shape}")
        blobs.append((name, tuple(shape), ty, data))

    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<IQQ", 3, len(blobs), len(metadata) + 1))
        _write_string(f, "general.alignment")
        f.write(struct.pack("<II", T_U32, align))
        for key, val in metadata.items():
            _write_string(f, key)
            _write_value(f, val)
        offset = 0
        for name, shape, ty, data in blobs:
            _write_string(f, name)
            dims = tuple(reversed(shape))  # ggml order: innermost first
            f.write(struct.pack("<I", len(dims)))
            for d in dims:
                f.write(struct.pack("<Q", d))
            f.write(struct.pack("<IQ", ty, offset))
            offset += (len(data) + align - 1) // align * align
        pad = (-f.tell()) % align
        f.write(b"\x00" * pad)
        for _name, _shape, _t, data in blobs:
            f.write(data)
            f.write(b"\x00" * ((-len(data)) % align))


# ---------------------------------------------------------------------------
# Metadata -> ModelConfig
# ---------------------------------------------------------------------------


def config_from_gguf(reader: GGUFReader, *, name: str | None = None) -> ModelConfig:
    """Map ``{arch}.*`` GGUF metadata keys onto :class:`ModelConfig`."""
    md = reader.metadata
    arch = md.get("general.architecture")
    if not arch:
        raise ValueError("GGUF file missing required `general.architecture` metadata")

    def get(key: str, default: Any = None) -> Any:
        value = md.get(f"{arch}.{key}", default)
        # Some exports store per-layer lists for scalar-shaped keys
        # (head_count, feed_forward_length, ...); take the first layer.
        if isinstance(value, list) and value:
            return value[0]
        return value

    heads = int(get("attention.head_count", 1))
    hidden = int(get("embedding_length", 0))
    kv_heads = get("attention.head_count_kv", heads)
    vocab = get("vocab_size")
    if vocab is None:
        toks = md.get("tokenizer.ggml.tokens")
        vocab = len(toks) if toks else 32000
    head_dim = int(get("attention.key_length", hidden // max(heads, 1)))
    # Gemma GGUFs: GeGLU + scaled embeddings come from the arch; the (1+w)
    # norm convention does NOT apply — llama.cpp's converter bakes the +1
    # into the exported norm weights.
    gemma = arch == "gemma"
    tied = "output.weight" not in reader.tensors
    # Rope scaling: GGUF stores {arch}.rope.scaling.* (llama.cpp key names);
    # map onto the HF-schema dict rope_frequencies consumes. Llama-3-style
    # GGUFs don't carry the low/high freq factors, so use the published
    # Llama-3 defaults when the type asks for them.
    rope_scaling = None
    sc_type = get("rope.scaling.type")
    if sc_type and sc_type != "none":
        rope_scaling = {
            "rope_type": sc_type,
            "factor": float(get("rope.scaling.factor", 1.0)),
            "original_max_position_embeddings": int(
                get("rope.scaling.original_context_length", get("context_length", 4096))
            ),
            "low_freq_factor": float(get("rope.scaling.low_freq_factor", 1.0)),
            "high_freq_factor": float(get("rope.scaling.high_freq_factor", 4.0)),
        }
        # YaRN extras (attn_factor is llama.cpp's key; betas are ours).
        if get("rope.scaling.attn_factor") is not None:
            rope_scaling["attention_factor"] = float(get("rope.scaling.attn_factor"))
        for beta in ("beta_fast", "beta_slow"):
            if get(f"rope.scaling.{beta}") is not None:
                rope_scaling[beta] = float(get(f"rope.scaling.{beta}"))
    shared_ffn = int(get("expert_shared_feed_forward_length", 0))
    if shared_ffn == 0 and "blk.0.ffn_gate_shexp.weight" in reader.tensors:
        shared_ffn = reader.tensors["blk.0.ffn_gate_shexp.weight"].shape[0]
    return ModelConfig(
        name=name or md.get("general.name", arch),
        vocab_size=int(vocab),
        hidden_size=hidden,
        num_layers=int(get("block_count", 0)),
        num_heads=heads,
        num_kv_heads=int(kv_heads),
        head_dim=head_dim,
        intermediate_size=int(get("feed_forward_length", 0)),
        rope_theta=float(get("rope.freq_base", 10000.0)),
        rope_scaling=rope_scaling,
        rms_eps=float(get("attention.layer_norm_rms_epsilon", 1e-5)),
        max_position=int(get("context_length", 4096)),
        tie_embeddings=tied,
        mlp_act="gelu_tanh" if gemma else "silu",
        embed_scale=gemma,  # norm_plus_one deliberately NOT set (see above)
        num_experts=int(get("expert_count", 0)),
        num_experts_per_token=int(get("expert_used_count", 0)),
        moe_intermediate_size=int(get("expert_feed_forward_length", 0)),
        shared_expert_size=shared_ffn,
        shared_expert_gated="blk.0.ffn_gate_inp_shexp.weight" in reader.tensors,
        attention_bias="blk.0.attn_q.bias" in reader.tensors,
        # Q/K RMS norms: present as blk.N.attn_{q,k}_norm.weight. The WIDTH
        # distinguishes the style — per-head (Qwen3) vs full projection
        # width (OLMoE) — so detection is shape-driven, not arch-name-driven.
        qk_norm=(
            ""
            if "blk.0.attn_q_norm.weight" not in reader.tensors
            else (
                "head"
                if reader.tensors["blk.0.attn_q_norm.weight"].shape[-1] == head_dim
                else "flat"
            )
        ),
    )


# ---------------------------------------------------------------------------
# Embedded tokenizer -> tokenizers object
# ---------------------------------------------------------------------------


def tokenizer_from_gguf(reader: GGUFReader):
    """Rebuild the embedded tokenizer as a BaseTokenizer.

    GGUF stores the vocab inline (``tokenizer.ggml.*``): SentencePiece-style
    unigram for ``model=llama``, byte-level BPE for ``model=gpt2``.
    """
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers

    from dynamo_tpu_torch.tokenizer import HfTokenizer

    md = reader.metadata
    kind = md.get("tokenizer.ggml.model", "llama")
    tokens: list[str] = md.get("tokenizer.ggml.tokens") or []
    if not tokens:
        raise ValueError("GGUF file has no embedded tokenizer (tokenizer.ggml.tokens)")
    bos = md.get("tokenizer.ggml.bos_token_id")
    eos = md.get("tokenizer.ggml.eos_token_id")
    if kind == "llama":
        scores = md.get("tokenizer.ggml.scores")
        if scores is None:
            raise ValueError("`llama` unigram tokenizer requires tokenizer.ggml.scores")
        unk = int(md.get("tokenizer.ggml.unknown_token_id", 0))
        tk = Tokenizer(models.Unigram(list(zip(tokens, map(float, scores))), unk_id=unk, byte_fallback=True))
        tk.pre_tokenizer = pre_tokenizers.Metaspace(replacement="▁", prepend_scheme="first")
        tk.decoder = decoders.Sequence(
            [decoders.Replace("▁", " "), decoders.ByteFallback(), decoders.Fuse(), decoders.Strip(" ", 1, 0)]
        )
    elif kind == "gpt2":
        merges_raw = md.get("tokenizer.ggml.merges") or []
        merges = [tuple(m.split(" ", 1)) for m in merges_raw]
        vocab = {tok: i for i, tok in enumerate(tokens)}
        tk = Tokenizer(models.BPE(vocab=vocab, merges=merges, fuse_unk=False))
        tk.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=True)
        tk.decoder = decoders.ByteLevel()
    else:
        raise ValueError(f"unsupported GGUF tokenizer model {kind!r}")
    # tokenizer.ggml.token_type marks CONTROL (=3) tokens — BOS/EOS/<|im_end|>
    # etc. Register them as special so `skip_special_tokens` decoding actually
    # skips them (unregistered, they'd leak into generated text).
    token_types = md.get("tokenizer.ggml.token_type")
    if token_types:
        from tokenizers import AddedToken

        control = [
            AddedToken(tok, special=True, normalized=False)
            for tok, tt in zip(tokens, token_types)
            if tt == 3
        ]
        if control:
            tk.add_special_tokens(control)
    return HfTokenizer(
        tk,
        eos_token_ids={int(eos)} if eos is not None else None,
        bos_token_id=int(bos) if bos is not None else None,
    )


# ---------------------------------------------------------------------------
# Tensor name mapping -> stacked params
# ---------------------------------------------------------------------------

# leaf name -> (gguf suffix, transpose?)
_GGUF_LAYER_MAP: dict[str, tuple[str, bool]] = {
    "attn_norm": ("attn_norm.weight", False),
    "mlp_norm": ("ffn_norm.weight", False),
    "wq": ("attn_q.weight", True),
    "wk": ("attn_k.weight", True),
    "wv": ("attn_v.weight", True),
    "wo": ("attn_output.weight", True),
    "w_gate": ("ffn_gate.weight", True),
    "w_up": ("ffn_up.weight", True),
    "w_down": ("ffn_down.weight", True),
}
_GGUF_BIAS_MAP = {"bq": "attn_q.bias", "bk": "attn_k.bias", "bv": "attn_v.bias"}
# Architectures whose GGUFs use GGML NORM (interleaved-pair) rope and whose
# Q/K were therefore permuted by llama.cpp's converter. Mistral/Mixtral are
# written under arch "llama"; qwen2/deepseek2 are NEOX (unpermuted).
_NORM_ROPE_ARCHS = {"llama"}


def load_gguf_params(
    source: str | pathlib.Path | GGUFReader,
    cfg: ModelConfig,
    *,
    device: str | torch.device = "cuda",
    dtype: torch.dtype | None = None,
    quantize: str = "",
) -> dict:
    """GGUF file -> the port's stacked parameters on ``device`` (the card
    unless the caller asks for the CPU).

    Each tensor's stored bytes go to the device once and are decoded, cast
    and written into their layer of a preallocated leaf there, so peak host
    memory is one tensor's stored bytes. ``quantize="int4"`` imports Q4_0/
    Q4_K matmul tensors directly into packed int4 leaves (``{"qw4",
    "scale"[, "qbias"]}``, float32 scale and bias, group 32): the file's own
    codes and group scales, repacked losslessly. Tensors stored at other
    ggml types (and any leaf whose layers mix types) fall back to the
    dequant path; the caller's ``quantize_params`` pass picks those up."""
    from dynamo_tpu_torch.models.llama import param_dtype
    from dynamo_tpu_torch.models.loader import rope_load_perm
    from dynamo_tpu_torch.models.quant import pack_int4

    if cfg.is_moe:
        raise NotImplementedError("MoE GGUF checkpoints (expert tensors) are not ported to dynamo_tpu_torch yet "
                                  "(ROADMAP B6, quantized expert forms)")
    dev = resolve_device(device)
    reader = source if isinstance(source, GGUFReader) else shared_reader(source)
    dt = dtype or param_dtype(cfg)

    # llama.cpp's converter permutes llama-family Q/K weights into GGML NORM
    # (interleaved-pair) rope order; ops/rope.apply_rope is half-split, so
    # the permutation is inverted at load (qwen2 etc. are NEOX: no permute).
    qk_perms: dict[str, torch.Tensor] = {}
    if reader.metadata.get("general.architecture") in _NORM_ROPE_ARCHS:
        qk_perms = {
            leaf: torch.from_numpy(rope_load_perm(h, cfg.head_dim, cfg.head_dim)).to(dev)
            for leaf, h in (("wq", cfg.num_heads), ("wk", cfg.num_kv_heads),
                            ("bq", cfg.num_heads), ("bk", cfg.num_kv_heads))
        }

    def rd(name: str, transpose: bool, perm: torch.Tensor | None = None) -> torch.Tensor:
        arr = reader.read(name, dev)
        if perm is not None:  # permute GGML rows (pre-transpose orientation)
            arr = arr[perm]
        return arr.T if transpose else arr

    def rd_packed(name: str, perm: torch.Tensor | None = None) -> dict | None:
        """Q4_0/Q4_K -> packed int4 leaf in model orientation, else None.
        The rope permutation applies to GGML rows = output channels, the
        leaf's last axis after the transpose, which the group scales (along
        the contraction axis) allow."""
        info = reader.tensors.get(name)
        if info is None or info.ggml_type not in (GGML_Q4_0, GGML_Q4_K):
            return None
        q, scale, bias = reader.read_q4(name, dev)
        if perm is not None:
            q, scale = q[perm], scale[perm]
            bias = bias[perm] if bias is not None else None
        leaf = {"qw4": pack_int4(q.T.contiguous()), "scale": scale.T.contiguous()}
        if bias is not None:
            leaf["qbias"] = bias.T.contiguous()
        return leaf

    L = cfg.num_layers
    layers: dict[str, Any] = {}

    def stack(leaf: str, suffix: str, transpose: bool) -> torch.Tensor:
        perm = qk_perms.get(leaf)
        out = None
        for li in range(L):
            arr = rd(f"blk.{li}.{suffix}", transpose, perm)
            if out is None:
                out = torch.empty((L, *arr.shape), dtype=dt, device=dev)
            out[li].copy_(arr.to(dt))
        return out

    def stack_packed(leaf: str, suffix: str) -> dict | None:
        """Layer-stacked packed leaf, or None if any layer can't pack (or
        the layers mix Q4_0 with Q4_K — stacking needs uniform keys)."""
        types = {reader.tensors[f"blk.{li}.{suffix}"].ggml_type if f"blk.{li}.{suffix}" in reader else None
                 for li in range(L)}
        if len(types) != 1 or types.pop() not in (GGML_Q4_0, GGML_Q4_K):
            return None
        perm = qk_perms.get(leaf)
        out: dict[str, torch.Tensor] = {}
        for li in range(L):
            for k, v in rd_packed(f"blk.{li}.{suffix}", perm).items():
                if k not in out:
                    out[k] = torch.empty((L, *v.shape), dtype=v.dtype, device=dev)
                out[k][li].copy_(v)
        return out

    packed_q4 = quantize == "int4"
    for leaf, (suffix, t) in _GGUF_LAYER_MAP.items():
        packed = stack_packed(leaf, suffix) if packed_q4 and t else None
        layers[leaf] = packed if packed is not None else stack(leaf, suffix, t)
    if cfg.attention_bias:
        for leaf, suffix in _GGUF_BIAS_MAP.items():
            layers[leaf] = stack(leaf, suffix, False)
    if cfg.qk_norm:
        layers["q_norm"] = stack("q_norm", "attn_q_norm.weight", False)
        layers["k_norm"] = stack("k_norm", "attn_k_norm.weight", False)

    params: dict[str, Any] = {
        "embed": rd("token_embd.weight", False).to(dt),
        "norm_f": rd("output_norm.weight", False).to(dt),
        "layers": layers,
    }
    if not cfg.tie_embeddings:
        lm = "output.weight" if "output.weight" in reader else "token_embd.weight"
        packed = rd_packed(lm) if packed_q4 else None
        params["lm_head"] = packed if packed is not None else rd(lm, True).to(dt).contiguous()
    return params


def save_params_gguf(
    path: str | pathlib.Path,
    cfg: ModelConfig,
    params: dict,
    *,
    quant: dict[str, int] | int | None = None,
    tokenizer_metadata: dict[str, Any] | None = None,
) -> None:
    """Reverse mapping: the port's parameters (full width, on any device) ->
    GGUF file, written under arch "llama" with Q/K permuted back to GGML
    NORM rope order. ``quant`` applies to matrices only (norm vectors and
    biases stay float32); block encoding runs on the parameters' device."""
    from dynamo_tpu_torch.models.loader import rope_save_perm
    from dynamo_tpu_torch.models.quant import is_quantized

    def walk(tree):
        for v in tree.values():
            if is_quantized(v):
                raise ValueError("save_params_gguf takes full-width parameters, not quantized leaves")
            if isinstance(v, dict):
                walk(v)

    walk(params)
    if cfg.is_moe:
        raise NotImplementedError("MoE GGUF export (expert tensors) is not ported to dynamo_tpu_torch yet "
                                  "(ROADMAP B6, quantized expert forms)")
    arch = "llama"
    md: dict[str, Any] = {
        "general.architecture": arch,
        "general.name": cfg.name,
        f"{arch}.embedding_length": cfg.hidden_size,
        f"{arch}.block_count": cfg.num_layers,
        f"{arch}.attention.head_count": cfg.num_heads,
        f"{arch}.attention.head_count_kv": cfg.num_kv_heads,
        f"{arch}.attention.key_length": cfg.head_dim,
        f"{arch}.feed_forward_length": cfg.intermediate_size,
        f"{arch}.rope.freq_base": float(cfg.rope_theta),
        f"{arch}.attention.layer_norm_rms_epsilon": float(cfg.rms_eps),
        f"{arch}.context_length": cfg.max_position,
        f"{arch}.vocab_size": cfg.vocab_size,
    }
    if cfg.rope_scaling:
        sc = cfg.rope_scaling
        md[f"{arch}.rope.scaling.type"] = str(sc.get("rope_type", sc.get("type", "linear")))
        md[f"{arch}.rope.scaling.factor"] = float(sc.get("factor", 1.0))
        if "original_max_position_embeddings" in sc:
            md[f"{arch}.rope.scaling.original_context_length"] = int(sc["original_max_position_embeddings"])
        for key in ("low_freq_factor", "high_freq_factor", "beta_fast", "beta_slow"):
            if key in sc:
                md[f"{arch}.rope.scaling.{key}"] = float(sc[key])
        if "attention_factor" in sc:
            md[f"{arch}.rope.scaling.attn_factor"] = float(sc["attention_factor"])
    md.update(tokenizer_metadata or {})

    tensors: dict[str, torch.Tensor] = {
        "token_embd.weight": params["embed"],
        "output_norm.weight": params["norm_f"],
    }
    if "lm_head" in params:
        tensors["output.weight"] = params["lm_head"].T
    layers = params["layers"]
    dev = params["embed"].device
    save_perms = {
        leaf: torch.from_numpy(rope_save_perm(h, cfg.head_dim, cfg.head_dim)).to(dev)
        for leaf, h in (("wq", cfg.num_heads), ("wk", cfg.num_kv_heads),
                        ("bq", cfg.num_heads), ("bk", cfg.num_kv_heads))
    }
    for li in range(cfg.num_layers):
        if cfg.qk_norm:
            tensors[f"blk.{li}.attn_q_norm.weight"] = layers["q_norm"][li]
            tensors[f"blk.{li}.attn_k_norm.weight"] = layers["k_norm"][li]
        for leaf, (suffix, t) in _GGUF_LAYER_MAP.items():
            if leaf not in layers:
                continue
            arr = layers[leaf][li]
            if t:
                arr = arr.T
            if leaf in save_perms:
                arr = arr[save_perms[leaf]]
            tensors[f"blk.{li}.{suffix}"] = arr
        for leaf, suffix in _GGUF_BIAS_MAP.items():
            if leaf in layers:
                arr = layers[leaf][li]
                if leaf in save_perms:
                    arr = arr[save_perms[leaf]]
                tensors[f"blk.{li}.{suffix}"] = arr
    qmap: dict[str, int] | None = None
    if isinstance(quant, dict):
        qmap = {n: q for n, q in quant.items() if tensors[n].dim() >= 2}
    elif quant is not None:
        qmap = {n: quant for n, a in tensors.items() if a.dim() >= 2}
    write_gguf(path, md, {n: a.to(torch.float32).contiguous() for n, a in tensors.items()}, quant=qmap)
