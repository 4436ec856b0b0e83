"""Checkpoint loading: HF-style safetensors model dirs -> the port's stacked
parameters (the dense and MLA half of ``dynamo_tpu/models/loader.py``).

HF checkpoints store one tensor per layer in torch's ``[out_features,
in_features]`` orientation; the port's parameters (``models/llama.py``)
stack layers on a leading axis in the ``[in, out]`` (``x @ W``) orientation,
exactly the JAX pytree's layout. The loader maps names, transposes
projections, stacks layers and writes each layer straight into its leaf on
the requested device, so peak host memory is one per-layer tensor, not the
checkpoint; transposes and casts run on the device.

The safetensors format is read by hand (:class:`SafetensorsFile`): an 8-byte
little-endian header length, a JSON header naming each tensor's dtype,
shape and byte range, then the raw bytes, mapped with ``numpy.memmap`` and
read one tensor at a time. Sharded checkpoints list their files in
``model.safetensors.index.json``. bf16 crosses into torch through a
``uint16`` view (``torch.from_numpy`` has no bf16).

``save_params`` is the reverse mapping (HF names, ``[out, in]`` tensors, a
``config.json``), optionally split into shards with an index, so tests and
tools can write an HF-compatible checkpoint from any parameters.

Routed-MoE checkpoints load with the JAX loader's name tables: the router
(``mlp.gate`` or Mixtral's ``block_sparse_moe.gate``), one tensor per expert
stacked on an expert axis (``mlp.experts.{e}.*``, ``block_sparse_moe.experts.{e}.w1/w3/w2``),
the shared expert (``mlp.shared_expert(s).*``, ``shared_expert_gate``) and
DeepSeek-V3's f32 ``e_score_correction_bias``; DeepSeek's leading dense
layers load into a ``dense_layers`` subtree.

Not ported yet: vision towers (``load_vlm``, ROADMAP A6) and mesh-sharded
placement (A8). GGUF files load through ``models/gguf.py``.
"""

from __future__ import annotations

import json
import pathlib
import struct
from typing import Any

import numpy as np
import torch

from dynamo_tpu_torch.device import resolve_device
from dynamo_tpu_torch.models.config import ModelConfig

Params = dict

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

# safetensors dtype name -> (numpy storage type, torch view of it or None).
# bf16 and fp8 are stored as same-width integers and viewed in torch.
_ST_DTYPES: dict[str, tuple[np.dtype, torch.dtype | None]] = {
    "F64": (np.dtype(np.float64), None),
    "F32": (np.dtype(np.float32), None),
    "F16": (np.dtype(np.float16), None),
    "BF16": (np.dtype(np.uint16), torch.bfloat16),
    "F8_E4M3": (np.dtype(np.uint8), torch.float8_e4m3fn),
    "I64": (np.dtype(np.int64), None),
    "I32": (np.dtype(np.int32), None),
    "I16": (np.dtype(np.int16), None),
    "I8": (np.dtype(np.int8), None),
    "U8": (np.dtype(np.uint8), None),
    "BOOL": (np.dtype(np.bool_), None),
}
_ST_NAMES = {torch.float64: "F64", torch.float32: "F32", torch.float16: "F16", torch.bfloat16: "BF16",
             torch.float8_e4m3fn: "F8_E4M3", torch.int64: "I64", torch.int32: "I32", torch.int16: "I16",
             torch.int8: "I8", torch.uint8: "U8", torch.bool: "BOOL"}


# ---------------------------------------------------------------------------
# The safetensors format, by hand
# ---------------------------------------------------------------------------


class SafetensorsFile:
    """One ``.safetensors`` file: its header parsed at open, its bytes mapped
    (``numpy.memmap``) at the first read."""

    def __init__(self, path: str | pathlib.Path) -> None:
        self.path = pathlib.Path(path)
        with open(self.path, "rb") as f:
            head = f.read(8)
            if len(head) != 8:
                raise ValueError(f"{self.path}: not a safetensors file (shorter than its header length)")
            (n,) = struct.unpack("<Q", head)
            header = json.loads(f.read(n))
        self.metadata: dict | None = header.pop("__metadata__", None)
        self._entries: dict[str, dict] = header
        self._start = 8 + n
        size = self.path.stat().st_size - self._start
        for name, e in header.items():
            if e["dtype"] not in _ST_DTYPES:
                raise ValueError(f"{self.path}: tensor {name!r} has unsupported dtype {e['dtype']}")
            lo, hi = e["data_offsets"]
            want = _ST_DTYPES[e["dtype"]][0].itemsize * int(np.prod(e["shape"], dtype=np.int64))
            if hi - lo != want or hi > size:
                raise ValueError(f"{self.path}: tensor {name!r} spans bytes [{lo}, {hi}), "
                                 f"its shape needs {want} and the file holds {size}")
        self._mm: np.memmap | None = None

    def keys(self) -> list[str]:
        return list(self._entries)

    def shape(self, name: str) -> tuple[int, ...]:
        return tuple(self._entries[name]["shape"])

    def dtype(self, name: str) -> str:
        return self._entries[name]["dtype"]

    def read(self, name: str) -> torch.Tensor:
        """The tensor on the CPU in its own dtype, copied out of the mapping
        (bf16 and fp8 through their same-width integer storage)."""
        if self._mm is None:
            self._mm = np.memmap(self.path, dtype=np.uint8, mode="r")
        e = self._entries[name]
        lo, hi = e["data_offsets"]
        storage, view = _ST_DTYPES[e["dtype"]]
        raw = self._mm[self._start + lo:self._start + hi]
        t = torch.from_numpy(np.frombuffer(raw, dtype=storage).reshape(e["shape"]).copy())
        return t.view(view) if view is not None else t


def write_safetensors(path: str | pathlib.Path, tensors: list[tuple[str, Any]],
                      metadata: dict[str, str] | None = None) -> int:
    """Write ``(name, tensor)`` pairs as one safetensors file, one tensor in
    host memory at a time: a value may be a callable returning its tensor,
    asked for its shape and dtype first (``(shape, dtype, fn)``). Returns
    the bytes of tensor data written."""
    plan = []
    off = 0
    for name, spec in tensors:
        shape, dtype, fn = spec if isinstance(spec, tuple) else (tuple(spec.shape), spec.dtype, lambda t=spec: t)
        nbytes = int(np.prod(shape, dtype=np.int64)) * torch.empty((), dtype=dtype).element_size()
        plan.append((name, shape, dtype, fn, off, off + nbytes))
        off += nbytes
    header: dict[str, Any] = {}
    if metadata:
        header["__metadata__"] = metadata
    for name, shape, dtype, _fn, lo, hi in plan:
        header[name] = {"dtype": _ST_NAMES[dtype], "shape": list(shape), "data_offsets": [lo, hi]}
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)  # the data starts 8-byte aligned, as the reference writer pads it
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for name, shape, dtype, fn, lo, hi in plan:
            t = fn().detach().to("cpu").contiguous()
            if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
                raise ValueError(f"tensor {name!r}: planned {shape} {dtype}, got {tuple(t.shape)} {t.dtype}")
            if t.dtype in (torch.bfloat16, torch.float8_e4m3fn):
                t = t.view(torch.uint16 if t.element_size() == 2 else torch.uint8)
            f.write(t.numpy().data)
    return off


# ---------------------------------------------------------------------------
# Checkpoint index: tensor name -> file
# ---------------------------------------------------------------------------


class CheckpointIndex:
    """All tensors of a (possibly sharded) safetensors checkpoint: a single
    ``model.safetensors`` (or any ``*.safetensors``) or the files listed in
    ``model.safetensors.index.json``. Nothing is read until asked for."""

    def __init__(self, model_dir: str | pathlib.Path) -> None:
        self.dir = pathlib.Path(model_dir)
        index_file = self.dir / "model.safetensors.index.json"
        if index_file.exists():
            weight_map: dict[str, str] = json.loads(index_file.read_text())["weight_map"]
            files = sorted(set(weight_map.values()))
        else:
            files = sorted(f.name for f in self.dir.glob("*.safetensors"))
            if not files:
                raise FileNotFoundError(f"no *.safetensors under {self.dir}")
        self._handles = {f: SafetensorsFile(self.dir / f) for f in files}
        self._where: dict[str, str] = {}
        for fname, h in self._handles.items():
            for key in h.keys():
                self._where[key] = fname

    def keys(self) -> list[str]:
        return sorted(self._where)

    def __contains__(self, name: str) -> bool:
        return name in self._where

    def shape(self, name: str) -> tuple[int, ...]:
        return self._handles[self._where[name]].shape(name)

    def read(self, name: str) -> torch.Tensor:
        return self._handles[self._where[name]].read(name)


# ---------------------------------------------------------------------------
# HF name mapping (the JAX loader's tables, dense and MLA)
# ---------------------------------------------------------------------------

# Per-layer sources: leaf name -> (hf suffix candidates, transpose?)
_LAYER_MAP: dict[str, tuple[tuple[str, ...], bool]] = {
    "attn_norm": (("input_layernorm.weight",), False),
    "mlp_norm": (("post_attention_layernorm.weight",), False),
    "wq": (("self_attn.q_proj.weight",), True),
    "wk": (("self_attn.k_proj.weight",), True),
    "wv": (("self_attn.v_proj.weight",), True),
    "wo": (("self_attn.o_proj.weight",), True),
    "w_gate": (("mlp.gate_proj.weight",), True),
    "w_up": (("mlp.up_proj.weight",), True),
    "w_down": (("mlp.down_proj.weight",), True),
}

# Qwen2-family attention biases.
_BIAS_MAP: dict[str, tuple[tuple[str, ...], bool]] = {
    "bq": (("self_attn.q_proj.bias",), False),
    "bk": (("self_attn.k_proj.bias",), False),
    "bv": (("self_attn.v_proj.bias",), False),
}

# MLA per-layer sources (DeepSeek-V2/V3 HF names). kv_b_proj packs per-head
# [K_nope; V] row blocks and is split by _KvBLeaf.
_MLA_MAP: dict[str, tuple[tuple[str, ...], bool]] = {
    "w_q_a": (("self_attn.q_a_proj.weight",), True),
    "q_norm": (("self_attn.q_a_layernorm.weight",), False),
    "w_q_b": (("self_attn.q_b_proj.weight",), True),
    "w_q": (("self_attn.q_proj.weight",), True),
    "w_kv_a": (("self_attn.kv_a_proj_with_mqa.weight",), True),
    "kv_norm": (("self_attn.kv_a_layernorm.weight",), False),
    "wo_mla": (("self_attn.o_proj.weight",), True),
}


# MoE per-layer sources. Router: [E, D] in HF -> [D, E]. Experts are stored
# one tensor per expert; the loader stacks them on an expert axis.
_MOE_ROUTER = ("mlp.gate.weight", "block_sparse_moe.gate.weight")
_MOE_ROUTER_BIAS = ("mlp.gate.e_score_correction_bias",)
_MOE_EXPERT_MAP: dict[str, tuple[tuple[str, ...], bool]] = {
    "w_gate": (("mlp.experts.{e}.gate_proj.weight", "block_sparse_moe.experts.{e}.w1.weight"), True),
    "w_up": (("mlp.experts.{e}.up_proj.weight", "block_sparse_moe.experts.{e}.w3.weight"), True),
    "w_down": (("mlp.experts.{e}.down_proj.weight", "block_sparse_moe.experts.{e}.w2.weight"), True),
}

# Always-on shared expert: Qwen2-MoE (``mlp.shared_expert.*`` + a sigmoid
# gate) / DeepSeek (``mlp.shared_experts.*``, ungated).
_SHARED_EXPERT_MAP: dict[str, tuple[tuple[str, ...], bool]] = {
    "w_shared_gate": (("mlp.shared_expert.gate_proj.weight", "mlp.shared_experts.gate_proj.weight"), True),
    "w_shared_up": (("mlp.shared_expert.up_proj.weight", "mlp.shared_experts.up_proj.weight"), True),
    "w_shared_down": (("mlp.shared_expert.down_proj.weight", "mlp.shared_experts.down_proj.weight"), True),
}
_SHARED_GATE = ("mlp.shared_expert_gate.weight",)


def _find(index, candidates: tuple[str, ...], li: int, e: int | None = None) -> str:
    for cand in candidates:
        name = f"model.layers.{li}." + (cand.format(e=e) if e is not None else cand)
        if name in index:
            return name
    raise KeyError(f"layer {li}: none of {candidates} in checkpoint (expert={e})")


class _LazyLeaf:
    """A stacked leaf over per-layer checkpoint tensors: ``shape`` is the
    stacked ``[L, ...]`` shape in the port's orientation (``[L, E, ...]``
    for an expert stack, ``expert_axis``); ``load`` reads one tensor at a
    time, copies it to the device as it is stored, and permutes, transposes
    and casts it there into a leaf allocated on the device, in ``dtype`` or
    the leaf's own (the router bias stays f32)."""

    expert_axis = False
    dtype: torch.dtype | None = None

    def __init__(self, index, shape: tuple[int, ...], per_layer, row_perm: np.ndarray | None = None,
                 expert_axis: bool = False, dtype: torch.dtype | None = None) -> None:
        self.index = index
        self.shape = shape
        self.per_layer = per_layer  # li -> [(tensor name, transpose?)], one per expert of a stack
        # Source-row (torch [out, in] axis-0) permutation applied at read
        # time (rope interleaved -> half-split, see rope_load_perm).
        self.row_perm = row_perm
        self.expert_axis = expert_axis
        self.dtype = dtype

    def names(self) -> set[str]:
        return {n for li in range(self.shape[0]) for n, _t in self.per_layer(li)}

    def _read(self, name: str, transpose: bool, device: torch.device) -> torch.Tensor:
        arr = self.index.read(name).to(device)
        if self.row_perm is not None:
            arr = arr[torch.from_numpy(self.row_perm).to(device)]
        return arr.T if transpose else arr

    def layer(self, li: int, device: torch.device) -> torch.Tensor:
        ((name, transpose),) = self.per_layer(li)
        return self._read(name, transpose, device)

    def load(self, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
        dtype = self.dtype or dtype
        out = torch.empty(self.shape, dtype=dtype, device=device)
        for li in range(self.shape[0]):
            if self.expert_axis:
                for e, (name, transpose) in enumerate(self.per_layer(li)):
                    out[li, e].copy_(self._read(name, transpose, device).to(dtype))
            else:
                out[li].copy_(self.layer(li, device).to(dtype))
        return out


def rope_load_perm(n_heads: int, head_size: int, rope_dim: int) -> np.ndarray:
    """Row permutation (torch ``[out, in]`` orientation) converting each
    head's trailing ``rope_dim`` rows from interleaved pair order to the
    half-split order ``ops/rope.apply_rope`` expects: ``new = old[perm]``.

    DeepSeek-V2/V3 checkpoints ship rope dims interleaved (HF
    ``rope_interleave=True``); permuting the *weights* once at load keeps the
    runtime half-split everywhere. Half-split row ``p*half + d`` reads
    interleaved row ``2*d + p``."""
    half = rope_dim // 2
    idx = np.arange(n_heads * head_size)
    head, r = idx // head_size, idx % head_size
    off = head_size - rope_dim
    j = r - off
    src_r = np.where(r >= off, off + 2 * (j % max(half, 1)) + j // max(half, 1), r)
    return head * head_size + src_r


def rope_save_perm(n_heads: int, head_size: int, rope_dim: int) -> np.ndarray:
    """Inverse of :func:`rope_load_perm` (half-split -> interleaved), applied
    by the checkpoint writer so exports match the ecosystem convention."""
    return np.argsort(rope_load_perm(n_heads, head_size, rope_dim))


class _KvBLeaf:
    """Stacked ``[L, r_kv, H, seg_width]`` view over per-layer kv_b_proj
    tensors. kv_b_proj is torch-``[H*(dn+dv), r_kv]``; head h's rows are
    ``h*(dn+dv) + offset .. + offset + width`` (offset 0 / width dn for W_uk,
    offset dn / width dv for W_uv)."""

    def __init__(self, index, num_layers: int, n_heads: int, dn: int, dv: int, offset: int, width: int,
                 layer_offset: int = 0) -> None:
        self.index = index
        self.layer_offset = layer_offset
        self.shape = (
            num_layers,
            index.shape(f"model.layers.{layer_offset}.self_attn.kv_b_proj.weight")[1],
            n_heads, width,
        )
        self.n_heads, self.seg = n_heads, dn + dv
        self.offset, self.width = offset, width

    def per_layer_name(self, li: int) -> str:
        return f"model.layers.{li + self.layer_offset}.self_attn.kv_b_proj.weight"

    def names(self) -> set[str]:
        return {self.per_layer_name(li) for li in range(self.shape[0])}

    def layer(self, li: int, device: torch.device) -> torch.Tensor:
        full = self.index.read(self.per_layer_name(li)).to(device)  # [H*seg, r_kv]
        per_head = full.reshape(self.n_heads, self.seg, -1)  # [H, dn+dv, r_kv]
        return per_head[:, self.offset:self.offset + self.width, :].permute(2, 0, 1)  # [r_kv, H, w]

    expert_axis = False
    dtype = None
    load = _LazyLeaf.load


class _TopLeaf:
    """One un-stacked checkpoint tensor (embeddings, final norm, lm_head)."""

    def __init__(self, index, name: str, transpose: bool) -> None:
        self.index, self.name, self.transpose = index, name, transpose
        shp = index.shape(name)
        self.shape = shp[::-1] if transpose else shp

    def names(self) -> set[str]:
        return {self.name}

    def load(self, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
        arr = self.index.read(self.name).to(device)
        return (arr.T if self.transpose else arr).to(dtype).contiguous()


def _leaf_specs(index, cfg: ModelConfig) -> dict[str, Any]:
    """The params tree of lazy leaves (``_LazyLeaf``, ``_KvBLeaf``,
    ``_TopLeaf``): GQA or MLA attention over a dense or routed-MoE MLP. A
    mixed DeepSeek stack (``cfg.first_k_dense``) gives two subtrees,
    ``dense_layers`` (checkpoint layers [0, k), dense MLP) and ``layers``
    (layers [k, L), MoE), as the JAX loader splits them."""

    def subtree(l0: int, count: int, moe: bool) -> dict[str, Any]:
        def simple(suffixes: tuple[str, ...], transpose: bool, row_perm: np.ndarray | None = None,
                   dtype: torch.dtype | None = None) -> _LazyLeaf:
            shp = index.shape(_find(index, suffixes, l0))
            shp = shp[::-1] if transpose else shp
            return _LazyLeaf(index, (count, *shp),
                             lambda li, s=suffixes, t=transpose: [(_find(index, s, li + l0), t)],
                             row_perm=row_perm, dtype=dtype)

        if cfg.attn_type == "mla":
            layers = {name: simple(s, t) for name, (s, t) in _LAYER_MAP.items() if name in ("attn_norm", "mlp_norm")}
            # DeepSeek checkpoints store rope dims interleaved: permute the
            # rope rows of the q projection (per head) and kv_a_proj (single
            # shared rope key) to half-split at load (rope_load_perm).
            q_perm = kv_perm = None
            if cfg.rope_interleave:
                q_perm = rope_load_perm(cfg.num_heads, cfg.qk_nope_head_dim + cfg.qk_rope_head_dim,
                                        cfg.qk_rope_head_dim)
                kv_perm = rope_load_perm(1, cfg.kv_lora_rank + cfg.qk_rope_head_dim, cfg.qk_rope_head_dim)
            for name, (suffixes, t) in _MLA_MAP.items():
                if name in ("w_q_a", "q_norm", "w_q_b") and cfg.q_lora_rank <= 0:
                    continue
                if name == "w_q" and cfg.q_lora_rank > 0:
                    continue
                layers[name] = simple(suffixes, t,
                                      row_perm={"w_q_b": q_perm, "w_q": q_perm, "w_kv_a": kv_perm}.get(name))
            dn, dv = cfg.qk_nope_head_dim, cfg.v_head_dim
            layers["w_uk"] = _KvBLeaf(index, count, cfg.num_heads, dn, dv, 0, dn, layer_offset=l0)
            layers["w_uv"] = _KvBLeaf(index, count, cfg.num_heads, dn, dv, dn, dv, layer_offset=l0)
        else:
            layers = {name: simple(s, t) for name, (s, t) in _LAYER_MAP.items()
                      if name not in ("w_gate", "w_up", "w_down")}
            if cfg.qk_norm:  # Qwen3 (per-head) / OLMoE (flat) q/k RMS norms
                layers["q_norm"] = simple(("self_attn.q_norm.weight",), False)
                layers["k_norm"] = simple(("self_attn.k_norm.weight",), False)
        if cfg.attention_bias:
            for name, (suffixes, t) in _BIAS_MAP.items():
                layers[name] = simple(suffixes, t)
        if moe:
            e = cfg.num_experts
            layers["router"] = simple(_MOE_ROUTER, True)
            if cfg.moe_router_bias:
                # The correction bias competes with sigmoid scores at O(1e-2)
                # margins: kept f32, as HF keeps it, never the compute dtype.
                layers["router_bias"] = simple(_MOE_ROUTER_BIAS, False, dtype=torch.float32)
            for name, (suffixes, t) in _MOE_EXPERT_MAP.items():
                shp = index.shape(_find(index, suffixes, l0, 0))[::-1]
                layers[name] = _LazyLeaf(
                    index, (count, e, *shp),
                    lambda li, s=suffixes, t=t: [(_find(index, s, li + l0, ei), t) for ei in range(e)],
                    expert_axis=True)
            if cfg.shared_expert_size:
                for name, (suffixes, t) in _SHARED_EXPERT_MAP.items():
                    layers[name] = simple(suffixes, t)
                if cfg.shared_expert_gated:
                    layers["shared_gate"] = simple(_SHARED_GATE, True)
        else:
            for name in ("w_gate", "w_up", "w_down"):
                layers[name] = simple(_LAYER_MAP[name][0], True)
        return layers

    k_dense = cfg.first_k_dense if cfg.is_moe else 0
    moe = cfg.is_moe and any(f"model.layers.{k_dense}.{c}" in index for c in _MOE_ROUTER)
    params: dict[str, Any] = {
        "embed": _TopLeaf(index, "model.embed_tokens.weight", False),
        "norm_f": _TopLeaf(index, "model.norm.weight", False),
        "layers": subtree(k_dense, cfg.num_layers - k_dense, moe),
    }
    if k_dense:
        params["dense_layers"] = subtree(0, k_dense, False)
    if not cfg.tie_embeddings:
        # A config that says untied over a checkpoint that ties reuses the embeddings.
        head = "lm_head.weight" if "lm_head.weight" in index else "model.embed_tokens.weight"
        params["lm_head"] = _TopLeaf(index, head, True)
    return params


def _leaves(tree: dict):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def _consumed_names(specs: dict) -> set[str]:
    """Every checkpoint tensor the spec tree will read."""
    names: set[str] = set()
    for leaf in _leaves(specs):
        names |= leaf.names()
    return names


# Buffers some exporters serialize that carry no weights.
_IGNORABLE = ("rotary_emb.inv_freq", "masked_bias", ".attn.bias")


class _RenamedIndex:
    """View over a CheckpointIndex translating canonical Llama names
    (``model.X`` / ``lm_head.weight``) to a VLM checkpoint's language-model
    subtree: the post-refactor ``model.language_model.X`` (+ top-level
    ``lm_head.weight``) and the legacy ``language_model.model.X`` (+
    ``language_model.lm_head.weight``). Vision and projector tensors are
    hidden from ``keys()``, so the strict leftover check applies to the LM
    subtree only."""

    def __init__(self, index: CheckpointIndex) -> None:
        self._index = index
        self._legacy = any(k.startswith("language_model.model.") for k in index.keys())

    def _translate(self, name: str) -> str:
        if self._legacy:
            if name == "lm_head.weight":
                return "language_model.lm_head.weight"
            if name.startswith("model."):
                return "language_model." + name
            return name
        if name.startswith("model."):
            return "model.language_model." + name[len("model."):]
        return name

    def keys(self) -> list[str]:
        out = []
        for k in self._index.keys():
            if self._legacy and k.startswith("language_model.model."):
                out.append("model." + k[len("language_model.model."):])
            elif self._legacy and k == "language_model.lm_head.weight":
                out.append("lm_head.weight")
            elif k.startswith("model.language_model."):
                out.append("model." + k[len("model.language_model."):])
            elif k == "lm_head.weight" and not self._legacy:
                out.append(k)
        return out

    def __contains__(self, name: str) -> bool:
        return self._translate(name) in self._index

    def shape(self, name: str) -> tuple[int, ...]:
        return self._index.shape(self._translate(name))

    def read(self, name: str) -> torch.Tensor:
        return self._index.read(self._translate(name))


def load_params(
    model_dir: str | pathlib.Path,
    cfg: ModelConfig,
    *,
    device: str | torch.device = "cuda",
    dtype: torch.dtype | None = None,
    strict: bool = True,
    index: Any | None = None,
) -> Params:
    """Load the port's parameters from an HF-style safetensors checkpoint
    onto ``device`` (the card unless the caller asks for the CPU), every leaf
    in ``dtype`` (default: the config's). Each layer's tensor is read, cast
    and copied into its stacked leaf on its own, so host memory holds one
    per-layer tensor at a time.

    ``strict`` (default) fails on checkpoint tensors the mapping would
    silently drop: a model whose weights are partially ignored looks like a
    working deployment while generating garbage."""
    dev = resolve_device(device)
    target = dtype or _DTYPES[cfg.dtype]
    index = index if index is not None else CheckpointIndex(model_dir)
    specs = _leaf_specs(index, cfg)
    if strict:
        consumed = _consumed_names(specs)
        leftover = [n for n in index.keys()
                    if n not in consumed and not any(n.endswith(sfx) for sfx in _IGNORABLE)]
        if leftover:
            raise ValueError(
                f"checkpoint has {len(leftover)} tensors the {cfg.name!r} mapping would "
                f"silently drop (first few: {leftover[:6]}); the architecture config and "
                f"checkpoint disagree — pass strict=False only if this is intentional"
            )

    def load(node):
        if isinstance(node, dict):
            return {k: load(v) for k, v in node.items()}
        return node.load(dev, target)

    return load(specs)


def load_model(
    model_dir: str | pathlib.Path,
    *,
    device: str | torch.device = "cuda",
    dtype: torch.dtype | None = None,
    name: str | None = None,
) -> tuple[ModelConfig, Params]:
    """Resolve an HF model directory: config.json -> ModelConfig, weights ->
    parameters on ``device``."""
    p = pathlib.Path(model_dir)
    cfg = ModelConfig.from_hf(p / "config.json", name=name or p.name)
    if dtype is not None:
        import dataclasses

        cfg = dataclasses.replace(cfg, dtype={v: k for k, v in _DTYPES.items()}[dtype])
    return cfg, load_params(p, cfg, device=device, dtype=dtype)


# ---------------------------------------------------------------------------
# The reverse writer
# ---------------------------------------------------------------------------


def hf_config(cfg: ModelConfig) -> dict[str, Any]:
    """The ``config.json`` dict ``save_params`` writes for ``cfg`` (the JAX
    writer's keys, ``dynamo_tpu/models/loader.py:save_params``)."""
    hf: dict[str, Any] = {
        "architectures": ["LlamaForCausalLM"],
        "model_type": "llama",
        "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.hidden_size,
        "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads,
        "head_dim": cfg.head_dim,
        "intermediate_size": cfg.intermediate_size,
        "rope_theta": cfg.rope_theta,
        "rms_norm_eps": cfg.rms_eps,
        "max_position_embeddings": cfg.max_position,
        "tie_word_embeddings": cfg.tie_embeddings,
        "torch_dtype": cfg.dtype,
    }
    if cfg.rope_scaling:
        hf["rope_scaling"] = cfg.rope_scaling
    hf["attention_bias"] = cfg.attention_bias
    if cfg.qk_norm:
        # qk_norm is reconstructed from model_type at load (from_hf).
        if cfg.qk_norm == "head":
            hf["model_type"] = "qwen3_moe" if cfg.is_moe else "qwen3"
            hf["architectures"] = ["Qwen3MoeForCausalLM" if cfg.is_moe else "Qwen3ForCausalLM"]
        else:
            hf["model_type"], hf["architectures"] = "olmoe", ["OlmoeForCausalLM"]
    gemma_family = cfg.norm_plus_one or cfg.mlp_act == "gelu_tanh" or cfg.embed_scale
    if gemma_family:
        hf["model_type"], hf["architectures"] = "gemma", ["GemmaForCausalLM"]
        hf["hidden_activation"] = "gelu_pytorch_tanh"
    if cfg.attn_type == "mla":
        hf.update(
            model_type="deepseek_v3",
            architectures=["DeepseekV3ForCausalLM"],
            q_lora_rank=cfg.q_lora_rank or None,
            kv_lora_rank=cfg.kv_lora_rank,
            qk_nope_head_dim=cfg.qk_nope_head_dim,
            qk_rope_head_dim=cfg.qk_rope_head_dim,
            v_head_dim=cfg.v_head_dim,
            rope_interleave=cfg.rope_interleave,
        )
    if cfg.is_moe:
        if cfg.attn_type != "mla" and not cfg.qk_norm:
            # MLA pinned deepseek_v3; qk_norm pinned qwen3_moe/olmoe above.
            hf["model_type"] = "qwen2_moe" if cfg.shared_expert_gated or not cfg.shared_expert_size else "deepseek_v2"
        hf.update(
            num_experts=cfg.num_experts,
            num_experts_per_tok=cfg.num_experts_per_token,
            moe_intermediate_size=cfg.moe_intermediate_size,
            scoring_func=cfg.moe_scoring,
            norm_topk_prob=cfg.moe_norm_topk,
            routed_scaling_factor=cfg.moe_routed_scaling,
        )
        if cfg.moe_n_group:
            hf.update(n_group=cfg.moe_n_group, topk_group=cfg.moe_topk_group)
        if cfg.moe_router_bias:
            hf["topk_method"] = "noaux_tc"
        if cfg.first_k_dense:
            hf["first_k_dense_replace"] = cfg.first_k_dense
        if cfg.shared_expert_size:
            if cfg.shared_expert_gated:
                hf["shared_expert_intermediate_size"] = cfg.shared_expert_size
            else:
                hf["n_shared_experts"] = cfg.shared_expert_size // cfg.moe_intermediate_size
    return hf


def _hf_tensors(cfg: ModelConfig, params: Params) -> list[tuple[str, tuple]]:
    """``(hf name, (shape, dtype, fn))`` for every tensor of the checkpoint,
    in the JAX writer's order; ``fn`` builds the tensor (transposed to
    ``[out, in]``, rope rows interleaved) only when it is written."""
    out: list[tuple[str, tuple]] = []
    gemma_family = cfg.norm_plus_one or cfg.mlp_act == "gelu_tanh" or cfg.embed_scale
    shift_norms = gemma_family and not cfg.norm_plus_one

    def put(name: str, fn, transpose: bool, row_perm: np.ndarray | None = None, zero_center: bool = False) -> None:
        def build():
            a = fn()
            if zero_center:  # HF Gemma stores zero-centered norm weights
                a = (a.float() - 1.0).to(a.dtype)
            if transpose:
                a = a.T
            if row_perm is not None:  # half-split -> checkpoint (interleaved) order
                a = a[torch.from_numpy(row_perm).to(a.device)]
            return a.contiguous()

        probe = fn()
        shape = tuple(probe.shape[::-1]) if transpose else tuple(probe.shape)
        out.append((name, (shape, probe.dtype, build)))

    put("model.embed_tokens.weight", lambda: params["embed"], False)
    put("model.norm.weight", lambda: params["norm_f"], False, zero_center=shift_norms)
    if not cfg.tie_embeddings and "lm_head" in params:
        put("lm_head.weight", lambda: params["lm_head"], True)
    q_sperm = kv_sperm = None
    if cfg.attn_type == "mla" and cfg.rope_interleave:
        q_sperm = rope_save_perm(cfg.num_heads, cfg.qk_nope_head_dim + cfg.qk_rope_head_dim, cfg.qk_rope_head_dim)
        kv_sperm = rope_save_perm(1, cfg.kv_lora_rank + cfg.qk_rope_head_dim, cfg.qk_rope_head_dim)

    def write_subtree(lp: dict, l0: int, count: int, moe: bool) -> None:
        for j in range(count):
            base = f"model.layers.{j + l0}."
            for leaf, (suffixes, transpose) in _LAYER_MAP.items():
                if (moe and leaf in _MOE_EXPERT_MAP) or (cfg.attn_type == "mla" and leaf in ("wq", "wk", "wv", "wo")):
                    continue
                put(base + suffixes[0], lambda leaf=leaf, j=j: lp[leaf][j], transpose,
                    zero_center=shift_norms and leaf in ("attn_norm", "mlp_norm"))
            if cfg.qk_norm and cfg.attn_type != "mla":
                put(base + "self_attn.q_norm.weight", lambda j=j: lp["q_norm"][j], False)
                put(base + "self_attn.k_norm.weight", lambda j=j: lp["k_norm"][j], False)
            if cfg.attn_type == "mla":
                for leaf, (suffixes, transpose) in _MLA_MAP.items():
                    if leaf in lp:
                        put(base + suffixes[0], lambda leaf=leaf, j=j: lp[leaf][j], transpose,
                            row_perm={"w_q_b": q_sperm, "w_q": q_sperm, "w_kv_a": kv_sperm}.get(leaf))

                def kv_b(j=j):
                    # kv_b_proj: interleave per-head [K_nope; V] row blocks.
                    uk, uv = lp["w_uk"][j], lp["w_uv"][j]  # [r_kv, H, dn], [r_kv, H, dv]
                    per_head = torch.cat([uk.permute(1, 2, 0), uv.permute(1, 2, 0)], dim=1)  # [H, dn+dv, r_kv]
                    return per_head.reshape(-1, per_head.shape[-1])

                put(base + "self_attn.kv_b_proj.weight", kv_b, False)
            if cfg.attention_bias:
                for leaf, (suffixes, transpose) in _BIAS_MAP.items():
                    put(base + suffixes[0], lambda leaf=leaf, j=j: lp[leaf][j], transpose)
            if moe:
                put(base + _MOE_ROUTER[0], lambda j=j: lp["router"][j], True)
                if "router_bias" in lp:
                    put(base + _MOE_ROUTER_BIAS[0], lambda j=j: lp["router_bias"][j], False)
                for leaf, (suffixes, transpose) in _MOE_EXPERT_MAP.items():
                    for e in range(cfg.num_experts):
                        put(base + suffixes[0].format(e=e), lambda leaf=leaf, j=j, e=e: lp[leaf][j, e], transpose)
                if cfg.shared_expert_size:
                    src = 0 if cfg.shared_expert_gated else 1
                    for leaf, (suffixes, transpose) in _SHARED_EXPERT_MAP.items():
                        put(base + suffixes[src], lambda leaf=leaf, j=j: lp[leaf][j], transpose)
                    if cfg.shared_expert_gated:
                        put(base + _SHARED_GATE[0], lambda j=j: lp["shared_gate"][j], True)

    k_dense = cfg.first_k_dense if cfg.is_moe else 0
    if k_dense:
        write_subtree(params["dense_layers"], 0, k_dense, False)
    write_subtree(params["layers"], k_dense, cfg.num_layers - k_dense, cfg.is_moe)
    return out


def save_params(
    model_dir: str | pathlib.Path,
    cfg: ModelConfig,
    params: Params,
    *,
    max_shard_bytes: int | None = None,
) -> list[str]:
    """Write ``params`` as an HF-compatible checkpoint: ``config.json``, the
    safetensors file(s) and ``model.safetensors.index.json``.

    The exact inverse of :func:`load_params`: unstack layers, transpose back
    to torch ``[out, in]`` orientation, emit HF Llama / DeepSeek names.
    ``max_shard_bytes`` splits the tensors, in order, into shards
    ``model-0000i-of-0000n.safetensors`` of at most that many bytes (a
    tensor larger than it gets a shard of its own); None writes one
    ``model.safetensors``. One tensor is in host memory at a time. Returns
    the files written."""
    p = pathlib.Path(model_dir)
    p.mkdir(parents=True, exist_ok=True)
    (p / "config.json").write_text(json.dumps(hf_config(cfg), indent=2))
    tensors = _hf_tensors(cfg, params)
    shards: list[list] = [[]]
    size = 0
    for name, spec in tensors:
        shape, dtype, _fn = spec
        nbytes = int(np.prod(shape, dtype=np.int64)) * torch.empty((), dtype=dtype).element_size()
        if max_shard_bytes is not None and shards[-1] and size + nbytes > max_shard_bytes:
            shards.append([])
            size = 0
        shards[-1].append((name, spec))
        size += nbytes
    n = len(shards)
    files = ["model.safetensors"] if n == 1 else [f"model-{i + 1:05d}-of-{n:05d}.safetensors" for i in range(n)]
    weight_map: dict[str, str] = {}
    total = 0
    for fname, shard in zip(files, shards):
        total += write_safetensors(p / fname, shard, metadata={"format": "pt"})
        weight_map.update({name: fname for name, _ in shard})
    (p / "model.safetensors.index.json").write_text(
        json.dumps({"metadata": {"total_size": total}, "weight_map": weight_map}))
    return files
