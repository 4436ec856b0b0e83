"""Engine runner: one paged forward + fused sampling per engine step
(counterpart of ``dynamo_tpu/engine/runner.py:ModelRunner``).

``TorchModelRunner`` owns the parameters and the paged KV cache on its
device and serves the seam ``EngineCore`` drives: ``step``, ``step_async``,
``can_chain``/``chain_len``/``reset_chain``, ``cfg``, ``io_lock`` and
``last_attn_dispatch``. Host arrays are padded onto the same bucket lattice
as the JAX build (batch and chunk length to powers of two, table width and
penalty history to powers of two), packed into one buffer (int32 fields,
then any constraint masks, bit-packed) and sent to the device in a single
copy from pinned memory; only the sampled token ids (and logprobs when
asked) come back, by one copy into pinned memory that a CUDA event closes.
The KV cache is updated in place by the forward.

On the card every step replays a CUDA graph, one per dispatch key — the
padded shapes ``(b, t, n, h)``, ``lp_k``, whether the step chains, and the
sampling branches it takes (a sampled row, penalties, a mask) — where the
JAX build runs one jitted program per key. A key is run once eagerly on a
side stream to warm it up, then captured at its first use; every graph
shares one memory pool; its inputs are a persistent device buffer per key,
filled outside the graph. A failed capture or replay raises: nothing falls
back to eager. The eager body runs only on the CPU, or on the card when the
runner is built with ``graphs=False`` (the comparison ``chip_smoke.py``
makes).

``step_async`` dispatches without waiting (the overlapped engine's depth-1
pipeline): its samples stay on the device in ``_chain_buf``, a runner-owned
buffer outside the graph pool, and the next dispatch may take each row's
input token from there in-graph (``_apply_chain``). ``DeviceStepTokens``
waits for the step's copy to host; two pinned buffers alternate, so a
harvest never reads one that the next copy is filling.

Speculative verify (``spec_step``, ``spec_step_async``,
``DeviceSpecTokens``) scores V = spec_k + 1 columns a row in one forward
and samples every column as the non-speculative step would after j
accepted tokens: logits flattened to ``[B*V]`` rows, column j drawing with
the fold counter ``sample_steps + j``, so acceptance on the host is a plain
prefix comparison. Its targets become the chain buffer, flat ``[B*V]``.
``multi_step`` runs a fused burst of decode steps in one dispatch, each
step's sample the next one's input. Each is a CUDA graph per dispatch key
on the card, V (or the burst length) in the key.

Constrained rows (``response_format: json_object``) carry their masks in
the packed input, bit-packed: a host-known mask (``logit_mask``, on a step
whose input tokens the host knows) or, on a chained step, one mask per
successor state of the row's token in flight (``la_masks``) and the
token -> group table (``la_groups``, in the narrowest integer the group
count allows); the step picks ``la_masks[i, la_groups[i, tokens[i, 0]]]`` on
the device once the chained token is gathered, as the JAX build's chained
program does. G's power-of-two bucket is in the dispatch key.

Page I/O for the KV tiers (``blocks/``): ``read_pages_async`` gathers pages
with one ``index_select`` on a stream of its own, fenced behind the last
``write_pages`` and ahead of every later step, and copies them into pinned
host memory (``InFlightPages.wait`` waits for that copy); ``write_pages``
scatters payloads back with one ``index_copy_`` on the steps' stream. A
payload is the page's bytes in the cache's ``[L, ps, W]`` layout as an
unsigned-integer view (numpy has no bf16 or e4m3). Page ids are padded to a
power-of-two bucket with the null page.

Not ported yet: ``embed``.
"""

from __future__ import annotations

import dataclasses
import gc
import threading
import time
from typing import Callable

import numpy as np
import torch

from dynamo_tpu_torch.device import resolve_device
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.models.mla import mla_cache_widths
from dynamo_tpu_torch.ops import build
from dynamo_tpu_torch.ops.attention import CACHE_DTYPES, NEG_INF, attention_phase, noncontiguous_rows
from dynamo_tpu_torch.ops.grouped_matmul import grouped_matmul_supported
from dynamo_tpu_torch.ops.paged_decode import decode_kernel_supported
from dynamo_tpu_torch.ops.paged_mla import paged_mla_supported
from dynamo_tpu_torch.ops.paged_prefill import prefill_kernel_supported
from dynamo_tpu_torch.ops.quant_matmul import group_size as quant_group_size
from dynamo_tpu_torch.ops.quant_matmul import is_quantized, quant_matmul_supported
from dynamo_tpu_torch.ops.sampling import CANDIDATES, gumbel_noise, sample_tokens, token_logprobs


# One CUDA-graph capture at a time in the process (the runners of several
# workers share it): entering and leaving a capture synchronizes the device,
# which another thread's capture in flight forbids.
_CAPTURE_LOCK = threading.Lock()


def next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def _apply_chain(tokens, history, sample_steps, chain_buf, chain_src):
    """Per-row device-resident token sourcing for a chained dispatch
    (``dynamo_tpu/engine/runner.py:_apply_chain``).

    ``chain_src`` i32[B] holds, per row, an index into ``chain_buf`` (the
    previous dispatch's device-resident samples) or -1 for host-fed rows.
    Chained rows' column-0 input token is gathered on the device; host-fed
    rows keep their host token. The gathered token is also written into the
    penalty ``history`` at ``sample_steps - 1``: a chained row's host history
    lacks exactly the one in-flight token it chains, and that token is the
    gathered value; for host-fed rows the write stores what is already
    there. Returns new ``(tokens, history)``."""
    src = chain_src.clamp(0, chain_buf.shape[0] - 1).long()
    gathered = chain_buf[src]
    chained = chain_src >= 0
    tokens = torch.cat([torch.where(chained, gathered, tokens[:, 0])[:, None], tokens[:, 1:]], dim=1)
    idx = (sample_steps - 1).clamp(0, history.shape[1] - 1).long()[:, None]
    cur = history.gather(1, idx)[:, 0]
    history = history.scatter(1, idx, torch.where(chained, gathered, cur)[:, None])
    return tokens, history


@dataclasses.dataclass
class StepBatch:
    """Host-side arrays describing one engine step (pre-padding)."""

    tokens: np.ndarray  # i32[B, T]
    positions: np.ndarray  # i32[B, T]
    block_tables: np.ndarray  # i32[B, N]
    slot_mapping: np.ndarray  # i32[B, T]
    last_token_index: np.ndarray  # i32[B]
    temperature: np.ndarray  # f32[B]
    top_k: np.ndarray  # i32[B]
    top_p: np.ndarray  # f32[B]
    seeds: np.ndarray  # u32[B]
    sample_steps: np.ndarray  # i32[B] — rng counter (monotonic per request)
    freq_pen: np.ndarray  # f32[B] — OpenAI frequency_penalty
    pres_pen: np.ndarray  # f32[B] — OpenAI presence_penalty
    pos_limit: np.ndarray  # i32[B] first absolute position KV must never be written at
    history: np.ndarray  # i32[B, H] generated tokens so far, pad -1 (H=1 when no penalties)
    logit_mask: np.ndarray | None = None  # bool[B, vocab] allowed tokens (None = all)
    # Constrained decoding on a chained step: one-step-lookahead mask groups
    # (``dynamo_tpu/engine/runner.py:StepBatch``). Row i samples under
    # la_masks[i, la_groups[i, tokens[i, 0]]], taken on the device after the
    # chain gather; group 0 is all-True. Excludes logit_mask; needs a chain.
    # The masks come bit-packed (``pack_masks`` of the JAX build's bool[B, G, vocab]).
    la_masks: np.ndarray | None = None  # u8[B, G, ceil(vocab/8)]
    la_groups: np.ndarray | None = None  # i32[B, vocab] (or any narrower integer)
    # Speculative verify: each row's first verify column (0 for decode rows,
    # n-1 for prefill-chunk rows, which score only their last column).
    spec_start: np.ndarray | None = None  # i32[B]

    @property
    def batch_size(self) -> int:
        return self.tokens.shape[0]


def _to_device(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


class DeviceStepTokens:
    """Handle to one dispatched step's sampled tokens and optional logprob
    arrays (``dynamo_tpu/engine/runner.py:DeviceStepTokens``): the copy to
    host is already enqueued; ``result()`` waits for it (a CUDA event) and
    returns ``(tokens i32[B_real, W], lp_aux | None)``, W = 1 for a step (a
    burst's W is its length, with no logprobs)."""

    per_column = False  # logprob arrays [B] / [B, k] (a verify's: [B, V] / [B, V, k])

    def __init__(self, host: torch.Tensor, event, b_real: int, bp: int, lp_k: int, width: int = 1) -> None:
        self._host = host  # int32: tokens [bp*W], then chosen, top_ids, top_lps (f32 as bits)
        self._event = event  # None on the CPU: host already holds the values
        self._b_real, self._bp, self._lp_k, self._w = b_real, bp, lp_k, width
        self._value = None

    def result(self) -> tuple[np.ndarray, dict | None]:
        if self._value is None:
            if self._event is not None:
                self._event.synchronize()
            flat, b, k, w = self._host.numpy(), self._b_real, self._lp_k, self._w
            n = self._bp * w
            toks = flat[:n].reshape(-1, w)[:b].copy()
            aux = None
            if k:
                rows = (-1, w) if self.per_column else (-1,)
                aux = {
                    "logprob": flat[n:2 * n].view(np.float32).reshape(rows)[:b].copy(),
                    "top_ids": flat[2 * n:2 * n + n * k].reshape(*rows, k)[:b].copy(),
                    "top_lps": flat[2 * n + n * k:2 * n * (1 + k)].view(np.float32).reshape(*rows, k)[:b].copy(),
                }
            self._value = (toks, aux)
            self._host = None  # the pinned buffer goes back to the runner
        return self._value


class DeviceSpecTokens(DeviceStepTokens):
    """Handle to a dispatched speculative verify's targets
    (``dynamo_tpu/engine/runner.py:DeviceSpecTokens``): ``result()`` returns
    ``(targets i32[B_real, V], lp_aux | None)`` with per-column logprob
    arrays ``[B_real, V]`` / ``[B_real, V, k]``, the values
    :meth:`TorchModelRunner.spec_step` returns."""

    per_column = True


@dataclasses.dataclass
class _Graph:
    """One captured dispatch key: the graph, its static outputs (``(packed
    int32 results, draw tensors)``) and the kernel launches its capture
    recorded, counted again at every replay."""

    graph: object
    outputs: tuple
    launches: dict


@dataclasses.dataclass
class _Slot:
    """One of the two alternating pinned host buffers of the pipeline: the
    packed step inputs (reusable once ``staged`` completes) and the results
    (handed out through ``handle``)."""

    stage: torch.Tensor | None = None
    staged: torch.cuda.Event | None = None
    out: torch.Tensor | None = None
    handle: DeviceStepTokens | None = None


def _pinned(n: int, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(next_pow2(n), dtype=dtype, pin_memory=True)


# Lookahead groups are padded to a power of two of at least this many: fewer
# dispatch keys (each a graph to capture) for a few more bytes of packed masks.
MIN_GROUPS = 8


def pack_masks(masks: np.ndarray) -> np.ndarray:
    """bool[..., vocab] -> the bit-packed u8[..., ceil(vocab/8)] the runner
    ships (bit i of byte j is token 8j+i)."""
    return np.packbits(masks, axis=-1, bitorder="little")


def _group_dtype(groups: int) -> tuple[np.dtype, torch.dtype]:
    """The narrowest integer that holds ``groups`` lookahead group ids."""
    if groups <= 256:
        return np.dtype(np.uint8), torch.uint8
    if groups <= 1 << 15:
        return np.dtype(np.int16), torch.int16
    return np.dtype(np.int32), torch.int32


def _unpack_bits(packed: torch.Tensor, vocab: int) -> torch.Tensor:
    """bool[..., vocab] from ``np.packbits(..., bitorder="little")`` bytes."""
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed.unsqueeze(-1) >> shifts) & 1
    return bits.reshape(*packed.shape[:-1], -1)[..., :vocab].bool()


# Payload views: a page's bytes as numpy carries them (numpy has neither bf16
# nor e4m3), by element size; torch views through the signed type of that size.
_PAYLOAD_VIEWS = {1: (torch.uint8, np.uint8), 2: (torch.int16, np.uint16), 4: (torch.int32, np.uint32)}


def _bits(t: torch.Tensor) -> torch.Tensor:
    """``t``'s bytes as the signed integer of its element size (index_select
    and index_copy_ take every such type; not every float type, e4m3 among them)."""
    return t.view(_PAYLOAD_VIEWS[t.element_size()][0])


def _payload_to_host(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(_PAYLOAD_VIEWS[t.element_size()][1])


class InFlightPages:
    """Handle to a dispatched page gather whose copy to host is in flight
    (``dynamo_tpu/engine/runner.py:InFlightPages``)."""

    def __init__(self, k: torch.Tensor | None, v: torch.Tensor | None, n: int, event=None) -> None:
        self._k, self._v, self._n = k, v, n  # host [Np, L, ps, W] (page-major); pinned on the card
        self._event = event  # recorded after the copies (None on the CPU)

    @property
    def num_pages(self) -> int:
        return self._n

    def wait(self) -> list[tuple[np.ndarray, np.ndarray]]:
        """Block until the pages are on the host; returns ``[(k, v), ...]``
        per page, ``[L, ps, W]`` each as an unsigned-integer view of the
        cache dtype, the padding sliced off."""
        if self._n == 0:
            return []
        if self._event is not None:
            self._event.synchronize()
        k, v = _payload_to_host(self._k), _payload_to_host(self._v)
        return [(k[i].copy(), v[i].copy()) for i in range(self._n)]


class TorchModelRunner:
    """Owns device state (params + paged KV cache) and runs engine steps."""

    def __init__(
        self,
        cfg: ModelConfig,
        params: llama.Params,
        *,
        num_pages: int,
        page_size: int,
        max_batch_size: int = 64,
        prefill_bucket: int = 64,
        cache_dtype: torch.dtype | None = None,
        device: str | torch.device = "cuda",
        graphs: bool | None = None,
        verify_width: int = 1,
    ) -> None:
        """``verify_width`` sizes the device-resident sample buffer for
        verify dispatches of that many columns (``spec_k + 1``); a wider
        one grows it, and the graphs captured before are captured again."""
        self.device = resolve_device(device)
        llama.check_supported(cfg)
        self.cfg = cfg
        self.num_pages = num_pages
        self.page_size = page_size
        self.max_batch_size = max_batch_size
        self.prefill_bucket = prefill_bucket
        # Held by every entry point that touches the KV cache (step, step_async).
        self.io_lock = threading.RLock()
        # (phase, path) of the most recent dispatch — phase in {decode,
        # verify, prefill}, path "kernel" on the card (every phase of a GQA
        # or MLA model runs in a kernel there) or "plain" on the CPU.
        # EngineCore consumes it into its dispatch-path counters.
        self.last_attn_dispatch: tuple[str, str] | None = None
        # Host seconds spent in dispatches (packing, the input copy, a graph
        # replay or the eager body's launches, a first capture included):
        # EngineCore reads the difference over a step as its dispatch_ms.
        self.dispatch_seconds_total = 0.0
        self._attn_path = "kernel" if self.device.type == "cuda" else "plain"
        # CUDA graphs: always on the card unless the caller asks for the
        # eager body; never on the CPU.
        self.graphs = self.device.type == "cuda" if graphs is None else graphs
        if self.graphs and self.device.type != "cuda":
            raise ValueError("CUDA graphs need the card: pass graphs=False (or nothing) with device='cpu'")
        dt = cache_dtype or llama.param_dtype(cfg)
        if dt not in CACHE_DTYPES:
            raise ValueError(f"unsupported KV cache dtype {dt} (want {', '.join(map(str, CACHE_DTYPES))})")
        if self.device.type == "cuda":
            self._check_kernels_take(cfg, dt, page_size)
            self._check_quantized_take(cfg, params)
            self._check_experts_take(cfg)
        self.params = _to_device(params, self.device)
        self.k_cache, self.v_cache = llama.init_kv_cache(
            cfg, num_pages, page_size, dtype=dt, device=self.device
        )
        self._inv_freq = llama.rope_table(cfg, self.device)
        # The latest async dispatch's samples, one per padded batch row (a
        # verify's: row * V + column), and how many of them are live (0:
        # nothing to chain from).
        self._chain_buf = torch.zeros(max_batch_size * max(1, verify_width), dtype=torch.int32, device=self.device)
        self._chain_rows = 0
        self._inputs: dict[tuple, torch.Tensor] = {}  # key -> its device input buffer
        self._slots = [_Slot(), _Slot()]
        self._slot = 0
        # Called after every dispatch with the padded host batch and the
        # step's draw tensors (``_body``): the sampled-from logits, the
        # Gumbel noise (None when no row samples), the tokens and, with
        # penalties, the history and penalty arrays the sampler read. The
        # tensors are the step's own (under replay, a graph's static
        # outputs), valid until the next dispatch: copy what you keep.
        self.draw_hook: Callable[[StepBatch, dict], None] | None = None
        self._graphs: dict[tuple, _Graph] = {}
        self.capture_seconds = 0.0
        # Page reads run on a stream of their own (a gather need not wait for
        # a step in flight: the pages the engine reads were written by steps
        # it has harvested); ``_kv_fence`` is recorded after each page write,
        # which a later read waits for.
        self._io_stream = torch.cuda.Stream(self.device, priority=-1) if self.device.type == "cuda" else None
        self._kv_fence = None
        if self.graphs:
            self._pool = torch.cuda.graph_pool_handle()
            self._side = torch.cuda.Stream(self.device)
            self._warm_chain = torch.empty_like(self._chain_buf)  # the warm-up's samples go here

    def _ensure_chain(self, n: int) -> None:
        """Grow the sample buffer to hold ``n`` samples, keeping the samples
        it holds (the dispatch that grows it may chain from them). The
        graphs captured so far read and write the old buffer, so they are
        dropped and captured again at their next use."""
        if n <= self._chain_buf.numel():
            return
        grown = torch.zeros(next_pow2(n), dtype=torch.int32, device=self.device)
        grown[:self._chain_buf.numel()].copy_(self._chain_buf)
        self._chain_buf = grown
        self._graphs.clear()
        if self.graphs:
            self._warm_chain = torch.empty_like(self._chain_buf)

    @staticmethod
    def _check_kernels_take(cfg: ModelConfig, cache_dtype: torch.dtype, page_size: int) -> None:
        """On the card every step's attention runs in a kernel (``paged_mla``
        for an MLA model, the decode and prefill kernels for GQA; their fp8
        forms for an fp8 cache); refuse a model whose geometry or cache type
        they do not take before allocating anything."""
        kw = dict(q_dtype=llama.param_dtype(cfg), cache_dtype=cache_dtype)
        if cfg.attn_type == "mla":
            r_kv, r_width = mla_cache_widths(cfg)
            if not paged_mla_supported(cfg.num_heads, r_kv, r_width, cfg.qk_rope_head_dim, page_size, **kw):
                raise NotImplementedError(
                    f"the paged MLA kernel does not take heads={cfg.num_heads}, kv_lora_rank={r_kv}, "
                    f"qk_rope_head_dim={cfg.qk_rope_head_dim}, page size {page_size}, cache {cache_dtype}"
                )
            return
        w = cfg.num_kv_heads * cfg.head_dim
        if not (decode_kernel_supported(cfg.num_heads, cfg.head_dim, w, **kw)
                and prefill_kernel_supported(cfg.num_heads, cfg.head_dim, w, **kw)):
            raise NotImplementedError(
                f"the paged-attention kernels do not take heads={cfg.num_heads}/{cfg.num_kv_heads}, "
                f"head_dim={cfg.head_dim}, cache {cache_dtype}"
            )

    @staticmethod
    def _check_experts_take(cfg: ModelConfig) -> None:
        """On the card a MoE model's expert products run in the grouped
        kernel (``w_gate``/``w_up``: hidden -> expert width, ``w_down``: the
        reverse); refuse a geometry or dtype it does not take before
        allocating anything."""
        if not cfg.is_moe:
            return
        d, f, e, dt = cfg.hidden_size, cfg.moe_intermediate_size, cfg.num_experts, llama.param_dtype(cfg)
        if not (grouped_matmul_supported(d, f, e, dt) and grouped_matmul_supported(f, d, e, dt)):
            raise NotImplementedError(
                f"the grouped_matmul kernel does not take {e} experts of {d} x {f} ({dt})")

    @staticmethod
    def _check_quantized_take(cfg: ModelConfig, params: llama.Params) -> None:
        """On the card every quantized projection runs in the quant_matmul
        kernel; refuse a leaf whose geometry or types it does not take
        before allocating anything (layer-stacked leaves: the last two axes
        are K x N; the head's output is f32)."""
        def walk(tree, name):
            if not isinstance(tree, dict):
                return
            if not is_quantized(tree):
                for k, v in tree.items():
                    walk(v, k)
                return
            packed = "qw4" in tree
            qw = tree["qw4" if packed else "qw"]
            k, n = qw.shape[-2] * (2 if packed else 1), qw.shape[-1]
            mode, group = ("int4", quant_group_size(tree)) if packed else ("int8", 0)
            out = torch.float32 if name == "lm_head" else llama.param_dtype(cfg)
            if not quant_matmul_supported(k, n, mode=mode, group=group, x_dtype=llama.param_dtype(cfg),
                                          scale_dtype=tree["scale"].dtype, out_dtype=out):
                raise NotImplementedError(
                    f"the quant_matmul kernel does not take {name}: K={k}, N={n}, {mode}"
                    f"{f' group {group}' if group else ''}, scale {tree['scale'].dtype}, "
                    f"activations {llama.param_dtype(cfg)}"
                )

        walk(params, None)

    # -- bucketing (same lattice as the JAX runner) -------------------------

    def _bucket_batch(self, b: int) -> int:
        return min(next_pow2(b), max(self.max_batch_size, b))

    def _bucket_time(self, t: int) -> int:
        if t <= 1:
            return 1
        return min(next_pow2(t), max(self.prefill_bucket * ((t + self.prefill_bucket - 1) // self.prefill_bucket), t))

    def _bucket_pages(self, n: int) -> int:
        return max(1, next_pow2(n))

    def _pad(self, batch: StepBatch) -> StepBatch:
        """Pad ``batch`` onto the bucket lattice: pad rows carry zeros,
        position limit 0 (their writes land in the null page), top-p 1 and
        an empty penalty history."""
        b, t = batch.tokens.shape
        bp = self._bucket_batch(b)
        tp = self._bucket_time(t)
        np_ = self._bucket_pages(batch.block_tables.shape[1])
        hp = next_pow2(batch.history.shape[1])
        lmask = None
        if batch.logit_mask is not None:
            lmask = np.ones((bp, batch.logit_mask.shape[1]), bool)
            lmask[: batch.logit_mask.shape[0]] = batch.logit_mask
        la_m = la_g = None
        if batch.la_masks is not None:
            gb, g, row = batch.la_masks.shape
            # Pad rows and pad groups are all-True with group id 0: padding
            # samples stay unconstrained, as on the synchronous path.
            la_m = np.full((bp, max(MIN_GROUPS, next_pow2(g)), row), 0xFF, np.uint8)
            la_m[:gb, :g] = batch.la_masks
            la_g = np.zeros((bp, batch.la_groups.shape[1]), batch.la_groups.dtype)
            la_g[: batch.la_groups.shape[0]] = batch.la_groups

        def pad2(a, rows, cols, fill=0):
            out = np.full((rows, cols), fill, a.dtype)
            out[: a.shape[0], : a.shape[1]] = a
            return out

        def pad1(a, rows, fill=0):
            out = np.full((rows,), fill, a.dtype)
            out[: a.shape[0]] = a
            return out

        return StepBatch(
            tokens=pad2(batch.tokens, bp, tp),
            positions=pad2(batch.positions, bp, tp),
            block_tables=pad2(batch.block_tables, bp, np_),
            slot_mapping=pad2(batch.slot_mapping, bp, tp),
            last_token_index=pad1(batch.last_token_index, bp),
            temperature=pad1(batch.temperature, bp),
            top_k=pad1(batch.top_k, bp),
            top_p=pad1(batch.top_p, bp, fill=1.0),
            seeds=pad1(batch.seeds, bp),
            sample_steps=pad1(batch.sample_steps, bp),
            freq_pen=pad1(batch.freq_pen, bp),
            pres_pen=pad1(batch.pres_pen, bp),
            pos_limit=pad1(batch.pos_limit, bp),  # pad rows: limit 0 -> null page
            history=pad2(batch.history, bp, hp, fill=-1),
            logit_mask=lmask,
            la_masks=la_m,
            la_groups=la_g,
            spec_start=None if batch.spec_start is None else pad1(np.asarray(batch.spec_start, np.int32), bp),
        )

    # -- execution ---------------------------------------------------------

    def step(self, batch: StepBatch, lp_k: int = 0):
        """Run one forward+sample step; returns sampled token ids i32[B_real].

        Rows may carry different real token counts: a mixed step fuses
        1-token decode rows with prefill-chunk rows, each row's logits taken
        at its ``last_token_index``. ``lp_k > 0`` additionally returns
        ``{"logprob": f32[B], "top_ids": i32[B, k], "top_lps": f32[B, k]}``.
        The step overwrites the device-resident samples, so nothing can
        chain across it."""
        with self.io_lock:
            self._chain_rows = 0
            toks, aux = self._dispatch(batch, lp_k, None).result()
            return (toks[:, 0], aux) if lp_k else toks[:, 0]

    def step_async(self, batch: StepBatch, lp_k: int = 0, *, chain: bool = False,
                   chain_src: np.ndarray | None = None) -> DeviceStepTokens:
        """Dispatch ONE (possibly mixed prefill+decode) step without waiting
        for its result (``dynamo_tpu/engine/runner.py:step_async``).

        The sampled tokens stay on the device, so the next step can be
        dispatched with ``chain=True`` before this one's tokens reach the
        host: ``chain_src`` i32[B_real] names, per row, the row of this
        dispatch whose sample is its column-0 input token, or -1 to feed the
        row from the host (prefill chunks, fresh admissions); ``None`` with
        ``chain=True`` chains row i from row i. Returns a
        :class:`DeviceStepTokens` whose ``result()`` waits for the
        already-started copy to host."""
        with self.io_lock:
            src = self._chain_src_padded(chain_src, batch.batch_size, self._bucket_batch(batch.batch_size)) \
                if chain else None
            handle = self._dispatch(batch, lp_k, src)
            self._chain_rows = self._bucket_batch(batch.batch_size)
            return handle

    def spec_step(self, batch: StepBatch, verify_width: int, lp_k: int = 0):
        """Speculative verify dispatch (``dynamo_tpu/engine/runner.py:spec_step``):
        returns target tokens i32[B_real, V], with ``lp_k`` also per-column
        logprob arrays ``[B, V]`` / ``[B, V, k]``.

        ``batch`` is a mixed StepBatch whose decode rows carry draft tokens
        as extra real columns and whose ``spec_start`` names each row's first
        verify column (0 for decode rows, n-1 for prefill-chunk rows, which
        score only their last column exactly as :meth:`step` does). Verify
        columns past a row's real span clamp to its last column; the engine
        discards those duplicates. Column j of the result is the token the
        non-speculative engine would sample after accepting j draft tokens
        (fold counter ``sample_steps + j``)."""
        with self.io_lock:
            self._chain_rows = 0
            targets, aux = self._dispatch(batch, lp_k, None, kind="spec", width=verify_width).result()
            return (targets, aux) if lp_k else targets

    def spec_step_async(self, batch: StepBatch, verify_width: int, lp_k: int = 0, *,
                        chain_src: np.ndarray | None = None) -> DeviceSpecTokens:
        """Dispatch a speculative verify without waiting for its result
        (``dynamo_tpu/engine/runner.py:spec_step_async``). With ``chain_src``
        (see :meth:`step_async`) the decode rows' column-0 input token is
        taken on the device from the previous dispatch's samples. The
        verify's own targets become the chain buffer, flat ``[Bp*V]``
        row-major: the engine chains the next dispatch from index
        ``row * V + accepted columns - 1`` once acceptance is known."""
        with self.io_lock:
            bp = self._bucket_batch(batch.batch_size)
            src = self._chain_src_padded(chain_src, batch.batch_size, bp) if chain_src is not None else None
            handle = self._dispatch(batch, lp_k, src, kind="spec", width=verify_width)
            self._chain_rows = bp * verify_width
            return handle

    def multi_step(self, batch: StepBatch, num_steps: int) -> np.ndarray:
        """Fused decode burst (``dynamo_tpu/engine/runner.py:multi_step``):
        ``num_steps`` decode iterations in one dispatch, the sample of step i
        the input of step i+1, slots derived on the device from positions and
        tables (past a row's position limit the write lands in the null
        page); returns sampled tokens i32[B_real, num_steps]. ``batch`` is a
        decode batch (T == 1) whose tables cover positions + num_steps."""
        if batch.tokens.shape[1] != 1:
            raise ValueError("multi_step is decode-only (T == 1)")
        with self.io_lock:
            self._chain_rows = 0
            toks, _ = self._dispatch(batch, 0, None, kind="burst", width=num_steps).result()
            return toks

    def _chain_src_padded(self, chain_src, b_real: int, bp: int) -> np.ndarray:
        """Pad a per-row chain source vector to the batch bucket (-1 = host).

        ``chain_src=None`` with chaining requested means the whole-batch
        form: row i chains from row i of the previous dispatch."""
        src = np.full(bp, -1, np.int32)
        if chain_src is None:
            src[:b_real] = np.arange(b_real, dtype=np.int32)
        else:
            src[:b_real] = np.asarray(chain_src, np.int32)
        if int(src.max()) >= self._chain_rows:
            raise ValueError(f"chain_src points past the {self._chain_rows} device-resident samples")
        return src

    def can_chain(self, batch_size: int) -> bool:
        """True if a chained step of ``batch_size`` real rows lines up with
        the previous dispatch's padded samples."""
        return self._chain_rows > 0 and self._chain_rows == self._bucket_batch(batch_size)

    def chain_len(self) -> int:
        """Rows of the device-resident sample buffer (0 = nothing to chain)."""
        return self._chain_rows

    def reset_chain(self) -> None:
        self._chain_rows = 0

    # -- tier access (block manager offload/onboard) -----------------------

    def read_page(self, page_id: int) -> tuple[np.ndarray, np.ndarray]:
        """One page to the host: ``(k, v)``, ``[L, ps, W]`` each."""
        return self.read_pages([page_id])[0]

    def read_pages(self, page_ids: list[int]) -> list[tuple[np.ndarray, np.ndarray]]:
        """Batched copy to the host: one gather and one transfer for N pages."""
        return self.read_pages_async(page_ids).wait()

    def read_pages_async(self, page_ids: list[int]) -> InFlightPages:
        """Gather ``page_ids`` into a fresh buffer (ids padded to a power of
        two with the null page) and start its copy into pinned host memory,
        without waiting for it (``dynamo_tpu/engine/runner.py:read_pages_async``).

        On the card both run on the runner's I/O stream: it waits for the
        last :meth:`write_pages`, and the steps' stream waits for the gather
        before its next step, so a page can be written again only after it
        was read. A step in flight is not waited for: the engine reads only
        pages of steps it has harvested."""
        if not page_ids:
            return InFlightPages(None, None, 0)
        n = len(page_ids)
        ids = np.zeros(next_pow2(n), np.int64)
        ids[:n] = page_ids
        with self.io_lock:
            if self._io_stream is None:
                return InFlightPages(*self._gather(self._ids_to_device(ids)), n)
            main = torch.cuda.current_stream(self.device)
            with torch.cuda.stream(self._io_stream):
                if self._kv_fence is not None:
                    self._io_stream.wait_event(self._kv_fence)
                k, v = self._gather(self._ids_to_device(ids))
                gathered = torch.cuda.Event()
                gathered.record()
                k_host = torch.empty(k.shape, dtype=k.dtype, pin_memory=True)
                v_host = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                k_host.copy_(k, non_blocking=True)
                v_host.copy_(v, non_blocking=True)
                done = torch.cuda.Event()
                done.record()
            main.wait_event(gathered)
            return InFlightPages(k_host, v_host, n, done)

    def _ids_to_device(self, ids: np.ndarray) -> torch.Tensor:
        """Page ids to the device; to the card without waiting (a copy from
        pageable memory would first wait for the current stream's work, a
        step in flight among it)."""
        ids = torch.from_numpy(ids)
        return ids if self.device.type == "cpu" else ids.pin_memory().to(self.device, non_blocking=True)

    def _gather(self, idx: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The pages ``idx`` of both caches, page-major ``[N, L, ps, W]`` (each
        page one contiguous block for the host), as :func:`_bits` views."""
        return tuple(_bits(c).index_select(1, idx).transpose(0, 1).contiguous()
                     for c in (self.k_cache, self.v_cache))

    def write_page(self, page_id: int, k: np.ndarray, v: np.ndarray) -> None:
        """One page from the host (see :meth:`write_pages`)."""
        self.write_pages([page_id], [k], [v])

    def write_pages(self, page_ids: list[int], ks, vs) -> None:
        """Batched write from the host (``dynamo_tpu/engine/runner.py:write_pages``):
        one transfer and one in-place ``index_copy_`` scatter for N pages, on
        the steps' stream, so the next step reads them. ``ks``/``vs``: per-page
        arrays ``[L, ps, W]`` or stacks ``[L, N, ps, W]``: the payload's
        unsigned-integer view of the cache dtype (its bytes, bit for bit), as
        :meth:`read_pages` gives it. Padding writes land in the null page."""
        if not page_ids:
            return
        n = len(page_ids)
        ids = np.zeros(next_pow2(n), np.int64)
        ids[:n] = page_ids
        with self.io_lock:
            idx = self._ids_to_device(ids)
            for cache, pages in ((self.k_cache, ks), (self.v_cache, vs)):
                _bits(cache).index_copy_(1, idx, self._payload_to_device(pages, cache, len(ids)).transpose(0, 1))
            if self._io_stream is not None:
                self._kv_fence = torch.cuda.Event()
                self._kv_fence.record()

    def _payload_to_device(self, pages, cache: torch.Tensor, padded: int) -> torch.Tensor:
        """Host payloads -> the bytes of ``padded`` pages of the cache's dtype
        on the device (:func:`_bits`), page-major ``[padded, L, ps, W]``,
        each page copied once into a contiguous block of a pinned staging
        buffer on the card's side."""
        pages = list(pages) if isinstance(pages, (list, tuple)) else [pages[:, i] for i in range(pages.shape[1])]
        shape = (padded, *pages[0].shape)
        host = torch.zeros(shape, dtype=_PAYLOAD_VIEWS[cache.element_size()][0],
                           pin_memory=self.device.type == "cuda")
        staged = host.numpy()
        for i, page in enumerate(pages):
            page = np.asarray(page)
            if page.dtype.kind not in "ui" or page.dtype.itemsize != cache.element_size():
                raise ValueError(f"payload of {page.dtype} does not carry {cache.dtype} pages")
            staged[i] = page.view(staged.dtype)
        return host.to(self.device, non_blocking=True) if self.device.type == "cuda" else host

    def graph_stats(self) -> dict:
        """Captured keys, seconds spent warming up and capturing them, and
        the bytes the shared graph pool holds on the card."""
        pool = None
        if self.graphs:
            pool = sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                       if tuple(seg.get("segment_pool_id", ())) == tuple(self._pool))
        return {"keys": len(self._graphs), "capture_s": self.capture_seconds, "pool_bytes": pool}

    def _layout(self, key: tuple) -> tuple[list[int], int]:
        """The int32 fields of a key's packed input buffer, and its bytes:
        the fields, then a host mask's bits (``masked``), or the lookahead
        groups' table and their masks' bits (``groups`` > 0)."""
        kind, b, t, n, h, width, _, _, _, _, masked, groups = key
        sizes = [b * t, b * t, b * n, b * t] + [b] * 8 + [b * h, b, b, b * width if kind == "spec" else 0]
        return sizes, 4 * sum(sizes) + self._mask_layout(b, masked, groups)[-1]

    def _mask_layout(self, b: int, masked: bool, groups: int) -> tuple[int, int, int]:
        """Bytes of a key's mask section: (group table, packed masks, total)."""
        vocab = self.cfg.vocab_size
        row = -(-vocab // 8)
        if groups:
            table = b * vocab * _group_dtype(groups)[0].itemsize
            return table, b * groups * row, table + b * groups * row
        return 0, b * row if masked else 0, b * row if masked else 0

    def _dispatch(self, batch: StepBatch, lp_k: int, chain_src: np.ndarray | None, *,
                  kind: str = "step", width: int = 1) -> DeviceStepTokens:
        """Pack, copy and run one dispatch: ``kind`` "step" (one token a
        row), "spec" (a verify of ``width`` columns) or "burst" (``width``
        fused decode steps)."""
        t0 = time.perf_counter()
        b_real = batch.batch_size
        if b_real > self.max_batch_size:
            raise ValueError(f"a step of {b_real} rows exceeds max_batch_size {self.max_batch_size}")
        if kind != "step" and (batch.logit_mask is not None or batch.la_masks is not None):
            raise ValueError("constrained rows take plain steps (a verify or a burst carries no logit mask)")
        if batch.la_masks is not None and (chain_src is None or batch.logit_mask is not None):
            raise ValueError("lookahead mask groups resolve against a chained token; host-known tokens take "
                             "logit_mask")
        padded = self._pad(batch)
        b, t = padded.tokens.shape
        if t > 1 and kind == "step":
            bad = noncontiguous_rows(padded.positions)
            if bad:
                raise ValueError(f"step rows {bad} have non-contiguous positions")
        self.last_attn_dispatch = (attention_phase(t, kind != "spec"), self._attn_path)
        # Decided on the host: a captured step never reads a flag back.
        key = (kind, b, t, padded.block_tables.shape[1], padded.history.shape[1], width, lp_k,
               chain_src is not None, bool((padded.temperature > 0).any()),
               bool(padded.freq_pen.any() or padded.pres_pen.any()), padded.logit_mask is not None,
               0 if padded.la_masks is None else padded.la_masks.shape[1])
        samples = b * width if kind == "spec" else b
        self._ensure_chain(samples)
        sizes, nbytes = self._layout(key)
        n_out = samples * (2 + 2 * lp_k) if lp_k else b * width
        slot = self._take_slot(nbytes, n_out)
        host = slot.stage.numpy()[:nbytes] if slot.stage is not None else np.empty(nbytes, np.uint8)
        self._pack(host, padded, sizes, chain_src, width if kind == "spec" else 0)
        if self.device.type == "cpu":
            buf = torch.from_numpy(host)
        else:
            buf = self._inputs.get(key)
            if buf is None:
                buf = self._inputs[key] = torch.empty(nbytes, dtype=torch.uint8, device=self.device)
            buf.copy_(slot.stage[:nbytes], non_blocking=True)
            slot.staged = torch.cuda.Event()
            slot.staged.record()
        with torch.inference_mode():
            if self.graphs:
                graph = self._graphs.get(key) or self._capture(key, buf)
                graph.graph.replay()
                build.add_launches(graph.launches)
                packed_out, draw = graph.outputs
            else:
                packed_out, draw = self._body(buf, key, self._chain_buf)
        if self.draw_hook is not None and kind == "step":
            self.draw_hook(padded, draw)
        handle_cls = DeviceSpecTokens if kind == "spec" else DeviceStepTokens
        if self.device.type == "cpu":
            slot.handle = handle_cls(packed_out, None, b_real, b, lp_k, width)
        else:
            out = slot.out[:n_out]
            out.copy_(packed_out, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            slot.handle = handle_cls(out, done, b_real, b, lp_k, width)
        self.dispatch_seconds_total += time.perf_counter() - t0
        return slot.handle

    def _take_slot(self, nbytes: int, n_out: int) -> _Slot:
        """The next pipeline slot, once its previous use is over: its result
        materialized (waiting for that copy, long done in a depth-1
        pipeline) and its staged inputs copied; its pinned buffers grown to
        fit (on the card)."""
        self._slot ^= 1
        slot = self._slots[self._slot]
        if slot.handle is not None:
            slot.handle.result()
            slot.handle = None
        if self.device.type == "cuda":
            if slot.staged is not None:
                slot.staged.synchronize()
            if slot.stage is None or slot.stage.numel() < nbytes:
                slot.stage = _pinned(nbytes, torch.uint8)
            if slot.out is None or slot.out.numel() < n_out:
                slot.out = _pinned(n_out, torch.int32)
        return slot

    def _pack(self, host: np.ndarray, padded: StepBatch, sizes: list[int], chain_src: np.ndarray | None,
              verify_width: int = 0) -> None:
        """Write the padded batch into ``host`` (uint8, the key's layout)."""
        b = padded.tokens.shape[0]
        n_ints = sum(sizes)
        # Finish-line clamp: a column at/past its row's position limit writes
        # KV to the null page instead of a live slot.
        slots = np.where(padded.positions < padded.pos_limit[:, None], padded.slot_mapping, 0)
        # Verify columns: each row's from its spec_start on, clamped to its last real column.
        start = padded.spec_start if padded.spec_start is not None else np.zeros(b, np.int32)
        vi = np.minimum(start[:, None] + np.arange(verify_width, dtype=np.int32)[None, :],
                        padded.last_token_index[:, None])
        fields = [
            padded.tokens, padded.positions, padded.block_tables, slots, padded.last_token_index,
            padded.temperature.astype(np.float32).view(np.int32), padded.top_k,
            padded.top_p.astype(np.float32).view(np.int32), padded.seeds.astype(np.uint32).view(np.int32),
            padded.sample_steps, padded.freq_pen.astype(np.float32).view(np.int32),
            padded.pres_pen.astype(np.float32).view(np.int32), padded.history,
            chain_src if chain_src is not None else np.full(b, -1, np.int32), padded.pos_limit, vi,
        ]
        ints = host[:4 * n_ints].view(np.int32)
        off = 0
        for size, a in zip(sizes, fields):
            ints[off:off + size] = np.asarray(a).reshape(-1)
            off += size
        tail = host[4 * n_ints:]
        if padded.logit_mask is not None:
            tail[:] = pack_masks(padded.logit_mask).reshape(-1)
        elif padded.la_masks is not None:
            narrow = _group_dtype(padded.la_masks.shape[1])[0]
            table = padded.la_groups.astype(narrow, copy=False).reshape(-1).view(np.uint8)
            tail[:table.size] = table
            tail[table.size:] = padded.la_masks.reshape(-1)

    def _capture(self, key: tuple, buf: torch.Tensor) -> _Graph:
        """Warm ``key`` up eagerly on a side stream (first launches build
        and load the kernels, raise their shared-memory limits and encode
        their tensor maps: none of that may happen inside a capture), then
        capture it into the shared pool. The warm-up writes the same KV the
        replay writes and keeps its samples apart, so the replay that
        follows computes this step from the same state."""
        t0 = time.perf_counter()
        main = torch.cuda.current_stream(self.device)
        self._side.wait_stream(main)
        with torch.cuda.stream(self._side):
            self._body(buf, key, self._warm_chain)
        main.wait_stream(self._side)
        graph = torch.cuda.CUDAGraph()
        # thread_local: another worker's thread may run its own steps
        # meanwhile, but not a capture of its own (_CAPTURE_LOCK). The cyclic
        # collector is held off while capturing: a collection the capture's
        # own allocations set off would free a released runner's graphs on
        # this thread, which a capture forbids (it invalidates the capture).
        # Its state is read and restored under the lock, so a capture that
        # waited on another one never reads that one's disabled state.
        with _CAPTURE_LOCK:
            collecting = gc.isenabled()
            gc.disable()
            try:
                with build.capture_launches() as tally, \
                        torch.cuda.graph(graph, pool=self._pool, capture_error_mode="thread_local"):
                    outputs = self._body(buf, key, self._chain_buf)
            finally:
                if collecting:
                    gc.enable()
        captured = self._graphs[key] = _Graph(graph, outputs, tally)
        self.capture_seconds += time.perf_counter() - t0
        return captured

    def _body(self, buf: torch.Tensor, key: tuple, chain_out: torch.Tensor) -> tuple[torch.Tensor, dict]:
        """The step itself, from the device input buffer to the packed int32
        results: chain, forward, sample, logprobs. Writes the samples into
        ``chain_out``. Copies nothing to or from the host and branches only
        on ``key``, so it can be captured."""
        kind, b, t, n, h, width, lp_k, chain, sampled, penalized, masked, groups = key
        sizes, _ = self._layout(key)
        ints = buf[:4 * sum(sizes)].view(torch.int32)
        (tokens, positions, tables, slot_mapping, last_idx, temperature, top_k, top_p, seeds, sample_steps,
         freq_pen, pres_pen, history, chain_src, pos_limit, verify_idx) = torch.split(ints, sizes)
        tokens, positions, slot_mapping = tokens.view(b, t), positions.view(b, t), slot_mapping.view(b, t)
        tables, history = tables.view(b, n), history.view(b, h)
        temperature, top_p = temperature.view(torch.float32), top_p.view(torch.float32)
        freq_pen, pres_pen = freq_pen.view(torch.float32), pres_pen.view(torch.float32)
        if chain:
            tokens, history = _apply_chain(tokens, history, sample_steps, self._chain_buf, chain_src)
        if kind == "burst":
            return self._burst(width, tokens[:, 0], positions[:, 0], tables, pos_limit, temperature, top_k, top_p,
                               seeds, sample_steps, freq_pen, pres_pen, history, sampled, penalized, chain_out)
        if kind == "spec":
            logits, _, _ = llama.forward(
                self.params, self.cfg, tokens, positions, self.k_cache, self.v_cache, tables, slot_mapping,
                last_idx, logit_indices=verify_idx.view(b, width), contiguous_positions=False,
                inv_freq=self._inv_freq,
            )
            logits = logits.reshape(b * width, -1)  # row b*V + j: column j of row b
            # Column j draws with the fold counter the non-speculative engine
            # reaches after accepting j tokens; every other input is its row's.
            cols = torch.arange(width, device=ints.device, dtype=torch.int32)
            sample_steps = (sample_steps[:, None] + cols[None, :]).reshape(-1)
            seeds, temperature, top_k, top_p, freq_pen, pres_pen, history = (
                x.repeat_interleave(width, dim=0)
                for x in (seeds, temperature, top_k, top_p, freq_pen, pres_pen, history))
        else:
            logits, _, _ = llama.forward(
                self.params, self.cfg, tokens, positions, self.k_cache, self.v_cache,
                tables, slot_mapping, last_idx, inv_freq=self._inv_freq,
            )
        sample_logits = logits
        if masked or groups:
            # Constrained rows: disallowed tokens never sample; logprobs stay
            # on the raw logits (the model's distribution), as in the JAX build.
            vocab, off = self.cfg.vocab_size, 4 * sum(sizes)
            table, bits, _ = self._mask_layout(b, masked, groups)
            packed = buf[off + table:off + table + bits]
            if groups:
                # The row's group at its input token, read after the chain
                # gather: the token the host did not know at compose time.
                rows = torch.arange(b, device=buf.device)
                group_of = buf[off:off + table].view(_group_dtype(groups)[1]).view(b, vocab)
                g = group_of[rows, tokens[:, 0].long()].long()
                mask = _unpack_bits(packed.view(b, groups, -1)[rows, g], vocab)
            else:
                mask = _unpack_bits(packed.view(b, -1), vocab)
            sample_logits = torch.where(mask, logits, NEG_INF)
        gumbel = gumbel_noise(seeds, sample_steps, temperature, min(CANDIDATES, logits.shape[-1])) \
            if sampled else None
        pen = dict(history=history, frequency_penalty=freq_pen, presence_penalty=pres_pen) if penalized else {}
        next_tokens = sample_tokens(sample_logits, temperature, top_k, top_p, gumbel=gumbel,
                                    all_greedy=not sampled, **pen)
        chain_out[:next_tokens.shape[0]].copy_(next_tokens)
        packed = next_tokens
        if lp_k:
            chosen, top_ids, top_lps = token_logprobs(logits, next_tokens, lp_k)
            packed = torch.cat([next_tokens, chosen.view(torch.int32), top_ids.reshape(-1),
                                top_lps.reshape(-1).view(torch.int32)])
        return packed, {"logits": sample_logits, "gumbel": gumbel, "tokens": next_tokens, **pen}

    def _burst(self, steps, tok, pos, tables, pos_limit, temperature, top_k, top_p, seeds, cnt, freq_pen,
               pres_pen, history, sampled, penalized, chain_out) -> tuple[torch.Tensor, dict]:
        """``steps`` fused decode iterations (the JAX build's ``_multi_step``
        scan, unrolled): each writes its KV at a slot taken from the tables
        (the null page past the row's position limit), samples with fold
        counter ``cnt`` and feeds its sample to the next; the burst's own
        samples join the penalty history. Returns the tokens ``[B, steps]``
        row-major."""
        ps = self.page_size
        zeros = torch.zeros_like(tok)
        outs = []
        for _ in range(steps):
            col = (pos // ps).clamp(max=tables.shape[1] - 1).long()
            slot = tables.gather(1, col[:, None])[:, 0] * ps + pos % ps
            slot = torch.where(pos < pos_limit, slot, 0)
            logits, _, _ = llama.forward(
                self.params, self.cfg, tok[:, None], pos[:, None], self.k_cache, self.v_cache,
                tables, slot[:, None], zeros, inv_freq=self._inv_freq,
            )
            gumbel = gumbel_noise(seeds, cnt, temperature, min(CANDIDATES, logits.shape[-1])) if sampled else None
            pen = dict(history=history, frequency_penalty=freq_pen, presence_penalty=pres_pen) if penalized else {}
            nxt = sample_tokens(logits, temperature, top_k, top_p, gumbel=gumbel, all_greedy=not sampled, **pen)
            if penalized:
                write = cnt.clamp(max=history.shape[1] - 1).long()[:, None]
                history = history.scatter(1, write, nxt[:, None])
            outs.append(nxt)
            tok, pos, cnt = nxt, pos + 1, cnt + 1
        chain_out[:tok.shape[0]].copy_(tok)
        toks = torch.stack(outs, dim=1)
        return toks.reshape(-1), {"tokens": toks}
