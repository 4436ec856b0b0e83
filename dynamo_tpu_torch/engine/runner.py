"""Engine runner: one paged forward + fused sampling per engine step
(counterpart of ``dynamo_tpu/engine/runner.py:ModelRunner``).

``TorchModelRunner`` owns the parameters and the paged KV cache on its
device and serves the seam ``EngineCore`` drives: ``step``, ``cfg``,
``io_lock`` and ``last_attn_dispatch``. Host arrays are padded onto the
same bucket lattice as the JAX build (batch and chunk length to powers of
two, table width to a power of two), packed into one int32 buffer and sent
to the device in a single copy; only the sampled token ids come back. The
KV cache is updated in place by the forward.

Not ported yet: ``step_async``, ``spec_step``, ``multi_step``,
``read_page(s)``, ``write_page(s)`` and ``embed``.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch

from dynamo_tpu_torch.device import resolve_device
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.models.mla import mla_cache_widths
from dynamo_tpu_torch.ops.attention import CACHE_DTYPES, NEG_INF, attention_phase, noncontiguous_rows
from dynamo_tpu_torch.ops.paged_decode import decode_kernel_supported
from dynamo_tpu_torch.ops.paged_mla import paged_mla_supported
from dynamo_tpu_torch.ops.paged_prefill import prefill_kernel_supported
from dynamo_tpu_torch.ops.sampling import CANDIDATES, gumbel_noise, sample_tokens, token_logprobs


def next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


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

    @property
    def batch_size(self) -> int:
        return self.tokens.shape[0]


def _to_device(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


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
    ) -> None:
        self.device = resolve_device(device)
        llama.check_supported(cfg)
        self.cfg = cfg
        self.num_pages = num_pages
        self.page_size = page_size
        self.max_batch_size = max_batch_size
        self.prefill_bucket = prefill_bucket
        # Held by every entry point that touches the KV cache (today: step).
        self.io_lock = threading.RLock()
        # (phase, path) of the most recent dispatch — phase in {decode,
        # verify, prefill}, path "kernel" on the card (every phase of a GQA
        # or MLA model runs in a kernel there) or "plain" on the CPU.
        # EngineCore consumes it into its dispatch-path counters.
        self.last_attn_dispatch: tuple[str, str] | None = None
        self._attn_path = "kernel" if self.device.type == "cuda" else "plain"
        dt = cache_dtype or llama.param_dtype(cfg)
        if dt not in CACHE_DTYPES:
            raise ValueError(f"unsupported KV cache dtype {dt} (want {', '.join(map(str, CACHE_DTYPES))})")
        if self.device.type == "cuda":
            self._check_kernels_take(cfg, dt, page_size)
        self.params = _to_device(params, self.device)
        self.k_cache, self.v_cache = llama.init_kv_cache(
            cfg, num_pages, page_size, dtype=dt, device=self.device
        )

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
        b, t = batch.tokens.shape
        bp = self._bucket_batch(b)
        tp = self._bucket_time(t)
        np_ = self._bucket_pages(batch.block_tables.shape[1])
        hp = next_pow2(batch.history.shape[1])
        lmask = None
        if batch.logit_mask is not None:
            lmask = np.ones((bp, batch.logit_mask.shape[1]), bool)
            lmask[: batch.logit_mask.shape[0]] = batch.logit_mask

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
        )

    # -- execution ---------------------------------------------------------

    def step(self, batch: StepBatch, lp_k: int = 0):
        """Run one forward+sample step; returns sampled token ids i32[B_real].

        Rows may carry different real token counts: a mixed step fuses
        1-token decode rows with prefill-chunk rows, each row's logits taken
        at its ``last_token_index``. ``lp_k > 0`` additionally returns
        ``{"logprob": f32[B], "top_ids": i32[B, k], "top_lps": f32[B, k]}``."""
        with self.io_lock:
            return self._step(batch, lp_k)

    def _step(self, batch: StepBatch, lp_k: int):
        b_real = batch.batch_size
        padded = self._pad(batch)
        b, t = padded.tokens.shape
        if t > 1:
            bad = noncontiguous_rows(padded.positions)
            if bad:
                raise ValueError(f"step rows {bad} have non-contiguous positions")
        self.last_attn_dispatch = (attention_phase(t, True), self._attn_path)
        # Finish-line clamp: a column at/past its row's position limit writes
        # KV to the null page instead of a live slot.
        slots = np.where(padded.positions < padded.pos_limit[:, None], padded.slot_mapping, 0)
        n = padded.block_tables.shape[1]
        packed = np.concatenate([
            padded.tokens.ravel(), padded.positions.ravel(), padded.block_tables.ravel(),
            slots.astype(np.int32).ravel(), padded.last_token_index.astype(np.int32),
            padded.temperature.astype(np.float32).view(np.int32),
            padded.top_k.astype(np.int32), padded.top_p.astype(np.float32).view(np.int32),
            padded.seeds.astype(np.uint32).view(np.int32), padded.sample_steps.astype(np.int32),
        ])
        dev = torch.from_numpy(packed).to(self.device)
        sizes = [b * t, b * t, b * n, b * t, b, b, b, b, b, b]
        parts = torch.split(dev, sizes)
        tokens = parts[0].view(b, t)
        positions = parts[1].view(b, t)
        tables = parts[2].view(b, n)
        slot_mapping = parts[3].view(b, t)
        last_idx = parts[4]
        temperature = parts[5].view(torch.float32)
        top_k = parts[6]
        top_p = parts[7].view(torch.float32)
        seeds, sample_steps = parts[8], parts[9]
        with torch.inference_mode():
            logits, _, _ = llama.forward(
                self.params, self.cfg, tokens, positions, self.k_cache, self.v_cache,
                tables, slot_mapping, last_idx,
            )
            sample_logits = logits
            if padded.logit_mask is not None:
                mask = torch.from_numpy(padded.logit_mask).to(self.device)
                sample_logits = torch.where(mask, logits, NEG_INF)
            gumbel = None
            if (padded.temperature > 0).any():
                width = min(CANDIDATES, logits.shape[-1])
                gumbel = gumbel_noise(seeds, sample_steps, temperature, width)
            pen = {}
            if padded.freq_pen.any() or padded.pres_pen.any():
                pen = dict(
                    history=torch.from_numpy(padded.history.astype(np.int32)).to(self.device),
                    frequency_penalty=torch.from_numpy(padded.freq_pen.astype(np.float32)).to(self.device),
                    presence_penalty=torch.from_numpy(padded.pres_pen.astype(np.float32)).to(self.device),
                )
            next_tokens = sample_tokens(sample_logits, temperature, top_k, top_p, gumbel=gumbel, **pen)
            if lp_k:
                chosen, top_ids, top_lps = token_logprobs(logits, next_tokens, lp_k)
                # .cpu() waits for this thread's stream: the kernels ran there.
                return next_tokens.cpu().numpy()[:b_real], {
                    "logprob": chosen.cpu().numpy()[:b_real],
                    "top_ids": top_ids.cpu().numpy()[:b_real],
                    "top_lps": top_lps.cpu().numpy()[:b_real],
                }
            return next_tokens.cpu().numpy()[:b_real]
