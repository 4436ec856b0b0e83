#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``dynamo_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, one JSON line each (with ``t_s``, seconds since the start); any
failure exits non-zero:

1. build    — compile every CUDA kernel of the serving paths from ``csrc/``,
              one nvcc per source, all started together; every wgmma
              instantiation of paged_prefill and paged_mla, bf16 and fp8,
              must compile without register spills (nvcc's report per
              instantiation is on the line).
   fp8_casts, sampling — the fp8 cache write (``to_fp8_like_jax``) on
              the card bitwise the CPU's over all 65,536 bf16 patterns, the
              kernels' on-chip e4m3 -> bf16 conversion over all 256 codes;
              seeded sampling's threefry words, Gumbel noise and tokens on
              the card against the CPU's draw.
2. kernels  — hold each kernel against its plain PyTorch version. GQA
              (paged_decode, paged_prefill): the llama-3.2-1b (32/8 heads,
              hd 64), llama-3-8b (32/8, hd 128) and a GQA group of 8
              (64/8, hd 64) geometries, bf16 also on pages of 12 (no TMA
              box, page lookups by division) and 24 (TMA, division), decode
              also at T_q 8 (two and four 16-row tiles). MLA
              (paged_mla, phase "kernels_mla", ``mla_kernel_checks``): the
              mla-8b-proxy (32 heads, latent 512, rope 64) and
              test-mla-kernel (4 heads, latent 128, rope 64) geometries in
              bf16 and f32, bf16 also on pages of 8 (the 8-row TMA box) and
              4 (cp.async), and ``MLA_PATHS``, the bf16 kernel's other
              paths (ropes of 32, 80, 128 and 512 lanes, a rope stream
              narrower than a box, f32 queries on bf16 pages): ragged
              lengths, -1 table tails, splits 1, 2 and auto, gappy T_q 1, 4,
              8 (and 20 at 4 heads), prefill chunks with start > 0 and mixed
              1-token rows; the bitwise T_q=1 / verify-column check; a mixed
              step at each serve phase's shape. Then, at the main paths'
              shapes, each kernel is held against its plain version once
              more and timed (CUDA-graph replay between CUDA events, median
              of repeats) beside its bound, the plain version's time, one
              PyTorch library call's (MLA: ``folded_sdpa``, its backend
              named), the device µs of each CUDA kernel it launches and the
              wrapper's host µs per call; the GQA kernels also at hd 128
              (llama-3-8b's 32/8 heads), both prefill kernels also at the
              serve's mixed-step shape. Every comparison is per row,
              relative to the row's largest plain output. The fp8 forms
              (phases "kernels_fp8", "kernels_mla_fp8") the same way on
              fp8 caches with bf16 and f32 queries (``fp8_kernel_checks``,
              ``fp8_mla_kernel_checks``), with at least 264 and 1164
              bitwise verify columns (paged_mla's unsplit verify rows run
              in a share group of 2 row tiles, a cluster that converts each
              key tile once, their T_q=1 columns in none), and
              ``share_soak``: thousands of back-to-back paged_mla launches
              in share groups, each bitwise the first; timed beside bf16
              (each entry's ``vs_bf16`` ratio), with no library yardstick
              (none attends over fp8 K/V). paged_decode past 32 query
              tokens ("kernels_wide_verify", ``wide_verify_checks``): T_q
              33, 64, 512 and 2048, gappy and contiguous rows, bf16 and fp8,
              hd 64 and 128, with the bitwise T_q=1 / verify-column check;
              timed at the spec serve's verify and widened mixed verify
              steps beside paged_prefill on the same rows
              ("kernel_timing_wide_verify").
3. forward  — one prefill and one decode step at full width, with the
              kernels and with plain attention, same inputs; logits
              compared: llama-3.2-1b, then mla-8b-proxy, each on a bf16 and
              an fp8 cache; plain attention is the gather reference but
              for mla-8b-proxy on fp8, where it is the kernels' plain
              versions.
   graphs   — CUDA-graph replay against the eager step (``graph_check``):
              two runners on the same weights, graphs and eager, take the
              same prefill, mixed and two decode steps (the graph runner's
              decode rows chained on the card through ``step_async``);
              tokens, logprobs and top-20 alternatives bitwise equal, for
              each model on a bf16 cache and llama-3.2-1b on fp8 too; and
              (``spec_graph_check``, "graphs_spec") a verify of 5 columns,
              chained, and a 4-step ``multi_step`` burst, bitwise equal.
4. serve    — ``build_engine_service`` (random init, bf16 weights) behind
              ``build_pipeline``: 8 concurrent OpenAI completion requests,
              prompts of 16..1500 tokens, 32 tokens each, after a warm-up
              request and an untimed pass of a mix of other prompts; the
              model's kernels' launch counts (counted through graph
              replays) must be > 0, every engine step's attention must have
              run in a kernel, and a mixed step must occur. Each mix is
              served twice (``serve_both``): by the eager runner behind the
              synchronous engine, then by the main path, CUDA graphs behind
              the overlapped engine, whose steps must overlap; greedy tokens
              bitwise equal between the two; both modes' tok/s, graph keys,
              capture seconds, graph-pool bytes and overlapped / barrier
              steps reported. llama-3.2-1b (paged_decode, paged_prefill),
              then, after it is freed, mla-8b-proxy (paged_mla); each on a
              bf16 and an fp8 cache (launch counts ``<kernel>_fp8``). Every
              draw the card makes for the mix's seeded request is replayed
              on the CPU (``record_draws`` reads it through the runner's
              ``draw_hook``; ``replay_draws``): tokens equal.
5. http     — ``launch.run_local``: two llama-3.2-1b workers (same seed
              as phase 4, the main path: graphs, overlapped engine) behind
              the KV router and the OpenAI frontend on a free port.
              /v1/models, /health and /metrics; phase 4's mix
              as 8 concurrent streamed completions over aiohttp (every
              stream ends with [DONE], finish "length", 32 tokens; both
              kernels launch, every step's attention in a kernel, a mixed
              step in a worker); two bursts, the second sent once the
              router sees the first's worker busy, so both workers must
              step while the first decodes; a 100-token prompt sent twice,
              the repeat routed to the worker holding its blocks with >= 32
              cached tokens; one greedy body alone on a cold worker, whose
              tokens (each position's logprob and top-5 alternatives,
              bitwise) and text must equal a cold in-process service's;
              one worker closed while the other serves a request, which
              must finish. Reports HTTP tok/s, TTFT and ITL (SSE arrival
              times) beside phase 4's, and one uncached request's times
              alone on the warm server, over HTTP and in-process.

6. spec     — speculative decoding and decode bursts (``spec_phase``):
              a mix of repeated spans served with spec_k 4 (llama-3.2-1b on
              bf16 and fp8 caches, mla-8b-proxy on bf16; the main path, and
              llama-3.2-1b bf16 eager + synchronous too) and with
              decode_steps 4 (llama-3.2-1b, overlapped and synchronous),
              each beside the plain serve of the same mix in the same mode;
              every step's attention in a kernel, verify steps in the
              decode kernel, drafts accepted, and every greedy token within
              TF_LOGIT_TOL of an eager forward's argmax over the request's
              prompt + output (the teacher-forced check).
7. checkpoint — llama-3.2-1b's serve-phase weights saved as an HF
              checkpoint (safetensors shards, an index, config.json, a
              SentencePiece tokenizer.model), loaded back bitwise with
              ``load_model``, and served from the directory through
              ``run_local``: every position's logprobs equal the preset's.
8. quant    — weight-only quantized weights (``quant_kernel_checks``,
              phase "kernels_quant"): ``quant_matmul`` against its plain
              version at every quantized leaf the slice serves
              (``QUANT_SHAPES``: llama-3-8b, mla-8b-proxy with its
              576-column edge, llama-3-70b; int8, int4 at group 128, int4
              with and without qbias at group 32 with f32 scales as a GGUF
              import holds them), at M 1, 5, 8, 16, 17, 64, 512 and 2051
              (both forms of the kernel, each side of their switch), bf16
              and f32 out, per row; every
              product launched twice, bitwise equal; and x = I_K, whose
              products are the weight elements themselves, bitwise the plain
              dequantization. Timed ("kernel_timing_quant") at llama-3-8b's
              w_gate and w_down and llama-3-70b's 8192 x 28672 at M 8, 64,
              512 and 2048, and the head's product at M 8 (int8, f32 out),
              the weights cycled through copies that exceed the L2, beside
              the bound, the plain version and cuBLAS on the pre-dequantized
              bf16 weight, each with the form and plan it took; the build
              line lists every quant_matmul instantiation's registers and
              spills (a spill fails the build phase). Then
              (``quant_serve_phase``) llama-3-8b served at bf16 (main path),
              then at int8 and int4 and mla-8b-proxy at int8, each random-init
              directly quantized: a forward check (quant_matmul and
              attention kernels against plain versions), a graph check and
              the mix eager + sync then graphs + overlap (greedy tokens
              equal; quant_matmul launched exactly once per quantized
              projection and forward); llama-3-70b at int4 at full width and
              depth on the one card: resident weight GB, a forward check,
              one main-path serve and the peak allocated memory ("big_model").
9. gguf     — llama-3.2-1b written by the port's GGUF writer at Q4_K (the
              blocks encoded on the card, held byte for byte against the
              CPU's encoding), imported with ``load_gguf_params(quantize=
              "int4")``, and served from the file through
              ``run_local(path, quantize="int4")``: its leaves bitwise the
              import's, its config the preset's, every position's logprobs
              equal an in-process serve of the imported leaves.

10. constrained — constrained decoding (``constrained_phase``): the serve
              mix with its four greedy even requests asking for
              ``response_format: json_object``, on llama-3.2-1b, prefix
              caching off (the untimed pass is the timed mix, so the timed
              pass replays its graphs): graphs + overlap at
              DYN_CONSTRAINT_LOOKAHEAD_TOKENS 32 and 0, eager +
              synchronous, and the same mix without json_mode; with the
              byte tokenizer on bf16 and fp8 caches and the SentencePiece
              model of phase 7 on bf16. Every constrained output parses
              (random weights: the force-close), greedy tokens are equal
              across the modes, a lookahead step is chained; barriers by
              reason, mask-cache hits, misses and build seconds, the mask
              bytes a constrained step ships (and the JAX build's unpacked
              layout's), graph keys and tok/s beside the plain mix. Then
              four json_object chat requests over ``run_local``'s HTTP
              frontend, the launcher's warm-up thread on: all parse.
11. tiers   — the G2/G3 KV tiers (``tiers_phase``): ``read_pages`` /
              ``write_pages`` of 64 pages on bf16 and fp8 caches (round
              trip and the cache's pages bitwise, GB/s); a prompt set
              sharing a 1024-token prefix (1280–2048 tokens) served, pushed
              out of a 256-page pool by four other 2048-token prompts, and
              served again, one request at a time, its repeat a G1 hit (a
              roomy pool), onboarded from G2 and from G3 (a temporary
              directory), synchronously and in the background
              (``async_onboard``), or recomputed (prefix caching off), on
              bf16 (G1 and G2 on fp8 too): pages offloaded and onboarded by
              tier, the shortfall, repeat TTFT by way, the async sessions'
              overlap and stall steps; every onboarded repeat's greedy
              tokens equal the G1 hit's; every async repeat opens a
              background session, and one more, sent beside a live decode
              row, onboards while that row's steps run (overlap steps > 0);
              the G1 hit's and recompute's tokens pass the teacher-forced
              check (recompute's may part from the G1 hit's at a near-tie).
              Page reads and every way's flushes split into dispatch, copy
              wait, per-page host copies, tier puts and disk writes. Then
              the serve mix profiled with every committed page written
              through to G2 and without tiers: the device busy share, tok/s
              and the flushes' split seconds.
12. slo     — the SLO admission plane, cache-aware admission and routing,
              the flight recorder, fault points and spans (``slo_phase``),
              every part through ``run_local`` over HTTP on llama-3.2-1b,
              bf16, graphs + overlap, with phase 4's weights. (a) 16
              1024-token requests of tenant "heavy" at priority 2, then 50
              ms later 8 128-token requests of tenant "light" at priority
              0, 32 tokens each, max_batch_size 8: served with the plane
              off, then with DYN_SLO_SCHED=1 and DYN_TENANT_QUOTAS capping
              heavy at 4096 live prompt tokens; each way untimed, timed
              (TTFT p50 / p99 per tier, tok/s, graph keys captured, the
              chunk budgets seen) and under the profiler (device busy
              share); with the plane on every stream ends with its 32
              tokens, heavy's live prompt tokens never pass 4096 and it is
              throttled, no heavy request is admitted ahead of a waiting
              light one, every greedy token passes the teacher-forced check,
              and the host µs of ``admission.prepare`` a step are reported.
              (d) on that stack a request with a ``traceparent`` leaves
              engine_queue_wait, engine_admission_wait, engine_first_token
              and engine_request under its trace; (c) DYN_FAULTS=
              engine.step:crash@12 with DYN_FLIGHT_DUMP_DIR: one STEP record
              per engine step before the crash, one CRASH record, a JSONL
              dump equal to the ring, both in-flight streams ending in an
              error, nothing left live, the next request served;
              ``sched.admit:delay`` holds admission back 0.2 s. (b)
              DYN_SLO_SCHED, DYN_CACHE_AWARE, DYN_ASYNC_ONBOARD and a G2 tier
              behind a 320-page pool: a 2048-token prompt served, sent again
              beside four cold 512-token prompts (a G1 hit), pushed out of G1
              by three more, and sent beside four other cold ones: its
              admission step's STEP record with cached_frac > 0, its quota
              charge the residual, its tokens the G1 hit's, an
              engine_onboard_wait span; then two workers behind the KV
              router with the cache-aware term: every repeat of a warm
              prefix goes to the worker holding it (decisions and costs
              printed).

13. moe     — routed MoE (``moe_phase``): ``grouped_matmul`` against its
              plain version (a loop of torch.matmul over the experts) at
              olmoe-1b-7b's, deepseek-v2-lite's and qwen3-30b-a3b's expert
              products, both directions, 8 and 512 tokens, uniform, skewed
              and one-expert routings, per row, two launches bitwise
              ("kernels_moe"); timed at olmoe's w_gate and w_down with 8, 64,
              512 and 2048 tokens beside the touched experts' bound, the plain
              version, ``torch._grouped_mm`` and the host µs a call
              ("kernel_timing_moe"); paged_decode and paged_prefill at
              olmoe's 16/16 heads (a 16-row decode tile carries one query
              row). olmoe-1b-7b at full width: a forward check against the
              plain grouped product and reference attention, a graph check,
              the mix eager + sync then graphs + overlap on bf16 and fp8
              caches (greedy tokens equal, MoE steps captured,
              grouped_matmul launched three times a MoE layer and forward,
              the device's busy share over one more profiled pass, peak
              GB); deepseek-v2-lite (MLA, shared experts, a dense first
              layer) and qwen3-30b-a3b (61 GB of bf16 weights) served on the
              main path with their weight and peak GB; deepseek-r1-distill-8b,
              qwen2.5-7b and qwen3-8b a forward check and a serve each.

Then the kernels line (quant_matmul_int8 and quant_matmul_int4 timed at
llama-3-8b's w_gate at M = 8, their launches summed over the quantized
main-path serves; grouped_matmul timed at olmoe's w_gate with 8 tokens, its
launches summed over olmoe's two main-path serves), the card's name and power limit, and the last line
``{"ok": true, "device": {...}}``. Imports nothing of JAX or ``dynamo_tpu``.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import contextlib
import dataclasses
import gc
import importlib
import json
import os
import pathlib
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOPS = 989e12  # dense bf16 tensor-core peak
FP8 = torch.float8_e4m3fn  # the fp8 KV cache (launch --kv-cache-dtype fp8)
MODEL = "llama-3.2-1b"
MLA_MODEL = "mla-8b-proxy"
QUANT_MODEL, BIG_MODEL = "llama-3-8b", "llama-3-70b"  # quantized serves (BIG_MODEL at int4 on one card)
MOE_MODEL, MOE_MLA_MODEL, MOE_BIG_MODEL = "olmoe-1b-7b", "deepseek-v2-lite", "qwen3-30b-a3b"
DENSE_PRESETS = ("deepseek-r1-distill-8b", "qwen2.5-7b", "qwen3-8b")
GQA_KERNELS = ("paged_decode", "paged_prefill")
SERVE_KERNELS = {MODEL: GQA_KERNELS, MLA_MODEL: ("paged_mla",), QUANT_MODEL: GQA_KERNELS, BIG_MODEL: GQA_KERNELS,
                 MOE_MODEL: GQA_KERNELS + ("grouped_matmul",), MOE_MLA_MODEL: ("paged_mla", "grouped_matmul"),
                 MOE_BIG_MODEL: GQA_KERNELS + ("grouped_matmul",), **{m: GQA_KERNELS for m in DENSE_PRESETS}}
FP8_FORMS = ("paged_decode", "paged_prefill", "paged_mla")  # kernels with an fp8-cache form (launches_fp8)
# MLA geometries: heads, latent (kv_lora_rank), rope lanes, rope stream width, nope dim.
MLA_GEOMS = {"mla-8b-proxy": (32, 512, 64, 128, 128), "test-mla-kernel": (4, 128, 64, 128, 32)}
# Per row: max |kernel - plain| <= REL_TOL * max |plain| over the row's real
# columns (reasons in compare).
REL_TOL = {torch.float32: 2**-14, torch.bfloat16: 2**-6}
SERVE_LENGTHS = [16, 40, 100, 250, 500, 800, 1200, 1500]  # prompt tokens, BOS included
SERVE_ENGINE = dict(num_pages=2048, max_batch_size=16)
# A mixed step of the serve phases' shape, (start, real tokens) per row of a
# 512-token bucket: a chunk after 1024 cached tokens, a whole chunk from 0,
# a short last chunk, and 1-token decode rows (start = kv_len - 1).
MIXED_SPANS = [(1024, 512), (0, 512), (1400, 100), (1530, 1), (799, 1), (15, 1), (250, 1), (1199, 1)]
SOAK_LAUNCHES = 3000  # share_soak: back-to-back paged_mla launches of each shape


_T0 = time.perf_counter()


def emit(obj: dict) -> None:
    """One phase's JSON line, with the seconds since the script started."""
    print(json.dumps({**obj, "t_s": round(time.perf_counter() - _T0, 1)}), flush=True)


def compare(name: str, got: torch.Tensor, want: torch.Tensor, rows, dtype: torch.dtype) -> float:
    """Hold a kernel's output against its plain version row by row, over each
    row's real columns ``rows = [(b, n), ...]``; returns the max abs error.

    The limit is relative to the row's own largest output, so a long row
    whose outputs are small (a softmax over thousands of keys averages its
    values down to ~0.05) is held as tightly as a short one. bf16: both sides
    round their outputs to bf16, one ulp apart at most, and an ulp is at most
    2**-7 of the row's largest value; 2**-6 is two ulps. f32: both sides
    accumulate in f32 in different orders; 2**-14 leaves ~100x room over the
    disagreement that order alone gives, and still fails a row that lost a
    64-key block (a change of a few percent)."""
    worst = 0.0
    for b, n in rows:
        g, w = got[b, :n].float(), want[b, :n].float()
        err, ref = float((g - w).abs().max()), float(w.abs().max())
        if not err <= REL_TOL[dtype] * ref:
            raise AssertionError(f"{name}: row {b}: max abs err {err} exceeds {REL_TOL[dtype]} * "
                                 f"max|plain| {ref} ({dtype})")
        worst = max(worst, err)
    return worst


def time_ms(fn, *, iters: int, repeats: int = 7) -> float:
    """Device time of one call: ``iters`` calls captured in a CUDA graph, the
    graph replayed ``repeats`` times between CUDA events; the median replay
    over ``iters``. Replay launches no Python, so the host's per-call
    overhead (wrapper checks, allocation, ctypes) is not in the number."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture (allocator, lazy loading)
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    samples = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        samples.append(start.elapsed_time(end) / iters)
    del graph
    return statistics.median(samples)


def device_us_by_kernel(fn, calls: int = 10) -> dict:
    """Device time per call of each CUDA kernel ``fn`` launches, by kernel
    name (``torch.profiler``; the function's name without its namespace,
    template arguments and parameters)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = re.search(r"(\w+)\s*[<(]", e.name.replace("(anonymous namespace)::", "")).group(1)
            out[name] = out.get(name, 0.0) + (e.time_range.end - e.time_range.start) / calls
    return out


def busy_us(kernels) -> float:
    """The union of the intervals of profiler ``kernels`` (µs): the time the
    device was busy."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((k.time_range.start, k.time_range.end) for k in kernels):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return busy + (cur_e - cur_s if cur_e is not None else 0.0)


def host_us(fn, calls: int = 100) -> float:
    """Host time of one call of ``fn`` in µs: ``calls`` calls back to back
    with no synchronisation between them (the launch queue holds them all,
    so the device's time is not in the number), after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / calls * 1e6


# -- phase 2: kernels ---------------------------------------------------------


def _positions(lengths, t: int, contiguous: bool) -> np.ndarray:
    """Query positions [len(lengths), t]: per row of n tokens its last
    min(t, n) positions (contiguous) or min(t, n) sorted gappy columns ending
    at n-1 (verify), padded with zeros."""
    pos = np.zeros((len(lengths), t), np.int32)
    for i, n in enumerate(lengths):
        if contiguous:  # the row's last min(t, n) tokens, padded with zeros
            k = min(t, n)
            pos[i, :k] = np.arange(n - k, n)
        else:  # gappy verify columns, last one at n-1
            cols = np.sort(np.random.default_rng(i).choice(n, size=min(t, n), replace=False))
            cols[-1] = n - 1
            pos[i, : len(cols)] = np.sort(cols)
    return pos


def _tables(rng, dev, pos: np.ndarray, *, layers: int, npp: int, ps: int) -> torch.Tensor:
    """Distinct random pages (page 0 is the null page) for ``layers`` x rows,
    -1 past each row's used pages."""
    b = pos.shape[0]
    perm = torch.randperm(layers * b * npp, generator=rng, device=dev) + 1
    tables = perm.view(layers, b, npp).to(torch.int32)
    for i in range(b):
        tables[:, i, int(pos[i].max()) // ps + 1:] = -1
    return tables


def _cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` in ``dtype``; to fp8 as the port's cache writes cast (JAX's cast)."""
    if dtype == FP8:
        from dynamo_tpu_torch.ops.attention import to_fp8_like_jax

        return to_fp8_like_jax(x)
    return x.to(dtype)


def _case(rng, dev, *, b, t, h, n_kv, hd, ps, npp, dtype, lengths, contiguous, layers=1, q_dtype=None):
    """Random paged caches (``dtype``) + queries (``q_dtype``, else ``dtype``)
    + tables with -1 tails past each row's used pages."""
    w = n_kv * hd
    pages = layers * b * npp + 1
    kc = _cast(torch.randn((pages, ps, w), generator=rng, device=dev), dtype)
    vc = _cast(torch.randn((pages, ps, w), generator=rng, device=dev), dtype)
    q = torch.randn((b, t, h, hd), generator=rng, device=dev).to(q_dtype or dtype)
    pos = _positions(lengths, t, contiguous)
    tb = _tables(rng, dev, pos, layers=layers, npp=npp, ps=ps)
    return q, kc, vc, tb, torch.from_numpy(pos).to(dev), pos


def kernel_checks(dev) -> dict:
    from dynamo_tpu_torch.ops import paged_decode as pd
    from dynamo_tpu_torch.ops import paged_prefill as pp

    rng = torch.Generator(device=dev).manual_seed(0)
    errs = {f"{k}/{d}": 0.0 for k in ("paged_decode", "paged_prefill") for d in ("bfloat16", "float32")}
    bitwise = []
    for dtype in (torch.bfloat16, torch.float32):
        for h, n_kv, hd in ((32, 8, 64), (32, 8, 128), (64, 8, 64)):
            scale = hd**-0.5
            # Pages of 12 and 24 tokens take the bf16 kernels' other paths:
            # cp.async copies (no 8-row TMA box) and page lookups by division.
            for ps in (16, 32, 12, 24) if dtype == torch.bfloat16 else (16, 32):
                lengths = [1, 37, 300, 1000]
                npp = -(-1000 // ps) + 2
                for t in (1, 4, 8):
                    q, kc, vc, tb, pos, _ = _case(rng, dev, b=4, t=t, h=h, n_kv=n_kv, hd=hd, ps=ps, npp=npp,
                                                  dtype=dtype, lengths=lengths, contiguous=False)
                    for ns in (1, 0):
                        got = pd.paged_decode_attention(q, kc, vc, tb[0], pos, scale=scale, num_splits=ns)
                        want = pd.paged_decode_plain(q, kc, vc, tb[0], pos, scale=scale, num_splits=ns)
                        err = compare(f"decode {dtype} heads {h}/{n_kv} hd{hd} ps{ps} T{t} splits{ns}", got, want,
                                      [(i, t) for i in range(4)], dtype)
                        key = f"paged_decode/{str(dtype).removeprefix('torch.')}"
                        errs[key] = max(errs[key], err)
                        if t > 1:
                            # A T_q=1 decode of each verify column must equal that column bitwise.
                            for j in range(t):
                                one = pd.paged_decode_attention(q[:, j:j + 1].contiguous(), kc, vc, tb[0],
                                                                pos[:, j:j + 1].contiguous(), scale=scale,
                                                                num_splits=ns)
                                same = bool(torch.equal(one[:, 0], got[:, j]))
                                bitwise.append(same)
                                if not same:
                                    raise AssertionError(f"T_q=1 decode differs from verify column {j} ({dtype} "
                                                         f"heads {h}/{n_kv} hd{hd} ps{ps} T{t} splits{ns})")
                # Prefill: chunks continuing after a cached prefix (start > 0),
                # a whole prompt from 0, and mixed 1-token decode rows.
                t = 100
                spans = [(900, 100), (0, 77), (499, 1), (650, 1)]  # (start, real tokens)
                q, kc, vc, tb, _, _ = _case(rng, dev, b=4, t=t, h=h, n_kv=n_kv, hd=hd, ps=ps, npp=npp,
                                            dtype=dtype, lengths=[s + n for s, n in spans], contiguous=True)
                posn = np.zeros((4, t), np.int32)
                for i, (start, n) in enumerate(spans):
                    posn[i, :n] = np.arange(start, start + n)
                pos = torch.from_numpy(posn).to(dev)
                got = pp.paged_prefill_attention(q, kc, vc, tb[0], pos, scale=scale)
                want = pp.paged_prefill_plain(q, kc, vc, tb[0], pos, scale=scale)
                err = compare(f"prefill {dtype} heads {h}/{n_kv} hd{hd} ps{ps}", got, want,
                              [(i, n) for i, (_, n) in enumerate(spans)], dtype)
                key = f"paged_prefill/{str(dtype).removeprefix('torch.')}"
                errs[key] = max(errs[key], err)
    errs["paged_prefill/bfloat16"] = max(errs["paged_prefill/bfloat16"], mixed_step_check(dev, rng))
    emit({"phase": "kernels", "max_abs_err": errs,
          "tolerance": {"float32": f"{REL_TOL[torch.float32]} * max|plain| per row",
                        "bfloat16": f"{REL_TOL[torch.bfloat16]} * max|plain| per row"},
          "bitwise_verify_columns": f"{sum(bitwise)}/{len(bitwise)}"})
    return errs


def mixed_step_check(dev, rng, cache: torch.dtype = torch.bfloat16) -> float:
    """The prefill kernel at a mixed step of the serve phase: llama-3.2-1b
    geometry with bf16 queries on a ``cache`` cache, 16-token pages, a batch of 8 on 128-page tables, the
    step's 512-token bucket holding a chunk after 1024 cached tokens, a
    whole 512-token chunk from 0, a short last chunk, and 1-token decode rows
    (start = kv_len - 1) of up to 1531 tokens."""
    from dynamo_tpu_torch.ops import paged_prefill as pp

    h, n_kv, hd, ps, t, npp = 32, 8, 64, 16, 512, 128
    spans = MIXED_SPANS
    q, kc, vc, tb, _, _ = _case(rng, dev, b=len(spans), t=t, h=h, n_kv=n_kv, hd=hd, ps=ps, npp=npp,
                                dtype=cache, lengths=[s + n for s, n in spans], contiguous=True,
                                q_dtype=torch.bfloat16)
    pos = torch.from_numpy(_spans(spans, t)).to(dev)
    got = pp.paged_prefill_attention(q, kc, vc, tb[0], pos, scale=hd**-0.5)
    want = pp.paged_prefill_plain(q, kc, vc, tb[0], pos, scale=hd**-0.5)
    return compare(f"prefill mixed step (serve shape, {cache} cache)", got, want,
                   [(i, n) for i, (_, n) in enumerate(spans)], torch.bfloat16)


def _mla_case(rng, dev, pos: np.ndarray, *, h, r_kv, dr, r_width, ps, npp, dtype, layers=1, q_dtype=None):
    """Random latent / rope pages (the rope stream's tail past ``dr`` zero, as
    the writers leave it), queries (``q_dtype``, else the caches' dtype), and
    tables with -1 tails."""
    b, t = pos.shape
    pages = layers * b * npp + 1
    c = _cast(torch.randn((pages, ps, r_kv), generator=rng, device=dev), dtype)
    r = torch.zeros((pages, ps, r_width), device=dev)
    r[..., :dr] = torch.randn((pages, ps, dr), generator=rng, device=dev)
    r = _cast(r, dtype)
    q_lat = torch.randn((b, t, h, r_kv), generator=rng, device=dev).to(q_dtype or dtype)
    q_rope = torch.randn((b, t, h, dr), generator=rng, device=dev).to(q_dtype or dtype)
    tables = _tables(rng, dev, pos, layers=layers, npp=npp, ps=ps)
    return q_lat, q_rope, c, r, tables, torch.from_numpy(pos).to(dev)


def _spans(spans, t: int) -> np.ndarray:
    """Contiguous rows ``(start, real tokens)`` in a ``t``-token bucket."""
    pos = np.zeros((len(spans), t), np.int32)
    for i, (start, n) in enumerate(spans):
        pos[i, :n] = np.arange(start, start + n)
    return pos


# bf16-cache geometries outside the serving ones, each reaching a path of the
# bf16 kernel that MLA_GEOMS does not: heads, latent, rope lanes, rope stream
# width, nope dim, query dtype. A rope of other than 64 lanes takes the looped
# score product; one that is not whole 64-lane boxes, or f32 queries, stages
# the queries from registers; more than nine 64-lane atoms a row take 32-key
# stages; a rope stream narrower than a box copies with cp.async.
MLA_PATHS = {
    "rope-128 (32-key stages)": (32, 512, 128, 128, 128, torch.bfloat16),
    "rope-32 of 128": (32, 512, 32, 128, 128, torch.bfloat16),
    "rope-80 of 128 (32-key stages)": (32, 512, 80, 128, 128, torch.bfloat16),
    "latent-128 rope-32 of 128": (4, 128, 32, 128, 32, torch.bfloat16),
    "latent-128 rope-128": (4, 128, 128, 128, 32, torch.bfloat16),
    "latent-128 rope-512 (32-key stages)": (4, 128, 512, 512, 32, torch.bfloat16),
    "latent-128 rope-32 of 32 (cp.async)": (4, 128, 32, 32, 32, torch.bfloat16),
    "mla-8b-proxy f32 queries": (32, 512, 64, 128, 128, torch.float32),
    "test-mla-kernel f32 queries": (4, 128, 64, 128, 32, torch.float32),
}


def mla_kernel_checks(dev) -> dict:
    """paged_mla against its plain version at the MLA_GEOMS geometries, bf16
    and f32: gappy T_q 1, 4 and 8 rows at ragged lengths (at 4 heads also
    T_q 20, two 64-row tiles), splits 1, 2 and auto, with the bitwise T_q=1 /
    verify-column check wherever the two share a split plan; prefill chunks
    after a cached prefix beside 1-token rows. bf16 pages of 16 and 32 (TMA
    boxes of 16 and 32 rows), 8 (the 8-row box) and 4 (no box: cp.async);
    f32 pages of 16 and 32. The same at the MLA_PATHS geometries on bf16
    pages of 16, T_q 1 and 4 (at 4 heads also 20). Then a 512-token chunk
    after 1024 cached tokens (both dtypes) and a mixed step at the serve
    phase's shape. Returns the max errors by cache dtype."""
    from dynamo_tpu_torch.ops import paged_mla as pm

    rng = torch.Generator(device=dev).manual_seed(10)
    errs = {"bfloat16": 0.0, "float32": 0.0}
    bitwise = []

    def check(name, case, real, dtype, scale, num_splits=0):
        got = pm.paged_mla(*case, scale=scale, num_splits=num_splits)
        want = pm.paged_mla_plain(*case, scale=scale, num_splits=num_splits)
        key = str(dtype).removeprefix("torch.")
        errs[key] = max(errs[key], compare(name, got, want, list(enumerate(real)), dtype))
        return got

    # (name, geometry, cache dtype, query dtype, page sizes, T_q list)
    runs = []
    for dtype in (torch.bfloat16, torch.float32):
        for geom, (h, *dims) in MLA_GEOMS.items():
            runs.append((geom, (h, *dims), dtype, dtype, (16, 32, 8, 4) if dtype == torch.bfloat16 else (16, 32),
                         (1, 4, 8, 20) if h == 4 else (1, 4, 8)))
    for geom, (h, *dims, q_dtype) in MLA_PATHS.items():
        runs.append((geom, (h, *dims), torch.bfloat16, q_dtype, (16,), (1, 4, 20) if h == 4 else (1, 4)))
    for geom, (h, r_kv, dr, r_width, dn), dtype, q_dtype, page_sizes, t_list in runs:
        scale = (dn + dr) ** -0.5
        dims = dict(h=h, r_kv=r_kv, dr=dr, r_width=r_width, dtype=dtype, q_dtype=q_dtype)
        for ps in page_sizes:
            lengths = [1, 37, 300, 1000]
            npp = -(-1000 // ps) + 2
            for t in t_list:
                pos = _positions(lengths, t, contiguous=False)
                real = [min(t, n) for n in lengths]
                q_lat, q_rope, c, r, tb, posd = _mla_case(rng, dev, pos, ps=ps, npp=npp, **dims)
                for ns in (1, 2, 0):
                    tag = f"mla {geom} {dtype} ps{ps} T{t} splits{ns}"
                    got = check(tag, (q_lat, q_rope, c, r, tb[0], posd), real, dtype, scale, ns)
                    if t == 1 or (ns == 0 and t > pm.MAX_SPLIT_T):
                        continue  # auto plans split a T_q=1 row and a row of more than 8 differently
                    # A T_q=1 decode of each verify column must equal that column bitwise.
                    for j in range(t):
                        one = pm.paged_mla(q_lat[:, j:j + 1].contiguous(), q_rope[:, j:j + 1].contiguous(), c, r,
                                           tb[0], posd[:, j:j + 1].contiguous(), scale=scale, num_splits=ns)
                        for i in range(len(lengths)):
                            if j < real[i]:
                                bitwise.append(bool(torch.equal(one[i, 0], got[i, j])))
                                if not bitwise[-1]:
                                    raise AssertionError(f"T_q=1 decode differs from verify column {j} of row "
                                                         f"{i} ({tag})")
            spans = [(900, 100), (0, 77), (499, 1), (650, 1)]
            pos = _spans(spans, 100)
            case = _mla_case(rng, dev, pos, ps=ps, npp=npp, **dims)
            check(f"mla chunk {geom} {dtype} ps{ps}", (*case[:4], case[4][0], case[5]), [n for _, n in spans],
                  dtype, scale)
    for dtype in (torch.bfloat16, torch.float32):
        # The main path's prefill shape: one 512-token chunk after 1024 cached tokens.
        h, r_kv, dr, r_width, dn = MLA_GEOMS[MLA_MODEL]
        pos = _spans([(1024, 512)], 512)
        case = _mla_case(rng, dev, pos, h=h, r_kv=r_kv, dr=dr, r_width=r_width, ps=16, npp=96, dtype=dtype)
        check(f"mla 512 after 1024 {dtype}", (*case[:4], case[4][0], case[5]), [512], dtype, (dn + dr) ** -0.5)
    errs["bfloat16"] = max(errs["bfloat16"], mla_mixed_step_check(dev, rng))
    emit({"phase": "kernels_mla", "max_abs_err": errs,
          "tolerance": {"float32": f"{REL_TOL[torch.float32]} * max|plain| per row",
                        "bfloat16": f"{REL_TOL[torch.bfloat16]} * max|plain| per row"},
          "bitwise_verify_columns": f"{sum(bitwise)}/{len(bitwise)}"})
    if len(bitwise) < 208:
        raise AssertionError(f"only {len(bitwise)} bitwise verify columns were checked")
    return errs


def mla_mixed_step_check(dev, rng, cache: torch.dtype = torch.bfloat16) -> float:
    """paged_mla at a mixed step of the MLA serve phase: mla-8b-proxy
    geometry with bf16 queries on a ``cache`` cache, 16-token pages, a batch of 8 on 128-page tables, the
    512-token bucket holding a chunk after 1024 cached tokens, a whole chunk
    from 0, a short last chunk and 1-token decode rows of up to 1531 tokens."""
    from dynamo_tpu_torch.ops import paged_mla as pm

    h, r_kv, dr, r_width, dn = MLA_GEOMS[MLA_MODEL]
    spans = MIXED_SPANS
    case = _mla_case(rng, dev, _spans(spans, 512), h=h, r_kv=r_kv, dr=dr, r_width=r_width, ps=16, npp=128,
                     dtype=cache, q_dtype=torch.bfloat16)
    case = (*case[:4], case[4][0], case[5])
    got = pm.paged_mla(*case, scale=(dn + dr) ** -0.5)
    want = pm.paged_mla_plain(*case, scale=(dn + dr) ** -0.5)
    return compare(f"mla mixed step (serve shape, {cache} cache)", got, want,
                   [(i, n) for i, (_, n) in enumerate(spans)], torch.bfloat16)


def folded_sdpa(q_lat, q_rope, kg, vg, mask, scale):
    """The MLA yardstick: one SDPA call with the heads folded into the query
    rows (MLA is MQA): q ``[B, 1, T*H, r_kv + dr]`` (row t*H + h) against the
    gathered keys ``kg [B, 1, S, r_kv + dr]`` and values ``vg [B, 1, S,
    r_kv]``, with a boolean per-row horizon mask ``[B, 1, T*H, S]`` or none.
    The first backend of flash, memory-efficient, cuDNN and math that takes
    these widths is pinned with ``sdpa_kernel``; a backend that refuses them
    raises before it launches anything. Returns (call, backend name). Timed
    only as a yardstick: the port never calls it."""
    import warnings

    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    b, t, h, _ = q_lat.shape
    qf = torch.cat([q_lat, q_rope], dim=-1).reshape(b, 1, t * h, -1).contiguous()
    refusals = []
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.MATH):
        def call(backend=backend):
            with sdpa_kernel(backend):
                return F.scaled_dot_product_attention(qf, kg, vg, attn_mask=mask, scale=scale)
        try:
            with warnings.catch_warnings():  # a refusing backend warns why, then raises
                warnings.simplefilter("ignore", UserWarning)
                call()
            torch.cuda.synchronize()
        except RuntimeError as exc:
            refusals.append(f"{backend.name}: {str(exc).splitlines()[0][:120]}")
            continue
        return call, backend.name
    raise RuntimeError(f"no SDPA backend takes the folded MLA shapes: {refusals}")


def mla_timings(dev, cache: torch.dtype = torch.bfloat16, bf16: dict | None = None) -> dict:
    """paged_mla at the MLA main path's shapes (mla-8b-proxy, bf16 queries on
    a ``cache`` cache, 16-token pages): decode at batch 8 over 2048-token contexts on 128-page tables
    (the serve phase's table width, so the same split plan), a 512-token
    chunk after 1024 cached tokens, and the serve's mixed step
    (``mla_mixed_step_timing``); each held against its plain version on the
    timed inputs first. The library yardstick is ``folded_sdpa``: no mask at
    full-context decode, the per-row horizon mask at prefill and the mixed
    step; an fp8 cache has none (no PyTorch call attends over fp8 latents).
    Beside the device times, the wrapper's host µs per call, and (``bf16``:
    the bf16 cache's record) each time's ratio to bf16's. At T > 1 the
    walk facts are computed once beforehand, as the forward computes them
    once per step for all its layers. Each entry names the share group its
    launch ran in (``share``)."""
    from dynamo_tpu_torch.ops import paged_mla as pm

    rng = torch.Generator(device=dev).manual_seed(11)
    h, r_kv, dr, r_width, dn = MLA_GEOMS[MLA_MODEL]
    ps, dtype, scale = 16, torch.bfloat16, (dn + dr) ** -0.5
    dims = dict(h=h, r_kv=r_kv, dr=dr, r_width=r_width, dtype=cache, q_dtype=dtype)
    isz, tag = cache.itemsize, str(cache).removeprefix("torch.")

    out = {}
    # Decode: 4 layers' worth of distinct pages (4 x 21 MB > the 50 MB L2),
    # cycled per launch, so each launch reads its latents from HBM.
    b, ctx, layers = 8, 2048, 4
    npp = ctx // ps
    pos = np.full((b, 1), ctx - 1, np.int32)
    q_lat, q_rope, c, r, tb, posd = _mla_case(rng, dev, pos, ps=ps, npp=npp, layers=layers, **dims)
    tbs = [tb[i].contiguous() for i in range(layers)]
    it = iter(range(10**9))
    err = max(compare(f"mla decode timing inputs, layer {i}",
                      pm.paged_mla(q_lat, q_rope, c, r, tbs[i], posd, scale=scale),
                      pm.paged_mla_plain(q_lat, q_rope, c, r, tbs[i], posd, scale=scale),
                      [(row, 1) for row in range(b)], dtype) for i in range(layers))
    kv = [_mla_gathered(c, r, tbs[i], dr) for i in range(layers)] if cache == dtype else []
    libs = [folded_sdpa(q_lat, q_rope, kv[i][0], kv[i][1], None, scale) for i in range(len(kv))]
    nbytes = (b * ctx * (r_kv + dr) * isz  # latent + rope lanes, read once
              + b * h * (r_kv + dr) * 2 + b * h * r_kv * 4  # queries in, f32 latent out
              + b * npp * 4 + b * 4)  # tables, positions
    flops = 2 * b * h * ctx * (r_kv + dr) + 2 * b * h * ctx * r_kv
    kern = lambda: pm.paged_mla(q_lat, q_rope, c, r, tbs[next(it) % layers], posd, scale=scale)
    out["decode"] = _mla_entry(
        kern, lambda: pm.paged_mla_plain(q_lat, q_rope, c, r, tbs[next(it) % layers], posd, scale=scale),
        (lambda: libs[next(it) % layers][0]()) if libs else None, nbytes, flops, 50,
        shape=f"B={b} ctx={ctx} heads={h} r_kv={r_kv} rope={dr}/{r_width} {tag} page={ps}",
        max_abs_err=err, splits=pm.mla_split_plan(b, 1, npp, ps, 0, dev),
        library_backend=libs[0][1] if libs else None,
        device_us_by_kernel=device_us_by_kernel(kern), host_us_per_call=host_us(kern))
    del q_lat, q_rope, c, r, kv, libs

    # Prefill: one 512-token chunk at positions 1024..1535.
    start, t = 1024, 512
    kv_len = start + t
    npp = kv_len // ps
    pos = _spans([(start, t)], t)
    q_lat, q_rope, c, r, tb, posd = _mla_case(rng, dev, pos, ps=ps, npp=npp, **dims)
    tb0 = tb[0].contiguous()
    walk = pm.walk_facts(posd)
    kern = lambda: pm.paged_mla(q_lat, q_rope, c, r, tb0, posd, scale=scale, walk=walk)
    plain = lambda: pm.paged_mla_plain(q_lat, q_rope, c, r, tb0, posd, scale=scale)
    err = compare("mla prefill timing inputs", kern(), plain(), [(0, t)], dtype)
    lib, backend = None, None
    if cache == dtype:
        kg, vg = _mla_gathered(c, r, tb0, dr)
        lib, backend = folded_sdpa(q_lat, q_rope, kg, vg, _mla_horizon_mask(posd, h, kv_len), scale)
    pairs = t * start + t * (t + 1) // 2  # causal (query, key) pairs
    nbytes = kv_len * (r_kv + dr) * isz + t * h * (r_kv + dr) * 2 + t * h * r_kv * 4 + npp * 4 + t * 4
    flops = 2 * h * pairs * (r_kv + dr) + 2 * h * pairs * r_kv
    out["prefill"] = _mla_entry(kern, plain, lib, nbytes, flops, 20, max_abs_err=err, library_backend=backend,
                                shape=f"B=1 T={t} start={start} heads={h} r_kv={r_kv} rope={dr}/{r_width} {tag} "
                                      f"page={ps}",
                                device_us_by_kernel=device_us_by_kernel(kern, 5), host_us_per_call=host_us(kern),
                                share=pm.mla_share_plan(t, h, 1, cache))
    del q_lat, q_rope, c, r, lib
    out["mixed_step"] = mla_mixed_step_timing(dev, rng, cache)
    if bf16 is not None:
        _vs_bf16(out, bf16)
    emit({"phase": "kernel_timing_mla" if cache == dtype else f"kernel_timing_mla_{tag}", **out})
    return out


def _mla_gathered(c, r, tb, dr):
    """Each row's whole table gathered: keys ``[c; r[:dr]]`` ``[B, 1, S, r_kv
    + dr]`` and values ``c`` ``[B, 1, S, r_kv]``, one shared KV head."""
    idx = tb.clamp(min=0).reshape(-1).long()
    b, s = tb.shape[0], tb.shape[1] * c.shape[1]
    cg = c[idx].reshape(b, 1, s, c.shape[2])
    rg = r[idx].reshape(b, 1, s, r.shape[2])[..., :dr]
    return torch.cat([cg, rg], dim=-1).contiguous(), cg.contiguous()


def _mla_horizon_mask(pos, h, s):
    """Boolean ``[B, 1, T*H, S]``: folded row t*H + h sees keys kpos <= pos[b, t]."""
    kpos = torch.arange(s, device=pos.device)
    mask = kpos[None, None, :] <= pos[:, :, None]  # [B, T, S]
    return mask[:, :, None, :].expand(-1, -1, h, -1).reshape(pos.shape[0], 1, -1, s).contiguous()


def _mla_entry(kern, plain, lib, nbytes, flops, iters, **extra):
    return dict(ms=time_ms(kern, iters=iters), plain_ms=time_ms(plain, iters=3),
                library_ms=time_ms(lib, iters=iters) if lib is not None else None,
                bound_ms=max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3,
                bound_by="bytes" if nbytes / HBM_BYTES_PER_S >= flops / BF16_FLOPS else "operations", **extra)


def mla_mixed_step_timing(dev, rng, cache: torch.dtype = torch.bfloat16) -> dict:
    """paged_mla at the serve's mixed-step shape (``mla_mixed_step_check``'s
    spans: mla-8b-proxy geometry, bf16 queries on a ``cache`` cache, a batch
    of 8 in a 512-token bucket on 128-page tables, five of the rows 1-token
    decode rows), held against its plain version first. The yardstick (bf16
    caches only) is ``folded_sdpa`` over each row's whole table with the
    per-row horizon mask."""
    from dynamo_tpu_torch.ops import paged_mla as pm

    h, r_kv, dr, r_width, dn = MLA_GEOMS[MLA_MODEL]
    ps, t, npp, scale = 16, 512, 128, (dn + dr) ** -0.5
    spans = MIXED_SPANS
    q_lat, q_rope, c, r, tb, posd = _mla_case(rng, dev, _spans(spans, t), h=h, r_kv=r_kv, dr=dr, r_width=r_width,
                                             ps=ps, npp=npp, dtype=cache, q_dtype=torch.bfloat16)
    tb0 = tb[0].contiguous()
    walk = pm.walk_facts(posd)
    kern = lambda: pm.paged_mla(q_lat, q_rope, c, r, tb0, posd, scale=scale, walk=walk)
    plain = lambda: pm.paged_mla_plain(q_lat, q_rope, c, r, tb0, posd, scale=scale)
    err = compare("mla mixed-step timing inputs", kern(), plain(), [(i, n) for i, (_, n) in enumerate(spans)],
                  torch.bfloat16)
    lib, backend = None, None
    if cache == torch.bfloat16:
        kg, vg = _mla_gathered(c, r, tb0, dr)
        lib, backend = folded_sdpa(q_lat, q_rope, kg, vg, _mla_horizon_mask(posd, h, npp * ps), scale)
    pairs = sum(n * s + n * (n + 1) // 2 for s, n in spans)
    nbytes = (sum((s + n) * (r_kv + dr) * cache.itemsize for s, n in spans)  # each row's latents + rope lanes, once
              + sum(n * h * ((r_kv + dr) * 2 + r_kv * 4) for _, n in spans)  # real queries in, f32 latent out
              + len(spans) * (npp * 4 + t * 4))  # tables, positions
    flops = 2 * h * pairs * (r_kv + dr) + 2 * h * pairs * r_kv
    return _mla_entry(kern, plain, lib, nbytes, flops, 20, max_abs_err=err, library_backend=backend,
                      shape=f"B=8 T={t} spans={spans} heads={h} r_kv={r_kv} rope={dr}/{r_width} "
                            f"{str(cache).removeprefix('torch.')} page={ps}",
                      device_us_by_kernel=device_us_by_kernel(kern, 5), host_us_per_call=host_us(kern),
                      share=pm.mla_share_plan(t, h, 1, cache))


def _gqa_timings(dev, rng, h: int, n_kv: int, hd: int, cache: torch.dtype = torch.bfloat16) -> dict:
    """paged_decode and paged_prefill at one GQA geometry (bf16 queries on a
    ``cache`` cache, 16-token pages; the SDPA yardstick for bf16 caches
    only: no PyTorch call attends over fp8 K/V): decode at batch 8 over 2048-token contexts on 128-page tables
    (the serve phase's table width, so the same split plan), prefill of a
    512-token chunk after 1024 cached tokens. Before timing, each kernel's
    output on the timed inputs is held against its plain version's. Beside
    the device times, the wrapper's host time per call (checks, ctypes,
    tensor maps and the launch)."""
    import torch.nn.functional as F

    from dynamo_tpu_torch.ops import paged_decode as pd
    from dynamo_tpu_torch.ops import paged_prefill as pp
    from dynamo_tpu_torch.ops.attention import gather_pages

    ps, dtype = 16, torch.bfloat16
    scale = hd**-0.5
    isz = cache.itemsize
    geom = f"heads={h}/{n_kv} hd={hd} {str(cache).removeprefix('torch.')} page={ps}"
    out = {}

    # Decode: 4 layers' worth of distinct pages (4 x 33.6 MB at hd 64 > the
    # 50 MB L2), cycled per launch, so each launch reads its K/V from HBM as a
    # serving step does.
    b, ctx, layers = 8, 2048, 4
    npp = ctx // ps
    q, kc, vc, tb, pos, _ = _case(rng, dev, b=b, t=1, h=h, n_kv=n_kv, hd=hd, ps=ps, npp=npp, dtype=cache,
                                  lengths=[ctx] * b, contiguous=True, layers=layers, q_dtype=dtype)
    tbs = [tb[i].contiguous() for i in range(layers)]
    it = iter(range(10**9))
    kern = lambda: pd.paged_decode_attention(q, kc, vc, tbs[next(it) % layers], pos, scale=scale)
    plain = lambda: pd.paged_decode_plain(q, kc, vc, tbs[next(it) % layers], pos, scale=scale)
    err = max(compare(f"decode timing inputs, {geom}, layer {i}",
                      pd.paged_decode_attention(q, kc, vc, tbs[i], pos, scale=scale),
                      pd.paged_decode_plain(q, kc, vc, tbs[i], pos, scale=scale), [(r, 1) for r in range(b)], dtype)
              for i in range(layers))
    lib = None
    if cache == dtype:
        kg = [gather_pages(kc, tbs[i], n_kv).permute(0, 2, 1, 3).contiguous() for i in range(layers)]
        vg = [gather_pages(vc, tbs[i], n_kv).permute(0, 2, 1, 3).contiguous() for i in range(layers)]
        qg = q.permute(0, 2, 1, 3).contiguous()  # [B, H, 1, hd]
        lib = lambda: (lambda i: F.scaled_dot_product_attention(qg, kg[i], vg[i], scale=scale, enable_gqa=True))(
            next(it) % layers)
    nbytes = (2 * b * ctx * n_kv * hd * isz  # K and V strips, read once
              + 2 * b * h * hd * 2  # q in, out
              + b * npp * 4 + b * 4)  # tables, positions
    flops = 4 * b * h * ctx * hd
    ms = time_ms(kern, iters=50)
    out["paged_decode"] = dict(
        ms=ms, plain_ms=time_ms(plain, iters=5),
        library_ms=time_ms(lib, iters=50) if lib else None,
        host_us_per_call=host_us(kern),
        bound_ms=max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3,
        bound_by="bytes" if nbytes / HBM_BYTES_PER_S >= flops / BF16_FLOPS else "operations",
        achieved_gb_per_s=nbytes / ms * 1e-6,  # the bound's bytes over the measured time
        shape=f"B={b} ctx={ctx} {geom}", max_abs_err=err,
        splits=pd.decode_split_plan(b, n_kv, npp, ps, 0, q.device),
        device_us_by_kernel=device_us_by_kernel(kern),
    )
    del q, kc, vc, lib

    # Prefill: one 512-token chunk at positions 1024..1535.
    start, t = 1024, 512
    kv_len = start + t
    npp = kv_len // ps
    q, kc, vc, tb, pos, _ = _case(rng, dev, b=1, t=t, h=h, n_kv=n_kv, hd=hd, ps=ps, npp=npp, dtype=cache,
                                  lengths=[kv_len], contiguous=True, q_dtype=dtype)
    tb0 = tb[0].contiguous()
    kern = lambda: pp.paged_prefill_attention(q, kc, vc, tb0, pos, scale=scale)
    plain = lambda: pp.paged_prefill_plain(q, kc, vc, tb0, pos, scale=scale)
    err = compare(f"prefill timing inputs, {geom}", kern(), plain(), [(0, t)], dtype)
    lib = None
    if cache == dtype:
        kgp = gather_pages(kc, tb0, n_kv).permute(0, 2, 1, 3).contiguous()
        vgp = gather_pages(vc, tb0, n_kv).permute(0, 2, 1, 3).contiguous()
        qgp = q.permute(0, 2, 1, 3).contiguous()
        causal = (torch.arange(kv_len, device=dev)[None, :] <= (start + torch.arange(t, device=dev))[:, None])
        lib = lambda: F.scaled_dot_product_attention(qgp, kgp, vgp, attn_mask=causal, scale=scale, enable_gqa=True)
    pairs = t * start + t * (t + 1) // 2  # causal (query, key) pairs
    nbytes = 2 * kv_len * n_kv * hd * isz + 2 * t * h * hd * 2 + npp * 4 + t * 4
    flops = 4 * pairs * h * hd
    out["paged_prefill"] = dict(
        ms=time_ms(kern, iters=20), plain_ms=time_ms(plain, iters=3),
        library_ms=time_ms(lib, iters=20) if lib else None,
        bound_ms=max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3,
        bound_by="bytes" if nbytes / HBM_BYTES_PER_S >= flops / BF16_FLOPS else "operations",
        shape=f"B=1 T={t} start={start} {geom}", max_abs_err=err, host_us_per_call=host_us(kern),
        device_us_by_kernel=device_us_by_kernel(kern, 5),
    )
    return out


def mixed_step_timing(dev, rng, cache: torch.dtype = torch.bfloat16) -> dict:
    """paged_prefill at the serve's mixed-step shape (``mixed_step_check``'s
    spans: llama-3.2-1b geometry, bf16 queries on a ``cache`` cache, a batch
    of 8 in a 512-token bucket on 128-page tables, five of the rows 1-token
    decode rows). The library yardstick (bf16 caches only) is one SDPA call over each row's gathered K/V (its whole
    128-page table, KV heads repeated to the query heads before timing) with
    the boolean mask ``kpos <= qpos & kpos < kv_len``."""
    import torch.nn.functional as F

    from dynamo_tpu_torch.ops import paged_prefill as pp
    from dynamo_tpu_torch.ops.attention import gather_pages

    h, n_kv, hd, ps, t, npp = 32, 8, 64, 16, 512, 128
    spans = MIXED_SPANS
    q, kc, vc, tb, _, _ = _case(rng, dev, b=len(spans), t=t, h=h, n_kv=n_kv, hd=hd, ps=ps, npp=npp,
                                dtype=cache, lengths=[s + n for s, n in spans], contiguous=True,
                                q_dtype=torch.bfloat16)
    pos = torch.from_numpy(_spans(spans, t)).to(dev)
    tb0 = tb[0].contiguous()
    scale = hd**-0.5
    kern = lambda: pp.paged_prefill_attention(q, kc, vc, tb0, pos, scale=scale)
    plain = lambda: pp.paged_prefill_plain(q, kc, vc, tb0, pos, scale=scale)
    err = compare("prefill mixed-step timing inputs", kern(), plain(), [(i, n) for i, (_, n) in enumerate(spans)],
                  torch.bfloat16)
    lib = None
    if cache == torch.bfloat16:
        g = h // n_kv
        kg = gather_pages(kc, tb0.clamp(min=0), n_kv).repeat_interleave(g, dim=2).permute(0, 2, 1, 3).contiguous()
        vg = gather_pages(vc, tb0.clamp(min=0), n_kv).repeat_interleave(g, dim=2).permute(0, 2, 1, 3).contiguous()
        qg = q.permute(0, 2, 1, 3).contiguous()  # [B, H, T, hd]
        kpos = torch.arange(npp * ps, device=dev)
        kv_len = pos.amax(dim=1) + 1
        mask = ((kpos[None, None, :] <= pos[:, :, None]) & (kpos[None, None, :] < kv_len[:, None, None]))[:, None]
        lib = lambda: F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask, scale=scale)
    kv_lens = [s + n for s, n in spans]
    pairs = sum(n * s + n * (n + 1) // 2 for s, n in spans)
    nbytes = (sum(2 * kv * n_kv * hd * cache.itemsize for kv in kv_lens) + sum(2 * n * h * hd * 2 for _, n in spans)
              + len(spans) * (npp * 4 + t * 4))
    flops = 4 * pairs * h * hd
    return dict(ms=time_ms(kern, iters=20), plain_ms=time_ms(plain, iters=3),
                library_ms=time_ms(lib, iters=20) if lib else None,
                bound_ms=max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3,
                bound_by="bytes" if nbytes / HBM_BYTES_PER_S >= flops / BF16_FLOPS else "operations",
                shape=f"B=8 T={t} spans={spans} heads={h}/{n_kv} hd={hd} {str(cache).removeprefix('torch.')} "
                      f"page={ps}", max_abs_err=err, host_us_per_call=host_us(kern),
                device_us_by_kernel=device_us_by_kernel(kern, 5))


def kernel_timings(dev, cache: torch.dtype = torch.bfloat16, bf16: dict | None = None) -> dict:
    """Each GQA kernel at the main path's geometry (llama-3.2-1b: 32/8 heads,
    hd 64) and at llama-3-8b's (32/8, hd 128), and the prefill kernel at the
    serve's mixed-step shape, on a ``cache`` cache. ``bf16``: the bf16
    cache's record, beside whose times each entry states its ratio
    (``vs_bf16``). Returns the record."""
    rng = torch.Generator(device=dev).manual_seed(1)
    out = _gqa_timings(dev, rng, 32, 8, 64, cache)
    out["paged_prefill_mixed_step"] = mixed_step_timing(dev, rng, cache)
    out["hd128"] = _gqa_timings(dev, rng, 32, 8, 128, cache)
    if bf16 is not None:
        _vs_bf16(out, bf16)
    tag = str(cache).removeprefix("torch.")
    emit({"phase": "kernel_timing" if cache == torch.bfloat16 else f"kernel_timing_{tag}", **out})
    return out


def _vs_bf16(record: dict, bf16: dict) -> None:
    """Beside each timed entry of ``record`` (nested records too), its
    device time over the same entry's in the bf16 record."""
    for key, entry in record.items():
        if isinstance(entry, dict) and key in bf16:
            if "ms" in entry:
                entry["vs_bf16"] = entry["ms"] / bf16[key]["ms"]
            else:
                _vs_bf16(entry, bf16[key])


# -- phase 2d: paged_decode past 32 query tokens --------------------------------

WIDE_T = (33, 64, 512, 2048)  # verify widths past the earlier cap, up to the serve's prefill budget
# The spec serve's widened mixed verify steps, (start, real tokens) a row:
# chunks beside 5-token verify rows (spec_k 4), in a 512-token bucket (the
# chunk budget) and in a 2048-token one (the prefill budget).
WIDE_MIXED = {512: [(1024, 512), (0, 512), (1400, 100), (1530, 5), (799, 5), (15, 5), (250, 5), (1199, 5)],
              2048: [(0, 2048), (1400, 100), (1530, 5), (799, 5), (15, 5), (250, 5), (1199, 5), (2000, 5)]}


def wide_verify_checks(dev) -> dict:
    """paged_decode's multi-query form at T_q in WIDE_T (33 to 2048 query
    tokens a row) against its plain version: llama-3.2-1b's heads (32/8),
    hd 64 and 128, bf16 and fp8 caches with bf16 queries, pages of 16,
    gappy rows (sorted random columns, the last at the row's end) and
    contiguous ones (a chunk ending at the row's end, padded with zeros),
    splits 1 and auto; with the bitwise T_q=1 / verify-column check on every
    column at T_q 33 and on 17 columns spread over the row past it. Returns
    the max abs errors by cache (``paged_decode``, ``paged_decode_fp8``)."""
    from dynamo_tpu_torch.ops import paged_decode as pd

    rng = torch.Generator(device=dev).manual_seed(30)
    h, n_kv, ps = 32, 8, 16
    errs = {"paged_decode": 0.0, "paged_decode_fp8": 0.0}
    bitwise = []
    for cache in (torch.bfloat16, FP8):
        name = "paged_decode_fp8" if cache == FP8 else "paged_decode"
        for hd in (64, 128):
            scale = hd**-0.5
            for t in WIDE_T:
                lengths = [t + 300, 2 * t + 77]
                npp = -(-max(lengths) // ps) + 1
                for contiguous in (False, True):
                    q, kc, vc, tb, pos, posn = _case(rng, dev, b=2, t=t, h=h, n_kv=n_kv, hd=hd, ps=ps, npp=npp,
                                                     dtype=cache, lengths=lengths, contiguous=contiguous,
                                                     q_dtype=torch.bfloat16)
                    cols = range(t) if t <= 33 else sorted(set(np.linspace(0, t - 1, 17).round().astype(int)))
                    tag = f"{str(cache).removeprefix('torch.')} hd{hd} T{t} {'contiguous' if contiguous else 'gappy'}"
                    for ns in (1, 0):
                        got = pd.paged_decode_attention(q, kc, vc, tb[0], pos, scale=scale, num_splits=ns)
                        want = pd.paged_decode_plain(q, kc, vc, tb[0], pos, scale=scale, num_splits=ns)
                        errs[name] = max(errs[name], compare(f"wide decode {tag} splits{ns}", got, want,
                                                             [(i, min(t, n)) for i, n in enumerate(lengths)],
                                                             torch.bfloat16))
                        for j in cols:
                            one = pd.paged_decode_attention(q[:, j:j + 1].contiguous(), kc, vc, tb[0],
                                                            pos[:, j:j + 1].contiguous(), scale=scale, num_splits=ns)
                            bitwise.append(bool(torch.equal(one[:, 0], got[:, j])))
                            if not bitwise[-1]:
                                raise AssertionError(f"T_q=1 decode differs from verify column {j} ({tag} "
                                                     f"splits{ns})")
                    del q, kc, vc, got, want
    emit({"phase": "kernels_wide_verify", "t_q": list(WIDE_T), "max_abs_err": errs,
          "tolerance": f"{REL_TOL[torch.bfloat16]} * max|plain| per row",
          "bitwise_verify_columns": f"{sum(bitwise)}/{len(bitwise)}"})
    return errs


def wide_verify_timing(dev) -> dict:
    """paged_decode at the spec serve's verify shapes, bf16 and fp8 caches:
    a T_q = 5 verify (spec_k 4) of 8 rows at 2048-token contexts on 128-page
    tables (the timed decode shape), and the widened mixed verify steps of
    WIDE_MIXED, where the decode kernel takes every row, beside
    ``paged_prefill`` on the same rows (contiguous, so the prefill kernel
    takes them too) and their ratio. Bounds count each row's K/V once and
    the causal (query, key) pairs' operations; the library yardstick (bf16
    only) is SDPA over the gathered K/V with the boolean mask."""
    import torch.nn.functional as F

    from dynamo_tpu_torch.ops import paged_decode as pd
    from dynamo_tpu_torch.ops import paged_prefill as pp
    from dynamo_tpu_torch.ops.attention import gather_pages

    rng = torch.Generator(device=dev).manual_seed(31)
    h, n_kv, hd, ps = 32, 8, 64, 16
    scale = hd**-0.5
    record = {"phase": "kernel_timing_wide_verify", "geometry": f"heads={h}/{n_kv} hd={hd} page={ps}"}
    for cache in (torch.bfloat16, FP8):
        tag = str(cache).removeprefix("torch.")
        shapes = {"verify_t5": ([(2043, 5)] * 8, 5, 128), **{f"mixed_verify_t{t}": (spans, t, 160)
                                                             for t, spans in WIDE_MIXED.items()}}
        out = {}
        for key, (spans, t, npp) in shapes.items():
            q, kc, vc, tb, _, _ = _case(rng, dev, b=len(spans), t=t, h=h, n_kv=n_kv, hd=hd, ps=ps, npp=npp,
                                        dtype=cache, lengths=[s + n for s, n in spans], contiguous=True,
                                        q_dtype=torch.bfloat16)
            pos = torch.from_numpy(_spans(spans, t)).to(dev)
            tb0 = tb[0].contiguous()
            rows = [(i, n) for i, (_, n) in enumerate(spans)]
            kern = lambda: pd.paged_decode_attention(q, kc, vc, tb0, pos, scale=scale)
            plain = lambda: pd.paged_decode_plain(q, kc, vc, tb0, pos, scale=scale)
            prefill = lambda: pp.paged_prefill_attention(q, kc, vc, tb0, pos, scale=scale)
            err = compare(f"wide verify timing inputs {key} {tag}", kern(), plain(), rows, torch.bfloat16)
            compare(f"prefill on the wide verify rows {key} {tag}", prefill(), plain(), rows, torch.bfloat16)
            lib = None
            if cache == torch.bfloat16:
                g = h // n_kv
                kg = gather_pages(kc, tb0.clamp(min=0), n_kv).repeat_interleave(g, dim=2).permute(0, 2, 1, 3).contiguous()
                vg = gather_pages(vc, tb0.clamp(min=0), n_kv).repeat_interleave(g, dim=2).permute(0, 2, 1, 3).contiguous()
                qg = q.permute(0, 2, 1, 3).contiguous()
                kpos = torch.arange(npp * ps, device=dev)
                kv_len = pos.amax(dim=1) + 1
                mask = ((kpos[None, None, :] <= pos[:, :, None]) & (kpos[None, None, :] < kv_len[:, None, None]))[:, None]
                lib = lambda: F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask, scale=scale)
            pairs = sum(n * s + n * (n + 1) // 2 for s, n in spans)
            nbytes = (sum(2 * (s + n) * n_kv * hd * cache.itemsize for s, n in spans)
                      + sum(2 * n * h * hd * 2 for _, n in spans) + len(spans) * (npp * 4 + t * 4))
            flops = 4 * pairs * h * hd
            iters = 50 if t <= 5 else 10
            ms = time_ms(kern, iters=iters)
            prefill_ms = time_ms(prefill, iters=iters)
            out[key] = dict(ms=ms, prefill_ms=prefill_ms, vs_prefill=ms / prefill_ms,
                            plain_ms=time_ms(plain, iters=2), library_ms=time_ms(lib, iters=iters) if lib else None,
                            bound_ms=max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3,
                            bound_by="bytes" if nbytes / HBM_BYTES_PER_S >= flops / BF16_FLOPS else "operations",
                            shape=f"B={len(spans)} T={t} spans={spans} {tag}", max_abs_err=err,
                            splits=pd.decode_split_plan(len(spans), n_kv, npp, ps, 0, q.device))
            del q, kc, vc, lib
        record[tag] = out
    emit(record)
    return record


# -- fp8 caches: casts, sampling, the kernels' fp8 forms ----------------------------


def fp8_cast_checks(dev) -> dict:
    """The fp8 cache write and the kernels' on-chip conversion on the card:
    ``to_fp8_like_jax`` over all 65,536 bf16 patterns, bitwise the same
    function on the CPU (JAX's cast, tests/test_torch_fp8.py); all 256 e4m3
    codes through the kernels' conversion (``fp8x8_to_bf16x8``, the
    ``fp8_convert`` library), bitwise torch's CPU ``.to(bfloat16)``, a NaN
    compared as a NaN."""
    from dynamo_tpu_torch.ops import build
    from dynamo_tpu_torch.ops.attention import to_fp8_like_jax

    pats = torch.arange(1 << 16, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    cpu = to_fp8_like_jax(pats).view(torch.uint8)
    card = to_fp8_like_jax(pats.to(dev)).view(torch.uint8).cpu()
    cast_mismatch = int((cpu != card).sum())
    codes = torch.arange(256, dtype=torch.int32).to(torch.uint8)
    want = codes.view(FP8).to(torch.bfloat16)
    src = codes.to(dev)
    out = torch.empty(256, dtype=torch.bfloat16, device=dev)
    build.check_launch("fp8_convert", build.load("fp8_convert")(src.data_ptr(), out.data_ptr(), 256,
                                                                 build.stream_of(out)))
    got = out.cpu()
    same = (got.view(torch.int16) == want.view(torch.int16)) | (torch.isnan(got) & torch.isnan(want))
    record = {"phase": "fp8_casts", "bf16_patterns": int(pats.numel()), "cast_mismatches": cast_mismatch,
              "e4m3_codes": 256, "conversion_mismatches": int((~same).sum()),
              "nan_codes": int(torch.isnan(want).sum())}
    emit(record)
    if cast_mismatch or record["conversion_mismatches"]:
        raise AssertionError(f"fp8 casts on the card differ: {record}")
    return record


def sampling_check(dev) -> dict:
    """Seeded sampling on the card equals the port's CPU draw: the threefry
    words of ``fold_in(PRNGKey(seed), step)`` bitwise, the Gumbel noise
    within 2 ulps of max(|g|, 1), and the tokens ``sample_tokens`` draws from
    the same f32 logits (llama-3.2-1b's vocabulary, temperature, top-k and
    top-p rows, one greedy) equal."""
    from dynamo_tpu_torch.ops import sampling as smp

    b, vocab = 8, 128256
    gen = torch.Generator().manual_seed(5)
    logits = torch.randn((b, vocab), generator=gen) * 4
    seeds = torch.tensor([0, 1, 2**31, 2**32 - 1, 7, 1234, 99, 5], dtype=torch.int64).to(torch.int32)
    steps = torch.tensor([0, 1, 1000, 3, 0, 17, 2**20, 9], dtype=torch.int32)
    temp = torch.tensor([0.8, 1.0, 1.3, 0.6, 0.0, 0.9, 1.1, 0.7])
    top_k = torch.tensor([0, 40, 0, 5, 0, 0, 100, 0], dtype=torch.int32)
    top_p = torch.tensor([0.95, 1.0, 0.9, 1.0, 1.0, 0.8, 1.0, 0.5])
    width = smp.CANDIDATES
    out = {}
    for where in ("cpu", dev):
        args = [x.to(where) for x in (logits, seeds, steps, temp, top_k, top_p)]
        bits = smp.random_bits(args[1], args[2], width)
        noise = smp.gumbel_noise(args[1], args[2], args[3], width)
        toks = smp.sample_tokens(args[0], args[3], args[4], args[5], gumbel=noise)
        out[str(where)] = (bits.cpu(), noise.cpu(), toks.cpu())
    (bc, gc, tc), (bd, gd, td) = out["cpu"], out[str(dev)]
    ulp = torch.from_numpy(np.spacing(np.maximum(np.abs(gc.numpy()), 1.0).astype(np.float32)))
    record = {"phase": "sampling", "rows": b, "bits_equal": bool(torch.equal(bc, bd)),
              "gumbel_max_err_in_ulps": float(((gc - gd).abs() / ulp).max()),
              "tokens_equal": bool(torch.equal(tc, td)), "tokens": td.tolist()}
    emit(record)
    if not (record["bits_equal"] and record["tokens_equal"] and record["gumbel_max_err_in_ulps"] <= 2):
        raise AssertionError(f"seeded sampling on the card differs from the CPU's: {record}")
    return record


def fp8_kernel_checks(dev) -> dict:
    """The fp8 forms of paged_decode and paged_prefill against their plain
    versions: the GQA geometries of ``kernel_checks`` with bf16 queries on
    pages of 16 (decode: TMA), 12 (TMA boxes of 4 rows, lookups by division)
    and 5 (cp.async), llama-3.2-1b's also on pages of 8 and 4, f32 queries
    on pages of 16; decode at gappy T_q 1, 4 and 8 (and 32, MAX_VERIFY_T:
    8 row tiles, at 32/8 heads on pages of 16, hd 64 and 128), splits 1 and
    auto, with the bitwise T_q=1 / verify-column check; prefill chunks after a cached
    prefix beside 1-token rows; the serve's mixed step. Outputs are held at
    the bf16 tolerance (queries and p are staged in bf16)."""
    from dynamo_tpu_torch.ops import paged_decode as pd
    from dynamo_tpu_torch.ops import paged_prefill as pp

    rng = torch.Generator(device=dev).manual_seed(20)
    errs = {"paged_decode_fp8": 0.0, "paged_prefill_fp8": 0.0}
    bitwise = []
    runs = [(g, torch.bfloat16, ps) for g in ((32, 8, 64), (32, 8, 128), (64, 8, 64)) for ps in (16, 12, 5)]
    runs += [((32, 8, 64), torch.bfloat16, ps) for ps in (8, 4)]
    runs += [((32, 8, 64), torch.float32, 16), ((32, 8, 128), torch.float32, 16)]
    for (h, n_kv, hd), q_dtype, ps in runs:
        scale = hd**-0.5
        lengths = [1, 37, 300, 1000]
        npp = -(-1000 // ps) + 2
        tag = f"heads {h}/{n_kv} hd{hd} ps{ps} q {q_dtype}"
        for t in (1, 4, 8) + ((pd.MAX_VERIFY_T,) if (h, n_kv, ps) == (32, 8, 16) else ()):
            q, kc, vc, tb, pos, _ = _case(rng, dev, b=4, t=t, h=h, n_kv=n_kv, hd=hd, ps=ps, npp=npp, dtype=FP8,
                                          lengths=lengths, contiguous=False, q_dtype=q_dtype)
            for ns in (1, 0):
                got = pd.paged_decode_attention(q, kc, vc, tb[0], pos, scale=scale, num_splits=ns)
                want = pd.paged_decode_plain(q, kc, vc, tb[0], pos, scale=scale, num_splits=ns)
                errs["paged_decode_fp8"] = max(errs["paged_decode_fp8"], compare(
                    f"decode fp8 {tag} T{t} splits{ns}", got, want, [(i, t) for i in range(4)], torch.bfloat16))
                for j in range(t if t > 1 else 0):
                    one = pd.paged_decode_attention(q[:, j:j + 1].contiguous(), kc, vc, tb[0],
                                                    pos[:, j:j + 1].contiguous(), scale=scale, num_splits=ns)
                    bitwise.append(bool(torch.equal(one[:, 0], got[:, j])))
                    if not bitwise[-1]:
                        raise AssertionError(f"fp8: T_q=1 decode differs from verify column {j} ({tag} T{t} "
                                             f"splits{ns})")
        spans = [(900, 100), (0, 77), (499, 1), (650, 1)]
        q, kc, vc, tb, _, _ = _case(rng, dev, b=4, t=100, h=h, n_kv=n_kv, hd=hd, ps=ps, npp=npp, dtype=FP8,
                                    lengths=[s + n for s, n in spans], contiguous=True, q_dtype=q_dtype)
        pos = torch.from_numpy(_spans(spans, 100)).to(dev)
        got = pp.paged_prefill_attention(q, kc, vc, tb[0], pos, scale=scale)
        want = pp.paged_prefill_plain(q, kc, vc, tb[0], pos, scale=scale)
        errs["paged_prefill_fp8"] = max(errs["paged_prefill_fp8"], compare(
            f"prefill fp8 {tag}", got, want, [(i, n) for i, (_, n) in enumerate(spans)], torch.bfloat16))
    errs["paged_prefill_fp8"] = max(errs["paged_prefill_fp8"], mixed_step_check(dev, rng, FP8))
    emit({"phase": "kernels_fp8", "max_abs_err": errs,
          "tolerance": f"{REL_TOL[torch.bfloat16]} * max|plain| per row",
          "bitwise_verify_columns": f"{sum(bitwise)}/{len(bitwise)}"})
    if len(bitwise) < 264 or not all(bitwise):
        raise AssertionError(f"fp8: {sum(bitwise)}/{len(bitwise)} bitwise verify columns")
    return errs


# fp8-cache MLA geometries beyond MLA_GEOMS: a looped rope of 80 lanes (TMA
# boxes of 80 bytes), a rope whose boxes would land misaligned (cp.async),
# f32 queries. (heads, latent, rope lanes, rope stream width, nope dim,
# query dtype, page size).
MLA_PATHS_FP8 = {
    "rope-80 of 128": (32, 512, 80, 128, 128, torch.bfloat16, 16),
    "latent-128 rope-32 of 32 ps2 (cp.async)": (4, 128, 32, 32, 32, torch.bfloat16, 2),
    "mla-8b-proxy f32 queries": (32, 512, 64, 128, 128, torch.float32, 16),
}


def fp8_mla_kernel_checks(dev) -> dict:
    """The fp8 form of paged_mla against its plain version: the MLA_GEOMS
    geometries on pages of 16, 8 and 4, and MLA_PATHS_FP8, at gappy T_q 1, 4
    and 8 (at 4 heads also 20), splits 1, 2 and auto, with the bitwise
    T_q=1 / verify-column check (an unsplit verify row of two or more row
    tiles runs in a share group of 2, its T_q=1 columns in none: the plan
    must pick both sizes); chunks after a cached prefix beside 1-token rows
    (share groups whose ranks' walks end at different tiles, and padding
    ranks that only help fill); a 512-token chunk after 1024 cached tokens;
    the serve's mixed step; then ``share_soak``. Held at the bf16
    tolerance."""
    from dynamo_tpu_torch.ops import paged_mla as pm

    rng = torch.Generator(device=dev).manual_seed(21)
    err = 0.0
    bitwise, shares = [], set()
    runs = [(geom, dims, torch.bfloat16, ps) for geom, dims in MLA_GEOMS.items() for ps in (16, 8, 4)]
    runs += [(geom, dims[:5], dims[5], dims[6]) for geom, dims in MLA_PATHS_FP8.items()]
    for geom, (h, r_kv, dr, r_width, dn), q_dtype, ps in runs:
        scale = (dn + dr) ** -0.5
        dims = dict(h=h, r_kv=r_kv, dr=dr, r_width=r_width, dtype=FP8, q_dtype=q_dtype)
        lengths = [1, 37, 300, 1000]
        npp = -(-1000 // ps) + 2
        for t in (1, 4, 8, 20) if h == 4 else (1, 4, 8):
            pos = _positions(lengths, t, contiguous=False)
            real = [min(t, n) for n in lengths]
            q_lat, q_rope, c, r, tb, posd = _mla_case(rng, dev, pos, ps=ps, npp=npp, **dims)
            for ns in (1, 2, 0):
                tag = f"mla fp8 {geom} q {q_dtype} ps{ps} T{t} splits{ns}"
                got = pm.paged_mla(q_lat, q_rope, c, r, tb[0], posd, scale=scale, num_splits=ns)
                splits = pm.mla_split_plan(len(lengths), t, tb.shape[2], ps, ns, dev)[0]
                shares.add(pm.mla_share_plan(t, h, splits, FP8))
                want = pm.paged_mla_plain(q_lat, q_rope, c, r, tb[0], posd, scale=scale, num_splits=ns)
                err = max(err, compare(tag, got, want, list(enumerate(real)), torch.bfloat16))
                if t == 1 or (ns == 0 and t > pm.MAX_SPLIT_T):
                    continue
                for j in range(t):
                    one = pm.paged_mla(q_lat[:, j:j + 1].contiguous(), q_rope[:, j:j + 1].contiguous(), c, r,
                                       tb[0], posd[:, j:j + 1].contiguous(), scale=scale, num_splits=ns)
                    for i in range(len(lengths)):
                        if j < real[i]:
                            bitwise.append(bool(torch.equal(one[i, 0], got[i, j])))
                            if not bitwise[-1]:
                                raise AssertionError(f"T_q=1 decode differs from verify column {j} of row {i} "
                                                     f"({tag})")
        spans = [(900, 100), (0, 77), (499, 1), (650, 1)]
        case = _mla_case(rng, dev, _spans(spans, 100), ps=ps, npp=npp, **dims)
        case = (*case[:4], case[4][0], case[5])
        err = max(err, compare(f"mla fp8 chunk {geom} ps{ps}", pm.paged_mla(*case, scale=scale),
                               pm.paged_mla_plain(*case, scale=scale), [(i, n) for i, (_, n) in enumerate(spans)],
                               torch.bfloat16))
    h, r_kv, dr, r_width, dn = MLA_GEOMS[MLA_MODEL]
    case = _mla_case(rng, dev, _spans([(1024, 512)], 512), h=h, r_kv=r_kv, dr=dr, r_width=r_width, ps=16, npp=96,
                     dtype=FP8, q_dtype=torch.bfloat16)
    case = (*case[:4], case[4][0], case[5])
    err = max(err, compare("mla fp8 512 after 1024", pm.paged_mla(*case, scale=(dn + dr) ** -0.5),
                           pm.paged_mla_plain(*case, scale=(dn + dr) ** -0.5), [(0, 512)], torch.bfloat16))
    err = max(err, mla_mixed_step_check(dev, rng, FP8))
    soak = share_soak(dev, rng)
    emit({"phase": "kernels_mla_fp8", "max_abs_err": err,
          "tolerance": f"{REL_TOL[torch.bfloat16]} * max|plain| per row",
          "bitwise_verify_columns": f"{sum(bitwise)}/{len(bitwise)}", "share_groups": sorted(shares),
          "share_soak": soak})
    if len(bitwise) < 1164 or not all(bitwise) or shares != {1, 2}:
        raise AssertionError(f"mla fp8: {sum(bitwise)}/{len(bitwise)} bitwise verify columns, share groups "
                             f"{sorted(shares)}")
    return {"paged_mla_fp8": err}


def share_soak(dev, rng, n: int = SOAK_LAUNCHES) -> dict:
    """paged_mla's fp8 share groups launched back to back, with no host
    synchronisation between launches: the serve's mixed step (groups whose
    ranks' walks end at different tiles, the 1-token rows' groups a rank
    with rows and a padding helper) and a 512-token chunk after 1024 cached
    tokens (mla-8b-proxy, bf16 queries, pages of 16), ``n`` launches each,
    every output's real rows bitwise the first launch's (checked on the
    device). A lost arrival or byte count in the cluster protocol hangs a
    launch, and the phase with it. Returns the launches, their share group
    and the seconds each shape took."""
    from dynamo_tpu_torch.ops import paged_mla as pm

    h, r_kv, dr, r_width, dn = MLA_GEOMS[MLA_MODEL]
    out = {}
    for name, spans in (("mixed_step", MIXED_SPANS), ("chunk", [(1024, 512)])):
        case = _mla_case(rng, dev, _spans(spans, 512), h=h, r_kv=r_kv, dr=dr, r_width=r_width, ps=16, npp=128,
                         dtype=FP8, q_dtype=torch.bfloat16)
        q_lat, q_rope, c, r, tb, posd = case
        tb0, walk = tb[0].contiguous(), pm.walk_facts(posd)
        real = torch.zeros(posd.shape, dtype=torch.bool, device=dev)
        for i, (_, k) in enumerate(spans):
            real[i, :k] = True
        ref = pm.paged_mla(q_lat, q_rope, c, r, tb0, posd, scale=(dn + dr) ** -0.5, walk=walk)
        bad = torch.zeros((), dtype=torch.bool, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            got = pm.paged_mla(q_lat, q_rope, c, r, tb0, posd, scale=(dn + dr) ** -0.5, walk=walk)
            bad |= ((got != ref).flatten(2).any(-1) & real).any()
        torch.cuda.synchronize()
        out[name] = {"launches": n, "share": pm.mla_share_plan(512, h, 1, FP8),
                     "seconds": time.perf_counter() - t0}
        if bool(bad):
            raise AssertionError(f"share soak, {name}: a launch's output differs from the first's")
        del case, q_lat, q_rope, c, r, tb, ref, got
    return out


# -- phase 3: forward -----------------------------------------------------------


@contextlib.contextmanager
def plain_kernels():
    """Route the model's attention and MoE expert products through the
    kernels' plain PyTorch versions on the card, for as long as the context
    lasts."""
    from dynamo_tpu_torch.models import mla
    from dynamo_tpu_torch.ops import paged_decode as pd
    from dynamo_tpu_torch.ops import paged_mla as pm
    from dynamo_tpu_torch.ops import paged_prefill as pp

    saved = pd.paged_decode_attention, pp.paged_prefill_attention, mla.paged_mla
    pd.paged_decode_attention = pd.paged_decode_plain
    pp.paged_prefill_attention = pp.paged_prefill_plain
    mla.paged_mla = lambda *args, walk=None, **kw: pm.paged_mla_plain(*args, **kw)
    try:
        with plain_experts():
            yield
    finally:
        pd.paged_decode_attention, pp.paged_prefill_attention, mla.paged_mla = saved


@contextlib.contextmanager
def plain_experts():
    """Route every MoE expert product through ``grouped_matmul``'s plain
    PyTorch version on the card, for as long as the context lasts."""
    from dynamo_tpu_torch.ops import grouped_matmul as gmm
    from dynamo_tpu_torch.parallel import moe

    saved = moe.grouped_matmul
    moe.grouped_matmul = gmm.grouped_matmul_plain
    try:
        yield
    finally:
        moe.grouped_matmul = saved


def weights_of(params: dict) -> str:
    """The format of a parameter tree's projections: "int8", "int4" or "bf16"."""
    wq = params["layers"].get("wq", params["layers"].get("w_kv_a"))
    return ("int4" if "qw4" in wq else "int8") if isinstance(wq, dict) else "bf16"


@contextlib.contextmanager
def plain_quant():
    """Route every quantized projection through ``quant_matmul``'s plain
    PyTorch version on the card, for as long as the context lasts."""
    from dynamo_tpu_torch.ops import quant_matmul as qmm

    saved = qmm.quant_matmul
    qmm.quant_matmul = qmm.quant_matmul_plain
    try:
        yield
    finally:
        qmm.quant_matmul = saved


def forward_check(dev, model: str, cache_dtype: torch.dtype | None = None, params: dict | None = None,
                  quant: str = "") -> None:
    """One prefill chunk (T=64, two rows, the second continuing at 64) and
    one decode step of ``model`` at full width on ``cache_dtype`` caches
    (the model's dtype when None), run with the kernels and with plain
    attention from the same caches: the gather reference, except for MLA
    on an fp8 cache, which is held against the kernels' plain versions (the
    MLA gather reference rounds p to fp8 as JAX's reference does,
    models/mla.py:237, not to the kernels' bf16). With ``quant`` (the
    format of ``params``' quantized leaves) the plain side also runs
    quant_matmul's plain version; a MoE model's plain side runs
    grouped_matmul's plain version (``plain_experts``)."""
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.models.config import PRESETS

    cfg = PRESETS[model]
    params = params if params is not None else llama.init_params(cfg, 0, device=dev)
    ps, npages = 16, 64
    kc0, vc0 = llama.init_kv_cache(cfg, npages, ps, dtype=cache_dtype, device=dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    b, t = 2, 64
    tables = torch.arange(1, 19, dtype=torch.int32, device=dev).view(b, 9)  # 9 pages of 16 tokens per row
    starts = [0, 64]
    # Row 1 continues a 64-token prefix: fill it with the plain path first.
    tokens0 = torch.randint(0, cfg.vocab_size, (1, 64), generator=gen, device=dev, dtype=torch.int32)
    pos0 = torch.arange(64, device=dev, dtype=torch.int32)[None]
    slots0 = (tables[1:2, (pos0[0] // ps).long()] * ps + pos0 % ps).to(torch.int32)
    llama.forward(params, cfg, tokens0, pos0, kc0, vc0, tables[1:2], slots0,
                  torch.tensor([63], dtype=torch.int32, device=dev), attn_impl="reference")
    tokens = torch.randint(0, cfg.vocab_size, (b, t), generator=gen, device=dev, dtype=torch.int32)
    pos = torch.stack([torch.arange(s, s + t, device=dev, dtype=torch.int32) for s in starts])
    slots = torch.stack([tables[i, (pos[i] // ps).long()] * ps + pos[i] % ps for i in range(b)]).to(torch.int32)
    last = torch.full((b,), t - 1, dtype=torch.int32, device=dev)
    dec_tok = torch.randint(0, cfg.vocab_size, (b, 1), generator=gen, device=dev, dtype=torch.int32)
    dec_pos = pos[:, -1:] + 1
    dec_slots = torch.stack([tables[i, (dec_pos[i] // ps).long()] * ps + dec_pos[i] % ps for i in range(b)]).to(torch.int32)
    baseline = "plain" if kc0.dtype == FP8 and cfg.attn_type == "mla" else "reference"
    results = {}
    with torch.inference_mode():
        for impl in (None, baseline):
            kc, vc = kc0.clone(), vc0.clone()
            with plain_kernels() if impl == "plain" else contextlib.nullcontext(), \
                    plain_quant() if impl is not None and quant else contextlib.nullcontext(), \
                    plain_experts() if impl == "reference" else contextlib.nullcontext():
                attn_impl = "reference" if impl == "reference" else None
                pre, _, _ = llama.forward(params, cfg, tokens, pos, kc, vc, tables, slots, last, attn_impl=attn_impl)
                dec, _, _ = llama.forward(params, cfg, dec_tok, dec_pos, kc, vc, tables, dec_slots,
                                          torch.zeros(b, dtype=torch.int32, device=dev), attn_impl=attn_impl)
            results[impl] = (pre, dec)
    torch.cuda.synchronize()
    errs = {}
    for i, phase in enumerate(("prefill", "decode")):
        a, r = results[None][i], results[baseline][i]
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"forward {phase}: non-finite logits")
        errs[phase] = float((a - r).abs().max())
        scale = float(r.abs().max())
        # bf16 weights and activations through 16 (32) layers: the two
        # attention implementations round differently (~2**-8 relative per
        # layer); allow 5% of the largest logit.
        if not errs[phase] <= 0.05 * scale:
            raise AssertionError(f"forward {phase}: max abs err {errs[phase]} > 5% of max |logit| {scale}")
        errs[f"{phase}_argmax_equal"] = bool(torch.equal(a.argmax(-1), r.argmax(-1)))
    emit({"phase": "forward", "model": model, "cache": str(kc0.dtype).removeprefix("torch."), "baseline": baseline,
          "weights": quant or "bf16",
          "logits_max_abs_err": errs,
          "tolerance": "0.05 * max|logit|", "logits_shape": list(results[None][0].shape)})


# -- phase 3b: graphs -----------------------------------------------------------


def graph_check(dev, model: str, params: dict, cache_dtype: torch.dtype | None = None) -> dict:
    """Graph replay against the eager step on the same inputs, at full
    width: two runners on the same weights, one replaying CUDA graphs (the
    main path), one eager, each on its own cache, take the same steps:
    a prefill of two 64-token prompts, a mixed step (one decode row, one
    prompt's second 48-token chunk, a new 40-token prompt; a mixed-step key),
    then two decode steps (a decode key: its second use a replay alone).
    The graph runner dispatches every step with ``step_async``, each
    decode row's input token chained on the card from the step before; the
    eager runner gets the same tokens from the host.
    One row samples (seeded), every step asks for logprobs. Tokens,
    logprobs and top-20 ids and logprobs must be bitwise equal."""
    from dynamo_tpu_torch.engine.runner import StepBatch, TorchModelRunner
    from dynamo_tpu_torch.models.config import PRESETS

    cfg = PRESETS[model]
    ps, npages, lp_k = 16, 64, 20
    runners = {g: TorchModelRunner(cfg, params, num_pages=npages, page_size=ps, max_batch_size=8,
                                   cache_dtype=cache_dtype, device=dev, graphs=g) for g in (True, False)}
    rng = np.random.default_rng(9)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in (64, 112, 40)]
    tables = np.arange(1, 1 + 3 * 8, dtype=np.int32).reshape(3, 8)  # 8 pages of 16 tokens per row

    def batch(rows, tokens):
        """rows: (row id, start position, new tokens); row 1 samples."""
        b, t = len(rows), max(n for _, _, n in rows)
        tok = np.zeros((b, t), np.int32)
        pos = np.zeros((b, t), np.int32)
        for i, (r, start, n) in enumerate(rows):
            tok[i, :n] = tokens[i]
            pos[i, :n] = np.arange(start, start + n)
        tb = tables[[r for r, _, _ in rows]]
        slots = (tb[np.arange(b)[:, None], pos // ps] * ps + pos % ps).astype(np.int32)
        for i, (_, _, n) in enumerate(rows):
            slots[i, n:] = 0  # padding columns write to the null page, as the engine's do
        temp = np.array([0.8 if r == 1 else 0.0 for r, _, _ in rows], np.float32)
        return StepBatch(tok, pos, tb, slots, np.array([n - 1 for _, _, n in rows], np.int32), temp,
                         np.zeros(b, np.int32), np.full(b, 0.95, np.float32), np.full(b, 1234, np.uint32),
                         np.array([start for _, start, _ in rows], np.int32), np.zeros(b, np.float32),
                         np.zeros(b, np.float32), np.full(b, 8 * ps, np.int32), np.full((b, 1), -1, np.int32))

    def same(a, b) -> bool:
        return a.dtype == b.dtype and np.array_equal(a.view(np.int32), b.view(np.int32))

    def run(name, rows, graph_tokens, eager_tokens, **chain):
        """One step on both runners (the graph runner's through
        ``step_async``); records whether they agree bitwise and returns the
        eager runner's tokens."""
        g_toks, g_aux = runners[True].step_async(batch(rows, graph_tokens), lp_k, **chain).result()
        e_toks, e_aux = runners[False].step(batch(rows, eager_tokens), lp_k=lp_k)
        ok = same(g_toks[:, 0], e_toks) and all(same(g_aux[k], e_aux[k]) for k in ("logprob", "top_ids", "top_lps"))
        steps.append({"step": name, "tokens": len(e_toks), "bitwise_equal": ok})
        return e_toks

    steps = []
    first = run("prefill", [(0, 0, 64), (1, 0, 64)], *[[prompts[0], prompts[1][:64]]] * 2)
    mixed = [[first[0]], prompts[1][64:], prompts[2]]
    prev = run("mixed", [(0, 64, 1), (1, 64, 48), (2, 0, 40)], mixed, mixed)
    for k in range(2):
        prev = run(f"decode{k}", [(r, (65, 112, 40)[r] + k, 1) for r in range(3)], [[0]] * 3,
                   [[int(t)] for t in prev], chain=True, chain_src=[0, 1, 2])
    equal = all(st["bitwise_equal"] for st in steps)
    stats = runners[True].graph_stats()
    record = {"phase": "graphs", "model": model, "cache": str(runners[True].k_cache.dtype).removeprefix("torch."),
              "weights": weights_of(params),
              "steps": steps, "keys_captured": stats["keys"], "capture_s": stats["capture_s"],
              "pool_bytes": stats["pool_bytes"]}
    emit(record)
    if not equal or stats["keys"] != 3:
        raise AssertionError(f"graph replay differs from the eager step: {record}")
    del runners
    gc.collect()
    torch.cuda.empty_cache()
    return record


# -- phase 4: serve -------------------------------------------------------------


async def build_serving(model: str = MODEL, cache_dtype: torch.dtype | None = None, params: dict | None = None,
                        *, graphs: bool = True, overlap: bool = True, **engine_kw):
    """The serve phase's engine and pipeline: ``build_engine_service`` of
    ``model`` (random init from seed 0, or ``params``; bf16; on the card;
    ``cache_dtype`` caches, the model's dtype when None; ``engine_kw`` on
    top of SERVE_ENGINE) behind ``build_pipeline``; by default the main
    path, CUDA graphs behind the overlapped engine."""
    from dynamo_tpu_torch.launch import build_engine_service, build_pipeline

    service = await build_engine_service(model, cache_dtype=cache_dtype, params=params, graphs=graphs,
                                         overlap=overlap, **SERVE_ENGINE, **engine_kw)
    return service, build_pipeline(service)


def serve_bodies(rng: np.random.Generator, model: str = MODEL) -> list[dict]:
    """The serve mix: one OpenAI completion body per ``SERVE_LENGTHS`` prompt
    length, random letters, 32 output tokens each; greedy except one seeded
    nucleus-sampled request."""
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz ", dtype=np.uint8)
    bodies = []
    for i, n in enumerate(SERVE_LENGTHS):
        body = {"model": model, "prompt": bytes(rng.choice(letters, n - 1)).decode(),  # + BOS = n tokens
                "max_tokens": 32, "temperature": 0.0, "nvext": {"ignore_eos": True}}
        if i == 3:
            body.update(temperature=0.8, top_p=0.95, seed=1234)
        bodies.append(body)
    return bodies


async def warm_up(pipeline, model: str = MODEL) -> None:
    """One request outside any measurement: CUDA lazy loading, cuBLAS
    heuristics and allocator growth would otherwise land in the first timed
    requests' TTFT."""
    from dynamo_tpu_torch.runtime.engine import Context

    warm = {"model": model, "prompt": "w" * 600, "max_tokens": 4, "temperature": 0.0,
            "nvext": {"ignore_eos": True}}
    async for _ in pipeline.generate(warm, Context()):
        pass


async def send_all(pipeline, bodies: list[dict], lengths: list[int] = SERVE_LENGTHS) -> list[dict]:
    """Send every body concurrently; per request its prompt length (from
    ``lengths``), tokens, text, time to first token and finish reason."""
    from dynamo_tpu_torch.runtime.engine import Context

    async def one(body: dict, n: int) -> dict:
        sent = time.perf_counter()
        first, toks, text, finish = None, [], "", None
        async for out in pipeline.generate(body, Context()):
            if out.token_ids and first is None:
                first = time.perf_counter() - sent
            toks += out.token_ids
            text += out.text or ""
            finish = out.finish_reason
        return {"n_prompt": n, "tokens": toks, "text": text, "ttft_s": first, "finish": finish}

    return await asyncio.gather(*(one(body, n) for body, n in zip(bodies, lengths)))


@contextlib.contextmanager
def record_draws(runner):
    """For as long as the context lasts, record every dispatch in which
    ``runner`` samples a row with temperature > 0, through its ``draw_hook``
    (a graph replay or ``step_async`` calls no Python per row): the host's
    padded ``StepBatch`` (seeds, sample steps, temperatures, top-k, top-p,
    before they are packed and copied to the card) and, for those rows
    only, the logits the card sampled from, its Gumbel noise, its tokens
    and any penalty inputs, read from the step's own tensors (a graph's
    static outputs under replay). The rows are copied on the card as they
    are dispatched (a copy kernel, no wait, no module loaded lazily), and
    to the host when the context ends. Yields the list."""
    steps = []

    def hook(batch, draw):
        rows = np.flatnonzero(batch.temperature > 0)
        if draw["gumbel"] is None or not rows.size:
            return
        pen = ("history", "frequency_penalty", "presence_penalty")
        steps.append({"batch": batch, "rows": rows,
                      **{k: [draw[k][r:r + 1].clone() for r in rows] for k in ("logits", "gumbel", "tokens")},
                      "pen": {k: [draw[k][r:r + 1].clone() for r in rows] for k in pen if k in draw}})

    runner.draw_hook = hook
    try:
        yield steps
    finally:
        runner.draw_hook = None
        for st in steps:
            for k in ("logits", "gumbel", "tokens"):
                st[k] = torch.cat(st[k]).cpu()
            st["logits"] = st["logits"].float()
            st["pen"] = {k: torch.cat(v).cpu() for k, v in st["pen"].items()}


def replay_draws(steps: list[dict], tokens: list[int]) -> dict:
    """Hold the card's draws (``record_draws``) against the port's CPU draw:
    the noise (``gumbel_noise``) and tokens (``sample_tokens``) recomputed
    on the CPU from the host's seeds, steps, temperatures, top-k and top-p
    and the card's logits. Tokens must be equal, the noise within 2 ulps of
    max(|g|, 1), and ``tokens`` (the one sampled request's output) the last
    of its row's draws."""
    from dynamo_tpu_torch.ops import sampling as smp

    sampled = [s for s in steps if "rows" in s]
    drawn, err, equal = [], 0.0, True
    for s in sampled:
        bt, rows = s["batch"], s["rows"]
        seeds = torch.from_numpy(bt.seeds[rows].astype(np.uint32).view(np.int32).copy())
        temp = torch.from_numpy(bt.temperature[rows].astype(np.float32))
        noise = smp.gumbel_noise(seeds, torch.from_numpy(bt.sample_steps[rows].astype(np.int32)), temp,
                                 s["gumbel"].shape[-1])
        toks = smp.sample_tokens(s["logits"], temp, torch.from_numpy(bt.top_k[rows].astype(np.int32)),
                                 torch.from_numpy(bt.top_p[rows].astype(np.float32)), gumbel=noise, **s["pen"])
        ulp = torch.from_numpy(np.spacing(np.maximum(np.abs(noise.numpy()), 1.0).astype(np.float32)))
        err = max(err, float(((noise - s["gumbel"]).abs() / ulp).max()))
        equal &= bool(torch.equal(toks, s["tokens"]))
        drawn.append(s["tokens"].tolist())
    record = {"sampled_steps": len(sampled), "rows_per_step": sorted({len(d) for d in drawn}),
              "tokens_equal_cpu_draw": equal, "gumbel_max_err_in_ulps": err}
    # One sampled row a step: the request's first token is drawn by its last
    # prefill chunk, each later one by a step of its own.
    mine = [d[0] for d in drawn[-len(tokens):]]
    if not (equal and err <= 2 and record["rows_per_step"] == [1] and mine == tokens):
        raise AssertionError(f"seeded sampling on the card differs from the CPU's draw: {record}")
    return record


def _overlap_counts(core) -> dict:
    return {"steps": dict(core.overlap_step_counts), "barriers": dict(core.overlap_barrier_counts)}


def _counts_since(now: dict, then: dict) -> dict:
    return {k: n - then.get(k, 0) for k, n in now.items() if n - then.get(k, 0)}


def quant_launches_per_forward(model: str, params: dict) -> int:
    """quant_matmul launches one forward makes: one per quantized leaf of a
    layer, times the layers, plus a quantized head."""
    from dynamo_tpu_torch.models.quant import is_quantized

    layers = params["layers"]
    per_layer = sum(1 for leaf in layers.values() if is_quantized(leaf))
    first = next(leaf for leaf in layers.values() if is_quantized(leaf))
    n_layers = first["qw" if "qw" in first else "qw4"].shape[0]
    return per_layer * n_layers + int(is_quantized(params.get("lm_head")))


async def serve(model: str, cache_dtype: torch.dtype | None = None, params: dict | None = None, *,
                eager: bool = False, quant: str = "", profile: bool = False) -> tuple[dict, list[list[int]]]:
    """Serve the mix on ``model`` with ``cache_dtype`` caches: the main path
    (CUDA graphs, overlapped engine), or with ``eager`` the eager runner
    behind the synchronous engine. One warm-up request and one pass of a
    mix of other prompts (same lengths, so mostly the same graph keys) go
    first, untimed; then the timed pass. Returns the phase's record, which
    holds the launches of its kernels (``SERVE_KERNELS``; their fp8 forms,
    named ``<kernel>_fp8``, on an fp8 cache, counted through graph replays)
    over the timed requests, and each timed request's tokens. With
    ``quant`` ("int8" or "int4": ``params`` hold such leaves, passed with
    ``quantize=quant``) the record holds ``quant_matmul_<quant>``'s
    launches too, which must equal the launches a forward makes times the
    forwards run: every engine step, and the warm-up of every graph key
    captured in the window. A MoE model's ``grouped_matmul`` launches must
    likewise equal three a MoE layer times the forwards run. ``profile``
    serves a mix of fresh prompts of the same lengths after the timed pass
    under ``torch.profiler`` and reports the device's busy share there."""
    from dynamo_tpu_torch.models.config import PRESETS

    fp8 = cache_dtype == FP8
    kernels = {}
    for name in SERVE_KERNELS[model]:
        f8 = fp8 and name in FP8_FORMS
        kernels[name + ("_fp8" if f8 else "")] = (importlib.import_module(f"dynamo_tpu_torch.ops.{name}"),
                                                  "launches_fp8" if f8 else "launches")
    if quant:
        kernels[f"quant_matmul_{quant}"] = (importlib.import_module("dynamo_tpu_torch.ops.quant_matmul"),
                                            f"launches_{quant}")
    t0 = time.perf_counter()
    service, pipeline = await build_serving(model, cache_dtype, params, graphs=not eager, overlap=not eager,
                                            quantize=quant)
    build_s = time.perf_counter() - t0
    core = service.core
    if cache_dtype is not None and core.runner.k_cache.dtype != cache_dtype:
        raise AssertionError(f"asked for a {cache_dtype} cache, got {core.runner.k_cache.dtype}")
    if core.runner.graphs == eager or core.config.overlap == eager:
        raise AssertionError(f"asked for eager={eager}, got graphs={core.runner.graphs}, "
                             f"overlap={core.config.overlap}")
    bodies = serve_bodies(np.random.default_rng(3), model)
    try:
        t0 = time.perf_counter()
        await warm_up(pipeline, model)
        await send_all(pipeline, serve_bodies(np.random.default_rng(4), model))
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        graphs0 = core.runner.graph_stats()
        # Counters go to 0 just before the main path and are read just after;
        # the engine's own cumulative counters are read as differences.
        dispatch0, mixed0, overlap0 = dict(core.attn_dispatch_counts), core.mixed_steps, _overlap_counts(core)
        for mod, name in kernels.values():
            setattr(mod, name, 0)
        with record_draws(core.runner) as draws:
            start = time.perf_counter()
            results = await send_all(pipeline, bodies)
            torch.cuda.synchronize()
            wall = time.perf_counter() - start
        launches = {name: getattr(mod, attr) for name, (mod, attr) in kernels.items()}
        per_forward = quant_launches_per_forward(model, core.runner.params) if quant else 0
        graphs1 = core.runner.graph_stats()
        overlap1 = _overlap_counts(core)
        cache = str(core.runner.k_cache.dtype).removeprefix("torch.")
        dispatch = {f"{p}/{k}": n - dispatch0.get((p, k), 0) for (p, k), n in core.attn_dispatch_counts.items()}
        mixed = core.mixed_steps - mixed0
        # Every counter above is read: the profiled pass counts in none.
        busy = None
        if profile:
            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                t1 = time.perf_counter()
                # Fresh prompts of the same lengths: the timed ones would hit the prefix cache.
                profiled = await send_all(pipeline, serve_bodies(np.random.default_rng(5), model))
                torch.cuda.synchronize()
                prof_wall = time.perf_counter() - t1
            kern = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
            busy = {"device_busy_share": busy_us(kern) / 1e6 / prof_wall, "wall_s": prof_wall,
                    "output_tokens_per_s": sum(len(r["tokens"]) for r in profiled) / prof_wall,
                    "cuda_kernels": len(kern)}
    finally:
        await service.close()
    for r in results:
        if len(r["tokens"]) != 32 or r["finish"] is None or r["finish"].value != "length":
            raise AssertionError(f"request of {r['n_prompt']} tokens ended with {len(r['tokens'])} tokens ({r['finish']})")
        if not all(0 <= tok < PRESETS[model].vocab_size for tok in r["tokens"]):
            raise AssertionError("token id outside the vocabulary")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    off_kernel = {k: n for k, n in dispatch.items() if n and not k.endswith("/kernel")}
    if off_kernel:
        raise AssertionError(f"engine steps whose attention did not run in the kernels: {off_kernel}")
    if mixed <= 0:
        raise AssertionError("no mixed prefill+decode step occurred")
    forwards = sum(dispatch.values()) + graphs1["keys"] - graphs0["keys"]
    if quant and launches[f"quant_matmul_{quant}"] != per_forward * forwards:
        raise AssertionError(f"quant_matmul_{quant} launched {launches[f'quant_matmul_{quant}']} times, not "
                             f"{per_forward} a forward x {forwards} forwards")
    if "grouped_matmul" in launches and launches["grouped_matmul"] != moe_launches_per_forward(model) * forwards:
        raise AssertionError(f"grouped_matmul launched {launches['grouped_matmul']} times, not "
                             f"{moe_launches_per_forward(model)} a forward x {forwards} forwards")
    overlap = {"steps": _counts_since(overlap1["steps"], overlap0["steps"]),
               "barriers": _counts_since(overlap1["barriers"], overlap0["barriers"])}
    if not eager and overlap["steps"].get("overlapped", 0) <= 0:
        raise AssertionError(f"the overlapped engine never overlapped a step: {overlap}")
    ((body, seeded),) = [(b, r["tokens"]) for b, r in zip(bodies, results) if b["temperature"] > 0]
    draws = replay_draws(draws, seeded)
    out_tokens = sum(len(r["tokens"]) for r in results)
    ttfts = sorted(r["ttft_s"] for r in results)
    record = {"phase": "serve", "model": model, "cache": cache, "weights": quant or "bf16",
              "mode": "eager, synchronous engine" if eager else "cuda graphs, overlapped engine",
              "requests": len(results), "prompt_tokens": SERVE_LENGTHS,
              "output_tokens": out_tokens, "wall_s": wall, "requests_per_s": len(results) / wall,
              "output_tokens_per_s": out_tokens / wall,
              "ttft_s": {"min": ttfts[0], "median": statistics.median(ttfts), "max": ttfts[-1]},
              "engine_build_s": build_s, "warm_up_s": warm_s, "kernel_launches": launches,
              "quant_launches_per_forward": per_forward,
              "engine_steps": sum(dispatch.values()), "mixed_steps": mixed, "attn_dispatch_steps": dispatch,
              "overlap": overlap,
              "graphs": {"keys": graphs1["keys"], "keys_captured_in_window": graphs1["keys"] - graphs0["keys"],
                         "capture_s": graphs1["capture_s"], "pool_bytes": graphs1["pool_bytes"]},
              "seeded_request": {**{k: body[k] for k in ("temperature", "top_p", "seed")}, **draws}}
    if busy is not None:
        record["profiled_pass"] = busy
    emit(record)
    return record, [r["tokens"] for r in results]


def serve_both(model: str, cache_dtype: torch.dtype | None, params: dict, quant: str = "") -> dict:
    """The mix served twice in one run: the eager runner behind the
    synchronous engine, then the main path. Every request's tokens must be
    bitwise equal (every step carries the same rows and shapes in both
    modes, and a replay runs the eager step's kernels on the same inputs).
    Returns the main path's record."""
    eager, eager_tokens = asyncio.run(serve(model, cache_dtype, params, eager=True, quant=quant))
    gc.collect()
    torch.cuda.empty_cache()
    main_path, tokens = asyncio.run(serve(model, cache_dtype, params, quant=quant))
    gc.collect()
    torch.cuda.empty_cache()
    greedy = [i for i, body in enumerate(serve_bodies(np.random.default_rng(3), model)) if body["temperature"] == 0]
    differ = [SERVE_LENGTHS[i] for i in range(len(tokens)) if tokens[i] != eager_tokens[i]]
    emit({"phase": "serve_modes", "model": model, "cache": main_path["cache"], "weights": quant or "bf16",
          "tokens_equal": not differ, "requests_differing_by_prompt_tokens": differ,
          "output_tokens_per_s": {"eager_sync": eager["output_tokens_per_s"],
                                  "graphs_overlap": main_path["output_tokens_per_s"]},
          "speedup": main_path["output_tokens_per_s"] / eager["output_tokens_per_s"]})
    if any(SERVE_LENGTHS[i] in differ for i in greedy):
        raise AssertionError(f"greedy tokens of the graph-replayed overlapped serve differ from the eager "
                             f"synchronous serve's (requests of {differ} prompt tokens)")
    return main_path


# -- phase 5: http --------------------------------------------------------------

HTTP_WORKERS = 2
CLOSE_TOKENS = 256  # the request that outlives the other worker's close()
LONG_TOKENS = 1024  # each request of the burst both workers must step beside


async def stream_completion(session, base: str, body: dict, first_chunk: asyncio.Event | None = None, *,
                            headers: dict | None = None, allow_error: bool = False) -> dict:
    """One streamed ``/v1/completions`` request with usage: the arrival time
    of each SSE chunk after sending, the text, finish reason and usage, the
    legacy logprobs (``token_logprobs``, ``top_logprobs``) where the body
    asked for them, and whether the stream ended with ``[DONE]``. Sets
    ``first_chunk``, if given, when the first chunk arrives. ``headers`` go
    with the request; with ``allow_error`` an HTTP error status or an error
    event ends the stream and is returned under ``error`` instead of
    raising."""
    sent = time.perf_counter()
    arrivals, text, finish, usage, done = [], [], None, None, False
    token_logprobs, top_logprobs = [], []
    body = {**body, "stream": True, "stream_options": {"include_usage": True}}
    async with session.post(base + "/v1/completions", json=body, headers=headers) as r:
        if r.status != 200:
            if allow_error:
                return {"error": {"status": r.status, "body": await r.text()}, "arrivals": [], "done": False,
                        "finish": None, "usage": None, "total_s": time.perf_counter() - sent}
            raise AssertionError(f"HTTP {r.status}: {await r.text()}")
        async for line in r.content:
            line = line.strip()
            if not line.startswith(b"data: "):
                continue
            payload = line[len(b"data: "):]
            if payload == b"[DONE]":
                done = True
                continue
            if done:
                raise AssertionError("an SSE chunk after [DONE]")
            doc = json.loads(payload)
            if "error" in doc:
                if not allow_error:
                    raise AssertionError(f"error event in the stream: {doc}")
                finish = "error"
                continue
            arrivals.append(time.perf_counter() - sent)
            if first_chunk is not None:
                first_chunk.set()
            choice = doc["choices"][0]
            text.append(choice["text"])
            if choice.get("logprobs"):
                token_logprobs += choice["logprobs"]["token_logprobs"]
                top_logprobs += choice["logprobs"]["top_logprobs"]
            finish = choice["finish_reason"] or finish
            usage = doc.get("usage") or usage
    return {"arrivals": arrivals, "text": "".join(text), "finish": finish, "usage": usage, "done": done,
            "total_s": time.perf_counter() - sent, "sent_at": sent, "token_logprobs": token_logprobs, "top_logprobs": top_logprobs}


async def http_get(session, base: str, path: str):
    async with session.get(base + path) as r:
        if r.status != 200:
            raise AssertionError(f"GET {path}: HTTP {r.status}")
        return await (r.json() if r.content_type == "application/json" else r.text())


def _metric_sum(text: str, family: str) -> tuple[float, float]:
    """(sum, count) of a histogram family in Prometheus text."""
    vals = {}
    for line in text.splitlines():
        for suffix in ("_sum", "_count"):
            if line.startswith(family + suffix + "{") or line.startswith(family + suffix + " "):
                vals[suffix] = vals.get(suffix, 0.0) + float(line.rsplit(" ", 1)[1])
    return vals.get("_sum", 0.0), vals.get("_count", 0.0)


def token_mismatch(http: dict, entries: list[dict], n: int) -> str | None:
    """Why an HTTP stream's tokens are not those of an in-process run of the
    same body, or None. ``http`` is a ``stream_completion`` result,
    ``entries`` the run's ``BackendOutput.logprobs``, ``n`` the tokens both
    must hold. Random weights over llama's 128256 ids behind the byte
    tokenizer give almost no token text, so the text cannot tell two token
    streams apart: each position's logprob and its top alternatives' must
    be bitwise the in-process run's (JSON carries a float exactly)."""
    got = http["token_logprobs"]
    if len(entries) != n or len(got) != n or len(http["top_logprobs"]) != n:
        return f"{len(got)} HTTP and {len(entries)} in-process logprob positions, want {n}"
    want = [e["logprob"] for e in entries]
    if got != want:
        i = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
        return f"position {i}: HTTP logprob {got[i]!r} != in-process {want[i]!r}"
    for i, (top, e) in enumerate(zip(http["top_logprobs"], entries)):
        if sorted(top.values()) != sorted(t[1] for t in e["top"]):
            return f"position {i}: HTTP top logprobs {top} != in-process {e['top']}"
    return None


def logprob_diff(a: list[float], b: list[float]) -> float | None:
    """Max |a - b| over positions, None when the lengths differ."""
    return max((abs(x - y) for x, y in zip(a, b)), default=0.0) if len(a) == len(b) else None


async def until(probe, what: str, timeout: float = 10.0):
    """Poll ``probe`` every 10 ms until it returns something true; return it.
    Raises naming ``what`` after ``timeout`` seconds."""
    for _ in range(int(timeout / 0.01)):
        got = probe()
        if got:
            return got
        await asyncio.sleep(0.01)
    raise AssertionError(f"{what}: not seen within {timeout} s")


async def serve_http(in_process: dict) -> dict:
    """``run_local`` of MODEL on the card (HTTP_WORKERS workers behind the KV
    router, the OpenAI frontend on a free port, the seed of phase 4): the
    plain routes; phase 4's mix as concurrent streamed completions; a window
    in which both workers step at once; a repeat prompt routed to the worker
    holding its blocks; one greedy body on a cold worker whose tokens must
    be a cold in-process service's; one uncached request alone on the warm
    server, timed over HTTP and in-process; and one worker closed while the
    other serves."""
    import aiohttp

    from dynamo_tpu_torch.launch import build_pipeline, run_local, shutdown
    from dynamo_tpu_torch.runtime.engine import Context
    from dynamo_tpu_torch.tokenizer import ByteTokenizer
    from dynamo_tpu_torch.tokens import compute_block_hashes
    from dynamo_tpu_torch.tracing import SPANS

    kernels = {name: importlib.import_module(f"dynamo_tpu_torch.ops.{name}") for name in SERVE_KERNELS[MODEL]}
    rng = np.random.default_rng(5)
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz ", dtype=np.uint8)
    greedy = {"model": MODEL, "max_tokens": 32, "temperature": 0.0, "nvext": {"ignore_eos": True}}
    # Bodies whose tokens are compared ask for the 5 best alternatives'
    # logprobs of every position (see token_mismatch).
    cold_body = {**greedy, "prompt": bytes(rng.choice(letters, 299)).decode(), "logprobs": 5}
    alone_body = {**cold_body, "prompt": bytes(rng.choice(letters, 299)).decode()}
    wrng = np.random.default_rng(6)
    # The first burst must outlast the router's view of load (published
    # every 0.5 s) by a margin: ~1,000 graph-replayed decode steps.
    long_bodies = [{**greedy, "prompt": bytes(wrng.choice(letters, 299)).decode(), "max_tokens": LONG_TOKENS}
                   for _ in range(4)]
    short_bodies = [{**greedy, "prompt": bytes(wrng.choice(letters, 299)).decode()} for _ in range(4)]
    t0 = time.perf_counter()
    handles = await run_local(MODEL, port=0, num_workers=HTTP_WORKERS, router_mode="kv", device="cuda",
                              overlap=True, **SERVE_ENGINE)
    build_s = time.perf_counter() - t0
    base = f"http://127.0.0.1:{handles['port']}"
    cores = [svc.core for svc in handles["services"]]

    def counts() -> list[tuple[dict, int, int]]:
        return [(dict(c.attn_dispatch_counts), c.mixed_steps, c.metrics().prompt_tokens_total) for c in cores]

    def since(before: list[tuple[dict, int, int]]) -> tuple[dict, list[int], list[int], list[int]]:
        """Attention dispatches (all workers), and per worker the steps,
        mixed steps and prompt tokens since ``before``."""
        dispatch, steps, mixed, prompt_tokens = {}, [], [], []
        for core, (d0, m0, p0) in zip(cores, before):
            for (p, k), n in core.attn_dispatch_counts.items():
                dispatch[f"{p}/{k}"] = dispatch.get(f"{p}/{k}", 0) + n - d0.get((p, k), 0)
            steps.append(sum(core.attn_dispatch_counts.values()) - sum(d0.values()))
            mixed.append(core.mixed_steps - m0)
            prompt_tokens.append(core.metrics().prompt_tokens_total - p0)
        return dispatch, steps, mixed, prompt_tokens

    try:
        async with aiohttp.ClientSession() as session:
            models = await http_get(session, base, "/v1/models")
            if [m["id"] for m in models["data"]] != [MODEL]:
                raise AssertionError(f"/v1/models lists {models}")
            health = await http_get(session, base, "/health")
            if health["status"] != "healthy":
                raise AssertionError(f"/health says {health}")
            if "dynamo_frontend_requests_total" not in await http_get(session, base, "/metrics"):
                raise AssertionError("/metrics holds no dynamo_frontend families")

            # Both workers are cold: the router sends this to one of them.
            cold = await stream_completion(session, base, cold_body)
            await stream_completion(session, base, {"model": MODEL, "prompt": "w" * 600, "max_tokens": 4,
                                                    "temperature": 0.0, "nvext": {"ignore_eos": True}})
            # Each worker in-process first takes a mix of other prompts and a
            # lone prompt of the timed ones' lengths, as in phase 4: the
            # graph keys of the timed requests below are captured on both
            # workers before any is sent.
            for svc in handles["services"]:
                warm_pipeline = build_pipeline(svc)
                await send_all(warm_pipeline, serve_bodies(np.random.default_rng(4), MODEL))
                async for _ in warm_pipeline.generate({**greedy, "prompt": "v" * 299}, Context()):
                    pass

            # Phase 4's mix, concurrent and streamed. Counters go to 0 just
            # before it and are read just after.
            bodies = serve_bodies(np.random.default_rng(3), MODEL)
            before = counts()
            graphs0 = [c.runner.graph_stats() for c in cores]
            queue0 = _metric_sum(await http_get(session, base, "/metrics"), "dynamo_frontend_request_queue_seconds")
            for mod in kernels.values():
                mod.launches = 0
            start = time.perf_counter()
            results = await asyncio.gather(*(stream_completion(session, base, b) for b in bodies))
            torch.cuda.synchronize()
            wall = time.perf_counter() - start
            launches = {name: mod.launches for name, mod in kernels.items()}
            dispatch, steps, mixed, prompt_tokens = since(before)
            captured = [{"keys": g1["keys"] - g0["keys"], "capture_s": g1["capture_s"] - g0["capture_s"]}
                        for g0, g1 in zip(graphs0, (c.runner.graph_stats() for c in cores))]
            queue1 = _metric_sum(await http_get(session, base, "/metrics"), "dynamo_frontend_request_queue_seconds")

            # Both workers at once. The router reads load from metrics each
            # worker publishes every 0.5 s, so a burst lands on one worker;
            # once the router sees that worker's pages in use, a second
            # burst goes to the other while the first still decodes.
            entry = handles["http"].manager.get(MODEL)
            indexer, aggregator = entry.aux[0].indexer, entry.aux[1]
            await until(lambda: len(snap := aggregator.snapshot()) == HTTP_WORKERS
                        and all(m.kv_active_blocks == 0 for m in snap.values()), "both workers idle to the router")
            window0 = counts()
            first_burst = [asyncio.ensure_future(stream_completion(session, base, b)) for b in long_bodies]
            busy = await until(lambda: [w for w, m in aggregator.snapshot().items() if m.kv_active_blocks > 0],
                               "the first burst's worker busy to the router")
            steps0 = since(window0)[1]
            second_burst = [asyncio.ensure_future(stream_completion(session, base, b)) for b in short_bodies]
            await asyncio.wait(first_burst, return_when=asyncio.FIRST_COMPLETED)
            steps1 = since(window0)[1]
            bursts = await asyncio.gather(*first_burst, *second_burst)
            both_dispatch, _, both_mixed, both_prompt_tokens = since(window0)

            # KV-aware routing: a prompt of 6 full pages, then the same again.
            kv_body = {**greedy, "prompt": bytes(rng.choice(letters, 99)).decode(), "max_tokens": 8, "logprobs": 5}
            hashes = compute_block_hashes(ByteTokenizer().encode(kv_body["prompt"], add_bos=True), 16)
            first = await stream_completion(session, base, {**kv_body, "request_id": "kv-first"})
            held = await until(lambda: {w: n for w, n in indexer.find_matches(hashes).scores.items() if n >= 3},
                               "the prompt's blocks in the router's indexer")
            if len(held) != 1:
                raise AssertionError(f"the router's indexer holds the prompt's blocks on {held}")
            (hot,) = held
            hot_core = next(c for c in cores if c.config.worker_id == hot)
            hits0 = hot_core.allocator.stats().hits
            repeat = await stream_completion(session, base, {**kv_body, "request_id": "kv-repeat"})
            decisions = [s for s in SPANS.query(request_id="kv-repeat") if s["name"] == "router_decision"]
            cached = ((repeat["usage"] or {}).get("prompt_tokens_details") or {}).get("cached_tokens", 0)
            # One uncached request alone on the warm, idle server.
            alone = await stream_completion(session, base, alone_body)

            # close() of one worker must not stall the other: the worker
            # holding the KV prompt serves it again, and once its first
            # token is out the other worker closes.
            other = next(s for s in handles["services"] if s.core is not hot_core)
            streaming = asyncio.Event()
            during = asyncio.ensure_future(stream_completion(
                session, base, {**kv_body, "max_tokens": CLOSE_TOKENS, "request_id": "kv-close"}, streaming))
            await asyncio.wait_for(streaming.wait(), 60)
            close_t0 = time.perf_counter()
            await other.close()
            close_t1 = time.perf_counter()
            during = await asyncio.wait_for(during, 60)
    finally:
        await shutdown(handles)
    gc.collect()
    torch.cuda.empty_cache()

    for body, r in zip(bodies + long_bodies + short_bodies + [{**kv_body, "max_tokens": CLOSE_TOKENS}],
                       results + bursts + [during]):
        n_out = (r["usage"] or {}).get("completion_tokens")
        if not r["done"] or r["finish"] != "length" or n_out != body["max_tokens"]:
            raise AssertionError(f"stream of {len(body['prompt']) + 1} prompt tokens: [DONE] {r['done']}, "
                                 f"finish {r['finish']}, {n_out} of {body['max_tokens']} completion tokens")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the HTTP path never launched: {launches}")
    off_kernel = {k: n for k, n in (dispatch | both_dispatch).items() if n and not k.endswith("/kernel")}
    if off_kernel:
        raise AssertionError(f"engine steps whose attention did not run in the kernels: {off_kernel}")
    if max(mixed) <= 0:
        raise AssertionError("no mixed prefill+decode step occurred in either worker")
    stepped = [b - a for a, b in zip(steps0, steps1)]
    if min(stepped) <= 0 or min(both_prompt_tokens) <= 0:
        raise AssertionError(f"not both workers stepped while the first burst decoded: steps {stepped}, "
                             f"prompt tokens {both_prompt_tokens}")
    if [d["worker"] for d in decisions] != [f"{hot:x}"]:
        raise AssertionError(f"the repeat prompt was routed by {decisions}, not to worker {hot:x}")
    if hot_core.allocator.stats().hits <= hits0 or cached < 32:
        raise AssertionError(f"the repeat prompt hit {cached} cached tokens")
    during_at = [during["sent_at"] + a for a in during["arrivals"]]
    if during_at[-1] <= close_t1:
        raise AssertionError(f"the request on the worker that stays ended before the other's close() returned "
                             f"({close_t1 - close_t0:.3f} s): nothing overlapped")

    # The cold body alone through build_pipeline on a cold service of the
    # same seed, for its tokens; then, the service warm, the alone body,
    # timed beside the HTTP request's (one uncached request on a warm, idle
    # server each: the per-request cost of HTTP, the router, the runtime
    # hop, SSE).
    service, pipeline = await build_serving(MODEL)
    try:
        async def timed(body: dict) -> tuple[float, float, str, list[dict]]:
            sent, ttft, pieces, entries = time.perf_counter(), None, [], []
            async for out in pipeline.generate(dict(body), Context()):
                if out.token_ids and ttft is None:
                    ttft = time.perf_counter() - sent
                pieces.append(out.text)
                entries += out.logprobs or []
            return ttft, time.perf_counter() - sent, "".join(pieces), entries

        _, _, in_text, in_entries = await timed(cold_body)
        in_ttft, in_total, in_alone_text, in_alone_entries = await timed(alone_body)
    finally:
        await service.close()
    wrong = token_mismatch(cold, in_entries, 32)
    if wrong or cold["text"] != in_text or cold["finish"] != "length":
        raise AssertionError(f"the cold HTTP request's tokens are not the in-process run's: {wrong}; "
                             f"text {cold['text']!r} vs {in_text!r}")

    out_tokens = sum(r["usage"]["completion_tokens"] for r in results)
    ttfts = sorted(r["arrivals"][0] for r in results)
    gaps = sorted(b - a for r in results for a, b in zip(r["arrivals"], r["arrivals"][1:]))
    pct = lambda q: gaps[min(len(gaps) - 1, int(q * len(gaps)))]  # noqa: E731
    q_sum, q_count = queue1[0] - queue0[0], queue1[1] - queue0[1]
    record = {
        "phase": "http", "model": MODEL, "workers": HTTP_WORKERS, "router_mode": "kv", "requests": len(results),
        "prompt_tokens": SERVE_LENGTHS, "output_tokens": out_tokens, "wall_s": wall,
        "output_tokens_per_s": out_tokens / wall,
        "ttft_s": {"min": ttfts[0], "median": statistics.median(ttfts), "max": ttfts[-1]},
        "itl_s": {"p50": pct(0.50), "p99": pct(0.99)},
        "frontend_queue_s_mean": q_sum / q_count if q_count else None,
        "in_process": {"output_tokens_per_s": in_process["output_tokens_per_s"], "ttft_s": in_process["ttft_s"],
                       "wall_s": in_process["wall_s"]},
        "http_minus_in_process": {"wall_s": wall - in_process["wall_s"],
                                  "ttft_median_s": statistics.median(ttfts) - in_process["ttft_s"]["median"]},
        "stack_build_s": build_s, "kernel_launches": launches, "engine_steps": sum(dispatch.values()),
        "attn_dispatch_steps": dispatch, "steps_per_worker": steps, "mixed_steps_per_worker": mixed,
        "graph_keys_captured_in_window_per_worker": captured,
        "prompt_tokens_per_worker": prompt_tokens,
        "both_workers": {"first_burst_worker": [f"{w:x}" for w in busy], "steps_per_worker_in_window": stepped,
                         "prompt_tokens_per_worker": both_prompt_tokens, "mixed_steps_per_worker": both_mixed,
                         "engine_steps": sum(both_dispatch.values())},
        "kv_routing": {"hot_worker": f"{hot:x}", "blocks_held": held[hot], "repeat_routed_to": decisions[0]["worker"],
                       "cached_tokens": cached,
                       "repeat_logprobs_equal": repeat["token_logprobs"] == first["token_logprobs"],
                       "repeat_logprobs_max_abs_diff": logprob_diff(repeat["token_logprobs"],
                                                                    first["token_logprobs"])},
        "cold_tokens_equal_in_process": True,
        "one_request_alone": {"prompt_tokens": len(alone_body["prompt"]) + 1, "output_tokens": 32,
                              "http_ttft_s": alone["arrivals"][0], "http_total_s": alone["total_s"],
                              "in_process_ttft_s": in_ttft, "in_process_total_s": in_total,
                              "tokens_equal": token_mismatch(alone, in_alone_entries, 32) is None,
                              "logprobs_max_abs_diff": logprob_diff(
                                  alone["token_logprobs"], [e["logprob"] for e in in_alone_entries])},
        "close_while_other_serves": {
            "close_s": close_t1 - close_t0, "tokens": CLOSE_TOKENS,
            "chunks_during_close": sum(close_t0 <= t <= close_t1 for t in during_at),
            "gap_s": {"median": statistics.median(b - a for a, b in zip(during_at, during_at[1:])),
                      "max": max(b - a for a, b in zip(during_at, during_at[1:]))}},
    }
    emit(record)
    return record


# -- phase 6: spec -----------------------------------------------------------------

SPEC_K = 4
SPEC_SPAN = 64  # tokens of the random span each spec prompt repeats
SPEC_LENGTHS = [128, 192, 256, 320, 384, 512, 768, 1024]  # prompt tokens, BOS included
SPEC_TOKENS = 64  # output tokens a request
# Teacher-forced check: an emitted greedy token must be the argmax of an
# eager forward over the request's own prompt + output, or its logit at most
# this far below the argmax's (the same weights in another batch shape round
# bf16 activations elsewhere: logits move by a few hundredths).
TF_LOGIT_TOL = 0.125


def spec_bodies(rng: np.random.Generator, model: str = MODEL) -> list[dict]:
    """The spec mix: per SPEC_LENGTHS entry a prompt of one random
    SPEC_SPAN-letter span repeated (the n-gram proposer drafts from such
    histories), SPEC_TOKENS output tokens; greedy except one seeded
    nucleus-sampled request of SPEC_TOKENS // 4 (its draws seldom match a
    draft, so it would set the serve's length alone). Prompts are token ids
    (BOS + letters, the byte tokenizer's), so a checkpoint's tokenizer sees
    the same ids."""
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz ", dtype=np.uint8)
    bodies = []
    for i, n in enumerate(SPEC_LENGTHS):
        span = rng.choice(letters, SPEC_SPAN).astype(int).tolist()
        ids = [256] + (span * (n // SPEC_SPAN + 1))[:n - 1]
        body = {"model": model, "prompt": ids, "max_tokens": SPEC_TOKENS, "temperature": 0.0,
                "nvext": {"ignore_eos": True}}
        if i == 3:
            body.update(temperature=0.8, top_p=0.95, seed=1234, max_tokens=SPEC_TOKENS // 4)
        bodies.append(body)
    return bodies


async def serve_spec(model: str, params: dict, cache_dtype: torch.dtype | None = None, *, spec_k: int = 0,
                     decode_steps: int = 1, graphs: bool = True, overlap: bool = True) -> tuple[dict, list]:
    """Serve the spec mix once, after a warm-up request and an untimed pass
    of the same mix, with prefix caching off so that the timed pass steps
    through the untimed pass's compositions and replays the graphs it
    captured (a verify step's shape follows its drafts, which no other mix
    reproduces): ``spec_k`` (0 = off), ``decode_steps``, the main path
    (CUDA graphs, the overlapped engine, verify steps chained through it)
    or, with ``graphs``/``overlap`` off, the eager runner behind the
    synchronous engine. Counters go to 0 just before the timed pass and are
    read just after. Every request must end with its
    ``max_tokens``, every step's attention in a kernel, and with spec_k a verify
    step must run in the kernel. Returns the record and each request's
    (prompt ids, tokens)."""
    fp8 = cache_dtype == FP8
    counter = "launches_fp8" if fp8 else "launches"
    kernels = {name + ("_fp8" if fp8 else ""): importlib.import_module(f"dynamo_tpu_torch.ops.{name}")
               for name in SERVE_KERNELS[model]}
    service, pipeline = await build_serving(model, cache_dtype, params, graphs=graphs, overlap=overlap,
                                            spec_k=spec_k, decode_steps=decode_steps, enable_prefix_caching=False)
    core = service.core
    bodies = spec_bodies(np.random.default_rng(7), model)
    try:
        await warm_up(pipeline, model)
        untimed = await send_all(pipeline, bodies, SPEC_LENGTHS)
        torch.cuda.synchronize()
        graphs0 = core.runner.graph_stats()
        dispatch0 = dict(core.attn_dispatch_counts)
        spec0 = (core.spec_steps, core.spec_tokens_proposed, core.spec_tokens_accepted)
        for mod in kernels.values():
            setattr(mod, counter, 0)
        start = time.perf_counter()
        results = await send_all(pipeline, bodies, SPEC_LENGTHS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        launches = {name: getattr(mod, counter) for name, mod in kernels.items()}
        dispatch = {f"{p}/{k}": n - dispatch0.get((p, k), 0) for (p, k), n in core.attn_dispatch_counts.items()}
        steps, drafted, accepted = (a - b for a, b in zip(
            (core.spec_steps, core.spec_tokens_proposed, core.spec_tokens_accepted), spec0))
        graphs1 = core.runner.graph_stats()
    finally:
        await service.close()
    if [r["tokens"] for r in untimed] != [r["tokens"] for r in results]:
        raise AssertionError(f"{model} spec_k={spec_k}: the timed pass's tokens differ from the untimed pass's")
    for b, r in zip(bodies, results):
        if len(r["tokens"]) != b["max_tokens"] or r["finish"] is None or r["finish"].value != "length":
            raise AssertionError(f"{model} spec_k={spec_k} decode_steps={decode_steps}: a request of "
                                 f"{r['n_prompt']} tokens ended with {len(r['tokens'])} tokens ({r['finish']})")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the path never launched: {launches}")
    off_kernel = {k: n for k, n in dispatch.items() if n and not k.endswith("/kernel")}
    if off_kernel:
        raise AssertionError(f"engine steps whose attention did not run in the kernels: {off_kernel}")
    if spec_k and not dispatch.get("verify/kernel"):
        raise AssertionError(f"spec_k={spec_k}: no verify step ran in the kernel: {dispatch}")
    out_tokens = sum(len(r["tokens"]) for r in results)
    record = {"model": model, "cache": str(cache_dtype or torch.bfloat16).removeprefix("torch."),
              "mode": f"{'cuda graphs' if graphs else 'eager'}, {'overlapped' if overlap else 'synchronous'} engine",
              "spec_k": spec_k, "decode_steps": decode_steps, "output_tokens": out_tokens, "wall_s": wall,
              "output_tokens_per_s": out_tokens / wall, "engine_steps": sum(dispatch.values()),
              "attn_dispatch_steps": dispatch, "kernel_launches": launches, "graph_keys": graphs1["keys"],
              "keys_captured_in_window": graphs1["keys"] - graphs0["keys"],
              "verify_steps": steps, "drafted_tokens": drafted, "accepted_tokens": accepted,
              "accepted_per_verify_step": accepted / steps if steps else None,
              "output_tokens_per_verify_step": out_tokens / steps if steps else None}
    return record, [(b["prompt"], r["tokens"]) for b, r in zip(bodies, results)]


def teacher_forced(dev, model: str, params: dict, cache_dtype: torch.dtype | None, served: list,
                   greedy: list[int]) -> dict:
    """One eager forward (speculation off, batch of one) over each greedy
    request's prompt + output, the logits of every output position read
    with ``logit_indices``: each emitted token must be the argmax, or its
    logit within TF_LOGIT_TOL of it. Returns the gaps' maximum and how many
    tokens were not the argmax."""
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.models.config import PRESETS

    cfg = PRESETS[model]
    ps = 16
    worst, off_argmax, n_tok = 0.0, 0, 0
    with torch.inference_mode():
        for i in greedy:
            prompt, out = served[i]
            seq = list(prompt) + list(out)
            n = len(seq) - 1  # the last output token is never an input
            pages = -(-n // ps)
            kc, vc = llama.init_kv_cache(cfg, pages + 1, ps, dtype=cache_dtype, device=dev)
            tables = torch.arange(1, pages + 1, dtype=torch.int32, device=dev)[None]
            pos = torch.arange(n, dtype=torch.int32, device=dev)[None]
            slots = (tables[0, (pos[0] // ps).long()] * ps + pos[0] % ps)[None].to(torch.int32)
            tokens = torch.tensor([seq[:n]], dtype=torch.int32, device=dev)
            cols = torch.arange(len(prompt) - 1, n, dtype=torch.int32, device=dev)[None]
            logits, _, _ = llama.forward(params, cfg, tokens, pos, kc, vc, tables, slots, cols[:, -1],
                                         logit_indices=cols)
            logits = logits[0].float()
            chosen = logits.gather(1, torch.tensor(out, device=dev)[:, None].long())[:, 0]
            gap = logits.max(dim=1).values - chosen
            worst = max(worst, float(gap.max()))
            off_argmax += int((gap > 0).sum())
            n_tok += len(out)
            del kc, vc
    return {"tokens": n_tok, "not_argmax": off_argmax, "max_logit_gap": worst, "tolerance": TF_LOGIT_TOL,
            "ok": worst <= TF_LOGIT_TOL}


def spec_phase(dev, model: str, params: dict) -> list[dict]:
    """Speculative decoding and decode bursts on the card, each serve beside
    the same mix served without them in the same run (``serve_spec``):
    spec_k = SPEC_K on the main path, bf16 and (llama-3.2-1b) fp8 caches,
    llama-3.2-1b also eager + synchronous; decode_steps = 4 on llama-3.2-1b,
    overlapped (chained sub-steps) and synchronous (the fused multi_step
    graph). Bitwise equality with the plain serve is not expected on the
    card (a row's arithmetic depends on the batch's shapes, and a verify
    step's matmuls have B*V rows): each serve's greedy tokens are held to
    the teacher-forced check instead, and counted where they equal the
    plain serve's. Fails if no draft is accepted, a check fails or a step
    raised (a request that did not finish with its tokens)."""
    greedy = [i for i, b in enumerate(spec_bodies(np.random.default_rng(7), model)) if b["temperature"] == 0]
    runs = [dict(spec_k=SPEC_K)]
    if model == MODEL:
        runs += [dict(spec_k=SPEC_K, cache_dtype=FP8), dict(spec_k=SPEC_K, graphs=False, overlap=False),
                 dict(decode_steps=4), dict(decode_steps=4, overlap=False)]
    baselines, records = {}, []
    for run in runs:
        cache = run.get("cache_dtype")
        mode = dict(graphs=run.get("graphs", True), overlap=run.get("overlap", True))
        base_key = (cache, mode["graphs"], mode["overlap"] if "spec_k" in run else True)
        if base_key not in baselines:
            base, base_served = asyncio.run(serve_spec(model, params, cache, graphs=base_key[1],
                                                       overlap=base_key[2]))
            base["teacher_forced"] = teacher_forced(dev, model, params, cache, base_served, greedy)
            baselines[base_key] = (base, base_served)
        base, base_served = baselines[base_key]
        rec, served = asyncio.run(serve_spec(model, params, cache, spec_k=run.get("spec_k", 0),
                                             decode_steps=run.get("decode_steps", 1), **mode))
        gc.collect()
        torch.cuda.empty_cache()
        rec["teacher_forced"] = teacher_forced(dev, model, params, cache, served, greedy)
        rec["greedy_requests_equal_plain"] = f"{sum(served[i][1] == base_served[i][1] for i in greedy)}/{len(greedy)}"
        rec["plain"] = {k: base[k] for k in ("mode", "decode_steps", "output_tokens_per_s", "engine_steps",
                                             "teacher_forced")}
        rec["vs_plain"] = rec["output_tokens_per_s"] / base["output_tokens_per_s"]
        emit({"phase": "spec" if rec["spec_k"] else "decode_burst", **rec})
        records.append(rec)
        bad = [r for r in (rec, base) if not r["teacher_forced"]["ok"]]
        if bad:
            raise AssertionError(f"teacher-forced check failed: {[r['teacher_forced'] for r in bad]}")
        if rec["spec_k"] and rec["accepted_tokens"] <= 0:
            raise AssertionError(f"no draft was accepted: {rec}")
    return records


def spec_graph_check(dev, model: str, params: dict) -> dict:
    """A speculative verify and a decode burst replayed from CUDA graphs
    against the eager runner on the same inputs, at full width: after a
    two-row prefill (``step_async`` on the graph runner), a verify of 5
    columns (one row with 3 drafts, one with 4; the graph runner's column 0
    chained from the prefill's samples, ``spec_step_async``) with logprobs,
    then a 4-step ``multi_step`` burst. Targets, per-column logprobs and
    burst tokens must be bitwise equal."""
    from dynamo_tpu_torch.engine.runner import StepBatch, TorchModelRunner
    from dynamo_tpu_torch.models.config import PRESETS

    cfg = PRESETS[model]
    ps, npages, lp_k, v = 16, 64, 20, SPEC_K + 1
    runners = {g: TorchModelRunner(cfg, params, num_pages=npages, page_size=ps, max_batch_size=8, device=dev,
                                   graphs=g, verify_width=v) for g in (True, False)}
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, cfg.vocab_size, 64).tolist() for _ in range(2)]
    tables = np.arange(1, 1 + 2 * 8, dtype=np.int32).reshape(2, 8)

    def batch(starts, tokens, temp=(0.0, 0.8)):
        b, t = len(tokens), max(len(x) for x in tokens)
        tok, pos = np.zeros((b, t), np.int32), np.zeros((b, t), np.int32)
        for i, (s, x) in enumerate(zip(starts, tokens)):
            tok[i, :len(x)] = x
            pos[i, :len(x)] = np.arange(s, s + len(x))
        slots = (tables[np.arange(b)[:, None], pos // ps] * ps + pos % ps).astype(np.int32)
        for i, x in enumerate(tokens):
            slots[i, len(x):] = 0
        return StepBatch(tok, pos, tables, slots, np.array([len(x) - 1 for x in tokens], np.int32),
                         np.array(temp, np.float32), np.zeros(b, np.int32), np.full(b, 0.95, np.float32),
                         np.full(b, 1234, np.uint32), np.array([0, 0], np.int32), np.zeros(b, np.float32),
                         np.zeros(b, np.float32), np.full(b, 8 * ps, np.int32), np.full((b, 1), -1, np.int32))

    def same(a, b) -> bool:
        return a.shape == b.shape and np.array_equal(np.asarray(a).view(np.int32), np.asarray(b).view(np.int32))

    steps = []
    g_pre = runners[True].step_async(batch([0, 0], prompts)).result()[0][:, 0]
    e_pre = runners[False].step(batch([0, 0], prompts))
    steps.append({"step": "prefill", "bitwise_equal": same(g_pre, e_pre)})
    drafts = [rng.integers(1, cfg.vocab_size, 3).tolist(), rng.integers(1, cfg.vocab_size, 4).tolist()]
    sb_g = batch([64, 64], [[0] + d for d in drafts])
    sb_e = batch([64, 64], [[int(e_pre[i])] + d for i, d in enumerate(drafts)])
    for sb in (sb_g, sb_e):
        sb.spec_start = np.zeros(2, np.int32)
        sb.sample_steps = np.ones(2, np.int32)
    g_t, g_aux = runners[True].spec_step_async(sb_g, v, lp_k, chain_src=np.array([0, 1])).result()
    e_t, e_aux = runners[False].spec_step(sb_e, v, lp_k=lp_k)
    steps.append({"step": "verify", "bitwise_equal": same(g_t, e_t) and all(
        same(g_aux[k], e_aux[k]) for k in ("logprob", "top_ids", "top_lps"))})
    burst = batch([69, 69], [[int(e_t[i, -1])] for i in range(2)])
    burst.sample_steps = np.full(2, 6, np.int32)
    g_b, e_b = runners[True].multi_step(burst, 4), runners[False].multi_step(burst, 4)
    steps.append({"step": "multi_step", "bitwise_equal": same(g_b, e_b)})
    stats = runners[True].graph_stats()
    record = {"phase": "graphs_spec", "model": model, "verify_width": v, "steps": steps,
              "keys_captured": stats["keys"], "capture_s": stats["capture_s"]}
    emit(record)
    if not all(st["bitwise_equal"] for st in steps) or stats["keys"] != 3:
        raise AssertionError(f"graph replay of a verify or a burst differs from the eager runner: {record}")
    del runners
    gc.collect()
    torch.cuda.empty_cache()
    return record


# -- phase 7: checkpoint -------------------------------------------------------------

CKPT_SHARD_BYTES = 1 << 30  # llama-3.2-1b's 2.5 GB of bf16 weights in three shards


def _sentencepiece_model() -> bytes:
    """A small SentencePiece model: the letters and the space as pieces,
    byte fallback, <unk>/<s>/</s> (``sentencepiece.write_model``)."""
    from dynamo_tpu_torch.sentencepiece import BYTE, CONTROL, NORMAL, UNKNOWN, write_model

    pieces = [("<unk>", 0.0, UNKNOWN), ("<s>", 0.0, CONTROL), ("</s>", 0.0, CONTROL), ("▁", -2.0, NORMAL)]
    pieces += [(chr(97 + i), -3.0 - i / 100, NORMAL) for i in range(26)]
    pieces += [(f"<0x{i:02X}>", -10.0, BYTE) for i in range(256)]
    return write_model(pieces)


async def _serve_sequential(model: str, params: dict | None, bodies: list[dict], *, quantize: str = "",
                            inspect=None, **engine_kw) -> tuple[list[dict], dict]:
    """``launch.run_local`` of ``model`` (a preset with ``params``, a
    checkpoint directory or a GGUF file; ``quantize`` as ``--quantize``; one
    worker, CUDA graphs behind the overlapped engine, in-process HTTP on a
    free port), then each body alone over HTTP (one request at a time, so
    both serves step through the same compositions), streamed with the
    logprobs of each position and its top-5 alternatives. ``inspect(handles)``
    runs before the requests. Returns the streams and the launches of the
    model's kernels over them (quant_matmul's too, with ``quantize``)."""
    import aiohttp

    from dynamo_tpu_torch.launch import run_local, shutdown

    kernels = {name: (importlib.import_module(f"dynamo_tpu_torch.ops.{name}"), "launches")
               for name in SERVE_KERNELS[MODEL]}
    if quantize:
        kernels[f"quant_matmul_{quantize}"] = (importlib.import_module("dynamo_tpu_torch.ops.quant_matmul"),
                                               f"launches_{quantize}")
    handles = await run_local(model, port=0, device="cuda", params=params, overlap=True, quantize=quantize,
                              **{**SERVE_ENGINE, **engine_kw})
    base = f"http://127.0.0.1:{handles['port']}"
    try:
        if inspect is not None:
            inspect(handles)
        async with aiohttp.ClientSession() as session:
            name = (await http_get(session, base, "/v1/models"))["data"][0]["id"]
            warm = {"model": name, "prompt": [256] + [119] * 599, "max_tokens": 4, "temperature": 0.0,
                    "nvext": {"ignore_eos": True}}
            await stream_completion(session, base, warm)
            for mod, attr in kernels.values():
                setattr(mod, attr, 0)
            streams = [await stream_completion(session, base, {**b, "model": name, "logprobs": 5}) for b in bodies]
            launches = {k: getattr(mod, attr) for k, (mod, attr) in kernels.items()}
    finally:
        await shutdown(handles)
    return streams, launches


def checkpoint_phase(dev, params: dict) -> dict:
    """llama-3.2-1b served from an HF checkpoint directory: the serve phase's
    random-init parameters written by ``save_params`` (safetensors shards of
    at most CKPT_SHARD_BYTES and an index, a config.json at the preset's
    widths) with a SentencePiece tokenizer.model, in a temporary directory;
    loaded back with ``load_model(dir, device="cuda")``, every leaf bitwise
    the in-memory one; then the serve phase's 8-request mix (its seeded
    request too), as token ids, served through ``launch.run_local(dir)``
    and through ``run_local(MODEL)`` on the same weights, one request at a
    time: every position's logprob and top-5 alternatives bitwise equal
    (equal tokens). The directory is deleted afterwards."""
    import shutil
    import tempfile

    from dynamo_tpu_torch.models import loader
    from dynamo_tpu_torch.models.config import PRESETS

    cfg = PRESETS[MODEL]
    root = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))
    ckpt = root / MODEL
    try:
        t0 = time.perf_counter()
        files = loader.save_params(ckpt, cfg, params, max_shard_bytes=CKPT_SHARD_BYTES)
        (ckpt / "tokenizer.model").write_bytes(_sentencepiece_model())
        save_s = time.perf_counter() - t0
        nbytes = sum((ckpt / f).stat().st_size for f in files)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lcfg, loaded = loader.load_model(ckpt, device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        want, got = dict(_leaves(params)), dict(_leaves(loaded))
        unequal = sorted(k for k in want if k not in got or got[k].shape != want[k].shape
                         or got[k].dtype != want[k].dtype or not torch.equal(got[k], want[k]))
        extra = sorted(set(got) - set(want))
        del loaded
        gc.collect()
        torch.cuda.empty_cache()
        # from_hf derives the MoE-only moe_norm_topk from the model type, as the JAX build does.
        same_cfg = dataclasses.replace(lcfg, name=cfg.name, moe_norm_topk=cfg.moe_norm_topk) == cfg
        if unequal or extra or not same_cfg:
            raise AssertionError(f"checkpoint load: leaves {unequal} unequal, {extra} extra, config {lcfg}")
        # The serve phase's mix, its prompts as the byte tokenizer's ids (BOS +
        # bytes), which both serves' engines then see alike.
        bodies = [{**b, "prompt": [256] + list(b["prompt"].encode())}
                  for b in serve_bodies(np.random.default_rng(3))]
        t0 = time.perf_counter()
        preset, _ = asyncio.run(_serve_sequential(MODEL, params, bodies))
        ckpt_streams, launches = asyncio.run(_serve_sequential(str(ckpt), None, bodies))
        serve_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    differ = [i for i, (a, b) in enumerate(zip(preset, ckpt_streams))
              if a["token_logprobs"] != b["token_logprobs"]
              or [sorted(x.values()) for x in a["top_logprobs"]] != [sorted(x.values()) for x in b["top_logprobs"]]]
    record = {"phase": "checkpoint", "model": MODEL, "shards": len(files), "checkpoint_bytes": nbytes,
              "save_s": save_s, "load_s": load_s, "load_gb_per_s": nbytes / load_s * 1e-9,
              "leaves": len(want), "leaves_bitwise_equal": not unequal, "requests": len(bodies),
              "requests_equal_preset_serve": len(bodies) - len(differ), "kernel_launches": launches,
              "finish": sorted({s["finish"] for s in ckpt_streams}), "serve_s": serve_s}
    emit(record)
    if differ or min(launches.values()) <= 0 or record["finish"] != ["length"]:
        raise AssertionError(f"the checkpoint serve differs from the preset serve (requests {differ}) or "
                             f"did not run in the kernels: {record}")
    return record


# -- constrained decoding and the KV tiers ---------------------------------------

LOOKAHEAD = 32  # DYN_CONSTRAINT_LOOKAHEAD_TOKENS, the JAX build's default


def _kernel_counters(cache_dtype: torch.dtype | None) -> dict:
    """The serve kernels' launch counters on ``cache_dtype`` caches."""
    fp8 = cache_dtype == FP8
    return {name + ("_fp8" if fp8 else ""): (importlib.import_module(f"dynamo_tpu_torch.ops.{name}"),
                                             "launches_fp8" if fp8 else "launches")
            for name in GQA_KERNELS}


def constrained_bodies(rng: np.random.Generator, json_mode: bool = True) -> list[dict]:
    """The serve mix, every other request (the greedy ones of even index)
    asking for ``response_format: json_object``; those stop at EOS or at
    their 32 tokens, by then a complete value (the force-close)."""
    bodies = serve_bodies(rng)
    if json_mode:
        for body in bodies[::2]:
            body.update(response_format={"type": "json_object"}, nvext={})
    return bodies


def _mask_bytes(runner, log: list) -> None:
    """Record each dispatch's mask section as the port packs it and as the
    JAX build lays it out (bool masks, int32 group ids) through ``_pad``."""
    pad = runner._pad

    def spy(batch):
        padded = pad(batch)
        vocab = runner.cfg.vocab_size
        if padded.la_masks is not None:
            b, g, _ = padded.la_masks.shape
            log.append((runner._mask_layout(b, False, g)[-1], b * vocab * 4 + b * g * vocab, g))
        elif padded.logit_mask is not None:
            b = padded.logit_mask.shape[0]
            log.append((runner._mask_layout(b, True, 0)[-1], b * vocab, 0))
        return padded

    runner._pad = spy


async def serve_constrained(params: dict, cache_dtype: torch.dtype | None, *, eager: bool, lookahead: int,
                            json_mode: bool = True, sp_dir: pathlib.Path | None = None) -> tuple[dict, list]:
    """The constrained mix on llama-3.2-1b, through ``build_engine_service``
    with DYN_CONSTRAINT_LOOKAHEAD_TOKENS=``lookahead`` behind
    ``build_pipeline``: the main path or, with ``eager``, the eager runner
    behind the synchronous engine; the byte tokenizer, or the SentencePiece
    model in ``sp_dir`` (its </s> the EOS) for the pipeline and the
    constraint masks. Prefix caching off, so the two untimed passes (after
    a warm-up request) are the timed mix itself: the first warms the mask
    cache, the second captures the graphs of the lookahead steps' group
    counts, which the timed pass replays. The kernel counters at 0 just
    before the timed pass and read just after."""
    from dynamo_tpu_torch.launch import build_pipeline
    from dynamo_tpu_torch.tokenizer import load_tokenizer

    os.environ["DYN_CONSTRAINT_LOOKAHEAD_TOKENS"] = str(lookahead)
    tok = load_tokenizer(sp_dir) if sp_dir is not None else None
    extra = {"eos_token_ids": (2,)} if tok is not None else {}
    service, _ = await build_serving(MODEL, cache_dtype, params, graphs=not eager, overlap=not eager,
                                     enable_prefix_caching=False, **extra)
    core, runner = service.core, service.core.runner
    pipeline = build_pipeline(service, tok)
    if tok is not None:
        core.set_constraint_tokenizer(tok)
    counters = _kernel_counters(cache_dtype)
    masks: list = []
    try:
        t0 = time.perf_counter()
        core.warm_constraints()
        warm_s = time.perf_counter() - t0
        await warm_up(pipeline)
        for _ in range(2):
            await send_all(pipeline, constrained_bodies(np.random.default_rng(3), json_mode))
        torch.cuda.synchronize()
        core.drain_constraint_build_seconds()
        graphs0, overlap0 = runner.graph_stats(), _overlap_counts(core)
        hits0, misses0 = core.constraint_mask_cache_hits, core.constraint_mask_cache_misses
        steps0 = sum(core.attn_dispatch_counts.values())
        _mask_bytes(runner, masks)
        for mod, attr in counters.values():
            setattr(mod, attr, 0)
        bodies = constrained_bodies(np.random.default_rng(3), json_mode)
        start = time.perf_counter()
        results = await send_all(pipeline, bodies)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        launches = {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}
        overlap1, graphs1 = _overlap_counts(core), runner.graph_stats()
        record = {
            "mode": "eager, synchronous engine" if eager else "cuda graphs, overlapped engine",
            "lookahead_tokens": lookahead, "json_requests": sum("response_format" in b for b in bodies),
            "output_tokens_per_s": sum(len(r["tokens"]) for r in results) / wall, "wall_s": wall,
            "engine_steps": sum(core.attn_dispatch_counts.values()) - steps0,
            "barriers": _counts_since(overlap1["barriers"], overlap0["barriers"]),
            "overlapped_steps": overlap1["steps"].get("overlapped", 0) - overlap0["steps"].get("overlapped", 0),
            "mask_cache": {"hits": core.constraint_mask_cache_hits - hits0,
                           "misses": core.constraint_mask_cache_misses - misses0,
                           "build_s": sum(core.drain_constraint_build_seconds()), "warm_s": warm_s},
            "masked_steps": len(masks), "lookahead_steps": sum(1 for m in masks if m[2]),
            "mask_bytes_per_step": sum(m[0] for m in masks) / max(1, len(masks)),
            "jax_layout_bytes_per_step": sum(m[1] for m in masks) / max(1, len(masks)),
            "max_groups": max([m[2] for m in masks] or [0]),
            "graph_keys": graphs1["keys"] if runner.graphs else 0,
            "graph_keys_captured_in_window": graphs1["keys"] - graphs0["keys"], "kernel_launches": launches,
        }
    finally:
        await service.close()
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the constrained serve never launched: {launches}")
    return record, results


async def json_over_http(params: dict) -> dict:
    """Four json_object chat requests, concurrent, over ``run_local``'s HTTP
    frontend (one worker, the main path, the constraint warm-up thread on):
    every answer parses."""
    import aiohttp

    from dynamo_tpu_torch.launch import run_local, shutdown

    os.environ["DYNAMO_WARM_CONSTRAINTS"] = "1"
    handles = await run_local(MODEL, port=0, device="cuda", params=params, overlap=True, **SERVE_ENGINE)
    try:
        async with aiohttp.ClientSession() as session:
            async def one(i: int) -> str:
                body = {"model": MODEL, "max_tokens": 48, "temperature": 0.7 if i % 2 else 0.0, "seed": i,
                        "response_format": {"type": "json_object"},
                        "messages": [{"role": "user", "content": f"give me json number {i}"}]}
                async with session.post(f"http://127.0.0.1:{handles['port']}/v1/chat/completions",
                                        json=body) as r:
                    return (await r.json())["choices"][0]["message"]["content"]

            answers = await asyncio.gather(*(one(i) for i in range(4)))
        rejected = handles["services"][0].core.admission_rejections
    finally:
        await shutdown(handles)
        os.environ["DYNAMO_WARM_CONSTRAINTS"] = "0"
    parsed = []
    for a in answers:
        try:
            json.loads(a)
            parsed.append(True)
        except ValueError:
            parsed.append(False)
    return {"requests": len(answers), "parsed": sum(parsed), "rejected": rejected, "answers": answers}


def constrained_phase(dev, params: dict) -> dict:
    """Constrained decoding on the card (phase "constrained"): the serve mix
    with half its requests json_object, on llama-3.2-1b, served graphs +
    overlap at lookahead 32 and 0 and eager + synchronous, beside the same
    mix without json_mode; with the byte tokenizer on bf16 and fp8 caches,
    and with the checkpoint phase's SentencePiece model on bf16. Every
    constrained output must parse and every greedy request's tokens must be
    equal across the modes; barrier reasons, mask-cache counts and build
    seconds, the mask bytes a constrained step ships (and what the JAX
    build's unpacked layout would), graph keys and tok/s are reported."""
    import shutil
    import tempfile

    root = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_sp_"))
    (root / "tokenizer.model").write_bytes(_sentencepiece_model())
    runs = [("byte", None, "plain", dict(eager=False, lookahead=LOOKAHEAD, json_mode=False)),
            ("byte", None, "overlap_la32", dict(eager=False, lookahead=LOOKAHEAD)),
            ("byte", None, "overlap_la0", dict(eager=False, lookahead=0)),
            ("byte", None, "eager_sync", dict(eager=True, lookahead=LOOKAHEAD)),
            ("sentencepiece", None, "overlap_la32", dict(eager=False, lookahead=LOOKAHEAD, sp_dir=root)),
            ("sentencepiece", None, "eager_sync", dict(eager=True, lookahead=LOOKAHEAD, sp_dir=root)),
            ("byte", FP8, "overlap_la32", dict(eager=False, lookahead=LOOKAHEAD)),
            ("byte", FP8, "eager_sync", dict(eager=True, lookahead=LOOKAHEAD))]
    greedy = [i for i, b in enumerate(constrained_bodies(np.random.default_rng(3))) if b["temperature"] == 0]
    jsons = [i for i, b in enumerate(constrained_bodies(np.random.default_rng(3))) if "response_format" in b]
    records, failures = {}, []
    try:
        for tokenizer, cache, name, kw in runs:
            rec, results = asyncio.run(serve_constrained(params, cache, **kw))
            gc.collect()
            torch.cuda.empty_cache()
            group = f"{tokenizer}/{'fp8' if cache == FP8 else 'bf16'}"
            bad = []
            for i in jsons if kw.get("json_mode", True) else []:
                try:
                    json.loads(results[i]["text"])
                except ValueError:
                    bad.append(results[i]["text"])
            rec["json_outputs_parse"] = not bad
            rec["json_finish"] = sorted({results[i]["finish"].value for i in jsons})
            records.setdefault(group, {})[name] = (rec, [r["tokens"] for r in results])
            if bad:
                failures.append(f"{group} {name}: unparsable outputs {bad}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
        os.environ.pop("DYN_CONSTRAINT_LOOKAHEAD_TOKENS", None)
    http = asyncio.run(json_over_http(params))
    gc.collect()
    torch.cuda.empty_cache()
    out = {"phase": "constrained", "model": MODEL, "runs": {}, "http": http}
    for group, runs_ in records.items():
        base = runs_.get("overlap_la32")[1]
        equal = {name: all(toks[i] == base[i] for i in greedy) for name, (_, toks) in runs_.items()
                 if name != "plain"}
        out["runs"][group] = {"greedy_tokens_equal_across_modes": equal,
                              **{name: rec for name, (rec, _) in runs_.items()}}
        if "plain" in runs_:
            out["runs"][group]["tok_s_json_vs_plain"] = (runs_["overlap_la32"][0]["output_tokens_per_s"]
                                                         / runs_["plain"][0]["output_tokens_per_s"])
        if not all(equal.values()):
            failures.append(f"{group}: greedy tokens differ across modes {equal}")
        la = runs_["overlap_la32"][0]
        if la["overlapped_steps"] <= 0 or la["lookahead_steps"] <= 0:
            failures.append(f"{group}: the overlapped constrained serve never chained a lookahead step")
        if "overlap_la0" in runs_ and runs_["overlap_la0"][0]["barriers"].get("constraint", 0) <= 0:
            failures.append(f"{group}: lookahead 0 never barriered with reason constraint")
    if http["parsed"] != http["requests"] or http["rejected"]:
        failures.append(f"json_object over HTTP: {http}")
    emit(out)
    if failures:
        raise AssertionError("; ".join(failures))
    return out


TIER_PREFIX = 1024  # tokens every tier prompt shares
TIER_LENGTHS = [1280, 1536, 1792, 2048]  # prompt tokens, BOS included
TIER_TOKENS = 16
TIER_POOL = 256  # pages: a small pool evicts the prompts between their two serves
TIER_G2_BLOCKS, TIER_G3_BLOCKS = 2048, 2048
TIER_G2_OVER_G3 = 64  # the host tier over the disk tier: too small to keep the set, which spills to disk
TIER_IO_PAGES = 64  # pages a timed read_pages / write_pages moves
TIER_LIVE_TOKENS = 256  # the live decode row an async onboarding runs beside


@contextlib.contextmanager
def flush_profile(core):
    """For as long as the context lasts, the host seconds of ``core``'s tier
    flushes that had pages pending, split into the page read's dispatch
    (gather and pinned copy issued, pinned buffers allocated), its wait for
    the copy, the per-page copies out of the pinned buffer
    (``InFlightPages.wait``), and the tier puts (G2, with what they cascade
    into G3), the G3 disk writes among them; puts and writes outside a
    flush (a G3 hit promoted to G2 as it is fetched) are not counted.
    Yields the dict."""
    import threading

    prof = dict(flushes=0, pages=0, flush_s=0.0, dispatch_s=0.0, copy_wait_s=0.0, host_copy_s=0.0,
                tier_put_s=0.0, disk_write_s=0.0)
    runner, bm = core.runner, core.block_manager
    flush, read_async = core.flush_offloads, runner.read_pages_async
    disk = bm.g3.storage if bm.g3 is not None else None
    flushing = set()  # the thread running a flush

    def timed(key, fn):
        def call(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                if threading.get_ident() in flushing:
                    prof[key] += time.perf_counter() - t0
        return call

    def timed_flush():
        if not core.pending_offloads:
            return flush()
        prof["flushes"] += 1
        flushing.add(threading.get_ident())
        try:
            return timed("flush_s", flush)()
        finally:
            flushing.discard(threading.get_ident())

    def timed_read(page_ids):
        t0 = time.perf_counter()
        handle = read_async(page_ids)
        prof["dispatch_s"] += time.perf_counter() - t0
        prof["pages"] += len(page_ids)
        wait = handle.wait

        def timed_wait():
            t0 = time.perf_counter()
            if handle._event is not None:
                handle._event.synchronize()
            t1 = time.perf_counter()
            out = wait()
            prof["copy_wait_s"] += t1 - t0
            prof["host_copy_s"] += time.perf_counter() - t1
            return out

        handle.wait = timed_wait
        return handle

    core.flush_offloads, runner.read_pages_async = timed_flush, timed_read
    bm.g2.put = timed("tier_put_s", bm.g2.put)
    if disk is not None:
        disk.write = timed("disk_write_s", disk.write)
    try:
        yield prof
    finally:
        del core.flush_offloads, runner.read_pages_async, bm.g2.put
        if disk is not None:
            del disk.write


def tier_prompts(rng: np.random.Generator, shared: bool = True) -> list[list[int]]:
    """Prompts of TIER_LENGTHS tokens as byte-tokenizer ids (BOS + letters),
    sharing their first TIER_PREFIX tokens when ``shared``."""
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", dtype=np.uint8)
    prefix = rng.choice(letters, TIER_PREFIX - 1).tolist()
    out = []
    for n in TIER_LENGTHS:
        body = prefix if shared else rng.choice(letters, TIER_PREFIX - 1).tolist()
        out.append([256] + body + rng.choice(letters, n - TIER_PREFIX).tolist())
    return out


def _tier_body(prompt: list[int]) -> dict:
    return {"model": MODEL, "prompt": prompt, "max_tokens": TIER_TOKENS, "temperature": 0.0,
            "nvext": {"ignore_eos": True}}


async def serve_tiers(params: dict, cache_dtype: torch.dtype | None, way: str, g3_root: pathlib.Path) -> dict:
    """One way of serving a repeated prompt set on llama-3.2-1b, the main
    path: the set A (TIER_LENGTHS, one shared prefix), then a set of four
    2048-token prompts, then A again, one request at a time (so a repeat's
    steps carry the same rows whichever way it was cached); first all of it
    on other prompts, untimed, to capture the graphs. ``way``: "g1"
    (a pool that keeps A), "g2"/"g3" (a TIER_POOL pool with a host tier, or
    a small host tier over a disk tier in ``g3_root``), with "_async" the
    background onboard, or "recompute" (prefix caching off). Returns A's
    repeat tokens and TTFTs, and the engine's tier counters."""
    from dynamo_tpu_torch.blocks import BlockManagerConfig
    from dynamo_tpu_torch.engine.core import EngineConfig

    kw: dict = {"num_pages": SERVE_ENGINE["num_pages"] if way == "g1" else TIER_POOL}
    if way.startswith(("g2", "g3")):
        g3 = way.startswith("g3")
        # onboard_limit covers a whole prompt: a repeat's cached prefix is then the G1 hit's.
        kw["block_manager_config"] = BlockManagerConfig(
            g2_capacity_blocks=TIER_G2_OVER_G3 if g3 else TIER_G2_BLOCKS,
            g3_capacity_blocks=TIER_G3_BLOCKS if g3 else 0,
            g3_path=g3_root / way, onboard_limit=max(TIER_LENGTHS) // 16)
        kw["async_onboard"] = way.endswith("_async")
    if way == "recompute":
        kw["enable_prefix_caching"] = False
    counters = _kernel_counters(cache_dtype)
    from dynamo_tpu_torch.launch import build_engine_service, build_pipeline

    engine = {**SERVE_ENGINE, **kw}
    service = await build_engine_service(MODEL, cache_dtype=cache_dtype, params=params, overlap=True, **engine)
    pipeline = build_pipeline(service)
    core = service.core
    if not isinstance(core.config, EngineConfig) or core.runner.num_pages != engine["num_pages"]:
        raise AssertionError("the tier serve did not take its pool")
    async def alone(prompts: list[list[int]]) -> list[dict]:
        return [(await send_all(pipeline, [_tier_body(p)], [len(p)]))[0] for p in prompts]

    async def beside_live(prompt: list[int]) -> dict:
        """``prompt`` sent once a live decode row has streamed its first
        token, so its onboarding runs beside that row's steps."""
        from dynamo_tpu_torch.runtime.engine import Context

        live_body = {"model": MODEL, "prompt": [256] + [ord("z")] * 63, "max_tokens": TIER_LIVE_TOKENS,
                     "temperature": 0.0, "nvext": {"ignore_eos": True}}
        started = asyncio.Event()

        async def live() -> int:
            n = 0
            async for out in pipeline.generate(live_body, Context()):
                n += len(out.token_ids)
                started.set()
            return n

        task = asyncio.create_task(live())
        await started.wait()
        rep = (await send_all(pipeline, [_tier_body(prompt)], [len(prompt)]))[0]
        live_tokens = await task
        if live_tokens != TIER_LIVE_TOKENS:
            raise AssertionError(f"{way}: the live row ended early ({live_tokens} tokens)")
        return rep

    bm = core.block_manager
    profiling = flush_profile(core) if bm is not None else contextlib.nullcontext({})
    try:
        with profiling as flushes:
            await warm_up(pipeline)
            flushes.update(dict.fromkeys(flushes, 0))  # the warm-up's flush is not counted
            for seed in (12, 11):  # the untimed cycle, then the measured one
                rng = np.random.default_rng(seed)
                a_set, others = tier_prompts(rng), tier_prompts(rng, shared=False)
                first = await alone(a_set)
                await alone(others)
                if seed == 12:
                    await alone(a_set)
            torch.cuda.synchronize()
            for mod, attr in counters.values():
                setattr(mod, attr, 0)
            ob0, sh0 = dict(core.onboard_page_counts), core.onboard_shortfall_pages
            sess0, over0, stall0 = core.onboard_sessions, core.onboard_overlap_steps, core.onboard_stall_steps
            wait0, waits0 = core.onboard_wait_ms_sum, core.onboard_wait_count
            repeat = await alone(a_set)
            torch.cuda.synchronize()
            launches = {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}
            record = {
                "way": way, "pool_pages": engine["num_pages"],
                "repeat_ttft_s": [r["ttft_s"] for r in repeat], "first_ttft_s": [r["ttft_s"] for r in first],
                "onboarded_pages": _counts_since(core.onboard_page_counts, ob0),
                "shortfall_pages": core.onboard_shortfall_pages - sh0,
                "kernel_launches": launches,
                "onboard_sessions": core.onboard_sessions - sess0,
                "onboard_overlap_steps": core.onboard_overlap_steps - over0,
                "onboard_stall_steps": core.onboard_stall_steps - stall0,
                "onboard_wait_ms_mean": (core.onboard_wait_ms_sum - wait0) / max(1, core.onboard_wait_count - waits0),
            }
            if way.endswith("_async"):
                # A's first prompt out of G1 again, then back beside a live row.
                await alone(others)
                ob0, sess0 = dict(core.onboard_page_counts), core.onboard_sessions
                over0, stall0 = core.onboard_overlap_steps, core.onboard_stall_steps
                rep = await beside_live(a_set[0])
                record["beside_live"] = {
                    "live_tokens": TIER_LIVE_TOKENS, "ttft_s": rep["ttft_s"],
                    "onboarded_pages": _counts_since(core.onboard_page_counts, ob0),
                    "onboard_sessions": core.onboard_sessions - sess0,
                    "onboard_overlap_steps": core.onboard_overlap_steps - over0,
                    "onboard_stall_steps": core.onboard_stall_steps - stall0,
                    "tokens_equal_alone": rep["tokens"] == repeat[0]["tokens"]}
            if bm is not None:
                st = bm.stats()
                record.update(offloaded_pages=st["offloaded"], onboarded_total=st["onboarded"],
                              tiers={t: st[t] for t in ("g2", "g3") if t in st}, flush_profile=flushes)
            tokens = [r["tokens"] for r in repeat]
    finally:
        await service.close()
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the tier serve never launched: {launches}")
    if any(len(t) != TIER_TOKENS for t in tokens):
        raise AssertionError(f"{way}: a repeat request ended early")
    return {**record, "tokens": tokens, "prompts": a_set}


def page_io(dev, params: dict, cache_dtype: torch.dtype) -> dict:
    """read_pages / write_pages at TIER_IO_PAGES pages of llama-3.2-1b on a
    runner whose cache holds random bytes: the round trip (read, write to
    other pages, read again) bitwise, the cache's pages byte for byte, and
    each direction's GB/s (host clock around the call, which waits for its
    copies: median of 9)."""
    from dynamo_tpu_torch.engine.runner import TorchModelRunner
    from dynamo_tpu_torch.models.config import PRESETS

    runner = TorchModelRunner(PRESETS[MODEL], params, num_pages=512, page_size=16, cache_dtype=cache_dtype,
                              device=dev, graphs=False)
    gen = torch.Generator(device=dev).manual_seed(5)
    for cache in (runner.k_cache, runner.v_cache):
        bits = cache.view(torch.uint8)
        bits.copy_(torch.randint(0, 256, bits.shape, dtype=torch.uint8, device=dev, generator=gen))
    src = list(range(1, 1 + TIER_IO_PAGES))
    dst = list(range(256, 256 + TIER_IO_PAGES))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first = runner.read_pages(src)
    first_read_s = time.perf_counter() - t0
    runner.write_pages(dst, [k for k, _ in first], [v for _, v in first])
    again = runner.read_pages(dst)
    bitwise = all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1]) for a, b in zip(first, again))
    s, d = torch.tensor(src, device=dev), torch.tensor(dst, device=dev)
    on_card = all(torch.equal(c.view(torch.uint8)[:, s], c.view(torch.uint8)[:, d])
                  for c in (runner.k_cache, runner.v_cache))
    nbytes = sum(k.nbytes + v.nbytes for k, v in first)

    def clock(fn) -> float:
        times = []
        for _ in range(9):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return statistics.median(times)

    def read_split() -> tuple[float, float, float]:
        """One read's host seconds: dispatch (gather, pinned buffers, copy
        issued), the wait for the copy, the per-page copies out of it."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        handle = runner.read_pages_async(src)
        t1 = time.perf_counter()
        handle._event.synchronize()
        t2 = time.perf_counter()
        handle.wait()
        return t1 - t0, t2 - t1, time.perf_counter() - t2

    split = [read_split() for _ in range(9)]
    read_s = clock(lambda: runner.read_pages(src))
    write_s = clock(lambda: runner.write_pages(dst, [k for k, _ in first], [v for _, v in first]))
    del runner
    gc.collect()
    torch.cuda.empty_cache()
    return {"cache": str(cache_dtype).removeprefix("torch."), "pages": TIER_IO_PAGES, "bytes": nbytes,
            "payload_dtype": str(first[0][0].dtype), "round_trip_bitwise": bitwise and on_card,
            "read_pages_gb_per_s": nbytes / read_s * 1e-9, "write_pages_gb_per_s": nbytes / write_s * 1e-9,
            "read_ms": read_s * 1e3, "write_ms": write_s * 1e3, "first_read_ms": first_read_s * 1e3,
            "read_split_ms": {part: {"median": 1e3 * statistics.median(t[i] for t in split),
                                     "max": 1e3 * max(t[i] for t in split)}
                              for i, part in enumerate(("dispatch", "copy_wait", "host_copy"))}}


async def busy_share(params: dict, tiers: bool) -> dict:
    """The serve mix on the main path under ``torch.profiler``: the device's
    busy share (the union of its kernels' intervals over the wall time),
    with every committed page written through to a host tier (``tiers``)
    or with no tier."""
    from dynamo_tpu_torch.blocks import BlockManagerConfig

    kw = {"block_manager_config": BlockManagerConfig(g2_capacity_blocks=4 * TIER_G2_BLOCKS)} if tiers else {}
    service, pipeline = await build_serving(MODEL, None, params, **kw)
    core = service.core
    try:
        await warm_up(pipeline)
        await send_all(pipeline, serve_bodies(np.random.default_rng(4)))
        torch.cuda.synchronize()
        off0 = core.block_manager.offloaded if tiers else 0
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with (flush_profile(core) if tiers else contextlib.nullcontext({})) as flushes:
            with torch.profiler.profile(activities=acts) as prof:
                t0 = time.perf_counter()
                results = await send_all(pipeline, serve_bodies(np.random.default_rng(3)))
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        offloaded = core.block_manager.offloaded - off0 if tiers else 0
    finally:
        await service.close()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    out_tokens = sum(len(r["tokens"]) for r in results)
    return {"device_busy_share": busy_us(kernels) / 1e6 / wall, "wall_s": wall,
            "output_tokens_per_s": out_tokens / wall, "offloaded_pages": offloaded, "cuda_kernels": len(kernels),
            "flush_profile": flushes}


def tiers_phase(dev, params: dict) -> dict:
    """The G2/G3 KV tiers on the card (phase "tiers"): page I/O round trips
    and GB/s on bf16 and fp8 caches; a prompt set with a shared
    1024-token prefix served, pushed out of a small pool, and served again,
    one request at a time, its repeat's prefix a G1 hit (a pool that keeps
    it), onboarded from G2 and from G3, synchronously and in the background,
    or recomputed (prefix caching off), on bf16 (and G1 / G2 on fp8): pages
    offloaded and onboarded by tier, the shortfall, repeat TTFT by way, the
    async sessions' overlap and stall steps (each async way once more
    beside a live decode row), the flushes' split seconds; every onboarded
    repeat's greedy tokens equal the G1 hit's, and the G1 hit's and
    recompute's pass the teacher-forced check. Then the device busy share
    of the serve mix with offload on and off."""
    import shutil
    import tempfile

    io = [page_io(dev, params, dt) for dt in (torch.bfloat16, FP8)]
    root = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_g3_"))
    ways = {}
    try:
        for cache, way in ([(None, w) for w in ("g1", "g2", "g2_async", "g3", "g3_async", "recompute")]
                           + [(FP8, "g1"), (FP8, "g2")]):
            ways[f"{'fp8' if cache == FP8 else 'bf16'}/{way}"] = asyncio.run(serve_tiers(params, cache, way, root))
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    busy = {"offload_on": asyncio.run(busy_share(params, True))}
    gc.collect()
    torch.cuda.empty_cache()
    busy["offload_off"] = asyncio.run(busy_share(params, False))
    gc.collect()
    torch.cuda.empty_cache()
    failures = [f"page round trip on {r['cache']} not bitwise" for r in io if not r["round_trip_bitwise"]]
    equal = {}
    for key, rec in ways.items():
        cache, way = key.split("/")
        equal[key] = rec["tokens"] == ways[f"{cache}/g1"]["tokens"]
        if way.startswith(("g2", "g3")):
            tier = way[:2]
            if rec["onboarded_pages"].get(tier, 0) <= 0 or not equal[key]:
                failures.append(f"{key}: onboarded {rec['onboarded_pages']}, tokens equal the G1 hit's: "
                                f"{equal[key]}")
        if way.endswith("_async"):
            live = rec["beside_live"]
            if rec["onboard_sessions"] <= 0:
                failures.append(f"{key}: the repeat opened no background onboarding session")
            if live["onboard_sessions"] <= 0 or live["onboard_overlap_steps"] <= 0 \
                    or live["onboarded_pages"].get(way[:2], 0) <= 0:
                failures.append(f"{key}: the repeat beside a live row did not onboard in the background "
                                f"while that row decoded: {live}")
    # Recompute prefills the whole prompt in one chunk, the G1 hit only the
    # suffix over the cached prefix: the matmuls round differently, so greedy
    # tokens may part at a near-tie. Both are held to an eager forward's
    # argmax over prompt + output, and the first position where they part is
    # reported.
    forced, parted = {}, []
    for key in ("bf16/g1", "bf16/recompute"):
        served = list(zip(ways[key]["prompts"], ways[key]["tokens"]))
        forced[key] = teacher_forced(dev, MODEL, params, None, served, list(range(len(served))))
        if not forced[key]["ok"]:
            failures.append(f"{key}: teacher-forced check failed: {forced[key]}")
    for a, b in zip(ways["bf16/g1"]["tokens"], ways["bf16/recompute"]["tokens"]):
        parted.append(next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None))
    if busy["offload_on"]["offloaded_pages"] <= 0:
        failures.append("the offload-on serve wrote no page through")
    out = {"phase": "tiers", "model": MODEL, "page_io": io,
           "ways": {k: {kk: v for kk, v in r.items() if kk not in ("tokens", "prompts")} for k, r in ways.items()},
           "repeat_tokens_equal_g1_hit": equal,
           "recompute_vs_g1": {"first_differing_position": parted, "teacher_forced": forced},
           "repeat_ttft_ms_median": {k: 1e3 * statistics.median(r["repeat_ttft_s"]) for k, r in ways.items()},
           "device_busy": busy}
    emit(out)
    if failures:
        raise AssertionError("; ".join(failures))
    return out


# -- phase 12: slo -----------------------------------------------------------------

SLO_MIX = {"heavy": (16, 1024, 2), "light": (8, 128, 0)}  # tenant: requests, prompt tokens (BOS included), priority
SLO_TOKENS = 32
SLO_LIGHT_AFTER_S = 0.05  # the light tenant's requests follow the heavy burst by this
SLO_QUOTAS = '{"heavy": {"max_inflight_tokens": 4096, "rate_tokens_per_s": 20000}}'  # DYN_TENANT_QUOTAS
SLO_ENGINE = dict(num_pages=2048, max_batch_size=8)
CACHE_PROMPT = 2048  # the prompt served, pushed out of G1 into G2, and sent again
CACHE_COLD = (4, 512)  # the cold prompts sent beside its repeat
CACHE_POOL = 320  # pages: CACHE_PUSHERS more CACHE_PROMPT-token prompts push the first out of G1
CACHE_PUSHERS = 3
CACHE_BESIDE_S = 0.05  # the warm prompt follows its four cold neighbours by this
CACHE_G2_BLOCKS = 1024
ROUTE_PREFIX, ROUTE_REPEATS = 1024, 3  # the warm prefix the router must send back to its worker
CRASH_AT = 12  # DYN_FAULTS=engine.step:crash@CRASH_AT, counted from arming
ADMIT_DELAY_S = 0.2  # DYN_FAULTS_DELAY_S of sched.admit:delay


@contextlib.contextmanager
def _env(**values):
    """The environment with ``values`` set (None: unset) for the block."""
    def put(items):
        for k, v in items:
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    old = {k: os.environ.get(k) for k in values}
    try:
        put(values.items())
        yield
    finally:
        put(old.items())


def _letters(rng: np.random.Generator, n: int) -> str:
    return bytes(rng.choice(np.frombuffer(b"abcdefghijklmnopqrstuvwxyz ", dtype=np.uint8), n)).decode()


def slo_bodies(seed: int, tag: str) -> dict:
    """The SLO mix: per tenant, its requests (the byte tokenizer adds BOS, so
    a prompt of n-1 letters is n tokens), greedy, SLO_TOKENS out."""
    rng = np.random.default_rng(seed)
    return {tenant: [{"model": MODEL, "prompt": _letters(rng, length - 1), "max_tokens": SLO_TOKENS,
                      "temperature": 0.0, "nvext": {"ignore_eos": True}, "priority": prio,
                      "request_id": f"{tag}-{tenant}-{i}"} for i in range(n)]
            for tenant, (n, length, prio) in SLO_MIX.items()}


async def slo_mix(session, base: str, bodies: dict) -> dict:
    """The heavy tenant's burst, then the light tenant's SLO_LIGHT_AFTER_S
    later, each request streamed with its tenant header."""
    t0 = time.perf_counter()
    heavy = [asyncio.ensure_future(stream_completion(session, base, b, headers={"x-dynamo-tenant": "heavy"}))
             for b in bodies["heavy"]]
    await asyncio.sleep(SLO_LIGHT_AFTER_S)
    light = [asyncio.ensure_future(stream_completion(session, base, b, headers={"x-dynamo-tenant": "light"}))
             for b in bodies["light"]]
    results = await asyncio.gather(*heavy, *light)
    torch.cuda.synchronize()
    return {"heavy": results[:len(heavy)], "light": results[len(heavy):], "wall_s": time.perf_counter() - t0}


def _nearest_rank(xs: list[float], q: float) -> float:
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))]


def _mix_stats(mix: dict) -> dict:
    out_tokens = sum(r["usage"]["completion_tokens"] for tier in ("heavy", "light") for r in mix[tier])
    return {"wall_s": mix["wall_s"], "output_tokens_per_s": out_tokens / mix["wall_s"],
            "ttft_s": {tier: {"p50": _nearest_rank([r["arrivals"][0] for r in mix[tier]], 0.5),
                              "p99": _nearest_rank([r["arrivals"][0] for r in mix[tier]], 0.99)}
                       for tier in ("heavy", "light")}}


class SeqLog:
    """The core's sequences by request id (``add_request`` wrapped): prompt
    and output token ids, arrival and admission times."""

    def __init__(self, core):
        self.seqs = {}
        add = core.add_request

        def logged(request, context=None):
            seq = add(request, context)
            self.seqs[request.request_id] = seq
            return seq

        core.add_request = logged

    def served(self, request_id: str) -> tuple[list[int], list[int]]:
        seq = self.seqs[request_id]
        return list(seq.tokens[:seq.num_prompt]), list(seq.tokens[seq.num_prompt:])


class AdmissionProbe:
    """The core's admission controller wrapped: the host µs of each
    ``prepare`` (under the step lock), the admissible EDF head it left and
    the requests admitted after it, each admission's quota charge, the
    heavy tenant's in-flight tokens in the controller's ledger after each
    admission and, counted apart from the ledger, its prompt tokens live on
    the card then, and the chunk budget at each prepare.

    Live on the card means in ``core.running`` or ``core.prefilling``, the
    admitted row included. ``heavy_card`` leaves out the rows that reach
    their finish line inside the step in flight (effective state: the
    synchronous engine would have finished them before admitting), which
    is what the quota holds; ``heavy_card_raw`` keeps them."""

    def __init__(self, core):
        ctl = self.ctl = core.admission
        self.prepare_us, self.steps, self.heavy_live, self.budgets, self.charges = [], [], [], [], {}
        self.heavy_card, self.heavy_card_raw = [], []
        prepare, on_admit = ctl.prepare, ctl.on_admit

        def timed(waiting, **kw):
            t0 = time.perf_counter()
            n = prepare(waiting, **kw)
            self.prepare_us.append((time.perf_counter() - t0) * 1e6)
            self.steps.append({"head": [(s.seq_id, ctl.tenant_of(s)) for s in list(waiting)[:n]], "admitted": []})
            self.budgets.append(core.chunk_budget_tokens())
            return n

        def recorded(seq, now=None):
            on_admit(seq, now)
            if self.steps:
                self.steps[-1]["admitted"].append((seq.seq_id, ctl.tenant_of(seq)))
            self.charges[seq.request.request_id] = ctl._charges.get(seq.seq_id)
            self.heavy_live.append(ctl.tenants.inflight("heavy"))
            rows = [s for s in core.running + core.prefilling if s.request.tenant_id == "heavy"]
            own = seq.num_prompt if seq.request.tenant_id == "heavy" else 0
            self.heavy_card_raw.append(own + sum(s.num_prompt for s in rows))
            self.heavy_card.append(own + sum(s.num_prompt for s in rows if core._eff_remaining(s) >= 1))

        ctl.prepare, ctl.on_admit = timed, recorded

    def reset(self) -> None:
        for x in (self.prepare_us, self.steps, self.heavy_live, self.heavy_card, self.heavy_card_raw, self.budgets):
            x.clear()

    def heavy_ahead_of_light(self) -> list[dict]:
        """Steps that admitted a heavy request while a light one stood in the
        admissible head (waiting, within its quota) and was not admitted
        ahead of it."""
        bad = []
        for k, st in enumerate(self.steps):
            pos = {sid: i for i, (sid, _) in enumerate(st["head"])}
            heavy = [pos[sid] for sid, t in st["admitted"] if t == "heavy" and sid in pos]
            if not heavy:
                continue
            admitted = {sid for sid, _ in st["admitted"]}
            light = [sid for sid, t in st["head"] if t == "light" and (sid not in admitted or pos[sid] > min(heavy))]
            if light:
                bad.append({"prepare": k, "head": st["head"], "admitted": st["admitted"]})
        return bad


def _kernel_modules() -> dict:
    return {name: importlib.import_module(f"dynamo_tpu_torch.ops.{name}") for name in SERVE_KERNELS[MODEL]}


async def slo_edf_tenants(dev, params: dict, plane: bool, after=None) -> dict:
    """Part (a) with the SLO plane off or on: ``run_local`` (one worker,
    graphs + overlap, max_batch_size 8), the SLO mix served three times
    with other prompts of the same lengths: untimed (graph keys), timed
    (TTFT per tier, tok/s, the host cost of ``prepare``, the graph keys the
    chunk controller's budgets reach), profiled (the device busy share).
    ``after(session, base, handles)`` runs on the same stack between the
    timed and the profiled pass."""
    import aiohttp

    from dynamo_tpu_torch.launch import run_local, shutdown

    kernels = _kernel_modules()
    env = {"DYN_SLO_SCHED": "1" if plane else None, "DYN_TENANT_QUOTAS": SLO_QUOTAS if plane else None}
    with _env(**env):
        handles = await run_local(MODEL, port=0, num_workers=1, device="cuda", params=params, overlap=True,
                                  **SLO_ENGINE)
        base = f"http://127.0.0.1:{handles['port']}"
        core = handles["services"][0].core
        if (core.admission is not None) != plane or (core.chunk_controller is not None) != plane:
            raise AssertionError(f"DYN_SLO_SCHED={int(plane)} built admission {core.admission}, chunk "
                                 f"controller {core.chunk_controller}")
        probe = AdmissionProbe(core) if plane else None
        log = SeqLog(core)
        extra = None
        try:
            async with aiohttp.ClientSession() as session:
                await slo_mix(session, base, slo_bodies(20, "warm"))
                if probe:
                    probe.reset()
                    throttled0 = dict(probe.ctl.tenants.throttled)
                for mod in kernels.values():
                    mod.launches = 0
                dispatch0 = dict(core.attn_dispatch_counts)
                graphs0, keys0 = core.runner.graph_stats(), set(core.runner._graphs)
                ring0 = core.flight.snapshot()[-1]["seq"]
                timed = await slo_mix(session, base, slo_bodies(21, "timed"))
                n_prepares = len(probe.prepare_us) if probe else 0  # the timed window's
                launches = {name: mod.launches for name, mod in kernels.items()}
                graphs1, new_keys = core.runner.graph_stats(), set(core.runner._graphs) - keys0
                dispatch = {f"{p}/{k}": n - dispatch0.get((p, k), 0) for (p, k), n in core.attn_dispatch_counts.items()}
                records = [r for r in core.flight.snapshot(kind="step") if r["seq"] > ring0]
                if after is not None:
                    extra = await after(session, base, handles)
                # Last on the stack: stopping the profiler holds the
                # interpreter for seconds while it collects the window's
                # kernels, which can outlast the runtime's lease (nothing is
                # routed after it). It starts and stops off the event loop,
                # on one thread (its state is the thread's).
                loop = asyncio.get_running_loop()
                prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
                with concurrent.futures.ThreadPoolExecutor(max_workers=1) as one:
                    await loop.run_in_executor(one, prof.__enter__)
                    try:
                        profiled = await slo_mix(session, base, slo_bodies(22, "profiled"))
                    finally:
                        t_stop = time.perf_counter()
                        await loop.run_in_executor(one, prof.__exit__, None, None, None)
                        profiler_stop_s = time.perf_counter() - t_stop
        finally:
            await shutdown(handles)
    gc.collect()
    torch.cuda.empty_cache()
    busy = busy_us([e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]) / 1e6
    failures = []
    for tier in ("heavy", "light"):
        for r in timed[tier] + profiled[tier]:
            n_out = (r["usage"] or {}).get("completion_tokens")
            if not r["done"] or r["finish"] != "length" or n_out != SLO_TOKENS:
                failures.append(f"a {tier} stream: [DONE] {r['done']}, finish {r['finish']}, {n_out} tokens")
    if failures:
        raise AssertionError(f"the SLO mix, plane {'on' if plane else 'off'}: " + "; ".join(failures[:4]))
    if min(launches.values()) <= 0:
        failures.append(f"a kernel of the path never launched: {launches}")
    off_kernel = {k: n for k, n in dispatch.items() if n and not k.endswith("/kernel")}
    if off_kernel:
        failures.append(f"steps whose attention did not run in the kernels: {off_kernel}")
    out = {"plane": "on" if plane else "off", **_mix_stats(timed),
           "device_busy_share": busy / profiled["wall_s"], "profiled_wall_s": profiled["wall_s"],
           "profiler_stop_s": profiler_stop_s,
           "engine_steps": len(records), "kernel_launches": launches,
           "graph_keys_captured_in_window": graphs1["keys"] - graphs0["keys"],
           "capture_s_in_window": graphs1["capture_s"] - graphs0["capture_s"],
           # (kind, rows, tokens a row, table width, history width, ...): runner._dispatch's key
           "graph_keys_new": sorted(str(k[:4]) for k in new_keys),
           "chunk_tokens_per_step_max": max((r["chunk_tokens"] for r in records), default=0),
           "decode_step_wall_ms": {q: _nearest_rank([r["wall_ms"] for r in records if r["decode_rows"]], v)
                                   for q, v in (("p50", 0.5), ("p99", 0.99), ("max", 1.0))}}
    if plane:
        ids = [f"timed-{t}-{i}" for t in ("heavy", "light") for i in range(SLO_MIX[t][0])]
        served = [log.served(rid) for rid in ids]
        forced = teacher_forced(dev, MODEL, params, None, served, list(range(len(served))))
        # The quota and order checks cover every pass from the timed one on;
        # the host cost and the budgets are the timed window's.
        ahead = probe.heavy_ahead_of_light()
        throttled = probe.ctl.tenants.throttled.get("heavy", 0) - throttled0.get("heavy", 0)
        us = probe.prepare_us[:n_prepares]
        out.update({
            "prepare_host_us": {"calls": len(us), "mean": statistics.mean(us), "p50": _nearest_rank(us, 0.5),
                                "max": max(us), "per_engine_step": sum(us) / max(1, len(records))},
            "heavy_ledger_tokens_max": max(probe.heavy_live),
            "heavy_live_prompt_tokens_max": max(probe.heavy_card),
            "heavy_live_prompt_tokens_raw_max": max(probe.heavy_card_raw), "heavy_throttled": throttled,
            "deferred_steps": sum(r["deferred"] > 0 for r in records),
            "chunk_budgets_seen": sorted(set(probe.budgets[:n_prepares])),
            "chunk_controller": {"shrinks": core.chunk_controller.shrinks, "relaxes": core.chunk_controller.relaxes,
                                 "budget": core.chunk_controller.budget()},
            "heavy_admitted_ahead_of_light": ahead, "teacher_forced": forced})
        if any(len(o) != SLO_TOKENS for _, o in served):
            failures.append("a timed request's engine sequence does not hold its tokens")
        cap = json.loads(SLO_QUOTAS)["heavy"]["max_inflight_tokens"]
        if max(out["heavy_live_prompt_tokens_max"], out["heavy_ledger_tokens_max"]) > cap or throttled <= 0:
            failures.append(f"heavy tenant: live prompt tokens up to {out['heavy_live_prompt_tokens_max']} "
                            f"(ledger {out['heavy_ledger_tokens_max']}) "
                            f"(cap {cap}), throttled {throttled} times (want > 0)")
        if ahead:
            failures.append(f"heavy requests admitted ahead of waiting light ones: {ahead[:3]}")
        if not forced["ok"]:
            failures.append(f"teacher-forced check failed: {forced}")
    if failures:
        emit({"phase": "slo", "part": "edf_tenants", **out, "failures": failures})
        raise AssertionError("; ".join(failures))
    return {**out, "extra": extra}


async def slo_flight_faults(session, base: str, handles: dict) -> dict:
    """Parts (d) and (c) on the SLO stack of part (a): a traced request's
    engine spans; ``engine.step:crash@CRASH_AT`` armed from DYN_FAULTS with a
    flight dump directory (STEP records, the CRASH record, the dump, the
    streams' errors, the request served after it); ``sched.admit:delay``."""
    import shutil
    import tempfile

    from dynamo_tpu_torch.runtime.faults import FAULTS
    from dynamo_tpu_torch.tracing import SPANS, TraceContext

    svc = handles["services"][0]
    core = svc.core
    log = SeqLog(core)
    light = slo_bodies(23, "ff")["light"]
    failures = []

    # (d) spans under the caller's trace.
    trace = TraceContext.new()
    traced = await stream_completion(session, base, {**light[0], "request_id": "ff-traced"},
                                     headers={"x-dynamo-tenant": "light", "traceparent": trace.to_traceparent()})
    spans = {s["name"]: s for s in SPANS.query(trace_id=trace.trace_id)}
    want = {"engine_queue_wait", "engine_request", "engine_first_token", "engine_admission_wait"}
    if not want <= set(spans) or traced["finish"] != "length":
        failures.append(f"the traced request left spans {sorted(spans)}")
    req = spans.get("engine_request", {})
    if spans.get("engine_first_token", {}).get("parent_id") != req.get("span_id"):
        failures.append("engine_first_token is not a child of engine_request")

    # (c) a crash before the CRASH_AT-th engine step after arming.
    steps = {"work": 0}
    step = core.step

    def counted():
        before = (core.last_step_info, core.runner.dispatch_seconds_total)
        out = step()
        if out or (core.last_step_info, core.runner.dispatch_seconds_total) != before or core.running:
            steps["work"] += 1
        return out

    core.step = counted
    dump_dir = tempfile.mkdtemp(prefix="dynamo_flight_")
    ring0 = core.flight.snapshot()[-1]["seq"]
    with _env(DYN_FLIGHT_DUMP_DIR=dump_dir, DYN_FAULTS=f"engine.step:crash@{CRASH_AT}"):
        FAULTS.arm(os.environ["DYN_FAULTS"])
        try:
            crashed = await asyncio.gather(*(stream_completion(
                session, base, {**b, "max_tokens": 4 * SLO_TOKENS, "request_id": f"ff-crash-{i}"},
                headers={"x-dynamo-tenant": "light"}, allow_error=True) for i, b in enumerate(light[1:3])))
            fired = FAULTS.fired("engine.step")
        finally:
            FAULTS.disarm()
    core.step = step
    ring = [r for r in core.flight.snapshot() if r["seq"] > ring0]
    dumps = sorted(pathlib.Path(dump_dir).glob("flight-*.jsonl"))
    lines = [json.loads(x) for x in dumps[0].read_text().splitlines()] if len(dumps) == 1 else []
    dumped = [r for r in lines[1:] if r["seq"] > ring0]
    crash = [r for r in ring if r["kind"] == "crash"]
    stream_errors = [r.get("error", {}).get("status") or r["finish"] for r in crashed]
    after_crash = {"has_work": core.has_work, "active_pages": core.allocator.stats().active_pages}
    served_after = await stream_completion(session, base, {**light[3], "request_id": "ff-after"},
                                           headers={"x-dynamo-tenant": "light"})
    if fired != 1 or len(crash) != 1 or crash[0].get("where") != "engine_loop" or crash[0].get("error") != "CrashFault":
        failures.append(f"engine.step fired {fired} times, CRASH records {crash}")
    if sum(r["kind"] == "step" for r in ring) != steps["work"] or steps["work"] < CRASH_AT - 1:
        failures.append(f"{sum(r['kind'] == 'step' for r in ring)} STEP records for {steps['work']} engine steps")
    if len(dumps) != 1 or lines[0].get("reason") != "engine_step_failure" or dumped != ring:
        failures.append(f"flight dumps {dumps}: header {lines[:1]}, {len(dumped)} records against {len(ring)}")
    if any(e not in (502, "error") for e in stream_errors):
        failures.append(f"the in-flight streams ended {stream_errors}, not in an error")
    if after_crash != {"has_work": False, "active_pages": 0} or served_after["finish"] != "length" or \
            served_after["usage"]["completion_tokens"] != SLO_TOKENS:
        failures.append(f"after the crash: {after_crash}, then a request ended {served_after['finish']}")

    # sched.admit:delay holds the head back for DYN_FAULTS_DELAY_S.
    with _env(DYN_FAULTS_DELAY_S=str(ADMIT_DELAY_S)):
        FAULTS.arm("sched.admit:delay@1")
        try:
            delayed = await stream_completion(session, base, {**light[4], "request_id": "ff-delay"},
                                              headers={"x-dynamo-tenant": "light"})
            delay_fired = FAULTS.fired("sched.admit")
        finally:
            FAULTS.disarm()
    seq = log.seqs["ff-delay"]
    admit_wait = seq.admitted_time - seq.arrival_time
    if delay_fired != 1 or admit_wait < ADMIT_DELAY_S or delayed["finish"] != "length":
        failures.append(f"sched.admit:delay fired {delay_fired}, admission {admit_wait:.3f} s after arrival")
    shutil.rmtree(dump_dir, ignore_errors=True)
    out = {"spans": {k: {"duration_ms": v["duration_ms"], "parent_is_engine_request": v.get("parent_id") == req.get("span_id")}
                     for k, v in spans.items() if k.startswith("engine_")},
           "crash": {"at_engine_step": CRASH_AT, "fired": fired, "step_records": sum(r["kind"] == "step" for r in ring),
                     "engine_steps_with_work": steps["work"], "crash_records": len(crash),
                     "dump_records": len(dumped), "stream_errors": stream_errors, "after": after_crash,
                     "request_after_crash_tokens": served_after["usage"]["completion_tokens"]},
           "sched_admit_delay": {"fired": delay_fired, "admission_wait_s": admit_wait, "armed_s": ADMIT_DELAY_S}}
    if failures:
        emit({"phase": "slo", "part": "flight_faults_spans", **out, "failures": failures})
        raise AssertionError("; ".join(failures))
    return out


async def slo_cache_aware(params: dict) -> dict:
    """Part (b): DYN_SLO_SCHED, DYN_CACHE_AWARE and DYN_ASYNC_ONBOARD with a
    G2 tier behind a CACHE_POOL-page pool. A CACHE_PROMPT-token prompt is
    served; then sent again beside CACHE_COLD cold prompts (sent just
    before it, so it joins their decode steps): a G1 hit; pushed out of G1
    by CACHE_PUSHERS more prompts; and sent once more beside as many other
    cold prompts: its admission step's cached_frac, its quota charge (the
    residual), its tokens against the G1 hit's, its onboard span. Then two
    workers behind the KV router with the cache-aware cost term: every
    repeat of a warm prefix goes to the worker that holds it."""
    import aiohttp

    from dynamo_tpu_torch.launch import run_local, shutdown
    from dynamo_tpu_torch.router import scheduler as router_scheduler
    from dynamo_tpu_torch.tokenizer import ByteTokenizer
    from dynamo_tpu_torch.tokens import compute_block_hashes
    from dynamo_tpu_torch.tracing import SPANS

    rng = np.random.default_rng(30)
    greedy = {"model": MODEL, "max_tokens": SLO_TOKENS, "temperature": 0.0, "nvext": {"ignore_eos": True}}
    warm = {**greedy, "prompt": _letters(rng, CACHE_PROMPT - 1)}
    pushers = [{**greedy, "prompt": _letters(rng, CACHE_PROMPT - 1), "max_tokens": 4} for _ in range(CACHE_PUSHERS)]
    colds = [[{**greedy, "prompt": _letters(rng, CACHE_COLD[1] - 1), "request_id": f"ca-{tag}-cold-{i}"}
              for i in range(CACHE_COLD[0])] for tag in ("g1", "repeat")]

    async def beside(session, base, tag, cold):
        sent = [asyncio.ensure_future(stream_completion(session, base, b)) for b in cold]
        await asyncio.sleep(CACHE_BESIDE_S)
        return await asyncio.gather(stream_completion(session, base, {**warm, "request_id": f"ca-{tag}"}), *sent)

    failures = []
    with _env(DYN_SLO_SCHED="1", DYN_CACHE_AWARE="1", DYN_ASYNC_ONBOARD="1"):
        handles = await run_local(MODEL, port=0, num_workers=1, device="cuda", params=params, overlap=True,
                                  num_pages=CACHE_POOL, max_batch_size=8, g2_blocks=CACHE_G2_BLOCKS)
        base = f"http://127.0.0.1:{handles['port']}"
        core = handles["services"][0].core
        log, probe = SeqLog(core), AdmissionProbe(core)
        try:
            async with aiohttp.ClientSession() as session:
                first = await stream_completion(session, base, {**warm, "request_id": "ca-first"})
                g1, *g1_colds = await beside(session, base, "g1", colds[0])
                for i, body in enumerate(pushers):
                    await stream_completion(session, base, {**body, "request_id": f"ca-push-{i}"})
                hashes = log.seqs["ca-first"].block_seq.block_hashes[:CACHE_PROMPT // 16]  # the prompt's blocks
                resident = core.allocator.peek_prefix(hashes)
                in_g2 = sum(h in core.block_manager.g2 for h in hashes)
                # Admission reads at most the manager's onboard_limit blocks
                # from the tiers (64, the JAX build's default); the rest is
                # recomputed, and priced so.
                in_tiers = core.block_manager.probe_prefix(hashes, resident)
                ring0 = core.flight.snapshot()[-1]["seq"]
                onboard0 = dict(core.onboard_page_counts)
                graphs0 = core.runner.graph_stats()
                repeat, *repeat_colds = await beside(session, base, "repeat", colds[1])
                graphs1 = core.runner.graph_stats()
                records = [r for r in core.flight.snapshot(kind="step") if r["seq"] > ring0]
                onboarded = {t: n - onboard0.get(t, 0) for t, n in core.onboard_page_counts.items()}
        finally:
            await shutdown(handles)
    gc.collect()
    torch.cuda.empty_cache()
    g1_tokens, repeat_tokens = log.served("ca-g1")[1], log.served("ca-repeat")[1]
    charge = probe.charges.get("ca-repeat")
    spans = [s for s in SPANS.query(request_id="ca-repeat") if s["name"] == "engine_onboard_wait"]
    warm_steps = [r for r in records if r["admitted"] and r["cached_frac"] > 0]
    g1_cached = ((g1["usage"] or {}).get("prompt_tokens_details") or {}).get("cached_tokens", 0)
    if resident or in_g2 < CACHE_PROMPT // 16 or in_tiers != min(CACHE_PROMPT // 16, 64):
        failures.append(f"the prompt was not pushed out of G1 into G2: {resident} blocks resident, {in_g2} in G2, "
                        f"{in_tiers} probed")
    if not warm_steps:
        failures.append(f"no admission step with cached_frac > 0: {[(r['admitted'], r['cached_frac']) for r in records]}")
    residual = CACHE_PROMPT - min(16 * (resident + in_tiers), CACHE_PROMPT - 1)  # the controller's estimate
    if charge is None or charge[1] != residual or residual >= CACHE_PROMPT - 16:
        failures.append(f"the repeat was charged {charge}, not its residual")
    if repeat_tokens != g1_tokens:
        failures.append(f"the repeat's tokens part from the G1 hit's at "
                        f"{next((i for i, (a, b) in enumerate(zip(repeat_tokens, g1_tokens)) if a != b), None)}")
    if not spans or onboarded.get("g2", 0) <= 0:
        failures.append(f"no engine_onboard_wait span ({spans}) or no G2 page onboarded ({onboarded})")
    for r in [first, g1, repeat, *g1_colds, *repeat_colds]:
        if r["finish"] != "length" or r["usage"]["completion_tokens"] != SLO_TOKENS:
            failures.append(f"a stream ended {r['finish']} after {r['usage']}")
    out = {"pool_pages": CACHE_POOL, "after_push": {"g1_blocks": resident, "g2_blocks": in_g2,
                                                    "onboard_probe_blocks": in_tiers},
           "graph_keys_captured_in_repeat_window": graphs1["keys"] - graphs0["keys"],
           "capture_s_in_repeat_window": graphs1["capture_s"] - graphs0["capture_s"],
           "g1_hit_cached_tokens": g1_cached, "repeat_charge": charge,
           "admission_steps": [{k: r[k] for k in ("admitted", "deferred", "cached_frac", "deadline_slack_ms")}
                               for r in records if r["admitted"]],
           "onboarded_pages": onboarded, "onboard_wait_ms": [s["duration_ms"] for s in spans],
           "repeat_tokens_equal_g1_hit": repeat_tokens == g1_tokens,
           "repeat_ttft_s": repeat["arrivals"][0], "g1_hit_ttft_s": g1["arrivals"][0],
           "cold_ttft_s": sorted(r["arrivals"][0] for r in repeat_colds)}

    # Two workers behind the KV router, the cache-aware term armed.
    decisions = []
    schedule = router_scheduler.KvScheduler.schedule

    def logged(self, num_blocks, overlaps, metrics, worker_ids, *, staleness=None):
        costs = self.costs(num_blocks, overlaps, metrics, worker_ids, staleness=staleness)
        wid = self.select(costs)
        decisions.append({"blocks": num_blocks, "overlaps": dict(overlaps.scores), "costs": costs, "worker": wid,
                          "cache_aware_weight": self.config.cache_aware_weight})
        return wid

    prefix = _letters(rng, ROUTE_PREFIX - 1)
    bodies = [{**greedy, "prompt": prefix + _letters(rng, 32), "max_tokens": 8} for _ in range(ROUTE_REPEATS + 1)]
    router_scheduler.KvScheduler.schedule = logged
    try:
        with _env(DYN_CACHE_AWARE="1"):
            handles = await run_local(MODEL, port=0, num_workers=2, router_mode="kv", device="cuda", params=params,
                                      overlap=True, **SLO_ENGINE)
            base = f"http://127.0.0.1:{handles['port']}"
            try:
                async with aiohttp.ClientSession() as session:
                    await stream_completion(session, base, {**bodies[0], "request_id": "route-0"})
                    entry = handles["http"].manager.get(MODEL)
                    indexer = entry.aux[0].indexer
                    hashes = compute_block_hashes(ByteTokenizer().encode(prefix, add_bos=True), 16)
                    held = await until(lambda: {w: n for w, n in indexer.find_matches(hashes).scores.items()
                                                if n >= len(hashes) - 1}, "the warm prefix in the router's indexer")
                    first_decision = len(decisions)
                    for i, body in enumerate(bodies[1:], 1):
                        await stream_completion(session, base, {**body, "request_id": f"route-{i}"})
            finally:
                await shutdown(handles)
    finally:
        router_scheduler.KvScheduler.schedule = schedule
    gc.collect()
    torch.cuda.empty_cache()
    repeats = decisions[first_decision:]
    holder = next(iter(held))
    if len(held) != 1 or len(repeats) != ROUTE_REPEATS or any(d["worker"] != holder for d in repeats) \
            or not all(d["cache_aware_weight"] > 0 for d in decisions):
        failures.append(f"the warm prefix (held by {held}) was routed {[d['worker'] for d in repeats]}")
    out["router"] = {"holder": f"{holder:x}", "decisions": [
        {"worker": f"{d['worker']:x}", "blocks": d["blocks"], "overlap": {f"{w:x}": n for w, n in d["overlaps"].items()},
         "costs": {f"{w:x}": c for w, c in d["costs"].items()}} for d in decisions]}
    if failures:
        emit({"phase": "slo", "part": "cache_aware", **out, "failures": failures})
        raise AssertionError("; ".join(failures))
    return out


def slo_phase(dev, params: dict) -> dict:
    """Phase 12: the SLO admission plane, cache-aware admission and routing,
    the flight recorder, fault points and spans, all through ``run_local``
    over HTTP on the main path (llama-3.2-1b, bf16, graphs + overlap). (a)
    the SLO mix with the plane off, then on (EDF, tenant quotas, the chunk
    controller); (d) and (c) on the plane's stack; (b) cache-aware
    admission over G2 and the cache-aware router term on two workers."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]):
        torch.zeros(1, device=dev).add_(1)  # the profiler's one-time start-up, before any stack runs
    off = asyncio.run(slo_edf_tenants(dev, params, plane=False))
    on = asyncio.run(slo_edf_tenants(dev, params, plane=True, after=slo_flight_faults))
    flight = on.pop("extra")
    off.pop("extra")
    edf = {"phase": "slo", "part": "edf_tenants", "model": MODEL,
           "mix": {t: {"requests": n, "prompt_tokens": length, "priority": p} for t, (n, length, p) in SLO_MIX.items()},
           "output_tokens": SLO_TOKENS, "tenant_quotas": json.loads(SLO_QUOTAS), **SLO_ENGINE,
           "plane_off": off, "plane_on": on}
    emit(edf)
    emit({"phase": "slo", "part": "flight_faults_spans", **flight})
    cache = {"phase": "slo", "part": "cache_aware", **asyncio.run(slo_cache_aware(params))}
    emit(cache)
    return {"edf_tenants": edf, "flight_faults_spans": flight, "cache_aware": cache}


# -- quantized weights: quant_matmul -------------------------------------------------

# decode rows, a ragged row tile, rows at each side of the decode/prefill switch, verify rows, prefill
# chunks, a mixed step
QUANT_M = (1, 5, 8, 16, 17, 64, 512, 2051)
# (K, N) of every quantized leaf the slice serves, by leaf format: llama-3-8b's
# projections and head, mla-8b-proxy's (w_q_a, w_q_b, w_kv_a with its ragged
# 576-column edge; wo_mla is 4096 x 4096), llama-3-70b's at int4, and
# llama-3.2-1b from a GGUF file (group 32, f32 scales, with and without qbias).
QUANT_SHAPES = {
    "int8": [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096), (4096, 128256),
             (4096, 1536), (1536, 6144), (4096, 576)],
    "int4": [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096), (4096, 128256),
             (8192, 8192), (8192, 1024), (8192, 28672), (28672, 8192), (8192, 128256)],
    "int4_g32": [(2048, 2048), (2048, 512), (2048, 8192), (8192, 2048)],
}
QUANT_HEAD_N = 128256  # the vocabulary: the head's product, f32 out
L2_BYTES = 50 * 2**20  # the H100's L2: timed weights are cycled through copies that exceed it 4x
# (name, K, N) of the timed products
QUANT_TIMED = [("llama-3-8b w_gate", 4096, 14336), ("llama-3-8b w_down", 14336, 4096),
               ("llama-3-70b w_gate", 8192, 28672)]


def quant_leaf(dev, gen, k: int, n: int, fmt: str, bias: bool = False) -> dict:
    """A random quantized leaf: int8 codes over [-127, 127] with per-column
    bf16 scales around the fan-in scale; int4 bytes over all 256 codes with
    group scales (group 128, bf16; or ``int4_g32``: group 32, f32 scales and,
    with ``bias``, an f32 qbias, as a GGUF Q4_K import holds them)."""
    if fmt == "int8":
        return {"qw": torch.randint(-127, 128, (k, n), generator=gen, device=dev, dtype=torch.int8),
                "scale": ((torch.rand(n, generator=gen, device=dev) + 0.5) * k**-0.5 / 127).to(torch.bfloat16)}
    gs, sdt = (32, torch.float32) if fmt == "int4_g32" else (128, torch.bfloat16)
    leaf = {"qw4": torch.randint(-128, 128, (k // 2, n), generator=gen, device=dev, dtype=torch.int8),
            "scale": ((torch.rand(k // gs, n, generator=gen, device=dev) + 0.5) * k**-0.5 / 7).to(sdt)}
    if bias:
        leaf["qbias"] = ((torch.rand(k // gs, n, generator=gen, device=dev) - 0.5) * k**-0.5).to(sdt)
    return leaf


def compare_rows(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """``compare``'s per-row limit, vectorized over every row of a product:
    max |kernel - plain| <= REL_TOL * max |plain| in each row. Both sides
    dequantize to the same bf16 weights (held bitwise by the identity
    check) and accumulate in f32 in different orders; bf16 outputs are then
    one or two ulps apart at most (int8 rounds twice)."""
    g, w = got.float(), want.float()
    err, ref = (g - w).abs().amax(dim=1), w.abs().amax(dim=1)
    bad = torch.nonzero(err > REL_TOL[got.dtype] * ref)
    if bad.numel():
        r = int(bad[0, 0])
        raise AssertionError(f"{name}: row {r}: max abs err {float(err[r])} exceeds {REL_TOL[got.dtype]} * "
                             f"max|plain| {float(ref[r])} ({got.dtype})")
    return float(err.max())


def quant_kernel_checks(dev) -> dict:
    """``quant_matmul`` against its plain version at every QUANT_SHAPES leaf
    and QUANT_M row count, bf16 out and f32 out (the head's), per row; two
    launches bitwise equal; and an identity check (x = I_K, every product
    one weight element) that the kernel's dequantization is bitwise the
    plain version's, for every leaf with K <= 8192 but the heads. Returns
    the max abs error by format."""
    from dynamo_tpu_torch.ops import quant_matmul as qmm

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(11)
    errs, checks, identity, bitwise = {}, 0, 0, 0
    for fmt, shapes in QUANT_SHAPES.items():
        for si, (k, n) in enumerate(shapes):
            for bias in ((False, True) if fmt == "int4_g32" else (False,)):
                leaf = quant_leaf(dev, gen, k, n, fmt, bias)
                name = f"{fmt}{'+qbias' if bias else ''} {k}x{n}"
                for m in QUANT_M:
                    x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
                    for out in (torch.bfloat16, torch.float32):
                        got = qmm.quant_matmul(x, leaf, out)
                        again = qmm.quant_matmul(x, leaf, out)
                        want = qmm.quant_matmul_plain(x, leaf, out)
                        if not torch.equal(got, again):
                            raise AssertionError(f"{name} M={m} {out}: two launches differ")
                        key = f"{fmt}/{'f32' if out == torch.float32 else 'bf16'}"
                        errs[key] = max(errs.get(key, 0.0), compare_rows(f"{name} M={m} {out}", got, want))
                        checks += 1
                        bitwise += 1
                if n != QUANT_HEAD_N and k <= 8192:
                    eye = torch.eye(k, device=dev, dtype=torch.bfloat16)
                    got, want = qmm.quant_matmul(eye, leaf), qmm.quant_matmul_plain(eye, leaf)
                    if not torch.equal(got.view(torch.int16), want.view(torch.int16)):
                        bad = int((got.view(torch.int16) != want.view(torch.int16)).sum())
                        raise AssertionError(f"{name}: identity product differs from the plain dequantization "
                                             f"in {bad} elements")
                    identity += 1
                del leaf
    torch.cuda.synchronize()
    emit({"phase": "kernels_quant", "checks": checks, "two_launch_bitwise": bitwise, "identity_bitwise": identity,
          "m": list(QUANT_M), "shapes": {f: [f"{k}x{n}" for k, n in s] for f, s in QUANT_SHAPES.items()},
          "max_abs_err": errs, "tolerance": {str(d).removeprefix("torch."): t for d, t in REL_TOL.items()},
          "seconds": time.perf_counter() - t0})
    return errs


def quant_bound(m: int, k: int, n: int, leaf: dict, out_bytes: int = 2) -> tuple[float, str]:
    """The least time the card takes for one product (ms) and what bounds
    it: each input read once (x, the quantized weight, its scales and
    biases), the output written once, over HBM's rate; 2*M*N*K operations
    over the bf16 tensor-core peak."""
    nbytes = m * k * 2 + sum(t.numel() * t.element_size() for t in leaf.values()) + m * n * out_bytes
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 2.0 * m * n * k / BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


QUANT_TIMED_M = (8, 64, 512, 2048)  # a decode step, verify rows, a prefill chunk, a long prefill


def quant_timing(dev) -> dict:
    """Device ms of ``quant_matmul`` at QUANT_TIMED's products, at every
    QUANT_TIMED_M row count, int8 and int4 (group 128), then the head's
    product at a decode step (llama-3-8b's 4096 x QUANT_HEAD_N at int8, f32
    out, the largest quantized read of a step): each call reads its own
    copy of the weight, cycled through copies that exceed the L2 4x (a
    serve streams each layer's weights cold); beside its bound, the plain
    version and the library yardstick (``torch.matmul`` on the weight
    dequantized to bf16 beforehand, never called by the port), the form
    and plan the wrapper took, and the device µs of each CUDA kernel a
    call launches. Returns the entries by format, the first (llama-3-8b
    w_gate at M=8) first; the head's entry is ``out["head"]``."""
    from dynamo_tpu_torch.models.quant import maybe_dequant
    from dynamo_tpu_torch.ops import quant_matmul as qmm

    gen = torch.Generator(device=dev).manual_seed(12)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {}
    timed = [(fmt, name, k, n, QUANT_TIMED_M, torch.bfloat16) for fmt in ("int8", "int4") for name, k, n in QUANT_TIMED]
    timed.append(("head", "llama-3-8b lm_head", 4096, QUANT_HEAD_N, (8,), torch.float32))
    for key, name, k, n, ms, odt in timed:
        fmt = "int8" if key == "head" else key
        leaf = quant_leaf(dev, gen, k, n, fmt)
        nbytes = sum(t.numel() * t.element_size() for t in leaf.values())
        copies = [leaf] + [{c: t.clone() for c, t in leaf.items()} for _ in range(-(-4 * L2_BYTES // nbytes) - 1)]
        w16 = maybe_dequant(leaf, torch.bfloat16)
        for m in ms:
            x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
            got, want = qmm.quant_matmul(x, leaf, odt), qmm.quant_matmul_plain(x, leaf, odt)
            err = compare_rows(f"timed {key} {name} M={m}", got, want)
            qmm.launches_int8 = qmm.launches_int4 = 0
            ms_kernel = time_ms(lambda: [qmm.quant_matmul(x, c, odt) for c in copies], iters=4) / len(copies)
            bound, by = quant_bound(m, k, n, leaf, out_bytes=torch.empty((), dtype=odt).element_size())
            form, param, splits = qmm.plan(m, n, k, sms, fmt)
            out.setdefault(key, []).append({
                "shape": name, "k": k, "n": n, "m": m, "out": str(odt).removeprefix("torch."), "copies": len(copies),
                "ms": ms_kernel, "plain_ms": time_ms(lambda: qmm.quant_matmul_plain(x, leaf, odt), iters=2),
                "library_ms": time_ms(lambda: qmm.matmul(x, w16, odt), iters=4),
                "bound_ms": bound, "bound_by": by, "of_bound": bound / ms_kernel, "max_abs_err": err,
                "form": "decode" if form == qmm.FORM_DECODE else "prefill", "plan": [form, param, splits],
                "device_us_by_kernel": device_us_by_kernel(lambda: qmm.quant_matmul(x, leaf, odt))})
        del copies, leaf, w16
        gc.collect()
        torch.cuda.empty_cache()
    for key, entries in out.items():
        emit({"phase": "kernel_timing_quant", "format": key, "entries": entries})
    return out


def _leaves(tree: dict, path: str = ""):
    for k, v in tree.items():
        yield from _leaves(v, f"{path}/{k}") if isinstance(v, dict) else [(f"{path}/{k}", v)]


# The quantized serves: (model, format); then BIG_MODEL at int4 on one card.
QUANT_SERVES = [(QUANT_MODEL, "int8"), (QUANT_MODEL, "int4"), (MLA_MODEL, "int8")]


def quant_serve_phase(dev) -> dict:
    """Quantized weights served through ``build_engine_service(quantize=)``,
    each model's weights random-init directly in their quantized form on
    the card (``init_params_quantized``, what the launcher runs for a preset
    with ``--quantize``) and freed before the next: llama-3-8b at int8 and
    int4 and mla-8b-proxy at int8 each take a forward check (every kernel
    against the plain versions), a graph check (replays bitwise the eager
    steps) and the serve mix eager + synchronous then graphs + overlap
    (greedy tokens equal; ``quant_matmul`` launched exactly once per
    quantized projection and forward). Then llama-3-70b at int4 on one card,
    at full width and depth: its resident weight bytes, a forward check and
    one serve on the main path, and the peak of allocated device memory.
    llama-3-8b's bf16 weights are served first, on the main path, beside
    them.
    Returns quant_matmul's launches by format over the main-path windows."""
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.models.config import PRESETS
    from dynamo_tpu_torch.models.quant import init_params_quantized

    params = llama.init_params(PRESETS[QUANT_MODEL], 0, device=dev)  # the bf16 serve beside them
    asyncio.run(serve(QUANT_MODEL, None, params))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    launches = {"int8": 0, "int4": 0}
    for model, mode in QUANT_SERVES:
        params = init_params_quantized(PRESETS[model], 0, mode=mode, device=dev)
        forward_check(dev, model, params=params, quant=mode)
        graph_check(dev, model, params)
        launches[mode] += serve_both(model, None, params, quant=mode)["kernel_launches"][f"quant_matmul_{mode}"]
        del params
        gc.collect()
        torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = init_params_quantized(PRESETS[BIG_MODEL], 0, mode="int4", device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    resident = sum(t.numel() * t.element_size() for _, t in _leaves(params))
    forward_check(dev, BIG_MODEL, params=params, quant="int4")
    record, _ = asyncio.run(serve(BIG_MODEL, None, params, quant="int4"))
    launches["int4"] += record["kernel_launches"]["quant_matmul_int4"]
    emit({"phase": "big_model", "model": BIG_MODEL, "weights": "int4", "resident_weight_gb": resident / 1e9,
          "init_s": init_s, "max_memory_allocated_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
          "device_memory_gb": torch.cuda.get_device_properties(dev).total_memory / 1e9,
          "output_tokens_per_s": record["output_tokens_per_s"], "engine_steps": record["engine_steps"]})
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _gguf_tokenizer() -> dict:
    """An embedded unigram (``llama``) tokenizer: the letters and the space
    as pieces, byte fallback, <unk>/<s>/</s>."""
    tokens = ["<unk>", "<s>", "</s>", "▁"] + [chr(97 + i) for i in range(26)] + [f"<0x{i:02X}>" for i in range(256)]
    return {"tokenizer.ggml.model": "llama", "tokenizer.ggml.tokens": tokens,
            "tokenizer.ggml.scores": [0.0, 0.0, 0.0, -2.0] + [-3.0 - i / 100 for i in range(26)] + [-10.0] * 256,
            "tokenizer.ggml.token_type": [2, 3, 3] + [1] * 27 + [6] * 256,
            "tokenizer.ggml.unknown_token_id": 0, "tokenizer.ggml.bos_token_id": 1,
            "tokenizer.ggml.eos_token_id": 2}


def gguf_phase(dev) -> dict:
    """llama-3.2-1b served from a GGUF file: its random weights (seed 0,
    bf16) written by the port's writer at Q4_K (``save_params_gguf``, the
    blocks encoded on the card; norms f32) with an embedded tokenizer, in a
    temporary directory; imported in-process with
    ``load_gguf_params(quantize="int4")`` (every projection a packed int4
    leaf: the file's codes, f32 scales and qbias at group 32); then the
    serve phase's mix, as token ids, served one request at a time through
    ``launch.run_local(path, quantize="int4")`` (config, card, tokenizer
    and weights from the file: the launcher's path; its leaves must be
    bitwise the in-process import's) and through ``run_local(MODEL)`` on
    the imported leaves: every position's logprob and top-5 alternatives
    equal. A few blocks encoded on the card are held byte for byte against
    the CPU's encoding first."""
    import shutil
    import tempfile

    from dynamo_tpu_torch.models import gguf, llama
    from dynamo_tpu_torch.models.config import PRESETS

    cfg = PRESETS[MODEL]
    params = llama.init_params(cfg, 0, device=dev)
    sample = params["layers"]["w_up"][0][:, :512].T.contiguous()  # 512 rows of the 2048-wide layer-0 weight
    for enc in (gguf._quantize_q4_k, gguf._quantize_q4_0, gguf._quantize_q8_0):
        if not torch.equal(enc(sample).cpu(), enc(sample.cpu())):
            raise AssertionError(f"{enc.__name__}: the card's encoding differs from the CPU's")
    root = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_gguf_"))
    path = root / f"{MODEL}-q4_k.gguf"
    try:
        t0 = time.perf_counter()
        gguf.save_params_gguf(path, cfg, params, quant=gguf.GGML_Q4_K, tokenizer_metadata=_gguf_tokenizer())
        write_s = time.perf_counter() - t0
        del params
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        imported = gguf.load_gguf_params(gguf.GGUFReader(path), cfg, quantize="int4", device=dev)
        torch.cuda.synchronize()
        import_s = time.perf_counter() - t0
        packed = sorted(k for k, v in imported["layers"].items() if isinstance(v, dict))
        bodies = [{**b, "prompt": [256] + list(b["prompt"].encode())}
                  for b in serve_bodies(np.random.default_rng(3))]
        seen = {}

        def launcher_leaves(handles):
            runner = handles["services"][0].core.runner
            got, want = dict(_leaves(runner.params)), dict(_leaves(imported))
            seen["unequal"] = sorted(k for k in want if k not in got or got[k].dtype != want[k].dtype
                                     or not torch.equal(got[k], want[k])) + sorted(set(got) - set(want))
            # GGUF stores floats as f32: rms_eps comes back as f32(1e-5), which the
            # f32 norm adds as it adds 1e-5
            seen["config_equal"] = (dataclasses.replace(runner.cfg, name=cfg.name, rms_eps=cfg.rms_eps) == cfg
                                    and bool(np.float32(runner.cfg.rms_eps) == np.float32(cfg.rms_eps)))

        run_kw = dict(max_seq_len=4096)
        t0 = time.perf_counter()
        from_file, launches = asyncio.run(_serve_sequential(str(path), None, bodies, quantize="int4",
                                                            inspect=launcher_leaves, **run_kw))
        in_process, _ = asyncio.run(_serve_sequential(MODEL, imported, bodies, quantize="int4", **run_kw))
        serve_s = time.perf_counter() - t0
        file_bytes = path.stat().st_size
    finally:
        shutil.rmtree(root, ignore_errors=True)
    differ = [i for i, (a, b) in enumerate(zip(in_process, from_file))
              if a["token_logprobs"] != b["token_logprobs"]
              or [sorted(x.values()) for x in a["top_logprobs"]] != [sorted(x.values()) for x in b["top_logprobs"]]]
    record = {"phase": "gguf", "model": MODEL, "ggml_type": "Q4_K", "file_bytes": file_bytes, "write_s": write_s,
              "import_s": import_s, "packed_int4_leaves": packed,
              "leaves_bitwise_equal_import": not seen.get("unequal", ["not inspected"]),
              "config_equal_preset": seen.get("config_equal"), "requests": len(bodies),
              "requests_equal_in_process": len(bodies) - len(differ), "kernel_launches": launches,
              "finish": sorted({s["finish"] for s in from_file}), "serve_s": serve_s}
    emit(record)
    if (differ or seen.get("unequal", True) or not seen["config_equal"] or min(launches.values()) <= 0
            or len(packed) != 7 or record["finish"] != ["length"]):
        raise AssertionError(f"the GGUF serve differs from the in-process import or did not run in the kernels: "
                             f"requests {differ}, {record}, leaves {seen.get('unequal')}")
    del imported
    gc.collect()
    torch.cuda.empty_cache()
    return record


# -- phase 13: moe ------------------------------------------------------------------

# Grouped-kernel geometries: experts, top-k, hidden, expert width; each MoE
# layer runs w_gate and w_up (K hidden, N width) and w_down (the reverse).
MOE_GEOMS = {"olmoe-1b-7b": (64, 8, 2048, 1024), "deepseek-v2-lite": (64, 6, 2048, 1408),
             "qwen3-30b-a3b": (128, 8, 2048, 768)}
MOE_CHECK_TOKENS = (8, 512)  # a decode batch, a prefill chunk; rows = tokens * top-k
MOE_ROUTINGS = ("uniform", "skewed", "one_expert")
MOE_TIMED_TOKENS = (8, 64, 512, 2048)


def moe_expert_ids(rng: np.random.Generator, routing: str, tokens: int, e: int, k: int) -> np.ndarray:
    """The sorted expert id of each of tokens * k rows. ``uniform``: each
    token's k distinct experts drawn uniformly (the router's shape);
    ``skewed``: half the rows on expert 3, the rest on every 8th expert, the
    others empty; ``one_expert``: every row on the last expert."""
    m = tokens * k
    if routing == "uniform":
        ids = np.argsort(rng.random((tokens, e)), axis=1)[:, :k].reshape(-1)
    elif routing == "skewed":
        ids = np.concatenate([np.full(m // 2, 3), rng.integers(0, e // 8, m - m // 2) * 8])
    else:
        ids = np.full(m, e - 1)
    return np.sort(ids)


def moe_case(dev, gen, rng, routing: str, tokens: int, e: int, k: int, kk: int, n: int):
    """x bf16[tokens * k, kk] ~ N(0, 1), w bf16[e, kk, n] at the fan-in scale,
    the group offsets of ``routing`` and the experts that have rows."""
    ids = moe_expert_ids(rng, routing, tokens, e, k)
    offsets = torch.from_numpy(np.searchsorted(ids, np.arange(e + 1)).astype(np.int32)).to(dev)
    x = torch.randn(tokens * k, kk, generator=gen, device=dev).to(torch.bfloat16)
    w = (torch.randn(e, kk, n, generator=gen, device=dev) * kk**-0.5).to(torch.bfloat16)
    return x, w, offsets, int(len(np.unique(ids)))


def moe_kernel_checks(dev) -> dict:
    """``grouped_matmul`` against its plain version (a loop of torch.matmul
    over the experts) at each MOE_GEOMS geometry, both products (hidden ->
    width, width -> hidden), MOE_CHECK_TOKENS tokens and every MOE_ROUTINGS
    routing, per row (``compare_rows``: bf16 outputs one or two ulps apart,
    the two sides summing K in different orders); two launches bitwise
    equal. Returns the max abs error by geometry."""
    from dynamo_tpu_torch.ops import grouped_matmul as gmm

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(21)
    rng = np.random.default_rng(21)
    errs, checks = {}, 0
    for model, (e, k, d, f) in MOE_GEOMS.items():
        for kk, n in ((d, f), (f, d)):
            for tokens in MOE_CHECK_TOKENS:
                for routing in MOE_ROUTINGS:
                    x, w, offsets, _ = moe_case(dev, gen, rng, routing, tokens, e, k, kk, n)
                    got, again = gmm.grouped_matmul(x, w, offsets), gmm.grouped_matmul(x, w, offsets)
                    want = gmm.grouped_matmul_plain(x, w, offsets)
                    name = f"grouped_matmul {model} {kk}x{n} tokens={tokens} {routing}"
                    if not torch.equal(got, again):
                        raise AssertionError(f"{name}: two launches differ")
                    errs[model] = max(errs.get(model, 0.0), compare_rows(name, got, want))
                    checks += 1
    torch.cuda.synchronize()
    emit({"phase": "kernels_moe", "checks": checks, "geometries": MOE_GEOMS, "tokens": list(MOE_CHECK_TOKENS),
          "routings": list(MOE_ROUTINGS), "max_abs_err": errs,
          "tolerance": f"{REL_TOL[torch.bfloat16]} * max|plain| per row", "seconds": time.perf_counter() - t0})
    return errs


def moe_launches_per_forward(model: str) -> int:
    """grouped_matmul launches one forward of ``model`` makes: three a MoE layer."""
    from dynamo_tpu_torch.models.config import PRESETS

    cfg = PRESETS[model]
    return 3 * (cfg.num_layers - cfg.first_k_dense)


def _grouped_mm_yardstick(x, w, offsets, want):
    """``torch._grouped_mm`` on the same product, where this torch has it (a
    library call, timed beside the kernel and never used by the port): the
    callable, the layout of ``w`` it took, and its max abs error against the
    plain version; or None and why not."""
    fn = getattr(torch, "_grouped_mm", None)
    if fn is None:
        return None, "absent: torch has no _grouped_mm", None
    ends = offsets[1:].contiguous()
    tried = []
    for layout, wl in (("[E, K, N] row-major", w), ("[E, K, N] column-major", w.transpose(1, 2).contiguous().transpose(1, 2))):
        try:
            out = fn(x, wl, offs=ends)
            torch.cuda.synchronize()
            return (lambda: fn(x, wl, offs=ends)), layout, float((out.float() - want.float()).abs().max())
        except Exception as exc:  # noqa: BLE001 - reported, not hidden
            tried.append(f"{layout}: {type(exc).__name__}: {str(exc)[:160]}")
    return None, "refused: " + " | ".join(tried), None


def eager_ms(fn, calls: int = 5) -> float:
    """Wall ms of one eager call between CUDA events, after a warm-up call:
    for a function a CUDA graph cannot hold (the plain grouped product reads
    its offsets on the host), so its host work is in the number."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def moe_timing(dev) -> list[dict]:
    """Device ms of ``grouped_matmul`` at olmoe-1b-7b's w_gate (2048 -> 1024)
    and w_down (1024 -> 2048) products with MOE_TIMED_TOKENS tokens, each
    token's 8 of 64 experts drawn uniformly: the kernel (graph replay,
    median of 7), its bound (the touched experts' weights, x and the output
    once over HBM's rate, or 2*M*K*N over the bf16 peak; the larger), the
    plain version, ``torch._grouped_mm`` where this torch has it, the
    wrapper's host µs a call and the device µs of each CUDA kernel a call
    launches. The experts' weights (268 MB) exceed the L2. The plain
    version reads its offsets on the host, so it is timed eagerly
    (``eager_ms``), its host work included."""
    from dynamo_tpu_torch.ops import grouped_matmul as gmm

    gen = torch.Generator(device=dev).manual_seed(22)
    rng = np.random.default_rng(22)
    e, k, d, f = MOE_GEOMS["olmoe-1b-7b"]
    entries = []
    for name, kk, n in (("w_gate", d, f), ("w_down", f, d)):
        for tokens in MOE_TIMED_TOKENS:
            x, w, offsets, touched = moe_case(dev, gen, rng, "uniform", tokens, e, k, kk, n)
            m = x.shape[0]
            got, want = gmm.grouped_matmul(x, w, offsets), gmm.grouped_matmul_plain(x, w, offsets)
            err = compare_rows(f"timed grouped_matmul {name} tokens={tokens}", got, want)
            lib, layout, lib_err = _grouped_mm_yardstick(x, w, offsets, want)
            ms = time_ms(lambda: gmm.grouped_matmul(x, w, offsets), iters=20)
            nbytes = touched * kk * n * 2 + m * kk * 2 + m * n * 2 + (e + 1) * 4
            t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 2.0 * m * kk * n / BF16_FLOPS
            bound = max(t_bytes, t_ops) * 1e3
            entries.append({
                "shape": f"olmoe-1b-7b {name}", "k": kk, "n": n, "tokens": tokens, "m": m, "experts": e,
                "experts_touched": touched, "ms": ms, "bound_ms": bound,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations", "of_bound": bound / ms,
                "plain_ms": eager_ms(lambda: gmm.grouped_matmul_plain(x, w, offsets)),
                "library_ms": time_ms(lib, iters=20) if lib is not None else None, "library": layout,
                "library_max_abs_err": lib_err, "max_abs_err": err,
                "host_us": host_us(lambda: gmm.grouped_matmul(x, w, offsets)),
                "device_us_by_kernel": device_us_by_kernel(lambda: gmm.grouped_matmul(x, w, offsets))})
            del x, w
    emit({"phase": "kernel_timing_moe", "entries": entries,
          "launches_per_forward": {m: moe_launches_per_forward(m) for m in MOE_GEOMS}})
    return entries


def _weight_gb(params: dict) -> float:
    return sum(t.numel() * t.element_size() for _, t in _leaves(params)) / 1e9


def _peak_serve(model: str, params: dict, cache_dtype=None, **kw) -> dict:
    """One serve of the mix (``serve``) with the peak allocated memory over
    it, from a reset of the peak statistics just before."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    record, _ = asyncio.run(serve(model, cache_dtype, params, **kw))
    record["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    gc.collect()
    torch.cuda.empty_cache()
    return record


def moe_phase(dev) -> dict:
    """Routed MoE on the card (phase 13): the grouped kernel's checks and
    timing; olmoe-1b-7b at full width (a forward check against the plain
    grouped product and reference attention, a graph check, the mix eager +
    sync then graphs + overlap on bf16 and fp8 caches, greedy tokens equal,
    grouped_matmul launched three times a layer and forward, the device's
    busy share, peak memory, paged_decode at its 16/16 heads, a 16-row tile
    carrying one query row at T_q 1); deepseek-v2-lite (MLA, 2 shared
    experts, one dense layer) served on the main path; qwen3-30b-a3b at bf16
    served with its weight and peak GB; the three dense presets a forward
    check and a serve each. Returns what the kernels line needs."""
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.models.config import PRESETS

    t0 = time.perf_counter()
    errs = moe_kernel_checks(dev)
    timed = moe_timing(dev)
    decode = _gqa_timings(dev, torch.Generator(device=dev).manual_seed(23), 16, 16, 128)
    emit({"phase": "kernel_timing_moe_attention", "model": MOE_MODEL,
          "paged_decode_rows_per_16_row_tile": 1 * (PRESETS[MOE_MODEL].num_heads // PRESETS[MOE_MODEL].num_kv_heads),
          "paged_decode_tile_occupancy": 1 / 16, **{k: {f: v[f] for f in ("ms", "bound_ms", "bound_by", "plain_ms",
                                                                          "library_ms", "shape")}
                                                    for k, v in decode.items()}})
    launches, records = 0, {}

    params = llama.init_params(PRESETS[MOE_MODEL], 0, device=dev)
    weight_gb = _weight_gb(params)
    forward_check(dev, MOE_MODEL, params=params)
    graph_check(dev, MOE_MODEL, params)
    for cache_dtype in (None, FP8):
        eager, eager_tokens = asyncio.run(serve(MOE_MODEL, cache_dtype, params, eager=True))
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        main, tokens = asyncio.run(serve(MOE_MODEL, cache_dtype, params, profile=cache_dtype is None))
        main["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        gc.collect()
        torch.cuda.empty_cache()
        greedy = [i for i, b in enumerate(serve_bodies(np.random.default_rng(3), MOE_MODEL)) if b["temperature"] == 0]
        differ = [SERVE_LENGTHS[i] for i in greedy if tokens[i] != eager_tokens[i]]
        emit({"phase": "serve_modes", "model": MOE_MODEL, "cache": main["cache"], "weights": "bf16",
              "tokens_equal": not differ, "greedy_requests_differing_by_prompt_tokens": differ,
              "output_tokens_per_s": {"eager_sync": eager["output_tokens_per_s"],
                                      "graphs_overlap": main["output_tokens_per_s"]},
              "speedup": main["output_tokens_per_s"] / eager["output_tokens_per_s"], "weight_gb": weight_gb,
              "peak_gb": main["peak_gb"]})
        if differ:
            raise AssertionError(f"{MOE_MODEL}: greedy tokens of the main path differ from eager + sync "
                                 f"(requests of {differ} prompt tokens)")
        if main["graphs"]["keys"] <= 0:
            raise AssertionError(f"{MOE_MODEL}: no MoE step was captured")
        launches += main["kernel_launches"]["grouped_matmul"]
        records[main["cache"]] = main
    del params

    for model in (MOE_MLA_MODEL, MOE_BIG_MODEL, *DENSE_PRESETS):
        gc.collect()
        torch.cuda.empty_cache()
        params = llama.init_params(PRESETS[model], 0, device=dev)
        weight_gb = _weight_gb(params)
        if model in DENSE_PRESETS:
            forward_check(dev, model, params=params)
        record = _peak_serve(model, params)
        emit({"phase": "moe_serve" if PRESETS[model].is_moe else "dense_preset_serve", "model": model,
              "weight_gb": weight_gb, "peak_gb": record["peak_gb"],
              "output_tokens_per_s": record["output_tokens_per_s"], "ttft_s": record["ttft_s"],
              "kernel_launches": record["kernel_launches"], "graph_keys": record["graphs"]["keys"]})
        del params
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "moe", "seconds": time.perf_counter() - t0, "grouped_matmul_main_path_launches": launches})
    return {"errs": errs, "timed": timed, "launches": launches}


def ptxas_functions(log: str) -> dict:
    """nvcc's -Xptxas -v report, per compiled entry function: {mangled name:
    {"registers": n, "spill_stores": bytes}}."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
            out[fn] = {"registers": None, "spill_stores": 0}
        elif fn is not None:
            m = re.search(r"(\d+) bytes spill stores", line)
            if m:
                out[fn]["spill_stores"] = int(m.group(1))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                out[fn]["registers"] = int(m.group(1))
    return out


def _short(fn: str) -> str:
    """A mangled kernel instantiation's name and its template arguments,
    shortened (e.g. ``mla_wgmma_kernel<512,64,4,true>``)."""
    found = None  # the rightmost length-prefixed identifier naming a *_kernel template
    for d in re.finditer(r"\d+", fn):
        for i in range(d.start(), d.end()):
            name = fn[d.end():d.end() + int(fn[i:d.end()])]
            if name.endswith("_kernel") and fn[d.end() + len(name):].startswith("I"):
                found = (name, d.end() + len(name) + 1)
                break
    if found is None:
        return fn
    args = re.findall(r"Li(\d+)E|Lb([01])E|(13__nv_bfloat16|f)(?=[^a-z]|$)", fn[found[1]:].split("EEv")[0])
    text = [a or ("true" if b == "1" else "false" if b else "") or ("bf16" if c.startswith("13") else "f32")
            for a, b, c in args]
    return f"{found[0]}<{','.join(text)}>"


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    try:
        from dynamo_tpu_torch.ops import build
    except ImportError as exc:
        print(f"chip_smoke: the dynamo_tpu_torch package is not importable here: {exc}", file=sys.stderr)
        return 2
    # The launcher warms constraint masks on a thread at every worker's
    # start; the constrained phase warms them itself (and turns the thread
    # on for its HTTP serve), so no other phase runs beside one.
    os.environ["DYNAMO_WARM_CONSTRAINTS"] = "0"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    last = json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}})

    t0 = time.perf_counter()
    built = build.build()
    regs = {name: sorted({int(x.split("Used ")[1].split()[0]) for x in log.splitlines() if "Used " in x})
            for name, log in built["ptxas"].items()}
    spills = {name: max([int(n) for n in re.findall(r"(\d+) bytes spill stores", log)] or [0])
              for name, log in built["ptxas"].items()}
    wgmma = {fn: rs for name in ("paged_prefill", "paged_mla")
             for fn, rs in ptxas_functions(built["ptxas"].get(name, "")).items() if "wgmma" in fn}
    quant = ptxas_functions(built["ptxas"].get("quant_matmul", ""))
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "nvcc_registers": regs,
          "nvcc_max_spill_store_bytes": spills,
          "wgmma_instantiations": {_short(fn): rs for fn, rs in sorted(wgmma.items())},
          "quant_matmul_instantiations": {_short(fn): rs for fn, rs in sorted(quant.items())}})
    # Their consumers' registers are budgeted by setmaxnreg (quant_matmul's
    # prefill form too): a spill in any instantiation is a regression.
    spilled = {_short(fn): rs for fn, rs in {**wgmma, **quant}.items() if rs["spill_stores"]}
    if spilled or (any(name in built["ptxas"] for name in ("paged_prefill", "paged_mla")) and not wgmma):
        raise AssertionError(f"the wgmma kernels spill registers (or none were reported): {spilled}")

    fp8_cast_checks(dev)
    sampling_check(dev)
    errs = kernel_checks(dev)
    mla_errs = mla_kernel_checks(dev)
    errs.update({f"paged_mla/{k}": e for k, e in mla_errs.items()})
    errs.update({f"{k}/": e for k, e in {**fp8_kernel_checks(dev), **fp8_mla_kernel_checks(dev)}.items()})
    errs.update({f"{k}/wide": e for k, e in wide_verify_checks(dev).items()})
    gqa = kernel_timings(dev)
    gqa_fp8 = kernel_timings(dev, FP8, bf16=gqa)
    wide_verify_timing(dev)
    quant_errs = quant_kernel_checks(dev)
    quant_timed = quant_timing(dev)
    timing = {k: gqa[k] for k in ("paged_decode", "paged_prefill")}
    timing.update({f"{k}_fp8": gqa_fp8[k] for k in ("paged_decode", "paged_prefill")})
    # The kernels line carries paged_mla's decode time; its prefill and
    # mixed-step times are on the kernel_timing_mla lines.
    mla = mla_timings(dev)
    timing["paged_mla"] = mla["decode"]
    timing["paged_mla_fp8"] = mla_timings(dev, FP8, bf16=mla)["decode"]
    launches, served = {}, {}
    for model in (MODEL, MLA_MODEL):  # each model's weights are freed before the next is made
        from dynamo_tpu_torch.models import llama
        from dynamo_tpu_torch.models.config import PRESETS

        params = llama.init_params(PRESETS[model], 0, device=dev)
        forward_check(dev, model, params=params)
        forward_check(dev, model, FP8, params=params)
        graph_check(dev, model, params)
        if model == MODEL:
            graph_check(dev, model, params, FP8)
        spec_graph_check(dev, model, params)
        for cache_dtype in (None, FP8):
            record = serve_both(model, cache_dtype, params)
            served.setdefault(model, record)
            launches.update(record["kernel_launches"])
        spec_phase(dev, model, params)
        if model == MODEL:
            checkpoint_phase(dev, params)
            constrained_phase(dev, params)
            tiers_phase(dev, params)
            slo_phase(dev, params)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    asyncio.run(serve_http(served[MODEL]))
    gc.collect()
    torch.cuda.empty_cache()
    quant_launches = quant_serve_phase(dev)
    gguf_phase(dev)
    moe = moe_phase(dev)

    replaces = {
        "paged_decode": "dynamo_tpu/ops/pallas_paged.py:230",
        "paged_prefill": "dynamo_tpu/ops/pallas_prefill.py:93",
        "paged_mla": "dynamo_tpu/ops/pallas_mla.py:83",
        "paged_decode_fp8": "dynamo_tpu/ops/pallas_paged.py:368",
        "paged_prefill_fp8": "dynamo_tpu/ops/pallas_prefill.py:189",
        "paged_mla_fp8": "dynamo_tpu/ops/pallas_mla.py:200",
    }
    kernels = []
    for name in replaces:
        tm = timing[name]
        kernels.append({
            "name": name, "route": "cuda", "source": f"dynamo_tpu_torch/csrc/{name.removesuffix('_fp8')}.cu",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": max([tm["max_abs_err"]] + [e for k, e in errs.items() if k.startswith(name + "/")]),
            "ms": tm["ms"], "plain_ms": tm["plain_ms"], "bound_ms": tm["bound_ms"],
            "bound_by": tm["bound_by"], "library_ms": tm["library_ms"],
        })
    for fmt in ("int8", "int4"):
        tm = quant_timed[fmt][0]  # llama-3-8b w_gate at M = 8, a decode step's product
        kernels.append({
            "name": f"quant_matmul_{fmt}", "route": "cuda", "source": "dynamo_tpu_torch/csrc/quant_matmul.cu",
            "replaces": "dynamo_tpu/models/quant.py:182", "launches": quant_launches[fmt],
            "max_abs_err": max([e["max_abs_err"] for e in quant_timed[fmt]]
                               + [e for k, e in quant_errs.items() if k.startswith(fmt)]),
            "ms": tm["ms"], "plain_ms": tm["plain_ms"], "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
            "library_ms": tm["library_ms"],
        })
    tm = moe["timed"][0]  # olmoe-1b-7b w_gate with 8 tokens, a decode step's product
    kernels.append({
        "name": "grouped_matmul", "route": "cuda", "source": "dynamo_tpu_torch/csrc/grouped_matmul.cu",
        "replaces": "dynamo_tpu/parallel/moe.py:232", "launches": moe["launches"],
        "max_abs_err": max([e["max_abs_err"] for e in moe["timed"]] + list(moe["errs"].values())),
        "ms": tm["ms"], "plain_ms": tm["plain_ms"], "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
        "library_ms": tm["library_ms"],
    })
    print(json.dumps({"kernels": kernels}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(last, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
