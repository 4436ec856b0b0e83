#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``dynamo_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, one JSON line each; any failure exits non-zero:

1. build    — compile every CUDA kernel of the serving paths from ``csrc/``,
              one nvcc per source, all started together.
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
              relative to the row's largest plain output.
3. forward  — one prefill and one decode step at full width, with the
              kernels and with the plain attention, same inputs; logits
              compared: llama-3.2-1b, then mla-8b-proxy.
4. serve    — ``build_engine_service`` (random init, bf16) behind
              ``build_pipeline``: 8 concurrent OpenAI completion requests,
              prompts of 16..1500 tokens, 32 tokens each; the model's
              kernels' launch counts must be > 0, every engine step's
              attention must have run in a kernel, and a mixed step must
              occur. llama-3.2-1b (paged_decode, paged_prefill), then, after
              it is freed, mla-8b-proxy (paged_mla).

Then the kernels line, the card's name and power limit, and the last line
``{"ok": true, "device": {...}}``. Imports nothing of JAX or ``dynamo_tpu``.
"""

from __future__ import annotations

import asyncio
import gc
import importlib
import json
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOPS = 989e12  # dense bf16 tensor-core peak
MODEL = "llama-3.2-1b"
MLA_MODEL = "mla-8b-proxy"
SERVE_KERNELS = {MODEL: ("paged_decode", "paged_prefill"), MLA_MODEL: ("paged_mla",)}
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


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


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


def _case(rng, dev, *, b, t, h, n_kv, hd, ps, npp, dtype, lengths, contiguous, layers=1):
    """Random paged caches + tables with -1 tails past each row's used pages."""
    w = n_kv * hd
    pages = layers * b * npp + 1
    kc = torch.randn((pages, ps, w), generator=rng, device=dev).to(dtype)
    vc = torch.randn((pages, ps, w), generator=rng, device=dev).to(dtype)
    q = torch.randn((b, t, h, hd), generator=rng, device=dev).to(dtype)
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


def mixed_step_check(dev, rng) -> float:
    """The prefill kernel at a mixed step of the serve phase: llama-3.2-1b
    geometry in bf16, 16-token pages, a batch of 8 on 128-page tables, the
    step's 512-token bucket holding a chunk after 1024 cached tokens, a
    whole 512-token chunk from 0, a short last chunk, and 1-token decode rows
    (start = kv_len - 1) of up to 1531 tokens."""
    from dynamo_tpu_torch.ops import paged_prefill as pp

    h, n_kv, hd, ps, t, npp = 32, 8, 64, 16, 512, 128
    spans = MIXED_SPANS
    q, kc, vc, tb, _, _ = _case(rng, dev, b=len(spans), t=t, h=h, n_kv=n_kv, hd=hd, ps=ps, npp=npp,
                                dtype=torch.bfloat16, lengths=[s + n for s, n in spans], contiguous=True)
    pos = torch.from_numpy(_spans(spans, t)).to(dev)
    got = pp.paged_prefill_attention(q, kc, vc, tb[0], pos, scale=hd**-0.5)
    want = pp.paged_prefill_plain(q, kc, vc, tb[0], pos, scale=hd**-0.5)
    return compare("prefill mixed step (serve shape)", got, want,
                   [(i, n) for i, (_, n) in enumerate(spans)], torch.bfloat16)


def _mla_case(rng, dev, pos: np.ndarray, *, h, r_kv, dr, r_width, ps, npp, dtype, layers=1, q_dtype=None):
    """Random latent / rope pages (the rope stream's tail past ``dr`` zero, as
    the writers leave it), queries (``q_dtype``, else the caches' dtype), and
    tables with -1 tails."""
    b, t = pos.shape
    pages = layers * b * npp + 1
    c = torch.randn((pages, ps, r_kv), generator=rng, device=dev).to(dtype)
    r = torch.zeros((pages, ps, r_width), device=dev, dtype=dtype)
    r[..., :dr] = torch.randn((pages, ps, dr), generator=rng, device=dev).to(dtype)
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


def mla_mixed_step_check(dev, rng) -> float:
    """paged_mla at a mixed step of the MLA serve phase: mla-8b-proxy
    geometry in bf16, 16-token pages, a batch of 8 on 128-page tables, the
    512-token bucket holding a chunk after 1024 cached tokens, a whole chunk
    from 0, a short last chunk and 1-token decode rows of up to 1531 tokens."""
    from dynamo_tpu_torch.ops import paged_mla as pm

    h, r_kv, dr, r_width, dn = MLA_GEOMS[MLA_MODEL]
    spans = MIXED_SPANS
    case = _mla_case(rng, dev, _spans(spans, 512), h=h, r_kv=r_kv, dr=dr, r_width=r_width, ps=16, npp=128,
                     dtype=torch.bfloat16)
    case = (*case[:4], case[4][0], case[5])
    got = pm.paged_mla(*case, scale=(dn + dr) ** -0.5)
    want = pm.paged_mla_plain(*case, scale=(dn + dr) ** -0.5)
    return compare("mla mixed step (serve shape)", got, want, [(i, n) for i, (_, n) in enumerate(spans)],
                   torch.bfloat16)


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


def mla_timings(dev) -> dict:
    """paged_mla at the MLA main path's shapes (mla-8b-proxy, bf16, 16-token
    pages): decode at batch 8 over 2048-token contexts on 128-page tables
    (the serve phase's table width, so the same split plan), a 512-token
    chunk after 1024 cached tokens, and the serve's mixed step
    (``mla_mixed_step_timing``); each held against its plain version on the
    timed inputs first. The library yardstick is ``folded_sdpa``: no mask at
    full-context decode, the per-row horizon mask at prefill and the mixed
    step. Beside the device times, the wrapper's host µs per call. At T > 1
    the walk facts are computed once beforehand, as the forward computes them
    once per step for all its layers."""
    from dynamo_tpu_torch.ops import paged_mla as pm

    rng = torch.Generator(device=dev).manual_seed(11)
    h, r_kv, dr, r_width, dn = MLA_GEOMS[MLA_MODEL]
    ps, dtype, scale = 16, torch.bfloat16, (dn + dr) ** -0.5
    dims = dict(h=h, r_kv=r_kv, dr=dr, r_width=r_width, dtype=dtype)

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
    kv = [_mla_gathered(c, r, tbs[i], dr) for i in range(layers)]
    libs = [folded_sdpa(q_lat, q_rope, kv[i][0], kv[i][1], None, scale) for i in range(layers)]
    nbytes = (b * ctx * (r_kv + dr) * 2  # latent + rope lanes, read once
              + b * h * (r_kv + dr) * 2 + b * h * r_kv * 4  # queries in, f32 latent out
              + b * npp * 4 + b * 4)  # tables, positions
    flops = 2 * b * h * ctx * (r_kv + dr) + 2 * b * h * ctx * r_kv
    kern = lambda: pm.paged_mla(q_lat, q_rope, c, r, tbs[next(it) % layers], posd, scale=scale)
    out["decode"] = _mla_entry(
        kern, lambda: pm.paged_mla_plain(q_lat, q_rope, c, r, tbs[next(it) % layers], posd, scale=scale),
        lambda: libs[next(it) % layers][0](), nbytes, flops, 50,
        shape=f"B={b} ctx={ctx} heads={h} r_kv={r_kv} rope={dr}/{r_width} bf16 page={ps}",
        max_abs_err=err, splits=pm.mla_split_plan(b, 1, npp, ps, 0, dev), library_backend=libs[0][1],
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
    kg, vg = _mla_gathered(c, r, tb0, dr)
    lib, backend = folded_sdpa(q_lat, q_rope, kg, vg, _mla_horizon_mask(posd, h, kv_len), scale)
    pairs = t * start + t * (t + 1) // 2  # causal (query, key) pairs
    nbytes = kv_len * (r_kv + dr) * 2 + t * h * (r_kv + dr) * 2 + t * h * r_kv * 4 + npp * 4 + t * 4
    flops = 2 * h * pairs * (r_kv + dr) + 2 * h * pairs * r_kv
    out["prefill"] = _mla_entry(kern, plain, lib, nbytes, flops, 20, max_abs_err=err, library_backend=backend,
                                shape=f"B=1 T={t} start={start} heads={h} r_kv={r_kv} rope={dr}/{r_width} bf16 "
                                      f"page={ps}",
                                device_us_by_kernel=device_us_by_kernel(kern, 5), host_us_per_call=host_us(kern))
    del q_lat, q_rope, c, r, kg, vg, lib
    out["mixed_step"] = mla_mixed_step_timing(dev, rng)
    emit({"phase": "kernel_timing_mla", **out})
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
    return dict(ms=time_ms(kern, iters=iters), plain_ms=time_ms(plain, iters=3), library_ms=time_ms(lib, iters=iters),
                bound_ms=max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3,
                bound_by="bytes" if nbytes / HBM_BYTES_PER_S >= flops / BF16_FLOPS else "operations", **extra)


def mla_mixed_step_timing(dev, rng) -> dict:
    """paged_mla at the serve's mixed-step shape (``mla_mixed_step_check``'s
    spans: mla-8b-proxy geometry, bf16, a batch of 8 in a 512-token bucket on
    128-page tables, five of the rows 1-token decode rows), held against its
    plain version first. The yardstick is ``folded_sdpa`` over each row's
    whole table with the per-row horizon mask."""
    from dynamo_tpu_torch.ops import paged_mla as pm

    h, r_kv, dr, r_width, dn = MLA_GEOMS[MLA_MODEL]
    ps, t, npp, scale = 16, 512, 128, (dn + dr) ** -0.5
    spans = MIXED_SPANS
    q_lat, q_rope, c, r, tb, posd = _mla_case(rng, dev, _spans(spans, t), h=h, r_kv=r_kv, dr=dr, r_width=r_width,
                                             ps=ps, npp=npp, dtype=torch.bfloat16)
    tb0 = tb[0].contiguous()
    walk = pm.walk_facts(posd)
    kern = lambda: pm.paged_mla(q_lat, q_rope, c, r, tb0, posd, scale=scale, walk=walk)
    plain = lambda: pm.paged_mla_plain(q_lat, q_rope, c, r, tb0, posd, scale=scale)
    err = compare("mla mixed-step timing inputs", kern(), plain(), [(i, n) for i, (_, n) in enumerate(spans)],
                  torch.bfloat16)
    kg, vg = _mla_gathered(c, r, tb0, dr)
    lib, backend = folded_sdpa(q_lat, q_rope, kg, vg, _mla_horizon_mask(posd, h, npp * ps), scale)
    pairs = sum(n * s + n * (n + 1) // 2 for s, n in spans)
    nbytes = (sum((s + n) * (r_kv + dr) * 2 for s, n in spans)  # each row's latents + rope lanes, read once
              + sum(n * h * ((r_kv + dr) * 2 + r_kv * 4) for _, n in spans)  # real queries in, f32 latent out
              + len(spans) * (npp * 4 + t * 4))  # tables, positions
    flops = 2 * h * pairs * (r_kv + dr) + 2 * h * pairs * r_kv
    return _mla_entry(kern, plain, lib, nbytes, flops, 20, max_abs_err=err, library_backend=backend,
                      shape=f"B=8 T={t} spans={spans} heads={h} r_kv={r_kv} rope={dr}/{r_width} bf16 page={ps}",
                      device_us_by_kernel=device_us_by_kernel(kern, 5), host_us_per_call=host_us(kern))


def _gqa_timings(dev, rng, h: int, n_kv: int, hd: int) -> dict:
    """paged_decode and paged_prefill at one GQA geometry (bf16, 16-token
    pages): decode at batch 8 over 2048-token contexts on 128-page tables
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
    geom = f"heads={h}/{n_kv} hd={hd} bf16 page={ps}"
    out = {}

    # Decode: 4 layers' worth of distinct pages (4 x 33.6 MB at hd 64 > the
    # 50 MB L2), cycled per launch, so each launch reads its K/V from HBM as a
    # serving step does.
    b, ctx, layers = 8, 2048, 4
    npp = ctx // ps
    q, kc, vc, tb, pos, _ = _case(rng, dev, b=b, t=1, h=h, n_kv=n_kv, hd=hd, ps=ps, npp=npp, dtype=dtype,
                                  lengths=[ctx] * b, contiguous=True, layers=layers)
    tbs = [tb[i].contiguous() for i in range(layers)]
    it = iter(range(10**9))
    kern = lambda: pd.paged_decode_attention(q, kc, vc, tbs[next(it) % layers], pos, scale=scale)
    plain = lambda: pd.paged_decode_plain(q, kc, vc, tbs[next(it) % layers], pos, scale=scale)
    err = max(compare(f"decode timing inputs, {geom}, layer {i}",
                      pd.paged_decode_attention(q, kc, vc, tbs[i], pos, scale=scale),
                      pd.paged_decode_plain(q, kc, vc, tbs[i], pos, scale=scale), [(r, 1) for r in range(b)], dtype)
              for i in range(layers))
    kg = [gather_pages(kc, tbs[i], n_kv).permute(0, 2, 1, 3).contiguous() for i in range(layers)]
    vg = [gather_pages(vc, tbs[i], n_kv).permute(0, 2, 1, 3).contiguous() for i in range(layers)]
    qg = q.permute(0, 2, 1, 3).contiguous()  # [B, H, 1, hd]
    lib = lambda: (lambda i: F.scaled_dot_product_attention(qg, kg[i], vg[i], scale=scale, enable_gqa=True))(
        next(it) % layers)
    nbytes = (2 * b * ctx * n_kv * hd * 2  # K and V strips, read once
              + 2 * b * h * hd * 2  # q in, out
              + b * npp * 4 + b * 4)  # tables, positions
    flops = 4 * b * h * ctx * hd
    out["paged_decode"] = dict(
        ms=time_ms(kern, iters=50), plain_ms=time_ms(plain, iters=5), library_ms=time_ms(lib, iters=50),
        host_us_per_call=host_us(kern),
        bound_ms=max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3,
        bound_by="bytes" if nbytes / HBM_BYTES_PER_S >= flops / BF16_FLOPS else "operations",
        shape=f"B={b} ctx={ctx} {geom}", max_abs_err=err,
        splits=pd.decode_split_plan(b, n_kv, npp, ps, 0, q.device), device_us_by_kernel=device_us_by_kernel(kern),
    )
    del q, kc, vc, kg, vg

    # Prefill: one 512-token chunk at positions 1024..1535.
    start, t = 1024, 512
    kv_len = start + t
    npp = kv_len // ps
    q, kc, vc, tb, pos, _ = _case(rng, dev, b=1, t=t, h=h, n_kv=n_kv, hd=hd, ps=ps, npp=npp, dtype=dtype,
                                  lengths=[kv_len], contiguous=True)
    tb0 = tb[0].contiguous()
    kern = lambda: pp.paged_prefill_attention(q, kc, vc, tb0, pos, scale=scale)
    plain = lambda: pp.paged_prefill_plain(q, kc, vc, tb0, pos, scale=scale)
    err = compare(f"prefill timing inputs, {geom}", kern(), plain(), [(0, t)], dtype)
    kgp = gather_pages(kc, tb0, n_kv).permute(0, 2, 1, 3).contiguous()
    vgp = gather_pages(vc, tb0, n_kv).permute(0, 2, 1, 3).contiguous()
    qgp = q.permute(0, 2, 1, 3).contiguous()
    causal = (torch.arange(kv_len, device=dev)[None, :] <= (start + torch.arange(t, device=dev))[:, None])
    lib = lambda: F.scaled_dot_product_attention(qgp, kgp, vgp, attn_mask=causal, scale=scale, enable_gqa=True)
    pairs = t * start + t * (t + 1) // 2  # causal (query, key) pairs
    nbytes = 2 * kv_len * n_kv * hd * 2 + 2 * t * h * hd * 2 + npp * 4 + t * 4
    flops = 4 * pairs * h * hd
    out["paged_prefill"] = dict(
        ms=time_ms(kern, iters=20), plain_ms=time_ms(plain, iters=3), library_ms=time_ms(lib, iters=20),
        bound_ms=max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3,
        bound_by="bytes" if nbytes / HBM_BYTES_PER_S >= flops / BF16_FLOPS else "operations",
        shape=f"B=1 T={t} start={start} {geom}", max_abs_err=err, host_us_per_call=host_us(kern),
        device_us_by_kernel=device_us_by_kernel(kern, 5),
    )
    return out


def mixed_step_timing(dev, rng) -> dict:
    """paged_prefill at the serve's mixed-step shape (``mixed_step_check``'s
    spans: llama-3.2-1b geometry, bf16, a batch of 8 in a 512-token bucket on
    128-page tables, five of the rows 1-token decode rows). The library
    yardstick is one SDPA call over each row's gathered K/V (its whole
    128-page table, KV heads repeated to the query heads before timing) with
    the boolean mask ``kpos <= qpos & kpos < kv_len``."""
    import torch.nn.functional as F

    from dynamo_tpu_torch.ops import paged_prefill as pp
    from dynamo_tpu_torch.ops.attention import gather_pages

    h, n_kv, hd, ps, t, npp = 32, 8, 64, 16, 512, 128
    spans = MIXED_SPANS
    q, kc, vc, tb, _, _ = _case(rng, dev, b=len(spans), t=t, h=h, n_kv=n_kv, hd=hd, ps=ps, npp=npp,
                                dtype=torch.bfloat16, lengths=[s + n for s, n in spans], contiguous=True)
    pos = torch.from_numpy(_spans(spans, t)).to(dev)
    tb0 = tb[0].contiguous()
    scale = hd**-0.5
    kern = lambda: pp.paged_prefill_attention(q, kc, vc, tb0, pos, scale=scale)
    plain = lambda: pp.paged_prefill_plain(q, kc, vc, tb0, pos, scale=scale)
    err = compare("prefill mixed-step timing inputs", kern(), plain(), [(i, n) for i, (_, n) in enumerate(spans)],
                  torch.bfloat16)
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
    nbytes = (sum(2 * kv * n_kv * hd * 2 for kv in kv_lens) + sum(2 * n * h * hd * 2 for _, n in spans)
              + len(spans) * (npp * 4 + t * 4))
    flops = 4 * pairs * h * hd
    return dict(ms=time_ms(kern, iters=20), plain_ms=time_ms(plain, iters=3), library_ms=time_ms(lib, iters=20),
                bound_ms=max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3,
                bound_by="bytes" if nbytes / HBM_BYTES_PER_S >= flops / BF16_FLOPS else "operations",
                shape=f"B=8 T={t} spans={spans} heads={h}/{n_kv} hd={hd} bf16 page={ps}", max_abs_err=err,
                device_us_by_kernel=device_us_by_kernel(kern, 5))


def kernel_timings(dev) -> dict:
    """Each GQA kernel at the main path's geometry (llama-3.2-1b: 32/8 heads,
    hd 64) and at llama-3-8b's (32/8, hd 128), and the prefill kernel at the
    serve's mixed-step shape. Returns the main geometry's entries."""
    rng = torch.Generator(device=dev).manual_seed(1)
    out = _gqa_timings(dev, rng, 32, 8, 64)
    hd128 = _gqa_timings(dev, rng, 32, 8, 128)
    emit({"phase": "kernel_timing", **out, "paged_prefill_mixed_step": mixed_step_timing(dev, rng),
          "hd128": hd128})
    return out


# -- phase 3: forward -----------------------------------------------------------


def forward_check(dev, model: str) -> None:
    """One prefill chunk (T=64, two rows, the second continuing at 64) and
    one decode step of ``model`` at full width, run with the kernels and
    with the plain attention from the same caches."""
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.models.config import PRESETS

    cfg = PRESETS[model]
    params = llama.init_params(cfg, 0, device=dev)
    ps, npages = 16, 64
    kc0, vc0 = llama.init_kv_cache(cfg, npages, ps, device=dev)
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
    results = {}
    with torch.inference_mode():
        for impl in (None, "reference"):
            kc, vc = kc0.clone(), vc0.clone()
            pre, _, _ = llama.forward(params, cfg, tokens, pos, kc, vc, tables, slots, last, attn_impl=impl)
            dec, _, _ = llama.forward(params, cfg, dec_tok, dec_pos, kc, vc, tables, dec_slots,
                                      torch.zeros(b, dtype=torch.int32, device=dev), attn_impl=impl)
            results[impl] = (pre, dec)
    torch.cuda.synchronize()
    errs = {}
    for i, phase in enumerate(("prefill", "decode")):
        a, r = results[None][i], results["reference"][i]
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
    emit({"phase": "forward", "model": model, "logits_max_abs_err": errs,
          "tolerance": "0.05 * max|logit|", "logits_shape": list(results[None][0].shape)})


# -- phase 4: serve -------------------------------------------------------------


async def build_serving(model: str = MODEL):
    """The serve phase's engine and pipeline: ``build_engine_service`` of
    ``model`` (random init, bf16, on the card) behind ``build_pipeline``."""
    from dynamo_tpu_torch.launch import build_engine_service, build_pipeline

    service = await build_engine_service(model, **SERVE_ENGINE)
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


async def send_all(pipeline, bodies: list[dict]) -> list[dict]:
    """Send every body concurrently; per request its prompt length, tokens,
    time to first token and finish reason."""
    from dynamo_tpu_torch.runtime.engine import Context

    async def one(body: dict, n: int) -> dict:
        sent = time.perf_counter()
        first, toks, finish = None, [], None
        async for out in pipeline.generate(body, Context()):
            if out.token_ids and first is None:
                first = time.perf_counter() - sent
            toks += out.token_ids
            finish = out.finish_reason
        return {"n_prompt": n, "tokens": toks, "ttft_s": first, "finish": finish}

    return await asyncio.gather(*(one(body, n) for body, n in zip(bodies, SERVE_LENGTHS)))


async def serve(model: str) -> dict:
    """Serve the mix on ``model``; returns the launches of its kernels
    (``SERVE_KERNELS``) over the timed requests."""
    kernels = {name: importlib.import_module(f"dynamo_tpu_torch.ops.{name}") for name in SERVE_KERNELS[model]}
    t0 = time.perf_counter()
    service, pipeline = await build_serving(model)
    build_s = time.perf_counter() - t0
    bodies = serve_bodies(np.random.default_rng(3), model)
    try:
        await warm_up(pipeline, model)
        # Counters go to 0 just before the main path and are read just after;
        # the engine's own cumulative counters are read as differences.
        core = service.core
        dispatch0, mixed0 = dict(core.attn_dispatch_counts), core.mixed_steps
        for mod in kernels.values():
            mod.launches = 0
        start = time.perf_counter()
        results = await send_all(pipeline, bodies)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        launches = {name: mod.launches for name, mod in kernels.items()}
        dispatch = {f"{p}/{k}": n - dispatch0.get((p, k), 0) for (p, k), n in core.attn_dispatch_counts.items()}
        mixed = core.mixed_steps - mixed0
    finally:
        await service.close()
    for r in results:
        if len(r["tokens"]) != 32 or r["finish"] is None or r["finish"].value != "length":
            raise AssertionError(f"request of {r['n_prompt']} tokens ended with {len(r['tokens'])} tokens ({r['finish']})")
        if not all(0 <= tok < 128256 for tok in r["tokens"]):
            raise AssertionError("token id outside the vocabulary")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    off_kernel = {k: n for k, n in dispatch.items() if n and not k.endswith("/kernel")}
    if off_kernel:
        raise AssertionError(f"engine steps whose attention did not run in the kernels: {off_kernel}")
    if mixed <= 0:
        raise AssertionError("no mixed prefill+decode step occurred")
    out_tokens = sum(len(r["tokens"]) for r in results)
    ttfts = sorted(r["ttft_s"] for r in results)
    emit({"phase": "serve", "model": model, "requests": len(results), "prompt_tokens": SERVE_LENGTHS,
          "output_tokens": out_tokens, "wall_s": wall, "requests_per_s": len(results) / wall,
          "output_tokens_per_s": out_tokens / wall, "ttft_s": {"min": ttfts[0], "median": statistics.median(ttfts),
                                                              "max": ttfts[-1]},
          "engine_build_s": build_s, "kernel_launches": launches,
          "engine_steps": sum(dispatch.values()), "mixed_steps": mixed, "attn_dispatch_steps": dispatch})
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    try:
        from dynamo_tpu_torch.ops import build
    except ImportError as exc:
        print(f"chip_smoke: the dynamo_tpu_torch package is not importable here: {exc}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    t0 = time.perf_counter()
    built = build.build()
    regs = {name: sorted({int(x.split("Used ")[1].split()[0]) for x in log.splitlines() if "Used " in x})
            for name, log in built["ptxas"].items()}
    spills = {name: max([int(n) for n in re.findall(r"(\d+) bytes spill stores", log)] or [0])
              for name, log in built["ptxas"].items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "nvcc_registers": regs,
          "nvcc_max_spill_store_bytes": spills})
    if spills.get("paged_mla", 0):  # its consumers' registers are budgeted by setmaxnreg: a spill is a regression
        raise AssertionError(f"paged_mla spills registers: {spills['paged_mla']} bytes of spill stores")

    errs = kernel_checks(dev)
    mla_errs = mla_kernel_checks(dev)
    errs.update({f"paged_mla/{k}": e for k, e in mla_errs.items()})
    timing = kernel_timings(dev)
    # The kernels line carries paged_mla's decode time; its prefill and
    # mixed-step times are on the kernel_timing_mla line.
    timing["paged_mla"] = mla_timings(dev)["decode"]
    launches = {}
    for model in (MODEL, MLA_MODEL):
        forward_check(dev, model)
        gc.collect()
        torch.cuda.empty_cache()
    for model in (MODEL, MLA_MODEL):  # each model's service is freed before the next is built
        launches.update(asyncio.run(serve(model)))
        gc.collect()
        torch.cuda.empty_cache()

    replaces = {
        "paged_decode": "dynamo_tpu/ops/pallas_paged.py:230",
        "paged_prefill": "dynamo_tpu/ops/pallas_prefill.py:93",
        "paged_mla": "dynamo_tpu/ops/pallas_mla.py:83",
    }
    kernels = []
    for name in ("paged_decode", "paged_prefill", "paged_mla"):
        tm = timing[name]
        kernels.append({
            "name": name, "route": "cuda", "source": f"dynamo_tpu_torch/csrc/{name}.cu",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": max([tm["max_abs_err"]] + [e for k, e in errs.items() if k.startswith(name + "/")]),
            "ms": tm["ms"], "plain_ms": tm["plain_ms"], "bound_ms": tm["bound_ms"],
            "bound_by": tm["bound_by"], "library_ms": tm["library_ms"],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
