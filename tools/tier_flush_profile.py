#!/usr/bin/env python3
"""Where a tier write-through flush spends its host time, on one card.

    python3 tools/tier_flush_profile.py

Serves ``chip_smoke.py``'s serve mix on llama-3.2-1b (random init, the main
path: CUDA graphs behind the overlapped engine) with every committed page
written through to a host tier (G2), as that script's busy-share run does
(without its profiler), twice: an untimed pass, then the measured one.
Prints one JSON line with:

- ``flush_profile``: ``chip_smoke.flush_profile``'s split of the measured
  pass's flushes (page read dispatch, copy wait, per-page host copies, tier
  puts);
- ``flush_pages``: the pages of each of its flushes;
- ``dispatch_ms``: the page read's dispatch in those flushes, split into
  the page ids' copy to the card (``_ids_to_device``), the gather
  (``_gather``), the pinned buffers' allocation (``torch.empty(...,
  pin_memory=True)`` on the flushing thread) and the rest (copies and
  events issued, the I/O lock);
- ``per_flush_ms``: each of those flushes' host ms beside its pinned
  allocation's;
- ``pinned_alloc_ms``: ``torch.empty(n, pin_memory=True)`` at the sizes a
  read of 256 and 512 bf16 pages allocates (sizes the serve never asked
  for), the first time and again after the buffer was freed;
- ``page_copies``: 128 copies of a 256 KB page (one bf16 page of
  llama-3.2-1b's k or v cache) out of a pinned buffer, each into a fresh
  numpy array (as ``InFlightPages.wait`` makes them) and each into an array
  allocated and touched beforehand: host ms, median and most of 5.

Torch's profiler is not used: it records no CPU op on the executor threads
that run a service's steps and flushes.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402  (the serve mix and the flush split live there)


def page_copies(pages: int = 128, page_bytes: int = 256 * 1024) -> dict:
    src = torch.empty(pages * page_bytes // 2, dtype=torch.int16, pin_memory=True)
    src.random_(-2**15, 2**15 - 1)
    view = src.numpy().view(np.uint16).reshape(pages, -1)
    kept = [np.ones(page_bytes // 2, np.uint16) for _ in range(pages)]  # touched once, reused

    def fresh():
        return [view[i].copy() for i in range(pages)]

    def reused():
        for i in range(pages):
            np.copyto(kept[i], view[i])

    out = {}
    for name, fn in (("fresh_arrays", fresh), ("touched_arrays", reused)):
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            held = fn()
            times.append(1e3 * (time.perf_counter() - t0))
            del held
        out[name] = {"ms_median": statistics.median(times), "ms_max": max(times)}
    out.update(pages=pages, page_bytes=page_bytes)
    return out


def pinned_alloc() -> dict:
    out = {}
    for pages in (256, 512):
        n = pages * 256 * 1024  # bytes of one cache's pages, bf16
        times = []
        for _ in range(2):
            t0 = time.perf_counter()
            buf = torch.empty(n, dtype=torch.uint8, pin_memory=True)
            times.append(1e3 * (time.perf_counter() - t0))
            del buf
        out[f"{pages}_pages"] = {"first": times[0], "again": times[1]}
    return out


async def serve(params: dict) -> tuple[dict, list[int], dict, list[dict]]:
    import threading

    from dynamo_tpu_torch.blocks import BlockManagerConfig

    bm_cfg = BlockManagerConfig(g2_capacity_blocks=4 * chip_smoke.TIER_G2_BLOCKS)
    service, pipeline = await chip_smoke.build_serving(chip_smoke.MODEL, None, params,
                                                       block_manager_config=bm_cfg)
    core, runner = service.core, service.core.runner
    parts = dict(ids_to_device=0.0, gather=0.0, pinned_alloc=0.0)
    flushing, pages, per_flush = set(), [], []
    empty, ids_to_device, gather = torch.empty, runner._ids_to_device, runner._gather

    def timed(key, fn, only_pinned=False):
        def call(*a, **kw):
            if threading.get_ident() not in flushing or (only_pinned and not kw.get("pin_memory")):
                return fn(*a, **kw)
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                parts[key] += time.perf_counter() - t0
        return call

    try:
        await chip_smoke.warm_up(pipeline)
        await chip_smoke.send_all(pipeline, chip_smoke.serve_bodies(np.random.default_rng(4)))
        torch.cuda.synchronize()
        with chip_smoke.flush_profile(core) as split:
            split_flush = core.flush_offloads

            def noted_flush():
                if not core.pending_offloads:
                    return split_flush()
                pages.append(len(core.pending_offloads))
                alloc0, t0 = parts["pinned_alloc"], time.perf_counter()
                flushing.add(threading.get_ident())
                try:
                    split_flush()
                finally:
                    flushing.discard(threading.get_ident())
                    per_flush.append({"ms": 1e3 * (time.perf_counter() - t0),
                                      "pinned_alloc_ms": 1e3 * (parts["pinned_alloc"] - alloc0)})

            core.flush_offloads = noted_flush
            runner._ids_to_device, runner._gather = timed("ids_to_device", ids_to_device), timed("gather", gather)
            torch.empty = timed("pinned_alloc", empty, only_pinned=True)
            try:
                await chip_smoke.send_all(pipeline, chip_smoke.serve_bodies(np.random.default_rng(3)))
                torch.cuda.synchronize()
            finally:
                torch.empty = empty
                del runner._ids_to_device, runner._gather
                core.flush_offloads = split_flush
    finally:
        await service.close()
    dispatch = {k: 1e3 * v for k, v in parts.items()}
    dispatch["rest"] = 1e3 * split["dispatch_s"] - sum(dispatch.values())
    return split, pages, dispatch, per_flush


def main() -> int:
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args()
    if not torch.cuda.is_available():
        print("tier_flush_profile: no CUDA device", file=sys.stderr)
        return 1
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.models.config import PRESETS
    from dynamo_tpu_torch.ops import build

    build.build()
    dev = torch.device("cuda")
    params = llama.init_params(PRESETS[chip_smoke.MODEL], 0, device=dev)
    split, pages, dispatch, per_flush = asyncio.run(serve(params))
    print(json.dumps({"model": chip_smoke.MODEL, "flush_profile": split, "flush_pages": pages,
                      "dispatch_ms": dispatch, "per_flush_ms": per_flush, "pinned_alloc_ms": pinned_alloc(),
                      "page_copies": page_copies(),
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
