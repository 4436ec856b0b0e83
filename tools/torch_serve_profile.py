#!/usr/bin/env python3
"""Where a serving step's time goes in the PyTorch/CUDA port, on one card.

    python3 tools/torch_serve_profile.py --out DIR [--model mla-8b-proxy] [--kv-cache-dtype fp8]
                                         [--no-graphs] [--no-overlap] [--mix spec --spec-k 4]

Serves the request mix of ``chip_smoke.py``'s serve phase, taken from that
script so the two stay the same (llama-3.2-1b by default, or any model of
its ``SERVE_KERNELS``: mla-8b-proxy, olmoe-1b-7b, ...; random init, 8 concurrent completions of 16..1500 prompt tokens, 32 output
tokens each), after the same warm-up request and untimed pass of other
prompts (so CUDA graphs are captured before the window), under
``torch.profiler`` (CPU + CUDA activities). By default the main path: CUDA
graphs behind the overlapped engine; ``--no-graphs`` runs the eager runner,
``--no-overlap`` the synchronous engine; ``--kv-cache-dtype fp8`` serves
on fp8 e4m3 KV caches (the kernels' fp8 forms), bf16 by default.
``--mix spec`` serves the spec phase's mix instead (8 prompts of a repeated
random span, 64 output tokens; ``chip_smoke.spec_bodies``), as
``chip_smoke.serve_spec`` does (its untimed pass is the mix itself, with
prefix caching off), with ``--spec-k K`` drafting K tokens a decode row
(0: off).
Prints one JSON line: wall time, engine steps, device busy share (union of
CUDA kernel intervals over the profiled wall), CUDA kernels per step (a
graph replay's kernels included), the host's launch calls per step (the
calls that put a kernel or a graph on a stream, by name), and the
device time by kernel family. Writes the Chrome trace to
``DIR/serve_trace_<model>_<kv cache dtype>_<mix><spec_k>.json`` (tens of MB). The profiler adds host overhead of
its own, so the wall time here is not a throughput number;
``chip_smoke.py`` measures that without the profiler.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402  (the serve mix lives there)

FAMILIES = (  # kernel name fragment -> family, first match wins
    ("decode_partials", "attention: paged_decode"), ("decode_mma", "attention: paged_decode"),
    ("mla_", "attention: paged_mla"), ("grouped_mm", "moe: grouped_matmul"),
    ("prefill", "attention: paged_prefill"), ("gemm", "matmul"), ("gemv", "matmul"), ("cutlass", "matmul"),
    ("sm90_xmma", "matmul"), ("nvjet", "matmul"), ("index", "gather/scatter"), ("elementwise", "elementwise"),
    ("reduce", "reduction"), ("softmax", "sampling/softmax"), ("topk", "sampling/softmax"),
    ("sort", "sampling/softmax"), ("Memcpy", "copy"), ("copy", "copy"), ("cat", "elementwise"),
)
# Host calls that put a kernel or a graph on a stream.
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaGraphLaunch", "cuGraphLaunch")


def family(name: str) -> str:
    for frag, fam in FAMILIES:
        if frag.lower() in name.lower():
            return fam
    return "other"


async def main(out_dir: str, model: str, graphs: bool, overlap: bool, kv_cache_dtype: str = "bf16",
               mix: str = "serve", spec_k: int = 0) -> dict:
    cache_dtype = chip_smoke.FP8 if kv_cache_dtype == "fp8" else None
    spec = mix == "spec"
    # The spec mix as chip_smoke.serve_spec serves it: its untimed pass is the
    # timed mix itself, prefix caching off, so the window replays its graphs.
    service, pipeline = await chip_smoke.build_serving(model, cache_dtype, graphs=graphs, overlap=overlap,
                                                       spec_k=spec_k, enable_prefix_caching=not spec)
    bodies_of, lengths = ((chip_smoke.spec_bodies, chip_smoke.SPEC_LENGTHS) if spec
                          else (chip_smoke.serve_bodies, chip_smoke.SERVE_LENGTHS))
    bodies = bodies_of(np.random.default_rng(7 if spec else 3), model)
    steps = {"n": 0}
    step = service.core.step

    def counted_step():
        steps["n"] += 1
        return step()

    service.core.step = counted_step
    try:
        await chip_smoke.warm_up(pipeline, model)  # not profiled
        await chip_smoke.send_all(pipeline, bodies if spec else bodies_of(np.random.default_rng(4), model), lengths)
        torch.cuda.synchronize()
        steps["n"] = 0
        overlap0 = dict(service.core.overlap_step_counts)
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            await chip_smoke.send_all(pipeline, bodies, lengths)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        overlap_steps = {k: n - overlap0.get(k, 0) for k, n in service.core.overlap_step_counts.items()}
        graph_stats = service.core.runner.graph_stats()
    finally:
        await service.close()
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, f"serve_trace_{model}_{kv_cache_dtype}_{mix}{spec_k}.json"))
    events = prof.events()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    launch_calls: dict[str, int] = {}
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CPU and e.name in LAUNCH_CALLS:
            launch_calls[e.name] = launch_calls.get(e.name, 0) + 1
    busy = chip_smoke.busy_us(kernels)
    by_family: dict[str, float] = {}
    for e in kernels:
        fam = family(e.name)
        by_family[fam] = by_family.get(fam, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
    n_steps = max(1, steps["n"])
    return {
        "model": model, "kv_cache_dtype": kv_cache_dtype, "device": torch.cuda.get_device_name(0), "graphs": graphs,
        "overlap": overlap, "mix": mix, "spec_k": spec_k,
        "profiled_wall_s": wall, "engine_steps": steps["n"], "overlap_steps": overlap_steps,
        "graph_keys": graph_stats["keys"], "cuda_kernels": len(kernels),
        "kernels_per_step": len(kernels) / n_steps,
        "host_launch_calls_per_step": sum(launch_calls.values()) / n_steps,
        "host_launch_calls_by_name": launch_calls,
        "device_busy_share": busy / 1e6 / wall,
        "device_ms_by_family": dict(sorted(by_family.items(), key=lambda kv: -kv[1])),
    }


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", required=True, help="directory for the Chrome trace")
    ap.add_argument("--model", default=chip_smoke.MODEL, choices=sorted(chip_smoke.SERVE_KERNELS),
                    help="the served preset (default %(default)s)")
    ap.add_argument("--kv-cache-dtype", default="bf16", choices=("bf16", "fp8"),
                    help="the KV caches' dtype (default %(default)s)")
    ap.add_argument("--graphs", action=argparse.BooleanOptionalAction, default=True,
                    help="replay each step as a CUDA graph (default on)")
    ap.add_argument("--overlap", action=argparse.BooleanOptionalAction, default=True,
                    help="the overlapped engine pipeline (default on)")
    ap.add_argument("--mix", default="serve", choices=("serve", "spec"),
                    help="the serve phase's mix or the spec phase's (default %(default)s)")
    ap.add_argument("--spec-k", type=int, default=0, help="draft tokens a decode row (default 0: off)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_serve_profile: no CUDA device available", file=sys.stderr)
        sys.exit(2)
    print(json.dumps(asyncio.run(main(args.out, args.model, args.graphs, args.overlap, args.kv_cache_dtype,
                                      args.mix, args.spec_k))), flush=True)
