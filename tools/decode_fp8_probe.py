#!/usr/bin/env python3
"""What moves the fp8-cache form of paged_decode, on one card.

    python3 tools/decode_fp8_probe.py [--root DIR]

Builds variants of ``DIR``'s ``csrc/paged_decode.cu`` (default: this
checkout) with that checkout's own nvcc flags, each into a library of its
own in a temporary directory, and times its fp8 decode at ``chip_smoke.py``'s
timed shape (batch 8 x 2048 tokens, 32/8 heads, pages of 16, 128-page
tables, four layers' tables cycled so K/V come from HBM; bf16 queries) at hd
64 and hd 128, over 1, 2, 4 and 8 splits, through the library's C entry point.
The variants:

- ``base``: the source as it is;
- ``stages=N``: the fp8 ring ``kStagesF8`` (hd 64's, where the source
  keeps hd 128's apart) set to N;
- ``groups=N``: the fp8 form's warp groups a block ``kGroupsF8`` set to N;
- ``no_convert``: the e4m3 -> bf16 conversion (``fp8x8_to_bf16x8`` in
  ``common.cuh``) replaced by a plain copy of the bytes: the numbers are
  wrong, every load, store, barrier and product of the walk stays.

Every variant but ``no_convert`` is held against the plain version at the
bf16 tolerance before it is timed. Device ms come from ``chip_smoke.time_ms``
(CUDA-graph replay between CUDA events, median of 7). The bf16 cache's time
over the same splits is printed beside them. Then, with the base build, two
sweeps on bf16 and fp8 caches: the cache row width at the same bytes and
blocks (B x n_kv from 8 x 8 to 64 x 1 at 2 splits), and contexts of 64, 512
and 2048 tokens over 1, 2, 4 and 8 splits with the profiler's kernel µs
beside the device ms (a 64-key walk is almost all start-up and merge).
Prints one JSON line per (variant, hd) and per sweep entry, then the card's
name and power limit. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402  (the shapes, the checks and the timer live there)
from dynamo_tpu_torch.ops import build  # noqa: E402
from dynamo_tpu_torch.ops import paged_decode as pd  # noqa: E402
from kernel_ab import call_decode  # noqa: E402  (tools/, this script's directory)

SPLITS = (1, 2, 4, 8)
NO_CONVERT = ("__device__ __forceinline__ uint4 fp8x8_to_bf16x8(uint2 v) {\n"
              "  return make_uint4(v.x, v.y, v.x ^ v.y, v.x + v.y);\n}\n"
              "__device__ __forceinline__ uint4 fp8x8_to_bf16x8_unused(uint2 v) {")


def variants(src: str) -> dict:
    """{name: (paged_decode.cu text, common.cuh patch or None)}; a value the
    source already has is left out (it is ``base``). Raises if the source
    has no constant for a knob."""
    out = {"base": (src, None), "no_convert": (src, NO_CONVERT)}
    for knob, name, values in (("kStagesF8", "stages", (3, 4, 6, 8)), ("kGroupsF8", "groups", (1, 2, 4))):
        if not re.search(rf"constexpr int {knob} = \d+;", src):
            raise RuntimeError(f"paged_decode.cu has no 'constexpr int {knob} = N;' to vary")
        for n in values:
            text = re.sub(rf"constexpr int {knob} = \d+;", f"constexpr int {knob} = {n};", src)
            if text != src:
                out[f"{name}={n}"] = (text, None)
    return out


def build_variant(root: str, flags, name: str, src: str, common_patch: str | None, tmp: str):
    """Compile one variant of paged_decode.cu beside a copy of the root's
    headers; returns its bound C entry point."""
    vdir = os.path.join(tmp, re.sub(r"\W", "_", name))
    shutil.copytree(os.path.join(root, "dynamo_tpu_torch", "csrc"), vdir)
    with open(os.path.join(vdir, "paged_decode.cu"), "w") as f:
        f.write(src)
    if common_patch:
        path = os.path.join(vdir, "common.cuh")
        text = open(path).read()
        head = "__device__ __forceinline__ uint4 fp8x8_to_bf16x8(uint2 v) {"
        if head not in text:
            raise RuntimeError("common.cuh has no fp8x8_to_bf16x8 to replace")
        with open(path, "w") as f:
            f.write(text.replace(head, common_patch))
    lib = os.path.join(vdir, "libpaged_decode.so")
    proc = subprocess.run([build._nvcc(), *flags, "-o", lib, os.path.join(vdir, "paged_decode.cu")],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{name}: nvcc failed:\n{proc.stdout}{proc.stderr}")
    spills = max([int(n) for n in re.findall(r"(\d+) bytes spill stores", proc.stdout + proc.stderr)] or [0])
    fn = ctypes.CDLL(lib).dyn_paged_decode
    fn.argtypes = build.SIGNATURES["paged_decode"][1]
    fn.restype = ctypes.c_int
    return fn, spills


def call(fn, q, kc, vc, tb, pos, scale, splits):
    max_blocks = -(-(tb.shape[1] * kc.shape[1]) // pd.BLOCK_TOKENS)
    return call_decode(fn, q, kc, vc, tb, pos, scale, splits, -(-max_blocks // splits), "probe paged_decode")


def main(root: str) -> int:
    if not torch.cuda.is_available():
        print("decode_fp8_probe: no CUDA device available", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("root_build", os.path.join(root, "dynamo_tpu_torch/ops/build.py"))
    root_build = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(root_build)
    dev = torch.device("cuda")
    src = open(os.path.join(root, "dynamo_tpu_torch", "csrc", "paged_decode.cu")).read()
    b, ctx, ps, layers, h, n_kv = 8, 2048, 16, 4, 32, 8
    npp = ctx // ps
    with tempfile.TemporaryDirectory() as tmp, concurrent.futures.ThreadPoolExecutor() as pool:
        jobs = {name: pool.submit(build_variant, root, root_build.NVCC_FLAGS, name, text, patch, tmp)
                for name, (text, patch) in variants(src).items()}
        fns = {name: job.result() for name, job in jobs.items()}
        for hd in (64, 128):
            rng = torch.Generator(device=dev).manual_seed(40 + hd)
            scale = hd**-0.5
            cases = {}
            for cache in (torch.bfloat16, cs.FP8):
                q, kc, vc, tb, pos, _ = cs._case(rng, dev, b=b, t=1, h=h, n_kv=n_kv, hd=hd, ps=ps, npp=npp,
                                                 dtype=cache, lengths=[ctx] * b, contiguous=True, layers=layers,
                                                 q_dtype=torch.bfloat16)
                cases[cache] = (q, kc, vc, [tb[i].contiguous() for i in range(layers)], pos)
            for name, (fn, spills) in fns.items():
                for cache in (cs.FP8, torch.bfloat16) if name == "base" else (cs.FP8,):
                    q, kc, vc, tbs, pos = cases[cache]
                    rec = {"variant": name, "hd": hd, "cache": str(cache).removeprefix("torch."),
                           "spill_stores": spills, "ms": {}}
                    for splits in SPLITS:
                        try:
                            got = call(fn, q, kc, vc, tbs[0], pos, scale, splits)
                        except RuntimeError as exc:  # e.g. a layout over the shared-memory limit
                            rec["ms"][splits] = str(exc)
                            continue
                        if name != "no_convert":
                            cs.compare(f"probe {name} hd{hd} splits{splits}", got,
                                       pd.paged_decode_plain(q, kc, vc, tbs[0], pos, scale=scale, num_splits=splits),
                                       [(r, 1) for r in range(b)], torch.bfloat16)
                        it = iter(range(10**9))
                        rec["ms"][splits] = cs.time_ms(
                            lambda: call(fn, q, kc, vc, tbs[next(it) % layers], pos, scale, splits), iters=50)
                    print(json.dumps(rec), flush=True)
        # The same bytes over narrower cache rows: B x n_kv fixed at 64 row
        # tiles of 4 heads, so every layout runs the same blocks (2 splits)
        # and moves the same bytes; with one KV head a row is one head's strip.
        fn = fns["base"][0]
        for hd in (64, 128):
            rng = torch.Generator(device=dev).manual_seed(60 + hd)
            for cache in (cs.FP8, torch.bfloat16):
                rec = {"sweep": "row width", "hd": hd, "cache": str(cache).removeprefix("torch."), "ms": {}}
                for bb, kv in ((8, 8), (16, 4), (32, 2), (64, 1)):
                    q, kc, vc, tb, pos, _ = cs._case(rng, dev, b=bb, t=1, h=4 * kv, n_kv=kv, hd=hd, ps=ps,
                                                     npp=npp, dtype=cache, lengths=[ctx] * bb, contiguous=True,
                                                     layers=layers, q_dtype=torch.bfloat16)
                    tbs = [tb[i].contiguous() for i in range(layers)]
                    it = iter(range(10**9))
                    rec["ms"][f"B={bb} n_kv={kv} row={kv * hd * cache.itemsize}B"] = cs.time_ms(
                        lambda: call(fn, q, kc, vc, tbs[next(it) % layers], pos, hd**-0.5, 2), iters=50)
                    del q, kc, vc, tb, tbs
                print(json.dumps(rec), flush=True)
        # Where a launch's time goes: the base build at shorter contexts (a
        # walk of 64 keys is almost all start-up and merge), device ms beside
        # the profiler's kernel duration (no launch gap in it).
        fn = fns["base"][0]
        for hd in (64, 128):
            rng = torch.Generator(device=dev).manual_seed(50 + hd)
            for cache in (cs.FP8, torch.bfloat16):
                for ctx_s in (64, 512, ctx):
                    q, kc, vc, tb, pos, _ = cs._case(rng, dev, b=b, t=1, h=h, n_kv=n_kv, hd=hd, ps=ps, npp=npp,
                                                     dtype=cache, lengths=[ctx_s] * b, contiguous=True,
                                                     layers=layers, q_dtype=torch.bfloat16)
                    tbs = [tb[i].contiguous() for i in range(layers)]
                    rec = {"sweep": "context", "hd": hd, "cache": str(cache).removeprefix("torch."), "ctx": ctx_s,
                           "ms": {}, "kernel_us": {}}
                    for splits in SPLITS:
                        it = iter(range(10**9))
                        run = lambda: call(fn, q, kc, vc, tbs[next(it) % layers], pos, hd**-0.5, splits)
                        rec["ms"][splits] = cs.time_ms(run, iters=50)
                        rec["kernel_us"][splits] = sum(cs.device_us_by_kernel(run, 20).values())
                    print(json.dumps(rec), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    help="checkout whose csrc/paged_decode.cu is probed (default: this one)")
    sys.exit(main(ap.parse_args().root))
