#!/usr/bin/env python3
"""Two builds of the port's kernels on the same inputs, on one card.

    python3 tools/kernel_ab.py --other DIR [--kernels attention quant_matmul]

``DIR`` is another checkout of this repository (for example the parent
commit, unpacked with ``git archive``). Its ``paged_decode``,
``paged_prefill`` and ``paged_mla`` libraries are built from its own
sources with its own flags (its ``ops/build.py``) and called through their
C entry points, the decode one with its own split plan (its
``ops/paged_decode.py``); this checkout's through its wrappers. At each
timing shape of ``chip_smoke.py`` (llama-3.2-1b's and llama-3-8b's decode
of 8 x 2048 tokens, four layers' tables cycled, and a gappy verify at T_q 8
on the same tables; their prefill chunk, the serve's mixed step;
mla-8b-proxy's decode, prefill chunk and mixed step), on bf16 and on fp8
caches, both see the same inputs: the lines say whether the outputs are
bitwise equal over the real rows (else their largest difference) and each
version's device ms (CUDA-graph replay, ``chip_smoke.time_ms``), timed in
turns: other, this, this, other. ``quant_matmul`` (``--kernels
quant_matmul``): at ``chip_smoke.py``'s timed products (QUANT_TIMED at
QUANT_TIMED_M rows, int8 and int4, and the head at M 8, f32 out), each tree
with its own plan (its ``ops/quant_matmul.py``; an older tree's entry point
takes a split-K workspace), the weights cycled through copies that exceed
the L2 as ``kernel_timing_quant`` cycles them; the two sum in different
orders, so the outputs are held within ``chip_smoke.REL_TOL`` per row, not
bitwise. Prints one JSON line per shape, then the card's name and power
limit. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402  (the shapes and the timer live there)
from dynamo_tpu_torch.ops import build  # noqa: E402
from dynamo_tpu_torch.ops import paged_decode as pd  # noqa: E402
from dynamo_tpu_torch.ops import paged_mla as pm  # noqa: E402
from dynamo_tpu_torch.ops import paged_prefill as pp  # noqa: E402
from dynamo_tpu_torch.ops import quant_matmul as qmm  # noqa: E402

FP8 = cs.FP8


def _module(root: str, name: str, path: str):
    spec = importlib.util.spec_from_file_location(name, os.path.join(root, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def other_entry_points(root: str) -> dict:
    """The other checkout's C entry points, built by its own build module:
    {"paged_decode": (fn, split_plan), "paged_prefill": (fn,), "paged_mla":
    (fn, takes_share)}. split_plan is the other tree's decode_split_plan;
    takes_share says whether its MLA entry point has this tree's
    share-group argument (a tree without it has one int fewer). The other
    tree's MLA runs with no share group (1)."""
    other = _module(root, "other_build", "dynamo_tpu_torch/ops/build.py")
    other.build(("paged_decode", "paged_prefill", "paged_mla"))
    if other.SIGNATURES["paged_decode"][1] != build.SIGNATURES["paged_decode"][1]:
        raise RuntimeError("the other tree's paged_decode entry point takes other arguments")
    split_plan = _module(root, "other_paged_decode", "dynamo_tpu_torch/ops/paged_decode.py").decode_split_plan
    takes_share = len(other.SIGNATURES["paged_mla"][1]) == len(build.SIGNATURES["paged_mla"][1])
    return {"paged_decode": (other.load("paged_decode"), split_plan), "paged_prefill": (other.load("paged_prefill"),),
            "paged_mla": (other.load("paged_mla"), takes_share)}


def other_quant(root: str):
    """The other checkout's quant_matmul entry point and its plan."""
    other = _module(root, "other_build_quant", "dynamo_tpu_torch/ops/build.py")
    other.build(("quant_matmul",))
    return other.load("quant_matmul"), _module(root, "other_quant_matmul", "dynamo_tpu_torch/ops/quant_matmul.py").plan


def call_other_quant(fn, plan, x: torch.Tensor, leaf: dict, odt: torch.dtype, sms: int) -> torch.Tensor:
    """One launch of another tree's quant_matmul with its own plan: an
    entry point whose plan is (config, splits) also takes a split-K
    workspace; one whose plan is (form, param, splits) does not."""
    mode = "int4" if "qw4" in leaf else "int8"
    qw, scale, qbias = leaf["qw4" if mode == "int4" else "qw"], leaf["scale"], leaf.get("qbias")
    m, k = x.shape
    n = qw.shape[1]
    out = torch.empty((m, n), dtype=odt, device=x.device)
    p = plan(m, n, k, sms, mode)
    head = [x.data_ptr(), qw.data_ptr(), scale.data_ptr(), qbias.data_ptr() if qbias is not None else None,
            out.data_ptr()]
    tail = [m, n, k, 0 if mode == "int8" else 1, qmm.group_size(leaf), build.DTYPE_CODES[scale.dtype],
            build.DTYPE_CODES[odt], *p, build.stream_of(x)]
    if len(p) == 2:
        ws = torch.empty(p[1] * m * n, dtype=torch.float32, device=x.device) if p[1] > 1 else None
        head.append(ws.data_ptr() if ws is not None else None)
    build.check_launch("other quant_matmul", fn(*head, *tail))
    return out


def quant_ab(root: str, dev) -> list[dict]:
    """This tree's quant_matmul against the other's at the smoke's timed products."""
    fn, plan = other_quant(root)
    build.build(("quant_matmul",))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(31)
    timed = [(fmt, name, k, n, cs.QUANT_TIMED_M, torch.bfloat16) for fmt in ("int8", "int4")
             for name, k, n in cs.QUANT_TIMED]
    timed.append(("int8", "llama-3-8b lm_head", 4096, cs.QUANT_HEAD_N, (8,), torch.float32))
    records = []
    for fmt, name, k, n, ms, odt in timed:
        leaf = cs.quant_leaf(dev, gen, k, n, fmt)
        nbytes = sum(t.numel() * t.element_size() for t in leaf.values())
        copies = [leaf] + [{c: t.clone() for c, t in leaf.items()} for _ in range(-(-4 * cs.L2_BYTES // nbytes) - 1)]
        for m in ms:
            x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
            this = qmm.quant_matmul(x, leaf, odt)
            other = call_other_quant(fn, plan, x, leaf, odt, sms)
            err = cs.compare_rows(f"quant_matmul {fmt} {name} M={m}: this tree against the other", this, other)
            t_this = lambda: [qmm.quant_matmul(x, c, odt) for c in copies]  # noqa: E731
            t_other = lambda: [call_other_quant(fn, plan, x, c, odt, sms) for c in copies]  # noqa: E731
            o1 = cs.time_ms(t_other, iters=2) / len(copies)
            t1 = cs.time_ms(t_this, iters=2) / len(copies)
            t2 = cs.time_ms(t_this, iters=2) / len(copies)
            o2 = cs.time_ms(t_other, iters=2) / len(copies)
            rec = {"kernel": "quant_matmul", "format": fmt, "shape": name, "m": m,
                   "out": str(odt).removeprefix("torch."),
                   "this_plan": list(qmm.plan(m, n, k, sms, fmt)), "other_plan": list(plan(m, n, k, sms, fmt)),
                   "max_abs_diff": err, "within_rel_tol": True, "other_ms": [o1, o2], "this_ms": [t1, t2],
                   "this_over_other": (t1 + t2) / (o1 + o2)}
            print(json.dumps(rec), flush=True)
            records.append(rec)
        del copies, leaf
        torch.cuda.empty_cache()
    return records


def call_decode(fn, q, kc, vc, tb, pos, scale, splits: int, bps: int, what: str = "other paged_decode"):
    """One launch of a paged_decode library's C entry point ``fn`` over
    ``splits`` splits of ``bps`` 64-key blocks each."""
    b, t, h, hd = q.shape
    _, ps, w = kc.shape
    out = torch.empty_like(q)
    err = fn(q.data_ptr(), kc.data_ptr(), vc.data_ptr(), tb.data_ptr(), pos.data_ptr(), out.data_ptr(), b, t, h,
             w // hd, hd, ps, tb.shape[1], kc.shape[0], splits, bps, build.DTYPE_CODES[kc.dtype],
             build.DTYPE_CODES[q.dtype], float(scale), build.stream_of(q))
    build.check_launch(what, err)
    return out


def other_decode(fn, split_plan, q, kc, vc, tb, pos, scale):
    splits, bps = split_plan(q.shape[0], kc.shape[2] // q.shape[3], tb.shape[1], kc.shape[1], 0, q.device)
    return call_decode(fn, q, kc, vc, tb, pos, scale, splits, bps)


def other_prefill(fn, q, kc, vc, tb, pos, scale):
    b, t, h, hd = q.shape
    out = torch.empty_like(q)
    err = fn(q.data_ptr(), kc.data_ptr(), vc.data_ptr(), tb.data_ptr(), pos.data_ptr(), out.data_ptr(), b, t, h,
             kc.shape[2] // hd, hd, kc.shape[1], tb.shape[1], kc.shape[0], build.DTYPE_CODES[kc.dtype],
             build.DTYPE_CODES[q.dtype], float(scale), build.stream_of(q))
    build.check_launch("other paged_prefill", err)
    return out


def other_mla(fn, takes_share, q_lat, q_rope, c, r, tb, pos, scale, walk):
    b, t, h, r_kv = q_lat.shape
    splits, bps = pm.mla_split_plan(b, t, tb.shape[1], c.shape[1], 0, q_lat.device)
    walk = (None, None) if t == 1 else walk
    out = torch.empty((b, t, h, r_kv), dtype=torch.float32, device=q_lat.device)
    share = [1] if takes_share else []
    err = fn(q_lat.data_ptr(), q_rope.data_ptr(), c.data_ptr(), r.data_ptr(), tb.data_ptr(), pos.data_ptr(),
             *(x.data_ptr() if x is not None else None for x in walk), out.data_ptr(), b, t, h, r_kv,
             q_rope.shape[-1], r.shape[2], c.shape[1], tb.shape[1], c.shape[0], splits, bps, *share,
             build.DTYPE_CODES[c.dtype], build.DTYPE_CODES[q_lat.dtype], float(scale), build.stream_of(q_lat))
    build.check_launch("other paged_mla", err)
    return out


def compare(kernel: str, shape: str, cache, this, other, rows, iters: int) -> dict:
    a, b = this(), other()
    torch.cuda.synchronize()
    equal = all(torch.equal(a[i, :n], b[i, :n]) for i, n in rows)
    diff = max(float((a[i, :n].float() - b[i, :n].float()).abs().max()) for i, n in rows)
    o1 = cs.time_ms(other, iters=iters)
    t1 = cs.time_ms(this, iters=iters)
    t2 = cs.time_ms(this, iters=iters)
    o2 = cs.time_ms(other, iters=iters)
    rec = {"kernel": kernel, "shape": shape, "cache": str(cache).removeprefix("torch."), "bitwise_equal": equal,
           "max_abs_diff": diff, "other_ms": [o1, o2], "this_ms": [t1, t2],
           "this_over_other": (t1 + t2) / (o1 + o2)}
    print(json.dumps(rec), flush=True)
    return rec


def main(root: str, kernels) -> int:
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    records = quant_ab(root, dev) if "quant_matmul" in kernels else []
    if "attention" in kernels:
        records += attention_ab(root, dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    bf16 = [r for r in records if r.get("cache") == "bfloat16"]
    print(json.dumps({"bf16_bitwise_equal": all(r["bitwise_equal"] for r in bf16), "records": len(records)}))
    return 0


def attention_ab(root: str, dev) -> list[dict]:
    """This tree's attention kernels against the other's at the smoke's shapes."""
    other = other_entry_points(root)
    build.build(("paged_decode", "paged_prefill", "paged_mla"))
    rng = torch.Generator(device=dev).manual_seed(30)
    records = []
    for cache in (torch.bfloat16, FP8):
        for hd in (64, 128):
            b, ctx, layers, npp = 8, 2048, 4, 128
            q, kc, vc, tb, pos, _ = cs._case(rng, dev, b=b, t=1, h=32, n_kv=8, hd=hd, ps=16, npp=npp, dtype=cache,
                                             lengths=[ctx] * b, contiguous=True, layers=layers,
                                             q_dtype=torch.bfloat16)
            tbs = [tb[i].contiguous() for i in range(layers)]
            # Each call reads the next layer's pages, from HBM as a serving
            # step does; the two versions' first calls (compared) read layer 0.
            it_this, it_other = iter(range(10**9)), iter(range(10**9))
            records.append(compare(
                "paged_decode", f"hd {hd} decode {b} x {ctx}", cache,
                lambda: pd.paged_decode_attention(q, kc, vc, tbs[next(it_this) % layers], pos, scale=hd**-0.5),
                lambda: other_decode(*other["paged_decode"], q, kc, vc, tbs[next(it_other) % layers], pos,
                                     hd**-0.5),
                [(i, 1) for i in range(b)], 50))
            lengths = [1, 37, 300, 1000, 2048, 1500, 700, 64]
            qv = torch.randn((b, 8, 32, hd), generator=rng, device=dev).to(torch.bfloat16)
            pv_np = cs._positions(lengths, 8, contiguous=False)
            pv = torch.from_numpy(pv_np).to(dev)
            records.append(compare(
                "paged_decode", f"hd {hd} verify T_q 8 {lengths}", cache,
                lambda: pd.paged_decode_attention(qv, kc, vc, tbs[0], pv, scale=hd**-0.5),
                lambda: other_decode(*other["paged_decode"], qv, kc, vc, tbs[0], pv, hd**-0.5),
                [(i, min(8, n)) for i, n in enumerate(lengths)], 50))
            del q, kc, vc, tb, tbs
        for hd, name, spans in ((64, "chunk", [(1024, 512)]), (64, "mixed step", cs.MIXED_SPANS),
                                (128, "chunk", [(1024, 512)])):
            q, kc, vc, tb, _, _ = cs._case(rng, dev, b=len(spans), t=512, h=32, n_kv=8, hd=hd, ps=16, npp=128,
                                           dtype=cache, lengths=[s + n for s, n in spans], contiguous=True,
                                           q_dtype=torch.bfloat16)
            pos = torch.from_numpy(cs._spans(spans, 512)).to(dev)
            tb0 = tb[0].contiguous()
            records.append(compare(
                "paged_prefill", f"hd {hd} {name} {spans}", cache,
                lambda: pp.paged_prefill_attention(q, kc, vc, tb0, pos, scale=hd**-0.5),
                lambda: other_prefill(*other["paged_prefill"], q, kc, vc, tb0, pos, hd**-0.5),
                [(i, n) for i, (_, n) in enumerate(spans)], 20))
        h, r_kv, dr, r_width, dn = cs.MLA_GEOMS[cs.MLA_MODEL]
        scale = (dn + dr) ** -0.5
        for name, spans, t in (("decode 8 x 2048", [(2047, 1)] * 8, 1), ("chunk", [(1024, 512)], 512),
                               ("mixed step", cs.MIXED_SPANS, 512)):
            case = cs._mla_case(rng, dev, cs._spans(spans, t), h=h, r_kv=r_kv, dr=dr, r_width=r_width, ps=16,
                                npp=128, dtype=cache, q_dtype=torch.bfloat16)
            q_lat, q_rope, c, r, tb, posd = case
            tb0 = tb[0].contiguous()
            walk = pm.walk_facts(posd)
            records.append(compare(
                "paged_mla", f"{name} {spans[:3]}", cache,
                lambda: pm.paged_mla(q_lat, q_rope, c, r, tb0, posd, scale=scale, walk=walk),
                lambda: other_mla(*other["paged_mla"], q_lat, q_rope, c, r, tb0, posd, scale, walk),
                [(i, n) for i, (_, n) in enumerate(spans)], 50 if t == 1 else 20))
    return records


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--other", required=True, help="root of the other checkout")
    ap.add_argument("--kernels", nargs="+", default=["attention", "quant_matmul"],
                    choices=["attention", "quant_matmul"])
    args = ap.parse_args()
    sys.exit(main(args.other, args.kernels))
