#!/usr/bin/env python3
"""quant_matmul's forms side by side on one card.

    python3 tools/quant_forms.py [--checks] [--m 8 64 512 2048] [--shapes 0 1 2]
                                 [--formats int8 int4] [--variants base ...]

Builds ``csrc/quant_matmul.cu`` (nvcc's register and spill report for each
instantiation is printed first). With ``--checks``, runs ``chip_smoke.py``'s
``kernels_quant`` checks (every QUANT_SHAPES leaf at every QUANT_M row count
through the wrapper, bf16 and f32 out, two launches bitwise, the identity
products bitwise). Then, for each of ``chip_smoke.py``'s QUANT_TIMED products
(``--shapes`` indexes them; 3 is llama-3-8b's head, 4 on ``--kn`` shapes),
int8 and int4, and each M of ``--m``, every form the kernel can run at that M
is launched through the C entry point with its own (form, param, splits):
the plan's first, then up to 16 rows the decode form at 1 to 8 K splits,
and the prefill form at 128 and 256 rows (``--plan-only``: the plan's
alone). Each is held against the plain version (``chip_smoke.REL_TOL`` per
row) and timed (``chip_smoke.time_ms``, the weights cycled through copies that
exceed the L2, as ``kernel_timing_quant`` times them); one JSON line each, the
plan's choice marked, beside cuBLAS on the weight dequantized to bf16
beforehand. ``--variants`` builds variants of the source (VARIANTS: text
substitutions, each compiled with the same flags into a library of its own)
and times each form in every variant in turns, on the same inputs. Ends with
the card's name and power limit. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import pathlib
import subprocess
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402  (shapes, leaves, tolerances and the timer live there)
from dynamo_tpu_torch.models.quant import maybe_dequant  # noqa: E402
from dynamo_tpu_torch.ops import build  # noqa: E402
from dynamo_tpu_torch.ops import quant_matmul as qmm  # noqa: E402


# Variants of csrc/quant_matmul.cu: name -> [(text, replacement), ...]
VARIANTS = {
    "base": [],
    # Diagnostic variants (wrong outputs): the decode form without its conversion and products, or without its
    # weight loads; the prefill form without its conversion (A from the raw words) or without its products.
    "decode_no_compute": [("for (int ks = 0; ks < kBK / 16; ++ks) {", "for (int ks = 0; ks < 0; ++ks) {")],
    "decode_no_tma": [("mbar_arrive_expect_tx(&full[s], wtx);", "mbar_arrive(&full[s]);\n        continue;")],
    # ... and without the products too, or without the conversion too (the raw words go to the products)
    "decode_no_tma_no_mma": [
        ("mbar_arrive_expect_tx(&full[s], wtx);", "mbar_arrive(&full[s]);\n        continue;"),
        ("for (int j = 0; j < 4; ++j) mma_bf16(acc[t][j], a[j], xf[t][0], xf[t][1]);",
         "for (int j = 0; j < 4; ++j) acc[t][j][0] += __uint_as_float((a[j][0] ^ a[j][1] ^ a[j][2] ^ a[j][3] ^ "
         "xf[t][0] ^ xf[t][1]) & 0x7fffff);")],
    "decode_no_tma_no_dq": [
        ("mbar_arrive_expect_tx(&full[s], wtx);", "mbar_arrive(&full[s]);\n        continue;"),
        ("a[j][q] = dq4(lo, hi, j, grp ? sc[1][set][j] : sc[0][set][j], grp ? bi[1][set][j] : bi[0][set][j],\n"
         "                            bias);", "a[j][q] = lo ^ (hi << j);"),
        ("for (int j = 0; j < 4; ++j) a[j][q] = pack_bf16(i8f(lo, j), i8f(hi, j));",
         "for (int j = 0; j < 4; ++j) a[j][q] = lo ^ (hi << j);")],
    "prefill_no_convert": [(f"a[ks][{r}] = {call};", f"a[ks][{r}] = {arg};") for r, call, arg in (
        (0, "i8_pair(h00, h01, 0)", "h00"), (1, "i8_pair(h00, h01, 1)", "h01"), (2, "i8_pair(h10, h11, 0)", "h10"),
        (3, "i8_pair(h10, h11, 1)", "h11"), (0, "dq4(lo0, hi0, 0, sg[gr][0], bg[gr][0], bias)", "lo0"),
        (1, "dq4(lo0, hi0, 1, sg[gr][1], bg[gr][1], bias)", "hi0"), (2, "dq4(lo1, hi1, 0, sg[gr][0], bg[gr][0], bias)",
                                                                     "lo1"),
        (3, "dq4(lo1, hi1, 1, sg[gr][1], bg[gr][1], bias)", "hi1"))],
    "prefill_no_wgmma": [("wgmma_m64n256k16_rs(acc, a[ks], db);", "(void)db;"),
                         ("wgmma_m64n128k16_rs(acc, a[ks], db);", "(void)db;")],
    # every mbarrier wait a polling loop (mbarrier.test_wait) instead of try_wait's potentially suspending one
    "poll_waits": [("mbar_wait(", "mbar_poll("), ("namespace {\n\nconstexpr int kBK", (
        "namespace {\n\n__device__ __forceinline__ void mbar_poll(uint64_t* bar, uint32_t parity) {\n"
        "  asm volatile(\"{\\n.reg .pred done;\\nPOLL:\\n\"\n"
        "               \"mbarrier.test_wait.parity.shared::cta.b64 done, [%0], %1;\\n\"\n"
        "               \"@!done bra POLL;\\n}\\n\" ::\"r\"(smem_u32(bar)), \"r\"(parity) : \"memory\");\n}\n\n"
        "constexpr int kBK"))],
    # Tuning variants: ring depths.
    "decode_int4_r4": [("R = MODE == kInt4 ? 6 : 4;  // ring stages", "R = MODE == kInt4 ? 4 : 4;  // ring stages")],
    "prefill_pending2": [("constexpr int kPending = 1;", "constexpr int kPending = 2;")],
    "prefill_r4": [("R = NX == 256 ? 5 : 8;", "R = NX == 256 ? 4 : 6;")],
    # the decode form walking one stage a block, or ending without the cluster merge (wrong outputs): its fixed costs
    "decode_one_stage": [("(int)((long long)(blockIdx.x + 1) * nk / S) - kb;",
                          "min(1, (int)((long long)(blockIdx.x + 1) * nk / S) - kb);")],
    "decode_no_merge": [("  if (S == 1) {\n    if (warp < kWarps) {", "  if (true) {\n    if (warp < kWarps) {")],
    # eight consumer warps a block, 512 columns (int8 only: an int4 scale row of 512 exceeds a TMA box)
    "decode_bn512": [("constexpr int kDecBN = 256;", "constexpr int kDecBN = 512;")],
    # clusters of up to 16 K splits (non-portable) for the decode form
    "decode_cluster16": [
        ("constexpr int kMaxSplits = 8;", "constexpr int kMaxSplits = 16;"),
        ("  cudaError_t e = allow_smem(kern, cfg.dynamicSmemBytes, allowed);\n  if (e != cudaSuccess) return e;\n",
         "  cudaError_t e = allow_smem(kern, cfg.dynamicSmemBytes, allowed);\n  if (e != cudaSuccess) return e;\n"
         "  e = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);\n"
         "  if (e != cudaSuccess) return e;\n")],
    "decode_deep": [("R = MODE == kInt4 ? 6 : 4;  // ring stages", "R = MODE == kInt4 ? 10 : 6;  // ring stages")],
}


# Variants whose outputs are wrong by design: timed, not compared.
DIAGNOSTIC = {"decode_no_compute", "decode_no_tma", "decode_no_tma_no_mma", "decode_no_tma_no_dq", "prefill_no_convert",
              "prefill_no_wgmma", "decode_one_stage", "decode_no_merge"}


def build_variants(names) -> dict:
    """{name: C entry point} of each variant, compiled in parallel."""
    src = (build.SRC_DIR / "quant_matmul.cu").read_text()
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="quant_forms_"))
    for h in build.SRC_DIR.glob("*.cuh"):
        (tmp / h.name).write_text(h.read_text())
    procs = {}
    for name in names:
        text = src
        for old, new in VARIANTS[name]:
            if old not in text:
                raise ValueError(f"variant {name}: {old!r} not in the source")
            text = text.replace(old, new)
        (tmp / f"{name}.cu").write_text(text)
        lib = tmp / f"lib{name}.so"
        procs[name] = (subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(tmp / f"{name}.cu")],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    fns = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name}: nvcc exit {proc.returncode}:\n{log[-3000:]}")
        spills = {cs._short(f): r for f, r in cs.ptxas_functions(log).items() if r["spill_stores"]}
        print(json.dumps({"variant": name, "spills": spills}), flush=True)
        fn_name, argtypes = build.SIGNATURES["quant_matmul"]
        fn = getattr(ctypes.CDLL(str(lib)), fn_name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[name] = fn
    return fns


def launch(x: torch.Tensor, leaf: dict, form: int, param: int, splits: int, fn=None) -> torch.Tensor:
    """One launch of the kernel (or a variant's entry point ``fn``) with an
    explicit (form, param, splits)."""
    mode = 1 if "qw4" in leaf else 0
    qw, scale, qbias = leaf["qw4" if mode else "qw"], leaf["scale"], leaf.get("qbias")
    m, k = x.shape
    n = qw.shape[1]
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    err = (fn or build.load("quant_matmul"))(
        x.data_ptr(), qw.data_ptr(), scale.data_ptr(), qbias.data_ptr() if qbias is not None else None,
        out.data_ptr(), m, n, k, mode, qmm.group_size(leaf), build.DTYPE_CODES[scale.dtype],
        build.DTYPE_CODES[torch.bfloat16], form, param, splits, build.stream_of(x))
    build.check_launch(f"quant_matmul form {form} param {param} splits {splits}", err)
    return out


def forms_at(m: int, n: int, k: int, sms: int, splits=()) -> list[tuple[int, int, int]]:
    """Every (form, param, splits) the kernel runs at these shapes, the plan's
    first (``splits``: the decode form at these split counts alone)."""
    chosen = qmm.plan(m, n, k, sms)
    out = [chosen]
    max_splits = min(qmm.MAX_SPLITS, k // qmm.BLOCK_K)
    if m <= qmm.DECODE_MAX_M:
        mt = next(t for t in qmm.DECODE_TILES if m <= 8 * t)
        out += [(qmm.FORM_DECODE, mt, s) for s in (splits or range(1, qmm.MAX_SPLITS + 1))
                if s <= (k // qmm.BLOCK_K if splits else max_splits)]
    out += [(qmm.FORM_PREFILL, nx, 1) for nx in qmm.PREFILL_BLOCK_M]
    return list(dict.fromkeys(out))


def main(args) -> int:
    if not torch.cuda.is_available():
        print("quant_forms: no CUDA device available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    built = build.build(("quant_matmul",))
    for fn, rs in sorted(cs.ptxas_functions(built["ptxas"].get("quant_matmul", "")).items()):
        print(json.dumps({"instantiation": cs._short(fn), **rs}), flush=True)
    if args.checks:
        cs.quant_kernel_checks(dev)
    fns = build_variants(args.variants) if args.variants != ["base"] else {"base": None}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(13)
    for fmt in args.formats:
        for si in args.shapes:
            name, k, n = (cs.QUANT_TIMED + [("llama-3-8b lm_head", 4096, cs.QUANT_HEAD_N)] + [
                (f"{k_} x {n_}", k_, n_) for k_, n_ in args.kn])[si]
            leaf = cs.quant_leaf(dev, gen, k, n, fmt)
            nbytes = sum(t.numel() * t.element_size() for t in leaf.values())
            copies = [leaf] + [{key: t.clone() for key, t in leaf.items()}
                               for _ in range(-(-4 * cs.L2_BYTES // nbytes) - 1)]
            w16 = maybe_dequant(leaf, torch.bfloat16)
            for m in args.m:
                x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
                want = qmm.quant_matmul_plain(x, leaf)
                bound, by = cs.quant_bound(m, k, n, leaf)
                lib = cs.time_ms(lambda: torch.matmul(x, w16), iters=4)
                for form, param, splits in forms_at(m, n, k, sms, args.splits)[:1 if args.plan_only else None]:
                    if args.forms and ("decode", "prefill")[form] not in args.forms:
                        continue
                    order = list(fns) + list(fns)[::-1]  # in turns: a b c c b a
                    rec = {"format": fmt, "shape": name, "m": m, "form": ("decode", "prefill")[form], "param": param,
                           "splits": splits,
                           "plan": (form, param, splits) == qmm.plan(m, n, k, sms, fmt)}
                    live = dict(fns)  # the variants that launch at this form (a variant may refuse it)
                    for v, fn in fns.items():
                        try:
                            got = launch(x, leaf, form, param, splits, fn)
                            rec.setdefault("max_abs_err", {})[v] = cs.compare_rows(
                                f"{v} {fmt} {name} M={m} {rec}", got, want) if v not in DIAGNOSTIC else None
                            rec.setdefault("bitwise_twice", {})[v] = bool(
                                torch.equal(got, launch(x, leaf, form, param, splits, fn)))
                        except (AssertionError, RuntimeError) as exc:
                            rec.setdefault("error", {})[v] = str(exc)[:300]
                            del live[v]
                    times = {v: [] for v in live}
                    for v in [v for v in order if v in live]:
                        fn = fns[v]
                        times[v].append(cs.time_ms(lambda: [launch(x, c, form, param, splits, fn) for c in copies],
                                                   iters=2) / len(copies))
                    if live:
                        rec["ms"] = {v: sum(t) / len(t) for v, t in times.items()}
                        rec.update(bound_ms=bound, bound_by=by, cublas_ms=lib,
                                   of_bound={v: bound / t for v, t in rec["ms"].items()},
                                   vs_cublas={v: t / lib for v, t in rec["ms"].items()})
                    print(json.dumps(rec), flush=True)
            del copies, leaf, w16
            torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--checks", action="store_true", help="run chip_smoke.py's kernels_quant checks first")
    ap.add_argument("--m", type=int, nargs="+", default=[8, 64, 65, 512, 2048])
    ap.add_argument("--shapes", type=int, nargs="+", default=[0, 1, 2],
                    help="indexes into QUANT_TIMED, then 3: llama-3-8b's head")
    ap.add_argument("--formats", nargs="+", default=["int8", "int4"])
    ap.add_argument("--kn", type=int, nargs=2, action="append", default=[],
                    help="another (K, N) product, indexed after the head")
    ap.add_argument("--forms", nargs="*", default=[], help="decode and/or prefill (default: both)")
    ap.add_argument("--variants", nargs="+", default=["base"], help=f"of {sorted(VARIANTS)}")
    ap.add_argument("--plan-only", action="store_true", help="time the plan's form alone")
    ap.add_argument("--splits", type=int, nargs="*", default=[], help="the decode form at these K splits alone")
    sys.exit(main(ap.parse_args()))
