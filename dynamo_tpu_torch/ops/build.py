"""Build the port's CUDA kernels at first use and bind them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface (seconds per file, where a source that
includes PyTorch's headers takes minutes). Libraries land in ``_build/``
beside the package (listed in ``.gitignore``), named by a digest of the
sources and flags so a changed source rebuilds and an unchanged one is
reused. :func:`build` compiles every missing library at once, one ``nvcc``
process per source, all started together.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v",
    # Optimise a source's kernels in parallel threads: paged_mla.cu's nine
    # instantiations are the build's long pole, and the build counts against
    # chip_smoke.py's time.
    "--split-compile=0",
)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry point and argument types of each kernel library.
SIGNATURES: dict[str, tuple[str, list]] = {
    "paged_decode": (
        "dyn_paged_decode",
        [_P] * 6 + [_I] * 12 + [_F, _P],
    ),
    "paged_prefill": (
        "dyn_paged_prefill",
        [_P] * 6 + [_I] * 10 + [_F, _P],
    ),
    "paged_mla": (
        "dyn_paged_mla",
        [_P] * 9 + [_I] * 14 + [_F, _P],
    ),
    "quant_matmul": (
        "dyn_quant_matmul",
        [_P] * 5 + [_I] * 10 + [_P],
    ),
    "grouped_matmul": (
        "dyn_grouped_matmul",
        [_P] * 4 + [_I] * 4 + [_P],
    ),
    # The fp8 kernels' on-chip e4m3 -> bf16 conversion alone, for checks.
    "fp8_convert": (
        "dyn_fp8_to_bf16",
        [_P, _P, _I, _P],
    ),
}

_lock = threading.Lock()
_fns: dict[str, object] = {}  # name -> bound C entry point


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the port's kernels")


def _target(name: str) -> Path:
    """The library path of ``name``: a digest of its source, every shared
    header in ``csrc/`` and the flags."""
    h = hashlib.sha256()
    for src in (SRC_DIR / f"{name}.cu", *sorted(SRC_DIR.glob("*.cuh"))):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=tuple(SIGNATURES)) -> dict:
    """Compile every library of ``names`` not yet built, in parallel.

    Returns ``{"seconds": wall time, "ptxas": {name: nvcc's register and
    shared-memory report}}``; raises RuntimeError with the compiler output
    when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in names:
        target = _target(name)
        if target.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        procs[name] = (proc, tmp, target)
    logs = {}
    failed = []
    for name, (proc, tmp, target) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode == 0:
            os.replace(tmp, target)
        else:
            os.unlink(tmp)
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{out}")
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return {"seconds": time.perf_counter() - t0, "ptxas": logs}


def load(name: str):
    """The C entry point of kernel library ``name``, building it if needed;
    bound once, then returned from a table (every launch asks for it)."""
    fn = _fns.get(name)
    if fn is not None:
        return fn
    with _lock:
        fn = _fns.get(name)
        if fn is None:
            target = _target(name)
            if not target.exists():
                build((name,))
            fn_name, argtypes = SIGNATURES[name]
            fn = getattr(ctypes.CDLL(str(target)), fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _fns[name] = fn
    return fn


def stream_of(t: torch.Tensor) -> int:
    """Handle of PyTorch's current stream on ``t``'s device (kernels launch there)."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check_launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


# Launch counting. Each wrapper counts its launches in its module's
# ``launches`` / ``launches_fp8``. A launch recorded into a CUDA graph runs
# at each replay instead: while this thread captures, it is tallied apart
# (``capture_launches``) and the runner adds the tally at every replay
# (``add_launches``).
_capturing = threading.local()


def count_launch(module_globals: dict, counter: str) -> None:
    """One launch of the kernel whose wrapper lives in ``module_globals``."""
    tally = getattr(_capturing, "tally", None)
    if tally is None:
        module_globals[counter] += 1
    else:
        key = (module_globals["__name__"], counter)
        tally[key] = tally.get(key, 0) + 1


@contextlib.contextmanager
def capture_launches():
    """Tally this thread's launches apart for as long as the context lasts
    (a graph capture, which records them but runs none); yields the tally
    ``{(module, counter): launches}``."""
    prev = getattr(_capturing, "tally", None)
    _capturing.tally = tally = {}
    try:
        yield tally
    finally:
        _capturing.tally = prev


def add_launches(tally: dict) -> None:
    """Count the launches of one replay of a graph whose capture tallied ``tally``."""
    for (module, counter), n in tally.items():
        mod = sys.modules[module]
        setattr(mod, counter, getattr(mod, counter) + n)


def check_paged_args(q, k_cache, v_cache, block_tables, positions) -> None:
    """Raise ValueError unless the arguments have the layout the CUDA kernels
    read: one device, contiguous, ``q [B, T, H, hd]``, equal caches
    ``[P, ps, W]``, int32 ``block_tables [B, N]`` and ``positions [B, T]``."""
    for name, x in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("block_tables", block_tables), ("positions", positions)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dim() != 4 or k_cache.dim() != 3 or k_cache.shape != v_cache.shape or k_cache.dtype != v_cache.dtype:
        raise ValueError(f"bad shapes: q {tuple(q.shape)}, k {tuple(k_cache.shape)}, v {tuple(v_cache.shape)}")
    if block_tables.dtype != torch.int32 or positions.dtype != torch.int32:
        raise ValueError("block_tables and positions must be int32")
    b, t = q.shape[:2]
    if block_tables.dim() != 2 or block_tables.shape[0] != b or tuple(positions.shape) != (b, t):
        raise ValueError(f"bad table/position shapes {tuple(block_tables.shape)} / {tuple(positions.shape)}")
