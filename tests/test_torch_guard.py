"""Guards of the dynamo_tpu_torch package: it imports neither JAX, anything
of dynamo_tpu nor safetensors (it reads the format by hand), and its entry
points never fall back to the CPU quietly."""

import ast
import asyncio
import pathlib
import subprocess
import sys

import pytest
import torch

import dynamo_tpu_torch

PKG = pathlib.Path(dynamo_tpu_torch.__file__).resolve().parent

_IMPORT_ALL = """
import importlib, pathlib, sys
pkg = pathlib.Path(sys.argv[1])
names = sorted(
    "dynamo_tpu_torch." + ".".join(p.relative_to(pkg).with_suffix("").parts).removesuffix(".__init__")
    for p in pkg.rglob("*.py")
)
for name in names:
    importlib.import_module(name.removesuffix("."))
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "dynamo_tpu", "safetensors"))
print(len(names), bad)
"""


def test_package_imports_neither_jax_nor_dynamo_tpu():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL, str(PKG)], capture_output=True, text=True,
                         timeout=120, cwd=PKG.parent)
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.strip().split(" ", 1)
    assert int(count) >= 20  # every module of the package was imported
    assert bad == "[]"


def test_entry_points_default_to_the_card_and_refuse_without_one(monkeypatch):
    from dynamo_tpu_torch.engine.runner import TorchModelRunner
    from dynamo_tpu_torch.launch import build_engine_service
    from dynamo_tpu_torch.models.config import PRESETS

    from dynamo_tpu_torch.bridge import params_from_jax
    from dynamo_tpu_torch.models import llama

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        asyncio.run(build_engine_service("test-tiny"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchModelRunner(PRESETS["test-tiny"], {}, num_pages=4, page_size=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        llama.init_params(PRESETS["test-tiny"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        llama.init_kv_cache(PRESETS["test-tiny"], 4, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_jax({"embed": torch.zeros(2, 2).numpy()})


def test_runner_on_the_card_refuses_a_geometry_the_kernels_do_not_take(monkeypatch):
    """On the card every attention call runs in a kernel; a model outside
    their support (test-tiny: head_dim 16) is refused before anything is
    allocated, not served through the plain version."""
    from dynamo_tpu_torch.engine.runner import TorchModelRunner
    from dynamo_tpu_torch.models.config import PRESETS

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(NotImplementedError, match="head_dim=16"):
        TorchModelRunner(PRESETS["test-tiny"], {}, num_pages=4, page_size=4, device="cuda")


def test_serving_entry_points_default_to_the_card_and_refuse_without_one(monkeypatch, capsys):
    """run_local and the command line serve on the card unless asked for the
    CPU, and fail before anything is started without one."""
    from dynamo_tpu_torch import launch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        asyncio.run(launch.run_local("test-tiny", port=0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch.main(["--model", "test-tiny", "--http-port", "0"])
    with pytest.raises(SystemExit):  # a JAX launcher option the port does not take is refused, not ignored
        launch.main(["--model", "test-tiny", "--mesh", "auto", "--platform", "cpu"])
    assert "not supported by dynamo_tpu_torch yet: --mesh auto" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        launch.main(["--role", "frontend", "--platform", "cpu"])
    assert "--role" in capsys.readouterr().err


def test_quantized_and_gguf_entry_points_are_guarded_too(monkeypatch):
    """The modules of quantized serving and GGUF import are among those the
    import guard walks, and their entry points default to the card."""
    from dynamo_tpu_torch.launch import build_engine_service
    from dynamo_tpu_torch.models.config import PRESETS
    from dynamo_tpu_torch.models.gguf import load_gguf_params
    from dynamo_tpu_torch.models.quant import init_params_quantized

    files = {p.relative_to(PKG).as_posix() for p in PKG.rglob("*.py")}
    assert {"models/quant.py", "models/gguf.py", "ops/quant_matmul.py"} <= files
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params_quantized(PRESETS["test-tiny"], mode="int4")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_gguf_params("missing.gguf", PRESETS["test-tiny"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        asyncio.run(build_engine_service("test-tiny", quantize="int8"))


_IMPORT_HOST_ONLY = """
import importlib, sys
for name in sys.argv[1:]:
    importlib.import_module(name)
print(sorted({m.split(".")[0] for m in sys.modules} & {"jax", "dynamo_tpu", "torch"}))
"""


def test_constraint_and_tier_modules_are_host_code():
    """Constrained decoding and the KV tiers are among the modules the
    import guard walks, and import numpy and the standard library only:
    neither JAX nor anything of dynamo_tpu, nor torch (the runner does
    their device work)."""
    files = {p.relative_to(PKG).as_posix() for p in PKG.rglob("*.py")}
    mods = ["constrained", "blocks/__init__", "blocks/tier", "blocks/storage", "blocks/manager"]
    assert {m + ".py" for m in mods} <= files
    names = ["dynamo_tpu_torch." + m.replace("/", ".").removesuffix(".__init__") for m in mods]
    out = subprocess.run([sys.executable, "-c", _IMPORT_HOST_ONLY, *names], capture_output=True, text=True,
                         timeout=120, cwd=PKG.parent)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


_LAZY = """
import importlib, sys
importlib.import_module(sys.argv[1])
print(sorted(m for m in sys.modules if m.startswith("dynamo_tpu_torch.")))
"""


def test_slo_plane_and_flight_modules_are_host_code_imported_lazily():
    """The SLO plane, the planner's WorkerProfile and the flight recorder are
    among the modules the import guard walks and import neither JAX,
    anything of dynamo_tpu nor torch. They load where the JAX package loads
    its own: the engine core takes the flight recorder at import and the
    plane only when ``slo_sched`` builds it, the router its cost terms
    inside ``build_kv_router``, the plane its settings and the planner
    inside the calls that read them."""
    files = {p.relative_to(PKG).as_posix() for p in PKG.rglob("*.py")}
    mods = ["sched/__init__", "sched/admission", "sched/chunk_control", "sched/predictor", "sched/tenants",
            "planner/__init__", "planner/core", "observability/__init__", "observability/flight"]
    assert {m + ".py" for m in mods} <= files
    names = ["dynamo_tpu_torch." + m.replace("/", ".").removesuffix(".__init__") for m in mods]
    out = subprocess.run([sys.executable, "-c", _IMPORT_HOST_ONLY, *names], capture_output=True, text=True,
                         timeout=120, cwd=PKG.parent)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"

    def loaded(name):
        run = subprocess.run([sys.executable, "-c", _LAZY, name], capture_output=True, text=True, timeout=120,
                             cwd=PKG.parent)
        assert run.returncode == 0, run.stderr
        return set(ast.literal_eval(run.stdout))

    core = loaded("dynamo_tpu_torch.engine.core")
    assert "dynamo_tpu_torch.observability.flight" in core and not any(
        m.startswith(("dynamo_tpu_torch.sched", "dynamo_tpu_torch.planner")) for m in core)
    assert not any(m.startswith("dynamo_tpu_torch.sched") for m in loaded("dynamo_tpu_torch.router.router"))
    sched = loaded("dynamo_tpu_torch.sched")
    assert "dynamo_tpu_torch.config" not in sched and "dynamo_tpu_torch.planner" not in sched
