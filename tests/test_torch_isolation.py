"""The port stands alone: nothing under ``src/repro_torch/`` nor ``chip_smoke.py``
imports ``jax`` or the reference package ``repro``, and importing the port's
modules loads no jax."""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def _imports(path: pathlib.Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
    return names


def test_port_files_exist():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    assert "chip_smoke.py" in names
    assert "src/repro_torch/models/model.py" in names
    assert "src/repro_torch/launch/serve.py" in names
    assert "src/repro_torch/launch/train.py" in names
    assert "src/repro_torch/optim/__init__.py" in names
    assert "src/repro_torch/core/api.py" in names
    assert "src/repro_torch/kernels/codegen.py" in names
    assert "src/repro_torch/launch/myia_step.py" in names
    for module in ("core/torch_backend.py", "obs/metrics.py", "obs/profile.py",
                   "obs/explain.py", "serve/__init__.py", "serve/model.py", "serve/faults.py",
                   "serve/engine.py", "core/oo_tape.py", "core/spmd.py", "parallel/__init__.py",
                   "launch/mesh.py", "configs/base.py", "distributed/sharding.py",
                   "distributed/collectives.py", "launch/dryrun.py", "models/boundary.py"):
        assert f"src/repro_torch/{module}" in names, module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_forbidden_names():
    assert _forbidden("jax.numpy") and _forbidden("repro.models") and _forbidden("repro")
    assert not _forbidden("repro_torch.models") and not _forbidden("torch")


def _top_level_imports(path: pathlib.Path) -> list[str]:
    names = []
    for node in ast.parse(path.read_text(), filename=str(path)).body:
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
    return names


@pytest.mark.parametrize(
    "path", [p for p in PORT_FILES if "repro_torch" in p.parts],
    ids=lambda p: p.relative_to(ROOT).as_posix(),
)
def test_no_module_level_triton_import(path):
    """Triton is imported only inside the function that builds a kernel: the
    port must import where there is no triton."""
    bad = [m for m in _top_level_imports(path) if m.split(".")[0] == "triton"]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad} at module level"


def test_importing_the_myia_core_loads_no_jax_or_triton():
    code = (
        "import sys\n"
        "import repro_torch.core, repro_torch.kernels.codegen, repro_torch.kernels.k1_cases\n"
        "import repro_torch.launch.myia_step, repro_torch.launch.profile_myia\n"
        "import repro_torch.obs\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro', 'triton'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code],
        cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
        capture_output=True,
        text=True,
        timeout=240,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.configs, repro_torch.models, repro_torch.kernels\n"
        "import repro_torch.models.convert, repro_torch.launch.serve\n"
        "import repro_torch.kernels.build, repro_torch.kernels.ops, repro_torch.kernels.ssd_scan\n"
        "import repro_torch.configs.mamba2_370m\n"
        "import repro_torch.tree, repro_torch.optim, repro_torch.data, repro_torch.checkpoint\n"
        "import repro_torch.runtime, repro_torch.distributed, repro_torch.launch.train\n"
        "import repro_torch.launch.profile_train, repro_torch.launch.profile_serve\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code],
        cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
        capture_output=True,
        text=True,
        timeout=240,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_importing_the_serving_runtime_loads_no_jax_or_triton():
    """The serving runtime and the observability tier (program cache, metrics,
    profiler, explain, engine) import neither jax, the reference, nor triton."""
    code = (
        "import sys\n"
        "import repro_torch.serve, repro_torch.serve.engine, repro_torch.serve.faults\n"
        "import repro_torch.obs.metrics, repro_torch.obs.profile, repro_torch.obs.explain\n"
        "import repro_torch.core.torch_backend, repro_torch.launch.serve\n"
        "import repro_torch.launch.profile_serve_myia\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro', 'triton'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code],
        cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
        capture_output=True,
        text=True,
        timeout=240,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_importing_the_spmd_tier_loads_no_jax_or_triton():
    """The OO tape, the SPMD tier and the mesh layer import neither jax, the
    reference, nor triton."""
    code = (
        "import sys\n"
        "import repro_torch.core, repro_torch.core.oo_tape, repro_torch.core.spmd\n"
        "import repro_torch.parallel, repro_torch.launch.mesh\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro', 'triton'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code],
        cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
        capture_output=True,
        text=True,
        timeout=240,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
