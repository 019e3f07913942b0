"""The port stands alone: no module of ``repro_torch``, no file of the
port's ``examples_torch/`` and ``benchmarks_torch/``, and not the root
``chip_smoke.py``, imports JAX or the JAX package ``repro``."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted(
    path for d in ("src/repro_torch", "examples_torch", "benchmarks_torch")
    for path in (ROOT / d).rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    for name in _imported_modules(path):
        top = name.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name} imports {name}"


def _port_modules():
    return sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
        .removesuffix(".__init__")
        for p in (ROOT / "src" / "repro_torch").rglob("*.py"))


def test_port_modules_include_the_experiments_engine():
    modules = _port_modules()
    for name in ("repro_torch._lru", "repro_torch.experiments",
                 "repro_torch.experiments.axes",
                 "repro_torch.experiments.engine",
                 "repro_torch.experiments.results",
                 "repro_torch.experiments.scenario",
                 "repro_torch.experiments.study",
                 "repro_torch.core.faults", "repro_torch.checkpoint",
                 "repro_torch.checkpoint.checkpoint",
                 "repro_torch.experiments.manifest", "repro_torch.serve",
                 "repro_torch.serve.cache", "repro_torch.serve.service",
                 "repro_torch.launch.serve", "repro_torch.launch.train",
                 "repro_torch.launch.steps", "repro_torch.data.loader",
                 "repro_torch.data.partition", "repro_torch.core.trainer",
                 "repro_torch.models.transformer",
                 "repro_torch.models.moe", "repro_torch.configs.minitron_4b",
                 "repro_torch.configs.deepseek_coder_33b",
                 "repro_torch.configs.command_r_35b",
                 "repro_torch.configs.phi35_moe_42b",
                 "repro_torch.configs.llama4_scout_17b",
                 "repro_torch._env", "repro_torch.experiments.placement",
                 "repro_torch.launch.distributed", "repro_torch.launch.mesh"):
        assert name in modules
    scripts = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    assert {"examples_torch/quickstart.py", "examples_torch/paper_cifar.py",
            "benchmarks_torch/theory.py", "examples_torch/serve_batch.py",
            "benchmarks_torch/serve_bench.py",
            "examples_torch/train_lm.py"} <= scripts


def test_port_imports_with_jax_blocked():
    """Every module of the port, and the port's examples and benches,
    import with ``jax`` and ``repro`` made unimportable."""
    modules = _port_modules()
    scripts = [str(p) for d in ("examples_torch", "benchmarks_torch")
               for p in sorted((ROOT / d).glob("*.py"))]
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[m] = None\n"
            "import importlib\n"
            f"for m in {modules!r}:\n"
            "    importlib.import_module(m)\n"
            "import importlib.util\n"
            f"for i, path in enumerate({scripts!r}):\n"
            "    spec = importlib.util.spec_from_file_location(f'script{i}', path)\n"
            "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
