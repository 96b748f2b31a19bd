"""The port stands alone: no module of ``repro_torch`` (and not
``chip_smoke.py``) brings in JAX or the reference package, and no entry
point quietly runs on the CPU when no card is present."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import DeviceEngine, cholesky, resolve_device
from repro_torch.sparse import laplacian_2d

ROOT = Path(__file__).resolve().parents[1]

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(" ".join(names), "|", bad)
assert not bad, bad
"""


def test_port_imports_neither_jax_nor_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    names, bad = out.stdout.split("|", 1)
    names = set(names.split())
    assert len(names) >= 15 and bad.strip() == "[]"
    # the server, the fault injectors and the static analysis too, its
    # kernel pass and CLI, the LM stack's models and configs, and its
    # optimizer, data stream, checkpoints and training loop, the mesh
    # construction and placements, and the dry-run tooling
    assert {"repro_torch.faults", "repro_torch.launch.serve",
            "repro_torch.analyze.plan_lint", "repro_torch.analyze.hazards",
            "repro_torch.analyze.cache_check",
            "repro_torch.analyze.kernel_check",
            "repro_torch.analyze.__main__", "repro_torch.device",
            "repro_torch.models.common", "repro_torch.models.attention",
            "repro_torch.models.moe", "repro_torch.models.ssm",
            "repro_torch.models.model", "repro_torch.models.convert",
            "repro_torch.configs.registry",
            # the training path
            "repro_torch.optim.adamw", "repro_torch.data.pipeline",
            "repro_torch.ckpt.checkpoint", "repro_torch.launch.train",
            # the mesh path
            "repro_torch.launch.mesh", "repro_torch.launch.steps",
            # the dry-run tooling
            "repro_torch.launch.hlo_analysis", "repro_torch.launch.roofline",
            "repro_torch.launch.dryrun", "repro_torch.launch.perf"} <= names
    assert {f"repro_torch.configs.{m}" for m in (
        "llama3_2_1b", "mamba2_1_3b", "deepseek_v3_671b",
        "jamba_1_5_large_398b", "dbrx_132b", "granite_20b", "yi_6b",
        "yi_9b", "llava_next_34b", "musicgen_large")} <= names


def test_port_examples_import_neither_jax_nor_repro():
    for name in ("torch_quickstart.py", "torch_pde_solve.py",
                 "torch_train_lm.py"):
        tree = ast.parse((ROOT / "examples" / name).read_text())
        mods = {m for node in ast.walk(tree)
                for m in ([a.name for a in node.names]
                          if isinstance(node, ast.Import) else
                          [node.module] if isinstance(node, ast.ImportFrom)
                          else [])}
        assert mods and not {m for m in mods
                             if m.split(".")[0] in ("jax", "repro")}, name


def test_chip_smoke_imports_neither_jax_nor_repro():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            mods.add(node.module)
    assert mods, "no imports found"
    assert not {m for m in mods if m.split(".")[0] in ("jax", "repro")}


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_a_card(no_card):
    A = laplacian_2d(6)
    with pytest.raises(RuntimeError, match="CUDA"):
        cholesky(A)
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceEngine()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    from repro_torch.ckpt import restore_checkpoint
    from repro_torch.launch.train import train
    from repro_torch.models import init_params
    from repro_torch.configs import get_smoke_config

    with pytest.raises(RuntimeError, match="CUDA"):
        train(steps=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(get_smoke_config("llama3.2-1b"))
    with pytest.raises(RuntimeError, match="CUDA"):
        restore_checkpoint("unused", 0, {})
    # asked for explicitly, the CPU runs
    F = cholesky(A, device="cpu")
    x = F.solve(np.ones(A.shape[0]), backend="device")
    assert np.linalg.norm(A @ x - 1.0) < 1e-12 * np.sqrt(A.shape[0])


def test_unported_routes_raise_not_implemented(tmp_path):
    # the guard, the plan cache and the plan lint run now
    # (tests/test_torch_guard.py, tests/test_torch_many.py,
    # tests/test_torch_analyze.py): what is left are the reference's own
    # errors
    from repro_torch.core import CachedPlan, PlanCache

    A = laplacian_2d(6)
    with pytest.raises(ValueError, match="perturb"):
        cholesky(A, device="cpu", schedule="seq", guard="perturb")
    with pytest.raises(ValueError, match="unknown guard"):
        cholesky(A, device="cpu", guard="xx")
    with pytest.raises(ValueError):
        cholesky(A, device="cpu", method="xx")
    plan = PlanCache().get(A)
    path = plan.save(tmp_path)
    assert CachedPlan.load(path, lint=True).key == plan.key
