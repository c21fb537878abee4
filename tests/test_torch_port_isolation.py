"""The PyTorch port stands alone: ``hydragnn_tpu_torch`` and ``chip_smoke.py``
import nothing of JAX or of the JAX package, nor ``msgpack`` or ``sklearn``
(the card's machine has neither), and ``chip_smoke.py`` refuses to run
without a CUDA device instead of falling back to the CPU."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "hydragnn_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "msgpack", "sklearn", "hydragnn_tpu"}


def _sources():
    return sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module.split(".")[0]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def pytest_no_forbidden_imports(path):
    bad = [(line, mod) for line, mod in _imported_roots(path) if mod in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def pytest_package_imports_with_jax_blocked():
    """Every module of the port imports in a fresh interpreter in which
    ``jax``, ``flax``, ``msgpack``, ``sklearn`` and ``hydragnn_tpu`` cannot
    be imported; the walk reaches every sub-package, ``train`` included."""
    code = (
        "import sys, importlib, pkgutil\n"
        "for m in %r:\n"
        "    sys.modules[m] = None\n"
        "import hydragnn_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert 'jax' not in {k for k, v in sys.modules.items() if v is not None}\n"
        "print(' '.join(names))\n"
    ) % (tuple(sorted(FORBIDDEN)),)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=240,
        env={**os.environ, "PYTHONPATH": str(ROOT)},
    )
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.strip().splitlines()[-1].split())
    on_disk = {
        "hydragnn_tpu_torch." + ".".join(p.relative_to(PACKAGE).with_suffix("").parts)
        for p in PACKAGE.rglob("*.py")
        if p.name != "__init__.py"
    }
    assert on_disk <= names, sorted(on_disk - names)
    assert {"hydragnn_tpu_torch.train.trainer", "hydragnn_tpu_torch.train.train_validate_test",
            "hydragnn_tpu_torch.utils.optimizer", "hydragnn_tpu_torch.preprocess.dataloader",
            "hydragnn_tpu_torch.ops.segment_sum_count", "hydragnn_tpu_torch.models.convs",
            "hydragnn_tpu_torch.models.base", "hydragnn_tpu_torch.models.layers"} <= names


@pytest.mark.parametrize("where", ["repo", "alone"])
def pytest_chip_smoke_fails_without_a_card(tmp_path, where):
    """Without a CUDA device (here), or run from a directory that holds only
    the script, chip_smoke.py exits non-zero and prints no result line."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    if where == "alone":
        shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    else:
        cwd = ROOT
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True, text=True,
        timeout=240, env=env,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "CUDA" in out.stderr
