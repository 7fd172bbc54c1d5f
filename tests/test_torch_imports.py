"""The PyTorch port stands alone: no jax, no JAX package, no pydantic."""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "tensorflow_nufft_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "tensorflow_nufft_tpu", "pydantic",
             "google.protobuf")


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _forbidden(name):
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


@pytest.mark.parametrize(
    "path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_no_jax(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path} imports {bad}"


def test_import_leaves_jax_unloaded():
    code = ("import sys, tensorflow_nufft_tpu_torch as t; "
            "import tensorflow_nufft_tpu_torch.kernels.xla_ops; "
            "import tensorflow_nufft_tpu_torch.fft.fft_ops; "
            "t.planar.PlannedNufft; t.planar.ToeplitzNormal; t.nufft; "
            "t.models.mri.SenseNufft; t.models.mri.cg_sense; "
            "import tensorflow_nufft_tpu_torch.ops.type3; "
            "t.Type3Plan; t.nufft_type3; t.nudft_type3; "
            "t.planar.Type3Plan; t.planar.nufft_type3; "
            "t.planar.nudft_type3; t.planar.BatchedPlannedNufft; "
            "t.PlannedNufft.batch_build; t.PlannedNufft.from_batch; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'tensorflow_nufft_tpu', 'pydantic')]; "
            "assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120,
                          check=False)
    assert proc.returncode == 0, proc.stderr
