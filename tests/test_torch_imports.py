"""The PyTorch port stands alone: no jax, no JAX package, no pydantic;
and its sub-packages export the JAX sub-packages' public names."""

import ast
import importlib
import inspect
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

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
            "t.ops.nufft; t.plan.kernel_beta; t.kernels.spread_xla; "
            "t.fft.deconvolve; t.utils.complex_dtype; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'tensorflow_nufft_tpu', 'pydantic')]; "
            "assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120,
                          check=False)
    assert proc.returncode == 0, proc.stderr


JAX = ROOT / "tensorflow_nufft_tpu"
SUBPACKAGES = ("ops", "plan", "kernels", "fft", "utils")


def _jax_exports(sub):
    """{name: module file that defines it} of the JAX sub-package's
    ``__all__``, read from its ``__init__.py`` by ``ast`` (no jax loads)."""
    tree = ast.parse((JAX / sub / "__init__.py").read_text())
    names, source = None, {}
    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            path = ROOT.joinpath(*node.module.split(".")).with_suffix(".py")
            source.update({a.name: path for a in node.names})
        elif (isinstance(node, ast.Assign)
              and node.targets[0].id == "__all__"):
            names = ast.literal_eval(node.value)
    assert names, f"no __all__ in the JAX {sub}/__init__.py"
    return {name: source[name] for name in names}


def _jax_params(path, name):
    """Parameter names of the top-level ``def name`` in ``path``, or None
    where ``name`` is no function there."""
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.FunctionDef) and node.name == name:
            a = node.args
            return [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
    return None


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_subpackage_exports_the_jax_names(sub):
    port = importlib.import_module(f"tensorflow_nufft_tpu_torch.{sub}")
    missing = [n for n in _jax_exports(sub) if n not in port.__all__]
    assert not missing, f"tnt.{sub}.__all__ lacks {missing}"
    unresolved = [n for n in port.__all__ if not hasattr(port, n)]
    assert not unresolved, f"tnt.{sub} does not resolve {unresolved}"


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_exported_functions_keep_the_jax_parameters(sub):
    """The JAX parameter names, in their order, lead the port function's;
    a parameter the port adds after them (``device``) has a default."""
    port = importlib.import_module(f"tensorflow_nufft_tpu_torch.{sub}")
    checked = 0
    for name, path in _jax_exports(sub).items():
        want = _jax_params(path, name)
        if want is None:
            continue
        params = list(inspect.signature(getattr(port, name)).parameters
                      .values())
        assert [p.name for p in params[:len(want)]] == want, name
        extra = [p.name for p in params[len(want):]
                 if p.default is inspect.Parameter.empty]
        assert not extra, f"{name}: added parameters without a default"
        checked += 1
    assert checked


def test_plan_constants_match_jax():
    from tensorflow_nufft_tpu_torch import plan
    tree = ast.parse((JAX / "plan" / "plan.py").read_text())
    consts = {node.targets[0].id: node.value for node in tree.body
              if isinstance(node, ast.Assign)
              and isinstance(node.targets[0], ast.Name)}
    assert plan.MAX_KERNEL_WIDTH == ast.literal_eval(
        consts["MAX_KERNEL_WIDTH"])
    # {np.dtype(np.float32): 6e-08, ...}: the keys are calls, the values
    # literals.
    want = [ast.literal_eval(v) for v in consts["EPSILON"].values]
    assert list(plan.EPSILON.values()) == want
    assert [np.dtype(k) for k in plan.EPSILON] == [np.float32, np.float64]


_DTYPES = [(torch.float32, np.float32), (torch.float64, np.float64),
           (torch.complex64, np.complex64), (torch.complex128, np.complex128)]


@pytest.mark.parametrize("torch_dtype,np_dtype", _DTYPES,
                         ids=lambda d: str(d))
def test_dtype_helpers_match_jax(torch_dtype, np_dtype):
    from tensorflow_nufft_tpu.utils import dtypes as jax_dtypes
    from tensorflow_nufft_tpu_torch.utils import (complex_dtype,
                                                  is_complex_dtype,
                                                  real_dtype)
    to_np = {t: np.dtype(n) for t, n in _DTYPES}
    assert is_complex_dtype(torch_dtype) == jax_dtypes.is_complex_dtype(
        np_dtype)
    assert to_np[complex_dtype(torch_dtype)] == jax_dtypes.complex_dtype(
        np_dtype)
    assert to_np[real_dtype(torch_dtype)] == jax_dtypes.real_dtype(np_dtype)


def test_dtype_helpers_reject_what_jax_rejects():
    from tensorflow_nufft_tpu.utils import dtypes as jax_dtypes
    from tensorflow_nufft_tpu_torch.utils import (complex_dtype,
                                                  is_complex_dtype,
                                                  real_dtype)
    assert is_complex_dtype(torch.int32) == jax_dtypes.is_complex_dtype(
        np.int32)
    for port_fn, jax_fn in ((complex_dtype, jax_dtypes.complex_dtype),
                            (real_dtype, jax_dtypes.real_dtype)):
        with pytest.raises(TypeError):
            jax_fn(np.int32)
        with pytest.raises(TypeError, match="Expected a complex or float"):
            port_fn(torch.int32)
