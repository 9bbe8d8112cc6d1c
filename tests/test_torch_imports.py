"""The port stands alone: no file of ``rte_rrtmgp_torch`` (nor
``chip_smoke.py``) imports JAX, the JAX package or the repository's root
``tools/`` (the JAX package's drivers), and the package imports
on CPU-only PyTorch without ``nvcc`` or ``triton`` (kernels build lazily,
inside the first CUDA call)."""

import ast
import os
import subprocess
import sys

import jax  # noqa: F401  (both frameworks load in every port test file)
import pytest
import torch  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "rte_rrtmgp_tpu", "tools")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "rte_rrtmgp_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_modules(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", "")
              in ("__import__",) and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_import(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_package_imports_without_jax_nvcc_or_triton():
    code = (
        "import sys, importlib, pkgutil\n"
        "import rte_rrtmgp_torch\n"
        "for m in pkgutil.walk_packages(rte_rrtmgp_torch.__path__, 'rte_rrtmgp_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from rte_rrtmgp_torch.ops.kernels import _build\n"
        "assert _build._state['lib'] is None and _build._state['info'] is None\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'rte_rrtmgp_tpu', 'triton'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PATH"] = os.path.dirname(sys.executable)   # no nvcc on the path
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def test_camera_modules_are_checked():
    """The camera tracer, its solver, CLI, tools and tuner are among the
    files held to no JAX import above."""
    names = {os.path.relpath(p, ROOT) for p in _port_files()}
    for mod in ("models/raytracer_bw.py", "models/radiation_bw.py",
                "cli_bw.py", "tools/set_virtual_camera.py",
                "tools/image_from_xyz.py", "tools/box_cloud.py",
                "tools/bench_bw.py", "tuning/tune_bw.py"):
        assert "rte_rrtmgp_torch/" + mod in names, mod


def test_parallel_modules_are_checked():
    """The sharding layer and the multi-process tool are among the files
    held to no JAX import above."""
    names = {os.path.relpath(p, ROOT) for p in _port_files()}
    for mod in ("parallel/__init__.py", "parallel/mesh.py",
                "parallel/sharded.py", "parallel/distributed.py",
                "tools/multihost_smoke.py"):
        assert "rte_rrtmgp_torch/" + mod in names, mod


def test_tool_modules_are_checked():
    """The tools around the main path and the goldens generator are among
    the files held to no JAX and no root-``tools`` import above."""
    names = {os.path.relpath(p, ROOT) for p in _port_files()}
    for mod in ("profile_stages", "ablate", "crosscheck", "bench_rt_solve",
                "scaling_bench", "plot_fluxes", "make_goldens"):
        assert f"rte_rrtmgp_torch/tools/{mod}.py" in names, mod
