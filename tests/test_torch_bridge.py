"""The port's weight bridge and its import hygiene.

* numpy leaves of a JAX parameter tree (fp32 and ml_dtypes bf16) become
  tensors bit for bit;
* ``import repro_torch`` (every module) works with ``jax`` and ``repro``
  blocked from import;
* no module under ``src/repro_torch`` (nor ``chip_smoke.py``, the tools
  and ``examples/*_torch.py``) names ``jax`` or a ``repro.*`` module in
  an import.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config
from repro.models import api as jax_api
from repro_torch import bridge

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"


def _bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.view(torch.int32).numpy()


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_bridge_roundtrip_exact(dtype):
    a = np.random.default_rng(0).standard_normal((5, 7)).astype(np.float32)
    ref = np.asarray(jnp.asarray(a, dtype))          # read-only, ml_dtypes for bf16
    t = bridge.to_tensor(ref, device="cpu")
    want = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    assert t.dtype == want and tuple(t.shape) == ref.shape
    ref_bits = ref.view(np.int16 if dtype == jnp.bfloat16 else np.int32)
    np.testing.assert_array_equal(_bits(t), ref_bits)
    np.testing.assert_array_equal(bridge.to_numpy(t), ref.astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_param_tree(dtype):
    cfg = reduced_config("granite-moe-1b-a400m").replace(dtype=dtype)
    tree = jax.tree.map(np.asarray, jax_api.init_params(jax.random.PRNGKey(0),
                                                        cfg))
    params = bridge.from_reference_params(tree, device="cpu")
    ref_leaves = jax.tree_util.tree_leaves_with_path(tree)
    flat = {}

    def walk(node, path):
        if isinstance(node, torch.Tensor):
            flat[path] = node
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        else:
            for i, v in enumerate(node):
                walk(v, path + (i,))

    walk(params, ())
    assert len(flat) == len(ref_leaves)
    for path, leaf in ref_leaves:
        key = tuple(getattr(p, "key", getattr(p, "idx", None)) for p in path)
        np.testing.assert_array_equal(bridge.to_numpy(flat[key]),
                                      leaf.astype(np.float32))


def test_import_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import pkgutil, importlib, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert 'jax' not in [k for k, v in sys.modules.items() if v]\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, timeout=120,
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _imported_names(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


SCANNED = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py",
                                         REPO / "tools" / "flash_bits.py",
                                         REPO / "tools" / "kernel_variants.py",
                                         REPO / "tools" / "fit_tile_model.py",
                                         REPO / "tools" / "ssd_ablations.py",
                                         REPO / "tools" / "ssd_premove_bits.py",
                                         REPO / "tools" / "tf32_ablations.py"]
SCANNED += sorted((REPO / "examples").glob("*_torch.py"))


def test_scan_covers_every_port_module():
    """The scan below walks every package of the port: the configs (each
    arch and ``shapes.py``), the encoder-decoder model and the mesh
    machinery (sharding rules, meshes, specs, steps, analysis, dry run)
    among them."""
    names = {str(p.relative_to(PORT)) for p in SCANNED if PORT in p.parents}
    for want in ("configs/base.py", "configs/shapes.py",
                 "configs/deepseek_moe_16b.py", "configs/whisper_base.py",
                 "models/whisper.py", "models/api.py", "launch/serve.py",
                 "parallel/sharding.py", "launch/mesh.py", "launch/specs.py",
                 "launch/steps.py", "launch/analysis.py",
                 "launch/dryrun.py"):
        assert want in names, want
    assert len([n for n in names if n.startswith("configs/")]) == 16


@pytest.mark.parametrize("path", SCANNED,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_imports(path):
    bad = [f"{path.name}:{ln}: {name}" for ln, name in _imported_names(path)
           if name.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad
