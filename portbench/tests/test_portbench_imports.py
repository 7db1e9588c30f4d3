"""No run loads JAX or the JAX package, and the reference imports neither
those nor the port."""
import ast
import os
import subprocess
import sys
from pathlib import Path

from portbench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_file_imports_jax_or_the_jax_package():
    for path in harness.HERE.rglob("*.py"):
        bad = set(_imports(path)) & FORBIDDEN
        assert not bad, f"{path} imports {bad}"


def test_the_reference_imports_nothing_of_the_program():
    for path in (harness.HERE / "reference").glob("*.py"):
        got = set(_imports(path))
        assert not got & (FORBIDDEN | {"repro_torch", "portbench"}), path
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import torch\n"
            "from portbench.reference import lm\n"
            "conf = dict(num_hidden_layers=1, num_attention_heads=2, "
            "num_key_value_heads=1, head_dim=4, rope_theta=1e4, "
            "n_routed_experts=2, num_experts_per_tok=1, n_shared_experts=0)\n"
            "L = lambda *s: torch.randn(1, *s)\n"
            "w = {'embed': torch.randn(5, 8), 'final_norm': {'scale': "
            "torch.ones(8)}, 'lm_head': torch.randn(8, 5), 'periods': ({"
            "'norm1': {'scale': L(8)}, 'norm2': {'scale': L(8)}, 'attn': {"
            "'wq': L(8, 8), 'wk': L(8, 4), 'wv': L(8, 4), 'wo': L(8, 8)}, "
            "'moe': {'router': {'w_router': L(8, 2)}, 'w_gate': L(2, 8, 3), "
            "'w_up': L(2, 8, 3), 'w_down': L(2, 3, 8)}},)}\n"
            "lm.served_gaps(w, conf, [[1, 2, 3]], [[4, 0]])\n"
            "bad = sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'repro', 'repro_torch'})\n"
            "print('LOADED', bad)\n" % str(harness.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout


def test_a_small_run_loads_no_jax():
    code = ("import sys, json; sys.path.insert(0, %r)\n"
            "from portbench.tests import small\n"
            "from portbench import harness, run\n"
            "ctx = small.small_context('deepseek-moe-16b.decode-closed8', "
            "seconds=0.5, mix_update=small.SHORT_SERVING, cell_update=dict("
            "warmup_s=0.2, serve={'max_ctx': 64}))\n"
            "out = run.execute(ctx)\n"
            "print('LOADED', harness.loaded_forbidden(), out['attempted'])\n"
            % str(harness.ROOT))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LOADED []" in out.stdout
