"""The port stands alone: no file of ``lcqpow_tpu_torch`` or
``chip_smoke.py`` imports JAX or the JAX package, and the port solves with
JAX made unimportable."""

import ast
import pathlib
import subprocess
import sys
import textwrap

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
SOURCES = sorted((ROOT / "lcqpow_tpu_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_no_jax_import(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "lcqpow_tpu"), (path, mod)


def test_solves_with_jax_unimportable():
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["lcqpow_tpu"] = None
        import lcqpow_tpu_torch as lt
        from lcqpow_tpu_torch.problems import warm_up
        sol = lt.solve(warm_up(device="cpu"),
                       lt.Options(print_level=lt.PrintLevel.NONE))
        x = sorted(sol.x.tolist())
        assert int(sol.ret) == 0, int(sol.ret)
        assert abs(x[0]) < 1e-10 and abs(x[1] - 1) < 1e-10, x
        assert not any(m == "jax" or m.startswith(("jax.", "lcqpow_tpu."))
                       for m in sys.modules if sys.modules[m] is not None)
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
