"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level module names (the port's name begins with the JAX
package's), and the reference imports nothing of the program."""

from __future__ import annotations

import ast
import subprocess
import sys

from sedbench import run

FORBIDDEN = {"jax", "jaxlib", "flax", "desed_task_tpu"}


def _imports(path) -> set[str]:
    """Top-level names of the modules a file imports (relative imports are
    the benchmark's own)."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


def test_no_file_imports_jax_or_the_jax_package():
    for p in run.HERE.rglob("*.py"):
        assert not _imports(p) & FORBIDDEN, p


def test_the_reference_imports_nothing_of_the_program():
    for p in (run.HERE / "reference").rglob("*.py"):
        assert _imports(p) <= {"__future__", "contextlib", "math", "numpy", "torch"}, p


def test_a_whole_name_match_tells_the_port_from_the_jax_package():
    assert "desed_task_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "desed_task_tpu.ops".split(".")[0] in FORBIDDEN


def test_a_run_loads_no_jax_module():
    """The modules a run imports, in a fresh interpreter."""
    code = ("import sys; from sedbench import run; "
            "from sedbench.drivers import train, eval; "
            "import desed_task_tpu_torch.training.single_run, "
            "desed_task_tpu_torch.training.evaluate; "
            "print(run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT, capture_output=True,
                         text=True, timeout=300, env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
