"""Nothing the benchmark loads is JAX or the JAX package, compared by
whole top-level names; the reference loads nothing of the port."""
import ast
import subprocess
import sys
import types

from lsbench import harness


def test_forbidden_modules_compare_whole_names(monkeypatch):
    before = set(harness.forbidden_modules())
    for name in ("repro_torch_probe", "reproduce", "jaxtyping"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert set(harness.forbidden_modules()) == before
    monkeypatch.setitem(sys.modules, "repro.core",
                        types.ModuleType("repro.core"))
    assert set(harness.forbidden_modules()) - before == {"repro"}


def test_reference_imports_only_torch_and_numpy():
    allowed = {"__future__", "math", "typing", "numpy", "torch"}
    for path in (harness.HERE / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                # Another reference module under ``reference/`` is plain
                # too.
                assert n.split(".")[0] in allowed \
                    or n.startswith("lsbench.reference."), (path.name, n)


def test_a_run_loads_no_jax():
    code = (
        "import sys, time; sys.path[:0] = ['src', '.'];"
        "from lsbench.tests.tiny import run_tiny;"
        "run_tiny('tandt-train.walk', seconds=0.5);"
        "from lsbench.tests.lm_tiny import run_tiny_lm;"
        "run_tiny_lm(seconds=0.5);"
        "run_tiny_lm('minicpm3-4b', seconds=0.5);"
        "from lsbench import harness;"
        "print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
