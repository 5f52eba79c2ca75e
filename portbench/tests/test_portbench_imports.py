"""The import guard: a run loads neither JAX nor the JAX package ``repro``,
compared by whole top-level module names (``repro_torch`` is the program)."""
import ast
import os
import subprocess
import sys
from pathlib import Path

from portbench import harness

REPO = Path(__file__).resolve().parents[2]
PKG = REPO / "portbench"


def test_whole_top_level_names(monkeypatch):
    clean = {k: v for k, v in sys.modules.items() if k.split(".")[0] not in harness.FORBIDDEN}
    monkeypatch.setattr(sys, "modules", dict(clean))
    assert harness.forbidden_modules() == []
    sys.modules["repro_torch_like"] = sys
    sys.modules["reprox.y"] = sys
    assert harness.forbidden_modules() == []
    sys.modules["repro.kernels"] = sys
    sys.modules["jax.numpy"] = sys
    assert harness.forbidden_modules() == ["jax", "repro"]


def test_no_source_imports_jax_or_the_jax_package():
    for path in PKG.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            assert not {n.split(".")[0] for n in names} & harness.FORBIDDEN, (path, names)


def test_a_run_loads_none_of_them():
    """What ``run.py`` and the program's serving path load, in a fresh process."""
    code = (
        "import importlib.util, sys\n"
        "spec = importlib.util.spec_from_file_location('r', 'portbench/run.py')\n"
        "m = importlib.util.module_from_spec(spec); spec.loader.exec_module(m)\n"
        "import repro_torch.models.model, repro_torch.serving, repro_torch.training\n"
        "from portbench import check\n"
        "print(m.harness.forbidden_modules())\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_without_a_card_no_result(tmp_path):
    """No card (or too few): exit non-zero and print nothing on stdout."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "glm4-gen",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
