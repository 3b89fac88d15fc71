"""No module of the benchmark, and nothing it imports, pulls in JAX or the
JAX package: each is imported in a process where they cannot be found,
and the top-level names of ``sys.modules`` are compared whole (the port's
name begins with the JAX package's)."""

import glob
import os
import subprocess
import sys

import pytest

from benchmark import run

BLOCK = """
import importlib, sys
BANNED = {"jax", "jaxlib", "flax", "emsar_tpu"}
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BANNED:
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, Block())
for name in sys.argv[1:]:
    importlib.import_module(name)
    loaded = {m.split(".")[0] for m in sys.modules} & BANNED
    assert not loaded, (name, loaded)
"""

MODULES = sorted(
    "benchmark." + os.path.splitext(os.path.basename(p))[0]
    for p in glob.glob(os.path.join(run.HERE, "*.py"))
    if not os.path.basename(p).startswith("test_"))


@pytest.mark.parametrize("module", MODULES + ["emsar_tpu_torch.cli.emsar",
                                              "emsar_tpu_torch.cli.emsar_build"])
def test_imports_without_jax(module):
    subprocess.run([sys.executable, "-c", BLOCK, module], cwd=run.ROOT,
                   check=True, env={**os.environ, "PYTHONPATH": run.ROOT})


def test_metric_readers_without_jax():
    names = [os.path.basename(p)[:-3] for p in
             glob.glob(os.path.join(run.HERE, "metrics", "*.py"))]
    code = BLOCK.replace("for name in sys.argv[1:]:", "for name in []:") + (
        "from benchmark import run\n"
        f"for n in {names!r}:\n"
        "    run.metric_reader(n)\n"
        "assert not {m.split('.')[0] for m in sys.modules} & BANNED\n")
    subprocess.run([sys.executable, "-c", code], cwd=run.ROOT, check=True,
                   env={**os.environ, "PYTHONPATH": run.ROOT})


def test_banned_names_compared_whole():
    from benchmark import child
    sys.modules.setdefault("emsar_tpu_torch", __import__("emsar_tpu_torch"))
    assert "emsar_tpu_torch" not in child.banned_modules()
