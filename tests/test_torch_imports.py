"""The port stands alone: no module under src/repro_torch, and neither
chip_smoke.py nor the scripts under tools/, imports jax or the JAX
package ``repro`` — shown by
reading every import statement and by importing the port in a fresh
interpreter and listing what it loaded."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + \
    sorted((ROOT / "tools").glob("*.py"))
FORBIDDEN = ("jax", "jaxlib", "repro")


def _top(name):
    return name.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_import_statement(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert _top(name) not in FORBIDDEN, \
                f"{path.relative_to(ROOT)}:{node.lineno} imports {name}"


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_importing_the_port_loads_no_jax():
    mods = sorted(str(p.relative_to(ROOT / "src").with_suffix(""))
                  .replace(os.sep, ".").removesuffix(".__init__")
                  for p in PORT.rglob("*.py"))
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "sys.path.insert(0, sys.argv[1]); import chip_smoke\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]\n"
            "print(len(bad), bad)\n")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)],
                         capture_output=True, text=True, env=_env(),
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("0 []"), out.stdout


def test_chip_smoke_fails_without_a_card_or_a_checkout(tmp_path):
    """Without CUDA, or copied away from the repo, it exits non-zero and
    prints no result line."""
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", lone)
    runs = [lone]
    if not torch.cuda.is_available():
        runs.append(ROOT / "chip_smoke.py")
    for script in runs:
        out = subprocess.run([sys.executable, str(script)],
                             capture_output=True, text=True, env=_env(),
                             cwd=script.parent, timeout=300)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


def test_the_serving_slice_is_covered():
    """The modules of the serving slice are among those read and
    imported above, the config copies included."""
    names = {str(p.relative_to(PORT)) for p in FILES if PORT in p.parents}
    assert {"configs/__init__.py", "configs/base.py",
            "configs/zamba2_1p2b.py",
            "kernels/flash_attention.py", "kernels/ssd.py",
            "models/layers.py", "models/attention.py", "models/ssm.py",
            "models/blocks.py", "models/model.py", "models/convert.py",
            "serve/engine.py", "launch/serve.py"} <= names


def test_the_training_slice_is_covered():
    """The modules of the training slice are among those read and imported
    above."""
    names = {str(p.relative_to(PORT)) for p in FILES if PORT in p.parents}
    assert {"tree.py", "optim/adamw.py", "optim/compression.py",
            "runtime/fault_tolerance.py", "checkpoint/checkpointer.py",
            "train/loop.py", "launch/train.py", "data/pipeline.py",
            "kernels/_autograd.py", "kernels/ref.py"} <= names
