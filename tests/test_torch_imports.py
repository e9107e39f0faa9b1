"""The PyTorch port stands alone: importing it and every one of its modules
loads neither ``jax`` nor the JAX package ``repro``, and ``chip_smoke.py``
names neither."""
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)

PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(names), bad)
sys.exit(1 if bad or len(names) < 15 else 0)
"""


def test_port_imports_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-c", PROBE], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_names_neither():
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        src = f.read()
    assert re.search(r"\bjax\b", src, re.IGNORECASE) is None
    assert re.search(r"\brepro\b", src) is None
    assert "repro_torch" in src
