"""The PyTorch port must run where JAX is not installed: importing every
module of langscenex_tpu_torch, and chip_smoke.py, succeeds in a process
in which ``import jax`` fails, and no source of the port imports JAX or
the JAX package."""
import os
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "langscenex_tpu_torch"

_CHILD = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None                  # any `import jax` now fails
import langscenex_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
assert not any(k == "langscenex_tpu" or k.startswith("langscenex_tpu.")
               for k in sys.modules), "the JAX package was imported"
print(len(names))
"""


def test_port_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", _CHILD], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip().splitlines()[-1]) >= 15


def test_port_sources_do_not_name_jax():
    pat = re.compile(r"^\s*(import jax|from jax)|langscenex_tpu\.", re.M)
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    bad = [str(f) for f in files if pat.search(f.read_text())]
    assert not bad, bad
