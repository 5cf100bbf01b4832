"""The PyTorch port must run where JAX, Pillow, TensorFlow and Hugging
Face's packages are not installed: importing every module of
langscenex_tpu_torch, and chip_smoke.py, succeeds in a process in which
``import jax``, ``import PIL``, ``import transformers``, ``import
safetensors``, ``import tokenizers`` and ``import tensorflow`` fail; no
source of the port imports JAX, the JAX package, PIL, safetensors or
tokenizers, ``transformers`` is imported only inside ``TextEncoder._load``
(for the T5 tokenizer; the CLIP text tower takes token ids and a caller's
tokenizer) and ``tensorflow`` only inside ``OpenSegExtractor``."""
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
sys.modules["PIL"] = None                  # and any `import PIL`
for name in ("transformers", "safetensors", "tokenizers", "tensorflow"):
    sys.modules[name] = None
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


def test_port_sources_do_not_import_pil():
    # the machine with the card has no Pillow: images go through utils/png
    pat = re.compile(r"^\s*(import PIL|from PIL)", re.M)
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    bad = [str(f) for f in files if pat.search(f.read_text())]
    assert not bad, bad


def test_port_sources_import_no_hf_package_at_module_level():
    # the machine with the card has none of them: safetensors files are
    # read by models/t5.read_safetensors, and transformers only gives the
    # T5 tokenizer, imported where a checkpoint directory is loaded
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    never = re.compile(r"^\s*(import|from)\s+(safetensors|tokenizers)\b",
                       re.M)
    assert not [str(f) for f in files if never.search(f.read_text())]
    hf = re.compile(r"^(\s*)(import|from)\s+transformers\b", re.M)
    uses = {str(f.relative_to(ROOT)): [m.group(1) for m in
                                       hf.finditer(f.read_text())]
            for f in files}
    uses = {k: v for k, v in uses.items() if v}
    assert list(uses) == ["langscenex_tpu_torch/models/t5.py"], uses
    src = (PKG / "models" / "t5.py").read_text()
    load = src[src.index("    def _load("):src.index("    def encode_ids(")]
    assert all(indent == " " * 12 for indent in
               uses["langscenex_tpu_torch/models/t5.py"])
    assert "from transformers import AutoTokenizer" in load


def test_port_imports_tensorflow_only_inside_openseg_extractor():
    # the OpenSeg SavedModel is an external artifact: tensorflow is
    # imported where OpenSegExtractor loads it, and nowhere else (the
    # CLIP dense extractor serves the same contract on the card)
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    tf = re.compile(r"^(\s*)(import|from)\s+tensorflow\b", re.M)
    uses = {str(f.relative_to(ROOT)): [m.group(1) for m in
                                       tf.finditer(f.read_text())]
            for f in files}
    uses = {k: v for k, v in uses.items() if v}
    assert list(uses) == ["langscenex_tpu_torch/models/openseg.py"], uses
    src = (PKG / "models" / "openseg.py").read_text()
    cls = src[src.index("class OpenSegExtractor"):
              src.index("def extract_scene_features")]
    assert len(uses["langscenex_tpu_torch/models/openseg.py"]) == 1
    assert "            import tensorflow as tf" in cls


def test_spawned_ranks_run_without_jax(tmp_path):
    # the tensor-parallel ranks are fresh interpreters: with a `jax` that
    # fails on import first on their path, the port's dry run (2 gloo
    # ranks, one full and one LoRA step) still runs to its end
    fake = tmp_path / "jax"
    fake.mkdir()
    (fake / "__init__.py").write_text('raise ImportError("jax is blocked")\n')
    env = dict(os.environ, PYTHONPATH=f"{tmp_path}{os.pathsep}{ROOT}")
    code = ("from langscenex_tpu_torch.parallel import dryrun\n"
            f"dryrun.dryrun(2, 'cpu', workdir={str(tmp_path)!r})\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "dryrun lora (data=1, model=2) OK" in proc.stdout
