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
for name in ("quick_start", "train_all", "convert_cli", "ops.ring_attention",
             "utils.stepfun", "utils.profiling", "utils.pose_eval",
             "utils.camera_paths"):
    assert "langscenex_tpu_torch." + name in names, name
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
    # the ranks are fresh interpreters: with a `jax` that fails on import
    # first on their path, the port's dry run (2 gloo ranks: the
    # view-parallel field step, one full and one LoRA step, the SP ring
    # forward) still runs to its end
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
    assert "dryrun field (data=2) OK" in proc.stdout
    assert "dryrun sp ring (seq over 2 ranks) OK" in proc.stdout


def test_quick_start_tiny_chain_runs_without_jax_or_pil(tmp_path):
    # the four-stage chain end to end (--tiny, on the CPU) in a process
    # where jax, the JAX package's dependencies, PIL and the Hugging Face
    # packages cannot be imported
    code = ("import sys\n"
            "for name in ('jax', 'PIL', 'transformers', 'safetensors',\n"
            "             'tokenizers', 'tensorflow'):\n"
            "    sys.modules[name] = None\n"
            "import numpy as np, torch\n"
            "torch.set_num_threads(2)\n"
            "from langscenex_tpu_torch import quick_start\n"
            "from langscenex_tpu_torch.utils.png import write_png\n"
            f"root = {str(tmp_path)!r}\n"
            "for name, seed in (('a', 1), ('b', 2)):\n"
            "    img = np.random.default_rng(seed).integers(\n"
            "        0, 255, (64, 96, 3)).astype(np.uint8)\n"
            "    write_png(f'{root}/{name}.png', img)\n"
            "rec = quick_start.run(['--data_path', f'{root}/demo',\n"
            "    '--first_image', f'{root}/a.png', '--last_image',\n"
            "    f'{root}/b.png', '--tiny', '--iterations', '3',\n"
            "    '--ae_epochs', '1', '--pose_optim_iter', '1', '--eval'])\n"
            "assert not any(k == 'langscenex_tpu' or k.startswith(\n"
            "    'langscenex_tpu.') for k in sys.modules)\n"
            "print(sorted(rec['stage_t']))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert ("['1_keyframes', '2_trimap_x3', '3_preprocess', '4_field', "
            "'5b_eval', 'total']") in proc.stdout
