"""The port's tables of its CUDA kernels against the sources they name,
read as text with no build (the kernels compile only where nvcc is):
``chip_smoke.SOURCES`` and ``TPU_KERNELS``, the C signatures of
``langscenex_tpu_torch._build`` and the includes under ``csrc/``."""
import ast
import pathlib
import re

import pytest

from langscenex_tpu_torch import _build

ROOT = pathlib.Path(__file__).resolve().parent.parent
CSRC = ROOT / "langscenex_tpu_torch" / "csrc"


def _assigned(path: pathlib.Path, name: str):
    """The literal value assigned to ``name`` at the top level of a Python
    file, without importing it."""
    for node in ast.parse(path.read_text()).body:
        if (isinstance(node, ast.Assign)
                and any(isinstance(t, ast.Name) and t.id == name
                        for t in node.targets)):
            return ast.literal_eval(node.value)
    raise AssertionError(f"{path.name} assigns no {name}")


SOURCES = _assigned(ROOT / "chip_smoke.py", "SOURCES")
TPU_KERNELS = _assigned(ROOT / "chip_smoke.py", "TPU_KERNELS")
CUDA_FILES = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


@pytest.mark.parametrize("kernel", sorted(SOURCES))
def test_chip_smoke_sources_exist(kernel):
    # each kernel of the kernels line names a CUDA source of the port that
    # the build compiles, and the TPU kernel it replaces
    path = ROOT / SOURCES[kernel]
    assert path.is_file(), SOURCES[kernel]
    assert path.parent == CSRC and path.suffix == ".cu"
    assert kernel in TPU_KERNELS


@pytest.mark.parametrize("entry", sorted(_build._SIGNATURES))
def test_signature_defined_once(entry):
    # ctypes binds each entry of _SIGNATURES by name: exactly one source
    # defines it with C linkage
    pat = re.compile(r'extern\s+"C"\s+[\w\s*]*?\b' + entry + r"\s*\(")
    where = [f.name for f in CSRC.glob("*.cu") if pat.search(f.read_text())]
    assert len(where) == 1, (entry, where)


@pytest.mark.parametrize("path", CUDA_FILES, ids=lambda p: p.name)
def test_includes_exist(path):
    # a quoted include names a file beside it (the build copies nothing
    # else); a deleted header leaves no include behind
    for inc in re.findall(r'^\s*#\s*include\s+"([^"]+)"', path.read_text(),
                          re.M):
        assert (path.parent / inc).is_file(), (path.name, inc)

