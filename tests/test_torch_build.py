"""The port's one seam to its CUDA kernels, ``langscenex_tpu_torch._build``,
on the CPU: :func:`_build.launch` against a stub library (one count under
the kernel's name, the stream last, a CUDA error raised), the rule of
:func:`_build.use_kernel` and its :func:`_build.plain` scope, and that no
other module of the port calls the library, takes a stream or writes a
launch count itself."""
import ast
import contextlib
import pathlib

import pytest
import torch

from langscenex_tpu_torch import _build

PORT = pathlib.Path(_build.__file__).resolve().parent
STREAM = 0x5EED


class _StubLibrary:
    """Every C entry of ``_build._SIGNATURES`` as a function that records
    its arguments and returns ``code``."""

    def __init__(self, code: int):
        self.calls = []
        for entry in _build._SIGNATURES:
            setattr(self, entry, self._entry(entry, code))

    def _entry(self, entry, code):
        def call(*args):
            self.calls.append((entry, args))
            return code
        return call

    @staticmethod
    def lsx_error_string(code):
        return b"stub error"


@pytest.fixture
def stub(monkeypatch):
    """Install a stub library returning the code the test passes; the
    launch counts are put back afterwards."""
    before = dict(_build.launch_counts)

    def install(code: int) -> _StubLibrary:
        lib = _StubLibrary(code)
        monkeypatch.setattr(_build, "library", lambda: lib)
        monkeypatch.setattr(_build, "stream_ptr", lambda device: STREAM)
        return lib
    yield install
    for name, n in before.items():
        _build.launch_counts[name] = n


@pytest.mark.parametrize("name", _build.KERNELS)
def test_launch_counts_once_passes_the_stream_last_and_raises(stub, name):
    entry = _build._TABLE[name][0]
    lib = stub(0)
    _build.reset_launch_counts()
    _build.launch(name, torch.device("cpu"), 11, 22)
    assert lib.calls == [(entry, (11, 22, STREAM))]
    assert dict(_build.launch_counts) == {
        k: int(k == name) for k in _build.KERNELS}
    assert _build._SIGNATURES[entry][-1] is _build._P   # the stream's type
    stub(700)
    with pytest.raises(RuntimeError, match=f"{name}: CUDA error 700"):
        _build.launch(name, torch.device("cpu"))


def test_knn_scratch_query_is_not_a_launch(stub, monkeypatch):
    lib = stub(0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda index: contextlib.nullcontext())
    _build.reset_launch_counts()
    _build.knn_select_scratch.cache_clear()
    try:
        assert _build.knn_select_scratch(800, 4096, 5, 0) == 0
    finally:
        _build.knn_select_scratch.cache_clear()
    assert [c[0] for c in lib.calls] == ["lsx_knn_select_scratch"]
    assert not any(_build.launch_counts.values())


def _own_surface_uses(path: pathlib.Path) -> list:
    """Calls of ``_build``'s library(), stream_ptr() or check(), imports of
    those names, and writes to a ``launch_counts`` entry, in one file."""
    private = ("library", "stream_ptr", "check")
    found = []
    for node in ast.walk(ast.parse(path.read_text())):
        if (isinstance(node, ast.Attribute) and node.attr in private
                and isinstance(node.value, ast.Name)
                and node.value.id == "_build"):
            found.append(f"_build.{node.attr}")
        elif (isinstance(node, ast.ImportFrom)
              and (node.module or "").endswith("_build")):
            found += [a.name for a in node.names
                      if a.name in private + ("launch_counts",)]
        elif isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                if (isinstance(t, ast.Subscript)
                        and "launch_counts" in ast.unparse(t.value)):
                    found.append(ast.unparse(t))
    return found


def test_only_build_launches():
    files = [p for p in PORT.rglob("*.py") if p.name != "_build.py"]
    assert len(files) > 50
    uses = {str(p.relative_to(PORT)): u for p in files
            if (u := _own_surface_uses(p))}
    assert uses == {}


class _OnCuda:
    """What the rule reads of a CUDA tensor, without a card."""
    device = torch.device("cuda", 0)


def test_rule_takes_the_kernel_on_cuda_outside_plain():
    assert _build.use_kernel(_OnCuda())
    with _build.plain():
        assert not _build.use_kernel(_OnCuda())
    assert _build.use_kernel(_OnCuda())


def test_rule_takes_the_plain_version_on_cpu_with_or_without_plain():
    x = torch.zeros(2)
    assert not _build.use_kernel(x)
    with _build.plain():
        assert not _build.use_kernel(x)
    with pytest.raises(ValueError, match="unsupported device"):
        _build.use_kernel(torch.empty(2, device="meta"))


def test_plain_nests():
    assert not _build.in_plain()
    with _build.plain():
        with _build.plain():
            assert _build.in_plain()
        assert _build.in_plain()
    assert not _build.in_plain()


def test_plain_is_restored_after_an_exception():
    with pytest.raises(KeyError):
        with _build.plain():
            with pytest.raises(ValueError):
                with _build.plain():
                    raise ValueError
            assert _build.in_plain()
            raise KeyError
    assert not _build.in_plain()
    assert _build.use_kernel(_OnCuda())
