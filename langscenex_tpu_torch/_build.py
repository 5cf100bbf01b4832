"""Build, load and launch the hand-written CUDA kernels under ``csrc/``,
and the one rule that picks a kernel or its plain version.

``nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler
-fPIC`` compiles every ``csrc/*.cu`` to an object, one nvcc process per
source, all started together, and ``nvcc -shared`` links the objects into
one shared library with a plain C interface, placed in ``build/kernels/``
at the repository root under a name that hashes the sources and flags (so
an edited source rebuilds and an unchanged one loads the cached library).
ctypes loads it;
pointers and the CUDA stream travel as ``c_void_p``. Nothing here runs at
import time: the first CUDA tensor that reaches a kernel wrapper builds
the library.

The rule: an op runs its kernel on a CUDA tensor unless a :func:`plain`
scope is open, and its plain version on every other tensor
(:func:`use_kernel`). An op asks once, at its entry or in its autograd
``forward``, and keeps the answer for its backward.

:func:`launch` is every kernel's launch: it calls the kernel's C entry
(``_TABLE``) with the current stream of the device last, counts the
launch in :data:`launch_counts` (plain ints, reset with
:func:`reset_launch_counts`) so a run can prove that its main path went
through the kernels, and raises on the non-zero ``cudaGetLastError()``
code the entry returns. The counts live in ``utils/profiling.counters``,
the port's one set of counters; :data:`launch_counts` reads and writes
the :data:`KERNELS` entries of it and shows no other counter.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
import time
from collections.abc import MutableMapping
from pathlib import Path

import torch

from .utils import profiling

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-lineinfo"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# kernel name -> (C entry, argument types); the stream is every entry's
# last argument. KERNELS, the launch counters and the ctypes binding all
# come from this one table.
_TABLE = {
    # keys_in, vals_in, keys_out, vals_out, scratch, n, stream
    "sort_pairs": ("lsx_sort_pairs", [_P, _P, _P, _P, _P, _I, _P]),
    # key, sid, out_key, out_sid, status words, n, out_len, n_tiles,
    # sent_min, fill_key, fill_sid, stream
    "compact_pairs": ("lsx_compact_pairs",
                      [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]),
    # point_list, tile_starts, tile_counts, payload, accum, final_T,
    # observe, n_tiles, grid_x, tile_w, tile_h, n_channels, row_stride,
    # n_splats, stream
    "blend_forward": ("lsx_blend_forward",
                      [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                       _I, _P]),
    # point_list, tile_starts, tile_counts, payload, accum, final_T,
    # g_accum, g_T, grad, n_tiles, grid_x, tile_w, tile_h, n_channels,
    # row_stride, n_splats, stream
    "blend_backward": ("lsx_blend_backward",
                       [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                        _I, _I, _I, _P]),
    # K5: q, k, v, o, l2, B, T, H, (b, t, h) element strides of q, k, v
    # and o, scale2, stream
    "flash_attention": ("lsx_flash_attention_fwd",
                        [_P, _P, _P, _P, _P, _I, _I, _I, *[_L] * 12, _F,
                         _P]),
    # K6: q, k, v, o, l2, B, H, T, Tk, (b, h, t) element strides of q, k,
    # v and o, scale2, stream
    "flash_attention_bhtd": ("lsx_flash_attention_bhtd_fwd",
                             [_P, _P, _P, _P, _P, _I, _I, _I, _I,
                              *[_L] * 12, _F, _P]),
    # K7: q', k, v, do, aux (l2 and dvec), dq, dk, dv, B, T, Tk, H,
    # (b, t, h) element strides of q', k, v and do, scale, stream
    "flash_attention_backward": ("lsx_flash_attention_bwd",
                                 [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                  _I, _I, *[_L] * 12, _F, _P]),
    # K8: x, gamma, beta, sc, sh, tsc, tsh, y, B, T, H, text_len, is_f32,
    # stream
    "ln_modulate": ("lsx_ln_modulate",
                    [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                     _P]),
    # K9: as K6's
    "flash_attention_online": ("lsx_flash_attention_online_fwd",
                               [_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                *[_L] * 12, _F, _P]),
    # K11: q, k, v, o, B, H, T, Tk, (b, h, t) element strides of q, k, v
    # and o, bf16(scale), stream
    "flash_attention_h2": ("lsx_flash_attention_h2_fwd",
                           [_P, _P, _P, _P, _I, _I, _I, _I, *[_L] * 12, _F,
                            _P]),
    # K13a, K13b: as K11's, with bf16(scale * log2 e)
    "flash_attention_exp2": ("lsx_flash_attention_exp2_fwd",
                             [_P, _P, _P, _P, _I, _I, _I, _I, *[_L] * 12,
                              _F, _P]),
    "flash_attention_exp2_bf16": ("lsx_flash_attention_exp2_bf16_fwd",
                                  [_P, _P, _P, _P, _I, _I, _I, _I,
                                   *[_L] * 12, _F, _P]),
    # K13c: tab, idx, out, R, W, A, elem_bytes, stream
    "gather_rows": ("lsx_gather_rows", [_P, _P, _P, _I, _I, _I, _I, _P]),
    # K13b's packed exp alone: x, y, n, stream
    "exp2_bf16x2": ("lsx_exp2_bf16x2", [_P, _P, _I, _P]),
    # K14: sf, sq_s, f, sq_f, out d2, out slots, scratch, S, N, k, stream
    "knn_select": ("lsx_knn_select",
                   [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P]),
    # K15: tt, rect_min, rect_max, depth rank, mean2d, conic, qmax, the
    # register's -tt and ids, tiers (a host int array), n_tiers, out_key,
    # out_sid, total, overflowed, status words, P, K1, grid_x, n_tiles,
    # tile_w, tile_h, budget, out_len, n_blocks, stream
    "bin_pairs": ("lsx_bin_pairs",
                  [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P,
                   _P, _P, _I, _I, _I, _I, _I, _I, _L, _I, _I, _P]),
}
KERNELS = tuple(_TABLE)
# every C entry ctypes binds: the kernels' and K14's scratch-size query
# (S, N, k, out bytes of scratch as a long long*), which launches nothing
_SIGNATURES = {entry: argtypes for entry, argtypes in _TABLE.values()}
_SIGNATURES["lsx_knn_select_scratch"] = [_I, _I, _I, _P]


class _LaunchCounts(MutableMapping):
    """The kernels' entries of ``profiling.counters``, read and written
    through; a name outside :data:`KERNELS` is a ``KeyError``."""

    def __getitem__(self, name):
        if name not in KERNELS:
            raise KeyError(name)
        return profiling.counters[name]

    def __setitem__(self, name, value):
        if name not in KERNELS:
            raise KeyError(name)
        profiling.counters[name] = value

    def __delitem__(self, name):
        raise TypeError("a kernel's launch count cannot be removed")

    def __iter__(self):
        return iter(KERNELS)

    def __len__(self):
        return len(KERNELS)


for _name in KERNELS:
    profiling.counters.setdefault(_name, 0)
launch_counts = _LaunchCounts()

# seconds the last nvcc build of this process took (0.0 when only the
# cached library was loaded); read by chip_smoke.py
last_build_seconds = 0.0

_PLAIN = False


@contextlib.contextmanager
def plain():
    """Inside the block every op runs its plain version, on CUDA tensors
    too: how the kernels are held against their plain versions on the
    card. Process-wide; nests; the state before it returns on exit, an
    exception's too."""
    global _PLAIN
    prev = _PLAIN
    _PLAIN = True
    try:
        yield
    finally:
        _PLAIN = prev


def in_plain() -> bool:
    """Whether a :func:`plain` scope is open."""
    return _PLAIN


def use_kernel(t: torch.Tensor) -> bool:
    """The rule: ``t`` goes to the kernel when it is a CUDA tensor and no
    :func:`plain` scope is open, to the plain version when it is a CPU
    tensor or inside one. A tensor on any other device raises: it never
    falls back to the plain version."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}: the port's ops "
                         "take CPU and CUDA tensors")
    return t.device.type == "cuda" and not _PLAIN


def reset_launch_counts() -> None:
    """Zero every kernel's launch count."""
    for k in launch_counts:
        launch_counts[k] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found at {path}; set CUDA_HOME")
    return path


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"liblangscenex_kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile csrc/*.cu into the hashed library unless it exists: one
    nvcc per source, started together, then one link."""
    global last_build_seconds
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    # build into a temporary directory and name, then rename: a concurrent
    # or cut build never leaves a half-written library under the final name
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp_dir:
        nvcc = _nvcc()
        jobs = []
        for src in sorted(CSRC.glob("*.cu")):
            obj = Path(tmp_dir) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", str(obj),
                   str(src)]
            jobs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        logs, failed = [], []
        for src, _, proc in jobs:
            stdout, stderr = proc.communicate()
            logs.append(stderr)
            if proc.returncode != 0:
                failed.append(f"{src.name}:\n{stdout}{stderr}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp = Path(tmp_dir) / out.name
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
             *[str(obj) for _, obj, _ in jobs]],
            capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + link.stdout
                               + link.stderr)
        if verbose:
            print("".join(logs), end="")
        os.replace(tmp, out)
    last_build_seconds = time.perf_counter() - t0
    return out


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.lsx_error_string.argtypes = [ctypes.c_int]
    lib.lsx_error_string.restype = ctypes.c_char_p
    return lib


def check(code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        msg = library().lsx_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def stream_ptr(device) -> int:
    """PyTorch's current CUDA stream on ``device``, as an int."""
    return torch.cuda.current_stream(device).cuda_stream


def launch(name: str, device, *args) -> None:
    """Launch kernel ``name`` (a :data:`KERNELS` entry): its C entry with
    ``args`` and the current CUDA stream of ``device`` last. Counts one
    launch under ``name``; raises on a CUDA error."""
    entry = _TABLE[name][0]
    code = getattr(library(), entry)(*args, stream_ptr(device))
    launch_counts[name] += 1
    check(code, name)


@functools.lru_cache(maxsize=64)
def knn_select_scratch(S: int, N: int, k: int, device: int) -> int:
    """Bytes of device scratch K14 takes for (S, N, k) on CUDA device
    index ``device``: a query of its C side, no launch."""
    n = ctypes.c_longlong(0)
    with torch.cuda.device(device):
        check(library().lsx_knn_select_scratch(S, N, k, ctypes.addressof(n)),
              "knn_select scratch")
    return n.value
