"""Build and load the hand-written CUDA kernels under ``csrc/``.

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

Each C entry point returns ``cudaGetLastError()`` after its launches;
:func:`check` raises on a non-zero code. Each wrapper counts its launches
in :data:`launch_counts` (plain ints, reset with :func:`reset_launch_counts`)
so a run can prove that its main path went through the kernels.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-lineinfo"]

launch_counts = {"sort_pairs": 0, "compact_pairs": 0, "blend_forward": 0,
                 "blend_backward": 0, "flash_attention": 0,
                 "flash_attention_bhtd": 0, "flash_attention_backward": 0,
                 "ln_modulate": 0, "flash_attention_online": 0,
                 "flash_attention_h2": 0, "flash_attention_exp2": 0,
                 "flash_attention_exp2_bf16": 0, "gather_rows": 0,
                 "exp2_bf16x2": 0}

# seconds the last nvcc build of this process took (0.0 when only the
# cached library was loaded); read by chip_smoke.py
last_build_seconds = 0.0

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    # keys_in, vals_in, keys_out, vals_out, scratch, n, stream
    "lsx_sort_pairs": [_P, _P, _P, _P, _P, _I, _P],
    # key, sid, out_key, out_sid, block_counts, n, out_len, n_blocks,
    # sent_min, fill_key, fill_sid, stream
    "lsx_compact_pairs": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # point_list, tile_starts, tile_counts, payload, accum, final_T,
    # observe, n_tiles, grid_x, tile_w, tile_h, n_channels, row_stride,
    # n_splats, stream
    "lsx_blend_forward": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                          _I, _I, _P],
    # point_list, tile_starts, tile_counts, payload, accum, final_T,
    # g_accum, g_T, grad, n_tiles, grid_x, tile_w, tile_h, n_channels,
    # row_stride, n_splats, stream
    "lsx_blend_backward": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                           _I, _I, _I, _I, _P],
    # q, k, v, o, l2, B, T, H, (b, t, h) element strides of q, k, v and o,
    # scale2, stream
    "lsx_flash_attention_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, *[_L] * 12,
                                _F, _P],
    # q, k, v, o, l2, B, H, T, Tk, (b, h, t) element strides of q, k, v
    # and o, scale2, stream
    "lsx_flash_attention_bhtd_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                     *[_L] * 12, _F, _P],
    # K9: as K6's
    "lsx_flash_attention_online_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                       *[_L] * 12, _F, _P],
    # K11: q, k, v, o, B, H, T, Tk, (b, h, t) element strides of q, k, v
    # and o, bf16(scale), stream
    "lsx_flash_attention_h2_fwd": [_P, _P, _P, _P, _I, _I, _I, _I,
                                   *[_L] * 12, _F, _P],
    # K13a, K13b: as K11's, with bf16(scale * log2 e)
    "lsx_flash_attention_exp2_fwd": [_P, _P, _P, _P, _I, _I, _I, _I,
                                     *[_L] * 12, _F, _P],
    "lsx_flash_attention_exp2_bf16_fwd": [_P, _P, _P, _P, _I, _I, _I, _I,
                                          *[_L] * 12, _F, _P],
    # K13c: tab, idx, out, R, W, A, elem_bytes, stream
    "lsx_gather_rows": [_P, _P, _P, _I, _I, _I, _I, _P],
    # K13b's packed exp alone: x, y, n, stream
    "lsx_exp2_bf16x2": [_P, _P, _I, _P],
    # q', k, v, do, aux (l2 and dvec), dq, dk, dv, B, T, Tk, H, (b, t, h)
    # element strides of q', k, v and do, scale, stream
    "lsx_flash_attention_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                _I, *[_L] * 12, _F, _P],
    # x, gamma, beta, sc, sh, tsc, tsh, y, B, T, H, text_len, is_f32,
    # stream
    "lsx_ln_modulate": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                        _P],
}


def reset_launch_counts() -> None:
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
