"""Designs of the tile blend forward (K1) and backward (K2), timed in turns
on one card at the main path's two shapes.

Each variant is a copy of the blend sources (``csrc/blend.cu`` and
``csrc/blend_backward.cu`` with the headers beside them) from the port
(``port``) or from an earlier tree given by ``--old`` (``old``), with a few
text edits (``VARIANTS``), built with the port's nvcc flags into
``build/variants_blend/<name>/`` (one nvcc per variant, all started
together) and loaded with ctypes under the port's C signatures. The old
design is PR 11's: unpack it first, for example

    git archive 0705aad langscenex_tpu_torch/csrc | tar -x -C build/old

and pass ``--old build/old/langscenex_tpu_torch/csrc``. ``old_tr`` is that
design with its 22 butterflies per pair and warp replaced by one
transposing reduction (22 values over 32 lanes in 16 + 8 + 4 + 2 + 1
shuffles, then one shared add per lane), the alternative to the new
design's reduction by products.

The inputs are the render scene's identity view (``chip_smoke.py`` phase
3: 100,000 splats, 720x480, 32x32 tiles, 14 channels, seeded upstream
gradients) and the field step's first view at iteration 600's flags
(phase 7's geometry + multi-view step, here on the trainer's state after
phase 6's first two windows, iterations 1-20 and 599-601, supervised by
the render scene's four views). For each
shape every variant's K1 and K2 are held against the plain versions under
``chip_smoke.py``'s bounds, then timed with CUDA events in turns (the
variants in order, then in reverse, ``--rounds`` times). It prints the
card's name and power limit, ptxas's registers and spills and cuobjdump's
resource line of each kernel of each build, and each kernel's bound with
its terms (``chip_smoke.blend_bound``). Needs a card with ``nvcc``:

    python3 tools/ab_blend.py --old build/old/langscenex_tpu_torch/csrc
        [--variants old,old_tr,port] [--rounds 2] [--iters 10]
"""
from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys
import tempfile
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from langscenex_tpu_torch import _build  # noqa: E402
from langscenex_tpu_torch.scene.gaussians import GaussianState  # noqa: E402
from langscenex_tpu_torch.train.render_mode import (  # noqa: E402
    render_all_views)

ENTRIES = ("lsx_blend_forward", "lsx_blend_backward")
SOURCES = ("blend.cu", "blend_backward.cu")

# the old design's per-pair reduction: 22 butterflies, each with a shared
# atomic from lane 0
_OLD_REDUCE = """      float* out = &s_grad[i * OUT_MAX];
      warp_add(d_x, out + 0, lane);
      warp_add(d_y, out + 1, lane);
      warp_add(d_a, out + 2, lane);
      warp_add(d_b, out + 3, lane);
      warp_add(d_c, out + 4, lane);
      warp_add(dop, out + 5, lane);
#pragma unroll
      for (int c = 0; c < BLEND_MAX_CH; ++c) {
        if (c < n_ch) warp_add(w * g[c], out + BLEND_GEOM + c, lane);
      }
      warp_add(fabsf(d_x), out + BLEND_GEOM + n_ch, lane);
      warp_add(fabsf(d_y), out + BLEND_GEOM + n_ch + 1, lane);
"""
# one transposing reduction of 32 slots: after the level of h, a lane
# keeps the half of its slots its bit h selects, summed with its
# partner's; lane l ends with the warp's sum of slot l
_TRANSPOSE_REDUCE = """      float v[32];
      v[0] = d_x; v[1] = d_y; v[2] = d_a; v[3] = d_b; v[4] = d_c;
      v[5] = dop;
#pragma unroll
      for (int c = 0; c < BLEND_MAX_CH; ++c) v[BLEND_GEOM + c] = w * g[c];
      v[22] = fabsf(d_x);
      v[23] = fabsf(d_y);
#pragma unroll
      for (int j = 24; j < 32; ++j) v[j] = 0.0f;
#pragma unroll
      for (int h = 16; h >= 1; h >>= 1) {
        const bool up = (lane & h) != 0;
#pragma unroll
        for (int j = 0; j < h; ++j) {
          const float send = up ? v[j] : v[j + h];
          const float keep = up ? v[j + h] : v[j];
          v[j] = keep + __shfl_xor_sync(FULL, send, h);
        }
      }
      const int col = lane < BLEND_GEOM + n_ch ? lane
                      : lane == 22 ? BLEND_GEOM + n_ch
                      : lane == 23 ? BLEND_GEOM + n_ch + 1 : -1;
      if (col >= 0 && v[0] != 0.0f) {
        atomicAdd(&s_grad[i * OUT_MAX + col], v[0]);
      }
"""
# name -> (source tree, [(text, replacement)] applied to its sources)
VARIANTS = {
    "old": ("old", []),
    "old_tr": ("old", [(_OLD_REDUCE, _TRANSPOSE_REDUCE)]),
    "port": ("port", []),
}


def variant_texts(name: str, tree: Path) -> dict:
    """{file: text} of a variant's blend sources and headers: those of
    ``tree`` with the variant's edits, each found in exactly one file."""
    files = [*SOURCES, *(h.name for h in tree.glob("*.cuh"))]
    texts = {f: (tree / f).read_text() for f in files}
    for old, new in VARIANTS[name][1]:
        hits = [f for f in files if old in texts[f]]
        if len(hits) != 1:
            raise ValueError(f"variant {name}: edit found in {hits}")
        texts[hits[0]] = texts[hits[0]].replace(old, new)
    return texts


def build(names, old_dir):
    """Build each variant; returns {name: namespace of its C entries}."""
    trees = {"port": _build.CSRC, "old": old_dir}
    jobs = {}
    for name in names:
        tree = trees[VARIANTS[name][0]]
        if tree is None:
            raise SystemExit(f"variant {name} needs --old")
        out = ROOT / "build" / "variants_blend" / name
        out.mkdir(parents=True, exist_ok=True)
        for f, text in variant_texts(name, Path(tree)).items():
            (out / f).write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
               "-shared", "-o", str(out / "lib.so"),
               *[str(out / f) for f in SOURCES]]
        jobs[name] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True))
    libs = {}
    for name, (out, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"variant {name} failed:\n{log}")
        for kernel, (regs, spills) in ptxas_report(log).items():
            print(f"{name} {kernel}: ptxas {regs} registers, {spills}")
        for line in resources(out / "lib.so"):
            print(f"{name} {line}")
        lib = ctypes.CDLL(str(out / "lib.so"))
        ns = types.SimpleNamespace(
            lsx_error_string=_build.library().lsx_error_string)
        for entry in ENTRIES:
            fn = getattr(lib, entry)
            fn.argtypes = _build._SIGNATURES[entry]
            fn.restype = ctypes.c_int
            setattr(ns, entry, fn)
        libs[name] = ns
    return libs


def ptxas_report(log: str) -> dict:
    """{kernel: (registers, spill line)} from ptxas -v's log."""
    out, fn = {}, None
    for line in log.splitlines():
        entry = re.search(r"entry function '([^']+)'", line)
        if entry:
            fn = re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_\d+_", "", entry.group(1))
            out[fn] = ["?", ""]
        elif fn is not None and "Used" in line and "registers" in line:
            out[fn][0] = line.split("Used")[1].split("registers")[0].strip()
        elif fn is not None and "spill" in line:
            out[fn][1] = line.strip()
    return out


def resources(lib: Path) -> list[str]:
    """cuobjdump's resource line of each blend kernel of a build."""
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                             "bin", "cuobjdump")
    out = subprocess.run([cuobjdump, "-res-usage", str(lib)],
                         capture_output=True, text=True,
                         check=True).stdout.splitlines()
    names = [(i, re.search(r"blend_\w+", line))
             for i, line in enumerate(out[:-1]) if "Function" in line]
    return [f"{m.group(0)}: {out[i + 1].strip()}" for i, m in names if m]


def shapes(dev):
    """(name, (bargs, cfg, g_accum, g_T)) of the render scene and of the
    field step at iteration 600, after the first two training windows."""
    state = cs.gaussian_state(cs.scene(cs.P, seed=0))
    s = GaussianState(**{k: v.to(dev) for k, v in state.__dict__.items()})
    bi = cs.render_blend_inputs(dev, s)
    n_tiles = bi.grid_x * bi.grid_y
    npx = cs.EXACT_CFG.tile_w * cs.EXACT_CFG.tile_h
    grng = torch.Generator(device=dev).manual_seed(2)
    g_accum = torch.randn((n_tiles, bi.channels.shape[1], npx),
                          generator=grng, device=dev)
    g_T = torch.randn((n_tiles, npx), generator=grng, device=dev)
    render = ((bi.lists, bi.proc.mean2d, bi.proc.conic, bi.opacity,
               bi.channels, bi.grid_x, bi.grid_y), cs.EXACT_CFG, g_accum,
              g_T)
    cams = cs.cameras()
    maps = [m for _, m in render_all_views(s, cams, cs.EXACT_CFG,
                                           sh_degree=3)]
    with tempfile.TemporaryDirectory() as lang_dir:
        cs.supervise(cams, maps, lang_dir)
        tr = cs.field_trainer(dev, cams, lang_dir)
        for first, last in cs.TRAIN_WINDOWS[:2]:
            tr.train(iterations=last, first_iteration=first)
        _, _, field = cs.kernel_step(tr, 600)
    return [("render scene", render), ("field step, it 600", field)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default="old,old_tr,port")
    ap.add_argument("--old", default=None,
                    help="csrc/ of an earlier tree (the old design)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ab_blend: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"{torch.cuda.get_device_name(0)} ({smi})")
    names = args.variants.split(",")
    libs = build(names, args.old)
    dev = torch.device("cuda")
    own = _build.library
    for what, (bargs, cfg, g_accum, g_T) in shapes(dev):
        tw, th, chunk = cfg.tile_w, cfg.tile_h, cfg.chunk
        C = bargs[4].shape[1]
        with torch.no_grad():
            ref = cs.blend_tiles_plain(*bargs, tw, th, chunk)
            k2args = (*bargs[:5], ref[0], ref[1], g_accum, g_T,
                      *bargs[5:7])
            ref2 = cs.blend_backward_plain(*k2args, tw, th, chunk)
            work = cs.blend_work(*bargs[:4], *bargs[5:7], tw, th, chunk)
            runs = {(n, k): [] for n in names for k in ("K1", "K2")}
            first = None
            flips = cs.K1_MAX_FLIPS if what.startswith("field") else 0
            try:
                for n in names:
                    _build.library = lambda n=n: libs[n]
                    got = cs.blend_forward(*bargs, cfg)
                    try:
                        cs.check_blend(got, ref, f"{what} {n} K1", flips)
                    except AssertionError as e:
                        print(f"  {what} {n} K1 differs from the plain "
                              f"version: {str(e).splitlines()[:4]}")
                    first = first or got
                    same = all(torch.equal(x, y) for x, y in zip(got, first))
                    print(f"  {what} {n} K1: accum, T and observe "
                          f"{'equal' if same else 'differ from'} "
                          f"{names[0]}'s bit for bit")
                    got2 = cs.blend_backward(*k2args, cfg)
                    print(f"  {what} {n} K2: {cs.bad_rows(got2, ref2):.4%} "
                          f"of splats outside the per-column bound, max "
                          f"abs err {cs.max_abs(got2, ref2):.3e}")
                for n in (names + names[::-1]) * args.rounds:
                    _build.library = lambda n=n: libs[n]
                    runs[(n, "K1")].append(cs.cuda_ms(
                        lambda: cs.blend_forward(*bargs, cfg), args.iters))
                    runs[(n, "K2")].append(cs.cuda_ms(
                        lambda: cs.blend_backward(*k2args, cfg), args.iters))
            finally:
                _build.library = own
        ins = (bargs[0].point_list, bargs[0].tile_starts,
               bargs[0].tile_counts, *bargs[1:5])
        counts = bargs[0].tile_counts
        print(f"{what}: {bargs[5] * bargs[6]} tiles of {tw}x{th}, "
              f"{int(counts.sum())} pairs (max {int(counts.max())}/tile), "
              f"{C} channels; evaluations {work}")
        for k, moved, bw in (("K1", cs.nbytes(*ins, *ref), False),
                             ("K2", cs.nbytes(*ins, *ref[:2], g_accum, g_T,
                                              ref2), True)):
            b = cs.blend_bound(work, C, moved, bw, dev)
            print(f"{what} {k} bound {b['bound_ms']:.5f} ms "
                  f"({b['bound_term']}; " + ", ".join(
                      f"{t} {v:.5f} ms" for t, v in b["terms"].items())
                  + ")")
        for n in names:
            print(f"{what} {n}: " + ", ".join(
                f"{k} {' / '.join('%.4f' % x for x in runs[(n, k)])} ms "
                f"(mean {sum(runs[(n, k)]) / len(runs[(n, k)]):.4f})"
                for k in ("K1", "K2")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
