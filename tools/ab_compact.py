"""Designs of the pair-key stream compaction (K3), timed in turns on one
card at the main path's two streams.

``old`` is the four-launch design of an earlier tree given by ``--old``
(a count pass, a one-block scan of the block counts, a scatter pass and a
tail fill), driven through that tree's wrapper, which allocates its block
counts per call; ``port`` is this tree's ``csrc/compaction.cu`` driven
through ``ops/compaction.compact_pairs``; the other names (``VARIANTS``)
are the port with one choice of its design undone by a text edit: a
look-back of 4 status words a lane (``lookback4``), no floor of six
blocks an SM on the registers (``regs_free``), the status words side by
side in place of one per 32-byte sector (``stride1``), each thread's
valid pairs stored straight from registers in place of staged in shared
memory (``direct``). Unpack the old
design first, for example

    git archive d7cfba6 langscenex_tpu_torch/csrc | tar -x -C build/old

and pass ``--old build/old/langscenex_tpu_torch/csrc``. Each design's
``compaction.cu`` (with the headers beside it, edited as the variant
says) is built with the port's
nvcc flags into ``build/variants_compact/<name>/`` (one nvcc per design,
started together) and loaded with ctypes under the port's C signature of
``lsx_compact_pairs``.

The streams are the render scene's enumerated slots (``chip_smoke.py``
phase 3: 100,000 splats, the identity view at 720x480, 32x32 tiles) and
the field step's first view at iteration 600's flags (phase 7's geometry
+ multi-view step, on the trainer's state after phase 6's first two
windows, iterations 1-20 and 599-601, supervised by the render scene's
four views). On each stream every design is held bit for bit against
``compact_pairs_plain``, its device kernels per call are counted from a
torch.profiler trace, and then the designs are timed with CUDA events in
turns (in order, then in reverse, ``--rounds`` times): queued behind a
spin (the device's time) and paced by the host. Beside them it prints the
plain version's time, the library yardstick's (``chip_smoke.
compact_library``), the needed-bytes bound with its terms
(``chip_smoke.compact_bound``), the card's name and power limit and
ptxas's registers and spills of each build. Needs a card with ``nvcc``:

    python3 tools/ab_compact.py --old build/old/langscenex_tpu_torch/csrc
        [--designs old,port,lookback4,regs_free,stride1,direct]
        [--rounds 2]
        [--iters 50]
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import tempfile
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from ab_blend import ptxas_report  # noqa: E402
from langscenex_tpu_torch import _build  # noqa: E402
from langscenex_tpu_torch.experiments import time_ms  # noqa: E402
from langscenex_tpu_torch.ops.binning import enumerate_pairs  # noqa: E402
from langscenex_tpu_torch.scene.gaussians import GaussianState  # noqa: E402
from langscenex_tpu_torch.train.render_mode import (  # noqa: E402
    render_all_views)

ENTRY = "lsx_compact_pairs"
OLD_TILE = 2048               # slots per block of the old design

# the look-back of the port with 4 status words a lane (128 tiles a round)
_LOOKBACK_1 = """    const int j = base - lane;
    const unsigned long long w =
        j >= 0 ? ld_relaxed64(&status[(size_t)j * STATUS_STRIDE])
               : status_word(epoch, FLAG_PREFIX, 0u);
    const unsigned flag = (unsigned)w & ~VALUE_MASK;
    const bool ready = (unsigned)(w >> 32) == epoch && flag != 0u;
    const unsigned prefix = __ballot_sync(FULL, ready && flag == FLAG_PREFIX);
    // the lanes up to the nearest inclusive prefix, or all of them
    const unsigned need = prefix ? (prefix & (0u - prefix)) * 2u - 1u : FULL;
    if ((__ballot_sync(FULL, ready) & need) != need) continue;
    excl += __reduce_add_sync(
        FULL, (need >> lane) & 1u ? (unsigned)w & VALUE_MASK : 0u);
    if (prefix) return excl;
    base -= 32;
"""
_LOOKBACK_4 = """    unsigned long long w[4];
    unsigned ready = 0u, prefix = 0u;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = base - 4 * lane - k;
      w[k] = j >= 0 ? ld_relaxed64(&status[(size_t)j * STATUS_STRIDE])
                    : status_word(epoch, FLAG_PREFIX, 0u);
      const unsigned flag = (unsigned)w[k] & ~VALUE_MASK;
      if ((unsigned)(w[k] >> 32) == epoch && flag != 0u) {
        ready |= 1u << k;
        if (flag == FLAG_PREFIX) prefix |= 1u << k;
      }
    }
    const unsigned lanes = __ballot_sync(FULL, prefix != 0u);
    const int lp = lanes ? __ffs(lanes) - 1 : 32;
    const unsigned need = lane < lp ? 15u
                          : lane == lp ? (2u << (__ffs(prefix) - 1)) - 1u
                                       : 0u;
    if (__any_sync(FULL, (ready & need) != need)) continue;
    unsigned part = 0u;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (need & (1u << k)) part += (unsigned)w[k] & VALUE_MASK;
    }
    excl += __reduce_add_sync(FULL, part);
    if (lp < 32) return excl;
    base -= 128;
"""
# the port's staging of a tile's valid pairs in shared memory, and its
# stores from there
_STAGED = """  // stage the valid pairs at their ranks in the tile: keys from registers,
  // sids by cp.async, in flight while warp 0 looks back
#pragma unroll
  for (int r = 0; r < CMP_ROWS; ++r) {
    const int i0 = tile * CMP_TILE + 4 * (r * CMP_THREADS + t) - pad;
    unsigned p = sm.offset[r * CMP_WARPS + warp] + rank[r];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if ((valid[r] >> e) & 1u) {
        sm.key[p] = k[r][e];
        lsx::cp_async4(&sm.sid[p], sid + i0 + e, true);
        ++p;
      }
    }
  }
  lsx::cp_async_commit();
  if (warp == 0) {
    const unsigned excl = tile == 0 ? 0u : look_back(status, tile, epoch);
    if (lane == 0) {
      if (tile > 0) {
        st_relaxed64(&status[(size_t)tile * STATUS_STRIDE],
                     status_word(epoch, FLAG_PREFIX, excl + sm.count));
      }
      sm.excl = excl;
    }
  }
  lsx::cp_async_wait_all();
  __syncthreads();

  const unsigned count = sm.count;
  const unsigned excl = sm.excl;
  for (unsigned j = t; j < count; j += CMP_THREADS) {
    const unsigned pos = excl + j;
    if (pos < (unsigned)out_len) {
      out_key[pos] = sm.key[j];
      out_sid[pos] = sm.sid[j];
    }
  }
"""
# each thread's valid pairs stored straight from registers after the
# look-back, sids read then
_DIRECT = """  if (warp == 0) {
    const unsigned excl = tile == 0 ? 0u : look_back(status, tile, epoch);
    if (lane == 0) {
      if (tile > 0) {
        st_relaxed64(&status[(size_t)tile * STATUS_STRIDE],
                     status_word(epoch, FLAG_PREFIX, excl + sm.count));
      }
      sm.excl = excl;
    }
  }
  __syncthreads();

  const unsigned count = sm.count;
  const unsigned excl = sm.excl;
  // each valid pair straight to its place (a warp's run is contiguous)
#pragma unroll
  for (int r = 0; r < CMP_ROWS; ++r) {
    const int i0 = tile * CMP_TILE + 4 * (r * CMP_THREADS + t) - pad;
    unsigned pos = excl + sm.offset[r * CMP_WARPS + warp] + rank[r];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if ((valid[r] >> e) & 1u) {
        if (pos < (unsigned)out_len) {
          out_key[pos] = k[r][e];
          out_sid[pos] = __ldg(sid + i0 + e);
        }
        ++pos;
      }
    }
  }
"""
# name -> (source tree, [(text, replacement)] applied to compaction.cu):
# each variant undoes one choice of the port's design
VARIANTS = {
    "old": ("old", []),
    "port": ("port", []),
    # the look-back reads 4 status words a lane
    "lookback4": ("port", [(_LOOKBACK_1, _LOOKBACK_4)]),
    # no floor of six blocks an SM: the compiler takes more registers
    "regs_free": ("port", [("__launch_bounds__(CMP_THREADS, "
                            "CMP_BLOCKS_PER_SM)",
                            "__launch_bounds__(CMP_THREADS)")]),
    # the status words side by side, not one per 32-byte sector
    "stride1": ("port", [("constexpr int STATUS_STRIDE = 4;",
                          "constexpr int STATUS_STRIDE = 1;")]),
    # no staging in shared memory: scattered stores from registers
    "direct": ("port", [(_STAGED, _DIRECT)]),
}


def variant_text(name: str, tree: Path) -> str:
    """A variant's compaction.cu: that of ``tree`` with its edits, each
    found exactly once."""
    text = (tree / "compaction.cu").read_text()
    for old, new in VARIANTS[name][1]:
        if text.count(old) != 1:
            raise ValueError(f"variant {name}: edit found {text.count(old)} "
                             "times")
        text = text.replace(old, new)
    return text


def build(names, old_dir) -> dict:
    """Build each design's compaction.cu; returns {name: namespace of its
    C entry}."""
    trees = {"port": _build.CSRC, "old": old_dir}
    jobs = {}
    for name in names:
        tree = trees[VARIANTS[name][0]]
        if tree is None:
            raise SystemExit(f"design {name} needs --old")
        tree = Path(tree)
        out = ROOT / "build" / "variants_compact" / name
        out.mkdir(parents=True, exist_ok=True)
        for h in tree.glob("*.cuh"):
            (out / h.name).write_text(h.read_text())
        (out / "compaction.cu").write_text(variant_text(name, tree))
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
               "-shared", "-o", str(out / "lib.so"), str(out /
                                                         "compaction.cu")]
        jobs[name] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True))
    libs = {}
    for name, (out, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"design {name} failed:\n{log}")
        for kernel, (regs, spills) in ptxas_report(log).items():
            print(f"{name} {kernel}: ptxas {regs} registers, {spills}")
        fn = getattr(ctypes.CDLL(str(out / "lib.so")), ENTRY)
        fn.argtypes = _build._SIGNATURES[ENTRY]
        fn.restype = ctypes.c_int
        libs[name] = types.SimpleNamespace(
            lsx_compact_pairs=fn,
            lsx_error_string=_build.library().lsx_error_string)
    return libs


def old_compact(lib, key, sid, sent_min, out_len, fill_key, fill_sid):
    """The old design's wrapper: both outputs and ceil(n / 2048) + 1 block
    counts allocated per call, then its four launches."""
    n = key.numel()
    n_blocks = -(-n // OLD_TILE)
    out_k = torch.empty(out_len, dtype=torch.int32, device=key.device)
    out_s = torch.empty(out_len, dtype=torch.int32, device=key.device)
    counts = torch.empty(n_blocks + 1, dtype=torch.int32, device=key.device)
    code = lib.lsx_compact_pairs(
        key.data_ptr(), sid.data_ptr(), out_k.data_ptr(), out_s.data_ptr(),
        counts.data_ptr(), n, out_len, n_blocks, int(sent_min),
        int(fill_key), int(fill_sid), _build.stream_ptr(key.device))
    _build.check(code, "old compact_pairs")
    return out_k, out_s


def caller(name: str, lib):
    """compact_pairs(*args) through design ``name``'s build."""
    if VARIANTS[name][0] == "old":
        return lambda *args: old_compact(lib, *args)

    def port(*args):
        own = _build.library
        _build.library = lambda: lib
        try:
            return cs.compact_pairs(*args)
        finally:
            _build.library = own
    return port


def streams(dev):
    """(name, compact_pairs args) of the render scene's enumerated stream
    and of the field step's first view at iteration 600."""
    state = cs.gaussian_state(cs.scene(cs.P, seed=0))
    s = GaussianState(**{k: v.to(dev) for k, v in state.__dict__.items()})
    bi = cs.render_blend_inputs(dev, s)
    cfg = cs.EXACT_CFG
    ps = enumerate_pairs(bi.proc, bi.grid_x, bi.grid_y,
                         cfg.max_tiles_per_splat, cfg.max_pairs,
                         cfg.big_splats, bi.cull, cfg.extra_tiers,
                         rank_key=True)
    sent = (bi.grid_x * bi.grid_y) << 22
    render = (ps.key, ps.sid, sent, ps.out_len, sent, cs.P)
    cams = cs.cameras()
    maps = [m for _, m in render_all_views(s, cams, cfg, sh_degree=3)]
    with tempfile.TemporaryDirectory() as lang_dir:
        cs.supervise(cams, maps, lang_dir)
        tr = cs.field_trainer(dev, cams, lang_dir)
        for first, last in cs.TRAIN_WINDOWS[:2]:
            tr.train(iterations=last, first_iteration=first)
        inputs, _, _ = cs.kernel_step(tr, 600)
    return [("render scene", render),
            ("field step, it 600", inputs["compactions"][0])]


def measure(dev, what: str, cargs, fns: dict, rounds: int,
            iters: int) -> None:
    """Every design (``fns``: name -> compact_pairs through that design)
    on one stream: bit for bit against the plain version, its device
    kernels per call, its times in turns, beside the plain version's, the
    library yardstick's and the needed-bytes bound."""
    names = list(fns)
    key, sid, sent_min, out_len = cargs[:4]
    ref = cs.compact_pairs_plain(*cargs)
    for n in names:
        got = fns[n](*cargs)
        cs.require(torch.equal(got[0], ref[0])
                   and torch.equal(got[1], ref[1]),
                   f"{what}: {n} differs from compact_pairs_plain")
        kernels = cs.device_kernels(lambda: fns[n](*cargs))
        print(f"{what} {n}: bit for bit with compact_pairs_plain; "
              f"{len(kernels)} device kernel(s) per call: {kernels}")
    runs = {(n, m): [] for n in names for m in ("queued", "paced")}
    for n in (names + names[::-1]) * rounds:
        fn = fns[n]
        runs[(n, "queued")].append(time_ms(
            lambda: fn(*cargs), iters, dev, queued=True))
        runs[(n, "paced")].append(cs.cuda_ms(lambda: fn(*cargs),
                                             iters))
    lib_name, lib_fn = cs.compact_library(key, sent_min, out_len)
    lib_ms = time_ms(lib_fn, iters, dev, queued=True)
    lib_paced = cs.cuda_ms(lib_fn, iters)
    plain_ms = cs.cuda_ms(lambda: cs.compact_pairs_plain(*cargs), 20)
    n_valid = int((key < sent_min).sum())
    b = cs.compact_bound(key.numel(), n_valid, out_len)
    print(f"{what}: {key.numel()} slots -> {out_len} ({n_valid} valid), "
          f"key offset {key.data_ptr() % 16} B from 16; plain "
          f"{plain_ms:.4f} ms; {lib_name} {lib_ms:.5f} ms queued, "
          f"{lib_paced:.5f} host-paced; bound {b['bound_ms']:.5f} ms "
          f"(bytes: " + ", ".join(f"{k} {v}" for k, v in
                                   b["terms"].items())
          + f", {b['bytes']} B at 3.35 TB/s)")
    for n in names:
        print(f"{what} {n}: " + ", ".join(
            f"{m} {' / '.join('%.5f' % x for x in runs[(n, m)])} ms "
            f"(mean {sum(runs[(n, m)]) / len(runs[(n, m)]):.5f})"
            for m in ("queued", "paced")), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--designs", default="old,port")
    ap.add_argument("--old", default=None,
                    help="csrc/ of an earlier tree (the old design)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ab_compact: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"{torch.cuda.get_device_name(0)} ({smi}), torch "
          f"{torch.__version__}")
    names = args.designs.split(",")
    libs = build(names, args.old)
    fns = {n: caller(n, libs[n]) for n in names}
    dev = torch.device("cuda")
    for what, cargs in streams(dev):
        measure(dev, what, cargs, fns, args.rounds, args.iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
