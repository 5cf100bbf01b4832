"""Variants of the wgmma attention forward (K6, K9, K11, K13a, K13b),
timed in turns on one card.

Each variant is a copy of ``langscenex_tpu_torch/csrc/flash_attention_sm90.cu``
with a few text edits (``VARIANTS``), built with the port's nvcc flags into
``build/variants/<name>/`` (one nvcc per variant, all started together)
and loaded with ctypes under the port's C signatures. ``base`` is the
source as it stands. For each length of ``--tokens`` the script runs the
chosen kernels (K6, the bounded mode that K5 shares; K9, K11, K13a and
K13b) of every variant at [B, 48, T, 64] on seeded bf16 inputs, says
whether each output (K6's and K9's o and l2) equals the port's own build
bit for bit (variants that drop work, or sum K9's l another way, differ),
then times them with CUDA events in turns (the variants in order, then
in reverse, ``--rounds`` times) beside ``scaled_dot_product_attention``,
prints the per-score ratios K13b / K11, K9 / K13a and K6 / K9 (what the
online softmax's max and rescale cost over the bounded one), and prints
ptxas's registers, spills and C75xx performance notes for each mode of
each build. Needs a card with ``nvcc``:

    python3 tools/ab_forward_sm90.py [--variants base,lalu] [--tokens 17776]
        [--batch 1] [--kernels K6,K9] [--rounds 1] [--iters 5]
"""
from __future__ import annotations

import argparse
import ctypes
import os
import re
import shutil
import subprocess
import sys
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import langscenex_tpu_torch.ops.flash_attention as fa  # noqa: E402
from langscenex_tpu_torch import _build  # noqa: E402

ENTRIES = ("lsx_flash_attention_online_fwd", "lsx_flash_attention_h2_fwd",
           "lsx_flash_attention_exp2_fwd",
           "lsx_flash_attention_exp2_bf16_fwd",
           "lsx_flash_attention_bhtd_fwd")
# flash_fwd_wgmma's modes in the order of its Softmax enum, each with the
# kernels it serves
MODES = (("kNatural", "K11"), ("kExp2Bf16", "K13b"), ("kExp2", "K13a"),
         ("kOnline", "K9"), ("kBounded", "K5/K6"))
# name -> [(text, replacement)] applied to the source
VARIANTS = {
    "base": [],
    # two or four (k, v) stages in the ring instead of three
    "stages2": [("FW_STAGES = 3;", "FW_STAGES = 2;")],
    "stages4": [("FW_STAGES = 3;", "FW_STAGES = 4;")],
    # the consumers issue their products without taking turns
    "nopp": [("  bar_sync(BAR_TURN + wg, FW_CONSUMERS);\n", ""),
             ("  bar_arrive(BAR_TURN + (wg ^ 1), FW_CONSUMERS);\n", ""),
             ("    if (wg == 1) bar_arrive(BAR_TURN, FW_CONSUMERS);\n", ""),
             ("    if (wg == 0) bar_sync(BAR_TURN, FW_CONSUMERS);\n", "")],
    # no exp of the scores on the SFU: p is the exp's argument (timing
    # only; the rescale's exps stay)
    "nosfu": [("exp2_ftz(fmaf(", "(fmaf("),
              ("exp2_ftz(s[4 * i + e", "(s[4 * i + e"),
              ("exp2_bf16x2(pack_bf16(", "(pack_bf16(")],
    # K9's l summed from bf16(p) rounded in f32 registers (a cvt and two
    # unpacking ops per pair) instead of by the tensor cores against ones
    # (the bounded mode's stays on the tensor cores)
    "lalu": [("L_MMA = MODE == Softmax::kOnline || "
              "MODE == Softmax::kBounded;",
              "L_MMA = MODE == Softmax::kBounded;"),
             ("          const float p0 = exp2_ftz(s[4 * i + e] - mx);\n"
              "          const float p1 = exp2_ftz(s[4 * i + e + 1] - mx);\n",
              "          float p0 = exp2_ftz(s[4 * i + e] - mx);\n"
              "          float p1 = exp2_ftz(s[4 * i + e + 1] - mx);\n"
              "          if constexpr (MODE == Softmax::kOnline) {\n"
              "            const uint32_t pb = pack_bf16(p0, p1);\n"
              "            p0 = __uint_as_float(pb << 16);\n"
              "            p1 = __uint_as_float(pb & 0xffff0000u);\n"
              "          }\n")],
    # the producer loads the (k, v) tiles of even j only, or of the first
    # stages only, and completes the other stages' barriers with no bytes,
    # so the consumers reuse stale tiles: the K/V traffic from L2 halves
    # or vanishes (timing only)
    "halfkv": [("        mbar_expect_tx(&sm.full[s], 2 * TILE_BYTES);",
                "        if (j & 1) {\n          mbar_arrive(&sm.full[s]);\n"
                "          continue;\n        }\n"
                "        mbar_expect_tx(&sm.full[s], 2 * TILE_BYTES);")],
    "nokv": [("        mbar_expect_tx(&sm.full[s], 2 * TILE_BYTES);",
              "        if (j >= FW_STAGES) {\n          mbar_arrive(&sm.full[s]);\n"
              "          continue;\n        }\n"
              "        mbar_expect_tx(&sm.full[s], 2 * TILE_BYTES);")],
}


def build(names):
    """Build each variant; returns {name: namespace of its C entries}."""
    src = (_build.CSRC / "flash_attention_sm90.cu").read_text()
    jobs = {}
    for name in names:
        text = src
        for old, new in VARIANTS[name]:
            if old not in text:
                raise ValueError(f"variant {name}: {old!r} not in source")
            text = text.replace(old, new)
        out = ROOT / "build" / "variants" / name
        out.mkdir(parents=True, exist_ok=True)
        for header in _build.CSRC.glob("*.cuh"):
            shutil.copy(header, out)
        (out / "kernel.cu").write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
               "-shared", "-o", str(out / "lib.so"), str(out / "kernel.cu")]
        jobs[name] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True))
    libs = {}
    for name, (out, proc) in jobs.items():
        log = proc.communicate()[0].splitlines()
        if proc.returncode:
            raise RuntimeError(f"variant {name} failed:\n" + "\n".join(log))
        for mode, (regs, spills, notes) in ptxas_report(log).items():
            print(f"{name} {mode}: ptxas {regs} registers, {spills}, C75 "
                  f"notes {sorted(notes) or 'none'}")
        lib = ctypes.CDLL(str(out / "lib.so"))
        ns = types.SimpleNamespace()
        for entry in ENTRIES:
            fn = getattr(lib, entry)
            fn.argtypes = _build._SIGNATURES[entry]
            fn.restype = ctypes.c_int
            setattr(ns, entry, fn)
        libs[name] = ns
    return libs


def ptxas_report(log) -> dict:
    """{kernel: (registers, spill line, C75xx notes)} from ptxas -v's log,
    the wgmma forward's modes named by the kernels of MODES."""
    def label(fn):
        mode = re.search(r"SoftmaxE(\d)E", fn)
        return MODES[int(mode.group(1))][1] if mode else fn
    out, fn = {}, None
    for line in log:
        entry = re.search(r"entry function '([^']+)'", line)
        if entry:
            fn = label(entry.group(1))
            out[fn] = ["?", "", set()]
        elif fn is None:
            continue
        elif "(C75" in line:
            mode = re.search(r"SoftmaxE(\d)E", line)
            out[MODES[int(mode.group(1))][1] if mode else fn][2].add(
                "C75" + line.split("(C75")[1][:2])
        elif "Used" in line and "registers" in line:
            out[fn][0] = line.split("Used")[1].split("registers")[0].strip()
        elif "spill" in line:
            out[fn][1] = line.strip()
    return out


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def as_tuple(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--tokens", type=int, nargs="+", default=[17776, 18432])
    ap.add_argument("--heads", type=int, default=48)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--kernels", default="K6,K9,K13a,K11,K13b")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ab_forward_sm90: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"{torch.cuda.get_device_name(0)} ({smi})")
    names = args.variants.split(",")
    libs = build(names)
    own = _build.library
    kernels = {"K6": fa.flash_attention_kernel,
               "K9": fa.flash_attention_online_kernel,
               "K13a": fa.flash_attention_exp2_kernel,
               "K11": fa.flash_attention_h2_kernel,
               "K13b": fa.flash_attention_exp2_bf16_kernel}
    kernels = {kn: kernels[kn] for kn in args.kernels.split(",")}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    sc = 0.125
    for T in args.tokens:
        q, k, v = (torch.randn((args.batch, args.heads, T, 64), generator=gen,
                               device=dev).to(torch.bfloat16)
                   for _ in range(3))
        runs = {(n, kn): [] for n in names for kn in kernels}
        with torch.inference_mode():
            try:
                ref = {kn: fn(q, k, v, sc) for kn, fn in kernels.items()}
                for n in names:
                    _build.library = lambda n=n: libs[n]
                    for kn, fn in kernels.items():
                        outs = fn(q, k, v, sc)
                        for what, o, r in zip(("o", "l2"), as_tuple(outs),
                                              as_tuple(ref[kn])):
                            if not torch.equal(o, r):
                                err = (o.float() - r.float()).abs().max()
                                print(f"  T={T} {n} {kn}: {what} differs from "
                                      f"the port's build, max |diff| "
                                      f"{float(err):.3e}")
                for n in (names + names[::-1]) * args.rounds:
                    _build.library = lambda n=n: libs[n]
                    for kn, fn in kernels.items():
                        runs[(n, kn)].append(cuda_ms(
                            lambda: fn(q, k, v, sc), args.iters))
            finally:
                _build.library = own
            sdpa = [cuda_ms(lambda: torch.nn.functional
                            .scaled_dot_product_attention(q, k, v),
                            args.iters) for _ in range(2)]
        print(f"B={args.batch} T={T}: scaled_dot_product_attention "
              f"{' / '.join('%.4f' % x for x in sdpa)} ms")
        for n in names:
            t = {kn: runs[(n, kn)] for kn in kernels}
            ratios = [f"{a} / {b} {sum(t[a]) / sum(t[b]):.4f}"
                      for a, b in (("K13b", "K11"), ("K9", "K13a"),
                                   ("K6", "K9"))
                      if a in t and b in t]
            print(f"B={args.batch} T={T} {n}: " + ", ".join(
                f"{kn} {' / '.join('%.4f' % x for x in t[kn])} ms "
                f"(mean {sum(t[kn]) / len(t[kn]):.4f})" for kn in kernels)
                + "; " + ", ".join(ratios), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
