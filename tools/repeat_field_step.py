"""Phase 7 of ``chip_smoke.py`` (the field train step through the kernels
against the plain path) repeated on fresh trainers, to read how its gates
vary between trainings.

Each repeat renders the render scene's four views (phase 4), supervises
and trains field-200k-720x480 through phase 6's windows and runs
``chip_smoke.compare_plain_step``, which prints the step's pose row
through the kernels, through the plain path on the kernels' renders and
through the plain path, with the plain path's own move when the splat
means are one f32 ulp apart. The trained state differs between repeats
(K2 sums in a varying order over 29 steps). A repeat whose gates fail is
reported and the next one runs. Needs a card with ``nvcc``:

    python3 tools/repeat_field_step.py [--repeats 3]
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from langscenex_tpu_torch import _build  # noqa: E402


def repeat(dev, repeats: int) -> int:
    """Train and compare ``repeats`` times; returns the count that failed."""
    failed = 0
    for rep in range(repeats):
        state = cs.gaussian_state(cs.scene(cs.P, seed=0))
        cams = cs.cameras()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "scene.ply")
            cs.save_ply(state, path)
            maps = cs.phase_main_path(dev, cams, path)["maps"]
        with tempfile.TemporaryDirectory() as lang_dir:
            tcams = cs.cameras()
            cs.supervise(tcams, maps, lang_dir)
            train = cs.phase_train(dev, tcams, lang_dir)
            try:
                cs.compare_plain_step(train["trainer"])
                print(f"repeat {rep}: phase 7 passed")
            except AssertionError as e:
                failed += 1
                print(f"repeat {rep}: phase 7 failed: {e}")
        del train, maps
        torch.cuda.empty_cache()
    return failed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("repeat_field_step: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    _build.build()
    failed = repeat(torch.device("cuda", 0), args.repeats)
    print(f"{args.repeats - failed} of {args.repeats} repeats passed")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
