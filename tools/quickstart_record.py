#!/usr/bin/env python3
"""The full-scale record of the port's four-stage chain on one card.

    python3 tools/quickstart_record.py [--out DIR] [--log-dir DIR] [--poll 60]

Writes two 720x480 keyframes of ``chip_smoke.py``'s room (phase 22's
200,000 splats seen from the ends of phase 25's 30-degree arc, rendered
by the port) and runs

    python -m langscenex_tpu_torch.quick_start --data_path OUT/demo \\
        --first_image OUT/keyframes/0001.png \\
        --last_image OUT/keyframes/0002.png --full-random --render --eval

with every depth at its default: 50 DDIM steps for each of the three
TriMap videos, the 12,000-iteration field schedule (densification and
every loss as the default config phases them), the scene AE's 400 epochs
and 100 eval pose iterations per view. The run is a child process whose
output goes to ``LOG_DIR/demo.log`` (``--log-dir``, OUT by default);
this script polls the log every
``--poll`` seconds and prints its newest lines, then the card's name and
power limit and quick_start's ``stage wall-clock`` and ``stage peak
memory`` lines.

If the chain fails, the script prints the failing command and the end of
its log and runs it again in a fresh directory that holds the room's
``camera/`` tree (the 49 poses of phase 25's arc) and ``points3D.ply``
beforehand, so quick_start skips pose estimation (the root script's
contract: a ``camera/`` directory present means the poses are given).
The exit code is the last run's.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def write_keyframes(out: str) -> None:
    import torch
    import chip_smoke as cs
    kf = os.path.join(out, "keyframes")
    os.makedirs(kf, exist_ok=True)
    cs.write_arc_frames(torch.device("cuda", 0), kf, 2)


def write_camera_tree(data: str, n: int) -> None:
    """camera/000N.npz (c2w, K) of the arc's n views and the room's
    points3D.ply."""
    import numpy as np
    import chip_smoke as cs
    os.makedirs(os.path.join(data, "camera"), exist_ok=True)
    for cam in cs.arc_cameras(n):
        K = np.array([[cam.fx, 0, cs.W / 2], [0, cam.fy, cs.H / 2],
                      [0, 0, 1]])
        np.savez(os.path.join(data, "camera", cam.image_name + ".npz"),
                 pose=np.linalg.inv(cam.w2c), intrinsics=K)
    arrays, cols = cs.e2e_room(cs.FIELD_P)
    cs.write_ply_points(os.path.join(data, "points3D.ply"), arrays[0], cols)


def run_chain(out: str, data: str, poll: float, log_dir: str) -> int:
    kf = os.path.join(out, "keyframes")
    cmd = [sys.executable, "-m", "langscenex_tpu_torch.quick_start",
           "--data_path", data,
           "--first_image", os.path.join(kf, "0001.png"),
           "--last_image", os.path.join(kf, "0002.png"),
           "--full-random", "--render", "--eval"]
    log = os.path.join(log_dir, os.path.basename(data) + ".log")
    print("command: " + " ".join(cmd), flush=True)
    t0 = time.perf_counter()
    with open(log, "w") as f:
        proc = subprocess.Popen(cmd, cwd=ROOT, stdout=f,
                                stderr=subprocess.STDOUT)
        while proc.poll() is None:
            time.sleep(poll)
            with open(log) as g:
                lines = [x for x in g.read().splitlines()
                         if "WARNING" not in x and "warn" not in x]
            print(f"[{time.perf_counter() - t0:.0f} s] "
                  + (lines[-1][:200] if lines else ""), flush=True)
    with open(log) as g:
        lines = g.read().splitlines()
    for x in lines:
        if "stage wall-clock" in x or "stage peak memory" in x:
            print(x, flush=True)
    print(f"exit {proc.returncode} after {time.perf_counter() - t0:.1f} s",
          flush=True)
    if proc.returncode:
        print("\n".join(lines[-40:]), flush=True)
    return proc.returncode


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default=os.path.join(ROOT, "build", "record"))
    p.add_argument("--log-dir", default=None,
                   help="where the chain's logs go (default: --out)")
    p.add_argument("--poll", type=float, default=60.0)
    args = p.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    log_dir = args.log_dir or args.out
    for d in (args.out, log_dir):
        os.makedirs(d, exist_ok=True)
    write_keyframes(args.out)
    rc = run_chain(args.out, os.path.join(args.out, "demo"), args.poll,
                   log_dir)
    if rc:
        data = os.path.join(args.out, "demo_camera")
        write_camera_tree(data, 49)
        print("rerun with the room's camera/ tree present "
              "(skip_pose_estimate)", flush=True)
        rc = run_chain(args.out, data, args.poll, log_dir)
    print(smi, flush=True)
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
