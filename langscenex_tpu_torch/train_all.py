"""Multi-scene batch runner, the ``train_all.sh`` counterpart, port of the
JAX package's ``train_all.py`` (train_all.sh:1-27: a loop over scenes
that runs entry_point with per-scene path overrides and shared
hyperparameter overrides).

Scenes come from --scenes; the directory layout is the reference's
(<videos>/<scene>/{rgb,normal,seg}/video_ckpt.mp4 -> <data>/<scene> ->
<out>/<scene>); extra key=value arguments go verbatim to every scene's
``entry_point.run`` (``device=cpu`` among them runs every scene on the
CPU); a failing scene is logged and skipped (the shell loop's behaviour)
unless --stop-on-error, and the exit code is 1 when any scene failed.

Usage:
  python -m langscenex_tpu_torch.train_all --scenes kitchen,ramen,teatime \\
      --videos outputs --data field_construction/data \\
      --out field_construction/outputs \\
      gaussian.opt.max_geo_iter=1500 pipeline.selection=False
"""
from __future__ import annotations

import argparse
import logging
import os

log = logging.getLogger("train_all")


def scene_argv(scene: str, videos: str, data: str, out: str,
               extra: list[str]) -> list[str]:
    """The per-scene override list train_all.sh:10-23 builds."""
    v = os.path.join(videos, scene)
    argv = [
        f"pipeline.rgb_video_path={v}/rgb/video_ckpt.mp4",
        f"pipeline.normal_video_path={v}/normal/video_ckpt.mp4",
        f"pipeline.seg_video_path={v}/seg/video_ckpt.mp4",
        f"pipeline.data_path={os.path.join(data, scene)}",
        f"gaussian.dataset.source_path={os.path.join(data, scene)}",
        f"gaussian.dataset.model_path={os.path.join(out, scene)}",
    ]
    # reference defaults for the batch run (train_all.sh:18-23)
    defaults = [
        "pipeline.selection=False",
        "gaussian.opt.max_geo_iter=1500",
        "gaussian.opt.normal_optim=True",
        "gaussian.opt.optim_pose=False",
    ]
    seen = {a.split("=", 1)[0] for a in extra}
    argv += [d for d in defaults if d.split("=", 1)[0] not in seen]
    return argv + list(extra)


def main(argv=None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--scenes", required=True,
                    help="comma-separated scene names")
    ap.add_argument("--videos", default="outputs",
                    help="base dir of per-scene TriMap videos")
    ap.add_argument("--data", default="field_construction/data",
                    help="base dir for per-scene extracted data")
    ap.add_argument("--out", default="field_construction/outputs",
                    help="base dir for per-scene field outputs")
    ap.add_argument("--mode", default="train",
                    choices=("train", "render", "eval"))
    ap.add_argument("--stop-on-error", action="store_true",
                    help="abort the batch on the first failing scene")
    ap.add_argument("overrides", nargs="*",
                    help="extra key=value overrides forwarded to every scene")
    args = ap.parse_args(argv)

    from . import entry_point

    scenes = [s for s in args.scenes.split(",") if s]
    failed = []
    for i, scene in enumerate(scenes):
        sa = ([f"mode={args.mode}"]
              + scene_argv(scene, args.videos, args.data, args.out,
                           args.overrides))
        log.info("scene %d/%d %r: entry_point %s", i + 1, len(scenes),
                 scene, " ".join(sa))
        try:
            entry_point.run(sa)
        except (Exception, SystemExit) as e:   # noqa: BLE001 — batch runner
            # entry_point rejects bad arguments with SystemExit
            log.error("scene %r FAILED: %s", scene, e)
            failed.append(scene)
            if args.stop_on_error:
                raise
    log.info("batch done: %d/%d scenes OK%s", len(scenes) - len(failed),
             len(scenes), f", failed: {failed}" if failed else "")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
