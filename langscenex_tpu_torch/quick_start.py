"""Four-stage end-to-end runner (quick_start.sh), port of the repository's
root ``quick_start.py``:

  1. auto-seg on the (first, last) keyframes -> seg keyframes and
     colors.npy (auto-mask-align.py), then get_normal -> normal keyframes;
  2. TriMap generation: three video_inference runs (rgb, seg, normal);
  3+4. the field pipeline: preprocess (frames, poses, language features)
     and field construction, then the render and eval modes.

    python -m langscenex_tpu_torch.quick_start --data_path demo \\
        --first_image a.png --last_image b.png --full-random --render --eval

Each stage is skippable and talks through the same directory contract as
the root script, so stages interchange with artifacts of the JAX package
or the reference. Every stage logs its seconds in one JSON line
(``stage wall-clock: {...}``) and, on a card, its peak memory in another.

It runs on ``cuda:0`` unless ``--device`` names another device.
``--tiny`` swaps every model for a tiny seeded random one (SAM2, VGGT,
CLIP, the TriMap DiT and VAE) so the whole chain runs without
checkpoints; the tiny TriMap model is CPU-only, so ``--tiny`` runs on the
CPU and raises for a card. ``--full-random`` builds the full-size models
with seeded random weights on the card: SAM1 ViT-H and SAM2 Hiera-L with
the thresholds off, VGGT-1B, CLIP ViT-L/14 and (as ``build_pipeline``
always does without a checkpoint) the 5.57B DiT and the VAE. The outputs
are meaningless; every stage does its real-scale work. Each stage's
models are freed before the next.

Deviations from the root script: ``--num_inference_steps`` (default 50)
sets the TriMap requests' depth on the full-size pipeline (the tiny one
keeps its 4 steps); there is no ``--zero-weights``, since the DiT and VAE
draw seeded random weights; keyframes and id maps are resized by
``utils/png`` (PIL's bicubic and nearest), not PIL.
"""
from __future__ import annotations

import argparse
import gc
import json
import logging
import os
import shutil
import time

import numpy as np
import torch

from .utils.device import resolve_device
from .utils.png import read_png, resize_bicubic, to_rgb

log = logging.getLogger("quick_start")


def _tiny_vggt_cfg():
    from .models.vggt import VGGTConfig
    return VGGTConfig(img_size=28, patch_size=14, embed_dim=32, depth=2,
                      num_heads=2, num_register_tokens=2,
                      vit_embed_dim=32, vit_depth=2, vit_num_heads=2,
                      camera_trunk_depth=1, camera_iterations=2,
                      intermediate_layers=(0, 0, 1, 1),
                      dpt_features=16, dpt_out_channels=(16, 16, 16, 16),
                      enable_point_head=False)


def build_vggt(tiny: bool, device: torch.device):
    """The seeded random VGGT of ``--tiny`` or ``--full-random``
    (VGGT-1B)."""
    from .models.vggt import VGGT, VGGTConfig, init_vggt_params
    cfg = _tiny_vggt_cfg() if tiny else VGGTConfig()
    return init_vggt_params(VGGT(cfg, device=device), 0).eval()


def build_clip_extractor(tiny: bool, device: torch.device):
    """The seeded random CLIP dense extractor of ``--tiny`` or
    ``--full-random`` (ViT-L/14)."""
    from .models.clip_dense import (CLIPVisionConfig, CLIPVisionDense,
                                    ClipDenseExtractor, init_clip_params)
    if tiny:
        cfg = CLIPVisionConfig(hidden_size=32, intermediate_size=64,
                               num_layers=2, num_heads=4, patch_size=14,
                               image_size=28, projection_dim=16)
        return ClipDenseExtractor(init_clip_params(
            CLIPVisionDense(cfg, device=device), 0), max_side=28)
    return ClipDenseExtractor(init_clip_params(
        CLIPVisionDense(CLIPVisionConfig(), device=device), 0))


def _tiny_sam_stack(device: torch.device):
    from .autoseg.mask_align import MaskAlignConfig
    from .models.sam2.amg import AMGConfig, AutomaticMaskGenerator
    from .models.sam2.decoder import DecoderConfig
    from .models.sam2.hiera import HieraConfig
    from .models.sam2.memory import MemoryConfig
    from .models.sam2.model import (SAM2, SAM2Config, SAM2VideoPredictor,
                                    init_sam2_params)
    cfg = SAM2Config(
        hiera=HieraConfig(embed_dim=8, num_heads=1, stages=(1, 1, 1, 1),
                          global_att_blocks=(3,), window_spec=(4, 4, 2, 2),
                          pos_embed_bkg_size=(2, 2), neck_dim=32),
        decoder=DecoderConfig(dim=32, num_heads=2, mlp_dim=64, depth=1,
                              num_multimask=3),
        memory=MemoryConfig(dim=32, mem_dim=16, num_heads=1, depth=1,
                            ffn_dim=64, num_maskmem=3, max_obj_ptrs=4),
        image_size=64)
    model = init_sam2_params(SAM2(cfg, device=device))
    amg = AutomaticMaskGenerator(
        model, AMGConfig(points_per_side=2, points_per_batch=4,
                         pred_iou_thresh=-1e9, stability_score_thresh=-1e9,
                         min_mask_area=0))
    acfg = MaskAlignConfig(detect_stride=1, max_objects=4,
                           new_obj_min_area=4, postnms_score=-1e9)
    return amg, SAM2VideoPredictor(model), acfg


def random_sam_stack(device: torch.device, level: str = "default"):
    """Full-size SAM1 ViT-H + SAM2 Hiera-L with seeded RANDOM weights and
    the thresholds off, each normalising its input as
    ``build_from_checkpoints`` builds them: the ``--full-random``
    configuration's auto-seg (reference-scale encoders, point grids, crop
    layers and propagation passes without the checkpoints). Masks are
    meaningless; wall-clock and mechanics are real."""
    from .autoseg.mask_align import MaskAlignConfig
    from .models.sam1 import (SAM1, SAM1AMGConfig, SAM1Config,
                              SAM1AutomaticMaskGenerator, init_sam1_params)
    from .models.sam2.model import (SAM2, SAM2Config, SAM2VideoPredictor,
                                    init_sam2_params)
    m1 = init_sam1_params(SAM1(SAM1Config(), device=device,
                               normalize_input=True), 0)
    m2 = init_sam2_params(SAM2(SAM2Config(), device=device,
                               normalize_input=True), 0)
    amg = SAM1AutomaticMaskGenerator(m1, SAM1AMGConfig(
        pred_iou_thresh=-1e9, stability_score_thresh=-1e9,
        min_mask_region_area=0))
    acfg = MaskAlignConfig(level=level, new_obj_min_area=4,
                           postnms_score=-1e9)
    return amg, SAM2VideoPredictor(m2), acfg


def run_autoseg(first_image: str, last_image: str, seg_dir: str,
                tiny: bool, sam1_ckpt=None, sam2_ckpt=None,
                level: str = "default", full_random: bool = False,
                device: torch.device | str | None = None) -> None:
    """Stage 1a: SAM proposals + SAM2 alignment over the two keyframes ->
    flat-colour seg keyframes and colors.npy (auto-mask-align.py:
    404-640)."""
    from .autoseg.__main__ import resize_id_maps
    from .autoseg.mask_align import (MaskAligner, MaskAlignConfig,
                                     build_from_checkpoints, save_outputs)
    dev = resolve_device(device)
    raw = [to_rgb(read_png(p)) for p in (first_image, last_image)]
    hw = raw[0].shape[:2]
    if tiny:
        amg, pred, acfg = _tiny_sam_stack(dev)
    elif full_random:
        amg, pred, acfg = random_sam_stack(dev, level)
    else:
        if not (sam1_ckpt and sam2_ckpt):
            raise RuntimeError(
                "auto-seg needs --sam1_checkpoint/--sam2_checkpoint, "
                "--tiny or --full-random")
        amg, pred = build_from_checkpoints(sam1_ckpt, sam2_ckpt,
                                           device=dev)
        acfg = MaskAlignConfig(level=level)
    # the SAM stack runs at the model's square size (the reference's SAM
    # transforms do the same inside); the id maps go back per pixel
    S = (amg.image_size if hasattr(amg, "image_size")
         else amg.model.cfg.img_size)
    frames = np.stack([resize_bicubic(r, (S, S)).astype(np.float32)
                       .transpose(2, 0, 1) / 255.0 for r in raw])
    seg_maps, colors = MaskAligner(amg, pred, acfg).run(frames)
    save_outputs(resize_id_maps(seg_maps, hw), colors, seg_dir)
    # the seg TriMap's keyframes: the flat-colour key PNGs
    for i in (1, 2):
        src = os.path.join(seg_dir, f"key_{i:04d}.png")
        if os.path.exists(src):
            shutil.copy(src, os.path.join(seg_dir, f"{i:04d}.png"))


def _free(dev: torch.device) -> None:
    """Drop what the finished stage left (its models are out of scope)."""
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--data_path", required=True)
    p.add_argument("--first_image")
    p.add_argument("--last_image")
    p.add_argument("--prompt", default="")
    p.add_argument("--checkpoint", default=None, help="TriMap DiT ckpt")
    p.add_argument("--sam1_checkpoint", default=None)
    p.add_argument("--sam2_checkpoint", default=None)
    p.add_argument("--vggt_checkpoint", default=None)
    p.add_argument("--level", default="default")
    p.add_argument("--skip_keyframes", action="store_true",
                   help="skip auto-seg + normal keyframe stages")
    p.add_argument("--skip_trimap", action="store_true")
    p.add_argument("--skip_train", action="store_true")
    p.add_argument("--render", action="store_true")
    p.add_argument("--eval", action="store_true")
    p.add_argument("--iterations", type=int, default=None)
    p.add_argument("--ae_epochs", type=int, default=400)
    p.add_argument("--pose_optim_iter", type=int, default=None,
                   help="eval pose-fit iters (gaussian.eval.pose_optim_iter)")
    p.add_argument("--num_inference_steps", type=int, default=50,
                   help="DDIM steps of each TriMap request (full-size "
                        "pipeline; the tiny one keeps its 4)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the first CUDA card; "
                        "--tiny runs on the CPU)")
    p.add_argument("--tiny", action="store_true",
                   help="tiny random models end-to-end (smoke test, CPU)")
    p.add_argument("--full-random", action="store_true", dest="full_random",
                   help="FULL-SIZE models with seeded random weights: the "
                        "reference-scale compute configuration (outputs are "
                        "meaningless; every stage does real-scale work)")
    return p.parse_args(argv)


def run(argv=None) -> dict:
    """The chain of ``argv``; returns {"stage_t": seconds per stage and
    "total", "peak_gib": peak device memory per stage (on a card)}."""
    args = parse_args(argv)
    if args.tiny:
        dev = torch.device(args.device or "cpu")
        if dev.type != "cpu":
            raise ValueError(
                f"--tiny runs on the CPU only, not on {dev}: the tiny "
                f"TriMap model (head dim 16, f32) is outside what the "
                f"attention kernels take")
    else:
        dev = resolve_device(args.device)
    dev_arg = ["--device", str(dev)]

    from .pipeline import FieldConstructionPipeline, PipelinePaths

    dp = args.data_path
    os.makedirs(dp, exist_ok=True)
    rgb_key = os.path.join(dp, "rgb")
    seg_key = os.path.join(dp, "seg")
    stage_t, peak = {}, {}
    t_all = time.perf_counter()

    def stage(name, t0):
        stage_t[name] = round(time.perf_counter() - t0, 1)
        # the peak since the last stage ended (a fresh process starts at 0)
        if dev.type == "cuda" and torch.cuda.is_initialized():
            torch.cuda.synchronize(dev)
            peak[name] = round(torch.cuda.max_memory_allocated(dev) / 2 ** 30,
                               2)
            _free(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        else:
            _free(dev)

    def vggt():
        if args.vggt_checkpoint:
            from .get_normal import load_checkpoint
            return load_checkpoint(args.vggt_checkpoint, device=dev)
        if args.tiny or args.full_random:
            return build_vggt(args.tiny, dev)
        return None

    # ---- stage 1: keyframes (seg via auto-seg, normal via get_normal) --
    if not args.skip_keyframes:
        t0 = time.perf_counter()
        os.makedirs(rgb_key, exist_ok=True)
        shutil.copy(args.first_image, os.path.join(rgb_key, "0001.png"))
        shutil.copy(args.last_image, os.path.join(rgb_key, "0002.png"))
        log.info("auto-seg keyframes -> %s", seg_key)
        run_autoseg(args.first_image, args.last_image, seg_key, args.tiny,
                    args.sam1_checkpoint, args.sam2_checkpoint, args.level,
                    full_random=args.full_random, device=dev)
        _free(dev)
        log.info("normal keyframes -> %s/normal", dp)
        from .get_normal import generate_normals
        generate_normals(dp, model=vggt(), device=dev)
        stage("1_keyframes", t0)

    # ---- stage 2: TriMap videos (rgb / seg / normal) -------------------
    if not args.skip_trimap:
        t0 = time.perf_counter()
        from .video_inference import main as vi_main
        for kind, d in (("rgb", rgb_key), ("seg", seg_key),
                        ("normal", os.path.join(dp, "normal"))):
            out = os.path.join(dp, f"trimap_{kind}")
            log.info("TriMap %s video -> %s", kind, out)
            vi_main(["--first_image", os.path.join(d, "0001.png"),
                     "--last_image", os.path.join(d, "0002.png"),
                     "--prompt", args.prompt, "--output_path", out,
                     "--num_inference_steps", str(args.num_inference_steps)]
                    + dev_arg
                    + (["--checkpoint", args.checkpoint]
                       if args.checkpoint else [])
                    + (["--tiny"] if args.tiny else []))
            _free(dev)
        stage("2_trimap_x3", t0)

    # ---- stages 3+4: preprocess + field construction -------------------
    if os.path.exists(os.path.join(seg_key, "colors.npy")):
        shutil.copy(os.path.join(seg_key, "colors.npy"),
                    os.path.join(dp, "colors.npy"))
    paths = PipelinePaths(
        data_path=dp,
        rgb_video_path=os.path.join(dp, "trimap_rgb"),
        seg_video_path=os.path.join(dp, "trimap_seg"),
        normal_video_path=os.path.join(dp, "trimap_normal"),
        skip_video_process=args.skip_trimap,
        skip_pose_estimate=os.path.isdir(os.path.join(dp, "camera")))
    pipe = FieldConstructionPipeline(paths, ae_epochs=args.ae_epochs,
                                     device=dev)
    if args.pose_optim_iter is not None:
        pipe.cfg.render.pose_optim_iter = args.pose_optim_iter
    if not args.skip_train:
        t0 = time.perf_counter()
        pipe.vggt = vggt()
        if args.tiny:
            pipe.pose_target_wh = (96, 64)
        if args.tiny or args.full_random:
            pipe.lang_extractor = build_clip_extractor(args.tiny, dev)
        pipe.preprocess()
        pipe.vggt = pipe.lang_extractor = pipe.ae_trainer = None
        stage("3_preprocess", t0)
        t0 = time.perf_counter()
        pipe.construct_field(iterations=args.iterations)
        pipe.trainer = None
        stage("4_field", t0)
    if args.render:
        t0 = time.perf_counter()
        pipe.render_result(load_iteration=args.iterations)
        stage("5a_render", t0)
    if args.eval:
        t0 = time.perf_counter()
        for r in pipe.eval(load_iteration=args.iterations):
            log.info("eval %s", r)
        stage("5b_eval", t0)
    stage_t["total"] = round(time.perf_counter() - t_all, 1)
    log.info("stage wall-clock: %s", json.dumps(stage_t))
    if peak:
        log.info("stage peak memory (GiB): %s", json.dumps(peak))
    return {"stage_t": stage_t, "peak_gib": peak}


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
