"""FieldConstructionPipeline, the field stage's orchestration, port of the JAX
``pipeline.py`` (field_construction/pipeline.py:8-31; Preprocessor.
preprocess, preprocessor.py:296-316; VideoPreprocessor,
video_preprocessor/__init__.py:14-48; select_valid_data,
preprocessor.py:257-294).

The stages talk through the reference's filesystem contract: a scene
directory with ``input/``, ``normal/``, ``camera/``, ``lang_features/``,
``lang_features_dim3/``, ``colors.npy`` and ``points3D.ply``; the
trainer writes under ``output/`` (or ``model_path``). ``construct_field``
trains from a CUT3R-contract scene, ``render_result`` renders a PLY
snapshot with its meshes and ``eval`` runs the pose-fitted eval. They
run on ``device`` (``cuda:0`` unless the caller names another).

Frames are PNGs (``utils/png``, no PIL); ffmpeg is used where it is on
the PATH. ``preprocess`` runs the whole of stage 3: ``estimate_poses``
(VGGT, the dense-init COLMAP export or COLMAP, through
``pose_estimation.get_pose_estimator``) and ``extract_language_features``
(pooled CLIP / OpenSeg rows and the scene autoencoder, or the LSeg + VQ
branch). The models are the pipeline's attributes: ``vggt`` (a VGGT or
its state_dict; ``vggt_cfg`` its config), ``lang_extractor`` (a dense
extractor; else one is built from ``paths.openseg_path`` or
``paths.clip_ckpt`` at ``clip_cfg``) and, for LSeg, ``clip_cfg`` and
``vq_cfg`` for the checkpoints of ``paths.lseg_ckpt`` and
``paths.sem_ae_ckpt``. No weights ship with the port.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import shutil
import subprocess
from typing import Optional

import numpy as np
import torch

from .utils.device import resolve_device
from .utils.png import read_png, to_rgb

log = logging.getLogger(__name__)


def load_state_dict(path: str) -> dict:
    """A checkpoint's state_dict: a ``.safetensors`` file through
    ``models/t5.read_safetensors``, anything else with
    ``torch.load(weights_only=True)``."""
    if path.endswith(".safetensors"):
        from .models.t5 import read_safetensors
        return {k: torch.from_numpy(v.copy())
                for k, v in read_safetensors(path).items()}
    return torch.load(path, map_location="cpu", weights_only=True)


@dataclasses.dataclass
class PipelinePaths:
    data_path: str
    rgb_video_path: str = ""
    seg_video_path: str = ""
    normal_video_path: str = ""
    model_path: str = ""
    skip_video_process: bool = False
    skip_pose_estimate: bool = False
    skip_lang_feature_extraction: bool = False
    # the reference's view-selection switch (pipeline.selection, which
    # train_all.sh sets False); True raises: call select_valid_data with
    # the scene's chunking instead
    selection: bool = False
    # language-feature extractor checkpoints (preprocessor.py:22-34)
    openseg_path: str = ""
    clip_ckpt: str = ""
    # LSeg branch (preprocessor.py:112-138, 229-255)
    feature_extractor_type: str = "openseg"
    lseg_ckpt: str = ""
    sem_ae_ckpt: str = ""


class VideoPreprocessor:
    """Frame extraction and seg-video to id-map conversion."""

    def __init__(self, paths: PipelinePaths, img_format: str = "png"):
        self.paths = paths
        self.img_format = img_format

    def video_process(self) -> None:
        self.extract_frames(self.paths.rgb_video_path, "input")
        if self.paths.normal_video_path:
            self.extract_frames(self.paths.normal_video_path, "normal")
        if self.paths.seg_video_path:
            self.extract_masks("lang_features_dim3")

    def extract_frames(self, video_path: str, dir_name: str) -> None:
        """ffmpeg frame dump (video_preprocessor/__init__.py:26-31), or a
        renumbered copy when the input is already a frame directory."""
        out_dir = os.path.join(self.paths.data_path, dir_name)
        os.makedirs(out_dir, exist_ok=True)
        if os.path.isdir(video_path):
            for i, fn in enumerate(sorted(os.listdir(video_path))):
                shutil.copy(os.path.join(video_path, fn), os.path.join(
                    out_dir, f"{i + 1:04d}.{self.img_format}"))
            return
        if shutil.which("ffmpeg") is None:
            raise RuntimeError(
                "ffmpeg not available and input is not a frame directory")
        subprocess.run(
            ["ffmpeg", "-y", "-i", video_path,
             os.path.join(out_dir, f"%04d.{self.img_format}")],
            check=True, capture_output=True)

    def extract_masks(self, save_dir_name: str) -> None:
        """seg keyframes -> per-frame nearest-palette-colour id maps
        ``*_s.npy`` (video_preprocessor/__init__.py:33-48; -1 is the
        palette's first colour, the background)."""
        colors = np.load(os.path.join(self.paths.data_path, "colors.npy"))
        colors = colors.astype(np.float32) / 255.0
        save_path = os.path.join(self.paths.data_path, save_dir_name)
        os.makedirs(save_path, exist_ok=True)
        for idx, frame in enumerate(self._load_video_or_dir(
                self.paths.seg_video_path)):
            f = frame.astype(np.float32) / 255.0      # [H,W,3]
            d = ((f[:, :, None, :] - colors[None, None]) ** 2).sum(-1)
            np.save(os.path.join(save_path, f"{idx + 1:04d}_s.npy"),
                    np.argmin(d, axis=-1) - 1)

    def _load_video_or_dir(self, path: str):
        if os.path.isdir(path):
            for fn in sorted(os.listdir(path)):
                yield to_rgb(read_png(os.path.join(path, fn)))
            return
        tmp = os.path.join(self.paths.data_path, "_segframes")
        self.extract_frames(path, "_segframes")
        try:
            for fn in sorted(os.listdir(tmp)):
                yield to_rgb(read_png(os.path.join(tmp, fn)))
        finally:
            shutil.rmtree(tmp, ignore_errors=True)


def select_valid_data(data_path: str, chunk_num: int, keep_per_chunk: int,
                      dirs=("input", "normal")) -> None:
    """Uniform chunked frame subsample; renumbers the frames and the
    ``_f`` / ``_s`` pairs (preprocessor.py:257-294). The raw directories
    move to ``*_raw``."""
    names = sorted(os.listdir(os.path.join(data_path, "input")))
    n = len(names)
    chunk = max(n // chunk_num, 1)
    keep_idx = []
    for c in range(0, n, chunk):
        keep_idx.extend(range(c, min(c + keep_per_chunk, n)))
    keep_idx = sorted(set(keep_idx))

    for d in list(dirs) + ["lang_features_dim3"]:
        src = os.path.join(data_path, d)
        if not os.path.isdir(src):
            continue
        raw = os.path.join(data_path, d + "_raw")
        if os.path.isdir(raw):
            shutil.rmtree(raw)
        os.rename(src, raw)
        os.makedirs(src)
        by_stem = {}
        for fn in sorted(os.listdir(raw)):
            by_stem.setdefault(fn.split("_")[0].split(".")[0], []).append(fn)
        stems = sorted(by_stem)
        for new_i, old_i in enumerate(keep_idx):
            if old_i >= len(stems):
                break
            for fn in by_stem[stems[old_i]]:
                shutil.copy(os.path.join(raw, fn), os.path.join(
                    src, f"{new_i + 1:04d}{fn[len(stems[old_i]):]}"))


class FieldConstructionPipeline:
    """Top level (pipeline.py:8-31): preprocess -> train / render /
    eval over the filesystem contract, on ``device``."""

    def __init__(self, paths: PipelinePaths, gaussian_cfg=None,
                 pose_estimator: str = "vggt", ae_epochs: int = 400,
                 device: torch.device | str | None = None):
        from .utils.config import GaussianConfig
        self.paths = paths
        self.cfg = gaussian_cfg or GaussianConfig()
        self.pose_estimator = pose_estimator
        self.ae_epochs = ae_epochs
        self.device = resolve_device(device)
        self.trainer = None           # the last construct_field's trainer
        # the stage-3 models (tests and quick_start set them; the
        # production paths load checkpoints)
        self.vggt = None
        self.vggt_cfg = None
        self.pose_target_wh = (720, 480)
        self.lang_extractor = None
        self.clip_cfg = None          # CLIPVisionConfig() when None
        self.vq_cfg = None            # VQConfig() when None
        self.ae_trainer = None        # the last AE trainer

    @property
    def out_dir(self) -> str:
        return self.paths.model_path or os.path.join(self.paths.data_path,
                                                     "output")

    # -------------------------------------------------------- preprocess
    def preprocess(self, lang_features: bool = True) -> None:
        p = self.paths
        if p.selection:
            raise ValueError(
                "pipeline.selection=True: the port's configs carry no "
                "chunking for the view selection; run select_valid_data("
                "data_path, chunk_num, keep_per_chunk) on the scene instead")
        if not p.skip_video_process:
            VideoPreprocessor(p).video_process()
        if not p.skip_pose_estimate:
            self.estimate_poses()
        if not p.skip_lang_feature_extraction and lang_features:
            self.extract_language_features()

    def estimate_poses(self) -> None:
        """Pose initialisation through the estimator factory
        (pose_estimator/__init__.py:296-303): "vggt" (the default,
        :227-294) writes camera/%04d.npz {pose (c2w), intrinsics} and
        points3D.ply; "mast3r"/"cut3r" write the dense-init COLMAP tree;
        "colmap" runs the colmap binary."""
        from .pose_estimation import (estimate_poses_dense_init,
                                      estimate_poses_vggt, get_pose_estimator)
        est = get_pose_estimator(self.pose_estimator)
        if est is estimate_poses_vggt:
            est(self.paths.data_path, model=self.vggt, cfg=self.vggt_cfg,
                target_wh=self.pose_target_wh, device=self.device)
        elif est is estimate_poses_dense_init:
            est(self.paths.data_path, model=self.vggt, cfg=self.vggt_cfg,
                device=self.device)
        else:
            est(self.paths.data_path)

    def extract_language_features(self, extractor=None) -> None:
        """Language lifting and the per-scene AE (preprocessor.py:22-227).
        The rows come from lang_features/ when it holds them, else from
        ``extractor``, ``lang_extractor``, OpenSeg (paths.openseg_path) or
        the CLIP dense extractor (paths.clip_ckpt), in that order; the AE
        then trains on them and writes lang_features_dim3/*_f.npy. With
        ``feature_extractor_type`` "lseg", the LSeg + VQ branch runs
        instead."""
        from .train.ae import generate_dim3_features
        if self.paths.feature_extractor_type == "lseg":
            self._extract_lseg_features()
            return
        lf = os.path.join(self.paths.data_path, "lang_features")
        seg = os.path.join(self.paths.data_path, "lang_features_dim3")
        if not os.path.isdir(lf) or not os.listdir(lf):
            extractor = (extractor or self.lang_extractor
                         or self._make_lang_extractor())
            if extractor is None:
                log.warning(
                    "lang_features/ missing and no extractor configured "
                    "(set openseg_path or clip_ckpt); skipping AE stage")
                return
            from .models.openseg import extract_scene_features
            extract_scene_features(self.paths.data_path, extractor=extractor)
        self.ae_trainer = generate_dim3_features(
            lf, seg, seg, num_epochs=self.ae_epochs, device=self.device)

    def _extract_lseg_features(self) -> None:
        """The reference's LSeg branch (preprocessor.py:229-255): LSeg
        512-d dense features -> the VQ encoder -> lang_features_dim4/.
        Without ``paths.lseg_ckpt`` it logs and returns; without
        ``paths.sem_ae_ckpt`` the VQ model has seeded random weights (the
        shapes are right, the features are not semantic)."""
        from .models.clip_dense import CLIPVisionConfig
        from .models.lseg import (LSegFeatureExtractor,
                                  generate_lang_features_with_lseg)
        from .models.vq_model import VQConfig, VQModel, init_vq_params
        p = self.paths
        if not (p.lseg_ckpt and os.path.exists(p.lseg_ckpt)):
            log.warning("feature_extractor_type=lseg but lseg_ckpt "
                        "missing; skipping LSeg stage")
            return
        vq = VQModel(self.vq_cfg or VQConfig(), device=self.device)
        lseg = LSegFeatureExtractor.from_torch_checkpoint(
            p.lseg_ckpt, self.clip_cfg or CLIPVisionConfig(),
            out_dim=vq.cfg.in_channels, device=self.device)
        if p.sem_ae_ckpt and os.path.exists(p.sem_ae_ckpt):
            vq.load_state_dict(load_state_dict(p.sem_ae_ckpt), strict=True)
        else:
            log.warning("sem_ae_ckpt missing; using random-init VQ "
                        "compressor (shape-correct, not semantic)")
            init_vq_params(vq, 0)
        n = generate_lang_features_with_lseg(p.data_path, lseg, vq)
        log.info("LSeg branch wrote %d lang_features_dim4 maps", n)

    def _make_lang_extractor(self):
        p = self.paths
        if p.openseg_path and os.path.isdir(p.openseg_path):
            from .models.openseg import OpenSegExtractor
            return OpenSegExtractor(p.openseg_path)
        if p.clip_ckpt and os.path.exists(p.clip_ckpt):
            from .models.clip_dense import (CLIPVisionConfig,
                                            ClipDenseExtractor)
            return ClipDenseExtractor.from_torch_checkpoint(
                p.clip_ckpt, self.clip_cfg or CLIPVisionConfig(),
                device=self.device)
        return None

    # ------------------------------------------------------------- train
    def _confidence_lr(self, capacity: int) -> Optional[torch.Tensor]:
        """The per-point Adam's multipliers from sparse/0/confidence_dsp.npy
        (gaussian_field.py:128-136); without the file the per-point Adam
        is turned off, as the reference does."""
        from .train.per_point_adam import confidence_lr
        cpath = os.path.join(self.paths.data_path, "sparse/0",
                             "confidence_dsp.npy")
        try:
            conf = np.load(cpath).reshape(-1).astype(np.float32)
        except (OSError, ValueError):
            log.warning("can not load confidence; disabling pp_optimizer")
            self.cfg.opt.pp_optimizer = False
            return None
        pad = np.zeros(capacity, np.float32)
        pad[:min(len(conf), capacity)] = conf[:capacity]
        return confidence_lr(torch.from_numpy(pad), scale=(2.0, 100.0))

    def construct_field(self, iterations: Optional[int] = None):
        """Train from the CUT3R-contract scene: PLY and pose snapshots,
        checkpoints, reports and the collage under ``out_dir``, the final
        snapshot, and ``render_camera/*.npz`` from the optimised poses.
        Returns (state, metrics); the trainer stays in ``self.trainer``."""
        from .scene.dataset_readers import load_scene
        from .scene.gaussians import create_from_points
        from .train.field import GaussianFieldTrainer
        from .utils.camera_paths import post_pose_process
        cfg = self.cfg
        info = load_scene(self.paths.data_path, kind="cut3r")
        splats = create_from_points(info.points, info.colors,
                                    cfg.dataset.sh_degree, device=self.device)
        confidence = (self._confidence_lr(splats.capacity)
                      if cfg.opt.pp_optimizer else None)
        lang_dir = os.path.join(self.paths.data_path,
                                cfg.dataset.language_features_name)
        trainer = GaussianFieldTrainer(
            info.cameras, splats, cfg.opt,
            scene_extent=info.nerf_norm_radius,
            sh_degree_max=cfg.dataset.sh_degree,
            white_background=cfg.dataset.white_background,
            lang_dir=lang_dir if os.path.isdir(lang_dir) else None,
            confidence_lr=confidence)
        self.trainer = trainer
        out = self.out_dir
        start_it = 0
        if cfg.start_checkpoint:
            # resume (gaussian_field.py:146-149)
            start_it = trainer.restore(cfg.start_checkpoint)
            log.info("resumed from %s at iteration %d", cfg.start_checkpoint,
                     start_it)
        final_it = iterations or cfg.opt.iterations
        trainer.save_pose_org(out, tuple(cfg.save_iterations) + (final_it,))
        state, metrics = trainer.train(
            iterations=iterations, save_dir=out, first_iteration=start_it + 1,
            test_iterations=cfg.test_iterations, collage_interval=200,
            save_iterations=cfg.save_iterations,
            checkpoint_iterations=cfg.checkpoint_iterations)
        # final PLY + optimised poses (gaussian_field.py:516-549)
        trainer.save_snapshot(out, final_it)
        # render_camera/*.npz from the optimised poses (:553-559)
        cam_dir = os.path.join(self.paths.data_path, "camera")
        if os.path.isdir(cam_dir) and os.listdir(cam_dir):
            post_pose_process(
                state.poses.detach().cpu().numpy(),
                os.path.join(cam_dir, sorted(os.listdir(cam_dir))[0]),
                os.path.join(self.paths.data_path, "render_camera"))
        return state, metrics

    def _snapshot(self, load_iteration: Optional[int]):
        from .scene.dataset_readers import load_scene
        from .scene.ply_io import load_ply
        it = load_iteration or self.cfg.render.load_iteration
        splats = load_ply(os.path.join(
            self.out_dir, f"point_cloud/iteration_{it}", "point_cloud.ply"),
            self.cfg.dataset.sh_degree, device=self.device)
        info = load_scene(self.paths.data_path, kind="cut3r", shuffle=False)
        return it, splats, info

    # ------------------------------------------------------------ render
    def render_result(self, load_iteration: Optional[int] = None) -> dict:
        """Render mode into ``out_dir/renders/iteration_<it>``; returns
        the meshes' times and sizes."""
        from .train.render_mode import render_result
        it, splats, info = self._snapshot(load_iteration)
        return render_result(
            splats, info.cameras,
            os.path.join(self.out_dir, f"renders/iteration_{it}"),
            sh_degree=self.cfg.dataset.sh_degree,
            voxel_size=self.cfg.render.voxel_size)

    # -------------------------------------------------------------- eval
    def eval(self, load_iteration: Optional[int] = None):
        """Eval mode into ``out_dir/eval``, rendering with the snapshot's
        SH degree (the JAX pipeline renders with degree 3 whatever
        ``dataset.sh_degree`` is, and its clamped gather then repeats the
        last coefficient of a lower-degree snapshot)."""
        from .train.render_mode import eval_result
        _, splats, info = self._snapshot(load_iteration)
        results = eval_result(
            splats, info.cameras, self.out_dir,
            sh_degree=self.cfg.dataset.sh_degree,
            pose_optim_iters=self.cfg.render.pose_optim_iter)
        for r in results:
            log.info("eval %s psnr=%.2f", r["camera"], r["psnr"])
        return results
