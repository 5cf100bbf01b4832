"""Field-construction settings, copied from the JAX ``utils/config.py``
(``OptimizationConfig``, ``DatasetConfig``, ``PipeConfig``,
``RenderConfig`` and ``GaussianConfig``: the same fields and the same
defaults, the reference's shipped values of
configs/field_construction.yaml:45-139), so a configuration carries
across packages without importing the JAX one."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass
class OptimizationConfig:
    """gaussian.opt (configs/field_construction.yaml:66-121)."""
    pp_optimizer: bool = False
    optim_pose: bool = True
    pose_until_iter: int = 2000
    iterations: int = 12_000
    max_geo_iter: int = 1500
    normal_optim: bool = False

    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 1000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    language_feature_lr: float = 0.0050
    instance_feature_lr: float = 0.0050
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    knn_f_lr: float = 0.01
    percent_dense: float = 0.001
    lambda_dssim: float = 0.2

    densification_interval: int = 100
    opacity_reset_interval: int = 999_999
    densify_from_iter: int = 500
    densify_until_iter: int = 1200
    densify_grad_threshold: float = 0.004
    densify_abs_grad_threshold: float = 0.016
    abs_split_radii2D_threshold: float = 20
    max_abs_split_points: int = 0
    max_all_points: int = 12_000_000
    opacity_cull_threshold: float = 0.05

    scale_loss_weight: float = 100.0
    wo_image_weight: bool = False
    single_view_weight: float = 0.10
    single_view_weight_from_iter: int = 500
    single_view_weight_end_iter: int = 2000

    instance_supervision_from_iter: int = 12_001
    use_virtul_cam: bool = False
    virtul_cam_prob: float = 0.5
    use_multi_view_trim: bool = True
    multi_view_ncc_weight: float = 0.15
    multi_view_geo_weight: float = 0.03
    multi_view_weight_from_iter: int = 500
    multi_view_weight_end_iter: int = 2000
    multi_view_patch_size: int = 3
    multi_view_sample_num: int = 102_400
    multi_view_pixel_noise_th: float = 1.0
    # dense windowed NCC (see train/multiview.py docstring); False = the
    # reference's literal gathered-patch formulation
    multi_view_dense_ncc: bool = True
    wo_use_geo_occ_aware: bool = False

    exposure_compensation: bool = False
    random_background: bool = False
    reg3d_k: int = 5
    reg3d_lambda_val: float = 4
    lang_loss_start_iter: int = 1200
    grouping_loss: bool = True
    loss_obj_3d: bool = True


@dataclasses.dataclass
class DatasetConfig:
    """gaussian.dataset (configs/field_construction.yaml:45-64)."""
    source_path: str = ""
    model_path: str = ""
    images: str = "images"
    resolution: int = -1
    white_background: bool = False
    sh_degree: int = 3
    eval: bool = False
    num_images: int = 1600        # AppModel table size (app_model.py:12)
    multi_view_num: int = 8
    multi_view_max_angle: float = 30
    multi_view_min_dis: float = 0.01
    multi_view_max_dis: float = 1.5
    language_features_name: str = "lang_features_dim3"


@dataclasses.dataclass
class PipeConfig:
    convert_SHs_python: bool = False
    compute_cov3D_python: bool = False
    debug: bool = False


@dataclasses.dataclass
class RenderConfig:
    """gaussian.render (configs/field_construction.yaml:129-134)."""
    load_iteration: int = 5_000
    pose_optim_iter: int = 100
    voxel_size: float = 0.01
    normalized: bool = True
    include_features: bool = True


@dataclasses.dataclass
class GaussianConfig:
    dataset: DatasetConfig = dataclasses.field(default_factory=DatasetConfig)
    opt: OptimizationConfig = dataclasses.field(default_factory=OptimizationConfig)
    pipe: PipeConfig = dataclasses.field(default_factory=PipeConfig)
    render: RenderConfig = dataclasses.field(default_factory=RenderConfig)
    save_iterations: Tuple[int, ...] = (100, 500, 1000, 2000, 5000, 10000, 12000)
    checkpoint_iterations: Tuple[int, ...] = (100, 500, 1000, 2000, 5000, 10000, 12000)
    test_iterations: Tuple[int, ...] = (100, 500, 1000, 2000, 5000, 10000, 12000)
    quiet: bool = False
    start_checkpoint: Optional[str] = None
