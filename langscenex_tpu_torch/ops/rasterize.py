"""Tile-based differentiable Gaussian rasterization, port of the JAX
``ops/rasterize.py``.

``rasterize`` runs preprocess -> binning -> blend -> untile and assembles
the full :class:`RenderOutput`. Gradients flow by autograd through
preprocess, the blend (a ``torch.autograd.Function``, see
:mod:`.rasterize_cuda`) and the assembly; binning is discrete and runs
outside the graph, on detached inputs. Binning goes through kernels K15
(the pair enumeration; K3's compaction on the card's fallback) and K4
(radix sort) and the blend through kernels K1 (forward) and K2
(backward), or every wrapper runs its plain version, by ``_build``'s
rule: inside ``_build.plain()`` the plain path runs on the card too,
which is how the kernels are held against it there.

Channel layout (config.h:15-20): 3 RGB + 3 language + 3 instance + 5
all_map (local normal xyz, alpha-constant 1, plane distance).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..utils import profiling
from .binning import CullSpec, TileLists, build_tile_lists
from .projection import ProcessedSplats, RasterCamera, preprocess
from .rasterize_cuda import blend_tiles


@dataclasses.dataclass(frozen=True)
class RasterConfig:
    """The fields of the JAX ``RasterConfig`` that select something on the
    port's path; ``chunk`` is the plain blend's chunk length. The JAX
    config's other fields have no counterpart here: the port has none of
    their paths (``depth_presort``, ``payload_depth_rank``,
    ``packed_sort``, ``key_only_sort``, ``align_free``), it makes their
    choice once (binning always compacts and radix-sorts, which the JAX
    docstrings give the same lists as ``compact_sort`` and ``pallas_sort``;
    the plain blend walks every pair, as the kernel does, with no
    ``max_splats_per_tile``), or it picks the kernels by ``_build``'s
    rule."""
    tile_w: int = 32
    tile_h: int = 32
    max_tiles_per_splat: int = 32
    max_pairs: int | None = None
    big_splats: int = 256
    chunk: int = 128
    opacity_aware_radius: bool = True
    tile_cull: bool = True
    extra_tiers: tuple = ()
    rank_key_sort: bool = True


class RenderOutput(NamedTuple):
    color: torch.Tensor                    # [3,H,W]
    language: Optional[torch.Tensor]       # [3,H,W] or None
    instance: Optional[torch.Tensor]       # [3,H,W] or None
    all_map: Optional[torch.Tensor]        # [5,H,W] or None
    plane_depth: Optional[torch.Tensor]    # [H,W] or None
    final_T: torch.Tensor                  # [H,W]
    radii: torch.Tensor                    # [P]
    out_observe: torch.Tensor              # [P] int32
    visible: torch.Tensor                  # [P] bool
    pairs_overflowed: torch.Tensor         # [] bool
    k_overflowed: Optional[torch.Tensor] = None   # [] bool
    num_pairs: Optional[torch.Tensor] = None      # [] int32 true demand
    num_big: Optional[torch.Tensor] = None        # [] int32


def _untile(img_tiles: torch.Tensor, grid_x: int, grid_y: int,
            tile_h: int, tile_w: int, H: int, W: int) -> torch.Tensor:
    """[n_tiles, C, npx] -> [C, H, W] (crop the tile-grid padding)."""
    C = img_tiles.shape[1]
    x = img_tiles.reshape(grid_y, grid_x, C, tile_h, tile_w)
    x = x.permute(2, 0, 3, 1, 4).reshape(C, grid_y * tile_h, grid_x * tile_w)
    return x[:, :H, :W]


class BlendInputs(NamedTuple):
    """Everything the blend consumes: preprocess output, the conic cull
    spec and tile lists built from it, the visibility-masked opacity [P]
    and the channel payload [P, C]."""
    proc: ProcessedSplats
    cull: Optional[CullSpec]
    lists: TileLists
    opacity: torch.Tensor
    channels: torch.Tensor
    grid_x: int
    grid_y: int


def prepare_blend(means3d, scales, quats, opacity, cam: RasterCamera,
                  shs=None, sh_degree: int = 0, colors_precomp=None,
                  language_feature=None, instance_feature=None, all_map=None,
                  cov3d_precomp=None, scale_modifier: float = 1.0,
                  mean2d_offset=None,
                  cfg: RasterConfig = RasterConfig()) -> BlendInputs:
    """Preprocess, conic cull spec and binning: the part of
    :func:`rasterize` before the blend."""
    grid_x = (cam.width + cfg.tile_w - 1) // cfg.tile_w
    grid_y = (cam.height + cfg.tile_h - 1) // cfg.tile_h
    proc = preprocess(means3d, scales, quats, cam, shs=shs,
                      sh_degree=sh_degree, colors_precomp=colors_precomp,
                      cov3d_precomp=cov3d_precomp,
                      scale_modifier=scale_modifier, tile_w=cfg.tile_w,
                      tile_h=cfg.tile_h, mean2d_offset=mean2d_offset,
                      opacity=opacity if cfg.opacity_aware_radius else None)
    cull = None
    if cfg.tile_cull:
        op_cull = torch.where(proc.visible, opacity.reshape(-1),
                              0.0).detach()
        # +0.05 q-margin absorbs f32 evaluation differences between the
        # cull's component math and the blend's bilinear form
        qmax = 2.0 * torch.log(torch.clamp(255.0 * op_cull, min=1e-12)) + 0.05
        cull = CullSpec(mean2d=proc.mean2d.detach(),
                        conic=proc.conic.detach(), qmax=qmax,
                        tile_w=cfg.tile_w, tile_h=cfg.tile_h)

    # binning is discrete: keep it out of the autograd graph (the JAX code
    # stop_gradients its inputs)
    with torch.no_grad(), profiling.span("raster.bin"):
        lists = build_tile_lists(
            proc, grid_x, grid_y, cfg.max_tiles_per_splat,
            max_pairs=cfg.max_pairs, big_splats=cfg.big_splats, cull=cull,
            extra_tiers=cfg.extra_tiers, rank_key=cfg.rank_key_sort)

    parts = [proc.rgb]
    for extra in (language_feature, instance_feature, all_map):
        if extra is not None:
            parts.append(extra)
    channels = torch.cat(parts, dim=-1)
    # invisible splats never contribute (they are absent from the lists)
    op = torch.where(proc.visible, opacity.reshape(-1), 0.0)
    return BlendInputs(proc=proc, cull=cull, lists=lists, opacity=op,
                       channels=channels, grid_x=grid_x, grid_y=grid_y)


def rasterize(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    quats: torch.Tensor,
    opacity: torch.Tensor,
    cam: RasterCamera,
    bg_color: torch.Tensor,
    shs: Optional[torch.Tensor] = None,
    sh_degree: int = 0,
    colors_precomp: Optional[torch.Tensor] = None,
    language_feature: Optional[torch.Tensor] = None,
    instance_feature: Optional[torch.Tensor] = None,
    all_map: Optional[torch.Tensor] = None,
    cov3d_precomp: Optional[torch.Tensor] = None,
    scale_modifier: float = 1.0,
    mean2d_offset: Optional[torch.Tensor] = None,
    mean2d_abs_hook: Optional[torch.Tensor] = None,
    cfg: RasterConfig = RasterConfig(),
) -> RenderOutput:
    """Full differentiable rasterization pass. Mirrors
    diff_LangSurf_rasterization.GaussianRasterizer: include_feature is
    implied by language_feature/instance_feature being given, render_geo
    by all_map being given. ``mean2d_abs_hook``: an optional zero [P, 2]
    tensor whose gradient receives each splat's sum over pixels of
    |dL/d mean2d| (pixel units), on the kernel and the plain path alike."""
    H, W = cam.height, cam.width
    bi = prepare_blend(means3d, scales, quats, opacity, cam, shs=shs,
                       sh_degree=sh_degree, colors_precomp=colors_precomp,
                       language_feature=language_feature,
                       instance_feature=instance_feature, all_map=all_map,
                       cov3d_precomp=cov3d_precomp,
                       scale_modifier=scale_modifier,
                       mean2d_offset=mean2d_offset, cfg=cfg)
    proc, lists, grid_x, grid_y = bi.proc, bi.lists, bi.grid_x, bi.grid_y
    accum, T, observe = blend_tiles(lists, proc.mean2d, proc.conic,
                                    bi.opacity, bi.channels, grid_x, grid_y,
                                    cfg, mean2d_abs_hook=mean2d_abs_hook)

    imgs = _untile(accum, grid_x, grid_y, cfg.tile_h, cfg.tile_w, H, W)
    final_T = _untile(T[:, None, :], grid_x, grid_y, cfg.tile_h, cfg.tile_w,
                      H, W)[0]

    c0 = 0
    color = imgs[c0:c0 + 3] + final_T[None] * bg_color[:, None, None]
    c0 += 3
    language = instance = out_all_map = plane_depth = None
    if language_feature is not None:
        language = imgs[c0:c0 + 3]
        c0 += 3
    if instance_feature is not None:
        instance = imgs[c0:c0 + 3]
        c0 += 3
    if all_map is not None:
        out_all_map = imgs[c0:c0 + 5]
        # plane depth via per-pixel ray intersection (forward.cu:425-429)
        dev = imgs.device
        xs = (torch.arange(W, dtype=torch.float32, device=dev)
              - cam.cx) / cam.focal_x
        ys = (torch.arange(H, dtype=torch.float32, device=dev)
              - cam.cy) / cam.focal_y
        denom = (out_all_map[0] * xs[None, :] + out_all_map[1] * ys[:, None]
                 + out_all_map[2] + 1e-8)
        plane_depth = out_all_map[4] / -denom

    return RenderOutput(color=color, language=language, instance=instance,
                        all_map=out_all_map, plane_depth=plane_depth,
                        final_T=final_T, radii=proc.radius,
                        out_observe=observe, visible=proc.visible,
                        pairs_overflowed=lists.overflowed,
                        k_overflowed=lists.k_overflowed,
                        num_pairs=lists.num_pairs, num_big=lists.num_big)
