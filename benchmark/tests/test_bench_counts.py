"""The operation counts against hand counts and against the port's own
work counter."""
import pytest
import torch

from benchmark.counts import blend, dit


def test_dit_step_flops_by_hand():
    cfg = dict(num_layers=2, num_heads=2, head_dim=64, in_channels=32,
               out_channels=16, patch_size=2, text_embed_dim=32,
               time_embed_dim=32, text_len=8, num_frames=5, height=64,
               width=64, vae_scale_factor_spatial=8,
               vae_scale_factor_temporal=4)
    h, te = 128, 32
    L, V = 8, 2 * 4 * 4            # 2 latent frames of 4 x 4 patches
    T = L + V
    per_seq_block = (2 * T * h * h * 4 + 2 * T * h * 4 * h * 2
                     + 2 * te * 6 * h * 2 + 4 * 2 * T * T * 64)
    embed = (2 * V * 32 * 4 * h + 2 * L * 32 * h + 2 * (h * te + te * te)
             + 2 * te * 2 * h + 2 * V * h * 4 * 16)
    assert dit.tokens(cfg) == (L, V)
    assert dit.step_flops(cfg) == pytest.approx(
        2 * (2 * per_seq_block + embed), rel=1e-12)


def test_published_step_count():
    """About 6.6e14 a guided step at CogVideoX-5B's widths: 17,550 video
    tokens and 226 text tokens."""
    cfg = dict(num_layers=42, num_heads=48, head_dim=64, in_channels=32,
               out_channels=16, patch_size=2, text_embed_dim=4096,
               time_embed_dim=512, text_len=226, num_frames=49, height=480,
               width=720, vae_scale_factor_spatial=8,
               vae_scale_factor_temporal=4)
    assert dit.tokens(cfg) == (226, 17550)
    f = dit.forward_flops(cfg, 2)
    assert 3.2e14 < f["attention"] < 3.3e14
    assert 6.5e14 < f["total"] < 6.8e14


def small_lists(seed=0):
    """A render's tile lists through the port's plain binning."""
    from langscenex_tpu_torch.ops.binning import build_tile_lists
    from langscenex_tpu_torch.ops.projection import RasterCamera, preprocess
    from langscenex_tpu_torch.ops.transforms import projection_matrix
    g = torch.Generator().manual_seed(seed)
    n, W, H = 400, 64, 64
    means = torch.stack([torch.rand(n, generator=g) * 4 - 2,
                         torch.rand(n, generator=g) * 4 - 2,
                         torch.rand(n, generator=g) * 4 + 3], -1)
    scales = torch.exp(torch.rand((n, 3), generator=g) * 2 - 4)
    quats = torch.nn.functional.normalize(torch.randn((n, 4), generator=g),
                                          dim=-1)
    opac = torch.rand(n, generator=g) * 0.9 + 0.05
    cam = RasterCamera(w2c=torch.eye(4), proj=torch.as_tensor(
        projection_matrix(0.01, 100.0, 1.0, 1.0)), width=W, height=H,
        tan_fovx=0.5463, tan_fovy=0.5463)
    proc = preprocess(means, scales, quats, cam,
                      colors_precomp=torch.zeros(n, 3), tile_w=16,
                      tile_h=16, opacity=opac)
    lists = build_tile_lists(proc, 4, 4, 32, kernels=False)
    op = torch.where(proc.visible, opac, 0.0)
    return lists, proc, op


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_blend_work_matches_the_port(seed):
    from langscenex_tpu_torch.ops.rasterize_cuda import blend_work as port
    lists, proc, op = small_lists(seed)
    ours = blend.blend_work(lists.tile_starts, lists.tile_counts,
                            lists.point_list, proc.mean2d, proc.conic, op,
                            4, 4, 16, 16, chunk=32)
    theirs = port(lists, proc.mean2d, proc.conic, op, 4, 4, 16, 16, 128)
    assert ours == theirs
    assert ours["included"] > 0


def test_blend_bound_terms():
    work = dict(walked=1000, live=800, gated=600, included=500)
    fp32, sfu = blend.blend_ops(work, 14, False)
    assert fp32 == 12 * 1000 + 2 * 800 + 2 * 600 + 29 * 500
    assert sfu == 800 + 600 + 500
    fp32b, _ = blend.blend_ops(work, 14, True)
    assert fp32b - fp32 == (38 + 44) * 500
    b = blend.blend_bound_ms(work, 14, 0, False, sms=132, mhz=1980.0)
    assert b["bound_term"] in ("FP32", "SFU")
    assert b["bound_ms"] == max(b["terms"].values())
