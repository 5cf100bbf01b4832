"""VGGT in the PyTorch port against the benchmark's plain reference
(``benchmark/reference/vggt.py``, float32 torch from facebook/VGGT-1B's
state_dict keys, independent of the port) on the CPU, on the benchmark's
seeded weights (``benchmark/inputs/vggt.py``) loaded into the port's
module: the pose encoding, depth, depth confidence and the aggregator's
last layer of tokens, at a small configuration (3 frames of 56 x 56, 2 +
2 blocks, heads of 64) and at VGGT-1B's widths (1024, 16 heads of 64, DPT
features 256) with 2 + 2 blocks, 2 ViT blocks and 2 frames of 28 x 28.
Also: the RoPE tables built once per forward rotate as the per-call
rotation does, ``run_vggt`` runs no point head, and ``VGGTConfig`` takes
no precision but bfloat16.

Tolerance: relative RMS 1e-4 on each output. Both sides are f32 on the
CPU; they differ in the softmax (the port's online form in exp2 with q
scaled by scale·log2 e, the reference's softmax), in the align-corners
resize's tap positions (a few ulps) and in the uv embedding's
frequencies (f32 against double), which read 1e-6 to 1e-5 here; a bf16
step anywhere reads above 1e-3."""
import json
import sys
from pathlib import Path

import pytest
import torch
from test_torch_threads import few_torch_threads  # noqa: F401
from torch_vggt_mirror import rope2d

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from benchmark.drivers.vggt_forward import CONFIG_KEYS  # noqa: E402
from benchmark.inputs import vggt as vggt_inputs  # noqa: E402
from benchmark.reference import vggt as vggt_ref  # noqa: E402
from langscenex_tpu_torch import pose_estimation  # noqa: E402
from langscenex_tpu_torch.models import vggt as tv  # noqa: E402

TOL = 1e-4
SEED = 2147483659
SMALL = dict(img_size=56, embed_dim=128, num_heads=2, vit_embed_dim=128,
             vit_num_heads=2, depth=2, vit_depth=2, camera_trunk_depth=1,
             intermediate_layers=[0, 0, 1, 1], dpt_features=32,
             dpt_out_channels=[32, 32, 64, 64], num_frames=3)
PUBLISHED = dict(img_size=28, depth=2, vit_depth=2, camera_trunk_depth=1,
                 intermediate_layers=[0, 0, 1, 1], num_frames=2)


def config(**cut) -> dict:
    cfg = json.loads((ROOT / "benchmark/configs/vggt-1b-49x518.json")
                     .read_text())
    cfg.update(cut)
    return cfg


def port_model(cfg: dict, seed: int = SEED, with_points: bool = False):
    vcfg = tv.VGGTConfig(**{k: tuple(cfg[k]) if isinstance(cfg[k], list)
                            else cfg[k] for k in CONFIG_KEYS},
                         enable_point_head=with_points)
    model = tv.VGGT(vcfg, device="cpu").eval()
    sd = model.state_dict()
    for name, t in vggt_inputs.weights(cfg, seed, "cpu"):
        sd[name].copy_(t)
    return model


def rel_rms(x, ref, base=None):
    base = ref if base is None else base
    return float(torch.linalg.norm(x - ref) / torch.linalg.norm(base))


@pytest.mark.parametrize("cut", [SMALL, PUBLISHED], ids=["small", "widths"])
def test_port_matches_the_reference(cut):
    cfg = config(**cut)
    model = port_model(cfg)
    clip = vggt_inputs.clip(cfg, {"pan": 5}, SEED, 0, "cpu")
    seen = {}
    inner = model.aggregator.forward

    def aggregate(images):
        out = inner(images)
        seen["tokens"] = out[0][cfg["depth"] - 1]
        return out
    model.aggregator.forward = aggregate
    out = pose_estimation.run_vggt(model, clip)
    params = dict(vggt_inputs.weights(cfg, SEED, "cpu"))
    ref = vggt_ref.forward(params, cfg, clip[None])
    for k in ("pose_enc", "depth", "depth_conf"):
        assert out[k].shape == ref[k][0].shape, k
        assert rel_rms(out[k], ref[k][0]) <= TOL, k
    change = ref["tokens"] - ref["tokens_in"].repeat(1, 1, 1, 2)
    assert rel_rms(seen["tokens"], ref["tokens"], change) <= TOL
    # the blocks move the tokens well above the tolerance
    assert torch.linalg.norm(change) > 0.1 * torch.linalg.norm(
        ref["tokens"])


@pytest.mark.parametrize("frames,T", [(1, 21), (3, 21), (2, 5 + 37 * 37)])
def test_cached_rope_tables_match_the_per_call_rotation(frames, T):
    """Rope2D's tables for one frame, applied to a [B, S·T, H, hd] global
    sequence, rotate as the per-call rotation of the mirror (upstream's
    RotaryPositionEmbedding2D) at the positions repeated per frame."""
    g = torch.Generator().manual_seed(frames)
    side = int(round((T - 5) ** 0.5))
    ys, xs = torch.meshgrid(torch.arange(side), torch.arange(side),
                            indexing="ij")
    pos = torch.cat([torch.zeros(5, 2), torch.stack(
        [ys.flatten(), xs.flatten()], -1).float() + 1.0])
    x = torch.randn((2, frames * T, 4, 64), generator=g)
    got = tv.Rope2D(pos, 64, 100.0)(x)
    want = rope2d(x.transpose(1, 2), pos.repeat(frames, 1), 100.0)
    torch.testing.assert_close(got, want.transpose(1, 2), atol=1e-6,
                               rtol=1e-6)
    # the special tokens (position 0) pass unrotated
    assert torch.equal(got[:, :5], x[:, :5])


def test_run_vggt_runs_no_point_head():
    cfg = config(**SMALL)
    model = port_model(cfg, with_points=True)
    calls = []
    model.point_head.register_forward_hook(lambda *a: calls.append(1))
    out = pose_estimation.run_vggt(model, vggt_inputs.clip(
        cfg, {"pan": 5}, SEED, 0, "cpu").numpy())
    assert not calls
    assert "world_points" not in out
    assert {"pose_enc", "depth", "depth_conf", "extri", "K"} <= set(out)
    with torch.no_grad():
        full = model(torch.as_tensor(out["depth"].new_zeros(
            (1, cfg["num_frames"], 3, cfg["img_size"], cfg["img_size"]))))
    assert calls and "world_points" in full


@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_config_takes_bfloat16_alone(dtype):
    """K9 takes bf16 operands, so the aggregator's precision has one
    value; the CPU runs f32 whatever it says."""
    with pytest.raises(ValueError, match="dtype"):
        tv.VGGTConfig(dtype=dtype)
    assert tv.VGGTConfig().dtype == "bfloat16"
