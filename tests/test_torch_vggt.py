"""VGGT in the PyTorch port vs the JAX package on the CPU, in f32, at the
JAX tests' tiny config (tests/test_vggt.py): 2D RoPE, the align-corners
bilinear resize, the pose decoding (with a zero fov) and the unprojection;
the whole model's pose encoding, depth, depth confidence, world points and
their confidence on 3 frames of 28x42 (so the DINOv2 position table is
resized); the track head; the DPT heads' frame chunks; and the reference
checkpoint's keys: the torch mirror's state_dicts (tests/
torch_vggt_mirror.py, facebook/VGGT-1B's layout) load into the port as
they are and give the mirror's outputs, and ``vggt_from_numpy`` inverts
``convert_vggt`` exactly.

The JAX model runs jitted on the port's seeded weights through the JAX
package's ``convert_vggt``. Tolerances: RoPE, the resize, the pose
decoding and the unprojection 1e-6 absolute (1e-5 relative for the
unprojection's larger values); the model and the track head the bounds of
tests/test_vggt.py's mirror tests (5e-4 absolute + 1e-3 relative; the
tracks 2e-3 + 1e-3); the port vs the mirror 1e-5 absolute; the frame
chunks 1e-6 absolute + 1e-5 relative (the CPU's convolutions round a
batch of 2 frames and one of 5 differently, by about 1e-6 relative)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_threads import few_torch_threads  # noqa: F401
from torch_vggt_mirror import TrackHeadMirror, VGGTMirror

from langscenex_tpu.models import vggt as jv
from langscenex_tpu.utils.convert import _vggt_track_head, convert_vggt
from langscenex_tpu_torch import convert
from langscenex_tpu_torch.models import vggt as tv

J_TINY = jv.VGGTConfig(img_size=28, patch_size=14, embed_dim=32, depth=2,
                       num_heads=2, num_register_tokens=2,
                       vit_embed_dim=32, vit_depth=2, vit_num_heads=2,
                       camera_trunk_depth=1, camera_iterations=2,
                       intermediate_layers=(0, 0, 1, 1),
                       dpt_features=16, dpt_out_channels=(16, 16, 16, 16))
J_TRACK = dataclasses.replace(
    J_TINY, enable_point_head=False, enable_track_head=True,
    track_features=16, track_iters=2, track_corr_levels=2,
    track_corr_radius=2, track_depth=2, track_hidden=32, track_virtual=4,
    track_num_heads=2)
MIRROR_CFG = {"patch": 14, "dim": 32, "depth": 2, "heads": 2, "n_reg": 2,
              "rope_freq": 100.0, "vit_dim": 32, "vit_depth": 2,
              "vit_heads": 2, "pos_grid": 2, "trunk_depth": 1,
              "iterations": 2, "inter_layers": [0, 0, 1, 1],
              "dpt_oc": [16, 16, 16, 16], "dpt_f": 16}
RNG = np.random.default_rng(0)
MODEL_TOL = dict(atol=5e-4, rtol=1e-3)


def port_cfg(jcfg, **kw):
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg) if f.name != "attn_dtype"}
    return tv.VGGTConfig(**{**fields, **kw})


def pair(jcfg, seed=0, include_track=False):
    """The port's model with seeded weights, and the JAX params converted
    from its state_dict."""
    tm = tv.init_vggt_params(tv.VGGT(port_cfg(jcfg), device="cpu"),
                             seed).eval()
    sd = {k: v.numpy().copy() for k, v in tm.state_dict().items()}
    params = jax.tree_util.tree_map(jnp.asarray,
                                    convert_vggt(sd, include_track))
    return tm, params


def jit_apply(jcfg, params, *args):
    return jax.jit(lambda p, *a: jv.VGGT(jcfg).apply(p, *a))(params, *args)


def test_rope_matches_jax():
    x = RNG.normal(size=(1, 2, 7, 16)).astype(np.float32)
    pos = RNG.integers(0, 9, (7, 2)).astype(np.float32)
    got = tv.rotate_2d(torch.from_numpy(x), *tv.rope_2d_tables(
        torch.from_numpy(pos), 16, 100.0))
    want = jv.apply_rope_2d(jnp.asarray(x), jnp.asarray(pos), 100.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("hw,size", [((3, 4), (5, 7)), ((37, 37), (148, 148)),
                                     ((19, 19), (37, 37)), ((4, 6), (4, 6))])
def test_resize_bilinear_ac_matches_jax(hw, size):
    x = RNG.normal(size=(2, 3) + hw).astype(np.float32)
    got = tv.resize_bilinear_ac(torch.from_numpy(x), size).numpy()
    want = np.asarray(jv.resize_bilinear_ac(
        jnp.asarray(x.transpose(0, 2, 3, 1)), size)).transpose(0, 3, 1, 2)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_pose_decoding_and_unprojection_match_jax():
    enc = RNG.normal(size=(4, 9)).astype(np.float32)
    enc[:, 7:] = np.abs(enc[:, 7:])
    enc[0, 7] = 0.0                       # a ReLU'd fov of 0: the clamp
    e_t, k_t = tv.pose_encoding_to_extri_intri(torch.from_numpy(enc),
                                               (28, 42))
    e_j, k_j = jv.pose_encoding_to_extri_intri(jnp.asarray(enc), (28, 42))
    np.testing.assert_allclose(e_t.numpy(), np.asarray(e_j), atol=1e-6)
    np.testing.assert_allclose(k_t.numpy(), np.asarray(k_j), rtol=1e-6)
    assert np.isfinite(k_t.numpy()).all()
    depth = RNG.uniform(0.5, 3.0, (4, 6, 8)).astype(np.float32)
    k = np.array(k_j)
    k[0] = [[20.0, 0, 4], [0, 20.0, 3], [0, 0, 1]]   # the clamped row aside
    got = tv.unproject_depth_to_points(torch.from_numpy(depth), e_t,
                                       torch.from_numpy(k)).numpy()
    want = np.asarray(jv.unproject_depth_to_points(
        jnp.asarray(depth), e_j, jnp.asarray(k)))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-5)


def test_model_matches_jax():
    tm, params = pair(J_TINY, seed=1)
    imgs = RNG.uniform(0, 1, (1, 3, 3, 28, 42)).astype(np.float32)
    with torch.no_grad():
        got = tm(torch.from_numpy(imgs))
    want = jit_apply(J_TINY, params, jnp.asarray(imgs))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **MODEL_TOL)


def test_track_head_matches_jax():
    tm, params = pair(J_TRACK, seed=2, include_track=True)
    imgs = RNG.uniform(0, 1, (1, 3, 3, 28, 42)).astype(np.float32)
    qp = np.array([[[5.0, 6.0], [10.5, 12.0], [30.0, 20.0]]], np.float32)
    with torch.no_grad():
        got = tm(torch.from_numpy(imgs), torch.from_numpy(qp))
    want = jit_apply(J_TRACK, params, jnp.asarray(imgs), jnp.asarray(qp))
    np.testing.assert_allclose(got["track"].numpy(),
                               np.asarray(want["track"]), atol=2e-3,
                               rtol=1e-3)
    for k in ("vis", "conf", "depth", "pose_enc"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **MODEL_TOL)
    # frame 0 is pinned to the query points (base_track_predictor :186)
    np.testing.assert_allclose(got["track"][0, 0].numpy(), qp[0], atol=1e-5)


def test_dpt_frame_chunks_equal_one_pass(monkeypatch):
    tm, _ = pair(J_TINY, seed=3)
    imgs = torch.from_numpy(RNG.uniform(0, 1, (1, 5, 3, 28, 28)).astype(
        np.float32))
    with torch.no_grad():
        monkeypatch.setattr(tv, "FRAMES_CHUNK", 2)
        a = tm(imgs)
        monkeypatch.setattr(tv, "FRAMES_CHUNK", 5)
        b = tm(imgs)
    for k in a:
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), atol=1e-6,
                                   rtol=1e-5, err_msg=k)


def test_mirror_state_dict_loads_and_converts_back():
    torch.manual_seed(0)
    mirror = VGGTMirror(MIRROR_CFG).eval()
    sd = mirror.state_dict()
    tm = tv.VGGT(port_cfg(J_TINY), device="cpu").eval()
    tm.load_state_dict(sd, strict=True)
    imgs = torch.from_numpy(RNG.uniform(0, 1, (1, 2, 3, 28, 28)).astype(
        np.float32))
    with torch.no_grad():
        ref, got = mirror(imgs), tm(imgs)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(),
                                   atol=1e-5, err_msg=k)
    sdn = {k: v.numpy() for k, v in sd.items()}
    back = convert.vggt_from_numpy(convert_vggt(sdn), device="cpu")
    assert back.keys() == sd.keys()
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), sdn[k], err_msg=k)


def test_track_mirror_state_dict_loads_and_converts_back():
    torch.manual_seed(3)
    mirror = TrackHeadMirror(dim_in=64, patch=14, layers=(0, 0, 1, 1),
                             oc=(16, 16, 16, 16), f=8, hidden=16, depth=2,
                             levels=2, radius=1, iters=2, heads=2,
                             n_virtual=3).eval()
    cfg = port_cfg(J_TINY, enable_point_head=False, enable_depth_head=False,
                   enable_track_head=True, dpt_features=8, track_features=8,
                   track_iters=2, track_corr_levels=2, track_corr_radius=1,
                   track_depth=2, track_hidden=16, track_virtual=3,
                   track_num_heads=2)
    head = tv.VGGT(cfg, device="cpu").track_head.eval()
    head.load_state_dict(mirror.state_dict(), strict=True)
    sdn = {f"track_head.{k}": v.numpy()
           for k, v in mirror.state_dict().items()}
    back = convert.vggt_from_numpy({"track_head": _vggt_track_head(sdn)},
                                   device="cpu")
    assert back.keys() == sdn.keys()
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), sdn[k], err_msg=k)
