"""The auto-seg models of the PyTorch port vs the JAX package on the CPU,
in f32: each ``jax.image.resize`` site of the SAM models (upscale,
same size, downscale), ``ops/connected`` (components that hit the
iteration cap, NMS with tied scores), the SAM1 encoder and decoder, the
SAM2 encoder, its conditioning and tracking steps and both automatic mask
generators (the JAX models run on the port's seeded weights through the
JAX package's ``convert_sam{1,2}``, and ``sam{1,2}_from_numpy`` gives
those weights back exactly), and the torch mirrors' state_dicts (the
checkpoints' keys) loading into the port strictly.

Tolerances: resizes and the relative-position table to 1e-6 absolute
(and 1e-6 relative for the table; float32 rounding of the same weights); the encoders and decoders to the JAX
package's own mirror bounds (tests/test_sam1.py, tests/test_sam2.py);
connected components, component areas and both NMS keep masks exactly;
the generators' proposals exactly (the same masks in the same order) with
their scores to 1e-5."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_threads import few_torch_threads  # noqa: F401

import test_sam1 as jt1
import test_sam2 as jt2
from langscenex_tpu.models import sam1 as jsam1
from langscenex_tpu.models.sam2 import amg as jamg
from langscenex_tpu.models.sam2 import model as jmodel
from langscenex_tpu.models.sam2.hiera import sine_pos_embed as j_sine
from langscenex_tpu.ops import connected as jconn
from langscenex_tpu.ops.interp import resize_bicubic_torch as j_bicubic
from langscenex_tpu.utils.convert import convert_sam1, convert_sam2
from langscenex_tpu_torch import convert
from langscenex_tpu_torch.models import sam1
from langscenex_tpu_torch.models.sam2 import amg, decoder, hiera, memory, model
from langscenex_tpu_torch.ops import connected, interp


def _cfg(cls, jcfg):
    return cls(**{f.name: getattr(jcfg, f.name)
                  for f in dataclasses.fields(jcfg)})


T_SAM2 = model.SAM2Config(
    hiera=_cfg(hiera.HieraConfig, jt2.TINY.hiera),
    decoder=_cfg(decoder.DecoderConfig, jt2.TINY.decoder),
    memory=_cfg(memory.MemoryConfig, jt2.TINY.memory), image_size=64)
T_SAM1 = _cfg(sam1.SAM1Config, jt1.TINY)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def japply(jm, params, method, *args, **static):
    """``jm.apply(params, *args, **static, method=method)`` jitted (a
    traced program compiles in a fraction of the time eager flax takes
    for its first call)."""
    return jax.jit(lambda p, *a: jm.apply(p, *a, **static, method=method))(
        params, *args)


def sam2_pair(seed: int = 0):
    """The port's tiny SAM2 with seeded random weights (object-score bias
    +2, so float rounding cannot flip the object gate), and the JAX model
    with the same weights through the JAX package's ``convert_sam2``.
    ``sam2_from_numpy`` must give the weights back exactly."""
    tm = model.init_sam2_params(model.SAM2(T_SAM2, device="cpu"), seed)
    with torch.no_grad():
        tm.sam_mask_decoder.pred_obj_score_head.layers[2].bias += 2.0
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    params = jax.tree_util.tree_map(jnp.asarray, convert_sam2(sd))
    back = convert.sam2_from_numpy(_np(params), device="cpu")
    assert back.keys() == sd.keys()
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)
    return jmodel.SAM2(jt2.TINY), params, tm.eval()


@pytest.fixture(scope="module", name="sam2_pair")
def sam2_pair_fixture():
    return sam2_pair()


@pytest.fixture(scope="module")
def sam1_pair():
    """As ``sam2_pair`` for SAM1 (whose JAX converter drops the unused
    ``mask_downscaling`` keys)."""
    tm = sam1.init_sam1_params(sam1.SAM1(T_SAM1, device="cpu"), 1)
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    params = jax.tree_util.tree_map(jnp.asarray, convert_sam1(sd))
    back = convert.sam1_from_numpy(_np(params), device="cpu")
    assert set(sd) - set(back) == {
        k for k in sd if k.startswith("prompt_encoder.mask_downscaling.")}
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)
    return jsam1.SAM1(jt1.TINY), params, tm.eval()


# ------------------------------------------------------------- resizes

@pytest.mark.parametrize("hw,size", [
    ((16, 16), (64, 64)),      # SAM2 low-res masks to the image (x4 up)
    ((64, 64), (16, 16)),      # a prompt mask to low res (x4 down)
    ((20, 20), (20, 20)),      # same size
    ((48, 64), (64, 85)),      # a SAM1 crop to the model frame, up
    ((100, 150), (33, 47)),    # and down, antialiased
])
def test_resize_linear_matches_jax(hw, size):
    x = np.random.default_rng(0).normal(size=(2, 3) + hw).astype(np.float32)
    for aa in (True, False):
        want = jax.image.resize(jnp.asarray(x), (2, 3) + size, "bilinear",
                                antialias=aa)
        got = interp.resize_linear(torch.from_numpy(x), size, aa)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("hw,size", [((4, 4), (8, 8)), ((8, 8), (8, 8)),
                                     ((9, 7), (4, 3)), ((5, 6), (11, 13))])
def test_resize_nearest_matches_jax(hw, size):
    x = np.random.default_rng(1).normal(size=(2,) + hw).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (2,) + size, "nearest")
    got = interp.resize_nearest(torch.from_numpy(x), size)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("hw,size", [((2, 2), (16, 16)), ((7, 7), (7, 7)),
                                     ((7, 7), (5, 4))])
def test_resize_bicubic_matches_jax(hw, size):
    x = np.random.default_rng(2).normal(size=(1, 4) + hw).astype(np.float32)
    want = j_bicubic(jnp.asarray(x.transpose(0, 2, 3, 1)), size)
    got = interp.resize_bicubic_torch(torch.from_numpy(x), size)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(want).transpose(0, 3, 1, 2),
                               atol=1e-6)


@pytest.mark.parametrize("L", [7, 5, 11])
def test_rel_pos_table_matches_jax(L):
    rel = np.random.default_rng(L).normal(size=(L, 8)).astype(np.float32)
    want = jsam1._get_rel_pos(4, 4, jnp.asarray(rel))
    got = sam1.get_rel_pos(4, 4, torch.from_numpy(rel))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)


def test_sine_pos_embed_matches_jax():
    got = hiera.sine_pos_embed(4, 6, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(
        j_sine(4, 6, 32)).transpose(2, 0, 1), atol=1e-6)


# ----------------------------------------------------------- connected

def _blobs(seed, shape=(24, 24)):
    return np.random.default_rng(seed).uniform(size=shape) > 0.55


def test_connected_components_match_jax():
    for seed in range(3):
        m = _blobs(seed)
        want = np.asarray(jconn.connected_components(jnp.asarray(m)))
        got = connected.connected_components(torch.from_numpy(m))
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            connected.component_areas(got).numpy(),
            np.asarray(jconn.component_areas(jnp.asarray(want))))


def test_connected_components_hit_the_cap():
    # a serpentine corridor: labels travel one pixel a pass, so 5 passes
    # leave the far end unlabelled by the minimum, as in the JAX loop
    m = np.zeros((9, 9), bool)
    m[::2] = True
    m[1::4, -1] = True
    m[3::4, 0] = True
    for iters in (5, 7, 256):
        want = np.asarray(jconn.connected_components(jnp.asarray(m), iters))
        got = connected.connected_components(torch.from_numpy(m), iters)
        np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(np.asarray(jconn.connected_components(
        jnp.asarray(m), 5))[m])) > 1


@pytest.mark.parametrize("mode", ["holes", "islands"])
def test_remove_small_regions_matches_jax(mode):
    m = _blobs(5, (20, 20))
    want = jconn.remove_small_regions(jnp.asarray(m), 6, mode)
    got = connected.remove_small_regions(torch.from_numpy(m), 6, mode)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _masks(seed, n=12):
    rng = np.random.default_rng(seed)
    m = np.zeros((n, 16, 16), bool)
    for i in range(n):
        y, x = rng.integers(0, 10, 2)
        h, w = rng.integers(3, 7, 2)
        m[i, y:y + h, x:x + w] = True
    m[3] = m[2]                                # a duplicate
    m[7, 2:4, 2:4] = True                      # one nearly inside another
    return m


def test_overlap_matrices_match_jax():
    m = _masks(0)
    for jf, tf in ((jconn.mask_iou_matrix, connected.mask_iou_matrix),
                   (jconn.mask_inner_matrix, connected.mask_inner_matrix)):
        np.testing.assert_allclose(tf(torch.from_numpy(m)).numpy(),
                                   np.asarray(jf(jnp.asarray(m))), atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mask_nms_with_tied_scores_matches_jax(seed):
    m = _masks(seed)
    scores = np.repeat(np.float32([0.9, 0.5, 0.7]), 4)   # ties
    want = jconn.mask_nms(jnp.asarray(m), jnp.asarray(scores), 0.3, 0.6)
    got = connected.mask_nms(torch.from_numpy(m), torch.from_numpy(scores),
                             0.3, 0.6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("thr", [(0.3, 0.1, 0.2), (0.7, 0.95, 0.5),
                                 (0.05, -1e9, 0.9)])
def test_mask_nms_reference_matches_jax(thr):
    m = _masks(3)
    scores = np.repeat(np.float32([0.4, 0.9, 0.2, 0.6]), 3)
    want = jconn.mask_nms_reference(jnp.asarray(m), jnp.asarray(scores), *thr)
    got = connected.mask_nms_reference(torch.from_numpy(m),
                                       torch.from_numpy(scores), *thr)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------- SAM1

def test_sam1_mirror_loads_strictly():
    from torch_sam1_mirror import SAM1Mirror
    sd = SAM1Mirror(jt1.MIRROR_CFG).state_dict()
    sam1.SAM1(T_SAM1, device="cpu").load_state_dict(sd, strict=True)


def test_sam1_encoder_and_decoder_match_jax(sam1_pair):
    jm, params, tm = sam1_pair
    rng = np.random.default_rng(4)
    img = rng.uniform(0, 1, (1, 3, 64, 64)).astype(np.float32)
    jf = japply(jm, params, jsam1.SAM1.encode_image, jnp.asarray(img))
    with torch.no_grad():
        tf = tm.encode_image(torch.from_numpy(img))
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf).transpose(
        0, 3, 1, 2), atol=2e-4, rtol=1e-3)
    coords = rng.uniform(0, 64, (2, 1, 2)).astype(np.float32)
    labels = np.ones((2, 1), np.int32)
    jmask, jiou = japply(jm, params, jsam1.SAM1.decode_points,
                         jnp.broadcast_to(jf, (2,) + jf.shape[1:]),
                         jnp.asarray(coords), jnp.asarray(labels),
                         multimask_output=True)
    with torch.no_grad():
        tmask, tiou = tm.decode_points(tf.expand(2, -1, -1, -1),
                                       torch.from_numpy(coords),
                                       torch.from_numpy(labels), True)
    np.testing.assert_allclose(tmask.numpy(), np.asarray(jmask), atol=5e-4,
                               rtol=1e-3)
    np.testing.assert_allclose(tiou.numpy(), np.asarray(jiou), atol=5e-4,
                               rtol=1e-3)


def _same_levels(got, want, atol=1e-5):
    assert len(got) == len(want) == 4
    for g_lvl, w_lvl in zip(got, want):
        assert len(g_lvl) == len(w_lvl)
        for g, w in zip(g_lvl, w_lvl):
            np.testing.assert_array_equal(g["segmentation"].numpy(),
                                          w["segmentation"])
            for k in ("predicted_iou", "stability_score"):
                assert abs(g[k] - w[k]) <= atol


@pytest.mark.parametrize("crop_layers,hw", [(0, (48, 64)), (1, (40, 56))])
def test_sam1_amg_matches_jax(sam1_pair, crop_layers, hw):
    jm, params, tm = sam1_pair
    kw = dict(points_per_side=2, points_per_batch=4, pred_iou_thresh=-1e9,
              stability_score_thresh=-1e9, crop_n_layers=crop_layers,
              min_mask_region_area=0, max_proposals=6)
    img = np.random.default_rng(2).uniform(0, 1, (3,) + hw).astype(
        np.float32)
    want = jsam1.SAM1AutomaticMaskGenerator(
        jm, params, jsam1.SAM1AMGConfig(**kw)).generate(img)
    got = sam1.SAM1AutomaticMaskGenerator(
        tm, sam1.SAM1AMGConfig(**kw)).generate(img)
    assert sum(map(len, want)) > 0
    _same_levels(got, want)


# ---------------------------------------------------------------- SAM2

def test_sam2_mirror_loads_strictly():
    from torch_sam2_mirror import SAM2Mirror
    sd = SAM2Mirror(jt2.MIRROR_CFG).state_dict()
    model.SAM2(T_SAM2, device="cpu").load_state_dict(sd, strict=True)


def test_sam2_encoder_matches_jax(sam2_pair):
    jm, params, tm = sam2_pair
    img = np.random.default_rng(7).uniform(0, 1, (1, 3, 64, 64)).astype(
        np.float32)
    out = japply(jm, params, jmodel.SAM2.forward_image, jnp.asarray(img))
    with torch.no_grad():
        got = tm.forward_image(torch.from_numpy(img))
    for lvl in range(3):
        np.testing.assert_allclose(
            got["backbone_fpn"][lvl].numpy(),
            np.asarray(out["backbone_fpn"][lvl]).transpose(0, 3, 1, 2),
            atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(
        got["vision_pos_enc"][-1].numpy(),
        np.asarray(out["vision_pos_enc"][-1]).transpose(2, 0, 1), atol=1e-5)


def test_sam2_cond_and_track_steps_match_jax(sam2_pair):
    """A mask-prompted frame (mask as output + memory encode), then a
    tracked frame conditioned on that memory and its object pointer."""
    jm, params, tm = sam2_pair
    S = jmodel.SAM2
    rng = np.random.default_rng(8)
    img = rng.uniform(0, 1, (1, 3, 64, 64)).astype(np.float32)
    mask = np.zeros((1, 1, 64, 64), np.float32)
    mask[:, :, 16:48, 20:44] = 1.0
    out = japply(jm, params, S.forward_image, jnp.asarray(img))
    fpn, pos = out["backbone_fpn"], out["vision_pos_enc"][-1]
    j_low, j_high, _, _, _, j_ptr, j_obj = japply(
        jm, params, S.use_mask_as_output, fpn[-1], fpn[:2],
        jnp.asarray(mask))
    j_mem = japply(jm, params, S.encode_new_memory, fpn[-1], j_high,
                   is_mask_from_pts=False)
    mem_pos = (np.asarray(j_sine(4, 4, 16)).reshape(1, -1, 16)
               + np.asarray(params["params"]["maskmem_tpos_enc"])[-1]
               .reshape(1, 1, 16))
    memory_ = np.concatenate([np.asarray(j_mem).reshape(1, -1, 16),
                              np.asarray(j_ptr).reshape(1, 2, 16)], 1)
    memory_pos = np.concatenate([mem_pos, np.zeros((1, 2, 16), np.float32)],
                                1)
    j_cond = japply(jm, params, S.condition_features, fpn[-1], pos,
                    jnp.asarray(memory_), jnp.asarray(memory_pos),
                    num_obj_ptr_tokens=2)
    j_out = japply(jm, params, S.forward_sam_heads, j_cond,
                   high_res_features=fpn[:2], multimask_output=True)

    with torch.no_grad():
        o = tm.forward_image(torch.from_numpy(img))
        tf, tpos = o["backbone_fpn"], o["vision_pos_enc"][-1]
        t_low, t_high, _, _, _, t_ptr, t_obj = tm.use_mask_as_output(
            tf[-1], tf[:2], torch.from_numpy(mask))
        t_mem = tm.encode_new_memory(tf[-1], t_high, False)
        t_cond = tm.condition_features(
            tf[-1], tpos, torch.from_numpy(memory_),
            torch.from_numpy(memory_pos), 2)
        t_out = tm.forward_sam_heads(t_cond, high_res_features=tf[:2],
                                     multimask_output=True)
    np.testing.assert_allclose(t_low.numpy(), np.asarray(j_low), atol=2e-3)
    np.testing.assert_array_equal(t_obj.numpy(), np.asarray(j_obj))
    np.testing.assert_allclose(t_ptr.numpy(), np.asarray(j_ptr), atol=2e-4,
                               rtol=1e-3)
    np.testing.assert_allclose(t_mem.numpy(), np.asarray(j_mem).transpose(
        0, 3, 1, 2), atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(t_cond.numpy(), np.asarray(j_cond).transpose(
        0, 3, 1, 2), atol=5e-4, rtol=1e-3)
    for i, tol in ((0, 5e-3), (1, 5e-3), (2, 1e-3), (3, 5e-3), (5, 1e-3),
                   (6, 1e-3)):
        np.testing.assert_allclose(t_out[i].numpy(), np.asarray(j_out[i]),
                                   atol=tol, rtol=1e-3)


def test_sam2_amg_matches_jax(sam2_pair):
    jm, params, tm = sam2_pair
    kw = dict(points_per_side=3, points_per_batch=4, pred_iou_thresh=-1e9,
              stability_score_thresh=-1e9, min_mask_area=0)
    img = np.random.default_rng(3).uniform(0, 1, (3, 64, 64)).astype(
        np.float32)
    want = jamg.AutomaticMaskGenerator(jm, params,
                                       jamg.AMGConfig(**kw)).generate(img)
    got = amg.AutomaticMaskGenerator(tm, amg.AMGConfig(**kw)).generate(img)
    assert sum(map(len, want)) > 0
    _same_levels(got, want)
    np.testing.assert_array_equal(amg.point_grid(5), jamg.point_grid(5))
