"""The VGGT cell at a small size on the CPU: the port agrees with the plain
reference, the check fails for the fp8 control and for each planted
fault, a traced run reports every ``vggt.*`` metric BENCHMARK.json lists,
and the operation counts match hand counts."""
import contextlib

import pytest

from benchmark import calibrate, run
from benchmark.counts import peaks, vggt
from benchmark.drivers import vggt_forward
from benchmark.harness import manifest

CELL = "vggt-pose-1b-49x518"
SEED = 3000000017
SMALL = dict(img_size=56, embed_dim=128, num_heads=2, vit_embed_dim=128,
             vit_num_heads=2, depth=2, vit_depth=2, camera_trunk_depth=1,
             intermediate_layers=[0, 0, 1, 1], dpt_features=32,
             dpt_out_channels=[32, 32, 64, 64], num_frames=3)


@contextlib.contextmanager
def small():
    """The cell's configuration cut to SMALL and its traffic to two
    clips."""
    config_of, traffic_of = manifest.config_of, manifest.traffic_of

    def small_config(m, wl):
        c = config_of(m, wl)
        if wl["name"] == CELL:
            c.update(SMALL)
        return c

    def small_traffic(wl):
        t = traffic_of(wl)
        if wl["name"] == CELL:
            t.update(clips=2)
        return t
    manifest.config_of, manifest.traffic_of = small_config, small_traffic
    try:
        yield
    finally:
        manifest.config_of, manifest.traffic_of = config_of, traffic_of


def run_small(trace=0, fault=None, strict=None):
    args = run.parse(["--workload", CELL, "--seed", str(SEED), "--seconds",
                      "0.2", "--trace", str(trace)])
    with small():
        return run.run_cell(args, device="cpu", require_card=False,
                            fault=fault, strict=strict)


def test_port_agrees_with_the_reference():
    r = run_small()
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1
    assert {"setup_s", "trimap_step_ms"} <= set(r["metrics"])
    assert set(r["checks"]) == {"pose_enc_rel_rms", "depth_rel_rms",
                                "depth_conf_rel_rms", "tokens_rel_rms",
                                "global_block_rel_rms",
                                "ref_fed_block_rel_rms"}


def test_control_is_not_correct(monkeypatch):
    monkeypatch.setitem(calibrate.CONTROL, "vggt_forward", "fp8")
    with small():
        c = calibrate.control(CELL, SEED, "cpu")
    assert not c["correct"], c["checks"]


@pytest.mark.parametrize("fault", vggt_forward.FAULTS)
def test_planted_fault_is_not_correct(fault):
    r = run_small(fault=fault)
    assert not r["correct"], r["checks"]
    if fault == "unchanged":
        for name in ("tokens_rel_rms", "ref_fed_block_rel_rms"):
            assert r["checks"][name]["value"] == pytest.approx(1.0,
                                                               rel=1e-3)
    # each of the two global blocks alone fails the check: the one on the
    # program's input and the one on the reference's
    for name in ("global_block_rel_rms", "ref_fed_block_rel_rms"):
        c = r["checks"][name]
        assert c["value"] > c["limit"], (name, c)


def test_witness_block_takes_the_references_input():
    """The witness block's input is the reference's own forward of clip 0
    up to that block, whatever the program computed."""
    import torch
    from benchmark.inputs import vggt as vggt_inputs
    from benchmark.reference import vggt as vggt_ref
    m = manifest.load()
    wl = manifest.workload(m, CELL)
    with small():
        cfg, traffic = manifest.config_of(m, wl), manifest.traffic_of(wl)
    drv = vggt_forward.make(cfg, traffic, SEED, "cpu")
    drv.setup()
    drv.window(0.0, lambda: 0.0)
    clip = drv.clips[0][None]
    prog = drv.release()
    params = dict(vggt_inputs.weights(cfg, SEED, "cpu"))
    want = vggt_ref.global_input(params, cfg, vggt_forward.WITNESS, clip)
    assert torch.equal(prog["witness_in"], want)
    assert prog["witness_out"].shape == want.shape
    assert not torch.equal(prog["witness_out"], want)


def test_traced_run_reports_every_listed_metric(monkeypatch):
    """On the CPU a span has no device time: each span reads its host
    time here, so that the readers and their span filters are held."""
    from langscenex_tpu_torch.utils import profiling
    monkeypatch.setattr(profiling.SpanRecord, "device_ms", property(
        lambda r: (r.end_ns - r.start_ns) / 1e6))
    r = run_small(trace=1, strict=True)
    assert r["correct"], r["checks"]
    listed = {x["name"] for x in manifest.metrics_for(
        manifest.load(), "per_layer", CELL)}
    assert listed == {"vggt.device_idle_pct", "vggt.step_mfu",
                      "vggt.global_attn_roofline",
                      "vggt.frame_attn_roofline", "vggt.vit_ms_per_forward",
                      "vggt.heads_ms_per_forward"}
    assert set(r["metrics"]) == listed
    assert r["attempted"] == 3


def published() -> dict:
    m = manifest.load()
    return manifest.config_of(m, manifest.workload(m, CELL))


def test_counts_match_the_hand_counts():
    """The hand counts at 49 frames of 518 x 518: 1,374 tokens a frame,
    67,326 in a global block."""
    cfg = published()
    assert vggt.tokens(cfg) == (49, 1374)
    f = vggt.forward_flops(cfg)
    glob = 4 * 16 * 67326 ** 2 * 64
    assert f["global_attn"] == 24 * glob
    assert glob == pytest.approx(1.857e13, rel=1e-3)
    assert peaks.tensor_ms(glob) == pytest.approx(18.77, rel=1e-3)
    # 72 blocks of qkv, out and MLP over 67,326 tokens of 1024
    per_token = 2 * 1024 * (3 * 1024 + 1024 + 2 * 4096)
    assert f["blocks"] == 72 * 67326 * per_token
    assert f["blocks"] == pytest.approx(1.22e14, rel=1e-2)
    frame = 4 * 49 * 16 * 1374 ** 2 * 64
    assert f["frame_attn"] == 48 * frame
    assert peaks.tensor_ms(frame) == pytest.approx(0.38, rel=1e-2)
    assert f["aggregator"] == pytest.approx(5.86e14, rel=1e-3)
    assert f["global_attn"] / f["aggregator"] == pytest.approx(0.76,
                                                               abs=0.005)
    # the heads: about 1.5e13, most of it the DPT's convolutions at 148,
    # 296 and 518 pixels a side
    assert 1.2e13 < f["dpt"] < 1.8e13
    assert f["camera"] < 1e11
    assert f["total"] == f["aggregator"] + f["dpt"] + f["camera"]


def test_dpt_count_by_hand():
    """The depth head at a 2 x 2 patch grid, one frame, 4 channels."""
    cfg = dict(img_size=28, patch_size=14, num_frames=1, embed_dim=2,
               num_register_tokens=0, dpt_features=4,
               dpt_out_channels=[4, 4, 4, 4])
    n = 2 * 4 * 4 * 16                           # projects at 2 x 2
    n += 2 * 4 * 4 * 4 * 16 + 2 * 4 * 4 * 4 * 4  # transposed 4x4 and 2x2
    n += 2 * 1 * 4 * 4 * 9                       # 3x3 s2 -> 1 x 1
    n += 2 * 4 * 4 * 9 * (64 + 16 + 4 + 1)       # layer_rn at 8, 4, 2, 1
    n += 2 * 4 * 4 * 9 * (4 * 64 + 4 * 16 + 4 * 4 + 2 * 1)  # the RCUs
    n += 2 * 4 * 4 * (256 + 64 + 16 + 4)         # out_convs at 16, 8, 4, 2
    n += 2 * 4 * 2 * 9 * 256                     # output_conv1 at 16
    n += 2 * 2 * 32 * 9 * 784 + 2 * 32 * 2 * 784  # output_conv2 at 28
    assert vggt.dpt_flops(cfg) == n
