"""The port's spans and counters (``utils/profiling``) on the CPU: a span
that finds no profiler does nothing at all; under ``torch.profiler`` it
logs its host times on kineto's clock and its parent; a session starts
afresh; the field trainer and the DiT denoise loop log their spans where
the work happens; the kernels' launch counts are the same counters."""
import threading
from collections import Counter

import numpy as np
import pytest
import torch
from test_torch_threads import few_torch_threads  # noqa: F401
from torch.profiler import ProfilerActivity, profile

from langscenex_tpu_torch import _build, convert
from langscenex_tpu_torch.models.cogvideox import pipeline as pl
from langscenex_tpu_torch.models.cogvideox import transformer as tm
from langscenex_tpu_torch.models.cogvideox.scheduler import DDIMScheduler
from langscenex_tpu_torch.ops.rasterize import RasterConfig
from langscenex_tpu_torch.scene.cameras import Camera
from langscenex_tpu_torch.train import field as tfield
from langscenex_tpu_torch.utils import profiling
from langscenex_tpu_torch.utils.config import OptimizationConfig

CPU = [ProfilerActivity.CPU]


def _names():
    return [r.name for r in profiling.records()]


@pytest.fixture(autouse=True)
def _session_ends():
    """Each test's first traced span starts a session of its own: a span
    that finds the profiler off ends the one before."""
    with profiling.span("between.tests"):
        pass


def test_a_span_without_a_profiler_does_nothing(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("called with no profiler recording")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(profiling.time, "time_ns", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(profiling, "SpanRecord", refuse)
    log = profiling.records()
    n = len(log)
    first = profiling.span("a")
    with first:
        with profiling.span("b"):
            pass
    assert profiling.span("c") is first           # one object, reused
    assert profiling.records() is log and len(log) == n


def test_span_times_are_kinetos():
    with profile(activities=CPU) as prof:
        # the process's first record_function takes a while to set up
        with profiling.span("warm"):
            pass
        for i in range(3):
            with profiling.span(f"probe.{i}"):
                torch.ones(256, 256) @ torch.ones(256, 256)
    ours = {r.name: r for r in profiling.records() if r.name != "warm"}
    events = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("probe.")}
    assert sorted(ours) == sorted(events) == ["probe.0", "probe.1",
                                              "probe.2"]
    for name, r in ours.items():
        e = events[name]
        assert abs(r.start_ns - e.start_ns()) < 200_000, name
        assert abs(r.end_ns - e.end_ns()) < 200_000, name
        assert r.start_ns <= r.end_ns
        assert r.device_ms is None                 # no card here


def test_parents_nest_and_sessions_start_afresh():
    with profile(activities=CPU):
        with profiling.span("outer"):
            with profiling.span("inner"):
                profiling.count("probe.counter", 3)
            with profiling.span("sibling"):
                pass
    first = profiling.records()
    by = {r.name: r for r in first}
    assert [r.name for r in first] == ["inner", "sibling", "outer"]
    assert by["inner"].parent is by["outer"]
    assert by["sibling"].parent is by["outer"]
    assert by["outer"].parent is None
    assert profiling.session_counts()["probe.counter"] == 3

    with profiling.span("off"):                    # the profiler is off
        profiling.count("probe.counter", 2)
    with profile(activities=CPU):
        with profiling.span("later"):
            profiling.count("probe.counter")
    assert _names() == ["later"]
    assert profiling.session_counts()["probe.counter"] == 1
    assert profiling.counters["probe.counter"] >= 6
    assert [r.name for r in first] == ["inner", "sibling", "outer"]


def test_device_trace_starts_a_session(tmp_path):
    with profile(activities=CPU):
        with profiling.span("before"):
            pass
    with profiling.device_trace(str(tmp_path)):
        with profiling.span("inside"):
            pass
    assert _names() == ["inside"]


def test_a_span_on_a_thread_with_none_open_takes_the_caller():
    # autograd's engine runs a backward through CUDA tensors on its own
    # thread; the span that calls the backward adopts the spans there
    def worker():
        with profiling.span("engine.side"):
            pass
    with profile(activities=CPU):
        with profiling.span("caller", adopts=True):
            with profiling.span("inner"):
                t = threading.Thread(target=worker)
                t.start()
                t.join()
    by = {r.name: r for r in profiling.records()}
    assert by["engine.side"].parent is by["caller"]
    assert by["inner"].parent is by["caller"]
    assert by["engine.side"].thread != by["caller"].thread


def test_a_span_on_another_thread_has_no_parent_unless_adopted():
    def worker(name):
        with profiling.span(name):
            pass
    with profile(activities=CPU):
        with profiling.span("caller"):
            t = threading.Thread(target=worker, args=("orphan",))
            t.start()
            t.join()
        with profiling.span("adopter", adopts=True):
            pass
        t = threading.Thread(target=worker, args=("after",))
        t.start()
        t.join()
    by = {r.name: r for r in profiling.records()}
    assert by["orphan"].parent is None
    assert by["after"].parent is None         # the adopter has closed


def test_launch_counts_are_the_counters():
    assert set(_build.launch_counts) == set(_build.KERNELS)
    before = _build.launch_counts["blend_forward"]
    profiling.count("blend_forward")
    assert _build.launch_counts["blend_forward"] == before + 1
    _build.launch_counts["sort_pairs"] += 2
    assert profiling.counters["sort_pairs"] >= 2
    _build.reset_launch_counts()
    assert profiling.counters["blend_forward"] == 0
    assert sum(_build.launch_counts.values()) == 0


def test_launch_counts_show_the_kernels_alone():
    profiling.count("probe.other", 5)
    _build.reset_launch_counts()
    assert _build.launch_counts == dict.fromkeys(_build.KERNELS, 0)
    assert profiling.counters["probe.other"] >= 5   # not a launch count
    assert "probe.other" not in dict(_build.launch_counts)
    with pytest.raises(KeyError):
        _build.launch_counts["probe.other"]
    with pytest.raises(KeyError):
        _build.launch_counts["probe.other"] = 1


# ---- the field trainer ------------------------------------------------------

W, H = 64, 32
CAP, N = 96, 80


def _trainer():
    """Two cameras facing a box of splats; the dead slots sit at the
    origin, as a fixed-capacity state keeps them, so every sampled dead
    slot's kNN row ties."""
    rng = np.random.default_rng(0)
    cams = []
    for i in range(2):
        img = rng.uniform(0, 1, (3, H, W)).astype(np.float32)
        cams.append(Camera(
            uid=i, colmap_id=i, R=np.eye(3),
            T=np.array([0.04 * i, 0.0, 0.05 * i]), fovx=1.0, fovy=0.55,
            width=W, height=H, image_name=f"v{i}", image=img,
            nearest_id=[1 - i]))
    d = dict(
        xyz=np.stack([rng.uniform(-1.2, 1.2, CAP), rng.uniform(-0.6, 0.6, CAP),
                      rng.uniform(2, 5, CAP)], -1),
        knn_f=rng.normal(size=(CAP, 6)),
        features_dc=rng.normal(0, 0.5, (CAP, 1, 3)),
        features_rest=rng.normal(0, 0.1, (CAP, 3, 3)),
        scaling=np.log(rng.uniform(0.02, 0.08, (CAP, 3))),
        rotation=rng.normal(size=(CAP, 4)),
        opacity=rng.normal(0, 1, (CAP, 1)),
        language_feature=rng.uniform(-1, 1, (CAP, 3)),
        instance_feature=rng.uniform(-1, 1, (CAP, 3)))
    d = {k: np.asarray(v, np.float32) for k, v in d.items()}
    d["xyz"][N:] = 0.0
    d["alive"] = np.arange(CAP) < N
    return tfield.GaussianFieldTrainer(
        cams, convert.gaussian_state_from_numpy(d, "cpu"),
        OptimizationConfig(), 4.0, sh_degree_max=1,
        rcfg=RasterConfig(tile_w=32, tile_h=32))


STEP_CHILDREN = ("field.render", "field.render_near", "field.loss.image",
                 "field.loss.normal", "field.loss.multiview",
                 "field.loss.lang", "field.loss.knn", "field.backward",
                 "field.optim")


def test_trainer_spans_and_knn_counters():
    tr = _trainer()
    # iterations 1299-1300: image, normal, multi-view and language losses
    # all on; 1300 checks the pair cap
    seen = []
    with profile(activities=CPU):
        tr.train(iterations=1300, first_iteration=1299,
                 callback=lambda it, s, m: seen.append(it))
    assert seen == [1299, 1300]
    recs = profiling.records()
    n = Counter(r.name for r in recs)
    for name in ("field.iter", "field.batch", "field.step") + STEP_CHILDREN:
        assert n[name] == 2, name
    assert n["field.check"] == 1 and n["field.densify"] == 0
    for r in recs:
        if r.name in STEP_CHILDREN:
            assert r.parent.name == "field.step", r
        elif r.name in ("field.step", "field.batch", "field.check"):
            assert r.parent.name == "field.iter", r
        elif r.name == "field.iter":
            assert r.parent is None
        elif r.name == "raster.blend_bwd":
            assert r.parent.name == "field.backward", r
        elif r.name in ("raster.bin", "raster.blend_fwd"):
            assert r.parent.name in ("field.render", "field.render_near"), r
    assert n["raster.blend_bwd"] >= 2 and n["raster.bin"] == 4
    # every slot is sampled (800 > CAP); the dead ones, all at the
    # origin, tie, and no live one does
    counts = profiling.session_counts()
    assert counts["knn.rows"] == 2 * CAP
    assert counts["knn.tie_rows"] == 2 * (CAP - N)


# ---- the DiT denoise loop ---------------------------------------------------

LAYERS, STEPS = 2, 2
# spans of one block, and of one DiT call outside its blocks
PER_BLOCK = {"dit.lnz": 2, "dit.linear": 8, "dit.qk_norm": 2,
             "dit.rope": 1, "dit.attn": 1, "dit.gate": 2}
PER_CALL = {"dit.linear": 5, "dit.call": 1, "dit.guidance": 1}


def test_denoise_loop_spans():
    cfg = tm.TransformerConfig(num_layers=LAYERS, num_heads=2, head_dim=16,
                               in_channels=8, out_channels=4,
                               text_embed_dim=32, time_embed_dim=32)
    torch.manual_seed(0)
    model = tm.CogVideoXTransformer(cfg, device="cpu")
    pcfg = pl.PipelineConfig(num_frames=5, height=32, width=32,
                             num_inference_steps=STEPS, latent_channels=4)
    lat = torch.randn(1, pcfg.latent_frames, 4, pcfg.latent_height,
                      pcfg.latent_width)
    text = torch.randn(1, 8, 32)
    with torch.no_grad(), _build.plain(), profile(activities=CPU):
        pl.denoise_loop(model, lat, torch.zeros_like(lat), text, text,
                        DDIMScheduler(), pcfg)
    recs = profiling.records()
    want = Counter({k: v * LAYERS * STEPS for k, v in PER_BLOCK.items()})
    want.update({k: v * STEPS for k, v in PER_CALL.items()})
    want.update({"dit.step": STEPS, "dit.scheduler": STEPS})
    assert Counter(r.name for r in recs) == want
    for r in recs:
        if r.name in ("dit.call", "dit.guidance", "dit.scheduler"):
            assert r.parent.name == "dit.step", r
        elif r.name in ("dit.attn", "dit.rope", "dit.qk_norm", "dit.lnz",
                        "dit.gate"):
            assert r.parent.name == "dit.call", r
        elif r.name == "dit.step":
            assert r.parent is None


class _OneRank:
    """A mesh of one model rank (the all-reduce is the identity)."""
    n_model = 1

    def reduce_from_model(self, y):
        return y


def test_row_parallel_linear_runs_inside_its_span():
    lin = tm.RowParallelLinear(4, 3, _OneRank())
    with profile(activities=CPU):
        lin(torch.ones(2, 4))
    assert _names() == ["dit.linear"]
