"""The readers of the program's spans and counters
(``benchmark/harness/spans.py`` and the metrics that use it) on a
synthetic trace and span log, and on the small field cell's traced run
on the CPU with the readers listed."""
import json
from types import SimpleNamespace

import pytest

from benchmark import run
from benchmark.harness import manifest, spans, trace
from benchmark.tests import tiny

# kernels (us): busy 0-10, 12-20 (two overlapping), 25-30, 40-41, 50-60
KERNELS = [("k", 0.0, 10.0), ("k", 12.0, 18.0), ("k", 15.0, 20.0),
           ("k", 25.0, 30.0), ("k", 40.0, 41.0), ("k", 50.0, 60.0)]
# interior gaps: 10-12, 20-25, 30-40, 41-50 (28 us)


# The per-layer entries these readers take in BENCHMARK.json. They are
# not listed there yet: run.py ends a traced run on the card when a listed
# metric reads nothing, and a program older than its span log reads
# nothing here. Once run.py leaves such a metric out of the line, they
# are appended to BENCHMARK.json's per_layer as they stand.
PENDING = [
    dict(name="field.render_ms_per_iter", unit="ms",
         better="lower", source="program_span",
         layer=("forward render (train/field.render_view: preprocess, SH, "
                "binning K3/K4, blend K1)"),
         moves="field_iter_ms",
         workloads=["field-sem-720x480"]),
    dict(name="field.backward_ms_per_iter", unit="ms",
         better="lower", source="program_span",
         layer=("backward (train/field.loss_and_grads: torch.autograd.grad, "
                "blend backward K2)"),
         moves="field_iter_ms",
         workloads=["field-sem-720x480"]),
    dict(name="field.lang_loss_ms_per_iter", unit="ms",
         better="lower", source="program_span",
         layer=("language losses (ops/losses.l1_loss, loss_semantic_group)"),
         moves="field_iter_ms",
         workloads=["field-sem-720x480"]),
    dict(name="field.step_idle_ms_per_iter", unit="ms",
         better="lower", source="program_span",
         layer=("training step, host dispatch (train/field.make_train_step)"),
         moves="field_iter_ms",
         workloads=["field-sem-720x480"]),
    dict(name="field.loop_idle_ms_per_iter", unit="ms",
         better="lower", source="program_span",
         layer=("trainer loop, host dispatch "
                "(train/field.GaussianFieldTrainer.train)"),
         moves="field_iter_ms",
         workloads=["field-sem-720x480"]),
    dict(name="field.knn_tie_rows_per_iter", unit="rows/iter",
         better="lower", source="program_counter",
         layer=("losses (ops/losses.loss_cls_3d, the 3D kNN regulariser)"),
         moves="field_iter_ms",
         workloads=["field-sem-720x480"]),
    dict(name="trimap.qk_norm_ms_per_step", unit="ms",
         better="lower", source="program_span",
         layer=("qk-LayerNorm (models/cogvideox/transformer.JointAttention)"),
         moves="trimap_step_ms",
         workloads=["trimap-denoise-5b-49x480x720"]),
    dict(name="trimap.rope_ms_per_step", unit="ms",
         better="lower", source="program_span",
         layer=("3D RoPE (models/cogvideox/transformer.apply_rope_fused)"),
         moves="trimap_step_ms",
         workloads=["trimap-denoise-5b-49x480x720"]),
]


def span(name, start_us, end_us, device_ms=None):
    return SimpleNamespace(name=name, start_ns=int(start_us * 1e3),
                           end_ns=int(end_us * 1e3), device_ms=device_ms)


# two iterations: the first from 0 to 31 with its step over 5-24, the
# second from 35 to 60 with its step over 44-55; 31-35 is the caller's
LOG = [span("field.step", 5, 24, 1.0), span("field.iter", 0, 31),
       span("field.step", 44, 55, 2.0), span("field.iter", 35, 60)]


def ctx(kernels=KERNELS, units=2):
    return SimpleNamespace(trace=trace.Trace(
        window_s=60e-6, busy_s=0.0, units=units, kernels=list(kernels),
        span_device_ms={}, device_ops=[], idle_gaps=[]))


def reader(name):
    return manifest.metric_reader(name).read


def test_interior_gaps_of_the_union():
    gaps = spans.interior_gaps(KERNELS)
    assert gaps.tolist() == [[10, 12], [20, 25], [30, 40], [41, 50]]
    assert spans.interior_gaps([]).shape == (0, 2)


def test_idle_parts_add_up_to_the_interior_idle():
    split = spans.idle_split(KERNELS, LOG, "field.step", "field.iter")
    # midpoints 11 (step), 22.5 (step), 35 (iter 2, outside its step),
    # 45.5 (step)
    assert split == pytest.approx({"field.step": (2 + 5 + 9) / 1e3,
                                   "field.iter": 10 / 1e3,
                                   "elsewhere": 0.0})
    log = LOG[:3] + [span("field.iter", 36, 60)]   # 35 is now the caller's
    split = spans.idle_split(KERNELS, log, "field.step", "field.iter")
    assert split["elsewhere"] == pytest.approx(10 / 1e3)
    total = (spans.interior_gaps(KERNELS) @ [-1, 1]).sum() / 1e3
    assert sum(split.values()) == pytest.approx(total)


def test_idle_readers(monkeypatch):
    monkeypatch.setattr(spans, "log", lambda: list(LOG))
    assert reader("field.step_idle_ms_per_iter")(ctx()) == \
        pytest.approx(16 / 1e3 / 2)
    assert reader("field.loop_idle_ms_per_iter")(ctx()) == \
        pytest.approx(10 / 1e3 / 2)


def test_span_device_ms_reader(monkeypatch):
    log = LOG + [span("field.render", 6, 9, 0.5),
                 span("field.render", 45, 47, 0.25)]
    monkeypatch.setattr(spans, "log", lambda: log)
    assert reader("field.render_ms_per_iter")(ctx()) == pytest.approx(0.375)


SPAN_READERS = ("field.render_ms_per_iter", "field.backward_ms_per_iter",
                "field.lang_loss_ms_per_iter", "field.step_idle_ms_per_iter",
                "field.loop_idle_ms_per_iter", "trimap.qk_norm_ms_per_step",
                "trimap.rope_ms_per_step")


@pytest.mark.parametrize("name", SPAN_READERS)
def test_a_reader_reads_nothing_without_its_span(monkeypatch, name):
    monkeypatch.setattr(spans, "log", lambda: [span("other", 0, 60, 1.0)])
    assert reader(name)(ctx()) is None


@pytest.mark.parametrize("name", SPAN_READERS + (
    "field.knn_tie_rows_per_iter",))
def test_a_program_without_spans_reads_nothing(monkeypatch, name):
    monkeypatch.setattr(spans, "_profiling", lambda: None)
    assert reader(name)(ctx()) is None


def test_a_span_without_device_time_reads_nothing(monkeypatch):
    monkeypatch.setattr(spans, "log", lambda: [span("dit.rope", 0, 1)])
    assert reader("trimap.rope_ms_per_step")(ctx()) is None


def test_tie_rows_reader(monkeypatch):
    counts = {"knn.rows": 1600, "knn.tie_rows": 461}
    monkeypatch.setattr(spans, "counted", counts.get)
    assert reader("field.knn_tie_rows_per_iter")(ctx()) == 230.5
    counts["knn.rows"] = 0                    # the kNN loss did not run
    assert reader("field.knn_tie_rows_per_iter")(ctx()) is None


def test_pending_entries_pass_the_manifest(tmp_path):
    m = manifest.load()
    assert not {e["name"] for e in PENDING} & \
        {x["name"] for x in m["per_layer"]}
    m["per_layer"] += PENDING
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(m))
    manifest.load(path)
    for e in PENDING:
        assert (manifest.BENCH_DIR / "metrics" / f"{e['name']}.py").exists()


def test_small_field_cell_reads_the_programs_spans(monkeypatch):
    load = manifest.load

    def listed(*a):
        m = load(*a)
        m["per_layer"] += PENDING
        return m
    monkeypatch.setattr(manifest, "load", listed)
    args = run.parse(["--workload", "field-sem-720x480", "--seed",
                      "3000000017", "--seconds", "0.5", "--trace", "1"])
    with tiny.cells():
        r = run.run_cell(args, device="cpu", require_card=False)
    assert r["correct"], r["checks"]
    m = r["metrics"]
    # the small room's dead slots tie in the kNN loss; the CPU runs no
    # kernels, so the idle reads 0, and no span has a device time
    assert m["field.knn_tie_rows_per_iter"]["value"] > 0
    assert m["field.step_idle_ms_per_iter"]["value"] == 0.0
    assert m["field.loop_idle_ms_per_iter"]["value"] == 0.0
    assert "field.render_ms_per_iter" not in m
    names = {s.name for s in spans.log()}
    assert {"field.iter", "field.step", "field.render", "field.backward",
            "field.optim", "field.loss.lang", "field.loss.knn"} <= names
    assert sum(s.name == "field.iter" for s in spans.log()) == \
        r["attempted"]
