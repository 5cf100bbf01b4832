"""The cells at a small size on the CPU: the plain references agree with
the port, and the check's comparison fails for the control (the reference
in the precision below the configuration's, in the program's place) and
for each fault planted in the program's timed path."""
import pytest

from benchmark import calibrate, run
from benchmark.harness import manifest
from benchmark.tests import tiny

CELLS = ("field-sem-720x480", "trimap-denoise-5b-49x480x720")
SEED = 3000000017


def run_small(workload, trace=0, fault=None, device="cpu", seed=SEED):
    args = run.parse(["--workload", workload, "--seed", str(seed),
                      "--seconds", "0.5", "--trace", str(trace)])
    with tiny.cells():
        return run.run_cell(args, device=device,
                            require_card=device != "cpu", fault=fault)


@pytest.mark.parametrize("workload", CELLS)
def test_port_agrees_with_the_reference(workload):
    r = run_small(workload)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1
    assert set(r["metrics"]) >= {"setup_s"}
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("workload", CELLS)
def test_traced_run_reports_and_checks(workload):
    r = run_small(workload, trace=1)
    assert r["correct"], r["checks"]
    assert r["device"]["window_s"] > 0
    assert "breakdown" in r


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload):
    with tiny.cells():
        c = calibrate.control(workload, SEED, "cpu")
    assert not c["correct"], c["checks"]


def faults(workload):
    m = manifest.load()
    return manifest.driver(manifest.config_of(
        m, manifest.workload(m, workload))).FAULTS


@pytest.mark.parametrize("workload,fault", [
    (c, f) for c in CELLS for f in faults(c)])
def test_planted_fault_is_not_correct(workload, fault):
    r = run_small(workload, fault=fault)
    assert not r["correct"], r["checks"]


def test_a_listed_metric_that_reads_nothing_ends_the_run(monkeypatch):
    reader = manifest.metric_reader

    def silent(name):
        mod = reader(name)
        if name == "field.pairs_per_iter":
            mod.read = lambda ctx: None
        return mod
    monkeypatch.setattr(manifest, "metric_reader", silent)
    args = run.parse(["--workload", CELLS[0], "--seed", str(SEED),
                      "--seconds", "0.5", "--trace", "1"])
    with tiny.cells(), pytest.raises(SystemExit, match="pairs_per_iter"):
        run.run_cell(args, device="cpu", require_card=False, strict=True)


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_port_on_the_card_agrees(workload, card):
    r = run_small(workload, device=card)
    assert r["correct"], r["checks"]
