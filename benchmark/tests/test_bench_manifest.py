"""The manifest and the files it names."""
import json

import pytest

from benchmark.harness import manifest


def test_every_name_finds_its_files():
    m = manifest.load()
    for wl in m["workloads"]:
        config = manifest.config_of(m, wl)
        assert config["name"] == wl["config"]
        assert (manifest.BENCH_DIR / "drivers"
                / f"{config['driver']}.py").exists()
        manifest.driver(config)
        assert set(manifest.traffic_of(wl))
        assert manifest.limits_of(wl)["checks"]
        for kind in ("end_to_end", "per_layer"):
            names = [x["name"] for x in manifest.metrics_for(m, kind,
                                                             wl["name"])]
            assert names, (wl["name"], kind)
            for name in names:
                assert callable(manifest.metric_reader(name).read)
        assert "setup_s" in [x["name"] for x in
                             manifest.metrics_for(m, "end_to_end",
                                                  wl["name"])]


def test_per_layer_metrics_move_a_metric_their_cells_report():
    m = manifest.load()
    for x in m["per_layer"]:
        for wl in x.get("workloads", [w["name"] for w in m["workloads"]]):
            e2e = [y["name"] for y in manifest.metrics_for(m, "end_to_end",
                                                           wl)]
            assert x["moves"] in e2e, (x["name"], wl)


def test_config_files_are_distinct_and_under_paths():
    m = manifest.load()
    files = [c["file"] for c in m["configs"]]
    assert len(set(files)) == len(files)
    for f in files:
        assert any(f.startswith(p + "/") for p in m["paths"])
    assert all(w["chips"] == 1 for w in m["workloads"])


@pytest.mark.parametrize("name", ["a b", "x/y", "", "é", "a,b", "-a",
                                  "n" * 65])
def test_bad_names_are_refused(name):
    with pytest.raises(manifest.ManifestError):
        manifest.check_name(name, "test")


@pytest.mark.parametrize("unit", ["tokens per second", "µs", "",
                                  "u" * 17])
def test_bad_units_are_refused(unit):
    with pytest.raises(manifest.ManifestError):
        manifest.check_unit(unit, "test")


@pytest.mark.parametrize("unit", ["ms", "%", "kernels/iter", "GiB"])
def test_units_of_the_manifest_pass(unit):
    assert manifest.check_unit(unit, "test") == unit


def test_a_bad_name_in_the_manifest_is_refused(tmp_path):
    m = json.loads(manifest.MANIFEST.read_text())
    m["workloads"][0]["name"] = "bad name"
    p = tmp_path / "BENCHMARK.json"
    p.write_text(json.dumps(m))
    with pytest.raises(manifest.ManifestError):
        manifest.load(p)


def perf_md_bounds() -> dict:
    """{metric: bound} from the first table of PERF.md's section 2."""
    text = (manifest.ROOT / "PERF.md").read_text()
    section = text.split("\n## 2.", 1)[1].split("\n## ", 1)[0]
    lines = section.splitlines()
    first = next(i for i, line in enumerate(lines) if line.startswith("|"))
    rows = []
    for line in lines[first:]:
        if not line.startswith("|"):
            break
        rows.append(line)
    head = [c.strip() for c in rows[0].strip("|").split("|")]
    col = head.index("Bound")
    out = {}
    for line in rows[2:]:
        cells = [c.strip() for c in line.strip("|").split("|")]
        out[cells[0].strip("`")] = float(cells[col])
    return out


def test_bounds_are_the_ones_perf_md_gives():
    m = manifest.load()
    written = perf_md_bounds()
    for x in m["end_to_end"]:
        assert written.get(x["name"]) == x["bound"], x["name"]
