"""The benchmark's manifest: ``BENCHMARK.json`` at the checkout's root and
the files it names under ``benchmark/``, found by name.

A workload (cell) names a configuration and a traffic mix. The
configuration's file is the entry of ``configs`` (it names its driver,
``benchmark/drivers/<driver>.py``); the traffic mix is
``benchmark/traffic/<traffic>.json``; the limits of the cell's
comparison are ``benchmark/limits/<workload>.json``; each per-layer
metric is read by ``benchmark/metrics/<metric>.py``. A new cell, traffic
mix, configuration or metric is new files plus entries in
``BENCHMARK.json``: nothing here names one.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
MANIFEST = ROOT / "BENCHMARK.json"

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
E2E_SOURCES = ("device_trace", "host_clock")


class ManifestError(ValueError):
    pass


def check_name(name: str, what: str) -> str:
    if not isinstance(name, str) or not NAME_RE.match(name):
        raise ManifestError(f"{what} {name!r}: a name is 1 to 64 of "
                            f"A-Z a-z 0-9 _ . - and starts with a letter, "
                            f"a digit or _")
    return name


def check_unit(unit: str, what: str) -> str:
    if not isinstance(unit, str) or not UNIT_RE.match(unit):
        raise ManifestError(f"{what}: unit {unit!r} is not 1 to 16 of "
                            f"A-Z a-z 0-9 _ / % . -")
    return unit


def check_line(text: str, what: str) -> str:
    if (not isinstance(text, str) or not 1 <= len(text) <= 200
            or "\n" in text or "\t" in text):
        raise ManifestError(f"{what}: 1 to 200 characters on one line, no "
                            f"tab")
    return text


def load(path: Path = MANIFEST) -> dict:
    """The manifest, checked for the names, units and cross references
    the harness relies on."""
    m = json.loads(Path(path).read_text())
    configs = {check_name(c["name"], "config"): c for c in m["configs"]}
    for c in configs.values():
        for k in c.get("reduced", []):
            check_name(k, f"config {c['name']}: reduced key")
        check_line(c["source"], f"config {c['name']}: source")
    names = set()
    for w in m["workloads"]:
        check_name(w["name"], "workload")
        check_name(w["traffic"], f"workload {w['name']}: traffic")
        check_line(w["why"], f"workload {w['name']}: why")
        if w["config"] not in configs:
            raise ManifestError(f"workload {w['name']}: no config "
                                f"{w['config']!r}")
        if w["chips"] not in (1, 4):
            raise ManifestError(f"workload {w['name']}: chips 1 or 4")
        names.add(w["name"])
    for kind in ("end_to_end", "per_layer"):
        for metric in m[kind]:
            check_name(metric["name"], kind)
            check_unit(metric["unit"], metric["name"])
            if metric["better"] not in ("lower", "higher"):
                raise ManifestError(f"{metric['name']}: better is lower or "
                                    f"higher")
            allowed = E2E_SOURCES if kind == "end_to_end" else SOURCES
            if metric["source"] not in allowed:
                raise ManifestError(f"{metric['name']}: source "
                                    f"{metric['source']!r}")
            for wl in metric.get("workloads", []):
                if wl not in names:
                    raise ManifestError(f"{metric['name']}: no workload "
                                        f"{wl!r}")
    e2e = {x["name"] for x in m["end_to_end"]}
    for metric in m["per_layer"]:
        check_line(metric["layer"], f"{metric['name']}: layer")
        if metric["moves"] not in e2e:
            raise ManifestError(f"{metric['name']}: moves "
                                f"{metric['moves']!r}, not an end-to-end "
                                f"metric")
    return m


def workload(m: dict, name: str) -> dict:
    for w in m["workloads"]:
        if w["name"] == name:
            return w
    raise ManifestError(f"no workload {name!r} in BENCHMARK.json")


def config_of(m: dict, wl: dict) -> dict:
    """The configuration's entry and its file's contents."""
    entry = next(c for c in m["configs"] if c["name"] == wl["config"])
    return json.loads((ROOT / entry["file"]).read_text())


def traffic_of(wl: dict) -> dict:
    return json.loads((BENCH_DIR / "traffic" / f"{wl['traffic']}.json")
                      .read_text())


def limits_of(wl: dict) -> dict:
    return json.loads((BENCH_DIR / "limits" / f"{wl['name']}.json")
                      .read_text())


def metrics_for(m: dict, kind: str, wl_name: str) -> list:
    """The metrics of ``kind`` this workload reports: those that list it,
    and those without a ``workloads`` key."""
    return [x for x in m[kind]
            if wl_name in x.get("workloads", [wl_name])]


def load_module(path: Path, name: str):
    """A module from a file, whatever characters its name holds."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(config: dict):
    return load_module(BENCH_DIR / "drivers" / f"{config['driver']}.py",
                       f"bench_driver_{config['driver']}")


def metric_reader(name: str):
    return load_module(BENCH_DIR / "metrics" / f"{name}.py",
                       "bench_metric_" + name.replace(".", "_")
                       .replace("-", "_"))
