"""Run one cell of the benchmark once and print its result line.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Everything the cell needs is found by name from ``BENCHMARK.json``: the
configuration's file (which names its driver under
``benchmark/drivers/``), the traffic mix ``benchmark/traffic/<name>.json``,
the check's limits ``benchmark/limits/<cell>.json`` and one reader per
metric ``benchmark/metrics/<metric>.py``. Set-up (inputs, weights, warm
steps) runs first; then a window of ``--seconds`` (``--trace 0``, the
end-to-end metrics) or a traced window of the traffic's ``traced_units``
(``--trace 1``, the per-layer metrics). Once the window has closed the
peak memory is read, the program's state is freed and the plain reference
checks what the window produced. The last line of standard output is one
JSON object; the checks' numbers and limits end standard error.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "langscenex_tpu")


def cache_dirs() -> None:
    """Build and kernel caches inside the checkout, at fixed paths."""
    build = ROOT / "build"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(build / sub)
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> list:
    """Top-level names in sys.modules that the port must not load, compared
    whole."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


class Context:
    """What a metric's reader reads."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def judge(limits: dict, readings: dict) -> tuple:
    """(correct, {number: {value, limit}}): every number at or under its
    limit."""
    checks = {name: dict(value=readings[name], limit=lim["limit"])
              for name, lim in limits["checks"].items()}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    return correct, checks


def run_cell(args, device: str = "cuda:0", require_card: bool = True,
             fault=None, strict=None) -> dict:
    """Set-up, window, check. Returns the result object, or raises.
    ``fault`` (the name of one the driver can plant in the program's timed
    path) serves the check's own tests. A metric that BENCHMARK.json lists
    for the cell and that reads nothing ends the run with an error on the
    card (``strict`` None), or wherever ``strict`` is true."""
    import torch
    from benchmark.harness import manifest

    m = manifest.load()
    wl = manifest.workload(m, args.workload)
    config = manifest.config_of(m, wl)
    traffic = manifest.traffic_of(wl)
    limits = manifest.limits_of(wl)
    drv_mod = manifest.driver(config)
    if require_card:
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device: this benchmark measures the "
                             "card")
        if torch.cuda.device_count() < wl["chips"]:
            raise SystemExit(f"{wl['name']} asks for {wl['chips']} cards, "
                             f"{torch.cuda.device_count()} present")
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.set_device(dev)
        torch.empty(0, device=dev)              # the context, before stats
        torch.cuda.reset_peak_memory_stats(dev)
    remove = drv_mod.plant(fault) if fault else None
    drv = drv_mod.make(config, traffic, args.seed, dev)
    try:
        drv.setup()

        def clock():
            return time.perf_counter() - T_START
        setup_s = clock()
        window = {}
        tr = None
        if args.trace:
            tr = drv.traced()
        else:
            units = drv.window(args.seconds, clock)
            if on_card:
                torch.cuda.synchronize(dev)
            window = dict(units=units, elapsed_s=clock() - setup_s)
        peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
        found = forbidden_modules()
        if found:
            raise SystemExit(f"modules that must not load are loaded: "
                             f"{found}")
        prog = drv.release()
        if remove is not None:
            remove()
            remove = None
        ref = drv.reference(prog)
        readings = drv.readings(prog, ref)
    finally:
        if remove is not None:
            remove()
        drv.close()
    correct, checks = judge(limits, readings)
    failed = drv.failed()
    ctx = Context(trace=tr, window=window, setup_s=setup_s, peak_bytes=peak,
                  config=config, traffic=traffic, workload=wl, device=dev,
                  records=drv.records)
    kind = "per_layer" if args.trace else "end_to_end"
    metrics, missing = {}, []
    for spec in manifest.metrics_for(m, kind, wl["name"]):
        value = manifest.metric_reader(spec["name"]).read(ctx)
        if value is None:
            missing.append(spec["name"])
        else:
            metrics[spec["name"]] = dict(value=value, unit=spec["unit"])
    if missing and (on_card if strict is None else strict):
        raise SystemExit(f"{wl['name']}: {missing} read nothing, though "
                         f"BENCHMARK.json lists them for this cell (the "
                         f"span or counter each reads recorded nothing in "
                         f"the window)")
    device_info = dict(
        platform="gpu" if on_card else "cpu",
        kind=torch.cuda.get_device_name(dev) if on_card else "cpu",
        count=wl["chips"], memory_peak_bytes=int(peak))
    result = dict(correct=bool(correct),
                  attempted=int(window.get("units", tr.units if tr else 0)),
                  failed=int(failed), metrics=metrics, device=device_info)
    if tr is not None:
        device_info.update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = dict(device_ops=tr.device_ops,
                                   idle_gaps=tr.idle_gaps)
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    args = parse(argv)
    cache_dirs()
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    result = run_cell(args)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
