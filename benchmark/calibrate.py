"""Readings that the check's limits are set from, in one process.

    python benchmark/calibrate.py --workload <cell> --seeds 1,2,... \
        [--control-seeds a,b,c] [--fault-seeds a,b,c] [--out FILE]

For every seed: the program's set-up and its first window step, then the
plain reference; the numbers the cell's check compares, as a run of
``benchmark/run.py`` computes them (the lower readings). On the control
seeds also the reference in the precision below the configuration's, in
the program's place (the control's readings), and on the fault seeds the
program with each planted fault (the faults' readings; a state left
unchanged reads 1 and is not run). One JSON line per reading.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

CONTROL = {"field_train": "tf32", "dit_denoise": "fp8"}


def seeds(text: str) -> list:
    return [int(x) for x in text.split(",") if x]


def program(mod, config, traffic, seed, dev):
    drv = mod.make(config, traffic, seed, dev)
    try:
        drv.setup()
        drv.window(0.0, time.perf_counter)
        return drv, drv.release()
    finally:
        drv.close()


def control(workload: str, seed: int, device) -> dict:
    """The control of one seed judged by the cell's limits: the reference
    in the precision below the configuration's, in the program's place,
    against the reference."""
    import torch
    from benchmark import run
    from benchmark.harness import manifest
    m = manifest.load()
    wl = manifest.workload(m, workload)
    config = manifest.config_of(m, wl)
    mod = manifest.driver(config)
    drv, prog = program(mod, config, manifest.traffic_of(wl), seed,
                        torch.device(device))
    ref = drv.reference(prog, "f32")
    c = drv.reference(prog, CONTROL[config["driver"]])
    readings = drv.readings(drv.as_program(c), ref)
    correct, checks = run.judge(manifest.limits_of(wl), readings)
    return dict(correct=correct, checks=checks)


def main(argv=None) -> int:
    import torch
    from benchmark.harness import manifest
    from benchmark import run
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--device", default="cuda:0")
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    run.cache_dirs()
    m = manifest.load()
    wl = manifest.workload(m, a.workload)
    config = manifest.config_of(m, wl)
    traffic = manifest.traffic_of(wl)
    mod = manifest.driver(config)
    dev = torch.device(a.device)
    out = open(a.out, "a") if a.out else None

    def emit(seed, kind, readings, seconds):
        line = json.dumps(dict(workload=a.workload, seed=seed, kind=kind,
                               seconds=round(seconds, 3), **readings))
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    every = seeds(a.seeds)
    ctrl, flt = seeds(a.control_seeds), seeds(a.fault_seeds)
    for seed in dict.fromkeys(every + ctrl + flt):
        t0 = time.perf_counter()
        drv, prog = program(mod, config, traffic, seed, dev)
        ref = drv.reference(prog, "f32")
        t1 = time.perf_counter()
        if seed in every:
            emit(seed, "program", drv.readings(prog, ref), t1 - t0)
        if seed in ctrl:
            c = drv.reference(prog, CONTROL[config["driver"]])
            emit(seed, "control", drv.readings(drv.as_program(c), ref),
                 time.perf_counter() - t1)
            del c
        del prog
        for fault in mod.FAULTS if seed in flt else ():
            if fault == "unchanged":
                continue
            t2 = time.perf_counter()
            remove = mod.plant(fault)
            try:
                fdrv, fprog = program(mod, config, traffic, seed, dev)
            finally:
                remove()
            emit(seed, "fault:" + fault, fdrv.readings(fprog, ref),
                 time.perf_counter() - t2)
            del fdrv, fprog
        del drv, ref
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
