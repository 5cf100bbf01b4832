"""The field stage's command line: train / render / eval, port of the JAX
``entry_point.py`` (entry_point.py:21-44: seed 42, logging, the mode
dispatch to FieldConstructionPipeline), with the
configs/field_construction.yaml surface as dotted overrides
(``key.subkey=value``), the grammar of the JAX package's CLI.

Usage:
  python -m langscenex_tpu_torch.entry_point mode=train \\
      pipeline.data_path=demo/data/scene gaussian.opt.iterations=12000

It runs on ``cuda:0`` and raises without a card; ``device=cpu`` (or any
torch device) runs it elsewhere. Beside the JAX grammar, a tuple setting
such as ``gaussian.save_iterations`` takes comma-separated integers
(``gaussian.save_iterations=10,30``).
"""
from __future__ import annotations

import dataclasses
import logging
import random
import sys

import numpy as np
import torch


def setup_seed(seed: int = 42) -> None:
    """entry_point.setup_seed:14: Python, numpy and torch seeded."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def apply_overrides(obj, overrides: dict) -> None:
    """Apply dotted-path overrides onto nested dataclasses in place."""
    for key, val in overrides.items():
        parts = key.split(".")
        target = obj
        for p in parts[:-1]:
            target = getattr(target, p)
        leaf = parts[-1]
        cur = getattr(target, leaf)
        if isinstance(cur, bool):
            val = val.lower() in ("1", "true", "yes")
        elif isinstance(cur, int):
            val = int(val.replace("_", ""))
        elif isinstance(cur, float):
            val = float(val)
        elif isinstance(cur, tuple):
            val = tuple(int(v.replace("_", "")) for v in val.split(",") if v)
        setattr(target, leaf, val)


USAGE = ("usage: python -m langscenex_tpu_torch.entry_point [key=value ...]\n"
         "  mode=train|render|eval   seed=42   device=cuda:0|cpu\n"
         "  pipeline.data_path=...   gaussian.opt.iterations=12000\n"
         "Dotted keys override the typed configs in utils/config.py\n"
         "(the override grammar of the reference's Hydra CLI).")


def run(argv):
    """Parse ``argv`` and run its mode; returns the pipeline (the trainer
    of a train run is its ``trainer``, the mode's result its
    ``result``)."""
    overrides = {}
    for arg in argv:
        if "=" not in arg:
            raise SystemExit(f"arguments must be key=value, got {arg!r}")
        k, v = arg.split("=", 1)
        overrides[k] = v

    mode = overrides.pop("mode", "train")
    seed = int(overrides.pop("seed", "42"))
    device = overrides.pop("device", None)
    setup_seed(seed)

    from .pipeline import FieldConstructionPipeline, PipelinePaths
    from .utils.config import GaussianConfig

    paths = PipelinePaths(data_path=overrides.pop("pipeline.data_path", "."))
    for f in dataclasses.fields(PipelinePaths):
        key = f"pipeline.{f.name}"
        if key in overrides:
            val = overrides.pop(key)
            if isinstance(getattr(paths, f.name), bool):
                val = val.lower() in ("1", "true", "yes")
            setattr(paths, f.name, val)

    gcfg = GaussianConfig()
    apply_overrides(gcfg, {k[len("gaussian."):]: v
                           for k, v in overrides.items()
                           if k.startswith("gaussian.")})
    unknown = [k for k in overrides if not k.startswith("gaussian.")]
    if unknown:
        raise SystemExit(f"unknown overrides: {unknown}")
    if mode not in ("train", "render", "eval"):
        raise SystemExit(f"unknown mode {mode!r} (train|render|eval)")

    pipe = FieldConstructionPipeline(paths, gcfg, device=device)
    if mode == "train":
        pipe.preprocess()
        pipe.result = pipe.construct_field()
    elif mode == "render":
        pipe.result = pipe.render_result()
    else:
        pipe.result = pipe.eval()
    return pipe


def main(argv=None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    argv = argv if argv is not None else sys.argv[1:]
    if any(a in ("-h", "--help") for a in argv):
        print(USAGE)
        return 0
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
