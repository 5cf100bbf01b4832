"""Small forms of the cells for tests on the CPU: every width of the
configuration is kept where the code allows, the counts of points,
layers, heads, cameras, frames and pixels are cut."""
from __future__ import annotations

import contextlib

from benchmark.harness import manifest

CONFIGS = {
    "lsgs-field-1p5m-720x480": dict(
        points=3000, capacity=4096, cameras=5, width=96, height=64,
        targets={"downsample": 8, "segment_cells": 2, "masked_share": 0.05}),
    "cogvideox-5b-trimap-49x480x720": dict(
        num_layers=6, num_heads=2, text_embed_dim=32, time_embed_dim=32,
        text_len=8, num_frames=5, height=64, width=64),
}
TRAFFIC = {"field-semantic": dict(warm_iterations=5, traced_units=2),
           "dit-denoise-request": dict(traced_units=3, check_within=3)}


@contextlib.contextmanager
def cells():
    """Point the manifest's configuration and traffic readers at the small
    forms."""
    config_of, traffic_of = manifest.config_of, manifest.traffic_of

    def small_config(m, wl):
        c = config_of(m, wl)
        c.update(CONFIGS[c["name"]])
        return c

    def small_traffic(wl):
        t = traffic_of(wl)
        t.update(TRAFFIC[wl["traffic"]])
        return t
    manifest.config_of, manifest.traffic_of = small_config, small_traffic
    try:
        yield
    finally:
        manifest.config_of, manifest.traffic_of = config_of, traffic_of
