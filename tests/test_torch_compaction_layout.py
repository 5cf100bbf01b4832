"""K3's host-side logic and index arithmetic, on the CPU (the kernel
itself runs only on the card).

``ops/compaction.tile_layout`` places the slots in the kernel's
4,096-slot tiles (``pad``: the key's offset from a 16-byte line, in
slots), ``StatusWords`` owns the kernel's scratch, and
``chip_smoke.compact_bound`` counts the bytes the function needs. A
numpy model of the kernel's indices (each tile's exclusive prefix, its
staged valid pairs and its share of the sentinel tail, which needs no
grand total) is held against ``compact_pairs_plain``."""
from pathlib import Path

import numpy as np
import pytest
import torch

from langscenex_tpu_torch.ops.compaction import (CMP_TILE, MAX_SLOTS,
                                                 StatusWords,
                                                 compact_pairs_plain,
                                                 tile_layout)
from test_torch_threads import few_torch_threads  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent


def test_compact_bound_counts_needed_bytes(monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke
    # the render scene's stream: every key, the valid slots' sids, both
    # outputs
    b = chip_smoke.compact_bound(1_781_824, 519_360, 520_000)
    assert b["terms"] == {"keys": 7_127_296, "valid sids": 2_077_440,
                          "outputs": 4_160_000}
    assert b["bytes"] == 13_364_736
    assert b["bound_ms"] == pytest.approx(13_364_736 / 3.35e12 * 1e3)
    assert b["bound_by"] == "bytes"
    assert chip_smoke.compact_bound(0, 0, 16)["bytes"] == 128


@pytest.mark.parametrize("offset,pad", [(0, 0), (4, 1), (8, 2), (12, 3),
                                        (16, 0), (4100, 1)])
def test_tile_layout_pads_to_the_16_byte_line(offset, pad):
    base = 0x7F00_0000_0000
    assert tile_layout(base + offset, 100)[0] == pad


@pytest.mark.parametrize("n,pad,n_tiles", [
    (0, 0, 1), (1, 3, 1), (CMP_TILE, 0, 1), (CMP_TILE - 3, 3, 1),
    (CMP_TILE - 2, 3, 2), (CMP_TILE + 1, 0, 2), (1_781_824, 0, 436),
    (8_468_736, 0, 2068)])
def test_tile_layout_counts_tiles(n, pad, n_tiles):
    assert tile_layout(0x1000 + 4 * pad, n) == (pad, n_tiles)


def test_tile_layout_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError, match="4-byte aligned"):
        tile_layout(0x1002, 10)
    with pytest.raises(ValueError, match="fewer than"):
        tile_layout(0x1000, MAX_SLOTS)
    assert tile_layout(0x1000, MAX_SLOTS - 1)[1] == MAX_SLOTS // CMP_TILE


def test_status_words_grow_and_are_reused():
    # 4 int64 words (one 32-byte sector) for the ticket and for each tile
    cpu = torch.device("cpu")
    words = StatusWords()
    a = words.get(cpu, 7, 1)
    assert a.dtype == torch.int64 and a.numel() == 8 and not a.any()
    b = words.get(cpu, 7, 3)                  # 16 words: grows
    assert b.numel() == 16 and b.data_ptr() != a.data_ptr()
    assert words.get(cpu, 7, 2) is b          # shorter: reused
    assert words.get(cpu, 7, 3) is b
    c = words.get(cpu, 7, 436)                # the render stream's tiles
    assert c.numel() == 2048 and not c.any()
    assert words.get(cpu, 7, 100) is c
    other = words.get(cpu, 9, 100)            # another stream: its own
    assert other is not c and other.numel() == 512


def _kernel_model(key, sid, sent_min, out_len, fill_key, fill_sid, pad):
    """The kernel's writes in numpy: tile t holds slots [max(0, t T - pad),
    min(n, (t + 1) T - pad)); its valid pairs go to excl_t + rank, those at
    or past out_len dropped; its fill to [excl_t + count_t + n - end_t,
    excl_t + n - start_t) within out_len; slots [n, out_len) are fill.
    Every output slot must be written exactly once."""
    n = key.size
    _, n_tiles = tile_layout(4 * pad, n)
    out_k = np.zeros(out_len, np.int64)
    out_s = np.zeros(out_len, np.int64)
    hits = np.zeros(out_len, np.int64)
    valid = key < sent_min
    excl = 0
    for t in range(n_tiles):
        start = max(0, t * CMP_TILE - pad)
        end = min(n, (t + 1) * CMP_TILE - pad)
        v = np.flatnonzero(valid[start:end]) + start
        pos = excl + np.arange(v.size)
        keep = pos < out_len
        out_k[pos[keep]], out_s[pos[keep]] = key[v[keep]], sid[v[keep]]
        hits[pos[keep]] += 1
        fill = np.arange(excl + v.size + n - end, min(excl + n - start,
                                                      out_len))
        out_k[fill], out_s[fill] = fill_key, fill_sid
        hits[fill] += 1
        excl += v.size
    tail = np.arange(n, out_len)
    out_k[tail], out_s[tail] = fill_key, fill_sid
    hits[tail] += 1
    assert (hits == 1).all()
    return out_k, out_s


@pytest.mark.parametrize("n,n_valid,out_len,pad", [
    (0, 0, 16, 0), (5, 2, 16, 3), (20_000, 0, 8000, 0),
    (20_000, 20_000, 20_000, 1), (30_000, 25_000, 9000, 2),
    (5003, 4000, 9000, 3), (3 * CMP_TILE + 7, 6000, 6500, 0),
    (CMP_TILE - 1, 2000, 3000, 1), (CMP_TILE + 1, 2000, 3000, 3),
    (200_000, 60_000, 131_072, 0)])
def test_kernel_index_model_matches_plain(n, n_valid, out_len, pad):
    rng = np.random.default_rng(n + pad)
    sent = 345 << 22
    key = np.full(n, sent, np.int32)
    key[:n_valid] = rng.integers(0, sent, n_valid)
    key = key[rng.permutation(n)]
    sid = rng.integers(0, 100_000, n).astype(np.int32)
    got = _kernel_model(key, sid, sent, out_len, sent, 100_000, pad)
    ref = compact_pairs_plain(torch.from_numpy(key), torch.from_numpy(sid),
                              sent, out_len, sent, 100_000)
    np.testing.assert_array_equal(got[0], ref[0].numpy())
    np.testing.assert_array_equal(got[1], ref[1].numpy())
