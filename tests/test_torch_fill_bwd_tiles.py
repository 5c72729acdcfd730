"""CPU emulation of the fill's kernels in ``csrc/dense_fill.cu``.

The backward's warp kernel (``fill_bwd_warp_kernel``) is emulated warp by
warp: one coalesced load of 32 rows' ids, each lane's chunk of a row found by
a shuffle from the lane that holds the row's id, all of a lane's loads
issued before its stores. The emulation must rebuild the plain backward,
``fill_rows_by_id_bwd_ref``, exactly and write every 16-byte chunk of the
output exactly once, at the path shapes and at the edges a tiled gather gets
wrong first; the lane kernel, element by element, likewise at the rows the
rule gives it. The forward kernel's window search (rounds of 256 parallel
probes, both ends of a tile's window in the same rounds) is emulated
against ``searchsorted``, its tiles' run table (where
each canvas row's ids start and end in the window) must rebuild the plain
scatter, and its tiles must cover every canvas row once. The launch rules
are checked, and the plain backward against the JAX package's gradient."""

import runpy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lyft3d_tpu.ops import dense_fill as jfill
from lyft3d_tpu_torch.ops import dense_fill

THREADS = 256  # the forward kernel's block
WARP_LOADS = 8  # kWarpLoads: 16-byte loads a lane issues before its stores


def emulate_warp(g, ids, num_rows):
    """The warp kernel's warps on the CPU. Returns (gf, stores of each
    16-byte chunk of the output)."""
    b, v = ids.shape
    c = g.shape[-1]
    per = 16 // g.element_size()  # elements a chunk
    assert c % per == 0
    chunks = c // per
    src = g.reshape(b, num_rows, chunks, per)
    gf = torch.full((b, v, chunks, per), float("nan"), dtype=g.dtype)
    stores = torch.zeros(b, v, chunks, dtype=torch.int64)
    lanes = torch.arange(32)
    items = 32 * chunks
    for bb in range(b):
        for row0 in range(0, v, 32):
            # One coalesced load: lane l holds the id of row row0 + l (the
            # sentinel past the sample's end).
            mine = torch.full((32,), num_rows, dtype=torch.int64)
            mine[:min(32, v - row0)] = ids[bb, row0:row0 + 32].long()
            for base in range(0, items, 32 * WARP_LOADS):
                buf = []
                for u in range(WARP_LOADS):  # every load before any store
                    item = base + u * 32 + lanes
                    r = torch.clamp(item // chunks, max=31)  # the shuffle's source lane
                    rid = mine[r]
                    hit = (item < items) & (rid >= 0) & (rid < num_rows)
                    got = torch.zeros(32, per, dtype=g.dtype)
                    got[hit] = src[bb, rid[hit], (item - r * chunks)[hit]]
                    buf.append(got)
                for u in range(WARP_LOADS):
                    item = base + u * 32 + lanes
                    keep = (item < items) & (row0 + item // chunks < v)
                    rows, cols = row0 + item[keep] // chunks, item[keep] % chunks
                    gf[bb, rows, cols] = buf[u][keep]
                    stores[bb, rows, cols] += 1
    return gf.reshape(b, v, c), stores


def sorted_ids(rng, b, v, rows, sentinel_tail=0.1):
    ids = np.stack([np.sort(rng.choice(rows, v, replace=False)) for _ in range(b)])
    ids[:, v - int(v * sentinel_tail):] = rows
    return torch.from_numpy(ids.astype(np.int32))


# (what, B, V, C, rows, dtype): the path shapes cut in V, and the edges.
CASES = [
    ("pillars-like", 2, 2500, 64, 24601, torch.bfloat16),
    ("dense BEV-like", 4, 819, 64, 30752, torch.bfloat16),
    ("V no multiple of a warp", 3, 1001, 64, 20000, torch.bfloat16),
    ("V under a warp", 2, 20, 64, 1000, torch.bfloat16),
    ("an all-sentinel sample", 3, 700, 64, 5000, torch.bfloat16),
    ("duplicate ids", 2, 4000, 64, 300, torch.bfloat16),
    ("float32 rows of 256 B", 2, 3000, 64, 20000, torch.float32),
    ("rows of 16 B, bf16", 2, 3000, 8, 20000, torch.bfloat16),
    ("rows of 16 B, f32", 2, 3001, 4, 20000, torch.float32),
    ("rows of 48 B", 2, 999, 24, 4000, torch.bfloat16),
    ("rows of 2048 B", 2, 70, 512, 400, torch.float32),
    ("one row", 1, 1, 64, 10, torch.bfloat16),
]


def case_inputs(what, b, v, c, rows, dtype, seed=0):
    rng = np.random.RandomState(seed)
    if what == "duplicate ids":
        ids = torch.from_numpy(rng.randint(0, rows + 1, (b, v)).astype(np.int32))
    else:
        ids = sorted_ids(rng, b, v, rows, sentinel_tail=0.0 if v < 10 else 0.1)
    if what == "an all-sentinel sample":
        ids[1] = rows
    g = torch.from_numpy(rng.randn(b, rows, c).astype(np.float32)).to(dtype)
    return g, ids


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_warps_rebuild_the_plain_backward(case):
    what, b, v, c, rows, dtype = case
    g, ids = case_inputs(*case)
    assert dense_fill._fill_bwd_kernel(c, dtype) == "warp"
    got, stores = emulate_warp(g, ids, rows)
    assert torch.equal(stores, torch.ones_like(stores))  # every chunk written exactly once
    assert torch.equal(got, dense_fill.fill_rows_by_id_bwd_ref(g, ids, rows))


@pytest.mark.parametrize("c,dtype,kernel", [
    (64, torch.bfloat16, "warp"), (64, torch.float32, "warp"), (8, torch.bfloat16, "warp"),
    (4, torch.float32, "warp"), (24, torch.bfloat16, "warp"), (512, torch.float32, "warp"),
    (4, torch.bfloat16, "lanes"), (5, torch.float32, "lanes"), (3, torch.float32, "lanes"),
    (12, torch.bfloat16, "lanes"), (513, torch.float32, "lanes"), (1032, torch.bfloat16, "warp"),
    (1, torch.bfloat16, "lanes"),
])
def test_rule_takes_the_warp_kernel_for_16_byte_rows(c, dtype, kernel):
    assert dense_fill._fill_bwd_kernel(c, dtype) == kernel
    assert dense_fill._fill_bwd_kernel(c, dtype, aligned=False) == "lanes"


def emulate_lanes(g, ids, num_rows):
    """The lane kernel (``dense_fill_bwd_kernel``) on the CPU: ``lanes``
    threads (a power of two, at most 32, at least the row's elements when
    those are fewer) copy a row element by element, lane l the elements l,
    l + lanes, ... Returns (gf, stores of each element)."""
    b, v = ids.shape
    c = g.shape[-1]
    lanes = 1
    while lanes < 32 and lanes < c:
        lanes *= 2
    flat = ids.reshape(-1).long()
    sample = torch.arange(b * v) // v
    hit = (flat >= 0) & (flat < num_rows)
    gf = torch.full((b * v, c), float("nan"), dtype=g.dtype)
    stores = torch.zeros(b * v, c, dtype=torch.int64)
    for lane in range(min(lanes, c)):  # lanes past the row's end copy nothing
        cols = torch.arange(lane, c, lanes)
        src = g[sample, torch.where(hit, flat, 0)][:, cols]
        gf[:, cols] = torch.where(hit[:, None], src, torch.zeros((), dtype=g.dtype))
        stores[:, cols] += 1
    return gf.reshape(b, v, c), stores.reshape(b, v, c)


# (what, B, V, C, rows, dtype, aligned) of the rows the rule gives the lane kernel.
LANE_CASES = [
    ("8-byte rows (FHD units)", 4, 6000, 4, 60000, torch.bfloat16, True),
    ("20-byte rows", 4, 6000, 5, 60000, torch.float32, True),
    ("rows wider than a warp", 2, 300, 33, 1000, torch.float32, True),
    ("duplicate ids", 2, 400, 3, 30, torch.bfloat16, True),
    ("one element a row", 1, 5, 1, 10, torch.bfloat16, True),
    ("128-byte rows, unaligned", 2, 500, 64, 3000, torch.bfloat16, False),
]


@pytest.mark.parametrize("case", LANE_CASES, ids=[c[0] for c in LANE_CASES])
def test_lanes_rebuild_the_plain_backward(case):
    what, b, v, c, rows, dtype, aligned = case
    g, ids = case_inputs(what, b, v, c, rows, dtype)
    assert dense_fill._fill_bwd_kernel(c, dtype, aligned) == "lanes"
    got, stores = emulate_lanes(g, ids, rows)
    assert torch.equal(stores, torch.ones_like(stores))  # every element written exactly once
    assert torch.equal(got, dense_fill.fill_rows_by_id_bwd_ref(g, ids, rows))


@pytest.mark.parametrize("backward", [False, True])
def test_bound_counts_the_rows_read_for_ids_below_num_rows(backward):
    """``chip_smoke.fill_bound``: ids read once, the canvas (forward) or the
    rows (backward) written once, a row read only for an id below
    ``num_rows``, and the backward's duplicate ids reading their cotangent
    row once."""
    fill_bound = runpy.run_path(str(Path(__file__).parents[1] / "chip_smoke.py"),
                                run_name="chip_smoke")["fill_bound"]
    ids = torch.tensor([[1, 1, 2, 5], [0, 5, 5, 5]], dtype=torch.int32)  # 5: the sentinel
    c, size, rows, rate = 8, 2, 5, 3.35e12
    read = 3 if backward else 4  # distinct hit rows (1, 2; 0) or hit feature rows
    written = 2 * 4 if backward else 2 * rows
    ms, by, share = fill_bound(ids, rows, c, size, backward=backward)
    assert by == "bytes" and share == 0.5
    assert ms == pytest.approx(((read + written) * c * size + 4 * 8) / rate * 1e3, rel=1e-12)


def block_lower_bounds(ids, key0, key1):
    """The forward kernel's window search, round by round: for each key still
    open, each of THREADS threads probes the last id of its part of the open
    range, and the count of probes below the key keeps the part where it
    falls; both keys' probes share a round. Returns (positions, rounds)."""
    keys, lo, hi, rounds = (key0, key1), [0, 0], [len(ids), len(ids)], 0
    while lo[0] < hi[0] or lo[1] < hi[1]:
        for i, key in enumerate(keys):
            if lo[i] < hi[i]:
                step = -(-(hi[i] - lo[i]) // THREADS)
                pos = lo[i] + (np.arange(THREADS) + 1) * step - 1
                below = (pos < hi[i]) & (ids[np.minimum(pos, len(ids) - 1)] < key)
                parts = int(below.sum())
                assert below[:parts].all()  # the probes below the key are a prefix
                lo[i] += parts * step
                hi[i] = min(hi[i], lo[i] + step - 1)
        rounds += 1
    return lo, rounds


@pytest.mark.parametrize("v,rows", [(0, 100), (1, 10), (255, 1000), (256, 300), (8192, 307520),
                                    (25000, 246016), (60000, 600000), (65792, 70000), (200000, 400000)])
def test_window_search_equals_searchsorted(v, rows):
    rng = np.random.RandomState(v)
    ids = np.sort(rng.choice(rows + 1, v, replace=True)).astype(np.int64)  # repeats and sentinels
    starts = np.concatenate([[0, rows], rng.randint(0, rows + 1, 200),
                             ids[rng.randint(0, max(v, 1), 20)] if v else []]).astype(np.int64)
    for row0 in starts:
        for tile in (1, 128, 4096):
            (lo, hi), rounds = block_lower_bounds(ids, row0, row0 + tile)
            assert (lo, hi) == tuple(np.searchsorted(ids, [row0, row0 + tile], side="left"))
            assert rounds <= (2 if v <= THREADS * (THREADS + 1) else 3)


def emulate_fill(feats, ids, num_rows, tile):
    """The forward kernel's tiles on the CPU: the window by the block search,
    the run table by the walk, each row the float32 sum of its run."""
    v, c = feats.shape
    ids_np = ids.numpy().astype(np.int64)
    out = torch.full((num_rows, c), float("nan"), dtype=feats.dtype)
    for row0 in range(0, num_rows, tile):
        rows = min(tile, num_rows - row0)
        (lo, hi), _ = block_lower_bounds(ids_np, row0, row0 + rows)
        first, stop = np.full(rows, -1), np.zeros(rows, np.int64)
        for k in range(lo, hi):  # the walk: one thread a window position
            r = ids_np[k] - row0
            if 0 <= r < rows:
                if k == lo or ids_np[k - 1] != ids_np[k]:
                    first[r] = k - lo
                if k == hi - 1 or ids_np[k + 1] != ids_np[k]:
                    stop[r] = k + 1 - lo
        for r in range(rows):
            acc = torch.zeros(c)
            if first[r] >= 0:
                for k in range(lo + first[r], lo + stop[r]):
                    acc += feats[k].float()
            out[row0 + r] = acc.to(feats.dtype)
    return out


@pytest.mark.parametrize("what,v,c,rows,dtype", [
    ("unique ids", 700, 4, 3000, torch.bfloat16),
    ("unique ids", 300, 64, 1000, torch.float32),
    ("duplicate ids", 500, 5, 400, torch.float32),
    ("a long run at a tile's edge", 600, 3, 300, torch.float32),
])
def test_forward_run_table_rebuilds_the_plain_scatter(what, v, c, rows, dtype):
    rng = np.random.RandomState(v)
    if what == "unique ids":
        ids = np.sort(rng.choice(rows, v, replace=False))
        feats = rng.randn(v, c)
    else:  # integer features: every order of summation is exact
        ids = np.sort(rng.randint(0, rows, v))
        if what != "duplicate ids":
            ids = np.sort(np.concatenate([ids[:-40], np.full(40, 127)]))
        feats = rng.randint(-50, 50, (v, c))
    ids[-v // 10:] = rows  # the masked tail
    ids = torch.from_numpy(ids.astype(np.int32))
    feats = torch.from_numpy(feats.astype(np.float32)).to(dtype)
    want = dense_fill.fill_rows_by_id_scatter(feats, ids, ids < rows, rows)
    assert torch.equal(emulate_fill(feats, ids, rows, tile=128), want)


@pytest.mark.parametrize("c,size", [(64, 2), (64, 4), (4, 2), (5, 4), (3, 4), (1, 2), (256, 4)])
def test_forward_tiles_cover_the_canvas_once(c, size):
    row_bytes = c * size
    tile = dense_fill._fill_tile_rows(row_bytes)
    assert tile & (tile - 1) == 0 and 128 <= tile <= 4096 and 2 * tile * 4 <= 48 * 1024
    assert tile * row_bytes <= dense_fill.FILL_TILE_BYTES or tile == 128
    for num_rows in (1, 127, tile, 3 * tile + 5):
        covered = np.zeros(num_rows, np.int64)
        for row0 in range(0, num_rows, tile):
            covered[row0:min(num_rows, row0 + tile)] += 1
        assert (covered == 1).all()


@pytest.mark.parametrize("c,size,ptrs,elems", [
    (64, 2, (0, 512), 8), (4, 2, (0, 0), 4), (5, 4, (0, 0), 1), (6, 2, (0, 0), 2),
    (64, 4, (0, 8), 2), (64, 2, (2, 0), 1), (2, 4, (0, 0), 2), (3, 2, (0, 0), 1),
])
def test_forward_accesses_are_as_wide_as_the_row_allows(c, size, ptrs, elems):
    assert dense_fill._access_elems(c, size, *ptrs) == elems


def test_plain_backward_equals_the_jax_gradient():
    """What the emulated warps rebuild, the plain backward, is the JAX
    package's gradient of its fill on the same ids."""
    g, ids = case_inputs("pillars-like", 2, 700, 16, 3000, torch.float32, seed=3)
    valid = ids < 3000
    feats = np.zeros((2, 700, 16), np.float32)
    _, vjp = jax.vjp(lambda f: jax.vmap(lambda a, i, m: jfill.fill_rows_by_id(
        a, i, m, 3000, assume_sorted=True, method="scatter"))(f, jnp.asarray(ids.numpy()),
                                                              jnp.asarray(valid.numpy())),
        jnp.asarray(feats))
    (want,) = vjp(jnp.asarray(g.numpy()))
    np.testing.assert_array_equal(dense_fill.fill_rows_by_id_bwd_ref(g, ids, 3000).numpy(),
                                  np.asarray(want))
