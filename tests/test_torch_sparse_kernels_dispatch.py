"""Host side of the sparse-conv tensor-core kernels
(``csrc/stencil_conv.cu``, ``csrc/wgrad_tile.cuh``): what the wrappers of
``ops/column_sparse.py`` tell the kernels (tile and padding by shape), and the
plain versions of the small preparation kernels (positions, row padding and
flags, weight layout and non-zero block bitmap, the hi + lo split), each
against a numpy reckoning, and the route as a whole against the plain stencil.

Tolerances: layouts, flags, positions and bitmaps exact; the route with
float32 values 1e-5 of the output scale (the same products in another order);
``hi + lo`` within 2^-16 of the float32 value (two bfloat16 mantissas).
"""

import itertools

import numpy as np
import pytest
import torch

import chip_smoke
from lyft3d_tpu_torch.ops import column_sparse as tcs
from lyft3d_tpu_torch.ops import subm_conv_kernel as sk

SM_SHARED_BYTES = 233472  # an H100 SM's shared memory; a block may take 232,448
BLOCK_SHARED_BYTES = 232448


def fhd_stencil_shapes():
    """(kzp, N) of the nine stencil launches of the FHD unit middle, as
    ``subm_conv_units_batched`` and ``strided_conv_units_batched`` build them."""
    shapes = []
    for cin, cout, z_out, strided in chip_smoke.FHD_STENCIL_LAYERS:
        if strided:
            kz, n = (2 * z_out + 1) * (cin + 1), z_out * (cout + 1)
        else:
            kz, n = (z_out + 2) * cin, z_out * cout
        shapes.append((tcs._lane_pad(kz), n))
    return shapes


@pytest.mark.parametrize("kzp,n", fhd_stencil_shapes())
def test_stencil_variant_takes_every_fhd_layer_forward_and_backward(kzp, n):
    """The unit middle's forward: the strided layers' 65-68 columns on the
    unit tile, the 128-column layers on the wide tile; every ``d_src`` (kzp
    = 128 or 256 output columns) on the wide tile. Each block owns all its
    columns on 8 warps."""
    fwd = tcs.stencil_mma_variant(kzp, n)
    assert fwd["kp"] == kzp and fwd["n_pad"] % 16 == 0 and n <= fwd["n_pad"] < n + 16
    assert fwd["cols"] >= fwd["n_pad"] and fwd["warps"] == 8 and fwd["queries"] == 128
    assert fwd["route"] == ("wide" if n == 128 else "unit") and fwd["col_tiles"] == 1
    # d_src: the cotangent's N lanes are the contraction, kzp the output width.
    bwd = tcs.stencil_mma_variant(n, kzp)
    assert bwd["kp"] % 64 == 0 and n <= bwd["kp"] < n + 64 and bwd["n_pad"] == kzp
    assert bwd["route"] == "wide" and bwd["cols"] >= kzp and bwd["warps"] == 8
    assert bwd["queries"] == 16 * (8 // bwd["col_warps"]) and bwd["col_tiles"] == 1
    for var in (fwd, bwd):
        if var["route"] == "unit":
            assert var["smem_bytes"] == var["stages"] * (var["queries"] + var["cols"]) * 72 * 2
            assert 2 * (var["smem_bytes"] + 2048) <= SM_SHARED_BYTES
        assert var["smem_bytes"] <= 232448
    wg = tcs.wgrad_mma_variant(kzp, n)
    assert wg["tile"] == (128, 128) and wg["k_tiles"] == kzp // 128 and wg["n_tiles"] == 1


@pytest.mark.parametrize("k,n", [(641, 128), (700, 16), (0, 16), (16, 0), (1000, 1000), (128, 641), (64, 1000)])
def test_stencil_variant_raises_on_shapes_the_kernel_does_not_take(k, n):
    with pytest.raises(ValueError):
        tcs.stencil_mma_variant(k, n)


def column_stencil_shapes():
    """(side, kzp or the contraction, N or the output, nc) of the twelve
    forward and nine ``d_src`` launches of the dense-z column middle at the
    FHD geometry (``chip_smoke.column_stencil_replay``'s layers)."""
    shapes = []
    for cin, cout, z_out, strided in chip_smoke.FHD_COLUMN_LAYERS + chip_smoke.COLUMN_MASK_LAYERS:
        plan = tcs._chunk_plan(cin, z_out, 2 if strided else 1)
        n = plan.z * cout
        shapes.append(("forward", plan.kzp, n, plan.nc))
        if cin > 1:  # the mask convs have no gradient
            shapes.append(("d_src", n, plan.kzp, plan.nc))
    return shapes


@pytest.mark.parametrize("side,k,n,nc", column_stencil_shapes(),
                         ids=[f"{s}-{k}x{n}-nc{c}" for s, k, n, c in column_stencil_shapes()])
def test_stencil_variant_at_every_column_shape(side, k, n, nc):
    """The rule at the column middle's shapes: every launch of more than 256
    lanes or more than 128 columns (128 at one chunk too) takes the wide
    tile, whose warps of a 16-query group own a
    chunk's whole width (one warp a 128 columns, no column tiles) with no
    shared memory; ``d_src`` reads its float32 cotangent as it is (no
    bfloat16 copy: its widths are even). The mask convs (one chunk, at most
    32 columns) and the four forward layers of 64 to 128 columns keep the
    unit tile, whose block owns all their columns too."""
    src_dtype = torch.bfloat16 if side == "forward" else torch.float32
    var = tcs.stencil_mma_variant(k, n, nc, src_dtype)
    assert var["kp"] % 64 == 0 and k <= var["kp"] < k + 64 and n <= var["n_pad"] < n + 16
    assert var["col_tiles"] == 1 and var["cols"] >= var["n_pad"]
    assert var["smem_bytes"] <= BLOCK_SHARED_BYTES
    if var["kp"] <= 256 and (var["n_pad"] < 128 or (var["n_pad"] == 128 and nc > 1)):
        assert side == "forward" and var["route"] == "unit" and var["warps"] == 8 and var["cols"] == 128
        return
    assert var["route"] == "wide" and var["code"] == 1 and not var["prep"]
    assert var["rows_dtype"] == src_dtype and var["stages"] == 0 and var["smem_bytes"] == 0
    col_warps = -(-var["n_pad"] // 128)
    assert var["col_warps"] == col_warps and var["cols"] == 128 * col_warps
    assert var["warps"] == max(1, 8 // col_warps) * col_warps <= 8 and var["queries"] == 16 * (var["warps"] // col_warps)


@pytest.mark.parametrize("kzp,n", fhd_stencil_shapes())
def test_stencil_variant_keeps_the_unit_tile_at_every_unit_shape(kzp, n):
    """The unit middle's nine forward and nine ``d_src`` shapes (one chunk, at
    most 256 lanes and columns): the unit tile keeps the forward outputs of
    fewer than 128 columns (the strided layers), reading bfloat16 rows of
    whole 64-lane slices as they are; the wide tile, measured faster there
    (``tools/stencil_tile_ab.py``), takes the 128-column forwards and every
    ``d_src``, reading the float32 cotangent as it is except a chunk of an
    odd width (65 lanes), which it copies."""
    for k, width, dtype in ((kzp, n, torch.bfloat16), (n, kzp, torch.float32)):
        var = tcs.stencil_mma_variant(k, width, 1, dtype)
        assert var["col_tiles"] == 1 and var["smem_bytes"] <= BLOCK_SHARED_BYTES
        if dtype == torch.bfloat16 and width < 128:
            assert var["route"] == "unit" and var["code"] == 0
            assert var["queries"] == 128 and var["stages"] == 3 and var["prep"] == (var["kp"] != k)
        else:
            assert var["route"] == "wide" and var["code"] == 1 and var["stages"] == 0
            assert var["prep"] == (k % 2 == 1)
            assert var["rows_dtype"] == (torch.bfloat16 if k % 2 else dtype)


@pytest.mark.parametrize("k,n,nc,dtype,prep", [
    (65, 256, 2, torch.float32, True), (66, 256, 3, torch.float32, False), (640, 256, 1, torch.float32, False),
    (640, 640, 1, torch.float32, False), (67, 448, 2, torch.bfloat16, True), (64, 640, 2, torch.bfloat16, False)],
    ids=["65_lanes", "66_lanes", "f32_640_lanes", "f32_640_columns", "bf16_67_lanes", "bf16_640_columns"])
def test_wide_tile_copies_only_rows_it_cannot_read(k, n, nc, dtype, prep):
    """The wide tile reads its rows two lanes at a time: rows whose chunk is
    an even number of lanes are read as they are (float32 rounded to
    bfloat16 as it is read), odd ones (the unit middle's 65-lane strided
    layer) get the padded bfloat16 copy."""
    var = tcs.stencil_mma_variant(k, n, nc, dtype)
    assert var["route"] == "wide" and var["prep"] == prep
    assert var["rows_dtype"] == (torch.bfloat16 if prep else dtype)


@pytest.mark.parametrize("k,n,tile,tiles", [
    (128, 640, (128, 256), (1, 3)), (256, 224, (256, 128), (1, 2)), (256, 112, (128, 128), (2, 1)),
    (256, 448, (256, 128), (1, 4)), (256, 192, (256, 128), (1, 2)), (256, 96, (128, 128), (2, 1)),
    (256, 384, (256, 128), (1, 3)), (256, 128, (128, 128), (2, 1)), (256, 64, (128, 128), (2, 1))])
def test_wgrad_variant_at_every_column_shape(k, n, tile, tiles):
    """``d_wc`` at the column middle's nine shapes: above 128 columns the
    16-warp tiles, a whole 256-lane contraction (the float32 cotangent row
    read once) or 128 x 256 at 128 lanes; up to 128 columns the unit
    middle's 128 x 128 on 8 warps, two blocks an SM."""
    assert tcs.wgrad_mma_variant(k, n) == dict(tile=tile, k_tiles=tiles[0], n_tiles=tiles[1], hit_split=1)
    _, queues, n_tiles = tcs.wgrad_buffers(9, k, n, torch.device("cpu"))
    assert n_tiles == tiles[0] * tiles[1] and queues.numel() == 9 * n_tiles


@pytest.mark.parametrize("c,cout", list(itertools.product((3, 16, 32, 64), (16, 32, 64))))
def test_wgrad_variant_fits_each_rank_gather_shape_without_padding_tiles(c, cout):
    var = tcs.wgrad_mma_variant(c, cout)
    tk, tn = var["tile"]
    assert var["k_tiles"] == var["n_tiles"] == 1 and c <= tk and cout <= tn
    assert (tk, tn) == ((32, 32) if max(c, cout) <= 32 else (64, 64))
    assert var["hit_split"] * (tk // 32) * (tn // (32 if tk == 32 else 64)) == 8  # all eight warps work


def test_wgrad_variant_tiles_large_matrices_and_raises_on_absurd_ones():
    assert tcs.wgrad_mma_variant(256, 68) == dict(tile=(128, 128), k_tiles=2, n_tiles=1, hit_split=1)
    assert tcs.wgrad_mma_variant(300, 100)["k_tiles"] == 3
    # Wider than 128 columns: the column middle's 16-warp tiles, 256 x 128 above 128 lanes.
    assert tcs.wgrad_mma_variant(300, 300) == dict(tile=(256, 128), k_tiles=2, n_tiles=3, hit_split=1)
    with pytest.raises(ValueError):
        tcs.wgrad_mma_variant(0, 4)
    with pytest.raises(ValueError):
        tcs.wgrad_mma_variant(128 * 300, 128 * 300)


@pytest.mark.parametrize("offsets,k,n", [(9, 256, 128), (9, 128, 68), (27, 32, 32), (27, 3, 16), (27, 96, 80)])
def test_wgrad_buffers_are_zeroed_views_sized_by_the_variant(offsets, k, n):
    var = tcs.wgrad_mma_variant(k, n)
    out, queues, tiles = tcs.wgrad_buffers(offsets, k, n, torch.device("cpu"))
    assert tiles == var["k_tiles"] * var["n_tiles"]
    assert out.shape == (offsets, k, n) and out.dtype == torch.float32 and not out.any()
    assert queues.shape == (offsets * tiles,) and queues.dtype == torch.int32 and not queues.any()
    assert queues.data_ptr() == out.data_ptr() + 4 * out.numel()  # one allocation, one memset
    assert sk.wgrad_buffers is tcs.wgrad_buffers  # both callers size the queues by one function


@pytest.mark.parametrize("c,cout", list(itertools.product((3, 4, 5, 16, 32, 64), (16, 32, 64))))
@pytest.mark.parametrize("side", ["forward", "df"])
def test_subm_variant_pads_the_contraction_to_16_lanes(c, cout, side):
    """The rank gather's tensor-core launch at every width of the per-voxel
    middle (3 to 5 point features, 16 to 64 channels), forward and ``df`` (the
    forward with C and Cout exchanged): the contraction padded to 16, not to
    64, one tile of columns, two blocks an SM."""
    k_in, n_out = (c, cout) if side == "forward" else (cout, c)
    var = sk.subm_mma_variant(27, k_in, n_out)
    assert var["kp"] == -(-k_in // 16) * 16 and var["slice"] == var["kp"]
    assert var["pad_rows"] == (k_in % 16 != 0)
    assert var["n_pad"] == var["cols"] == -(-n_out // 16) * 16
    assert var["warps"] == 8 and var["queries"] == 128
    assert var["smem_bytes"] == var["stages"] * (128 + var["cols"]) * (var["slice"] + 8) * 2 + 27 * 128 * 4
    assert 2 * (var["smem_bytes"] + 4096) <= SM_SHARED_BYTES


@pytest.mark.parametrize("k,c,cout", [(28, 16, 16), (27, 257, 16), (27, 16, 300), (0, 16, 16), (27, 0, 16)])
def test_subm_variant_raises_on_shapes_the_kernel_does_not_take(k, c, cout):
    with pytest.raises(ValueError):
        sk.subm_mma_variant(k, c, cout)


def launch_counts():
    return (tcs.KERNEL_LAUNCHES, tcs.DGRAD_KERNEL_LAUNCHES, tcs.WGRAD_KERNEL_LAUNCHES,
            sk.KERNEL_LAUNCHES, sk.DGRAD_KERNEL_LAUNCHES, sk.WGRAD_KERNEL_LAUNCHES)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("b,vs,vq", [(0, 8, 8), (2, 0, 8), (2, 8, 0)])
def test_empty_shapes_raise_in_the_launch_wrappers_and_count_nothing(dtype, b, vs, vq):
    """The kernels take no empty shape: their wrappers raise before anything
    is launched, and a counter moves only where a kernel was launched."""
    before = launch_counts()
    src = torch.zeros(b, vs, 64, dtype=dtype)
    qids, ids = torch.zeros(b, 9, vq, dtype=torch.int32), torch.zeros(b, vs, dtype=torch.int32)
    wc, cot = torch.zeros(9, 64, 16, dtype=dtype), torch.zeros(b, vq, 16)
    for dgrad in (False, True):
        with pytest.raises(ValueError, match="empty"):
            tcs._stencil_conv_cuda(src, qids, ids, wc, 1, dgrad=dgrad)
    with pytest.raises(ValueError, match="empty"):
        tcs._stencil_wgrad_cuda(src, qids, ids, cot, 1, 64, 16)
    ranks, w = torch.zeros(b, 27, vq, dtype=torch.int32), torch.zeros(27, 64, 16, dtype=dtype)
    with pytest.raises(ValueError, match="empty"):
        sk._subm_conv_cuda(src, ranks, w)
    with pytest.raises(ValueError, match="empty"):
        sk._subm_conv_bwd_cuda(src, ranks, w, cot.to(dtype), True, True)
    assert launch_counts() == before


@pytest.mark.parametrize("scale", [1e-6, 1.0, 3e4])
def test_bf16_split_restores_float32_to_two_mantissas(scale):
    x = torch.from_numpy((np.random.RandomState(0).randn(4096) * scale).astype(np.float32))
    hi, lo = tcs.bf16_split(x)
    assert hi.dtype == lo.dtype == torch.bfloat16
    err = (hi.double() + lo.double() - x.double()).abs()
    assert float((err / x.double().abs()).max()) <= 2.0 ** -16
    # Rounding once loses 256 times as much.
    assert float(((hi.double() - x.double()).abs() / x.double().abs()).max()) > 2.0 ** -10


def band_weights(seed, zs, cin, cout, stride, kzp):
    w = torch.from_numpy((np.random.RandomState(seed).randn(27, cin, cout) * 0.3).astype(np.float32))
    zs_out = zs if stride == 1 else zs // 2
    return tcs._unit_band_weights(w, zs_out, zs + (2 if stride == 1 else 1), stride, kzp)


WEIGHT_CASES = {
    "banded_subm": lambda: band_weights(0, 8, 16, 16, 1, 256),
    "banded_strided": lambda: band_weights(1, 8, 17, 17, 2, 256),
    "dense": lambda: torch.from_numpy(np.random.RandomState(2).randn(9, 128, 66).astype(np.float32)),
    "narrow": lambda: torch.from_numpy(np.random.RandomState(3).randn(9, 30, 5).astype(np.float32)),
    # The dense-z column middle's stage-0 band (3 → 16 channels, 40 cells: 640
    # columns, three bitmap tiles) and the d_src of its stage-1 layer (448
    # lanes: 28 bitmap words a tile).
    "banded_columns_wide": lambda: column_band_weights(4, 3, 16, 40),
    "banded_columns_d_src": lambda: column_band_weights(5, 16, 32, 20).transpose(1, 2),
}


def column_band_weights(seed, cin, cout, nz):
    w = torch.from_numpy((np.random.RandomState(seed).randn(9, 3, cin, cout) * 0.3).astype(np.float32))
    return tcs._chunk_weights(w, tcs._chunk_plan(cin, nz, 1), 1)


@pytest.mark.parametrize("case", list(WEIGHT_CASES))
def test_weight_prep_layout_and_block_bitmap_equal_numpy(case):
    wc = WEIGHT_CASES[case]()
    k, n = wc.shape[1:]
    var = tcs.stencil_mma_variant(k, n)
    kp, n_pad = var["kp"], var["n_pad"]
    wt, wmask = tcs.stencil_weight_prep_ref(wc, kp, n_pad)
    # One word a (256-column tile, 16-lane step), at least 16 a tile.
    tiles, msteps = -(-n_pad // 256), max(16, kp // 16)
    assert wt.shape == (9, n_pad, kp) and wt.dtype == torch.bfloat16 and wmask.shape == (9, tiles * msteps)
    assert (tiles, msteps) == ((1, 16) if max(kp, n_pad) <= 256 else (tiles, msteps))
    w = wc.to(torch.bfloat16).float().numpy()
    want_t = np.zeros((9, n_pad, kp), np.float32)
    want_t[:, :n, :k] = w.transpose(0, 2, 1)
    np.testing.assert_array_equal(wt.float().numpy(), want_t)
    want_mask = np.zeros((9, tiles, msteps), np.int64)
    for j, step, tile in itertools.product(range(9), range(kp // 16), range(n_pad // 8)):
        if want_t[j, tile * 8:(tile + 1) * 8, step * 16:(step + 1) * 16].any():
            want_mask[j, tile // 32, step] |= 1 << (tile % 32)
    np.testing.assert_array_equal(wmask.numpy(), want_mask.reshape(9, -1))
    zero_blocks = sum(1 for j, s in itertools.product(range(9), range(kp // 16))
                      for tile in range(n_pad // 8) if not (want_mask[j, tile // 32, s] >> (tile % 32)) & 1)
    if case.startswith("banded"):
        assert zero_blocks > 9 * (kp // 16) * (n_pad // 8) // 2  # most of a band is zeros
    if case == "dense":
        assert zero_blocks == 9 * (kp // 16)  # only the last 8 of the columns padded from 66 to 80


def stencil_inputs(seed, b, vs, vq, nc, k, n, wc=None):
    rng = np.random.RandomState(seed)
    ids = np.stack([np.sort(rng.choice(4 * vs, vs, replace=False)) for _ in range(b)]).astype(np.int32)
    qids = np.where(rng.rand(b, 9, vq) < 0.5, rng.randint(0, 4 * vs, (b, 9, vq)), -1).astype(np.int32)
    for i in range(b):  # half of the queries hit
        pick = rng.rand(9, vq) < 0.5
        qids[i] = np.where(pick, ids[i][rng.randint(0, vs, (9, vq))], qids[i])
    src = rng.randn(b, vs, nc * k).astype(np.float32)
    src[:, ::4] = 0  # zero rows: flagged, their hits become misses
    if wc is None:
        wc = torch.from_numpy((rng.randn(9, k, n) * 0.3).astype(np.float32))
    return torch.from_numpy(src), torch.from_numpy(qids), torch.from_numpy(ids), wc


@pytest.mark.parametrize("flagged", [False, True])
def test_positions_ref_equals_numpy(flagged):
    src, qids, ids, _ = stencil_inputs(5, 2, 40, 33, 1, 8, 4)
    flags = (src != 0).any(-1).to(torch.uint8) if flagged else None
    got = tcs.stencil_positions_ref(qids, ids, flags).numpy()
    want = np.full(qids.shape, -1, np.int32)
    for b, j, q in itertools.product(range(2), range(9), range(33)):
        where = np.nonzero(ids[b].numpy() == qids[b, j, q].item())[0]
        if qids[b, j, q] >= 0 and len(where) and (flags is None or flags[b, where[0]]):
            want[b, j, q] = where[0]
    np.testing.assert_array_equal(got, want)
    assert (want >= 0).any() and (want < 0).any()
    assert tcs.stencil_positions_ref(qids, ids[:, :0]).eq(-1).all()  # no source rows


@pytest.mark.parametrize("nc,k,kp", [(1, 65, 128), (2, 68, 128), (1, 64, 64), (2, 30, 64)])
def test_rows_prep_pads_each_chunk_and_flags_nonzero_rows(nc, k, kp):
    rows = np.random.RandomState(k).randn(2, 9, nc * k).astype(np.float32)
    rows[0, 3] = 0
    rows[1, 5, 1:] = 0  # one non-zero lane keeps the flag
    padded, flags = tcs.stencil_rows_prep_ref(torch.from_numpy(rows), nc, k, kp)
    assert padded.shape == (2, 9, nc * kp) and padded.dtype == torch.bfloat16 and flags.dtype == torch.uint8
    want = np.zeros((2, 9, nc, kp), np.float32)
    want[..., :k] = torch.from_numpy(rows).to(torch.bfloat16).float().numpy().reshape(2, 9, nc, k)
    np.testing.assert_array_equal(padded.float().numpy(), want.reshape(2, 9, nc * kp))
    want_flags = np.ones((2, 9), np.uint8)
    want_flags[0, 3] = 0
    np.testing.assert_array_equal(flags.numpy(), want_flags)


@pytest.mark.parametrize("case,nc", [("banded_subm", 1), ("banded_strided", 1), ("dense", 2), ("narrow", 2)])
def test_mma_route_with_masked_zero_blocks_equals_plain_stencil(case, nc):
    """The route's padding, zero-row flags and skipped zero weight blocks change
    nothing: float32 values through it equal the plain stencil (1e-5), and
    bfloat16 values equal the plain stencil on the rounded inputs."""
    wc = WEIGHT_CASES[case]()
    k, n = wc.shape[1:]
    src, qids, ids, _ = stencil_inputs(11, 2, 50, 37, nc, k, n, wc)
    want = tcs.stencil_conv_ref(src, qids, ids, wc, nc)
    got = tcs.stencil_conv_mma_ref(src, qids, ids, wc, nc, dtype=torch.float32)
    assert got.shape == want.shape == (2, 37, nc * n)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    src16, wc16 = src.to(torch.bfloat16), wc.to(torch.bfloat16)
    want16 = tcs.stencil_conv_ref(src16, qids, ids, wc16, nc)
    got16 = tcs.stencil_conv_mma_ref(src16, qids, ids, wc16, nc)
    assert float((got16 - want16).abs().max()) <= 1e-5 * float(want16.abs().max())
    assert float(want.abs().max()) > 0


@pytest.mark.parametrize("n,kzp", [(65, 128), (66, 256), (68, 256), (128, 256)])
def test_padded_cotangent_route_of_d_src_equals_plain_backward(n, kzp):
    """d_src as the kernels take it (cotangent rows padded from N to whole
    64-lane slices, zero rows dropped, the transposed weights as a strided
    view) equals autograd of the plain forward."""
    dev = torch.device("cpu")
    src, src_ids, q_ids, qids, rev, wc, cot = chip_smoke.stencil_edge_case(2, 60, 50, 1, kzp, n, 0.4, n, dev)
    s = src.clone().requires_grad_(True)
    want, = torch.autograd.grad(tcs.stencil_conv_ref(s, qids, src_ids, wc, 1), (s,), cot)
    got = tcs.stencil_conv_mma_ref(cot, rev, q_ids, wc.transpose(1, 2), 1, dtype=torch.float32)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert float(want.abs().max()) > 0 and tcs.stencil_mma_variant(n, kzp)["kp"] > n - 64


def test_edge_cases_cover_the_shapes_the_kernels_get_wrong_first():
    """The card-side edge list names every shape class, and its generator's
    reverse queries are the true inverse of its queries."""
    cases = chip_smoke.STENCIL_EDGES
    assert {c[5] for c in cases} >= {65, 66, 68, 128, 256} and {c[4] for c in cases} >= {128, 256}
    # The dense-z column middle's wide outputs (and so d_src contractions) at 1-5 chunks.
    assert {c[5] for c in cases} >= {384, 448, 640} and max(c[5] for c in cases if c[3] == 1) == 640
    assert {c[3] for c in cases} == {1, 2, 3, 4, 5} and {"all", "one", "holes"} <= {c[6] for c in cases}
    assert any(c[2] % 128 for c in cases)
    assert {16, 32, 64} <= {c for pair in chip_smoke.SUBM_EDGES for c in pair}
    src, src_ids, q_ids, qids, rev, wc, cot = chip_smoke.stencil_edge_case(
        2, 40, 30, 1, 16, 8, 0.5, 3, torch.device("cpu"))
    pos = tcs.stencil_positions_ref(qids, src_ids)
    back = tcs.stencil_positions_ref(rev, q_ids)
    for b, j in itertools.product(range(2), range(9)):
        for q in range(30):
            if pos[b, j, q] >= 0:
                assert back[b, j, pos[b, j, q]] == q
        assert int((back[b, j] >= 0).sum()) == int((pos[b, j] >= 0).sum())


@pytest.mark.cuda
def test_sparse_kernels_on_card_at_edge_shapes():
    """The tensor-core kernels and their preparation kernels on the card. This
    file imports no JAX, so it also runs where only PyTorch is installed:
    ``python3 -m pytest --noconftest tests/test_torch_sparse_kernels_dispatch.py -m cuda``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs the full check")
    dev = torch.device("cuda")
    # The last three: the dense-z column middle's 640 columns at 2 chunks, and
    # contractions of 640 and 448 lanes (its d_src): the wide tile.
    for nc, k, n in ((2, 128, 68), (1, 30, 65), (1, 256, 256), (1, 65, 128), (2, 128, 640), (1, 640, 256),
                     (3, 448, 128)):
        src, qids, ids, wc = (a.to(dev) for a in stencil_inputs(k + n, 2, 300, 260, nc, k, n))
        var = tcs.stencil_mma_variant(k, n)
        rows, flags = tcs._rows_prep_cuda(src, nc, k, var["kp"])
        want_rows, want_flags = tcs.stencil_rows_prep_ref(src, nc, k, var["kp"])
        assert torch.equal(rows, want_rows) and torch.equal(flags, want_flags)
        assert torch.equal(tcs._rows_prep_cuda(src, nc, k, var["kp"], want_rows=False)[1], want_flags)
        assert torch.equal(tcs._positions_cuda(qids, ids, flags), tcs.stencil_positions_ref(qids, ids, flags))
        wc16 = wc.to(torch.bfloat16)
        for w in (wc16, wc16.transpose(1, 2).contiguous().transpose(1, 2)):  # both stride orders
            wt, wmask = tcs._weight_prep_cuda(w, var["kp"], var["n_pad"])
            want_wt, want_mask = tcs.stencil_weight_prep_ref(wc16, var["kp"], var["n_pad"])
            steps = var["kp"] // 16
            assert torch.equal(wt, want_wt)
            words = (wmask.long() & 0xFFFFFFFF).reshape(9, -(-var["n_pad"] // 256), -1)
            assert torch.equal(words[..., :steps], want_mask.reshape(words.shape)[..., :steps])
        got = tcs.stencil_conv_batched(src.to(torch.bfloat16), qids, ids, wc16, nc)
        want = tcs.stencil_conv_ref(src.to(torch.bfloat16), qids, ids, wc16, nc)
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    with pytest.raises(ValueError):  # a contraction above 640 lanes
        tcs.stencil_conv_batched(torch.zeros(1, 8, 700, device=dev, dtype=torch.bfloat16),
                                 torch.zeros(1, 9, 8, device=dev, dtype=torch.int32),
                                 torch.arange(8, device=dev, dtype=torch.int32)[None],
                                 torch.zeros(9, 700, 8, device=dev), 1)
    # Each call of a wrapper is one launch on its own counter; an empty shape
    # raises and counts nothing.
    src, qids, ids, wc = (a.to(dev) for a in stencil_inputs(7, 2, 300, 260, 1, 128, 68))
    cot = torch.randn(2, 260, 68, device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        before = launch_counts()
        tcs._stencil_conv_cuda(src.to(dtype), qids, ids, wc.to(dtype), 1)
        assert launch_counts() == (before[0] + 1, *before[1:])
        tcs._stencil_wgrad_cuda(src.to(dtype), qids, ids, cot, 1, 128, 68)
        assert launch_counts() == (before[0] + 1, before[1], before[2] + 1, *before[3:])
        with pytest.raises(ValueError, match="empty"):
            tcs._stencil_conv_cuda(src.to(dtype)[:, :0], qids, ids[:, :0], wc.to(dtype), 1)
        with pytest.raises(ValueError, match="empty"):
            tcs._stencil_wgrad_cuda(src.to(dtype), qids[..., :0], ids, cot[:, :0], 1, 128, 68)
        assert launch_counts() == (before[0] + 1, before[1], before[2] + 1, *before[3:])
    # The rank gather: the forward and df (the forward kernel on the reverse
    # ranks) are one launch each on their own counters, dW on its own.
    ranks = chip_smoke.subm_edge_table("random", 2, 500, seed=1).to(dev)
    f, g = torch.randn(2, 500, 16, device=dev), torch.randn(2, 500, 32, device=dev)
    w = torch.randn(27, 16, 32, device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        before = launch_counts()
        sk._subm_conv_cuda(f.to(dtype), ranks, w.to(dtype))
        assert launch_counts() == (*before[:3], before[3] + 1, *before[4:])
        sk._subm_conv_bwd_cuda(f.to(dtype), ranks, w.to(dtype), g.to(dtype), True, False)
        assert launch_counts() == (*before[:3], before[3] + 1, before[4] + 1, before[5])
        sk._subm_conv_bwd_cuda(f.to(dtype), ranks, w.to(dtype), g.to(dtype), False, True)
        assert launch_counts() == (*before[:3], before[3] + 1, before[4] + 1, before[5] + 1)
    chip_smoke.subm_contract_flag(dev)
    assert chip_smoke.stencil_edge_checks(dev) <= 1.0
    assert chip_smoke.subm_edge_checks(dev) <= 1.0
