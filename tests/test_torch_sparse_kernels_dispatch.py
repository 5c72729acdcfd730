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
    fwd = tcs.stencil_mma_variant(kzp, n)
    assert fwd["kp"] == kzp and fwd["n_pad"] % 16 == 0 and n <= fwd["n_pad"] < n + 16
    assert fwd["cols"] >= fwd["n_pad"] and fwd["warps"] == 8 and fwd["queries"] == 128
    # d_src: the cotangent's N lanes are the contraction, kzp the output width.
    bwd = tcs.stencil_mma_variant(n, kzp)
    assert bwd["kp"] % 64 == 0 and n <= bwd["kp"] < n + 64 and bwd["n_pad"] == kzp
    assert bwd["cols"] >= kzp and bwd["warps"] == (8 if kzp <= 128 else 16)
    for var in (fwd, bwd):
        assert var["smem_bytes"] == var["stages"] * (var["queries"] + var["cols"]) * 72 * 2
        assert 2 * (var["smem_bytes"] + 2048) <= SM_SHARED_BYTES or var["warps"] == 16
        assert var["smem_bytes"] <= 232448
    wg = tcs.wgrad_mma_variant(kzp, n)
    assert wg["tile"] == (128, 128) and wg["k_tiles"] == kzp // 128 and wg["n_tiles"] == 1


@pytest.mark.parametrize("k,n", [(257, 128), (128, 257), (0, 16), (16, 0), (300, 300)])
def test_stencil_variant_raises_on_shapes_the_kernel_does_not_take(k, n):
    with pytest.raises(ValueError):
        tcs.stencil_mma_variant(k, n)


@pytest.mark.parametrize("c,cout", list(itertools.product((3, 16, 32, 64), (16, 32, 64))))
def test_wgrad_variant_fits_each_rank_gather_shape_without_padding_tiles(c, cout):
    var = tcs.wgrad_mma_variant(c, cout)
    tk, tn = var["tile"]
    assert var["k_tiles"] == var["n_tiles"] == 1 and c <= tk and cout <= tn
    assert (tk, tn) == ((32, 32) if max(c, cout) <= 32 else (64, 64))
    assert var["hit_split"] * (tk // 32) * (tn // (32 if tk == 32 else 64)) == 8  # all eight warps work


def test_wgrad_variant_tiles_large_matrices_and_raises_on_absurd_ones():
    assert tcs.wgrad_mma_variant(256, 68) == dict(tile=(128, 128), k_tiles=2, n_tiles=1, hit_split=1)
    assert tcs.wgrad_mma_variant(300, 300)["k_tiles"] == 3
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
}


@pytest.mark.parametrize("case", list(WEIGHT_CASES))
def test_weight_prep_layout_and_block_bitmap_equal_numpy(case):
    wc = WEIGHT_CASES[case]()
    k, n = wc.shape[1:]
    var = tcs.stencil_mma_variant(k, n)
    kp, n_pad = var["kp"], var["n_pad"]
    wt, wmask = tcs.stencil_weight_prep_ref(wc, kp, n_pad)
    assert wt.shape == (9, n_pad, kp) and wt.dtype == torch.bfloat16 and wmask.shape == (9, 16)
    w = wc.to(torch.bfloat16).float().numpy()
    want_t = np.zeros((9, n_pad, kp), np.float32)
    want_t[:, :n, :k] = w.transpose(0, 2, 1)
    np.testing.assert_array_equal(wt.float().numpy(), want_t)
    want_mask = np.zeros((9, 16), np.int64)
    for j, step, tile in itertools.product(range(9), range(kp // 16), range(n_pad // 8)):
        if want_t[j, tile * 8:(tile + 1) * 8, step * 16:(step + 1) * 16].any():
            want_mask[j, step] |= 1 << tile
    np.testing.assert_array_equal(wmask.numpy(), want_mask)
    zero_blocks = sum(1 for j, s in itertools.product(range(9), range(kp // 16))
                      for tile in range(n_pad // 8) if not (want_mask[j, s] >> tile) & 1)
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
    assert {c[3] for c in cases} == {1, 2} and {"all", "one", "holes"} <= {c[6] for c in cases}
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
    for nc, k, n in ((2, 128, 68), (1, 30, 65), (1, 256, 256), (1, 65, 128)):
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
            assert torch.equal(wmask.long()[:, :steps] & 0xFFFFFFFF, want_mask[:, :steps])
        got = tcs.stencil_conv_batched(src.to(torch.bfloat16), qids, ids, wc16, nc)
        want = tcs.stencil_conv_ref(src.to(torch.bfloat16), qids, ids, wc16, nc)
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    with pytest.raises(ValueError):
        tcs.stencil_conv_batched(torch.zeros(1, 8, 300, device=dev, dtype=torch.bfloat16),
                                 torch.zeros(1, 9, 8, device=dev, dtype=torch.int32),
                                 torch.arange(8, device=dev, dtype=torch.int32)[None],
                                 torch.zeros(9, 300, 8, device=dev), 1)
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
