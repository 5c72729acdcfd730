"""Operations of one VoxelNet forward of one sample: two per multiply-add of
every convolution and linear layer (predict, voxelize and the optimizer
count none). The pillar encoder's linear layers are counted for every point
slot of each occupied pillar (the slots it computes), the sparse middle's
layers from their useful pairs (:mod:`h100bench.counts.sparse_middle`), the
RPN and the heads from their shapes."""

from __future__ import annotations


def rpn_flops(rcfg, in_ch: int, h: int, w: int) -> float:
    macs, cin, out_hw = 0, in_ch, None
    for n, s, f, up in zip(rcfg.rpn_layer_nums, rcfg.rpn_strides, rcfg.rpn_filters, rcfg.rpn_up_filters):
        h, w = (h + 2 - 3) // s + 1, (w + 2 - 3) // s + 1
        macs += h * w * 9 * (cin * f + n * f * f) + h * w * f * up
        if out_hw is None:
            out_hw = (int(h * rcfg.rpn_up_strides[0]), int(w * rcfg.rpn_up_strides[0]))
        cin = f
    heads = rcfg.anchors_per_loc * (7 + rcfg.num_classes + 2)
    macs += out_hw[0] * out_hw[1] * sum(rcfg.rpn_up_filters) * heads
    return 2.0 * macs


def forward_flops(rcfg, in_features: int, occupied: int, middle_layers) -> float:
    nx, ny, _ = rcfg.grid.grid_size
    flops = 0.0
    if rcfg.encoder == "pillars":
        widths = [in_features + 5, *rcfg.encoder_features]
        flops += 2.0 * occupied * rcfg.max_points_per_voxel * sum(a * b for a, b in zip(widths[:-1], widths[1:]))
        bev = (rcfg.encoder_features[-1], ny, nx)
    if rcfg.sparse:
        flops += sum(2.0 * x["pairs"] * x["cin"] * x["cout"] for x in middle_layers)
        h, w = ny, nx
        for _ in rcfg.middle_features:
            h, w = (h - 1) // 2 + 1, (w - 1) // 2 + 1
        bev = (rcfg.middle_features[-1] * rcfg.final_nz, h, w)
    return flops + rpn_flops(rcfg, *bev)
