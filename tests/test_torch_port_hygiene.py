"""Boundaries of the port package ``lyft3d_tpu_torch``:

- none of its modules imports jax, flax or optax, nor anything of the JAX
  package ``lyft3d_tpu``, and neither does ``chip_smoke.py``; none imports
  cv2 or PIL when it is imported;
- ``bev_rasterize`` picks its path by ``device.type`` alone, and the CUDA
  path never falls back to the plain version (``fill_rows_by_id``: see
  ``test_torch_dense_fill.py``);
- importing the kernel modules and the training modules needs no nvcc and
  no GPU, and a backward pass on CPU tensors launches no kernel;
- a failing backward launch raises and never reaches the plain backward;
- models that are not yet ported fail loudly.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from lyft3d_tpu_torch import _build
from lyft3d_tpu_torch.models import build_model, list_models
from lyft3d_tpu_torch.models.backbones import build_backbone
from lyft3d_tpu_torch.models.second.voxelnet import VoxelNet, VoxelNetConfig
from lyft3d_tpu_torch.ops import bev_raster

REPO = Path(__file__).resolve().parent.parent


def _run(code, env_extra=None):
    env = {**os.environ, "PYTHONPATH": str(REPO), **(env_extra or {})}
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)


def test_no_module_imports_jax():
    code = """
import importlib, pkgutil, sys
import lyft3d_tpu_torch
names = [m.name for m in pkgutil.walk_packages(lyft3d_tpu_torch.__path__, "lyft3d_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import runpy
runpy.run_path("chip_smoke.py", run_name="chip_smoke")  # defines, runs nothing
# The learning demos and the writer of their inputs: no JAX, no image library and
# no pyyaml when imported (the card's machine has none of the three).
sys.path.insert(0, "tools")
for tool in ("demo_inputs", "demo_bev_e2e", "demo_second_e2e", "demo_pointrcnn_e2e", "regression_curves",
             "demo_probe", "learning_rehearsal", "entry_points_over_ranks", "data_parallel_families_phase",
             "batch_dependence_probe"):
    importlib.import_module(tool)
libs = sorted(m for m in sys.modules if m.split(".")[0] in ("cv2", "PIL", "yaml"))
assert not libs, f"a module imports {libs} when it is imported"
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax"))
assert not bad, bad
ours = sorted(m for m in sys.modules if m == "lyft3d_tpu" or m.startswith("lyft3d_tpu."))
assert not ours, ours
# cv2 and PIL are imported inside the functions that draw or read images:
# a CUDA host need not have either.
images = sorted(m for m in sys.modules if m.split(".")[0] in ("cv2", "PIL"))
assert not images, images
assert len(names) >= 88, names
for new in ("config", "data.augment", "data.prefetch", "train.losses", "train.optim", "train.trainer",
            "train.checkpoint", "train.logging", "pipelines.second_train", "models.backbones.seresnext",
            "data.bev_dataset", "train.swa", "pipelines.bev_train", "train.metrics", "models.deeplab",
            "models.backbones.efficientnet", "models.backbones.dpn", "models.backbones.wide_resnet",
            "models.backbones.xception", "serve.viewer", "serve.frontend", "native.bindings",
            "data.synthetic", "utils.visualize", "utils.progress", "utils.torch_import", "parallel",
            "parallel.mesh", "parallel.tensor", "dryrun"):
    assert "lyft3d_tpu_torch." + new in names, new
print("ok", len(names))
"""
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_raster_import_needs_no_nvcc_or_gpu():
    code = """
import lyft3d_tpu_torch.ops.bev_raster as r
import lyft3d_tpu_torch._build as b
import torch
assert not b._LIBS, "a kernel library was loaded at import"
pts = torch.zeros(4, 3); valid = torch.ones(4, dtype=torch.bool)
assert r.bev_rasterize(pts, valid).sum() == 4
assert r.KERNEL_LAUNCHES == 0
print("ok")
"""
    proc = _run(code, {"PATH": "/usr/bin:/bin", "CUDA_HOME": "/nonexistent",
                       "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_fill_import_needs_no_nvcc_or_gpu():
    code = """
import lyft3d_tpu_torch.ops.dense_fill as f
import lyft3d_tpu_torch.models.second.voxelnet
import lyft3d_tpu_torch._build as b
import torch
assert not b._LIBS, "a kernel library was loaded at import"
out = f.fill_rows_by_id(torch.ones(3, 2), torch.tensor([4, 0, 2]), torch.ones(3, dtype=torch.bool), 5)
assert out.sum() == 6 and f.KERNEL_LAUNCHES == 0
print("ok")
"""
    proc = _run(code, {"PATH": "/usr/bin:/bin", "CUDA_HOME": "/nonexistent",
                       "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_rotated_iou_import_needs_no_nvcc_or_gpu():
    code = """
import lyft3d_tpu_torch.ops.rotated_iou as r
import lyft3d_tpu_torch.ops.nms as nms
import lyft3d_tpu_torch._build as b
import torch
assert not b._LIBS, "a kernel library was loaded at import"
boxes = torch.tensor([[0.0, 0.0, 2.0, 4.0, 0.3], [0.0, 0.0, 2.0, 4.0, 0.3], [9.0, 9.0, 2.0, 4.0, 0.0]])
iou = r.rotated_iou_bev(boxes, boxes)
assert abs(float(iou[0, 1]) - 1.0) < 1e-5 and float(iou[0, 2]) == 0.0
assert r.rotated_iou_3d(torch.zeros(1, 2, 7), torch.ones(1, 3, 7)).shape == (1, 2, 3)
assert nms.rotated_nms(boxes, torch.tensor([0.9, 0.8, 0.7]), 0.5).tolist() == [True, False, True]
assert r.KERNEL_LAUNCHES == 0 and not b._LIBS
print("ok")
"""
    proc = _run(code, {"PATH": "/usr/bin:/bin", "CUDA_HOME": "/nonexistent",
                       "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_pointnet2_import_needs_no_nvcc_or_gpu():
    code = """
import lyft3d_tpu_torch.ops.pointnet2 as p2
import lyft3d_tpu_torch.pipelines.pointrcnn
import lyft3d_tpu_torch._build as b
import torch
assert not b._LIBS, "a kernel library was loaded at import"
pts = torch.rand(1, 32, 3); valid = torch.ones(1, 32, dtype=torch.bool)
sel = p2.fps(pts, valid, 4)
idx, cnt = p2.ball_query(pts[:, :4], pts, valid, 0.5, 8)
d, nn = p2.three_nn(pts, pts[:, :4], valid[:, :4])
assert sel.shape == (1, 4) and idx.shape == (1, 4, 8) and nn.shape == (1, 32, 3)
assert not any(p2.KERNEL_LAUNCHES.values())
print("ok")
"""
    proc = _run(code, {"PATH": "/usr/bin:/bin", "CUDA_HOME": "/nonexistent",
                       "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_sparse_kernels_import_needs_no_nvcc_or_gpu():
    code = """
import lyft3d_tpu_torch.ops.column_sparse as cs
import lyft3d_tpu_torch.ops.subm_conv_kernel as sk
import lyft3d_tpu_torch.models.second.middle
import lyft3d_tpu_torch._build as b
import torch
assert not b._LIBS, "a kernel library was loaded at import"
src = torch.ones(4, 128); ids = torch.tensor([3, 5, 8, 9], dtype=torch.int32)
qids = torch.full((9, 2), -1, dtype=torch.int32); qids[4] = torch.tensor([5, 7])
out = cs.stencil_conv_batched(src, qids, ids, torch.ones(9, 128, 2), 1)
assert out.tolist() == [[128.0, 128.0], [0.0, 0.0]]
out = sk.subm_conv(torch.ones(4, 3), torch.zeros(27, 4, dtype=torch.int32), torch.ones(27, 3, 2))
assert out.sum() == 27 * 3 * 2 * 4
assert cs.KERNEL_LAUNCHES == 0 and sk.KERNEL_LAUNCHES == 0
print("ok")
"""
    proc = _run(code, {"PATH": "/usr/bin:/bin", "CUDA_HOME": "/nonexistent",
                       "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_training_import_and_cpu_backward_need_no_nvcc_or_gpu():
    code = """
import lyft3d_tpu_torch.pipelines.second_train
import lyft3d_tpu_torch.train.trainer
import lyft3d_tpu_torch.cli
import lyft3d_tpu_torch.ops.column_sparse as cs
import lyft3d_tpu_torch.ops.subm_conv_kernel as sk
import lyft3d_tpu_torch.ops.dense_fill as f
import lyft3d_tpu_torch._build as b
import torch
src = torch.ones(4, 128, requires_grad=True); ids = torch.tensor([3, 5, 8, 9], dtype=torch.int32)
qids = torch.full((9, 4), -1, dtype=torch.int32); qids[4] = ids
wc = torch.ones(9, 128, 2, requires_grad=True)
cs.stencil_conv_batched(src, qids, ids, wc, 1, rev_qids=qids.flip(0), rev_src_ids=ids).sum().backward()
assert src.grad.sum() == 4 * 128 * 2 and wc.grad[4].sum() == 4 * 128 * 2
feats = torch.ones(4, 3, requires_grad=True)
sk.subm_conv(feats, torch.zeros(27, 4, dtype=torch.int32), torch.ones(27, 3, 2)).sum().backward()
assert feats.grad[0].sum() == 27 * 4 * 3 * 2
rows = torch.ones(3, 2, requires_grad=True)
f.fill_rows_by_id(rows, torch.tensor([4, 0, 9]), torch.ones(3, dtype=torch.bool), 5).sum().backward()
assert rows.grad.tolist() == [[1, 1], [1, 1], [0, 0]]
assert not b._LIBS, "a kernel library was loaded"
counts = (cs.KERNEL_LAUNCHES, cs.DGRAD_KERNEL_LAUNCHES, cs.WGRAD_KERNEL_LAUNCHES, sk.KERNEL_LAUNCHES,
          sk.DGRAD_KERNEL_LAUNCHES, sk.WGRAD_KERNEL_LAUNCHES, f.KERNEL_LAUNCHES, f.BWD_KERNEL_LAUNCHES)
assert not any(counts), counts
print("ok")
"""
    proc = _run(code, {"PATH": "/usr/bin:/bin", "CUDA_HOME": "/nonexistent",
                       "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


@pytest.mark.parametrize("which", ["stencil_dgrad", "stencil_dgrad_mma", "stencil_wgrad", "subm", "fill"])
def test_backward_cuda_paths_propagate_loader_errors(monkeypatch, which):
    """Each backward launcher, with the kernel loader failing, raises before
    it counts a launch, and the plain backward is never called."""
    from lyft3d_tpu_torch.ops import column_sparse as cs
    from lyft3d_tpu_torch.ops import dense_fill as f
    from lyft3d_tpu_torch.ops import subm_conv_kernel as sk

    def broken_loader(name):
        raise RuntimeError(f"cannot build {name}")

    def plain_must_not_run(*a, **k):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(_build, "load_library", broken_loader)
    for mod, name in ((cs, "stencil_conv_bwd_ref"), (cs, "stencil_conv_ref"), (sk, "subm_conv_bwd_ref"),
                      (f, "fill_rows_by_id_bwd_ref")):
        monkeypatch.setattr(mod, name, plain_must_not_run)
    ids = torch.zeros(4, dtype=torch.int32)
    q = torch.zeros(9, 4, dtype=torch.int32)
    calls = {
        "stencil_dgrad": (lambda: cs._stencil_conv_cuda(torch.zeros(4, 2), q, ids, torch.zeros(9, 2, 128), 1,
                                                        dgrad=True), "stencil_conv"),
        "stencil_dgrad_mma": (lambda: cs._stencil_dgrad_cuda(torch.zeros(4, 128), q, ids,
                                                             torch.zeros(9, 128, 128, dtype=torch.bfloat16), 1),
                              "stencil_conv"),
        "stencil_wgrad": (lambda: cs._stencil_wgrad_cuda(torch.zeros(4, 128), q, ids, torch.zeros(4, 2), 1,
                                                         128, 2), "stencil_conv"),
        "subm": (lambda: sk._subm_conv_bwd_cuda(torch.zeros(4, 3), torch.zeros(27, 4, dtype=torch.int32),
                                                torch.zeros(27, 3, 2), torch.zeros(4, 2), True, True),
                 "subm_conv"),
        "fill": (lambda: f._fill_bwd_cuda(torch.zeros(6, 4), ids, 6), "dense_fill"),
    }
    call, lib = calls[which]
    with pytest.raises(RuntimeError, match=f"cannot build {lib}"):
        call()
    assert not any((cs.DGRAD_KERNEL_LAUNCHES, cs.WGRAD_KERNEL_LAUNCHES, sk.DGRAD_KERNEL_LAUNCHES,
                    sk.WGRAD_KERNEL_LAUNCHES, f.BWD_KERNEL_LAUNCHES))


def test_stencil_backward_on_a_cuda_tensor_needs_reverse_queries():
    """The legacy branch (no ``rev_qids``) is the plain backward; the Function
    refuses it for a cotangent on the card instead of differentiating the
    plain forward there."""
    from lyft3d_tpu_torch.ops import column_sparse as cs

    class Ctx:
        saved_tensors = (torch.zeros(4, 128), torch.zeros(9, 4, dtype=torch.int32),
                         torch.zeros(4, dtype=torch.int32), torch.zeros(9, 128, 2), None, None, None)
        nc = 1
        needs_input_grad = (True, False, False, True, False, False, False)

    class OnCard:  # stands for a CUDA cotangent: only its device is read before the check
        device = torch.device("cuda")

        def contiguous(self):
            return self

    with pytest.raises(ValueError, match="needs rev_qids"):
        cs.StencilConv.backward(Ctx(), OnCard())


def test_dispatch_by_device_type(monkeypatch):
    pts = torch.zeros(16, 3)
    valid = torch.ones(16, dtype=torch.bool)
    # cpu → the plain version
    calls = []
    plain = bev_raster.bev_rasterize_scatter
    monkeypatch.setattr(bev_raster, "bev_rasterize_scatter",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    before = bev_raster.KERNEL_LAUNCHES
    out = bev_raster.bev_rasterize(pts, valid)
    assert calls == [1] and out.shape == bev_raster.DEFAULT_SHAPE
    assert bev_raster.KERNEL_LAUNCHES == before
    # any other device type → an error, not a fallback
    with pytest.raises(ValueError, match="meta"):
        bev_raster.bev_rasterize(pts.to("meta"), valid.to("meta"))
    assert calls == [1]


def test_cuda_path_propagates_loader_errors(monkeypatch):
    """The CUDA launch path, with the kernel loader failing, raises and
    returns no plain result."""
    def broken_loader(name):
        raise RuntimeError(f"cannot build {name}")

    def plain_must_not_run(*a, **k):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(_build, "load_library", broken_loader)
    monkeypatch.setattr(bev_raster, "bev_rasterize_scatter", plain_must_not_run)
    before = bev_raster.KERNEL_LAUNCHES
    with pytest.raises(RuntimeError, match="cannot build bev_raster"):
        bev_raster._bev_rasterize_cuda(torch.zeros(2, 8, 3), torch.ones(2, 8, dtype=torch.bool),
                                       bev_raster.DEFAULT_SHAPE, bev_raster.DEFAULT_VOXEL_SIZE,
                                       bev_raster.DEFAULT_Z_OFFSET)
    assert bev_raster.KERNEL_LAUNCHES == before


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "none"))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build("bev_raster", build_dir=tmp_path / "build")
    assert not (tmp_path / "build" / "libbev_raster.so").exists()


@pytest.mark.parametrize("name", ["unet_dpn68", "unet_efficientnet_b1", "deeplab_resnet50"])
def test_unported_models_raise(name):
    """Every name of the JAX registry is ported now (these three were the
    first examples of missing ones); a name the JAX package lacks raises."""
    assert name in list_models()
    with pytest.raises(KeyError, match="not yet ported"):
        build_model(name + "_x")


def test_unported_backbone_raises():
    build_backbone("efficientnet_b1", device="meta")  # ported now
    with pytest.raises(KeyError, match="not yet ported"):
        build_backbone("efficientnet_b7")


VOXELNET_PAIRS = [(e, m) for e in ("simple", "vfe", "pillars")
                  for m in ("scatter", "sparse", "sparse_units", "sparse_columns")]


@pytest.fixture(scope="module")
def tiny_voxels():
    """The JAX voxelizer's output for two small clouds, one point a voxel, on
    a 32 x 32 x 16 grid, and the tiny config both packages' VoxelNets are
    built from."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from lyft3d_tpu.models.second.voxelnet import VoxelNetConfig as JConfig
    from lyft3d_tpu.ops import anchors as janchors
    from lyft3d_tpu.ops import voxelize as jvox

    grid = jvox.VoxelGrid((-8.0, -8.0, -2.0, 8.0, 8.0, 2.0), (0.5, 0.5, 0.25))
    jcfg = JConfig(grid=grid, max_voxels=400, max_points_per_voxel=4, encoder_features=(16,),
                   middle_features=(8, 16), middle_max_voxels=(384, 256), middle_z_slab=4,
                   anchor_specs=(janchors.AnchorSpec((1.0, 2.0, 1.0), 0.0, 0.5, 0.35),),
                   rpn_layer_nums=(1, 1), rpn_strides=(1, 2), rpn_filters=(16, 32),
                   rpn_up_strides=(1, 2), rpn_up_filters=(16, 16))
    nx, ny, nz = grid.grid_size
    clouds = []
    for seed in (0, 1):
        # One voxel a BEV column at a random height: the scatter's ids stay
        # unique, the contract of the JAX fill (which keeps one of several
        # voxels of a column on the CPU and sums them on the TPU).
        rng = np.random.RandomState(seed)
        flat = rng.choice(nx * ny, 300, replace=False)
        idx = np.stack([flat % nx, flat // nx, rng.randint(0, nz, 300)], -1)
        xyz = np.array(grid.point_cloud_range[:3]) + (idx + 0.5 + rng.uniform(-0.3, 0.3, idx.shape)) * np.array(
            grid.voxel_size)
        clouds.append(np.concatenate([xyz, rng.rand(300, 1)], -1).astype(np.float32))
    pts = jnp.asarray(np.stack(clouds))
    vox = jax.vmap(lambda p: jvox.voxelize(p, jnp.ones(p.shape[0], bool), grid, jcfg.max_voxels,
                                           jcfg.max_points_per_voxel))(pts)
    return jcfg, [np.asarray(vox[k]) for k in ("voxels", "num_points", "coords", "voxel_valid")]


@pytest.mark.parametrize("encoder,middle", VOXELNET_PAIRS + [("an_unknown_encoder", "an_unknown_middle")])
def test_unported_voxelnet_variants_raise(encoder, middle, tiny_voxels):
    """Every (encoder, middle) pair the JAX ``VoxelNet`` builds, builds in the
    port too and, with JAX's flax init loaded by ``load_flax_params``, gives
    its boxes, classes and directions in float32 within 1e-4 of their scale
    on a tiny grid. An unknown encoder name builds the pillar encoder and an
    unknown middle name the scatter, as the JAX package's fall-through
    branches do (ROADMAP §C)."""
    import jax
    import numpy as np

    from lyft3d_tpu.models.second.voxelnet import VoxelNet as JVoxelNet
    from lyft3d_tpu_torch.ops.anchors import AnchorSpec
    from lyft3d_tpu_torch.ops.voxelize import VoxelGrid
    from lyft3d_tpu_torch.utils.flax_params import load_flax_params

    jcfg, inputs = tiny_voxels
    jcfg = dataclasses.replace(jcfg, encoder=encoder, middle=middle)
    names = {f.name for f in dataclasses.fields(VoxelNetConfig)}
    kw = {k: getattr(jcfg, k) for k in names}
    cfg = VoxelNetConfig(**{**kw, "grid": VoxelGrid(*jcfg.grid),
                            "anchor_specs": tuple(AnchorSpec(*a) for a in jcfg.anchor_specs)})
    assert cfg.feature_hw == tuple(jcfg.feature_hw)
    jmodel = JVoxelNet(jcfg, dtype=np.float32)
    variables = jax.device_get(jax.jit(jmodel.init)(jax.random.PRNGKey(0), *inputs))
    want = jax.device_get(jax.jit(jmodel.apply)(variables, *inputs))
    model = load_flax_params(VoxelNet(cfg, in_features=4, device="cpu"), variables)
    with torch.no_grad():
        got = model(*(torch.from_numpy(np.array(x)) for x in inputs))
    for k in ("box", "cls", "dir"):
        scale = float(np.abs(want[k]).max())
        assert scale > 0, k
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=1e-4 * scale, rtol=0, err_msg=k)


@pytest.mark.cuda
def test_kernel_on_card_matches_plain():
    """On a machine with a card: the CUDA kernel equals the plain version,
    including points on bin edges."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs the full check")
    g = torch.Generator().manual_seed(0)
    pts = (torch.rand(4, 20000, 3, generator=g) - 0.5) * torch.tensor([160.0, 160.0, 8.0])
    pts[:, :400, 0] = torch.arange(400).float() * 0.4 - 67.2
    valid = torch.rand(4, 20000, generator=g) > 0.1
    pts, valid = pts.cuda(), valid.cuda()
    got = bev_raster.bev_rasterize(pts, valid)
    torch.cuda.synchronize()
    assert torch.equal(got, bev_raster.bev_rasterize_scatter(pts, valid))
