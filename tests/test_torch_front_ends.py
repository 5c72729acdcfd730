"""The port's front ends against the JAX package's, on the CPU: the CLI's
subcommands, ``import-weights`` (a torch checkpoint straight into the port's
modules, held to the JAX importer's result carried over the flax bridge),
``synth-data`` / ``eval-map`` / ``export-kitti`` through both CLIs and the
native host runtime."""

import argparse
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch import nn

import lyft3d_tpu.cli as jcli
import lyft3d_tpu.native as jnative
import lyft3d_tpu_torch.cli as tcli
import lyft3d_tpu_torch.native as tnative
from lyft3d_tpu_torch.models import build_model
from lyft3d_tpu_torch.models.backbones import build_backbone
from lyft3d_tpu_torch.native import bindings as tbindings
from lyft3d_tpu_torch.utils import torch_import as timport
from lyft3d_tpu_torch.utils.flax_params import load_flax_params
from test_torch_import import _torch_efficientnet, _torch_seresnext26


def _subcommands(parser):
    sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return sorted(sub.choices)


def test_subcommands_equal_the_jax_cli():
    names = _subcommands(tcli.build_parser())
    assert names == _subcommands(jcli.build_parser()) and len(names) == 13


def _randomize_bn(net):
    for m in net.modules():
        if isinstance(m, nn.BatchNorm2d):
            with torch.no_grad():
                m.running_mean.normal_(0.1, 0.5)
                m.running_var.uniform_(0.5, 2.0)
                m.weight.normal_(1.0, 0.2)
                m.bias.normal_(0.0, 0.2)
    return net


def _torch_resnet18(in_ch=3):
    """torchvision-resnet-shaped resnet18 (conv1/bn1, layer{1..4}.{0,1} with
    conv1/bn1/conv2/bn2 and downsample.{0,1}, an fc head)."""

    class Block(nn.Module):
        def __init__(self, cin, cout, stride):
            super().__init__()
            self.conv1 = nn.Conv2d(cin, cout, 3, stride, 1, bias=False)
            self.bn1 = nn.BatchNorm2d(cout)
            self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1, bias=False)
            self.bn2 = nn.BatchNorm2d(cout)
            if cin != cout or stride != 1:
                self.downsample = nn.Sequential(nn.Conv2d(cin, cout, 1, stride, bias=False),
                                                nn.BatchNorm2d(cout))

    class Net(nn.Module):
        def __init__(self):
            super().__init__()
            self.conv1 = nn.Conv2d(in_ch, 64, 7, 2, 3, bias=False)
            self.bn1 = nn.BatchNorm2d(64)
            cin = 64
            for si, f in enumerate((64, 128, 256, 512)):
                blocks = []
                for bi in range(2):
                    blocks.append(Block(cin, f, 2 if (si > 0 and bi == 0) else 1))
                    cin = f
                setattr(self, f"layer{si + 1}", nn.Sequential(*blocks))
            self.fc = nn.Linear(512, 1000)

    return _randomize_bn(Net())


IMPORT_CASES = {
    "seresnext26": ("unet_seresnext26", lambda: _randomize_bn(_torch_seresnext26())),
    "resnet18": ("unet_resnet18", _torch_resnet18),
    "efficientnet_b1": ("unet_efficientnet_b1", lambda: _randomize_bn(_torch_efficientnet("b1"))),
}


def _counts(out):
    m = re.search(r"\[torch_import\] loaded (\d+) tensors, skipped (\d+)", out)
    return int(m.group(1)), int(m.group(2))


@pytest.fixture(scope="module")
def imported(tmp_path_factory):
    """Each case's checkpoint through both CLIs' ``import-weights``:
    {backbone: (model name, torch net, jax out dir, jax counts, port out
    dir, port counts)}."""
    import contextlib
    import io

    root = tmp_path_factory.mktemp("import")
    out = {}
    for backbone, (model, make) in IMPORT_CASES.items():
        torch.manual_seed(0)
        net = make()
        path = root / f"{backbone}.pth"
        torch.save(net.state_dict(), path)
        row = [model, net]
        for pkg, main in (("jax", jcli.main), ("port", tcli.main)):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                main(["import-weights", "--torch-ckpt", str(path), "--backbone", backbone,
                      "--out", str(root / f"{pkg}_{backbone}"), "--image-size", "64"])
            row += [root / f"{pkg}_{backbone}", _counts(buf.getvalue())]
        out[backbone] = tuple(row)
    return out


@pytest.mark.parametrize("backbone", sorted(IMPORT_CASES))
def test_import_weights_equals_the_jax_importer(imported, backbone):
    """The port's backbone tensors equal the JAX result carried over
    ``load_flax_params`` (1e-6), with the same loaded and skipped counts;
    the stem holds the torch stem inflated to 6 channels."""
    from flax import serialization

    model, net, jdir, jcounts, tdir, tcounts = imported[backbone]
    assert tcounts == jcounts and jcounts[0] > 0
    jtree = serialization.msgpack_restore((jdir / f"{model}-0.ckpt").read_bytes())
    carried = load_flax_params(build_model(model, n_classes=10), {"params": jtree["params"]}).state_dict()
    snap = torch.load(tdir / f"{model}-0.ckpt", map_location="cpu", weights_only=True)
    assert snap["masters"] == []
    ours = snap["model"]
    keys = [k for k in ours if k.startswith("backbone.")]
    assert keys and carried.keys() == ours.keys()
    for k in keys:
        torch.testing.assert_close(ours[k], carried[k], rtol=0, atol=1e-6, msg=k)
    stem = net.layer0.conv1 if backbone.startswith("seresnext") else (
        net.conv1 if backbone.startswith("resnet") else net._conv_stem)
    want = timport.inflate_input_channels(stem.weight.detach().numpy(), 6)
    np.testing.assert_allclose(ours["backbone.stem.conv.weight"].numpy(), want, rtol=0, atol=1e-6)


def test_import_weights_snapshot_restores(imported, tmp_path, monkeypatch):
    """The written snapshot restores through ``train-bev``'s ``init_from``
    and through ``infer-bev model:dir``."""
    from lyft3d_tpu.data.synthetic import make_synthetic_lyft
    from lyft3d_tpu_torch.config import BEVExperiment
    from lyft3d_tpu_torch.pipelines.bev_train import _init_from

    model, _, _, _, tdir, _ = imported["resnet18"]
    want = torch.load(tdir / f"{model}-0.ckpt", map_location="cpu", weights_only=True)["model"]

    net = build_model(model, n_classes=10, generator=torch.Generator().manual_seed(3))
    _init_from(net, BEVExperiment(model=model, init_from=str(tdir)))
    got = net.state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want)

    import lyft3d_tpu_torch.models as models

    built = []
    real = models.build_model
    monkeypatch.setattr(models, "build_model", lambda *a, **k: built.append(real(*a, **k)) or built[-1])
    root = make_synthetic_lyft(tmp_path / "lyft", num_scenes=1, samples_per_scene=1, points_per_sweep=1024)
    tcli.main(["infer-bev", "--data-root", str(root), "--model", f"{model}:{tdir}",
               "--out", str(tmp_path / "sub.csv"), "--device", "cpu"])
    got = built[-1].state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_import_batch_norm_is_function_preserving():
    """``norm_type="batch"``: the port's stem in eval mode equals the torch
    stem (conv → BN → ReLU) in eval mode, and the tensors equal the JAX
    importer's carried over the bridge, with the same counts."""
    import contextlib
    import io

    import jax
    import jax.numpy as jnp

    from lyft3d_tpu.models.backbones import build_backbone as jbuild_backbone
    from lyft3d_tpu.utils import torch_import as jimport

    torch.manual_seed(1)
    net = _randomize_bn(_torch_seresnext26(in_ch=3)).eval()
    sd = net.state_dict()
    bb = build_backbone("seresnext26", in_features=3, norm_type="batch")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        timport.load_pretrained_backbone(bb, sd, "seresnext26", in_channels=3, norm_type="batch",
                                         verbose=True)
    bb.eval()
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 3, 32, 32).astype(np.float32))
    with torch.no_grad():
        want = torch.relu(net.layer0.bn1(net.layer0.conv1(x)))
        torch.testing.assert_close(bb.stem(x), want, rtol=0, atol=1e-5)

    variables = jax.jit(jbuild_backbone("seresnext26", norm_type="batch").init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    wrapped = {c: {"SEResNeXt_0": variables[c]} for c in ("params", "batch_stats")}
    jbuf = io.StringIO()
    with contextlib.redirect_stdout(jbuf):
        jout = jimport.load_pretrained_backbone(wrapped, timport.normalize_state_dict(sd), "seresnext26",
                                                in_channels=3, norm_type="batch", verbose=True)
    assert _counts(buf.getvalue()) == _counts(jbuf.getvalue())
    carried = load_flax_params(build_backbone("seresnext26", in_features=3, norm_type="batch"),
                               {c: jout[c]["SEResNeXt_0"] for c in ("params", "batch_stats")}).state_dict()
    for k, v in bb.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            torch.testing.assert_close(v, carried[k], rtol=0, atol=1e-6, msg=k)


@pytest.mark.parametrize("case", ["shape", "norm_kind", "shallow"])
def test_import_skips_like_the_jax_importer(case):
    """Mismatches are skipped and counted as the JAX importer counts them: a
    tensor of another shape, a norm of the other kind (a BatchNorm model
    given GroupNorm folds), a checkpoint shallower than the model (its
    missing blocks keep their initialisation)."""
    import contextlib
    import io

    import jax
    import jax.numpy as jnp

    from lyft3d_tpu.models.backbones import build_backbone as jbuild_backbone
    from lyft3d_tpu.utils import torch_import as jimport

    torch.manual_seed(2)
    sd = timport.normalize_state_dict(_torch_resnet18().state_dict())
    norm = "group"
    if case == "shape":
        sd["layer2.0.conv1.weight"] = sd["layer2.0.conv1.weight"][:, :32]
    elif case == "norm_kind":
        norm = "batch"
    else:
        sd = {k: v for k, v in sd.items() if not k.startswith("layer4.1.")}
    jvars = jax.jit(jbuild_backbone("resnet18", norm_type=norm).init)(jax.random.PRNGKey(0),
                                                                       jnp.zeros((1, 32, 32, 6)))
    wrapped = {c: {"ResNet_0": v} for c, v in jvars.items()}
    bb = build_backbone("resnet18", norm_type=norm)
    init = {k: v.clone() for k, v in bb.state_dict().items()}
    bufs = [io.StringIO(), io.StringIO()]
    with contextlib.redirect_stdout(bufs[0]):
        jimport.load_pretrained_backbone(wrapped, sd, "resnet18", verbose=True)
    with contextlib.redirect_stdout(bufs[1]):
        timport.load_pretrained_backbone(bb, sd, "resnet18", verbose=True)
    counts = [_counts(b.getvalue()) for b in bufs]
    assert counts[0] == counts[1]
    assert (counts[1][1] == 0) == (case == "shallow")
    after = bb.state_dict()
    if case == "shape":
        assert torch.equal(after["stages.1.0.conv1.conv.weight"], init["stages.1.0.conv1.conv.weight"])
    elif case == "norm_kind":
        assert torch.equal(after["stem.norm.running_var"], init["stem.norm.running_var"])
    else:
        assert all(torch.equal(after[k], init[k]) for k in init if k.startswith("stages.3.1."))
        assert not torch.equal(after["stages.3.0.conv1.conv.weight"], init["stages.3.0.conv1.conv.weight"])


@pytest.mark.parametrize("backbone", ["dpn68", "xception", "inception_v4"])
def test_unsupported_backbone_raises(backbone):
    with pytest.raises(KeyError, match="no torch importer"):
        timport.load_pretrained_backbone(nn.Module(), {}, backbone)


@pytest.fixture(scope="module")
def synth_trees(tmp_path_factory):
    """``synth-data`` through both CLIs with the same arguments."""
    root = tmp_path_factory.mktemp("synth")
    args = ["synth-data", "--scenes", "1", "--samples", "2", "--seed", "3"]
    jcli.main(args + ["--out", str(root / "jax")])
    tcli.main(args + ["--out", str(root / "port")])
    return root / "jax", root / "port"


def _same_tree(a: Path, b: Path):
    files = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file())
    for f in files:
        assert (a / f).read_bytes() == (b / f).read_bytes(), f
    return files


def test_synth_data_trees_are_byte_equal(synth_trees):
    files = _same_tree(*synth_trees)
    suffixes = {f.suffix for f in files}
    assert {".json", ".bin", ".png"} <= suffixes


def test_export_kitti_trees_are_byte_equal(synth_trees, tmp_path, capsys):
    jroot, _ = synth_trees
    jcli.main(["export-kitti", "--data-root", str(jroot), "--out", str(tmp_path / "jax")])
    tcli.main(["export-kitti", "--data-root", str(jroot), "--out", str(tmp_path / "port")])
    files = _same_tree(tmp_path / "jax", tmp_path / "port")
    assert any(f.parts[0] == "velodyne" for f in files) and any(f.parts[0] == "label_2" for f in files)


@pytest.mark.parametrize("jitter", [0.0, 0.5])
def test_eval_map_prints_the_same_json(synth_trees, tmp_path, capsys, jitter):
    from lyft3d_tpu_torch.core.quaternion import quaternion_yaw
    from lyft3d_tpu_torch.data.lyftdb import LyftDB
    from lyft3d_tpu_torch.eval.submission import write_submission

    root, _ = synth_trees
    db = LyftDB(root, root / "data")
    rng = np.random.RandomState(4)
    dets = {}
    for s in db.sample:
        for b in db.get_boxes(s["data"]["LIDAR_TOP"]):
            dets.setdefault(s["token"], []).append({
                "translation": (b.center + rng.randn(3) * jitter).tolist(), "size": b.wlh.tolist(),
                "yaw": quaternion_yaw(b.orientation), "name": b.name, "score": float(rng.rand())})
    sub = write_submission(tmp_path / "sub.csv", dets, [s["token"] for s in db.sample])
    outs = []
    for main in (jcli.main, tcli.main):
        main(["eval-map", "--data-root", str(root), "--submission", str(sub)])
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]
    assert (json.loads(outs[1])["mAP"] == 1.0) == (jitter == 0.0)


@pytest.fixture(scope="module")
def sweeps(tmp_path_factory):
    """Four Lyft .bin sweeps (float32 × 5) and their SE(3) transforms."""
    from lyft3d_tpu_torch.core.geometry import transform_matrix
    from lyft3d_tpu_torch.core.quaternion import quat_from_yaw

    root = tmp_path_factory.mktemp("bins")
    rng = np.random.RandomState(1)
    paths, tms = [], []
    for i in range(4):
        p = root / f"s{i}.bin"
        rng.uniform(-60, 60, (3000 + 500 * i, 5)).astype(np.float32).tofile(p)
        paths.append(p)
        tms.append(transform_matrix([100.0 * i, -50.0, 1.5], quat_from_yaw(0.3 * i)))
    return paths, np.stack(tms)


def test_native_builds_into_the_port_build_dir():
    from lyft3d_tpu_torch import _build

    assert tnative.native_available()
    assert tbindings._SO == _build.BUILD_DIR / "libl3dnative.so" and tbindings._SO.exists()
    assert (tbindings._SRC.read_bytes()
            == (Path(jnative.__file__).parent / "loader.cpp").read_bytes())


def f32_ulps(a, b):
    """Largest difference, in float32 ulps of the largest magnitude."""
    return float(np.abs(a - b).max() / np.spacing(np.float32(np.abs(b).max())))


@pytest.mark.parametrize("fn", ["read_lidar", "read_lidar_cap", "transform_points", "load_batch", "bev_raster"])
def test_native_equals_jax_native_and_fallback(sweeps, monkeypatch, fn):
    """Native results equal the JAX package's native library's exactly, and
    the numpy fallbacks: reads exactly; transforms within 2 float32 ulps of
    the largest coordinate (the fallback's BLAS product sums in another
    order than the C++ loop); the raster's counts exactly where every point
    bins alike in float32 (the fallback) and float64 (the C++), and capped at
    16 as the fallback's normalisation caps them."""
    from lyft3d_tpu_torch.data.bev_pipeline import BEVConfig

    paths, tms = sweeps
    pts = np.fromfile(paths[3], np.float32).reshape(-1, 5)[:, :4]
    cfg = BEVConfig(shape=(64, 64, 3), voxel_size=(0.5, 0.5, 1.5), z_offset=-2.0)
    calls = {
        "read_lidar": lambda m: m.read_lidar(paths[2]),
        "read_lidar_cap": lambda m: m.read_lidar(paths[2], max_points=100),
        "transform_points": lambda m: m.transform_points(pts.copy(), tms[1]),
        "load_batch": lambda m: m.load_batch(paths, tms, max_points=4096, n_threads=3),
        "bev_raster": lambda m: m.bev_raster(pts * 0.05, cfg.shape, cfg.voxel_size, cfg.z_offset),
    }
    got, jax_native = calls[fn](tnative), calls[fn](jnative)
    assert jnative.native_available()
    for a, b in zip(*((r if fn == "load_batch" else (r,)) for r in (got, jax_native))):
        np.testing.assert_array_equal(a, b)
    monkeypatch.setattr(tbindings, "_get", lambda: None)
    fallback = calls[fn](tbindings)
    if fn.startswith("read_lidar"):
        np.testing.assert_array_equal(got, fallback[: len(got)])
    elif fn == "transform_points":
        assert f32_ulps(got, fallback) <= 2
    elif fn == "load_batch":
        np.testing.assert_array_equal(got[1], fallback[1])
        assert f32_ulps(got[0], fallback[0]) <= 2
        assert got[1].tolist() == [3000, 3500, 4000, 4096]
    else:
        p = pts * 0.05
        h, w, c = cfg.shape
        bins = []
        for dt in (np.float32, np.float64):
            q = p.astype(dt)
            bins.append((np.floor(q[:, 0] / dt(0.5) + w / 2), np.floor(q[:, 1] / dt(0.5) + h / 2),
                         np.floor((q[:, 2] - dt(-2.0)) / dt(1.5))))
        alike = all((x == y).all() for x, y in zip(*bins))
        assert alike, "a point on a bin edge: the float32 and float64 bins differ"
        np.testing.assert_array_equal(np.minimum(got, 16.0), fallback)
        assert got.sum() > 0 and got.max() > 16.0
