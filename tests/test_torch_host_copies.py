"""The port's own host modules (``lyft3d_tpu_torch.core/.data/.eval``,
``.config``, ``.train.logging`` and ``.pipelines.second_pipeline``, numpy
only) give the results of the JAX package's originals on the synthetic
dataset, the augmentations under equal seeds included. Equal where the arithmetic is
the same code; every case is one parametrised test."""

import dataclasses
import json
import re
from pathlib import Path

import numpy as np
import pytest

import lyft3d_tpu.config as jconfig
import lyft3d_tpu.core as jcore
import lyft3d_tpu.core.box as jbox
import lyft3d_tpu.core.geometry as jgeo
import lyft3d_tpu.core.quaternion as jquat
import lyft3d_tpu.data.aug_scene as jaugscene
import lyft3d_tpu.data.augment as jaug
import lyft3d_tpu.data.bev_dataset as jbevds
import lyft3d_tpu.data.bev_pipeline as jbev
import lyft3d_tpu.data.kitti as jkitti
import lyft3d_tpu.data.lyftdb as jdb
import lyft3d_tpu.data.map_mask as jmap
import lyft3d_tpu.data.pointcloud as jpc
import lyft3d_tpu.data.prefetch as jprefetch
import lyft3d_tpu.data.splits as jsplits
import lyft3d_tpu.eval.kitti_eval as jkeval
import lyft3d_tpu.eval.map_eval as jmeval
import lyft3d_tpu.eval.np_rotated_iou as jiou
import lyft3d_tpu.eval.submission as jsub
import lyft3d_tpu.pipelines.second_pipeline as jsec
import lyft3d_tpu.train.logging as jlog
import lyft3d_tpu.utils.profiler as jprof
import lyft3d_tpu.utils.progress as jprog
import lyft3d_tpu.utils.visualize as jvis
import lyft3d_tpu_torch.config as tconfig
import lyft3d_tpu_torch.core as tcore
import lyft3d_tpu_torch.core.box as tbox
import lyft3d_tpu_torch.core.geometry as tgeo
import lyft3d_tpu_torch.core.quaternion as tquat
import lyft3d_tpu_torch.data.aug_scene as taugscene
import lyft3d_tpu_torch.data.augment as taug
import lyft3d_tpu_torch.data.bev_dataset as tbevds
import lyft3d_tpu_torch.data.bev_pipeline as tbev
import lyft3d_tpu_torch.data.kitti as tkitti
import lyft3d_tpu_torch.data.lyftdb as tdb
import lyft3d_tpu_torch.data.map_mask as tmap
import lyft3d_tpu_torch.data.pointcloud as tpc
import lyft3d_tpu_torch.data.prefetch as tprefetch
import lyft3d_tpu_torch.data.splits as tsplits
import lyft3d_tpu_torch.eval.kitti_eval as tkeval
import lyft3d_tpu_torch.eval.map_eval as tmeval
import lyft3d_tpu_torch.eval.np_rotated_iou as tiou
import lyft3d_tpu_torch.eval.submission as tsub
import lyft3d_tpu_torch.pipelines.second_pipeline as tsec
import lyft3d_tpu_torch.train.logging as tlog
import lyft3d_tpu_torch.utils.profiler as tprof
import lyft3d_tpu_torch.utils.progress as tprog
import lyft3d_tpu_torch.utils.visualize as tvis
from lyft3d_tpu.data.synthetic import make_synthetic_lyft


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_synthetic_lyft(tmp_path_factory.mktemp("host") / "lyft", num_scenes=1,
                               samples_per_scene=3, boxes_per_sample=5, seed=4,
                               points_per_sweep=2048)


@pytest.fixture(scope="module")
def dbs(root):
    return jdb.LyftDB(root, root / "data"), tdb.LyftDB(root, root / "data")


def rand_quats(n, seed=0):
    q = np.random.RandomState(seed).randn(n, 4)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def same(a, b):
    """Equal, through dicts, sequences, arrays, boxes and scalars."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            same(x, y)
    elif hasattr(a, "as_xyzwlhr"):
        np.testing.assert_array_equal(a.as_xyzwlhr(), b.as_xyzwlhr())
        assert (a.name, a.token, a.score) == (b.name, b.token, b.score) or np.isnan(a.score)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


QUAT_CASES = {
    "normalize": lambda m, q: [m.quat_normalize(3 * x) for x in q],
    "multiply": lambda m, q: [m.quat_multiply(x, y) for x, y in zip(q, q[::-1])],
    "inverse": lambda m, q: [m.quat_inverse(x) for x in q],
    "rotate": lambda m, q: [m.quat_rotate(x, np.array([1.0, -2.0, 0.5])) for x in q],
    "rotation_matrix": lambda m, q: [m.quat_to_rotation_matrix(x) for x in q],
    "axis_angle": lambda m, q: [m.quat_from_axis_angle(x[:3], x[3]) for x in q],
    "from_yaw": lambda m, q: [m.quat_from_yaw(x[0] * 3) for x in q],
    "slerp": lambda m, q: [m.quat_slerp(x, y, 0.3) for x, y in zip(q, q[::-1])],
    "yaw": lambda m, q: [m.quaternion_yaw(x) for x in q],
}


@pytest.mark.parametrize("case", sorted(QUAT_CASES))
def test_quaternion_ops(case):
    q = rand_quats(8)
    same(QUAT_CASES[case](tquat, q), QUAT_CASES[case](jquat, q))


def _boxes(mod, q):
    return [mod.Box(center=x[:3] * 10, wlh=np.abs(x[1:4]) * 4 + 0.5, orientation=x,
                    name="car", token=f"t{i}") for i, x in enumerate(q)]


BOX_CASES = {
    "corners": lambda m, bs: [b.corners(1.1) for b in bs],
    "bottom_corners": lambda m, bs: [b.bottom_corners() for b in bs],
    "yaw": lambda m, bs: [b.yaw for b in bs],
    "as_xyzwlhr": lambda m, bs: m[1].boxes_to_xyzwlhr(bs),
    "translate_rotate": lambda m, bs: [
        b.copy().translate(np.array([1.0, 2.0, 3.0])).rotate(b.orientation) for b in bs],
    "transform": lambda m, bs: [
        b.copy().transform(m[0].transform_matrix(b.center, b.orientation)) for b in bs],
    "points_in_box": lambda m, bs: [
        m[0].points_in_box(b, (np.random.RandomState(1).rand(3, 50) - 0.5) * 8 + b.center[:, None])
        for b in bs],
    "points_in_boxes": lambda m, bs: (lambda a: m[2].points_in_boxes(
        (np.random.RandomState(2).rand(200, 3) - 0.5) * 30, a[:, :3], a[:, 3:6], a[:, 6]))(
            m[1].boxes_to_xyzwlhr(bs)),
    "transform_matrix": lambda m, bs: [m[0].transform_matrix(b.center, b.orientation, inverse=i)
                                       for b in bs for i in (False, True)],
    "view_points": lambda m, bs: [m[0].view_points(b.corners(), np.eye(3) * 2.0, normalize=n)
                                  for b in bs for n in (False, True)],
}


@pytest.mark.parametrize("case", sorted(BOX_CASES))
def test_box_and_geometry_ops(case):
    q = rand_quats(6, seed=3)
    same(BOX_CASES[case]((tcore, tbox, tgeo), _boxes(tcore, q)),
         BOX_CASES[case]((jcore, jbox, jgeo), _boxes(jcore, q)))


def _lidar(db):
    return db.sample[1]["data"]["LIDAR_TOP"]


DB_CASES = {
    "tables": lambda db: [len(getattr(db, t)) for t in ("scene", "sample", "sample_data",
                                                        "sample_annotation", "ego_pose")],
    "get_and_index": lambda db: [db.get("sample", db.sample[2]["token"])["timestamp"],
                                 db.getind("sample", db.sample[2]["token"])],
    "field2token": lambda db: db.field2token("sample", "scene_token", db.scene[0]["token"]),
    "data_path": lambda db: str(db.get_sample_data_path(_lidar(db))),
    "ego_pose_matrix": lambda db: [db.ego_pose_matrix(_lidar(db), inverse=i) for i in (False, True)],
    "sensor_pose_matrix": lambda db: [db.sensor_pose_matrix(_lidar(db), inverse=i)
                                      for i in (False, True)],
    "get_box": lambda db: [db.get_box(t) for t in db.sample[0]["anns"]],
    "get_boxes": lambda db: db.get_boxes(_lidar(db)),
    "boxes_in_sensor_frame": lambda db: db.get_boxes_in_sensor_frame(_lidar(db)),
    "box_velocity": lambda db: [np.nan_to_num(db.box_velocity(t)) for t in db.sample[1]["anns"]],
    "scene_samples": lambda db: db.sample_tokens_of_scene(db.scene[0]["token"]),
    "map_mask_path": lambda db: str(db.map_mask_path(db.sample[0]["token"])),
}


@pytest.mark.parametrize("case", sorted(DB_CASES))
def test_lyftdb_lookups(dbs, case):
    j, t = dbs
    same(DB_CASES[case](t), DB_CASES[case](j))


def test_point_cloud_and_multisweep(dbs):
    j, t = dbs
    path = j.get_sample_data_path(_lidar(j))
    a, b = tpc.LidarPointCloud.from_file(path), jpc.LidarPointCloud.from_file(path)
    same(a.points, b.points)
    tm = jcore.transform_matrix(np.array([1.0, 2.0, 0.5]), rand_quats(1)[0])
    same(a.transform(tm).remove_close(1.5).points, b.transform(tm).remove_close(1.5).points)
    assert len(a) == len(b) and len(a) > 0
    same(tpc.load_multisweep(t, _lidar(t), num_sweeps=2), jpc.load_multisweep(j, _lidar(j), num_sweeps=2))


def test_map_mask_crop(dbs):
    j, t = dbs
    path = j.map_mask_path(j.sample[0]["token"])
    a, b = tmap.MapMask(path), jmap.MapMask(path)
    same(a.mask(), b.mask())
    same(a.transform_matrix, b.transform_matrix)
    same(a.to_pixel_coords(np.array([3.0, 40.0]), np.array([5.0, 60.0])),
         b.to_pixel_coords(np.array([3.0, 40.0]), np.array([5.0, 60.0])))
    same(a.is_on_mask(np.array([3.0, 40.0]), np.array([5.0, 60.0])),
         b.is_on_mask(np.array([3.0, 40.0]), np.array([5.0, 60.0])))
    for centre in ((20.0, 30.0), (0.5, 0.5)):  # inside, and over the border (zero-padded)
        same(a.crop_around(centre, 25.6, 0.5), b.crop_around(centre, 25.6, 0.5))


BEV_CASES = {
    "points_in_car_frame": lambda g, tok: g.points_in_car_frame(tok),
    "boxes_in_car_frame": lambda g, tok: g.boxes_in_car_frame(tok),
    "map_channel": lambda g, tok: g.map_channel(tok),
    "sample_arrays": lambda g, tok: g.sample_arrays(tok, max_boxes=16),
    "car_to_world_and_height": lambda g, tok: [g.car_to_world_matrix(tok), g.ego_height(tok),
                                               g.pixels_to_car(np.array([3.0]), np.array([7.0]))],
}


@pytest.mark.parametrize("case", sorted(BEV_CASES))
def test_bev_sample_generator(dbs, case):
    j, t = dbs
    cfg = dict(shape=(96, 96, 3), num_sweeps=2, max_points=4096)
    assert tbev.BEVConfig(**cfg) == tbev.BEVConfig(**cfg) and tbev.BEV_CLASSES == jbev.BEV_CLASSES
    assert tbev.CLASS_HEIGHTS == jbev.CLASS_HEIGHTS and tbev.BEVConfig().shape == jbev.BEVConfig().shape
    tok = j.sample[1]["token"]
    same(BEV_CASES[case](tbev.BEVSampleGenerator(t, tbev.BEVConfig(**cfg)), tok),
         BEV_CASES[case](jbev.BEVSampleGenerator(j, jbev.BEVConfig(**cfg)), tok))


@pytest.fixture(scope="module")
def bev_pngs(dbs, tmp_path_factory):
    """The same samples written by both packages' ``generate_bev_dataset``."""
    j, t = dbs
    out = tmp_path_factory.mktemp("bevds")
    cfg = dict(shape=(64, 64, 3), voxel_size=(1.0, 1.0, 1.5))
    tokens = [s["token"] for s in j.sample]
    assert jbevds.generate_bev_dataset(j, out / "j", jbev.BEVConfig(**cfg)) == tokens
    assert tbevds.generate_bev_dataset(t, out / "t", tbev.BEVConfig(**cfg)) == tokens
    return out, tokens


def _bev_dataset_case(case, m, bev, root, tokens):
    if case == "raster":
        pts = np.random.RandomState(3).uniform(-40, 40, (3000, 4)).astype(np.float32)
        return m.numpy_bev_raster(pts, bev.BEVConfig(shape=(64, 64, 3), voxel_size=(1.0, 1.0, 1.5)))
    if case == "index_batches":
        return list(m.index_batches(5, 3, steps=7, seed=4))
    ds = m.BEVImageDataset(root, tokens, with_map=True, augment=case == "augmented", seed=2)
    if case == "batch_iterator":
        return list(m.batch_iterator(ds, 2, steps=3, seed=1))
    return [ds.load(i % len(tokens)) for i in range(8)]  # one RandomState, eight draws


@pytest.mark.parametrize("case", ["raster", "pngs", "loaded", "augmented", "index_batches", "batch_iterator"])
def test_bev_dataset_copy(bev_pngs, case):
    out, tokens = bev_pngs
    if case == "pngs":
        import cv2

        names = sorted(p.name for p in (out / "j").iterdir())
        assert names == sorted(p.name for p in (out / "t").iterdir()) and len(names) == 3 * len(tokens)
        for name in names:
            np.testing.assert_array_equal(cv2.imread(str(out / "t" / name)), cv2.imread(str(out / "j" / name)))
        return
    same(_bev_dataset_case(case, tbevds, tbev, out / "j", tokens),
         _bev_dataset_case(case, jbevds, jbev, out / "j", tokens))


def _records(db, rng, jitter):
    """GT records of every sample, and detections: the GT jittered, scored."""
    gt, det = [], []
    for s in db.sample:
        for b in db.get_boxes(s["data"]["LIDAR_TOP"]):
            rec = {"sample_token": s["token"], "translation": b.center.tolist(),
                   "size": b.wlh.tolist(), "rotation": b.orientation.tolist(), "name": b.name}
            gt.append(rec)
            det.append(dict(rec, translation=(b.center + rng.randn(3) * jitter).tolist(),
                            score=float(rng.rand())))
    return gt, det


@pytest.mark.parametrize("jitter", [0.0, 0.3, 1.0])
def test_evaluate_map(dbs, jitter):
    j, _ = dbs
    gt, det = _records(j, np.random.RandomState(5), jitter)
    got, want = tmeval.evaluate_map(gt, det), jmeval.evaluate_map(gt, det)
    same(got, want)
    assert (got[0] == 1.0) == (jitter == 0.0)
    same(tmeval.get_class_names(gt), jmeval.get_class_names(gt))
    same(tmeval.record_to_array(gt[0]), jmeval.record_to_array(gt[0]))


@pytest.mark.parametrize("fn", ["box_corners_2d_np", "iou_bev_np", "iou_3d_np"])
def test_np_rotated_iou(fn):
    rng = np.random.RandomState(6)
    a = np.column_stack([rng.uniform(-5, 5, (30, 3)), rng.uniform(1, 5, (30, 3)),
                         rng.uniform(-np.pi, np.pi, 30)])
    b = a[::-1] + rng.randn(30, 7) * 0.3
    if fn == "box_corners_2d_np":
        same(tiou.box_corners_2d_np(a[:, [0, 1, 3, 4, 6]]), jiou.box_corners_2d_np(a[:, [0, 1, 3, 4, 6]]))
    elif fn == "iou_bev_np":
        same(tiou.iou_bev_np(a[:, [0, 1, 3, 4, 6]], b[:, [0, 1, 3, 4, 6]]),
             jiou.iou_bev_np(a[:, [0, 1, 3, 4, 6]], b[:, [0, 1, 3, 4, 6]]))
    else:
        for z_center in (True, False):
            same(tiou.iou_3d_np(a, b, z_center=z_center), jiou.iou_3d_np(a, b, z_center=z_center))


def test_submission_round_trip(dbs, tmp_path):
    j, _ = dbs
    _, det = _records(j, np.random.RandomState(7), 0.2)
    by_sample = {}
    for d in det:
        by_sample.setdefault(d["sample_token"], []).append(dict(d, yaw=0.3))
    tokens = [s["token"] for s in j.sample]
    tsub.write_submission(tmp_path / "t.csv", by_sample, tokens)
    jsub.write_submission(tmp_path / "j.csv", by_sample, tokens)
    assert (tmp_path / "t.csv").read_text() == (tmp_path / "j.csv").read_text()
    same(tsub.read_submission(tmp_path / "j.csv"), jsub.read_submission(tmp_path / "j.csv"))
    same(tsub.records_from_detections(by_sample), jsub.records_from_detections(by_sample))
    yawed = [dict(d, yaw=0.3) for d in det[:3]]
    same(tsub.detection_to_pred_string(yawed), jsub.detection_to_pred_string(yawed))


@pytest.fixture(scope="module")
def kitti_roots(dbs, tmp_path_factory):
    j, t = dbs
    return (jkitti.export_kitti(j, tmp_path_factory.mktemp("k") / "jax"),
            tkitti.export_kitti(t, tmp_path_factory.mktemp("k") / "port"))


def test_kitti_export_and_label_round_trip(kitti_roots, tmp_path):
    jroot, troot = kitti_roots
    stems = sorted(p.stem for p in (jroot / "label_2").glob("*.txt"))
    assert stems == sorted(p.stem for p in (troot / "label_2").glob("*.txt")) and len(stems) == 3
    for stem in stems:
        for sub, ext in (("label_2", "txt"), ("calib", "txt"), ("velodyne", "bin")):
            assert (troot / sub / f"{stem}.{ext}").read_bytes() == (
                jroot / sub / f"{stem}.{ext}").read_bytes()
        objs, ref = (m.read_label_file(jroot / "label_2" / f"{stem}.txt") for m in (tkitti, jkitti))
        assert [o.to_line() for o in objs] == [o.to_line() for o in ref] and len(objs) > 0
        assert [o.difficulty for o in objs] == [o.difficulty for o in ref]
        tkitti.write_label_file(tmp_path / "t.txt", objs)
        jkitti.write_label_file(tmp_path / "j.txt", ref)
        assert (tmp_path / "t.txt").read_text() == (tmp_path / "j.txt").read_text()
        tc, jc = (m.Calibration.from_file(jroot / "calib" / f"{stem}.txt") for m in (tkitti, jkitti))
        pts = np.random.RandomState(8).uniform(-20, 20, (10, 3))
        same(tc.lidar_to_rect(pts), jc.lidar_to_rect(pts))
        same(tc.rect_to_lidar(pts), jc.rect_to_lidar(pts))
        same(tc.rect_to_img(np.abs(pts) + 1), jc.rect_to_img(np.abs(pts) + 1))
        for o, r in zip(objs, ref):
            box_t = tkitti.box_camera_to_lidar(o.pos, (o.h, o.w, o.l), o.ry, tc)
            same(box_t, jkitti.box_camera_to_lidar(r.pos, (r.h, r.w, r.l), r.ry, jc))
            same(tkitti.box_lidar_to_camera(box_t, tc), jkitti.box_lidar_to_camera(box_t, jc))
    same(vars(tkitti.default_calibration()), vars(jkitti.default_calibration()))


@pytest.mark.parametrize("metric", ["3d", "bev"])
def test_kitti_recall_and_ap(metric):
    rng = np.random.RandomState(9)
    gt_frames, det_frames = [], []
    for _ in range(4):
        g = np.column_stack([rng.uniform(-20, 20, (5, 3)), rng.uniform(1.5, 4.5, (5, 3)),
                             rng.uniform(-np.pi, np.pi, 5)])
        d = np.concatenate([g + rng.randn(5, 7) * 0.15, g[:2] + 8.0])
        gt_frames.append({"boxes": g, "names": np.asarray(["car"] * 5),
                          "difficulty": np.zeros(5, np.int64)})
        det_frames.append({"boxes": d, "names": np.asarray(["car"] * 7), "scores": rng.rand(7)})
    for thr in (0.3, 0.5, 0.7):
        got = tkeval.recall_at(gt_frames, det_frames, "car", thr, metric=metric)
        assert got == jkeval.recall_at(gt_frames, det_frames, "car", thr, metric=metric)
    assert 0.0 < tkeval.recall_at(gt_frames, det_frames, "car", 0.5, metric=metric) <= 1.0
    same(tkeval.kitti_ap(gt_frames, det_frames, "car", 0.5, metric=metric),
         jkeval.kitti_ap(gt_frames, det_frames, "car", 0.5, metric=metric))
    same(tkeval.evaluate_kitti(gt_frames, det_frames, ["car"]),
         jkeval.evaluate_kitti(gt_frames, det_frames, ["car"]))


def test_second_loader_and_world_records(dbs):
    j, t = dbs
    classes = ["car", "pedestrian"]
    j_infos, t_infos = jsec.create_infos(j, num_sweeps=2), tsec.create_infos(t, num_sweeps=2)
    same(t_infos, j_infos)
    cfg = dict(max_points=4096, max_gt=16, num_sweeps=2, augment=False)
    jl = jsec.SecondSampleLoader(j, j_infos, classes, jsec.LoaderConfig(**cfg), seed=1)
    tl = tsec.SecondSampleLoader(t, t_infos, classes, tsec.LoaderConfig(**cfg), seed=1)
    tokens = [s["token"] for s in j.sample]
    for tok in tokens:
        same(tl.sample(tok, train=False), jl.sample(tok, train=False))
    same(tl.batch(tokens, train=False), jl.batch(tokens, train=False))
    rng = np.random.RandomState(10)
    boxes = np.column_stack([rng.uniform(-20, 20, (6, 3)), rng.uniform(1, 4, (6, 3)),
                             rng.uniform(-3, 3, 6)])
    args = (boxes, rng.rand(6), np.array([1, 2, 1, 0, 3, 2]), np.array([1, 1, 0, 1, 1, 1], bool),
            classes)
    same(tsec.detections_to_world_records(t_infos[0], *args),
         jsec.detections_to_world_records(j_infos[0], *args))
    # Training samples: the augmentations draw from the loader's RandomState
    # in the original's order, so equal seeds give equal arrays.
    aug = dict(cfg, augment=True)
    jl = jsec.SecondSampleLoader(j, j_infos, classes, jsec.LoaderConfig(**aug), seed=5)
    tl = tsec.SecondSampleLoader(t, t_infos, classes, tsec.LoaderConfig(**aug), seed=5)
    plain = tl.sample(tokens[0], train=False)
    for tok in tokens:
        same(tl.sample(tok), jl.sample(tok))
    same(tl.batch(tokens), jl.batch(tokens))
    assert not np.array_equal(tl.sample(tokens[0])["points"], plain["points"])


def test_second_loader_with_database_sampling(dbs, tmp_path):
    """GT database creation, class-balanced copy-paste sampling and the
    training sample that pastes from it, under equal seeds."""
    j, t = dbs
    classes = ["car", "pedestrian"]
    infos = tsec.create_infos(t, num_sweeps=1)
    plain = tsec.SecondSampleLoader(t, infos, classes, tsec.LoaderConfig(num_sweeps=1, augment=False))
    samples = [{"points": plain.load_points(i), "gt_boxes": i["gt_boxes"], "gt_names": i["gt_names"]}
               for i in infos]
    jaug.create_gt_database(tmp_path / "jdb", samples, min_points=1)
    taug.create_gt_database(tmp_path / "tdb", samples, min_points=1)
    jgt, tgt = jaug.GTDatabase(tmp_path / "jdb"), taug.GTDatabase(tmp_path / "tdb")
    assert tgt.classes() == jgt.classes() and tgt.classes()
    quota = {c: 6 for c in tgt.classes()}
    cfg = dict(max_points=8192, max_gt=32, num_sweeps=1, augment=True)
    jl = jsec.SecondSampleLoader(j, infos, classes, jsec.LoaderConfig(**cfg), seed=3,
                                 db_sampler=jaug.DataBaseSampler(jgt, quota, seed=7))
    tl = tsec.SecondSampleLoader(t, infos, classes, tsec.LoaderConfig(**cfg), seed=3,
                                 db_sampler=taug.DataBaseSampler(tgt, quota, seed=7))
    tokens = [s["token"] for s in t.sample]
    pasted = 0
    for tok in tokens:
        got, want = tl.sample(tok), jl.sample(tok)
        same(got, want)
        pasted += int(got["gt_valid"].sum()) - int(plain.sample(tok, train=False)["gt_valid"].sum())
    assert pasted > 0
    tsec.save_infos(infos, tmp_path / "infos.pkl")
    same(tsec.load_infos(tmp_path / "infos.pkl"), jsec.load_infos(tmp_path / "infos.pkl"))


AUG_CASES = {
    "random_flip": lambda m, p, b, r: m.random_flip(p, b, r, 0.9),
    "global_rotation": lambda m, p, b, r: m.global_rotation(p, b, r, (-0.4, 0.4)),
    "global_scaling": lambda m, p, b, r: m.global_scaling(p, b, r, (0.9, 1.1)),
    "global_translate": lambda m, p, b, r: m.global_translate(p, b, r),
    "noise_per_object": lambda m, p, b, r: m.noise_per_object(p, b, r),
    "box_collision_test": lambda m, p, b, r: m.box_collision_test(b[:4], b[2:]),
}


@pytest.mark.parametrize("case", sorted(AUG_CASES))
def test_augmentations(case):
    rng = np.random.RandomState(2)
    boxes = np.column_stack([rng.uniform(-15, 15, (6, 2)), rng.uniform(-1, 1, 6),
                             rng.uniform(1.5, 4, (6, 3)), rng.uniform(-3, 3, 6)])
    boxes[5, :2] = boxes[4, :2] + 0.5  # one colliding pair
    points = rng.uniform(-20, 20, (500, 4)).astype(np.float32)
    points[:240, :3] = (boxes[:, None, :3] + rng.uniform(-0.7, 0.7, (6, 40, 3))).reshape(-1, 3)
    fn = AUG_CASES[case]
    same(fn(taug, points.copy(), boxes.copy(), np.random.RandomState(8)),
         fn(jaug, points.copy(), boxes.copy(), np.random.RandomState(8)))


def test_config_copy(tmp_path):
    """Defaults, dict round trip, overrides, the yaml presets and the snapshot
    of the copy equal the original's (compared as plain dicts)."""
    for name in ("OptimizerConfig", "DataConfig", "BEVExperiment", "AnchorConfig", "SecondExperiment",
                 "PointRCNNExperiment"):
        assert tconfig.to_dict(getattr(tconfig, name)()) == jconfig.to_dict(getattr(jconfig, name)())
    repo = Path(__file__).resolve().parent.parent
    for cls, fname in (("SecondExperiment", "second_lyft_9class.yaml"),
                       ("SecondExperiment", "second_lyft_9class_sparse.yaml"),
                       ("BEVExperiment", "bev_seresnext101_map.yaml")):
        jexp = jconfig.load_yaml(getattr(jconfig, cls), repo / "configs" / fname)
        texp = tconfig.load_yaml(getattr(tconfig, cls), repo / "configs" / fname)
        assert tconfig.to_dict(texp) == jconfig.to_dict(jexp)
    overrides = ["optimizer.lr=0.5", "batch_size=3", "middle=sparse", "voxel_size=[0.1,0.1,0.2]"]
    jexp = jconfig.apply_overrides(jconfig.SecondExperiment(), overrides)
    texp = tconfig.apply_overrides(tconfig.SecondExperiment(), overrides)
    assert tconfig.to_dict(texp) == jconfig.to_dict(jexp)
    assert texp.optimizer.lr == 0.5 and texp.middle == "sparse" and tuple(texp.voxel_size) == (0.1, 0.1, 0.2)
    with pytest.raises(Exception):
        tconfig.apply_overrides(tconfig.SecondExperiment(), ["no_such_field=1"])
    jp, tp = jconfig.snapshot_config(jexp, tmp_path / "j"), tconfig.snapshot_config(texp, tmp_path / "t")
    assert tp.name == jp.name == "experiment.yaml"
    assert tconfig.to_dict(tconfig.load_yaml(tconfig.SecondExperiment, tp)) == tconfig.to_dict(texp)
    moved = tconfig.change_detection_range(texp, (-30, -30, -3, 30, 30, 1))
    assert dataclasses.asdict(moved) == dataclasses.asdict(
        jconfig.change_detection_range(jexp, (-30, -30, -3, 30, 30, 1)))


@pytest.mark.parametrize("kind", ["mapped", "mapped_unordered", "threaded", "prefetch"])
def test_prefetch_copy(kind):
    def run(m):
        work = lambda: iter(range(23))  # noqa: E731
        if kind.startswith("mapped"):
            it = m.MappedPrefetcher(work, lambda i: i * i, num_workers=3, depth=2,
                                    ordered=kind == "mapped")
        elif kind == "threaded":
            it = m.ThreadedPrefetcher(work, depth=3)
        else:
            return list(m.prefetch(range(23), depth=2))
        return list(iter(it))

    got, want = run(tprefetch), run(jprefetch)
    if kind == "mapped_unordered":
        got, want = sorted(got), sorted(want)
    assert got == want and len(got) == 23

    def boom(i):
        if i == 5:
            raise ValueError("bad item")
        return i

    if kind == "mapped":
        with pytest.raises(ValueError, match="bad item"):
            list(iter(tprefetch.MappedPrefetcher(lambda: iter(range(9)), boom, num_workers=2)))


def test_logging_copy(tmp_path):
    metrics = {"train": {"loss": 1.5, "parts": {"cls": np.float32(0.25)}, "note": "warm"}, "lr": 3}
    assert tlog.flatten_metrics(metrics) == jlog.flatten_metrics(metrics)
    logs = []
    for m, d in ((jlog, tmp_path / "j"), (tlog, tmp_path / "t")):
        log = m.MetricLog(d, use_tensorboard=False)
        log.log_text("hello", 1)
        log.log_metrics(metrics, 2)
        history = log.reload_history()
        log.close()
        for h in history:
            h.pop("ts")
        logs.append(((d / "log.txt").read_text(), history))
    assert logs[0] == logs[1]
    assert logs[1][1] == [{"step": 2, "train.loss": 1.5, "train.parts.cls": 0.25, "train.note": "warm", "lr": 3.0}]
    assert json.loads((tmp_path / "t" / "log.json.lst").read_text().splitlines()[0])["step"] == 2


@pytest.mark.parametrize("case", ["report", "disabled", "sentinel"])
def test_profiler_copy(case):
    """SectionTimers: the shared arithmetic (averages, report, clear) equal to
    the original's on the same totals; sections counted alike with a
    sentinel (a JAX array there, a tensor here) and without; disabled timers
    count nothing."""
    import torch

    timers = [m.SectionTimers(enabled=case != "disabled") for m in (jprof, tprof)]
    if case == "report":
        for t in timers:
            t.totals.update(prep=0.5, infer=1.25, postprocess=0.125)
            t.counts.update(prep=3, infer=5, postprocess=2)
        assert timers[1].averages_ms() == timers[0].averages_ms()
        assert timers[1].report() == timers[0].report() == "infer=250.00ms, postprocess=62.50ms, prep=166.67ms"
        for t in timers:
            t.clear()
        assert timers[1].report() == timers[0].report() == ""
    else:
        for t, sentinel in zip(timers, (np.ones(3), torch.ones(3))):
            for _ in range(3):
                with t.section("infer") as sec:
                    sec.set_sentinel(sentinel)
                with t.section("prep"):
                    pass
        counts = [dict(t.counts) for t in timers]
        assert counts[1] == counts[0] == ({} if case == "disabled" else {"infer": 3, "prep": 3})
        assert all(v >= 0 for v in timers[1].totals.values())


SPLIT_CASES = {
    "split_parts": lambda m, names: m.split_parts(names, 4),
    "split_parts_fewer_items_than_parts": lambda m, names: m.split_parts(names[:3], 4),
    "train_val_split": lambda m, names: m.train_val_split(names, seed=42),
    "train_val_split_one_item": lambda m, names: m.train_val_split(names[:1], seed=3),
}


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_splits_copy(case):
    names = [f"scene-{i:03d}" for i in range(23)]
    same(SPLIT_CASES[case](tsplits, names), SPLIT_CASES[case](jsplits, names))


def test_aug_scene_copy(kitti_roots, tmp_path):
    """``generate_aug_scenes`` on the exported tree with equal sampler seeds
    writes the same velodyne, calib and label files, pasted objects
    included."""
    jroot, _ = kitti_roots
    stems = sorted(p.stem for p in (jroot / "velodyne").glob("*.bin"))
    samples = []
    for stem in stems:
        calib = jkitti.Calibration.from_file(jroot / "calib" / f"{stem}.txt")
        objs = jkitti.read_label_file(jroot / "label_2" / f"{stem}.txt")
        samples.append({
            "points": np.fromfile(jroot / "velodyne" / f"{stem}.bin", np.float32).reshape(-1, 4),
            "gt_boxes": np.stack([jkitti.box_camera_to_lidar(o.pos, (o.h, o.w, o.l), o.ry, calib)
                                  for o in objs]),
            "gt_names": np.array([o.cls_type for o in objs]),
        })
    jaug.create_gt_database(tmp_path / "db", samples, min_points=1)
    classes = tuple(jaug.GTDatabase(tmp_path / "db").classes())
    outs = {}
    for name, aug, gen in (("jax", jaug, jaugscene), ("port", taug, taugscene)):
        sampler = aug.DataBaseSampler(aug.GTDatabase(tmp_path / "db"), {c: 4 for c in classes}, seed=2)
        outs[name] = gen.generate_aug_scenes(jroot, tmp_path / name, sampler, copies=2, classes=classes)
    files = sorted(p.relative_to(outs["jax"]) for p in outs["jax"].rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(outs["port"]) for p in outs["port"].rglob("*") if p.is_file())
    assert len(files) == 3 * 2 * len(stems)
    for rel in files:
        assert (outs["port"] / rel).read_bytes() == (outs["jax"] / rel).read_bytes(), rel
    grown = sum(len(jkitti.read_label_file(outs["jax"] / "label_2" / f"{stem}_0.txt"))
                > len(jkitti.read_label_file(jroot / "label_2" / f"{stem}.txt")) for stem in stems)
    assert grown > 0


def _vis_inputs(db):
    sample = db.sample[1]
    lidar = sample["data"]["LIDAR_TOP"]
    pts = np.fromfile(db.get_sample_data_path(lidar), np.float32).reshape(-1, 5)
    boxes = np.stack([b.as_xyzwlhr() for b in db.get_boxes_in_sensor_frame(lidar)])
    return sample, pts, boxes


VIS_CASES = {
    "points_to_bev_image": lambda m, db, s, pts, boxes: m.points_to_bev_image(pts, extent=40.0, resolution=0.2),
    "draw_boxes_bev": lambda m, db, s, pts, boxes: m.draw_boxes_bev(
        np.zeros((200, 200, 3), np.uint8), boxes, np.arange(len(boxes)), extent=16.0, thickness=2),
    "bev_debug_image": lambda m, db, s, pts, boxes: m.bev_debug_image(
        pts, boxes, boxes[::-1] + [1.0, 1.0, 0, 0, 0, 0, 0.5], extent=40.0, resolution=0.2),
    "map_pointcloud_to_image": lambda m, db, s, pts, boxes: m.map_pointcloud_to_image(
        db, s["data"]["LIDAR_TOP"], s["data"]["CAM_FRONT"]),
    "render_pointcloud_in_image": lambda m, db, s, pts, boxes: m.render_pointcloud_in_image(db, s["token"]),
    "render_boxes_in_image": lambda m, db, s, pts, boxes: m.render_boxes_in_image(db, s["token"]),
    "draw_box_edges_cv2": lambda m, db, s, pts, boxes: m.draw_box_edges_cv2(
        img := np.zeros((48, 64, 3), np.uint8), np.random.RandomState(2).uniform(0, 60, (2, 8)), (9, 200, 30)) or img,
}


@pytest.mark.parametrize("case", sorted(VIS_CASES))
def test_visualize_copy(dbs, case):
    """``utils/visualize.py``: every image equal to the original's on the
    same sample (each package's DB and boxes), and not blank."""
    outs = []
    for m, db in zip((jvis, tvis), dbs):
        sample, pts, boxes = _vis_inputs(db)
        outs.append(VIS_CASES[case](m, db, sample, pts, boxes))
    same(outs[1], outs[0])
    assert any(np.asarray(o).any() for o in (outs[1] if isinstance(outs[1], tuple) else [outs[1]]))


@pytest.mark.parametrize("total", [0, 1, 7])
def test_progress_copy(monkeypatch, total):
    """``ProgressBar`` writes the original's text on a clock that both read
    alike; ``progress_iter`` yields every item."""
    import io
    import itertools
    import time

    texts = []
    for m in (jprog, tprog):
        clock = itertools.count(100.0, 0.25)
        monkeypatch.setattr(time, "time", lambda: next(clock))
        out = io.StringIO()
        bar = m.ProgressBar(total, width=12, stream=out)
        for n in (1, 2, 3, 1):
            bar.update(n)
        texts.append(out.getvalue())
    assert texts[1] == texts[0] and texts[1].startswith("\r[")
    monkeypatch.undo()
    items = list(range(total))
    assert list(tprog.progress_iter(items)) == list(jprog.progress_iter(items)) == items


@pytest.mark.parametrize("case", ["simple_timer", "trace"])
def test_profiler_helpers_copy(tmp_path, capsys, case):
    """``simple_timer`` prints the original's line; ``trace`` (the
    counterpart of ``jax.profiler``'s) writes a ``torch.profiler`` trace
    file into its directory, with the operators of every thread."""
    import torch

    if case == "simple_timer":
        lines = []
        for m in (jprof, tprof):
            with m.simple_timer("stage"):
                pass
            lines.append(capsys.readouterr().out)
        assert all(re.fullmatch(r"stage elapsed: \d+\.\d{4}s\n", line) for line in lines)
        assert tprof.__all__ == jprof.__all__
    else:
        import threading

        def request():  # a server's request runs on a thread of its own
            torch.ones(8, 8).matmul(torch.ones(8, 8))

        with tprof.trace(str(tmp_path / "tb")) as prof:
            torch.ones(8).cumsum(0)
            worker = threading.Thread(target=request)
            worker.start()
            worker.join(timeout=60)
        assert not worker.is_alive() and prof is not None
        files = list((tmp_path / "tb").glob("*.pt.trace.json"))
        assert len(files) == 1
        names = {e.get("name", "") for e in json.loads(files[0].read_text())["traceEvents"]}
        assert {"aten::cumsum", "aten::mm"} <= names
