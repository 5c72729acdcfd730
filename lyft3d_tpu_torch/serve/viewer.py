"""Dataset/detection viewer backend — JSON over HTTP (stdlib, no flask);
port of ``lyft3d_tpu/serve/viewer.py``.

Capability of the reference's KITTI viewer backend
(``second/second/kittiviewer/backend/main.py``: flask endpoints to load a
dataset, fetch a sample's point cloud + GT boxes, and run inference with a
built network; the three.js frontend consumes JSON). Endpoints:

    GET  /                   self-contained canvas frontend (serve/frontend.py)
    POST /api/load_dataset   {"data_root": ..., "json_dir": ...}
    POST /api/load_model     {"model": ..., "ckpt_dir": optional}
    GET  /api/samples                         → token list
    GET  /api/sample?token=...&max_points=N   → points + gt boxes
    GET  /api/detect?token=...                → BEV-pipeline detections
    GET  /api/bev_image?token=...             → base64 PNG debug render (cv2)

The model runs on the first CUDA card in bfloat16 (``device="cuda"``, the
default; loading a model raises without a card) or on the CPU in float32
(``device="cpu"``). Requests are served on the server's threads; each
``/api/detect`` is one batch-1 pass of the BEV pipeline, one launch of the
raster kernel on the card.

Run: ``python -m lyft3d_tpu_torch.serve.viewer --port 16666 [--device cpu]``.
"""

from __future__ import annotations

import base64
import json
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np


def _device(name):
    import torch

    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "viewer device cuda: torch.cuda.is_available() is false; no CUDA card is "
            "visible. Pass device='cpu' (--device cpu) to run on the CPU."
        )
    return device


def sensor_boxes(db, token: str, records):
    """World-frame detection records → boxes in the sample's lidar sensor
    frame (for overlay on /api/sample points)."""
    from lyft3d_tpu_torch.core.box import Box
    from lyft3d_tpu_torch.core.quaternion import quat_inverse

    sd = db.get("sample_data", db.get("sample", token)["data"]["LIDAR_TOP"])
    pose = db.get("ego_pose", sd["ego_pose_token"])
    cs = db.get("calibrated_sensor", sd["calibrated_sensor_token"])
    sensor = []
    for r in records:
        box = Box(
            center=np.asarray(r["translation"], np.float64),
            wlh=np.asarray(r["size"], np.float64),
            orientation=np.asarray(r["rotation"], np.float64),
            name=r["name"],
        )
        box.translate(-np.asarray(pose["translation"]))
        box.rotate(quat_inverse(pose["rotation"]))
        box.translate(-np.asarray(cs["translation"]))
        box.rotate(quat_inverse(cs["rotation"]))
        sensor.append(
            {
                "box": np.round(box.as_xyzwlhr(), 3).tolist(),
                "name": r["name"],
                "score": float(r["score"]),
            }
        )
    return sensor


class ViewerState:
    def __init__(self, device="cuda"):
        self.db = None
        self.pipeline = None
        self.model_name = None
        self.device = device

    def load(self, data_root: str, json_dir: str = "data"):
        from pathlib import Path

        from lyft3d_tpu_torch.data.lyftdb import LyftDB

        self.db = LyftDB(data_root, Path(data_root) / json_dir)
        return [s["token"] for s in self.db.sample]

    def sample(self, token: str, max_points: int = 20000):
        from lyft3d_tpu_torch.data.pointcloud import LidarPointCloud

        sd_token = self.db.get("sample", token)["data"]["LIDAR_TOP"]
        pc = LidarPointCloud.from_file(self.db.get_sample_data_path(sd_token))
        pts = pc.points
        if len(pts) > max_points:
            idx = np.random.RandomState(0).choice(len(pts), max_points, replace=False)
            pts = pts[idx]
        boxes = self.db.get_boxes_in_sensor_frame(sd_token)
        return {
            "token": token,
            "points": np.round(pts, 3).tolist(),
            "gt_boxes": [
                {"box": np.round(b.as_xyzwlhr(), 3).tolist(), "name": b.name}
                for b in boxes
            ],
        }

    def load_model(self, model: str, ckpt_dir: str | None = None):
        """Build the BEV inference pipeline (the reference viewer's
        buildNet/inference endpoints, kittiviewer/backend/main.py): the
        named model from a seeded initialisation, with the shape-matching
        weights of the latest ``model`` checkpoint of ``ckpt_dir`` where
        there is one."""
        import torch

        from lyft3d_tpu_torch.data.bev_pipeline import BEVConfig
        from lyft3d_tpu_torch.models import build_model
        from lyft3d_tpu_torch.pipelines.bev import BEVInferencePipeline

        if self.db is None:
            raise RuntimeError("load a dataset first")
        device = _device(self.device)
        dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
        net = build_model(model, n_classes=10, device=device, dtype=dtype,
                          generator=torch.Generator().manual_seed(0))
        if ckpt_dir:
            from lyft3d_tpu_torch.train import checkpoint as ckpt

            snapshot, step = ckpt.restore_latest(ckpt_dir, name=model)
            if step is not None:
                ckpt.load_partial(net, snapshot)
        self.pipeline = BEVInferencePipeline(self.db, [net], BEVConfig(), device=device)
        self.model_name = model
        return model

    def detect(self, token: str):
        """Run the BEV pipeline on one sample; boxes returned both in world
        frame (submission records) and the lidar sensor frame (for overlay
        on /api/sample points)."""
        if self.pipeline is None:
            raise RuntimeError("load a model first")
        records = self.pipeline.detect_all([token], batch_size=1)[token]
        return {"token": token, "boxes_world": records,
                "boxes_sensor": sensor_boxes(self.db, token, records)}

    def bev_image(self, token: str) -> str:
        import cv2

        from lyft3d_tpu_torch.core.box import boxes_to_xyzwlhr
        from lyft3d_tpu_torch.data.pointcloud import LidarPointCloud
        from lyft3d_tpu_torch.utils.visualize import bev_debug_image

        sd_token = self.db.get("sample", token)["data"]["LIDAR_TOP"]
        pc = LidarPointCloud.from_file(self.db.get_sample_data_path(sd_token))
        gt = boxes_to_xyzwlhr(self.db.get_boxes_in_sensor_frame(sd_token))
        img = bev_debug_image(pc.points, gt_boxes=gt)
        ok, png = cv2.imencode(".png", img)
        return base64.b64encode(png.tobytes()).decode()


STATE = ViewerState()


class Handler(BaseHTTPRequestHandler):
    def _send(self, payload, status=200):
        body = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.send_header("Access-Control-Allow-Origin", "*")
        self.end_headers()
        self.wfile.write(body)

    def do_POST(self):
        n = int(self.headers.get("Content-Length", 0))
        data = json.loads(self.rfile.read(n) or b"{}")
        try:
            if self.path == "/api/load_dataset":
                tokens = STATE.load(data["data_root"], data.get("json_dir", "data"))
                self._send({"ok": True, "num_samples": len(tokens)})
            elif self.path == "/api/load_model":
                name = STATE.load_model(
                    data.get("model", "unet_reference"), data.get("ckpt_dir")
                )
                self._send({"ok": True, "model": name})
            else:
                self._send({"error": "unknown endpoint"}, 404)
        except Exception as e:
            self._send({"ok": False, "error": str(e)}, 400)

    def do_GET(self):
        url = urllib.parse.urlparse(self.path)
        q = dict(urllib.parse.parse_qsl(url.query))
        try:
            if url.path in ("/", "/index.html"):
                from lyft3d_tpu_torch.serve.frontend import INDEX_HTML

                body = INDEX_HTML.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif url.path == "/api/samples":
                self._send({"tokens": [s["token"] for s in STATE.db.sample]})
            elif url.path == "/api/sample":
                self._send(STATE.sample(q["token"], int(q.get("max_points", 20000))))
            elif url.path == "/api/detect":
                self._send(STATE.detect(q["token"]))
            elif url.path == "/api/bev_image":
                self._send({"png_base64": STATE.bev_image(q["token"])})
            else:
                self._send({"error": "unknown endpoint"}, 404)
        except Exception as e:
            self._send({"error": str(e)}, 500)

    def log_message(self, *args):
        pass


def serve(port: int = 16666, device="cuda"):
    """Serve the viewer on ``port`` until interrupted; the model runs on
    ``device`` (raises at once for ``cuda`` without a card)."""
    global STATE
    STATE = ViewerState(_device(device))
    server = ThreadingHTTPServer(("0.0.0.0", port), Handler)
    print(f"viewer backend on :{port} ({STATE.device})")
    server.serve_forever()


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, default=16666)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
    serve(args.port, args.device)
