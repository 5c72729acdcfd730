"""The port's viewer (``lyft3d_tpu_torch/serve/viewer.py``) against the JAX
package's on one synthetic tree, on the CPU: each on its own
``ThreadingHTTPServer`` at ``127.0.0.1:0``, the host endpoints give equal
JSON; the port's detect equals its BEV pipeline called directly, and its
sensor-frame boxes equal the JAX viewer's transform of the same records;
``load_model`` restores a checkpoint's tensors."""

import json
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

import lyft3d_tpu.serve.viewer as jviewer
import lyft3d_tpu_torch.serve.viewer as tviewer
from lyft3d_tpu.data.synthetic import make_synthetic_lyft
from lyft3d_tpu_torch.train import checkpoint as ckpt

MODEL = "unet_reference"
# Local requests only: no proxy from the environment.
_OPENER = urllib.request.build_opener(urllib.request.ProxyHandler({}))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_synthetic_lyft(tmp_path_factory.mktemp("serve") / "lyft", num_scenes=1,
                               samples_per_scene=2, points_per_sweep=2048, seed=5)


def _start(module, state):
    """The module's Handler on a free local port, with ``state`` as its
    ``STATE``; returns (base url, stop)."""
    saved = module.STATE
    module.STATE = state
    server = ThreadingHTTPServer(("127.0.0.1", 0), module.Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()

    def stop():
        server.shutdown()
        server.server_close()
        thread.join()
        module.STATE = saved

    return f"http://127.0.0.1:{server.server_address[1]}", stop


def _get(base, path):
    return json.loads(_OPENER.open(base + path).read())


def _post(base, path, payload):
    req = urllib.request.Request(base + path, data=json.dumps(payload).encode(), method="POST")
    return json.loads(_OPENER.open(req).read())


def _error(base, path):
    with pytest.raises(urllib.error.HTTPError) as err:
        _OPENER.open(base + path)
    return err.value.code, json.loads(err.value.fp.read())


@pytest.fixture(scope="module")
def servers(root):
    """(JAX base url, port base url, port state), the dataset loaded into
    neither yet."""
    jbase, jstop = _start(jviewer, jviewer.ViewerState())
    state = tviewer.ViewerState(device="cpu")
    tbase, tstop = _start(tviewer, state)
    yield jbase, tbase, state
    jstop()
    tstop()


@pytest.fixture(scope="module")
def loaded(servers, root):
    jbase, tbase, state = servers
    replies = [_post(b, "/api/load_dataset", {"data_root": str(root)}) for b in (jbase, tbase)]
    assert replies[0] == replies[1] == {"ok": True, "num_samples": 2}
    return servers


@pytest.fixture(scope="module")
def detected(loaded):
    """The port's model loaded over HTTP and one detect per token."""
    _, tbase, state = loaded
    assert _post(tbase, "/api/load_model", {"model": MODEL}) == {"ok": True, "model": MODEL}
    tokens = _get(tbase, "/api/samples")["tokens"]
    return state, {tok: _get(tbase, f"/api/detect?token={tok}") for tok in tokens}


def test_frontend_page_and_detect_before_a_model(servers):
    """``/`` serves the page with its canvas; detect before load_model is a
    500 with an ``error`` payload in both packages."""
    jbase, tbase, _ = servers
    page = _OPENER.open(tbase + "/").read().decode()
    assert "lyft3d_tpu_torch viewer" in page and "<canvas" in page
    jpage = _OPENER.open(jbase + "/").read().decode()
    assert page.count("/api/") == jpage.count("/api/") > 0
    for base in (jbase, tbase):
        code, payload = _error(base, "/api/detect?token=x")
        assert code == 500 and "error" in payload
        code, payload = _error(base, "/api/nowhere")
        assert code == 404 and payload == {"error": "unknown endpoint"}


@pytest.mark.parametrize("endpoint", ["samples", "sample", "bev_image"])
def test_host_endpoints_equal_the_jax_viewer(loaded, endpoint):
    jbase, tbase, _ = loaded
    tokens = _get(jbase, "/api/samples")["tokens"]
    paths = {
        "samples": ["/api/samples"],
        "sample": [f"/api/sample?token={t}&max_points=500" for t in tokens],
        "bev_image": [f"/api/bev_image?token={t}" for t in tokens],
    }[endpoint]
    for path in paths:
        got, want = _get(tbase, path), _get(jbase, path)
        assert got == want, path
    if endpoint == "sample":
        assert len(got["points"]) == 500 and len(got["gt_boxes"]) > 0


def test_detect_equals_the_pipeline(detected):
    """Each /api/detect answer: ``boxes_world`` is the port's pipeline called
    directly (held to the JAX pipeline by test_torch_bev_pipeline.py)."""
    state, answers = detected
    n = 0
    for tok, det in answers.items():
        direct = state.pipeline.detect_all([tok], batch_size=1)[tok]
        assert det["token"] == tok
        assert det["boxes_world"] == json.loads(json.dumps(direct))
        assert len(det["boxes_sensor"]) == len(direct)
        n += len(direct)
    assert n > 0, "the random model detected nothing; the transform check would be empty"


def test_sensor_boxes_equal_the_jax_viewer(detected, root):
    """The JAX viewer's ``detect``, its pipeline replaced by a stub that
    returns the port's records, gives the port's ``boxes_sensor``: the
    world → sensor transform compared across the packages without the JAX
    viewer's bfloat16 model."""
    from lyft3d_tpu.data.lyftdb import LyftDB

    state, answers = detected

    class Stub:
        def detect_all(self, tokens, batch_size=8):
            assert batch_size == 1
            return {t: answers[t]["boxes_world"] for t in tokens}

    jstate = jviewer.ViewerState()
    jstate.db = LyftDB(root, root / "data")
    jstate.pipeline = Stub()
    for tok, det in answers.items():
        want = json.loads(json.dumps(jstate.detect(tok)))
        assert det == want


@pytest.mark.parametrize("layout", ["train_state", "state_dict"])
def test_load_model_restores_a_checkpoint(root, tmp_path, monkeypatch, layout):
    """``load_model(model, ckpt_dir)`` restores the latest ``model``
    checkpoint's tensors (a train state's snapshot or a bare ``state_dict``,
    as ``train-bev``'s ``init_from`` does); without one the seeded init stays."""
    import lyft3d_tpu_torch.models as models

    state = tviewer.ViewerState(device="cpu")
    state.load(str(root))
    donor = models.build_model(MODEL, n_classes=10, generator=torch.Generator().manual_seed(7))
    sd = donor.state_dict()
    snapshot = {"model": sd, "masters": []} if layout == "train_state" else sd
    ckpt.save(tmp_path / "run", snapshot, name=MODEL, global_step=3)

    built = []
    real = models.build_model
    monkeypatch.setattr(models, "build_model", lambda *a, **k: built.append(real(*a, **k)) or built[-1])
    assert state.load_model(MODEL, str(tmp_path / "run")) == MODEL
    got = built[-1].state_dict()
    assert got.keys() == sd.keys()
    for key in sd:
        assert torch.equal(got[key], sd[key]), key

    state.load_model(MODEL, str(tmp_path / "empty"))
    fresh = real(MODEL, n_classes=10, generator=torch.Generator().manual_seed(0)).state_dict()
    assert all(torch.equal(built[-1].state_dict()[k], fresh[k]) for k in fresh)


def test_the_card_is_the_default():
    """``serve`` and ``load_model`` default to the card and raise without one."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tviewer.serve(0)
    state = tviewer.ViewerState()
    state.db = object()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        state.load_model(MODEL)
    with pytest.raises(SystemExit, match="no CUDA card"):
        from lyft3d_tpu_torch.cli import main

        main(["serve", "--port", "0"])


def test_concurrent_detects_equal_sequential_ones(detected):
    """Four client threads at once get the sequential answers."""
    state, answers = detected
    base, stop = _start(tviewer, state)
    try:
        tokens = list(answers) * 2
        out = [None] * len(tokens)

        def ask(i):
            out[i] = _get(base, f"/api/detect?token={tokens[i]}")

        threads = [threading.Thread(target=ask, args=(i,)) for i in range(len(tokens))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        stop()
    assert not any(t.is_alive() for t in threads)
    assert all(o == answers[t] for o, t in zip(out, tokens))
    assert np.isfinite([b["score"] for o in out for b in o["boxes_sensor"]]).all()


def test_raster_launch_count_loses_no_update_across_threads(monkeypatch):
    """The viewer's server threads launch the raster kernel at once: its
    launch count, taken under a lock, loses no update (16 threads, the
    kernel's library and the card's stream stubbed, a short switch
    interval)."""
    import sys

    from lyft3d_tpu_torch.ops import bev_raster

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(bev_raster, "_kernel_library", lambda: (lambda *args: 0))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: Stream())
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(bev_raster, "KERNEL_LAUNCHES", 0)
    pts, valid = torch.zeros(1, 8, 3), torch.ones(1, 8, dtype=torch.bool)

    def launches():
        for _ in range(200):
            bev_raster._bev_rasterize_cuda(pts, valid, (4, 4, 2), (1.0, 1.0, 1.0), 0.0)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=launches) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert bev_raster.KERNEL_LAUNCHES == 16 * 200
