"""Self-contained browser frontend for the viewer backend (a copy of
``lyft3d_tpu/serve/frontend.py``: the same endpoints and JSON; only the title
and the model-loading status name the port).

Capability of the reference's three.js KITTI-viewer frontend
(``second/second/kittiviewer/frontend/``): load a dataset, step through
samples, see the point cloud with ground-truth and predicted boxes, and
trigger inference — served as ONE embedded HTML page (zero-egress: no CDN
scripts), rendered on a 2D BEV canvas with pan/zoom instead of WebGL.
"""

INDEX_HTML = r"""<!doctype html>
<html>
<head>
<meta charset="utf-8">
<title>lyft3d_tpu_torch viewer</title>
<style>
  body { margin:0; font:13px system-ui, sans-serif; background:#14161a; color:#d6d8de; }
  #bar { padding:8px 12px; background:#1d2026; display:flex; gap:8px; flex-wrap:wrap;
         align-items:center; border-bottom:1px solid #2a2e36; }
  #bar input { background:#14161a; color:#d6d8de; border:1px solid #3a3f49;
               border-radius:4px; padding:4px 6px; width:200px; }
  #bar button { background:#2f6fed; color:#fff; border:0; border-radius:4px;
                padding:5px 10px; cursor:pointer; }
  #bar button.sec { background:#3a3f49; }
  #status { color:#9aa0ab; margin-left:auto; }
  canvas { display:block; }
  #legend { position:fixed; right:10px; top:56px; background:#1d2026cc;
            padding:8px 10px; border-radius:6px; line-height:1.6; }
  .sw { display:inline-block; width:10px; height:10px; margin-right:6px;
        border-radius:2px; }
</style>
</head>
<body>
<div id="bar">
  <input id="root" placeholder="data_root" value=".">
  <input id="jsondir" placeholder="json_dir" value="data" style="width:90px">
  <button onclick="loadDataset()">Load dataset</button>
  <button class="sec" onclick="step(-1)">&#8592; prev</button>
  <select id="tokens" onchange="show()" style="max-width:220px"></select>
  <button class="sec" onclick="step(1)">next &#8594;</button>
  <input id="model" placeholder="model (e.g. unet_reference)" style="width:170px">
  <input id="ckpt" placeholder="ckpt dir (optional)" style="width:150px">
  <button onclick="loadModel()">Load model</button>
  <button onclick="detect()">Detect</button>
  <span id="status">no dataset</span>
</div>
<div id="legend">
  <span class="sw" style="background:#49c774"></span>ground truth<br>
  <span class="sw" style="background:#ff5d5d"></span>detection<br>
  <span class="sw" style="background:#5aa2ff"></span>lidar point<br>
  drag = pan &nbsp; wheel = zoom
</div>
<canvas id="cv"></canvas>
<script>
"use strict";
const cv = document.getElementById("cv"), ctx = cv.getContext("2d");
let view = {scale: 6, cx: 0, cy: 0};     // px per meter, center offset (m)
let sample = null, dets = null;
const S = document.getElementById("status");

function resize() {
  cv.width = innerWidth; cv.height = innerHeight - 46; draw();
}
addEventListener("resize", resize);

async function api(path, body) {
  const r = await fetch(path, body ? {method:"POST",
    headers:{"Content-Type":"application/json"}, body:JSON.stringify(body)} : {});
  return r.json();
}
async function loadDataset() {
  S.textContent = "loading dataset...";
  const r = await api("/api/load_dataset",
    {data_root: root.value, json_dir: jsondir.value});
  if (!r.ok) { S.textContent = "error: " + r.error; return; }
  const t = await api("/api/samples");
  tokens.innerHTML = t.tokens.map(x => `<option>${x}</option>`).join("");
  S.textContent = r.num_samples + " samples";
  show();
}
async function show() {
  if (!tokens.value) return;
  S.textContent = "fetching sample...";
  sample = await api("/api/sample?token=" + encodeURIComponent(tokens.value));
  dets = null;
  S.textContent = sample.points.length + " pts, " +
    sample.gt_boxes.length + " gt boxes";
  draw();
}
function step(d) {
  const i = Math.min(Math.max(tokens.selectedIndex + d, 0),
                     tokens.options.length - 1);
  tokens.selectedIndex = i; show();
}
async function loadModel() {
  S.textContent = "building model (the first detect sets up cuDNN)...";
  const r = await api("/api/load_model",
    {model: model.value || "unet_reference", ckpt_dir: ckpt.value || null});
  S.textContent = r.ok ? "model " + r.model + " ready" : "error: " + r.error;
}
async function detect() {
  if (!tokens.value) return;
  S.textContent = "running inference...";
  const r = await api("/api/detect?token=" + encodeURIComponent(tokens.value));
  if (r.error) { S.textContent = "error: " + r.error; return; }
  dets = r.boxes_sensor;
  S.textContent = dets.length + " detections";
  draw();
}
// world(m, sensor frame: x right, y up) -> screen px
function sx(x) { return cv.width / 2 + (x - view.cx) * view.scale; }
function sy(y) { return cv.height / 2 - (y - view.cy) * view.scale; }
function drawBox(b, color, label) {
  const [x, y, , w, l, , r] = [b[0], b[1], b[2], b[3], b[4], b[5], b[6]];
  const c = Math.cos(r), s = Math.sin(r);
  const pts = [[l/2, w/2], [l/2, -w/2], [-l/2, -w/2], [-l/2, w/2]]
    .map(([u, v]) => [x + u * c - v * s, y + u * s + v * c]);
  ctx.strokeStyle = color; ctx.lineWidth = 1.5;
  ctx.beginPath();
  pts.forEach(([px, py], i) => i ? ctx.lineTo(sx(px), sy(py))
                                 : ctx.moveTo(sx(px), sy(py)));
  ctx.closePath(); ctx.stroke();
  // heading tick
  ctx.beginPath();
  ctx.moveTo(sx(x), sy(y));
  ctx.lineTo(sx(x + (l/2) * c), sy(y + (l/2) * s));
  ctx.stroke();
  if (label && view.scale > 3) {
    ctx.fillStyle = color; ctx.fillText(label, sx(x) + 4, sy(y) - 4);
  }
}
function draw() {
  ctx.fillStyle = "#14161a"; ctx.fillRect(0, 0, cv.width, cv.height);
  // range rings every 20 m
  ctx.strokeStyle = "#23272f"; ctx.lineWidth = 1;
  for (let r = 20; r <= 100; r += 20) {
    ctx.beginPath();
    ctx.arc(sx(0), sy(0), r * view.scale, 0, 7); ctx.stroke();
  }
  if (!sample) return;
  ctx.fillStyle = "#5aa2ff";
  for (const p of sample.points) {
    ctx.fillRect(sx(p[0]) - .75, sy(p[1]) - .75, 1.5, 1.5);
  }
  for (const g of sample.gt_boxes) drawBox(g.box, "#49c774", g.name);
  if (dets) for (const d of dets) {
    drawBox(d.box, "#ff5d5d", d.name + " " + d.score.toFixed(2));
  }
}
let drag = null;
cv.onmousedown = e => drag = [e.clientX, e.clientY];
cv.onmouseup = () => drag = null;
cv.onmousemove = e => {
  if (!drag) return;
  view.cx -= (e.clientX - drag[0]) / view.scale;
  view.cy += (e.clientY - drag[1]) / view.scale;
  drag = [e.clientX, e.clientY]; draw();
};
cv.onwheel = e => {
  e.preventDefault();
  view.scale *= e.deltaY < 0 ? 1.15 : 1 / 1.15;
  view.scale = Math.min(Math.max(view.scale, 0.5), 100); draw();
};
resize();
</script>
</body>
</html>
"""
