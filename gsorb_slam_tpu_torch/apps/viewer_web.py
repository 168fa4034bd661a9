"""Interactive free-view map viewer served over HTTP (counterpart of
``gsorb_slam_tpu/apps/viewer_web.py``).

The equivalent of the reference's GLFW/ImGui viewer (``src/Viewer2.cc`` +
``src/imgui/``: free-view Gaussian-splat rendering with mouse and keyboard
navigation). A small stdlib HTTP server renders the requested poses with
the port's rasterizer (``Render::Viwer`` semantics,
``src/Render.cc:179-193``; K3 on the card, its plain version with
``--cpu``), one render at a time on the serving thread, and a browser
client provides the interaction:

- drag          orbit around the target
- shift-drag    pan the target
- wheel         dolly in/out
- R             reset view
- V             toggle the splat render and the map drawing

Usage:
    python -m gsorb_slam_tpu_torch.apps.viewer_web --ply out/GaussianModel.ply \\
        --config cfg.json --port 8008 [--cpu]
Then open http://localhost:8008/.
"""

from __future__ import annotations

import argparse
import io
import json
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer

import numpy as np

_PAGE = """<!doctype html>
<html><head><title>gsorb_slam_tpu_torch viewer</title><style>
body { margin:0; background:#111; color:#ccc; font:13px monospace; }
#hud { position:fixed; top:8px; left:8px; }
canvas { display:block; margin:auto; }
</style></head><body>
<div id="hud">drag: orbit &nbsp; shift-drag: pan &nbsp; wheel: dolly &nbsp; R: reset &nbsp; V: splats/map</div>
<canvas id="c"></canvas>
<script>
const c = document.getElementById('c'), ctx = c.getContext('2d');
let state = null, busy = false, dirty = true;
async function init() {
  const r = await fetch('/state'); state = await r.json();
  c.width = state.width; c.height = state.height; loop();
}
async function loop() {
  if (dirty && !busy) {
    busy = true; dirty = false;
    const r = await fetch('/render', {method:'POST', body: JSON.stringify(state)});
    const blob = await r.blob();
    const img = await createImageBitmap(blob);
    ctx.drawImage(img, 0, 0);
    busy = false;
  }
  requestAnimationFrame(loop);
}
let drag = null;
c.onmousedown = e => drag = {x:e.clientX, y:e.clientY, pan:e.shiftKey};
window.onmouseup = () => drag = null;
window.onmousemove = e => {
  if (!drag) return;
  const dx = e.clientX - drag.x, dy = e.clientY - drag.y;
  drag.x = e.clientX; drag.y = e.clientY;
  if (drag.pan) { state.pan_x -= dx * state.dist * 0.002;
                  state.pan_y -= dy * state.dist * 0.002; }
  else { state.yaw += dx * 0.008; state.pitch += dy * 0.008; }
  dirty = true;
};
c.onwheel = e => { e.preventDefault();
  state.dist *= Math.exp(e.deltaY * 0.001); dirty = true; };
window.onkeydown = e => {
  if (e.key == 'r' || e.key == 'R') {
    state.yaw = 0; state.pitch = 0; state.pan_x = 0; state.pan_y = 0;
    state.dist = state.dist0; dirty = true; }
  if (e.key == 'v' || e.key == 'V') {
    state.mode = state.mode == 'map' ? 'splat' : 'map'; dirty = true; }
};
init();
</script></body></html>"""


def orbit_pose(center: np.ndarray, yaw: float, pitch: float, dist: float,
               pan_x: float = 0.0, pan_y: float = 0.0) -> np.ndarray:
    """T_cw for a camera orbiting ``center`` (y-down convention)."""
    target = np.asarray(center, np.float64).copy()
    cp, sp = np.cos(pitch), np.sin(pitch)
    cy, sy = np.cos(yaw), np.sin(yaw)
    offset = dist * np.array([sy * cp, -sp, -cy * cp])
    eye = target + offset
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    up = np.array([0.0, -1.0, 0.0])
    right = np.cross(up, fwd)
    nr = np.linalg.norm(right)
    if nr < 1e-6:
        right = np.array([1.0, 0.0, 0.0])
    else:
        right = right / nr
    up2 = np.cross(fwd, right)
    # pan shifts both eye and target in the image plane
    eye = eye + pan_x * right + pan_y * up2
    R_wc = np.stack([right, up2, fwd], axis=1)
    T_cw = np.eye(4, dtype=np.float32)
    T_cw[:3, :3] = R_wc.T
    T_cw[:3, 3] = (-R_wc.T @ eye).astype(np.float32)
    return T_cw


def encode_jpeg(img01: np.ndarray) -> bytes:
    """RGB float [0,1] -> JPEG bytes (cv2 if present, else PNG via PIL)."""
    arr = (np.clip(img01, 0, 1) * 255).astype(np.uint8)
    try:
        import cv2

        ok, buf = cv2.imencode(".jpg", cv2.cvtColor(arr, cv2.COLOR_RGB2BGR),
                               [cv2.IMWRITE_JPEG_QUALITY, 88])
        return buf.tobytes()
    except Exception:
        from PIL import Image

        b = io.BytesIO()
        Image.fromarray(arr).save(b, format="PNG")
        return b.getvalue()


def encode_jpeg(img01: np.ndarray) -> bytes:
    """RGB float [0, 1] -> JPEG bytes (cv2), else PNG bytes (Pillow)."""
    arr = (np.clip(img01, 0, 1) * 255).astype(np.uint8)
    try:
        import cv2
    except ImportError:
        from PIL import Image

        b = io.BytesIO()
        Image.fromarray(arr).save(b, format="PNG")
        return b.getvalue()
    _ok, buf = cv2.imencode(".jpg", cv2.cvtColor(arr, cv2.COLOR_RGB2BGR),
                            [cv2.IMWRITE_JPEG_QUALITY, 88])
    return buf.tobytes()


class ViewerServer:
    """Serves the interaction page and renders requested orbit states."""

    def __init__(self, render_fn, width: int, height: int,
                 center: np.ndarray, dist0: float, map_state_fn=None):
        """``render_fn(T_cw)`` returns an ``[H, W, 3]`` image in [0, 1] (numpy).
        ``map_state_fn`` (optional): a zero-argument callable returning a
        dict with ``points`` [N, 3] (and optionally ``active``, the
        ``kf_T_cw`` list, ``graph_edges``, ``cur_T_cw``, ``trajectory``) as
        numpy arrays; it enables the 'map' view mode (the live MapDrawer
        role: points, frusta and the graph)."""
        self.render_fn = render_fn
        self.map_state_fn = map_state_fn
        self.state0 = dict(
            width=width, height=height, yaw=0.0, pitch=0.0,
            pan_x=0.0, pan_y=0.0, dist=dist0, dist0=dist0, mode="splat",
        )
        self.center = np.asarray(center, np.float64)
        self._lock = threading.Lock()

    def render_state(self, st: dict) -> bytes:
        T_cw = orbit_pose(
            self.center, float(st.get("yaw", 0.0)), float(st.get("pitch", 0.0)),
            float(st.get("dist", self.state0["dist0"])),
            float(st.get("pan_x", 0.0)), float(st.get("pan_y", 0.0)),
        )
        if st.get("mode") == "map" and self.map_state_fn is not None:
            from gsorb_slam_tpu_torch.utils.drawing import draw_map_3d

            ms = self.map_state_fn()
            img = draw_map_3d(
                ms["points"], T_cw,
                int(self.state0["width"]), int(self.state0["height"]),
                active=ms.get("active"), kf_T_cw=ms.get("kf_T_cw"),
                graph_edges=ms.get("graph_edges"),
                cur_T_cw=ms.get("cur_T_cw"),
                trajectory=ms.get("trajectory"),
            ) / 255.0
            return encode_jpeg(img)
        with self._lock:  # one render at a time (one device)
            img = self.render_fn(T_cw)
        return encode_jpeg(np.asarray(img))

    @classmethod
    def from_system(cls, system, scale: float = 1.0):
        """Live in-run viewer over a running port
        :class:`~gsorb_slam_tpu_torch.slam.system.System` (the reference's
        Viewer thread attached to Tracking and the Map): splat mode renders
        the current map from any pose (``System.render_view``; a ``scale``
        other than 1 renders the map at that resolution), map mode draws
        its points, keyframe frusta, the odometry graph and the trajectory.
        The map stays on its device: the active points are selected there,
        and only what is drawn moves to the host."""
        import torch

        from gsorb_slam_tpu_torch.raster import render

        cam = system.cam.scaled(scale) if scale != 1.0 else system.cam

        def render_fn(T_cw):
            with torch.no_grad():
                if scale == 1.0:
                    out = system.render_view(np.asarray(T_cw, np.float32))
                else:
                    gm = system.gm
                    out = render(gm.means, gm.rgb, gm.quats, gm.logit_opacities,
                                 gm.log_scales, gm.active,
                                 torch.as_tensor(np.asarray(T_cw, np.float32),
                                                 device=gm.means.device), cam, system.rcfg)
            return out.color.cpu().numpy()

        def active_points():
            gm = system.gm
            return gm.means[gm.active]

        def map_state_fn():
            kfs = list(system.keyframes)
            idx = {kf.kf_id: i for i, kf in enumerate(kfs)}
            edges = []
            for kf in kfs:
                par = getattr(kf, "parent_id", -1)
                if par >= 0 and par in idx:
                    edges.append((idx[par], idx[kf.kf_id]))
            edges.extend((i, i + 1) for i in range(len(kfs) - 1))
            traj = np.stack([-r.T_cw[:3, :3].T @ r.T_cw[:3, 3] for r in system.trajectory]
                            ) if system.trajectory else None
            return dict(points=active_points().cpu().numpy(), kf_T_cw=[kf.T_cw for kf in kfs],
                        graph_edges=edges, cur_T_cw=system.last_T_cw, trajectory=traj)

        pts = active_points()
        if pts.shape[0] > 0:
            center_t = pts.mean(dim=0)
            center = center_t.cpu().numpy().astype(np.float64)
            dist0 = float((pts - center_t).norm(dim=1).mean()) * 2.0
        else:
            center, dist0 = np.zeros(3), 2.0
        return cls(render_fn, cam.width, cam.height, center, dist0, map_state_fn=map_state_fn)

    def handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                if self.path == "/" or self.path.startswith("/index"):
                    body = _PAGE.encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                elif self.path == "/state":
                    body = json.dumps(server.state0).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                else:
                    self.send_response(404)
                    body = b"not found"
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):
                if self.path != "/render":
                    self.send_response(404)
                    self.end_headers()
                    return
                n = int(self.headers.get("Content-Length", "0"))
                st = json.loads(self.rfile.read(n) or b"{}")
                body = server.render_state(st)
                self.send_response(200)
                self.send_header("Content-Type", "image/jpeg")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        return Handler

    def serve(self, host: str = "127.0.0.1", port: int = 8008):
        httpd = HTTPServer((host, port), self.handler())
        print(f"viewer at http://{host}:{port}/", flush=True)
        httpd.serve_forever()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ply", required=True)
    ap.add_argument("--config", required=True)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8008)
    ap.add_argument("--scale", type=float, default=1.0,
                    help="render-resolution scale vs the config camera")
    ap.add_argument("--cpu", action="store_true", help="render on the CPU (plain versions)")
    args = ap.parse_args(argv)

    import torch

    from gsorb_slam_tpu_torch.core.camera import Camera
    from gsorb_slam_tpu_torch.core.config import load_config
    from gsorb_slam_tpu_torch.eval.ply import load_gaussian_ply
    from gsorb_slam_tpu_torch.raster import RasterConfig, render

    device = "cpu" if args.cpu else "cuda"
    cc = load_config(args.config).camera
    cam = Camera(fx=cc.fx, fy=cc.fy, cx=cc.cx, cy=cc.cy, width=cc.width,
                 height=cc.height).scaled(args.scale)
    model = load_gaussian_ply(args.ply)
    p = {k: torch.as_tensor(np.array(v, np.float32), device=device) for k, v in model.items()}
    active = torch.ones(len(model["means"]), dtype=torch.bool, device=device)
    rcfg = RasterConfig(tile=16, tile_capacity=1024, max_dup=16, chunk=128, exact_stop=False)

    def render_fn(T_cw):
        with torch.no_grad():
            return render(p["means"], p["rgb"], p["quats"], p["logit_opacities"],
                          p["log_scales"], active,
                          torch.as_tensor(np.asarray(T_cw, np.float32), device=device),
                          cam, rcfg).color.cpu().numpy()

    center = np.asarray(model["means"]).mean(axis=0)
    dist0 = float(np.linalg.norm(np.asarray(model["means"]) - center, axis=1).mean()) * 2.0
    ViewerServer(render_fn, cam.width, cam.height, center, dist0).serve(args.host, args.port)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
