"""Interactive HTTP viewer — port of ``gs_init_tpu/viewer.py``.

Serves an orbit-controllable render of the current gaussians from a plain
``http.server``, live during training (``Runner.start_viewer``, started by
``Runner.train`` unless ``disable_viewer``) or from a checkpoint:

    python -m gs_init_tpu_torch.viewer --ckpt results/garden/ckpts/ckpt_30000.npz \\
        --data_dir data/360_v2/garden --port 8080

Endpoints:
  /            a minimal HTML page with mouse orbit controls
  /render?yaw=..&pitch=..&radius=..&w=..&h=..   a PNG render
  /status      {"step": ..., "num_GS": ...}

Renders are PNG (``datasets/png.py``), where the JAX viewer serves JPEG
through imageio: the port depends on no image encoder.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from .datasets.png import encode_png
from .datasets.synthetic import look_at
from .engine.params import num_alive

_PAGE = """<!DOCTYPE html><html><head><title>gs_init_tpu_torch viewer</title>
<style>body{margin:0;background:#111;color:#eee;font-family:monospace}
#hud{position:fixed;top:8px;left:8px}</style></head>
<body><div id="hud">drag: orbit | wheel: zoom<span id="st"></span></div>
<img id="v" style="width:100vw;height:100vh;object-fit:contain">
<script>
let yaw=0,pitch=0,radius=3,busy=false,dirty=true;
const img=document.getElementById('v');
function refresh(){if(busy||!dirty)return;busy=true;dirty=false;
 img.onload=()=>{busy=false;refresh();};
 img.src=`/render?yaw=${yaw}&pitch=${pitch}&radius=${radius}&t=${Date.now()}`;}
let drag=false,lx=0,ly=0;
window.onmousedown=e=>{drag=true;lx=e.clientX;ly=e.clientY};
window.onmouseup=()=>drag=false;
window.onmousemove=e=>{if(!drag)return;yaw+=(e.clientX-lx)*0.01;
 pitch=Math.max(-1.5,Math.min(1.5,pitch+(e.clientY-ly)*0.01));
 lx=e.clientX;ly=e.clientY;dirty=true;refresh();};
window.onwheel=e=>{radius*=Math.exp(e.deltaY*0.001);dirty=true;refresh();};
setInterval(refresh,100);refresh();
async function st(){try{const r=await(await fetch('/status')).json();
 if(r.step>=0){document.getElementById('st').textContent=
  ` | step ${r.step} | ${r.num_GS} GS`;dirty=true;}}catch(e){}}
setInterval(st,2000);st();
</script></body></html>"""


class ViewerServer:
    """Serve renders of a live Runner (or a loaded checkpoint).

    ``start()`` runs the server on a daemon thread so the Runner keeps
    training while views are served from its current parameters. A train
    iteration updates them in place, so each render holds ``runner.lock``,
    which every train iteration holds too (the JAX viewer instead retries a
    render whose donated buffers a concurrent step deleted). Under a
    multi-GPU mesh it serves the main process and draws the copy of the
    state that the Runner gathers every ``tb_every`` steps
    (``Runner.view_gstate``). Pass ``port=0`` to bind an ephemeral
    port.
    """

    def __init__(self, runner, port: int = 8080, width: int = 640):
        self.runner = runner
        self.port = port
        self.width = width
        centers = np.stack([im.camtoworld[:3, 3] for im in runner.parser.images])
        self.center = centers.mean(axis=0) * 0.0  # the scene is normalised
        self.radius0 = float(np.linalg.norm(centers, axis=1).mean())
        self._srv = None
        self._thread = None

    def camera(self, yaw: float, pitch: float, radius: float, w: int, h: int):
        """(camtoworld [4, 4], K [3, 3]) of an orbit view."""
        r = radius * self.radius0
        eye = self.center + r * np.array(
            [np.cos(pitch) * np.sin(yaw), np.sin(pitch), np.cos(pitch) * np.cos(yaw)]
        )
        K = np.array([[0.9 * w, 0, w / 2], [0, 0.9 * w, h / 2], [0, 0, 1]], np.float32)
        return look_at(eye, self.center), K

    def render_view(self, yaw: float, pitch: float, radius: float, w: int, h: int) -> np.ndarray:
        c2w, K = self.camera(yaw, pitch, radius, w, h)
        with self.runner.lock:
            color, _, _ = self.runner.render(c2w, K, w, h, render_mode="RGB", gstate=self.runner.view_gstate)
        return (np.clip(color, 0, 1) * 255).astype(np.uint8)

    def _bind(self):
        self._srv = ThreadingHTTPServer(("0.0.0.0", self.port), self._make_handler())
        self.port = self._srv.server_address[1]
        print(f"viewer on http://localhost:{self.port}")

    def start(self) -> int:
        """Serve on a daemon thread; returns the bound port."""
        self._bind()
        self._thread = threading.Thread(target=self._srv.serve_forever, daemon=True, name="gs-viewer")
        self._thread.start()
        return self.port

    def stop(self):
        if self._srv is not None:
            self._srv.shutdown()
            self._srv.server_close()
            self._srv = None
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    def serve_forever(self):
        self._bind()
        self._srv.serve_forever()

    def _make_handler(self):
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, ctype: str, body: bytes):
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                u = urlparse(self.path)
                if u.path == "/":
                    self._send("text/html", _PAGE.encode())
                elif u.path == "/render":
                    q = parse_qs(u.query)
                    g = lambda k, d: float(q.get(k, [d])[0])
                    w = int(g("w", viewer.width))
                    h = int(g("h", int(viewer.width * 0.75)))
                    img = viewer.render_view(g("yaw", 0.0), g("pitch", 0.0), g("radius", 1.0), w, h)
                    self._send("image/png", encode_png(img))
                elif u.path == "/status":
                    with viewer.runner.lock:
                        n_gs = num_alive(viewer.runner.view_gstate)
                    body = json.dumps({"step": int(viewer.runner.train_step), "num_GS": n_gs})
                    self._send("application/json", body.encode())
                else:
                    self.send_response(404)
                    self.end_headers()

        return Handler


def main(argv=None, device=None):
    import argparse
    import tempfile

    from .engine.runner import Runner
    from .trainer import build_presets

    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--data_dir", required=True)
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--data_factor", type=int, default=4)
    ap.add_argument("--max_gaussians", type=int, default=1_000_000)
    ns = ap.parse_args(argv)
    cfg = build_presets()["default"]
    cfg.data_dir = ns.data_dir
    cfg.data_factor = ns.data_factor
    cfg.max_gaussians = ns.max_gaussians
    cfg.result_dir = tempfile.mkdtemp(prefix="gs_viewer_")
    runner = Runner(cfg, device=device)
    runner.load(ns.ckpt)
    ViewerServer(runner, port=ns.port).serve_forever()


if __name__ == "__main__":
    main()
