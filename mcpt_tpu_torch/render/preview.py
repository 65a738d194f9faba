"""Live progressive preview over HTTP (counterpart of
mcpt_tpu/render/preview.py).

The reference's real-time viewer is a GLUT window fed by a CUDA
progressive kernel with save-on-keypress (csrt src/ray_tracer.cpp:
161-201, renderer.cpp:97-138).  A render host is often headless, so
this is a tiny in-process HTTP server: the render loop pushes each
accumulated frame, browsers watch `http://host:port/` (an
auto-refreshing page), and `/frame.png` always returns the latest
sRGB-encoded frame.  No extra dependencies — `http.server` + PIL.
"""

from __future__ import annotations

import io
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

_PAGE = b"""<!doctype html>
<html><head><title>mcpt_tpu_torch preview</title>
<style>body{background:#111;margin:0;display:flex;flex-direction:column;
align-items:center;color:#ccc;font:13px monospace}
img{margin-top:8px;max-width:98vw}</style></head>
<body><div id="s">waiting for first frame&hellip;</div>
<img id="f" src="/frame.png">
<script>
const img = document.getElementById('f'), s = document.getElementById('s');
setInterval(() => {
  const n = new Image();
  n.onload = () => { img.src = n.src; s.textContent = new Date().toLocaleTimeString(); };
  n.src = '/frame.png?' + Date.now();
}, 1000);
</script></body></html>"""


class PreviewServer:
    """Serve the latest accumulated frame; `update(img)` from the render
    loop, `close()` when done (the final frame stays available until
    then)."""

    def __init__(self, port: int, host: str = "0.0.0.0"):
        self._png: bytes | None = None
        self._lock = threading.Lock()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # keep the render log clean
                pass

            def do_GET(self):
                if self.path.split("?")[0] == "/frame.png":
                    with outer._lock:
                        png = outer._png
                    if png is None:
                        self.send_response(404)
                        self.end_headers()
                        return
                    self.send_response(200)
                    self.send_header("Content-Type", "image/png")
                    self.send_header("Cache-Control", "no-store")
                    self.send_header("Content-Length", str(len(png)))
                    self.end_headers()
                    self.wfile.write(png)
                else:
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.send_header("Content-Length", str(len(_PAGE)))
                    self.end_headers()
                    self.wfile.write(_PAGE)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]  # resolved if port=0
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )
        self._thread.start()

    def update(self, linear_rgb: np.ndarray) -> None:
        from PIL import Image

        from mcpt_tpu_torch.utils.image import linear_to_srgb

        srgb = np.clip(linear_to_srgb(np.asarray(linear_rgb)), 0.0, 1.0)
        buf = io.BytesIO()
        Image.fromarray((srgb * 255.0 + 0.5).astype(np.uint8), "RGB").save(
            buf, format="PNG"
        )
        with self._lock:
            self._png = buf.getvalue()

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
