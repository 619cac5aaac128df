"""Live view of a render refining, over HTTP.

The reference draws its render into an ebiten window; a GPU server has no
window system, so the live view is a small stdlib HTTP server: open the
printed URL in a browser and the page polls the latest frame and a HUD
(pass, samples done, Mrays/s, elapsed), the reference's window HUD.  The
JAX package's module of the same name, taking tensors.

No dependency beyond the standard library; the server runs in a daemon
thread and costs the render loop one PNG encode an update.

    disp = LiveDisplay()            # disp.url to share
    disp.update(img01, pass_name="preview", done_spp=1, total_spp=100,
                mrays=31.9)
    ...
    disp.close()

CLI: ``python -m go_raytracing_tpu_torch.utils.cli -scene cornell
-interactive`` serves on 127.0.0.1:8265 (``-interactive-port`` to change
it) and updates after every progressive pass and every sample slice.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..core import film

_PAGE = """<!doctype html>
<html><head><title>go_raytracing_tpu_torch live render</title><style>
 body { background: #111; color: #ddd; font: 14px monospace; margin: 1em; }
 #hud { margin-bottom: .6em; white-space: pre; }
 img { image-rendering: pixelated; border: 1px solid #333; max-width: 100%; }
</style></head><body>
<div id="hud">waiting for first frame...</div>
<img id="frame" alt="render"/>
<script>
let seq = -1;
async function tick() {
  try {
    const s = await (await fetch('status')).json();
    document.getElementById('hud').textContent =
      `pass ${s.pass_name ?? '-'}  ` +
      `spp ${s.done_spp ?? 0}/${s.total_spp ?? '?'}  ` +
      `${(s.mrays ?? 0).toFixed(2)} Mrays/s  ` +
      `elapsed ${(s.elapsed ?? 0).toFixed(1)}s  frame #${s.seq}`;
    if (s.seq !== seq && s.seq >= 0) {
      seq = s.seq;
      document.getElementById('frame').src = 'frame.png?seq=' + seq;
    }
  } catch (e) {}
  setTimeout(tick, 500);
}
tick();
</script></body></html>"""


class LiveDisplay:
    """Threaded HTTP live viewer.  ``update`` is safe to call from the
    render loop; requests never block it (state swaps are atomic under one
    lock).  ``port=0`` takes a free port (``url`` names it)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8265):
        self._lock = threading.Lock()
        self._png = b""
        self._status = {"seq": -1}
        self._t0 = time.perf_counter()
        disp = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                path = self.path.split("?")[0]
                if path in ("/", "/index.html"):
                    body, ctype = _PAGE.encode(), "text/html"
                elif path == "/frame.png":
                    with disp._lock:
                        body = disp._png
                    ctype = "image/png"
                    if not body:
                        self.send_response(404)
                        self.end_headers()
                        return
                elif path == "/status":
                    with disp._lock:
                        body = json.dumps(disp._status).encode()
                    ctype = "application/json"
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )
        self._thread.start()

    @property
    def url(self) -> str:
        host, port = self._server.server_address[:2]
        return f"http://{host}:{port}/"

    def update(self, image01, **info):
        """Publish a frame.  ``image01``: [H, W, 3] floats in [0, 1), a
        tensor on any device; ``info``: HUD fields (pass_name, done_spp,
        total_spp, mrays...)."""
        png = film.encode_png(film.to_uint8(image01))
        with self._lock:
            self._png = png
            seq = self._status.get("seq", -1) + 1
            self._status = dict(
                info, seq=seq, elapsed=time.perf_counter() - self._t0
            )

    def close(self):
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5)
