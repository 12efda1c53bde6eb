"""Minimal live viewer: the reference's SDL window (src/main.cc:81-208) as a
local HTTP surface (VERDICT r3 next #9).

Serves a live-updating frame stream with the reference's controls:

* ``/``        — viewer page: the frame as a multipart PNG stream, an FPS
                 overlay (the F1 SDL_ttf overlay analog, 5-frame sample
                 window like main.cc:21,106-200), WASD keys and mouse-drag
                 look (each event re-renders), click-to-debug (prints the
                 single-ray narration server-side, main.cc:181-186).
* ``/stream``  — multipart/x-mixed-replace PNG stream of rendered frames.
* ``/frame.png`` — the latest frame.
* ``/stats``   — {"fps": ..., "frames": ...}.
* ``/key?k=w`` / ``/mouse?dx=..&dy=..`` / ``/click?x=..&y=..`` — controls.

Deliberately OUT of the core package: accelerator hosts have no display; this is a laptop/
devbox convenience wrapping the same camera_motion helpers the CLI's
``--interactive`` stdin loop uses.

Usage:
  python tools/live_viewer.py -c cubes1 --port 8787
  python tools/live_viewer.py -c ... --selftest   # headless smoke test
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time

sys.path.insert(0, __import__("os").path.dirname(__import__("os").path.dirname(
    __import__("os").path.abspath(__file__))))

SAMPLE_PERIOD = 5  # frames per FPS sample (reference main.cc:21)

PAGE = """<!doctype html>
<html><head><title>raytracer live</title><style>
body { background:#111; color:#eee; font-family:monospace; margin:0 }
#wrap { position:relative; display:inline-block }
#fps { position:absolute; top:6px; left:8px; color:#0f0;
       text-shadow:1px 1px 2px #000; font-size:16px }
img { display:block; image-rendering:pixelated }
p { margin:6px 8px }
</style></head><body>
<div id="wrap"><img id="view" src="/stream"><div id="fps">FPS: --</div></div>
<p>wasd: move &nbsp; drag: look &nbsp; click: debug ray (server console)</p>
<script>
setInterval(async () => {
  const s = await (await fetch('/stats')).json();
  document.getElementById('fps').textContent = 'FPS: ' + s.fps.toFixed(1);
}, 500);
document.addEventListener('keydown', e => {
  if ('wasd'.includes(e.key)) fetch('/key?k=' + e.key);
});
let drag = null;
const img = document.getElementById('view');
img.addEventListener('mousedown', e => { drag = [e.clientX, e.clientY]; });
window.addEventListener('mouseup', e => { drag = null; });
window.addEventListener('mousemove', e => {
  if (!drag) return;
  const dx = e.clientX - drag[0], dy = e.clientY - drag[1];
  drag = [e.clientX, e.clientY];
  fetch(`/mouse?dx=${dx}&dy=${dy}`);
});
img.addEventListener('click', e => {
  const r = img.getBoundingClientRect();
  fetch(`/click?x=${Math.round(e.clientX - r.left)}` +
        `&y=${Math.round(e.clientY - r.top)}`);
});
</script></body></html>"""


class Viewer:
    def __init__(self, config: str, width: int, height: int):
        import jax
        import jax.numpy as jnp

        from raytracer import generate
        from raytracer.builder import scale_camera
        from raytracer.render import render_frame
        from raytracer.render.engine import default_engine, frame_to_u8
        from raytracer.scene import device_scene

        self.world = generate(config)
        cfg = self.world.config
        cam = self.world.camera
        if width:
            cam = scale_camera(cam, width, cfg.width)
            cfg = cfg.replace(width=width)
        if height:
            cfg = cfg.replace(height=height)
        self.cfg = cfg.replace(engine=default_engine())
        self.scene = device_scene(self.world.scene)
        self.camera = jax.tree_util.tree_map(jnp.asarray, cam)
        self._render = jax.jit(render_frame, static_argnames=("cfg",))
        self._to_u8 = frame_to_u8
        self.lock = threading.Lock()
        self.png = b""
        self.fps = 0.0
        self.frames = 0
        self.dirty = threading.Event()
        self.dirty.set()

    def render_once(self):
        import numpy as np

        from raytracer.pngio import encode_png

        img = self._to_u8(self._render(self.scene, self.camera, self.cfg))
        png = encode_png(np.asarray(img)[..., :3], level=1)
        with self.lock:
            self.png = png
            self.frames += 1
        return png

    def loop(self):
        """Render whenever the camera changed; FPS over 5-frame windows."""
        count, t0 = 0, time.perf_counter()
        while True:
            self.dirty.wait()
            self.dirty.clear()
            self.render_once()
            count += 1
            if count == SAMPLE_PERIOD:
                t1 = time.perf_counter()
                with self.lock:
                    self.fps = count / (t1 - t0)
                count, t0 = 0, t1

    # -- controls (reference: WASD translate, mouse motion rotates) ------
    def key(self, k: str):
        from raytracer import camera_motion as cm

        with self.lock:
            self.camera = cm.key_move(self.camera, k)
        self.dirty.set()

    def mouse(self, dx: float, dy: float):
        from raytracer import camera_motion as cm

        with self.lock:
            self.camera = cm.mouse_look(self.camera, dx, dy)
        self.dirty.set()

    def click(self, x: int, y: int):
        from raytracer.debug import debug_cast

        print(f"debug ray at ({x}, {y}):", flush=True)
        debug_cast(self.scene, self.camera, self.cfg, x, y)


def serve(viewer: Viewer, port: int):
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    from urllib.parse import parse_qs, urlparse

    class H(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, code, ctype, body):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            u = urlparse(self.path)
            q = parse_qs(u.query)
            if u.path == "/":
                self._send(200, "text/html", PAGE.encode())
            elif u.path == "/frame.png":
                with viewer.lock:
                    png = viewer.png
                self._send(200, "image/png", png)
            elif u.path == "/stats":
                with viewer.lock:
                    body = json.dumps(
                        {"fps": viewer.fps, "frames": viewer.frames})
                self._send(200, "application/json", body.encode())
            elif u.path == "/stream":
                self.send_response(200)
                self.send_header(
                    "Content-Type",
                    "multipart/x-mixed-replace; boundary=frame")
                self.end_headers()
                last = -1
                try:
                    while True:
                        with viewer.lock:
                            png, n = viewer.png, viewer.frames
                        if n != last and png:
                            last = n
                            self.wfile.write(
                                b"--frame\r\nContent-Type: image/png\r\n"
                                + f"Content-Length: {len(png)}\r\n\r\n"
                                .encode() + png + b"\r\n")
                        time.sleep(0.02)
                except (BrokenPipeError, ConnectionResetError):
                    return
            elif u.path == "/key":
                viewer.key(q.get("k", ["w"])[0])
                self._send(200, "text/plain", b"ok")
            elif u.path == "/mouse":
                viewer.mouse(float(q.get("dx", [0])[0]),
                             float(q.get("dy", [0])[0]))
                self._send(200, "text/plain", b"ok")
            elif u.path == "/click":
                viewer.click(int(q.get("x", [0])[0]), int(q.get("y", [0])[0]))
                self._send(200, "text/plain", b"ok")
            else:
                self._send(404, "text/plain", b"not found")

    srv = ThreadingHTTPServer(("127.0.0.1", port), H)
    threading.Thread(target=viewer.loop, daemon=True).start()
    print(f"live viewer on http://127.0.0.1:{port}/ "
          f"({viewer.cfg.width}x{viewer.cfg.height}, "
          f"{viewer.cfg.engine} engine)", flush=True)
    return srv


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("-c", "--config", required=True)
    ap.add_argument("--port", type=int, default=8787)
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--selftest", action="store_true",
                    help="start, fetch page/frame/stats/controls, exit")
    args = ap.parse_args()

    viewer = Viewer(args.config, args.width, args.height)
    viewer.render_once()
    srv = serve(viewer, args.port)

    if args.selftest:
        import urllib.request

        t = threading.Thread(target=srv.serve_forever, daemon=True)
        t.start()
        base = f"http://127.0.0.1:{args.port}"
        page = urllib.request.urlopen(base + "/").read()
        assert b"raytracer live" in page
        png = urllib.request.urlopen(base + "/frame.png").read()
        assert png[:8] == b"\x89PNG\r\n\x1a\n" and len(png) > 100, (
            png[:16], len(png))
        urllib.request.urlopen(base + "/key?k=w").read()
        urllib.request.urlopen(base + "/mouse?dx=5&dy=0").read()
        time.sleep(1.0)  # let the loop render the moved camera
        stats = json.loads(urllib.request.urlopen(base + "/stats").read())
        assert stats["frames"] >= 2, stats
        png2 = urllib.request.urlopen(base + "/frame.png").read()
        assert png2 != png, "camera move must re-render"
        print(f"selftest OK: frames={stats['frames']} fps={stats['fps']:.2f}")
        srv.shutdown()
        return 0

    srv.serve_forever()
    return 0


if __name__ == "__main__":
    sys.exit(main())
