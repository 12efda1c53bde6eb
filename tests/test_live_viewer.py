"""The live viewer's headless selftest as a suite test: page + PNG frame +
stats endpoints serve, and a key/mouse event re-renders the frame (the
reference SDL loop's behavior, src/main.cc:81-208)."""

import os
import socket
import subprocess
import sys


def test_live_viewer_selftest():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ""
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [sys.executable, os.path.join(root, "tools", "live_viewer.py"),
         "-c", "cubes1", "--width", "96",
         "--height", "64", "--port", str(port), "--selftest"],
        capture_output=True, text=True, timeout=420, cwd=root, env=env,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "selftest OK" in proc.stdout, proc.stdout
