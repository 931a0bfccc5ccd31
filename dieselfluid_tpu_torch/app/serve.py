"""Serve an output directory with the trajectory viewer (counterpart of
dieselfluid_tpu/app/serve.py).

    python -m dieselfluid_tpu_torch.app.serve out/ [--port 8123]

Copies this package's app/viewer.html (a copy of the JAX package's: the file
formats are the same, so one viewer plays both packages' output) into the
directory and serves it over HTTP. The CLI exports .dfc trajectories
(--stream dfc) and the browser plays them back; `viewer.html?live=name.dfc`
follows a .dfc while the CLI still streams it, fetching only the bytes new
frames appended (HTTP Range requests, answered below). `POST /control`
writes the JSON body to control.json, which a CLI started with `--control`
polls between frames ({"paused": bool, "quit": bool}).
"""

from __future__ import annotations

import argparse
import functools
import http.server
import os
import shutil
import sys


class RangeRequestHandler(http.server.SimpleHTTPRequestHandler):
    """SimpleHTTPRequestHandler + single-range `Range: bytes=a-b` GETs
    (enough for the viewer's incremental .dfc tailing) + `POST /control`,
    which writes the JSON body to `control.json` in the served directory
    (atomically, for the polling CLI)."""

    def do_POST(self):
        if self.path.rstrip("/") != "/control":
            self.send_error(404, "unknown endpoint")
            return
        n = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(n) if 0 < n <= 1 << 16 else b"{}"
        import json as _json

        try:
            parsed = _json.loads(body.decode("utf-8"))
            assert isinstance(parsed, dict)
        except Exception:
            self.send_error(400, "control body must be a JSON object")
            return
        target = os.path.join(self.directory, "control.json")
        tmp = target + ".tmp"
        with open(tmp, "w") as f:
            _json.dump(parsed, f)
        os.replace(tmp, target)
        out = b'{"ok": true}'
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(out)))
        self.end_headers()
        self.wfile.write(out)

    def send_head(self):
        rng = self.headers.get("Range")
        if not (rng and rng.startswith("bytes=")):
            return super().send_head()
        path = self.translate_path(self.path)
        try:
            f = open(path, "rb")
        except OSError:
            self.send_error(404, "File not found")
            return None
        size = os.fstat(f.fileno()).st_size
        try:
            lo_s, hi_s = rng[len("bytes="):].split("-", 1)
            lo = int(lo_s)
            hi = int(hi_s) if hi_s else size - 1
        except ValueError:
            f.close()
            self.send_error(400, "Bad Range")
            return None
        hi = min(hi, size - 1)
        if lo > hi or lo >= size:
            f.close()
            self.send_error(416, "Range Not Satisfiable")
            return None
        self.send_response(206)
        self.send_header("Content-Type", self.guess_type(path))
        self.send_header("Content-Range", f"bytes {lo}-{hi}/{size}")
        self.send_header("Content-Length", str(hi - lo + 1))
        self.send_header("Accept-Ranges", "bytes")
        self.end_headers()
        f.seek(lo)
        self._range_left = hi - lo + 1
        return f

    def copyfile(self, source, outputfile):
        left = getattr(self, "_range_left", None)
        if left is None:
            return super().copyfile(source, outputfile)
        self._range_left = None
        while left > 0:
            chunk = source.read(min(left, 1 << 16))
            if not chunk:
                break
            outputfile.write(chunk)
            left -= len(chunk)

VIEWER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "viewer.html")


def install_viewer(out_dir: str) -> str:
    """Copy viewer.html into `out_dir`; returns the installed path."""
    os.makedirs(out_dir, exist_ok=True)
    dst = os.path.join(out_dir, "viewer.html")
    shutil.copyfile(VIEWER, dst)
    return dst


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="dieselfluid-serve", description=__doc__)
    p.add_argument("dir", nargs="?", default="out")
    p.add_argument("--port", type=int, default=8123)
    args = p.parse_args(argv)
    install_viewer(args.dir)
    handler = functools.partial(RangeRequestHandler,
                                directory=os.path.abspath(args.dir))
    with http.server.ThreadingHTTPServer(("127.0.0.1", args.port),
                                         handler) as srv:
        print(f"viewer: http://127.0.0.1:{args.port}/viewer.html "
              f"(serving {os.path.abspath(args.dir)})")
        try:
            srv.serve_forever()
        except KeyboardInterrupt:
            pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
