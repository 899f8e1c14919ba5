"""Artifact store server — the remote half of `artifacts.HttpTransport`;
the port's copy of `annlite_tpu/serving/artifact_server.py` (standard
library only).

The reference backs up to Jina's hosted Hubble service
(`annlite/hubble_tools.py:35-283`); this build has no hosted dependency, so
the artifact store is a self-hostable HTTP server over the LocalTransport
layout.  One instance can hold the backups of every shard (shard-suffixed
artifact names, `serving/executor.py backup/restore`).

REST scheme (mirrors HttpTransport):
  PUT    /artifacts/<name>/<file>   body = bytes, X-Artifact-Meta = JSON
  GET    /artifacts/<name>          JSON list of artifact metadata
  GET    /artifacts/<name>/<file>   artifact bytes
  DELETE /artifacts/<name>          drop all artifacts under <name>
"""
import json
import shutil
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Union
from urllib.parse import unquote

from ..artifacts import LocalTransport


class _Handler(BaseHTTPRequestHandler):
    store: LocalTransport = None  # set by ArtifactServer

    def log_message(self, *a):  # quiet
        pass

    def _split(self):
        parts = [unquote(p) for p in self.path.split('/') if p]
        if not parts or parts[0] != 'artifacts':
            return None, None
        name = parts[1] if len(parts) > 1 else None
        fname = '/'.join(parts[2:]) if len(parts) > 2 else None
        return name, fname

    def _json(self, code: int, obj):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header('Content-Type', 'application/json')
        self.send_header('Content-Length', str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_PUT(self):
        name, fname = self._split()
        if not name or not fname:
            return self._json(400, {'error': 'PUT /artifacts/<name>/<file>'})
        n = int(self.headers.get('Content-Length', 0))
        meta = json.loads(self.headers.get('X-Artifact-Meta', '{}'))
        dest = self.store.root / name
        dest.mkdir(parents=True, exist_ok=True)
        target = dest / Path(fname).name
        with open(target, 'wb') as f:
            remaining = n
            while remaining:
                chunk = self.rfile.read(min(remaining, 1 << 20))
                if not chunk:
                    break
                f.write(chunk)
                remaining -= len(chunk)
        with open(str(target) + '.meta.json', 'w') as f:
            json.dump(meta, f)
        self._json(200, {'path': f'/artifacts/{name}/{target.name}'})

    def do_GET(self):
        name, fname = self._split()
        if not name:
            return self._json(400, {'error': 'GET /artifacts/<name>[/<file>]'})
        if fname is None:
            if not (self.store.root / name).exists():
                return self._json(404, {'error': f'{name} not found'})
            arts = []
            for m in self.store.list(name):
                local = Path(m.pop('_path'))
                m['_path'] = f'/artifacts/{name}/{local.name}'
                arts.append(m)
            return self._json(200, arts)
        target = self.store.root / name / Path(fname).name
        if not target.exists():
            return self._json(404, {'error': f'{fname} not found'})
        self.send_response(200)
        self.send_header('Content-Type', 'application/octet-stream')
        self.send_header('Content-Length', str(target.stat().st_size))
        self.end_headers()
        with open(target, 'rb') as f:
            shutil.copyfileobj(f, self.wfile)

    def do_DELETE(self):
        name, _ = self._split()
        if not name:
            return self._json(400, {'error': 'DELETE /artifacts/<name>'})
        self.store.delete(name)
        self._json(200, {'deleted': name})


class ArtifactServer:
    """Serve a filesystem artifact root over HTTP (threaded, stdlib-only)."""

    def __init__(self, root: Union[str, Path], host: str = '127.0.0.1', port: int = 8777):
        self.store = LocalTransport(root)
        handler = type('Handler', (_Handler,), {'store': self.store})
        self._httpd = ThreadingHTTPServer((host, port), handler)
        # read back the BOUND address so port=0 (ephemeral) works in tests
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = None

    @property
    def url(self) -> str:
        return f'http://{self.host}:{self.port}'

    def start(self):
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )
        self._thread.start()
        return self

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)
