"""Artifact packaging for remote backup/restore; the port's copy of
`annlite_tpu/artifacts.py` (standard library only).

Re-expression of reference `annlite/hubble_tools.py` (Uploader splitting
>size-limit files, zipping, typed artifact metadata, retry loop,
`hubble_tools.py:35-237`; Merger downloading + merging splits,
`hubble_tools.py:240-283`) against a pluggable transport instead of the
Jina Hubble client (``LocalTransport`` stores artifacts on a filesystem
path, ``HttpTransport`` on an artifact server such as
`serving/artifact_server.py`).  The store's layout is the JAX package's
byte for byte (manifest JSON, part names, checksums, artifact types), so
either package merges an archive the other uploaded.
"""
import hashlib
import json
import shutil
import time
import zipfile
from pathlib import Path
from typing import Dict, List, Union

DEFAULT_SIZE_LIMIT_MB = 1024


class LocalTransport:
    """Filesystem 'remote': artifacts under root/<name>/ with metadata."""

    def __init__(self, root: Union[str, Path]):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    def upload(self, name: str, file_path: Path, metadata: Dict) -> str:
        dest = self.root / name
        dest.mkdir(parents=True, exist_ok=True)
        target = dest / file_path.name
        shutil.copy(file_path, target)
        with open(str(target) + '.meta.json', 'w') as f:
            json.dump(metadata, f)
        return str(target)

    def list(self, name: str) -> List[Dict]:
        dest = self.root / name
        out = []
        for meta in sorted(dest.glob('*.meta.json')):
            with open(meta) as f:
                m = json.load(f)
            m['_path'] = str(meta)[: -len('.meta.json')]
            out.append(m)
        return out

    def download(self, artifact: Dict, to: Path) -> Path:
        to.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(artifact['_path'], to)
        return to

    def exists(self, name: str) -> bool:
        return (self.root / name).exists() and bool(self.list(name))

    def delete(self, name: str):
        shutil.rmtree(self.root / name, ignore_errors=True)


class HttpTransport:
    """Object-store transport over HTTP (reference: the Hubble client,
    `annlite/hubble_tools.py:35-283`; here a plain REST scheme so any
    artifact server — including `annlite_torch.serving.artifact_server` —
    can hold backups).

    Scheme: PUT /artifacts/<name>/<file> (body = bytes, X-Artifact-Meta
    header = JSON), GET /artifacts/<name> (JSON list of metadata), GET
    /artifacts/<name>/<file>, DELETE /artifacts/<name>.
    """

    def __init__(self, base_url: str, timeout: float = 120.0):
        self.base = base_url.rstrip('/')
        self.timeout = timeout

    def _url(self, name: str, fname: str = '') -> str:
        from urllib.parse import quote

        u = f'{self.base}/artifacts/{quote(name, safe="")}'
        return f'{u}/{quote(fname)}' if fname else u

    def upload(self, name: str, file_path: Path, metadata: Dict) -> str:
        import urllib.request

        with open(file_path, 'rb') as f:
            body = f.read()
        req = urllib.request.Request(
            self._url(name, file_path.name),
            data=body,
            method='PUT',
            headers={
                'Content-Type': 'application/octet-stream',
                'X-Artifact-Meta': json.dumps(metadata),
            },
        )
        with urllib.request.urlopen(req, timeout=self.timeout) as r:
            return json.loads(r.read())['path']

    def list(self, name: str) -> List[Dict]:
        import urllib.error
        import urllib.request

        try:
            with urllib.request.urlopen(
                self._url(name), timeout=self.timeout
            ) as r:
                arts = json.loads(r.read())
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return []
            raise
        for a in arts:  # _path is a URL for HTTP artifacts
            a['_path'] = f'{self.base}{a["_path"]}'
        return arts

    def download(self, artifact: Dict, to: Path) -> Path:
        import urllib.request

        to.parent.mkdir(parents=True, exist_ok=True)
        with urllib.request.urlopen(
            artifact['_path'], timeout=self.timeout
        ) as r, open(to, 'wb') as f:
            shutil.copyfileobj(r, f)
        return to

    def exists(self, name: str) -> bool:
        return bool(self.list(name))

    def delete(self, name: str):
        import urllib.request

        req = urllib.request.Request(self._url(name), method='DELETE')
        with urllib.request.urlopen(req, timeout=self.timeout):
            pass


def make_transport(remote: Union[str, Path]):
    """'http(s)://...' → HttpTransport; anything else → LocalTransport."""
    s = str(remote)
    if s.startswith('http://') or s.startswith('https://'):
        return HttpTransport(s)
    return LocalTransport(s)


def split_file(path: Path, chunk_bytes: int, out_dir: Path) -> List[Path]:
    """Split a large file into numbered parts (reference uses `filesplit`)."""
    out_dir.mkdir(parents=True, exist_ok=True)
    parts = []
    with open(path, 'rb') as f:
        i = 0
        while True:
            chunk = f.read(chunk_bytes)
            if not chunk:
                break
            p = out_dir / f'{path.name}.part{i:04d}'
            with open(p, 'wb') as out:
                out.write(chunk)
            parts.append(p)
            i += 1
    return parts


def merge_files(parts: List[Path], target: Path) -> Path:
    target.parent.mkdir(parents=True, exist_ok=True)
    with open(target, 'wb') as out:
        for p in sorted(parts):
            with open(p, 'rb') as f:
                shutil.copyfileobj(f, out)
    return target


class Uploader:
    """Package a backup directory into typed artifacts
    (reference `hubble_tools.py:35-237`)."""

    def __init__(
        self,
        transport,
        size_limit_mb: int = DEFAULT_SIZE_LIMIT_MB,
        max_retries: int = 3,
    ):
        self.transport = transport
        self.size_limit = size_limit_mb * 1024 * 1024
        self.max_retries = max_retries

    def upload_directory(
        self, name: str, directory: Union[str, Path], skip_if_exists: bool = True
    ) -> List[str]:
        directory = Path(directory)
        if skip_if_exists and self.transport.exists(name):
            return []
        uploaded = []
        tmp = directory.parent / f'.upload_tmp_{name.replace("/", "_")}'
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir(parents=True)
        try:
            for f in sorted(directory.rglob('*')):
                if not f.is_file():
                    continue
                rel = f.relative_to(directory)
                art_type = rel.parts[0] if len(rel.parts) > 1 else 'file'
                files = [f]
                split = f.stat().st_size > self.size_limit
                if split:
                    files = split_file(f, self.size_limit, tmp / 'splits')
                for part in files:
                    zpath = tmp / (part.name + '.zip')
                    with zipfile.ZipFile(zpath, 'w', zipfile.ZIP_DEFLATED) as z:
                        z.write(part, arcname=part.name)
                    meta = {
                        'name': name,
                        'type': art_type,
                        'file_name': str(rel),
                        'part': part.name if split else None,
                        'sha256': _sha256(zpath),
                        'ts': time.time(),
                    }
                    uploaded.append(self._upload_with_retry(name, zpath, meta))
            return uploaded
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    def _upload_with_retry(self, name: str, path: Path, meta: Dict) -> str:
        last = None
        for attempt in range(self.max_retries):
            try:
                return self.transport.upload(name, path, meta)
            except Exception as e:  # retry loop, reference `hubble_tools.py:209-233`
                last = e
                time.sleep(0.1 * (attempt + 1))
        raise RuntimeError(f'upload failed after {self.max_retries} retries: {last}')


class Merger:
    """Download artifacts and reassemble the backup directory
    (reference `hubble_tools.py:240-283`)."""

    def __init__(self, transport):
        self.transport = transport

    def restore_directory(self, name: str, target: Union[str, Path]) -> Path:
        target = Path(target)
        arts = self.transport.list(name)
        if not arts:
            raise FileNotFoundError(f'no artifacts under {name!r}')
        tmp = target.parent / f'.restore_tmp_{name.replace("/", "_")}'
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir(parents=True)
        try:
            by_file: Dict[str, List[Path]] = {}
            for art in arts:
                z = self.transport.download(art, tmp / Path(art['_path']).name)
                with zipfile.ZipFile(z) as zf:
                    zf.extractall(tmp / 'x')
                inner = tmp / 'x' / Path(z.name[: -len('.zip')]).name
                by_file.setdefault(art['file_name'], []).append(inner)
            for rel, parts in by_file.items():
                dest = target / rel
                if len(parts) == 1 and '.part' not in parts[0].name:
                    dest.parent.mkdir(parents=True, exist_ok=True)
                    shutil.copy(parts[0], dest)
                else:
                    merge_files(parts, dest)
            return target
        finally:
            shutil.rmtree(tmp, ignore_errors=True)


def _sha256(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, 'rb') as f:
        for chunk in iter(lambda: f.read(1 << 20), b''):
            h.update(chunk)
    return h.hexdigest()
