"""Shard gateway: scatter/gather over N executor HTTP servers.

Mirrors the reference's only distributed mode — Jina Flow ``shards=N`` with
polling ``{'/index': 'ANY', '/search': 'ALL'}`` and gateway-side match
merging (`tests/executor/test_executor.py:268-340`, SURVEY.md §2.3 item 5):
writes go to ONE shard (round-robin), reads broadcast to ALL shards and the
per-shard top-k are merged by score.  Transport is plain HTTP/JSON (urllib,
no extra deps) — suitable for host-level sharding.  The port's copy of
`annlite_tpu/serving/gateway.py`.
"""
import json
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional


class ShardError(RuntimeError):
    """One or more shards failed a broadcast; carries per-shard failures."""

    def __init__(self, failures: Dict[str, str]):
        self.failures = failures
        super().__init__(
            'shard failures: '
            + '; '.join(f'{u}: {e}' for u, e in failures.items())
        )


class Gateway:
    def __init__(self, shard_urls: List[str], timeout: float = 60.0):
        if not shard_urls:
            raise ValueError('need at least one shard url')
        self.shard_urls = list(shard_urls)
        self.timeout = timeout
        self._rr = 0
        # broadcasts fan out concurrently: query latency is max over shards,
        # not sum (the reference's Flow gateway also fans out concurrently)
        self._pool = ThreadPoolExecutor(max_workers=max(4, len(shard_urls)))

    def _post(self, url: str, endpoint: str, payload: Dict) -> Dict:
        req = urllib.request.Request(
            f'{url}{endpoint}',
            data=json.dumps(payload).encode(),
            headers={'Content-Type': 'application/json'},
            method='POST',
        )
        with urllib.request.urlopen(req, timeout=self.timeout) as r:
            return json.loads(r.read())

    def _get(self, url: str, endpoint: str) -> Dict:
        with urllib.request.urlopen(f'{url}{endpoint}', timeout=self.timeout) as r:
            return json.loads(r.read())

    # ----- scatter writes (polling ANY) -----

    def index(self, docs: List[Dict], parameters: Optional[Dict] = None):
        url = self.shard_urls[self._rr % len(self.shard_urls)]
        self._rr += 1
        return self._post(url, '/index', {'docs': docs, 'parameters': parameters or {}})

    # ----- broadcast + gather (polling ALL) -----

    def _broadcast(
        self, endpoint: str, payload: Dict, allow_partial: bool = False
    ) -> List[Optional[Dict]]:
        """Concurrent fan-out with per-shard error isolation.  Strict mode
        (writes) raises :class:`ShardError` naming every failed shard;
        ``allow_partial`` (reads) returns None for failed shards so healthy
        shards still serve."""
        futs = [
            self._pool.submit(self._post, u, endpoint, payload)
            for u in self.shard_urls
        ]
        results: List[Optional[Dict]] = []
        failures: Dict[str, str] = {}
        for u, f in zip(self.shard_urls, futs):
            try:
                results.append(f.result(timeout=self.timeout + 5))
            except Exception as e:
                failures[u] = repr(e)
                results.append(None)
        if failures and (not allow_partial or len(failures) == len(futs)):
            raise ShardError(failures)
        return results

    def update(self, docs: List[Dict], parameters: Optional[Dict] = None):
        return self._broadcast('/update', {'docs': docs, 'parameters': parameters or {}})

    def delete(self, ids: List[str], parameters: Optional[Dict] = None):
        p = dict(parameters or {})
        p['ids'] = ids
        return self._broadcast('/delete', {'parameters': p})

    def search(self, docs: List[Dict], parameters: Optional[Dict] = None) -> List[Dict]:
        """Broadcast, then merge per-shard matches by ascending score."""
        limit = int((parameters or {}).get('limit', 10))
        replies = self._broadcast(
            '/search', {'docs': docs, 'parameters': parameters or {}},
            allow_partial=True,
        )
        merged = []
        for qi, query in enumerate(docs):
            all_matches = []
            for rep in replies:
                if rep is None:  # failed shard: healthy shards still serve
                    continue
                all_matches.extend(rep['results'][qi].get('matches', []))
            all_matches.sort(key=lambda m: m.get('score', 0.0))
            out = dict(query)
            out['matches'] = all_matches[:limit]
            merged.append(out)
        return merged

    def filter(self, parameters: Optional[Dict] = None) -> List[Dict]:
        limit = int((parameters or {}).get('limit', 10))
        replies = self._broadcast(
            '/filter', {'parameters': parameters or {}}, allow_partial=True
        )
        docs = [d for rep in replies if rep is not None for d in rep['docs']]
        return docs[:limit] if limit >= 0 else docs

    def status(self) -> Dict:
        futs = [
            self._pool.submit(self._get, u, '/status') for u in self.shard_urls
        ]
        stats, failed = [], {}
        for u, f in zip(self.shard_urls, futs):
            try:
                stats.append(f.result(timeout=self.timeout + 5))
            except Exception as e:
                failed[u] = repr(e)
        out = {
            'shards': stats,
            'total_docs': sum(s['total_docs'] for s in stats),
            'index_size': sum(s['index_size'] for s in stats),
        }
        if failed:
            out['failed_shards'] = failed
        return out

    def backup(self, name: Optional[str] = None, remote: Optional[str] = None):
        """Coordinated multi-shard backup: every shard archives under
        ``<name>_shard_<i>`` (optionally uploading to the ``remote``
        artifact store)."""
        return self._broadcast(
            '/backup', {'parameters': {'target_name': name, 'remote': remote}}
        )

    def restore(self, name: Optional[str] = None, remote: Optional[str] = None):
        return self._broadcast(
            '/restore', {'parameters': {'source_name': name, 'remote': remote}}
        )

    def clear(self):
        return self._broadcast('/clear', {})
