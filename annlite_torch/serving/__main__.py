"""CLI: python -m annlite_torch.serving --n-dim 128 --port 8080 [...]

Or with a config file (reference executor/config.yml shape):
    python -m annlite_torch.serving --config deploy/config.yml [overrides...]

Every key of the file's ``params:`` reaches the executor, and through it
``AnnLite``: ``device: cpu`` there serves from the CPU, the default is the
card.  The port's copy of `annlite_tpu/serving/__main__.py`.
"""
import argparse

from .http import serve


def _load_config(path):
    import yaml

    with open(path) as f:
        cfg = yaml.safe_load(f) or {}
    return cfg.get('params', cfg)


def main(argv=None):
    ap = argparse.ArgumentParser(description='annlite_torch HTTP server')
    ap.add_argument('--config', default=None,
                    help='YAML config file (params: section = defaults)')
    ap.add_argument('--n-dim', type=int, default=None)
    ap.add_argument('--metric', default=None)
    ap.add_argument('--host', default=None)
    ap.add_argument('--port', type=int, default=None)
    ap.add_argument('--workspace', default=None)
    ap.add_argument('--shard-id', type=int, default=None)
    ap.add_argument('--shards', type=int, default=None)
    ap.add_argument('--n-subvectors', type=int, default=None)
    ap.add_argument('--index-type', default=None)
    ap.add_argument('--rerank', type=int, default=None)
    args = ap.parse_args(argv)

    params = {
        'metric': 'cosine', 'host': '0.0.0.0', 'port': 8080,
        'workspace': './workspace', 'shard_id': 0, 'shards': 1,
        'n_subvectors': None, 'index_type': 'auto', 'rerank': 0,
    }
    if args.config:
        params.update(_load_config(args.config))
    for key in params | {'n_dim': None}:
        v = getattr(args, key, None)
        if v is not None:
            params[key] = v
    if params.get('n_dim') is None:
        ap.error('--n-dim is required (flag or config file)')
    serve(**params)


if __name__ == '__main__':
    main()
