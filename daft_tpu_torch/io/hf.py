"""HuggingFace Hub object source: ``hf://[datasets/]org/repo[@rev]/path``.

Capability mirror of the reference's HF client (``src/daft-io/src/
huggingface.rs``): resolve-URL downloads, tree-API listing/glob, optional
bearer token, anonymous for public repos. Rides the HTTP source's
request/retry machinery; ``HF_ENDPOINT`` points at a mirror or a mock
server in tests.

The port's copy of ``daft_tpu/io/hf.py``.
"""

from __future__ import annotations

import json
import os
import re
import urllib.parse
from typing import Iterator, List, Tuple

from .object_io import HTTPConfig, HTTPSource, ObjectSource


def _parse_hf_url(path: str) -> Tuple[str, str, str, str]:
    """→ (repo_type, repo_id, revision, path_in_repo)."""
    u = urllib.parse.urlparse(path)
    if u.scheme != "hf":
        raise ValueError(f"not an hf url: {path!r}")
    full = (u.netloc + u.path).strip("/")
    parts = full.split("/")
    if parts and parts[0] in ("datasets", "spaces", "models"):
        repo_type = parts[0]
        parts = parts[1:]
    else:
        repo_type = "datasets"
    if len(parts) < 2:
        raise ValueError(f"hf url needs org/repo: {path!r}")
    org, repo = parts[0], parts[1]
    revision = "main"
    if "@" in repo:
        repo, revision = repo.split("@", 1)
    return repo_type, f"{org}/{repo}", revision, "/".join(parts[2:])


class HFSource(ObjectSource):
    scheme = "hf"

    def __init__(self, config: HTTPConfig = HTTPConfig()):
        token = config.bearer_token or os.environ.get("HF_TOKEN")
        self._http = HTTPSource(HTTPConfig(
            user_agent=config.user_agent, bearer_token=token,
            num_tries=config.num_tries))
        self._endpoint = os.environ.get("HF_ENDPOINT",
                                        "https://huggingface.co")

    def _resolve_url(self, path: str) -> str:
        repo_type, repo_id, rev, inner = _parse_hf_url(path)
        prefix = "" if repo_type == "models" else f"{repo_type}/"
        return (f"{self._endpoint}/{prefix}{repo_id}/resolve/"
                f"{urllib.parse.quote(rev, safe='')}/"
                f"{urllib.parse.quote(inner, safe='/')}")

    # ------------------------------------------------------- ObjectSource
    def get(self, path, byte_range=None, stats=None) -> bytes:
        return self._http.get(self._resolve_url(path), byte_range, stats)

    def get_size(self, path) -> int:
        return self._http.get_size(self._resolve_url(path))

    def _tree(self, repo_type: str, repo_id: str, rev: str,
              subpath: str) -> List[dict]:
        url = (f"{self._endpoint}/api/{repo_type}/{repo_id}/tree/"
               f"{urllib.parse.quote(rev, safe='')}")
        if subpath:
            url += f"/{subpath}"
        url += "?recursive=true"
        body = self._http.get(url)
        return json.loads(body)

    def glob(self, pattern, stats=None) -> List[str]:
        from .s3 import _glob_regex
        repo_type, repo_id, rev, inner = _parse_hf_url(pattern)
        wild = min((inner.index(ch) for ch in "*?[" if ch in inner),
                   default=None)
        if wild is None:
            return [pattern]
        prefix = inner[:wild].rsplit("/", 1)[0] if "/" in inner[:wild] else ""
        if stats:
            stats.record_list()
        entries = self._tree(repo_type, repo_id, rev, prefix)
        rx = re.compile(_glob_regex(inner))
        at = "" if rev == "main" else f"@{rev}"
        base = f"hf://{repo_type}/{repo_id}{at}"
        return sorted(f"{base}/{e['path']}" for e in entries
                      if e.get("type") == "file" and rx.match(e["path"]))

    def ls(self, path) -> Iterator[Tuple[str, int]]:
        repo_type, repo_id, rev, inner = _parse_hf_url(path)
        at = "" if rev == "main" else f"@{rev}"
        base = f"hf://{repo_type}/{repo_id}{at}"
        for e in self._tree(repo_type, repo_id, rev, inner):
            if e.get("type") == "file":
                yield f"{base}/{e['path']}", int(e.get("size", 0))
