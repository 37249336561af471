"""Tokenization: byte-pair encoding over tiktoken-format vocabularies.

Reference: ``daft_tpu/functions/tokenize.py`` (after the tokenize crate,
``src/daft-functions-tokenize``: ``tokenize_encode`` /
``tokenize_decode``), a dependency-free BPE. Vocabularies load from local
tiktoken-format files (one ``base64(token) rank`` pair per line); the
builtin ``"bytes"`` tokenizer (ids = raw utf-8 bytes) needs no file.

The merge loop runs in the native host library (``native.BpeVocab``)
with ``DAFT_TORCH_NATIVE`` on, where a failed build raises
(``native.NativeBuildError``); off, this module's Python merge loop gives
the same ids. Without the ``regex`` package the pretokenizer is the
reference's ASCII approximation (:data:`PATTERN_KIND` says which runs).
"""

from __future__ import annotations

import base64
import functools
import threading
from typing import Dict, List, Optional

try:
    import regex as _re  # \p{L} classes like the reference's pretokenizer
except ImportError:  # pragma: no cover
    import re as _re

# GPT-2-family pretokenization pattern (the published tiktoken pattern for
# r50k/p50k vocabs; pure interop constant)
_DEFAULT_PATTERN = (
    r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+"
    r"|\s+(?!\S)|\s+")
#: which pretokenizer pattern runs: ``unicode`` (``regex``) or ``ascii``
PATTERN_KIND = "unicode"
if _re.__name__ == "re":  # pragma: no cover - ascii approximation
    PATTERN_KIND = "ascii"
    _DEFAULT_PATTERN = (
        r"'s|'t|'re|'ve|'m|'ll|'d| ?[A-Za-z]+| ?[0-9]+| ?[^\sA-Za-z0-9]+"
        r"|\s+(?!\S)|\s+")


class BPETokenizer:
    """Greedy lowest-rank byte-pair merges (the tiktoken algorithm). The
    merge loop runs in the native library (``native/src/kernels.cpp``
    ``dn_bpe_*``) with ``DAFT_TORCH_NATIVE`` on, else in :meth:`_bpe`:
    both give the same ids."""

    def __init__(self, ranks: Dict[bytes, int],
                 pattern: Optional[str] = None):
        self.ranks = ranks
        self.decoder = {v: k for k, v in ranks.items()}
        self._rx = _re.compile(pattern or _DEFAULT_PATTERN)
        self._native = None
        from .. import native
        if native.available():
            toks = list(ranks)
            self._native = native.BpeVocab(toks,
                                           [ranks[t] for t in toks])

    # ------------------------------------------------------------ encode
    def _bpe(self, piece: bytes) -> List[int]:
        if piece in self.ranks:
            return [self.ranks[piece]]
        parts = [piece[i:i + 1] for i in range(len(piece))]
        while len(parts) > 1:
            best_rank = None
            best_i = -1
            for i in range(len(parts) - 1):
                r = self.ranks.get(parts[i] + parts[i + 1])
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank = r
                    best_i = i
            if best_rank is None:
                break
            parts[best_i:best_i + 2] = [parts[best_i] + parts[best_i + 1]]
        out = []
        for p in parts:
            r = self.ranks.get(p)
            if r is None:
                raise ValueError(
                    f"byte sequence {p!r} not in vocabulary (vocab lacks "
                    f"single-byte tokens?)")
            out.append(r)
        return out

    def encode(self, text: str) -> List[int]:
        return self.encode_many([text])[0].tolist()

    def encode_many(self, texts):
        """The ids of many texts at once → (every text's ids end to end,
        int64; the id count of each text). The same ids as :meth:`encode`
        text by text; the native library encodes all the pieces in one
        call."""
        import numpy as np
        pieces: List[bytes] = []
        per_text = np.empty(len(texts), dtype=np.int64)
        for i, text in enumerate(texts):
            ps = [p.encode("utf-8") for p in self._rx.findall(text)]
            per_text[i] = len(ps)
            pieces.extend(ps)
        if self._native is not None:
            flat, counts = self._native.encode_flat(pieces)
            if flat is None:
                raise ValueError(
                    "text not fully covered by the vocabulary (vocab "
                    "lacks single-byte tokens?)")
            flat = flat.astype(np.int64)
        else:
            ids = [self._bpe(p) for p in pieces]
            counts = np.fromiter((len(x) for x in ids), np.int64, len(ids))
            flat = np.fromiter((t for x in ids for t in x), np.int64,
                               int(counts.sum()))
        # a text's ids are its pieces' ids: sum the pieces' counts per text
        cum = np.concatenate([[0], np.cumsum(counts)])
        ends = np.cumsum(per_text)
        return flat, cum[ends] - cum[ends - per_text]

    def decode(self, ids: List[int]) -> str:
        buf = bytearray()
        for i in ids:
            tok = self.decoder.get(int(i))
            if tok is None:
                raise ValueError(f"token id {i} not in vocabulary")
            buf += tok
        return buf.decode("utf-8", errors="replace")


def _load_tiktoken_file(path: str) -> Dict[bytes, int]:
    ranks: Dict[bytes, int] = {}
    with open(path, "rb") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            tok_b64, rank = line.split()
            ranks[base64.b64decode(tok_b64)] = int(rank)
    return ranks


_cache: Dict[str, BPETokenizer] = {}
_cache_lock = threading.Lock()


def get_tokenizer(tokens_path: Optional[str],
                  pattern: Optional[str] = None) -> BPETokenizer:
    """``None``/``"bytes"`` → builtin byte-level tokenizer; otherwise a
    local tiktoken-format vocab file path."""
    key = f"{tokens_path}\x00{pattern}"
    with _cache_lock:
        tk = _cache.get(key)
        if tk is None:
            if tokens_path in (None, "bytes"):
                ranks = {bytes([i]): i for i in range(256)}
            else:
                # daft-lint: allow(blocking-under-lock) -- load-once
                # dedupe is the point: holding the cache lock during the
                # vocab read stops N threads doing N expensive loads
                ranks = _load_tiktoken_file(tokens_path)
            tk = BPETokenizer(ranks, pattern)
            _cache[key] = tk
    return tk


def eval_tokenize(fn: str, e, kids, out_field):
    """Expression entry: ``str.tokenize_encode`` / ``str.tokenize_decode``."""
    from ..datatype import DataType
    from ..series import Series
    s = kids[0]
    name = s.name()
    tokens_path, pattern = e.params
    tk = get_tokenizer(tokens_path, pattern)
    if fn == "tokenize_encode":
        import numpy as np
        import pyarrow as pa
        texts = s.to_pylist()
        valid = np.fromiter((v is not None for v in texts), bool, len(texts))
        flat, lens = tk.encode_many([v for v in texts if v is not None])
        counts = np.zeros(len(texts), dtype=np.int64)
        counts[valid] = lens
        offsets = np.concatenate([[0], np.cumsum(counts)])
        dtype = DataType.list(DataType.uint32())
        arr = pa.LargeListArray.from_arrays(
            pa.array(offsets, pa.int64()), pa.array(flat, pa.uint32()),
            mask=pa.array(~valid))
        return Series.from_arrow(arr, name).cast(dtype)
    if fn == "tokenize_decode":
        out = [None if v is None else tk.decode(v) for v in s.to_pylist()]
        return Series.from_pylist(out, name, dtype=DataType.string())
    raise NotImplementedError(f"str.{fn}")
