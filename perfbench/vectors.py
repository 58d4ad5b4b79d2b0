"""The benchmark's text vectors: a frozen, batched copy of the port's
feature-hashed character n-gram embedder (``embedding/hashing.py``).

Each word ``w`` of ``[a-z0-9]+`` contributes its features ``w:<w>`` and the
3- to 5-grams of ``^w$``; a feature adds its crc32 sign (bit 31 clear: +1)
at bucket ``crc32 % dim``. A nonzero bucket sum ``c`` becomes
``sign(c) * (1 + log|c|)`` and each row is L2-normalized. The hashes are
taken once per distinct word on the host; the sums are one scatter-add on
the device. Entity names that share n-grams get near vectors, so the graph
gets synonymy edges, and questions land near the passages they name.
"""

from __future__ import annotations

import re
import zlib

import numpy as np
import torch

_TOKEN = re.compile(r"[a-z0-9]+")


def word_features(word: str, dim: int):
    """(buckets int64, signs float32) of one word's features."""
    marked = f"^{word}$"
    feats = [f"w:{word}"]
    for n in range(3, 6):
        feats.extend(marked[i:i + n] for i in range(len(marked) - n + 1))
    hashes = np.fromiter((zlib.crc32(f.encode("utf-8")) for f in feats), dtype=np.uint32, count=len(feats))
    return (hashes % dim).astype(np.int64), np.where((hashes >> 31) & 1 == 0, 1.0, -1.0).astype(np.float32)


def embed_texts(texts, dim: int, device) -> torch.Tensor:
    """[len(texts), dim] float32 unit rows on ``device`` (a text with no
    token gives a zero row)."""
    vocab: dict = {}
    rows, wids = [], []
    for r, text in enumerate(texts):
        for w in _TOKEN.findall(text.lower()):
            rows.append(r)
            wids.append(vocab.setdefault(w, len(vocab)))
    out = torch.zeros(len(texts), dim, dtype=torch.float32, device=device)
    if not rows:
        return out
    feats = [word_features(w, dim) for w in vocab]
    lens = np.fromiter((len(b) for b, _ in feats), dtype=np.int64, count=len(feats))
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    buckets = np.concatenate([b for b, _ in feats])
    signs = np.concatenate([s for _, s in feats])
    wids = np.asarray(wids, np.int64)
    occ_lens = lens[wids]
    # feature positions of every word occurrence: start of its word + 0..len-1
    offs = np.arange(int(occ_lens.sum())) - np.repeat(np.cumsum(occ_lens) - occ_lens, occ_lens)
    pos = np.repeat(starts[wids], occ_lens) + offs
    r_idx = torch.from_numpy(np.repeat(np.asarray(rows, np.int64), occ_lens)).to(device)
    c_idx = torch.from_numpy(buckets[pos]).to(device)
    out.index_put_((r_idx, c_idx), torch.from_numpy(signs[pos]).to(device), accumulate=True)
    mag = out.abs()
    out = torch.where(mag > 0, torch.sign(out) * (1.0 + torch.log(torch.clamp_min(mag, 1.0))), 0.0)
    norm = torch.linalg.vector_norm(out, dim=1, keepdim=True)
    return out / torch.clamp_min(norm, 1e-12)
