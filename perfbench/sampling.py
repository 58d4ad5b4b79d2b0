"""The sample of answers that is judged: a reservoir drawn from the seed,
so the window keeps a bounded number of the program's outputs alive."""

from __future__ import annotations

import numpy as np


class Reservoir:
    def __init__(self, size: int, seed: int):
        self.size = int(size)
        self.rng = np.random.default_rng([seed, 2])
        self.items: list = []
        self.seen = 0

    def offer(self, items) -> None:
        """Offer ``items`` in order; each of the ``seen`` so far is kept with
        equal chance."""
        m = len(items)
        pos = np.arange(self.seen, self.seen + m)
        draws = (self.rng.random(m) * (pos + 1)).astype(np.int64)
        for item, i, j in zip(items, pos, draws):
            if i < self.size:
                self.items.append(item)
            elif j < self.size:
                self.items[j] = item
        self.seen += m


def answer(question: str, docs, scores, k: int, facts=None) -> dict:
    """One answer in the form ``check.judge`` reads."""
    return {"question": question, "docs": list(docs), "scores": [float(s) for s in scores], "k": int(k),
            "facts": [tuple(f) for f in facts] if facts is not None else None}
