"""Seeded synthetic corpus, its OpenIE output, and the questions asked of it.

The shape is that of the served-index corpus the port was brought up on: a
title line and 3-6 sentences of 10-25 words per passage; each sentence names
2-4 entities, its head first; every passage opens with its title, a name of
its own. An entity mention draws a two-word name Zipf-skewed from a pool of
``pool_per_passage`` names per passage, and, with chance ``variant_share``,
one of its ``variants`` surface forms (the name and a suffix word, such as
"Kalove Misondra Jr") instead of the name itself. The forms of one name
share most of their character n-grams, so they become distinct graph nodes
joined by synonymy edges, as "Barack Obama" and "Obama" are in a real
knowledge graph; the parameters are fitted to the graph HippoRAG reports
for MuSiQue (nodes, triples and synonymy edges). The OpenIE output is made
here from the same draws, so no LLM runs: each sentence yields ``[head,
relation, other]`` for every other entity of the sentence, the relation
being the filler words that precede ``other``.

The corpus's structure (sentence and entity counts, which pool entity each
mention is, filler counts) is drawn from a fixed stream, so every seed
gives a graph of the same shape and the same work; the seed draws the
names, the filler words and the questions.

Questions are "Tell me about X." or "What connects X and Y?" over the
entities of one passage. A :class:`QuestionStream` never hands out the same
question twice.
"""

from __future__ import annotations

import numpy as np

NAME_SYLLABLES = ("ka lo ve mi dra sen tu bor li qua ren sta fa zel mor ni pe ri gu hal "
                  "wy cor bal dun gar hol jor kel lan mar nor par rus sol tam var wen yor").split()
FILLER_SYLLABLES = "ab ec id ob ut an en il om up ar es ir os ul ax ev im oz ud".split()
VARIANT_SUFFIXES = ("Jr", "Sr", "II", "III")


def _words(rng, syllables, count, parts=(2, 4)):
    """``count`` words of 2-3 syllables."""
    lengths = rng.integers(*parts, count)
    picks = rng.integers(0, len(syllables), int(lengths.sum()))
    cuts = np.concatenate([[0], np.cumsum(lengths)])
    return ["".join(syllables[j] for j in picks[cuts[i]:cuts[i + 1]]) for i in range(count)]


def _names(rng, count):
    """``count`` distinct capitalized two-word names."""
    out = {}
    while len(out) < count:
        first = _words(rng, NAME_SYLLABLES, 2 * count)
        for a, b in zip(first[::2], first[1::2]):
            out.setdefault(f"{a.capitalize()} {b.capitalize()}", None)
            if len(out) == count:
                break
    return list(out)


class Corpus:
    """Passages, their entities and their OpenIE triples, all from ``seed``.

    ``shape`` holds ``passages``, ``pool_per_passage``, ``zipf_s``,
    ``variants`` (at most 4), ``variant_share``, ``sentences`` [lo, hi],
    ``words`` [lo, hi] and ``entities`` [lo, hi] (inclusive ranges), as a
    configuration file states them.
    """

    def __init__(self, seed: int, shape: dict):
        self.shape = shape
        rng = np.random.default_rng([seed, 0])
        self.structure = np.random.default_rng([0, 0])
        n = int(shape["passages"])
        pool = int(shape["pool_per_passage"]) * n
        names = _names(rng, pool + n)
        self.pool, titles = names[:pool], names[pool:]
        self.fillers = _words(rng, FILLER_SYLLABLES, 2_000)
        weights = 1.0 / np.arange(1, pool + 1) ** float(shape["zipf_s"])
        weights /= weights.sum()
        self.docs, self.entities, self.triples = [], [], []
        s_lo, s_hi = shape["sentences"]
        e_lo, e_hi = shape["entities"]
        n_sent = self.structure.integers(s_lo, s_hi + 1, n)
        counts = self.structure.integers(e_lo, e_hi + 1, int(n_sent.sum()))
        total = int(counts.sum())
        drawn = self.structure.choice(pool, total, p=weights)
        n_var = int(shape["variants"])
        forms = np.where(self.structure.random(total) < float(shape["variant_share"]),
                         1 + self.structure.integers(0, n_var, total), 0)
        surface = [[name] + [f"{name} {suffix}" for suffix in VARIANT_SUFFIXES[:n_var]] for name in self.pool]
        at_sent = at_ent = 0
        for p in range(n):
            sentences, names_in, triples = [], {titles[p]: None}, []
            for i in range(int(n_sent[p])):
                c = int(counts[at_sent])
                at_sent += 1
                ents = [surface[j][f] for j, f in zip(drawn[at_ent:at_ent + c], forms[at_ent:at_ent + c])]
                at_ent += c
                if i == 0:
                    ents[0] = titles[p]
                ents = list(dict.fromkeys(ents))
                names_in.update(dict.fromkeys(ents))
                text, relations = self._sentence(rng, ents)
                sentences.append(text)
                triples.extend([ents[0], rel, other] for other, rel in zip(ents[1:], relations))
            self.docs.append(titles[p] + "\n" + " ".join(sentences))
            self.entities.append(list(names_in))
            self.triples.append(list({tuple(t): list(t) for t in triples}.values()))

    def _sentence(self, rng, entities):
        """``entities`` (the head first) in one sentence of 10-25 words, each
        pair apart by at least one lowercase filler word; returns the text and,
        for each entity after the head, the filler words before it."""
        w_lo, w_hi = self.shape["words"]
        k = len(entities)
        n_fill = max(k, int(self.structure.integers(w_lo, w_hi + 1)) - 2 * k)
        gaps = 1 + self.structure.multinomial(n_fill - k, [1 / k] * k)
        picks = rng.integers(0, len(self.fillers), int(gaps.sum()))
        words, relations, at = [], [], 0
        for ent, gap in zip(entities, gaps):
            words.append(ent)
            fill = [self.fillers[j] for j in picks[at:at + gap]]
            at += gap
            words.extend(fill)
            relations.append(" ".join(fill))
        return " ".join(words) + ".", relations[:-1]

    def openie(self) -> list:
        """The OpenIE rows of every passage, in the form the port persists."""
        return [
            {"passage": doc, "extracted_entities": ents, "extracted_triples": triples}
            for doc, ents, triples in zip(self.docs, self.entities, self.triples)
        ]


class QuestionStream:
    """Distinct questions over the corpus, drawn from their own seed stream."""

    def __init__(self, corpus: Corpus, seed: int):
        self.corpus = corpus
        self.rng = np.random.default_rng([seed, 1])
        self.seen: set = set()

    def draw(self) -> str:
        """One question, possibly asked before."""
        rng = self.rng
        ents = self.corpus.entities[int(rng.integers(0, len(self.corpus.docs)))]
        pick = rng.choice(len(ents), min(len(ents), int(rng.integers(1, 3))), replace=False)
        if len(pick) == 1:
            return f"Tell me about {ents[pick[0]]}."
        return f"What connects {ents[pick[0]]} and {ents[pick[1]]}?"

    def take(self, count: int) -> list:
        """``count`` questions never handed out before by this stream."""
        out, misses = [], 0
        while len(out) < count:
            q = self.draw()
            if q in self.seen:
                misses += 1
                if misses > 100 * count + 10_000:
                    raise RuntimeError(f"the corpus has too few distinct questions for {count} more")
                continue
            self.seen.add(q)
            out.append(q)
        return out
