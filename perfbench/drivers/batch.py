"""Closed loop with one caller: each call hands an entry point of the port
(``HippoRAG.retrieve`` or ``retrieve_dpr``) ``questions_per_call`` questions
never asked before, and the next call starts when it returns. Before each
call the harness makes its questions and, unless the configuration names a
question encoder, their vectors, the inputs an evaluation run embeds up
front; that is outside the call's time. A named encoder runs inside the
call. The window is the calls: they run until ``--seconds`` have passed,
the last call ends it, and ``retrieve_qps`` is the questions they answered
over their summed wall time. With an encoder, after the window, the
program's own fact and passage rows of the sampled questions (and, in a
traced run, of every question of the window, for the work counted) are
kept for the comparison (``query_rows``).

Traffic keys: ``entry``, ``questions_per_call``, ``sample`` (answers
judged).
"""

from __future__ import annotations

import sys
import time

from ..sampling import Reservoir, answer
from ..trace import Window


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.rag = ctx.dep.rag
        self.params = ctx.params
        self.entry = getattr(self.rag, self.params["entry"])
        self.per_call = int(self.params["questions_per_call"])

    def prepare(self) -> None:
        dep = self.ctx.dep
        self.entry(dep.take_questions(self.per_call))  # warm-up: the window's shapes
        if self.ctx.trace:
            Window(dep.device).warm()

    def measure(self) -> dict:
        ctx, rag = self.ctx, self.rag
        sample = Reservoir(self.params["sample"], ctx.seed)
        k = rag.global_config.retrieval_top_k
        graph = self.params["entry"] == "retrieve"
        window = Window(ctx.dep.device) if ctx.trace else None
        calls = []
        start = time.perf_counter()
        while True:
            # the call's inputs; their vectors reach the host before it starts
            qs = ctx.dep.take_questions(self.per_call)
            profile = window is not None and window.prof is None and time.perf_counter() >= start + 0.4 * ctx.seconds
            if profile:
                window.start()
            t0 = time.perf_counter()
            sols = self.entry(qs)
            t1 = time.perf_counter()
            if profile:
                window.stop()
            calls.append({"questions": qs, "t0": t0, "t1": t1, "traced": profile})
            if profile:
                print(f"perfbench: profiled call {t1 - t0:.3f} s", file=sys.stderr)
            sample.offer(sols)
            if t1 >= start + ctx.seconds:
                break
        window_s = sum(c["t1"] - c["t0"] for c in calls)
        answered = sum(len(c["questions"]) for c in calls)
        print(f"perfbench: {len(calls)} calls, {window_s:.3f} s in calls of {calls[-1]['t1'] - start:.3f} s",
              file=sys.stderr)
        out = {
            "e2e": {"retrieve_qps": answered / window_s},
            "attempted": answered,
            "failed": 0,
            "answers": [answer(s.question, s.docs, s.doc_scores, k, s.graph_seeds if graph else None)
                        for s in sample.items],
            "counters": {},
            "calls": [{"questions": c["questions"], "entry": self.params["entry"], "traced": c["traced"]}
                      for c in calls],
            "trace": window.reduce() if window is not None and window.prof is not None else None,
            "window_s": window_s,
        }
        if ctx.dep.encoder is not None:
            asked = [s.question for s in sample.items]
            if ctx.trace:
                asked += [q for c in calls for q in c["questions"]]
            out["query_rows"] = ctx.dep.query_rows(asked)
        return out

    def close(self) -> None:
        pass
