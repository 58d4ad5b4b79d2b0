"""The graph-vs-dense quality sections, one knob resolver for all callers
(port of ``hipporag_tpu/evaluation/bench_sections.py``).

Each section resolves its ``BENCH_*`` environment knobs here, with the JAX
package's defaults and parsing, and runs the port's harness on ``device``.
A caller that runs a section in-process and one that runs it in a
subprocess therefore measure the same configuration.

The one difference from the JAX module: ``DEFAULT_CORPUS`` lies inside
this checkout (``reproduce/dataset/`` under the repository root), where the
JAX module names the reference machine's copy. ``BENCH_2WIKI_CORPUS``
overrides it in both.
"""

import os

SECTIONS = ("2wiki", "hotpot", "musique", "replay", "multihop")

# repo root (this file lives at <repo>/hipporag_tpu_torch/evaluation/)
_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
DEFAULT_CORPUS = os.path.join(_REPO_ROOT, "reproduce", "dataset", "2wikimultihopqa_corpus.json")


def corpus_path() -> str:
    return os.environ.get("BENCH_2WIKI_CORPUS", DEFAULT_CORPUS)


def run_section(section: str, save_dir: str, repo_root: str = _REPO_ROOT, device="cuda"):
    """Resolve one quality section's BENCH_* env knobs and run it on ``device``.

    Returns the section's result dict (see evaluation/twiki.py,
    hotpot_synth.py, musique_synth.py, multihop.py, replay_quality.py).
    Raises ValueError on an unknown section name: callers must fail
    loudly, not skip silently.
    """
    corpus = corpus_path()
    if section == "2wiki":
        from .twiki import run_2wiki_eval

        # BENCH_2WIKI_EXACT: unset/"all" = every query, "0" = off
        # (matching the other BENCH_*=0 disable convention), N = first N
        exact_env = os.environ.get("BENCH_2WIKI_EXACT", "all")
        exact_q = (
            None if exact_env == "0"
            else 0 if exact_env == "all" else int(exact_env)
        )
        # n_queries default 0 = every synthesizable query
        return run_2wiki_eval(
            corpus,
            save_dir=save_dir,
            n_queries=int(os.environ.get("BENCH_2WIKI_QUERIES", 0)),
            n_docs=int(os.environ.get("BENCH_2WIKI_DOCS", 0)) or None,
            top_k=20,
            twin_queries=int(os.environ.get("BENCH_2WIKI_TWIN", 128)),
            exact_queries=exact_q,
            device=device,
        )
    if section == "hotpot":
        from .hotpot_synth import run_hotpot_eval

        return run_hotpot_eval(
            corpus,
            save_dir=save_dir,
            n_docs=int(os.environ.get("BENCH_HOTPOT_DOCS", 2000)),
            n_queries=int(os.environ.get("BENCH_HOTPOT_QUERIES", 0)),
            device=device,
        )
    if section == "musique":
        from .musique_synth import run_musique_eval

        return run_musique_eval(
            corpus,
            save_dir=save_dir,
            n_docs=int(os.environ.get("BENCH_MUSIQUE_DOCS", 2000)),
            n_queries=int(os.environ.get("BENCH_MUSIQUE_QUERIES", 0)),
            device=device,
        )
    if section == "multihop":
        from .multihop import run_multihop_eval

        # no BENCH_* knobs: the chain corpus is tiny and fixed
        return run_multihop_eval(save_dir=save_dir, device=device)
    if section == "replay":
        from .replay_quality import (
            QUALITY_DOCS_FULL,
            run_replay_quality_eval,
        )

        # the FULL recorded slice (2500 docs, 473 queries) for statistical
        # power at R@2; the pinned test replays the 1000-doc slice. Only
        # these two doc counts are in the fixture: the filter prompts' cache
        # keys depend on the whole indexed graph, so other sizes would
        # replay-miss.
        return run_replay_quality_eval(
            fixture_path=os.path.join(
                repo_root, "tests", "fixtures",
                "replay_2wiki_quality_cache.sqlite",
            ),
            save_dir=save_dir,
            corpus_path=corpus,
            n_docs=int(os.environ.get("BENCH_REPLAY_DOCS", QUALITY_DOCS_FULL)),
            device=device,
        )
    raise ValueError(f"unknown quality section: {section!r}")
