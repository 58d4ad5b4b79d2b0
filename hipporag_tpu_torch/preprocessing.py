"""Document → chunk preprocessing.

Contract parity with the reference preprocessing layer
(preprocessing.py:7-27; chunking knobs config_utils.py:100-117): default is
one chunk per document; a word-window chunker with overlap is provided for
long documents. Long-context handling in this framework happens on the
*corpus* axis (sharded stores/graph), not the sequence axis (SURVEY.md §5).
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import List, Union

from .config import BaseConfig
from .utils.misc import Chunk


class BaseTextPreprocessor(ABC):
    """Converts user documents into indexable chunks."""

    @abstractmethod
    def preprocess(self, docs: List[Union[str, Chunk]]) -> List[Chunk]: ...


class TextPreprocessor(BaseTextPreprocessor):
    """Default: one chunk per document."""

    def preprocess(self, docs: List[Union[str, Chunk]]) -> List[Chunk]:
        chunks: List[Chunk] = []
        for doc in docs:
            if isinstance(doc, Chunk):
                chunks.append(doc)
            elif isinstance(doc, str):
                chunks.append(Chunk(content=doc))
            else:
                raise TypeError(
                    f"Documents must be strings or Chunk instances, got {type(doc).__name__}."
                )
        return chunks


class WordWindowPreprocessor(BaseTextPreprocessor):
    """Sliding word-window chunker with overlap (``by_word`` mode)."""

    def __init__(self, max_words: int = 512, overlap_words: int = 64):
        if overlap_words >= max_words:
            raise ValueError("overlap must be smaller than the window size")
        self.max_words = max_words
        self.overlap_words = overlap_words

    def preprocess(self, docs: List[Union[str, Chunk]]) -> List[Chunk]:
        chunks: List[Chunk] = []
        for doc_idx, doc in enumerate(docs):
            if isinstance(doc, Chunk):
                text, source_id, metadata = doc.content, doc.source_id, doc.metadata
            else:
                text, source_id, metadata = doc, f"doc-{doc_idx}", {}
            words = text.split()
            if len(words) <= self.max_words:
                chunks.append(Chunk(content=text, source_id=source_id, metadata=dict(metadata)))
                continue
            step = self.max_words - self.overlap_words
            for chunk_no, start in enumerate(range(0, len(words), step)):
                window = words[start : start + self.max_words]
                if not window:
                    break
                meta = dict(metadata)
                meta["chunk_no"] = chunk_no
                chunks.append(
                    Chunk(content=" ".join(window), source_id=source_id, metadata=meta)
                )
                if start + self.max_words >= len(words):
                    break
        return chunks


class TokenWindowPreprocessor(BaseTextPreprocessor):
    """Sliding token-window chunker with overlap (``by_token`` mode).

    Token boundaries come from tiktoken's encoder for
    ``config.preprocess_encoder_name`` (reference: config_utils.py:100-117
    uses tiktoken counts for chunk sizing).
    """

    def __init__(self, max_tokens: int = 512, overlap_tokens: int = 128,
                 encoder_name: str = "gpt-4o"):
        if overlap_tokens >= max_tokens:
            raise ValueError("overlap must be smaller than the window size")
        try:
            import tiktoken

            try:
                self.enc = tiktoken.encoding_for_model(encoder_name)
            except KeyError:
                self.enc = tiktoken.get_encoding("cl100k_base")
        except Exception:  # vocab unavailable (e.g. offline) — word fallback
            self.enc = None
        self.max_tokens = max_tokens
        self.overlap_tokens = overlap_tokens

    def _encode(self, text: str):
        if self.enc is None:
            return text.split()
        return self.enc.encode(text)

    def _decode(self, tokens) -> str:
        if self.enc is None:
            return " ".join(tokens)
        return self.enc.decode(tokens)

    def preprocess(self, docs: List[Union[str, Chunk]]) -> List[Chunk]:
        chunks: List[Chunk] = []
        for doc_idx, doc in enumerate(docs):
            if isinstance(doc, Chunk):
                text, source_id, metadata = doc.content, doc.source_id, doc.metadata
            else:
                text, source_id, metadata = doc, f"doc-{doc_idx}", {}
            tokens = self._encode(text)
            if len(tokens) <= self.max_tokens:
                chunks.append(Chunk(content=text, source_id=source_id, metadata=dict(metadata)))
                continue
            step = self.max_tokens - self.overlap_tokens
            for chunk_no, start in enumerate(range(0, len(tokens), step)):
                window = tokens[start : start + self.max_tokens]
                if not window:
                    break
                meta = dict(metadata)
                meta["chunk_no"] = chunk_no
                chunks.append(
                    Chunk(content=self._decode(window), source_id=source_id, metadata=meta)
                )
                if start + self.max_tokens >= len(tokens):
                    break
        return chunks


def get_preprocessor(config: BaseConfig) -> BaseTextPreprocessor:
    name = config.text_preprocessor_class_name
    if name == "TextPreprocessor":
        if config.preprocess_chunk_max_token_size is not None:
            if config.preprocess_chunk_func == "by_word":
                return WordWindowPreprocessor(
                    max_words=config.preprocess_chunk_max_token_size,
                    overlap_words=config.preprocess_chunk_overlap_token_size,
                )
            return TokenWindowPreprocessor(
                max_tokens=config.preprocess_chunk_max_token_size,
                overlap_tokens=config.preprocess_chunk_overlap_token_size,
                encoder_name=config.preprocess_encoder_name,
            )
        return TextPreprocessor()
    if name == "WordWindowPreprocessor":
        return WordWindowPreprocessor(
            max_words=config.preprocess_chunk_max_token_size or 512,
            overlap_words=config.preprocess_chunk_overlap_token_size,
        )
    if name == "TokenWindowPreprocessor":
        return TokenWindowPreprocessor(
            max_tokens=config.preprocess_chunk_max_token_size or 512,
            overlap_tokens=config.preprocess_chunk_overlap_token_size,
            encoder_name=config.preprocess_encoder_name,
        )
    raise ValueError(f"Unknown preprocessor: {name}")
