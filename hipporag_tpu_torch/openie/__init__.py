from .openie_llm import LLMOpenIE, OpenIEResult

__all__ = ["LLMOpenIE", "OpenIEResult"]
