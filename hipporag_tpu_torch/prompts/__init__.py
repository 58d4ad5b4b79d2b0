from .filter_prompt import best_filter_prompt, default_filter_demos
from .linking import get_query_instruction
from .manager import PromptTemplateManager

__all__ = [
    "PromptTemplateManager",
    "best_filter_prompt",
    "default_filter_demos",
    "get_query_instruction",
]
