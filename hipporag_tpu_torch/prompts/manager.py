"""Prompt template manager.

Loads every module in ``hipporag_tpu_torch.prompts.templates`` exposing a
``prompt_template`` attribute (a chat-message list whose ``content`` strings
are ``string.Template`` bodies), applies role mapping, and renders by name —
the contract of the reference manager (prompts/prompt_template_manager.py:14-201).
"""

from __future__ import annotations

import importlib
import pkgutil
from dataclasses import dataclass, field
from string import Template
from typing import Dict, List, Union

from ..utils.logging import get_logger

logger = get_logger(__name__)


@dataclass
class PromptTemplateManager:
    role_mapping: Dict[str, str] = field(
        default_factory=lambda: {"system": "system", "user": "user", "assistant": "assistant"}
    )
    templates: Dict[str, Union[Template, List[Dict[str, Template]]]] = field(
        default_factory=dict, init=False
    )

    def __post_init__(self):
        self._load_all()

    def _load_all(self):
        from . import templates as templates_pkg

        for modinfo in pkgutil.iter_modules(templates_pkg.__path__):
            module = importlib.import_module(
                f"{templates_pkg.__name__}.{modinfo.name}"
            )
            template = getattr(module, "prompt_template", None)
            if template is None:
                continue
            self._register(modinfo.name, template)

    def _register(self, name: str, template):
        if isinstance(template, str):
            self.templates[name] = Template(template)
        elif isinstance(template, Template):
            self.templates[name] = template
        elif isinstance(template, list):
            chat = []
            for msg in template:
                content = msg["content"]
                chat.append(
                    {
                        "role": self.role_mapping.get(msg["role"], msg["role"]),
                        "content": content if isinstance(content, Template) else Template(content),
                    }
                )
            self.templates[name] = chat
        else:
            raise ValueError(f"Unsupported template type for {name}: {type(template)}")

    def is_template_name_valid(self, name: str) -> bool:
        return name in self.templates

    def list_template_names(self) -> List[str]:
        return sorted(self.templates.keys())

    def render(self, name: str, **kwargs):
        """Render a template; chat templates return a message list.

        Substitution is STRICT (like the reference manager,
        prompt_template_manager.py:123-133): a missing kwarg raises
        instead of silently shipping a literal ``${placeholder}`` to the
        LLM (which would corrupt extractions with no error anywhere).
        Extra kwargs are ignored; messages without placeholders pass
        through unchanged.
        """
        template = self.templates[name]
        if isinstance(template, Template):
            return template.substitute(**kwargs)
        rendered = []
        for msg in template:
            try:
                content = msg["content"].substitute(**kwargs)
            except KeyError as e:
                raise ValueError(
                    f"Template '{name}' is missing required kwarg {e} "
                    f"(got {sorted(kwargs)})"
                ) from e
            rendered.append({"role": msg["role"], "content": content})
        return rendered
