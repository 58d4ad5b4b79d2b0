"""Offline batch-inference engines (reference: llm/vllm_offline.py:28-101,
llm/transformers_offline.py:31-95).

These back the two-phase "offline OpenIE" indexing protocol: phase 1 runs
the whole corpus through a local batch engine with JSON-schema-guided
decoding, phase 2 consumes the saved results (reference HippoRAG.py:243-260).

- ``VLLMOffline`` — in-process vLLM engine with guided JSON. vLLM is an
  optional CUDA-side dependency; constructing it without vllm installed
  raises ImportError. An external OpenAI-compatible server is the
  alternative (the engines here exist for parity with the reference's
  GPU workflow).
- ``TransformersOffline`` — HF batch generation. The reference constrains
  decoding with ``outlines``; here malformed JSON is handled by the same
  repair/validation pass the online path uses (utils/llm_json.py), which
  keeps the dependency surface minimal.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from ..utils.llm_json import extract_json_dict, repair_truncated_json
from ..utils.logging import get_logger
from .base import BaseLLM, TextChatMessage

logger = get_logger(__name__)


class VLLMOffline(BaseLLM):
    """In-process vLLM batch engine (reference: llm/vllm_offline.py).

    TP size follows the local accelerator count like the reference
    (vllm_offline.py:39-41); guided JSON decoding is passed through
    vLLM's guided_json sampling option.
    """

    def __init__(self, global_config=None):
        super().__init__(global_config)
        try:
            from vllm import LLM as VLLMEngine
        except ImportError as e:  # pragma: no cover - env without vllm
            raise ImportError(
                "VLLMOffline requires the vllm package; without it "
                "use an external OpenAI-compatible server via llm_base_url"
            ) from e
        import torch

        cfg = self.global_config
        model = cfg.llm_name.split("/", 1)[1] if "/" in cfg.llm_name else cfg.llm_name
        num_devices = max(torch.cuda.device_count(), 1)
        self.engine = VLLMEngine(
            model=model,
            tensor_parallel_size=num_devices,
            max_model_len=4096,
            seed=cfg.seed or 0,
        )

    def infer(self, messages: List[TextChatMessage], **kwargs):
        return self.batch_infer([messages], **kwargs)[0]

    def batch_infer(
        self, batch_messages: List[List[TextChatMessage]],
        json_schema: Optional[dict] = None, **kwargs,
    ) -> List[Tuple[str, Dict[str, Any], bool]]:
        from vllm import SamplingParams

        cfg = self.global_config
        params = SamplingParams(
            temperature=cfg.temperature,
            max_tokens=cfg.max_new_tokens or 2048,
        )
        if json_schema is not None:
            try:
                from vllm.sampling_params import GuidedDecodingParams

                params.guided_decoding = GuidedDecodingParams(json=json_schema)
            except ImportError:
                pass
        prompts = [
            "\n\n".join(f"{m['role']}: {m['content']}" for m in msgs)
            for msgs in batch_messages
        ]
        outputs = self.engine.generate(prompts, params)
        results = []
        for out in outputs:
            text = out.outputs[0].text
            meta = {
                "prompt_tokens": len(out.prompt_token_ids),
                "completion_tokens": len(out.outputs[0].token_ids),
                "finish_reason": out.outputs[0].finish_reason,
            }
            results.append((text, meta, False))
        return results


class TransformersOffline(BaseLLM):
    """HF batch generation with JSON repair (reference: transformers_offline.py)."""

    def __init__(self, global_config=None):
        super().__init__(global_config)
        cfg = self.global_config
        self.model_name = (
            cfg.llm_name.split("/", 1)[1] if cfg.llm_name.startswith("Transformers") else cfg.llm_name
        )
        self._model = None
        self._tokenizer = None

    def _load(self):
        if self._model is not None:
            return
        import torch
        from transformers import AutoModelForCausalLM, AutoTokenizer

        self._tokenizer = AutoTokenizer.from_pretrained(self.model_name, padding_side="left")
        self._model = AutoModelForCausalLM.from_pretrained(
            self.model_name, torch_dtype="auto", device_map="auto"
        )
        if self._tokenizer.pad_token is None:
            self._tokenizer.pad_token = self._tokenizer.eos_token
        self._torch = torch

    def infer(self, messages: List[TextChatMessage], **kwargs):
        return self.batch_infer([messages], **kwargs)[0]

    def batch_infer(
        self, batch_messages: List[List[TextChatMessage]],
        json_schema: Optional[dict] = None, **kwargs,
    ) -> List[Tuple[str, Dict[str, Any], bool]]:
        self._load()
        cfg = self.global_config
        max_new = cfg.max_new_tokens or 2048
        prompts = []
        for msgs in batch_messages:
            if getattr(self._tokenizer, "chat_template", None):
                prompts.append(
                    self._tokenizer.apply_chat_template(
                        msgs, tokenize=False, add_generation_prompt=True
                    )
                )
            else:
                prompts.append(
                    "\n\n".join(f"{m['role']}: {m['content']}" for m in msgs)
                    + "\n\nassistant:"
                )
        inputs = self._tokenizer(prompts, return_tensors="pt", padding=True).to(
            self._model.device
        )
        with self._torch.no_grad():
            out = self._model.generate(
                **inputs,
                max_new_tokens=max_new,
                do_sample=cfg.temperature > 0,
                temperature=max(cfg.temperature, 1e-5),
                pad_token_id=self._tokenizer.pad_token_id,
            )
        results = []
        plen = inputs["input_ids"].shape[1]
        attn = inputs.get("attention_mask")
        pad_id = self._tokenizer.pad_token_id
        for i in range(out.shape[0]):
            gen = out[i][plen:]
            text = self._tokenizer.decode(gen, skip_special_tokens=True)
            if json_schema is not None and extract_json_dict(text) is None:
                text = repair_truncated_json(text)
            # per-row accounting: the padded batch tensor is rectangular,
            # so raw shapes over-count pad tokens for every row that
            # stopped before the batch maximum
            row_prompt = (
                int(attn[i].sum()) if attn is not None else int(plen)
            )
            if pad_id is not None:
                row_gen = int((gen != pad_id).sum())
            else:
                row_gen = int(gen.shape[0])
            meta = {
                "prompt_tokens": row_prompt,
                "completion_tokens": row_gen,
                "finish_reason": "length" if row_gen >= max_new else "stop",
            }
            results.append((text, meta, False))
        return results
