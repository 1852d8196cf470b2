"""Chat model UDFs of the port (counterpart of
``pathway_tpu/xpacks/llm/llms.py``; reference: xpacks/llm/llms.py:84-544 —
OpenAIChat, LiteLLMChat, HFPipelineChat, CohereChat; capacity/retry/cache
via udfs.async_options).

``TpuChat`` decodes on the port's ``TextGenerator`` (call-level
``generate``) or through its ``ContinuousDecoder``, on the CUDA device
unless ``device="cpu"`` is passed.  The hosted-API chats import their
client package at first call, as the reference's do, and raise
``ImportError`` where it is not installed; ``HFPipelineChat`` raises so at
construction (the port does not use the HF runtime)."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

from ...internals.udfs import UDF

__all__ = [
    "BaseChat",
    "OpenAIChat",
    "LiteLLMChat",
    "CohereChat",
    "HFPipelineChat",
    "TpuChat",
    "prompt_chat_single_qa",
]

Message = Dict[str, str]


def _messages_to_prompt(messages: Union[str, Sequence[Message]]) -> str:
    if isinstance(messages, str):
        return messages
    parts = []
    for m in messages:
        role = m.get("role", "user")
        parts.append(f"{role}: {m.get('content', '')}")
    return "\n".join(parts)


def prompt_chat_single_qa(question: str) -> List[Message]:
    """(reference: llms.py prompt_chat_single_qa helper)"""
    return [{"role": "user", "content": str(question)}]


class BaseChat(UDF):
    """Chat UDFs accept a message list (or plain string) per row and return
    the model answer."""

    model: Optional[str] = None

    def _accepts_call_arg(self, name: str) -> bool:
        return True


class TpuChat(BaseChat):
    """Local generation on the port's causal LM (batched decode per
    micro-batch) — the device-native slot for the reference's
    HFPipelineChat.

    ``continuous=True`` (or ``PATHWAY_CHAT_CONTINUOUS=1``) routes every
    prompt through the shared :class:`~pathway_tpu_torch.serve.ContinuousDecoder`
    slot pool instead of call-granular decode: concurrent chat rows —
    and anything else submitted to the same engine — share one
    token-level step loop, with per-prompt EOS leave freeing slots
    mid-flight.  Tokens are identical either way (the engine is
    solo-``generate``-token-identical per request).

    ``device``/``dtype`` reach the generator (``None`` = the process
    default device, bf16); ``generator`` / ``decoder`` take prepared
    ones instead."""

    def __init__(
        self,
        model: str = "pathway-mini-lm",
        max_new_tokens: int = 48,
        temperature: float = 0.0,
        checkpoint_path: Optional[str] = None,
        generator=None,
        continuous: Optional[bool] = None,
        decoder=None,
        device=None,
        dtype=None,
        **kwargs,
    ):
        import numpy as np

        self.model = model
        if generator is None:
            from ...device import DEFAULT_DTYPE
            from ...models.generator import TextGenerator

            generator = TextGenerator(
                model=model,
                checkpoint_path=checkpoint_path,
                device=device,
                dtype=DEFAULT_DTYPE if dtype is None else dtype,
            )
        self._generator = gen = generator
        if continuous is None:
            from ... import config

            continuous = config.get("chat.continuous")
        self._decoder = decoder
        if decoder is None and continuous:
            from ...serve import ContinuousDecoder

            self._decoder = ContinuousDecoder(gen)
        engine = self._decoder

        def chat(messages) -> np.ndarray:
            prompts = [_messages_to_prompt(m) for m in messages]
            if engine is not None:
                # submit-then-gather: every row joins the shared slot
                # pool, so concurrent micro-batches coalesce at token
                # granularity instead of serializing whole decodes
                tickets = [
                    engine.submit(
                        p,
                        max_new_tokens=max_new_tokens,
                        temperature=temperature,
                    )
                    for p in prompts
                ]
                results = [t() for t in tickets]
                for r in results:
                    if getattr(r, "degraded", ()) and not str(r):
                        # an empty degraded decode (generator down at
                        # prefill) must surface as a chat FAILURE so the
                        # QA layer's extractive_answer rung takes over;
                        # partial flagged results still serve their text
                        raise RuntimeError(
                            "continuous decode degraded: "
                            + ",".join(r.degraded)
                        )
                outs = [str(r) for r in results]
            else:
                outs = gen.generate(
                    prompts,
                    max_new_tokens=max_new_tokens,
                    temperature=temperature,
                )
            return np.array(outs, dtype=object)

        super().__init__(chat, batched=True, **kwargs)


class HFPipelineChat(BaseChat):
    """Local transformers pipeline (reference: llms.py:441).  The port
    never imports the HF runtime (the card's machine does not have it), so
    this chat raises at construction, as the reference's does where
    ``transformers`` is absent; ``TpuChat`` decodes locally instead, and
    ``models/hf_import.py`` reads HF checkpoints without the runtime."""

    def __init__(
        self,
        model: Optional[str] = None,
        call_kwargs: dict | None = None,
        device: str = "cpu",
        **pipeline_kwargs,
    ):
        raise ImportError(
            "HFPipelineChat needs the `transformers` runtime, which the port does not use; "
            "use TpuChat for local generation"
        )


class _ApiChat(BaseChat):
    def __init__(
        self,
        model: Optional[str] = None,
        capacity: Optional[int] = None,
        retry_strategy=None,
        cache_strategy=None,
        temperature: float = 0.0,
        max_tokens: Optional[int] = None,
        **call_kwargs,
    ):
        self.model = model
        self.temperature = temperature
        self.max_tokens = max_tokens
        self.call_kwargs = call_kwargs
        super().__init__(
            self._make_chat_fn(),
            executor="async",
            capacity=capacity,
            retry_strategy=retry_strategy,
            cache_strategy=cache_strategy,
        )

    def _make_chat_fn(self):
        raise NotImplementedError


class OpenAIChat(_ApiChat):
    """(reference: llms.py:84)"""

    def __init__(self, model: str = "gpt-4o-mini", **kwargs):
        super().__init__(model=model, **kwargs)

    def _make_chat_fn(self):
        async def chat(messages, **kw):
            try:
                import openai
            except ImportError as e:
                raise ImportError("OpenAIChat requires the `openai` package") from e
            client = openai.AsyncOpenAI()
            if isinstance(messages, str):
                messages = prompt_chat_single_qa(messages)
            response = await client.chat.completions.create(
                model=kw.pop("model", self.model),
                messages=list(messages),
                temperature=self.temperature,
                **{**self.call_kwargs, **kw},
            )
            return response.choices[0].message.content

        return chat


class LiteLLMChat(_ApiChat):
    """(reference: llms.py:313)"""

    def _make_chat_fn(self):
        async def chat(messages, **kw):
            try:
                import litellm
            except ImportError as e:
                raise ImportError("LiteLLMChat requires the `litellm` package") from e
            if isinstance(messages, str):
                messages = prompt_chat_single_qa(messages)
            response = await litellm.acompletion(
                model=kw.pop("model", self.model),
                messages=list(messages),
                **{**self.call_kwargs, **kw},
            )
            return response.choices[0].message.content

        return chat


class CohereChat(_ApiChat):
    """(reference: llms.py:544)"""

    def _make_chat_fn(self):
        async def chat(messages, **kw):
            try:
                import cohere
            except ImportError as e:
                raise ImportError("CohereChat requires the `cohere` package") from e
            client = cohere.AsyncClient()
            prompt = _messages_to_prompt(messages)
            response = await client.chat(
                message=prompt, model=kw.pop("model", self.model) or "command-r"
            )
            return response.text

        return chat
