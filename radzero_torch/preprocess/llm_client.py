"""OpenAI-compatible chat-completion client for key-phrase extraction (copy of
radzero_tpu/preprocess/llm_client.py).

The reference runs Llama-3.3-70B-Instruct on a local vLLM engine
(preprocess/mimic_cxr/prompt_alignment.py:121-194, TP=4, 32k-record
batches). The port talks to the SERVED equivalent instead — any
OpenAI-compatible endpoint (``vllm serve``, TGI, llama.cpp server, a
hosted API): point :class:`OpenAIChatClient` at ``base_url`` and plug it
into :class:`~radzero_torch.preprocess.keyphrases.LLMKeyPhraseExtractor`.

stdlib-only (urllib): no extra dependency, works in hermetic
environments. Transport-level retries with exponential backoff are
handled here; JSON-parse retries and failed-record quarantine live in
the extractor (prompt_alignment.py:87-116 semantics).
"""

from __future__ import annotations

import json
import time
import urllib.error
import urllib.request
from dataclasses import dataclass
from typing import Optional

from radzero_torch.utils.logging import logger


@dataclass
class OpenAIChatClient:
    """``complete(system_prompt, user_text) -> str`` over HTTP.

    Example (vLLM, the reference's engine, served):
        vllm serve meta-llama/Llama-3.3-70B-Instruct --tensor-parallel-size 4
        client = OpenAIChatClient("http://localhost:8000/v1",
                                  model="meta-llama/Llama-3.3-70B-Instruct")
    """

    base_url: str
    model: str = "meta-llama/Llama-3.3-70B-Instruct"
    api_key: Optional[str] = None
    temperature: float = 0.0
    max_tokens: int = 1024
    timeout: float = 120.0
    transport_retries: int = 3
    backoff_s: float = 1.0

    def __call__(self, system_prompt: str, user_text: str) -> str:
        url = self.base_url.rstrip("/") + "/chat/completions"
        payload = {
            "model": self.model,
            "messages": [
                {"role": "system", "content": system_prompt},
                {"role": "user", "content": user_text},
            ],
            "temperature": self.temperature,
            "max_tokens": self.max_tokens,
        }
        headers = {"Content-Type": "application/json"}
        if self.api_key:
            headers["Authorization"] = f"Bearer {self.api_key}"

        last_err: Exception = RuntimeError("unreachable")
        for attempt in range(self.transport_retries):
            try:
                req = urllib.request.Request(
                    url, data=json.dumps(payload).encode(), headers=headers
                )
                with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                    body = json.loads(resp.read().decode())
                return body["choices"][0]["message"]["content"]
            except (urllib.error.URLError, urllib.error.HTTPError, OSError,
                    KeyError, json.JSONDecodeError) as e:
                # Non-retryable client errors (bad auth, malformed request)
                # fail immediately; only 429 rate limits are worth backoff.
                if (
                    isinstance(e, urllib.error.HTTPError)
                    and 400 <= e.code < 500
                    and e.code != 429
                ):
                    raise RuntimeError(
                        f"LLM endpoint {url} rejected the request "
                        f"(HTTP {e.code}, non-retryable)"
                    ) from e
                last_err = e
                if attempt == self.transport_retries - 1:
                    break  # no pointless sleep after the final attempt
                wait = self.backoff_s * (2**attempt)
                logger.info(
                    f"LLM endpoint error ({e!r}), retry "
                    f"{attempt + 1}/{self.transport_retries} in {wait:.1f}s"
                )
                time.sleep(wait)
        raise RuntimeError(
            f"LLM endpoint {url} failed after {self.transport_retries} retries"
        ) from last_err
