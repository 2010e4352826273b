"""MIMIC-CXR stage 3: finding-sentence ("key phrase") extraction (copy of
radzero_tpu/preprocess/keyphrases.py).

Rebuild of preprocess/mimic_cxr/prompt_alignment.py: the reference runs
Llama-3.3-70B on vLLM with a system prompt that rewrites each report
into standalone sentences of the form "There is/may be/is no [finding]
of [location]" (KEY_PHRASES template, :20-55), with JSON-parse retries
and resumable per-batch output files (:58-194).

Here the extractor is a pluggable protocol:

- :class:`LLMKeyPhraseExtractor` — drives any OpenAI-compatible
  completion callable (vLLM server, local pipeline, ...); retains the
  reference's robustness behavior: JSON parse retry up to
  ``max_retries``, failed-record quarantine, resumable batch files.
- :class:`RuleBasedKeyPhraseExtractor` — dependency-free offline
  default: sentence-splits findings+impression, normalises each
  sentence into declarative "There is ..." phrasing where possible.

The prompt template text itself is configurable (``system_prompt``); a
functional default is provided without reproducing the reference's
exact wording.
"""

from __future__ import annotations

import json
import os
import re
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Protocol

from radzero_torch.utils.json_io import load_json, save_json
from radzero_torch.utils.logging import logger

DEFAULT_SYSTEM_PROMPT = (
    "You are a radiology report parser. Rewrite the report into a JSON list "
    "of short standalone finding sentences. Each sentence must state exactly "
    'one finding with its location, phrased as "There is [finding] of/in '
    '[location]", "There may be [finding] ..." for uncertain findings, or '
    '"There is no [finding]" for explicit negations. Output ONLY the JSON '
    "list of strings."
)


class KeyPhraseExtractor(Protocol):
    def __call__(self, findings: str, impression: str) -> List[str]: ...


_SENT_SPLIT = re.compile(r"(?<=[.!?])\s+")
_NEG_PAT = re.compile(r"\b(no|without|free of|negative for)\b", re.I)


@dataclass
class RuleBasedKeyPhraseExtractor:
    """Offline fallback: sentence split + light normalisation."""

    min_words: int = 3
    max_words: int = 40

    def __call__(self, findings: str, impression: str) -> List[str]:
        text = " ".join(t for t in (findings, impression) if t)
        text = re.sub(r"\s+", " ", text).strip()
        out: List[str] = []
        for sent in _SENT_SPLIT.split(text):
            sent = sent.strip().rstrip(".")
            words = sent.split()
            if not (self.min_words <= len(words) <= self.max_words):
                continue
            lower = sent.lower()
            if not lower.startswith(("there is", "there are", "there may")):
                if _NEG_PAT.search(lower):
                    sent = f"There is no {_strip_leading_negation(sent)}"
                else:
                    sent = f"There is {sent[0].lower()}{sent[1:]}"
            if sent not in out:
                out.append(sent)
        return out


def _strip_leading_negation(sent: str) -> str:
    return re.sub(r"^(there\s+is\s+)?(no|without)\s+", "", sent, flags=re.I).strip()


@dataclass
class LLMKeyPhraseExtractor:
    """LLM-backed extractor with the reference's retry/quarantine semantics
    (prompt_alignment.py:58-116).

    ``complete(system_prompt, user_text) -> str`` is any chat-completion
    callable (vLLM OpenAI server, transformers pipeline, ...).
    """

    complete: Callable[[str, str], str]
    system_prompt: str = DEFAULT_SYSTEM_PROMPT
    max_retries: int = 5
    failed: List[dict] = field(default_factory=list)

    def __call__(self, findings: str, impression: str) -> List[str]:
        user = f"FINDINGS: {findings}\nIMPRESSION: {impression}"
        for attempt in range(self.max_retries):
            raw = self.complete(self.system_prompt, user)
            phrases = _parse_json_list(raw)
            if phrases is not None:
                return phrases
            logger.info(f"JSON parse retry {attempt + 1}/{self.max_retries}")
        self.failed.append({"findings": findings, "impression": impression})
        return []


def _parse_json_list(raw: str) -> Optional[List[str]]:
    """Extract a JSON list of strings from an LLM response."""
    m = re.search(r"\[.*\]", raw, re.S)
    if not m:
        return None
    try:
        data = json.loads(m.group(0))
    except json.JSONDecodeError:
        return None
    if isinstance(data, list) and all(isinstance(x, str) for x in data):
        return [x.strip() for x in data if x.strip()]
    return None


def extract_key_phrases(
    records: List[dict],
    extractor: KeyPhraseExtractor,
    output_dir: str,
    batch_size: int = 1000,
    concurrency: int = 1,
) -> List[dict]:
    """Run extraction with resumable per-batch files
    (prompt_alignment.py:160-194): batch_{i}.json is skipped when it
    already exists, so interrupted runs continue where they stopped.

    ``concurrency > 1`` runs records of a batch through a thread pool —
    the throughput mode for HTTP extractors (an OpenAI-compatible vLLM
    server pipelines concurrent requests the way the reference's
    in-process 32k-record vLLM batches do); order is preserved.
    """
    os.makedirs(output_dir, exist_ok=True)
    out: List[dict] = []
    n_batches = (len(records) + batch_size - 1) // batch_size
    for b in range(n_batches):
        batch_path = os.path.join(output_dir, f"batch_{b}.json")
        if os.path.exists(batch_path):
            out.extend(load_json(batch_path))
            continue
        chunk = records[b * batch_size : (b + 1) * batch_size]

        def run(rec: dict) -> dict:
            phrases = extractor(rec.get("findings", ""), rec.get("impression", ""))
            return {**rec, "key_phrases": phrases}

        if concurrency > 1:
            import concurrent.futures as cf

            with cf.ThreadPoolExecutor(concurrency) as pool:
                done = list(pool.map(run, chunk))
        else:
            done = [run(rec) for rec in chunk]
        save_json(done, batch_path)
        out.extend(done)
        logger.info(f"key-phrase batch {b + 1}/{n_batches} done")

    if getattr(extractor, "failed", None):
        save_json(extractor.failed, os.path.join(output_dir, "failed.json"))
    return out
