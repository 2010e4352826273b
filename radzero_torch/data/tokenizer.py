"""Tokenizers (port of radzero_tpu/data/tokenizer.py; the port imports
nothing of that package).

The reference tokenizes with HF ``MPNetTokenizerFast`` (dataset.py:147-
154). Each tokenizer gives static-shape (N, max_length) int32 blocks of
ids and attention mask:

- :class:`WordPieceTokenizer` — vocab-file-driven BERT-style basic +
  WordPiece tokenization (MPNet or BERT special-token layout),
  token-for-token compatible with HF's slow/fast tokenizers given the
  same ``vocab.txt``. The serving/eval default: the card's host needs no
  ``transformers``.
- :class:`HFTokenizer` — wraps any HF tokenizer loaded from a local
  path/name (padding='max_length', truncation=True); imports
  ``transformers`` only when built.
- :class:`WhitespaceHashTokenizer` — dependency-free deterministic
  fallback for tests/benches with MPNet-style special ids
  (bos=0, pad=1, eos=2).

:func:`load_tokenizer` picks one, in the JAX package's order.
"""

from __future__ import annotations

import os
import unicodedata
from typing import Dict, List, Tuple, Union

import numpy as np


# ---------------------------------------------------------------------------
# First-party WordPiece (reference: exp/cxr_pt/dataset.py:147-154 tokenizes
# with MPNetTokenizerFast; semantics below replicate HF's BasicTokenizer +
# WordpieceTokenizer exactly so ids match token-for-token on a shared vocab)
# ---------------------------------------------------------------------------

def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    # ASCII ranges treated as punctuation even when their unicode category
    # is a symbol (e.g. '$', '^', '`') — BERT convention.
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        (0x4E00 <= cp <= 0x9FFF)
        or (0x3400 <= cp <= 0x4DBF)
        or (0x20000 <= cp <= 0x2A6DF)
        or (0x2A700 <= cp <= 0x2B73F)
        or (0x2B740 <= cp <= 0x2B81F)
        or (0x2B820 <= cp <= 0x2CEAF)
        or (0xF900 <= cp <= 0xFAFF)
        or (0x2F800 <= cp <= 0x2FA1F)
    )


def load_vocab_file(path: str) -> Dict[str, int]:
    """vocab.txt (one token per line, id = line number) -> dict."""
    vocab: Dict[str, int] = {}
    with open(path, encoding="utf-8") as f:
        for i, line in enumerate(f):
            vocab[line.rstrip("\n")] = i
    return vocab


_STYLES = {
    # (cls, sep, pad, unk)
    "mpnet": ("<s>", "</s>", "<pad>", "[UNK]"),
    "bert": ("[CLS]", "[SEP]", "[PAD]", "[UNK]"),
}


class WordPieceTokenizer:
    """Vocab-file-driven lowercase + punctuation-split + WordPiece.

    Replicates HF BasicTokenizer/WordpieceTokenizer semantics (clean
    text, CJK spacing, NFC normalise, lowercase + NFD accent strip,
    punctuation split, greedy longest-match-first WordPiece with '##'
    continuations, 100-char word cap -> unk) and the single-sequence
    ``<cls> X <sep>`` build with max_length truncation/padding. With
    all-mpnet-base-v2's vocab.txt this produces MPNetTokenizerFast's ids
    token-for-token (style='mpnet': bos 0 / pad 1 / eos 2 on the real
    vocab); style='bert' covers the BioClinical-BERT text path.

    Special tokens appearing verbatim inside input text are not
    protected from splitting (HF's AddedToken machinery); clinical
    finding sentences never contain them.
    """

    def __init__(
        self,
        vocab: Union[str, Dict[str, int]],
        style: str = "mpnet",
        max_length: int = 64,
        do_lower_case: bool = True,
        strip_accents: Union[bool, None] = None,
        tokenize_chinese_chars: bool = True,
        max_input_chars_per_word: int = 100,
    ):
        if isinstance(vocab, str):
            if os.path.isdir(vocab):
                vocab = os.path.join(vocab, "vocab.txt")
            vocab = load_vocab_file(vocab)
        self.vocab = vocab
        if style not in _STYLES:
            raise ValueError(f"style must be one of {sorted(_STYLES)}, got {style!r}")
        self.style = style
        cls_t, sep_t, pad_t, unk_t = _STYLES[style]
        missing = [t for t in (cls_t, sep_t, pad_t, unk_t) if t not in vocab]
        if missing:
            raise ValueError(f"vocab lacks special tokens {missing} for style {style!r}")
        self.cls_id = vocab[cls_t]
        self.sep_id = vocab[sep_t]
        self.pad_id = vocab[pad_t]
        self.unk_token = unk_t
        self.unk_id = vocab[unk_t]
        self.max_length = max_length
        self.do_lower_case = do_lower_case
        self.strip_accents = strip_accents
        self.tokenize_chinese_chars = tokenize_chinese_chars
        self.max_input_chars_per_word = max_input_chars_per_word

    # -- basic tokenization -------------------------------------------------
    @staticmethod
    def _clean_text(text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if _is_whitespace(ch) else ch)
        return "".join(out)

    @staticmethod
    def _space_cjk(text: str) -> str:
        out = []
        for ch in text:
            if _is_cjk(ord(ch)):
                out.append(" ")
                out.append(ch)
                out.append(" ")
            else:
                out.append(ch)
        return "".join(out)

    @staticmethod
    def _strip_accents_fn(text: str) -> str:
        text = unicodedata.normalize("NFD", text)
        return "".join(ch for ch in text if unicodedata.category(ch) != "Mn")

    @staticmethod
    def _split_on_punc(token: str) -> List[str]:
        out: List[List[str]] = []
        start_new = True
        for ch in token:
            if _is_punctuation(ch):
                out.append([ch])
                start_new = True
            else:
                if start_new:
                    out.append([])
                start_new = False
                out[-1].append(ch)
        return ["".join(x) for x in out]

    def _basic_tokenize(self, text: str) -> List[str]:
        text = self._clean_text(text)
        if self.tokenize_chinese_chars:
            text = self._space_cjk(text)
        text = unicodedata.normalize("NFC", text)
        split: List[str] = []
        for token in text.split():
            if self.do_lower_case:
                token = token.lower()
                if self.strip_accents is not False:
                    token = self._strip_accents_fn(token)
            elif self.strip_accents:
                token = self._strip_accents_fn(token)
            split.extend(self._split_on_punc(token))
        return " ".join(split).split()

    # -- wordpiece ----------------------------------------------------------
    def _wordpiece(self, word: str) -> List[str]:
        if len(word) > self.max_input_chars_per_word:
            return [self.unk_token]
        sub: List[str] = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                piece = word[start:end]
                if start > 0:
                    piece = "##" + piece
                if piece in self.vocab:
                    cur = piece
                    break
                end -= 1
            if cur is None:
                return [self.unk_token]
            sub.append(cur)
            start = end
        return sub

    def tokenize(self, text: str) -> List[str]:
        pieces: List[str] = []
        for word in self._basic_tokenize(text):
            pieces.extend(self._wordpiece(word))
        return pieces

    def encode(self, text: str, max_length: Union[int, None] = None) -> List[int]:
        """<cls> pieces[:L-2] <sep> — no padding."""
        L = max_length or self.max_length
        ids = [self.vocab[p] for p in self.tokenize(text)][: L - 2]
        return [self.cls_id] + ids + [self.sep_id]

    def __call__(
        self, texts: List[str], max_length: Union[int, None] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        L = max_length or self.max_length
        ids = np.full((len(texts), L), self.pad_id, np.int32)
        mask = np.zeros((len(texts), L), np.int32)
        for i, t in enumerate(texts):
            row = self.encode(t, L)
            ids[i, : len(row)] = row
            mask[i, : len(row)] = 1
        return ids, mask

    # -- persistence --------------------------------------------------------
    def save_vocab(self, path: str) -> None:
        """Write vocab.txt (id order) next to a converted checkpoint."""
        _write_vocab_by_id(self.vocab, path)


def _write_vocab_by_id(vocab: Dict[str, int], out_path: str) -> str:
    """Write vocab.txt such that ``load_vocab_file`` (id = line number)
    reproduces the EXACT token->id mapping. Vocabularies with
    non-contiguous ids (added special tokens, pruned slots) get unique
    placeholder lines at the gap ids — naively writing tokens in sorted
    order would silently shift every id after the first gap, making the
    text tower index wrong embedding rows with no error anywhere."""
    by_id: Dict[int, str] = {}
    for tok, i in vocab.items():
        if i in by_id:
            raise ValueError(
                f"duplicate id {i} for tokens {by_id[i]!r} and {tok!r}"
            )
        by_id[i] = tok
    n = max(by_id) + 1 if by_id else 0
    with open(out_path, "w", encoding="utf-8") as f:
        for i in range(n):
            tok = by_id.get(i)
            if tok is None:
                tok = f"[unused_gap_{i}]"
                if tok in vocab:  # pathological collision: keep ids exact
                    raise ValueError(f"cannot fill vocab id gap {i}: {tok!r} exists")
            f.write(tok + "\n")
    return out_path


def dump_hf_vocab(hf_tokenizer, out_path: str) -> str:
    """Extract a vocab.txt from a loaded HF tokenizer (checkpoint
    conversion helper): after this, runtime needs only WordPieceTokenizer."""
    return _write_vocab_by_id(hf_tokenizer.get_vocab(), out_path)


class HFTokenizer:
    def __init__(self, name_or_path: str, max_length: int = 64):
        from transformers import AutoTokenizer

        try:
            # local-first: instant on a cached/downloaded snapshot, instant
            # failure in zero-egress environments (the online path retries
            # against the hub with ~30 s of backoff before giving up)
            self.tok = AutoTokenizer.from_pretrained(name_or_path, local_files_only=True)
        except Exception:
            self.tok = AutoTokenizer.from_pretrained(name_or_path)
        self.max_length = max_length

    def __call__(self, texts: List[str], max_length: int | None = None) -> Tuple[np.ndarray, np.ndarray]:
        enc = self.tok(
            texts,
            padding="max_length",
            truncation=True,
            max_length=max_length or self.max_length,
            return_tensors="np",
        )
        return enc["input_ids"].astype(np.int32), enc["attention_mask"].astype(np.int32)


class WhitespaceHashTokenizer:
    """<s> tok* </s> padded with pad=1; each word is FNV-1a hashed into
    the vocabulary above the three special ids."""

    bos, pad, eos = 0, 1, 2

    def __init__(self, vocab_size: int = 30527, max_length: int = 64):
        self.vocab_size = vocab_size
        self.max_length = max_length

    def _tok(self, word: str) -> int:
        h = 2166136261
        for ch in word.encode():
            h = ((h ^ ch) * 16777619) & 0xFFFFFFFF
        return 3 + (h % (self.vocab_size - 3))

    def __call__(self, texts: List[str], max_length: int | None = None) -> Tuple[np.ndarray, np.ndarray]:
        L = max_length or self.max_length
        ids = np.full((len(texts), L), self.pad, np.int32)
        mask = np.zeros((len(texts), L), np.int32)
        for i, t in enumerate(texts):
            toks = [self.bos] + [self._tok(w) for w in t.lower().split()][: L - 2] + [self.eos]
            ids[i, : len(toks)] = toks
            mask[i, : len(toks)] = 1
        return ids, mask


def load_tokenizer(name_or_path: str | None, max_length: int = 64, style: str = "mpnet"):
    """Resolution order:

    1. a ``vocab.txt`` file, or a directory containing one (converted
       checkpoints dump it) -> first-party :class:`WordPieceTokenizer`
       — no ``transformers`` dependency at runtime;
    2. an HF name/path -> :class:`HFTokenizer`;
    3. hash fallback (zero-egress envs, tests).
    """
    from radzero_torch.utils.logging import logger

    if name_or_path:
        vocab_path = None
        if os.path.isfile(name_or_path) and name_or_path.endswith(".txt"):
            vocab_path = name_or_path
        elif os.path.isdir(name_or_path) and os.path.isfile(
            os.path.join(name_or_path, "vocab.txt")
        ):
            vocab_path = os.path.join(name_or_path, "vocab.txt")
        if vocab_path is not None:
            try:
                return WordPieceTokenizer(vocab_path, style=style, max_length=max_length)
            except Exception as e:
                logger.warning(
                    f"vocab file {vocab_path!r} unusable ({e}); trying HF tokenizer"
                )
        try:
            return HFTokenizer(name_or_path, max_length)
        except Exception as e:
            logger.warning(
                f"could not load tokenizer {name_or_path!r} ({e}); "
                "falling back to WhitespaceHashTokenizer (tokens will NOT match "
                "a pretrained text tower's vocabulary)"
            )
    return WhitespaceHashTokenizer(max_length=max_length)
