"""The port's WordPiece tokenizer (radzero_torch.data.tokenizer) against the
JAX package's, on the CPU.

Both read the synthetic vocabulary of tests/test_wordpiece_tokenizer.py
(the real all-mpnet-base-v2 vocab.txt is not in the repository) and must
give the same ids and masks on that file's battery of sentences and on the
runbook's probe corpus, in the ``mpnet`` and ``bert`` styles and at lengths
that truncate. ``load_tokenizer`` must resolve in the JAX order; HF
tokenizers are stood in for, so nothing reaches for the hub.
"""

import os
import sys

import numpy as np
import pytest

from radzero_tpu.data import tokenizer as jtok
from radzero_torch.data import tokenizer as ttok
from radzero_torch.tools.run_real_checkpoint import VOCAB_PROBE_SENTENCES

from test_wordpiece_tokenizer import _PIECES, SENTENCES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def vocab_file(tmp_path_factory):
    p = tmp_path_factory.mktemp("vocab") / "vocab.txt"
    p.write_text("\n".join(_PIECES) + "\n", encoding="utf-8")
    return str(p)


def test_probe_corpus_is_the_jax_runbooks():
    sys.path.insert(0, REPO)
    from tools.run_real_checkpoint import VOCAB_PROBE_SENTENCES as jax_probe

    assert VOCAB_PROBE_SENTENCES == jax_probe


@pytest.mark.parametrize("style", ["mpnet", "bert"])
@pytest.mark.parametrize("max_length", [24, 8, 64])
def test_ids_and_masks_match_jax(vocab_file, style, max_length):
    ours = ttok.WordPieceTokenizer(vocab_file, style=style, max_length=max_length)
    theirs = jtok.WordPieceTokenizer(vocab_file, style=style, max_length=max_length)
    texts = SENTENCES + VOCAB_PROBE_SENTENCES
    ids, mask = ours(texts)
    jids, jmask = theirs(texts)
    assert ids.dtype == mask.dtype == np.int32 and ids.shape == (len(texts), max_length)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(mask, jmask)
    assert (ours.cls_id, ours.sep_id, ours.pad_id, ours.unk_id) == \
        (theirs.cls_id, theirs.sep_id, theirs.pad_id, theirs.unk_id)
    for t in texts:
        assert ours.tokenize(t) == theirs.tokenize(t)


def test_mpnet_specials_on_the_mpnet_layout(vocab_file):
    """MPNet's bos 0, pad 1, eos 2 (the real vocabulary's layout, which this
    vocabulary's first lines copy)."""
    tok = ttok.WordPieceTokenizer(vocab_file)
    assert (tok.cls_id, tok.pad_id, tok.sep_id) == (0, 1, 2)
    ids, mask = tok(["There is no pneumothorax.", ""], max_length=10)
    assert ids[0].tolist() == [0, 8, 9, 10, 19, 20, 53, 2, 1, 1]
    assert ids[1].tolist()[:3] == [0, 2, 1] and mask.sum(1).tolist() == [8, 2]


def test_hf_tokenizer_matches_wordpiece(vocab_file, tmp_path):
    """HFTokenizer (transformers imported only when built) over a saved MPNet
    tokenizer gives WordPieceTokenizer's ids; dump_hf_vocab writes back a
    vocab.txt byte-equal to the JAX package's dump."""
    transformers = pytest.importorskip("transformers")
    hf = transformers.MPNetTokenizer(vocab_file=vocab_file, do_lower_case=True)
    hf.save_pretrained(str(tmp_path / "hf"))
    ours = ttok.HFTokenizer(str(tmp_path / "hf"), max_length=24)
    ids, mask = ours(SENTENCES)
    wids, wmask = ttok.WordPieceTokenizer(vocab_file, max_length=24)(SENTENCES)
    np.testing.assert_array_equal(ids, wids)
    np.testing.assert_array_equal(mask, wmask)
    a, b = str(tmp_path / "a.txt"), str(tmp_path / "b.txt")
    ttok.dump_hf_vocab(hf, a)
    jtok.dump_hf_vocab(hf, b)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


def test_vocab_with_gaps_writes_like_jax(tmp_path):
    vocab = {"<s>": 0, "<pad>": 1, "</s>": 2, "[UNK]": 5, "lung": 9}
    a, b = str(tmp_path / "a.txt"), str(tmp_path / "b.txt")
    ttok._write_vocab_by_id(vocab, a)
    jtok._write_vocab_by_id(vocab, b)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    assert ttok.load_vocab_file(a) == {**vocab, **{f"[unused_gap_{i}]": i for i in (3, 4, 6, 7, 8)}}
    with pytest.raises(ValueError, match="duplicate id"):
        ttok._write_vocab_by_id({"a": 0, "b": 0}, a)


def test_missing_specials_raise(tmp_path):
    p = tmp_path / "vocab.txt"
    p.write_text("<s>\n<pad>\n</s>\nlung\n", encoding="utf-8")  # no [UNK]
    for style in ("mpnet", "bert"):
        with pytest.raises(ValueError, match="special tokens"):
            ttok.WordPieceTokenizer(str(p), style=style)
    with pytest.raises(ValueError, match="style must be"):
        ttok.WordPieceTokenizer(str(p), style="roberta")


class _FakeHF:
    """Stands in for HFTokenizer: loads only the name "hf-ok"."""

    def __init__(self, name_or_path, max_length=64):
        if name_or_path != "hf-ok":
            raise OSError(f"no tokenizer at {name_or_path}")
        self.max_length = max_length


@pytest.mark.parametrize("case", ["file", "dir", "no_specials", "hf", "missing", "none"])
def test_load_tokenizer_resolves_like_jax(case, vocab_file, tmp_path, monkeypatch):
    """vocab.txt (a file or a directory's) -> WordPiece; one that lacks the
    specials warns and falls through to HF; an HF name -> HFTokenizer; else
    the hash tokenizer."""
    bad = tmp_path / "bad"
    bad.mkdir()
    (bad / "vocab.txt").write_text("hello\nworld\n", encoding="utf-8")
    arg = {"file": vocab_file, "dir": os.path.dirname(vocab_file), "no_specials": str(bad),
           "hf": "hf-ok", "missing": str(tmp_path / "nowhere"), "none": None}[case]
    kinds = []
    for mod in (ttok, jtok):
        monkeypatch.setattr(mod, "HFTokenizer", _FakeHF)
        tok = mod.load_tokenizer(arg, max_length=12)
        kinds.append(type(tok).__name__)
        assert tok.max_length == 12
    assert kinds[0] == kinds[1] == {
        "file": "WordPieceTokenizer", "dir": "WordPieceTokenizer",
        "no_specials": "WhitespaceHashTokenizer", "hf": "_FakeHF",
        "missing": "WhitespaceHashTokenizer", "none": "WhitespaceHashTokenizer"}[case]
