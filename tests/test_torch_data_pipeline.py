"""The port's training data path against the JAX package, on the CPU.

The cases of tests/test_data_pipeline.py, tests/test_multihost_data.py,
the packing and loader cases of tests/test_dedup.py and
test_review_fixes_r3.py::test_stable_sharding_pins_process_shards, run
against radzero_torch.data.{mimic, shards, pipeline}; then a parity test:
for the same records, image loader, tokenizer settings and seed, the
port's TrainLoader yields the keys and arrays of
radzero_tpu.data.pipeline.TrainLoader bit for bit, epoch after epoch,
in every setting the loader has (length buckets, dedup with the
"fallback" and "drop" policies, echo, record indices, two processes with
and without stable sharding). Exact equality: the loaders are the same
host numpy.
"""

import json
import os

import numpy as np
import pytest
import torch

from radzero_torch.data import pipeline as tpipe
from radzero_torch.data.mimic import from_list_with_missing, input_json_file_load, load_datasets
from radzero_torch.data.pipeline import (
    PackSpec,
    TrainLoader,
    device_prefetch,
    pack_batch,
    pil_image_loader,
    to_device,
)
from radzero_torch.data.shards import load_record_shards, write_record_shards
from radzero_torch.data.tokenizer import WhitespaceHashTokenizer


# ---------------------------------------------------------------------------
# tests/test_data_pipeline.py
# ---------------------------------------------------------------------------

def _write_mimic(tmp_path, n=10):
    (tmp_path / "MIMIC-CXR").mkdir(parents=True, exist_ok=True)
    (tmp_path / "MS-CXR").mkdir(exist_ok=True)
    rows = []
    for i in range(n):
        rows.append(
            {
                "dicom_id": f"img_{i}.jpg",
                "view_position": "PA" if i % 2 == 0 else "LATERAL",
                "key_phrases": [f"There is finding {j} of img {i}" for j in range(1 + i % 4)],
            }
        )
    # one record without key phrases -> dropped
    rows.append({"dicom_id": "empty.jpg", "view_position": "PA", "key_phrases": []})
    with open(tmp_path / "MIMIC-CXR" / "train.json", "w") as f:
        json.dump(rows, f)
    # MS-CXR leak: img_0 is in the grounding test set
    with open(tmp_path / "MS-CXR" / "test.json", "w") as f:
        json.dump([{"image": "somewhere/img_0.jpg"}], f)
    return tmp_path


def test_input_json_load_filters(tmp_path):
    root = _write_mimic(tmp_path)
    recs = input_json_file_load(
        "MIMIC-CXR/train.json", str(root), True,
        rm_mscxr=True, MS_CXR_test="MS-CXR/test.json",
    )
    names = {os.path.basename(r["image"]) for r in recs}
    assert "img_0.jpg" not in names      # de-leaked
    assert "empty.jpg" not in names      # no key phrases
    assert "img_1.jpg" in names          # lateral kept (filter off)

    recs_f = input_json_file_load(
        "MIMIC-CXR/train.json", str(root), True, use_frontal_view_only=True,
    )
    assert {os.path.basename(r["image"]) for r in recs_f} == {
        f"img_{i}.jpg" for i in range(10) if i % 2 == 0
    }


def test_load_datasets_splits_match_jax(tmp_path):
    from radzero_tpu.data.mimic import load_datasets as jax_load_datasets

    root = _write_mimic(tmp_path)
    cfg = {
        "data_root": str(root),
        "train": ["T"], "eval": ["T"],
        "T": "MIMIC-CXR/train.json",
        "rm_mscxr": True, "MS_CXR_test": "MS-CXR/test.json",
        "use_frontal_view_only": True,
    }
    ds = load_datasets(cfg)
    assert len(ds["train"]) == 4 and len(ds["eval"]) == 5  # de-leak on train only
    assert all(set(r.keys()) == set(ds["train"][0].keys()) for r in ds["train"])
    assert ds == jax_load_datasets(cfg)


def test_from_list_with_missing_unions_keys():
    out = from_list_with_missing([{"a": 1}, {"b": 2}])
    assert out == [{"a": 1, "b": None}, {"a": None, "b": 2}]


def test_pack_batch_layout():
    tok = WhitespaceHashTokenizer(max_length=12)
    recs = [
        {"key_phrases": ["a b", "c d", "e"]},
        {"key_phrases": ["x"]},
    ]
    imgs = np.zeros((2, 28, 28, 3), np.float32)
    spec = PackSpec(max_sentences_per_image=4, max_text_tokens=12, with_random_positive=True)
    b = pack_batch(recs, imgs, tok, spec, np.random.default_rng(0), global_offset=16)

    assert b["input_ids"].shape == (8, 12)
    assert b["row_mask"].sum() == 4  # 3 + 1 real sentences
    assert list(b["group_map"][:4]) == [16, 16, 16, 17]
    assert b["random_input_ids"].shape == (2, 12)
    # padded rows are empty text
    assert b["attention_mask"][4:].sum() == 2 * 4  # only bos/eos per padded row


def test_pack_batch_subsamples_excess_sentences():
    tok = WhitespaceHashTokenizer(max_length=8)
    recs = [{"key_phrases": [f"s{j}" for j in range(10)]}]
    b = pack_batch(recs, np.zeros((1, 4, 4, 3), np.float32), tok, PackSpec(3, 8))
    assert b["row_mask"].sum() == 3


def test_train_loader_epochs_and_shapes():
    tok = WhitespaceHashTokenizer(max_length=8)
    recs = [{"key_phrases": [f"finding {i}"], "image": None} for i in range(10)]

    def loader(rec):
        return np.zeros((8, 8, 3), np.float32)

    dl = TrainLoader(recs, loader, tok, batch_size=4, spec=PackSpec(2, 8), seed=1)
    batches = list(dl)
    assert len(batches) == 2  # drop_last
    assert batches[0]["pixel_values"].shape == (4, 8, 8, 3)
    assert batches[0]["input_ids"].shape == (8, 8)
    assert len(list(dl)) == 2


def test_text_length_buckets_trim_batch():
    tok = WhitespaceHashTokenizer(vocab_size=1009, max_length=64)
    records = [
        {"key_phrases": ["short one", "a slightly longer finding sentence here"]},
        {"key_phrases": ["another short"]},
    ]
    imgs = np.zeros((2, 8, 8, 3), np.float32)
    spec = PackSpec(max_sentences_per_image=2, max_text_tokens=64,
                    text_length_buckets=(16, 32))
    b = pack_batch(records, imgs, tok, spec)
    assert b["input_ids"].shape[1] == 16
    assert b["attention_mask"].shape[1] == 16
    full = pack_batch(records, imgs, tok,
                      PackSpec(max_sentences_per_image=2, max_text_tokens=64))
    np.testing.assert_array_equal(b["input_ids"], full["input_ids"][:, :16])
    assert full["attention_mask"][:, 16:].sum() == 0


def test_data_echoing_repeats_batches():
    records = [{"id": i, "key_phrases": [f"f {i}"]} for i in range(8)]
    tok = WhitespaceHashTokenizer(vocab_size=1009, max_length=8)

    def load(rec):
        return np.full((8, 8, 3), rec["id"], np.float32)

    loader = TrainLoader(records, load, tok, 4,
                         PackSpec(max_sentences_per_image=1, max_text_tokens=8),
                         num_threads=2, echo=3)
    assert len(loader) == 6  # 2 unique batches x 3 echoes
    batches = list(loader)
    assert len(batches) == 6
    for k in range(0, 6, 3):
        ids0 = batches[k]["pixel_values"][:, 0, 0, 0]
        for j in (1, 2):
            np.testing.assert_array_equal(batches[k + j]["pixel_values"][:, 0, 0, 0], ids0)


def test_multihost_disables_buckets_and_requires_drop_last():
    tok = WhitespaceHashTokenizer(vocab_size=101, max_length=64)
    recs = [
        {"image": None, "key_phrases": ["short", "a much longer finding sentence here"]}
        for _ in range(16)
    ]
    spec = PackSpec(max_sentences_per_image=2, max_text_tokens=64,
                    text_length_buckets=(16, 32))
    loader = TrainLoader(
        recs, lambda r: np.zeros((8, 8, 3), np.float32), tok, 4, spec,
        process_index=0, process_count=2,
    )
    assert loader.spec.text_length_buckets == ()  # forced off
    assert all(b["input_ids"].shape[1] == 64 for b in loader)
    solo = TrainLoader(recs, lambda r: np.zeros((8, 8, 3), np.float32), tok, 4, spec)
    assert solo.spec.text_length_buckets == (16, 32)
    with pytest.raises(ValueError, match="drop_last"):
        TrainLoader(
            recs, lambda r: np.zeros((8, 8, 3), np.float32), tok, 4,
            PackSpec(max_sentences_per_image=2, max_text_tokens=64),
            process_index=0, process_count=2, drop_last=False,
        )


def test_pil_image_loader_matches_jax(tmp_path):
    """The PIL loader (PIL imported inside it) decodes and processes a PNG
    as the JAX package's does, bit for bit."""
    from PIL import Image

    from radzero_torch.data.processing import BlipStyleImageProcessor
    from radzero_tpu.data.pipeline import pil_image_loader as jax_pil_image_loader
    from radzero_tpu.data.processing import BlipStyleImageProcessor as JaxBlip

    rng = np.random.default_rng(3)
    path = str(tmp_path / "study.png")
    Image.fromarray(rng.integers(0, 256, (60, 50), dtype=np.uint8), mode="L").save(path)
    got = pil_image_loader(BlipStyleImageProcessor(size=28))({"image": path})
    ref = jax_pil_image_loader(JaxBlip(size=28))({"image": path})
    assert got.shape == (28, 28, 3) and got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


def test_to_device_and_prefetch_on_the_cpu():
    """On the CPU: integer arrays become int64, floats keep their dtype and
    bits, record_indices stays on the host, nothing aliases the loader's
    arrays, and device_prefetch yields the batches in order."""
    rng = np.random.default_rng(0)
    batches = [{"pixel_values": rng.standard_normal((2, 4, 4, 3)).astype(np.float32),
                "input_ids": rng.integers(0, 9, (4, 5)).astype(np.int32),
                "row_mask": np.ones(4, np.float32),
                "record_indices": np.arange(2, dtype=np.int64)} for _ in range(3)]
    out = to_device(batches[0], "cpu")
    assert sorted(out) == ["input_ids", "pixel_values", "row_mask"]
    assert out["input_ids"].dtype == torch.int64
    np.testing.assert_array_equal(out["input_ids"].numpy(), batches[0]["input_ids"])
    assert out["pixel_values"].dtype == torch.float32
    np.testing.assert_array_equal(out["pixel_values"].numpy(), batches[0]["pixel_values"])
    out["pixel_values"].zero_()
    assert batches[0]["pixel_values"].any()  # a copy, not a view
    got = list(device_prefetch(iter(batches), "cpu", size=2))
    assert len(got) == 3
    for b, g in zip(batches, got):
        np.testing.assert_array_equal(g["pixel_values"].numpy(), b["pixel_values"])


# ---------------------------------------------------------------------------
# tests/test_multihost_data.py
# ---------------------------------------------------------------------------

def _mh_records(n):
    return [
        {"id": i, "key_phrases": [f"finding {i} a", f"finding {i} b"]}
        for i in range(n)
    ]


def _mh_loader(records, pi, pc, batch_size=4):
    tok = WhitespaceHashTokenizer(vocab_size=1009, max_length=8)

    def load_image(rec):
        return np.full((8, 8, 3), rec["id"], np.float32)

    return TrainLoader(
        records, load_image, tok, batch_size,
        PackSpec(max_sentences_per_image=2, max_text_tokens=8),
        seed=7, num_threads=2,
        process_index=pi, process_count=pc,
    )


def _ids(loader, per):
    return [int(b["pixel_values"][i, 0, 0, 0]) for b in loader for i in range(per)]


def test_processes_cover_disjoint_records_same_epoch_order():
    records = _mh_records(19)  # not a multiple of 4*2: tail dropped
    l0 = _mh_loader(records, 0, 2)
    l1 = _mh_loader(records, 1, 2)
    assert len(l0) == len(l1) == 2
    seen0, seen1 = _ids(l0, 4), _ids(l1, 4)
    assert not set(seen0) & set(seen1)
    assert len(set(seen0) | set(seen1)) == 16
    seen_all = _ids(_mh_loader(records, 0, 1, batch_size=8), 8)
    assert set(seen_all[:16]) == set(seen0) | set(seen1)


def test_group_map_offsets_match_reference_rank_offset():
    records = _mh_records(16)
    for pi in (0, 1):
        batch = next(iter(_mh_loader(records, pi, 2)))
        real = batch["row_mask"] > 0
        lo, hi = pi * 4, pi * 4 + 4
        assert batch["group_map"][real].min() >= lo
        assert batch["group_map"][real].max() < hi


def test_epoch_reshuffle_is_deterministic_and_differs():
    records = _mh_records(16)
    a = _mh_loader(records, 0, 2)
    e0, e1 = _ids(a, 4), _ids(a, 4)
    assert e0 != e1
    assert e0 == _ids(_mh_loader(records, 0, 2), 4)


def test_record_shards_roundtrip_matches_jax(tmp_path):
    from radzero_tpu.data.shards import load_record_shards as jax_load_record_shards

    records = _mh_records(11)
    write_record_shards(records, str(tmp_path), n_shards=3)
    all_back, index = load_record_shards(str(tmp_path))
    assert index["n_records"] == 11 and index["n_shards"] == 3
    assert sorted(r["id"] for r in all_back) == list(range(11))
    p0, _ = load_record_shards(str(tmp_path), 0, 2)
    p1, _ = load_record_shards(str(tmp_path), 1, 2)
    ids0, ids1 = {r["id"] for r in p0}, {r["id"] for r in p1}
    assert not ids0 & ids1
    assert ids0 | ids1 == set(range(11))
    assert (p0, index) == jax_load_record_shards(str(tmp_path), 0, 2)


# ---------------------------------------------------------------------------
# tests/test_dedup.py (packing and loader cases)
# ---------------------------------------------------------------------------

TOK = WhitespaceHashTokenizer(vocab_size=5003, max_length=10)

# 4 images x up to 4 sentences with heavy repeats: 6 unique among 13 real
RECORDS = [
    {"key_phrases": ["no pleural effusion", "clear lungs", "no pneumothorax"]},
    {"key_phrases": ["no pleural effusion", "clear lungs", "cardiomegaly mild"]},
    {"key_phrases": ["no pleural effusion", "left basilar opacity", "no pneumothorax",
                     "clear lungs"]},
    {"key_phrases": ["right effusion large", "no pleural effusion", "clear lungs"]},
]


def _images(n):
    return np.random.default_rng(0).standard_normal((n, 28, 28, 3)).astype(np.float32)


def _pack(spec, **kw):
    return pack_batch(RECORDS, _images(len(RECORDS)), TOK, spec,
                      rng=np.random.default_rng(1), **kw)


def test_pack_dedup_layout():
    plain = _pack(PackSpec(max_sentences_per_image=4, max_text_tokens=10))
    b = _pack(PackSpec(max_sentences_per_image=4, max_text_tokens=10, dedup_slots=8))
    assert b["input_ids"].shape == (8, 10)
    assert b["attention_mask"].shape == (8, 10)
    assert b["row_gather"].shape == (16,)
    np.testing.assert_array_equal(b["input_ids"][b["row_gather"]], plain["input_ids"])
    np.testing.assert_array_equal(b["attention_mask"][b["row_gather"]],
                                  plain["attention_mask"])
    np.testing.assert_array_equal(b["group_map"], plain["group_map"])
    np.testing.assert_array_equal(b["row_mask"], plain["row_mask"])
    assert len(np.unique(b["row_gather"])) == 7  # 6 unique real + 1 padding row


def test_pack_dedup_fallback_when_over_slots():
    b = _pack(PackSpec(max_sentences_per_image=4, max_text_tokens=10, dedup_slots=4))
    assert "row_gather" not in b
    assert b["input_ids"].shape == (16, 10)


def test_pack_dedup_respects_length_buckets():
    b = _pack(PackSpec(max_sentences_per_image=4, max_text_tokens=10,
                       text_length_buckets=(8,), dedup_slots=8))
    assert b["input_ids"].shape == (8, 8)
    assert b["attention_mask"].shape == (8, 8)


def test_pack_dedup_drop_policy_over_slots():
    plain = _pack(PackSpec(max_sentences_per_image=4, max_text_tokens=10))
    stats = {}
    b = _pack(PackSpec(max_sentences_per_image=4, max_text_tokens=10, dedup_slots=4),
              dedup_overflow="drop", stats=stats)
    assert b["input_ids"].shape == (4, 10)
    assert b["row_gather"].shape == (16,)
    kept = b["row_mask"] > 0
    np.testing.assert_array_equal(b["input_ids"][b["row_gather"][kept]],
                                  plain["input_ids"][kept])
    np.testing.assert_array_equal(b["group_map"][kept], plain["group_map"][kept])
    n_plain_real, n_kept = int(plain["row_mask"].sum()), int(b["row_mask"].sum())
    assert n_kept < n_plain_real
    assert stats["dedup_dropped"] == n_plain_real - n_kept
    assert np.all(b["group_map"][~kept] == 0)


def test_pack_dedup_drop_policy_exact_when_under_slots():
    spec = PackSpec(max_sentences_per_image=4, max_text_tokens=10, dedup_slots=8)
    stats = {}
    a = _pack(spec)
    b = _pack(spec, dedup_overflow="drop", stats=stats)
    assert stats.get("dedup_dropped", 0) == 0
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_pack_dedup_text_offset():
    spec = PackSpec(max_sentences_per_image=4, max_text_tokens=10, dedup_slots=8)
    b0 = _pack(spec)
    b1 = _pack(spec, text_offset=8)
    np.testing.assert_array_equal(b1["row_gather"], b0["row_gather"] + 8)
    np.testing.assert_array_equal(b1["input_ids"], b0["input_ids"])


def test_dedup_multihost_loader_layout():
    recs = [{"id": i, "key_phrases": [f"p {i % 3}", "q common"]} for i in range(8)]
    spec = PackSpec(max_sentences_per_image=2, max_text_tokens=10, dedup_slots=4)
    batches = {}
    for pi in range(2):
        loader = TrainLoader(recs, lambda rec: np.zeros((28, 28, 3), np.float32), TOK, 2,
                             spec, process_index=pi, process_count=2, num_threads=1)
        assert loader.dedup_overflow == "drop"
        batches[pi] = list(loader)
    for b0, b1 in zip(batches[0], batches[1]):
        assert b0["input_ids"].shape == b1["input_ids"].shape == (4, 10)
        assert b0["row_gather"].max() < 4
        assert 4 <= b1["row_gather"].min() and b1["row_gather"].max() < 8


def test_echoed_batches_are_independent_dicts():
    recs = [{"id": i, "key_phrases": ["a b"]} for i in range(4)]
    loader = TrainLoader(recs, lambda rec: np.zeros((28, 28, 3), np.float32), TOK, 2,
                         PackSpec(max_sentences_per_image=1, max_text_tokens=10),
                         echo=2, num_threads=1, with_indices=True)
    out = list(loader)
    assert len(out) == 4
    out[0].pop("record_indices")
    assert "record_indices" in out[1]


# ---------------------------------------------------------------------------
# test_review_fixes_r3.py::test_stable_sharding_pins_process_shards
# ---------------------------------------------------------------------------

def _indices_per_epoch(loader, epochs):
    return [[int(i) for b in loader for i in b["record_indices"]] for _ in range(epochs)]


def test_stable_sharding_pins_process_shards():
    records = [{"image": None, "key_phrases": [f"finding {i}"], "_i": i} for i in range(32)]
    spec = PackSpec(max_sentences_per_image=1, max_text_tokens=8)

    def loader_for(pi, stable):
        return TrainLoader(
            records, lambda rec: np.zeros((28, 28, 3), np.uint8),
            lambda texts, L: (np.ones((len(texts), L), np.int32),
                              np.ones((len(texts), L), np.int32)),
            batch_size=4, spec=spec, seed=7, num_threads=2,
            process_index=pi, process_count=2, with_indices=True, stable_sharding=stable,
        )

    p0 = _indices_per_epoch(loader_for(0, True), 2)
    p1 = _indices_per_epoch(loader_for(1, True), 2)
    assert set(p0[0]) == set(p0[1]) and set(p1[0]) == set(p1[1])
    assert p0[0] != p0[1]
    assert not (set(p0[0]) & set(p1[0]))
    assert len(p0[0]) == len(p1[0]) == 16
    unstable = _indices_per_epoch(loader_for(0, False), 2)
    assert set(unstable[0]) != set(unstable[1])


# ---------------------------------------------------------------------------
# Parity with radzero_tpu.data.pipeline.TrainLoader
# ---------------------------------------------------------------------------

POOL = ["no pleural effusion", "clear lungs", "no pneumothorax", "mild cardiomegaly",
        "left basilar opacity", "right effusion large", "stable mediastinal contours",
        "there is a small left apical pneumothorax seen on this radiograph today",
        "no focal consolidation", "degenerative changes of the thoracic spine",
        "the heart size is at the upper limits of normal and there is mild pulmonary "
        "vascular congestion without frank edema"]

SETTINGS = {
    "plain": dict(),
    "buckets": dict(spec=dict(text_length_buckets=(8, 14))),
    "dedup_fallback": dict(spec=dict(dedup_slots=8)),
    "dedup_drop": dict(spec=dict(dedup_slots=6), process_count=2),
    "echo3": dict(echo=3),
    "with_indices": dict(with_indices=True),
    "two_processes": dict(process_count=2),
    "two_processes_stable": dict(process_count=2, stable_sharding=True, with_indices=True),
    "eval_no_shuffle": dict(shuffle=False, drop_last=False),
}


def _parity_records(n=22):
    rng = np.random.default_rng(5)
    return [{"id": i, "key_phrases": [POOL[j] for j in rng.integers(0, len(POOL),
                                                                    rng.integers(1, 7))]}
            for i in range(n)]


def _parity_image(rec):
    return np.random.default_rng(rec["id"]).standard_normal((8, 8, 3)).astype(np.float32)


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_train_loader_matches_jax_bit_for_bit(setting):
    """Three epochs of every process: the same batches, keys, dtypes,
    shapes and bytes as the JAX TrainLoader, and the same dedup stats."""
    from radzero_tpu.data import pipeline as jpipe
    from radzero_tpu.data.tokenizer import WhitespaceHashTokenizer as JaxTok

    kw = dict(SETTINGS[setting])
    spec_kw = dict(max_sentences_per_image=4, max_text_tokens=16, **kw.pop("spec", {}))
    pc = kw.pop("process_count", 1)
    records = _parity_records()
    for pi in range(pc):
        loaders = [
            mod.TrainLoader(records, _parity_image, tok(vocab_size=1009, max_length=16), 4,
                            mod.PackSpec(**spec_kw), seed=11, num_threads=2,
                            process_index=pi, process_count=pc, **kw)
            for mod, tok in ((jpipe, JaxTok), (tpipe, WhitespaceHashTokenizer))
        ]
        ref, port = loaders
        assert len(port) == len(ref)
        for _ in range(3):
            want, got = list(ref), list(port)
            assert len(got) == len(want) > 0
            for a, b in zip(want, got):
                assert sorted(a) == sorted(b)
                for k in a:
                    assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
                    assert a[k].tobytes() == b[k].tobytes(), k
        assert port.stats == ref.stats and port.epoch == ref.epoch == 3
