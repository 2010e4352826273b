"""The port's frozen-tower activation cache on the CPU: the cases of
tests/test_tower_cache.py against radzero_torch.train.tower_cache (the
``device`` backing on ``device="cpu"``), and bf16 tokens through the
memmap bit for bit (numpy has no bfloat16: the file holds their int16
view). The port's cache tower is the step's own tower, so cached and
uncached runs agree bit for bit, where the JAX package allows a
tolerance for XLA's fusion boundaries.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from radzero_torch.data.pipeline import PackSpec, TrainLoader
from radzero_torch.data.tokenizer import WhitespaceHashTokenizer
from radzero_torch.models.configuration import (
    AlignConfig,
    LossConfig,
    RadZeroConfig,
    TextConfig,
    ViTConfig,
)
from radzero_torch.train.optim import tree_leaves
from radzero_torch.train.tower_cache import TowerCache, make_tower_fn
from radzero_torch.train.trainer import RadZeroTrainer, TrainerArgs

D = 32
CFG = RadZeroConfig(
    vision=ViTConfig(hidden_size=D, num_hidden_layers=1, num_attention_heads=2, mlp_ratio=2.0,
                     patch_size=14, pretrain_img_size=28, img_size=28),
    text=TextConfig(hidden_size=D, num_hidden_layers=1, num_attention_heads=2,
                    intermediate_size=64, vocab_size=5003, max_position_embeddings=40),
    align=AlignConfig(hidden_size=D, num_hidden_layers=1, num_attention_heads=2, mlp_ratio=2.0),
    loss=LossConfig(hidden_dim=D),
)


def _bf16(shape, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(torch.bfloat16)


# ---------------------------------------------------------------------------
# Storage
# ---------------------------------------------------------------------------

def test_tower_cache_ram_roundtrip():
    c = TowerCache("ram")
    tok = torch.arange(2 * 3 * 4, dtype=torch.float32).reshape(2, 3, 4)
    assert c.get(np.array([5, 9])) is None  # cold
    c.put(np.array([5, 9]), tok)
    assert torch.equal(c.get(np.array([9, 5])), tok.flip(0))  # any order
    assert c.get(np.array([5, 7])) is None  # partial presence is a miss
    s = c.stats()
    assert s["cached_records"] == 2 and s["hits"] == 1 and s["misses"] == 2
    assert s["bytes"] == tok.numel() * 4


def test_tower_cache_memmap_roundtrip(tmp_path):
    c = TowerCache("memmap", path=str(tmp_path), n_records=8)
    tok = _bf16((3, 5, 4), 0)
    idx = np.array([1, 6, 3])
    assert c.get(idx) is None
    c.put(idx, tok)
    got = c.get(idx)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), tok.view(torch.int16))
    assert c.get(np.array([1, 2])) is None
    assert c.n_cached == 3
    with open(tmp_path / "meta.json") as f:
        assert json.load(f) == {"shape": [8, 5, 4], "dtype": "torch.bfloat16"}
    with pytest.raises(ValueError, match="bfloat16"):
        c.put(np.array([2]), tok[:1].float())  # one store, one dtype: no silent recast


def test_tower_cache_memmap_bf16_every_bit_pattern(tmp_path):
    """All 65 536 bf16 bit patterns (zeros of both signs, subnormals,
    infinities, NaN payloads) come back from the memmap unchanged."""
    bits = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16).reshape(4, 128, 128)
    tok = bits.view(torch.bfloat16)
    c = TowerCache("memmap", path=str(tmp_path), n_records=4)
    c.put(np.arange(4), tok)
    del c
    got = TowerCache("memmap", path=str(tmp_path), n_records=4).get(np.array([2, 0, 3, 1]))
    assert torch.equal(got.view(torch.int16), bits[[2, 0, 3, 1]])


def test_tower_cache_memmap_cross_run_reuse(tmp_path):
    tok = _bf16((2, 4, 8), 1)
    c1 = TowerCache("memmap", path=str(tmp_path), n_records=6)
    c1.put(np.array([0, 3]), tok)
    del c1
    c2 = TowerCache("memmap", path=str(tmp_path), n_records=6)
    got = c2.get(np.array([0, 3]))  # warm get BEFORE any put
    assert got is not None and got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), tok.view(torch.int16))
    assert c2.get(np.array([1])) is None
    assert c2.n_cached == 2
    c3 = TowerCache("memmap", path=str(tmp_path), n_records=7)  # stale meta: cold start
    assert c3.get(np.array([0, 3])) is None
    c3.put(np.array([2]), tok[:1])
    assert c3.get(np.array([0, 3])) is None
    assert c3.n_cached == 1


def test_tower_cache_bad_args(tmp_path):
    with pytest.raises(ValueError, match="backing"):
        TowerCache("disk")
    with pytest.raises(ValueError, match="memmap"):
        TowerCache("memmap", path=str(tmp_path))
    with pytest.raises(ValueError, match="memmap"):
        TowerCache("memmap", n_records=4)


def test_tower_cache_device_roundtrip():
    c = TowerCache("device", n_records=8)
    tok = _bf16((3, 5, 4), 2)
    idx = np.array([1, 6, 3])
    assert c.get(idx) is None
    c.put(idx, tok)
    got = c.get(np.array([3, 1, 6]))
    assert got is not None and got.dtype == torch.bfloat16 and got.device == tok.device
    assert torch.equal(got, tok[[2, 0, 1]])
    assert c.get(np.array([1, 2])) is None
    assert c.n_cached == 3
    assert c.nbytes == 8 * 5 * 4 * 2  # the whole preallocated store, bf16
    with pytest.raises(ValueError, match="device"):
        TowerCache("device")


# ---------------------------------------------------------------------------
# Loader index plumbing
# ---------------------------------------------------------------------------

def _records(n):
    rng = np.random.default_rng(0)
    recs, images = [], {}
    for i in range(n):
        recs.append({"key_phrases": [f"finding alpha {i}", f"observation beta {i}"],
                     "image": i})
        images[i] = rng.standard_normal((28, 28, 3)).astype(np.float32) * 0.5 + 0.2 * i / n
    return recs, (lambda rec: images[rec["image"]])


def test_loader_with_indices_matches_order():
    recs, image_loader = _records(16)
    tok = WhitespaceHashTokenizer(vocab_size=5003, max_length=10)
    loader = TrainLoader(recs, image_loader, tok, 8,
                         PackSpec(max_sentences_per_image=2, max_text_tokens=10), seed=3,
                         num_threads=2, with_indices=True)
    seen = []
    for batch in loader:
        idx = batch["record_indices"]
        assert idx.shape == (8,)
        ref = np.stack([image_loader(recs[i]) for i in idx])
        np.testing.assert_array_equal(batch["pixel_values"], ref.astype(np.float32))
        seen.extend(idx.tolist())
    assert sorted(seen) == list(range(16))


# ---------------------------------------------------------------------------
# Trainer integration
# ---------------------------------------------------------------------------

def _loaders(with_indices, n=16, batch=8):
    recs, image_loader = _records(n)
    tok = WhitespaceHashTokenizer(vocab_size=5003, max_length=10)
    spec = PackSpec(max_sentences_per_image=2, max_text_tokens=10)
    train = TrainLoader(recs, image_loader, tok, batch, spec, seed=0, num_threads=2,
                        with_indices=with_indices)
    evalset = TrainLoader(recs[:8], image_loader, tok, batch, spec, seed=0, shuffle=False,
                          num_threads=2)
    return train, evalset


def _args(tmp_path, sub):
    return TrainerArgs(output_dir=str(tmp_path / sub), num_train_epochs=2, warmup_steps=1,
                       logging_steps=1, bf16=False, learning_rate=3e-4)


def _train(tmp_path, sub, with_indices, cache=None, cfg=CFG, args=None):
    train, evalset = _loaders(with_indices)
    t = RadZeroTrainer(cfg, args or _args(tmp_path, sub), train, evalset, device="cpu",
                       tower_cache=cache)
    t.train()
    return t


def _step_losses(t):
    return [r for r in t.state.log_history if "loss" in r]


def test_trainer_tower_cache_matches_uncached(tmp_path):
    """Two epochs cached vs uncached from the same seed: the same losses
    and final weights, bit for bit (the cache's tower is the step's)."""
    t_u = _train(tmp_path, "uncached", False)
    cache = TowerCache("ram")
    t_c = _train(tmp_path, "cached", True, cache)
    assert cache.misses == len(t_c.train_loader) and cache.hits == len(t_c.train_loader)
    assert _step_losses(t_c) == _step_losses(t_u)
    for a, b in zip(tree_leaves(t_u.trainable), tree_leaves(t_c.trainable)):
        assert torch.equal(a, b)


def test_tower_fn_is_the_steps_tower():
    from radzero_torch.models.radzero import forward_vision, init_radzero

    params = init_radzero(torch.Generator().manual_seed(0), CFG)
    pixels = torch.randn(2, 28, 28, 3, generator=torch.Generator().manual_seed(1))
    tokens = make_tower_fn(CFG, dtype=torch.float32)(params["vision_model"], pixels)
    assert tokens.shape == (2, 5, D) and not tokens.requires_grad
    with torch.no_grad():
        a = forward_vision(params, CFG, pixels, stop_tower_gradient=True)
        b = forward_vision(params, CFG, None, tower_tokens=tokens)
    assert torch.equal(a["vision_tokens"], b["vision_tokens"])


def test_trainer_tower_cache_hit_miss_accounting(tmp_path):
    cache = TowerCache("ram")
    t = _train(tmp_path, "acct", True, cache)
    per_epoch = len(t.train_loader)
    assert cache.misses == per_epoch
    assert cache.hits == per_epoch
    assert cache.n_cached == 16


def test_tower_cache_requires_frozen_tower(tmp_path):
    train, evalset = _loaders(with_indices=True)
    args = dataclasses.replace(
        _args(tmp_path, "bad"),
        module_to_update=("vision_model", "align_transformer", "text_model", "loss_fns"),
    )
    with pytest.raises(ValueError, match="frozen"):
        RadZeroTrainer(CFG, args, train, evalset, device="cpu", tower_cache=TowerCache("ram"))


def test_tower_cache_without_indices_errors(tmp_path):
    train, evalset = _loaders(with_indices=False)
    t = RadZeroTrainer(CFG, _args(tmp_path, "noidx"), train, evalset, device="cpu",
                       tower_cache=TowerCache("ram"))
    with pytest.raises(ValueError, match="record_indices"):
        t.train()


def test_tower_cache_defaults_align_no_remat(tmp_path):
    train, evalset = _loaders(with_indices=True)
    t = RadZeroTrainer(CFG, _args(tmp_path, "nr"), train, evalset, device="cpu",
                       tower_cache=TowerCache("ram"))
    assert t.cfg.align.remat is False
    cfg_explicit = dataclasses.replace(CFG, align=dataclasses.replace(CFG.align, remat=True))
    t2 = RadZeroTrainer(cfg_explicit, _args(tmp_path, "nr2"), train, evalset, device="cpu",
                        tower_cache=TowerCache("ram"))
    assert t2.cfg.align.remat is True
    t3 = RadZeroTrainer(CFG, _args(tmp_path, "nr3"), *_loaders(with_indices=False),
                        device="cpu")
    assert t3.cfg.align.remat is None


@pytest.mark.parametrize("backing", ["device", "memmap"])
def test_trainer_tower_cache_backing_matches_ram(tmp_path, backing):
    """Every backing trains to the RAM backing's weights bit for bit, with
    the same hit / miss profile."""
    t_r = _train(tmp_path, "ram", True, TowerCache("ram"))
    other = TowerCache(backing, n_records=16,
                       path=str(tmp_path / "mm") if backing == "memmap" else None)
    t_o = _train(tmp_path, backing, True, other)
    assert other.misses == len(t_o.train_loader) and other.hits == len(t_o.train_loader)
    assert _step_losses(t_o) == _step_losses(t_r)
    for a, b in zip(tree_leaves(t_r.trainable), tree_leaves(t_o.trainable)):
        assert torch.equal(a, b)
    if backing == "memmap":
        assert os.path.getsize(tmp_path / "mm" / "tokens.dat") == 16 * 5 * D * 4
