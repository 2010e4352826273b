"""The serving slice end to end on the CPU: compute_logits of the port
against the JAX compute_logits, and the port's ServingEngine.

Sizes: D = 64, 2 tower + 2 align + 2 text layers, 4 heads, positions
stored for 42 px and run at 56 px (bicubic resample). Weights come from
the JAX init through the bridge, inputs from numpy.
"""

import concurrent.futures as cf
import dataclasses
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radzero_tpu.models import configuration as jconf
from radzero_tpu.models.radzero import compute_logits as jax_compute_logits
from radzero_tpu.models.radzero import init_radzero as jax_init_radzero
from radzero_torch.data.tokenizer import WhitespaceHashTokenizer
from radzero_torch.eval.serving import ImageSpec, ServingEngine
from radzero_torch.models import configuration as tconf
from radzero_torch.models.from_jax import params_from_jax
from radzero_torch.models.radzero import compute_logits, init_radzero
from radzero_torch.ops.layers import normalize_pixels

from test_torch_modules import TEXT, VIT, perturbed

D = 64


def _cfg(m):
    return m.RadZeroConfig(
        vision=m.ViTConfig(**VIT),
        text=m.TextConfig(**TEXT, fuse_post=False),
        align=m.AlignConfig(hidden_size=D, num_hidden_layers=2, num_attention_heads=4,
                            mlp_ratio=2.0),
        loss=m.LossConfig(hidden_dim=D),
    )


JCFG, TCFG = _cfg(jconf), _cfg(tconf)


@pytest.fixture(scope="module")
def weights():
    tree = perturbed(jax_init_radzero(jax.random.PRNGKey(0), JCFG), np.random.default_rng(0))
    return tree, params_from_jax(tree)


def _inputs(seed=1, b=2, n=3, l=12):
    rng = np.random.default_rng(seed)
    pv = rng.standard_normal((b, 56, 56, 3)).astype(np.float32)
    ids = np.full((n, l), 1, np.int32)
    mask = np.zeros((n, l), np.int32)
    for i in range(n):
        k = int(rng.integers(4, l + 1))
        ids[i, :k] = rng.integers(3, 211, k)
        ids[i, 0], ids[i, k - 1] = 0, 2
        mask[i, :k] = 1
    return pv, ids, mask


@pytest.mark.parametrize("eager", [False, True])
def test_compute_logits_matches_jax(weights, eager):
    """Kernel path (K1-K3, K5 twins) against the JAX fused path; eager
    path against the JAX XLA path. The repo's gate is logits rtol 1e-3 /
    atol 2e-4 and map MAE < 1e-3 (tests/test_radzero_model.py); the port
    holds a tighter 1e-5 on both and a map MAE below 1e-6."""
    tree, params = weights
    pv, ids, mask = _inputs()
    jcfg = jconf.with_fused_towers(JCFG) if not eager else JCFG
    if eager:  # the JAX xla path: no Pallas in the towers
        jcfg = dataclasses.replace(
            JCFG, vision=dataclasses.replace(JCFG.vision, attn_impl="xla"),
            align=dataclasses.replace(JCFG.align, attn_impl="xla"))
    ref = jax_compute_logits(tree, jcfg, jnp.asarray(pv), jnp.asarray(ids), jnp.asarray(mask))
    out = compute_logits(params, TCFG, torch.from_numpy(pv), torch.from_numpy(ids).long(),
                         torch.from_numpy(mask).long(), eager=eager)
    logits, maps = out["logits"].numpy(), out["similarity_scores"].numpy()
    assert logits.shape == (2, 3) and maps.shape == (2, 3, 16)
    np.testing.assert_allclose(logits, np.asarray(ref["logits"]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(maps, np.asarray(ref["similarity_scores"]), rtol=1e-5, atol=1e-5)
    assert np.abs(maps - np.asarray(ref["similarity_scores"])).mean() < 1e-6


def test_unported_options_raise(weights):
    _, params = weights
    pv, ids, mask = (torch.from_numpy(a) for a in _inputs())
    for cfg in (
        dataclasses.replace(TCFG, compute_logits_type="cls_alignment"),
        dataclasses.replace(TCFG, vision=dataclasses.replace(TCFG.vision, token_filter_ratio=0.5)),
    ):
        with pytest.raises(NotImplementedError):
            compute_logits(params, cfg, pv, ids.long(), mask.long())


def test_port_init_matches_bridge_layout(weights):
    """init_radzero and params_from_jax give the same tree of shapes."""
    _, bridged = weights

    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        if isinstance(t, list):
            return [shapes(v) for v in t]
        return tuple(t.shape)

    assert shapes(init_radzero(torch.Generator().manual_seed(0), TCFG)) == shapes(bridged)


def _engine(params, **kw):
    tok = WhitespaceHashTokenizer(vocab_size=211, max_length=12)
    return ServingEngine(params, TCFG, tok, device="cpu", dtype=torch.float32,
                         preprocess_threads=2, **kw), tok


def _expected(params, tok, images_u8, prompts):
    ids, mask = (torch.as_tensor(a).long() for a in tok(prompts))
    u8 = torch.from_numpy(np.stack(images_u8))[..., None].expand(-1, 56, 56, 3)
    pv = normalize_pixels(u8, ImageSpec().mean, ImageSpec().std, dtype=torch.float32)
    out = compute_logits(params, TCFG, pv, ids, mask)
    return torch.sigmoid(out["logits"]).numpy(), torch.sigmoid(out["similarity_scores"]).numpy()


def test_serving_engine_answers_two_prompt_sets(weights):
    _, params = weights
    sets = {"a": ["There is Edema", "There is Pneumothorax", "No Finding"],
            "b": ["There is Cardiomegaly", "There is Pleural Effusion"]}
    rng = np.random.default_rng(3)
    images = [rng.integers(0, 256, (56, 56), dtype=np.uint8) for _ in range(5)]
    order = ["a", "b", "a", "a", "b"]
    engine, tok = _engine(params, max_batch=4, channels=1)
    with engine:
        for name, prompts in sets.items():
            engine.register_prompt_set(name, prompts)
        engine.warmup()
        assert engine.batch_sizes == []  # warmup batches are not served ones
        futs = [engine.submit(img, s, want_maps=(i % 2 == 0))
                for i, (img, s) in enumerate(zip(images, order))]
        results = [f.result(timeout=120) for f in futs]
    assert sum(engine.batch_sizes) == 5
    for name, prompts in sets.items():
        idx = [i for i, s in enumerate(order) if s == name]
        probs, maps = _expected(params, tok, [images[i] for i in idx], prompts)
        for j, i in enumerate(idx):
            np.testing.assert_allclose(results[i]["probs"], probs[j], rtol=1e-5, atol=1e-6)
            if i % 2 == 0:
                assert results[i]["similarity_maps"].shape == (len(prompts), 4, 4)
                np.testing.assert_allclose(results[i]["similarity_maps"],
                                           maps[j].reshape(-1, 4, 4), rtol=1e-5, atol=1e-6)
            else:
                assert results[i]["similarity_maps"] is None


def test_serving_engine_resizes_other_sizes_and_full_maps(weights):
    """An image not at model size goes through the (lazily imported) PIL
    resize, and "full" maps come back at the original resolution."""
    _, params = weights
    img = np.random.default_rng(4).integers(0, 256, (70, 60, 3), dtype=np.uint8)
    engine, _ = _engine(params, max_batch=2)
    with engine:
        engine.register_prompt_set("p", ["There is Edema", "No Finding"])
        r = engine.submit(img, "p", want_maps="full").result(timeout=120)
    assert r["probs"].shape == (2,)
    assert r["similarity_maps"].shape == (2, 70, 60)
    assert np.all((r["similarity_maps"] > 0) & (r["similarity_maps"] < 1))


def test_serving_engine_close_resolves_every_future(weights):
    """Stress the held slot: interleaved prompt sets from several threads,
    then close(); every future must resolve (answer or shutdown error)."""
    _, params = weights
    engine, _ = _engine(params, max_batch=3, max_delay_ms=1.0)
    engine.register_prompt_set("a", ["There is Edema"])
    engine.register_prompt_set("b", ["No Finding"])
    img = np.zeros((56, 56, 3), np.uint8)
    futs, lock = [], threading.Lock()

    def client(k):
        for i in range(8):
            try:
                f = engine.submit(img, "ab"[(i + k) % 2])
            except RuntimeError:  # engine closed
                return
            with lock:
                futs.append(f)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(k,)) for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        engine.close()
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert len(futs) == 32
    done, pending = cf.wait(futs, timeout=60)
    assert not pending
    for f in done:
        if f.exception() is None:
            assert f.result()["probs"].shape == (1,)
        else:
            assert "shutting down" in str(f.exception())
