"""LoRA adapters in the port (``radzero_torch/train/lora.py``), on the CPU.

The four cases of tests/test_lora.py against the port (identity at init,
stacked and plain kernels targeted in every tower, gradients reaching the
adapters and changing the loss, the adapter file round trip), then the
port against the JAX package: the same adapter keys and shapes from
``init_lora``; ``merge_lora`` of the bridged adapters (``lora_from_jax``)
equal to ``params_from_jax`` of the JAX merge at 1e-6, the packed qkv's
thirds included; the adapter gradients through ``forward_train`` (a
trainable tower on the K1-K3 / K6-K8 twins, fused_vjp align layers,
fuse_post MPNet) against ``jax.grad`` at 2e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radzero_tpu.models.radzero import forward_train as jax_forward_train
from radzero_tpu.train import lora as jlora
from radzero_torch.models.configuration import (
    AlignConfig,
    LossConfig,
    RadZeroConfig,
    TextConfig,
    ViTConfig,
)
from radzero_torch.models.from_jax import lora_from_jax, params_from_jax, params_to_numpy
from radzero_torch.models.radzero import forward_train, init_radzero
from radzero_torch.train.lora import (
    init_lora,
    load_adapter,
    lora_trainable,
    merge_lora,
    save_adapter,
    with_trainable,
)

from test_torch_train import JCFG, TCFG, _batch, _to_torch, weights  # noqa: F401

D = 32
CFG = RadZeroConfig(
    vision=ViTConfig(hidden_size=D, num_hidden_layers=1, num_attention_heads=2, mlp_ratio=2.0,
                     patch_size=14, pretrain_img_size=28, img_size=28),
    text=TextConfig(hidden_size=D, num_hidden_layers=1, num_attention_heads=2,
                    intermediate_size=64, vocab_size=101, max_position_embeddings=40),
    align=AlignConfig(hidden_size=D, num_hidden_layers=1, num_attention_heads=2, mlp_ratio=2.0),
    loss=LossConfig(hidden_dim=D),
)


def _params(seed=0):
    return init_radzero(torch.Generator().manual_seed(seed), CFG)


def _small_batch(rng):
    return {
        "pixel_values": torch.from_numpy(rng.standard_normal((2, 28, 28, 3)).astype(np.float32)),
        "input_ids": torch.from_numpy(rng.integers(3, 101, (4, 8))),
        "attention_mask": torch.ones((4, 8), dtype=torch.int64),
        "group_map": torch.tensor([0, 0, 1, 1]),
        "row_mask": torch.ones(4),
    }


def _loss(params, batch, cfg=CFG):
    return forward_train(params, cfg, batch)["losses"]["loss"]


def test_lora_identity_at_init():
    params = _params()
    lora = init_lora(torch.Generator().manual_seed(1), params, ["attn/q", "attn/v"], r=4)
    assert lora["adapters"], "no kernels targeted"
    batch = _small_batch(np.random.default_rng(0))
    with torch.no_grad():
        l0, l1 = _loss(params, batch), _loss(merge_lora(params, lora), batch)
    assert torch.equal(l0, l1)  # B = 0: the merged kernels are the base ones


def test_lora_targets_stacked_and_plain_kernels():
    params = _params()
    lora = init_lora(torch.Generator().manual_seed(1), params, ["attn/q", "patch_embed"], r=4)
    keys = list(lora["adapters"])
    assert any(k.startswith("vision_model/layers") for k in keys)
    assert any(k.startswith("align_transformer") for k in keys)
    assert any(k.startswith("text_model") for k in keys)
    for k, ab in lora["adapters"].items():
        if "layers" in k:  # per-layer adapters
            assert ab["a"].shape == (1, D, 4) and ab["b"].shape == (1, 4, D)
        else:
            assert k == "vision_model/patch_embed/kernel"
            assert ab["a"].ndim == 2 and ab["b"].shape == (4, D)


def test_lora_gradients_flow_and_change_output():
    params = _params()
    lora = init_lora(torch.Generator().manual_seed(1), params, ["attn/q", "mlp/fc1"], r=2)
    batch = _small_batch(np.random.default_rng(1))
    trainable = lora_trainable(lora)
    leaves = [t for ab in trainable["adapters"].values() for t in ab.values()]
    for t in leaves:
        t.requires_grad_(True)
    loss = _loss(merge_lora(params, with_trainable(lora, trainable)), batch)
    grads = torch.autograd.grad(loss, leaves)
    gb = [g.abs().max().item() for g in grads[1::2]]  # the b of each adapter
    assert max(gb) > 0  # b receives gradient (a's is 0 at init since b = 0)
    with torch.no_grad():
        pert = {"adapters": {k: {n: t + 0.1 for n, t in ab.items()}
                             for k, ab in trainable["adapters"].items()}}
        l0 = _loss(merge_lora(params, lora), batch).item()
        l1 = _loss(merge_lora(params, with_trainable(lora, pert)), batch).item()
    assert abs(l0 - l1) > 1e-6


def test_lora_adapter_save_load(tmp_path):
    params = _params()
    lora = init_lora(torch.Generator().manual_seed(1), params, ["attn/q"], r=4, alpha=16)
    lora["adapters"] = {k: {n: t + 0.5 for n, t in ab.items()}
                        for k, ab in lora["adapters"].items()}
    save_adapter(lora, str(tmp_path / "adapter"))
    fresh = init_lora(torch.Generator().manual_seed(2), params, ["attn/q"], r=4, alpha=16)
    restored = load_adapter(str(tmp_path / "adapter"), fresh)
    assert restored["r"] == 4 and restored["alpha"] == 16
    for k, ab in lora["adapters"].items():
        for n in ("a", "b"):
            assert torch.equal(restored["adapters"][k][n], ab[n])
    other = init_lora(torch.Generator().manual_seed(2), params, ["attn/v"], r=4, alpha=16)
    with pytest.raises(ValueError, match="differs"):
        load_adapter(str(tmp_path / "adapter"), other)


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

TARGETS = ["attn/q", "attn/v", "mlp/fc1", "patch_embed"]


def _jax_lora(weights, seed=3):  # noqa: F811
    """JAX init_lora with every b moved off zero (so a's gradient is not 0)."""
    lora = jlora.init_lora(jax.random.PRNGKey(seed), weights, TARGETS, r=4, alpha=8)
    rng = np.random.default_rng(seed)
    adapters = {k: {"a": np.asarray(ab["a"]),
                    "b": (0.05 * rng.standard_normal(ab["b"].shape)).astype(np.float32)}
                for k, ab in lora["adapters"].items()}
    return {**lora, "adapters": adapters}


def test_init_lora_keys_and_shapes_match_jax(weights):  # noqa: F811
    jl = jlora.init_lora(jax.random.PRNGKey(3), weights, TARGETS, r=4, alpha=8)
    tl = init_lora(torch.Generator().manual_seed(3), params_from_jax(weights), TARGETS, r=4,
                   alpha=8)
    assert list(tl["adapters"]) == list(jl["adapters"])
    for k, ab in jl["adapters"].items():
        for n in ("a", "b"):
            assert tuple(tl["adapters"][k][n].shape) == tuple(ab[n].shape), k
    assert not tl["adapters"]["text_model/layers/attn/q/kernel"]["b"].any()


def test_merge_lora_matches_jax(weights):  # noqa: F811
    lora = _jax_lora(weights)
    ref = params_to_numpy(params_from_jax(jax.tree_util.tree_map(
        np.asarray, jlora.merge_lora(jax.tree_util.tree_map(jnp.asarray, weights),
                                     jax.tree_util.tree_map(jnp.asarray, lora)))))
    got = params_to_numpy(merge_lora(params_from_jax(weights), lora_from_jax(lora)))
    base = params_to_numpy(params_from_jax(weights))
    for name in ("vision_model", "align_transformer"):
        for i, layer in enumerate(got[name]["layers"]):
            k, r, b = (t[name]["layers"][i]["attn"]["qkv"]["kernel"] for t in (got, ref, base))
            np.testing.assert_allclose(k, r, rtol=1e-6, atol=1e-6)
            d = k.shape[0]
            assert not np.array_equal(k[:, :d], b[:, :d])            # q: adapted
            np.testing.assert_array_equal(k[:, d:2 * d], b[:, d:2 * d])  # k: the base's
            assert not np.array_equal(k[:, 2 * d:], b[:, 2 * d:])    # v: adapted

    def walk(a, r, path=""):
        if isinstance(a, dict):
            for key in a:
                walk(a[key], r[key], f"{path}/{key}")
        elif isinstance(a, list):
            for i, (x, y) in enumerate(zip(a, r)):
                walk(x, y, f"{path}/{i}")
        else:
            np.testing.assert_allclose(a, r, rtol=1e-6, atol=1e-6, err_msg=path)

    walk(got, ref)


def test_lora_gradients_match_jax(weights):  # noqa: F811
    """Adapters on every tower, the tower trainable through them: the loss and
    every adapter gradient against jax.grad of the JAX merge + forward_train
    (fused_vjp in tower and align layers, fuse_post) at 2e-4."""
    lora = _jax_lora(weights, seed=4)
    jcfg = dataclasses.replace(
        JCFG, vision=dataclasses.replace(JCFG.vision, attn_impl="fused_vjp"),
        align=dataclasses.replace(JCFG.align, attn_impl="fused_vjp"),
        text=dataclasses.replace(JCFG.text, fuse_post=True))
    tcfg = dataclasses.replace(
        TCFG, align=dataclasses.replace(TCFG.align, attn_impl="fused_vjp"),
        text=dataclasses.replace(TCFG.text, fuse_post=True))
    batch = _batch(seed=10)
    jparams = jax.tree_util.tree_map(jnp.asarray, weights)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def jloss(tr):
        merged = jlora.merge_lora(jparams, jlora.with_trainable(lora, tr))
        return jax_forward_train(merged, jcfg, jbatch)["losses"]["loss"]

    jl, jg = jax.value_and_grad(jloss)(
        jax.tree_util.tree_map(jnp.asarray, jlora.lora_trainable(lora)))

    tlora = lora_from_jax(lora)
    tr = lora_trainable(tlora)
    for ab in tr["adapters"].values():
        for t in ab.values():
            t.requires_grad_(True)
    params = params_from_jax(weights)
    loss = forward_train(merge_lora(params, with_trainable(tlora, tr)), tcfg,
                         _to_torch(batch))["losses"]["loss"]
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5, atol=1e-6)
    assert any(k.startswith("vision_model/layers") for k in tr["adapters"])
    for k, ab in tr["adapters"].items():
        for n, t in ab.items():
            ref = np.asarray(jg["adapters"][k][n])
            assert np.abs(ref).max() > 0, (k, n)
            np.testing.assert_allclose(t.grad.numpy(), ref, rtol=2e-4, atol=2e-4,
                                       err_msg=f"{k} {n}")
