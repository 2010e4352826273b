"""Remat in the port (``remat=True``, ``TrainerArgs.gradient_checkpointing``)
against the port without it and against the JAX package under
``jax.checkpoint``, fp32 on the CPU.

- the align layers per route (``fused_vjp``, ``packed``, ``flash``, ``xla``)
  and per ``remat_policy`` (None, ``"save_attn"``): every gradient bit-equal
  to the same layers without remat, and within 2e-4 of ``jax.grad`` of the
  JAX layers under ``remat=True`` (tests/test_fused_layer.py:217-311);
- MPNet with ``fuse_post`` True and False: bit-equal to no remat, within
  5e-4 of the JAX ``mpnet_forward(remat=True)`` (tests/test_fused_layer.py:
  313-348);
- ``forward_train(remat=True)``: bit-equal to no remat, and within rtol
  1e-5 / atol 1e-6 of the JAX one (tests/test_train_memory_path.py:65-80);
- counting twins (the plain twins of K1-K4 wrapped with counters): on the
  fused layer ``save_attn`` reruns K1 once a layer in the backward and K2 /
  K3 never, None reruns all three, and MPNet's remat reruns K4 once a layer;
- ``saved_tensors_hooks``: a remat step keeps fewer bytes for the backward,
  and ``save_attn`` on the fused layer drops exactly qkv.

D = 64 as 4 heads of 16, L = 17 tokens (CLS + 4 x 4 patches), 2 layers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radzero_tpu.models import mpnet as jmpnet
from radzero_tpu.models import vit as jvit
from radzero_tpu.models.configuration import AlignConfig as JAlign
from radzero_tpu.models.configuration import TextConfig as JText
from radzero_tpu.models.radzero import forward_train as jax_forward_train
from radzero_torch.models import mpnet as tmpnet
from radzero_torch.models import vit as tvit
from radzero_torch.models.configuration import AlignConfig, TextConfig
from radzero_torch.models.from_jax import params_from_jax, params_to_numpy
from radzero_torch.models.radzero import forward_train
from radzero_torch.ops import fused_layer as tfl
from radzero_torch.train import optim as toptim

from test_torch_modules import TEXT, _text_inputs, perturbed
from test_torch_train import JCFG, TCFG, TRAINABLE, _batch, _leaves, _split, _to_torch, weights  # noqa: F401

D = 64
ALIGN = dict(hidden_size=D, num_hidden_layers=2, num_attention_heads=4, mlp_ratio=2.0)
ROUTES = ["fused_vjp", "packed", "flash", "xla"]
POLICIES = [None, "save_attn"]


def _align_tree(seed):
    jinit = jvit.init_vit_layers
    return perturbed(jinit(jax.random.PRNGKey(seed), JAlign(**ALIGN).as_vit()),
                     np.random.default_rng(seed))


def _port_grads(layers, cfg, x_np, impl, remat):
    """(loss, [d x, d leaf...]) of sum(out ** 2) over the port's layers."""
    x = torch.from_numpy(x_np).requires_grad_(True)
    leaves = toptim.tree_leaves(layers)
    for p in leaves:
        p.requires_grad_(True)
    out = tvit.vit_encoder(layers, cfg, x, impl=impl, remat=remat)
    loss = (out.float() ** 2).sum()
    grads = torch.autograd.grad(loss, [x] + leaves)
    for p in leaves:
        p.requires_grad_(False)
    return loss.detach(), grads


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("route", ROUTES)
def test_align_layers_remat_match_plain_and_jax(route, policy):
    tree = _align_tree(11)
    layers = params_from_jax({"align_transformer": {"layers": tree}})["align_transformer"]["layers"]
    x = np.random.default_rng(12).standard_normal((2, 17, D)).astype(np.float32)
    cfg = AlignConfig(**ALIGN, attn_impl=route, remat_policy=policy).as_vit()
    impl = tvit.layer_impl(route)

    ref_loss, ref = _port_grads(layers, cfg, x, impl, remat=False)
    loss, got = _port_grads(layers, cfg, x, impl, remat=True)
    assert torch.equal(loss, ref_loss)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)

    jcfg = JAlign(**ALIGN, attn_impl=route, remat_policy=policy).as_vit()

    def jloss(tree, xin):
        out = jvit.vit_encoder(tree, jcfg, xin, remat=True)
        return jnp.sum(out.astype(jnp.float32) ** 2)

    jl, (jg_tree, jg_x) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(x))
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(jg_x), rtol=2e-4, atol=2e-4)
    jlayers = params_from_jax({"align_transformer": {"layers": jax.tree_util.tree_map(
        np.asarray, jg_tree)}})["align_transformer"]["layers"]
    for g, r in zip(got[1:], toptim.tree_leaves(jlayers)):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("fuse_post", [True, False])
def test_mpnet_remat_matches_plain_and_jax(fuse_post):
    jcfg = JText(**TEXT, fuse_post=fuse_post)
    tree = perturbed(jmpnet.init_mpnet(jax.random.PRNGKey(13), jcfg), np.random.default_rng(13))
    params = params_from_jax({"text_model": tree})["text_model"]
    ids, mask = _text_inputs(np.random.default_rng(14))
    cfg = TextConfig(**TEXT, fuse_post=fuse_post)

    def port(remat):
        leaves = toptim.tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        h = tmpnet.mpnet_forward(params, cfg, torch.from_numpy(ids).long(),
                                 torch.from_numpy(mask).long(), remat=remat)
        loss = (h.float() ** 2).sum()
        grads = torch.autograd.grad(loss, leaves)
        for p in leaves:
            p.requires_grad_(False)
        return loss.detach(), grads

    ref_loss, ref = port(False)
    loss, got = port(True)
    assert torch.equal(loss, ref_loss)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))

    def jloss(p):
        h = jmpnet.mpnet_forward(p, jcfg, jnp.asarray(ids), jnp.asarray(mask), remat=True)
        return jnp.sum(h.astype(jnp.float32) ** 2)

    jg = jax.grad(jloss)(jax.tree_util.tree_map(jnp.asarray, tree))
    jleaves = toptim.tree_leaves(params_from_jax({"text_model": jax.tree_util.tree_map(
        np.asarray, jg)})["text_model"])
    assert len(jleaves) == len(got)
    for g, r in zip(got, jleaves):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=5e-4, atol=5e-4)


def _port_train(params, cfg, batch, remat):
    trainable, frozen = toptim.partition_params(params, TRAINABLE)
    leaves = toptim.tree_leaves(trainable)
    for p in leaves:
        p.requires_grad_(True)
    out = forward_train(toptim.merge_params(trainable, frozen), cfg, batch, remat=remat,
                        stop_vision_gradient=True)
    grads = torch.autograd.grad(out["losses"]["loss"], leaves)
    for p in leaves:
        p.requires_grad_(False)
    return out["losses"]["loss"].detach(), grads, trainable


@pytest.mark.parametrize("policy", POLICIES)
def test_forward_train_remat_matches_plain_and_jax(weights, policy):  # noqa: F811
    """The defaults' kernels (fused_vjp align layers, fuse_post MPNet, the
    fused VL-CABS loss) under remat: the loss and every gradient leaf
    bit-equal to the step without remat, and the JAX forward_train(remat=True)
    at rtol 1e-5 / atol 1e-6 on the loss, 2e-4 / 5e-4 (text) on the leaves."""
    def impls(c, m):
        return dataclasses.replace(
            c, align=dataclasses.replace(c.align, attn_impl="fused_vjp", remat_policy=policy),
            text=dataclasses.replace(c.text, fuse_post=True))

    cfg, jcfg = impls(TCFG, None), impls(JCFG, None)
    batch = _batch(seed=5)
    params = params_from_jax(weights)
    ref_loss, ref, _ = _port_train(params, cfg, _to_torch(batch), remat=False)
    loss, got, trainable = _port_train(params, cfg, _to_torch(batch), remat=True)
    assert torch.equal(loss, ref_loss)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))

    jtrain, jfrozen = _split(weights)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(tr):
        return jax_forward_train({**tr, **jfrozen}, jcfg, jbatch, remat=True,
                                 stop_vision_gradient=True)["losses"]["loss"]

    jl, jg = jax.value_and_grad(loss_fn)(jax.tree_util.tree_map(jnp.asarray, jtrain))
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5, atol=1e-6)
    ref_tree = dict(_leaves(params_to_numpy(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jg)))))
    paths = [path for path, _ in _leaves(trainable)]
    assert sorted(paths) == sorted(ref_tree)
    for path, g in zip(paths, got):
        tol = 5e-4 if path.startswith("/text_model") else 2e-4
        np.testing.assert_allclose(g.numpy(), ref_tree[path], rtol=tol, atol=tol, err_msg=path)


class _Counted:
    """The plain twins of K1-K4 wrapped with call counters."""

    NAMES = {"K1": "fused_preattn_plain", "K2": "flash_attention_packed_plain",
             "K3": "fused_postattn_plain", "K4": "fused_mpnet_post_plain"}

    def __init__(self, monkeypatch):
        self.n = dict.fromkeys(self.NAMES, 0)
        for k, name in self.NAMES.items():
            monkeypatch.setattr(tfl, name, self._wrap(k, getattr(tfl, name)))

    def _wrap(self, k, fn):
        def counted(*a, **kw):
            self.n[k] += 1
            return fn(*a, **kw)
        return counted

    def snap(self):
        return dict(self.n)


@pytest.mark.parametrize("policy", ["off", None, "save_attn"])
def test_remat_reruns_counted_kernels(weights, policy, monkeypatch):  # noqa: F811
    """Forward, then backward, of forward_train on the defaults' kernels with
    2 align layers and 2 MPNet layers: the backward reruns K1 2 times under
    save_attn and K1-K3 2 times each under None (the align layers), K4 2
    times under either (MPNet's full recompute); without remat nothing."""
    counts = _Counted(monkeypatch)
    cfg = dataclasses.replace(
        TCFG, align=dataclasses.replace(TCFG.align, attn_impl="fused_vjp",
                                        remat_policy=None if policy == "off" else policy),
        text=dataclasses.replace(TCFG.text, fuse_post=True))
    params = params_from_jax(weights)
    trainable, frozen = toptim.partition_params(params, TRAINABLE)
    leaves = toptim.tree_leaves(trainable)
    for p in leaves:
        p.requires_grad_(True)
    out = forward_train(toptim.merge_params(trainable, frozen), cfg, _to_torch(_batch(seed=6)),
                        remat=policy != "off", stop_vision_gradient=True)
    fwd = counts.snap()
    torch.autograd.grad(out["losses"]["loss"], leaves)
    bwd = {k: counts.n[k] - fwd[k] for k in fwd}
    # the frozen tower's 2 layers and the 2 align layers run K1-K3 once each
    assert fwd == {"K1": 4, "K2": 4, "K3": 4, "K4": 2}
    want = {"off": {"K1": 0, "K2": 0, "K3": 0, "K4": 0},
            None: {"K1": 2, "K2": 2, "K3": 2, "K4": 2},
            "save_attn": {"K1": 2, "K2": 0, "K3": 0, "K4": 2}}[policy]
    assert bwd == want


def _saved_bytes(fn):
    """Bytes of the distinct storages autograd keeps for the backward while
    ``fn`` runs (through ``saved_tensors_hooks``)."""
    seen = {}

    def pack(t):
        seen[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return sum(seen.values()), out


def test_remat_step_saves_fewer_bytes(weights):  # noqa: F811
    """save_attn on the fused align layers keeps exactly one (B, L, 3D) qkv
    less a layer; remat on MPNet too keeps less still (a checkpointed layer
    keeps its input only, held by the checkpoint itself)."""
    base = dataclasses.replace(
        TCFG, align=dataclasses.replace(TCFG.align, attn_impl="fused_vjp"),
        text=dataclasses.replace(TCFG.text, fuse_post=True))
    batch = _to_torch(_batch(seed=8))
    params = params_from_jax(weights)
    trainable, frozen = toptim.partition_params(params, TRAINABLE)
    for p in toptim.tree_leaves(trainable):
        p.requires_grad_(True)

    def run(cfg, remat):
        return _saved_bytes(lambda: forward_train(toptim.merge_params(trainable, frozen), cfg,
                                                  batch, remat=remat, stop_vision_gradient=True))

    plain, out = run(base, False)
    align_only, _ = run(dataclasses.replace(base, text=dataclasses.replace(base.text,
                                                                           remat=False)), True)
    both, _ = run(base, True)
    b, l, d = out["vision_tokens"].shape
    assert plain - align_only == base.align.num_hidden_layers * b * l * 3 * d * 4
    assert both < align_only
