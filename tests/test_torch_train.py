"""The training slice of the port against the JAX package, fp32 on the CPU.

MP-NCE, the VL-CABS training function (value and gradients), the training
forward with its gradient tree, the optimizer against optax, and a short
train-step trajectory. Sizes: D = 64, 2 tower + 2 align + 2 text layers.
Weights come from the JAX init through the bridge, inputs and gradients
from numpy. On the CPU the port's kernel wrappers run their plain twins;
the JAX side runs its Pallas kernels in interpret mode.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radzero_tpu.losses.mpnce import multi_positive_nce_loss as jax_mpnce
from radzero_tpu.models import configuration as jconf
from radzero_tpu.models.radzero import forward_train as jax_forward_train
from radzero_tpu.models.radzero import init_radzero as jax_init_radzero
from radzero_tpu.ops.vlcabs import vlcabs_similarity as jax_vlcabs
from radzero_tpu.train import optim as joptim
from radzero_tpu.train.step import make_train_step as jax_make_train_step
from radzero_torch.losses.mpnce import multi_positive_nce_loss
from radzero_torch.models import configuration as tconf
from radzero_torch.models.from_jax import params_from_jax, params_to_numpy
from radzero_torch.models.radzero import forward_train
from radzero_torch.ops import fused_layer as tfl
from radzero_torch.ops import vlcabs_fused as tvl
from radzero_torch.ops.vlcabs import vlcabs_similarity
from radzero_torch.train import optim as toptim
from radzero_torch.train.step import make_eval_step, make_train_step

from test_torch_modules import TEXT, VIT, perturbed

D = 64
TRAINABLE = ("align_transformer", "text_model", "loss_fns")


def _leaves(tree, prefix=""):
    """(path, leaf) pairs of a dict / list tree."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


# ---------------------------------------------------------------------------
# MP-NCE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("row_sum,col_sum", [(False, False), (True, False), (False, True),
                                             (True, True)])
def test_mpnce_matches_jax(row_sum, col_sum, padded):
    rng = np.random.default_rng(11)
    s, b = 12, 4
    logits = rng.standard_normal((s, b)).astype(np.float32)
    group = np.repeat(np.arange(b), s // b).astype(np.int32)
    mask = np.ones(s, np.float32)
    if padded:
        mask[[2, 7, 11]] = 0.0
    ref = jax_mpnce(jnp.asarray(logits), jnp.asarray(group), temperature=jnp.float32(0.07),
                    row_sum=row_sum, col_sum=col_sum, row_mask=jnp.asarray(mask))
    out = multi_positive_nce_loss(torch.from_numpy(logits), torch.from_numpy(group).long(),
                                  temperature=torch.tensor(0.07), row_sum=row_sum,
                                  col_sum=col_sum, row_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# VL-CABS training function (K10-K12 twins)
# ---------------------------------------------------------------------------

def _vlcabs_case(seed, n, b, l, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)).astype(np.float32),
            rng.standard_normal((b, l, d)).astype(np.float32),
            rng.standard_normal((n, b)).astype(np.float32))


def _torch_value_and_grads(q, t, tau, w, impl):
    tq, tt = torch.tensor(q, requires_grad=True), torch.tensor(t, requires_grad=True)
    ttau = torch.tensor(tau, requires_grad=True)
    logits, scores = vlcabs_similarity(tq, tt, sim_op="cos", temperature=ttau, impl=impl)
    assert scores is None
    val = (torch.from_numpy(w) * logits).sum()
    val.backward()
    return val.item(), (tq.grad.numpy(), tt.grad.numpy(), ttau.grad.numpy())


# L not a multiple of 128 and N not a multiple of 8; tau 0.008 and 0.002 are
# the JAX suite's tiny temperatures, where exp(s) without the row max overflows
@pytest.mark.parametrize("n,b,l,d,tau", [(5, 3, 37, 64, 0.07), (3, 2, 130, 32, 0.07),
                                         (8, 1, 128, 32, 0.07), (5, 3, 37, 64, 0.008),
                                         (5, 3, 37, 64, 0.002)])
def test_vlcabs_fused_train_matches_jax(n, b, l, d, tau):
    """Value rtol 1e-5 / atol 1e-6 and gradients rtol 1e-4 / atol 1e-5, the
    JAX suite's own (tests/test_pallas_vlcabs.py), against jax.grad of the
    JAX custom-VJP kernels."""
    q, t, w = _vlcabs_case(int(tau * 1e4) + l, n, b, l, d)

    def loss(q_, t_, tau_):
        logits, _ = jax_vlcabs(q_, t_, sim_op="cos", temperature=tau_, impl="fused_train")
        return jnp.sum(jnp.asarray(w) * logits)

    ref_val, ref_grads = jax.value_and_grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(t), jnp.float32(tau))
    launches = tvl.vlcabs_train_forward.launches
    val, grads = _torch_value_and_grads(q, t, np.float32(tau), w, "fused_train")
    assert tvl.vlcabs_train_forward.launches == launches  # CPU tensors: plain twins
    np.testing.assert_allclose(val, ref_val, rtol=1e-5, atol=1e-6)
    for g, r, name in zip(grads, ref_grads, ("dq", "dt", "dtau")):
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, np.asarray(r), rtol=1e-4, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("tau", [0.07, 0.008])
def test_vlcabs_plain_backward_matches_autograd_of_eager(tau):
    """The written-out backward formulas against torch.autograd through the
    eager VL-CABS chain."""
    q, t, w = _vlcabs_case(5, 6, 2, 50, 32)
    val, grads = _torch_value_and_grads(q, t, np.float32(tau), w, "fused_train")
    ref_val, ref_grads = _torch_value_and_grads(q, t, np.float32(tau), w, "xla")
    np.testing.assert_allclose(val, ref_val, rtol=1e-5, atol=1e-6)
    for g, r, name in zip(grads, ref_grads, ("dq", "dt", "dtau")):
        np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-5, err_msg=name)


def test_vlcabs_backward_plain_pieces():
    """vlcabs_train_backward_plain returns gradients in the operands'
    dtypes and tau's shape, and equals what the autograd function returns."""
    q, t, w = _vlcabs_case(9, 4, 2, 20, 32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    tq, tt, tau = torch.from_numpy(q), torch.from_numpy(t), torch.tensor([0.07])
    dq, dt, dtau = tvl.vlcabs_train_backward_plain(tq, tt, tau, torch.from_numpy(w))
    assert dq.shape == tq.shape and dt.shape == tt.shape and dtau.shape == tau.shape
    tq2, tt2, tau2 = (x.clone().requires_grad_(True) for x in (tq, tt, tau))
    (tvl.vlcabs_fused_train(tq2, tt2, tau2) * torch.from_numpy(w)).sum().backward()
    for a, r in ((dq, tq2.grad), (dt, tt2.grad), (dtau, tau2.grad)):
        np.testing.assert_array_equal(a.numpy(), r.numpy())


def test_vlcabs_impl_switch():
    q, t, _ = _vlcabs_case(1, 3, 2, 9, 16)
    tq, tt, tau = torch.from_numpy(q), torch.from_numpy(t), torch.tensor(0.07)
    with pytest.raises(ValueError, match="score maps"):
        vlcabs_similarity(tq, tt, temperature=tau, need_scores=True, impl="fused_train")
    with pytest.raises(ValueError, match="impl"):
        vlcabs_similarity(tq, tt, temperature=tau, impl="pallas")
    fused, maps = vlcabs_similarity(tq, tt, temperature=tau, need_scores=True, impl="fused")
    eager, ref_maps = vlcabs_similarity(tq, tt, temperature=tau, need_scores=True, impl="xla")
    np.testing.assert_allclose(fused.numpy(), eager.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(maps.numpy(), ref_maps.numpy(), rtol=1e-4, atol=1e-4)
    # dot has no kernel: every impl takes the eager chain
    a, _ = vlcabs_similarity(tq, tt, sim_op="dot", impl="fused_train")
    b, _ = vlcabs_similarity(tq, tt, sim_op="dot", impl="xla")
    np.testing.assert_array_equal(a.numpy(), b.numpy())


# ---------------------------------------------------------------------------
# grad guard of the forward-only kernels
# ---------------------------------------------------------------------------

def test_forward_only_wrappers_raise_under_gradients():
    """The kernels without a backward of their own (K5, K10) raise when handed
    a tensor that requires a gradient and name what provides it; they never
    cut the tape in silence. K1-K4 have backward kernels (K6-K9): the same
    call returns a tensor on the tape, and gradients for every operand."""
    d, f = 64, 128
    rng = np.random.default_rng(0)

    def t(*shape, grad=False):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 0.1
                                ).requires_grad_(grad)

    x, xg = t(4, d), t(4, d, grad=True)
    v, w3, b3 = t(d), t(d, 3 * d), t(3 * d)
    wdd, w1, b1, w2 = t(d, d), t(d, f), t(f), t(f, d)
    out = tfl.fused_preattn(xg, v, v, w3, b3)
    assert out.grad_fn is not None
    out.sum().backward()
    assert xg.grad is not None and torch.isfinite(xg.grad).all()
    w3g = w3.clone().requires_grad_(True)  # only a weight requires a gradient
    tfl.fused_preattn(x, v, v, w3g, b3).sum().backward()
    assert w3g.grad.shape == w3.shape and x.grad is None
    qkv = t(1, 4, 3 * d, grad=True)
    tfl.flash_attention_packed(qkv, 1).sum().backward()
    assert qkv.grad.shape == qkv.shape
    for fn, args in ((tfl.fused_postattn, (x, wdd, v, v, v, v, w1, b1, w2, v, v)),
                     (tfl.fused_mpnet_post, (x, wdd, v, v, v, w1, b1, w2, v, v, v))):
        leaf = t(4, d, grad=True)
        fn(leaf, *args).square().sum().backward()
        assert leaf.grad is not None and torch.isfinite(leaf.grad).all(), fn.__name__
    q = torch.zeros((2, d), requires_grad=True)
    with pytest.raises(RuntimeError, match="vlcabs_fused_train"):
        tvl.vlcabs_fused(q, torch.zeros((1, 4, d)), torch.tensor(0.07))
    with pytest.raises(RuntimeError, match="vlcabs_fused_train"):
        tvl.vlcabs_train_forward(q, torch.zeros((1, 4, d)), torch.tensor([0.07]))
    with torch.no_grad():  # the same operands without a tape are served, off the tape
        assert tfl.fused_preattn(xg, v, v, w3, b3).grad_fn is None
        assert tvl.vlcabs_fused(q, torch.zeros((1, 4, d)), torch.tensor(0.07))[0].shape == (2, 1)


# ---------------------------------------------------------------------------
# forward_train
# ---------------------------------------------------------------------------

def _cfg(m, **loss_kw):
    return m.RadZeroConfig(
        vision=m.ViTConfig(**VIT, attn_impl="xla"),
        text=m.TextConfig(**TEXT, fuse_post=False),
        align=m.AlignConfig(hidden_size=D, num_hidden_layers=2, num_attention_heads=4,
                            mlp_ratio=2.0, attn_impl="xla"),
        loss=m.LossConfig(hidden_dim=D, **loss_kw),
    )


JCFG, TCFG = _cfg(jconf), _cfg(tconf)


@pytest.fixture(scope="module")
def weights():
    tree = perturbed(jax_init_radzero(jax.random.PRNGKey(0), JCFG), np.random.default_rng(0))
    return tree


def _batch(seed=1, b=3, s_per=2, l=10, dedup=False):
    rng = np.random.default_rng(seed)
    s = b * s_per
    u = s - 2 if dedup else s
    ids = np.full((u, l), 1, np.int32)
    mask = np.zeros((u, l), np.int32)
    for i in range(u):
        k = int(rng.integers(4, l + 1))
        ids[i, :k] = rng.integers(3, 211, k)
        ids[i, 0], ids[i, k - 1] = 0, 2
        mask[i, :k] = 1
    row_mask = np.ones(s, np.float32)
    row_mask[-1] = 0.0  # one padding row
    batch = {
        "pixel_values": rng.standard_normal((b, 56, 56, 3)).astype(np.float32),
        "input_ids": ids, "attention_mask": mask,
        "group_map": np.repeat(np.arange(b), s_per).astype(np.int32),
        "row_mask": row_mask,
    }
    if dedup:  # two duplicated sentences: their gradients add up in the gather
        batch["row_gather"] = np.array([0, 1, 2, 3, 1, 0], np.int32)[:s]
    return batch


def _to_torch(batch):
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(v)
        out[k] = t.long() if v.dtype == np.int32 else t
    return out


def _split(tree):
    return ({k: v for k, v in tree.items() if k in TRAINABLE},
            {k: v for k, v in tree.items() if k not in TRAINABLE})


def _port_value_and_grads(params, cfg, batch):
    trainable, frozen = toptim.partition_params(params, TRAINABLE)
    leaves = toptim.tree_leaves(trainable)
    for p in leaves:
        p.requires_grad_(True)
    out = forward_train(toptim.merge_params(trainable, frozen), cfg, batch,
                        stop_vision_gradient=True)
    out["losses"]["loss"].backward()
    return out, trainable


@pytest.mark.parametrize("dedup", [False, True])
def test_forward_train_matches_jax(weights, dedup):
    """Losses and the whole gradient tree of the trainable modules against
    jax.value_and_grad of the JAX forward_train (eager towers, fused VL-CABS
    loss on both sides), rtol 1e-4 / atol 1e-5."""
    batch = _batch(dedup=dedup)
    jtrain, jfrozen = _split(weights)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(trainable):
        out = jax_forward_train({**trainable, **jfrozen}, JCFG, jbatch,
                                stop_vision_gradient=True)
        return out["losses"]["loss"], out["losses"]

    (_, ref_losses), ref_grads = jax.value_and_grad(loss_fn, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, jtrain))
    out, trainable = _port_value_and_grads(params_from_jax(weights), TCFG, _to_torch(batch))
    for name in ("loss", "t2i_loss", "radzero_loss"):
        np.testing.assert_allclose(out["losses"][name].item(), np.asarray(ref_losses[name]),
                                   rtol=1e-5, atol=1e-6)
    assert out["vision_tokens"].shape == (3, 17, D)
    ref = dict(_leaves(params_to_numpy(params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                                              ref_grads)))))
    got = {path: p.grad.numpy() for path, p in _leaves(trainable)}
    assert sorted(got) == sorted(ref)
    for path in ref:
        np.testing.assert_allclose(got[path], ref[path], rtol=1e-4, atol=1e-5, err_msg=path)


def test_forward_train_mlp_adapter_matches_jax():
    """The mlp align adapter under training: loss and the gradient tree of the
    trainable modules against jax.value_and_grad, rtol 2e-4 / atol 1e-5."""
    jcfg, tcfg = (dataclasses.replace(c, align=m.AlignConfig(hidden_size=D, model_type="mlp"))
                  for c, m in ((JCFG, jconf), (TCFG, tconf)))
    tree = perturbed(jax_init_radzero(jax.random.PRNGKey(4), jcfg), np.random.default_rng(4))
    batch = _batch(seed=5)
    jtrain, jfrozen = _split(tree)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(trainable):
        return jax_forward_train({**trainable, **jfrozen}, jcfg, jbatch,
                                 stop_vision_gradient=True)["losses"]["loss"]

    ref_loss, ref_grads = jax.value_and_grad(loss_fn)(jax.tree_util.tree_map(jnp.asarray, jtrain))
    out, trainable = _port_value_and_grads(params_from_jax(tree), tcfg, _to_torch(batch))
    np.testing.assert_allclose(out["losses"]["loss"].item(), np.asarray(ref_loss), rtol=1e-5,
                               atol=1e-6)
    ref = dict(_leaves(params_to_numpy(params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                                              ref_grads)))))
    got = {path: p.grad.numpy() for path, p in _leaves(trainable)}
    assert sorted(got) == sorted(ref) and any("/fc3/" in path for path in got)
    for path in ref:
        np.testing.assert_allclose(got[path], ref[path], rtol=2e-4, atol=1e-5, err_msg=path)


def test_forward_train_fused_kernels_match_eager_loss(weights):
    """train_impl="fused" (K10-K12 twins) against train_impl="xla" (autograd
    through the eager VL-CABS) inside the port."""
    batch = _to_torch(_batch(seed=4))
    xla_cfg = dataclasses.replace(TCFG, loss=dataclasses.replace(TCFG.loss, train_impl="xla"))
    out_f, tr_f = _port_value_and_grads(params_from_jax(weights), TCFG, batch)
    out_x, tr_x = _port_value_and_grads(params_from_jax(weights), xla_cfg, batch)
    np.testing.assert_allclose(out_f["losses"]["loss"].item(), out_x["losses"]["loss"].item(),
                               rtol=1e-5, atol=1e-6)
    for (path, a), (_, b) in zip(_leaves(tr_f), _leaves(tr_x)):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=path)


def test_forward_train_handles_tower_tokens_and_clip_losses():
    """``tower_tokens`` skips the tower with the same result, and the CLIP /
    SigLIP heads (text projected to 2 * hidden, as their configs do) give
    the JAX losses."""
    from radzero_tpu.models.vit import vit_forward as jax_vit_forward

    def cfg(m):
        base = _cfg(m)
        return dataclasses.replace(
            base, text=dataclasses.replace(base.text, use_text_projection=True))

    jcfg, tcfg = cfg(jconf), cfg(tconf)
    names = ("RadZeroLoss", "OpenClipLoss", "OpenSigLipLoss")
    tree = perturbed(jax_init_radzero(jax.random.PRNGKey(2), jcfg, loss_apply=names),
                     np.random.default_rng(2))
    batch = _batch(seed=5)
    batch["random_input_ids"] = batch["input_ids"][::2].copy()
    batch["random_attention_mask"] = batch["attention_mask"][::2].copy()
    ratio = {"RadZeroLoss": 1.0, "OpenClipLoss": 0.5, "OpenSigLipLoss": 0.25}
    ref = jax_forward_train(tree, jcfg, {k: jnp.asarray(v) for k, v in batch.items()},
                            loss_ratio=ratio, stop_vision_gradient=True)["losses"]
    params = params_from_jax(tree)
    with torch.no_grad():
        out = forward_train(params, tcfg, _to_torch(batch), loss_ratio=ratio,
                            stop_vision_gradient=True)["losses"]
        tokens = jax_vit_forward(tree["vision_model"], jcfg.vision,
                                 jnp.asarray(batch["pixel_values"]))
        cached = {k: v for k, v in _to_torch(batch).items() if k != "pixel_values"}
        cached["tower_tokens"] = torch.from_numpy(np.array(tokens))
        out_cached = forward_train(params, tcfg, cached, loss_ratio=ratio)["losses"]
    assert sorted(out) == sorted(ref)
    for name in ref:
        np.testing.assert_allclose(out[name].item(), np.asarray(ref[name]), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(out_cached[name].item(), out[name].item(), rtol=1e-5,
                                   atol=1e-5)


def _with_impls(cfg, attn_impl, fuse_post, text_attn_impl="xla"):
    return dataclasses.replace(
        cfg, align=dataclasses.replace(cfg.align, attn_impl=attn_impl),
        text=dataclasses.replace(cfg.text, fuse_post=fuse_post, attn_impl=text_attn_impl))


def test_forward_train_raises_for_missing_backward_kernels(weights):
    """No backward kernel is missing any more: fused_vjp / packed align layers
    and fuse_post=True train, and loss and every gradient match the eager
    configuration (2e-4 on the align leaves, 5e-4 on the text leaves, the JAX
    suite's tolerances for these layers). Without a tape the default runs too."""
    batch = _to_torch(_batch(seed=7))
    ref_out, ref_tr = _port_value_and_grads(params_from_jax(weights), TCFG, batch)
    ref = {path: p.grad.numpy() for path, p in _leaves(ref_tr)}
    for impl, fuse_post in (("fused_vjp", True), ("packed", False)):
        out, tr = _port_value_and_grads(params_from_jax(weights),
                                        _with_impls(TCFG, impl, fuse_post), batch)
        np.testing.assert_allclose(out["losses"]["loss"].item(),
                                   ref_out["losses"]["loss"].item(), rtol=1e-5, atol=1e-6)
        for path, p in _leaves(tr):
            tol = 5e-4 if path.startswith("/text_model") else 2e-4
            np.testing.assert_allclose(p.grad.numpy(), ref[path], rtol=tol, atol=tol,
                                       err_msg=f"{impl} {path}")
    params = params_from_jax(weights)
    default = _with_impls(TCFG, "fused_vjp", True)
    losses = make_eval_step(default, dtype=torch.float32, device="cpu")(params, batch)
    with pytest.raises(ValueError, match="lies on"):  # the card is the default
        make_eval_step(default, dtype=torch.float32)(params, batch)
    np.testing.assert_allclose(losses["loss"].item(), ref_out["losses"]["loss"].item(),
                               rtol=1e-5, atol=1e-6)


def test_forward_train_trainable_tower_matches_jax(weights):
    """The vision tower in the trainable subtree (2 layers): its gradients
    flow through the K1-K3 / K6-K8 Functions (the JAX side: attn_impl=
    "fused_vjp" in the tower and the align layers, fuse_post=True), every
    leaf against jax.grad at 2e-4 (5e-4 for the text tower)."""
    batch = _batch(seed=9)
    jcfg = dataclasses.replace(_with_impls(JCFG, "fused_vjp", True),
                               vision=dataclasses.replace(JCFG.vision, attn_impl="fused_vjp"))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(params):
        return jax_forward_train(params, jcfg, jbatch)["losses"]["loss"]

    ref_loss, ref_grads = jax.value_and_grad(loss_fn)(jax.tree_util.tree_map(jnp.asarray, weights))
    params = params_from_jax(weights)
    leaves = toptim.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    out = forward_train(params, _with_impls(TCFG, "fused_vjp", True), _to_torch(batch))
    out["losses"]["loss"].backward()
    np.testing.assert_allclose(out["losses"]["loss"].item(), np.asarray(ref_loss), rtol=1e-5,
                               atol=1e-6)
    ref = dict(_leaves(params_to_numpy(params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                                              ref_grads)))))
    got = {path: p.grad.numpy() for path, p in _leaves(params) if p.grad is not None}
    assert any(path.startswith("/vision_model/layers") for path in got)
    for path, g in got.items():
        tol = 5e-4 if path.startswith("/text_model") else 2e-4
        np.testing.assert_allclose(g, ref[path], rtol=tol, atol=tol, err_msg=path)


# ---------------------------------------------------------------------------
# optimizer against optax
# ---------------------------------------------------------------------------

def _opt_tree(rng):
    def a(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return {
        "text_model": {"embeddings": {"word": a(7, 4), "ln": {"scale": a(4), "bias": a(4)}},
                       "layers": {"attn": {"q": {"kernel": a(2, 4, 4), "bias": a(2, 4)}},
                                  "ln_out": {"scale": a(2, 4), "bias": a(2, 4)}}},
        "loss_fns": {"RadZeroLoss": {"log_loss_temperature": a(1),
                                     "layer_norm": {"scale": a(4), "bias": a(4)}}},
    }


def test_decay_mask_matches_jax():
    tree = _opt_tree(np.random.default_rng(0))
    assert toptim.decay_mask(tree) == joptim.decay_mask(tree)
    tree["text_model"]["layers"] = [tree["text_model"]["layers"]] * 2  # the port's lists
    mask = toptim.decay_mask(tree)
    assert mask["text_model"]["layers"][1]["attn"]["q"] == {"kernel": True, "bias": False}
    assert mask["text_model"]["layers"][0]["ln_out"] == {"scale": False, "bias": False}


@pytest.mark.parametrize("accum,bf16_moments", [(1, False), (2, False), (1, True)])
def test_adamw_matches_optax(accum, bf16_moments):
    """Identical numpy gradients through optax (the JAX package's
    build_optimizer) and the port for 5 updates; parameters within 1e-6.
    Gradient scales put the global norm on both sides of the clip."""
    rng = np.random.default_rng(3)
    tree = _opt_tree(rng)
    kw = dict(learning_rate=1e-2, weight_decay=0.05, max_grad_norm=1.0, warmup_steps=2,
              total_steps=5, gradient_accumulation_steps=accum, bf16_moments=bf16_moments)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    tx, _ = joptim.build_optimizer(jparams, **kw)
    jstate = tx.init(jparams)
    import optax

    tparams = jax.tree_util.tree_map(lambda x: torch.from_numpy(x.copy()), tree)
    opt, _ = toptim.build_optimizer(**kw)
    tstate = opt.init(tparams)
    for step in range(5 * accum):
        scale = (0.01, 3.0, 0.02, 5.0, 1.0)[step % 5]
        grads = jax.tree_util.tree_map(
            lambda x: (scale * rng.standard_normal(x.shape)).astype(np.float32), tree)
        updates, jstate = tx.update(jax.tree_util.tree_map(jnp.asarray, grads), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        tstate = opt.update(jax.tree_util.tree_map(torch.from_numpy, grads), tstate, tparams)
    assert tstate["count"] == 5
    ref = dict(_leaves(jax.tree_util.tree_map(np.asarray, jparams)))
    for path, p in _leaves(tparams):
        np.testing.assert_allclose(p.numpy(), ref[path], rtol=1e-6, atol=1e-6, err_msg=path)
    if bf16_moments:
        assert all(m.dtype == torch.bfloat16 for m in tstate["mu"])
        assert all(v.dtype == torch.float32 for v in tstate["nu"])


def test_warmup_cosine_schedule_matches_optax():
    """lr at update 0 (zero), 1, the end of the warmup, mid-decay and the end."""
    ref = joptim.warmup_cosine_schedule(3e-4, 10, 100)
    sched = toptim.warmup_cosine_schedule(3e-4, 10, 100)
    assert sched(0) == 0.0
    for count in (0, 1, 9, 10, 11, 55, 99, 100, 150):
        np.testing.assert_allclose(sched(count), float(ref(count)), rtol=1e-6, atol=1e-6 * 3e-4)
    # warmup_steps=0 behaves as 1, as in the JAX package
    np.testing.assert_allclose(toptim.warmup_cosine_schedule(1e-3, 0, 10)(1),
                               float(joptim.warmup_cosine_schedule(1e-3, 0, 10)(1)), rtol=1e-6)


# ---------------------------------------------------------------------------
# train step trajectory
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("attn_impl,fuse_post", [("xla", False), ("fused_vjp", True),
                                                 ("flash", True)],
                         ids=["eager", "defaults", "flash"])
def test_train_step_trajectory_matches_jax(weights, attn_impl, fuse_post):
    """4 steps on one batch against the JAX make_train_step (fp32, no
    donation), with eager layers, at the defaults (fused_vjp align layers,
    fuse_post=True: the backward kernels' twins against the JAX kernels) and
    with attn_impl="flash" in the align layers and the text tower (K13-K16
    twins against the JAX kernels): losses and grad_norm rtol 1e-4. Parameters are held to a
    tolerance scaled by the learning rate: an early Adam update is about
    lr * sign(g) whatever |g| is, so an element whose gradient is near zero
    may step the other way in the two frameworks and then differ by 2 lr
    per step; the bulk must agree far better (mean below lr / 100)."""
    lr, steps = 1e-3, 4
    kw = dict(learning_rate=lr, weight_decay=0.05, max_grad_norm=1.0, warmup_steps=1,
              total_steps=steps)
    batch = _batch(seed=8)
    jtrain, jfrozen = _split(jax.tree_util.tree_map(jnp.asarray, weights))
    tx, _ = joptim.build_optimizer(jtrain, **kw)
    text_attn = "flash" if attn_impl == "flash" else "xla"
    jcfg, tcfg = (_with_impls(c, attn_impl, fuse_post, text_attn) for c in (JCFG, TCFG))
    jstep = jax_make_train_step(jcfg, tx, dtype=jnp.float32, donate=False)
    jstate = tx.init(jtrain)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    trainable, frozen = toptim.partition_params(params_from_jax(weights), TRAINABLE)
    opt, _ = toptim.build_optimizer(**kw)
    tstate = opt.init(trainable)
    tstep = make_train_step(tcfg, opt, dtype=torch.float32, device="cpu")
    tbatch = _to_torch(batch)
    history = []
    for _ in range(steps):
        jtrain, jstate, jl = jstep(jtrain, jfrozen, jstate, jbatch)
        trainable, tstate, tl = tstep(trainable, frozen, tstate, tbatch)
        assert sorted(tl) == sorted(jl)
        for name in jl:
            np.testing.assert_allclose(tl[name].item(), np.asarray(jl[name]), rtol=1e-4,
                                       atol=1e-6, err_msg=name)
        history.append(tl["loss"].item())
    assert history[0] == pytest.approx(history[1], rel=1e-6)  # update 0 runs at lr 0
    assert history[-1] < history[1]
    assert not any(p.requires_grad for p in toptim.tree_leaves(trainable))
    ref = dict(_leaves(params_to_numpy(params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                                              jtrain)))))
    diffs = []
    for path, p in _leaves(trainable):
        diff = np.abs(p.numpy() - ref[path])
        assert diff.max() <= 2 * lr * (steps - 1) + 1e-6, path
        diffs.append(diff.ravel())
    assert np.concatenate(diffs).mean() < lr / 100
