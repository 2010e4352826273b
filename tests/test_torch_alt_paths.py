"""The alternate towers through LoRA, remat and export, the port against the
JAX package on the CPU, fp32, at tests/test_torch_alt_composite.py's widths
(its ``_cfgs`` / ``_weights`` / ``_batch``).

- LoRA (``radzero_torch/train/lora.py``) on SAM, MAE and BiomedCLIP towers
  for five target lists: ``init_lora`` gives the JAX ``init_lora``'s keys
  and shapes (none under SAM's ``vision_model/layers``: the JAX tree keeps
  SAM's layers as a list, which the JAX walk never enters); ``merge_lora`` of
  the bridged adapters (``lora_from_jax``, B drawn off zero) equals
  ``params_from_jax`` of the JAX merge leaf for leaf at 1e-6; the merged
  loss and every adapter gradient (the towers trained through their
  adapters) against ``jax.value_and_grad`` at rtol 2e-4 / atol 1e-5 (a list
  that yields no adapter, ``["qkv", "proj"]`` here, merges to the base tree);
- LoRA on a SAM composite over a gloo model group of two (``{data: 1,
  model: 2}``, ``merge_lora(tp=, specs=)``): at init the merged loss is the
  base's bit for bit, and the loss and each adapter gradient, bit-equal on
  both ranks, against the JAX package at the same gate;
- ``forward_train(remat=True)`` with SAM and MAE towers: the loss and the
  trainable gradient tree against the JAX ``forward_train(remat=True)`` at
  rtol 2e-4 / atol 1e-5;
- ``export_zero_shot(device="cpu")`` with SAM, BiomedCLIP and SigLIP towers:
  the loaded program bit-equal to the port's ``compute_logits``, and within
  the repo's gate of the JAX ``compute_logits`` (logits rtol 1e-3 / atol
  2e-4, map MAE < 1e-3; tests/test_torch_export.py).

The JAX side runs its eager align layer and MPNet chain, the port the plain
versions of K1-K4 and K6-K9. The model group's ranks are fresh interpreters
running this file (``run_ranks`` of tests/test_torch_parallel.py); they
import no JAX.
"""

import os

import numpy as np
import pytest
import torch

from radzero_torch.models.from_jax import lora_from_jax, params_from_jax, params_to_numpy
from radzero_torch.models.radzero import compute_logits, forward_train
from radzero_torch.parallel import tensor_parallel as tpar
from radzero_torch.train.lora import init_lora, lora_trainable, merge_lora, with_trainable
from radzero_torch.utils.tree import tree_leaves

from test_torch_parallel import rank_main, run_ranks

TARGETS = {"layers": ["layers"], "qkvo": ["q", "k", "v", "o"], "mlp": ["fc1", "fc2"],
           "qkv_proj": ["qkv", "proj"], "attn": ["attn"]}
TP_TARGETS = ["attn/q", "attn/v", "mlp/fc1", "patch_embed"]  # tests/test_torch_tp_paths.py's
TRAINABLE = ("align_transformer", "text_model", "loss_fns")
MODEL = 2


def _jax_lora(tree, targets, seed):
    """The JAX init_lora on ``tree`` with every b drawn off zero (numpy)."""
    import jax

    from radzero_tpu.train import lora as jlora

    lora = jlora.init_lora(jax.random.PRNGKey(seed), tree, targets, r=4, alpha=8)
    rng = np.random.default_rng(seed)
    adapters = {k: {"a": np.asarray(ab["a"]),
                    "b": (0.05 * rng.standard_normal(ab["b"].shape)).astype(np.float32)}
                for k, ab in lora["adapters"].items()}
    return {**lora, "adapters": adapters}


def _shapes(adapters):
    return {k: (tuple(ab["a"].shape), tuple(ab["b"].shape)) for k, ab in adapters.items()}


def _jax_lora_loss(tree, jcfg, lora, batch):
    """The JAX merged loss and its gradient over the adapters."""
    import jax
    import jax.numpy as jnp

    from radzero_tpu.models.radzero import forward_train as jax_forward_train
    from radzero_tpu.train import lora as jlora

    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss(tr):
        merged = jlora.merge_lora(jparams, jlora.with_trainable(lora, tr))
        return jax_forward_train(merged, jcfg, jbatch)["losses"]["loss"]

    value, grads = jax.value_and_grad(loss)(
        jax.tree_util.tree_map(jnp.asarray, jlora.lora_trainable(lora)))
    return float(value), {k: {n: np.asarray(g) for n, g in ab.items()}
                          for k, ab in grads["adapters"].items()}


def _lora_loss(params, cfg, lora, batch, tp=None, specs=None):
    """The port's merged loss and its adapters' gradients {key: {"a", "b"}}."""
    tr = {"adapters": {k: {n: t.clone().requires_grad_(True) for n, t in ab.items()}
                       for k, ab in lora_trainable(lora)["adapters"].items()}}
    merged = merge_lora(params, with_trainable(lora, tr), tp=tp, specs=specs)
    loss = forward_train(merged, cfg, batch, tp=tp)["losses"]["loss"]
    leaves = [t for ab in tr["adapters"].values() for t in ab.values()]
    grads = torch.autograd.grad(loss, leaves) if leaves else ()
    it = iter(grads)
    return loss.detach(), {k: {n: next(it) for n in ab} for k, ab in tr["adapters"].items()}


def _grad_gate(got, ref, label):
    assert sorted(got) == sorted(ref), (label, sorted(got), sorted(ref))
    for k, ab in ref.items():
        for n, r in ab.items():
            assert np.abs(r).max() > 0, (label, k, n)
            np.testing.assert_allclose(got[k][n].numpy(), r, rtol=2e-4, atol=1e-5,
                                       err_msg=f"{label}: {k} {n}")


def _walk_close(got, ref, path=""):
    if isinstance(ref, dict):
        assert sorted(got) == sorted(ref), path
        for key in ref:
            _walk_close(got[key], ref[key], f"{path}/{key}")
    elif isinstance(ref, list):
        assert len(got) == len(ref), path
        for i, (x, y) in enumerate(zip(got, ref)):
            _walk_close(x, y, f"{path}/{i}")
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6, err_msg=path)


# ---------------------------------------------------------------------------
# LoRA without a model group
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("targets", sorted(TARGETS))
@pytest.mark.parametrize("vision", ["sam", "mae", "biomedclip"])
def test_lora_with_alternate_towers_matches_jax(vision, targets):
    """init_lora's keys and shapes are the JAX init_lora's (SAM's layers get
    none); merge_lora of the JAX adapters (B off zero) is the JAX merge leaf
    for leaf; the merged loss and each adapter gradient against
    jax.value_and_grad, the towers trained through their adapters. A target
    list that yields no adapter merges to the base tree bit for bit."""
    import jax
    import jax.numpy as jnp

    from radzero_tpu.train import lora as jlora
    from test_torch_alt_composite import _batch, _cfgs, _weights

    names = TARGETS[targets]
    jcfg, tcfg = _cfgs(vision)
    tree, params = _weights(jcfg, 20)
    want = jlora.init_lora(jax.random.PRNGKey(3), tree, names, r=4, alpha=8)
    got = init_lora(torch.Generator().manual_seed(3), params, names, r=4, alpha=8)
    assert _shapes(got["adapters"]) == _shapes(want["adapters"])
    assert (got["r"], got["alpha"]) == (4, 8)
    if vision == "sam":
        assert not any(k.startswith("vision_model/layers") for k in got["adapters"])
    assert all(not ab["b"].any() for ab in got["adapters"].values())

    jl = _jax_lora(tree, names, 21)
    ref = params_to_numpy(params_from_jax(jax.tree_util.tree_map(np.asarray, jlora.merge_lora(
        jax.tree_util.tree_map(jnp.asarray, tree), jax.tree_util.tree_map(jnp.asarray, jl)))))
    lora = lora_from_jax(jl)
    merged = merge_lora(params, lora)
    _walk_close(params_to_numpy(merged), ref)
    if not want["adapters"]:  # e.g. ["qkv", "proj"]: no adapter, so no gradient to hold
        assert all(torch.equal(x, y) for x, y in zip(tree_leaves(merged), tree_leaves(params)))
        return

    batch = _batch(22)
    ref_loss, ref_grads = _jax_lora_loss(tree, jcfg, jl, batch)
    loss, grads = _lora_loss(params, tcfg, lora, {k: torch.from_numpy(v)
                                                  for k, v in batch.items()})
    np.testing.assert_allclose(loss.item(), ref_loss, rtol=2e-4, atol=1e-5)
    _grad_gate(grads, ref_grads, f"{vision} {names}")


# ---------------------------------------------------------------------------
# LoRA on a SAM composite over a model group of two
# ---------------------------------------------------------------------------

def _sam_lora_rank(group, out, inputs_path):
    """One rank of {data: 1, model: 2}: the merged loss at init against the
    base's, then the loss and the adapters' gradients; results to
    out/rank{r}.pt."""
    from radzero_torch.parallel.dist import mesh_groups

    inputs = torch.load(inputs_path, weights_only=False)
    r = torch.distributed.get_rank()
    _, tp = mesh_groups(1, MODEL)
    cfg, params = inputs["cfg"], inputs["params"]
    share = tpar.shard_params(params, r, MODEL)
    specs = tpar.param_specs(params, MODEL)
    batch = {k: torch.from_numpy(v) for k, v in inputs["batch"].items()}
    lora0 = {**inputs["lora"], "adapters": {k: {"a": ab["a"], "b": torch.zeros_like(ab["b"])}
                                            for k, ab in inputs["lora"]["adapters"].items()}}
    with torch.no_grad():
        base = forward_train(share, cfg, batch, tp=tp)["losses"]["loss"]
        at_init = forward_train(merge_lora(share, lora0, tp=tp, specs=specs), cfg, batch,
                                tp=tp)["losses"]["loss"]
    loss, grads = _lora_loss(share, cfg, inputs["lora"], batch, tp=tp, specs=specs)
    torch.save({"base": base, "at_init": at_init, "loss": loss, "grads": grads},
               os.path.join(out, f"rank{r}.pt"))


MODES = {"sam_lora": _sam_lora_rank}


def test_lora_on_a_sam_composite_over_a_model_group(tmp_path):
    """LoRA on tests/test_torch_tp_paths.py's targets over {data: 1, model: 2}
    with a SAM tower (its MLP split over the group, its qkv and proj whole,
    its layers without adapters): at init the merged loss equals the base
    loss bit for bit; the loss and every adapter gradient, the same bits on
    both ranks, against jax.value_and_grad of the JAX merge at rtol 2e-4 /
    atol 1e-5, and against the port's one process at the same gate."""
    from test_torch_alt_composite import _batch, _cfgs, _weights

    jcfg, tcfg = _cfgs("sam")
    tree, params = _weights(jcfg, 23)
    jl = _jax_lora(tree, TP_TARGETS, 24)
    lora = lora_from_jax(jl)
    assert "vision_model/patch_embed/kernel" in lora["adapters"]
    assert not any(k.startswith("vision_model/layers") for k in lora["adapters"])
    specs = tpar.param_specs(params, MODEL)
    assert specs["vision_model"]["layers"][0]["mlp"]["fc1"]["kernel"] == (None, "model")
    batch = _batch(25)
    torch.save({"cfg": tcfg, "params": params, "lora": lora, "batch": batch},
               tmp_path / "inputs.pt")
    res_dir = run_ranks(tmp_path, __file__, "sam_lora", world=MODEL, timeout_s=600,
                        args=(tmp_path / "inputs.pt",))
    ranks = [torch.load(res_dir / f"rank{r}.pt", weights_only=False) for r in range(MODEL)]
    ref_loss, ref_grads = _jax_lora_loss(tree, jcfg, jl, batch)
    one_loss, one_grads = _lora_loss(params, tcfg, lora,
                                     {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(one_loss.item(), ref_loss, rtol=2e-4, atol=1e-5)
    for r, res in enumerate(ranks):
        assert torch.equal(res["at_init"], res["base"]), (r, res["at_init"], res["base"])
        assert torch.equal(res["loss"], ranks[0]["loss"]), r
        for k, ab in res["grads"].items():
            for n, g in ab.items():
                assert torch.equal(g, ranks[0]["grads"][k][n]), (r, k, n)
        np.testing.assert_allclose(res["loss"].item(), ref_loss, rtol=2e-4, atol=1e-5)
        _grad_gate(res["grads"], ref_grads, f"rank {r} vs JAX")
        _grad_gate(res["grads"], {k: {n: g.numpy() for n, g in ab.items()}
                                  for k, ab in one_grads.items()}, f"rank {r} vs one process")


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vision", ["sam", "mae"])
def test_remat_with_alternate_towers_matches_jax(vision):
    """forward_train(remat=True), the tower frozen: the loss and the gradient
    tree of the trainable modules (align layers under save_attn, MPNet's
    checkpointed layers) against jax.value_and_grad of the JAX
    forward_train(remat=True)."""
    import jax
    import jax.numpy as jnp

    from radzero_tpu.models.radzero import forward_train as jax_forward_train
    from radzero_torch.train import optim as toptim
    from test_torch_alt_composite import _batch, _cfgs, _weights
    from test_torch_train import _leaves

    jcfg, tcfg = _cfgs(vision)
    tree, params = _weights(jcfg, 26)
    batch = _batch(27)
    jtrain = {k: v for k, v in tree.items() if k in TRAINABLE}
    jfrozen = {k: v for k, v in tree.items() if k not in TRAINABLE}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(trainable):
        return jax_forward_train({**trainable, **jfrozen}, jcfg, jbatch, remat=True,
                                 stop_vision_gradient=True)["losses"]["loss"]

    ref_loss, ref_grads = jax.value_and_grad(loss_fn)(jax.tree_util.tree_map(jnp.asarray,
                                                                              jtrain))
    trainable, frozen = toptim.partition_params(params, TRAINABLE)
    for p in toptim.tree_leaves(trainable):
        p.requires_grad_(True)
    out = forward_train(toptim.merge_params(trainable, frozen), tcfg,
                        {k: torch.from_numpy(v) for k, v in batch.items()}, remat=True,
                        stop_vision_gradient=True)
    out["losses"]["loss"].backward()
    np.testing.assert_allclose(out["losses"]["loss"].item(), np.asarray(ref_loss), rtol=2e-4,
                               atol=1e-5)
    ref = dict(_leaves(params_to_numpy(params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                                              ref_grads)))))
    got = {path: p.grad.numpy() for path, p in _leaves(trainable)}
    assert sorted(got) == sorted(ref)
    for path in ref:
        np.testing.assert_allclose(got[path], ref[path], rtol=2e-4, atol=1e-5, err_msg=path)


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vision", ["sam", "biomedclip", "siglip"])
def test_export_with_alternate_towers_matches_port_and_jax(vision, tmp_path):
    """export_zero_shot on the CPU, loaded by load_zero_shot: logits and maps
    bit-equal to the port's compute_logits on the same inputs, and within the
    repo's gate of the JAX compute_logits."""
    from radzero_torch.eval.export import export_zero_shot, load_zero_shot
    from radzero_tpu.models.radzero import compute_logits as jax_compute_logits
    from test_torch_alt_composite import _cfgs, _logits_gate, _text, _weights

    jcfg, tcfg = _cfgs(vision)
    tree, params = _weights(jcfg, 28)
    bundle = export_zero_shot(params, tcfg, str(tmp_path / "bundle"), batch_size=2,
                              n_prompts=3, max_tokens=8, dtype=torch.float32, device="cpu")
    runner, meta = load_zero_shot(bundle)
    assert meta["batch_size"] == 2 and meta["img_size"] == 32 and meta["device"] == "cpu"
    pv = np.random.default_rng(29).standard_normal((2, 32, 32, 3)).astype(np.float32)
    ids, mask = _text(30)
    args = (torch.from_numpy(pv), torch.from_numpy(ids), torch.from_numpy(mask))
    logits, scores = runner(*args)
    ref = compute_logits(params, tcfg, *args)
    l_maps = 15 if vision == "siglip" else 16
    assert logits.shape == (2, 3) and scores.shape == (2, 3, l_maps)
    assert torch.equal(logits, ref["logits"]), (logits - ref["logits"]).abs().max()
    assert torch.equal(scores, ref["similarity_scores"]), (
        (scores - ref["similarity_scores"]).abs().max())
    _logits_gate({"logits": logits, "similarity_scores": scores},
                 jax_compute_logits(tree, jcfg, pv, ids, mask))


if __name__ == "__main__":
    rank_main(MODES)
