"""The sanity harness of the port (``radzero_torch/tools/sanity_train.py``) and
the examples of its token filter study against the JAX tools' recipes
(``tools/sanity_train.py``, ``tools/token_filter_study.py``)
on the CPU, fp32, at the JAX tools' configuration (D = 64, 4 heads of 16, two
layers a tower, 56 px images, batch 32).

The weights are the JAX ``init_radzero`` tree through the bridge
(``models/from_jax.py``); both sides draw their examples from
``np.random.default_rng(0)`` with their own tool's ``make_example`` (which
must give the same arrays and sentences). Five steps' losses are held at
rtol 5e-4, then the 64 held-out examples' logits at rtol 1e-3 / atol 2e-4 and
their maps at a mean absolute error below 1e-3 (the token filter study's
table: ``test_torch_tools_filter.py``). The JAX side runs its kernels as its own
CPU tests do (Pallas in interpret mode); the port's wrappers their plain twins.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from radzero_torch.models.from_jax import params_from_jax
from radzero_torch.tools import sanity_train as tst
from radzero_torch.tools import token_filter_study as ttf
from radzero_torch.utils.tree import tree_leaves
from radzero_tpu.data.tokenizer import WhitespaceHashTokenizer
from radzero_tpu.models import configuration as jc
from radzero_tpu.models.radzero import compute_logits as jax_compute_logits
from radzero_tpu.models.radzero import init_radzero as jax_init_radzero
from radzero_tpu.train.optim import build_optimizer, partition_params
from radzero_tpu.train.step import make_train_step
from tools import sanity_train as jst
from tools import token_filter_study as jtf

STEPS, BATCH, LR = 5, 32, 3e-4
LOSS_RTOL, LOGITS_RTOL, LOGITS_ATOL, MAP_MAE = 5e-4, 1e-3, 2e-4, 1e-3


def _jax_cfg():
    """The JAX tools' configuration (tools/sanity_train.py:64-72)."""
    d = 64
    return jc.RadZeroConfig(
        vision=jc.ViTConfig(hidden_size=d, num_hidden_layers=2, num_attention_heads=4,
                            mlp_ratio=2.0, patch_size=14, pretrain_img_size=56, img_size=56),
        text=jc.TextConfig(hidden_size=d, num_hidden_layers=2, num_attention_heads=4,
                           intermediate_size=128, vocab_size=30527, max_position_embeddings=40),
        align=jc.AlignConfig(hidden_size=d, num_hidden_layers=2, num_attention_heads=4,
                             mlp_ratio=2.0),
        loss=jc.LossConfig(hidden_dim=d),
    )


@pytest.fixture(scope="module")
def weights():
    return jax.tree_util.tree_map(np.asarray, jax_init_radzero(jax.random.PRNGKey(0),
                                                               _jax_cfg()))


def _jax_run(weights, make, quadrants, ratios=(None,)):
    """The JAX tools' recipe: STEPS steps from rng 0, then compute_logits over 64
    held-out examples (at each filter ratio, the filter before layer 1) ->
    (losses, {ratio: (logits, maps)})."""
    cfg = _jax_cfg()
    tok = WhitespaceHashTokenizer(max_length=12)
    params = jax.tree_util.tree_map(jnp.asarray, weights)
    trainable, frozen = partition_params(params, ["align_transformer", "text_model", "loss_fns"])
    tx, _ = build_optimizer(trainable, learning_rate=LR, warmup_steps=10, total_steps=STEPS)
    opt_state = tx.init(trainable)
    step = make_train_step(cfg, tx, dtype=jnp.float32, donate=False)
    rng = np.random.default_rng(0)
    losses = []
    for _ in range(STEPS):
        imgs, texts = [], []
        for _ in range(BATCH):
            x, t, _ = make(rng)
            imgs.append(x)
            texts.append(t)
        ids, mask = tok(texts, 12)
        batch = {"pixel_values": np.stack(imgs), "input_ids": ids, "attention_mask": mask,
                 "group_map": np.arange(BATCH, dtype=np.int32),
                 "row_mask": np.ones(BATCH, np.float32)}
        trainable, opt_state, out = step(trainable, frozen, opt_state, batch)
        losses.append(float(out["loss"]))
    params = {**trainable, **frozen}
    ids, mask = tok([f"There is opacity in the {q} lung" for q in quadrants], 12)
    imgs = np.stack([make(rng)[0] for _ in range(64)])
    outs = {}
    for ratio in ratios:
        c = cfg if ratio is None else dataclasses.replace(cfg, vision=dataclasses.replace(
            cfg.vision, token_filter_ratio=ratio, token_filter_layer=1))
        out = jax_compute_logits(params, c, imgs, ids, mask, dtype=jnp.float32)
        outs[ratio] = (np.asarray(out["logits"]), np.asarray(out["similarity_scores"]))
    return losses, outs


def _gate(logits, maps, ref_logits, ref_maps, label):
    np.testing.assert_allclose(logits, ref_logits, rtol=LOGITS_RTOL, atol=LOGITS_ATOL,
                               err_msg=label)
    assert np.abs(maps - ref_maps).mean() < MAP_MAE, label


@pytest.mark.parametrize("tool", ["sanity", "token_filter"])
def test_make_example_stream_equals_jax(tool):
    """Each tool's examples from rng 0: the JAX tool's arrays and sentences."""
    port, ref = (tst, jst) if tool == "sanity" else (ttf, jtf)
    assert port.QUADRANTS == ref.QUADRANTS
    a, b = np.random.default_rng(0), np.random.default_rng(0)
    for _ in range(40):
        x, t, q = port.make_example(a)
        rx, rt, rq = ref.make_example(b)
        assert (t, q) == (rt, rq) and x.tobytes() == rx.tobytes()


def test_sanity_steps_and_logits_match_jax(weights):
    """The harness's train / eval_set / score at 4 heads from the JAX weights:
    five losses at rtol 5e-4, then the held-out logits and maps at the suite's
    compute_logits gate, and the accuracies read from them."""
    ref_losses, ref = _jax_run(weights, jst.make_example, jst.QUADRANTS)
    cfg, tok, rng = tst.sanity_config(4), tst.tokenizer(), np.random.default_rng(0)
    trainable, frozen, losses = tst.train(cfg, params_from_jax(weights), rng, tok, steps=STEPS,
                                          batch=BATCH, lr=LR, device="cpu")
    np.testing.assert_allclose(losses, ref_losses, rtol=LOSS_RTOL)
    imgs, labels = tst.eval_set(rng)
    retrieval, pointing, logits, maps = tst.score({**trainable, **frozen}, cfg, imgs, labels,
                                                  tok, "cpu")
    _gate(logits, maps, *ref[None], "sanity")
    assert logits.shape == (64, 4) and maps.shape == (64, 4, 16)
    assert retrieval == np.mean(logits.argmax(1) == np.asarray(labels))
    assert 0.0 <= pointing <= 1.0
    assert not any(p.requires_grad for p in tree_leaves(trainable))


def test_run_records_the_jax_tool_keys():
    """run() at 2 steps on the CPU at 1 head (the card's configuration): the JAX
    tool's keys and the device."""
    rec = tst.run(steps=2, batch=8, heads=1, device="cpu")
    assert set(rec) == {"first_loss", "last_loss", "retrieval_accuracy", "pointing_accuracy",
                        "chance", "device"}
    assert rec["device"] == "cpu" and rec["chance"] == 0.25
    assert np.isfinite(rec["first_loss"]) and np.isfinite(rec["last_loss"])
