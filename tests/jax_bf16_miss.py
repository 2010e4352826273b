"""How far the JAX package's bf16 training gradient lies from its fp32 one, leaf
by leaf, at one shape, on the CPU; the counterpart of chip_smoke.py phase 14's
port measurement on the card (``bf16_miss``), which uses the same shape and
the same batch (chip_smoke.py's ``miss_batch``, drawn with numpy from
``--seed``) and the same per-leaf measure (``grad_misses``, ``miss_summary``).

    JAX_PLATFORMS=cpu python tests/jax_bf16_miss.py [--seed 0] [--json OUT] [--port_cpu]

The shape (chip_smoke.py's ``MISS_SHAPE``): the flagship widths
and depths (ViT-B/14 tower, 2 align layers, MPNet 12 x 768) at 224 px (257
tokens), 8 images x 8 sentences x 32 tokens (2048 text rows), the tower
frozen. The JAX side runs its default routes, whose Pallas kernels run in
interpret mode on the CPU (their arithmetic: bf16 operands, fp32
accumulation, as on the TPU). Weights: the JAX ``init_radzero`` from
``PRNGKey(seed)`` (the card's run draws the port's own; the two are compared
as distributions). The gradients are moved into the port's layout through
``radzero_torch/models/from_jax.py`` (layers unstacked, q / k / v packed), so
both print the same leaf paths. For each trainable leaf whose fp32 gradient
reaches 1e-7: rms(g_bf16 - g_fp32) / rms(g_fp32); the summary gives the
worst leaves and the worst and median over MPNet's bias and LayerNorm leaves.
``--port_cpu`` also takes the port's fp32 and bf16 gradients from the same
weights on the CPU (its kernels' plain twins) against the JAX fp32 one (slow:
the port's bf16 on the CPU, several minutes).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

TRAINABLE = ("align_transformer", "text_model", "loss_fns")


def port_on_cpu(params, cfg, batch, jax_fp32) -> dict:
    """The port's gradients from the JAX weights (the bridge) on the CPU, in fp32
    and bf16: each one's per-leaf miss of the JAX fp32 gradient."""
    import numpy as np
    import torch

    from chip_smoke import grad_misses, miss_summary
    from radzero_torch.models import configuration as tc
    from radzero_torch.models.from_jax import params_from_jax
    from radzero_torch.models.radzero import forward_train
    from radzero_torch.train.optim import partition_params
    from radzero_torch.utils.tree import tree_leaves, tree_unflatten

    tparams = params_from_jax(jax_tree_to_numpy(params))
    tcfg = tc.RadZeroConfig(vision=tc.ViTConfig(img_size=cfg.vision.img_size))
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    tbatch = {k: v.long() if not v.is_floating_point() else v for k, v in tbatch.items()}
    out = {}
    for name, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        trainable, frozen = partition_params(tparams, TRAINABLE)
        leaves = tree_leaves(trainable)
        for p in leaves:
            p.requires_grad_(True)
        loss = forward_train({**trainable, **frozen}, tcfg, tbatch, dtype=dtype,
                             stop_vision_gradient=True)["losses"]["loss"]
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        for p in leaves:
            p.requires_grad_(False)
        tree = tree_unflatten([np.zeros(tuple(p.shape), np.float32) if g is None
                               else g.float().numpy() for p, g in zip(leaves, grads)], trainable)
        out[name] = miss_summary(grad_misses(tree, jax_fp32))
    return {"summary": out}


def jax_tree_to_numpy(tree):
    import jax
    import numpy as np

    return jax.tree_util.tree_map(np.asarray, tree)


def main(argv=None) -> int:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from chip_smoke import MISS_SHAPE, grad_misses, miss_batch, miss_summary
    from radzero_torch.models.from_jax import params_from_jax, params_to_numpy
    from radzero_tpu.models.configuration import RadZeroConfig
    from radzero_tpu.models.radzero import forward_train, init_radzero

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", default=None)
    ap.add_argument("--port_cpu", action="store_true",
                    help="also the port's bf16 and fp32 gradients from the same weights on the "
                         "CPU (its kernels' plain twins), each against the JAX fp32 gradient")
    args = ap.parse_args(argv)

    cfg = RadZeroConfig()
    cfg = dataclasses.replace(cfg, vision=dataclasses.replace(cfg.vision, img_size=MISS_SHAPE["img"]))
    params = init_radzero(jax.random.PRNGKey(args.seed), cfg)
    trainable = {k: v for k, v in params.items() if k in TRAINABLE}
    frozen = {k: v for k, v in params.items() if k not in TRAINABLE}
    batch = {k: jnp.asarray(v) for k, v in miss_batch(args.seed, cfg.text.vocab_size).items()}

    grads, losses, seconds = {}, {}, {}
    for name, dtype in (("fp32", jnp.float32), ("bf16", jnp.bfloat16)):
        def loss_fn(t, dtype=dtype):
            out = forward_train({**t, **frozen}, cfg, batch, dtype=dtype,
                                stop_vision_gradient=True)
            return out["losses"]["loss"]

        t0 = time.perf_counter()
        loss, g = jax.jit(jax.value_and_grad(loss_fn))(trainable)
        g = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), g)
        seconds[name] = time.perf_counter() - t0
        losses[name] = float(loss)
        grads[name] = params_to_numpy(params_from_jax(g))
    miss = grad_misses(grads["bf16"], grads["fp32"])
    rec = {"side": "jax", "device": "cpu", "shape": MISS_SHAPE, "seed": args.seed,
           "losses": losses, "seconds": seconds, "summary": miss_summary(miss), "miss": miss}
    print(json.dumps(rec["summary"] | {"losses": losses, "seconds": seconds}))
    if args.port_cpu:
        rec["port_cpu"] = port_on_cpu(params, cfg, batch, grads["fp32"])
        print(json.dumps({"port_cpu": rec["port_cpu"]["summary"]}))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rec, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
