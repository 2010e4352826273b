"""The port's sanity harness (``radzero_torch/tools/sanity_train.py``) on the CPU
from other initial weights: for each seed, the JAX ``init_radzero`` from
``PRNGKey(seed)`` through the bridge (``models/from_jax.py``) and the port's
``init_radzero`` from a CPU ``torch.Generator`` seeded alike, each trained and
scored by the harness's ``run`` (150 steps, batch 32, fp32). It shows how far
one draw's accuracies move with the weights alone, which the learning gates
of ``chip_smoke.py`` (``SANITY_GATES``) are set against.

    JAX_PLATFORMS=cpu python tests/sanity_seeds.py [--heads 1] [--seeds 0 1 2 3] [--steps 150]

One JSON line a run. At seed 0 from the JAX weights at 4 heads the record is
the JAX tool's (``tools/sanity_train.py``) to every printed digit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    import torch

    from radzero_torch.models.from_jax import params_from_jax
    from radzero_torch.models.radzero import init_radzero
    from radzero_torch.tools import sanity_train as st
    from radzero_tpu.models import configuration as jc
    from radzero_tpu.models.radzero import init_radzero as jax_init_radzero

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--heads", type=int, default=1)
    ap.add_argument("--seeds", type=int, nargs="*", default=[0, 1, 2, 3])
    ap.add_argument("--steps", type=int, default=150)
    args = ap.parse_args(argv)

    d = 64  # the JAX tool's configuration (tools/sanity_train.py:64-72)
    jcfg = jc.RadZeroConfig(
        vision=jc.ViTConfig(hidden_size=d, num_hidden_layers=2, num_attention_heads=4,
                            mlp_ratio=2.0, patch_size=14, pretrain_img_size=56, img_size=56),
        text=jc.TextConfig(hidden_size=d, num_hidden_layers=2, num_attention_heads=4,
                           intermediate_size=128, vocab_size=30527, max_position_embeddings=40),
        align=jc.AlignConfig(hidden_size=d, num_hidden_layers=2, num_attention_heads=4,
                             mlp_ratio=2.0),
        loss=jc.LossConfig(hidden_dim=d),
    )
    for seed in args.seeds:
        inits = {
            "jax_init": params_from_jax(jax.tree_util.tree_map(
                np.asarray, jax_init_radzero(jax.random.PRNGKey(seed), jcfg))),
            "port_init": init_radzero(torch.Generator().manual_seed(seed),
                                      st.sanity_config(args.heads)),
        }
        for name, params in inits.items():
            rec = st.run(args.steps, 32, 3e-4, args.heads, "cpu", params=params)
            print(json.dumps({"init": name, "seed": seed, "heads": args.heads, **rec}),
                  flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
