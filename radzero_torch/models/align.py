"""Align adapters (port of radzero_tpu/models/align.py).

``align_transformer``: N DINOv2 layers, on the fused K1-K3 layer unless
``impl`` names another ("packed", "flash", "eager": see ``models/vit.py``), plus an
optional trailing LN;
``identity``: tokens pass through. The ``linear`` and ``mlp`` baselines
are not ported yet (ROADMAP.md, modules still to port, item 7).
"""

from __future__ import annotations

import torch

from radzero_torch.models.configuration import AlignConfig
from radzero_torch.models.vit import init_vit_layers, vit_encoder
from radzero_torch.ops.layers import layer_norm


def _align_transformer_init(g: torch.Generator, cfg: AlignConfig) -> dict:
    params = {"layers": init_vit_layers(g, cfg.as_vit())}
    if cfg.use_layer_norm:
        params["layer_norm"] = {"scale": torch.ones(cfg.hidden_size, device=g.device),
                                "bias": torch.zeros(cfg.hidden_size, device=g.device)}
    return params


def _align_transformer_apply(params, cfg: AlignConfig, tokens, *, impl="fused"):
    tokens = vit_encoder(params["layers"], cfg.as_vit(), tokens, impl=impl)
    if cfg.use_layer_norm:
        tokens = layer_norm(tokens, params["layer_norm"], cfg.layer_norm_eps)
    return tokens


def _identity_init(g, cfg) -> dict:
    return {}


def _identity_apply(params, cfg, tokens, *, impl="fused"):
    return tokens


_ADAPTERS = {
    "align_transformer": (_align_transformer_init, _align_transformer_apply),
    "identity": (_identity_init, _identity_apply),
}


def build_align_adapter(model_type: str):
    """-> (init(generator, cfg), apply(params, cfg, tokens, *, impl))."""
    if model_type not in _ADAPTERS:
        raise NotImplementedError(
            f"align adapter {model_type!r} is not ported yet (ROADMAP.md, "
            "modules still to port, item 7)"
        )
    return _ADAPTERS[model_type]
