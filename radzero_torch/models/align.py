"""Align adapters (port of radzero_tpu/models/align.py).

``align_transformer``: N DINOv2 layers, on the fused K1-K3 layer unless
``impl`` names another ("packed", "flash", "eager": see ``models/vit.py``), plus an
optional trailing LN; under ``remat`` (with ``AlignConfig.remat``, when not
None, in its place, as radzero_tpu/models/align.py:40-48 does) each layer
runs under ``AlignConfig.remat_policy`` (``models/vit.py`` ``vit_encoder``);
``identity``: tokens pass through; ``linear``: one D -> D product;
``mlp``: the reference's 3-hidden-layer ReLU MLP, D -> 1024 -> 1024 -> 1024
-> D (align_transformers.py:65-83, dropout inactive at eval). The last two
are plain ``linear`` products, as in the JAX package, which runs them
outside any Pallas kernel; their kernels are (d_in, d_out).
"""

from __future__ import annotations

import torch

from radzero_torch.models.configuration import AlignConfig
from radzero_torch.models.vit import _init_linear, init_vit_layers, vit_encoder
from radzero_torch.ops.layers import layer_norm, linear

MLP_HIDDEN = 1024


def _align_transformer_init(g: torch.Generator, cfg: AlignConfig) -> dict:
    params = {"layers": init_vit_layers(g, cfg.as_vit())}
    if cfg.use_layer_norm:
        params["layer_norm"] = {"scale": torch.ones(cfg.hidden_size, device=g.device),
                                "bias": torch.zeros(cfg.hidden_size, device=g.device)}
    return params


def _align_transformer_apply(params, cfg: AlignConfig, tokens, *, impl="fused", remat=False):
    if cfg.remat is not None:
        remat = cfg.remat
    tokens = vit_encoder(params["layers"], cfg.as_vit(), tokens, impl=impl, remat=remat)
    if cfg.use_layer_norm:
        tokens = layer_norm(tokens, params["layer_norm"], cfg.layer_norm_eps)
    return tokens


def _identity_init(g, cfg) -> dict:
    return {}


def _identity_apply(params, cfg, tokens, *, impl="fused", remat=False):
    return tokens


def _linear_init(g, cfg: AlignConfig) -> dict:
    return {"linear": _init_linear(g, cfg.hidden_size, cfg.hidden_size)}


def _linear_apply(params, cfg, tokens, *, impl="fused", remat=False):
    return linear(tokens, params["linear"])


def _mlp_init(g, cfg: AlignConfig) -> dict:
    d = cfg.hidden_size
    dims = (d, MLP_HIDDEN, MLP_HIDDEN, MLP_HIDDEN, d)
    return {f"fc{i}": _init_linear(g, dims[i], dims[i + 1]) for i in range(4)}


def _mlp_apply(params, cfg, tokens, *, impl="fused", remat=False):
    x = tokens
    for i in range(3):
        x = torch.relu(linear(x, params[f"fc{i}"]))
    return linear(x, params["fc3"])


_ADAPTERS = {
    "align_transformer": (_align_transformer_init, _align_transformer_apply),
    "identity": (_identity_init, _identity_apply),
    "linear": (_linear_init, _linear_apply),
    "mlp": (_mlp_init, _mlp_apply),
}


def build_align_adapter(model_type: str):
    """-> (init(generator, cfg), apply(params, cfg, tokens, *, impl, remat));
    ``impl`` and ``remat`` are read by ``align_transformer`` and ignored by
    the others."""
    if model_type not in _ADAPTERS:
        raise ValueError(f"unknown align adapter {model_type!r}; expected one of "
                         f"{sorted(_ADAPTERS)}")
    return _ADAPTERS[model_type]
