"""CLIP text tower (clip_text / siglip_text factory entries, ref
exp/cxr_pt/model/text_encoders.py:8-28; port of
radzero_tpu/models/clip_text.py).

HF CLIPTextTransformer semantics: token + absolute position embeddings,
pre-LN blocks with quick_gelu and a *causal* mask combined with the
padding mask, final LayerNorm; pooled feature = hidden state at the
EOS (argmax of input_ids == eos_token_id) position. The composite model
refuses this tower in ``forward_text``, as the JAX composite does.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from radzero_torch.models.clip_vit import init_prenorm_layers, prenorm_layer
from radzero_torch.models.vit import _init_ln, _normal
from radzero_torch.ops.layers import layer_norm


@dataclass(frozen=True)
class ClipTextConfig:
    model_type: str = "clip_text"
    hidden_size: int = 512
    num_hidden_layers: int = 12
    num_attention_heads: int = 8
    intermediate_size: int = 2048
    vocab_size: int = 49408
    max_position_embeddings: int = 77
    layer_norm_eps: float = 1e-5
    eos_token_id: int = 49407

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads


def init_clip_text(g: torch.Generator, cfg: ClipTextConfig) -> dict:
    d, f = cfg.hidden_size, cfg.intermediate_size
    return {
        "embeddings": {
            "word": _normal(g, (cfg.vocab_size, d)),
            "position": _normal(g, (cfg.max_position_embeddings, d)),
        },
        "layers": init_prenorm_layers(g, cfg.num_hidden_layers, d, f),
        "final_ln": _init_ln(g, d),
    }


def clip_text_forward(params: dict, cfg: ClipTextConfig, input_ids: torch.Tensor,
                      attention_mask: torch.Tensor, *, dtype=torch.float32):
    """-> (last_hidden (S, L, D), pooled EOS features (S, D))."""
    s, l = input_ids.shape
    emb = params["embeddings"]
    x = (emb["word"][input_ids] + emb["position"][None, :l]).to(dtype)

    neg = torch.finfo(torch.float32).min
    causal = torch.triu(torch.full((l, l), neg, device=x.device), diagonal=1)[None, None]
    pad = (1.0 - attention_mask.float())[:, None, None, :] * neg
    bias = (causal + pad).to(dtype)
    for p in params["layers"]:
        x = prenorm_layer(x, p, cfg.num_attention_heads, cfg.layer_norm_eps, "quick_gelu", bias)
    x = layer_norm(x, params["final_ln"], cfg.layer_norm_eps)

    eos_pos = torch.argmax((input_ids == cfg.eos_token_id).int(), dim=1)
    return x, x[torch.arange(s, device=x.device), eos_pos]
