"""BERT text encoder (BioClinicalBERT family) and wordpiece aggregation
(port of radzero_tpu/models/bert.py).

The reference's alternate text tower (exp/cxr_pt/model/text_encoders.py:
8-28 'bioclinicalmpbert' via HF BertModel) with the BioViL-style
wordpiece->word aggregation over the last-n hidden layers
(aggregate_tokens, text_encoders.py:44-102) used when
``use_aggregate_tokens`` is set (modeling.py:170-193).

Architecture facts (HF BertModel): word + absolute-position +
token-type embeddings with LayerNorm(eps 1e-12); post-LN encoder blocks
(LN(x + attn), LN(y + ffn)), gelu; additive key-padding mask.

Parameters are the JAX layout with the layers unstacked: one dict per
layer in a list, q / k / v kept apart. Plain torch ops: the JAX tower
runs no Pallas kernel.

Over a model group ``tp`` (the parameters this rank's share,
``parallel/tensor_parallel.py``) each layer runs the rank's heads, q / k / v
and fc1 column-parallel, o and fc2 row-parallel; the word and position
tables split on their rows where the axis divides them, each rank looking
up the ids it holds and an all-reduce adding the rows (``embed_rows``,
whose backward hands each rank the gradient of its rows); ``token_type``
and the LayerNorms stay whole. The mask bias is per key, so it broadcasts
over the rank's heads as it is.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from radzero_torch.models.convert import _lin, _ln, _stack
from radzero_torch.models.vit import _init_linear, _init_ln, _normal
from radzero_torch.ops.layers import (
    column_linear, embed_rows, gelu, layer_norm, row_linear, self_attention,
)
from radzero_torch.parallel.tensor_parallel import active


@dataclass(frozen=True)
class BertConfig:
    model_type: str = "bert"
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    vocab_size: int = 28996
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 0

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads


def bert_config_from_text(text_cfg) -> "BertConfig":
    """Adapt the composite model's TextConfig to a BertConfig."""
    return BertConfig(
        hidden_size=text_cfg.hidden_size,
        num_hidden_layers=text_cfg.num_hidden_layers,
        num_attention_heads=text_cfg.num_attention_heads,
        intermediate_size=text_cfg.intermediate_size,
        vocab_size=text_cfg.vocab_size,
        max_position_embeddings=text_cfg.max_position_embeddings,
    )


def init_qkvo(g: torch.Generator, d: int) -> dict:
    """The q, k, v and o projections of the BERT, CLIP and MAE layers."""
    return {n: _init_linear(g, d, d) for n in "qkvo"}


def init_bert(g: torch.Generator, cfg: BertConfig) -> dict:
    d, f = cfg.hidden_size, cfg.intermediate_size
    return {
        "embeddings": {
            "word": _normal(g, (cfg.vocab_size, d)),
            "position": _normal(g, (cfg.max_position_embeddings, d)),
            "token_type": _normal(g, (cfg.type_vocab_size, d)),
            "ln": _init_ln(g, d),
        },
        "layers": [
            {"attn": init_qkvo(g, d), "ln_attn": _init_ln(g, d),
             "mlp": {"fc1": _init_linear(g, d, f), "fc2": _init_linear(g, f, d)},
             "ln_out": _init_ln(g, d)}
            for _ in range(cfg.num_hidden_layers)
        ],
    }


def _bert_layer(x, p, mask_bias, cfg: BertConfig, tp=None):
    a = self_attention(x, p["attn"], cfg.num_attention_heads, mask_bias, tp)
    x = layer_norm(x + a, p["ln_attn"], cfg.layer_norm_eps)
    m = row_linear(gelu(column_linear(x, p["mlp"]["fc1"], tp)), p["mlp"]["fc2"], tp)
    return layer_norm(x + m, p["ln_out"], cfg.layer_norm_eps)


def bert_forward(
    params: dict,
    cfg: BertConfig,
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    token_type_ids: Optional[torch.Tensor] = None,
    *,
    dtype=torch.float32,
    output_hidden_states: bool = False,
    tp=None,
):
    """-> last hidden (S, L, D) [and all hidden states (n_layers+1, S, L, D)];
    ``tp``: a model group (see the module docstring)."""
    tp = active(tp)
    emb = params["embeddings"]
    s, l = input_ids.shape
    if token_type_ids is None:
        token_type_ids = torch.zeros_like(input_ids)
    pos_ids = torch.arange(l, device=input_ids.device)[None, :]
    x = (embed_rows(emb["word"], input_ids, cfg.vocab_size, tp)
         + embed_rows(emb["position"], pos_ids, cfg.max_position_embeddings, tp)
         + emb["token_type"][token_type_ids])
    x = layer_norm(x.to(dtype), emb["ln"], cfg.layer_norm_eps)

    neg = torch.finfo(torch.float32).min
    bias = ((1.0 - attention_mask.float())[:, None, None, :] * neg).to(dtype)
    hiddens = [x]
    for p in params["layers"]:
        x = _bert_layer(x, p, bias, cfg, tp)
        hiddens.append(x)
    if output_hidden_states:
        return x, torch.stack(hiddens)
    return x


# ---------------------------------------------------------------------------
# Wordpiece -> word aggregation (ref text_encoders.py:44-102)
# ---------------------------------------------------------------------------

def aggregate_tokens(
    embeddings: np.ndarray,      # (B, n_layers, L, D) last-n hidden layers
    tokens: List[List[str]],     # decoded wordpiece strings per sequence
) -> Tuple[np.ndarray, List[List[str]]]:
    """Merge '##'-continuation wordpieces by averaging their embeddings;
    special tokens ([CLS]/[SEP]/[PAD]) are dropped. Returns word-level
    embeddings padded to the max word count: (B, n_layers, W_max, D),
    plus the word strings per sequence."""
    b, n_layers, l, d = embeddings.shape
    all_words: List[List[str]] = []
    all_embs: List[np.ndarray] = []

    for i in range(b):
        words: List[str] = []
        embs: List[np.ndarray] = []
        cur_word = ""
        cur: List[np.ndarray] = []

        def flush():
            nonlocal cur_word, cur
            if cur:
                embs.append(np.mean(cur, axis=0))
                words.append(cur_word)
            cur_word, cur = "", []

        for t in range(min(l, len(tokens[i]))):
            tok = tokens[i][t]
            if tok in ("[CLS]", "[SEP]", "[PAD]", "<s>", "</s>", "<pad>"):
                flush()
                continue
            if tok.startswith("##"):
                cur_word += tok[2:]
                cur.append(embeddings[i, :, t])
            else:
                flush()
                cur_word = tok
                cur = [embeddings[i, :, t]]
        flush()
        all_words.append(words)
        all_embs.append(np.stack(embs, axis=1) if embs else np.zeros((n_layers, 0, d)))

    w_max = max(e.shape[1] for e in all_embs)
    out = np.zeros((b, n_layers, w_max, d), embeddings.dtype)
    for i, e in enumerate(all_embs):
        out[i, :, : e.shape[1]] = e
    return out, all_words


def bert_sentence_features(
    params: dict,
    cfg: BertConfig,
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    *,
    use_cls_token: bool = False,
    dtype=torch.float32,
) -> torch.Tensor:
    """Sentence features: CLS or masked mean pooling (modeling.py:167-200)."""
    hidden = bert_forward(params, cfg, input_ids, attention_mask, dtype=dtype)
    if use_cls_token:
        return hidden[:, 0, :]
    mask = attention_mask.to(hidden.dtype)[..., None]
    return (hidden * mask).sum(dim=1) / mask.sum(dim=1).clamp_min(1e-9)


def convert_bert(sd: dict, num_layers: int) -> dict:
    """HF BertModel state_dict (numpy) -> the JAX layout (layers stacked),
    which :func:`radzero_torch.models.from_jax.params_from_jax` takes."""
    layers = []
    for i in range(num_layers):
        p = f"encoder.layer.{i}"
        layers.append(
            {
                "attn": {
                    "q": _lin(sd, f"{p}.attention.self.query"),
                    "k": _lin(sd, f"{p}.attention.self.key"),
                    "v": _lin(sd, f"{p}.attention.self.value"),
                    "o": _lin(sd, f"{p}.attention.output.dense"),
                },
                "ln_attn": _ln(sd, f"{p}.attention.output.LayerNorm"),
                "mlp": {
                    "fc1": _lin(sd, f"{p}.intermediate.dense"),
                    "fc2": _lin(sd, f"{p}.output.dense"),
                },
                "ln_out": _ln(sd, f"{p}.output.LayerNorm"),
            }
        )
    return {
        "embeddings": {
            "word": sd["embeddings.word_embeddings.weight"].copy(),
            "position": sd["embeddings.position_embeddings.weight"].copy(),
            "token_type": sd["embeddings.token_type_embeddings.weight"].copy(),
            "ln": _ln(sd, "embeddings.LayerNorm"),
        },
        "layers": _stack(layers),
    }
