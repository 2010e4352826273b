"""The composite RadZero model (port of radzero_tpu/models/radzero.py):
DINOv2 tower -> align adapter -> VL-CABS head, plus the MPNet tower, under
one dict of parameters whose top-level keys mirror the JAX tree. The
towers dispatch on ``model_type`` through the encoder registry
(``models/encoders.py``): the alternate vision towers (CLIP / SigLIP /
BiomedCLIP, SAM, MAE) and the BERT text tower run on plain torch ops, and
the align layers, MPNet and VL-CABS on the kernels below at their shapes.

Two entry points: :func:`compute_logits`, zero-shot scoring (the
``radzero`` logits type, and the ``cls_alignment`` / ``global_alignment``
alternates), and :func:`forward_train`, the training forward over one
flattened global batch.

What training runs on at the defaults (``AlignConfig.attn_impl=
"fused_vjp"``, ``TextConfig.fuse_post=True``, ``LossConfig.train_impl=
"fused"``): the frozen tower on the forward kernels K1-K3 without a tape,
the trainable align layers on K1-K3 with the backward kernels K6-K8, every
MPNet layer's post-attention chain on K4 with the backward K9, and the loss
on the VL-CABS training kernels K10-K12. A trainable vision tower runs
through the same K1-K3 / K6-K8 Functions. ``attn_impl="xla"`` and
``fuse_post=False`` are the eager paths that autograd differentiates.
``remat=True`` (``TrainerArgs.gradient_checkpointing``) reruns parts of a
trainable tower, of the align layers and of MPNet in the backward, with
``AlignConfig.remat`` / ``TextConfig.remat`` overriding it where they are
not None and the DINOv2 layers under their ``remat_policy``
(``models/vit.py``); a frozen tower keeps no tape either way.

``tp=`` (a model group, :func:`radzero_torch.parallel.dist.mesh_groups`)
runs :func:`compute_logits` and :func:`forward_train`'s forward over it, with
``params`` this rank's share
(:func:`radzero_torch.parallel.tensor_parallel.shard_params`): the DINOv2
tower, the align layers and MPNet split by heads and MLP columns, K3 and K4
row-parallel; VL-CABS, the loss heads and the LayerNorms run replicated on
every rank of the group, and every rank returns the same outputs. ``group=``
keeps its meaning, the data group. Under gradients the backward splits at
the same all-reduces (K6, K8 and K9 over the axis, ``copy_to_model`` at the
column-parallel inputs): every replicated leaf's gradient is whole and
bit-equal on every rank of the group, every split leaf's is the rank's
share. The alternate towers split as the JAX rules split their trees
(``parallel/tensor_parallel.py``): CLIP / SigLIP / BiomedCLIP, MAE and BERT
by heads and MLP columns (BERT's word and position rows too), SAM by its
MLP alone, on the same plain torch ops. A group of one runs today's path,
bit for bit.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from radzero_torch.losses.clip import (
    clip_loss,
    init_clip_loss,
    init_siglip_loss,
    siglip_loss,
)
from radzero_torch.losses.radzero_loss import (
    init_radzero_loss,
    radzero_loss,
    radzero_similarity,
    temperatures,
)
from radzero_torch.models.align import build_align_adapter
from radzero_torch.models.bert import bert_config_from_text, bert_forward
from radzero_torch.models.configuration import RadZeroConfig
from radzero_torch.models.encoders import BERT_TYPES, build_text_encoder, build_vision_encoder
from radzero_torch.models.mpnet import masked_mean_pool, mpnet_forward
from radzero_torch.models.vit import layer_impl, vit_forward
from radzero_torch.ops.layers import l2_normalize, linear
from radzero_torch.parallel.collectives import all_gather_rows
from radzero_torch.parallel.tensor_parallel import active


def init_radzero(g: torch.Generator, cfg: RadZeroConfig,
                 loss_apply: Sequence[str] = ("RadZeroLoss",)) -> dict:
    """Weights at the real shapes from ``g`` (fp32, on ``g.device``), in
    the layout :func:`radzero_torch.models.from_jax.params_from_jax`
    produces. The towers come from the encoder registry
    (``models/encoders.py``) by ``model_type``; a BERT-family text tower
    takes its widths from ``cfg.text`` (``bert_config_from_text``). The
    ``clip_text`` family is built but refused by :func:`forward_text`, as in
    the JAX package."""
    align_init, _ = build_align_adapter(cfg.align.model_type)
    vision_init, _ = build_vision_encoder(getattr(cfg.vision, "model_type", "dinov2"))
    text_type = getattr(cfg.text, "model_type", "mpnet")
    text_init, _ = build_text_encoder(text_type)
    params = {
        "vision_model": vision_init(g, cfg.vision),
        "align_transformer": align_init(g, cfg.align),
        "text_model": text_init(g, bert_config_from_text(cfg.text)
                                if text_type in BERT_TYPES else cfg.text),
    }
    if cfg.text.use_text_projection:
        d_in, d_out = cfg.text.hidden_size, 2 * cfg.align.hidden_size
        params["text_projector"] = {
            "kernel": torch.randn((d_in, d_out), generator=g, device=g.device) * 0.02,
            "bias": torch.zeros(d_out, device=g.device),
        }
    inits = {
        "RadZeroLoss": lambda: init_radzero_loss(cfg.loss, device=g.device),
        "OpenClipLoss": lambda: init_clip_loss(device=g.device),
        "OpenSigLipLoss": lambda: init_siglip_loss(device=g.device),
    }
    for name in loss_apply:
        if name not in inits:
            raise NotImplementedError(name)
    params["loss_fns"] = {name: inits[name]() for name in loss_apply}
    return params


def forward_vision(params: dict, cfg: RadZeroConfig, pixel_values: Optional[torch.Tensor], *,
                   dtype=torch.float32, eager: bool = False,
                   fused_towers: bool = True,
                   align_impl: Optional[str] = None,
                   stop_tower_gradient: bool = False,
                   tower_tokens: Optional[torch.Tensor] = None,
                   remat: bool = False, tp=None) -> Dict[str, torch.Tensor]:
    """Tower + align adapter + pooled image features, (B, H, W, 3) NHWC.

    The tower dispatches on ``cfg.vision.model_type`` through the encoder
    registry (``models/encoders.py``): dinov2 / raddino run ``models/vit.py``
    on the layer named below; the alternate towers (CLIP / SigLIP /
    BiomedCLIP, SAM, MAE) run on plain torch ops whatever the flags say, as
    the JAX package runs them on plain XLA. ``fused_towers`` (the default, the counterpart of the JAX package's
    ``with_fused_towers``) runs the tower and the align adapter on the fused
    K1-K3 layer whatever the config says; False runs the layers that
    ``cfg.vision.attn_impl`` and ``cfg.align.attn_impl`` name ("flash", the
    ``ViTConfig`` default, is K13; see :func:`radzero_torch.models.vit.
    layer_impl`). ``eager`` runs the eager reference layers in both instead.
    ``align_impl`` names the align adapter's layer over all of these
    ("fused", "packed", "flash" or "eager"). ``stop_tower_
    gradient`` runs the tower under ``torch.no_grad()``, so a frozen tower
    keeps no tape and may run on the forward kernels. ``tower_tokens``
    (B, L, D), a precomputed tower output at the real length L, skips the
    tower. ``remat`` reruns parts of a trainable tower and of the
    align layers in the backward (see :func:`radzero_torch.models.vit.
    vit_encoder`). ``tp``: the model group (see the module docstring)."""
    def impl_of(attn_impl):
        return "eager" if eager else "fused" if fused_towers else layer_impl(attn_impl)

    tp = active(tp)
    model_type = getattr(cfg.vision, "model_type", "dinov2")
    if tower_tokens is not None:
        tokens = tower_tokens.to(dtype)
    else:
        with torch.set_grad_enabled(torch.is_grad_enabled() and not stop_tower_gradient):
            if model_type in ("dinov2", "raddino"):
                tokens = vit_forward(params["vision_model"], cfg.vision, pixel_values,
                                     dtype=dtype, impl=impl_of(cfg.vision.attn_impl),
                                     remat=remat, tp=tp)
            else:
                _, vision_apply = build_vision_encoder(model_type)
                tokens = vision_apply(params["vision_model"], cfg.vision, pixel_values,
                                      dtype=dtype, tp=tp)
    _, align_apply = build_align_adapter(cfg.align.model_type)
    tokens = align_apply(params["align_transformer"], cfg.align, tokens,
                         impl=align_impl or impl_of(cfg.align.attn_impl), remat=remat, tp=tp)
    cls_token, patch_tokens = tokens[:, 0], tokens[:, 1:]
    image_features = l2_normalize(torch.cat([cls_token, patch_tokens.mean(dim=1)], dim=-1))
    return {
        "vision_tokens": tokens,
        "image_cls_token": cls_token,
        "image_patch_tokens": patch_tokens,
        "image_features": image_features,
    }


def forward_text(params: dict, cfg: RadZeroConfig, input_ids, attention_mask, *,
                 dtype=torch.float32, remat: bool = False, tp=None) -> Dict[str, torch.Tensor]:
    """Text tower + optional projector + pooling, by ``cfg.text.model_type``
    (radzero_tpu/models/radzero.py:194-245): MPNet (``remat``, or
    ``cfg.text.remat`` in its place when not None, reruns each layer in the
    backward) with the projector on the token embeddings before pooling
    (ref modeling.py:139-140); the BERT family (bert, bioclinicalmpbert,
    biomedclip) with the projector on the pooled features (ref
    modeling.py:202-203). Any other type, the CLIP text towers included,
    raises NotImplementedError, as the JAX composite does
    (radzero_tpu/models/radzero.py:240-241), over a model group as without
    one. ``tp``: the model group (see the module docstring)."""
    tp = active(tp)
    text_type = getattr(cfg.text, "model_type", "mpnet")
    if cfg.text.remat is not None:
        remat = cfg.text.remat
    if text_type == "mpnet":
        hidden = mpnet_forward(params["text_model"], cfg.text, input_ids, attention_mask,
                               dtype=dtype, remat=remat, tp=tp)
        if cfg.text.use_text_projection:
            hidden = linear(hidden, params["text_projector"])
        if cfg.text.use_cls_token:
            text_features = hidden[:, 0, :]
        else:
            text_features = masked_mean_pool(hidden, attention_mask)
    elif text_type in BERT_TYPES:
        hidden = bert_forward(params["text_model"], bert_config_from_text(cfg.text), input_ids,
                              attention_mask, dtype=dtype, tp=tp)
        if cfg.text.use_cls_token:
            text_features = hidden[:, 0, :]
        else:
            text_features = masked_mean_pool(hidden, attention_mask)
        if cfg.text.use_text_projection:
            text_features = linear(text_features, params["text_projector"])
    else:
        raise NotImplementedError(f"text model_type {text_type!r} in composite model")
    return {
        "text_features_wo_l2_norm": text_features,
        "text_features": l2_normalize(text_features),
    }


def forward_train(
    params: dict,
    cfg: RadZeroConfig,
    batch: Dict[str, torch.Tensor],
    *,
    loss_ratio: Optional[Dict[str, float]] = None,
    dtype=torch.float32,
    remat: bool = False,
    stop_vision_gradient: bool = False,
    group=None,
    tp=None,
) -> Dict[str, torch.Tensor]:
    """One training forward over the flattened global batch, or, with
    ``group`` (a process group), over this rank's share of it; with ``tp``
    (a model group) over the model axis as well, ``params`` this rank's
    share, differentiable (see the module docstring).

    batch keys:
        pixel_values          (B, H, W, 3), or ``tower_tokens`` (B, L, D), a
                              precomputed frozen-tower output at the real
                              length L, which skips the vision tower
        input_ids             (S, L)  flattened sentences
        attention_mask        (S, L)
        group_map             (S,)    image index per sentence
        row_mask              (S,)    1.0 real sentence / 0.0 padding
        row_gather            (S,)    optional: input_ids holds U unique
                              sentences and this gathers their features back
                              to the S loss rows. Autograd adds the
                              gradients of duplicated rows up: the backward
                              of ``v[idx]`` is an accumulating index put,
                              which on CUDA sorts by index first
                              (``indexing_backward_kernel``, no atomics), so
                              two steps give the same bits (chip_smoke.py's
                              trainer phase checks it); on the CPU, above
                              32768 elements, it accumulates in thread order
        random_input_ids      (B, L)  one random positive per image (only
        random_attention_mask (B, L)  with the CLIP / SigLIP losses)

    Reads ``cfg.align.attn_impl`` ("fused_vjp", the default: the K1-K3
    layer with the K6-K8 backward; "packed": eager ops around K2 / K7;
    "flash": eager ops around K13 / K14; "xla": eager layers that autograd
    differentiates), ``cfg.text.attn_impl`` ("flash": K15 / K16, else the
    eager attention), ``cfg.text.fuse_post`` (K4 with the K9 backward, or
    the eager chain) and
    ``cfg.loss.train_impl`` ("fused" with ``sim_op="cos"``: kernels
    K10-K12, else eager ops). ``remat`` goes to both towers and the align
    layers (:func:`forward_vision`, :func:`forward_text`).

    ``group``: the batch is this rank's share, ``group_map`` (and
    ``row_gather``) in global indices as the loader writes them. The towers
    run on the share; the loss heads gather what the global loss needs
    (``radzero_loss``, ``clip_loss``, ``siglip_loss``), so every rank
    returns the same losses. With ``row_gather`` the unique block's
    features are gathered first, then indexed.
    -> {"losses": {...}, **forward_vision outputs}."""
    loss_ratio = loss_ratio or {name: 1.0 for name in params["loss_fns"]}
    # the tower runs on K1-K3: frozen it keeps no tape; trainable, it
    # differentiates through K6-K8 like the align layers
    vision = forward_vision(
        params, cfg, batch.get("pixel_values"), dtype=dtype,
        align_impl=layer_impl(cfg.align.attn_impl),
        stop_tower_gradient=stop_vision_gradient, tower_tokens=batch.get("tower_tokens"),
        remat=remat, tp=tp)

    losses: Dict[str, torch.Tensor] = {}
    total = torch.zeros((), dtype=torch.float32, device=vision["vision_tokens"].device)
    for name, lparams in params["loss_fns"].items():
        if name == "RadZeroLoss":
            text = forward_text(params, cfg, batch["input_ids"], batch["attention_mask"],
                                dtype=dtype, remat=remat, tp=tp)
            if "row_gather" in batch:
                if group is not None:  # the loader's indices point into every rank's block
                    text = {k: all_gather_rows(v, group) for k, v in text.items()}
                text = {k: v[batch["row_gather"]] for k, v in text.items()}
            fused = cfg.loss.train_impl == "fused" and cfg.loss.sim_op == "cos"
            out = radzero_loss(
                lparams, cfg.loss, text["text_features_wo_l2_norm"], text["text_features"],
                batch["group_map"], batch["row_mask"], vision["vision_tokens"],
                impl="fused_train" if fused else "xla", group=group)
            losses["t2i_loss"] = out["losses"]["t2i_loss"]
            losses["radzero_loss"] = loop_loss = out["losses"]["loss"]
        elif name in ("OpenClipLoss", "OpenSigLipLoss"):
            text = forward_text(params, cfg, batch["random_input_ids"],
                                batch["random_attention_mask"], dtype=dtype, remat=remat, tp=tp)
            fn, key = ((clip_loss, "clip_loss") if name == "OpenClipLoss"
                       else (siglip_loss, "siglip_loss"))
            losses[key] = loop_loss = fn(lparams, vision["image_features"],
                                         text["text_features"], group=group)
        else:
            raise NotImplementedError(name)
        total = total + loop_loss.float() * loss_ratio.get(name, 1.0)
    losses["loss"] = total
    return {"losses": losses, **vision}


def compute_logits(
    params: dict,
    cfg: RadZeroConfig,
    pixel_values: torch.Tensor,    # (B, H, W, 3)
    input_ids: torch.Tensor,       # (N, L)
    attention_mask: torch.Tensor,  # (N, L)
    *,
    dtype=torch.float32,
    eager: bool = False,
    fused_towers: bool = True,
    tp=None,
) -> Dict[str, torch.Tensor]:
    """Zero-shot scoring, ``radzero`` branch:

        logits             (B, N)    = t2i_logits.T / exp(log_loss_temperature)
        similarity_scores  (B, N, L-1)  pre-softmax maps, CLS column removed

    The vision layers and VL-CABS run through the kernels K1-K3 and K5
    (their plain twins for CPU tensors); ``fused_towers=False`` runs the
    layers the config names instead of K1-K3 (``attn_impl="flash"``: K13);
    the text tower reads ``cfg.text.attn_impl`` ("flash": K15) and
    ``fuse_post`` (K4) either way. ``eager=True`` runs the eager reference
    layers and VL-CABS, for checking the kernels on the card.

    ``cfg.compute_logits_type`` "cls_alignment" / "global_alignment" run
    the same towers and no VL-CABS (:func:`_compute_logits_alignment`).
    ``tp``: a model group, ``params`` this rank's share (see the module
    docstring); every rank of the group returns the same outputs."""
    if cfg.compute_logits_type != "radzero":
        return _compute_logits_alignment(params, cfg, pixel_values, input_ids, attention_mask,
                                         dtype=dtype, eager=eager, fused_towers=fused_towers,
                                         tp=tp)
    vision = forward_vision(params, cfg, pixel_values, dtype=dtype, eager=eager,
                            fused_towers=fused_towers, tp=tp)
    text = forward_text(params, cfg, input_ids, attention_mask, dtype=dtype, tp=tp)
    lparams = params["loss_fns"]["RadZeroLoss"]
    out = radzero_similarity(
        lparams, cfg.loss, text["text_features_wo_l2_norm"], text["text_features"],
        vision["vision_tokens"], eager=eager,
    )
    scores = out["similarity_scores"]
    if cfg.loss.use_vision_cls_token:
        scores = scores[:, :, 1:]
    loss_temp, _ = temperatures(lparams)
    return {"logits": out["t2i_logits"].T / loss_temp, "similarity_scores": scores}


def _compute_logits_alignment(params, cfg, pixel_values, input_ids, attention_mask, *,
                              dtype, eager, fused_towers, tp=None):
    """The alternates of modeling.py:330-353, as radzero_tpu's:

    - ``cls_alignment``: logits (B, N) = CLS token . text features, no maps;
    - ``global_alignment``: logits = image features (CLS and patch mean,
      l2-normalised, 2 x hidden) . text features, and maps (B, N, L-1) =
      patch tokens . the text features' second half, so the text tower
      needs ``use_text_projection`` (width 2 x hidden)."""
    vision = forward_vision(params, cfg, pixel_values, dtype=dtype, eager=eager,
                            fused_towers=fused_towers, tp=tp)
    key_features = forward_text(params, cfg, input_ids, attention_mask,
                                dtype=dtype, tp=tp)["text_features"]
    if cfg.compute_logits_type == "cls_alignment":
        return {"logits": vision["image_cls_token"] @ key_features.T}
    if cfg.compute_logits_type == "global_alignment":
        hidden = cfg.align.hidden_size
        scores = torch.einsum("ind,jd->ijn", vision["image_patch_tokens"],
                              key_features[:, hidden:])
        return {"logits": vision["image_features"] @ key_features.T,
                "similarity_scores": scores}
    raise ValueError(f"unknown compute_logits_type {cfg.compute_logits_type!r}; expected "
                     "radzero, cls_alignment or global_alignment")
