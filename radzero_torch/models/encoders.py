"""Encoder factories: registry dispatch by model_type (port of
radzero_tpu/models/encoders.py, with the same keys).

Replaces the reference's if/elif factories
(exp/cxr_pt/model/vision_encoders.py:23-43 build_vision_encoder;
text_encoders.py:8-28 build_text_encoder) — and its ``eval(name)``
instantiation quirk — with the Registry pattern. Each entry returns
``(init(generator, cfg), apply(params, cfg, ...))``.

Vision entries produce the (B, 1+L, D) token layout the composite model
consumes (SigLIP: (B, L, D), no CLS slot); text entries produce hidden
states. The alternate towers run on plain torch ops, as the JAX towers run
on plain XLA (no ``pallas_call``); the DINOv2 tower is the port's kernel
path (``models/vit.py``).
"""

from __future__ import annotations

from radzero_torch.utils.registry import TEXT_ENCODERS, VISION_ENCODERS

CLIP_TYPES = ("clip", "clip_vision_model", "xrayclip", "biomedclip", "siglip",
              "siglip_vision_model")
MAE_TYPES = ("m3ae", "mae")
BERT_TYPES = ("bert", "bioclinicalmpbert", "biomedclip")


# ---------------------------------------------------------------------------
# Vision
# ---------------------------------------------------------------------------

@VISION_ENCODERS.register("dinov2")
@VISION_ENCODERS.register("raddino")  # RadDINO = DINOv2-B fine-tuned on CXR:
def _dinov2():                        # identical architecture + HF layout
    from radzero_torch.models.vit import init_vit, vit_forward

    return init_vit, vit_forward


@VISION_ENCODERS.register("clip")
@VISION_ENCODERS.register("clip_vision_model")
@VISION_ENCODERS.register("xrayclip")
@VISION_ENCODERS.register("biomedclip")
@VISION_ENCODERS.register("siglip")
@VISION_ENCODERS.register("siglip_vision_model")
def _clip():
    from radzero_torch.models.clip_vit import clip_vit_forward, init_clip_vit

    return init_clip_vit, clip_vit_forward


@VISION_ENCODERS.register("sam")
def _sam():
    # the reference ACCEPTS "sam" configs but its factory has no branch
    # for them (NotImplementedError, vision_encoders.py:40-41); the JAX
    # package implements the tower (models/sam_vit.py), ported here
    from radzero_torch.models.sam_vit import init_sam_vit, sam_vit_forward

    return init_sam_vit, sam_vit_forward


@VISION_ENCODERS.register("m3ae")
@VISION_ENCODERS.register("mae")
def _mae():
    from radzero_torch.models.mae_vit import init_mae_vit, mae_vision_tokens

    return init_mae_vit, mae_vision_tokens


# ---------------------------------------------------------------------------
# Text
# ---------------------------------------------------------------------------

@TEXT_ENCODERS.register("mpnet")
def _mpnet():
    from radzero_torch.models.mpnet import init_mpnet, mpnet_forward

    return init_mpnet, mpnet_forward


@TEXT_ENCODERS.register("bert")
@TEXT_ENCODERS.register("bioclinicalmpbert")
@TEXT_ENCODERS.register("biomedclip")  # open_clip PubMedBERT text tower =
def _bert():                           # BERT architecture (ref
    # text_encoders.py:16-19 builds it, but the reference's composite
    # forward then crashes on it — forward_text_model handles only
    # MPNetModel/BertModel instances (modeling.py:128-206)
    from radzero_torch.models.bert import bert_forward, init_bert

    return init_bert, bert_forward


@TEXT_ENCODERS.register("clip_text")
@TEXT_ENCODERS.register("clip_text_model")
@TEXT_ENCODERS.register("siglip_text")
@TEXT_ENCODERS.register("siglip_text_model")
def _clip_text():
    from radzero_torch.models.clip_text import clip_text_forward, init_clip_text

    return init_clip_text, clip_text_forward


def build_vision_encoder(model_type: str):
    return VISION_ENCODERS.get(model_type)()


def build_text_encoder(model_type: str):
    return TEXT_ENCODERS.get(model_type)()


def vision_params_at_grid(params: dict, cfg, grid: int) -> dict:
    """The tower's parameters with their position tables resampled once to a grid
    x grid patch grid, as the tower's forward resamples them every call: the
    DINOv2 and CLIP / SigLIP tables (bicubic), SAM's absolute grid and global
    layers' relative tables; the MAE tower's sin-cos table is computed, so its
    parameters pass through."""
    mt = getattr(cfg, "model_type", "dinov2")
    if mt == "sam":
        from radzero_torch.models.sam_vit import sam_params_at_grid

        return sam_params_at_grid(params, cfg, grid)
    if mt in CLIP_TYPES:
        from radzero_torch.models.clip_vit import clip_params_at_grid

        return clip_params_at_grid(params, cfg, grid)
    if mt in MAE_TYPES:
        return params
    from radzero_torch.models.vit import interpolate_pos_embed

    return {**params, "pos_embed": interpolate_pos_embed(params["pos_embed"], (grid, grid))}
