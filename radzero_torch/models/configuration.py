"""Model configuration dataclasses (port of radzero_tpu/models/configuration.py).

Same frozen dataclasses, fields and defaults as the JAX package, so the
YAML presets load unchanged through :func:`radzero_config_from_dict`.
``with_fused_towers`` and ``resolve_backend_impls`` have no counterpart:
the port picks kernel or plain twin by the tensor's device, and
``fused_towers=True`` (the default of ``compute_logits``, ``ServingEngine``
and ``ZeroShotScorer``) takes the place of ``with_fused_towers``: tower and
align layers on the fused K1-K3 layer. With ``fused_towers=False`` scoring
reads ``ViTConfig.attn_impl`` and ``AlignConfig.attn_impl`` as the JAX
package does ("flash": eager ops around K13; "packed": around K2;
"fused" / "fused_vjp": K1-K3; "xla": eager). ``forward_train`` reads
``AlignConfig.attn_impl`` ("fused_vjp", the default: the fused K1-K3 layer
with the backward kernels K6-K8; "packed": K2 / K7; "flash": K13 / K14;
"xla": the eager layers that autograd differentiates), and its tower
always runs the fused layer (trainable, it differentiates through K6-K8).
``TextConfig.attn_impl`` ("flash": K15 / K16, else eager attention) and
``TextConfig.fuse_post`` (K4 with its backward K9) are read in scoring and
in training alike, ``LossConfig.train_impl`` ("fused": the VL-CABS training
kernels K10-K12; else eager ops) in training.

Remat, in training only (``forward_train(..., remat=True)``, which
``TrainerArgs.gradient_checkpointing`` sets), with the JAX meanings:
``ViTConfig.remat_policy`` / ``AlignConfig.remat_policy`` pick what a
rematerialised DINOv2 layer keeps (None: its input only, the whole layer
recomputed in the backward; "save_attn": its input and the attention
output, only the pre-attention part recomputed; ``models/vit.py``),
``AlignConfig.remat`` and ``TextConfig.remat`` override the caller's flag
for the align layers and the MPNet tower when not None. A frozen tower runs
without a tape and ignores remat.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

_REMAT_POLICIES = (None, "save_attn")


def _check_remat_policy(policy: Optional[str]) -> None:
    if policy not in _REMAT_POLICIES:
        raise ValueError(
            f"unknown remat_policy {policy!r}; expected one of {_REMAT_POLICIES}"
        )


@dataclass(frozen=True)
class ViTConfig:
    """DINOv2-style ViT encoder config (HF Dinov2Config subset)."""

    model_type: str = "dinov2"    # dinov2 | raddino (same architecture)
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    mlp_ratio: float = 4.0
    patch_size: int = 14
    num_channels: int = 3
    layer_norm_eps: float = 1e-6
    layerscale_value: float = 1.0
    pretrain_img_size: int = 224  # grid the stored pos-embeds correspond to
    img_size: int = 518           # runtime resolution
    use_final_layernorm: bool = True
    attn_impl: str = "flash"      # read when fused_towers=False: "flash" = K13 / K14
    token_filter_ratio: float = 0.0  # > 0: drop this share of the patches (models/vit.py)
    token_filter_layer: int = 6      # ... before this layer
    # under remat: None = full per-layer recompute, "save_attn" = keep the
    # attention output, recompute only the pre-attention part (models/vit.py)
    remat_policy: Optional[str] = None

    def __post_init__(self):
        _check_remat_policy(self.remat_policy)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def intermediate_size(self) -> int:
        return int(self.hidden_size * self.mlp_ratio)

    @property
    def pos_grid(self) -> int:
        return self.pretrain_img_size // self.patch_size

    @property
    def patch_grid(self) -> int:
        return self.img_size // self.patch_size

    @property
    def seq_len(self) -> int:
        return 1 + self.patch_grid * self.patch_grid


@dataclass(frozen=True)
class AlignConfig:
    """Align-transformer config: N extra DINOv2 layers + optional trailing LN."""

    model_type: str = "align_transformer"  # align_transformer | identity | linear | mlp
    hidden_size: int = 768
    num_hidden_layers: int = 2
    num_attention_heads: int = 12
    mlp_ratio: float = 4.0
    layer_norm_eps: float = 1e-6
    layerscale_value: float = 1.0
    use_layer_norm: bool = False
    # None follows the caller's remat flag; True / False forces it for the
    # align layers alone
    remat: Optional[bool] = None
    # forward_train, and scoring with fused_towers=False: "fused_vjp" = K1-K3
    # with the K6-K8 backward, "packed" = K2 / K7, "flash" = K13 / K14,
    # "xla" = eager layers under autograd
    attn_impl: str = "fused_vjp"
    # see ViTConfig.remat_policy; read when the align layers run under remat
    remat_policy: Optional[str] = "save_attn"

    def __post_init__(self):
        _check_remat_policy(self.remat_policy)

    def as_vit(self) -> ViTConfig:
        return ViTConfig(
            hidden_size=self.hidden_size,
            num_hidden_layers=self.num_hidden_layers,
            num_attention_heads=self.num_attention_heads,
            mlp_ratio=self.mlp_ratio,
            layer_norm_eps=self.layer_norm_eps,
            layerscale_value=self.layerscale_value,
            use_final_layernorm=False,
            attn_impl=self.attn_impl,
            remat_policy=self.remat_policy,
        )


@dataclass(frozen=True)
class TextConfig:
    """MPNet text encoder config (HF MPNetConfig subset)."""

    model_type: str = "mpnet"
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    vocab_size: int = 30527
    max_position_embeddings: int = 514
    relative_attention_num_buckets: int = 32
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 1
    use_cls_token: bool = False        # False -> masked mean pooling
    use_text_projection: bool = False  # optional Linear(text_dim -> 2*hidden)
    pack_qkv: bool = False             # same math either way in the port
    attn_impl: str = "xla"             # "flash" = K15 / K16, else eager attention
    # True runs the post-attention chain through kernel K4, whose backward
    # under gradients is K9
    fuse_post: bool = True
    # None follows the caller's remat flag; True / False forces it for the
    # MPNet tower alone (full per-layer recompute)
    remat: Optional[bool] = None

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


@dataclass(frozen=True)
class LossConfig:
    """RadZeroLoss hyper-parameters."""

    hidden_dim: int = 768
    use_vision_cls_token: bool = True
    attn_temperature: Optional[float] = None  # None -> share loss_temperature
    loss_temperature: float = 0.07            # parameterised as log-temp
    text_features_l2_norm: bool = False
    mpnce_row_sum: bool = False
    mpnce_col_sum: bool = False
    sim_op: str = "cos"                       # cos | dot
    use_layer_norm: bool = True               # shared modality LN
    # forward_train: "fused" = kernels K10-K12 (cos only), else eager ops;
    # serving does not read it
    train_impl: str = "fused"


@dataclass(frozen=True)
class RadZeroConfig:
    """Composite model config."""

    vision: ViTConfig = dataclasses.field(default_factory=ViTConfig)
    text: TextConfig = dataclasses.field(default_factory=TextConfig)
    align: AlignConfig = dataclasses.field(default_factory=AlignConfig)
    loss: LossConfig = dataclasses.field(default_factory=LossConfig)
    compute_logits_type: str = "radzero"  # radzero | cls_alignment | global_alignment


def _filter_kwargs(cls, d: dict) -> dict:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in d.items() if k in names}


def _vision_config_from_dict(vc: dict) -> ViTConfig:
    mt = vc.get("model_type", "dinov2")
    if mt in ("dinov2", "raddino"):
        vc.setdefault("img_size", 518)
        return ViTConfig(**_filter_kwargs(ViTConfig, vc))
    raise NotImplementedError(
        f"vision model_type {mt!r} is not ported yet (alternate encoders "
        "are ROADMAP.md, modules still to port, item 9)"
    )


def radzero_config_from_dict(model_config: dict) -> RadZeroConfig:
    """Build a RadZeroConfig from the YAML ``model.model_config`` block."""
    vision = _vision_config_from_dict(dict(model_config.get("vision_config", {})))

    tc = dict(model_config.get("text_config", {}))
    text = TextConfig(**_filter_kwargs(TextConfig, tc))

    ac = dict(model_config.get("align_transformer_config", {}))
    align = AlignConfig(**_filter_kwargs(AlignConfig, ac))

    loss_block = model_config.get("loss", {}) or {}
    lc = dict(loss_block.get("RadZeroLoss", {}) or {})
    loss = LossConfig(**_filter_kwargs(LossConfig, lc))

    return RadZeroConfig(
        vision=vision,
        text=text,
        align=align,
        loss=loss,
        compute_logits_type=model_config.get("compute_logits_type", "radzero"),
    )
