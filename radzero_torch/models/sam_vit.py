"""SAM (Segment Anything) ViT-det vision encoder (port of
radzero_tpu/models/sam_vit.py).

The reference ACCEPTS ``model_type: "sam"`` in its config/processing
plumbing (exp/cxr_pt/model/configuration.py:22, processing.py:29) but
its encoder factory has no branch for it, so a "sam" config crashes
with NotImplementedError (exp/cxr_pt/model/vision_encoders.py:23-43).
The JAX package implements the tower with HF ``SamVisionEncoder``
semantics (modeling_sam.py); this is its port on plain torch ops.

Architecture (per HF SamVisionEncoder):
- patch-16 embedding kept as a 2-D feature map (B, H, W, D): patchify and
  one product;
- learned ABSOLUTE position embedding at the pretrain grid (no CLS
  token anywhere in the trunk), resampled bicubically when the runtime
  grid differs (the JAX package's extension; HF errors there);
- pre-LN blocks with windowed attention (window ``window_size``, zero
  padding at the grid edge: 64 -> 70, 25 windows of 196 tokens at 1024 px)
  except at ``global_attn_indexes``, which attend over the full grid
  (4096 tokens at 1024 px);
- decomposed RELATIVE position bias (MViTv2 style): per-layer learned
  tables rel_pos_h/rel_pos_w indexed by axial offset, linearly resampled
  when their length differs from 2 * size - 1, added to the scores as
  rel_h[:, :, :, None] + rel_w[:, :, None, :];
- a convolutional "neck" (1x1 -> LN -> 3x3 -> LN, both convs bias-free)
  projecting to ``output_channels``.

The attention materialises its scores and the decomposed bias as the JAX
package does, (B, 12, 4096, 4096) each in a global layer at 1024 px: about
0.8 GB an image per tensor in fp32 and 0.4 GB in bf16. The resamples are
``F.interpolate`` in fp32 (:mod:`radzero_torch.ops.resize`), whose semantics
the JAX package's interpolation matrices reproduce.

Composite-model integration (the JAX package's design; the reference
has none): :func:`sam_vit_forward` returns (B, 1 + H*W, D) tokens where
slot 0 is the mean-pooled trunk feature standing in for the CLS token
the align stage expects, and patch tokens are the PRE-neck trunk map.
The neck is exposed separately (:func:`sam_neck`).

Parameters: the JAX layout as it is, layers in a LIST (window and global
layers carry rel-pos tables of different shapes).

Over a model group ``tp`` (the parameters this rank's share,
``parallel/tensor_parallel.py``) only the MLP splits, as the JAX rules split
this tree: fc1 column-parallel, fc2 row-parallel (the partials all-reduced,
then fc2's whole bias). The packed ``qkv`` and ``proj`` sit at
``layers/i/qkv`` and ``layers/i/proj``, where the rules' ``attn/`` patterns
do not reach, so the attention, its decomposed relative-position bias and
its windows run whole on every rank, as does the neck.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F

from radzero_torch.models.vit import _init_linear, _init_ln, _normal, patchify
from radzero_torch.ops.layers import attention, column_linear, gelu, layer_norm, linear, row_linear
from radzero_torch.parallel.tensor_parallel import active
from radzero_torch.ops.resize import bicubic_resize_2d, linear_resize_1d


@dataclass(frozen=True)
class SamViTConfig:
    """HF ``SamVisionConfig`` subset (facebook/sam-vit-base defaults)."""

    model_type: str = "sam"
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    mlp_dim: int = 3072
    patch_size: int = 16
    num_channels: int = 3
    image_size: int = 1024          # pretrain grid the abs-pos embeds store
    img_size: int = 1024            # runtime resolution (must divide patch)
    window_size: int = 14
    global_attn_indexes: Tuple[int, ...] = (2, 5, 8, 11)
    use_rel_pos: bool = True
    use_abs_pos: bool = True
    qkv_bias: bool = True
    layer_norm_eps: float = 1e-6
    output_channels: int = 256

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def pos_grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def patch_grid(self) -> int:
        return self.img_size // self.patch_size

    def layer_window(self, i: int) -> int:
        """Window size for layer i (0 = global attention), as HF builds
        its layers (SamVisionEncoder.__init__)."""
        return 0 if i in self.global_attn_indexes else self.window_size

    def layer_input_size(self, i: int) -> int:
        """Grid edge the layer's rel-pos tables are stored for."""
        w = self.layer_window(i)
        return self.pos_grid if w == 0 else w


def init_sam_vit(g: torch.Generator, cfg: SamViTConfig) -> dict:
    d, hd, dev = cfg.hidden_size, cfg.head_dim, g.device
    params: dict = {"patch_embed": _init_linear(g, cfg.patch_size**2 * cfg.num_channels, d)}
    if cfg.use_abs_pos:
        params["pos_embed"] = torch.zeros((1, cfg.pos_grid, cfg.pos_grid, d), device=dev)
    layers = []
    for i in range(cfg.num_hidden_layers):
        layer = {
            "ln1": _init_ln(g, d),
            "qkv": _init_linear(g, d, 3 * d),
            "proj": _init_linear(g, d, d),
            "ln2": _init_ln(g, d),
            "mlp": {"fc1": _init_linear(g, d, cfg.mlp_dim), "fc2": _init_linear(g, cfg.mlp_dim, d)},
        }
        if not cfg.qkv_bias:
            del layer["qkv"]["bias"]
        if cfg.use_rel_pos:
            edge = cfg.layer_input_size(i)
            layer["rel_pos_h"] = torch.zeros((2 * edge - 1, hd), device=dev)
            layer["rel_pos_w"] = torch.zeros((2 * edge - 1, hd), device=dev)
        layers.append(layer)
    params["layers"] = layers
    c = cfg.output_channels
    params["neck"] = {
        # conv1: 1x1, stored as a (D, out) matmul kernel; conv2: 3x3 HWIO
        "conv1": _normal(g, (d, c)),
        "ln1": _init_ln(g, c),
        "conv2": _normal(g, (3, 3, c, c)),
        "ln2": _init_ln(g, c),
    }
    return params


# ---------------------------------------------------------------------------
# Relative position bias
# ---------------------------------------------------------------------------

def resample_rel_pos(rel_pos: torch.Tensor, size: int) -> torch.Tensor:
    """The stored (L, hd) table at length 2 * size - 1: HF ``get_rel_pos``'s
    linear resample (align_corners=False) in fp32, in the table's dtype; a
    table already at that length passes through."""
    need = 2 * size - 1
    if rel_pos.shape[0] == need:
        return rel_pos
    return linear_resize_1d(rel_pos.T, need).T.to(rel_pos.dtype)


def _rel_pos_table(rel_pos: torch.Tensor, size: int) -> torch.Tensor:
    """(L, hd) stored table -> (size, size, hd) axial offset table, indexed
    with offset (q - k) + size - 1 (HF ``get_rel_pos`` with q_size == k_size)."""
    rel_pos = resample_rel_pos(rel_pos, size)
    idx = torch.arange(size)[:, None] - torch.arange(size)[None, :] + size - 1
    return rel_pos[idx.to(rel_pos.device)]


def _decomposed_rel_bias(q: torch.Tensor, rel_pos_h: torch.Tensor, rel_pos_w: torch.Tensor,
                         h: int, w: int) -> torch.Tensor:
    """Scores bias (Bn, heads, h*w, h*w) from axial tables; ``q`` is (Bn, h*w,
    heads, hd). HF get_decomposed_rel_pos: rel_h[:, :, :, None] + rel_w[:, :, None, :]
    over (qh, qw, kh, kw)."""
    bn, _, heads, hd = q.shape
    rh = _rel_pos_table(rel_pos_h, h).to(q.dtype)  # (h, h, hd)
    rw = _rel_pos_table(rel_pos_w, w).to(q.dtype)  # (w, w, hd)
    qg = q.reshape(bn, h, w, heads, hd)
    rel_h = torch.einsum("bhwnc,hkc->bnhwk", qg, rh)
    rel_w = torch.einsum("bhwnc,wkc->bnhwk", qg, rw)
    bias = rel_h[..., :, None] + rel_w[..., None, :]   # (bn, heads, h, w, kh, kw)
    return bias.reshape(bn, heads, h * w, h * w)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _window_partition(x: torch.Tensor, win: int):
    """(B, H, W, D) -> (B*nW, win, win, D) with zero edge padding."""
    b, h, w, d = x.shape
    ph, pw = -h % win, -w % win
    if ph or pw:
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
    hh, ww = h + ph, w + pw
    x = x.reshape(b, hh // win, win, ww // win, win, d).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, win, win, d), (hh, ww)


def _window_unpartition(x: torch.Tensor, win: int, padded_hw, orig_hw):
    hh, ww = padded_hw
    h, w = orig_hw
    b = x.shape[0] // (hh // win * (ww // win))
    x = x.reshape(b, hh // win, ww // win, win, win, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, hh, ww, -1)[:, :h, :w]


def _sam_attention(x: torch.Tensor, p: dict, cfg: SamViTConfig) -> torch.Tensor:
    """Attention over a (Bn, h, w, D) feature map (window or full grid)."""
    bn, h, w, d = x.shape
    heads, hd = cfg.num_attention_heads, cfg.head_dim
    qkv = linear(x.reshape(bn, h * w, d), p["qkv"])  # (Bn, hw, 3D)
    q, k, v = qkv.reshape(bn, h * w, 3, heads, hd).unbind(2)  # (Bn, hw, heads, hd)
    # the bias is passed, not kept, so that attention frees it after the sum
    out = attention(q, k, v, bias=_decomposed_rel_bias(q, p["rel_pos_h"], p["rel_pos_w"], h, w)
                    if cfg.use_rel_pos else None)
    return linear(out.reshape(bn, h, w, d), p["proj"])


def sam_layer(x: torch.Tensor, p: dict, cfg: SamViTConfig, window: int,
              tp=None) -> torch.Tensor:
    """One ViT-det block on the (B, H, W, D) map (HF SamVisionLayer); over a
    model group ``tp`` the MLP alone splits (see the module docstring)."""
    h = layer_norm(x, p["ln1"], cfg.layer_norm_eps)
    if window > 0:
        orig_hw = h.shape[1], h.shape[2]
        h, padded_hw = _window_partition(h, window)
        h = _window_unpartition(_sam_attention(h, p, cfg), window, padded_hw, orig_hw)
    else:
        h = _sam_attention(h, p, cfg)
    x = x + h
    m = layer_norm(x, p["ln2"], cfg.layer_norm_eps)
    return x + row_linear(gelu(column_linear(m, p["mlp"]["fc1"], tp)), p["mlp"]["fc2"], tp)


def _interpolate_abs_pos(pos: torch.Tensor, grid_hw) -> torch.Tensor:
    """(1, G, G, D) -> (1, h, w, D) by a bicubic resample in fp32, in ``pos``'s
    dtype (as :func:`radzero_torch.models.vit.interpolate_pos_embed`). HF SAM has no runtime resizing (it errors on a
    mismatched input size); the JAX package's extension, so the tower runs at
    other resolutions."""
    h, w = grid_hw
    if (h, w) == tuple(pos.shape[1:3]):
        return pos
    grid = bicubic_resize_2d(pos.permute(0, 3, 1, 2), h, w)
    return grid.permute(0, 2, 3, 1).to(pos.dtype)


def sam_trunk(params: dict, cfg: SamViTConfig, pixel_values: torch.Tensor, *,
              dtype=torch.float32, tp=None) -> torch.Tensor:
    """Patch embed + abs pos + all blocks -> (B, h, w, D) feature map
    (HF SamVisionEncoder up to, excluding, the neck); ``tp``: a model group."""
    tp = active(tp)
    b, hh, ww, _ = pixel_values.shape
    h, w = hh // cfg.patch_size, ww // cfg.patch_size
    x = linear(patchify(pixel_values.to(dtype), cfg.patch_size), params["patch_embed"])
    x = x.reshape(b, h, w, cfg.hidden_size)
    if cfg.use_abs_pos:
        x = x + _interpolate_abs_pos(params["pos_embed"], (h, w)).to(dtype)
    for i, p in enumerate(params["layers"]):
        x = sam_layer(x, p, cfg, cfg.layer_window(i), tp)
    return x


def sam_neck(params: dict, cfg: SamViTConfig, fmap: torch.Tensor) -> torch.Tensor:
    """Convolutional neck: (B, h, w, D) -> (B, h, w, output_channels), NHWC as
    the JAX package runs it: the 1x1 conv is one product and both LayerNorms
    normalise the trailing channel axis."""
    p = params["neck"]
    x = layer_norm(fmap @ p["conv1"].to(fmap.dtype), p["ln1"], 1e-6)
    w = p["conv2"].to(x.dtype).permute(3, 2, 0, 1)  # HWIO -> OIHW
    x = F.conv2d(x.permute(0, 3, 1, 2), w, padding=1).permute(0, 2, 3, 1)
    return layer_norm(x, p["ln2"], 1e-6)


def sam_vit_forward(params: dict, cfg: SamViTConfig, pixel_values: torch.Tensor, *,
                    dtype=torch.float32, tp=None) -> torch.Tensor:
    """Composite-model entry: (B, H, W, C) -> (B, 1 + h*w, D) tokens.

    Slot 0 is the mean-pooled trunk feature (SAM has no CLS token; the
    align stage and RadZeroLoss expect a pooled prefix slot — the convention
    the m3ae tower uses for its global latent)."""
    fmap = sam_trunk(params, cfg, pixel_values, dtype=dtype, tp=tp)
    b, h, w, d = fmap.shape
    tokens = fmap.reshape(b, h * w, d)
    return torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1)


def sam_params_at_grid(params: dict, cfg: SamViTConfig, grid: int) -> dict:
    """``params`` with the absolute position grid and the global layers'
    relative tables resampled to a grid x grid patch grid once, as
    :func:`sam_vit_forward` resamples them every call (which then passes them
    through). Window layers keep their tables: their size is the window."""
    out = dict(params)
    if "pos_embed" in params:
        out["pos_embed"] = _interpolate_abs_pos(params["pos_embed"], (grid, grid))
    layers = []
    for i, p in enumerate(params["layers"]):
        if cfg.layer_window(i) == 0 and "rel_pos_h" in p:
            p = {**p, "rel_pos_h": resample_rel_pos(p["rel_pos_h"], grid),
                 "rel_pos_w": resample_rel_pos(p["rel_pos_w"], grid)}
        layers.append(p)
    out["layers"] = layers
    return out
