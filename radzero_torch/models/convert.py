"""HF / PyTorch state dict -> the port's parameter tree, and back.

The name mapping is a copy of radzero_tpu/models/convert.py (pure numpy;
the port imports nothing of that package): callers pass ``{name:
np.ndarray}``, the ``convert_*`` functions return the JAX package's
layout, and the port's bridge
(:func:`radzero_torch.models.from_jax.params_from_jax`) takes it from
there: it packs q/k/v into ``attn.qkv`` and unstacks the layers
(``radzero_torch.tools.convert_checkpoint`` chains the two).

Weight-layout conventions translated:
- torch Linear weight (out, in)        -> kernel (in, out)        [transpose]
- torch Conv2d patch kernel (D,C,P,P)  -> (P*P*C, D) matching
  :func:`radzero_torch.models.vit.patchify`'s (ph, pw, c) ordering
- per-layer tensors stacked on a leading axis (the bridge unstacks them)
- ``loss_fns.RadZeroLoss.loss_temperature`` is already a log-temperature
  and becomes ``log_loss_temperature``

Source name schemas: HF ``Dinov2Model`` / ``Dinov2Encoder`` (the
reference's vision tower + align transformer,
exp/cxr_pt/model/vision_encoders.py:23-43, align_transformers.py:23-45)
and HF ``MPNetModel`` (text tower, text_encoders.py:8-28). SAM's
converter waits for the SAM tower (ROADMAP.md, item 9).

:func:`to_hf_state_dict` is the inverse for a RadZero tree: it writes the
HF names a snapshot holds (tests and ``chip_smoke.py`` make snapshots
with it; no serving or training path calls it).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from radzero_torch.models.configuration import RadZeroConfig
from radzero_torch.models.from_jax import params_to_numpy

Array = np.ndarray
StateDict = Dict[str, Array]


def _lin(sd: StateDict, name: str) -> dict:
    return {"kernel": sd[f"{name}.weight"].T.copy(), "bias": sd[f"{name}.bias"].copy()}


def _ln(sd: StateDict, name: str) -> dict:
    return {"scale": sd[f"{name}.weight"].copy(), "bias": sd[f"{name}.bias"].copy()}


def _stack(dicts: list) -> dict:
    """List of identical pytrees -> one pytree of stacked leaves."""
    out = {}
    for k, v in dicts[0].items():
        if isinstance(v, dict):
            out[k] = _stack([d[k] for d in dicts])
        else:
            out[k] = np.stack([d[k] for d in dicts], axis=0)
    return out


def convert_dinov2_layers(sd: StateDict, num_layers: int, prefix: str = "encoder.layer") -> dict:
    layers = []
    for i in range(num_layers):
        p = f"{prefix}.{i}"
        layers.append(
            {
                "ln1": _ln(sd, f"{p}.norm1"),
                "attn": {
                    "q": _lin(sd, f"{p}.attention.attention.query"),
                    "k": _lin(sd, f"{p}.attention.attention.key"),
                    "v": _lin(sd, f"{p}.attention.attention.value"),
                    "o": _lin(sd, f"{p}.attention.output.dense"),
                },
                "ls1": sd[f"{p}.layer_scale1.lambda1"].copy(),
                "ln2": _ln(sd, f"{p}.norm2"),
                "mlp": {
                    "fc1": _lin(sd, f"{p}.mlp.fc1"),
                    "fc2": _lin(sd, f"{p}.mlp.fc2"),
                },
                "ls2": sd[f"{p}.layer_scale2.lambda1"].copy(),
            }
        )
    return _stack(layers)


def convert_dinov2(sd: StateDict, num_layers: int, use_final_layernorm: bool = True) -> dict:
    """HF Dinov2Model state_dict -> vit params pytree."""
    w = sd["embeddings.patch_embeddings.projection.weight"]  # (D, C, P, P)
    d = w.shape[0]
    kernel = w.transpose(2, 3, 1, 0).reshape(-1, d).copy()  # (P*P*C, D), (ph,pw,c) order
    params = {
        "patch_embed": {
            "kernel": kernel,
            "bias": sd["embeddings.patch_embeddings.projection.bias"].copy(),
        },
        "cls_token": sd["embeddings.cls_token"].copy(),
        "pos_embed": sd["embeddings.position_embeddings"].copy(),
        "layers": convert_dinov2_layers(sd, num_layers),
    }
    if use_final_layernorm:
        params["final_ln"] = _ln(sd, "layernorm")
    return params


def convert_dinov2_encoder_only(sd: StateDict, num_layers: int, prefix: str = "layer") -> dict:
    """HF Dinov2Encoder (align transformer) state_dict -> stacked layers pytree."""
    return convert_dinov2_layers(sd, num_layers, prefix=prefix)


def _strip_prefix(sd: StateDict, prefix: str) -> StateDict:
    plen = len(prefix)
    return {k[plen:]: v for k, v in sd.items() if k.startswith(prefix)}


def convert_radzero_checkpoint(
    sd: StateDict,
    vision_layers: int = 12,
    align_layers: int = 2,
    text_layers: int = 12,
) -> dict:
    """Full reference CxrAlignModel state_dict -> the JAX package's tree.

    Source module layout (exp/cxr_pt/model/modeling.py:51-94):
        vision_model.*                       (HF Dinov2Model)
        align_transformer.transformer_layers.* (HF Dinov2Encoder)
        align_transformer.layer_norm.*       (optional)
        text_model.*                         (HF MPNetModel)
        text_projector.*                     (optional Linear)
        loss_fns.RadZeroLoss.layer_norm.*    shared modality LN
        loss_fns.RadZeroLoss.loss_temperature  log-temp scalar
        loss_fns.RadZeroLoss.attn_temperature  optional log-temp
    """
    params: dict = {
        "vision_model": convert_dinov2(_strip_prefix(sd, "vision_model."), vision_layers),
        "align_transformer": {
            "layers": convert_dinov2_layers(
                sd, align_layers, prefix="align_transformer.transformer_layers.layer"
            )
        },
        "text_model": convert_mpnet(_strip_prefix(sd, "text_model."), text_layers),
    }
    if "align_transformer.layer_norm.weight" in sd:
        params["align_transformer"]["layer_norm"] = _ln(sd, "align_transformer.layer_norm")
    if "text_projector.weight" in sd:
        params["text_projector"] = _lin(sd, "text_projector")

    loss: dict = {}
    if "loss_fns.RadZeroLoss.loss_temperature" in sd:
        loss["log_loss_temperature"] = sd["loss_fns.RadZeroLoss.loss_temperature"].copy()
    if "loss_fns.RadZeroLoss.attn_temperature" in sd:
        loss["log_attn_temperature"] = sd["loss_fns.RadZeroLoss.attn_temperature"].copy()
    if "loss_fns.RadZeroLoss.layer_norm.weight" in sd:
        loss["layer_norm"] = _ln(sd, "loss_fns.RadZeroLoss.layer_norm")
    params["loss_fns"] = {"RadZeroLoss": loss}

    clip: dict = {}
    if "loss_fns.OpenClipLoss.logit_scale" in sd:
        clip["log_logit_scale"] = sd["loss_fns.OpenClipLoss.logit_scale"].copy()
        params["loss_fns"]["OpenClipLoss"] = clip
    sig: dict = {}
    if "loss_fns.OpenSigLipLoss.logit_scale" in sd:
        sig["log_logit_scale"] = sd["loss_fns.OpenSigLipLoss.logit_scale"].copy()
        sig["logit_bias"] = sd["loss_fns.OpenSigLipLoss.logit_bias"].copy()
        params["loss_fns"]["OpenSigLipLoss"] = sig
    return params


def convert_mpnet(sd: StateDict, num_layers: int) -> dict:
    """HF MPNetModel state_dict -> mpnet params pytree."""
    layers = []
    for i in range(num_layers):
        p = f"encoder.layer.{i}"
        layers.append(
            {
                "attn": {
                    "q": _lin(sd, f"{p}.attention.attn.q"),
                    "k": _lin(sd, f"{p}.attention.attn.k"),
                    "v": _lin(sd, f"{p}.attention.attn.v"),
                    "o": _lin(sd, f"{p}.attention.attn.o"),
                },
                "ln_attn": _ln(sd, f"{p}.attention.LayerNorm"),
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
            "ln": _ln(sd, "embeddings.LayerNorm"),
        },
        "rel_bias": sd["encoder.relative_attention_bias.weight"].copy(),
        "layers": _stack(layers),
    }


# ---------------------------------------------------------------------------
# Back to HF names
# ---------------------------------------------------------------------------

def _hf_lin(out: dict, name: str, p: dict) -> None:
    out[f"{name}.weight"] = np.ascontiguousarray(p["kernel"].T)
    out[f"{name}.bias"] = p["bias"]


def _hf_ln(out: dict, name: str, p: dict) -> None:
    out[f"{name}.weight"], out[f"{name}.bias"] = p["scale"], p["bias"]


def _hf_dinov2_layers(out: dict, prefix: str, layers: list) -> None:
    for i, p in enumerate(layers):
        pre = f"{prefix}.{i}"
        d = p["ln1"]["scale"].shape[0]
        qkv = p["attn"]["qkv"]
        _hf_ln(out, f"{pre}.norm1", p["ln1"])
        for j, n in enumerate(("query", "key", "value")):
            _hf_lin(out, f"{pre}.attention.attention.{n}",
                    {"kernel": qkv["kernel"][:, j * d:(j + 1) * d],
                     "bias": qkv["bias"][j * d:(j + 1) * d]})
        _hf_lin(out, f"{pre}.attention.output.dense", p["attn"]["o"])
        out[f"{pre}.layer_scale1.lambda1"] = p["ls1"]
        _hf_ln(out, f"{pre}.norm2", p["ln2"])
        _hf_lin(out, f"{pre}.mlp.fc1", p["mlp"]["fc1"])
        _hf_lin(out, f"{pre}.mlp.fc2", p["mlp"]["fc2"])
        out[f"{pre}.layer_scale2.lambda1"] = p["ls2"]


def to_hf_state_dict(params: dict, cfg: RadZeroConfig) -> StateDict:
    """The port's RadZero tree -> ``{HF name: fp32 np.ndarray}``, the names
    :func:`convert_radzero_checkpoint` reads (and HF ``Dinov2Model``'s
    ``embeddings.mask_token``, which it does not). Only the
    ``align_transformer`` adapter has HF names."""
    if cfg.align.model_type != "align_transformer":
        raise ValueError(f"align adapter {cfg.align.model_type!r} has no HF names")
    params = params_to_numpy(params)
    out: StateDict = {}
    vm, p, c = params["vision_model"], cfg.vision.patch_size, cfg.vision.num_channels
    k = vm["patch_embed"]["kernel"]
    out["vision_model.embeddings.patch_embeddings.projection.weight"] = np.ascontiguousarray(
        k.reshape(p, p, c, k.shape[1]).transpose(3, 2, 0, 1))
    out["vision_model.embeddings.patch_embeddings.projection.bias"] = vm["patch_embed"]["bias"]
    out["vision_model.embeddings.cls_token"] = vm["cls_token"]
    out["vision_model.embeddings.mask_token"] = np.zeros((1, k.shape[1]), np.float32)
    out["vision_model.embeddings.position_embeddings"] = vm["pos_embed"]
    _hf_dinov2_layers(out, "vision_model.encoder.layer", vm["layers"])
    if "final_ln" in vm:
        _hf_ln(out, "vision_model.layernorm", vm["final_ln"])

    at = params["align_transformer"]
    _hf_dinov2_layers(out, "align_transformer.transformer_layers.layer", at["layers"])
    if "layer_norm" in at:
        _hf_ln(out, "align_transformer.layer_norm", at["layer_norm"])

    tm = params["text_model"]
    emb = tm["embeddings"]
    out["text_model.embeddings.word_embeddings.weight"] = emb["word"]
    out["text_model.embeddings.position_embeddings.weight"] = emb["position"]
    _hf_ln(out, "text_model.embeddings.LayerNorm", emb["ln"])
    out["text_model.encoder.relative_attention_bias.weight"] = tm["rel_bias"]
    for i, lp in enumerate(tm["layers"]):
        pre = f"text_model.encoder.layer.{i}"
        for n in "qkvo":
            _hf_lin(out, f"{pre}.attention.attn.{n}", lp["attn"][n])
        _hf_ln(out, f"{pre}.attention.LayerNorm", lp["ln_attn"])
        _hf_lin(out, f"{pre}.intermediate.dense", lp["mlp"]["fc1"])
        _hf_lin(out, f"{pre}.output.dense", lp["mlp"]["fc2"])
        _hf_ln(out, f"{pre}.output.LayerNorm", lp["ln_out"])
    if "text_projector" in params:
        _hf_lin(out, "text_projector", params["text_projector"])

    losses = params["loss_fns"]
    rz = losses.get("RadZeroLoss", {})
    if "log_loss_temperature" in rz:
        out["loss_fns.RadZeroLoss.loss_temperature"] = rz["log_loss_temperature"]
    if "log_attn_temperature" in rz:
        out["loss_fns.RadZeroLoss.attn_temperature"] = rz["log_attn_temperature"]
    if "layer_norm" in rz:
        _hf_ln(out, "loss_fns.RadZeroLoss.layer_norm", rz["layer_norm"])
    if "OpenClipLoss" in losses:
        out["loss_fns.OpenClipLoss.logit_scale"] = losses["OpenClipLoss"]["log_logit_scale"]
    if "OpenSigLipLoss" in losses:
        sig = losses["OpenSigLipLoss"]
        out["loss_fns.OpenSigLipLoss.logit_scale"] = sig["log_logit_scale"]
        out["loss_fns.OpenSigLipLoss.logit_bias"] = sig["logit_bias"]
    return out
