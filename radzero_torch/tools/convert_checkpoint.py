"""Offline checkpoint converter: an HF / PyTorch snapshot -> the port's tree.

    python -m radzero_torch.tools.convert_checkpoint --src SNAPSHOT_DIR \
        --dst OUT_DIR --kind radzero

``--kind radzero``: a full reference CxrAlignModel checkpoint (the
Deepnoid/RadZero hub snapshot, or a Trainer checkpoint directory holding
``model.safetensors``); ``--kind dinov2``: a Dinov2Model checkpoint (the
XrayDINOv2 tower); ``--kind mpnet``: an MPNetModel checkpoint
(all-mpnet-base-v2).

Writes ``OUT_DIR/state.pt``: the port's parameter tree (the layout of
``radzero_torch.models.radzero.init_radzero``; the sub-tree of the tower for
dinov2 / mpnet) as fp32 CPU tensors, saved with ``torch.save`` as
``train/checkpoint.py`` saves its state. Beside it go the snapshot's
``vocab.txt`` (for :class:`radzero_torch.data.tokenizer.WordPieceTokenizer`;
a snapshot with only ``tokenizer.json`` has it extracted through
``transformers`` where that is installed) and ``processor_config.json``,
the image statistics from ``preprocessor_config.json``.
``radzero_torch.tools.run_real_checkpoint.load_converted`` reads it back.

The counterpart in the JAX package (tools/convert_checkpoint.py) writes
an Orbax directory. The port cannot read that without ``orbax``, which the
card's host lacks: convert the snapshot again with this tool.

Weights are read by the port's own safetensors reader
(``radzero_torch.utils.safetensors_io``) or, for ``.bin`` files, by
``torch.load(weights_only=True)``; every floating tensor becomes fp32.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil

import numpy as np
import torch

from radzero_torch.models import convert as cv
from radzero_torch.models.from_jax import params_from_jax
from radzero_torch.utils.safetensors_io import iter_tensors

STATE_FILE = "state.pt"


def _np(t: torch.Tensor) -> np.ndarray:
    return (t.float() if t.is_floating_point() else t).numpy()


def load_state_dict(src: str) -> dict:
    """{name: np.ndarray} from the ``.safetensors`` / ``.bin`` files of a
    directory (in name order) or from one file; floats as fp32."""
    files = []
    if os.path.isdir(src):
        for f in sorted(os.listdir(src)):
            if f.endswith(".safetensors") or f.endswith(".bin"):
                files.append(os.path.join(src, f))
    else:
        files = [src]
    if not files:
        raise FileNotFoundError(f"no weight files under {src}")

    sd = {}
    for path in files:
        if path.endswith(".safetensors"):
            for k, t in iter_tensors(path):
                sd[k] = _np(t)
        else:
            state = torch.load(path, map_location="cpu", weights_only=True)
            for k, v in state.items():
                sd[k] = _np(v)
    return sd


def strip_wrappers(sd: dict) -> dict:
    """Drop a ``model.`` / ``module.`` prefix that every name carries."""
    for prefix in ("model.", "module."):
        if sd and all(k.startswith(prefix) for k in sd):
            sd = {k[len(prefix):]: v for k, v in sd.items()}
    return sd


def n_layers(sd: dict, pat: str) -> int:
    """1 + the largest layer index after ``pat`` in any name (0 if none)."""
    idx = set()
    for k in sd:
        if pat in k:
            try:
                idx.add(int(k.split(pat)[1].split(".")[0]))
            except (ValueError, IndexError):
                pass
    return max(idx) + 1 if idx else 0


def convert_state_dict(sd: dict, kind: str) -> dict:
    """A snapshot's state dict (floats fp32, as :func:`load_state_dict`
    gives them) -> the port's tree of CPU tensors."""
    sd = strip_wrappers(sd)
    if kind == "radzero":
        return params_from_jax(cv.convert_radzero_checkpoint(
            sd,
            vision_layers=n_layers(sd, "vision_model.encoder.layer."),
            align_layers=n_layers(sd, "align_transformer.transformer_layers.layer."),
            text_layers=n_layers(sd, "text_model.encoder.layer."),
        ))
    if kind == "dinov2":
        tree = cv.convert_dinov2(sd, n_layers(sd, "encoder.layer."))
        return params_from_jax({"vision_model": tree})["vision_model"]
    if kind == "mpnet":
        tree = cv.convert_mpnet(sd, n_layers(sd, "encoder.layer."))
        return params_from_jax({"text_model": tree})["text_model"]
    raise ValueError(f"kind must be radzero, dinov2 or mpnet, got {kind!r}")


def carry_vocab(src_dir: str, dst: str) -> None:
    """vocab.txt beside the weights, or one extracted from an HF tokenizer
    (tokenizer.json-only snapshots, where transformers is installed)."""
    vocab_src = os.path.join(src_dir, "vocab.txt")
    if os.path.exists(vocab_src):
        shutil.copyfile(vocab_src, os.path.join(dst, "vocab.txt"))
        return
    try:
        from transformers import AutoTokenizer

        from radzero_torch.data.tokenizer import dump_hf_vocab

        tok = AutoTokenizer.from_pretrained(src_dir, local_files_only=True)
        dump_hf_vocab(tok, os.path.join(dst, "vocab.txt"))
    except Exception:  # no transformers, or no tokenizer files: no vocab.txt
        pass


def carry_processor_config(src_dir: str, dst: str) -> None:
    pc = os.path.join(src_dir, "preprocessor_config.json")
    if not os.path.exists(pc):
        return
    with open(pc) as f:
        conf = json.load(f)
    out = {
        "image_mean": conf.get("image_mean"),
        "image_std": conf.get("image_std"),
        "size": conf.get("size"),
        "resample": conf.get("resample"),
    }
    with open(os.path.join(dst, "processor_config.json"), "w") as f:
        json.dump(out, f, indent=2)


def convert(src: str, dst: str, kind: str = "radzero") -> dict:
    """Convert ``src`` into ``dst`` (created); -> the port's tree."""
    params = convert_state_dict(load_state_dict(src), kind)
    os.makedirs(dst, exist_ok=True)
    torch.save(params, os.path.join(dst, STATE_FILE))
    src_dir = src if os.path.isdir(src) else os.path.dirname(src)
    carry_vocab(src_dir, dst)
    carry_processor_config(src_dir, dst)
    return params


def _numel(tree) -> int:
    if isinstance(tree, dict):
        return sum(_numel(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(_numel(v) for v in tree)
    return tree.numel()


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="Convert an HF / PyTorch snapshot into the "
                                            "port's parameter tree (DST/state.pt).")
    p.add_argument("--src", required=True, help="snapshot directory or weight file")
    p.add_argument("--dst", required=True)
    p.add_argument("--kind", choices=["radzero", "dinov2", "mpnet"], default="radzero")
    a = p.parse_args(argv)
    params = convert(a.src, a.dst, a.kind)
    print(f"converted {a.kind}: {_numel(params) / 1e6:.1f}M params -> {a.dst}")


if __name__ == "__main__":
    main()
