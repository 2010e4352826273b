"""One-command runbook: a published RadZero snapshot -> the port's tree ->
zero-shot inference on the card (port of tools/run_real_checkpoint.py).

The Deepnoid/RadZero weights are fetched outside this tool; then:

    python -m radzero_torch.tools.run_real_checkpoint \
        --hub_snapshot /ckpt/radzero \
        --image chest_xray.jpg --text "There is pneumothorax" \
        --out out/

Steps performed:
1. Convert the snapshot into the port's tree
   (``radzero_torch.tools.convert_checkpoint --kind radzero``) unless
   ``--converted`` already points at a converted directory.
2. Build the tokenizer (:func:`checkpoint_tokenizer`: ``--tokenizer``, by
   default the converted directory's ``vocab.txt``) and the Blip-style
   image processor from the snapshot's ``preprocessor_config.json``.
3. Run the public API ``model_inference`` (eval/api.py) on (``--image``,
   ``--text``) on ``--device``; print similarity_prob and map statistics,
   save the map as .npy.
4. Where ``transformers`` and the snapshot's tokenizer files are present,
   hold the WordPiece tokenizer against the HF tokenizer on the real
   vocabulary (:func:`vocab_parity_check`).
5. ``--data_root`` + ``--tasks`` (or ``--datasets``): run the zero-shot eval
   suite through the port's ``Inference`` and write result.json.

The JAX runbook's ``--torch_check`` (the JAX package against HF's torch
modules) has no counterpart: the port is held against the JAX package by
its CPU tests.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from radzero_torch.models.configuration import (
    AlignConfig,
    RadZeroConfig,
    TextConfig,
    ViTConfig,
)
from radzero_torch.tools.convert_checkpoint import STATE_FILE

DEFAULT_HF_TOKENIZER = "sentence-transformers/all-mpnet-base-v2"


def load_converted(converted_dir: str, cfg=None):
    """-> (the port's tree as CPU tensors, config). The default config is
    the flagship's widths at ``img_size=518``, as the JAX runbook's, with
    what the tree itself says read off it: ``pretrain_img_size`` from the
    stored position table (the XrayDINOv2 tower ships a 37 x 37 table,
    radzero.yaml:17-19, hub dinov2-base a 16 x 16 one), each tower's depth,
    and whether the align LayerNorm and the text projector are present."""
    params = torch.load(os.path.join(converted_dir, STATE_FILE), map_location="cpu",
                        weights_only=True)
    if cfg is None:
        vm, at = params["vision_model"], params["align_transformer"]
        grid = int(round((vm["pos_embed"].shape[1] - 1) ** 0.5))
        cfg = RadZeroConfig(
            vision=ViTConfig(pretrain_img_size=grid * ViTConfig.patch_size, img_size=518,
                             num_hidden_layers=len(vm["layers"])),
            align=AlignConfig(num_hidden_layers=len(at["layers"]),
                              use_layer_norm="layer_norm" in at),
            text=TextConfig(num_hidden_layers=len(params["text_model"]["layers"]),
                            use_text_projection="text_projector" in params),
        )
    return params, cfg


def build_processor(converted_dir: str):
    from radzero_torch.data.processing import CLIP_MEAN, CLIP_STD, BlipStyleImageProcessor

    pc = os.path.join(converted_dir, "processor_config.json")
    mean, std, size = CLIP_MEAN, CLIP_STD, 518
    if os.path.exists(pc):
        with open(pc) as f:
            conf = json.load(f)
        mean = tuple(conf.get("image_mean") or mean)
        std = tuple(conf.get("image_std") or std)
        s = conf.get("size")
        if isinstance(s, dict):
            size = s.get("height") or s.get("shortest_edge") or size
        elif isinstance(s, int):
            size = s
    return BlipStyleImageProcessor(size=size, mean=mean, std=std)


def checkpoint_tokenizer(converted_dir: str, tokenizer=None, max_length: int = 64,
                         vocab_size: int = 30527):
    """``tokenizer`` (a vocab.txt, a directory holding one, or an HF name;
    :func:`radzero_torch.data.tokenizer.load_tokenizer`) when given, else the
    converted directory's vocab.txt, else the hash tokenizer, with a warning.
    Nothing here reaches for the hub unless ``tokenizer`` names it."""
    from radzero_torch.data.tokenizer import WhitespaceHashTokenizer, load_tokenizer
    from radzero_torch.utils.logging import logger

    if tokenizer is None and os.path.isfile(os.path.join(converted_dir, "vocab.txt")):
        tokenizer = converted_dir
    if tokenizer is not None:
        return load_tokenizer(tokenizer, max_length=max_length)
    logger.warning(f"{converted_dir} holds no vocab.txt and no tokenizer was given: the hash "
                   "tokenizer's ids do not match a pretrained text tower's vocabulary")
    return WhitespaceHashTokenizer(vocab_size=vocab_size, max_length=max_length)


# The reference's full zero-shot registry (exp/cxr_pt/inference/
# inference.py:36-170 + inference/utils.py:109-178): which task family
# each dataset belongs to. ChestXDet10 runs BOTH classification (CARZero
# merger, external/CARZero/inference.py:371-418) and grounding.
CLS_SETS = ["OpenI", "PadChest", "ChestXray14", "Chexpert", "ChestXDet10"]
DET_SETS = ["ChestXDet10", "MS-CXR"]
SEG_SETS = ["SIIM", "RSNA"]
FULL_REGISTRY = ["OpenI", "PadChest", "ChestXray14", "Chexpert",
                 "ChestXDet10", "MS-CXR", "SIIM", "RSNA"]


def select_datasets(data_root: str):
    """(present, absent) split of the full registry by on-disk files."""
    from radzero_torch.eval.registry import get_infer_dirs

    dirs = get_infer_dirs(data_root)
    present, absent = [], []
    for name in FULL_REGISTRY:
        if all(os.path.exists(p) for p in dirs[name].values()):
            present.append(name)
        else:
            absent.append(name)
    return present, absent


# Representative + adversarial probe corpus for the tokenizer parity
# dump: real prompt shapes, casing/accents/unicode, long words that
# force WordPiece splits, and degenerate inputs.
VOCAB_PROBE_SENTENCES = [
    "There is pneumothorax",
    "There is no focal consolidation of the left lower lobe.",
    "There may be mild cardiomegaly with small bilateral pleural effusions",
    "Hazy bibasilar opacities, likely atelectasis; cannot exclude pneumonia.",
    "Lungs are clear. No effusion, edema, or pneumothorax.",
    "post-surgical changes from CABG, stable since 2019-03-12",
    "IMPRESSION: 1. Unchanged right PICC line tip at the cavoatrial junction",
    "costophrenic angle blunting (possible trace effusion?)",
    "naïve café coördinate — ümlaut test",
    "supercalifragilisticexpialidocious hypertransradiancy",
    "漢字 mixed with latin words",
    "",
    "   ",
    "UPPERCASE SENTENCE WITH Pneumothorax AND Effusion!!!",
]


def vocab_parity_check(converted_dir: str, hf_source: str, max_length: int = 64):
    """Token-for-token parity of the WordPiece tokenizer against the HF
    tokenizer on the real vocabulary: compares (ids, mask) over
    VOCAB_PROBE_SENTENCES. Returns None (with a printed line) when either
    side is unavailable, e.g. without transformers or tokenizer files."""
    vocab_path = os.path.join(converted_dir, "vocab.txt")
    if not os.path.exists(vocab_path):
        print(f"vocab parity: skipped ({vocab_path} not found)")
        return None
    try:
        from transformers import AutoTokenizer

        hf_tok = AutoTokenizer.from_pretrained(hf_source, local_files_only=True)
    except Exception as e:
        print(f"vocab parity: skipped (HF tokenizer unavailable: {e})")
        return None

    from radzero_torch.data.tokenizer import WordPieceTokenizer

    ours = WordPieceTokenizer(vocab_path, style="mpnet", max_length=max_length)
    enc = hf_tok(
        VOCAB_PROBE_SENTENCES, padding="max_length", truncation=True,
        max_length=max_length, return_tensors="np",
    )
    ids_hf = enc["input_ids"].astype(np.int32)
    mask_hf = enc["attention_mask"].astype(np.int32)
    ids_ours, mask_ours = ours(VOCAB_PROBE_SENTENCES, max_length)

    mism = [
        i for i in range(len(VOCAB_PROBE_SENTENCES))
        if not (np.array_equal(ids_hf[i], ids_ours[i])
                and np.array_equal(mask_hf[i], mask_ours[i]))
    ]
    report = {
        "vocab_path": vocab_path,
        "n_sentences": len(VOCAB_PROBE_SENTENCES),
        "n_mismatched": len(mism),
        "token_for_token": not mism,
    }
    if mism:
        i = mism[0]
        report["first_mismatch"] = {
            "text": VOCAB_PROBE_SENTENCES[i],
            "hf_ids": ids_hf[i][mask_hf[i] == 1].tolist(),
            "our_ids": ids_ours[i][mask_ours[i] == 1].tolist(),
        }
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description="Convert a RadZero snapshot and run zero-shot "
                                             "inference and the eval suite on it.")
    ap.add_argument("--hub_snapshot", help="Deepnoid/RadZero snapshot dir (HF / PyTorch)")
    ap.add_argument("--converted", help="already-converted dir (skip conversion)")
    ap.add_argument("--image", help="input image (jpg/png/dcm)")
    ap.add_argument("--text", nargs="*", default=["There is pneumothorax"])
    ap.add_argument("--tokenizer", help="vocab.txt, a directory holding one, or an HF "
                                        "tokenizer name; default: the converted directory "
                                        "when it holds vocab.txt, else the hash tokenizer")
    ap.add_argument("--config", help="model_config JSON (the YAML model.model_config "
                                     "block shape) overriding the flagship default, "
                                     "for snapshots with non-default dims")
    ap.add_argument("--batch_size", type=int, default=64,
                    help="eval scorer batch size (partial batches pad to it)")
    ap.add_argument("--data_root", help="benchmark datasets root for the eval suite")
    ap.add_argument("--tasks", nargs="*", default=[],
                    help="e.g. Chexpert ChestXDet10 SIIM RSNA MS-CXR")
    ap.add_argument("--datasets", action="store_true",
                    help="run the FULL zero-shot registry; datasets whose files are "
                         "missing under --data_root are listed and skipped")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="real_ckpt_out")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    converted = args.converted
    if converted is None:
        if not args.hub_snapshot:
            ap.error("need --hub_snapshot or --converted")
        converted = os.path.join(args.out, "converted")
        from radzero_torch.tools.convert_checkpoint import convert

        convert(args.hub_snapshot, converted, "radzero")

    cfg_override = None
    if args.config:
        from radzero_torch.models.configuration import radzero_config_from_dict

        with open(args.config) as f:
            cfg_override = radzero_config_from_dict(json.load(f))
    params, cfg = load_converted(converted, cfg=cfg_override)
    processor = build_processor(converted)
    tokenizer = checkpoint_tokenizer(converted, args.tokenizer,
                                     vocab_size=cfg.text.vocab_size)

    if args.image:
        from radzero_torch.eval.api import model_inference

        probs, maps = model_inference(
            args.image, args.text, tokenizer, processor, (params, cfg), device=args.device
        )
        np.save(os.path.join(args.out, "similarity_map.npy"), maps)
        report = {
            "similarity_prob": probs.tolist(),
            "map_shape": list(maps.shape),
            "map_minmax": [float(maps.min()), float(maps.max())],
        }
        print(json.dumps(report, indent=2))
        with open(os.path.join(args.out, "inference.json"), "w") as f:
            json.dump(report, f, indent=2)

    vocab_parity = vocab_parity_check(
        converted, args.hub_snapshot or args.tokenizer or DEFAULT_HF_TOKENIZER
    )
    if vocab_parity is not None:
        print(json.dumps({"vocab_parity": vocab_parity}, indent=2))

    tasks = list(args.tasks)
    if args.datasets:
        if not args.data_root:
            ap.error("--datasets requires --data_root")
        tasks, absent = select_datasets(args.data_root)
        if absent:
            print(f"--datasets: skipping absent datasets: {absent}")
        print(f"--datasets: running {tasks}")

    if tasks:
        if not args.data_root:
            ap.error("--tasks requires --data_root")
        from radzero_torch.eval.inference import Inference
        from radzero_torch.eval.scorer import ZeroShotScorer

        scorer = ZeroShotScorer(params, cfg, processor, tokenizer, device=args.device,
                                batch_size=args.batch_size, dtype=torch.float32)
        # ChestXDet10 belongs to BOTH classification and grounding; unknown
        # names fall through to classification
        cls = [t for t in tasks if t in CLS_SETS or t not in (DET_SETS + SEG_SETS)]
        det = [t for t in tasks if t in DET_SETS]
        seg = [t for t in tasks if t in SEG_SETS]
        inf = Inference(cls, det, seg, args.data_root, batch_size=args.batch_size)
        results = {}
        if vocab_parity is not None:
            results["vocab_parity"] = vocab_parity
        if cls:
            results["classification"] = inf.classification(scorer, os.path.join(args.out, "cls"))
        if det:
            results["grounding"] = inf.grounding(scorer, os.path.join(args.out, "det"))
        if seg:
            results["segmentation"] = inf.segmentation(scorer, os.path.join(args.out, "seg"))
        with open(os.path.join(args.out, "result.json"), "w") as f:
            json.dump(results, f, indent=2, default=float)
        print(json.dumps(results, indent=2, default=float))


if __name__ == "__main__":
    main()
