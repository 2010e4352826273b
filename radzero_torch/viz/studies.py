"""Prompt-study and dataset-sampled visualization flows (port of
radzero_tpu/viz/studies.py).

Rebuilds the reference's study scripts (openvocab_attention_map.py:
172-451, pos_neg_attention_map.py, visualize_utils.py:153-280):

- open-vocabulary studies: arbitrary free-text prompts over one image;
- positional prompts: left/right lateralized phrasing pairs;
- positive/negative prompt pairs ("There is X" vs "There is no X");
- dataset-sampled flows: draw N samples from ChestXDet10 / SIIM /
  RSNA with their ground truth and render overlay panels.

The samplers read their CSVs with :mod:`radzero_torch.eval._table` (which
gives ``pd.read_csv``'s column types) in place of pandas, and draw the
same ``np.random.default_rng(seed)`` picks as the JAX package.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from radzero_torch.eval._table import isna, read_csv
from radzero_torch.eval.metrics import rle2mask
from radzero_torch.eval.registry import get_infer_dirs
from radzero_torch.eval.scorer import ZeroShotScorer
from radzero_torch.utils.json_io import load_json
from radzero_torch.viz.overlays import render_attention_panel

DEFAULT_OPEN_VOCAB_PROMPTS = [
    "There is Atelectasis",
    "There is Cardiomegaly",
    "There is Pleural Effusion",
    "There is Pneumothorax",
    "There is Consolidation",
    "There is no finding",
]

POSITIONAL_PROMPT_PAIRS = [
    ("There is left pleural effusion", "There is right pleural effusion"),
    ("There is left lung opacity", "There is right lung opacity"),
    ("There is left pneumothorax", "There is right pneumothorax"),
]


def open_vocab_study(
    scorer: ZeroShotScorer,
    image_path: str,
    save_dir: str,
    prompts: Optional[List[str]] = None,
) -> str:
    prompts = prompts or DEFAULT_OPEN_VOCAB_PROMPTS
    out = os.path.join(save_dir, "open_vocab.png")
    render_attention_panel(scorer, image_path, prompts, out)
    return out


def positional_prompt_study(
    scorer: ZeroShotScorer, image_path: str, save_dir: str
) -> List[str]:
    """Left/right lateralization panels (openvocab_attention_map.py:302-451)."""
    outs = []
    for i, (left, right) in enumerate(POSITIONAL_PROMPT_PAIRS):
        out = os.path.join(save_dir, f"positional_{i}.png")
        render_attention_panel(scorer, image_path, [left, right], out, ncols=3)
        outs.append(out)
    return outs


def pos_neg_prompt_study(
    scorer: ZeroShotScorer, image_path: str, save_dir: str, findings: List[str]
) -> List[str]:
    """'There is X' vs 'There is no X' panels (pos_neg_attention_map.py)."""
    outs = []
    for f in findings:
        out = os.path.join(save_dir, f"posneg_{f.replace(' ', '_')}.png")
        render_attention_panel(
            scorer, image_path, [f"There is {f}", f"There is no {f}"], out, ncols=3
        )
        outs.append(out)
    return outs


def visualize_chestxdet10_samples(
    scorer: ZeroShotScorer,
    data_root_dir: str,
    save_dir: str,
    num_samples: int = 8,
    seed: int = 0,
) -> List[str]:
    """Sampled ChestXDet10 overlays with GT boxes (visualize_utils.py:153-200)."""
    dirs = get_infer_dirs(data_root_dir)
    test = load_json(os.path.join(data_root_dir, "ChestXDet10/test.json"))
    images = read_csv(dirs["ChestXDet10"]["image_path"])["Path"].tolist()

    rng = np.random.default_rng(seed)
    positives = [i for i, t in enumerate(test) if t["syms"]]
    picks = rng.choice(positives, min(num_samples, len(positives)), replace=False)

    outs = []
    for i in picks:
        entry = test[i]
        prompts = [f"There is {s}" for s in dict.fromkeys(entry["syms"])]
        out = os.path.join(save_dir, f"chestxdet10_{i}.png")
        render_attention_panel(
            scorer,
            os.path.join(data_root_dir, images[i]),
            prompts,
            out,
            boxes=entry["boxes"],
        )
        outs.append(out)
    return outs


def visualize_siim_samples(
    scorer: ZeroShotScorer,
    data_root_dir: str,
    save_dir: str,
    num_samples: int = 8,
    seed: int = 0,
) -> List[str]:
    """Sampled SIIM overlays with GT mask contours (visualize_utils.py:203-240)."""
    from radzero_torch.data.dicom import load_eval_image

    dirs = get_infer_dirs(data_root_dir)
    data = read_csv(dirs["SIIM"]["data_path"])
    image_ids, paths = data["ImageId"].tolist(), data["dicom_path"].tolist()
    encoded = data[" EncodedPixels"].tolist()
    # the positives' ImageIds in order of first appearance (Series.unique)
    ids = list(dict.fromkeys(i for i, e in zip(image_ids, encoded) if e != " -1"))
    rng = np.random.default_rng(seed)
    picks = rng.choice(len(ids), min(num_samples, len(ids)), replace=False)

    outs = []
    for j in picks:
        rows = [r for r, i in enumerate(image_ids) if i == ids[j]]
        path = os.path.join(data_root_dir, paths[rows[0]])
        with load_eval_image(path) as im:
            w, h = im.size
        mask = np.zeros([h, w])
        for e in (encoded[r] for r in rows):
            if e != " -1":
                mask += rle2mask(e, h, w)
        out = os.path.join(save_dir, f"siim_{j}.png")
        render_attention_panel(
            scorer, path, ["There is Pneumothorax"], out, mask=(mask > 0), ncols=2
        )
        outs.append(out)
    return outs


def visualize_rsna_samples(
    scorer: ZeroShotScorer,
    data_root_dir: str,
    save_dir: str,
    num_samples: int = 8,
    seed: int = 0,
) -> List[str]:
    """Sampled RSNA overlays with GT boxes (visualize_utils.py:243-280)."""
    dirs = get_infer_dirs(data_root_dir)
    data = read_csv(dirs["RSNA"]["data_path"])
    pos = [(p, b) for p, b in zip(data["img_path"].tolist(), data["boxes"].tolist())
           if not isna(b) and str(b) != "nan"]
    rng = np.random.default_rng(seed)
    picks = rng.choice(len(pos), min(num_samples, len(pos)), replace=False)

    outs = []
    for j in picks:
        img_path, row_boxes = pos[int(j)]
        boxes = []
        for b in str(row_boxes).split("|"):
            x0, y0, bw, bh = (float(c) for c in b.split(";")[:4])
            boxes.append([x0, y0, x0 + bw, y0 + bh])
        out = os.path.join(save_dir, f"rsna_{j}.png")
        render_attention_panel(
            scorer,
            os.path.join(data_root_dir, img_path),
            ["There is Pneumonia"],
            out,
            boxes=boxes,
            ncols=2,
        )
        outs.append(out)
    return outs
