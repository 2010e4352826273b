#!/usr/bin/env python
"""Grammar-derived sentence-duplication calibration for PackSpec.dedup_slots
(counterpart of tools/dedup_calibration.py; host only, no kernel, no card).

The reference extracts finding sentences with a FIXED template grammar
(the reference's ``preprocess/mimic_cxr/prompt_alignment.py:20-55``):

    "There is [finding] of [location]."
    "There may be [finding] of [location]."
    "There is no [finding] of [location]."   (location optional)

so every training sentence is a draw from a bounded product space
(3 modalities) x (common-finding vocabulary) x (optional location).
Within a batch-64 x 8-slot window (512 sentence rows) identical strings
repeat heavily; that duplication is what ``PackSpec.dedup_slots``
(``radzero_torch/data/pipeline.py``) monetises.

This tool samples batches of reports from a generative model of the
grammar and reports the distribution of unique-sentence counts per
512-row window, over a sensitivity grid of the unknowns (vocabulary
size, Zipf exponent, negation share, location-attachment rate). The
model's anchored parts:

- finding vocabulary: union of the label spaces the reference itself
  evaluates on (OpenI 18 / ChestXray14 / CheXpert5 / ChestXDet10,
  ``radzero_torch/eval/mergers.py``) + the support-device and descriptor
  phrases visible in the reference prompt's own worked example, padded
  with synthetic tail findings to the sweep's vocabulary size;
- clinical finding mentions are Zipfian (a handful of findings,
  atelectasis/effusion/cardiomegaly/edema/pneumothorax, dominate
  MIMIC-style reports); the exponent is swept, not asserted;
- pertinent negatives concentrate on a tiny head ("There is no
  pneumothorax/pleural effusion/focal consolidation"), per the grammar
  example, and rarely carry a location;
- sentences within one report are distinct (a report does not state
  the same sentence twice); slots per image capped at the PackSpec's 8.

Output: one JSON document (the keys of the JAX tool's, and for the same
grid, window count and seed the same bytes) with the per-config
unique-count quantiles, the implied duplication factor, overflow
probabilities for candidate slot counts, and a recommended
``dedup_slots`` = the smallest grid candidate whose overflow probability
is < 1% under EVERY grid config (the multi-process "drop" policy makes
overflow a masked-row loss, so the recommendation is conservative).
``DEDUP_CALIBRATION_r05.json`` holds the JAX tool's record (320).

Run:  python -m radzero_torch.tools.dedup_calibration [--n_windows 2000] [--seed 0]

It runs numpy on the host alone, so it takes no ``--device``.
"""

from __future__ import annotations

import argparse
import itertools
import json

import numpy as np

from radzero_torch.eval.mergers import (
    CHESTXDET10_CLASSES,
    CHESTXRAY14_CLASSES,
    CHEXPERT5_CLASSES,
    OPENI_PATHOLOGIES,
)

BATCH_IMAGES = 64          # reference per-device batch (configs/radzero.yaml)
SLOTS_PER_IMAGE = 8        # PackSpec.max_sentences_per_image (radzero preset)
WINDOW_ROWS = BATCH_IMAGES * SLOTS_PER_IMAGE  # 512
CANDIDATE_SLOTS = [128, 192, 256, 320, 384]
N_WINDOWS = 2000

# Findings named by the reference's own eval label spaces (deduped,
# lowercased for string identity) + the phrases in the grammar's worked
# example (support devices, vascular congestion, retrocardiac opacity).
_EVAL_FINDINGS = sorted(
    {
        c.replace("_", " ").lower()
        for c in (
            list(OPENI_PATHOLOGIES)
            + list(CHESTXRAY14_CLASSES)
            + list(CHEXPERT5_CLASSES)
            + list(CHESTXDET10_CLASSES)
        )
    }
)
_EXAMPLE_FINDINGS = [
    "pulmonary vascular congestion", "pulmonary edema",
    "left retrocardiac opacity", "pigtail pleural catheter in place",
    "small right pleural effusion", "right lung base opacity",
    "enlarged cardiac silhouette", "low lung volumes",
    "central venous catheter in place", "endotracheal tube in place",
    "nasogastric tube in place", "sternotomy wires",
    "degenerative changes of the spine", "hiatal hernia",
    "blunting of the costophrenic angle", "interstitial markings",
    "bibasilar atelectasis", "patchy airspace disease",
]
# Pertinent negatives concentrate on a small head of ruled-out findings.
_NEG_HEAD = [
    "pneumothorax", "pleural effusion", "focal consolidation",
    "acute cardiopulmonary process", "pulmonary edema", "pneumonia",
]
_LOCATIONS = [
    "the left lung", "the right lung", "the left lower lobe",
    "the right lower lobe", "the left upper lobe", "the right upper lobe",
    "the right middle lobe", "the left lung base", "the right lung base",
    "both lung bases", "the bilateral lungs", "the left hemithorax",
    "the right hemithorax", "the left costophrenic angle",
    "the right costophrenic angle", "the cardiac silhouette",
    "the mediastinum", "the hila", "the left apex", "the right apex",
    "the retrocardiac region", "the perihilar region",
    "the lung periphery", "the pleural space",
]


def _zipf_probs(n: int, s: float) -> np.ndarray:
    w = 1.0 / np.arange(1, n + 1) ** s
    return w / w.sum()


def build_vocab(size: int, rng: np.random.Generator) -> list[str]:
    base = _EVAL_FINDINGS + [f for f in _EXAMPLE_FINDINGS if f not in _EVAL_FINDINGS]
    if size <= len(base):
        return base[:size]
    # synthetic tail: rarer modifier+finding composites ("mild ...",
    # "chronic ...") standing in for the long tail of real phrasing
    mods = ["mild", "moderate", "severe", "chronic", "trace", "subtle",
            "diffuse", "focal", "scattered", "residual"]
    tail = [f"{m} {f}" for m, f in itertools.product(mods, base)]
    rng.shuffle(tail)
    return base + tail[: size - len(base)]


def _sentence_pool(n: int, vocab_size: int, zipf_s: float, p_neg: float,
                   p_loc: float, rng: np.random.Generator) -> np.ndarray:
    """``n`` i.i.d. sentence draws encoded as int64 keys.

    Key layout: (is_neg, modality, finding_idx, location_idx+1) packed —
    string identity over the templated grammar is exactly key identity,
    so uniqueness over ints equals uniqueness over rendered sentences.
    """
    p_find = _zipf_probs(vocab_size, zipf_s)
    p_negh = _zipf_probs(len(_NEG_HEAD), 1.5)
    p_locs = _zipf_probs(len(_LOCATIONS), 1.0)

    is_neg = rng.random(n) < p_neg
    find_pos = rng.choice(vocab_size, size=n, p=p_find)
    find_neg = rng.choice(len(_NEG_HEAD), size=n, p=p_negh)
    maybe = rng.random(n) < 0.2            # "There may be" share (positives)
    has_loc = np.where(is_neg, rng.random(n) < p_loc * 0.3,  # negs rarely located
                       rng.random(n) < p_loc)
    loc = np.where(has_loc, rng.choice(len(_LOCATIONS), size=n, p=p_locs) + 1, 0)
    finding = np.where(is_neg, find_neg, find_pos)
    modality = np.where(is_neg, 2, maybe.astype(np.int64))
    return (is_neg.astype(np.int64) << 40) | (modality << 32) | (finding << 8) | loc


def simulate(vocab_size: int, zipf_s: float, p_neg: float, p_loc: float,
             seed: int = 0, n_windows: int = N_WINDOWS) -> dict:
    rng = np.random.default_rng(seed)
    vocab = build_vocab(vocab_size, rng)
    n_sent = np.minimum(SLOTS_PER_IMAGE,
                        1 + rng.poisson(5.0, n_windows * BATCH_IMAGES))
    # draw 4x the slots per report; take the first n_sent distinct keys
    # (a report does not state the same sentence twice)
    draw = 4 * SLOTS_PER_IMAGE
    pool = _sentence_pool(n_windows * BATCH_IMAGES * draw, len(vocab),
                          zipf_s, p_neg, p_loc, rng)
    pool = pool.reshape(n_windows * BATCH_IMAGES, draw)

    # vectorized "first n_sent distinct per report": a stable argsort
    # groups equal keys with the earliest position first, so scattering
    # the run-head mask back marks exactly the first occurrences in
    # i.i.d. draw order
    order = np.argsort(pool, axis=1, kind="stable")
    srt = np.take_along_axis(pool, order, axis=1)
    head = np.concatenate(
        [np.ones((pool.shape[0], 1), bool), srt[:, 1:] != srt[:, :-1]], axis=1)
    first = np.empty_like(head)
    np.put_along_axis(first, order, head, axis=1)
    keep = first & (np.cumsum(first, axis=1) <= n_sent[:, None])
    filled_per_report = keep.sum(axis=1)

    uniques = np.empty(n_windows, np.int32)
    keep = keep.reshape(n_windows, BATCH_IMAGES * draw)
    wpool = pool.reshape(n_windows, BATCH_IMAGES * draw)
    for w in range(n_windows):
        uniques[w] = np.unique(wpool[w][keep[w]]).size
    filled_tot = int(filled_per_report.sum())

    mean_filled = filled_tot / n_windows
    q = np.quantile(uniques, [0.5, 0.95, 0.99]).round(1)
    return {
        "config": {"vocab_size": vocab_size, "zipf_s": zipf_s,
                   "p_neg": p_neg, "p_loc": p_loc},
        "mean_filled_rows": round(mean_filled, 1),
        "unique_p50": float(q[0]),
        "unique_p95": float(q[1]),
        "unique_p99": float(q[2]),
        "dup_factor_p50": round(mean_filled / q[0], 2),
        "overflow_prob": {
            str(u): round(float((uniques > u).mean()), 4)
            for u in CANDIDATE_SLOTS
        },
    }


GRID = list(itertools.product(
    [60, 120, 240],      # finding vocabulary size
    [0.8, 1.0, 1.2],     # Zipf exponent over findings
    [0.15, 0.25],        # negation share
    [0.3, 0.5],          # location-attachment rate (positives)
))


def calibrate(grid=GRID, n_windows: int = N_WINDOWS, seed: int = 0) -> dict:
    """The JSON document for ``grid`` at ``n_windows`` windows a config, each
    config drawn from ``seed``."""
    results = [simulate(*cfg, seed=seed, n_windows=n_windows) for cfg in grid]

    # recommended slots: smallest candidate with <1% overflow under
    # EVERY config in the sensitivity grid
    rec = None
    for u in CANDIDATE_SLOTS:
        if all(r["overflow_prob"][str(u)] < 0.01 for r in results):
            rec = u
            break

    return {
        "window_rows": WINDOW_ROWS,
        "n_windows_per_config": n_windows,
        "grid_size": len(results),
        "recommended_dedup_slots": rec,
        # the throughput lever is STATIC: the text encoder always runs
        # dedup_slots rows instead of 512, regardless of the realized
        # unique count below it. rec=None: no candidate met the <1%
        # criterion; report that instead of crashing on the division.
        "static_text_row_reduction_at_recommended": (
            round(WINDOW_ROWS / rec, 2) if rec else
            "no candidate slot count met the <1% overflow criterion"),
        "dup_factor_p50_range": [
            min(r["dup_factor_p50"] for r in results),
            max(r["dup_factor_p50"] for r in results),
        ],
        "unique_p99_range": [
            min(r["unique_p99"] for r in results),
            max(r["unique_p99"] for r in results),
        ],
        "worst_overflow_prob": {
            str(u): max(r["overflow_prob"][str(u)] for r in results)
            for u in CANDIDATE_SLOTS
        },
        "configs": results,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n_windows", type=int, default=N_WINDOWS,
                    help="512-row windows drawn a grid config")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    print(json.dumps(calibrate(n_windows=args.n_windows, seed=args.seed), indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
