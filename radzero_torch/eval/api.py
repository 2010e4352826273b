"""Public single-sample inference API (port of radzero_tpu/eval/api.py):

    similarity_prob, similarity_map = model_inference(
        image_path, text, tokenizer, image_processor, model)

- ``similarity_prob``: sigmoid(logit) per text, one scalar probability that
  the finding is present;
- ``similarity_map``: sigmoid(bilinear-upsampled pre-softmax score map) at
  the original image resolution.
"""

from __future__ import annotations

from typing import List, Tuple, Union

import numpy as np
import torch

from radzero_torch.data.dicom import load_eval_image
from radzero_torch.eval.geometry import upsample_similarity_map
from radzero_torch.eval.scorer import ZeroShotScorer
from radzero_torch.models.configuration import RadZeroConfig


def model_inference(
    image_path: str,
    text: Union[str, List[str]],
    tokenizer,
    image_processor,
    model: Tuple[dict, RadZeroConfig],
    *,
    dtype: torch.dtype = torch.float32,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (similarity_prob (n_texts,), similarity_map (n_texts, H, W)).
    ``model`` is (params, cfg); it runs on ``device``."""
    params, cfg = model
    texts = [text] if isinstance(text, str) else list(text)

    scorer = ZeroShotScorer(params, cfg, image_processor, tokenizer, device=device,
                            batch_size=1, dtype=dtype)

    with load_eval_image(image_path) as im:
        w, h = im.size

    def load(_):
        return load_eval_image(image_path)

    logits, scores = scorer.score([image_path], load, texts, need_scores=True)

    similarity_prob = 1.0 / (1.0 + np.exp(-logits[0]))  # (n_texts,)
    maps = upsample_similarity_map(scores[0], (h, w), image_processor.geometry, device=device)
    similarity_map = 1.0 / (1.0 + np.exp(-maps))  # (n_texts, H, W)
    return similarity_prob, similarity_map
