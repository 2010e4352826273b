"""The port's visualization suite (radzero_torch.viz, cli.visualize)
against the JAX package, on the CPU.

Tolerances:
- colormaps: the float64 RGBA of matplotlib's ``inferno`` / ``tab10`` and
  ``matplotlib.colors.to_rgb``, exactly;
- ``_gaussian_blur`` against ``cv2.GaussianBlur``: 1e-6 absolute on maps
  in [0, 1] (OpenCV sums in its own order; a few float32 ulps);
- ``extract_similarity_map`` against the JAX function on the same weights
  (through ``params_from_jax``): tests/test_torch_scorer.py's gate,
  probabilities within 1e-4 and map MAE < 1e-3;
- with the maps patched to the same array in both packages, bit for bit:
  ``overlay_heatmap``, ``filter_top_k_percent``, ``compute_segmap``,
  ``render_segmap``'s overlay, ``visualize_segmap``'s composite and
  ``process_and_visualize_map``'s three files (there both packages blur
  with the port's blur, which is held to cv2 above).

The panel layouts are PIL's, not matplotlib's: their files are checked by
name, pixel size and decoding, not against the JAX figures.
"""

import json
import os
import subprocess
import sys

import cv2
import jax
import matplotlib
import matplotlib.axes
import matplotlib.colors as mcolors
import numpy as np
import pytest
import torch
from PIL import Image

from radzero_torch.data.processing import BlipStyleImageProcessor
from radzero_torch.data.tokenizer import WhitespaceHashTokenizer
from radzero_torch.eval.scorer import ZeroShotScorer
from radzero_torch.models import configuration as tconf
from radzero_torch.models.from_jax import params_from_jax
from radzero_torch.tools import synthetic_eval_data as sd
from radzero_torch.viz import colormaps, overlays, qualitative, segmap, studies
from radzero_tpu.data.processing import BlipStyleImageProcessor as JaxProcessor
from radzero_tpu.data.tokenizer import WhitespaceHashTokenizer as JaxTokenizer
from radzero_tpu.eval.scorer import ZeroShotScorer as JaxScorer
from radzero_tpu.models import configuration as jconf
from radzero_tpu.models.radzero import init_radzero as jax_init_radzero
from radzero_tpu.viz import overlays as joverlays
from radzero_tpu.viz import qualitative as jqualitative
from radzero_tpu.viz import segmap as jsegmap
from radzero_tpu.viz import studies as jstudies

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D = 32
MODEL = dict(
    vision=dict(hidden_size=D, num_hidden_layers=1, num_attention_heads=2, mlp_ratio=2.0,
                patch_size=14, pretrain_img_size=28, img_size=28),
    text=dict(hidden_size=D, num_hidden_layers=1, num_attention_heads=2, intermediate_size=64,
              vocab_size=5003, max_position_embeddings=40),
    align=dict(hidden_size=D, num_hidden_layers=1, num_attention_heads=2, mlp_ratio=2.0),
)


def _cfg(m):
    return m.RadZeroConfig(vision=m.ViTConfig(**MODEL["vision"]),
                           text=m.TextConfig(**MODEL["text"]),
                           align=m.AlignConfig(**MODEL["align"]),
                           loss=m.LossConfig(hidden_dim=D))


JCFG, TCFG = _cfg(jconf), _cfg(tconf)


@pytest.fixture(scope="module")
def scorers():
    """(port scorer on the CPU, JAX scorer) on the same weights."""
    tree = jax_init_radzero(jax.random.PRNGKey(0), JCFG)
    theirs = JaxScorer(tree, JCFG, JaxProcessor(size=28),
                       JaxTokenizer(vocab_size=5003, max_length=12), batch_size=1)
    ours = ZeroShotScorer(params_from_jax(tree), TCFG, BlipStyleImageProcessor(size=28),
                          WhitespaceHashTokenizer(vocab_size=5003, max_length=12),
                          device="cpu", batch_size=1, num_threads=2)
    return ours, theirs


@pytest.fixture(scope="module")
def scorer(scorers):
    return scorers[0]


@pytest.fixture(scope="module")
def image_path(tmp_path_factory):
    p = tmp_path_factory.mktemp("viz") / "x.png"
    arr = np.random.default_rng(0).integers(0, 256, (90, 70, 3), dtype=np.uint8)
    Image.fromarray(arr).save(p)
    return str(p)


def _decodes(path, size=None):
    with Image.open(path) as im:
        im.load()
        assert size is None or im.size == size, (path, im.size)
        return im.size


# ---------------------------------------------------------------------------
# mirrors of tests/test_viz.py
# ---------------------------------------------------------------------------

def test_extract_similarity_map(scorer, image_path):
    probs, maps, image = overlays.extract_similarity_map(
        scorer, image_path, ["There is Edema", "There is no finding"]
    )
    assert probs.shape == (2,) and maps.shape == (2, 90, 70)
    assert image.shape == (90, 70, 3)
    assert np.all((maps >= 0) & (maps <= 1))


def test_overlay_and_drawing_primitives():
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (50, 40, 3), dtype=np.uint8)
    heat = rng.random((50, 40)).astype(np.float32)
    out = overlays.overlay_heatmap(img, heat, blur_sigma=2.0)
    assert out.shape == img.shape and out.dtype == np.uint8

    boxed = overlays.draw_boxes(img, [[5, 5, 30, 30]])
    assert (boxed[5, 5:30] == (0, 255, 0)).all()
    np.testing.assert_array_equal(boxed, joverlays.draw_boxes(img, [[5, 5, 30, 30]]))

    mask = np.zeros((50, 40), bool)
    mask[10:20, 10:20] = True
    contoured = overlays.draw_mask_contours(img, mask)
    assert contoured.shape == img.shape
    assert (contoured[10, 10:20] == (0, 255, 0)).all() and (contoured[15, 15] == img[15, 15]).all()


def test_render_attention_panel(scorer, image_path, tmp_path):
    out = str(tmp_path / "panel.png")
    maps = overlays.render_attention_panel(
        scorer, image_path, ["There is Edema", "There is Mass"], out,
        boxes=[[2, 2, 30, 30]],
    )
    assert maps.shape == (2, 90, 70)
    _decodes(out, (3 * overlays.TILE, overlays.TILE))  # 3 tiles of the JAX figure's 480 px


def test_segmap(scorer, image_path, tmp_path):
    seg, maps, image = segmap.compute_segmap(
        scorer, image_path, ["heart", "left lung"], threshold=None
    )
    assert seg.shape == (90, 70)
    assert set(np.unique(seg)) <= {0, 1}
    out = str(tmp_path / "seg.png")
    segmap.render_segmap(image, seg, ["heart", "left lung"], out)
    _decodes(out, (segmap.CANVAS, segmap.CANVAS))


def test_filter_top_k_percent():
    m = np.arange(100, dtype=np.float32).reshape(10, 10) / 100.0
    out = qualitative.filter_top_k_percent(m, 10)
    kept = out > -1.0
    assert kept.sum() == 10            # top 10% of 100 pixels
    assert out[kept].min() >= 0.90
    with pytest.raises(ValueError):
        qualitative.filter_top_k_percent(m, 0)


def test_visualize_segmap_artifacts(image_path, tmp_path):
    prob = np.random.default_rng(1).random((3, 90, 70)).astype(np.float32)
    paths = qualitative.visualize_segmap(
        image_path, prob, ["left lung", "right lung", "background"],
        str(tmp_path), overlay_alpha=0.5, colors=["#E377C2", "#66C2A5", "#000000"],
        bbox=[[5, 5, 30, 40]],
    )
    assert len(paths) == 2
    for p in paths:
        assert os.path.exists(p) and os.path.getsize(p) > 0
    assert os.path.basename(paths[0]).startswith("seg_map_")
    assert os.path.basename(paths[1]).startswith("only_segmap_")
    _decodes(paths[1], (140, 180))  # the JAX figure's 2w x 2h


def test_visualize_disease_segmap_requires_color_dict(image_path, tmp_path):
    prob = np.random.default_rng(2).random((2, 90, 70)).astype(np.float32)
    with pytest.raises(ValueError):
        qualitative.visualize_disease_segmap(image_path, prob, ["a", "b"], str(tmp_path),
                                             colors="tab10")
    with pytest.raises(NotImplementedError):
        qualitative.visualize_disease_segmap(
            image_path, prob, ["a", "b"], str(tmp_path), colors={"a": "red"}
        )
    paths = qualitative.visualize_disease_segmap(
        image_path, prob, ["Pneumothorax", "background"], str(tmp_path),
        colors={"Pneumothorax": "red", "background": "black"},
    )
    assert all(os.path.exists(p) for p in paths)


def test_process_and_visualize_map_flow(scorer, image_path, tmp_path):
    paths = qualitative.process_and_visualize_map(
        scorer, image_path, ["There is Pneumothorax"], str(tmp_path),
        bbox=[10, 10, 40, 60], image_key="case1.png",
    )
    names = [os.path.basename(p) for p in paths]
    assert names == [
        "nobox_There is Pneumothorax_case1.png",
        "orig_case1.png",
        "There is Pneumothorax_case1.png",
    ]
    for p in paths:
        assert os.path.getsize(p) > 0


def test_process_and_visualize_segmentation_flow(scorer, image_path, tmp_path):
    paths = qualitative.process_and_visualize_segmentation(
        scorer, image_path, ["There is Pneumothorax", "There is Cardiomegaly"],
        str(tmp_path), k=20.0,
    )
    assert len(paths) == 2
    for p in paths:
        assert os.path.exists(p) and os.path.getsize(p) > 0


# ---------------------------------------------------------------------------
# colormaps against matplotlib
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["inferno", "tab10"])
def test_colormap_matches_matplotlib(name):
    ours, ref = colormaps.get_cmap(name), matplotlib.colormaps[name]
    assert ours.N == ref.N
    edges = np.arange(ours.N + 1) / ours.N
    x = np.concatenate([edges, np.nextafter(edges, -1), np.nextafter(edges, 2),
                        np.linspace(0, 1, 4097), [np.nan, -0.1, 1.1, -1e9, 1e9, np.inf, -np.inf]])
    for dtype in (np.float32, np.float64):
        got, want = ours(x.astype(dtype)), ref(x.astype(dtype))
        assert got.dtype == want.dtype and np.array_equal(got, want)
    i = np.arange(-2, ours.N + 3)
    assert np.array_equal(ours(i), ref(i))
    heat = np.random.default_rng(3).random((17, 9)).astype(np.float32)
    assert np.array_equal((ours(heat)[..., :3] * 255).astype(np.uint8),
                          (ref(heat)[..., :3] * 255).astype(np.uint8))


@pytest.mark.parametrize("table", ["BASE_COLORS", "TABLEAU_COLORS", "CSS4_COLORS"])
def test_named_colors_match_matplotlib(table):
    names = getattr(mcolors, table)
    assert names == getattr(colormaps, table)
    for name in names:
        assert colormaps.to_rgb(name) == mcolors.to_rgb(name), name
        if len(name) > 1:
            assert colormaps.to_rgb(name.upper()) == mcolors.to_rgb(name.upper()), name


def test_color_strings_match_matplotlib():
    for c in ["#E377C2", "#66c2a5", "#000", "#fA0", "#abcd", "#11223344", "0.25", "1", "none",
              "tab:grey", "DarkGrey", (0.1, 0.2, 0.3), (1, 0, 0, 0.5)]:
        assert colormaps.to_rgb(c) == mcolors.to_rgb(c), c
        assert colormaps.to_rgba(c) == mcolors.to_rgba(c), c
    for bad in ["notacolor", "#12345", "1.5", (2, 0, 0), "R"]:
        with pytest.raises(ValueError):
            mcolors.to_rgb(bad)
        with pytest.raises(ValueError):
            colormaps.to_rgb(bad)
    with pytest.raises(ValueError):
        colormaps.get_cmap("viridis")  # not carried over


# ---------------------------------------------------------------------------
# the blur against OpenCV
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sigma", [1.0, 2.0, 8.0])
@pytest.mark.parametrize("shape", [(90, 70), (37, 37), (5, 7), (300, 257)])
def test_gaussian_blur_matches_cv2(sigma, shape):
    k = int(sigma * 4) | 1
    np.testing.assert_array_equal(overlays.gaussian_taps(k, sigma),
                                  cv2.getGaussianKernel(k, sigma, cv2.CV_32F).ravel())
    x = np.random.default_rng(4).random(shape).astype(np.float32)
    got, want = overlays._gaussian_blur(x, sigma), cv2.GaussianBlur(x, (k, k), sigma)
    assert got.dtype == np.float32 and got.shape == shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert overlays._gaussian_blur(x, 0.0) is x


# ---------------------------------------------------------------------------
# against the JAX functions
# ---------------------------------------------------------------------------

def test_extract_similarity_map_matches_jax(scorers, image_path):
    ours, theirs = scorers
    prompts = ["There is Edema", "There is no finding", "There is left pleural effusion"]
    p, m, im = overlays.extract_similarity_map(ours, image_path, prompts)
    jp, jm, jim = joverlays.extract_similarity_map(theirs, image_path, prompts)
    np.testing.assert_array_equal(im, jim)
    assert p.dtype == jp.dtype and m.dtype == jm.dtype == np.float32
    np.testing.assert_allclose(p, jp, atol=1e-4)
    assert np.abs(m - jm).mean() < 1e-3


@pytest.fixture
def same_maps(monkeypatch, image_path):
    """extract_similarity_map of every viz module of both packages patched
    to return one seeded (probs, maps, image)."""
    image = np.asarray(Image.open(image_path).convert("RGB"))
    maps = np.random.default_rng(5).random((3, 90, 70)).astype(np.float32)
    maps[0, :10, :10] = 1.0  # ties and the top bin of the colormap
    probs = np.array([0.2, 0.7, 0.4], np.float32)

    def fake(scorer, path, prompts):
        return probs[: len(prompts)], maps[: len(prompts)].copy(), image

    for mod in (overlays, qualitative, segmap, joverlays, jqualitative, jsegmap):
        monkeypatch.setattr(mod, "extract_similarity_map", fake)
    return probs, maps, image


@pytest.mark.parametrize("kw", [dict(), dict(alpha=0.3, vmin=0.2, vmax=0.9),
                                dict(blur_sigma=2.0), dict(blur_sigma=8.0, alpha=0.6)])
def test_overlay_heatmap_is_the_jax_bytes(kw, monkeypatch, same_maps):
    """With a blur, both packages blur with the port's (held to cv2 above)."""
    monkeypatch.setattr(joverlays, "_gaussian_blur", overlays._gaussian_blur)
    _, maps, image = same_maps
    got = overlays.overlay_heatmap(image, maps[1], **kw)
    want = joverlays.overlay_heatmap(image, maps[1], **kw)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [10, 20.0, 33.3, 100])
def test_filter_top_k_percent_is_the_jax_array(k, same_maps):
    m = same_maps[1][2]
    got, want = qualitative.filter_top_k_percent(m, k), jqualitative.filter_top_k_percent(m, k)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("threshold", [None, 0.5, 0.9])
def test_compute_segmap_and_overlay_are_the_jax_arrays(threshold, same_maps, monkeypatch,
                                                       tmp_path):
    names = ["heart", "left lung", "spine"]
    seg, maps, image = segmap.compute_segmap(None, "x.png", names, threshold=threshold)
    jseg, jmaps, _ = jsegmap.compute_segmap(None, "x.png", names, threshold=threshold)
    assert seg.dtype == jseg.dtype
    np.testing.assert_array_equal(seg, jseg)
    np.testing.assert_array_equal(maps, jmaps)
    shown = []
    original = matplotlib.axes.Axes.imshow
    monkeypatch.setattr(matplotlib.axes.Axes, "imshow",
                        lambda ax, x, *a, **k: shown.append(np.array(x)) or original(ax, x, *a, **k))
    jsegmap.render_segmap(image, jseg, names, str(tmp_path / "jax.png"))
    overlay, _ = segmap.segmap_overlay(image, seg, len(names))
    np.testing.assert_array_equal(overlay, shown[0])
    segmap.render_segmap(image, seg, names, str(tmp_path / "port.png"))
    _decodes(str(tmp_path / "port.png"), (segmap.CANVAS, segmap.CANVAS))


@pytest.mark.parametrize("colors", ["tab10", ["#E377C2", "#66C2A5", "#000000"],
                                    {"a": "red", "b": "tab:blue", "background": "black"}])
def test_visualize_segmap_composite_is_the_jax_array(colors, same_maps, monkeypatch, tmp_path):
    _, maps, image = same_maps
    names = ["a", "b", "background"]
    shown = []
    original = matplotlib.axes.Axes.imshow
    monkeypatch.setattr(matplotlib.axes.Axes, "imshow",
                        lambda ax, x, *a, **k: shown.append(np.array(x)) or original(ax, x, *a, **k))
    jqualitative.visualize_segmap(image, maps, names, str(tmp_path / "jax"), colors=colors,
                                  bbox=[[5, 5, 30, 40]])
    composite, _, bg = qualitative.segmap_composite(image, maps, names, 0.5, colors)
    assert bg == 2
    np.testing.assert_array_equal(composite, shown[1])   # the panel's overlay
    np.testing.assert_array_equal(composite, shown[2])   # the overlay-only figure
    paths = qualitative.visualize_segmap(image, maps, names, str(tmp_path / "port"),
                                         colors=colors)
    assert [os.path.basename(p) for p in paths] == ["seg_map_image.png", "only_segmap_image.png"]
    with Image.open(paths[1]) as im:
        only = np.asarray(im.convert("RGB"))
    np.testing.assert_array_equal(only[::2, ::2], composite)
    np.testing.assert_array_equal(only[1::2, 1::2], composite)


@pytest.mark.parametrize("bbox", [None, [10, 10, 40, 60], [[2, 3, 20, 30], [30, 40, 60, 80]]])
def test_process_and_visualize_map_files_are_the_jax_bytes(bbox, same_maps, monkeypatch,
                                                           image_path, tmp_path):
    monkeypatch.setattr(jqualitative, "_gaussian_blur", overlays._gaussian_blur)
    texts = ["There is Pneumothorax", "There is Edema"]
    ours = qualitative.process_and_visualize_map(None, image_path, texts, str(tmp_path / "port"),
                                                 bbox=bbox)
    theirs = jqualitative.process_and_visualize_map(None, image_path, texts,
                                                    str(tmp_path / "jax"), bbox=bbox)
    assert [os.path.basename(p) for p in ours] == [os.path.basename(p) for p in theirs]
    for a, b in zip(ours, theirs):
        assert open(a, "rb").read() == open(b, "rb").read(), a


def test_process_and_visualize_segmentation_matches_jax(same_maps, monkeypatch, image_path,
                                                        tmp_path):
    """The top-k filtered maps and the zero background reach visualize_segmap
    as in the JAX function."""
    seen = {}

    def record(key):
        def fn(image, prob, class_names, save_dir, **kw):
            seen[key] = (prob, class_names, kw["colors"])
            return []
        return fn

    monkeypatch.setattr(qualitative, "visualize_segmap", record("port"))
    monkeypatch.setattr(jqualitative, "visualize_segmap", record("jax"))
    texts = ["There is Pneumothorax", "There is Cardiomegaly"]
    for mod, key in ((qualitative, "port"), (jqualitative, "jax")):
        mod.process_and_visualize_segmentation(None, image_path, texts, str(tmp_path), k=20.0,
                                               colors={t: "red" for t in texts})
    np.testing.assert_array_equal(seen["port"][0], seen["jax"][0])
    assert seen["port"][1:] == seen["jax"][1:]


@pytest.mark.parametrize("dataset", ["ChestXDet10", "SIIM", "RSNA"])
def test_dataset_samplers_pick_the_jax_samples(dataset, tmp_path, monkeypatch):
    """The pandas-free samplers draw the JAX samplers' studies, prompts,
    boxes and masks (render_attention_panel recorded in both)."""
    root = str(tmp_path / "data")
    sd.build_all(root, n=9)
    calls = {"port": [], "jax": []}

    def record(key):
        def fn(scorer, path, prompts, out, **kw):
            calls[key].append((os.path.relpath(path, root), prompts, os.path.basename(out),
                               json.dumps(kw.get("boxes")), kw.get("ncols"),
                               None if kw.get("mask") is None else kw["mask"].tobytes()))
        return fn

    monkeypatch.setattr(studies, "render_attention_panel", record("port"))
    monkeypatch.setattr(jstudies, "render_attention_panel", record("jax"))
    fn = {"ChestXDet10": "visualize_chestxdet10_samples", "SIIM": "visualize_siim_samples",
          "RSNA": "visualize_rsna_samples"}[dataset]
    for seed in (0, 3):
        getattr(studies, fn)(None, root, str(tmp_path / "out"), num_samples=3, seed=seed)
        getattr(jstudies, fn)(None, root, str(tmp_path / "out"), num_samples=3, seed=seed)
    assert len(calls["port"]) == 6 and calls["port"] == calls["jax"]


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

SINGLE_IMAGE_FILES = [
    "open_vocab.png", "positional_0.png", "positional_1.png", "positional_2.png",
    "posneg_Pneumothorax.png", "posneg_Pleural_Effusion.png", "posneg_Cardiomegaly.png",
    "anatomy_segmap.png", "disease_segmap.png", "nobox_There is Pneumothorax_x.png",
    "orig_x.png", "There is Pneumothorax_x.png", "seg_map_x.png", "only_segmap_x.png",
]


def test_visualize_cli_end_to_end(image_path, tmp_path):
    """python -m radzero_torch.cli.visualize --device cpu at the tiny
    config: all seven studies on one image, then a dataset's samples; the
    default --device cuda raises where there is no card."""
    (tmp_path / "cfg.json").write_text(json.dumps({
        "vision_config": MODEL["vision"], "text_config": MODEL["text"],
        "align_transformer_config": MODEL["align"], "loss": {"RadZeroLoss": {"hidden_dim": D}}}))
    words = sorted({w for s in SINGLE_IMAGE_FILES for w in s.lower().split()} | {"there", "is"})
    (tmp_path / "vocab.txt").write_text("\n".join(["<s>", "<pad>", "</s>", "<unk>", "[UNK]"]
                                                  + words) + "\n")
    root = str(tmp_path / "data")
    sd.build_all(root, n=6)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, HF_HUB_OFFLINE="1", TRANSFORMERS_OFFLINE="1")
    base = [sys.executable, "-m", "radzero_torch.cli.visualize", "--device", "cpu",
            "--config", str(tmp_path / "cfg.json"), "--tokenizer", str(tmp_path / "vocab.txt"),
            "--save_dir", str(tmp_path / "out")]
    res = subprocess.run(base + ["--image", image_path, "--top_k_percent", "10", "--studies",
                                 *(["open_vocab", "positional", "pos_neg", "anatomy", "disease",
                                    "disease_map", "open_vocab_seg"])],
                         capture_output=True, text=True, env=env, cwd=REPO, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    res = subprocess.run(base + ["--dataset", "RSNA", "--data_root", root, "--num_samples", "2"],
                         capture_output=True, text=True, env=env, cwd=REPO, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    written = sorted(os.listdir(tmp_path / "out"))
    rsna = [f for f in written if f.startswith("rsna_")]
    assert len(rsna) == 2 and sorted(set(written) - set(rsna)) == sorted(SINGLE_IMAGE_FILES)
    for f in written:
        _decodes(str(tmp_path / "out" / f))
    if torch.cuda.is_available():
        return
    res = subprocess.run([sys.executable, "-m", "radzero_torch.cli.visualize", "--image",
                          image_path, "--save_dir", str(tmp_path / "none")],
                         capture_output=True, text=True, env=env, cwd=REPO, timeout=600)
    assert res.returncode != 0 and "no CUDA device" in res.stderr
    assert not (tmp_path / "none").exists()
