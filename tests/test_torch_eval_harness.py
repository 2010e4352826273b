"""The port's zero-shot eval harness (radzero_torch/eval/{registry, _table,
mergers, classification, grounding, segmentation, inference}.py and
radzero_torch/tools/synthetic_eval_data.py) against the JAX package's, on
the CPU, at the JAX harness tests' small model (D = 32, one layer a tower).

- The port's synthetic builders write the JAX builders' files byte for byte.
- The table reader gives ``pd.read_csv``'s columns, dtypes and values on
  every file the harness reads, quirks included; the similarity CSV
  writer gives ``DataFrame.to_csv``'s bytes.
- Every merger agrees with the JAX merger at atol 1e-12 on shared arrays.
- ``Inference`` on one stub scorer (fixed arrays) writes the JAX facade's
  result.json and CSV files byte for byte. The stub test routes both
  harnesses' upsample through one function: the two resizes differ in the
  last bits (JAX's matmul form, torch's ``F.interpolate``), which the
  geometry tests hold at 1e-5.
- The whole suite on the two real scorers (weights carried across by
  ``params_from_jax``): similarity CSVs within compute_logits' gate (rtol
  1e-3, atol 2e-4, tests/test_radzero_model.py), and metrics within a
  tolerance from ranking margins. If every score moves by at most d, only
  two scores closer than 2 d can change order. So where the smallest gap
  between two scores exceeds 2 d, the two harnesses rank alike and every
  ranking metric (AUROC, AUPRC, pointing, Dice at a threshold no pixel
  lies within d of) must agree at 1e-12; pixel AUROC, over ~10^5 pixels,
  may move by the pairs closer than 2 d over n_pos n_neg.
"""

import json
import logging
import os
import zlib
from types import SimpleNamespace

import jax
import numpy as np
import pandas as pd
import pytest

from radzero_tpu.data.processing import BlipStyleImageProcessor as JaxProcessor
from radzero_tpu.data.tokenizer import WhitespaceHashTokenizer as JaxTokenizer
from radzero_tpu.eval import geometry as jgeometry
from radzero_tpu.eval import mergers as jmergers
from radzero_tpu.eval import segmentation as jsegmentation
from radzero_tpu.eval.inference import Inference as JaxInference
from radzero_tpu.eval.scorer import ZeroShotScorer as JaxScorer
from radzero_tpu.models import configuration as jconf
from radzero_tpu.models.radzero import init_radzero
from radzero_torch.data.dicom import load_eval_image
from radzero_torch.data.processing import BlipStyleImageProcessor
from radzero_torch.data.tokenizer import WhitespaceHashTokenizer
from radzero_torch.eval import _table, geometry, mergers, segmentation
from radzero_torch.eval.inference import Inference
from radzero_torch.eval.metrics import rle2mask
from radzero_torch.eval.registry import get_infer_dirs
from radzero_torch.eval.scorer import ZeroShotScorer
from radzero_torch.models import configuration as tconf
from radzero_torch.models.from_jax import params_from_jax
from radzero_torch.tools import synthetic_eval_data as tsd
from test_torch_modules import perturbed
from tools import synthetic_eval_data as jsd

D = 32
N = 24  # OpenI / PadChest need 24 studies for three non-empty long-tail buckets
CLS = ["OpenI", "PadChest", "ChestXray14", "Chexpert", "ChestXDet10"]
DET = ["ChestXDet10", "MS-CXR"]
SEG = ["SIIM", "RSNA"]


def _cfg(m):
    return m.RadZeroConfig(
        vision=m.ViTConfig(hidden_size=D, num_hidden_layers=1, num_attention_heads=2,
                           mlp_ratio=2.0, patch_size=14, pretrain_img_size=28, img_size=28),
        text=m.TextConfig(hidden_size=D, num_hidden_layers=1, num_attention_heads=2,
                          intermediate_size=64, vocab_size=5003, max_position_embeddings=40),
        align=m.AlignConfig(hidden_size=D, num_hidden_layers=1, num_attention_heads=2,
                            mlp_ratio=2.0),
        loss=m.LossConfig(hidden_dim=D),
    )


# the JAX builders, one call per dataset; the port's take the same arguments
BUILDS = {
    "images": ("build_images", dict(n=N)),
    "Chexpert": ("build_chexpert", dict(n=N)),
    "ChestXDet10": ("build_chestxdet10", dict(n=N, boxes_per_image=2)),
    "MS-CXR": ("build_mscxr", dict(n=4)),
    "SIIM": ("build_siim", dict(n=8)),
    "RSNA": ("build_rsna", dict(n=8)),
    "OpenI": ("build_openi", dict(n=N)),
    "PadChest": ("build_padchest", dict(n=N)),
    "ChestXray14": ("build_chestxray14", dict(n=N)),
}


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """Every registry dataset, written by the JAX builders (plus the port's
    CheXpert-5x200 label file, which the JAX builders lack)."""
    root = str(tmp_path_factory.mktemp("evaldata"))
    for fn, kw in BUILDS.values():
        getattr(jsd, fn)(root, **kw)
    tsd.build_chexpert5x200(root, n=10)
    return root


@pytest.mark.parametrize("dataset", sorted(BUILDS))
def test_builder_writes_the_jax_builders_files(dataset, tmp_path):
    fn, kw = BUILDS[dataset]
    theirs, ours = str(tmp_path / "jax"), str(tmp_path / "port")
    getattr(jsd, fn)(theirs, **kw)
    getattr(tsd, fn)(ours, **kw)
    assert _files(ours) == _files(theirs) and _files(ours)
    for f in _files(theirs):
        with open(os.path.join(theirs, f), "rb") as a, open(os.path.join(ours, f), "rb") as b:
            assert a.read() == b.read(), f


def _pandas_equal(path, table, **kw):
    df = pd.read_csv(path, **kw)
    assert table.columns == list(df.columns)
    for c in df.columns:
        theirs, ours = df[c].tolist(), table[c].tolist()
        kind = df[c].dtype.kind if df[c].dtype.kind in "if" else "O"
        assert table[c].dtype.kind == kind, (path, c, df[c].dtype, table[c].dtype)
        assert len(theirs) == len(ours)
        for a, b in zip(theirs, ours):
            assert (pd.isna(a) and _table.isna(b)) or (a == b and type(a) is type(b)), (c, a, b)


def _harness_csvs(root):
    dirs = get_infer_dirs(root)
    out = [(dirs[d]["image_path"], {}) for d in CLS]
    out += [(dirs[d]["data_path"], {}) for d in SEG]
    out += [(os.path.join(root, mergers.MERGERS[d][0]), {})
            for d in ("OpenI", "Chexpert", "Chexpert_5x200")]
    out.append((os.path.join(root, mergers.MERGERS["ChestXray14"][0]),
                dict(sep=" ", names=["path"] + mergers.CHESTXRAY14_CLASSES)))
    return out


def test_table_reader_matches_pandas_on_every_harness_file(data_root):
    files = _harness_csvs(data_root)
    assert len(files) == 11
    for path, kw in files:
        _pandas_equal(path, _table.read_csv(path, **kw), **kw)
    siim = _table.read_csv(get_infer_dirs(data_root)["SIIM"]["data_path"])
    assert " EncodedPixels" in siim.columns and " -1" in siim[" EncodedPixels"].tolist()
    boxes = _table.read_csv(get_infer_dirs(data_root)["RSNA"]["data_path"])["boxes"]
    assert _table.isna(boxes.tolist()[1])
    labels = _table.read_csv(os.path.join(data_root, "Chexpert/test_labels.csv"))
    assert labels.values(mergers.CHEXPERT5_CLASSES).dtype == np.int64


QUIRKS = {
    "siim_negatives_only": " EncodedPixels,x\n -1,1\n -1,2\n",  # reads as int -1
    "siim_mixed": "ImageId, EncodedPixels\nid0, -1\nid1,10 6\n",
    "rsna_empty": "img_path,boxes\na.png,\nb.png,\n",  # an all-NaN float column
    "int_with_empty": "a,b\n1,\n,3\n",  # int64 -> float64
    "floats_and_spaces": "a,b\n 1.5,1 \n.5,+2\n",
    "na_strings": "a,b\nNA,None\nnan,x\n",
    "quoted": 'a,b\n"x,y",1\nz,2\n',
    "not_numbers": "a\n0x10\n1_000\n",
    "blank_line_and_short_row": "a,b\n1,2\n\n3\n",
    "exponents": "a\n1e3\n-2E-2\ninf\n",
}


@pytest.mark.parametrize("name", sorted(QUIRKS))
def test_table_reader_quirks_match_pandas(name, tmp_path):
    path = tmp_path / "t.csv"
    path.write_text(QUIRKS[name])
    _pandas_equal(path, _table.read_csv(str(path)))


def test_space_separated_list_without_header_matches_pandas(tmp_path):
    path = tmp_path / "list.txt"
    path.write_text("imgs/0.png 1 0 1\nimgs/1.png 0 0 1\n")
    kw = dict(sep=" ", names=["path", "a", "b", "c"])
    table = _table.read_csv(str(path), **kw)
    _pandas_equal(path, table, **kw)
    np.testing.assert_array_equal(table.values(["a", "b", "c"]),
                                  pd.read_csv(path, **kw)[["a", "b", "c"]].values)


def test_similarity_csv_matches_pandas_bytes(tmp_path):
    rng = np.random.default_rng(0)
    sims = (rng.standard_normal((9, 7)) * np.logspace(-9, 9, 7)).astype(np.float32)
    sims[0, :4] = [0.0, -0.0, np.nan, np.inf]
    for array in (sims, sims.astype(np.float64) * 1.1, sims[:, :1]):
        pd.DataFrame(array).to_csv(tmp_path / "a.csv", index=False)
        _table.write_matrix_csv(str(tmp_path / "b.csv"), array)
        assert (tmp_path / "a.csv").read_bytes() == (tmp_path / "b.csv").read_bytes()


# ---------------------------------------------------------------------------
# mergers
# ---------------------------------------------------------------------------

def _similarities(n, p, seed):
    rng = np.random.default_rng(seed)
    sims = rng.standard_normal((n, p)).astype(np.float32)
    sims[:, 0] = np.round(sims[:, 0], 1)  # ties
    return sims


MERGER_SHAPES = {"OpenI": (N, 18), "PadChest": (N, 12), "ChestXray14": (N, 14),
                 "Chexpert": (N, 5), "ChestXDet10": (N, 10), "Chexpert_5x200": (10, 5)}


@pytest.mark.parametrize("name", sorted(MERGER_SHAPES))
def test_merger_matches_jax(name, data_root):
    sims = _similarities(*MERGER_SHAPES[name], seed=len(name))
    label = os.path.join(data_root, mergers.MERGERS[name][0])
    assert mergers.MERGERS[name][0] == jmergers.MERGERS[name][0]
    theirs = jmergers.MERGERS[name][1](sims, label)
    ours = mergers.MERGERS[name][1](sims, label)
    assert list(ours) == list(theirs)
    for k in theirs:
        np.testing.assert_allclose(ours[k], theirs[k], rtol=0, atol=1e-12, equal_nan=True,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# the facade on a stub scorer
# ---------------------------------------------------------------------------

class StubScorer:
    """Fixed arrays for each (items, prompts) call, from a seed of their
    names, with ties in the logits; loads every item as a scorer does."""

    device = "cpu"

    def __init__(self):
        self.image_processor = SimpleNamespace(geometry="resize")

    @staticmethod
    def _rng(items, texts):
        names = [os.path.basename(str(it)) if not isinstance(it, dict) else it["image"]
                 for it in items]
        return np.random.default_rng(zlib.crc32(repr((names, list(texts))).encode()))

    @staticmethod
    def _load(items, load_image):
        for it in items:
            im = load_image(it)
            im.close() if hasattr(im, "close") else None

    def score(self, items, load_image, prompts, *, need_scores=False):
        self._load(items, load_image)
        rng = self._rng(items, prompts)
        logits = np.round(rng.standard_normal((len(items), len(prompts))), 1).astype(np.float32)
        maps = rng.standard_normal((len(items), len(prompts), 16)).astype(np.float32)
        return logits, (maps if need_scores else None)

    def score_paired(self, items, load_image, texts, *, need_scores=False):
        self._load(items, load_image)
        rng = self._rng(items, texts)
        logits = rng.standard_normal(len(items)).astype(np.float32)
        maps = rng.standard_normal((len(items), 16)).astype(np.float32)
        return logits, (maps if need_scores else None)


def _port_upsample_cpu(scores, origin_size, geometry_name="resize"):
    return geometry.upsample_similarity_map(scores, origin_size, geometry_name, device="cpu")


@pytest.fixture
def shared_upsample(monkeypatch):
    """The JAX harness's upsample replaced by the port's on the CPU."""
    monkeypatch.setattr(jgeometry, "upsample_similarity_map", _port_upsample_cpu)
    monkeypatch.setattr(jsegmentation, "upsample_similarity_map", _port_upsample_cpu)


def _run(facade, scorer, root, out, task, **kw):
    inf = facade(CLS, DET, SEG, root, batch_size=4)
    return getattr(inf, task)(scorer, str(out), **kw)


@pytest.mark.parametrize("task,kw", [("classification", {}), ("grounding", {}),
                                     ("segmentation", {}),
                                     ("segmentation", {"compute_pixel_level_auroc": True})])
def test_inference_on_a_stub_scorer_writes_the_jax_files(task, kw, data_root, tmp_path,
                                                          shared_upsample):
    theirs = _run(JaxInference, StubScorer(), data_root, tmp_path / "jax", task, **kw)
    ours = _run(Inference, StubScorer(), data_root, tmp_path / "port", task, **kw)
    assert theirs is not None and ours is not None
    assert json.dumps(ours) == json.dumps(theirs)
    names = _files(tmp_path / "jax")
    assert names == _files(tmp_path / "port") and "result.json" in names
    if task == "classification":
        assert names == sorted([f"{d}.csv" for d in CLS] + ["result.json"])
    for f in names:
        assert (tmp_path / "jax" / f).read_bytes() == (tmp_path / "port" / f).read_bytes(), f


def test_streaming_segmentation_matches_materialising(data_root):
    table = _table.read_csv(get_infer_dirs(data_root)["SIIM"]["data_path"])
    ref = segmentation.eval_segmentation_siim(StubScorer(), table, "There is Pneumothorax",
                                              data_root)
    out = segmentation.eval_segmentation_siim(StubScorer(), table, "There is Pneumothorax",
                                              data_root, streaming=True)
    for key in ("auc", "dice", "best_threshold", "specificity"):
        np.testing.assert_allclose(out[key], ref[key], rtol=0, atol=1e-12, err_msg=key)


class _Broken(StubScorer):
    def score(self, *a, **kw):
        raise RuntimeError("scorer failed")


@pytest.mark.parametrize("task", ["classification", "grounding", "segmentation"])
def test_facade_contains_errors_like_jax(task, data_root, tmp_path):
    assert _run(JaxInference, _Broken(), data_root, tmp_path / "jax", task) is None
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    log = logging.getLogger("radzero_torch")
    log.addHandler(handler)
    try:
        assert _run(Inference, _Broken(), data_root, tmp_path / "port", task) is None
    finally:
        log.removeHandler(handler)
    assert any(r.levelno == logging.ERROR and "scorer failed" in r.getMessage()
               for r in records)
    assert not (tmp_path / "port" / "result.json").exists()


@pytest.mark.parametrize("geometry_name", ["resize", "aspect_pad", "center_crop", "m3ae"])
def test_grounding_point_matches_jax(geometry_name):
    """Equal points, except where a map's top two values lie within the
    two resizes' difference (counted, and held to that)."""
    rng = np.random.default_rng(20)
    for hw in ((70, 60), (45, 91), (33, 33)):
        scores = rng.standard_normal((6, 16)).astype(np.float32)
        for s in scores:
            ours = geometry.grounding_point(s, hw, geometry_name, device="cpu")
            theirs = jgeometry.grounding_point(s, hw, geometry_name)
            if ours != theirs:
                up = jgeometry.upsample_similarity_map(s, hw, geometry_name)
                assert up[theirs[1], theirs[0]] - up[ours[1], ours[0]] <= 2e-6
    assert geometry.is_point_in_bbox([[0, 0, 5, 5], [10, 10, 20, 20]], (12, 20))
    assert not geometry.is_point_in_bbox([[0, 0, 5, 5]], (6, 0))


def test_chest_sized_builder_reads_back(tmp_path):
    """``build_all`` with sizes: grayscale studies at those sizes, SIIM as
    8-bit DICOMs that both packages' readers open, masks and boxes inside
    the images; the stub facade finds MS-CXR's whole-image boxes."""
    from radzero_tpu.data.dicom import load_eval_image as jax_load

    sizes = [(150, 120), (128, 170), (141, 133), (160, 125)]
    root = str(tmp_path / "data")
    tsd.build_all(root, n=4, sizes=sizes, siim_size=64, compress_level=1, threads=2)
    for i, (h, w) in enumerate(sizes):
        with load_eval_image(os.path.join(root, f"imgs/{i}.png")) as im:
            assert im.size == (w, h) and im.mode == "L"
    siim = _table.read_csv(os.path.join(root, "SIIM/test.csv"))
    assert siim["ImageId"].tolist().count("id0") == 2
    for path, rle in zip(siim["dicom_path"].tolist(), siim[" EncodedPixels"].tolist()):
        ours = np.asarray(load_eval_image(os.path.join(root, path)))
        np.testing.assert_array_equal(ours, np.asarray(jax_load(os.path.join(root, path))))
        assert ours.shape == (64, 64, 3)
        if rle != " -1":
            assert 0 < rle2mask(rle, 64, 64).sum() < 64 * 64
    out = Inference([], ["MS-CXR"], ["SIIM", "RSNA"], root).grounding(
        StubScorer(), str(tmp_path / "det"))
    assert out == {"MS-CXR": 1.0}
    seg = Inference([], [], ["SIIM", "RSNA"], root).segmentation(StubScorer(),
                                                                 str(tmp_path / "seg"))
    assert seg is not None and set(seg) == {"SIIM", "RSNA"}


# ---------------------------------------------------------------------------
# the whole suite on the real scorers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def scorers():
    jcfg, tcfg = _cfg(jconf), _cfg(tconf)
    tree = perturbed(init_radzero(jax.random.PRNGKey(0), jcfg), np.random.default_rng(0))
    theirs = JaxScorer(tree, jcfg, JaxProcessor(size=28),
                       JaxTokenizer(vocab_size=5003, max_length=12), batch_size=4)
    ours = ZeroShotScorer(params_from_jax(tree), tcfg, BlipStyleImageProcessor(size=28),
                          WhitespaceHashTokenizer(vocab_size=5003, max_length=12),
                          device="cpu", batch_size=4)
    return ours, theirs


@pytest.fixture(scope="module")
def suites(scorers, data_root, tmp_path_factory):
    """Each package's facade over every dataset: (results, output dir)."""
    out = {}
    for name, facade, scorer in (("port", Inference, scorers[0]),
                                 ("jax", JaxInference, scorers[1])):
        d = tmp_path_factory.mktemp(f"suite_{name}")
        res = {task: _run(facade, scorer, data_root, d / task, task, **kw)
               for task, kw in (("classification", {}), ("grounding", {}),
                                ("segmentation", {"compute_pixel_level_auroc": True}))}
        assert all(v is not None for v in res.values()), name
        out[name] = (res, d)
    return out


def _min_gap(values):
    v = np.sort(np.asarray(values, np.float64).ravel())
    return float(np.diff(v).min())


@pytest.mark.parametrize("dataset", CLS)
def test_suite_classification_matches_jax(dataset, suites):
    (ours, od), (theirs, jd) = suites["port"], suites["jax"]
    a = _table.read_csv(str(od / "classification" / f"{dataset}.csv"))
    b = pd.read_csv(jd / "classification" / f"{dataset}.csv")
    sims_ours = a.values(a.columns).astype(np.float64)
    sims_theirs = b.values.astype(np.float64)
    np.testing.assert_allclose(sims_ours, sims_theirs, rtol=1e-3, atol=2e-4)
    d = float(np.abs(sims_ours - sims_theirs).max())
    # both rank alike (per column and over the raveled micro averages)
    assert _min_gap(sims_theirs) > 2 * d, (dataset, _min_gap(sims_theirs), d)
    r_ours, r_theirs = ours["classification"][dataset], theirs["classification"][dataset]
    assert list(r_ours) == list(r_theirs)
    for k in r_theirs:
        np.testing.assert_allclose(r_ours[k], r_theirs[k], rtol=0, atol=1e-12, err_msg=k)


def _maps(scorer, items, load, prompts, sizes, up):
    _, scores = scorer.score(items, load, prompts, need_scores=True)
    return [up(s, size) for s, size in zip(scores, sizes)]


def test_suite_grounding_matches_jax(suites, scorers, data_root):
    """Equal pointing scores and MS-CXR accuracy. The points of every
    ChestXDet10 map are recomputed from both scorers' maps: a point may
    differ only where the JAX map's value there is within twice the two
    maps' largest difference of its maximum (a near-tie); with no such
    map the pointing scores must be equal, else each differs by at most
    the differing maps' share."""
    (ours, _), (theirs, _) = suites["port"], suites["jax"]
    assert ours["grounding"]["MS-CXR"] == theirs["grounding"]["MS-CXR"] == 1.0
    dirs = get_infer_dirs(data_root)
    items = _table.read_csv(dirs["ChestXDet10"]["image_path"])["Path"].tolist()
    prompts = [v[0] for v in json.load(open(dirs["ChestXDet10"]["text_path"])).values()]
    sizes = []
    for p in items:
        with load_eval_image(os.path.join(data_root, p)) as im:
            sizes.append(im.size[::-1])
    from radzero_torch.eval.classification import _image_loader

    maps_ours = _maps(scorers[0], items, _image_loader(data_root), prompts, sizes,
                      lambda s, hw: geometry.upsample_similarity_map(s, hw, device="cpu"))
    maps_theirs = _maps(scorers[1], items, _image_loader(data_root), prompts, sizes,
                        jgeometry.upsample_similarity_map)
    n_maps, differ = 0, 0
    for a, b in zip(maps_ours, maps_theirs):
        d = float(np.abs(a - b).max())
        assert d < 1e-4
        for ma, mb in zip(a, b):
            n_maps += 1
            ia, ib = int(np.argmax(ma)), int(np.argmax(mb))
            if ia != ib:
                differ += 1
                assert mb.ravel()[ia] >= mb.max() - 2 * d
    r_ours, r_theirs = ours["grounding"]["ChestXDet10"], theirs["grounding"]["ChestXDet10"]
    assert list(r_ours) == list(r_theirs)
    for k in r_theirs:
        assert abs(r_ours[k] - r_theirs[k]) <= differ / n_maps * len(items), k
    if differ == 0:
        assert r_ours == r_theirs


def _pairs_within(pos, neg, w):
    """Number of (positive, negative) pairs whose scores lie within w."""
    neg = np.sort(neg)
    return int((np.searchsorted(neg, pos + w, "right")
                - np.searchsorted(neg, pos - w, "left")).sum())


@pytest.mark.parametrize("dataset", SEG)
def test_suite_segmentation_matches_jax(dataset, suites, scorers, data_root):
    (ours, _), (theirs, _) = suites["port"], suites["jax"]
    r_ours, r_theirs = ours["segmentation"][dataset], theirs["segmentation"][dataset]
    table = _table.read_csv(get_infer_dirs(data_root)[dataset]["data_path"])
    # the probability maps each harness computes, and the masks
    if dataset == "SIIM":  # one row an image in the builders' miniature
        paths = table["dicom_path"].tolist()
        rles = dict(zip(paths, table[" EncodedPixels"].tolist()))
    else:
        paths = table["img_path"].tolist()
    items = [os.path.join(data_root, p) for p in paths]
    sizes = []
    for it in items:
        with load_eval_image(it) as im:
            sizes.append(im.size[::-1])
    if dataset == "SIIM":
        masks = [(rle2mask(rles[p], *hw) > 0).astype(np.int64) if rles[p] != " -1"
                 else np.zeros(hw, np.int64) for p, hw in zip(paths, sizes)]
    else:
        masks = []
        for b, (h, w) in zip(table["boxes"].tolist(), sizes):
            m = np.zeros((h, w), np.int64)
            if not _table.isna(b):
                x0, y0, bw, bh = (int(float(c)) for c in b.split(";")[:4])
                m[y0:y0 + bh, x0:x0 + bw] = 1
            masks.append(m)
    text = ["There is Pneumothorax" if dataset == "SIIM" else "There is Pneumonia"]
    sig = segmentation._sigmoid
    p_ours = [sig(m[0]) for m in _maps(scorers[0], items, load_eval_image, text, sizes,
              lambda s, hw: geometry.upsample_similarity_map(s, hw, device="cpu"))]
    p_theirs = [sig(m[0]) for m in _maps(scorers[1], items, load_eval_image, text, sizes,
                jgeometry.upsample_similarity_map)]
    d = max(float(np.abs(a - b).max()) for a, b in zip(p_ours, p_theirs))
    assert d < 1e-5
    # Dice at threshold t counts the positive images' pixels above t: only
    # those within d of t can change sides (n_t pixels, m_t of them masked),
    # so each Dice lies in [2 (I - m) / (P + n + T), 2 (I + m) / (P - n + T)]
    # and the best one within the largest ends; with no such pixel the
    # counts, the Dice, its threshold and the specificity are the same
    grid = np.arange(0, 1.01, 0.01)
    pos = [(p.ravel(), m.ravel()) for p, m in zip(p_theirs, masks) if m.sum() > 0]
    probs = np.concatenate([p for p, _ in pos]).astype(np.float64)[:, None]
    target = np.concatenate([m for _, m in pos])[:, None]
    above, near = probs > grid, np.abs(probs - grid) <= d
    inter, pred, t_sum = (above * target).sum(0), above.sum(0), float(target.sum())
    n, m = near.sum(0), (near * target).sum(0)
    lo = (2 * (inter - m) / (pred + n + t_sum)).max()
    hi = (2 * (inter + m) / np.maximum(pred - n + t_sum, 1)).max()
    assert lo - 1e-12 <= r_ours["dice"] <= hi + 1e-12
    np.testing.assert_allclose(r_ours["auc"], r_theirs["auc"], rtol=0, atol=1e-12)
    if not near.any():
        for k in ("dice", "best_threshold", "specificity"):
            np.testing.assert_allclose(r_ours[k], r_theirs[k], rtol=0, atol=1e-12, err_msg=k)
    elif r_ours["best_threshold"] == r_theirs["best_threshold"]:
        t = r_theirs["best_threshold"]
        neg_max = [float(p.max()) for p, mk in zip(p_theirs, masks) if mk.sum() == 0]
        flips = sum(abs(v - t) <= d for v in neg_max)
        assert abs(r_ours["specificity"] - r_theirs["specificity"]) <= flips / len(neg_max)
    # pixel AUROC: each (positive, negative) pixel pair closer than 2 d may flip
    all_p = np.concatenate([p.ravel() for p in p_theirs]).astype(np.float64)
    all_m = np.concatenate([m.ravel() for m in masks]).astype(bool)
    n_pos, n_neg = int(all_m.sum()), int((~all_m).sum())
    bound = _pairs_within(all_p[all_m], all_p[~all_m], 2 * d) / (n_pos * n_neg)
    assert abs(r_ours["pixel_level_auroc"] - r_theirs["pixel_level_auroc"]) <= bound + 1e-12
