"""The port's numpy metrics (radzero_torch/eval/metrics.py) against the JAX
package's (radzero_tpu/eval/metrics.py, on scikit-learn), on the CPU.

Every metric is held at atol 1e-12 on seeded and hypothesis-drawn arrays
with ties, constant scores and degenerate label columns; rle2mask and the
streaming segmentation accumulator bit for bit; and where scikit-learn
raises, the port raises the same exception type. Where scikit-learn returns
NaN with a warning (a label column with a single class), so does the port.
"""

import warnings

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from hypothesis.extra import numpy as hnp
from scipy.stats import rankdata
from sklearn import metrics as skm

from radzero_tpu.eval import metrics as J
from radzero_torch.eval import metrics as T

ATOL = 1e-12


def _quiet(fn, *a, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*a, **kw)


def _same(a, b):
    """Equal within ATOL, NaN where the other is NaN, elementwise for tuples."""
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
        return
    np.testing.assert_allclose(np.asarray(b, np.float64), np.asarray(a, np.float64),
                               rtol=0, atol=ATOL, equal_nan=True)


def _labels_scores(seed, n=30, c=6, ties=False, float_labels=False):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2, (n, c))
    y[0], y[1] = 1, 0
    s = rng.standard_normal((n, c)).astype(np.float32)
    if ties:
        s = np.round(s, 1)
    return (y.astype(np.float32) if float_labels else y), s


# name -> (y_true, y_score): ties, constant scores, single-class and all-negative
# columns, float labels, one column
def _cases():
    y, s = _labels_scores(0)
    out = {"random": (y, s)}
    out["ties"] = _labels_scores(1, ties=True)
    yc, sc = _labels_scores(2)
    sc[:, 2] = 0.25
    out["constant_score_column"] = (yc, sc)
    yd, sd = _labels_scores(3)
    yd[:, 1] = 1
    yd[:, 4] = 0
    out["single_class_columns"] = (yd, sd)
    out["all_negative"] = (np.zeros((12, 3), np.int64), _labels_scores(4, n=12, c=3)[1])
    out["float_labels"] = _labels_scores(5, float_labels=True)
    y1, s1 = _labels_scores(6)
    out["one_column"] = (y1[:, [2]], s1[:, [2]])
    out["integer_scores"] = (y, np.floor(s * 2))
    return out


CASES = _cases()


@pytest.mark.parametrize("case", sorted(CASES))
def test_eval_auc_matches_sklearn(case):
    y, s = CASES[case]
    _same(_quiet(J.eval_auc, s, y), _quiet(T.eval_auc, s, y))


@pytest.mark.parametrize("case", sorted(c for c in CASES if c != "all_negative"))
def test_auprc_matches_sklearn(case):
    y, s = CASES[case]
    y = y if y.ndim == 2 and y.shape[1] > 1 else np.concatenate([y, 1 - y], axis=1)
    s = s if s.shape[1] == y.shape[1] else np.concatenate([s, -s], axis=1)
    _same(_quiet(J.calculate_micro_macro_auprc, y, s),
          _quiet(T.calculate_micro_macro_auprc, y, s))


def test_precision_recall_curve_and_auc_match_sklearn():
    y, s = CASES["ties"]
    for c in range(y.shape[1]):
        ours = T.precision_recall_curve(y[:, c], s[:, c])
        theirs = skm.precision_recall_curve(y[:, c], s[:, c])
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a, b)
        assert T.auc(ours[1], ours[0]) == skm.auc(theirs[1], theirs[0])
    x = np.array([0.0, 0.1, 0.1, 0.7, 1.0])
    assert T.auc(x, x ** 2) == skm.auc(x, x ** 2)
    assert T.auc(x[::-1], x[::-1] ** 2) == skm.auc(x[::-1], x[::-1] ** 2)


def test_roc_auc_is_the_mann_whitney_statistic():
    """The trapezoid over the ROC curve is U / (n_pos n_neg) with ties at
    half credit (the rank form)."""
    rng = np.random.default_rng(7)
    for n in (5, 50, 2000):
        y = rng.integers(0, 2, n)
        y[:2] = (0, 1)
        s = np.round(rng.standard_normal(n), 1)
        ranks = rankdata(s)
        n_pos = int(y.sum())
        u = ranks[y == 1].sum() - n_pos * (n_pos + 1) / 2
        assert abs(T.roc_auc_score(y, s) - u / (n_pos * (n - n_pos))) < ATOL


@pytest.mark.parametrize("labels", [(0, 1), (-1, 1), (1, 2), (0, 0)])
def test_binary_roc_auc_matches_sklearn(labels):
    rng = np.random.default_rng(8)
    y = np.asarray(labels)[rng.integers(0, 2, 40)]
    y[:2] = labels
    s = np.round(rng.standard_normal(40), 1)
    _same(_quiet(skm.roc_auc_score, y, s), _quiet(T.roc_auc_score, y, s))


def test_single_class_gives_nan_with_a_warning_as_sklearn():
    y, s = np.ones(6, np.int64), np.arange(6.0)
    with pytest.warns(UserWarning):
        ours = T.roc_auc_score(y, s)
    assert np.isnan(ours) and np.isnan(_quiet(skm.roc_auc_score, y, s))


@pytest.mark.parametrize("case", ["empty_columns", "empty_rows", "nan_score", "inf_score",
                                  "multiclass", "continuous_labels", "bad_average",
                                  "lengths"])
def test_roc_auc_raises_where_sklearn_raises(case):
    y, s = CASES["random"]
    y, s = {
        "empty_columns": (y[:, :0], s[:, :0]),
        "empty_rows": (y[:0], s[:0]),
        "nan_score": (y, np.where(np.eye(*s.shape, dtype=bool), np.nan, s)),
        "inf_score": (y[:, 0], np.r_[np.inf, s[1:, 0]]),
        "multiclass": (np.arange(10) % 3, np.arange(10.0)),
        "continuous_labels": (np.linspace(0, 1, 10), np.arange(10.0)),
        "bad_average": (y, s),
        "lengths": (y[:, 0], s[:-1, 0]),
    }[case]
    kw = {"average": "samples2"} if case == "bad_average" else {}
    with pytest.raises(ValueError):
        _quiet(skm.roc_auc_score, y, s, **kw)
    with pytest.raises(ValueError):
        _quiet(T.roc_auc_score, y, s, **kw)


@pytest.mark.parametrize("case", ["multiclass", "too_few_points", "not_monotonic"])
def test_curves_raise_where_sklearn_raises(case):
    if case == "multiclass":
        calls = [(m.precision_recall_curve, (np.arange(9) % 3, np.arange(9.0))) for m in (skm, T)]
    elif case == "too_few_points":
        calls = [(m.auc, (np.array([0.5]), np.array([1.0]))) for m in (skm, T)]
    else:
        calls = [(m.auc, (np.array([0.0, 0.5, 0.2]), np.array([1.0, 1.0, 1.0])))
                 for m in (skm, T)]
    for fn, args in calls:
        with pytest.raises(ValueError):
            fn(*args)


@pytest.mark.parametrize("case", ["random", "zero_division", "all_zero_truth"])
def test_eval_f1_matches_sklearn(case):
    rng = np.random.default_rng(9)
    y = rng.integers(0, 2, (20, 5))
    pred = (rng.random((20, 5)) > 0.6).astype(np.float64)
    if case == "zero_division":
        y[:, 1], pred[:, 1] = 0, 0
    elif case == "all_zero_truth":
        y[:] = 0
    _same(_quiet(J.eval_f1, pred, y), _quiet(T.eval_f1, pred, y))


def test_accuracy_matches_sklearn():
    rng = np.random.default_rng(10)
    y = rng.integers(0, 5, 50)
    p = rng.integers(0, 5, 50)
    assert T.accuracy_score(y, p) == skm.accuracy_score(y, p)
    assert T.accuracy_score(y % 2, (p % 2).astype(float)) == skm.accuracy_score(
        y % 2, (p % 2).astype(float))


@settings(max_examples=60, deadline=None)
@given(data=st.data())
def test_ranking_metrics_match_on_drawn_arrays(data):
    n = data.draw(st.integers(2, 25))
    c = data.draw(st.integers(2, 5))
    y = data.draw(hnp.arrays(np.int64, (n, c), elements=st.integers(0, 1)))
    # few distinct values: ties within and across columns, constant columns
    s = data.draw(hnp.arrays(np.float32, (n, c), elements=st.sampled_from(
        [-2.0, -0.5, 0.0, 0.25, 0.25000003, 1.0, 3.5])))
    _same(_quiet(J.eval_auc, s, y), _quiet(T.eval_auc, s, y))
    _same(_quiet(J.eval_f1, (s > 0).astype(np.int64), y),
          _quiet(T.eval_f1, (s > 0).astype(np.int64), y))
    if (y.sum(axis=0) > 0).all():
        _same(_quiet(J.calculate_micro_macro_auprc, y, s),
              _quiet(T.calculate_micro_macro_auprc, y, s))


@settings(max_examples=40, deadline=None)
@given(data=st.data())
def test_dice_sweep_matches_on_drawn_maps(data):
    n = data.draw(st.integers(1, 200))
    p = data.draw(hnp.arrays(np.float32, n, elements=st.one_of(
        st.sampled_from([0.0, 0.01, 0.5, 0.55, 0.99, 1.0, float("nan")]),
        st.floats(0, 1, width=32))))
    m = data.draw(hnp.arrays(np.int64, n, elements=st.integers(0, 1)))
    assert T.best_threshold_dice(p, m) == J.best_threshold_dice(p, m)


def test_long_tail_split_matches():
    y = np.random.default_rng(11).integers(0, 2, (40, 12))
    y[:, :3] = 0
    y[:5, :3] = 1
    for a, b in zip(J.long_tail_multi_label_split(y), T.long_tail_multi_label_split(y)):
        np.testing.assert_array_equal(a, b)


def _maps(seed, n=6, hw=(30, 20)):
    rng = np.random.default_rng(seed)
    probs = rng.random((n, *hw)).astype(np.float32)
    probs[0, :3] = 0.5  # exact threshold hits
    masks = (rng.random((n, *hw)) > 0.8).astype(np.int64)
    masks[1] = 0
    return probs, masks


def test_segmentation_metrics_match():
    probs, masks = _maps(12)
    pos = masks.reshape(len(masks), -1).sum(1) > 0
    flat_p, flat_m = probs[pos].ravel(), masks[pos].ravel()
    assert T.best_threshold_dice(flat_p, flat_m) == J.best_threshold_dice(flat_p, flat_m)
    t = [0.9, 0.1, 0.5, 0.5, 0.3]  # unsorted, repeated
    assert T.best_threshold_dice(flat_p, flat_m, t) == J.best_threshold_dice(flat_p, flat_m, t)
    assert T.micro_dice(flat_p > 0.4, flat_m) == J.micro_dice(flat_p > 0.4, flat_m)
    assert T.micro_dice(np.zeros(4), np.zeros(4)) == J.micro_dice(np.zeros(4), np.zeros(4))
    assert T.compute_specificity(probs[~pos], 0.5) == J.compute_specificity(probs[~pos], 0.5)
    assert T.pixel_auroc(probs, masks) == J.pixel_auroc(probs, masks)


def test_large_dice_sweep_runs_in_chunks():
    """Above one chunk of pixels (2^24) the counts still add up exactly."""
    rng = np.random.default_rng(13)
    n = (1 << 24) + 12_345
    p = rng.random(n, dtype=np.float32)
    m = (rng.random(n) > 0.7).astype(np.int64)
    t = np.arange(0, 1.01, 0.25)
    assert T.best_threshold_dice(p, m, t) == J.best_threshold_dice(p, m, t)


@pytest.mark.parametrize("fn", ["eval_precision", "eval_recall", "eval_bacc",
                                "eval_sensitivity_specificity"])
def test_sign_metrics_match(fn):
    rng = np.random.default_rng(14)
    y = rng.integers(0, 2, (25, 4))
    y[0], y[1] = 1, 0
    s = rng.standard_normal((25, 4))
    arg = (s > 0).astype(np.int64) if fn in ("eval_bacc", "eval_sensitivity_specificity") else s
    _same(getattr(J, fn)(arg, y), getattr(T, fn)(arg, y))


def _rle(rng, height, width, runs):
    pairs, pos = [], 0
    for _ in range(runs):
        gap, length = int(rng.integers(0, 40)), int(rng.integers(1, 30))
        if pos + gap + length > height * width:
            break
        pairs += [gap, length]
        pos += gap + length
    return " ".join(map(str, pairs))


@pytest.mark.parametrize("hw", [(32, 32), (20, 37)])
def test_rle2mask_is_bit_equal(hw):
    rng = np.random.default_rng(15)
    for runs in (0, 1, 7, 40):
        rle = _rle(rng, *hw, runs)
        a, b = J.rle2mask(rle, *hw), T.rle2mask(rle, *hw)
        assert a.dtype == b.dtype and a.shape == b.shape == hw
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("pixel_auroc", [False, True])
def test_streaming_accumulator_is_bit_equal(pixel_auroc):
    probs, masks = _maps(16)
    logits = np.random.default_rng(17).standard_normal(len(probs))
    accs = [J.StreamingSegmentationMetrics(), T.StreamingSegmentationMetrics()]
    for acc in accs:
        for lg, p, m in zip(logits, probs, masks):
            acc.update(float(lg), p, m)
    a, b = (acc.finalize(pixel_auroc) for acc in accs)
    assert a == b
    for name in ("_pos_tp", "_pos_pred", "_hist_pos", "_hist_neg"):
        np.testing.assert_array_equal(getattr(accs[0], name), getattr(accs[1], name))
