"""The port's training-run tools against the JAX tools under tools/, on the CPU.

``radzero_torch/tools/dedup_calibration.py``'s JSON against the JAX tool's
printout, byte for byte, at a cut window count; the soak's loader
(``radzero_torch/tools/soak_train.py`` ``build_loader``) against the JAX
``build_loader``'s batches, byte for byte, in both variants at a cut record
count and image size (the JAX module's constants patched here, the tool
untouched); the tower cache capacity probe's bisection against fake
predicates, its record size, and one ``--one`` trial at a tiny configuration.
The sanity harness, the token filter study and the soak protocol have files
of their own (``test_torch_tools_{sanity, filter, soak}.py``).
"""

import contextlib
import functools
import io
import json

import numpy as np
import pytest

from radzero_torch.tools import dedup_calibration as tdc
from radzero_torch.tools import probe_tower_cache_capacity as tcap
from radzero_torch.tools import soak_train as tsoak
from tools import dedup_calibration as jdc
from tools import soak_train as jsoak

from test_torch_tools_soak import TINY


# ---------------------------------------------------------------------------
# dedup calibration
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_windows", [24, 61])
def test_dedup_json_equals_jax_tool_bytes(monkeypatch, n_windows):
    """The JAX tool's main() over its whole grid with its window count cut to
    ``n_windows`` (its module constant and its simulate's default patched),
    against the port's main at --n_windows: the same printed bytes."""
    monkeypatch.setattr(jdc, "N_WINDOWS", n_windows)
    monkeypatch.setattr(jdc, "simulate", functools.partial(jdc.simulate, n_windows=n_windows))
    ref = io.StringIO()
    with contextlib.redirect_stdout(ref):
        jdc.main()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert tdc.main(["--n_windows", str(n_windows)]) == 0
    assert out.getvalue() == ref.getvalue()
    doc = json.loads(out.getvalue())
    assert doc["grid_size"] == 36 and doc["n_windows_per_config"] == n_windows


def test_dedup_simulate_and_vocab_equal_jax():
    """One config at another seed, and the vocabulary at each grid size."""
    for size in (10, 60, 120, 240):
        assert (tdc.build_vocab(size, np.random.default_rng(3))
                == jdc.build_vocab(size, np.random.default_rng(3)))
    kw = dict(vocab_size=120, zipf_s=1.0, p_neg=0.25, p_loc=0.5, seed=7, n_windows=30)
    assert json.dumps(tdc.simulate(**kw)) == json.dumps(jdc.simulate(**kw))
    assert tdc.calibrate(tdc.GRID[:3], n_windows=10, seed=1)["grid_size"] == 3


# ---------------------------------------------------------------------------
# the soak's loader
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("learnable", [False, True], ids=["noise", "learnable"])
def test_soak_loader_batches_equal_jax_bytes(monkeypatch, learnable):
    """Two epochs of the stability legs' loader (shuffled) and one of the eval
    split's (in order, disjoint ids): every key, dtype, shape and byte of
    every batch as the JAX build_loader gives them at 20 records of 28 px in
    batches of 4."""
    monkeypatch.setattr(jsoak, "IMG", 28)
    monkeypatch.setattr(jsoak, "BATCH", 4)
    for kw, epochs in (({"n_records": 20}, 2),
                       ({"n_records": 12, "first_id": jsoak.N_RECORDS + 1000,
                         "shuffle": False}, 1)):
        ref = jsoak.build_loader(learnable=learnable, **kw)
        got = tsoak.build_loader(learnable=learnable, img=28, batch=4, **kw)
        assert len(got) == len(ref)
        n = 0
        for _ in range(epochs):
            for a, b in zip(got, ref, strict=True):
                assert sorted(a) == sorted(b)
                for k in b:
                    assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
                    assert a[k].tobytes() == b[k].tobytes(), k
                n += 1
        assert n == epochs * len(ref)
        assert "record_indices" in a and a["input_ids"].shape[1] in (16, 32, 64)


# ---------------------------------------------------------------------------
# the tower cache's capacity probe
# ---------------------------------------------------------------------------

def test_record_bytes_are_the_port_store():
    assert tcap.RECORD_BYTES == 1370 * 768 * 2 == 2_104_320
    assert round(tcap.RECORD_BYTES / 1e6, 2) == 2.10


@pytest.mark.parametrize("limit", [64, 65, 127, 5017, 30_000, 37_999, 38_000])
def test_capacity_search_bisects_to_the_grain(limit):
    """Against a fake predicate (n fits iff n <= limit), from the floor of 64 to
    a ceiling of 38 000: the answer brackets the limit within 64 records, is the
    largest count tried that fitted and the smallest that did not, in at most
    2 + log2 of the range trials; a ceiling that fits is reported as such."""
    trials = []

    def ok(n):
        trials.append(n)
        return n <= limit

    best, first_fail = tcap.search(ok, 64, 38_000, grain=64)
    if limit >= 38_000:
        assert (best, first_fail) == (38_000, None) and trials == [38_000]
        return
    assert best <= limit < first_fail and first_fail - best <= 64
    passed = [n for n in trials if n <= limit]
    assert best == max(passed, default=64) and first_fail == min(set(trials) - set(passed))
    assert len(trials) <= 2 + int(np.ceil(np.log2((38_000 - 64) / 64)))


def test_capacity_trial_runs_at_a_tiny_config():
    """``run_one`` on the CPU at a tiny configuration: the store holds its
    records, the cached step's loss is finite."""
    rec = tcap.run_one(100, "cpu", TINY(), images=4, sentences=2, text_len=8)
    assert rec["ok"] and rec["n_records"] == 100 and np.isfinite(rec["loss"])
    cfg = TINY()
    assert rec["store_bytes"] == 100 * cfg.vision.seq_len * cfg.vision.hidden_size * 2
    assert rec["device"] == "cpu" and rec["launches"] == {}


# ---------------------------------------------------------------------------
# the pieces that chip_smoke.py's phase 14 drives the tools through
# ---------------------------------------------------------------------------

def test_counted_wrappers_are_every_counting_wrapper():
    """``ops.counted_wrappers`` (the one list that the tools' ``launch_counts`` and
    chip_smoke.py read) holds every wrapper of the kernel modules that counts its
    launches, once each, and ``launch_counts`` reads them by name."""
    from radzero_torch.ops import counted_wrappers, flash_attention, fused_layer, vlcabs_fused
    from radzero_torch.tools import launch_counts

    found = {fn for mod in (fused_layer, vlcabs_fused, flash_attention)
             for fn in vars(mod).values() if callable(fn) and hasattr(fn, "launches")}
    listed = counted_wrappers()
    assert len(set(listed)) == len(listed) == 22 and set(listed) == found
    counts = launch_counts()
    assert list(counts) == [fn.__name__ for fn in listed]
    assert counts == {fn.__name__: fn.launches for fn in listed}


def test_sanity_weights_are_drawn_on_the_cpu():
    """``sanity_train.init_params`` draws on the CPU's generator whatever the
    device, so a run on the card and one on the CPU start from the same weights:
    the tree is ``init_radzero``'s from a seeded CPU generator, bit for bit."""
    import torch

    from radzero_torch.models.radzero import init_radzero
    from radzero_torch.tools import sanity_train as tst
    from radzero_torch.utils.tree import tree_leaves

    cfg = tst.sanity_config(1)
    for seed in (0, 3):
        got = tree_leaves(tst.init_params(cfg, "cpu", seed=seed))
        want = tree_leaves(init_radzero(torch.Generator().manual_seed(seed), cfg))
        assert len(got) == len(want) and all(torch.equal(a, b) for a, b in zip(got, want))
    one, zero = (tree_leaves(tst.init_params(cfg, "cpu", seed=s)) for s in (1, 0))
    assert not all(torch.equal(a, b) for a, b in zip(one, zero))


def test_soak_leg_command_lines():
    """Each leg's command line: the tool's module, the leg's directory (control
    apart, killed and resumed sharing one), the shape and the kill step; the
    exit codes the protocol expects."""
    import os
    import sys

    cmd = tsoak.leg_command("resumed", "/o", 15, 7, n_records=320, img=518, batch=64,
                            model_config_path="cfg.json")
    assert cmd[:5] == [sys.executable, "-m", "radzero_torch.tools.soak_train", "--leg",
                       "resumed"]
    args = dict(zip(cmd[5::2], cmd[6::2]))
    assert args == {"--steps": "15", "--out": "/o/killed", "--kill-at": "7",
                    "--backing": "device", "--device": "cuda", "--records": "320",
                    "--img": "518", "--batch": "64", "--model_config": os.path.abspath("cfg.json")}
    assert [tsoak.leg_dir("/o", leg) for leg in tsoak.LEGS] == ["/o/control", "/o/killed",
                                                                 "/o/killed"]
    assert tsoak.LEG_RC == {"control": 0, "killed": 17, "resumed": 0}


@pytest.mark.parametrize("rc", [0, 1])
def test_capacity_trial_record_from_its_output(rc):
    """A ``--one`` trial's record is the JSON line of its standard output when it
    exits 0, else a failed trial."""
    assert tcap.trial_command(1024)[-2:] == ["--one", "1024"]
    out = 'warning: {not json\n{"ok": true, "n_records": 1024}\n'
    want = {"ok": True, "n_records": 1024} if rc == 0 else {"ok": False, "n_records": 1024,
                                                             "rc": rc}
    assert tcap.trial_record(out[len("warning: {not json\n"):], rc, 1024) == want
    assert tcap.trial_record("", rc, 1024)["ok"] is False


def test_chip_smoke_sanity_cpu_child(tmp_path, monkeypatch):
    """``chip_smoke.py --sanity-cpu OUT`` (the CPU's draws that phase 14 holds the
    card's against), cut to 3 steps and 2 draws: each draw's losses are the
    harness's from that draw's weights, with its accuracies and the child's wall."""
    import importlib.util
    from pathlib import Path

    import torch

    from radzero_torch.tools import sanity_train as tst

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    monkeypatch.setitem(cs.TOOLS_SANITY, "steps", 3)
    monkeypatch.setattr(cs, "SANITY_DRAWS", 2)
    threads = torch.get_num_threads()
    try:
        assert cs.sanity_cpu([str(tmp_path / "draws.json")]) == 0
    finally:
        torch.set_num_threads(threads)
    with open(tmp_path / "draws.json") as f:
        rec = json.load(f)
    assert rec["wall_s"] > 0 and len(rec["draws"]) == 2
    cfg, tok = tst.sanity_config(1), tst.tokenizer()
    for k, draw in enumerate(rec["draws"]):
        _, _, hist = tst.train(cfg, tst.init_params(cfg, "cpu", seed=k),
                               np.random.default_rng(0), tok, steps=3, batch=32, lr=3e-4,
                               device="cpu")
        np.testing.assert_allclose(draw["losses"], hist, rtol=1e-5)
        assert 0 <= draw["retrieval_accuracy"] <= 1 and 0 <= draw["pointing_accuracy"] <= 1
