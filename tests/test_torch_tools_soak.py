"""The soak's protocol (``radzero_torch/tools/soak_train.py``) at a tiny
configuration on the CPU: the control, killed (``os._exit(17)`` mid-epoch) and
resumed legs, each a process of its own through the tool's command line, and
``assemble``'s gates (the resumed trajectory within rtol 1e-5 of the
control's, the loss falling); then the model-selection leg's assertions
through ``--selection``, also in a process of its own. The shapes: D = 64, two
layers a tower, 28 px images (5 tokens), batches of 4 images; the recipe is the
tool's (bf16, remat, the device-backed tower cache, save_total_limit 3)."""

import json
import os
import subprocess
import sys

import pytest

from radzero_torch.tools import soak_train as tsoak

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_BLOCK = {
    "vision_config": {"hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 1,
                      "mlp_ratio": 2.0, "patch_size": 14, "pretrain_img_size": 28,
                      "img_size": 28},
    "text_config": {"hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 1,
                    "intermediate_size": 128},
    "align_transformer_config": {"hidden_size": 64, "num_hidden_layers": 2,
                                 "num_attention_heads": 1, "mlp_ratio": 2.0},
    "loss": {"RadZeroLoss": {"hidden_dim": 64}},
}


def TINY():
    """The tiny configuration as a RadZeroConfig."""
    from radzero_torch.models.configuration import radzero_config_from_dict

    return radzero_config_from_dict(json.loads(json.dumps(TINY_BLOCK)))


@pytest.fixture(scope="module")
def tiny_json(tmp_path_factory):
    path = tmp_path_factory.mktemp("cfg") / "tiny.json"
    path.write_text(json.dumps(TINY_BLOCK))
    return str(path)


def test_kill_resume_protocol_matches_control(tmp_path, tiny_json):
    """16 records in batches of 4 (4 steps an epoch), 10 steps asked (3 epochs,
    12 steps), the kill at step 5: the killed leg exits 17 after the epoch-1
    checkpoint, the resumed leg restarts from checkpoint-4, and every shared
    step's loss matches the control's within the tool's rtol 1e-5, and a resumed
    loss moved by 1e-4 of itself fails that gate; the legs' own records hold
    their walls and launches (none on the CPU)."""
    out = str(tmp_path / "soak")
    result = tsoak.protocol(out, 10, 5, device="cpu", n_records=16, img=28, batch=4,
                            model_config_path=tiny_json, timeout=300)
    assert result["steps"] == 12 and result["kill_at_step"] == 5
    assert result["resume_max_rel_loss_delta"] < 1e-5
    assert result["loss_last10_mean"] < result["loss_first10_mean"]
    assert set(result["legs"]) == {"control", "killed", "resumed"}
    assert result["legs"]["resumed"]["first_step"] == 5  # checkpoint-4 restored
    killed = tsoak.read_log(os.path.join(out, "killed"))
    assert max(killed) == 12 and min(killed) == 1
    with open(os.path.join(out, "soak_result.json")) as f:
        assert json.load(f) == json.loads(json.dumps(result))
    for leg in ("control", "killed"):
        with open(os.path.join(out, leg, f"leg_{leg}.json")) as f:
            assert not any(json.load(f)["launches"].values())
    assert sorted(os.listdir(os.path.join(out, "control"))) == [
        "checkpoint-12", "checkpoint-4", "checkpoint-8", "leg_control.json",
        "log_history.jsonl"]
    # a resumed trajectory 1e-4 off the control's at one step past the kill fails the gate
    log = os.path.join(out, "killed", "log_history.jsonl")
    with open(log) as f:
        recs = [json.loads(line) for line in f]
    recs = [dict(r, loss=r["loss"] * (1 + 1e-4)) if r.get("step") == 9 and "loss" in r else r
            for r in recs]
    with open(log, "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in recs)
    with pytest.raises(AssertionError, match="diverged"):
        tsoak.resume_delta(out, 5)


def test_selection_leg_assertions_hold(tmp_path, tiny_json):
    """``--selection`` over 16 learnable records (batches of 4) and 8 held-out
    ones, a budget of 6 epochs, patience 2, limit 3: the tool's assertions hold
    (its process exits 0) and its record says what they checked."""
    out = tmp_path / "sel"
    cmd = [sys.executable, "-m", "radzero_torch.tools.soak_train", "--selection",
           "--device", "cpu", "--epochs", "6", "--patience", "2", "--n_train", "16",
           "--n_eval", "8", "--batch", "4", "--img", "28", "--model_config", tiny_json,
           "--out", str(out)]
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    with open(out / "selection" / "selection_result.json") as f:
        rec = json.load(f)
    assert rec["epochs_run"] == 6 or rec["early_stopped"]
    assert len(rec["checkpoints_kept"]) == 3 and rec["best_checkpoint"] in rec["checkpoints_kept"]
    assert rec["best_metric"] == pytest.approx(min(rec["eval_loss_curve"]), abs=1e-4)
    assert rec["best_params_restored_bit_identical"] and rec["device"] == "cpu"
    assert rec["steps"] == 4 * rec["epochs_run"]
