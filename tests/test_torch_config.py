"""The port's config loader (``radzero_torch/config``) on the cases of
tests/test_config.py, and its YAML files against the JAX package's: the
same dict from both loaders, but for the keys ``configs/paths.yaml``
documents as the port's own."""

import os

import pytest

from radzero_tpu.config import load_config as jax_load_config
from radzero_torch.config import load_config, update_nested_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "radzero_torch", "config")
JAX_PKG = os.path.join(REPO, "radzero_tpu", "config")
# the values the port's YAML files set otherwise, as configs/paths.yaml says
PORT_OWN = {("experiment", "output_root_dir"): "/tmp/radzero_torch_runs"}


def test_update_nested_dict_leaf_override():
    a = {"x": {"y": 1, "z": 2}, "k": 3}
    update_nested_dict(a, {"x": {"y": 10}, "new": 4})
    assert a == {"x": {"y": 10, "z": 2}, "k": 3, "new": 4}


def test_update_nested_dict_dict_replaces_scalar():
    a = {"x": 1}
    update_nested_dict(a, {"x": {"y": 2}})
    assert a == {"x": {"y": 2}}


def test_load_defaults_with_radzero_overlay():
    cfg = load_config(os.path.join(PKG, "defaults.yaml"), ["radzero", "paths"])
    assert cfg["train"]["per_device_train_batch_size"] == 64
    assert cfg["train"]["num_train_epochs"] == 20
    assert cfg["train"]["gradient_checkpointing"] is True
    assert cfg["train"]["weight_decay"] == 0.05
    assert cfg["train"]["warmup_steps"] == 50
    mc = cfg["model"]["model_config"]
    assert mc["vision_config"]["img_size"] == 518
    assert mc["loss"]["RadZeroLoss"]["sim_op"] == "cos"
    assert mc["align_transformer_config"]["num_hidden_layers"] == 2
    assert cfg["dataset"]["data_root"] == "/data"


def test_ordered_overlays_later_wins(tmp_path):
    base = tmp_path / "base.yaml"
    base.write_text("a: {b: 1, c: 2}\n")
    cfgdir = tmp_path / "configs"
    cfgdir.mkdir()
    (cfgdir / "one.yaml").write_text("a: {b: 5}\n")
    (cfgdir / "two.yaml").write_text("a: {b: 9, d: 7}\n")
    cfg = load_config(str(base), ["one", "two"])
    assert cfg["a"] == {"b": 9, "c": 2, "d": 7}
    # an overlay given by its own path, with or without ".yaml"
    (tmp_path / "three.yaml").write_text("a: {c: 4}\n")
    assert load_config(str(base), [str(tmp_path / "three")])["a"] == {"b": 1, "c": 4}


@pytest.mark.parametrize("overlays", [[], ["radzero"], ["paths"], ["radzero", "paths"]])
def test_yaml_files_load_to_the_jax_dict(overlays):
    got = load_config(os.path.join(PKG, "defaults.yaml"), overlays)
    want = jax_load_config(os.path.join(JAX_PKG, "defaults.yaml"), overlays)
    for (section, key), value in PORT_OWN.items():
        if key in want.get(section, {}) and "paths" in overlays:
            assert got[section][key] == value
            want[section][key] = value
    assert got == want
