"""The PyTorch port imports neither jax nor radzero_tpu, nor pandas,
scikit-learn, safetensors or transformers.

The machine with the card has no JAX, so every module of radzero_torch
must import without it. Checked in a fresh interpreter: this pytest
process already has jax loaded by tests/conftest.py. Only the host image
modules (and the scorer and API built on them) may load PIL.
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# one fresh interpreter per group (a cold torch import takes seconds)
GROUPS = {
    "package": ["radzero_torch"],
    "models": ["radzero_torch.models." + m for m in
               ("configuration", "from_jax", "vit", "align", "mpnet", "radzero", "convert")],
    "ops": ["radzero_torch.ops." + m for m in
            ("_build", "_checks", "layers", "resize", "fused_layer", "flash_attention", "vlcabs",
             "vlcabs_fused", "ablate_sm90", "registry")],
    "serving": ["radzero_torch.losses.radzero_loss", "radzero_torch.eval.geometry",
                "radzero_torch.eval.serving", "radzero_torch.data.tokenizer",
                "radzero_torch.eval.export", "radzero_torch.eval.server",
                "radzero_torch.ops.registry", "radzero_torch.utils.logging",
                "radzero_torch.utils.json_io"],
    "training": ["radzero_torch.train", "radzero_torch.train.optim", "radzero_torch.train.step",
                 "radzero_torch.losses.mpnce", "radzero_torch.losses.clip"],
    "runtime": ["radzero_torch.data." + m for m in ("mimic", "shards", "pipeline")]
    + ["radzero_torch.train." + m for m in ("checkpoint", "trainer", "tower_cache")]
    + ["radzero_torch.utils.profiling"],
    "scoring": ["radzero_torch.data.processing", "radzero_torch.data.native",
                "radzero_torch.data.dicom",
                "radzero_torch.data.dicom_parse", "radzero_torch.eval.scorer",
                "radzero_torch.eval.api"],
    "eval": ["radzero_torch.eval." + m for m in
             ("registry", "metrics", "_table", "mergers", "geometry", "classification",
              "grounding", "segmentation", "inference")]
    + ["radzero_torch.tools", "radzero_torch.tools.synthetic_eval_data"],
    "checkpoint": ["radzero_torch.utils.safetensors_io", "radzero_torch.tools.convert_checkpoint",
                   "radzero_torch.tools.run_real_checkpoint", "radzero_torch.data.tokenizer"],
    "smoke": ["chip_smoke"],
    "config": ["radzero_torch.config", "radzero_torch.config.config",
               "radzero_torch.utils.experiment", "radzero_torch.train.lora"],
    "cli": ["radzero_torch.cli", "radzero_torch.cli.run"],
}
PIL_ALLOWED = {"scoring", "eval", "cli"}


def _forbidden(group):
    """The card's host may lack pandas and scikit-learn, and lacks safetensors
    and transformers: no module of the port imports them (the eval harness
    computes its metrics in numpy, the converter reads safetensors itself,
    and HFTokenizer imports transformers only when built). Nor does any
    import the JAX runbook and converter under tools/."""
    names = ("jax", "jaxlib", "radzero_tpu", "triton", "pandas", "sklearn", "safetensors",
             "transformers", "tools")
    return names if group in PIL_ALLOWED else names + ("PIL",)


@pytest.mark.parametrize("group", sorted(GROUPS))
def test_port_imports_without_jax(group):
    code = (
        "import importlib, sys\n"
        f"for m in {GROUPS[group]!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{_forbidden(group)!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
