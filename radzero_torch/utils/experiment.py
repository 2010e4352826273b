"""Experiment management: output directories and run snapshots (the port's
copy of radzero_tpu/utils/experiment.py).

Rebuilds common/utils.py:133-156 (output dir = root/project/user/name,
wandb env setup with debug suppression) and common/code_snapshot.py:9-37
(per-run snapshot of git diff, last commit metadata, and the fully
resolved config) without GitPython — plain ``git`` subprocess calls.
"""

from __future__ import annotations

import json
import os
import subprocess
from typing import Any, Dict

import yaml

from radzero_torch.utils.logging import set_logger_file


def output_directory_setting(cfg: Dict[str, Any], logger) -> str:
    """Compose the run output dir and wire logging/wandb env (ref common/utils.py:133-156)."""
    exp = cfg["experiment"]
    output_dir = os.path.join(
        exp["output_root_dir"], exp.get("project", "pt"), exp["user"], exp["name"]
    )
    cfg.setdefault("train", {})["output_dir"] = output_dir
    set_logger_file(os.path.join(output_dir, "output.log"), logger)
    logger.info(f"experiment output directory : {output_dir}")

    no_report = bool(cfg.get("args", {}).get("no_report"))
    if no_report or exp["user"] == "debug":
        logger.info("skip report to wandb")
        exp["report_to"] = "none"
    elif exp.get("report_to") == "wandb":
        os.environ["WANDB_PROJECT"] = exp.get("project", "pt")
        os.environ["WANDB_DIR"] = output_dir
    return output_dir


def _git(repo_dir: str, *args: str) -> str:
    try:
        return subprocess.run(
            ["git", "-C", repo_dir, *args],
            capture_output=True,
            text=True,
            timeout=30,
        ).stdout
    except Exception:
        return ""


def code_snapshot(cfg: Dict[str, Any], output_dir: str, repo_dir: str = ".") -> None:
    """Save git diff + last-commit JSON + resolved config (ref common/code_snapshot.py:9-37)."""
    snap_dir = os.path.join(output_dir, "snapshot")
    os.makedirs(snap_dir, exist_ok=True)

    diff = _git(repo_dir, "diff", "HEAD")
    with open(os.path.join(snap_dir, "git_diff.patch"), "w") as f:
        f.write(diff)

    log = _git(repo_dir, "log", "-1", "--pretty=format:%H%n%an%n%ad%n%s")
    lines = log.splitlines()
    commit = {
        "hash": lines[0] if len(lines) > 0 else "",
        "author": lines[1] if len(lines) > 1 else "",
        "date": lines[2] if len(lines) > 2 else "",
        "message": lines[3] if len(lines) > 3 else "",
    }
    with open(os.path.join(snap_dir, "last_commit.json"), "w") as f:
        json.dump(commit, f, indent=2)

    clean_cfg = {k: v for k, v in cfg.items() if k != "args"}
    with open(os.path.join(snap_dir, "config.yaml"), "w") as f:
        yaml.safe_dump(clean_cfg, f, sort_keys=False)
