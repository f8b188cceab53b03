"""Pin scripts/train_arena_gate.py's checkpoint/--resume surface on CPU.

The resume path is the recovery workflow for long runs (the board-16
1600-iteration curve and the board-24 run depend on it).  These tests run the
REAL script as a subprocess at tiny budgets and pin:

  * a fresh run writes latest + best checkpoints and best_meta.json;
  * --resume continues from the checkpointed iteration and RESTORES the
    best-gate record (score + iteration) instead of resetting it;
  * a pre-meta checkpoint dir (best/ without best_meta.json — the layout
    older runs wrote) re-gates the restored best rather than silently
    resetting best_score to -1, so a weaker later gate cannot overwrite
    the true best (ADVICE round-4 finding).
"""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "scripts", "train_arena_gate.py")

ARGS = [
    "--cpu", "--board_size=5", "--batch=16", "--chunk_steps=6",
    "--simulations=4", "--channels=8", "--blocks=1", "--temp_moves=4",
    "--arena_batch=8", "--arena_sims=4", "--seed=3",
]


def run_gate(tmp_path, extra, log_name):
    log = str(tmp_path / log_name)
    proc = subprocess.run(
        [sys.executable, SCRIPT, *ARGS,
         f"--checkpoint_dir={tmp_path / 'ckpt'}", f"--log={log}", *extra],
        capture_output=True, text=True, timeout=900,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(log) as f:
        return [json.loads(line) for line in f]


def test_resume_restores_best_record(tmp_path):
    recs = run_gate(tmp_path, ["--iterations=2", "--gates=1,2"], "a.jsonl")
    kinds = [r["kind"] for r in recs]
    assert "gate_vs_init" in kinds and "gate_vs_random" in kinds
    meta_path = tmp_path / "ckpt" / "best_meta.json"
    with open(meta_path) as f:
        meta = json.load(f)
    assert meta["iteration"] in (1, 2)

    # resume: continues past iteration 2 and restores the best record
    recs2 = run_gate(
        tmp_path, ["--iterations=4", "--gates=3,4", "--resume"], "b.jsonl"
    )
    resume = next(r for r in recs2 if r["kind"] == "resume")
    assert resume["from_iteration"] == 2
    assert resume["best_iteration"] == meta["iteration"]
    assert resume["best_score"] == pytest.approx(meta["a_score"])
    its = [r["iteration"] for r in recs2 if r["kind"] == "train"]
    assert its and min(its) == 3  # continuation, not a restart
    gate_its = [r["iteration"] for r in recs2 if r["kind"] == "gate_vs_init"]
    assert gate_its == [3, 4]


def test_resume_pre_meta_checkpoint_regates_best(tmp_path):
    run_gate(tmp_path, ["--iterations=2", "--gates=1,2"], "a.jsonl")
    os.remove(tmp_path / "ckpt" / "best_meta.json")  # pre-meta layout

    recs2 = run_gate(
        tmp_path, ["--iterations=3", "--gates=3", "--resume"], "b.jsonl"
    )
    warn = [r for r in recs2 if r["kind"] == "warn"]
    assert warn and "re-gating" in warn[0]["msg"]
    resume = next(r for r in recs2 if r["kind"] == "resume")
    # the restored best was RE-MEASURED, not reset to -1
    assert resume["best_score"] >= 0.0
    # and best_meta.json is re-established by the end of the run
    assert os.path.exists(tmp_path / "ckpt" / "best_meta.json")


def test_gumbel_rejects_dirichlet_flags(tmp_path):
    """--dirichlet_alpha/frac do nothing under --search=gumbel (Gumbel has
    no Dirichlet root noise) — the script must FAIL FAST rather than let a
    long chip run burn with the flag silently ignored."""
    proc = subprocess.run(
        [sys.executable, SCRIPT, *ARGS, "--iterations=1", "--gates=1",
         "--search=gumbel", "--dirichlet_alpha=0.02",
         f"--log={tmp_path / 'g.jsonl'}"],
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 2, (proc.returncode, proc.stderr[-500:])
    assert "no effect with" in proc.stderr
