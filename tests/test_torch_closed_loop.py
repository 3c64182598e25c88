"""The port's closed loop (``karanta_tpu_torch/bench/closed_loop.py``: train,
native checkpoint, server subprocess, pipeline, CER) run end to end on the
CPU, cut to 2 pages and 5 training steps: the plumbing only. The CER
acceptance of tests/test_closed_loop.py (8 pages, 500 steps, mean CER <=
0.15, at least 6 exact matches) is checked on the card by chip_smoke.py's
phase 17, where 500 steps take seconds.
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_closed_loop_plumbing_on_cpu(tmp_path):
    env = {**os.environ, "OMP_NUM_THREADS": "2",
           "PYTHONPATH": os.pathsep.join(
               [REPO] + os.environ.get("PYTHONPATH", "").split(os.pathsep))}
    proc = subprocess.run(
        [sys.executable, "-m", "karanta_tpu_torch.bench.closed_loop",
         "--root", str(tmp_path), "--device", "cpu",
         "--train-pages", "2", "--chars", "1",
         "--eval-pages", "2", "--eval-from-train",
         "--steps", "5", "--lr", "0.001"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert proc.returncode == 0, (proc.stdout[-2000:], proc.stderr[-2000:])
    assert "trained 5 steps" in proc.stdout
    summary = json.loads((tmp_path / "scores.json").read_text())
    assert summary["pages"] == 2
    assert set(summary) >= {"exact_match", "mean_cer", "mean_wer"}
    report = (tmp_path / "report.md").read_text()
    assert "exact match" in report
    rows = [line for line in report.splitlines() if line.startswith("| ")]
    assert len(rows) == 1 + 2  # the header and one row a page
    assert os.path.exists(tmp_path / "train" / "step_5" / "COMPLETED")
