"""Each cell end to end on an NVIDIA card, as the benchmark's command runs
it, with a short window: exit code 0, correct, the cell's end-to-end
metrics. Skips without a card."""
import json
import subprocess
import sys

import pytest

import harness


@pytest.mark.card
@pytest.mark.parametrize("name", [w["name"] for w in
                                  harness.benchmark()["workloads"]])
def test_cell_on_card(name):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    proc = subprocess.run(
        [sys.executable, str(harness.HERE / "run.py"), "--workload", name,
         "--seed", "4294967311", "--seconds", "3", "--trace", "0"],
        capture_output=True, text=True, cwd=harness.ROOT, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, proc.stderr[-4000:]
    want = {m["name"] for m in harness.benchmark()["end_to_end"]
            if name in m.get("workloads", [name])}
    assert set(line["metrics"]) == want
