"""The control (the reference at TF32 put in the program's place) comes
out as not correct, through the whole run at a test size on the CPU; on
the card the same comparison at the cells' own sizes is
`python3 mdbench/control.py --workload <name> --seeds ...`."""
import pytest
import torch

import check
import harness
from test_mdbench_faults import SECONDS, SIZES


@pytest.mark.parametrize("name", sorted(SIZES))
def test_control_is_not_correct(name):
    w = harness.workload(name)
    extra_config, extra_traffic = SIZES[name]
    config = dict(harness.load("configs", w["config"]), **extra_config)
    traffic = dict(harness.load("traffic", w["traffic"]), **extra_traffic)
    result = harness.execute(name, 31337, SECONDS, False,
                             torch.device("cpu"), config=config,
                             traffic=traffic, control=True,
                             log=lambda text: None)
    verdict = check.judge(result["control"], config["limits"])
    failed = {k for k, (_, _, ok) in verdict.items() if not ok}
    assert {"energy_err", "force_err", "constraint_err", "kinetic_err",
            "step_force_err"} <= failed, verdict
