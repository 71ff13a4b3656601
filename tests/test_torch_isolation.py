"""The port stands alone: importing it (and chip_smoke.py) loads neither
JAX nor openmm_tpu, its default platform is the GPU and raises without
one, and chip_smoke.py refuses to run without a GPU or without the
package beside it."""
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import openmm_tpu_torch as omm
from openmm_tpu_torch.models import tip3p_water_box

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code_or_script, cwd, *args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, *args, code_or_script], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=120)


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks its absence")


def test_import_loads_no_jax():
    code = ("import sys, openmm_tpu_torch, chip_smoke\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', "
            "'openmm_tpu'))\n"
            "assert not bad, bad\n")
    proc = _run(code, REPO, "-c")
    assert proc.returncode == 0, proc.stderr


def test_default_platform_raises_without_cuda(no_cuda):
    system, _ = tip3p_water_box(27)
    integ = omm.LangevinMiddleIntegrator(300.0, 1.0, 0.002)
    with pytest.raises(RuntimeError, match="CUDA"):
        omm.Context(system, integ)
    assert omm.Platform.getDefaultPlatform().getName() == "CUDA"


def test_chip_smoke_refuses_without_cuda(no_cuda):
    proc = _run("chip_smoke.py", REPO)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_alone_fails(tmp_path, no_cuda):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run("chip_smoke.py", tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_platforms_and_precision():
    assert omm.Platform.getPlatformByName("CPU").resolve(
        {"Precision": "double"}) == (torch.device("cpu"), "double")
    with pytest.raises(ValueError):
        omm.Platform.getPlatformByName("CPU").resolve({"Precision": "half"})
    with pytest.raises(ValueError):
        omm.Platform.getPlatformByName("Reference")
    assert np.isclose(omm.BOLTZ, 0.00831446261815324)
