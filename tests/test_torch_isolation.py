"""The port stands alone: importing any of its modules (and chip_smoke.py
and kernel_lab.py) loads neither JAX nor openmm_tpu, its default platform is the GPU and
raises without one, and chip_smoke.py refuses to run without a GPU or
without the package beside it."""
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import openmm_tpu_torch as omm
from openmm_tpu_torch.models import tip3p_water_box

# one intra-op thread, as tests/torch_port_helpers.py sets: the runner's
# worker processes would otherwise oversubscribe the cores
torch.set_num_threads(1)

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
    """Every module of the package, whether __init__ imports it or not,
    and chip_smoke.py, kernel_lab.py, nh_startup.py and nve_drift.py."""
    code = ("import importlib, pkgutil, sys\n"
            "import openmm_tpu_torch, chip_smoke, kernel_lab, nh_startup, "
            "nve_drift\n"
            "names = [m.name for m in pkgutil.walk_packages(\n"
            "    openmm_tpu_torch.__path__, 'openmm_tpu_torch.')]\n"
            "for name in names:\n"
            "    importlib.import_module(name)\n"
            "assert {'openmm_tpu_torch.profile_step',\n"
            "        'openmm_tpu_torch.ops.pallas_pme'} <= set(names), names\n"
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


def test_app_reads_only_its_own_data():
    """ForceField, Topology.createStandardBonds, the patch loader and
    PDBFile open files under openmm_tpu_torch/app/data/ only, never under
    the JAX package's openmm_tpu/; a file the port does not ship raises
    though the JAX package has it."""
    code = ("import os, sys\n"
            "opened = []\n"
            "sys.addaudithook(lambda event, args: opened.append(str(args[0]))"
            " if event == 'open' and isinstance(args[0], str) else None)\n"
            "import io\n"
            "from openmm_tpu_torch import app\n"
            "from openmm_tpu_torch.app.modeller import "
            "_load_membrane_patch\n"
            "ff = app.ForceField('amber14-all.json', 'amber14-tip3p.json')\n"
            "top, pos, box = _load_membrane_patch('POPC')\n"
            "bare = app.Topology()\n"
            "res = bare.addResidue('HOH', bare.addChain())\n"
            "for name, el in (('O', 'O'), ('H1', 'H'), ('H2', 'H')):\n"
            "    bare.addAtom(name, app.Element.getBySymbol(el), res)\n"
            "bare.createStandardBonds()\n"
            "assert len(list(bare.bonds())) == 2\n"
            "try:\n"
            "    app.ForceField('amoeba2013.json')\n"
            "    raise SystemExit('amoeba2013.json was found')\n"
            "except Exception as e:\n"
            "    assert 'not found' in str(e), e\n"
            "jax_dir = os.path.join(os.getcwd(), 'openmm_tpu') + os.sep\n"
            "data_dir = os.path.join(os.getcwd(), 'openmm_tpu_torch', 'app',"
            " 'data') + os.sep\n"
            "bad = [p for p in opened if os.path.abspath(p).startswith("
            "jax_dir)]\n"
            "assert not bad, bad\n"
            "ours = {os.path.basename(p) for p in opened\n"
            "        if os.path.abspath(p).startswith(data_dir)}\n"
            "assert {'amber14-all.json', 'amber14-tip3p.json', 'POPC.npz',\n"
            "        'residue_bonds.json', 'residues.xml'} <= ours, ours\n")
    proc = _run(code, REPO, "-c")
    assert proc.returncode == 0, proc.stderr
