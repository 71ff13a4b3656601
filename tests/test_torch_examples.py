"""examples/HelloArgon.py and examples/HelloWaterBox.py run on the port
with only the import changed (openmm_tpu -> openmm_tpu_torch): the State
returns Quantities, as the scripts expect. The test points the port's
default platform at "CPU" (the scripts build their Context without one,
and the default is the card), runs each script's main() and reads what it
prints: every frame's coordinates and every energy finite.
"""
import os
import re

import numpy as np
import pytest

import openmm_tpu_torch as omm

import torch_port_helpers  # noqa: F401  (one torch thread)

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples")


def port_text(name):
    """The example's source with the JAX package's name replaced."""
    with open(os.path.join(EXAMPLES, name)) as f:
        text = f.read()
    assert "openmm_tpu_torch" not in text
    return text.replace("openmm_tpu", "openmm_tpu_torch")


def run_example(name, monkeypatch, capsys):
    cpu = omm.Platform.getPlatformByName("CPU")
    monkeypatch.setattr(omm.Platform, "getDefaultPlatform",
                        staticmethod(lambda: cpu))
    namespace = {"__name__": "example"}
    exec(compile(port_text(name), name, "exec"), namespace)
    namespace["main"]()
    return capsys.readouterr()


def _frames(pdb_text):
    frames, current = [], []
    for line in pdb_text.splitlines():
        if line.startswith(("ATOM", "HETATM")):
            current.append([float(line[30:38]), float(line[38:46]),
                            float(line[46:54])])
        elif line.startswith("ENDMDL"):
            frames.append(np.asarray(current))
            current = []
    return frames


def test_hello_argon_runs_on_the_port(monkeypatch, capsys):
    out = run_example("HelloArgon.py", monkeypatch, capsys)
    assert "Using platform CPU" in out.err
    frames = _frames(out.out)
    # 0 to 10 ps every 40 fs (the clock's last sum may fall short of 10)
    assert len(frames) in (251, 252)
    assert all(f.shape == (3, 3) and np.isfinite(f).all() for f in frames)
    # the atoms move and stay bound by Lennard-Jones in NVE
    assert not np.array_equal(frames[0], frames[-1])
    assert np.abs(frames[-1]).max() < 100.0


def test_hello_water_box_runs_on_the_port(monkeypatch, capsys):
    out = run_example("HelloWaterBox.py", monkeypatch, capsys)
    assert "Using platform CPU" in out.err
    energies = [float(m) for m in re.findall(r"E_total=\s*(\S+) kJ/mol",
                                             out.err)]
    assert len(energies) == 20 and np.isfinite(energies).all()
    # NVE at 1 fs: the total energy holds within a few percent
    assert max(energies) - min(energies) < 0.05 * abs(energies[0])
    frames = _frames(out.out)
    assert len(frames) == 20
    assert all(f.shape == (375, 3) and np.isfinite(f).all() for f in frames)


@pytest.mark.parametrize("name", ["HelloArgon.py", "HelloWaterBox.py"])
def test_examples_import_only_the_port(name):
    text = port_text(name)
    assert "import openmm_tpu_torch as mm" in text
    assert not re.search(r"\bopenmm_tpu\b(?!_torch)", text)
