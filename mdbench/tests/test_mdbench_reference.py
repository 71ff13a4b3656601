"""The plain reference (reference/classical.py) against the port's CPU
float64 path on a 216-water box and on a cropped bilayer, and the
comparison failing on a perturbed state and on the TF32 control."""
import math

import numpy as np
import pytest
import torch

import openmm_tpu_torch as omm
from openmm_tpu_torch import unit as u

import check
import harness
import program
from reference import classical

# float64 against float64: the two sum in other orders
DOUBLE_BAR = 1e-9


def _water():
    config = harness.load("configs", "water_pme")
    return harness.load_module(config["inputs"]).build(
        dict(config, n_waters=216), 2 ** 31 + 12345)


def _bilayer():
    config = harness.load("configs", "popc_membrane")
    return harness.load_module(config["inputs"]).build(
        dict(config, crop=[5, 200]), 0)


def _port(tables, positions, precision):
    system, _ = program.build_system(tables, None)
    ctx = omm.Context(system, omm.LangevinMiddleIntegrator(300, 1, 0.002),
                      omm.Platform.getPlatformByName("CPU"),
                      {"Precision": precision})
    ctx.setPositions(positions)
    st = ctx.getState(getEnergy=True, getForces=True)
    return (u.plain(st.getPotentialEnergy()),
            np.asarray(u.plain(st.getForces(asNumpy=True)), float))


def _errors(e, f, e_ref, f_ref):
    rel = np.linalg.norm(f - f_ref, axis=1) / np.linalg.norm(f_ref, axis=1)
    return abs(e - e_ref) / abs(e_ref), float(np.median(rel))


@pytest.fixture(scope="module", params=["water", "bilayer"])
def system(request):
    tables = _water() if request.param == "water" else _bilayer()
    ref = classical.ClassicalForceField(tables, "cpu")
    e_ref, f_ref = ref.energy_forces(tables["positions"], tables["box"])
    return request.param, tables, e_ref, f_ref


def test_reference_matches_port_double(system):
    name, tables, e_ref, f_ref = system
    e, f = _port(tables, tables["positions"], "double")
    e_err, f_err = _errors(e, f, e_ref, f_ref)
    assert e_err < DOUBLE_BAR and f_err < DOUBLE_BAR, (name, e_err, f_err)
    assert np.max(np.abs(f - f_ref)) < 1e-6 * np.max(np.abs(f_ref))


def test_port_mixed_within_limits(system):
    name, tables, e_ref, f_ref = system
    limits = harness.load("configs", "water_pme" if name == "water"
                          else "popc_membrane")["limits"]
    e, f = _port(tables, tables["positions"], "mixed")
    e_err, f_err = _errors(e, f, e_ref, f_ref)
    assert e_err < limits["energy_err"] and f_err < limits["force_err"]


def test_perturbed_state_fails(system):
    """The port's energy and forces of a state with one molecule moved by
    0.01 nm, judged against the reference of the unmoved state."""
    name, tables, e_ref, f_ref = system
    limits = harness.load("configs", "water_pme" if name == "water"
                          else "popc_membrane")["limits"]
    moved = tables["positions"].copy()
    moved[:3] += 0.01
    e, f = _port(tables, moved, "double")
    e_err, _ = _errors(e, f, e_ref, f_ref)
    rel = np.linalg.norm(f - f_ref, axis=1) / np.linalg.norm(f_ref, axis=1)
    assert e_err > limits["energy_err"] or np.max(rel) > 1e-3


def test_control_fails_force_and_energy(system):
    name, tables, e_ref, f_ref = system
    limits = harness.load("configs", "water_pme" if name == "water"
                          else "popc_membrane")["limits"]
    ctl = classical.ClassicalForceField(tables, "cpu", "tf32")
    e, f = ctl.energy_forces(tables["positions"], tables["box"])
    e_err, f_err = _errors(e, f, e_ref, f_ref)
    assert e_err > limits["energy_err"] and f_err > limits["force_err"]


def _cell_config(name):
    return harness.load("configs", "water_pme" if name == "water"
                        else "popc_membrane")


def _constrained(tables):
    """The tables' positions with the constraints made to hold, and the
    rectangular box's widths, as float64 tensors."""
    cons = classical.Constraints(tables, "cpu")
    x = torch.as_tensor(tables["positions"], dtype=torch.float64)
    widths = torch.as_tensor(np.diag(tables["box"]).copy(),
                             dtype=torch.float64)
    return cons, cons.solve_positions(x, x, widths), widths


def test_projection_removes_the_constraint_directions(system):
    """P is a projector in the metric of M that removes M^-1 G^T l and
    leaves velocities with G v = 0."""
    name, tables, _, _ = system
    cons, x, widths = _constrained(tables)
    gen = torch.Generator().manual_seed(5)
    w = torch.randn(x.shape, generator=gen, dtype=torch.float64)
    pw = cons.project(x, w, widths)
    assert torch.allclose(cons.project(x, pw, widths), pw, atol=1e-12)
    g = cons._jacobian(cons._bonds(cons._gather(x), widths))
    lam = torch.randn(cons.d2.shape, generator=gen, dtype=torch.float64)
    along = cons._scatter(torch.zeros_like(x), cons.inv_m[..., None]
                          * torch.einsum("ckad,ck->cad", g, lam))
    assert float(cons.project(x, along, widths).abs().max()) < 1e-12
    gv = torch.einsum("ckad,cad->ck", g, cons._gather(pw))
    assert float(gv.abs().max()) < 1e-12


def test_reference_step_reads_its_own_forces(system):
    """The reference's LangevinMiddle step, read back by
    check.step_numbers, gives back the forces it kicked with and normals
    of mean square 1, and leaves the constraints holding."""
    name, tables, e_ref, f_ref = system
    config = _cell_config(name)
    cons, x, widths = _constrained(tables)
    f = torch.as_tensor(classical.ClassicalForceField(tables, "cpu")
                        .energy_forces(x.numpy(), tables["box"])[1])
    gen = torch.Generator().manual_seed(7)
    v = 0.3 * torch.randn(x.shape, generator=gen, dtype=torch.float64)
    xi = torch.randn(x.shape, generator=gen, dtype=torch.float64)
    x1, v1 = classical.langevin_middle_step(
        tables, x, v, widths, f, config["step_fs"] * 1e-3,
        config["friction_per_ps"], config["temperature_K"], xi, True)
    step = {"x0": x.numpy(), "v0": v.numpy(), "x1": x1.numpy(),
            "v1": v1.numpy(), "widths": widths.numpy(), "step": 0}
    got = check.step_numbers(tables, config, step, f.numpy(), classical)
    assert got["step_force_err"] < 1e-10, got
    n = xi.numel()
    want = abs(float((xi * xi).mean()) - 1.0)
    assert got["noise_dev"] == pytest.approx(want, abs=1e-6 / n ** 0.5)
    assert classical.constraint_error(tables, x1.numpy(),
                                      tables["box"]) < 1e-10


def test_port_double_step_reads_the_reference_forces(system):
    """One LangevinMiddle step of the port's CPU float64 path, read back by
    check.step_numbers against the reference's forces: the port's
    constraint corrections lie along the bonds before the move, as the
    check assumes, and its kick is the reference's forces at dt."""
    name, tables, _, _ = system
    config = _cell_config(name)
    system_, _ = program.build_system(tables, None)
    integ = omm.LangevinMiddleIntegrator(config["temperature_K"],
                                         config["friction_per_ps"],
                                         config["step_fs"] * 1e-3)
    ctx = omm.Context(system_, integ, omm.Platform.getPlatformByName("CPU"),
                      {"Precision": "double"})
    ctx.setPositions(tables["positions"])
    ctx.applyConstraints()
    ctx.setVelocitiesToTemperature(config["temperature_K"], 11)

    def read():
        st = ctx.getState(getPositions=True, getVelocities=True)
        return (np.asarray(u.plain(st.getPositions(asNumpy=True)), float),
                np.asarray(u.plain(st.getVelocities(asNumpy=True)), float))

    x0, v0 = read()
    integ.step(1)
    x1, v1 = read()
    f_ref = classical.ClassicalForceField(tables, "cpu").energy_forces(
        x0, tables["box"])[1]
    step = {"x0": x0, "v0": v0, "x1": x1, "v1": v1,
            "widths": np.diag(tables["box"]), "step": 0}
    got = check.step_numbers(tables, config, step, f_ref, classical)
    assert got["step_force_err"] < 1e-8, got
    assert got["noise_dev"] < 10 * (2.0 / x0.size) ** 0.5, got
    # the step taken at another dt reads far off
    step_dt = dict(config, step_fs=config["step_fs"] * 1.25)
    assert check.step_numbers(tables, step_dt, step, f_ref, classical)[
        "step_force_err"] > 1e-2


def test_bspline_weights_partition_unity():
    frac = torch.rand(1000, dtype=torch.float64)
    w = classical.bspline_weights(frac)
    assert torch.allclose(w.sum(-1), torch.ones(1000, dtype=torch.float64))
    # M_5 at the integers 1..4: 1/24, 11/24, 11/24, 1/24
    ints = classical.bspline_weights(torch.zeros((), dtype=torch.float64))
    assert np.allclose(ints.numpy(), [0, 1 / 24, 11 / 24, 11 / 24, 1 / 24])


def test_dispersion_coefficient_against_pair_sum():
    """The class sums against a sum over every pair i <= j."""
    rng = np.random.default_rng(3)
    sigma = rng.choice([0.3, 0.32, 0.25], 40)
    eps = rng.choice([0.5, 0.2, 0.0], 40)
    n, rc = 40, 0.9
    s1 = s2 = 0.0
    for i in range(n):
        for j in range(i, n):
            sig6 = (0.5 * (sigma[i] + sigma[j])) ** 6
            e = math.sqrt(eps[i] * eps[j])
            s1 += e * sig6 * sig6
            s2 += e * sig6
    pairs = n * (n + 1) / 2
    want = 8 * n * n * math.pi * (s1 / pairs / (9 * rc ** 9)
                                  - s2 / pairs / (3 * rc ** 3))
    got = classical.dispersion_coefficient(sigma, eps, rc)
    assert got == pytest.approx(want, rel=1e-12)


def test_constraint_and_kinetic_readings():
    tables = _water()
    assert classical.constraint_error(tables, tables["positions"],
                                      tables["box"]) < 1e-12
    v = np.ones((len(tables["masses"]), 3))
    assert classical.kinetic_energy(tables, v) == pytest.approx(
        1.5 * np.sum(tables["masses"]))


def test_dcd_and_state_data_read_back(tmp_path):
    """check.read_dcd and read_state_data on files the port's reporters
    wrote."""
    from openmm_tpu_torch import app
    tables = _water()
    system, top = program.build_system(tables, None)
    sim = app.Simulation(top, system, omm.LangevinMiddleIntegrator(
        300, 1, 0.002), omm.Platform.getPlatformByName("CPU"))
    sim.context.setPositions(tables["positions"])
    with open(tmp_path / "s.csv", "w") as f:
        sim.reporters.append(app.StateDataReporter(
            f, 2, step=True, potentialEnergy=True, kineticEnergy=True,
            temperature=True, volume=True))
        sim.reporters.append(app.DCDReporter(str(tmp_path / "f.dcd"), 2))
        sim.step(4)
    del sim
    rows = check.read_state_data(tmp_path / "s.csv")
    frames, boxes = check.read_dcd(tmp_path / "f.dcd")
    assert [int(r["Step"]) for r in rows] == [2, 4]
    assert frames.shape == (2, len(tables["masses"]), 3)
    assert np.allclose(boxes, np.diag(tables["box"]), rtol=1e-12)
