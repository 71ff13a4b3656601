"""A run driven past the look for a card, on the CPU at a test size, with
the timed path broken underneath: `correct` comes out false, by the number
that the fault should trip, once for each fault a cell can have (a step
that returns its state unchanged; half of the atoms' forces left out of
the step's own force evaluation; a step size other than the
configuration's; an answer altered where it is produced; a one-chip cell
has no exchange between chips). The faults in the step leave the readings
between steps (getState) as they were, so only the step's own numbers
can see them. Without a fault those numbers are within their limits."""
import numpy as np
import pytest
import torch

import harness

SECONDS = 1.5
SIZES = {
    "water_pme.dhfr_size-r100": ({"relax": [[0.5, 50.0, 100],
                                            [2.0, 5.0, 60]]},
                                 {"overrides": {"n_waters": 216},
                                  "report_interval": 10}),
    "popc_membrane.npt-r50": ({"relax": [[1.0, 10.0, 20]],
                               "minimize_iterations": 2},
                              {"overrides": {"crop": [4, 300]},
                               "report_interval": 10}),
}


def state_unchanged(run):
    run.integrator.step = lambda steps: None


def _in_every_program(run, patch):
    """patch(program) on each step program the Context hands out from
    now on (the programs are cached and made anew at a new capacity)."""
    ctx = run.context
    make = ctx._program

    def program():
        prog = make()
        if not getattr(prog, "_fault", False):
            patch(prog)
            prog._fault = True
        return prog
    ctx._program = program


def half_forces(run):
    def patch(prog):
        inner = prog._forces_groups

        def forces_groups(pos, box, mask):
            energy, forces = inner(pos, box, mask)
            forces = forces.clone()
            forces[forces.shape[0] // 2:] = 0.0
            return energy, forces
        prog._forces_groups = forces_groups
    _in_every_program(run, patch)


def wrong_dt(run):
    """The step runs at 1.25 times the step size that the integrator
    reports."""
    integ = run.integrator
    inner = integ._params

    def params():
        values = list(inner())
        values[integ._dt_index()] *= 1.25
        return tuple(values)
    integ._params = params


class _StaleEnergy:
    """A State whose potential energy is another State's."""

    def __init__(self, state, stale):
        self._state, self._stale = state, stale

    def __getattr__(self, name):
        return getattr(self._state, name)

    def getPotentialEnergy(self):
        return self._stale.getPotentialEnergy()


def stale_energy(run):
    rep = run.sim.reporters[0]
    inner = rep.report
    last = []

    def report(simulation, state):
        inner(simulation, _StaleEnergy(state, last[0]) if last else state)
        last[:] = [state]
    rep.report = report


FAULTS = {state_unchanged: "frozen_frames", half_forces: "step_force_err",
          wrong_dt: "step_force_err", stale_energy: "energy_err"}


def _run(name, fault):
    w = harness.workload(name)
    extra_config, extra_traffic = SIZES[name]
    config = dict(harness.load("configs", w["config"]), **extra_config)
    traffic = dict(harness.load("traffic", w["traffic"]), **extra_traffic)
    return harness.execute(name, 2 ** 31 + 99, SECONDS, False,
                           torch.device("cpu"), config=config,
                           traffic=traffic, fault=fault,
                           log=lambda text: None)


@pytest.mark.parametrize("name", sorted(SIZES))
@pytest.mark.parametrize("fault", list(FAULTS), ids=lambda f: f.__name__)
def test_fault_makes_run_incorrect(name, fault):
    result = _run(name, fault)
    value, limit, ok = result["checks"][FAULTS[fault]]
    assert not ok and value > limit
    assert result["correct"] is False


@pytest.mark.parametrize("name", sorted(SIZES))
def test_without_fault_those_numbers_hold(name):
    result = _run(name, None)
    for number in set(FAULTS.values()) | {"force_err", "noise_dev"}:
        assert result["checks"][number][2], (number, result["checks"])
    assert np.isfinite(result["ns_per_day"]) and result["attempted"] > 0
