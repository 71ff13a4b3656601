"""Simulation: a Topology, a System and an Integrator bound in a Context,
with a stepping loop that serves reporters.

The port's copy of openmm_tpu/app/simulation.py (after OpenMM's
wrappers/python/openmm/app/simulation.py:60-240). _simulate steps toward
the next report in one integrator.step(k) (the step program replays its
captured graph for any k, so no chunk size is captured), then takes one
getState for all the reporters that are due, with the union of what they
asked for. minimizeEnergy runs the port's LocalEnergyMinimizer;
runForClockTime runs until a wall-clock limit, saving checkpoints on the
way; saveCheckpoint and loadCheckpoint carry the Context's checkpoint
bytes.

The Context is built on the port's default platform, the CUDA one, unless
a platform is given: Simulation(..., platform=Platform.getPlatformByName(
"CPU")) runs on the host. The paths through XmlSerializer (a System or an
Integrator given as a file name, state=, saveState, loadState) wait for
the port's serialization (ROADMAP item 8) and raise.
"""
from __future__ import annotations

import sys
import time

from .. import unit as u
from ..context import Context

_SERIALIZATION = ("%s needs XmlSerializer, which the port has not got yet "
                  "(ROADMAP item 8, serialization)")


class Simulation(object):
    def __init__(self, topology, system, integrator, platform=None,
                 platformProperties=None, state=None):
        for what, value in (("a System from a file", system),
                            ("an Integrator from a file", integrator)):
            if isinstance(value, str):
                raise NotImplementedError(_SERIALIZATION % what)
        if state is not None:
            raise NotImplementedError(_SERIALIZATION % "state=")
        self.topology = topology
        self.system = system
        self.integrator = integrator
        self.currentStep = 0
        self.reporters = []
        self.context = Context(system, integrator, platform,
                               platformProperties)
        # the topology's box (when it has one) overrides the System's
        # default, as in the JAX package
        box = (topology.getPeriodicBoxVectors()
               if topology is not None else None)
        if box is not None:
            self.context.setPeriodicBoxVectors(
                *box.value_in_unit(u.nanometer))

    def minimizeEnergy(self, tolerance=10.0, maxIterations=0):
        from ..minimize import LocalEnergyMinimizer
        LocalEnergyMinimizer.minimize(self.context, tolerance, maxIterations)

    def step(self, steps):
        self._simulate(endStep=self.currentStep + steps)

    def runForClockTime(self, time_limit, checkpointFile=None, stateFile=None,
                        checkpointInterval=None):
        """Run until `time_limit` (seconds, or a time Quantity) of wall
        clock have passed, saving a checkpoint to checkpointFile every
        checkpointInterval and at the end."""
        if stateFile is not None:
            raise NotImplementedError(_SERIALIZATION % "stateFile=")
        if u.is_quantity(time_limit):
            time_limit = time_limit.value_in_unit(u.second)
        if checkpointInterval is not None and u.is_quantity(checkpointInterval):
            checkpointInterval = checkpointInterval.value_in_unit(u.second)
        end_time = time.time() + time_limit
        while time.time() < end_time:
            if checkpointInterval is None:
                next_time = end_time
            else:
                next_time = min(time.time() + checkpointInterval, end_time)
            self._simulate(endTime=next_time)
            if checkpointFile is not None:
                self.saveCheckpoint(checkpointFile)

    def saveCheckpoint(self, file):
        if isinstance(file, str):
            with open(file, "wb") as f:
                f.write(self.context.createCheckpoint())
        else:
            file.write(self.context.createCheckpoint())

    def loadCheckpoint(self, file):
        if isinstance(file, str):
            with open(file, "rb") as f:
                self.context.loadCheckpoint(f.read())
        else:
            self.context.loadCheckpoint(file.read())
        self.currentStep = self.context.getStepCount()

    def saveState(self, file):
        raise NotImplementedError(_SERIALIZATION % "saveState")

    def loadState(self, file):
        raise NotImplementedError(_SERIALIZATION % "loadState")

    def _simulate(self, endStep=None, endTime=None):
        """Step to endStep (or, with endTime, until the clock passes it, in
        chunks of 10 steps), stopping at each step a reporter is due."""
        if endStep is None:
            endStep = sys.maxsize
        nextReport = [None] * len(self.reporters)
        while self.currentStep < endStep and (endTime is None
                                              or time.time() < endTime):
            nextSteps = endStep - self.currentStep
            anyReport = False
            for i, reporter in enumerate(self.reporters):
                nextReport[i] = _report_request(
                    reporter.describeNextReport(self))
                steps = nextReport[i][0]
                if 0 < steps <= nextSteps:
                    nextSteps = steps
                    anyReport = True
            if endTime is None:
                self.integrator.step(nextSteps)
            else:
                stepsToGo = nextSteps
                while stepsToGo > 10 and time.time() < endTime:
                    self.integrator.step(10)
                    stepsToGo -= 10
                    self.currentStep += 10
                if stepsToGo > 10:
                    anyReport = False
                    continue
                self.integrator.step(stepsToGo)
                nextSteps = stepsToGo
            self.currentStep += nextSteps
            if anyReport:
                self._report(nextReport, nextSteps)

    def _report(self, nextReport, nextSteps):
        """One getState for the due reporters that wrap positions into the
        box, one for those that do not, each with the union of what its
        reporters asked for."""
        wrapped, unwrapped = [], []
        for reporter, (steps, flags, wrap) in zip(self.reporters,
                                                  nextReport):
            if steps == nextSteps:
                if wrap is None:
                    wrap = self.system.usesPeriodicBoundaryConditions()
                (wrapped if wrap else unwrapped).append((reporter, flags))
        for group, enforce in ((wrapped, True), (unwrapped, False)):
            if not group:
                continue
            want = [any(flags[k] for _, flags in group) for k in range(4)]
            state = self.context.getState(
                getPositions=want[0], getVelocities=want[1],
                getForces=want[2], getEnergy=want[3],
                enforcePeriodicBox=enforce)
            for reporter, _ in group:
                reporter.report(self, state)


def _report_request(rep):
    """(steps, (positions, velocities, forces, energy), wrap) of what a
    reporter's describeNextReport returned: a tuple (steps, positions,
    velocities, forces, energy[, wrap]) or a dict with "steps", "include"
    and "periodic"."""
    if isinstance(rep, dict):
        include = rep.get("include", [])
        return (rep["steps"],
                tuple(k in include for k in ("positions", "velocities",
                                             "forces", "energy")),
                rep.get("periodic", None))
    return (rep[0], tuple(rep[1:5]), rep[5] if len(rep) > 5 else None)
