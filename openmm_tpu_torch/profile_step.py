"""Where a step of the main path, or an evaluation of the minimizer's
objective, spends its time.

    python3 -m openmm_tpu_torch.profile_step [--steps 50] [--device cuda]
    python3 -m openmm_tpu_torch.profile_step --system bilayer [--steps 50]
        [--barostat {none,iso,membrane}]
    python3 -m openmm_tpu_torch.profile_step --minimizer [--evaluations 20]
        [--system bilayer]
    python3 -m openmm_tpu_torch.profile_step --method rf [--system bilayer]
    python3 -m openmm_tpu_torch.profile_step --method ljpme --system bilayer
    python3 -m openmm_tpu_torch.profile_step --system tip4pew
    python3 -m openmm_tpu_torch.profile_step --method ewald --waters 512
    python3 -m openmm_tpu_torch.profile_step --system popc_obc
    python3 -m openmm_tpu_torch.profile_step --integrator verlet
    python3 -m openmm_tpu_torch.profile_step --integrator custom_verlet
    python3 -m openmm_tpu_torch.profile_step --system bilayer --integrator mts
    python3 -m openmm_tpu_torch.profile_step --system alchemical
    python3 -m openmm_tpu_torch.profile_step --system custom_bilayer
    python3 -m openmm_tpu_torch.profile_step --system popc_gb
    python3 -m openmm_tpu_torch.profile_step --system rmsd_bilayer

Builds the 24,000-atom TIP3P PME box (--system water, the default), the
32,512-atom POPC bilayer (--system bilayer: amber14-lipid + TIP3P,
bonded forces, a CMMotionRemover, SETTLE and SHAKE) or the 2,546-atom
POPC cluster in implicit solvent (--system popc_obc: the reference
suite's dhfr_gbsa settings, GBSAOBCForce and the NonbondedForce at
CutoffNonPeriodic 2.0 nm, every pair; it takes no --method), or --waters
TIP4P-Ew waters (--system tip4pew, four particles a water, the M site a
virtual site), the water box as an alchemical run (--system alchemical:
models.alchemical_water_box, 64 solute waters, the soft-core
CustomNonbondedForce and three more custom forces) or the bilayer with
its bonds, angles and torsions as custom forces (--system custom_bilayer:
models.builders.custom_twins, the torsions' compound twin read but not
integrated), the implicit-solvent cluster under the GBn2 recipe
(--system popc_gb: models.popc_gb_cluster, a CustomGBForce) or the
bilayer with an RMSD restraint on its lipids' heavy atoms (--system
rmsd_bilayer: a CustomCVForce over an RMSDForce, rmsd_restrained).
--method picks the
NonbondedForce's method: pme (the default, 0.9 nm), rf (CutoffPeriodic at
1.0 nm, the reference suite's rf settings), ljpme (0.9 nm, the dispersion
grid beside the Coulomb one), ewald (0.9 nm; the water box
only, whose size --waters sets), or nocutoff and cutoffnonperiodic (2.0
nm) on the waters of the water box whose oxygens lie within 2.5 nm of its
centre, a droplet without a box (water_droplet). By default it
relaxes the start briefly (the water box from its lattice, the bilayer
after applyConstraints at 303.15 K), then, from one snapshot, times
`--steps` LangevinMiddle steps at 2 fs twice: through the Context's step
program ("graph": a replay of the captured CUDA graph a step) and through
the eager loop it replaced ("eager": Context._step_eager), each untraced
and then again under torch.profiler (host and CUDA activity).
--integrator times another integrator on a Context of its own, started
from the relaxed state: verlet (1 fs), langevin (leapfrog, 1/ps, 2 fs),
brownian (100/ps, 0.5 fs), andersen (Verlet at 1 fs with an
AndersenThermostat at 10/ps), custom_verlet (custom_verlet(): a
CustomIntegrator velocity Verlet at 1 fs with an if and a while block),
nose_hoover (10/ps, 1 fs; chain 3, MTS 3, YS 7), variable_langevin (1/ps,
error tolerance 1e-3), compound (a CompoundIntegrator of LangevinMiddle
at 2 fs and Verlet at 1 fs, both captured, Verlet's step timed), and on
the bilayer mts (MTSLangevinIntegrator, 1/ps, 2 fs, the NonbondedForce
in group 0 and the bonded forces in group 1, [(0, 1), (1, 2)]) and amd
(AMDForceGroupIntegrator at 1 fs on the torsions, in a group of their
own, alpha and E above their start energy V0 by 0.2 |V0|); not with
--barostat. With
--barostat iso (MonteCarloBarostat) or membrane
(MonteCarloMembraneBarostat, XYIsotropic, ZFree, no tension), both at 1
bar and an attempt every 25 steps, the system runs at constant pressure
(give --steps a multiple of 25 to weigh the attempts in); an "attempt"
window times ATTEMPTS barostat attempts alone, launched eagerly from
the snapshot's state without moving it (two candidate states and two
energies each): device ms and kernels an attempt; and "ab" times the
step program of the same system without the barostat (a Context of its
own, started from the same state) against it in turns, NVT, NPT, NPT,
NVT, `--steps` untraced steps each: the extra ms a step. With
--minimizer it times `--evaluations` evaluations of the minimizer's
objective (Context._make_position_energy_fn: energy and forces by
autograd through kernels 1, 4 and 5, and the bonded forces) at the
starting positions the same way. Prints one JSON
object: for each path (or the objective), wall ms per step (or
evaluation) with and without the profiler, the host CPU time of this
process per untraced unit (near the wall time when the host is what
holds the work back or spins waiting for the card, well under it when
the process waits for a CPU core), for steps the host's issue time per
untraced step (Context.issue_seconds: up to each chunk's one read, so
without the wait for the card) and the rebuilds in the untraced window,
device busy ms per unit (the sum of kernel, copy and fill durations on
the card), the device idle share against the untraced wall time,
kernels run on the card per unit, the CUDA runtime calls the host made
per unit (kernel launches, copies, graph launches), and the kernels that
take the most device time. On a CPU device it reports host time only.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from . import (AMDForceGroupIntegrator, AndersenThermostat,
               BrownianIntegrator, CompoundIntegrator, Context,
               CustomIntegrator, LangevinIntegrator,
               LangevinMiddleIntegrator, MonteCarloBarostat,
               MonteCarloMembraneBarostat, MTSLangevinIntegrator,
               NoseHooverIntegrator, PeriodicTorsionForce,
               VariableLangevinIntegrator, VerletIntegrator, CustomCVForce,
               RMSDForce)
from . import unit as u
from .forces.nonbonded import NonbondedForce
from .models import (alchemical_water_box, popc_bilayer, popc_gb_cluster,
                     popc_obc_cluster, tip3p_water_box, tip4pew_water_box,
                     water_droplet)
from .models.builders import TWIN_INTEGRATION_GROUPS, custom_twins
from .step_program import GATING

ATTEMPTS = 10       # barostat attempts timed alone (--barostat)


def _timed(run, count, device):
    """(wall ms, host CPU ms) per unit of run(), which does `count`."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0, c0 = time.perf_counter(), time.process_time()
    run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return ((time.perf_counter() - t0) / count * 1e3,
            (time.process_time() - c0) / count * 1e3)


def _window(run, count, device, unit, top, issued=None) -> dict:
    """Time run() untraced, then again under torch.profiler, and sum the
    device time of the traced run by kernel. issued(), where given, reads
    the host seconds spent issuing the work (Context.issue_seconds)."""
    issue0 = issued() if issued else 0.0
    wall_ms, cpu_ms = _timed(run, count, device)
    issue_ms = ((issued() - issue0) / count * 1e3) if issued else None
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        traced_ms = _timed(run, count, device)[0]
    out = {"wall_ms_per_" + unit: wall_ms,
           "host_cpu_ms_per_" + unit: cpu_ms,
           "wall_ms_per_%s_traced" % unit: traced_ms}
    if issued:
        out["host_issue_ms_per_" + unit] = issue_ms
    on_card = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in on_card) / count / 1e3
    if device.type == "cuda" and busy_ms > 0:
        out["device_busy_ms_per_" + unit] = busy_ms
        out["device_idle_share"] = 1.0 - busy_ms / wall_ms
        out["kernels_per_" + unit] = sum(e.count for e in on_card) / count
        calls = [e for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CPU
                 and e.key.startswith("cu")]
        out["runtime_calls_per_" + unit] = {
            e.key: e.count / count
            for e in sorted(calls, key=lambda e: -e.count)[:8]}
        out["top_kernels"] = [
            [e.key[:90], e.count / count, e.self_device_time_total / count
             / 1e3]
            for e in sorted(on_card, key=lambda e: -e.self_device_time_total)
            [:top]]
    else:
        out["device_busy_ms_per_" + unit] = "not measured"
    return out


# --method: (NonbondedForce method, cutoff nm)
METHODS = {"pme": (NonbondedForce.PME, 0.9),
           "rf": (NonbondedForce.CutoffPeriodic, 1.0),
           "ljpme": (NonbondedForce.LJPME, 0.9),
           "ewald": (NonbondedForce.Ewald, 0.9),
           "nocutoff": (NonbondedForce.NoCutoff, 2.0),
           "cutoffnonperiodic": (NonbondedForce.CutoffNonPeriodic, 2.0)}
DROPLET_RADIUS = 2.5


def _system(name, n_waters, method="pme"):
    """(system, positions, temperature K) of --system at --method."""
    nb_method, cutoff = METHODS[method]
    if name in ("popc_obc", "popc_gb"):
        if method != "pme":
            raise ValueError("--system %s takes no --method" % name)
        cluster = popc_obc_cluster if name == "popc_obc" else popc_gb_cluster
        return (*cluster(), 300.0)
    if name == "tip4pew":
        if method not in ("pme", "ljpme"):
            raise ValueError("--system tip4pew takes pme or ljpme")
        return (*tip4pew_water_box(n_waters, nonbonded_method=nb_method,
                                   cutoff=cutoff), 300.0)
    if name in ("alchemical", "custom_bilayer", "rmsd_bilayer") \
            and method != "pme":
        raise ValueError("--system %s takes no --method" % name)
    if name == "alchemical":
        return (*alchemical_water_box(n_waters), 300.0)
    if name == "custom_bilayer":
        system, positions = popc_bilayer()
        return custom_twins(system)[0], positions, 303.15
    if name == "rmsd_bilayer":
        system, positions = popc_bilayer()
        return rmsd_restrained(system, positions), positions, 303.15
    if name == "bilayer":
        if method not in ("pme", "rf", "ljpme"):
            raise ValueError("--method %s takes the water system" % method)
        system, positions = popc_bilayer()
        (nb,) = [f for f in system.getForces()
                 if isinstance(f, NonbondedForce)]
        nb.setNonbondedMethod(nb_method)
        nb.setCutoffDistance(cutoff)
        return system, positions, 303.15
    if method in ("nocutoff", "cutoffnonperiodic"):
        box, positions = tip3p_water_box(n_waters)
        return (*water_droplet(positions,
                               u.plain(box.getDefaultPeriodicBoxVectors()),
                               DROPLET_RADIUS, nb_method, cutoff), 300.0)
    return (*tip3p_water_box(n_waters, nonbonded_method=nb_method,
                             cutoff=cutoff), 300.0)


def rmsd_restrained(system, positions, k=2000.0, r0=0.05):
    """`system` with CustomCVForce("0.5*k*(rmsd-r0)^2") over an RMSDForce
    of the heavy atoms (above 2 amu) of its molecules larger than a
    water, the reference `positions`, in force group 6."""
    masses = np.asarray([u.plain(system.getParticleMass(i))
                         for i in range(system.getNumParticles())])
    probe = Context(system, LangevinMiddleIntegrator(300.0, 1.0, 0.002),
                    "CPU")
    heavy = sorted(i for mol in probe.getMolecules() if len(mol) > 3
                   for i in mol if masses[i] > 2.0)
    del probe
    cv = CustomCVForce("0.5*k*(rmsd-r0)^2")
    cv.addGlobalParameter("k", k)
    cv.addGlobalParameter("r0", r0)
    cv.addCollectiveVariable("rmsd", RMSDForce(positions, heavy))
    cv.setForceGroup(6)
    system.addForce(cv)
    return system


def _context(device, system, integ):
    return Context(system, integ, "CUDA" if device.type == "cuda" else "CPU")


def _device_name(device):
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def _barostat(name, temperature):
    """The --barostat force, or None."""
    if name == "iso":
        return MonteCarloBarostat(1.0, temperature, 25)
    if name == "membrane":
        return MonteCarloMembraneBarostat(
            1.0, 0.0, temperature, MonteCarloMembraneBarostat.XYIsotropic,
            MonteCarloMembraneBarostat.ZFree, 25)
    return None


def custom_verlet(dt=0.001, sum_every=10, loops=3):
    """A velocity Verlet written as a CustomIntegrator (half kick; drift;
    x1 = x; constrain positions; half kick plus (x - x1)/dt; constrain
    velocities), with a step counter n, the kinetic energy summed into ke
    inside an if block every `sum_every` steps, and a while block of
    `loops` passes that adds one to `passes` each."""
    integ = CustomIntegrator(dt)
    for name in ("n", "k", "ke", "j", "passes"):
        integ.addGlobalVariable(name, 0.0)
    integ.addPerDofVariable("x1", 0.0)
    integ.addUpdateContextState()
    integ.addComputePerDof("v", "v+0.5*dt*f/m")
    integ.addComputePerDof("x", "x+dt*v")
    integ.addComputePerDof("x1", "x")
    integ.addConstrainPositions()
    integ.addComputePerDof("v", "v+0.5*dt*f/m+(x-x1)/dt")
    integ.addConstrainVelocities()
    integ.addComputeGlobal("n", "n+1")
    integ.addComputeGlobal("k", "k+1")
    integ.beginIfBlock("k >= %d" % sum_every)
    integ.addComputeSum("ke", "m*v*v/2")
    integ.addComputeGlobal("k", "0")
    integ.endBlock()
    integ.addComputeGlobal("j", "0")
    integ.beginWhileBlock("j < %d" % loops)
    integ.addComputeGlobal("passes", "passes+1")
    integ.addComputeGlobal("j", "j+1")
    integ.endBlock()
    return integ


BILAYER_INTEGRATORS = ("mts", "amd")


def _integrator(name, temperature, system, ctx):
    """(the --integrator's integrator, whether the System takes an
    AndersenThermostat). mts and amd set the force groups of `system`;
    amd reads the torsions' start energy from `ctx`."""
    if name in BILAYER_INTEGRATORS:
        kind = NonbondedForce if name == "mts" else PeriodicTorsionForce
        for force in system.getForces():
            force.setForceGroup(
                int(isinstance(force, kind) == (name == "amd")))
        if name == "mts":
            return MTSLangevinIntegrator(temperature, 1.0, 0.002,
                                         [(0, 1), (1, 2)]), False
        probe = _context(ctx._device, system, VerletIntegrator(0.001))
        probe.setPositions(u.plain(ctx.getState(
            getPositions=True).getPositions(asNumpy=True)))
        v0 = u.plain(probe.getState(getEnergy=True,
                                    groups={1}).getPotentialEnergy())
        return AMDForceGroupIntegrator(0.001, 1, 0.2 * abs(v0),
                                       v0 + 0.2 * abs(v0)), False
    if name == "verlet":
        return VerletIntegrator(0.001), False
    if name == "andersen":
        return VerletIntegrator(0.001), True
    if name == "langevin":
        return LangevinIntegrator(temperature, 1.0, 0.002), False
    if name == "custom_verlet":
        return custom_verlet(), False
    if name == "nose_hoover":
        return NoseHooverIntegrator(temperature, 10.0, 0.001), False
    if name == "variable_langevin":
        return VariableLangevinIntegrator(temperature, 1.0, 1e-3), False
    if name == "compound":
        integ = CompoundIntegrator()
        integ.addIntegrator(LangevinMiddleIntegrator(temperature, 1.0,
                                                     0.002))
        integ.addIntegrator(VerletIntegrator(0.001))
        return integ, False
    return BrownianIntegrator(temperature, 100.0, 0.0005), False


def profile_steps(device, n_waters=8000, steps=50, top=20,
                  system_name="water", barostat="none",
                  method="pme", integrator="langevinmiddle") -> dict:
    if barostat != "none" and integrator != "langevinmiddle":
        raise ValueError("--integrator takes no --barostat")
    if integrator in BILAYER_INTEGRATORS and system_name != "bilayer":
        raise ValueError("--integrator %s takes --system bilayer"
                         % integrator)
    system, positions, temperature = _system(system_name, n_waters, method)
    force = _barostat(barostat, temperature)
    if force is not None:
        system.addForce(force)
    integ = LangevinMiddleIntegrator(temperature, 50.0, 0.0005)
    integ.setRandomNumberSeed(3)
    if system_name == "custom_bilayer":
        integ.setIntegrationForceGroups(TWIN_INTEGRATION_GROUPS)
    ctx = _context(device, system, integ)
    ctx.setPositions(positions)
    ctx.applyConstraints()
    ctx.setVelocitiesToTemperature(temperature, randomSeed=1)
    integ.step(300)
    integ.setStepSize(0.002)
    integ.setFriction(1.0)
    integ.step(20)
    if integrator != "langevinmiddle":
        system, _, _ = _system(system_name, n_waters, method)
        integ, thermostat = _integrator(integrator, temperature, system,
                                        ctx)
        if thermostat:
            system.addForce(AndersenThermostat(temperature, 10.0))
        integ.setRandomNumberSeed(3)
        twin = _context(device, system, integ)
        twin.setState(ctx.getState(getPositions=True, getVelocities=True))
        ctx = twin
        integ.step(20)                  # the capture, out of the window
        if integrator == "compound":
            integ.setCurrentIntegrator(1)
            integ.step(20)
    start = ctx._snapshot()
    out = {"device": _device_name(device), "system": system_name,
           "method": method, "barostat": barostat, "integrator": integrator,
           "atoms": system.getNumParticles(),
           "steps": steps, "gating": GATING,
           "escalations": ctx.escalation_count}
    for path, step in (("graph", integ.step), ("eager", ctx._step_eager)):
        ctx._restore(start)
        rebuilds = []

        def run(step=step, rebuilds=rebuilds):
            before = ctx.rebuild_count
            step(steps)
            rebuilds.append(ctx.rebuild_count - before)

        window = _window(run, steps, device, "step", top,
                         lambda: ctx.issue_seconds)
        out[path] = {"rebuilds": rebuilds[0], **window}
    if force is not None:
        ctx._restore(start)
        out["ab"] = _nvt_against_npt(device, system_name, n_waters, ctx,
                                     steps, method)
        ctx._restore(start)
        baro = ctx._barostats[0]
        pos, box = ctx._state["positions"], ctx._box
        u = baro.draw(ctx._generator, pos.device)

        def attempt():
            for _ in range(ATTEMPTS):
                baro.attempt(pos, box, u, ctx._gp, ctx._trial_energy)

        attempt()                       # cuFFT plans, the allocator
        out["attempt"] = _window(attempt, ATTEMPTS, device, "attempt", top)
    return out


def _nvt_against_npt(device, system_name, n_waters, ctx, steps,
                     method) -> dict:
    """Wall ms a step of `ctx`'s step program (NPT) and of a Context of
    the same system without its barostat (NVT) from the same state, in
    turns, each continuing from where its last window left it."""
    system, _, temperature = _system(system_name, n_waters, method)
    integ = LangevinMiddleIntegrator(temperature, 1.0, 0.002)
    integ.setRandomNumberSeed(3)
    twin = _context(device, system, integ)
    twin.setState(ctx.getState(getPositions=True, getVelocities=True))
    integ.step(steps)                   # the capture, out of the window
    runs = {"nvt": integ.step, "npt": ctx.getIntegrator().step}
    order = ("nvt", "npt", "npt", "nvt")
    return {"order": order,
            "wall_ms_per_step": [_timed(lambda: runs[k](steps), steps,
                                        device)[0] for k in order]}


def profile_objective(device, n_waters=8000, evaluations=20, top=20,
                      system_name="water", method="pme") -> dict:
    system, positions, temperature = _system(system_name, n_waters, method)
    ctx = _context(device, system,
                   LangevinMiddleIntegrator(temperature, 1.0, 0.002))
    ctx.setPositions(positions)
    evaluate = ctx._make_position_energy_fn()
    evaluate(positions)                     # builds the kernels

    def run():
        for _ in range(evaluations):
            evaluate(positions)

    window = _window(run, evaluations, device, "evaluation", top)
    return {"device": _device_name(device), "system": system_name,
            "method": method, "atoms": system.getNumParticles(),
            "evaluations": evaluations,
            **window}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=50)
    parser.add_argument("--minimizer", action="store_true",
                        help="profile the minimizer's objective instead")
    parser.add_argument("--evaluations", type=int, default=20)
    parser.add_argument("--waters", type=int, default=8000)
    parser.add_argument("--system", choices=("water", "bilayer", "popc_obc",
                                             "popc_gb", "tip4pew",
                                             "alchemical", "custom_bilayer",
                                             "rmsd_bilayer"),
                        default="water",
                        help="the system whose MD step (or objective) is "
                        "profiled")
    parser.add_argument("--method", choices=tuple(METHODS), default="pme",
                        help="the NonbondedForce's method (nocutoff and "
                        "cutoffnonperiodic on a droplet of the water box)")
    parser.add_argument("--barostat", choices=("none", "iso", "membrane"),
                        default="none",
                        help="run the MD step at constant pressure under "
                        "this barostat (an attempt every 25 steps) and "
                        "time its attempts alone")
    parser.add_argument("--integrator", default="langevinmiddle",
                        choices=("langevinmiddle", "verlet", "langevin",
                                 "brownian", "andersen", "custom_verlet",
                                 "nose_hoover", "variable_langevin",
                                 "compound") + BILAYER_INTEGRATORS,
                        help="the integrator whose step is profiled")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible to torch")
    if args.minimizer:
        out = profile_objective(device, args.waters, args.evaluations,
                                system_name=args.system, method=args.method)
    else:
        out = profile_steps(device, args.waters, args.steps,
                            system_name=args.system, barostat=args.barostat,
                            method=args.method, integrator=args.integrator)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
