"""Where a step of the main path, or an evaluation of the minimizer's
objective, spends its time.

    python3 -m openmm_tpu_torch.profile_step [--steps 50] [--device cuda]
    python3 -m openmm_tpu_torch.profile_step --system bilayer [--steps 50]
        [--barostat {none,iso,membrane}]
    python3 -m openmm_tpu_torch.profile_step --minimizer [--evaluations 20]
        [--system bilayer]

Builds the 24,000-atom TIP3P PME box (--system water, the default) or
the 32,512-atom POPC bilayer (--system bilayer: amber14-lipid + TIP3P,
bonded forces, a CMMotionRemover, SETTLE and SHAKE). By default it
relaxes the start briefly (the water box from its lattice, the bilayer
after applyConstraints at 303.15 K), then, from one snapshot, times
`--steps` LangevinMiddle steps at 2 fs twice: through the Context's step
program ("graph": a replay of the captured CUDA graph a step) and through
the eager loop it replaced ("eager": Context._step_eager), each untraced
and then again under torch.profiler (host and CUDA activity). With
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

import torch
from torch.profiler import ProfilerActivity, profile

from . import (Context, LangevinMiddleIntegrator, MonteCarloBarostat,
               MonteCarloMembraneBarostat)
from .models import popc_bilayer, tip3p_water_box
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


def _system(name, n_waters):
    """(system, positions, temperature K) of --system."""
    if name == "bilayer":
        return (*popc_bilayer(), 303.15)
    return (*tip3p_water_box(n_waters), 300.0)


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


def profile_steps(device, n_waters=8000, steps=50, top=20,
                  system_name="water", barostat="none") -> dict:
    system, positions, temperature = _system(system_name, n_waters)
    force = _barostat(barostat, temperature)
    if force is not None:
        system.addForce(force)
    integ = LangevinMiddleIntegrator(temperature, 50.0, 0.0005)
    integ.setRandomNumberSeed(3)
    ctx = _context(device, system, integ)
    ctx.setPositions(positions)
    ctx.applyConstraints()
    ctx.setVelocitiesToTemperature(temperature, randomSeed=1)
    integ.step(300)
    integ.setStepSize(0.002)
    integ.setFriction(1.0)
    integ.step(20)
    start = ctx._snapshot()
    out = {"device": _device_name(device), "system": system_name,
           "barostat": barostat, "atoms": system.getNumParticles(),
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
                                     steps)
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


def _nvt_against_npt(device, system_name, n_waters, ctx, steps) -> dict:
    """Wall ms a step of `ctx`'s step program (NPT) and of a Context of
    the same system without its barostat (NVT) from the same state, in
    turns, each continuing from where its last window left it."""
    system, _, temperature = _system(system_name, n_waters)
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
                      system_name="water") -> dict:
    system, positions, temperature = _system(system_name, n_waters)
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
            "atoms": system.getNumParticles(), "evaluations": evaluations,
            **window}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=50)
    parser.add_argument("--minimizer", action="store_true",
                        help="profile the minimizer's objective instead")
    parser.add_argument("--evaluations", type=int, default=20)
    parser.add_argument("--waters", type=int, default=8000)
    parser.add_argument("--system", choices=("water", "bilayer"),
                        default="water",
                        help="the system whose MD step (or objective) is "
                        "profiled")
    parser.add_argument("--barostat", choices=("none", "iso", "membrane"),
                        default="none",
                        help="run the MD step at constant pressure under "
                        "this barostat (an attempt every 25 steps) and "
                        "time its attempts alone")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible to torch")
    if args.minimizer:
        out = profile_objective(device, args.waters, args.evaluations,
                                system_name=args.system)
    else:
        out = profile_steps(device, args.waters, args.steps,
                            system_name=args.system, barostat=args.barostat)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
