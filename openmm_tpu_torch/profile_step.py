"""Where a step of the main path spends its time.

    python3 -m openmm_tpu_torch.profile_step [--steps 50] [--device cuda]

Builds the 24,000-atom TIP3P PME box, relaxes the lattice start briefly,
then times `--steps` LangevinMiddle steps at 2 fs untraced and the same
number again under torch.profiler (host and CUDA activity). Prints one JSON
object: wall ms per step with and without the profiler, the host CPU time
of this process per untraced step (near the wall time when the host is
what holds the step back, well under it when the process waits for a CPU
core or for the card), the rebuilds in the untraced window, device busy ms per
step (the sum of kernel, copy and fill durations on the card), the device
idle share against the untraced wall time, kernels launched per step, and
the kernels that take the most device time. On a CPU device it reports host
time only.
"""
from __future__ import annotations

import argparse
import json
import time

import torch
from torch.profiler import ProfilerActivity, profile

from . import Context, LangevinMiddleIntegrator
from .models import tip3p_water_box


def profile_steps(device, n_waters=8000, steps=50, top=12) -> dict:
    system, positions = tip3p_water_box(n_waters)
    integ = LangevinMiddleIntegrator(300.0, 50.0, 0.0005)
    integ.setRandomNumberSeed(3)
    ctx = Context(system, integ, "CUDA" if device.type == "cuda" else "CPU")
    ctx.setPositions(positions)
    ctx.applyConstraints()
    ctx.setVelocitiesToTemperature(300.0, randomSeed=1)
    integ.step(300)
    integ.setStepSize(0.002)
    integ.setFriction(1.0)
    integ.step(20)

    def timed_steps():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0, c0 = time.perf_counter(), time.process_time()
        integ.step(steps)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return ((time.perf_counter() - t0) / steps * 1e3,
                (time.process_time() - c0) / steps * 1e3)

    rebuilds = ctx.rebuild_count
    wall_ms, cpu_ms = timed_steps()
    rebuilds = ctx.rebuild_count - rebuilds
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        traced_ms = timed_steps()[0]
    out = {"device": (torch.cuda.get_device_name(device)
                      if device.type == "cuda" else "cpu"),
           "atoms": system.getNumParticles(), "steps": steps,
           "rebuilds": rebuilds, "wall_ms_per_step": wall_ms,
           "host_cpu_ms_per_step": cpu_ms,
           "wall_ms_per_step_traced": traced_ms}
    on_card = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in on_card) / steps / 1e3
    if device.type == "cuda" and busy_ms > 0:
        out["device_busy_ms_per_step"] = busy_ms
        out["device_idle_share"] = 1.0 - busy_ms / wall_ms
        out["kernels_per_step"] = sum(e.count for e in on_card) / steps
        out["top_kernels"] = [
            [e.key[:90], e.count / steps, e.self_device_time_total / steps
             / 1e3]
            for e in sorted(on_card, key=lambda e: -e.self_device_time_total)
            [:top]]
    else:
        out["device_busy_ms_per_step"] = "not measured"
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=50)
    parser.add_argument("--waters", type=int, default=8000)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible to torch")
    print(json.dumps(profile_steps(device, args.waters, args.steps)))


if __name__ == "__main__":
    main()
