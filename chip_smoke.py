"""Smoke test of openmm_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the three CUDA kernels from csrc/ with one nvcc call, holds each
kernel against its plain PyTorch version at the shapes of the main path,
then runs the main path -- a 24,000-atom TIP3P PME box (8,000 rigid waters,
0.9 nm cutoff, LangevinMiddle) -- through the port's public entry points,
and checks what comes out. It imports nothing of JAX or of openmm_tpu.

The script keeps to a budget of its own (BUDGET_S, build included) and exits
non-zero, naming the phase, when that is exceeded or any phase fails. Its
last line is {"ok": true, "device": {...}} and nothing else; the line before
it is the per-kernel JSON record (launches on the main path, times, bounds).
Without a CUDA device it exits non-zero before printing any result.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import openmm_tpu_torch as omm
from openmm_tpu_torch import _build
from openmm_tpu_torch.forces.nonbonded import NonbondedModule
from openmm_tpu_torch.models import tip3p_water_box
from openmm_tpu_torch.ops import geometry as geom
from openmm_tpu_torch.ops import pme_zslab, tile_pairs

BUDGET_S = 180.0
N_WATERS = 8000
# lattice-start relaxation: (step size ps, friction 1/ps, steps); bench.py
# uses 6,000 steps, which this smoke test cannot afford
RELAX = ((0.0005, 50.0, 300), (0.001, 20.0, 200))
DT_PS = 0.002
FRICTION = 1.0
PRODUCTION_STEPS = 200
ENERGY_EVERY = 50
FORCE_ERR_BAR = 1e-5
# clock cycles the card sleeps before each timed call (~1 ms at 1.98 GHz)
SLEEP_CYCLES = 2_000_000
# peak rates of one H100 SXM (data sheet, dense): float32 outside the
# tensor cores, and HBM bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12
KERNELS = (tile_pairs.TILES, pme_zslab.SPREAD, pme_zslab.GATHER)
# kernel vs plain tolerances, relative to the largest magnitude of the plain
# result: summation order differs (kernel 1: 8 slice partials; kernel 2:
# atomics in a run-dependent order) and rsqrtf/expf differ in the last ulps
TOLERANCE = {"nonbonded_tiles": 1e-4, "pme_spread": 1e-5,
             "pme_gather": 1e-4}


class Deadline:
    """The script's overall budget, checked inside every phase after each
    bounded piece of work (a chunk of steps, one kernel, the nvcc call)."""

    def __init__(self, budget_s: float):
        self.t0 = time.perf_counter()
        self.budget_s = budget_s

    def elapsed(self) -> float:
        return time.perf_counter() - self.t0

    def remaining(self) -> float:
        return self.budget_s - self.elapsed()

    def exceeded(self, phase: str) -> RuntimeError:
        return RuntimeError("budget of %.0f s exceeded in phase %s (%.1f s)"
                            % (self.budget_s, phase, self.elapsed()))

    def check(self, phase: str) -> None:
        if self.remaining() < 0.0:
            raise self.exceeded(phase)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def phase_device(device) -> dict:
    name = torch.cuda.get_device_name(device)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30, check=True).stdout.strip().splitlines()
    print("device: %s, count %d" % (name, torch.cuda.device_count()))
    print("nvidia-smi: %s" % smi[device.index or 0])
    return {"name": name, "smi": smi[device.index or 0],
            "count": torch.cuda.device_count()}


def phase_build(deadline) -> float:
    try:
        path, seconds, log = _build.build(timeout=max(deadline.remaining(),
                                                      1.0))
    except subprocess.TimeoutExpired:
        raise deadline.exceeded("build (nvcc)") from None
    regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
    (_build.BUILD_DIR / "ptxas.log").write_text(log)
    print("build: one nvcc call, %.1f s -> %s" % (seconds, path.name))
    for line in regs:
        print("  ptxas: %s" % line[:110])
    _build.library()
    return seconds


def kernel_inputs(device, n_waters) -> dict:
    """Inputs of the three kernels at the main path's shapes, from the
    water box's starting positions."""
    system, pos = tip3p_water_box(n_waters)
    box = torch.as_tensor(system.getDefaultPeriodicBoxVectors(),
                          dtype=torch.float32, device=device)
    module = NonbondedModule(system.getForce(0), box.cpu().numpy(), device)
    posf = torch.as_tensor(pos, dtype=torch.float32, device=device)
    st = module.build_state(posf, box)
    if int(st["overflow"]):
        raise RuntimeError("candidate state overflowed at the start")
    binv = geom.box_inverse(box).reshape(9).contiguous()
    return {
        "tiles": (tile_pairs.sorted_positions(posf, box, st), st["par4"],
                  st["cand"], st["count"], st["words"],
                  tile_pairs.tile_consts(box, module.tile_scalars)),
        "pos": posf.contiguous(), "charge": module.charge, "binv": binv,
        "grid": module.grid, "module": module, "box": box,
    }


def _kernel_calls(inp):
    """{name: (kernel call, plain call)} on the same inputs."""
    t = inp["tiles"]
    pos, q, binv, grid = inp["pos"], inp["charge"], inp["binv"], inp["grid"]
    m = inp["module"]
    q_grid = pme_zslab.pme_spread_plain(pos, q, binv, grid)
    phi, _ = pme_zslab.convolve_potential(
        q_grid, inp["box"], grid, m.alpha, m.bsq_x, m.bsq_y, m.bsq_z)
    phi2 = (2.0 * phi).contiguous()
    mode = tile_pairs.MODE_EWALD
    return {
        "nonbonded_tiles": (
            lambda: tile_pairs.nonbonded_tiles(*t, mode, m.use_switch),
            lambda: tile_pairs.nonbonded_tiles_plain(*t, mode, m.use_switch)),
        "pme_spread": (
            lambda: pme_zslab.pme_spread(pos, q, binv, grid),
            lambda: pme_zslab.pme_spread_plain(pos, q, binv, grid)),
        "pme_gather": (
            lambda: pme_zslab.pme_gather(pos, q, phi2, binv, grid),
            lambda: pme_zslab.pme_gather_plain(pos, q, phi2, binv, grid)),
    }


def phase_kernels(device, inp, deadline) -> dict:
    """Each kernel against its plain version; raises on a miss."""
    errors = {}
    for name, (kernel, plain) in _kernel_calls(inp).items():
        got = kernel()
        want = plain()
        _sync(device)
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        ok = math.isfinite(err) and err <= TOLERANCE[name] * scale
        print("kernel %-16s max_abs_err %.3e  rel %.3e  (tolerance %.0e of "
              "max %.3e) %s" % (name, err, err / scale, TOLERANCE[name],
                                scale, "ok" if ok else "MISS"))
        if not ok:
            raise RuntimeError("kernel %s disagrees with its plain version"
                               % name)
        errors[name] = err
        deadline.check("kernels: %s" % name)
    return errors


def _median_relative_error(forces, reference):
    norm = np.linalg.norm(reference, axis=1)
    norm = np.where(norm == 0.0, 1.0, norm)
    return float(np.median(np.linalg.norm(forces - reference, axis=1)
                           / norm))


def phase_main_path(device, n_waters=N_WATERS, relax=RELAX,
                    steps=PRODUCTION_STEPS, energy_every=ENERGY_EVERY,
                    deadline=None) -> dict:
    """Build the water box and a Context on `device` (the default platform
    on a GPU, "CPU" otherwise), relax the lattice start, check forces
    against the float64 plain path, then run `steps` production steps.
    `deadline` is checked after every `energy_every` steps."""
    deadline = deadline or Deadline(math.inf)
    platform = "CUDA" if device.type == "cuda" else "CPU"
    system, positions = tip3p_water_box(n_waters)
    integ = omm.LangevinMiddleIntegrator(300.0, FRICTION, DT_PS)
    integ.setRandomNumberSeed(7)
    ctx = (omm.Context(system, integ) if platform == "CUDA"
           else omm.Context(system, integ, platform))
    ctx.setPositions(positions)
    ctx.applyConstraints()
    ctx.setVelocitiesToTemperature(300.0, randomSeed=1)
    for dt, friction, n in relax:
        integ.setStepSize(dt)
        integ.setFriction(friction)
        for done in range(0, n, energy_every):
            integ.step(min(energy_every, n - done))
            deadline.check("main path: relaxation")
    integ.setStepSize(DT_PS)
    integ.setFriction(FRICTION)

    st = ctx.getState(getForces=True, getPositions=True, getEnergy=True)
    oracle = omm.Context(system, omm.LangevinMiddleIntegrator(
        300.0, FRICTION, DT_PS), platform, {"Precision": "double"})
    oracle.setPositions(st.getPositions())
    ref = oracle.getState(getForces=True, getEnergy=True)
    force_err = _median_relative_error(st.getForces(), ref.getForces())
    print("main path: median force error vs float64 plain path %.3e "
          "(bar %.0e); energy %.6f vs %.6f kJ/mol" % (
              force_err, FORCE_ERR_BAR, st.getPotentialEnergy(),
              ref.getPotentialEnergy()))
    del oracle
    deadline.check("main path: float64 oracle")
    if not force_err <= FORCE_ERR_BAR:
        raise RuntimeError("median force error %.3e above %.0e"
                           % (force_err, FORCE_ERR_BAR))

    energies, elapsed, done = [st.getPotentialEnergy()], 0.0, 0
    while done < steps:
        n = min(energy_every, steps - done)
        _sync(device)
        t0 = time.perf_counter()
        integ.step(n)
        _sync(device)
        elapsed += time.perf_counter() - t0
        done += n
        energies.append(ctx.getState(getEnergy=True).getPotentialEnergy())
        deadline.check("main path: production")
    temperature = ctx.temperature()
    ns_day = DT_PS * steps / elapsed * 86.4
    print("main path: %d atoms, %d relax + %d steps at %.3f ps; energies "
          "%s kJ/mol; T %.1f K; rebuilds %d, escalations %d" % (
              system.getNumParticles(), sum(r[2] for r in relax), steps,
              DT_PS, " ".join("%.1f" % e for e in energies), temperature,
              ctx.rebuild_count, ctx.escalation_count))
    if not all(math.isfinite(e) for e in energies):
        raise RuntimeError("a potential energy is not finite (NaN poison "
                           "or blow-up)")
    if not 200.0 <= temperature <= 450.0:
        raise RuntimeError("final temperature %.1f K outside 200-450 K"
                           % temperature)
    return {"force_err": force_err, "energies": energies,
            "temperature": temperature, "ns_day": ns_day,
            "rebuilds": ctx.rebuild_count,
            "escalations": ctx.escalation_count}


def _time_ms(fn, device, reps=20, warmup=3) -> float:
    """Median milliseconds per call over `reps` calls timed one by one
    with CUDA events, after `warmup` calls. Each call is queued behind a
    ~1 ms sleep on the card, so the events time the device work and not
    the host's launch overhead (which is larger than a 24,000-atom spread
    or gather)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize(device)
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


# float operations (an FMA counts 2) that each function needs, at least:
# kernel 1, per distinct pair inside the cutoff: staged triclinic image and
# r^2 (24), LJ (16), Ewald erfc and its force (29), the force applied to
# both atoms and the energy summed (11)
OPS_PER_PAIR = 80.0
# kernels 2-3, per atom and axis: fractional coordinate, base and the
# order-5 weights by recursion (55), with their derivatives (60)
OPS_WEIGHTS, OPS_WEIGHTS_DW = 55.0, 60.0
# kernel 2, per atom: q wx (5), then x wy (25), then x wz (125) products and
# 125 additions into the grid
OPS_SPREAD = 5.0 + 25.0 + 125.0 + 125.0
# kernel 3, per atom, contracted one axis at a time: over y, the weights and
# their derivatives against 25 rows of 5 (2 x 25 x 5 FMAs); over x, the three
# sums the forces need (3 x 5 x 5 FMAs); over z (3 x 5 FMAs); then the chain
# rule to Cartesian forces (21)
OPS_GATHER = 2 * (2 * 25 * 5 + 3 * 5 * 5 + 3 * 5) + 21.0


def kernel_bounds(inp) -> dict:
    """{name: (bound ms, "bytes" or "operations")}: the larger of the bytes
    each function must move (each input read once, each output written
    once) over HBM bandwidth and the float operations it needs over the
    float32 peak. Kernel 1 counts the distinct pairs inside the cutoff that
    these inputs have (each counted once, not from both atoms)."""
    pos4, par4, cand, count, words, consts = inp["tiles"]
    n = inp["pos"].shape[0]
    nx, ny, nz = inp["grid"]
    g = nx * ny * nz
    _, inside = tile_pairs.count_tile_pairs(pos4, cand, count, words, consts)
    tiles_in = sum(t.numel() * t.element_size()
                   for t in (pos4, par4, cand, count, words, consts))
    tiles_out = 4 * pos4.numel()              # (n_pad, 4) float32: f, e
    work = {
        "nonbonded_tiles": (tiles_in + tiles_out,
                            OPS_PER_PAIR * inside / 2),
        # in: positions (3 n), charges (n), binv; out: the grid
        "pme_spread": (4 * (4 * n + 9 + g),
                       n * (3 * OPS_WEIGHTS + OPS_SPREAD)),
        # in: positions, charges, binv, the grid; out: forces (3 n)
        "pme_gather": (4 * (4 * n + 9 + g + 3 * n),
                       n * (3 * OPS_WEIGHTS_DW + OPS_GATHER)),
    }
    out = {}
    for name, (nbytes, flops) in work.items():
        t_bytes = nbytes / PEAK_BYTES_S * 1e3
        t_ops = flops / PEAK_FP32_FLOPS * 1e3
        out[name] = ((t_bytes, "bytes") if t_bytes >= t_ops
                     else (t_ops, "operations"))
    return out


def phase_timing(device, inp, launches, errors, deadline) -> list:
    calls = _kernel_calls(inp)
    bounds = kernel_bounds(inp)
    flat, val = pme_zslab.spread_terms(inp["pos"], inp["charge"],
                                       inp["binv"], inp["grid"])
    nx, ny, nz = inp["grid"]
    q_flat = torch.zeros(nx * ny * nz, dtype=torch.float32, device=device)
    library = {"pme_spread": lambda: q_flat.zero_().index_add_(0, flat, val)}
    records = []
    for kern in KERNELS:
        kernel, plain = calls[kern.name]
        lib = library.get(kern.name)
        records.append({
            "name": kern.name, "route": "cuda", "source": kern.source,
            "replaces": kern.replaces, "launches": launches[kern.name],
            "max_abs_err": errors[kern.name],
            "ms": _time_ms(kernel, device),
            "plain_ms": _time_ms(plain, device),
            "bound_ms": bounds[kern.name][0],
            "bound_by": bounds[kern.name][1],
            "library_ms": _time_ms(lib, device) if lib else None,
        })
        deadline.check("timing: %s" % kern.name)
    return records


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; none is "
                           "visible to torch")
    deadline = Deadline(BUDGET_S)
    device = torch.device("cuda", 0)
    info = phase_device(device)
    deadline.check("device")
    phase_build(deadline)
    deadline.check("build")
    inp = kernel_inputs(device, N_WATERS)
    errors = phase_kernels(device, inp, deadline)
    for kern in KERNELS:
        kern.launches = 0
    result = phase_main_path(device, deadline=deadline)
    launches = {k.name: k.launches for k in KERNELS}
    print("main path launches: %s" % json.dumps(launches))
    if min(launches.values()) <= 0:
        raise RuntimeError("a kernel of the main path never launched: %s"
                           % launches)
    records = phase_timing(device, inp, launches, errors, deadline)
    print("main path: %.2f ns/day on %s (%s), %d steps of %.3f ps" % (
        result["ns_day"], info["name"], info["smi"], PRODUCTION_STEPS,
        DT_PS))
    print("total %.1f s of the %.0f s budget" % (deadline.elapsed(),
                                                 BUDGET_S))
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["name"], "count": info["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
