"""What decides `correct`: the reporters' files and the final state that
the timed path produced, read back and compared with the plain reference.

Numbers compared (each against the configuration's limit):
- energy_err: the largest |E_reported - E_ref| / |E_ref| over the sampled
  report intervals (the StateDataReporter's potential energy against the
  reference's energy of the DCD frame written at the same step, at its box)
  and the final state;
- force_err: the median over atoms of |F - F_ref| / |F_ref| at the final
  state (the Context's forces at its positions and box);
- constraint_err: the largest relative deviation of a constrained distance
  at the final state's positions;
- kinetic_err: |KE_reported - KE_ref| / KE_ref at the last report, the
  reference's 0.5 sum m v^2 of the final velocities;
- step_force_err and noise_dev, from two consecutive states of the timed
  path (one more Simulation.step(1) after the window, through the same
  captured step): LangevinMiddle moves x by dt (v + v_o) / 2 + c and sets
  the velocity to v_o + c / dt, with v = P(v_prev + dt F / m) the kicked
  and constrained velocity, v_o = a v + s xi / sqrt(m) after the
  thermostat, and c the position constraints' correction along the bonds
  at x (reference.Constraints.project: P removes it and the velocity
  constraints' correction). So P(2 dx / dt - v_next - v_prev) / dt =
  P M^-1 F: the forces that the step itself kicked with, free of the
  noise, at the configuration's dt. step_force_err is the RMS of
  M P M^-1 (F_step - F_ref) over the RMS of M P M^-1 F_ref, F_ref the
  reference's forces at x. And dx / dt - v_next = (v - v_o) / 2 gives
  the thermostat's normals xi; noise_dev is |mean xi^2 - 1| over every
  degree of freedom;
- frozen_frames: consecutive frames of the window whose RMS displacement is
  below FROZEN_NM (a step that leaves the state unchanged), limit 0;
- t_mean_dev: |mean reported temperature over the window - the bath's| /
  the bath's, the configuration's band;
- at constant pressure, volume_dev (the largest |V / V_start - 1| over
  the window's frames) and xy_aspect_drift (the largest change of the
  box's x / y ratio, which XYIsotropic keeps), the configuration's limits.
"""
from __future__ import annotations

import csv
import math
import struct

import numpy as np

FROZEN_NM = 1e-5


def read_state_data(path) -> list[dict]:
    """The StateDataReporter's rows: {column name: float}."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    header = [h.lstrip("#").strip('"') for h in rows[0]]
    return [{h: float(v) for h, v in zip(header, r)} for r in rows[1:] if r]


def read_dcd(path):
    """(positions (frames, n, 3) float32 nm, boxes (frames, 3) float64 nm)
    of a DCD with unit-cell records and rectangular cells."""
    with open(path, "rb") as f:
        data = f.read()
    n_frames = struct.unpack_from("<i", data, 8)[0]
    off = 4 + 84 + 4
    (title_len,) = struct.unpack_from("<i", data, off)
    off += 4 + title_len + 4
    off += 4
    (n,) = struct.unpack_from("<i", data, off)
    off += 4 + 4
    frame_bytes = (4 + 48 + 4) + 3 * (4 + 4 * n + 4)
    n_frames = min(n_frames, (len(data) - off) // frame_bytes)
    pos = np.empty((n_frames, n, 3), np.float32)
    boxes = np.empty((n_frames, 3))
    for k in range(n_frames):
        base = off + k * frame_bytes
        a, _, b, _, _, c = struct.unpack_from("<6d", data, base + 4)
        boxes[k] = (a / 10.0, b / 10.0, c / 10.0)
        p = base + 56
        for axis in range(3):
            pos[k, :, axis] = np.frombuffer(data, "<f4", n, p + 4)
            p += 8 + 4 * n
    return pos / 10.0, boxes


def frozen_frames(frames, boxes) -> int:
    """Consecutive frames whose RMS displacement (minimum images) is below
    FROZEN_NM."""
    count = 0
    for k in range(1, len(frames)):
        d = frames[k].astype(float) - frames[k - 1]
        d -= boxes[k] * np.round(d / boxes[k])
        if math.sqrt(float(np.mean(np.sum(d * d, axis=1)))) < FROZEN_NM:
            count += 1
    return count


def step_numbers(tables, config, step, f_ref, reference) -> dict:
    """step_force_err and noise_dev of `step` (x0, v0, x1, v1 (n, 3) nm
    and nm/ps, widths, the step count at x0) against f_ref, the
    reference's forces at x0, for the configuration's LangevinMiddle
    (step_fs, friction_per_ps, temperature_K) and CMMotionRemover."""
    import torch
    t = (lambda a: torch.as_tensor(np.array(a, float),
                                   dtype=torch.float64))
    x0, v0, x1, v1 = (t(step[k]) for k in ("x0", "v0", "x1", "v1"))
    widths, f_ref = t(step["widths"]), t(f_ref)
    cons = reference.Constraints(tables, "cpu")
    m = cons.m[:, None]
    dt = float(config["step_fs"]) * 1e-3
    freq = int(tables["cmm_frequency"])
    if freq > 0 and int(step["step"]) % freq == 0:
        v0 = v0 - (m * v0).sum(0) / m.sum()
    dx = x1 - x0
    dx = dx - widths * torch.round(dx / widths)
    kick = cons.project(x0, (2.0 * dx / dt - v1 - v0) / dt, widths)
    want = cons.project(x0, f_ref / m, widths)
    err = float(torch.sqrt(((m * (kick - want)) ** 2).sum()
                           / ((m * want) ** 2).sum()))
    a = math.exp(-float(config["friction_per_ps"]) * dt)
    s = math.sqrt(reference.GAS_CONSTANT * float(config["temperature_K"])
                  * (1.0 - a * a))
    vk = cons.project(x0, v0 + dt * f_ref / m, widths)
    xi = torch.sqrt(m) * ((1.0 - a) * vk - 2.0 * (dx / dt - v1)) / s
    return {"step_force_err": err,
            "noise_dev": abs(float((xi * xi).mean()) - 1.0)}


def numbers(tables, config, out, reference) -> dict:
    """The numbers compared, from `out` (what the program handed back: see
    harness.outputs) and `reference` (reference.classical's module, for its
    ClassicalForceField at float64 on out["device"])."""
    ff = reference.ClassicalForceField(tables, out["device"])
    got = {}
    errs = []
    for step, pe, positions, widths in out["sampled"]:
        e_ref = ff.energy(positions, np.diag(widths))
        errs.append(abs(pe - e_ref) / abs(e_ref))
    final = out["final"]
    e_ref, f_ref = ff.energy_forces(final["positions"], final["box"])
    errs.append(abs(final["energy"] - e_ref) / abs(e_ref))
    got["energy_err"] = max(errs)
    out["sampled_errs"] = errs[:-1]
    rel = (np.linalg.norm(final["forces"] - f_ref, axis=1)
           / np.maximum(np.linalg.norm(f_ref, axis=1), 1e-30))
    got["force_err"] = float(np.median(rel))
    got["constraint_err"] = reference.constraint_error(
        tables, final["positions"], final["box"])
    ke_ref = reference.kinetic_energy(tables, final["velocities"])
    got["kinetic_err"] = abs(out["last_kinetic"] - ke_ref) / ke_ref
    step = out["step"]
    if not np.allclose(step["widths"], np.diag(final["box"]), rtol=0,
                       atol=0) or not np.array_equal(step["x0"],
                                                     final["positions"]):
        raise RuntimeError("the step pair does not start at the final "
                           "state")
    got.update(step_numbers(tables, config, step, f_ref, reference))
    got["frozen_frames"] = frozen_frames(out["frames"], out["frame_boxes"])
    temps = [r["Temperature (K)"] for r in out["rows"]]
    bath = float(config["temperature_K"])
    got["t_mean_dev"] = abs(float(np.mean(temps)) - bath) / bath
    if out["barostat"]:
        vol = np.prod(out["frame_boxes"], axis=1)
        v0 = float(np.prod(out["start_widths"]))
        got["volume_dev"] = float(np.max(np.abs(vol / v0 - 1.0)))
        aspect = out["frame_boxes"][:, 0] / out["frame_boxes"][:, 1]
        a0 = out["start_widths"][0] / out["start_widths"][1]
        got["xy_aspect_drift"] = float(np.max(np.abs(aspect / a0 - 1.0)))
    return got


def control_outputs(tables, config, out, reference, seed) -> dict:
    """`out` with what the program computed replaced by the reference
    computed at TF32 (the control): the sampled energies, the final
    energy and forces, the final positions and velocities rounded, and
    the step after the final state taken by the reference's
    LangevinMiddle step in float32 with those TF32 forces and normals
    drawn from `seed`."""
    import torch
    ff = reference.ClassicalForceField(tables, out["device"], "tf32")
    tf32 = reference.Precision("tf32")

    def rounded(x):
        return tf32(torch.as_tensor(np.asarray(x), dtype=torch.float32)
                    ).double().numpy()

    ctl = dict(out)
    ctl["sampled"] = [(step, ff.energy(p, np.diag(w)), p, w)
                      for step, _, p, w in out["sampled"]]
    final = dict(out["final"])
    final["energy"], final["forces"] = ff.energy_forces(final["positions"],
                                                        final["box"])
    final["positions"] = rounded(final["positions"])
    final["velocities"] = rounded(final["velocities"])
    ctl["last_kinetic"] = reference.kinetic_energy(tables,
                                                   final["velocities"])
    final["velocities"] = out["final"]["velocities"]
    ctl["final"] = final
    step = dict(out["step"])
    t32 = (lambda a: torch.as_tensor(np.array(a), dtype=torch.float32))
    gen = torch.Generator().manual_seed(int(seed) & 0x7FFFFFFFFFFFFFFF)
    # the control's step starts from its own (rounded) final state
    step["x0"] = final["positions"]
    x0 = t32(step["x0"])
    xi = torch.randn(x0.shape, generator=gen, dtype=torch.float32)
    freq = int(tables["cmm_frequency"])
    x1, v1 = reference.langevin_middle_step(
        tables, x0, t32(step["v0"]), t32(step["widths"]),
        t32(final["forces"]), float(config["step_fs"]) * 1e-3,
        float(config["friction_per_ps"]), float(config["temperature_K"]),
        xi, freq > 0 and int(step["step"]) % freq == 0)
    step["x1"], step["v1"] = x1.double().numpy(), v1.double().numpy()
    ctl["step"] = step
    return ctl


def judge(got: dict, limits: dict) -> dict:
    """{name: (value, limit, within)} for each number that has a limit;
    a number without one is an error."""
    out = {}
    for name, value in got.items():
        if name not in limits:
            raise KeyError("no limit for %s" % name)
        limit = limits[name]
        ok = math.isfinite(value) and value <= limit
        out[name] = (float(value), limit, bool(ok))
    return out
