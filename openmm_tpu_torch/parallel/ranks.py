"""Ranks of a mesh in processes of their own.

`Ranks(n, tasks)` starts n fresh interpreters, `python -m
openmm_tpu_torch.parallel.ranks SPEC RANK`, that join one process group
(gloo by default, through a FileStore in a temporary directory), and
runs the listed tasks in each, in order; `join()` returns each rank's
results. A rank imports the package and torch only, and its arguments
and results are numpy arrays and Python numbers (pickled through files),
so a caller that has imported anything else (a test process with JAX,
the card's script) hands none of it to the ranks. What runs the
multi-rank checks: `python -m openmm_tpu_torch.parallel.dryrun N`, the
CPU tests, and chip_smoke.py's two ranks sharing a card, which are
forked children that run rank_main on a spec of write_spec.

A task is (name, kwargs, ranks): TASKS[name](mesh, **kwargs) on the ranks
listed (None: all; a sub-list runs on a group of its own, which every
rank creates in task order), the mesh built by make_mesh over that group.
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

_PACKAGE_PARENT = Path(__file__).resolve().parents[2]


def _water_system(n_waters, method, cutoff):
    from ..forces.nonbonded import NonbondedForce
    from ..models import tip3p_water_box, water_droplet
    if method == "droplet":
        system, pos = tip3p_water_box(n_waters)
        box = np.asarray(system._box, np.float64)
        return water_droplet(pos, box, radius=cutoff,
                             nonbonded_method=NonbondedForce.NoCutoff)
    return tip3p_water_box(n_waters, getattr(NonbondedForce, method),
                           cutoff=cutoff)


def water_box(mesh, n_waters=27, method="PME", cutoff=0.9, platform="CPU",
              precision="mixed", steps=0, eager=True, seed=1, dt=0.002,
              reference=False, refuse_capture=False) -> dict:
    """The water box (models.tip3p_water_box; method "droplet": a
    NoCutoff droplet of radius `cutoff`, models.water_droplet) in a
    Context on this rank's mesh: its energy and forces, then `steps`
    LangevinMiddle steps (300 K, 1/ps, `dt` ps, velocities of `seed`; the
    eager loop if `eager`, else the integrator's step) and the positions
    and energy after them, with kernel 1's launches in the steps.
    reference: the same without a mesh too, on the group's first rank.
    refuse_capture: first the mesh Context's step(1), which must raise on a mesh a graph cannot
    capture (its message recorded)."""
    import torch

    from .. import Context, LangevinMiddleIntegrator, Platform
    from ..ops import tile_pairs
    from .mesh import row_split, set_default_mesh
    system, positions = _water_system(n_waters, method, cutoff)
    plat = Platform.getPlatformByName(platform)
    props = {"Precision": precision}

    def run(m):
        set_default_mesh(m)
        try:
            integ = LangevinMiddleIntegrator(300.0, 1.0, dt)
            integ.setRandomNumberSeed(seed)
            ctx = Context(system, integ, plat, props)
        finally:
            set_default_mesh(None)
        ctx.setPositions(positions)
        out = {}
        if refuse_capture and m is not None:
            try:
                integ.step(1)
                out["capture"] = None
            except RuntimeError as e:
                out["capture"] = str(e)
        st = ctx.getState(getEnergy=True, getForces=True, getPositions=True)
        out["energy"] = float(st._pe)
        out["forces"] = np.asarray(st._forces, np.float64)
        ctx.setVelocitiesToTemperature(300.0, randomSeed=seed)
        tile_pairs.TILES.launches = 0
        t0 = time.perf_counter()
        if steps:
            (ctx._step_eager if eager else integ.step)(steps)
        if ctx._device.type == "cuda":
            torch.cuda.synchronize(ctx._device)
        out["ms_per_step"] = (time.perf_counter() - t0) * 1e3 / max(steps, 1)
        out["launches"] = tile_pairs.TILES.launches
        out["steps"] = steps
        st = (ctx.getState(getEnergy=True, getPositions=True) if steps
              else st)
        out["positions"] = np.asarray(st._positions, np.float64)
        out["energy_after"] = float(st._pe)
        if ctx._nonbonded is not None and ctx._nonbonded.periodic:
            nb = ctx._nonbonded
            n_bricks = tile_pairs.pad_to_block(nb.n, tile_pairs.BRICK) \
                // tile_pairs.BRICK
            out["bricks"] = (row_split(n_bricks, m.rank, m.size)
                             if m is not None else (0, n_bricks))
        return out

    result = {"mesh": run(mesh)}
    if reference and mesh.rank == 0:
        result["single"] = run(None)
    return result


def offsets_derivative(mesh, n_waters=512, n_solute=16, platform="CPU",
                       precision="mixed", reference=False) -> dict:
    """models.alchemical_water_box in a Context on this rank's mesh: the
    NonbondedForce group's energy and dE/dlambda_electrostatics (kernel
    1's derivative instantiation through the charges' offsets, its rows
    swept on this rank and gathered), with the derivative instantiation's
    launches. reference: without the mesh too, on the group's first
    rank."""
    from .. import Context, Platform, VerletIntegrator
    from ..models import alchemical_water_box
    from ..ops import tile_pairs
    from .mesh import set_default_mesh
    system, positions = alchemical_water_box(n_waters, n_solute)
    plat = Platform.getPlatformByName(platform)

    def run(m):
        set_default_mesh(m)
        try:
            ctx = Context(system, VerletIntegrator(0.001), plat,
                          {"Precision": precision})
        finally:
            set_default_mesh(None)
        ctx.setPositions(positions)
        tile_pairs.TILES_DERIV.launches = 0
        st = ctx.getState(getEnergy=True, getParameterDerivatives=True,
                          groups={0})
        return {"energy": float(st._pe),
                "derivative": float(st.getEnergyParameterDerivatives()[
                    "lambda_electrostatics"]),
                "launches": tile_pairs.TILES_DERIV.launches}

    out = {"mesh": run(mesh)}
    if reference and mesh.rank == 0:
        out["single"] = run(None)
    return out


def tiles(mesh, pos, box, charge, sigma, epsilon, exclusions, cutoff, alpha,
          max_bricks, sort_cell, mode=0, reference=False) -> dict:
    """Kernel 1's plain version on a candidate state of these arrays
    (float32), its rows split over the mesh and gathered: (energy, forces
    (n, 3)); reference: without the mesh too, on the group's first
    rank."""
    import torch

    from ..ops import tile_pairs as tp
    f32 = torch.float32
    t = {k: torch.as_tensor(v, dtype=f32) for k, v in (
        ("pos", pos), ("box", box), ("q", charge), ("sig", sigma),
        ("eps", epsilon))}
    st = tp.build_tile_state(t["pos"], t["box"], t["q"], t["sig"], t["eps"],
                             torch.as_tensor(exclusions), cutoff, max_bricks,
                             sort_cell)
    consts = tp.tile_consts(t["box"], torch.tensor(
        [alpha, cutoff ** 2, 0, 0, 0, 0], dtype=f32))

    def run(m):
        e, f = tp.tile_energy_forces(t["pos"], t["box"], st, consts, mode,
                                     False, mesh=m)
        return {"energy": float(e), "forces": f.double().numpy()}

    out = {"mesh": run(mesh), "overflow": int(st["overflow"])}
    if reference and mesh.rank == 0:
        out["single"] = run(None)
    return out


def fft(mesh, q, kernel=None) -> dict:
    """parallel/fft.py on this rank's block of the grid q (nz, nx, ny):
    its block of the spectrum and of the round trip back; with the
    spectral kernel (nz, nx, ny), its block of pme_convolve_sharded's
    potential and the energy."""
    import torch

    from . import fft as pfft
    d, r = mesh.size, mesh.rank
    nz, nx = q.shape[0], q.shape[1]
    q_local = torch.as_tensor(q[r * nz // d:(r + 1) * nz // d])
    spec = pfft.fft3_zsharded(mesh, q_local)
    back = pfft.ifft3_to_zsharded(mesh, spec)
    out = {"spectrum": spec.numpy(), "back": back.real.numpy()}
    if kernel is not None:
        k_local = torch.as_tensor(kernel[:, r * nx // d:(r + 1) * nx // d])
        phi, energy = pfft.pme_convolve_sharded(mesh, q_local, k_local)
        out["phi"], out["energy"] = phi.numpy(), float(energy)
    return out


def mesh_checks(mesh) -> dict:
    """make_mesh's refusal of a size other than the group's, and the
    refusal of a graph capture on a backend that cannot be captured: the
    messages raised."""
    from .mesh import make_mesh
    out = {}
    try:
        make_mesh(mesh.size + 1, group=mesh.group)
        out["size"] = None
    except ValueError as e:
        out["size"] = str(e)
    try:
        mesh.check_capture()
        out["capture"] = None
    except RuntimeError as e:
        out["capture"] = str(e)
    out["same_size"] = make_mesh(mesh.size, group=mesh.group).size
    return out


TASKS = {"water_box": water_box, "offsets_derivative": offsets_derivative,
         "tiles": tiles, "fft": fft, "mesh_checks": mesh_checks}


def write_spec(directory, n, tasks, backend="gloo", threads=1) -> str:
    """The spec file in `directory` from which rank_main runs a rank of n:
    the group's size, backend and FileStore, the intra-op threads and the
    tasks. Returns its path."""
    spec = os.path.join(directory, "spec.pickle")
    with open(spec, "wb") as f:
        pickle.dump({"size": n, "backend": backend, "threads": threads,
                     "store": os.path.join(directory, "store"),
                     "tasks": list(tasks)}, f)
    return spec


def out_path(spec_path, rank) -> str:
    """Where rank_main pickles rank `rank`'s results."""
    return os.path.join(os.path.dirname(spec_path), "out%d.pickle" % rank)


class Ranks:
    """n ranks started now, each `python -m openmm_tpu_torch.parallel.ranks`
    with `threads` intra-op threads; `env` adds to their environment.
    join() waits for them and returns, per rank, its list of task results
    (None where a task did not run on it); it raises with a rank's error
    output if one failed."""

    def __init__(self, n, tasks, backend="gloo", threads=1, env=None):
        self.n = n
        self.dir = tempfile.mkdtemp(prefix="omm_ranks_")
        self.spec = write_spec(self.dir, n, tasks, backend, threads)
        full_env = dict(os.environ, **(env or {}))
        self.procs = []
        for rank in range(n):
            log = open(os.path.join(self.dir, "log%d" % rank), "w")
            self.procs.append(subprocess.Popen(
                [sys.executable, "-m", "openmm_tpu_torch.parallel.ranks",
                 self.spec, str(rank)], cwd=str(_PACKAGE_PARENT),
                env=full_env,
                stdout=log, stderr=subprocess.STDOUT))
            log.close()

    def join(self, timeout=600.0) -> list:
        import shutil
        t0 = time.perf_counter()
        try:
            for rank, proc in enumerate(self.procs):
                left = max(timeout - (time.perf_counter() - t0), 0.1)
                proc.wait(left)
            for rank, proc in enumerate(self.procs):
                if proc.returncode != 0:
                    with open(os.path.join(self.dir, "log%d" % rank)) as f:
                        raise RuntimeError("rank %d of %d failed (exit %d):\n"
                                           "%s" % (rank, self.n,
                                                   proc.returncode,
                                                   f.read()[-4000:]))
            results = []
            for rank in range(self.n):
                with open(out_path(self.spec, rank), "rb") as f:
                    results.append(pickle.load(f))
            return results
        finally:
            self.kill()
            shutil.rmtree(self.dir, ignore_errors=True)

    def kill(self) -> None:
        for proc in self.procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def rank_main(spec_path, rank) -> None:
    """Rank `rank` of the spec at `spec_path` (write_spec): joins the
    process group, runs the tasks, and pickles its results and the
    modules of JAX or the JAX package it holds to out_path. The body of a
    Ranks process, and of a forked child that has the package imported
    already."""
    import torch
    import torch.distributed as dist

    from .mesh import make_mesh
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    torch.set_num_threads(spec["threads"])
    size = spec["size"]
    dist.init_process_group(spec["backend"],
                            init_method="file://" + spec["store"],
                            rank=rank, world_size=size)
    try:
        groups = {}
        for _, _, ranks in spec["tasks"]:
            key = None if ranks is None else tuple(ranks)
            if key is not None and key not in groups:
                groups[key] = dist.new_group(list(key))
        results = []
        for name, kwargs, ranks in spec["tasks"]:
            key = None if ranks is None else tuple(ranks)
            if key is not None and rank not in key:
                results.append(None)
                continue
            mesh = make_mesh(group=groups.get(key))
            results.append(TASKS[name](mesh, **kwargs))
        results.append({"modules": sorted(
            m for m in sys.modules
            if m.split(".")[0] in ("jax", "jaxlib", "openmm_tpu"))})
        out = out_path(spec_path, rank)
        with open(out + ".tmp", "wb") as f:
            pickle.dump(results, f)
        os.replace(out + ".tmp", out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    rank_main(sys.argv[1], int(sys.argv[2]))
