"""openmm_tpu_torch.parallel against tests/test_parallel.py: the port's
counterparts of its six cases, on gloo ranks that
openmm_tpu_torch/parallel/ranks.py starts (processes that import the port
and torch only; their inputs and results cross as numpy), against the
JAX package on its virtual 8-device mesh (`mesh8`) at test_parallel.py's
own tolerances, and against the port's single-rank results in bits with
D = 2 and 4 ranks (the distributed FFT with 2, 4 and 8). Beside them:
kernel 1's plain row-brick ranges put together are the whole sweep in
bits, in every mode and the derivative instantiation; D ranks give the
single-rank dE/dlambda through a NonbondedForce's offsets in bits; every rank holds
the single-rank positions in bits after 10 LangevinMiddle steps; the
all-pairs sweep splits by chunks with the single-rank bits; make_mesh
refuses a size other than its group's, and a gloo mesh refuses a graph
capture. One start of 8 ranks (subgroups of 2 and 4) serves the file,
beside the JAX references."""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import openmm_tpu as mm
from openmm_tpu.models import tip3p_water_box as jax_water_box
from openmm_tpu.ops import pairs as jpairs
from openmm_tpu.parallel import make_mesh as jax_make_mesh
from openmm_tpu.parallel import set_default_mesh as jax_set_default_mesh

from openmm_tpu_torch.forces.nonbonded import NonbondedForce
from openmm_tpu_torch.models import tip3p_water_box
from openmm_tpu_torch.ops import tile_pairs as tp
from openmm_tpu_torch.parallel import ranks
from openmm_tpu_torch.parallel.mesh import row_split
from openmm_tpu_torch.unit import plain

from helpers import reference_platform
from test_pallas_kernel import ALPHA, CUTOFF, water_like

torch.set_num_threads(1)

SIZES = (2, 4)
FFT_SIZES = (2, 4, 8)
GROUPS = {2: [0, 1], 4: [0, 1, 2, 3], 8: None}
FFT_SHAPE = (16, 16, 12)
PME_GRID = (16, 16, 16)
TILE_MOLECULES = 729
DROPLET = dict(n_waters=1331, method="droplet", cutoff=1.71)


def _pme_kernel():
    """q and the spectral kernel Kt of test_parallel.py's PME case, and
    the z-slab convolution's (phi, energy) from the JAX package."""
    from openmm_tpu.constants import ONE_4PI_EPS0
    from openmm_tpu.ops import geometry as geom
    from openmm_tpu.ops import pme as pme_mod
    from openmm_tpu.ops.pme_zslab import convolve_potential
    rng = np.random.RandomState(1)
    grid = PME_GRID
    box = jnp.asarray(np.diag([2.0, 2.0, 2.0]).astype(np.float32))
    q = jnp.asarray(rng.randn(*grid).astype(np.float32))
    md = pme_mod.make_pme_recip_data(grid, 5)
    bx, by, bz = (jnp.asarray(md[k].astype(np.float32))
                  for k in ("bsq_x", "bsq_y", "bsq_z"))
    alpha = 3.0
    phi_ref, e_ref = convolve_potential(q, box, grid, alpha, bx, by, bz)
    nx, ny, nz = grid
    f32 = jnp.float32
    bi = geom.box_inverse(box).astype(f32)
    vol = geom.box_volume(box).astype(f32)
    mx = jnp.fft.fftfreq(nx, 1.0 / nx).astype(f32)
    my = jnp.fft.fftfreq(ny, 1.0 / ny).astype(f32)
    mz = jnp.fft.fftfreq(nz, 1.0 / nz).astype(f32)
    kv = (mz[:, None, None, None] * bi.T[None, None, None, 2, :]
          + mx[None, :, None, None] * bi.T[None, None, None, 0, :]
          + my[None, None, :, None] * bi.T[None, None, None, 1, :])
    m2 = jnp.sum(kv * kv, axis=-1)
    m2s = jnp.where(m2 > 0, m2, 1.0)
    kern = jnp.where(m2 > 0,
                     jnp.exp(-(math.pi ** 2) * m2s / alpha ** 2) / m2s, 0.0)
    b = (bz[:, None, None] * bx[None, :, None] * by[None, None, :]).astype(f32)
    kt = (ONE_4PI_EPS0 / (2.0 * math.pi * vol)) * kern * b
    return (np.asarray(q), np.asarray(kt), np.asarray(phi_ref),
            float(e_ref))


def _tile_inputs():
    pos, box, q, sig, eps, _, n = water_like(n_mol=TILE_MOLECULES)
    pairs = [(3 * m + a, 3 * m + b) for m in range(TILE_MOLECULES)
             for a, b in ((0, 1), (0, 2), (1, 2))]
    nb = tp.pad_to_block(n, tp.BRICK) // tp.BRICK
    return dict(pos=pos[:n], box=box, charge=q[:n], sigma=sig[:n],
                epsilon=eps[:n],
                exclusions=np.asarray(jpairs.build_exclusion_table(n, pairs)),
                cutoff=CUTOFF, alpha=ALPHA, max_bricks=nb,
                sort_cell=0.6 * (64 * box[0, 0] ** 3 / n) ** (1 / 3))


def _tasks(fft_q, fft_kernel, pme_q):
    tasks = []
    for d in SIZES:
        first = d == SIZES[0]
        tasks += [
            ("water_box", dict(n_waters=27, platform="CPU",
                               precision="double", steps=10, eager=False,
                               reference=first), GROUPS[d]),
            ("water_box", dict(n_waters=512, precision="double",
                               reference=first), GROUPS[d]),
            ("water_box", dict(n_waters=512, reference=first), GROUPS[d]),
            ("tiles", dict(_tile_inputs(), reference=first), GROUPS[d]),
            ("offsets_derivative", dict(n_waters=512, reference=first),
             GROUPS[d])]
    tasks.append(("water_box", dict(DROPLET, reference=True), GROUPS[2]))
    for d in FFT_SIZES:
        tasks += [("fft", dict(q=fft_q), GROUPS[d]),
                  ("fft", dict(q=pme_q, kernel=fft_kernel), GROUPS[d])]
    tasks.append(("mesh_checks", {}, None))
    return tasks


@pytest.fixture(scope="module")
def runs():
    """The ranks' results by task, beside the JAX package's mesh8
    results."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    fft_q = np.random.RandomState(0).randn(*FFT_SHAPE).astype(np.float32)
    pme_q, kt, phi_dense, e_dense = _pme_kernel()
    tasks = _tasks(fft_q, kt, pme_q)
    started = ranks.Ranks(8, tasks)
    try:
        jax_out = _jax_mesh8(fft_q, pme_q, kt)
    except BaseException:
        started.kill()
        raise
    jax_out.update(phi_dense=phi_dense, e_dense=e_dense)
    results = started.join(timeout=300)
    by_task = {}
    for i, (name, kwargs, group) in enumerate(tasks):
        size = 8 if group is None else len(group)
        which = ("droplet" if kwargs.get("method") == "droplet"
                 else kwargs.get("n_waters"))
        key = (name, which, "kernel" in kwargs,
               kwargs.get("precision", "mixed"), size)
        by_task[key] = [r[i] for r in results if r[i] is not None]
    return {"tasks": by_task, "jax": jax_out, "fft_q": fft_q,
            "pme_q": pme_q, "modules": [r[-1]["modules"] for r in results]}


def _jax_mesh8(fft_q, pme_q, kt):
    from openmm_tpu.ops import pallas_pairs as PP
    from openmm_tpu.parallel import fft as pfft
    mesh8 = jax_make_mesh(8)
    out = {}
    try:
        jax_set_default_mesh(mesh8)
        for n_waters in (27, 512):
            system, positions = jax_water_box(n_waters=n_waters)
            ctx = mm.Context(system, mm.VerletIntegrator(0.001),
                             reference_platform())
            ctx.setPositions(positions)
            st = ctx.getState(getEnergy=True, getForces=True)
            out[n_waters] = (st.getPotentialEnergy()._value,
                             np.asarray(st.getForces(asNumpy=True)._value))
    finally:
        jax_set_default_mesh(None)
    q = jnp.asarray(fft_q)
    out["fft"] = np.asarray(pfft.fft3_zsharded(mesh8, q))
    phi, e = pfft.pme_convolve_sharded(mesh8, jnp.asarray(pme_q),
                                       jnp.asarray(kt))
    out["convolve"] = (np.asarray(phi), float(e))
    pos, box, q, sig, eps, excl, n = water_like(n_mol=TILE_MOLECULES)
    e, f, o = PP.direct_ef_pallas(
        jnp.asarray(pos), jnp.asarray(box), jnp.asarray(q), jnp.asarray(sig),
        jnp.asarray(eps), jnp.asarray(excl), n, CUTOFF, max_cols=64,
        mode=PP.MODE_EWALD, alpha=ALPHA, sort_cell=0.7, interpret=True,
        mesh=mesh8)
    assert int(o) == 0
    out["tiles"] = (float(e), np.asarray(f)[:n])
    return out


def _run(runs, name, which, d, precision="mixed", kernel=False):
    return runs["tasks"][(name, which, kernel, precision, d)]


def _single(runs, name, which, precision="mixed", kernel=False):
    return _run(runs, name, which, SIZES[0], precision, kernel)[0]["single"]


def _assert_same_rows(results, single, keys=("energy", "forces")):
    """Every rank's results of the mesh equal the single-rank ones in
    bits."""
    for r in results:
        for key in keys:
            np.testing.assert_array_equal(r["mesh"][key], single[key],
                                          err_msg=key)


@pytest.mark.parametrize("d", SIZES)
def test_sharded_energy_matches_single(runs, d):
    """27 waters at PME in float64: D ranks give the single-rank energy
    and forces in bits, and JAX's mesh8 "Reference" result at
    test_parallel.py's bars (1e-8 relative, 1e-6 absolute)."""
    single = _single(runs, "water_box", 27, "double")
    got = _run(runs, "water_box", 27, d, "double")
    assert len(got) == d
    _assert_same_rows(got, single)
    e_jax, f_jax = runs["jax"][27]
    e, f = got[0]["mesh"]["energy"], got[0]["mesh"]["forces"]
    assert abs(e - e_jax) < 1e-8 * max(abs(e_jax), 1.0), (e, e_jax)
    assert np.max(np.abs(f - f_jax)) < 1e-6
    assert [r["mesh"]["bricks"] for r in got] == [
        row_split(6, k, d) for k in range(d)]


@pytest.mark.parametrize("d", SIZES)
def test_sharded_dynamics_runs(runs, d):
    """10 LangevinMiddle steps through the step program on D ranks: every
    rank's positions and energy are the single-rank run's bits, and the
    energy is finite."""
    single = _single(runs, "water_box", 27, "double")
    got = _run(runs, "water_box", 27, d, "double")
    _assert_same_rows(got, single, ("positions", "energy_after"))
    assert np.isfinite(got[0]["mesh"]["energy_after"])
    start = tip3p_water_box(27)[1]
    assert np.abs(got[0]["mesh"]["positions"] - start).max() > 1e-4


@pytest.mark.parametrize("d", SIZES)
def test_sharded_neighbor_hot_path_matches_single(runs, d):
    """512 waters (1,536 atoms): D ranks each sweep their row bricks
    through kernel 1's plain version and give the single-rank bits, at
    the port's default precision (float32 pairs) and in float64; the
    float64 result against JAX's mesh8 float64 ("Reference") result at
    test_parallel.py's bars (energy 1e-5 relative, forces 1e-6 of the
    largest). (JAX's case takes its "CPU" platform, whose float32 sweep
    is held there to its own single-device sweep; across the packages
    the float32 sweeps' difference is their rounding, so the bars hold
    between the float64 ones.)"""
    for precision in ("mixed", "double"):
        _assert_same_rows(_run(runs, "water_box", 512, d, precision),
                          _single(runs, "water_box", 512, precision))
    got = _run(runs, "water_box", 512, d, "double")
    e_jax, f_jax = runs["jax"][512]
    e, f = got[0]["mesh"]["energy"], got[0]["mesh"]["forces"]
    scale = np.abs(f_jax).max()
    assert abs(e - e_jax) < 1e-5 * max(abs(e_jax), 1.0), (e, e_jax)
    assert np.max(np.abs(f - f_jax)) < 1e-6 * scale


@pytest.mark.parametrize("d", SIZES)
def test_sharded_parameter_derivative_matches_single(runs, d):
    """dE/dlambda through a NonbondedForce's charge offsets (the
    alchemical water box of 512 waters: kernel 1's derivative
    instantiation, whose plain version gives column 3 of its rows as the
    kernel does, a strided view) on D ranks: the single-rank energy and
    derivative in bits."""
    got = _run(runs, "offsets_derivative", 512, d)
    single = _single(runs, "offsets_derivative", 512)
    assert len(got) == d
    _assert_same_rows(got, single, keys=("energy", "derivative"))
    assert math.isfinite(single["derivative"]) and single["derivative"] != 0


@pytest.mark.parametrize("d", FFT_SIZES)
def test_distributed_fft_matches_fftn(runs, d):
    """fft3_zsharded on D ranks, the x-columns put together: numpy's
    fftn and the JAX mesh8 spectrum at 1e-3 of the largest, and the
    round trip through ifft3_to_zsharded at 1e-5."""
    q = runs["fft_q"]
    got = _run(runs, "fft", None, d)
    assert len(got) == d
    spec = np.concatenate([r["spectrum"] for r in got], axis=1)
    ref = np.fft.fftn(q.astype(np.float64))
    assert np.abs(spec - ref).max() < 1e-3 * np.abs(ref).max()
    assert np.abs(spec - runs["jax"]["fft"]).max() < 1e-3 * np.abs(ref).max()
    back = np.concatenate([r["back"] for r in got], axis=0)
    assert np.abs(back - q).max() < 1e-5


@pytest.mark.parametrize("d", FFT_SIZES)
def test_pme_convolve_sharded_matches_dense(runs, d):
    """pme_convolve_sharded on D ranks: the JAX z-slab convolution's and
    the JAX mesh8 twin's energy and potential at 1e-3; every rank holds
    the same energy bits."""
    got = _run(runs, "fft", None, d, kernel=True)
    phi = np.concatenate([r["phi"] for r in got], axis=0)
    energies = {r["energy"] for r in got}
    assert len(energies) == 1
    e = energies.pop()
    phi_jax, e_jax = runs["jax"]["convolve"]
    for phi_ref, e_ref in ((runs["jax"]["phi_dense"], runs["jax"]["e_dense"]),
                           (phi_jax, e_jax)):
        assert abs(e - e_ref) < 1e-3 * max(1.0, abs(e_ref))
        assert np.abs(phi - phi_ref).max() < 1e-3 * np.abs(phi_ref).max()


@pytest.mark.parametrize("d", SIZES)
def test_tile_kernel_sharded(runs, d):
    """Kernel 1's plain version over row bricks split on D ranks (729
    waters in float32, Ewald): the single-rank bits (test_parallel.py
    holds JAX's sharded sweep to its single one at 1e-4 and 1e-5 of the
    largest force); against JAX's Pallas tile kernel (interpret mode)
    sharded over row blocks on mesh8, the energy at test_parallel.py's
    1e-4 and the forces at the bar that holds between the two packages'
    float32 sweeps, 1e-4 of the largest (tests/test_torch_tile_pairs.py):
    JAX's float32 forces here lie 2.1e-5 of the largest from the float64
    sweep, the port's 2.0e-5."""
    single = _single(runs, "tiles", None)
    got = _run(runs, "tiles", None, d)
    assert got[0]["overflow"] == 0
    _assert_same_rows(got, single)
    e_jax, f_jax = runs["jax"]["tiles"]
    e, f = got[0]["mesh"]["energy"], got[0]["mesh"]["forces"]
    assert abs(e - e_jax) < 1e-4 * max(1.0, abs(e_jax)), (e, e_jax)
    assert np.abs(f - f_jax).max() < 1e-4 * max(1.0, np.abs(f_jax).max())


def test_all_pairs_sweep_sharded_by_chunks(runs):
    """A NoCutoff droplet of ~2,100 atoms (two chunks of
    ops/pairs.py:pair_energy_forces_n2) on 2 ranks, one chunk each: the
    single-rank energy and forces in bits."""
    got = _run(runs, "water_box", "droplet", 2)
    single = got[0]["single"]
    assert single["forces"].shape[0] > 2048
    _assert_same_rows(got, single)


def test_mesh_size_check_and_gloo_capture_refusal(runs):
    """make_mesh raises when asked for another size than its group's, and
    a gloo mesh refuses a CUDA graph capture, naming the backend."""
    got = _run(runs, "mesh_checks", None, 8)
    assert len(got) == 8
    for r in got:
        assert "of 8 ranks" in r["size"]
        assert "gloo" in r["capture"] and "_step_eager" in r["capture"]
        assert r["same_size"] == 8


def test_ranks_import_no_jax(runs):
    """The spawned ranks load neither JAX nor the JAX package."""
    assert runs["modules"] == [[]] * 8


@pytest.fixture(scope="module")
def tile_cases():
    """Kernel 1's inputs on 125 waters in each mode: (name, fn, args),
    fn(*args, bricks) the plain version."""
    cases = []
    for method, mode in ((NonbondedForce.PME, tp.MODE_EWALD),
                         (NonbondedForce.CutoffPeriodic, tp.MODE_RF),
                         (NonbondedForce.LJPME, tp.MODE_LJPME)):
        from openmm_tpu_torch.forces.nonbonded import NonbondedModule
        system, pos = tip3p_water_box(125, method, cutoff=0.6)
        box = plain(system.getDefaultPeriodicBoxVectors())
        module = NonbondedModule(system.getForce(0), box, torch.device("cpu"))
        pos_t, box_t = torch.as_tensor(pos), torch.as_tensor(box)
        st = module.build_state(pos_t, box_t)
        consts = tp.tile_consts(box_t.float(), module.tile_scalars)
        pos4 = tp.sorted_positions(pos_t, box_t, st)
        tables = (st["cand"], st["count"], st["words"], consts)
        name = {tp.MODE_EWALD: "ewald", tp.MODE_RF: "rf",
                tp.MODE_LJPME: "ljpme"}[mode]
        cases.append((name, lambda *a, fine=None: tp.nonbonded_tiles_plain(
            *a[:-1], pos_lo=fine, bricks=a[-1]),
            (pos4, st["par4"]) + tables + (mode, module.use_switch), None))
        if mode == tp.MODE_EWALD:
            hi, lo = tp.sorted_positions_fine(pos_t, box_t, st)
            cases.append(("fine", lambda *a, fine=None:
                          tp.nonbonded_tiles_plain(*a[:-1], pos_lo=fine,
                                                   bricks=a[-1]),
                          (hi, st["par4"]) + tables
                          + (mode, module.use_switch), lo))
            rng = np.random.RandomState(3)
            dpar4 = torch.as_tensor(rng.randn(*st["par4"].shape),
                                    dtype=torch.float32)
            cases.append(("deriv", lambda *a, fine=None:
                          tp.nonbonded_tiles_deriv_plain(*a),
                          (pos4, st["par4"], dpar4) + tables
                          + (mode, module.use_switch), None))
    return {c[0]: c[1:] for c in cases}


@pytest.mark.parametrize("name", ["ewald", "rf", "ljpme", "fine", "deriv"])
def test_plain_row_ranges_assemble_the_whole_sweep(tile_cases, name):
    """Kernel 1's plain version on the row-brick ranges of D = 2, 3, 4, 8
    ranks (the rows outside a range 0), added as integers as a mesh
    gathers them: the whole sweep in bits, in each mode, with float32
    pairs and in the derivative instantiation. The derivative comes in
    the kernel's layout, column 3 of (n_pad, 4) rows (a strided view,
    which a gather must copy)."""
    fn, args, fine = tile_cases[name]
    n_bricks = args[0].shape[0] // tp.BRICK
    whole = fn(*args, None, fine=fine)
    assert torch.count_nonzero(whole) > 0
    if name == "deriv":
        assert whole.shape == (args[0].shape[0],) and whole.stride() == (4,)
    for d in (2, 3, 4, 8):
        total = torch.zeros_like(whole).view(torch.int32)
        for rank in range(d):
            bricks = row_split(n_bricks, rank, d)
            part = fn(*args, bricks, fine=fine)
            outside = torch.ones(part.shape[0], dtype=torch.bool)
            outside[bricks[0] * tp.BRICK:bricks[1] * tp.BRICK] = False
            assert not part[outside].any()
            total += part.view(torch.int32)
        assert torch.equal(total.view(whole.dtype), whole), d
    with pytest.raises(ValueError):
        fn(*args, (2, n_bricks + 1), fine=fine)


def test_dryrun_entry_point():
    """python -m openmm_tpu_torch.parallel.dryrun 2 on the CPU: the
    512-water box on 2 gloo ranks passes JAX's gates and the port's bit
    equality, before and after one step, and exits 0."""
    import json
    import os
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-m", "openmm_tpu_torch.parallel.dryrun", "2"],
        cwd=repo, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["ok"] and all(out["gates"].values())
    assert out["bricks"] == [[0, 48], [48, 96]]


def test_context_off_the_nccl_rank_device_raises():
    """A Context built under an NCCL mesh must sit on the card its rank
    drives (DeviceIndex = the local rank): one on another device raises
    at construction, and none is left installed."""
    import openmm_tpu_torch as omm
    from openmm_tpu_torch.parallel import get_default_mesh, set_default_mesh
    from openmm_tpu_torch.parallel.mesh import Mesh
    system, _ = tip3p_water_box(27)
    set_default_mesh(Mesh(None, 0, 1, "nccl", torch.device("cuda", 0)))
    try:
        with pytest.raises(ValueError, match="DeviceIndex"):
            omm.Context(system, omm.VerletIntegrator(0.001), "CPU")
    finally:
        set_default_mesh(None)
    assert get_default_mesh() is None
