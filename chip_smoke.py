"""Smoke test of openmm_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the five CUDA kernels from csrc/ (an nvcc a source, in parallel),
holds each
kernel against its plain PyTorch version at the shapes of the paths that
run it (kernel 1 in both its modes, kernels 4-5 also on wider, dense and
wide-ranging inputs, kernels 1-3 also on the water box sheared into a
reduced triclinic one), checks
that every kernel gives the same bits on a second call, and that kernel 3
gives the same bits in the direct space's spatial order (the main path's),
in the user's order and in a random one; then it
drives two paths through the port's public entry points and checks what
comes out:

- the main path: a 24,000-atom TIP3P PME box (8,000 rigid waters, 0.9 nm
  cutoff) relaxed and stepped under LangevinMiddle (kernels 1-3), each
  step a replay of the Context's captured step program (a CUDA graph
  whose conditional node decides the candidate-state rebuild on the
  card); the same production steps are then run again from a copied
  snapshot through the eager loop the program replaced
  (Context._step_eager), which must give the same bits, the same rebuild
  steps and the same kernel launches, and a forced capacity overflow must
  be undone and redone by both alike;
- energy minimization of the same box from its lattice start with
  LocalEnergyMinimizer (kernel 1 and the dense PME spread, kernels 4-5),
  checked against the float64 objective and against the z-slab
  reciprocal forces;
- the 32,512-atom POPC bilayer (amber14-lipid + TIP3P, PME at 0.9 nm,
  HBonds: bonds, angles, torsions, 1-4 exceptions, a CMMotionRemover,
  SETTLE and SHAKE): kernels 1-3 at its shapes (a 60 x 60 x 70 grid),
  its float32 forces and per-group energies against float64, a minimize
  call, then MD through the step program, replayed from a snapshot
  through the eager loop for the same bits, with its ns/day;
- constant pressure: the bilayer from its minimized state under
  MonteCarloMembraneBarostat (1 bar, 0 bar nm, 303.15 K, XYIsotropic,
  ZFree, an attempt every 25 steps), 300 steps through the step program
  (each attempt under a second conditional node of the graph), the last
  25 replayed through the eager loop for the same bits, box and
  barostat statistics; the relaxed water box under MonteCarloBarostat
  (1 bar, 300 K, 25) and under MonteCarloAnisotropicBarostat (frequency
  5) the same way; each with its ns/day, attempts, acceptances, volume,
  and its float32 forces at the final box against float64;
- the other NonbondedForce methods (phase_method): the relaxed water box
  and the minimized bilayer at the reference suite's rf settings
  (CutoffPeriodic at 1.0 nm, reaction field: kernel 1 in MODE_RF against
  its plain version at their shapes, the bilayer's group energies), a
  droplet of the relaxed box (the waters within 2.5 nm of its centre, no
  box) at NoCutoff and at CutoffNonPeriodic 2.0 nm (every pair, plain
  PyTorch, as the JAX package runs them in plain XLA), and a 512-water
  box at Ewald (kernel 1 in MODE_EWALD and the exact k-sum): each its
  float32 forces against a float64 Context, steps through the step
  program replayed through the eager loop for the same bits, its ms a
  step and ns/day;
- the other integrators on the relaxed water box (PME, kernels 1-3
  counted; phase_integrators): Verlet at 1 fs for 3 ps with its NVE
  drift (kT/dof/ns, gated at 0.2 as tests/test_nve_drift.py) and its
  kinetic energy shifted by half a step and not; Verlet under an
  AndersenThermostat (300 K, 10/ps) from 250 K, its mean temperature
  over the last half of 500 steps within 270-330 K; leapfrog Langevin
  (300 K, 1/ps, 2 fs) and Brownian (300 K, 100/ps, 0.5 fs); each then 15
  steps from a snapshot through the step program and the eager loop,
  equal in bits;
- implicit solvent (phase_gbsa): a 2,546-atom cluster of 19 POPC lipids
  at the reference suite's dhfr_gbsa settings (GBSAOBCForce and the
  NonbondedForce at CutoffNonPeriodic 2.0 nm, every pair, plain PyTorch;
  HBonds; LangevinMiddle at 300 K, 1/ps, 2 fs): its float32 forces and
  group energies against float64, GB's analytic sweeps timed alone, a
  minimize call, 200 relaxation steps and 25 more replayed through the
  eager loop for the same bits, its ns/day;
- the integrators with control flow or state of their own: on the
  relaxed water box a CustomIntegrator velocity Verlet at 1 fs for 2 ps
  with a step counter, a kinetic-energy sum inside an if block every 10
  steps and a while block of 3 passes (conditional IF and WHILE nodes of
  the step graph; its drift gated at 0.2 kT/dof/ns, the sum against
  Context.kinetic_energy() to 1e-9), NoseHooverIntegrator (300 K, 10/ps,
  1 fs) from 250 K for 2,000 steps (the conserved quantity's drift, the
  mean temperature within 270-330 K), VariableLangevin and VariableVerlet
  at an error tolerance of 1e-3, 500 steps each (every step size in
  (0, maximum], the clock equal to their sum), and a CompoundIntegrator
  of LangevinMiddle and Verlet switched three times (the clock, one
  capture a member); on the minimized bilayer MTSLangevinIntegrator with
  the NonbondedForce in group 0 and the bonded forces in group 1 (kernel
  1 once a step) and AMDForceGroupIntegrator on the torsions (the boost
  active at every reading); each replays steps from a snapshot through
  the eager loop for the same bits, integrator state and clock;
- PR 15: the minimized bilayer at LJPME (phase_ljpme_bilayer: kernel 1
  in MODE_LJPME against its plain version in float32 and in float64,
  kernels 2-3 on the dispersion grid with c6 weights, the group
  energies with the reciprocal space in a group of its own, one minimize
  call through kernels 1, 4 and 5, MD replayed eagerly for the same
  bits); 8,000 TIP4P-Ew waters (32,000 particles, the M sites virtual;
  phase_tip4pew) relaxed from the lattice, every site on its weighted
  parents, then under MTSLangevin at 4 fs with the reciprocal space the
  slow group (phase_mts_tip4pew: kernels 2-3 once an outer step, kernel
  1 twice); the relaxed water box with 64 waters decoupled by a global
  parameter's offsets (phase_offsets: setParameter at three lambdas in
  one step program, the energy against float64 and against the
  parameters built in, updateParametersInContext against a fresh
  Context); and checkpoints (phase_checkpoint: a reloaded run, in the
  same and in a second Context, gives the uninterrupted run's bits;
  reinitialize keeps the state);
- the custom forces: the relaxed water box as an alchemical run
  (phase_alchemical: models.alchemical_water_box, 64 solute waters, the
  soft-core CustomNonbondedForce over (solute, solvent) and three more
  custom forces; a minimize call through kernels 1, 4 and 5; steps at
  three (lambda_sterics, lambda_electrostatics) through one step
  program, kernels 1-3 once a step; each custom group's float32 energy
  against float64 and dE/dlambda_sterics against central differences of
  float64 energies; updateParametersInContext without a capture; the
  eager loop's bits); a CustomIntegrator drawing inside a while block
  (phase_while_draws: the eager loop's bits); the bilayer's bonds,
  angles and torsions as custom twins (phase_custom_bilayer: float64
  energies and forces against the standard forces within 1e-10, the
  torsions' CustomCompoundBondForce against the CustomTorsionForce, 50
  steps with the eager loop's bits); tabulated functions on the card
  against the CPU (phase_tables);
- the rest of the custom forces: the alchemical box's
  dE/dlambda_electrostatics (the
  NonbondedForce's offsets: kernel 1's derivative instantiation against
  its plain version, kernel 2 on the charges and their derivatives)
  against central differences; the GB recipes (phase_customgb: the OBC2
  recipe against GBSAOBCForce in float64, then GBn2 on the 2,546-atom
  cluster: float32 against float64, a minimize call, 100 steps with the
  eager loop's bits, GB's share of the step); the bilayer under an RMSD
  restraint (phase_rmsd_cv: CustomCVForce over an RMSDForce of the
  lipids' heavy atoms, against numpy's Kabsch and a central difference,
  r0 steered between chunks without a capture, the eager loop's bits, ms
  a step against the plain bilayer in turns); and hydrogen bonds over 512
  waters, Axilrod-Teller on 256 argon atoms and a Gay-Berne fluid of 128
  ellipsoids (phase_more_custom: ef on the card against the CPU's
  float64, NVE drift, the eager loop's bits);
- the app layer (phase_app_bilayer): the POPC patch written with
  PDBFile.writeFile and read back, its System from
  ForceField("amber14-lipid.json", "amber14-tip3p.json").createSystem
  (PME 0.9 nm, HBonds) gated equal to models.popc_bilayer()'s (arrays
  equal, term lists in any order, the box to the PDB's 0.001 A) with
  energies and forces within 1e-6 at the PDB's positions, then
  Simulation (LangevinMiddle at 300 K, 1/ps, 2 fs, the default platform)
  minimizeEnergy(maxIterations=5) (kernels 1, 4, 5) and step(200)
  (kernels 1-3) with a StateDataReporter and a DCDReporter every 50
  steps: finite energies, 300 +- 15 K at the last report, the DCD read
  back to the final positions; ms a step through Simulation against the
  plain models.popc_bilayer() Context in turns. The later bilayer phases
  take the ForceField's System, the rf bilayer the reference one. The
  kernels are built with one nvcc a source, all at once, and one link;
- the AMOEBA family: the slice's path at full size (phase_amoeba_pme:
  ACE-(ALA)20-NME through PDBFile and Modeller.addHydrogens/addSolvent in
  a 6.5 nm cube, ~24,000 atoms, DHFR's size; ForceField("amoeba2013.json")
  .createSystem(PME 0.7 nm, vdwCutoff 0.9 nm, mutual polarization) with
  the AMOEBA forces in group 1; minimizeEnergy; float32 forces and group
  energies against float64; kernels 4-5 at its shapes against their
  plain versions, first and second order; MTSLangevin (2 fs, [(0, 2),
  (1, 1)]) through the step program, kernels 4-5 launched, the eager
  loop's bits, the SCF's residual and the peak memory), generalized
  Kirkwood on ACE-(ALA)247-NME (phase_amoeba_gk, amoebagk's ~2,490
  atoms) and HIPPO on a 512-water cluster (phase_hippo), each against
  float64 and a few steps (GK's through the eager loop). The three run
  in children forked at the start (fork_helper), beside the build, the
  kernel phases and the examples, which time no device work. The
  AMOEBA-PME phase goes past its relaxation once GK's child has ended:
  its float64 check and steps run beside the script's phases that need
  no main path (minimize, ewald, gbsa, customgb, tip4pew and MTS
  tip4pew, whose ms a step share the card with it), its timed replay
  alone while the script waits for it before its main path, and the
  script times kernels 4-5 at its shapes at the end. The helix in POPC
  runs in a forked child too (write_membrane: its build and
  phase_modeller_membrane);
- Drude and RPMD: kernels 1-3 at the shapes of a SWM4-NDP box built as
  users build it (Modeller.addSolvent and addExtraParticles with
  ForceField("swm4ndp.json"), PME 0.9 nm, rigid water; ~24,000
  particles, each Drude on its oxygen, those pairs excluded at r = 0);
  the box minimized, its float32 forces and group energies against
  float64, DrudeLangevin (300 K, 1/ps, 1 K, 20/ps, 1 fs) through the
  step program with the eager loop's bits, its two temperatures gated,
  DrudeSCF (kernel 1 thirteen times a step) and DrudeNoseHoover steps
  (phase_drude); 216 flexible TIP3P waters under RPMDIntegrator (32
  copies, 298 K, 1/ps, 0.25 fs, the reciprocal space contracted to 4):
  the centroid's temperature and the ring polymers' spread gated, the
  eager loop's bits, then RPMDMonteCarloBarostat, every copy moved by its
  centroid's offset (phase_rpmd). Both paths, their Systems' builds
  included, run in children forked at the start (write_drude,
  write_rpmd) and joined before the timing; each path's kernel launches
  go into the kernels line (launches_new_paths);
- XmlSerializer and a periodic collective variable on the main path's
  water box (phase_serialization, phase_cv_nonbonded): its System,
  integrator and State (Simulation.saveState) written as XML and a
  Simulation(topology, "system.xml", "integrator.xml", state="state.xml")
  run from them with a CheckpointReporter(writeState=True), whose State
  is loaded mid-run, giving the original Context's bits; the 32,512-atom
  bilayer's System written and read back with equal parameters (a helper
  forked at the start); the box's NonbondedForce as the variable of
  CustomCVForce("s*E") against the plain force, halved at s = 0.5, and
  200 steps with the variable's candidate state under the step
  program's gate (kernels 1-3 every step), the eager loop's bits, ms a
  step against the plain Context in turns; both paths' launches go into
  launches_new_paths;
- the mesh (openmm_tpu_torch.parallel, one card): kernel 1 in each
  instantiation on the row-brick ranges of 2, 4 and 8 ranks, their rows
  put together the whole launch's bits, a half range timed against the
  whole (phase_mesh_kernels); the water box on a one-rank NCCL mesh
  (a FileStore group of world size 1), 100 steps through the step program
  with the gather captured, the plain Context's bits, the first 25 the
  eager loop's, ms a step against the plain Context in turns
  (phase_mesh_nccl);
  two gloo ranks sharing the card (children forked at the start,
  ForkedRanks, each running parallel/ranks.py's water_box task after the
  build), 20 eager steps, each rank's positions and energy the
  single-process run's bits and its graph capture refused
  (phase_mesh_ranks); kernel 1's record carries
  the ranges' check ("mesh") and the mesh paths' launches.

It imports nothing of JAX or of openmm_tpu.

The script keeps to a budget of its own (BUDGET_S, build included) and exits
non-zero, naming the phase, when that is exceeded or any phase fails. Its
last line is {"ok": true, "device": {...}} and nothing else; the line before
it is the per-kernel JSON record (launches on the path that runs the
kernel, times, bounds; kernel 1's reaction-field mode as
"nonbonded_tiles_rf", at the rf water box's shapes; its LJPME mode and
kernels 2-3 on the dispersion grid as "nonbonded_tiles_ljpme",
"pme_spread_dispersion" and "pme_gather_dispersion", at the LJPME
bilayer's shapes; kernel 1's derivative instantiation as
"nonbonded_tiles_deriv", at the alchemical box's shapes).
Without a CUDA device it exits non-zero before printing any result.
"""
from __future__ import annotations

import atexit
import gc
import importlib
import io
import json
import math
import pickle
import statistics
import subprocess
import sys
import threading
import time
import types

import numpy as np
import torch

import openmm_tpu_torch as omm
from openmm_tpu_torch import _build
from openmm_tpu_torch import step_program
from openmm_tpu_torch.context import MAX_ESCALATIONS, STEP_CHUNK
from openmm_tpu_torch.forces.nonbonded import NonbondedModule
from openmm_tpu_torch.integrators.drude import SCF_ITERATIONS
from openmm_tpu_torch.models import builders, popc_bilayer, water_droplet
from openmm_tpu_torch.models.builders import (ALCHEMICAL_GROUPS,
                                              TWIN_GROUPS,
                                              TWIN_INTEGRATION_GROUPS,
                                              custom_twins)
from openmm_tpu_torch.ops import geometry as geom
from openmm_tpu_torch.ops import pallas_pme, pme_zslab, tile_pairs
from openmm_tpu_torch.ops import pme as pme_mod
from openmm_tpu_torch.parallel import (make_mesh, ranks,
                                       set_default_mesh)
from openmm_tpu_torch.parallel.mesh import row_split
from openmm_tpu_torch.platform import set_fp32_matmul_exact
from openmm_tpu_torch.profile_step import custom_verlet
from openmm_tpu_torch.unit import plain as in_md

BUDGET_S = 180.0
N_WATERS = 8000
# lattice-start relaxation: (step size ps, friction 1/ps, steps); bench.py
# uses 6,000 steps, which this smoke test cannot afford
RELAX = ((0.0005, 50.0, 300), (0.001, 20.0, 200))
DT_PS = 0.002
FRICTION = 1.0
PRODUCTION_STEPS = 100
ENERGY_EVERY = 50
# the step program against the eager loop: steps taken one a call (to
# find the steps that rebuild), steps from a capacity scale too small for
# the box (to force an escalation), and steps of a float64 Context
REBUILD_STEPS = 30
ESCALATION_SCALE = 0.5
ESCALATION_STEPS = 10
DOUBLE_WATERS = 512
DOUBLE_STEPS = 5
# float64 positions of the float64 Context after DOUBLE_STEPS steps, graph
# against eager: its plain PME spread adds in float64 atomics, whose order
# changes from run to run (each step's rounding, ~1e-16 relative, grown
# over the steps)
DOUBLE_POS_TOL = 1e-9
FORCE_ERR_BAR = 1e-5
# minimization: LocalEnergyMinimizer calls of MINIMIZE_ITERATIONS
# iterations each (per penalty stage), the deadline checked between calls
MINIMIZE_CALLS = 1
MINIMIZE_ITERATIONS = 6
MINIMIZE_TOLERANCE = 10.0       # kJ/mol/nm, the RMS gradient per particle
# the POPC bilayer: the force group of each force (for the per-group
# energies), its temperature, its steps before the production steps, its
# minimize call's iterations a penalty stage, and its bars
BILAYER_GROUPS = {"NonbondedForce": 0, "HarmonicBondForce": 1,
                  "HarmonicAngleForce": 2, "PeriodicTorsionForce": 3,
                  "CMMotionRemover": 4}
BILAYER_TEMPERATURE = 303.15
BILAYER_STEPS = 100
BILAYER_PRODUCTION = 30         # timed, then replayed through the eager loop
BILAYER_MINIMIZE_ITERATIONS = 4
GROUP_ENERGY_BAR = 1e-5
CONSTRAINT_ERR_BAR = 1e-5
# the app layer's path: the POPC patch through PDBFile, ForceField and
# Simulation (phase_app_bilayer), with bench.py's settings
APP_FORCEFIELD = ("amber14-lipid.json", "amber14-tip3p.json")
APP_CUTOFF = 0.9                # nm
APP_TEMPERATURE = 300.0         # K
APP_T_BAND = 15.0               # K about APP_TEMPERATURE at the last report
APP_MINIMIZE_ITERATIONS = 3
APP_STEPS = 100
APP_REPORT_EVERY = 50
APP_ENERGY_BAR = 1e-6           # relative, the two Systems' energies
APP_FORCE_BAR = 1e-6            # the median relative force difference
APP_BOX_BAR = 5e-5              # nm, half the PDB's 0.001 A
APP_TURN_STEPS = 10
APP_TURNS = ("simulation", "plain", "plain", "simulation")
# phase_modeller_membrane: the helix of helix_residues through
# Modeller.addHydrogens and addMembrane("POPC"), then a Simulation with
# reporters and Metadynamics on the helix's depth
MEMBRANE_FORCEFIELD = ("amber14-all.json", "amber14-tip3p.json")
MEMBRANE_PADDING = 1.0          # nm
MEMBRANE_IONIC = 0.15           # molar
MEMBRANE_RELAX = 6              # addMembrane's _relax_iterations (50 by
                                # default): 6 rounds of 20 steps
MEMBRANE_MINIMIZE_ITERATIONS = 3
MEMBRANE_STEPS = 300            # under Metadynamics
MEMBRANE_PLAIN_STEPS = 25       # timed without it, the reporters on
MEMBRANE_REPORT_EVERY = 50
MEMBRANE_FRICTION = 5.0         # 1/ps: the freshly built membrane, its
                                # energy minimized, takes its kinetic
                                # energy's share back within the run
META_FREQUENCY = 50             # steps between depositions
META_HEIGHT = 1.0               # kJ/mol
META_BIAS_FACTOR = 10.0
META_WIDTH = 0.05               # nm
META_RANGE = (-1.5, 1.5)        # nm, the CV's grid
META_CV_BAR = 1e-6              # nm, the CV against numpy's centroids
META_GRID_BAR = 1e-9            # kJ/mol, the bias grid against numpy's sum
META_ENERGY_BAR = 1e-6          # relative, group 31 against the table
PDBX_BAR = 0.5e-5               # nm, half the file's 0.0001 A
# phase_gromacs_water: the water box as .gro and an SPC/E .top
GROMACS_STEPS = 50
GROMACS_T_RANGE = (200.0, 450.0)
# phase_tempering: simulated tempering on the relaxed GROMACS water box
TEMPERING_RUNGS = (300.0, 330.0, 4)     # min K, max K, rungs
TEMPERING_INTERVAL = 25
TEMPERING_STEPS = 150
# constant pressure: the barostats' settings (bar, bar nm, K), steps and
# bars; the NPT phases read and print the box after every call of
# NPT_FREQUENCY steps, one attempt a call on the bilayer and the water box
NPT_PRESSURE = 1.0
NPT_TENSION = 0.0
NPT_FREQUENCY = 25
NPT_BILAYER_STEPS = 100
NPT_BILAYER_REPLAY = 10
NPT_WATER_STEPS = 100
NPT_WATER_REPLAY = 10
ANISO_FREQUENCY = 5
ANISO_STEPS = 50
NPT_VOLUME_BAR = 0.03       # |V / V0 - 1| after the run
# the bilayer's NVT and NPT step programs timed in turns, in one call each
# of NPT_TURN_STEPS steps (4 attempts), in the order NPT_TURNS, with the
# card's SM clock and power read before and after
NPT_TURN_STEPS = 25
NPT_TURNS = ("nvt", "npt", "npt", "nvt")
# the other NonbondedForce methods: the reference suite's rf settings
# (tools/bench_suite.py, dhfr_rf: CutoffPeriodic, 1.0 nm) on the relaxed
# water box and the minimized bilayer, steps in all and replayed through
# the eager loop; a droplet of the relaxed box (radius nm) at NoCutoff and
# CutoffNonPeriodic (cutoff nm; dhfr_gbsa's), and a small Ewald box
RF_CUTOFF = 1.0
RF_STEPS = 100
RF_REPLAY = 5
DROPLET_RADIUS = 2.5
DROPLET_CUTOFF = 2.0
DROPLET_STEPS = 40
DROPLET_REPLAY = 5
EWALD_WATERS = 512
EWALD_STEPS = 60
EWALD_REPLAY = 10
# implicit solvent (models.popc_obc_cluster: 19 lipids at the reference
# suite's dhfr_gbsa settings, LangevinMiddle at 300 K, 1/ps, 2 fs): the
# force group of each force, the minimize call's iterations a penalty
# stage, the relaxation's steps and friction (the minimized start takes
# the velocities' heat into its potential energy and regains it at the
# rate of the friction), and the steps replayed through the eager loop
GBSA_GROUPS = {"NonbondedForce": 0, "GBSAOBCForce": 1,
               "HarmonicBondForce": 2, "HarmonicAngleForce": 2,
               "PeriodicTorsionForce": 2, "CMMotionRemover": 3}
GBSA_TEMPERATURE = 300.0
GBSA_MINIMIZE_ITERATIONS = 5
GBSA_LIPIDS = 19                # of models.popc_obc_cluster's cluster
GBSA_STEPS = 100
GBSA_RELAX_FRICTION = 10.0
GBSA_REPLAY = 5
# the other integrators on the relaxed water box (PME, kernels 1-3):
# Verlet at 1 fs, its total energy read every DRIFT_EVERY steps over
# VERLET_STEPS steps for the NVE drift, gated as tests/test_nve_drift.py
# gates it (kT/dof/ns); Verlet under the Andersen thermostat from a start
# at ANDERSEN_START K, the temperature read every ANDERSEN_EVERY steps
# and its mean over the last half of the run within ANDERSEN_T_RANGE;
# leapfrog Langevin at 2 fs and 1/ps; Brownian at 0.5 fs and 100/ps (a
# hydrogen moves ~0.01 nm a step). Each run then replays
# INTEGRATOR_REPLAY steps from a snapshot through the eager loop.
VERLET_DT = 0.001
VERLET_STEPS = 800
DRIFT_EVERY = 100
DRIFT_GATE = 0.2
ANDERSEN_TEMPERATURE = 300.0
ANDERSEN_FREQUENCY = 10.0
ANDERSEN_START = 250.0
ANDERSEN_STEPS = 400
ANDERSEN_EVERY = 25
ANDERSEN_T_RANGE = (270.0, 330.0)
LANGEVIN_STEPS = 100
BROWNIAN_DT = 0.0005
BROWNIAN_FRICTION = 100.0
BROWNIAN_STEPS = 50
INTEGRATOR_REPLAY = 5
# the integrators written as programs or carrying state of their own, on
# the relaxed water box (PME, kernels 1-3): a CustomIntegrator velocity
# Verlet at VERLET_DT with a step counter, a kinetic-energy sum in an if
# block every CUSTOM_SUM_EVERY steps and a while block of CUSTOM_LOOPS
# passes, its total energy read every DRIFT_EVERY steps for the drift;
# NoseHooverIntegrator (chain 3, MTS 3, YS 7) from NH_START K, its conserved
# quantity read every NH_EVERY steps and held to NVE Verlet's energy from the
# same start, its mean temperature over the last half within NH_T_RANGE;
# VariableLangevin and VariableVerlet at VARIABLE_TOLERANCE, a step a call and
# the device step size read after each; a CompoundIntegrator of LangevinMiddle
# (2 fs) and Verlet (VERLET_DT), COMPOUND_STEPS steps a member, switched
# COMPOUND_SWITCHES times. On the minimized bilayer: MTSLangevinIntegrator with
# the NonbondedForce in group 0 and the bonded forces in group 1 (MTS_GROUPS:
# the slow group once a step, the fast one twice), and AMDForceGroupIntegrator
# on the torsions' group, alpha and the threshold above its start energy V0 set
# from AMD_FRACTION |V0|.
CUSTOM_STEPS = 2000
CUSTOM_SUM_EVERY = 10
CUSTOM_LOOPS = 3
NH_TEMPERATURE = 300.0
NH_FREQUENCY = 10.0
NH_START = 250.0
NH_STEPS = 700
NH_EVERY = 50
NH_T_RANGE = (270.0, 330.0)
VELOCITY_SEED = 8               # of the velocities drawn at a temperature
VARIABLE_TOLERANCE = 1e-3
VARIABLE_STEPS = 150
VARIABLE_ENERGY_BAR = 0.02      # |E1 / E0 - 1| under VariableVerlet
COMPOUND_STEPS = 50
COMPOUND_SWITCHES = 3
MTS_GROUPS = ((0, 1), (1, 2))
MTS_STEPS = 50
AMD_DT = 0.001
AMD_STEPS = 60
AMD_EVERY = 25
AMD_FRACTION = 0.2
BILAYER_T_RANGE = (250.0, 360.0)
# PR 15: the bilayer at LJPME (from the bilayer phase's minimized state;
# the NonbondedForce's reciprocal space in a group of its own for the
# energies by group), the TIP4P-Ew box relaxed from its lattice, then under
# MTS with the reciprocal space slow; parameter offsets and
# updateParametersInContext on the relaxed water box; checkpoints
LJPME_RECIP_GROUP = 5
LJPME_STEPS = 25
LJPME_REPLAY = 2
LJPME_MINIMIZE_ITERATIONS = 3
# 0.3 ps after fresh velocities at 303.15 K on a minimized structure: half
# the kinetic energy flows into the potential first (248.25 K in a chip
# run of 150 steps), hence a lower bound below BILAYER_T_RANGE's
LJPME_T_RANGE = (200.0, 360.0)
LJPME_KERNELS = ("nonbonded_tiles", "pme_spread_dispersion",
                 "pme_gather_dispersion")
# kernel 1's MODE_LJPME (float32) against its plain version in float64 on
# the same inputs: the median over atoms of the relative force error (the
# force error bar of the float32 path), the largest error against the
# largest force (kernel 1's tolerance against its float32 plain version)
LJPME_F64_MEDIAN_BAR = 1e-5
LJPME_F64_MAX_BAR = 1e-4
TIP4PEW_WATERS = 8000
TIP4PEW_RELAX = RELAX
TIP4PEW_STEPS = 150
TIP4PEW_REPLAY = 10
SITE_BAR = 1e-6                 # nm: a site from its weighted parents
MTS_TIP4PEW_DT = 0.004
MTS_TIP4PEW_GROUPS = ((1, 1), (0, 2))
MTS_TIP4PEW_STEPS = 100
MTS_T_RANGE = (250.0, 360.0)
OFFSET_WATERS = 64
OFFSET_LAMBDAS = (1.0, 0.5, 0.0)
OFFSET_CHUNK = 25
OFFSET_BUILT_IN_BAR = 1e-6      # relative, against the parameters built in
CHECKPOINT_STEPS = 50
# the alchemical water box (models.alchemical_water_box), the custom twins
# of the bilayer's bonded forces, the tables, the draws inside a while block
ALCHEMICAL_SOLUTE = 64
# (lambda_sterics, lambda_electrostatics) in turn: the solute's charges
# are off wherever its sterics are softened (its oxygens would fuse with
# the solvent's hydrogens otherwise), as an alchemical protocol takes them
ALCHEMICAL_LAMBDAS = ((1.0, 1.0), (0.5, 0.0), (0.2, 0.0))
ALCHEMICAL_CHUNK = 15           # steps at each lambda
ALCHEMICAL_REPLAY = 5
ALCHEMICAL_MINIMIZE_ITERATIONS = 5
ALCHEMICAL_T_RANGE = (200.0, 450.0)
ALCHEMICAL_H = 1e-4             # the central difference's step in lambda
ALCHEMICAL_DERIV_BAR = 1e-4     # relative, dE/dlambda against it
TWIN_BAR = 1e-10                # float64 twins against the standard forces
TWIN_STEPS = 25
TWIN_REPLAY = 5
TABLE_ATOMS = 2000              # atoms of the tables' synthetic dihedrals
TABLE_BAR = 1e-12               # the card's float64 against the CPU's
WHILE_DRAW_PASSES = 2
WHILE_DRAW_STEPS = 20
# what the bilayer phase prints of each force
# the Amber GB recipes (phase_customgb), the RMSD restraint
# (phase_rmsd_cv), the other custom forces (phase_more_custom) and the
# offsets' electrostatic derivative (phase_alchemical)
GB_MODEL = "GBn2"
GB_STEPS = 100
GB_REPLAY = 5
GB_MINIMIZE_ITERATIONS = 5
# the OBC2 recipe against GBSAOBCForce, float64, relative: the recipe's
# Coulomb constant 138.935485 against the port's 138.9354576 (2.0e-7)
RECIPE_BAR = 1e-6
GB_T_RANGE = (250.0, 360.0)
RMSD_K = 2000.0                 # kJ/mol/nm^2
RMSD_STEER = 0.01               # nm that r0 rises between chunks
RMSD_CHUNK = 50
RMSD_CHUNKS = 2
RMSD_REPLAY = 5
RMSD_TURN_STEPS = 25
RMSD_H = 1e-4                  # nm, the central difference's step
RMSD_FD_BAR = 1e-5              # of the largest force, float64: the
# msd is a difference of sums of squares ~1e4 times its size, so the float64
# energy's rounding puts the central difference's floor at ~1e-6 (CPU)
RMSD_KABSCH_BAR = 1e-9          # relative, the card's CV against numpy
HBOND_WATERS = 512
ARGON_ATOMS = 256
GAYBERNE_ELLIPSOIDS = 128
MORE_DT = 0.0005
MORE_STEPS = 200
ARGON_STEPS = 60                # its 2.76M triples cost 12 ms a step (H100
                                # 80GB HBM3, 700 W)
MORE_EVERY = 25
MORE_REPLAY = 5
MORE_BAR = 1e-10                # the card's float64 ef against the CPU's
DERIV_OPS_PER_PAIR = 75.0       # kernel 1's derivative instantiation
COUNTED = {"NonbondedForce": "getNumExceptions",
           "HarmonicBondForce": "getNumBonds",
           "HarmonicAngleForce": "getNumAngles",
           "PeriodicTorsionForce": "getNumTorsions",
           "CMMotionRemover": "getFrequency"}
# clock cycles the card sleeps before each timed call (~1 ms at 1.98 GHz)
SLEEP_CYCLES = 2_000_000
# calls timed of a kernel's plain version (a reference, 1-105 ms a call)
PLAIN_REPS = 3
# peak rates of one H100 SXM (data sheet, dense): float32 outside the
# tensor cores, and HBM bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12
MAIN_PATH_KERNELS = (tile_pairs.TILES, pme_zslab.SPREAD, pme_zslab.GATHER)
MAIN_PATH_NAMES = tuple(k.name for k in MAIN_PATH_KERNELS)
MINIMIZER_KERNELS = (tile_pairs.TILES, pallas_pme.FWD, pallas_pme.BWD)
KERNELS = MAIN_PATH_KERNELS + (pallas_pme.FWD, pallas_pme.BWD)
# kernel vs plain tolerances, relative to the largest magnitude of each plain
# output: the plain versions sum in float32 in their own order (index_add_,
# einsum), while kernels 2 and 4 add float64 products in 64-bit fixed point
# (exact integer sums, each term rounded at 2^-62 of the bound n max_i
# sum|terms_i|: ~1e-13 of a cell at 24,000 atoms), so they differ by the
# plain version's own rounding; kernel 1 adds each row atom's pairs in 32
# lane sums and a shuffle tree, kernel 5 each output over the atom's
# supports, kernel 3 each atom's 125 terms in its own fixed order, and
# rsqrtf/expf differ in the last ulps
TOLERANCE = {"nonbonded_tiles": 1e-4, "pme_spread": 1e-5,
             "pme_gather": 1e-5, "spread_triple_fwd": 1e-5,
             "spread_triple_bwd": 1e-5, "pme_spread_dispersion": 1e-5,
             "pme_gather_dispersion": 1e-5}
# kernels whose output must have the same bits on every call: the
# fixed-point spreads, and the three that own each output (no atomics)
DETERMINISTIC = ("nonbonded_tiles", "pme_spread", "pme_gather",
                 "spread_triple_fwd", "spread_triple_bwd",
                 "pme_spread_dispersion", "pme_gather_dispersion")
DISPERSION_KERNELS = (pme_zslab.SPREAD_DISPERSION,
                      pme_zslab.GATHER_DISPERSION)
# the triclinic phase shears the box of edge L into a = (L, 0, 0),
# b = (2L/7, L, 0), c = (-L/7, 2L/7, L), as tests/test_torch_triclinic.py
SHEAR = ((0.0, 0.0, 0.0), (2.0 / 7.0, 0.0, 0.0), (-1.0 / 7.0, 2.0 / 7.0, 0.0))


class Deadline:
    """The script's overall budget, checked inside every phase after each
    bounded piece of work (a chunk of steps, one kernel, the nvcc call)."""

    def __init__(self, budget_s: float):
        self.t0 = time.perf_counter()
        self.budget_s = budget_s
        self.laps = []      # (phase, seconds since the previous lap)

    def lap(self, phase: str) -> None:
        """Record the seconds `phase` took since the previous lap."""
        done = sum(t for _, t in self.laps)
        self.laps.append((phase, self.elapsed() - done))

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
    print("build: one nvcc a source, all at once, then one link: %.1f s -> "
          "%s" % (seconds, path.name))
    for line in regs:
        print("  ptxas: %s" % line[:110])
    _build.library()
    return seconds


_BUILT = {}


def _fresh(builder, *args, **kwargs):
    """builder(*args, **kwargs), built once for each set of arguments and
    handed out as a fresh copy (a pickle's): the phases add forces to the
    System they get, and a build of the 24,000-atom water box takes ~10
    times the host time of a copy."""
    key = (builder.__name__, args, tuple(sorted(kwargs.items())))
    if key not in _BUILT:
        _BUILT[key] = pickle.dumps(builder(*args, **kwargs))
    return pickle.loads(_BUILT[key])


def tip3p_water_box(*args, **kwargs) -> tuple:
    return _fresh(builders.tip3p_water_box, *args, **kwargs)


def tip4pew_water_box(*args, **kwargs) -> tuple:
    return _fresh(builders.tip4pew_water_box, *args, **kwargs)


def alchemical_water_box(*args, **kwargs) -> tuple:
    return _fresh(builders.alchemical_water_box, *args, **kwargs)


def popc_obc_cluster(*args, **kwargs) -> tuple:
    return _fresh(builders.popc_obc_cluster, *args, **kwargs)


def prebuild(n_waters=N_WATERS) -> None:
    """The models the phases after the helpers' join build, built while
    the script waits for the helpers (host work only; _fresh keeps them),
    with the arguments those phases pass."""
    tip3p_water_box(n_waters)
    tip3p_water_box(n_waters, nonbonded_method=omm.NonbondedForce.
                    CutoffPeriodic, cutoff=RF_CUTOFF)
    tip4pew_water_box(TIP4PEW_WATERS)
    alchemical_water_box(n_waters, ALCHEMICAL_SOLUTE)
    popc_obc_cluster(GBSA_LIPIDS)


def water_box(n_waters, sheared=False):
    """(system, positions) of the TIP3P box, its box sheared by SHEAR into a
    reduced triclinic one when `sheared`."""
    system, pos = tip3p_water_box(n_waters)
    if sheared:
        box = np.asarray(in_md(system.getDefaultPeriodicBoxVectors()))
        system.setDefaultPeriodicBoxVectors(
            *(box + box[0, 0] * np.asarray(SHEAR)))
    return system, pos


def kernel_inputs(device, n_waters, sheared=False, system=None,
                  positions=None, fine=False) -> dict:
    """Inputs of the kernels at the shapes of their paths, from the water
    box's starting positions (its box sheared when `sheared`), or from
    `system` at `positions`: kernel 1 as the path calls it (in the mode of
    the System's NonbondedForce) and, for PME, kernels 2-3 as the main
    path calls them (kernel 3 visiting the atoms in the candidate state's
    order) and kernels 4-5 on the dense weight planes of those positions
    (N unpadded) with a seeded cotangent dQ. The capacity grows, as a
    Context grows it, until the candidate state holds every pair. `fine`:
    kernel 1 on the positions as float32 pairs (pos_lo), as a Context of
    a System with Drude particles calls it."""
    if system is None:
        system, positions = water_box(n_waters, sheared)
    pos = positions
    box = torch.as_tensor(in_md(system.getDefaultPeriodicBoxVectors()),
                          dtype=torch.float32, device=device)
    (nb,) = [f for f in system.getForces()
             if isinstance(f, omm.NonbondedForce)]
    module = NonbondedModule(nb, box.cpu().numpy(), device)
    posf = torch.as_tensor(pos, dtype=torch.float32, device=device)
    st = module.build_state(posf, box)
    for _ in range(MAX_ESCALATIONS):  # as a Context grows it on overflow
        if not int(st["overflow"]):
            break
        module.capacity_scale *= 1.4
        st = module.build_state(posf, box)
    if int(st["overflow"]):
        raise RuntimeError("candidate state overflowed at the start")
    pos4, pos_lo = (tile_pairs.sorted_positions_fine(
        torch.as_tensor(pos, dtype=torch.float64, device=device),
        box.to(torch.float64), st) if fine else
        (tile_pairs.sorted_positions(posf, box, st), None))
    inp = {
        "tiles": (pos4, st["par4"], st["cand"], st["count"], st["words"],
                  tile_pairs.tile_consts(box, module.tile_scalars)),
        "pos": posf.contiguous(), "charge": module.charge,
        "module": module, "box": box, "pos_lo": pos_lo,
    }
    if module.method not in (omm.NonbondedForce.PME,
                             omm.NonbondedForce.LJPME):
        return inp
    if module.ljpme:
        inp["disp"] = {"c6": (2.0 * torch.sqrt(module.epsilon)
                              * module.sigma ** 3).contiguous(),
                       "grid": module.lj_grid}
    a, wy, wz = pme_mod.dense_weights(posf, module.charge,
                                      geom.box_inverse(box), module.grid,
                                      pme_zslab.ORDER)
    nx, ny, nz = module.grid
    gen = torch.Generator(device=device)
    gen.manual_seed(5)
    dq = torch.randn((nx, ny * nz), generator=gen, device=device)
    inp.update({
        "binv": geom.box_inverse(box).reshape(9).contiguous(),
        "order": st["order"][:posf.shape[0]], "grid": module.grid,
        "triple": (a.contiguous(), wy.contiguous(), wz.contiguous()),
        "dq": dq,
    })
    return inp


def potential_grid(inp, dispersion=False) -> torch.Tensor:
    """2*phi (nz, nx, ny), kernel 3's grid input, from the plain spread
    (of the dispersion grid's c6 weights when `dispersion`)."""
    m = inp["module"]
    pos, binv = inp["pos"], inp["binv"]
    if dispersion:
        q, grid = inp["disp"]["c6"], inp["disp"]["grid"]
        alpha, bsq = m.lj_alpha, (m.bsq_x_lj, m.bsq_y_lj, m.bsq_z_lj)
    else:
        q, grid = inp["charge"], inp["grid"]
        alpha, bsq = m.alpha, (m.bsq_x, m.bsq_y, m.bsq_z)
    q_grid = pme_zslab.pme_spread_plain(pos, q, binv, grid)
    phi, _ = pme_zslab.convolve_potential(q_grid, inp["box"], grid, alpha,
                                          *bsq, dispersion=dispersion)
    return (2.0 * phi).contiguous()


def _kernel_calls(inp):
    """{name: (kernel call, plain call)} on the same inputs: kernel 1 in
    the mode of the inputs' module, and kernels 2-5 for PME inputs."""
    t = inp["tiles"]
    m = inp["module"]
    lo = inp.get("pos_lo")
    calls = {"nonbonded_tiles": (
        lambda: tile_pairs.nonbonded_tiles(*t, m.mode, m.use_switch, lo),
        lambda: tile_pairs.nonbonded_tiles_plain(*t, m.mode, m.use_switch,
                                                 lo))}
    if "grid" not in inp:
        return calls
    pos, q, binv, grid = inp["pos"], inp["charge"], inp["binv"], inp["grid"]
    phi2 = potential_grid(inp)
    order = inp["order"]
    tr, dq = inp["triple"], inp["dq"]
    calls.update({
        "pme_spread": (
            lambda: pme_zslab.pme_spread(pos, q, binv, grid),
            lambda: pme_zslab.pme_spread_plain(pos, q, binv, grid)),
        "pme_gather": (
            lambda: pme_zslab.pme_gather(pos, q, phi2, binv, grid, order),
            lambda: pme_zslab.pme_gather_plain(pos, q, phi2, binv, grid)),
        "spread_triple_fwd": (
            lambda: pallas_pme.spread_triple_fwd(*tr),
            lambda: pallas_pme.spread_triple_plain(*tr)),
        "spread_triple_bwd": (
            lambda: pallas_pme.spread_triple_bwd(dq, *tr),
            lambda: pallas_pme.spread_triple_vjp_plain(dq, *tr)),
    })
    if "disp" not in inp:
        return calls
    c6, lj_grid = inp["disp"]["c6"], inp["disp"]["grid"]
    phi2_lj = potential_grid(inp, dispersion=True)
    calls.update({
        "pme_spread_dispersion": (
            lambda: pme_zslab.pme_spread(
                pos, c6, binv, lj_grid, counter=pme_zslab.SPREAD_DISPERSION),
            lambda: pme_zslab.pme_spread_plain(pos, c6, binv, lj_grid)),
        "pme_gather_dispersion": (
            lambda: pme_zslab.pme_gather(
                pos, c6, phi2_lj, binv, lj_grid, order,
                counter=pme_zslab.GATHER_DISPERSION),
            lambda: pme_zslab.pme_gather_plain(pos, c6, phi2_lj, binv,
                                               lj_grid)),
    })
    return calls


def _compare(got, want):
    """(largest absolute error, largest plain value, largest error relative
    to the largest value of its own output) over a kernel's outputs; the
    relative error is inf when an error is not finite."""
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
    scales = [float(w.abs().max()) for w in want]
    rel = max(e / s for e, s in zip(errs, scales))
    if not all(math.isfinite(e) for e in errs):
        rel = math.inf
    return max(errs), max(scales), rel


def _check_repeatable(name, first, again) -> None:
    """Raises unless two calls on the same inputs gave the same bits."""
    if not isinstance(first, tuple):
        first, again = (first,), (again,)
    for f, g in zip(first, again):
        if not torch.equal(f, g):
            raise RuntimeError("kernel %s gave other bits on a second call "
                               "(largest difference %.3e)"
                               % (name, float((f - g).abs().max())))


def phase_kernels(device, inp, deadline, names=None, label="") -> dict:
    """Each kernel (or those in `names`) against its plain version, and the
    DETERMINISTIC ones against a second call of their own; raises on a
    miss."""
    errors = {}
    for name, (kernel, plain) in _kernel_calls(inp).items():
        if names is not None and name not in names:
            continue
        got = kernel()
        want = plain()
        _sync(device)
        err, scale, rel = _compare(got, want)
        ok = rel <= TOLERANCE[name]
        print("kernel %-17s%s max_abs_err %.3e  rel %.3e  (tolerance %.0e "
              "of max %.3e) %s" % (name, label, err, rel, TOLERANCE[name],
                                   scale, "ok" if ok else "MISS"))
        if not ok:
            raise RuntimeError("kernel %s disagrees with its plain version%s"
                               % (name, label))
        if name in DETERMINISTIC:
            _check_repeatable(name, got, kernel())
            print("kernel %-17s a second call gave the same bits" % name)
        errors[name] = err
        deadline.check("kernels: %s" % name)
    return errors


def phase_gather_orders(device, inp, deadline, label="") -> dict:
    """Kernel 3 in three visiting orders: the candidate state's (the main
    path's), the user's and a seeded random permutation. Raises unless all
    three give the same bits. Returns {order: device ms per call on a GPU,
    else None}."""
    pos, q, binv, grid = inp["pos"], inp["charge"], inp["binv"], inp["grid"]
    phi2 = potential_grid(inp)
    gen = torch.Generator()
    gen.manual_seed(13)
    orders = {"state": inp["order"], "user": None,
              "random": torch.randperm(pos.shape[0], generator=gen).to(
                  device)}
    out, first = {}, None
    for name, order in orders.items():
        def call(order=order):
            return pme_zslab.pme_gather(pos, q, phi2, binv, grid, order)
        forces = call()
        if first is None:
            first = forces
        elif not torch.equal(forces, first):
            raise RuntimeError("kernel pme_gather%s gave other bits in the "
                               "%s order than in the state's (largest "
                               "difference %.3e)" % (label, name, float(
                                   (forces - first).abs().max())))
        out[name] = _time_ms(call, device) if device.type == "cuda" else None
        print("kernel pme_gather%s in the %s order: the same bits as in the "
              "state's order; %s ms" % (label, name, "not measured"
                                        if out[name] is None
                                        else "%.4f" % out[name]))
        deadline.check("kernel 3 in the %s order" % name)
    return out


# (atoms, grid) beside the main path's for kernels 4-5: N a multiple of
# 256 (the JAX kernels' padding) and not, non-cubic grids with axes below
# and above 32 and 64 entries and, at 144 x 20 x 160, two axes above 128
# (kernel 5 takes every grid in one launch), and fewer atoms than one warp
TRIPLE_SHAPES = ((24064, (56, 56, 56)), (300, (12, 10, 14)),
                 (1000, (100, 20, 30)), (7, (6, 7, 9)),
                 (256, (144, 20, 160)))
# (planes, atoms, grid) of the other inputs kernels 4-5 take: every entry
# nonzero, and spline supports whose weights span 1e-6 to 1e6
TRIPLE_PLANES = (("dense", 64, (12, 10, 14)), ("wide", 1000, (56, 56, 56)))


def _triple_planes(kind, n, grid, gen, device):
    """Seeded (a, wy, wz): "spline" rows hold 5 nonzero weights at a
    random base, wrapping round the edge, as the B-splines give; "wide"
    the same with weights 10^U(-6, 6); "dense" rows are nonzero
    everywhere (signed)."""
    planes = []
    for width in grid:
        if kind == "dense":
            w = torch.rand((n, width), generator=gen, device=device) + 0.05
            sign = torch.randint(0, 2, (n, width), generator=gen,
                                 device=device) * 2 - 1
            planes.append(w * sign)
            continue
        base = torch.randint(0, width, (n, 1), generator=gen, device=device)
        cols = torch.remainder(base + torch.arange(5, device=device), width)
        w = torch.rand((n, 5), generator=gen, device=device)
        if kind == "wide":
            w = 10.0 ** (12.0 * w - 6.0)
        planes.append(torch.zeros((n, width), device=device)
                      .scatter_add(1, cols, w))
    return planes


def phase_triple_shapes(device, deadline) -> None:
    """Kernels 4-5 against their plain versions on seeded inputs: spline
    planes at TRIPLE_SHAPES and the other planes of TRIPLE_PLANES; each
    also against a second call of its own, and kernel 5 in one launch a
    VJP. Raises on a miss."""
    gen = torch.Generator(device=device)
    gen.manual_seed(11)
    cases = ([("spline", n, grid) for n, grid in TRIPLE_SHAPES]
             + list(TRIPLE_PLANES))
    for kind, n, (nx, ny, nz) in cases:
        planes = _triple_planes(kind, n, (nx, ny, nz), gen, device)
        dq = torch.randn((nx, ny * nz), generator=gen, device=device)
        bwd_launches = pallas_pme.BWD.launches
        got = (pallas_pme.spread_triple_fwd(*planes),
               *pallas_pme.spread_triple_bwd(dq, *planes))
        bwd_launches = pallas_pme.BWD.launches - bwd_launches
        want = (pallas_pme.spread_triple_plain(*planes),
                *pallas_pme.spread_triple_vjp_plain(dq, *planes))
        _sync(device)
        rel = _compare(got, want)[2]
        ok = rel <= TOLERANCE["spread_triple_fwd"]
        print("kernels 4-5 on %s planes, N = %d, grid %dx%dx%d: largest "
              "error %.3e of the largest value %s" % (
                  kind, n, nx, ny, nz, rel, "ok" if ok else "MISS"))
        if not ok:
            raise RuntimeError("spread_triple disagrees with its plain "
                               "version on %s planes at N = %d" % (kind, n))
        if device.type == "cuda" and bwd_launches != 1:
            raise RuntimeError("kernel 5 took %d launches for one VJP on "
                               "%dx%dx%d" % (bwd_launches, nx, ny, nz))
        _check_repeatable("spread_triple_fwd", got[0],
                          pallas_pme.spread_triple_fwd(*planes))
        _check_repeatable("spread_triple_bwd", got[1:],
                          pallas_pme.spread_triple_bwd(dq, *planes))
        deadline.check("kernels 4-5 on %s planes at N = %d" % (kind, n))


def phase_triclinic(device, n_waters=N_WATERS, deadline=None) -> dict:
    """Kernels 1-3 on the water box sheared by SHEAR (their triclinic
    minimum images and fractional coordinates) against their plain
    versions, then the forces of a Context on that box (the default
    platform on a GPU, "CPU" otherwise) against the float64 plain path.
    Kernel comparisons only: no step is taken. Raises on a miss."""
    deadline = deadline or Deadline(math.inf)
    inp = kernel_inputs(device, n_waters, sheared=True)
    errors = phase_kernels(device, inp, deadline, names=MAIN_PATH_NAMES,
                           label=" (triclinic)")
    phase_gather_orders(device, inp, deadline, label=" (triclinic)")
    platform = "CUDA" if device.type == "cuda" else "CPU"
    system, positions = water_box(n_waters, sheared=True)
    scale = inp["module"].capacity_scale
    integ = omm.LangevinMiddleIntegrator(300.0, FRICTION, DT_PS)
    ctx = (omm.Context(system, integ) if platform == "CUDA"
           else omm.Context(system, integ, platform))
    oracle = omm.Context(system, omm.LangevinMiddleIntegrator(
        300.0, FRICTION, DT_PS), platform, {"Precision": "double"})
    states = []
    for c in (ctx, oracle):
        # getState does not grow the capacity (nor does the JAX Context's):
        # start at the scale the kernel inputs needed
        c._nonbonded.capacity_scale = scale
        c.setPositions(positions)
        states.append(c.getState(getForces=True, getEnergy=True))
    st, ref = states
    del ctx, oracle
    force_err = _median_relative_error(in_md(st.getForces(asNumpy=True)),
                                       in_md(ref.getForces(asNumpy=True)))
    print("triclinic box %s (capacity scale %.2f): median force error vs "
          "float64 plain path %.3e (bar %.0e); energy %.6f vs %.6f kJ/mol" % (
              np.array2string(np.asarray(in_md(
                  system.getDefaultPeriodicBoxVectors())),
                              precision=4, separator=",").replace("\n", ""),
              scale, force_err, FORCE_ERR_BAR, in_md(st.getPotentialEnergy()),
              in_md(ref.getPotentialEnergy())))
    deadline.check("triclinic: float64 oracle")
    if not force_err <= FORCE_ERR_BAR:
        raise RuntimeError("triclinic median force error %.3e above %.0e"
                           % (force_err, FORCE_ERR_BAR))
    return {"errors": errors, "force_err": force_err}


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
    oracle.setPositions(in_md(st.getPositions(asNumpy=True)))
    ref = oracle.getState(getForces=True, getEnergy=True)
    force_err = _median_relative_error(in_md(st.getForces(asNumpy=True)),
                                       in_md(ref.getForces(asNumpy=True)))
    print("main path: median force error vs float64 plain path %.3e "
          "(bar %.0e); energy %.6f vs %.6f kJ/mol" % (
              force_err, FORCE_ERR_BAR, in_md(st.getPotentialEnergy()),
              in_md(ref.getPotentialEnergy())))
    del oracle
    deadline.check("main path: float64 oracle")
    if not force_err <= FORCE_ERR_BAR:
        raise RuntimeError("median force error %.3e above %.0e"
                           % (force_err, FORCE_ERR_BAR))

    start = ctx._snapshot()
    run = _production(device, ctx, integ.step, in_md(st.getPotentialEnergy()),
                      steps, energy_every, deadline)
    temperature = ctx.temperature()
    print("main path: %d atoms, %d relax + %d steps at %.3f ps; energies "
          "%s kJ/mol; T %.1f K; rebuilds %d, escalations %d" % (
              system.getNumParticles(), sum(r[2] for r in relax), steps,
              DT_PS, " ".join("%.1f" % e for e in run["energies"]),
              temperature, ctx.rebuild_count, ctx.escalation_count))
    if not all(math.isfinite(e) for e in run["energies"]):
        raise RuntimeError("a potential energy is not finite (NaN poison "
                           "or blow-up)")
    if not 200.0 <= temperature <= 450.0:
        raise RuntimeError("final temperature %.1f K outside 200-450 K"
                           % temperature)
    return {"force_err": force_err, "energies": run["energies"],
            "temperature": temperature, "ns_day": run["ns_day"],
            "rebuilds": ctx.rebuild_count,
            "escalations": ctx.escalation_count, "production": run,
            "context": ctx, "start": start, "steps": steps,
            "energy_every": energy_every}


def _production(device, ctx, step, energy, steps, energy_every,
                deadline, read=None) -> dict:
    """`steps` steps by step(n) (the Context's step program, or its eager
    loop) in calls of `energy_every`, the potential energy (or read(ctx))
    read after each call (`energy` before the first). Returns the
    energies (or what read gave), the rebuilds
    since the start and the box after each call, the final positions,
    velocities and barostat statistics,
    the launches of the main path's kernels, ns/day, and per step of the
    calls: wall ms, host CPU ms (the process's, which counts the spin of
    the host waiting on the card) and host issue ms (Context.issue_seconds:
    the host's time up to each chunk's read, without that wait). ns/day
    is the simulated time the Context's clock advanced over the wall
    time."""
    energies, rebuilds, r0 = [energy], [], ctx.rebuild_count
    clock0 = in_md(ctx.getTime())
    boxes = []
    kernels = MAIN_PATH_KERNELS + DISPERSION_KERNELS
    launches = [k.launches for k in kernels]
    issue0 = ctx.issue_seconds
    wall = cpu = 0.0
    done = 0
    while done < steps:
        n = min(energy_every, steps - done)
        _sync(device)
        t0, c0 = time.perf_counter(), time.process_time()
        step(n)
        _sync(device)
        wall += time.perf_counter() - t0
        cpu += time.process_time() - c0
        done += n
        simulated = in_md(ctx.getTime()) - clock0
        energies.append(read(ctx) if read else
                        in_md(ctx.getState(
                            getEnergy=True).getPotentialEnergy()))
        rebuilds.append(ctx.rebuild_count - r0)
        boxes.append(tuple(ctx._box.flatten().tolist()))
        deadline.check("main path: production")
    return {"energies": energies, "rebuilds": rebuilds, "boxes": boxes,
            "positions": ctx._state["positions"].clone(),
            "velocities": ctx._state["velocities"].clone(),
            "statistics": [t.clone() for b in ctx._barostats
                           for t in b.statistics()],
            "launches": {k.name: k.launches - b
                         for k, b in zip(kernels, launches)
                         if k in MAIN_PATH_KERNELS or k.launches != b},
            "ns_day": simulated / wall * 86.4,
            "clock": in_md(ctx.getTime()),
            "state": [t.clone() for t in ctx._step_tensors()],
            "wall_ms_per_step": wall / steps * 1e3,
            "host_cpu_ms_per_step": cpu / steps * 1e3,
            "host_issue_ms_per_step": (ctx.issue_seconds - issue0) / steps
            * 1e3}


def _same_bits(what, got, want) -> None:
    for name, g, w in zip(("positions", "velocities"), got, want):
        if not torch.equal(g, w):
            raise RuntimeError("%s: the step program's %s differ from the "
                               "eager loop's by up to %.3e" % (
                                   what, name, float((g - w).abs().max())))


def _same_state(what, graph, eager) -> None:
    """The shared tensors (the box, the clock, the parameters, the
    barostats' statistics, the integrator's state) and the clock after
    two runs: the same bits."""
    for k, (g, e) in enumerate(zip(graph["state"], eager["state"])):
        if not torch.equal(g, e):
            raise RuntimeError("%s: shared tensor %d (of %d) of the step "
                               "program differs from the eager loop's" % (
                                   what, k, len(graph["state"])))
    if graph["clock"] != eager["clock"]:
        raise RuntimeError("%s: the clock reads %r after the step program, "
                           "%r after the eager loop" % (
                               what, graph["clock"], eager["clock"]))


def phase_step_program(device, main, deadline=None,
                       rebuild_steps=REBUILD_STEPS,
                       escalation_scale=ESCALATION_SCALE,
                       escalation_steps=ESCALATION_STEPS,
                       double_waters=DOUBLE_WATERS,
                       double_steps=DOUBLE_STEPS) -> dict:
    """The step program against the eager loop it replaced, from the
    snapshot phase_main_path took before its production steps: (1) the
    same production steps through Context._step_eager, which must give
    the same bits, energies, rebuilds and kernel launches; (2)
    `rebuild_steps` steps one a call, whose rebuild steps must agree;
    (3) `escalation_steps` steps from `escalation_scale` with no candidate
    state, which must overflow, escalate and end in the same bits; (4) a
    float64 Context of `double_waters` waters, `double_steps` steps, within
    DOUBLE_POS_TOL. Raises on a miss."""
    deadline = deadline or Deadline(math.inf)
    ctx, start, graph = main["context"], main["start"], main["production"]
    integ = ctx.getIntegrator()
    ctx._restore(start)
    eager = _production(device, ctx, ctx._step_eager, graph["energies"][0],
                        main["steps"], main["energy_every"], deadline)
    _same_bits("production", (graph["positions"], graph["velocities"]),
               (eager["positions"], eager["velocities"]))
    for name in ("energies", "rebuilds", "launches"):
        if graph[name] != eager[name]:
            raise RuntimeError("production: the step program's %s %s, the "
                               "eager loop's %s" % (name, graph[name],
                                                    eager[name]))
    for path in ("graph", "eager"):
        run = graph if path == "graph" else eager
        print("step program: %s path %.2f ns/day; per step %.4f ms wall, "
              "%.4f ms host issue, %.4f ms host CPU; launches %s" % (
                  path, run["ns_day"], run["wall_ms_per_step"],
                  run["host_issue_ms_per_step"], run["host_cpu_ms_per_step"],
                  json.dumps(run["launches"])))
    print("step program: capture of the main path's program %.3f s" % (
        ctx._program().capture_seconds))
    deadline.check("step program: eager production")

    marks = {}
    for path, step in (("graph", integ.step), ("eager", ctx._step_eager)):
        ctx._restore(start)
        r0, count = ctx.rebuild_count, []
        for _ in range(rebuild_steps):
            step(1)
            count.append(ctx.rebuild_count - r0)
        steps = [i + 1 for i in range(rebuild_steps)
                 if count[i] > (count[i - 1] if i else 0)]
        marks[path] = (steps, ctx._state["positions"].clone(),
                       ctx._state["velocities"].clone())
    if marks["graph"][0] != marks["eager"][0]:
        raise RuntimeError("rebuild steps differ: graph %s, eager %s"
                           % (marks["graph"][0], marks["eager"][0]))
    _same_bits("one step a call", marks["graph"][1:], marks["eager"][1:])
    print("step program: %d steps one a call, rebuilds at steps %s in both "
          "paths, the same bits" % (rebuild_steps, marks["graph"][0]))
    deadline.check("step program: rebuild steps")

    scale = ctx._nonbonded.capacity_scale
    escalated = {}
    for path, step in (("graph", integ.step), ("eager", ctx._step_eager)):
        ctx._restore(start)
        ctx._tiles = ctx._ref_pos = None
        ctx._nonbonded.capacity_scale = escalation_scale
        e0 = ctx.escalation_count
        step(escalation_steps)
        escalated[path] = (ctx.escalation_count - e0,
                           ctx._nonbonded.capacity_scale,
                           ctx._state["positions"].clone(),
                           ctx._state["velocities"].clone())
    ctx._nonbonded.capacity_scale = scale
    g, e = escalated["graph"], escalated["eager"]
    if g[0] < 1 or g[:2] != e[:2]:
        raise RuntimeError("escalation from capacity scale %.2f: graph %d "
                           "escalations to %.3f, eager %d to %.3f" % (
                               escalation_scale, g[0], g[1], e[0], e[1]))
    _same_bits("escalation", g[2:], e[2:])
    print("step program: from capacity scale %.2f, %d escalations to %.3f "
          "in both paths, the same bits after %d steps" % (
              escalation_scale, g[0], g[1], escalation_steps))
    deadline.check("step program: escalation")

    platform = "CUDA" if device.type == "cuda" else "CPU"
    system, positions = tip3p_water_box(double_waters)
    final = {}
    for path in ("graph", "eager"):
        integ64 = omm.LangevinMiddleIntegrator(300.0, FRICTION, DT_PS)
        integ64.setRandomNumberSeed(5)
        ctx64 = omm.Context(system, integ64, platform,
                            {"Precision": "double"})
        ctx64.setPositions(positions)
        ctx64.applyConstraints()
        ctx64.setVelocitiesToTemperature(300.0, randomSeed=2)
        (integ64.step if path == "graph" else ctx64._step_eager)(
            double_steps)
        final[path] = in_md(ctx64.getState(getPositions=True).getPositions(
            asNumpy=True))
        del ctx64
    double_err = float(np.abs(final["graph"] - final["eager"]).max())
    print("step program: float64 Context, %d atoms, %d steps: graph vs "
          "eager positions within %.3e nm (bar %.0e)" % (
              system.getNumParticles(), double_steps, double_err,
              DOUBLE_POS_TOL))
    if not double_err <= DOUBLE_POS_TOL:
        raise RuntimeError("float64 Context: graph and eager positions "
                           "differ by %.3e nm" % double_err)
    deadline.check("step program: float64 Context")
    print("step program: gating %s; ns/day %.2f (graph) vs %.2f (eager)" % (
        step_program.GATING, graph["ns_day"], eager["ns_day"]))
    return {"gating": step_program.GATING, "graph": graph, "eager": eager,
            "rebuild_steps": marks["graph"][0], "escalations": g[0],
            "double_err": double_err}


class _Iterations(omm.MinimizationReporter):
    """Counts the minimizer's iterations (it never stops a run: the
    minimizer ignores a reporter's exceptions, so the deadline is checked
    between calls instead)."""

    def __init__(self):
        self.count = 0

    def report(self, iteration, x, grad, args):
        self.count += 1
        return False


def _constraint_error(system, positions) -> float:
    """Largest |r - d| / d over the System's constraints."""
    cons = np.asarray(system._constraints, np.float64).reshape(-1, 3)
    p1, p2 = cons[:, :2].astype(np.int64).T
    d = cons[:, 2]
    r = np.linalg.norm(positions[p1] - positions[p2], axis=1)
    return float(np.max(np.abs(r - d) / d))


def phase_minimize(device, n_waters=N_WATERS, calls=MINIMIZE_CALLS,
                   iterations=MINIMIZE_ITERATIONS, deadline=None) -> dict:
    """Minimize the water box from its lattice start on a Context of its
    own (the default platform on a GPU, "CPU" otherwise) in `calls` calls
    of LocalEnergyMinimizer.minimize with maxIterations=`iterations`,
    checking `deadline` between calls. Then check at the final positions:
    energy fell; constraints hold to twice the tolerance; the float32
    objective's forces against the float64 objective's; the reciprocal
    forces of the dense path (kernels 4-5, by autograd) against the z-slab
    path's (kernels 2-3). Kernel launch counts are zeroed before the calls
    and read right after them; the caller checks them."""
    deadline = deadline or Deadline(math.inf)
    platform = "CUDA" if device.type == "cuda" else "CPU"
    system, positions = tip3p_water_box(n_waters)
    integ = omm.LangevinMiddleIntegrator(300.0, FRICTION, DT_PS)
    ctx = (omm.Context(system, integ) if platform == "CUDA"
           else omm.Context(system, integ, platform))
    ctx.setPositions(positions)
    before = in_md(ctx.getState(getEnergy=True).getPotentialEnergy())
    reporter = _Iterations()
    for kern in KERNELS:
        kern.launches = 0
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(calls):
        omm.LocalEnergyMinimizer.minimize(ctx, MINIMIZE_TOLERANCE, iterations,
                                          reporter)
        deadline.check("minimization")
    _sync(device)
    elapsed = time.perf_counter() - t0
    launches = {k.name: k.launches for k in MINIMIZER_KERNELS}
    evaluations = ctx.energy_evaluations
    st = ctx.getState(getEnergy=True, getPositions=True)
    after, x = in_md(st.getPotentialEnergy()), in_md(st.getPositions(
        asNumpy=True))
    constraint_err = _constraint_error(system, x)
    tol = integ.getConstraintTolerance()

    e32, f32 = ctx._make_position_energy_fn()(x)
    oracle = omm.Context(system, omm.LangevinMiddleIntegrator(
        300.0, FRICTION, DT_PS), platform, {"Precision": "double"})
    e64, f64 = oracle._make_position_energy_fn()(x)
    del oracle
    grad_err = _median_relative_error(f32, f64)
    deadline.check("minimization: float64 objective")

    m = ctx._nonbonded
    box = torch.as_tensor(in_md(system.getDefaultPeriodicBoxVectors()),
                          dtype=torch.float64, device=device)
    posf = torch.as_tensor(x, dtype=torch.float32, device=device)
    posg = posf.clone().requires_grad_()
    bsq = (m.bsq_x, m.bsq_y, m.bsq_z)
    e_dense = pme_mod.pme_reciprocal_energy(posg, m.charge, box, m.grid,
                                            pme_zslab.ORDER, m.alpha, *bsq)
    (g_dense,) = torch.autograd.grad(e_dense, posg)
    e_slab, f_slab = pme_zslab.pme_recip_ef(posf, m.charge, box.float(),
                                            m.grid, m.alpha, bsq)
    recip_err = _median_relative_error(-g_dense.double().cpu().numpy(),
                                       f_slab.double().cpu().numpy())

    print("minimization: %d atoms, %d calls of %d iterations: %d iterations,"
          " %d objective evaluations in %.2f s (%.2f ms each); energy %.3f "
          "-> %.3f kJ/mol" % (system.getNumParticles(), calls, iterations,
                              reporter.count, evaluations, elapsed,
                              elapsed / max(evaluations, 1) * 1e3, before,
                              after))
    print("minimization: launches %s; largest relative constraint error "
          "%.3e (bar %.0e); float32 vs float64 objective: median force "
          "error %.3e (bar %.0e), energy %.6f vs %.6f; dense vs z-slab "
          "reciprocal: median force difference %.3e (bar %.0e), energy "
          "%.6f vs %.6f" % (
              json.dumps(launches), constraint_err, 2 * tol, grad_err,
              FORCE_ERR_BAR, e32, e64, recip_err, FORCE_ERR_BAR,
              float(e_dense.detach()), float(e_slab)))
    if not (math.isfinite(after) and after < before):
        raise RuntimeError("minimization did not lower the energy: %.3f -> "
                           "%.3f" % (before, after))
    if not constraint_err < 2 * tol:
        raise RuntimeError("constraint error %.3e after minimization"
                           % constraint_err)
    if not grad_err <= FORCE_ERR_BAR:
        raise RuntimeError("float32 objective forces %.3e from float64"
                           % grad_err)
    if not recip_err <= FORCE_ERR_BAR:
        raise RuntimeError("dense and z-slab reciprocal forces differ by "
                           "%.3e" % recip_err)
    return {"launches": launches, "iterations": reporter.count,
            "evaluations": evaluations, "seconds": elapsed,
            "energies": (before, after), "constraint_err": constraint_err,
            "grad_err": grad_err, "recip_err": recip_err}


def phase_bilayer(device, deadline=None, bilayer=None,
                  steps=BILAYER_STEPS, production=BILAYER_PRODUCTION,
                  energy_every=ENERGY_EVERY,
                  minimize_iterations=BILAYER_MINIMIZE_ITERATIONS) -> dict:
    """The POPC bilayer (popc_bilayer(), or `bilayer` = (system,
    positions)) on a Context of its own (the default platform on a GPU,
    "CPU" otherwise): kernels 1-3 against their plain versions at its
    shapes; at the patch's coordinates the float32 forces and each force
    group's energy against the float64 plain path; then, with the kernel
    counts set to 0, applyConstraints and one minimize call of
    `minimize_iterations` iterations, velocities at BILAYER_TEMPERATURE,
    `steps` steps and `production` timed steps through the step program,
    and the same production steps again from a snapshot through the eager
    loop, which must give the same bits, energies, rebuilds and launches.
    Raises on a miss."""
    deadline = deadline or Deadline(math.inf)
    platform = "CUDA" if device.type == "cuda" else "CPU"
    system, positions = bilayer or popc_bilayer()
    for force in system.getForces():
        force.setForceGroup(BILAYER_GROUPS[type(force).__name__])
    n = system.getNumParticles()
    inp = kernel_inputs(device, 0, system=system, positions=positions)
    grid = inp["grid"]
    errors = phase_kernels(device, inp, deadline, names=MAIN_PATH_NAMES,
                           label=" (bilayer)")
    scale = inp["module"].capacity_scale
    if device.type == "cuda":
        calls = _kernel_calls(inp)
        bounds = kernel_bounds(inp, tile_counts(inp))
        for name in MAIN_PATH_NAMES:
            print("kernel %-17s (bilayer) %.4f ms a call, bound %.5f ms (%s)"
                  % (name, _time_ms(calls[name][0], device), *bounds[name]))
        del calls
        deadline.check("bilayer: kernel times")
    del inp
    integ = omm.LangevinMiddleIntegrator(BILAYER_TEMPERATURE, FRICTION,
                                         DT_PS)
    integ.setRandomNumberSeed(9)
    ctx = (omm.Context(system, integ) if platform == "CUDA"
           else omm.Context(system, integ, platform))
    oracle = omm.Context(system, omm.LangevinMiddleIntegrator(
        BILAYER_TEMPERATURE, FRICTION, DT_PS), platform,
        {"Precision": "double"})
    counts = {type(f).__name__: getattr(f, COUNTED[type(f).__name__])()
              for f in system.getForces()}
    print("bilayer: %d atoms, box %s nm, PME grid %s; terms %s (NonbondedForce"
          ": exceptions, CMMotionRemover: frequency); constraints %d: "
          "SETTLE %d / SHAKE %d / CCMA %d; capacity scale %.2f at the start"
          % (n,
             np.array2string(np.diag(in_md(
                 system.getDefaultPeriodicBoxVectors())),
                                precision=4, separator=","),
             "x".join(map(str, grid)), json.dumps(counts),
             system.getNumConstraints(), *ctx.constraint_split, scale))
    deadline.check("bilayer: set-up and kernels")

    groups = sorted(set(BILAYER_GROUPS.values()))
    energies = {}
    for c in (ctx, oracle):
        # getState does not grow the capacity: start at the kernels' scale
        c._nonbonded.capacity_scale = scale
        c.setPositions(positions)
    st = ctx.getState(getForces=True, getEnergy=True)
    ref = oracle.getState(getForces=True, getEnergy=True)
    force_err = _median_relative_error(in_md(st.getForces(asNumpy=True)),
                                       in_md(ref.getForces(asNumpy=True)))
    for g in groups:
        pair = [in_md(c.getState(getEnergy=True,
                                 groups={g}).getPotentialEnergy())
                for c in (ctx, oracle)]
        energies[g] = (*pair, abs(pair[0] - pair[1]) / max(abs(pair[1]),
                                                          1e-300))
    del oracle
    print("bilayer: median force error vs float64 plain path %.3e (bar "
          "%.0e); energy %.6f vs %.6f kJ/mol; by group (float32, float64, "
          "relative error; bar %.0e): %s" % (
              force_err, FORCE_ERR_BAR, in_md(st.getPotentialEnergy()),
              in_md(ref.getPotentialEnergy()), GROUP_ENERGY_BAR,
              "; ".join("%d: %.4f %.4f %.2e" % (g, *energies[g])
                        for g in groups)))
    if not force_err <= FORCE_ERR_BAR:
        raise RuntimeError("bilayer: median force error %.3e above %.0e"
                           % (force_err, FORCE_ERR_BAR))
    for g, (e32, e64, rel) in energies.items():
        if not (rel <= GROUP_ENERGY_BAR or e32 == e64):
            raise RuntimeError("bilayer: group %d energy %.6f vs %.6f"
                               % (g, e32, e64))
    deadline.check("bilayer: float64 oracle")

    for kern in KERNELS:
        kern.launches = 0
    ctx.applyConstraints()
    before = in_md(ctx.getState(getEnergy=True).getPotentialEnergy())
    reporter = _Iterations()
    _sync(device)
    t0 = time.perf_counter()
    omm.LocalEnergyMinimizer.minimize(ctx, MINIMIZE_TOLERANCE,
                                      minimize_iterations, reporter)
    _sync(device)
    minimize_s = time.perf_counter() - t0
    st = ctx.getState(getEnergy=True, getPositions=True)
    after = in_md(st.getPotentialEnergy())
    minimized = in_md(st.getPositions(asNumpy=True))
    minimized_err = _constraint_error(system, minimized)
    tol = integ.getConstraintTolerance()
    print("bilayer: minimize (%d iterations a stage): %d iterations, %d "
          "evaluations in %.2f s; energy %.3f -> %.3f kJ/mol; largest "
          "relative constraint error %.3e (bar %.0e)" % (
              minimize_iterations, reporter.count, ctx.energy_evaluations,
              minimize_s, before, after, minimized_err, 2 * tol))
    if not (math.isfinite(after) and after < before):
        raise RuntimeError("bilayer: minimization did not lower the energy:"
                           " %.3f -> %.3f" % (before, after))
    if not minimized_err < 2 * tol:
        raise RuntimeError("bilayer: constraint error %.3e after "
                           "minimization" % minimized_err)
    deadline.check("bilayer: minimization")

    ctx.setVelocitiesToTemperature(BILAYER_TEMPERATURE, randomSeed=3)
    for done in range(0, steps, energy_every):
        integ.step(min(energy_every, steps - done))
        deadline.check("bilayer: steps")
    start = ctx._snapshot()
    graph = _production(device, ctx, integ.step,
                        in_md(ctx.getState(
                            getEnergy=True).getPotentialEnergy()),
                        production, energy_every, deadline)
    temperature = ctx.temperature()
    x = in_md(ctx.getState(getPositions=True).getPositions(asNumpy=True))
    constraint_err = _constraint_error(system, x)
    rebuilds, escalations = ctx.rebuild_count, ctx.escalation_count
    ctx._restore(start)
    eager = _production(device, ctx, ctx._step_eager, graph["energies"][0],
                        production, energy_every, deadline)
    launches = {k.name: k.launches for k in KERNELS}
    _same_bits("bilayer production", (graph["positions"],
                                      graph["velocities"]),
               (eager["positions"], eager["velocities"]))
    for name in ("energies", "rebuilds", "launches"):
        if graph[name] != eager[name]:
            raise RuntimeError("bilayer: the step program's %s %s, the eager "
                               "loop's %s" % (name, graph[name], eager[name]))
    print("bilayer: %d + %d steps at %.3f ps (friction %.1f/ps, %.2f K) "
          "through the step program; energies %s kJ/mol; T %.2f K (dof 3n - "
          "constraints - 3); rebuilds %d, escalations %d (capacity scale "
          "%.2f); largest relative constraint error %.3e (bar %.0e)" % (
              steps, production, DT_PS, FRICTION, BILAYER_TEMPERATURE,
              " ".join("%.1f" % e for e in graph["energies"]), temperature,
              rebuilds, escalations, ctx._nonbonded.capacity_scale,
              constraint_err, CONSTRAINT_ERR_BAR))
    print("bilayer: eager loop from the same snapshot: the same bits, "
          "energies, rebuilds %s and launches %s; ns/day %.2f (graph) vs "
          "%.2f (eager); per step %.4f ms wall, %.4f ms host issue (graph)"
          % (graph["rebuilds"], json.dumps(graph["launches"]),
             graph["ns_day"], eager["ns_day"], graph["wall_ms_per_step"],
             graph["host_issue_ms_per_step"]))
    print("bilayer path launches (minimize, steps, production, eager "
          "replay): %s" % json.dumps(launches))
    if not all(math.isfinite(e) for e in graph["energies"]):
        raise RuntimeError("bilayer: a potential energy is not finite")
    if not 250.0 <= temperature <= 360.0:
        raise RuntimeError("bilayer: temperature %.2f K outside 250-360 K"
                           % temperature)
    if not constraint_err <= CONSTRAINT_ERR_BAR:
        raise RuntimeError("bilayer: constraint error %.3e" % constraint_err)
    if device.type == "cuda" and min(launches.values()) <= 0:
        raise RuntimeError("bilayer: a kernel of its path never launched: %s"
                           % launches)
    deadline.check("bilayer: production")
    return {"errors": errors, "force_err": force_err, "energies": energies,
            "minimized": (before, after), "temperature": temperature,
            "constraint_err": constraint_err, "graph": graph,
            "eager": eager, "launches": launches, "rebuilds": rebuilds,
            "escalations": escalations, "split": ctx.constraint_split,
            "ns_day": graph["ns_day"], "system": system,
            "minimized_positions": minimized, "context": ctx,
            "step": integ.step}


def _canonical_rows(params, atoms, par) -> np.ndarray:
    """A term list of a from_numpy dict as rows (atoms, parameters) in
    lexical order."""
    rows = np.concatenate([np.asarray(params[atoms], np.float64),
                           np.asarray(params[par], np.float64).reshape(
                               len(params[atoms]), -1)], axis=1)
    return rows[np.lexsort(rows.T[::-1])]


def gate_same_system(system, reference) -> list:
    """Raise unless every array of to_numpy(system) equals
    to_numpy(reference), a term list in either order, and the box within
    APP_BOX_BAR (a PDB file's CRYST1 record holds it to 0.001 A): the
    names of the term lists that held the same terms in another order."""
    got, want = omm.to_numpy(system), omm.to_numpy(reference)
    if sorted(got) != sorted(want):
        raise RuntimeError("app bilayer: the System's keys %s, the "
                           "reference's %s" % (sorted(got), sorted(want)))
    reordered = []
    paired = {k for pair in builders.TERM_KEYS for k in pair}
    for atoms, par in builders.TERM_KEYS:
        if atoms not in want:
            continue
        if (np.array_equal(got[atoms], want[atoms])
                and np.array_equal(got[par], want[par])):
            continue
        if not np.array_equal(_canonical_rows(got, atoms, par),
                              _canonical_rows(want, atoms, par)):
            raise RuntimeError("app bilayer: %s differ from the reference's "
                               "in content" % atoms)
        reordered.append(atoms)
    box_err = float(np.abs(got["box"] - want["box"]).max())
    if not box_err <= APP_BOX_BAR:
        raise RuntimeError("app bilayer: the box is %.3e nm off the "
                           "reference's" % box_err)
    for key in sorted(set(want) - paired - {"box"}):
        if not np.array_equal(np.asarray(got[key]), np.asarray(want[key])):
            raise RuntimeError("app bilayer: %s differs from the reference's"
                               % key)
    return reordered


# the transmembrane helix of phase_modeller_membrane: ACE-(ALA)n-NME as
# an ideal alpha helix, heavy atoms only, from internal coordinates
HELIX_ALANINES = 20
HELIX_PHI, HELIX_PSI, HELIX_OMEGA = -57.0, -47.0, 180.0     # degrees
# bond lengths (nm) and angles (degrees) of the backbone (Engh and Huber)
_N_CA, _CA_C, _C_N, _C_O, _CA_CB = 0.1458, 0.1525, 0.1329, 0.1231, 0.1530
_N_CA_C, _CA_C_N, _C_N_CA, _N_C_O, _N_CA_CB = 111.2, 116.2, 121.7, 122.7, \
    110.5
_CHI_CB = -122.6    # dihedral C-N-CA-CB of an L residue


def _place(a, b, c, bond, angle, torsion) -> np.ndarray:
    """The atom d bonded to c at `bond`, with the angle b-c-d `angle` and
    the dihedral a-b-c-d `torsion` (degrees; the natural extension of the
    reference frame)."""
    angle, torsion = math.radians(angle), math.radians(torsion)
    bc = (c - b) / np.linalg.norm(c - b)
    n = np.cross(b - a, bc)
    n /= np.linalg.norm(n)
    m = np.cross(n, bc)
    return c + bond * (-math.cos(angle) * bc
                       + math.sin(angle) * math.cos(torsion) * m
                       + math.sin(angle) * math.sin(torsion) * n)


def dihedral(a, b, c, d) -> float:
    """The dihedral a-b-c-d in degrees (IUPAC sign)."""
    b0, b1, b2 = a - b, c - b, d - c
    b1 = b1 / np.linalg.norm(b1)
    v = b0 - np.dot(b0, b1) * b1
    w = b2 - np.dot(b2, b1) * b1
    return math.degrees(math.atan2(np.dot(np.cross(b1, v), w),
                                   np.dot(v, w)))


def helix_residues(n_ala=HELIX_ALANINES) -> list:
    """[(residue name, [(atom name, element, xyz nm)])] of ACE-(ALA)n-NME
    as an ideal alpha helix (phi HELIX_PHI, psi HELIX_PSI, omega
    HELIX_OMEGA), heavy atoms only, its axis along z through the origin."""
    # the backbone trace: ACE's CH3 and C, then N, CA, C of each alanine,
    # then NME's N and CH3
    ch3 = np.zeros(3)
    c0 = np.array([_CA_C, 0.0, 0.0])
    n1 = c0 + _C_N * np.array([-math.cos(math.radians(_CA_C_N)),
                               math.sin(math.radians(_CA_C_N)), 0.0])
    trace = [ch3, c0, n1]
    # each next atom: (bond, angle at its neighbour, dihedral)
    for _ in range(n_ala):
        trace.append(_place(trace[-3], trace[-2], trace[-1], _N_CA, _C_N_CA,
                            HELIX_OMEGA))
        trace.append(_place(trace[-3], trace[-2], trace[-1], _CA_C,
                            _N_CA_C, HELIX_PHI))
        trace.append(_place(trace[-3], trace[-2], trace[-1], _C_N, _CA_C_N,
                            HELIX_PSI))
    trace.append(_place(trace[-3], trace[-2], trace[-1], _N_CA, _C_N_CA,
                        HELIX_OMEGA))
    # O of each carbonyl cis to the next residue's CA (a trans peptide)
    carbonyl = [(3 * k + 1, 3 * k + 2, 3 * k + 3) for k in range(n_ala + 1)]
    oxygens = [_place(trace[ca_next], trace[n_next], trace[c], _C_O,
                      _N_C_O, 0.0) for c, n_next, ca_next in carbonyl]
    residues = [("ACE", [("CH3", "C", trace[0]), ("C", "C", trace[1]),
                         ("O", "O", oxygens[0])])]
    for k in range(n_ala):
        n, ca, c = trace[3 * k + 2], trace[3 * k + 3], trace[3 * k + 4]
        cb = _place(c, n, ca, _CA_CB, _N_CA_CB, _CHI_CB)
        residues.append(("ALA", [("N", "N", n), ("CA", "C", ca),
                                 ("C", "C", c), ("O", "O", oxygens[k + 1]),
                                 ("CB", "C", cb)]))
    residues.append(("NME", [("N", "N", trace[-2]),
                             ("CH3", "C", trace[-1])]))
    # the axis: the CA trace's principal direction, turned onto z
    cas = np.asarray([atoms[1][2] for name, atoms in residues[1:-1]])
    centre = cas.mean(axis=0)
    _, _, vt = np.linalg.svd(cas - centre)
    axis = vt[0] if vt[0][2] >= 0 else -vt[0]
    x = np.cross(axis, [0.0, 0.0, 1.0])
    if np.linalg.norm(x) < 1e-12:
        rot = np.eye(3)
    else:
        x /= np.linalg.norm(x)
        y = np.cross(axis, x)
        rot = np.stack([x, y, axis])    # rows: the new x, y, z
    return [(name, [(a, el, rot @ (xyz - centre)) for a, el, xyz in atoms])
            for name, atoms in residues]


def helix_pdb_text(n_ala=HELIX_ALANINES) -> str:
    """The helix of helix_residues as PDB text, written by the port's
    PDBFile (bonds from the standard residue table)."""
    from openmm_tpu_torch.app import Element, PDBFile, Topology
    top = Topology()
    chain = top.addChain("A")
    positions = []
    for name, atoms in helix_residues(n_ala):
        res = top.addResidue(name, chain)
        for atom, symbol, xyz in atoms:
            top.addAtom(atom, Element.getBySymbol(symbol), res)
            positions.append(omm.Vec3(*xyz))
    top.createStandardBonds()
    text = io.StringIO()
    PDBFile.writeFile(top, omm.unit.Quantity(positions, omm.unit.nanometer),
                      text)
    return text.getvalue()


def read_dcd(path, n_atoms) -> np.ndarray:
    """(frames, n_atoms, 3) positions in nm of a DCD file that DCDFile
    wrote (a unit-cell record before each frame)."""
    with open(path, "rb") as f:
        data = f.read()
    frames = int(np.frombuffer(data, "<i4", 1, 8)[0])
    header = 84 + 8 + 164 + 8 + 4 + 8
    record = 56 + 3 * (8 + 4 * n_atoms)
    if len(data) != header + frames * record:
        raise RuntimeError("DCD: %d bytes, %d frames of %d atoms expected "
                           "%d" % (len(data), frames, n_atoms,
                                   header + frames * record))
    out = np.empty((frames, n_atoms, 3))
    for k in range(frames):
        at = header + k * record + 56
        for axis in range(3):
            out[k, :, axis] = np.frombuffer(data, "<f4", n_atoms,
                                            at + 4) / 10.0
            at += 8 + 4 * n_atoms
    return out


def app_bilayer_build(patch=None, reference=None) -> dict:
    """phase_app_bilayer's host work: the patch written with
    PDBFile.writeFile and read back, its System from
    ForceField(*APP_FORCEFIELD).createSystem(PME, APP_CUTOFF nm, HBonds)
    gated equal to models.popc_bilayer()'s (or `reference`'s); the
    topology, positions, Systems and seconds, for the phase."""
    import os
    import tempfile

    from openmm_tpu_torch import app
    from openmm_tpu_torch import unit as u
    from openmm_tpu_torch.app.modeller import _load_membrane_patch

    top, pos = patch or _load_membrane_patch("POPC")[:2]
    ref_system, _ = reference or popc_bilayer()
    with tempfile.TemporaryDirectory() as tmp:
        pdb_path = os.path.join(tmp, "bilayer.pdb")
        t0 = time.perf_counter()
        app.PDBFile.writeFile(top, u.Quantity(pos, u.nanometer), pdb_path)
        pdb = app.PDBFile(pdb_path)
        pdb_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    forcefield = app.ForceField(*APP_FORCEFIELD)
    system = forcefield.createSystem(
        pdb.topology, nonbondedMethod=app.PME,
        nonbondedCutoff=APP_CUTOFF * u.nanometer, constraints=app.HBonds)
    create_s = time.perf_counter() - t0
    return {"topology": pdb.topology, "positions": pdb.positions,
            "system": system, "reference": ref_system, "pdb_s": pdb_s,
            "create_s": create_s,
            "reordered": gate_same_system(system, ref_system)}


def write_app_build(path) -> None:
    """app_bilayer_build and more_custom_references pickled to `path` (a
    process of its own that sees no card, beside the kernel phases)."""
    out = (app_bilayer_build(), more_custom_references())
    with open(path, "wb") as f:
        pickle.dump(out, f)


def phase_app_bilayer(device, deadline=None, patch=None, reference=None,
                      steps=APP_STEPS, report_every=APP_REPORT_EVERY,
                      minimize_iterations=APP_MINIMIZE_ITERATIONS,
                      turn_steps=APP_TURN_STEPS, turns=APP_TURNS,
                      t_band=APP_T_BAND,
                      minimize_tolerance=MINIMIZE_TOLERANCE,
                      built=None) -> dict:
    """The POPC bilayer through the app layer, as a user builds it: the
    patch (app.modeller._load_membrane_patch("POPC"), or `patch` =
    (Topology, positions in nm)) written with PDBFile.writeFile to a
    temporary file and read back with PDBFile, its System from
    ForceField(*APP_FORCEFIELD).createSystem(PME, APP_CUTOFF nm, HBonds),
    gated equal to models.popc_bilayer()'s (or `reference` = (System,
    positions)) array by array, a term list in any order; both Systems'
    energies (APP_ENERGY_BAR relative) and forces (median relative
    difference APP_FORCE_BAR) at the PDB's positions on the device. Then
    Simulation(topology, system, LangevinMiddleIntegrator(300 K, 1/ps,
    2 fs)) on the default platform (the "CPU" one off a card), the PDB's
    positions, minimizeEnergy(`minimize_tolerance`,
    `minimize_iterations`) (kernels 1, 4 and 5), velocities at APP_TEMPERATURE, a
    StateDataReporter and a DCDReporter every `report_every` steps and
    step(`steps`) (kernels 1-3): every reported energy finite, the last
    report's temperature within `t_band` K of APP_TEMPERATURE, the DCD's
    frames read back, the last equal to the final positions within
    float32 rounding. Last, Simulation.step (reporters included) against
    the reference's plain Context, `turn_steps` steps a call in the order
    `turns`. Raises on a miss; returns the System, the PDB's positions and
    the reference System for the later bilayer phases. `built`:
    app_bilayer_build's result (made beside the kernel phases, in
    write_app_build's process); without, it is made here."""
    import os
    import tempfile

    from openmm_tpu_torch import app
    from openmm_tpu_torch import unit as u

    deadline = deadline or Deadline(math.inf)
    platform = (None if device.type == "cuda"
                else omm.Platform.getPlatformByName("CPU"))
    built = built or app_bilayer_build(patch, reference)
    system, ref_system = built["system"], built["reference"]
    pdb = types.SimpleNamespace(topology=built["topology"],
                                positions=built["positions"])
    pdb_s, create_s = built["pdb_s"], built["create_s"]
    reordered = built["reordered"]
    with tempfile.TemporaryDirectory() as tmp:
        n = system.getNumParticles()
        print("app bilayer: %d atoms; PDBFile write and read %.2f s, "
              "ForceField(%s).createSystem %.2f s on the host; the System "
              "equals models.popc_bilayer()'s, the term lists %s in "
              "another order" % (n, pdb_s, ", ".join(APP_FORCEFIELD),
                                 create_s, reordered or "none"))
        deadline.check("app bilayer: createSystem")

        pdb_pos = np.asarray(u.strip(pdb.positions, u.nanometer),
                             np.float64)
        integ = omm.LangevinMiddleIntegrator(
            APP_TEMPERATURE * u.kelvin, 1 / u.picosecond,
            DT_PS * u.picoseconds)
        integ.setRandomNumberSeed(11)
        sim = app.Simulation(pdb.topology, system, integ, platform)
        plain_integ = omm.LangevinMiddleIntegrator(APP_TEMPERATURE,
                                                   FRICTION, DT_PS)
        plain = omm.Context(ref_system, plain_integ, platform)
        # both at the PDB's box (the Simulation takes its topology's)
        plain.setPeriodicBoxVectors(
            *pdb.topology.getPeriodicBoxVectors().value_in_unit(u.nanometer))
        for ctx in (sim.context, plain):
            ctx.setPositions(pdb_pos)
        got, want = (c.getState(getEnergy=True, getForces=True)
                     for c in (sim.context, plain))
        e_rel = abs(in_md(got.getPotentialEnergy()) - in_md(
            want.getPotentialEnergy())) \
            / abs(in_md(want.getPotentialEnergy()))
        f_err = _median_relative_error(in_md(got.getForces(asNumpy=True)),
                                       in_md(want.getForces(asNumpy=True)))
        print("app bilayer: at the PDB's positions energy %.6f vs %.6f "
              "kJ/mol (relative %.3e, bar %.0e), median relative force "
              "difference %.3e (bar %.0e)" % (
                  in_md(got.getPotentialEnergy()), in_md(
                      want.getPotentialEnergy()),
                  e_rel, APP_ENERGY_BAR, f_err, APP_FORCE_BAR))
        if not (e_rel <= APP_ENERGY_BAR and f_err <= APP_FORCE_BAR):
            raise RuntimeError("app bilayer: the ForceField System's energy "
                               "(%.3e) or forces (%.3e) differ from the "
                               "reference's" % (e_rel, f_err))
        deadline.check("app bilayer: energies")

        sim.context.setPositions(pdb.positions)
        for kern in KERNELS:
            kern.launches = 0
        t0 = time.perf_counter()
        sim.minimizeEnergy(minimize_tolerance, minimize_iterations)
        _sync(device)
        minimize_s = time.perf_counter() - t0
        minimize_launches = {k.name: k.launches for k in KERNELS}
        sim.context.setVelocitiesToTemperature(APP_TEMPERATURE * u.kelvin,
                                               VELOCITY_SEED)
        log = io.StringIO()
        dcd_path = os.path.join(tmp, "bilayer.dcd")
        sim.reporters.append(app.StateDataReporter(
            log, report_every, step=True, potentialEnergy=True,
            kineticEnergy=True, temperature=True, volume=True))
        sim.reporters.append(app.DCDReporter(dcd_path, report_every))
        for kern in KERNELS:
            kern.launches = 0
        _sync(device)
        t0 = time.perf_counter()
        sim.step(steps)
        _sync(device)
        steps_s = time.perf_counter() - t0
        step_launches = {k.name: k.launches for k in KERNELS}
        final = in_md(sim.context.getState(getPositions=True,
                                     enforcePeriodicBox=True).getPositions(
                                         asNumpy=True))
        frames = read_dcd(dcd_path, n)
        deadline.check("app bilayer: steps")
    lines = log.getvalue().splitlines()
    header = [h.strip('"') for h in lines[0][2:].split('","')]
    rows = [dict(zip(header, line.split(","))) for line in lines[1:]]
    energies = [float(r["Potential Energy (kJ/mole)"]) for r in rows]
    temperature = float(rows[-1]["Temperature (K)"])
    dcd_err = float(np.abs(frames[-1] - final).max())
    dcd_bar = float(np.spacing(np.float32(10.0 * np.abs(final).max()))) / 10
    print("app bilayer: Simulation.minimizeEnergy(maxIterations=%d) %.2f s, "
          "launches %s; step(%d) with a StateDataReporter and a DCDReporter "
          "every %d steps %.2f s, launches %s; reported energies %s kJ/mol, "
          "temperature %.2f K at step %s; DCD %d frames, the last %.3e nm "
          "from the final positions (float32 rounding %.3e)" % (
              minimize_iterations, minimize_s,
              json.dumps(minimize_launches), steps, report_every, steps_s,
              json.dumps(step_launches),
              " ".join("%.1f" % e for e in energies), temperature,
              rows[-1]["Step"], len(frames), dcd_err, dcd_bar))
    if not all(math.isfinite(e) for e in energies) or \
            len(energies) != steps // report_every:
        raise RuntimeError("app bilayer: reported energies %s" % energies)
    if not abs(temperature - APP_TEMPERATURE) <= t_band:
        raise RuntimeError("app bilayer: temperature %.2f K outside %.0f +- "
                           "%.0f K" % (temperature, APP_TEMPERATURE, t_band))
    if len(frames) != steps // report_every or not dcd_err <= dcd_bar:
        raise RuntimeError("app bilayer: the DCD holds %d frames, the last "
                           "%.3e nm off" % (len(frames), dcd_err))
    if device.type == "cuda":
        missing = [k.name for k in (tile_pairs.TILES, pallas_pme.FWD,
                                    pallas_pme.BWD)
                   if minimize_launches[k.name] <= 0]
        missing += [name for name in MAIN_PATH_NAMES
                    if step_launches[name] <= 0]
        if missing:
            raise RuntimeError("app bilayer: kernels %s of its path never "
                               "launched" % missing)

    plain.setVelocitiesToTemperature(APP_TEMPERATURE, VELOCITY_SEED)
    plain_integ.step(1)                 # its capture, untimed
    timed = _in_turns(device, {"simulation": (sim.context, sim.step),
                               "plain": (plain, plain_integ.step)},
                      turn_steps, turns, deadline, "app bilayer")
    ms = {k: statistics.median(v[0]) for k, v in timed.items()}
    print("app bilayer in turns (%s, %d steps a call): ms a step through "
          "Simulation (reporters every %d steps included) %s, plain "
          "models.popc_bilayer() Context %s; median %.4f vs %.4f" % (
              " ".join(turns), turn_steps, report_every,
              " ".join("%.4f" % m for m in timed["simulation"][0]),
              " ".join("%.4f" % m for m in timed["plain"][0]),
              ms["simulation"], ms["plain"]))
    deadline.check("app bilayer: in turns")
    return {"system": system, "positions": pdb_pos,
            "reference": ref_system, "create_s": create_s,
            "reordered": reordered, "energy_rel": e_rel, "force_err": f_err,
            "temperature": temperature, "energies": energies,
            "frames": len(frames), "dcd_err": dcd_err,
            "minimize_launches": minimize_launches,
            "step_launches": step_launches, "ms": ms}


def _centroid_z(positions, atoms) -> float:
    return float(np.mean(positions[np.asarray(atoms), 2]))


def _bias_by_numpy(deposits, width, lo, hi, grid_width) -> np.ndarray:
    """The sum of the deposited Gaussians, height h at CV value x each,
    on the grid of grid_width points over [lo, hi]."""
    grid = np.linspace(lo, hi, grid_width)
    out = np.zeros(grid_width)
    for x, h in deposits:
        out += h * np.exp(-0.5 * ((x - grid) / width) ** 2)
    return out


def modeller_membrane_build(device, deadline=None, n_ala=HELIX_ALANINES,
                            relax=MEMBRANE_RELAX, patch=None,
                            padding=MEMBRANE_PADDING,
                            ionic=MEMBRANE_IONIC) -> dict:
    """phase_modeller_membrane's build: ACE-(ALA)n-NME through PDBFile,
    Modeller.addHydrogens (gated not to move a heavy atom),
    addMembrane (its relaxation's captures and rebuilds gated) and
    createSystem(PME 0.9 nm, HBonds). It times no device work, so
    write_membrane runs it in a helper process. Returns what the phase
    reads: the topology, positions and System, the helix's
    atom count, the host seconds and the relaxation's counts and
    launches. Raises on a miss."""
    from openmm_tpu_torch import app
    from openmm_tpu_torch import unit as u

    deadline = deadline or Deadline(math.inf)
    platform = (None if device.type == "cuda"
                else omm.Platform.getPlatformByName("CPU"))
    forcefield = app.ForceField(*MEMBRANE_FORCEFIELD)
    pdb = app.PDBFile(io.StringIO(helix_pdb_text(n_ala)))
    modeller = app.Modeller(pdb.topology, pdb.positions)
    heavy_before = in_md(modeller.getPositions())
    t0 = time.perf_counter()
    variants = modeller.addHydrogens(forcefield, platform=platform)
    hydrogens_s = time.perf_counter() - t0
    after = in_md(modeller.getPositions())
    heavy = [a.index for a in modeller.topology.atoms()
             if a.element.symbol != "H"]
    moved = float(np.abs(after[heavy] - heavy_before).max())
    n_helix = modeller.topology.getNumAtoms()
    if moved != 0.0 or any(v is not None for v in variants):
        raise RuntimeError("modeller membrane: addHydrogens moved a heavy "
                           "atom by %.3e nm or changed a variant %s"
                           % (moved, variants))
    deadline.check("modeller membrane: addHydrogens")

    made = []
    init = omm.Context.__init__

    def recording_init(ctx, *args, **kwargs):
        init(ctx, *args, **kwargs)
        made.append(ctx)

    for kern in KERNELS:
        kern.launches = 0
    omm.Context.__init__ = recording_init
    t0 = time.perf_counter()
    try:
        modeller.addMembrane(forcefield, lipidType=patch or "POPC",
                             minimumPadding=padding * u.nanometer,
                             ionicStrength=ionic * u.molar,
                             _relax_iterations=relax, platform=platform)
        _sync(device)
    finally:
        omm.Context.__init__ = init
    membrane_s = time.perf_counter() - t0
    membrane_launches = {k.name: k.launches for k in KERNELS}
    (relax_ctx,) = made
    captures, rebuilds = _captures(relax_ctx), relax_ctx.rebuild_count
    escalations = relax_ctx.escalation_count
    del made, relax_ctx
    top = modeller.topology
    names = [r.name for r in top.residues()]
    n = top.getNumAtoms()
    print("modeller membrane: ACE-(ALA)%d-NME, %d atoms with hydrogens "
          "(addHydrogens %.2f s, heavy atoms moved %.1e nm); addMembrane("
          "POPC, %.1f nm padding, %.2f M, %d relaxation rounds) %.2f s: %d "
          "atoms, %d lipids, %d waters, %d Na+, %d Cl-; relaxation captures "
          "%d (capacity escalations %d), candidate rebuilds %d, launches "
          "%s" % (
              n_ala, n_helix, hydrogens_s, moved, padding, ionic, relax,
              membrane_s, n, names.count("POP"), names.count("HOH"),
              names.count("NA"), names.count("CL"), captures, escalations,
              rebuilds, json.dumps(membrane_launches)))
    # one program a capacity: a round's setPositions drops the candidate
    # state (a rebuild) and replays the program it has
    if device.type == "cuda" and relax and not \
            1 <= captures <= 1 + escalations:
        raise RuntimeError("modeller membrane: the relaxation captured %d "
                           "graphs in %d rounds with %d escalations"
                           % (captures, relax, escalations))
    if relax and rebuilds < relax:
        raise RuntimeError("modeller membrane: %d candidate rebuilds in %d "
                           "rounds after setPositions" % (rebuilds, relax))
    deadline.check("modeller membrane: addMembrane")

    t0 = time.perf_counter()
    system = forcefield.createSystem(
        top, nonbondedMethod=app.PME, nonbondedCutoff=APP_CUTOFF * u.nanometer,
        constraints=app.HBonds)
    create_s = time.perf_counter() - t0
    deadline.check("modeller membrane: createSystem")
    return {"topology": top, "positions": modeller.positions,
            "system": system, "n_helix": n_helix,
            "hydrogens_s": hydrogens_s, "membrane_s": membrane_s,
            "create_s": create_s, "captures": captures,
            "escalations": escalations, "rebuilds": rebuilds,
            "membrane_launches": membrane_launches}


def phase_modeller_membrane(device, deadline=None, n_ala=HELIX_ALANINES,
                            relax=MEMBRANE_RELAX, patch=None,
                            padding=MEMBRANE_PADDING, ionic=MEMBRANE_IONIC,
                            minimize_iterations=MEMBRANE_MINIMIZE_ITERATIONS,
                            steps=MEMBRANE_STEPS,
                            plain_steps=MEMBRANE_PLAIN_STEPS,
                            report_every=MEMBRANE_REPORT_EVERY,
                            frequency=META_FREQUENCY,
                            t_band=APP_T_BAND, built=None) -> dict:
    """A transmembrane helix built as users build it: ACE-(ALA)n-NME
    (helix_pdb_text, heavy atoms) read with PDBFile, Modeller.addHydrogens
    (ForceField(*MEMBRANE_FORCEFIELD); the new hydrogens relaxed with the
    heavy atoms massless, gated not to move), addMembrane(lipidType="POPC"
    (or `patch`, an object with topology and positions), minimumPadding,
    ionicStrength, _relax_iterations=`relax`: kernel 1's RF mode; one
    capture for all the rounds and a candidate rebuild after each round's
    setPositions, gated), createSystem(PME 0.9 nm, HBonds), and a
    Simulation under LangevinMiddle (300 K, 1/ps, 2 fs) on the default
    platform: minimizeEnergy (kernels 1, 4, 5), `plain_steps` timed steps
    with a StateDataReporter and a PDBxReporter, then Metadynamics on the
    z distance between the helix's centroid and that of the lipids'
    phosphorus atoms (a CustomCentroidBondForce), a deposition every
    `frequency` steps over `steps` steps. Gates: finite reported
    energies, the last report's temperature within `t_band` K of
    APP_TEMPERATURE, the constraints within CONSTRAINT_ERR_BAR, the PDBx's
    last model read back with PDBxFile within PDBX_BAR of the positions,
    the CV within META_CV_BAR of numpy's centroids, the bias grid within
    META_GRID_BAR of numpy's sum of the deposited Gaussians, the bias
    energy (force group 31) within META_ENERGY_BAR of the table's natural
    spline (scipy) at the CV, and on a card every kernel launched.
    `built`: modeller_membrane_build's result (made here without).
    Raises on a miss."""
    import os
    import tempfile

    from scipy.interpolate import CubicSpline

    from openmm_tpu_torch import app
    from openmm_tpu_torch import unit as u

    deadline = deadline or Deadline(math.inf)
    platform = (None if device.type == "cuda"
                else omm.Platform.getPlatformByName("CPU"))
    if built is None:
        built = modeller_membrane_build(device, deadline, n_ala, relax,
                                        patch, padding, ionic)
    top, system = built["topology"], built["system"]
    n_helix, n = built["n_helix"], top.getNumAtoms()
    names = [r.name for r in top.residues()]
    membrane_launches = built["membrane_launches"]
    helix_atoms = list(range(n_helix))
    phosphorus = [a.index for a in top.atoms()
                  if a.residue.name == "POP" and a.element.symbol == "P"]
    cv = omm.CustomCentroidBondForce(2, "z1-z2")
    cv.addGroup(helix_atoms, [1.0] * len(helix_atoms))
    cv.addGroup(phosphorus, [1.0] * len(phosphorus))
    cv.addBond([0, 1])
    lo, hi = META_RANGE
    variable = app.BiasVariable(cv, lo * u.nanometer, hi * u.nanometer,
                                META_WIDTH * u.nanometer)
    meta = app.Metadynamics(system, [variable], APP_TEMPERATURE * u.kelvin,
                            META_BIAS_FACTOR,
                            META_HEIGHT * u.kilojoules_per_mole, frequency)
    deposits = []
    add_gaussian = meta._addGaussian

    def recording_gaussian(position, height, context):
        t0 = time.perf_counter()
        deposits.append((float(position[0]),
                         float(u.strip(height, u.kilojoule_per_mole))))
        add_gaussian(position, height, context)
        _sync(device)
        deposit_s.append(time.perf_counter() - t0)

    meta._addGaussian = recording_gaussian
    # a deposition's host work: the CV's value, the bias energy (group
    # 31) and the Gaussian with the table's update in the Context
    deposit_s = []
    read_cv = meta._force.getCollectiveVariableValues

    def timed_cv(context):
        t0 = time.perf_counter()
        out = read_cv(context)
        deposit_s.append(time.perf_counter() - t0)
        return out

    meta._force.getCollectiveVariableValues = timed_cv
    integ = omm.LangevinMiddleIntegrator(
        APP_TEMPERATURE * u.kelvin, MEMBRANE_FRICTION / u.picosecond,
        DT_PS * u.picoseconds)
    integ.setRandomNumberSeed(13)
    sim = app.Simulation(top, system, integ, platform)
    sim.context.setPositions(built["positions"])
    get_state = sim.context.getState

    def timed_state(*args, **kwargs):
        t0 = time.perf_counter()
        out = get_state(*args, **kwargs)
        if kwargs.get("groups") == {31}:
            deposit_s.append(time.perf_counter() - t0)
        return out

    sim.context.getState = timed_state
    for kern in KERNELS:
        kern.launches = 0
    t0 = time.perf_counter()
    sim.minimizeEnergy(MINIMIZE_TOLERANCE, minimize_iterations)
    _sync(device)
    minimize_s = time.perf_counter() - t0
    minimize_launches = {k.name: k.launches for k in KERNELS}
    sim.context.setVelocitiesToTemperature(APP_TEMPERATURE * u.kelvin,
                                           VELOCITY_SEED)
    deadline.check("modeller membrane: minimize")
    with tempfile.TemporaryDirectory() as tmp:
        log = io.StringIO()
        cif = os.path.join(tmp, "membrane.cif")
        sim.reporters.append(app.StateDataReporter(
            log, report_every, step=True, potentialEnergy=True,
            kineticEnergy=True, temperature=True))
        sim.reporters.append(app.PDBxReporter(cif, plain_steps + steps))
        for kern in KERNELS:
            kern.launches = 0
        sim.step(1)                      # the capture, untimed
        _sync(device)
        t0 = time.perf_counter()
        sim.step(plain_steps - 1)
        _sync(device)
        plain_s = time.perf_counter() - t0
        deadline.check("modeller membrane: steps")
        t0 = time.perf_counter()
        meta.step(sim, steps)
        _sync(device)
        meta_s = time.perf_counter() - t0
        sim.context.getState = get_state
        step_launches = {k.name: k.launches for k in KERNELS}
        state = sim.context.getState(getPositions=True, getEnergy=True,
                                     groups={31})
        wrapped = in_md(sim.context.getState(
            getPositions=True, enforcePeriodicBox=True).getPositions(
                asNumpy=True))
        del sim.reporters[:]
        frames = app.PDBxFile(cif)
        cif_pos = in_md(frames.getPositions(
            asNumpy=True, frame=frames.getNumFrames() - 1))
    deadline.check("modeller membrane: metadynamics")
    positions = in_md(state.getPositions(asNumpy=True))
    lines = log.getvalue().splitlines()
    header = [h.strip('"') for h in lines[0][2:].split('","')]
    rows = [dict(zip(header, line.split(","))) for line in lines[1:]]
    energies = [float(r["Potential Energy (kJ/mole)"]) for r in rows]
    temperature = float(rows[-1]["Temperature (K)"])
    constraint_err = _constraint_error(system, positions)
    pdbx_err = float(np.abs(cif_pos - wrapped).max())
    cv_value = meta.getCollectiveVariables(sim)[0]
    cv_numpy = _centroid_z(positions, helix_atoms) - _centroid_z(
        positions, phosphorus)
    grid = _bias_by_numpy(deposits, META_WIDTH, lo, hi, variable.gridWidth)
    grid_err = float(np.abs(grid - meta._totalBias).max())
    e31 = in_md(state.getPotentialEnergy())
    table = float(CubicSpline(np.linspace(lo, hi, variable.gridWidth),
                              meta._totalBias, bc_type="natural")(cv_value))
    e31_rel = abs(e31 - table) / max(abs(table), 1e-30)
    ms_plain = plain_s / (plain_steps - 1) * 1e3
    per_deposit_ms = sum(deposit_s) / max(len(deposits), 1) * 1e3
    print("modeller membrane: createSystem(PME %.1f nm, HBonds) %.2f s on "
          "the host; minimizeEnergy(maxIterations=%d) %.2f s, launches %s; "
          "%.4f ms a step with a StateDataReporter and a PDBxReporter; "
          "Metadynamics (CV z(helix) - z(%d P), %d depositions) %.2f s for "
          "%d steps, %.2f ms a deposition (the CV, the bias energy, the "
          "Gaussian and the table's update); launches in "
          "the steps %s" % (
              APP_CUTOFF, built["create_s"], minimize_iterations,
              minimize_s,
              json.dumps(minimize_launches), ms_plain, len(phosphorus),
              len(deposits), meta_s, steps, per_deposit_ms,
              json.dumps(step_launches)))
    print("modeller membrane: reported energies %s kJ/mol, temperature "
          "%.2f K at step %s; constraint error %.3e (bar %.0e); PDBx last "
          "model %.3e nm from the positions (bar %.1e); CV %.9f nm vs numpy "
          "%.9f (bar %.0e); bias grid %.3e from numpy's Gaussians (bar "
          "%.0e), max %.4f kJ/mol; group 31 energy %.9f vs the table's "
          "spline %.9f (relative %.3e, bar %.0e); deposits %s" % (
              " ".join("%.1f" % e for e in energies), temperature,
              rows[-1]["Step"], constraint_err, CONSTRAINT_ERR_BAR,
              pdbx_err, PDBX_BAR, cv_value, cv_numpy, META_CV_BAR, grid_err,
              META_GRID_BAR, float(meta._totalBias.max()), e31, table,
              e31_rel, META_ENERGY_BAR,
              " ".join("(%.4f, %.4f)" % d for d in deposits)))
    if not all(math.isfinite(e) for e in energies) or \
            len(energies) != (plain_steps + steps) // report_every:
        raise RuntimeError("modeller membrane: reported energies %s"
                           % energies)
    if not abs(temperature - APP_TEMPERATURE) <= t_band:
        raise RuntimeError("modeller membrane: temperature %.2f K outside "
                           "%.0f +- %.0f K" % (temperature, APP_TEMPERATURE,
                                               t_band))
    if not constraint_err <= CONSTRAINT_ERR_BAR:
        raise RuntimeError("modeller membrane: constraint error %.3e"
                           % constraint_err)
    if not pdbx_err <= PDBX_BAR * (1 + 1e-6):
        raise RuntimeError("modeller membrane: the PDBx model is %.3e nm "
                           "off" % pdbx_err)
    if not abs(cv_value - cv_numpy) <= META_CV_BAR:
        raise RuntimeError("modeller membrane: CV %.9f vs numpy %.9f"
                           % (cv_value, cv_numpy))
    if len(deposits) != steps // frequency or not grid_err <= META_GRID_BAR:
        raise RuntimeError("modeller membrane: %d deposits, the bias grid "
                           "%.3e off" % (len(deposits), grid_err))
    if not e31_rel <= META_ENERGY_BAR:
        raise RuntimeError("modeller membrane: bias energy %.9f vs the "
                           "table's %.9f" % (e31, table))
    if device.type == "cuda":
        missing = [k.name for k in (tile_pairs.TILES,)
                   if membrane_launches[k.name] <= 0]
        missing += [k.name for k in MINIMIZER_KERNELS
                    if minimize_launches[k.name] <= 0]
        missing += [name for name in MAIN_PATH_NAMES
                    if step_launches[name] <= 0]
        if missing:
            raise RuntimeError("modeller membrane: kernels %s of its path "
                               "never launched" % missing)
    return {"atoms": n, "lipids": names.count("POP"),
            "ions": (names.count("NA"), names.count("CL")),
            "hydrogens_s": built["hydrogens_s"],
            "membrane_s": built["membrane_s"],
            "create_s": built["create_s"], "captures": built["captures"],
            "escalations": built["escalations"],
            "rebuilds": built["rebuilds"],
            "membrane_launches": membrane_launches,
            "minimize_launches": minimize_launches,
            "step_launches": step_launches, "ms_per_step": ms_plain,
            "meta_s": meta_s, "per_deposit_ms": per_deposit_ms,
            "deposits": len(deposits), "temperature": temperature,
            "constraint_err": constraint_err, "pdbx_err": pdbx_err,
            "cv_err": abs(cv_value - cv_numpy), "grid_err": grid_err,
            "e31_rel": e31_rel}


SPCE_TOP = """[ defaults ]
1 2 yes 0.5 0.8333

[ atomtypes ]
OW  15.9994 -0.8476 A 0.316557 0.650194
HW  1.008    0.4238 A 0.0      0.0

[ moleculetype ]
SOL 2

[ atoms ]
1 OW 1 SOL OW 1 -0.8476 15.9994
2 HW 1 SOL HW1 1 0.4238 1.008
3 HW 1 SOL HW2 1 0.4238 1.008

[ settles ]
1 1 0.1 0.16330

[ exclusions ]
1 2 3
2 1 3
3 1 2

[ system ]
SPC/E water

[ molecules ]
SOL %d
"""


def water_gro_text(positions, box) -> str:
    """A water box (positions (3n, 3) nm in O, H, H order, cubic box
    width) as .gro text (GROMACS fixed columns, 0.001 nm)."""
    lines = ["SPC/E water", "%5d" % len(positions)]
    for k, p in enumerate(positions):
        lines.append("%5d%-5s%5s%5d%8.3f%8.3f%8.3f" % (
            (k // 3 + 1) % 100000, "SOL", ("OW", "HW1", "HW2")[k % 3],
            (k + 1) % 100000, p[0], p[1], p[2]))
    lines.append("%10.5f%10.5f%10.5f" % (box, box, box))
    return "\n".join(lines) + "\n"


def phase_gromacs_water(device, main, deadline=None, steps=GROMACS_STEPS,
                        t_range=GROMACS_T_RANGE) -> dict:
    """The main path's water box as a GROMACS user brings it: .gro text of
    its positions and a .top that defines SPC/E inline (a moleculetype SOL
    with settles, `n` molecules), read with GromacsGroFile and
    GromacsTopFile, createSystem(PME, 0.9 nm), a Simulation under
    LangevinMiddle (300 K, 1/ps, 2 fs): applyConstraints, velocities at
    300 K, `steps` steps (kernels 1-3). Gates: finite energies, the
    temperature within `t_range`, the forces against the float64 path
    (median relative error FORCE_ERR_BAR). Returns the Simulation for
    phase_tempering."""
    import os
    import tempfile

    from openmm_tpu_torch import app
    from openmm_tpu_torch import unit as u

    deadline = deadline or Deadline(math.inf)
    platform = (None if device.type == "cuda"
                else omm.Platform.getPlatformByName("CPU"))
    state = main["context"].getState(getPositions=True,
                                     enforcePeriodicBox=True)
    positions = in_md(state.getPositions(asNumpy=True))
    box = float(in_md(state.getPeriodicBoxVectors(asNumpy=True))[0][0])
    n = len(positions) // 3
    with tempfile.TemporaryDirectory() as tmp:
        gro_path = os.path.join(tmp, "water.gro")
        top_path = os.path.join(tmp, "water.top")
        with open(gro_path, "w") as f:
            f.write(water_gro_text(positions, box))
        with open(top_path, "w") as f:
            f.write(SPCE_TOP % n)
        t0 = time.perf_counter()
        gro = app.GromacsGroFile(gro_path)
        top = app.GromacsTopFile(
            top_path, periodicBoxVectors=gro.getPeriodicBoxVectors())
        system = top.createSystem(nonbondedMethod=app.PME,
                                  nonbondedCutoff=0.9 * u.nanometer)
        create_s = time.perf_counter() - t0
    integ = omm.LangevinMiddleIntegrator(300.0 * u.kelvin, 1 / u.picosecond,
                                         DT_PS * u.picoseconds)
    integ.setRandomNumberSeed(17)
    sim = app.Simulation(top.topology, system, integ, platform)
    sim.context.setPositions(gro.getPositions())
    sim.context.applyConstraints()
    sim.context.setVelocitiesToTemperature(300.0 * u.kelvin, VELOCITY_SEED)
    for kern in KERNELS:
        kern.launches = 0
    _sync(device)
    t0 = time.perf_counter()
    sim.step(steps)
    _sync(device)
    ms = (time.perf_counter() - t0) / steps * 1e3
    launches = {k.name: k.launches for k in MAIN_PATH_KERNELS}
    st = sim.context.getState(getEnergy=True, getForces=True,
                              getPositions=True)
    pos = in_md(st.getPositions(asNumpy=True))
    oracle = omm.Context(system, omm.VerletIntegrator(0.001),
                         omm.Platform.getPlatformByName(
                             "CUDA" if device.type == "cuda" else "CPU"),
                         {"Precision": "double"})
    oracle.setPositions(pos)
    ref = oracle.getState(getForces=True, getEnergy=True)
    force_err = _median_relative_error(in_md(st.getForces(asNumpy=True)),
                                       in_md(ref.getForces(asNumpy=True)))
    del oracle
    energy = in_md(st.getPotentialEnergy())
    temperature = sim.context.temperature()
    print("gromacs water: %d SPC/E waters from .gro and .top text, "
          "GromacsTopFile.createSystem(PME 0.9 nm) %.2f s on the host, %d "
          "constraints; %d steps %.4f ms a step, launches %s; energy %.3f "
          "kJ/mol, temperature %.2f K; median force error vs the float64 "
          "path %.3e (bar %.0e)" % (
              n, create_s, system.getNumConstraints(), steps, ms,
              json.dumps(launches), energy, temperature, force_err,
              FORCE_ERR_BAR))
    if not math.isfinite(energy) or not t_range[0] <= temperature \
            <= t_range[1]:
        raise RuntimeError("gromacs water: energy %.3f, temperature %.2f K"
                           % (energy, temperature))
    if not force_err <= FORCE_ERR_BAR:
        raise RuntimeError("gromacs water: force error %.3e" % force_err)
    if device.type == "cuda" and min(launches.values()) <= 0:
        raise RuntimeError("gromacs water: a kernel never launched: %s"
                           % launches)
    deadline.check("gromacs water")
    return {"simulation": sim, "create_s": create_s, "ms_per_step": ms,
            "force_err": force_err, "temperature": temperature,
            "launches": launches}


def phase_tempering(device, gromacs, deadline=None,
                    rungs=TEMPERING_RUNGS, interval=TEMPERING_INTERVAL,
                    steps=TEMPERING_STEPS) -> dict:
    """SimulatedTempering on the relaxed GROMACS water box: `rungs` (min K,
    max K, count) geometric, weights balancing the rungs at the box's
    energy before each interval, a temperature change attempted every
    `interval` steps over `steps` steps. Gates: after every attempt the
    integrator's temperature is the current rung, and the steps that
    follow run at it (the step's device parameters hold it); no capture
    beyond the Simulation's first. Raises on a miss."""
    from openmm_tpu_torch import app

    deadline = deadline or Deadline(math.inf)
    sim = gromacs["simulation"]
    ctx, integ = sim.context, sim.integrator
    captures0 = _captures(ctx)
    t_lo, t_hi, count = rungs
    ladder = [t_lo * math.exp(k * math.log(t_hi / t_lo) / (count - 1))
              for k in range(count)]

    def balanced():
        """Weights that make every rung equally likely at the box's energy
        now: 24,000 atoms' energy otherwise keeps the walk at the coldest
        rung for thousands of attempts (the adaptive weights move by 1 a
        visit), so each attempt weighs the energy's change over its
        interval."""
        energy = in_md(ctx.getState(getEnergy=True).getPotentialEnergy())
        return [energy / (omm.BOLTZ * t) for t in ladder]

    # attempts at the ends of this phase's intervals
    sim.step(-sim.currentStep % interval)
    np.random.seed(5)
    tempering = app.SimulatedTempering(
        sim, numTemperatures=count, minTemperature=t_lo,
        maxTemperature=t_hi, tempChangeInterval=interval,
        weights=balanced())
    visited, misses = [], []
    t0 = time.perf_counter()
    for _ in range(steps // interval):
        before = tempering.currentTemperature
        tempering._weights = balanced()
        tempering.step(interval)
        # the chunk just run read its temperature from the step's device
        # parameters: the rung current before this attempt
        used = float(ctx._deps.params[2])
        now = in_md(integ.getTemperature())
        visited.append(tempering.currentTemperature)
        if abs(used - ladder[before]) > 1e-9 or \
                abs(now - ladder[tempering.currentTemperature]) > 1e-9:
            misses.append((before, used, tempering.currentTemperature, now))
        deadline.check("tempering")
    _sync(device)
    seconds = time.perf_counter() - t0
    captures = _captures(ctx) - captures0
    print("tempering: SimulatedTempering over %s K on the %d-atom GROMACS "
          "water box, an attempt every %d steps, %d steps in %.2f s; rungs "
          "visited %s; weights %s; new captures %d" % (
              " ".join("%.2f" % t for t in ladder), ctx._n, interval, steps,
              seconds, visited, " ".join("%.3f" % w
                                         for w in tempering.weights),
              captures))
    if misses:
        raise RuntimeError("tempering: the temperature did not follow the "
                           "rungs: %s" % misses)
    if device.type == "cuda" and captures != 0:
        raise RuntimeError("tempering: %d new captures" % captures)
    return {"visited": visited, "captures": captures, "seconds": seconds}


EXAMPLES = ("HelloArgon.py", "HelloWaterBox.py")
# niceness added to the forked children off the critical path (GK, HIPPO,
# the examples): the AMOEBA preparation and the script itself get the
# card host's cores first
NICE = 10
# the cyclic garbage collector's thresholds while the children run: the
# host builds (Modeller, createSystem) spent a quarter of their time in
# full collections of a heap that the imports had filled
GC_WINDOW_THRESHOLDS = (50000, 20, 10)
GC_THRESHOLDS = gc.get_threshold()      # the interpreter's own


def _exec_example(name, text) -> None:
    """An example's text run as a script's __main__."""
    exec(compile(text, name, "exec"), {"__name__": "__main__"})


def start_examples(examples=EXAMPLES) -> tuple:
    """(start time, {name: process}) of examples/HelloArgon.py and
    HelloWaterBox.py with openmm_tpu replaced by openmm_tpu_torch, each in
    a Forked child of its own on the default platform (the card), all at
    once, at niceness NICE: forked before the script touches the card,
    they load the kernel library of the script's build (not built
    again). Killed at exit if not joined."""
    import os
    import tempfile

    root = os.path.dirname(os.path.abspath(__file__))
    procs = {}
    t0 = time.perf_counter()
    for name in examples:
        with open(os.path.join(root, "examples", name)) as f:
            text = f.read().replace("openmm_tpu", "openmm_tpu_torch")
        tmp = tempfile.mkdtemp(prefix="chip_smoke_example_")
        procs[name] = Forked(tmp, _exec_example, name, text, nice=NICE)
        atexit.register(_stop_helper, procs[name], tmp)
    return t0, procs


def phase_examples(device, deadline=None, started=None) -> dict:
    """Waits for the examples' processes (start_examples, started here
    unless `started`). Gates: exit 0, the frames' and energies' numbers
    finite, on the card. Raises on a miss."""
    import re

    deadline = deadline or Deadline(math.inf)
    t0, procs = started or start_examples()
    out = {}
    try:
        for name, proc in procs.items():
            stdout, stderr = proc.communicate(
                timeout=max(deadline.remaining(), 1.0))
            out[name] = (proc.returncode, stdout, stderr)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    seconds = time.perf_counter() - t0
    summary = {}
    for name, (code, stdout, stderr) in out.items():
        coords = [float(v) for line in stdout.splitlines()
                  if line.startswith(("ATOM", "HETATM"))
                  for v in (line[30:38], line[38:46], line[46:54])]
        energies = [float(v) for v in re.findall(r"E_total=\s*(\S+)",
                                                 stderr)]
        frames = stdout.count("ENDMDL")
        platform = re.findall(r"Using platform (\S+)", stderr)
        summary[name] = (code, frames, energies, platform)
        ok = code == 0 and frames > 0 and coords and all(
            math.isfinite(v) for v in coords + energies)
        if not ok:
            raise RuntimeError("examples: %s exited %s with %d frames; "
                               "stderr %s" % (name, code, frames,
                                              stderr[-2000:]))
    print("examples (openmm_tpu -> openmm_tpu_torch, each in its own "
          "process, %.2f s together): %s" % (seconds, "; ".join(
              "%s exit %d, platform %s, %d frames%s" % (
                  name, code, ",".join(plat), frames,
                  (", E_total %s kJ/mol" % " ".join(
                      "%.3f" % e for e in (energies[0], energies[-1])))
                  if energies else "")
              for name, (code, frames, energies, plat) in summary.items())))
    if device.type == "cuda" and any(plat != ["CUDA"] for _, _, _, plat
                                     in summary.values()):
        raise RuntimeError("examples: not on the card: %s" % summary)
    return {"seconds": seconds, "summary": summary}


def _same_npt(what, graph, eager) -> None:
    """The box and the barostats' statistics of two runs, bit for bit."""
    if graph["boxes"] != eager["boxes"]:
        raise RuntimeError("%s: the step program's boxes %s, the eager "
                           "loop's %s" % (what, graph["boxes"],
                                          eager["boxes"]))
    for g, e in zip(graph["statistics"], eager["statistics"]):
        if not torch.equal(g, e):
            raise RuntimeError("%s: the barostat's statistics differ: %s "
                               "against %s" % (what, g.tolist(),
                                               e.tolist()))


def phase_npt(device, label, system, positions, barostat, temperature,
              steps, replay, t_range, deadline=None, velocities=None,
              seed=13) -> dict:
    """`system` with `barostat` added on a Context of its own (the default
    platform on a GPU, "CPU" otherwise) from `positions` (and `velocities`,
    else constrained positions and velocities at `temperature`): with the
    kernel counts set to 0, `steps` steps through the step program in
    calls of the barostat's frequency (one attempt a call), the box read
    after each call, the last `replay` of
    them timed and then run again from a snapshot through the eager loop,
    which must give the same bits, energies, rebuilds, launches, boxes
    and barostat statistics. Then at the final box: the float32 forces
    against a float64 Context given that box, the largest relative
    constraint error, the temperature (within `t_range` K), the volume
    against the start's. Raises on a miss; returns what it printed."""
    deadline = deadline or Deadline(math.inf)
    platform = "CUDA" if device.type == "cuda" else "CPU"
    every = barostat.getFrequency()
    system.addForce(barostat)
    integ = omm.LangevinMiddleIntegrator(temperature, FRICTION, DT_PS)
    integ.setRandomNumberSeed(seed)
    ctx = (omm.Context(system, integ) if platform == "CUDA"
           else omm.Context(system, integ, platform))
    ctx.setPositions(positions)
    if velocities is None:
        ctx.applyConstraints()
        ctx.setVelocitiesToTemperature(temperature, randomSeed=seed)
    else:
        ctx.setVelocities(velocities)
    box0 = in_md(ctx.getState().getPeriodicBoxVectors(asNumpy=True))
    for kern in KERNELS:
        kern.launches = 0
    energy = in_md(ctx.getState(getEnergy=True).getPotentialEnergy())
    lead = _production(device, ctx, integ.step, energy, steps - replay,
                       every, deadline) if steps > replay else None
    start = ctx._snapshot()
    graph = _production(device, ctx, integ.step,
                        lead["energies"][-1] if lead else energy, replay,
                        every, deadline)
    launches = {k.name: k.launches for k in MAIN_PATH_KERNELS}
    rebuilds, escalations = ctx.rebuild_count, ctx.escalation_count
    st = ctx.getState(getPositions=True, getForces=True)
    x, box = in_md(st.getPositions(asNumpy=True)), in_md(
        st.getPeriodicBoxVectors(asNumpy=True))
    temperature_end = ctx.temperature()
    constraint_err = _constraint_error(system, x)
    ctx._restore(start)
    eager = _production(device, ctx, ctx._step_eager, graph["energies"][0],
                        replay, every, deadline)
    _same_bits(label, (graph["positions"], graph["velocities"]),
               (eager["positions"], eager["velocities"]))
    _same_npt(label, graph, eager)
    for name in ("energies", "rebuilds", "launches"):
        if graph[name] != eager[name]:
            raise RuntimeError("%s: the step program's %s %s, the eager "
                               "loop's %s" % (label, name, graph[name],
                                              eager[name]))
    deadline.check(label + ": eager replay")
    oracle = omm.Context(system, omm.LangevinMiddleIntegrator(
        temperature, FRICTION, DT_PS), platform, {"Precision": "double"})
    oracle.setPeriodicBoxVectors(*box)
    oracle.setPositions(x)
    force_err = _median_relative_error(
        in_md(st.getForces(asNumpy=True)), in_md(oracle.getState(
            getForces=True).getForces(asNumpy=True)))
    del oracle
    boxes = [tuple(np.asarray(box0).flatten())] + (
        lead["boxes"] if lead else []) + graph["boxes"]
    attempts = ctx._barostats[0].attempts_in(0, steps)
    accepted = sum(a != b for a, b in zip(boxes, boxes[1:]))
    volume = (abs(np.linalg.det(box)) / abs(np.linalg.det(box0)))
    print("%s: %d atoms, %s every %d steps: %d steps through the step "
          "program, %d attempts, %d moves accepted (box read every %d "
          "steps); box %s -> %s nm, volume x %.6f (bar +-%.2f); rebuilds "
          "%d, escalations %d; T %.2f K; largest relative constraint error "
          "%.3e (bar %.0e); median force error at the final box vs float64 "
          "%.3e (bar %.0e)" % (
              label, system.getNumParticles(), type(barostat).__name__,
              every, steps, attempts, accepted, every,
              np.array2string(np.diag(box0), precision=6, separator=","),
              np.array2string(np.diag(box), precision=6, separator=","),
              volume, NPT_VOLUME_BAR, rebuilds, escalations,
              temperature_end, constraint_err, CONSTRAINT_ERR_BAR,
              force_err, FORCE_ERR_BAR))
    print("%s: eager loop over the last %d steps from a snapshot: the same "
          "bits, box, statistics, energies, rebuilds %s and launches %s; "
          "ns/day %.2f (graph) vs %.2f (eager); per step %.4f ms wall, "
          "%.4f ms host issue (graph); launches of the graph run %s" % (
              label, replay, graph["rebuilds"],
              json.dumps(graph["launches"]), graph["ns_day"],
              eager["ns_day"], graph["wall_ms_per_step"],
              graph["host_issue_ms_per_step"], json.dumps(launches)))
    if accepted < 1:
        raise RuntimeError("%s: no move accepted in %d attempts"
                           % (label, attempts))
    if not abs(volume - 1.0) <= NPT_VOLUME_BAR:
        raise RuntimeError("%s: volume x %.4f" % (label, volume))
    if not force_err <= FORCE_ERR_BAR:
        raise RuntimeError("%s: median force error %.3e" % (label,
                                                           force_err))
    if not constraint_err <= CONSTRAINT_ERR_BAR:
        raise RuntimeError("%s: constraint error %.3e"
                           % (label, constraint_err))
    if not t_range[0] <= temperature_end <= t_range[1]:
        raise RuntimeError("%s: temperature %.2f K outside %.0f-%.0f K"
                           % (label, temperature_end, *t_range))
    if not all(math.isfinite(e) for e in graph["energies"]):
        raise RuntimeError("%s: a potential energy is not finite" % label)
    if device.type == "cuda" and min(launches.values()) <= 0:
        raise RuntimeError("%s: a kernel of its path never launched: %s"
                           % (label, launches))
    deadline.check(label)
    return {"ns_day": graph["ns_day"], "eager_ns_day": eager["ns_day"],
            "attempts": attempts, "accepted": accepted, "volume": volume,
            "boxes": (np.diag(box0), np.diag(box)), "force_err": force_err,
            "constraint_err": constraint_err, "rebuilds": rebuilds,
            "escalations": escalations, "temperature": temperature_end,
            "launches": launches, "graph": graph, "eager": eager,
            "context": ctx, "step": integ.step}


def _clocks(device) -> str:
    """The card's SM clock and power draw, as nvidia-smi reads them."""
    if device.type != "cuda":
        return "not read"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30, check=True).stdout.strip().splitlines()[device.index or 0]


def _in_turns(device, runs, steps, order, deadline,
              label="npt bilayer") -> dict:
    """Wall ms a step of each run's step(steps) call, runs[key] = (Context,
    step), timed in `order`, each run continuing from where its last call
    left it: {key: ([ms, ...], rebuilds over its calls, capacity scale)}."""
    ms = {key: [] for key in runs}
    r0 = {key: ctx.rebuild_count for key, (ctx, _) in runs.items()}
    for key in order:
        _sync(device)
        t0 = time.perf_counter()
        runs[key][1](steps)
        _sync(device)
        ms[key].append((time.perf_counter() - t0) / steps * 1e3)
        deadline.check(label + ": in turns")
    return {key: (ms[key], ctx.rebuild_count - r0[key],
                  ctx._candidates.capacity_scale)
            for key, (ctx, _) in runs.items()}


def phase_npt_bilayer(device, bilayer, deadline=None,
                      steps=NPT_BILAYER_STEPS, replay=NPT_BILAYER_REPLAY,
                      frequency=NPT_FREQUENCY,
                      t_range=(250.0, 360.0), turn_steps=NPT_TURN_STEPS,
                      turns=NPT_TURNS) -> dict:
    """The bilayer phase's system from its minimized positions under
    MonteCarloMembraneBarostat(NPT_PRESSURE, NPT_TENSION,
    BILAYER_TEMPERATURE, XYIsotropic, ZFree, `frequency`); the final
    temperature within `t_range` K. Then the bilayer phase's NVT step
    program and this one, each in calls of `turn_steps` steps in the
    order `turns`: the NPT cost a step against NVT in one process, on
    equal calls, with the card's clock and power beside it."""
    deadline = deadline or Deadline(math.inf)
    barostat = omm.MonteCarloMembraneBarostat(
        NPT_PRESSURE, NPT_TENSION, BILAYER_TEMPERATURE,
        omm.MonteCarloMembraneBarostat.XYIsotropic,
        omm.MonteCarloMembraneBarostat.ZFree, frequency)
    out = phase_npt(device, "npt bilayer", bilayer["system"],
                    bilayer["minimized_positions"], barostat,
                    BILAYER_TEMPERATURE, steps, replay, t_range, deadline)
    clocks = [_clocks(device)]
    turns_out = _in_turns(device, {
        "nvt": (bilayer["context"], bilayer["step"]),
        "npt": (out["context"], out["step"])}, turn_steps, turns, deadline)
    clocks.append(_clocks(device))
    ms = {k: v[0] for k, v in turns_out.items()}
    nvt, npt = (statistics.median(ms[k]) for k in ("nvt", "npt"))
    print("npt bilayer in turns (%s, %d steps a call): wall ms a step NVT "
          "%s, NPT %s; medians %.4f and %.4f ms, NPT +%.4f ms a step "
          "(%.2f %%), ns/day %.2f NVT and %.2f NPT; rebuilds NVT %d, NPT "
          "%d; capacity scale NVT %.2f, NPT %.2f; SM clock, power before "
          "and after: %s; %s" % (
              " ".join(turns), turn_steps,
              " ".join("%.4f" % t for t in ms["nvt"]),
              " ".join("%.4f" % t for t in ms["npt"]), nvt, npt, npt - nvt,
              100.0 * (npt / nvt - 1.0), DT_PS / nvt * 86.4e3,
              DT_PS / npt * 86.4e3, turns_out["nvt"][1],
              turns_out["npt"][1], turns_out["nvt"][2],
              turns_out["npt"][2], *clocks))
    print("npt bilayer: %.2f ns/day at constant pressure against %.2f NVT "
          "in this run's production windows (%.1f %% lower)" % (
              out["ns_day"], bilayer["ns_day"],
              100.0 * (1.0 - out["ns_day"] / bilayer["ns_day"])))
    out["turns"] = {"ms": ms, "nvt_ms": nvt, "npt_ms": npt,
                    "clocks": clocks}
    return out


def phase_npt_water(device, main, deadline=None, steps=NPT_WATER_STEPS,
                    replay=NPT_WATER_REPLAY, frequency=NPT_FREQUENCY,
                    aniso_steps=ANISO_STEPS,
                    aniso_frequency=ANISO_FREQUENCY) -> tuple:
    """The relaxed water box of phase_main_path (its final positions and
    velocities) under MonteCarloBarostat(NPT_PRESSURE, 300 K,
    `frequency`), then under MonteCarloAnisotropicBarostat (NPT_PRESSURE on
    each axis, 300 K, every axis, `aniso_frequency`) for `aniso_steps`
    steps, each on a fresh copy of the system."""
    st = main["context"].getState(getPositions=True, getVelocities=True)
    n_waters = in_md(st.getPositions(asNumpy=True)).shape[0] // 3
    runs = []
    for label, barostat, n, m in (
            ("npt water", omm.MonteCarloBarostat(NPT_PRESSURE, 300.0,
                                                 frequency), steps, replay),
            ("npt water aniso", omm.MonteCarloAnisotropicBarostat(
                (NPT_PRESSURE,) * 3, 300.0, True, True, True,
                aniso_frequency), aniso_steps, aniso_steps)):
        system, _ = tip3p_water_box(n_waters)
        runs.append(phase_npt(device, label, system,
                              in_md(st.getPositions(asNumpy=True)),
                              barostat, 300.0, n, m, (200.0, 450.0),
                              deadline, velocities=in_md(st.getVelocities(
                                  asNumpy=True))))
    return tuple(runs)


def _kernel_record(device, inp, name, launches, err,
                   kern=tile_pairs.TILES) -> dict:
    """The kernels line's entry of kernel `kern` (kernel 1 by default, or
    a dispersion-grid kernel) on `inp` (its path's inputs), named `name`:
    launches from its path's run, times and bound measured here; for the
    dispersion spread, the library time of index_add_ of its terms."""
    kernel, plain = _kernel_calls(inp)[kern.name]
    bound = (tile_bound(inp, tile_counts(inp)) if kern is tile_pairs.TILES
             else kernel_bounds(inp, None)[kern.name])
    library = None
    if kern is pme_zslab.SPREAD_DISPERSION:
        grid = inp["disp"]["grid"]
        flat, val = pme_zslab.spread_terms(inp["pos"], inp["disp"]["c6"],
                                           inp["binv"], grid)
        q_flat = torch.zeros(math.prod(grid), dtype=torch.float32,
                             device=device)

        def library():
            return q_flat.zero_().index_add_(0, flat, val)
    cuda = device.type == "cuda"
    return {"name": name, "route": "cuda", "source": kern.source,
            "replaces": kern.replaces, "launches": launches,
            "max_abs_err": err,
            "ms": _time_ms(kernel, device) if cuda else None,
            "plain_ms": (_time_ms(plain, device, PLAIN_REPS, 1) if cuda
                         else None),
            "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": (_time_ms(library, device)
                           if cuda and library else None)}


def phase_method(device, label, system, positions, temperature, steps,
                 replay, t_range, deadline=None, velocities=None, seed=19,
                 energy_every=ENERGY_EVERY, step_size=DT_PS,
                 friction=FRICTION, groups=None, record=None,
                 minimize_iterations=0, kernel_names=("nonbonded_tiles",),
                 check=None, relax=()) -> dict:
    """`system` (any NonbondedForce method) on a Context of its own (the
    default platform on a GPU, "CPU" otherwise) from `positions`: where
    the force keeps a candidate state, kernel 1 in its mode against its
    plain version at these shapes (and again for the same bits); the
    float32 forces (and the energy of each force group in `groups`)
    against a float64 Context; then, with the kernel counts set to 0,
    `steps` steps of `step_size` ps at `friction` through the step
    program (velocities `velocities`, else at `temperature`), the last
    `replay` of them timed (the steps before them take the capture out of
    the window) and run again from a snapshot through the eager loop,
    which must give the same bits, energies, rebuilds and launches;
    the constraint error and the temperature (within `t_range` K) at the
    end. `record`, a kernels-line name, times kernel 1 for that line.
    kernel_names: the kernels held against their plain versions (those of
    _kernel_calls). minimize_iterations > 0: one minimize call of that
    many iterations before the velocities (kernels 1, 4 and 5 counted).
    check(ctx), where given, runs after the steps (a gate of the caller).
    relax: stages (step size, friction, steps) run after the velocities
    and before the counted steps (a start from a lattice).
    Raises on a miss; returns what it printed."""
    deadline = deadline or Deadline(math.inf)
    platform = "CUDA" if device.type == "cuda" else "CPU"
    integ = omm.LangevinMiddleIntegrator(temperature, friction, step_size)
    integ.setRandomNumberSeed(seed)
    ctx = (omm.Context(system, integ) if platform == "CUDA"
           else omm.Context(system, integ, platform))
    n = system.getNumParticles()
    out = {"label": label, "atoms": n, "tiled": ctx._candidates is not None}
    scale = 1.0
    if out["tiled"]:
        inp = kernel_inputs(device, 0, system=system, positions=positions)
        out["kernel_errs"] = phase_kernels(
            device, inp, deadline, names=kernel_names,
            label=" (%s)" % label)
        out["kernel_err"] = out["kernel_errs"]["nonbonded_tiles"]
        out["inputs"] = inp
        scale = inp["module"].capacity_scale
    oracle = omm.Context(system, omm.LangevinMiddleIntegrator(
        temperature, friction, step_size), platform, {"Precision": "double"})
    for c in (ctx, oracle):
        # getState does not grow the capacity: start at the kernel's scale
        c._nonbonded.capacity_scale = scale
        c.setPositions(positions)
    st = ctx.getState(getForces=True, getEnergy=True)
    ref = oracle.getState(getForces=True, getEnergy=True)
    force_err = _median_relative_error(in_md(st.getForces(asNumpy=True)),
                                       in_md(ref.getForces(asNumpy=True)))
    energies = {}
    for g in groups or ():
        pair = [in_md(c.getState(getEnergy=True,
                                 groups={g}).getPotentialEnergy())
                for c in (ctx, oracle)]
        energies[g] = (*pair, abs(pair[0] - pair[1]) / max(abs(pair[1]),
                                                          1e-300))
    del oracle
    print("%s: %d atoms, %s; median force error vs float64 %.3e (bar "
          "%.0e); energy %.6f vs %.6f kJ/mol%s" % (
              label, n, "kernel 1 on the candidate state" if out["tiled"]
              else "every pair (no candidate state)", force_err,
              FORCE_ERR_BAR, in_md(st.getPotentialEnergy()),
              in_md(ref.getPotentialEnergy()),
              "; by group (float32, float64, relative error; bar %.0e): %s"
              % (GROUP_ENERGY_BAR, "; ".join(
                  "%d: %.4f %.4f %.2e" % (g, *energies[g])
                  for g in sorted(energies))) if energies else ""))
    if not force_err <= FORCE_ERR_BAR:
        raise RuntimeError("%s: median force error %.3e above %.0e"
                           % (label, force_err, FORCE_ERR_BAR))
    for g, (e32, e64, rel) in energies.items():
        if not (rel <= GROUP_ENERGY_BAR or e32 == e64):
            raise RuntimeError("%s: group %d energy %.6f vs %.6f"
                               % (label, g, e32, e64))
    deadline.check(label + ": float64 oracle")

    if minimize_iterations:
        for kern in _build.KERNELS:
            kern.launches = 0
        ctx.applyConstraints()
        before = in_md(ctx.getState(getEnergy=True).getPotentialEnergy())
        reporter = _Iterations()
        t0 = time.perf_counter()
        omm.LocalEnergyMinimizer.minimize(ctx, MINIMIZE_TOLERANCE,
                                          minimize_iterations, reporter)
        _sync(device)
        after = in_md(ctx.getState(getEnergy=True).getPotentialEnergy())
        out["minimize"] = {
            "iterations": reporter.count, "energies": (before, after),
            "seconds": time.perf_counter() - t0,
            "launches": {k.name: k.launches for k in MINIMIZER_KERNELS}}
        print("%s: minimize (%d iterations a stage): %d iterations in %.2f "
              "s; energy %.3f -> %.3f kJ/mol; launches %s" % (
                  label, minimize_iterations, reporter.count,
                  out["minimize"]["seconds"], before, after,
                  json.dumps(out["minimize"]["launches"])))
        if not (math.isfinite(after) and after < before):
            raise RuntimeError("%s: minimization did not lower the energy"
                               % label)
        if device.type == "cuda" and min(
                out["minimize"]["launches"].values()) <= 0:
            raise RuntimeError("%s: a kernel of the minimizer never "
                               "launched: %s" % (label, out["minimize"]))
        deadline.check(label + ": minimization")
    if velocities is None:
        ctx.applyConstraints()
        ctx.setVelocitiesToTemperature(temperature, randomSeed=seed)
    else:
        ctx.setVelocities(velocities)
    for dt, gamma, count in relax:
        integ.setStepSize(dt)
        integ.setFriction(gamma)
        integ.step(count)
        deadline.check(label + ": relaxation")
    integ.setStepSize(step_size)
    integ.setFriction(friction)
    for kern in _build.KERNELS:
        kern.launches = 0
    energy = in_md(ctx.getState(getEnergy=True).getPotentialEnergy())
    lead = _production(device, ctx, integ.step, energy, steps - replay,
                       energy_every, deadline) if steps > replay else None
    start = ctx._snapshot()
    graph = _production(device, ctx, integ.step,
                        lead["energies"][-1] if lead else energy, replay,
                        energy_every, deadline)
    launches = {k.name: k.launches for k in _build.KERNELS if k.launches}
    launches.setdefault(tile_pairs.TILES.name, 0)
    rebuilds, escalations = ctx.rebuild_count, ctx.escalation_count
    temperature_end = ctx.temperature()
    if check is not None:
        out["check"] = check(ctx)
    x = in_md(ctx.getState(getPositions=True).getPositions(asNumpy=True))
    constraint_err = _constraint_error(system, x)
    ctx._restore(start)
    eager = _production(device, ctx, ctx._step_eager, graph["energies"][0],
                        replay, energy_every, deadline)
    _same_bits(label, (graph["positions"], graph["velocities"]),
               (eager["positions"], eager["velocities"]))
    for name in ("energies", "rebuilds", "launches"):
        if graph[name] != eager[name]:
            raise RuntimeError("%s: the step program's %s %s, the eager "
                               "loop's %s" % (label, name, graph[name],
                                              eager[name]))
    print("%s: %d steps of %.4f ps (friction %.1f/ps) through the step "
          "program, the last %d replayed through the eager loop from a "
          "snapshot: the same bits, energies, rebuilds %s and launches %s; "
          "energies %s kJ/mol; T %.2f K; rebuilds %d, escalations %d; "
          "largest relative constraint error %.3e (bar %.0e); ns/day %.2f "
          "(graph) vs %.2f (eager); per step %.4f ms wall (graph), %.4f ms "
          "(eager); launches of the graph run %s" % (
              label, steps, step_size, friction, replay, graph["rebuilds"],
              json.dumps(graph["launches"]),
              " ".join("%.1f" % e for e in graph["energies"]),
              temperature_end, rebuilds, escalations, constraint_err,
              CONSTRAINT_ERR_BAR, graph["ns_day"], eager["ns_day"],
              graph["wall_ms_per_step"], eager["wall_ms_per_step"],
              json.dumps(launches)))
    if not all(math.isfinite(e) for e in graph["energies"]):
        raise RuntimeError("%s: a potential energy is not finite" % label)
    if not constraint_err <= CONSTRAINT_ERR_BAR:
        raise RuntimeError("%s: constraint error %.3e"
                           % (label, constraint_err))
    if not t_range[0] <= temperature_end <= t_range[1]:
        raise RuntimeError("%s: temperature %.2f K outside %.0f-%.0f K"
                           % (label, temperature_end, *t_range))
    if device.type == "cuda" and out["tiled"] \
            and launches[tile_pairs.TILES.name] <= 0:
        raise RuntimeError("%s: kernel 1 of its path never launched: %s"
                           % (label, launches))
    if out["tiled"] and record:
        out["record"] = _kernel_record(device, inp, record,
                                       launches[tile_pairs.TILES.name],
                                       out["kernel_err"])
    deadline.check(label)
    out.update({"force_err": force_err, "energies": energies,
                "ns_day": graph["ns_day"], "eager_ns_day": eager["ns_day"],
                "ms_per_step": graph["wall_ms_per_step"],
                "temperature": temperature_end,
                "constraint_err": constraint_err, "rebuilds": rebuilds,
                "escalations": escalations, "launches": launches,
                "graph": graph, "eager": eager})
    return out


def phase_rf_water(device, main, deadline=None, steps=RF_STEPS,
                   replay=RF_REPLAY) -> dict:
    """The relaxed water box of phase_main_path (its final positions and
    velocities) at the reference suite's rf settings: CutoffPeriodic at
    RF_CUTOFF nm, reaction-field dielectric 78.3, dispersion correction,
    300 K (phase_method)."""
    st = main["context"].getState(getPositions=True, getVelocities=True)
    system, _ = tip3p_water_box(
        in_md(st.getPositions(asNumpy=True)).shape[0] // 3,
        nonbonded_method=omm.NonbondedForce.CutoffPeriodic, cutoff=RF_CUTOFF)
    return phase_method(device, "rf water", system,
                        in_md(st.getPositions(asNumpy=True)), 300.0,
                        steps, replay, (200.0, 450.0), deadline,
                        velocities=in_md(st.getVelocities(asNumpy=True)),
                        record="nonbonded_tiles_rf")


def phase_rf_bilayer(device, bilayer_positions, deadline=None,
                     bilayer=None, steps=RF_STEPS, replay=RF_REPLAY,
                     energy_every=ENERGY_EVERY) -> dict:
    """The POPC bilayer (popc_bilayer(), or `bilayer` = (system,
    positions)) at the minimized positions of phase_bilayer, at the rf
    settings (CutoffPeriodic, RF_CUTOFF nm), its force groups as
    BILAYER_GROUPS and each group's energy against float64, at
    BILAYER_TEMPERATURE (phase_method)."""
    system, _ = bilayer or popc_bilayer()
    for force in system.getForces():
        force.setForceGroup(BILAYER_GROUPS[type(force).__name__])
        if isinstance(force, omm.NonbondedForce):
            force.setNonbondedMethod(omm.NonbondedForce.CutoffPeriodic)
            force.setCutoffDistance(RF_CUTOFF)
    return phase_method(device, "rf bilayer", system, bilayer_positions,
                        BILAYER_TEMPERATURE, steps, replay, (250.0, 360.0),
                        deadline, energy_every=energy_every,
                        groups=sorted(set(BILAYER_GROUPS.values())))


def phase_nonperiodic(device, main, deadline=None, radius=DROPLET_RADIUS,
                      steps=DROPLET_STEPS, replay=DROPLET_REPLAY) -> list:
    """The waters of phase_main_path's relaxed box whose oxygens lie
    within `radius` nm of its centre (water_droplet: no box), at NoCutoff
    and at CutoffNonPeriodic DROPLET_CUTOFF nm, 300 K, at 0.5 fs steps
    (an unrelaxed surface): phase_method for each."""
    st = main["context"].getState(getPositions=True)
    box = in_md(main["context"].getSystem().getDefaultPeriodicBoxVectors())
    runs = []
    for label, method in (("nocutoff droplet", omm.NonbondedForce.NoCutoff),
                          ("cutoffnonperiodic droplet",
                           omm.NonbondedForce.CutoffNonPeriodic)):
        system, pos = water_droplet(in_md(st.getPositions(asNumpy=True)), box,
                                    radius, method,
                                    DROPLET_CUTOFF)
        runs.append(phase_method(device, label, system, pos, 300.0, steps,
                                 replay, (100.0, 600.0), deadline,
                                 energy_every=replay, step_size=0.0005))
    return runs


def phase_ewald(device, deadline=None, n_waters=EWALD_WATERS,
                steps=EWALD_STEPS, replay=EWALD_REPLAY) -> dict:
    """A box of `n_waters` waters at NonbondedForce.Ewald (0.9 nm): kernel
    1 in MODE_EWALD and the exact k-sum, from the lattice start at 0.5 fs
    and friction 50/ps, the first stage of the main path's relaxation
    (phase_method). The lattice start heats the box, hence the wide
    temperature band."""
    system, positions = tip3p_water_box(
        n_waters, nonbonded_method=omm.NonbondedForce.Ewald, cutoff=0.9)
    return phase_method(device, "ewald water", system, positions, 300.0,
                        steps, replay, (100.0, 800.0), deadline,
                        energy_every=replay, step_size=0.0005,
                        friction=50.0)


def phase_gbsa(device, deadline=None, lipids=GBSA_LIPIDS,
               steps=GBSA_STEPS,
               replay=GBSA_REPLAY, energy_every=ENERGY_EVERY,
               minimize_iterations=GBSA_MINIMIZE_ITERATIONS) -> dict:
    """The implicit-solvent cluster (popc_obc_cluster(lipids)) on a
    Context of its own (the default platform on a GPU, "CPU" otherwise):
    its float32 forces and the energy of each force group (nonbonded, GB,
    bonded) against a float64 Context; GB's analytic sweeps alone timed
    at this size (on a card); then applyConstraints, one minimize call of
    `minimize_iterations` iterations a stage, velocities at 300 K, `steps`
    steps through the step program at GBSA_RELAX_FRICTION, and `replay`
    steps at the suite's 1/ps from a snapshot through the step program
    and again through the eager loop, which must give the same bits and
    energies. Gates: the force error, the group energies, the
    temperature (250-360 K) and the constraint error at the end. Raises on
    a miss."""
    deadline = deadline or Deadline(math.inf)
    platform = "CUDA" if device.type == "cuda" else "CPU"
    system, positions = popc_obc_cluster(lipids)
    for force in system.getForces():
        force.setForceGroup(GBSA_GROUPS[type(force).__name__])
    n = system.getNumParticles()
    integ = omm.LangevinMiddleIntegrator(GBSA_TEMPERATURE,
                                         GBSA_RELAX_FRICTION, DT_PS)
    integ.setRandomNumberSeed(23)
    ctx = (omm.Context(system, integ) if platform == "CUDA"
           else omm.Context(system, integ, platform))
    oracle = omm.Context(system, omm.LangevinMiddleIntegrator(
        GBSA_TEMPERATURE, FRICTION, DT_PS), platform,
        {"Precision": "double"})
    for c in (ctx, oracle):
        c.setPositions(positions)
    st = ctx.getState(getForces=True, getEnergy=True)
    ref = oracle.getState(getForces=True, getEnergy=True)
    force_err = _median_relative_error(in_md(st.getForces(asNumpy=True)),
                                       in_md(ref.getForces(asNumpy=True)))
    energies = {}
    for g in sorted(set(GBSA_GROUPS.values()) - {GBSA_GROUPS[
            "CMMotionRemover"]}):
        pair = [in_md(c.getState(getEnergy=True,
                                 groups={g}).getPotentialEnergy())
                for c in (ctx, oracle)]
        energies[g] = (*pair, abs(pair[0] - pair[1]) / max(abs(pair[1]),
                                                          1e-300))
    del oracle
    print("gbsa: %d atoms (%d lipids), GBSAOBCForce and NonbondedForce at "
          "CutoffNonPeriodic %.1f nm; constraints %d (SHAKE %d, CCMA %d); "
          "median force error vs float64 %.3e (bar %.0e); energy %.6f vs "
          "%.6f kJ/mol; by group (nonbonded 0, GB 1, bonded 2; float32, "
          "float64, relative error; bar %.0e): %s" % (
              n, lipids, builders.OBC_CUTOFF,
              system.getNumConstraints(), *ctx.constraint_split[1:],
              force_err, FORCE_ERR_BAR, in_md(st.getPotentialEnergy()),
              in_md(ref.getPotentialEnergy()), GROUP_ENERGY_BAR,
              "; ".join("%d: %.4f %.4f %.2e" % (g, *energies[g])
                        for g in sorted(energies))))
    if not force_err <= FORCE_ERR_BAR:
        raise RuntimeError("gbsa: median force error %.3e above %.0e"
                           % (force_err, FORCE_ERR_BAR))
    for g, (e32, e64, rel) in energies.items():
        if not rel <= GROUP_ENERGY_BAR:
            raise RuntimeError("gbsa: group %d energy %.6f vs %.6f"
                               % (g, e32, e64))
    deadline.check("gbsa: float64 oracle")

    sweeps_ms = None
    if device.type == "cuda":
        (gb,) = ctx._gb
        pos, box = ctx._state["positions"], ctx._box
        sweeps_ms = _time_ms(lambda: gb.ef(pos, box), device)
        print("gbsa: GB's three analytic sweeps (energy and forces) at %d "
              "atoms: %.4f ms a call" % (n, sweeps_ms))
        deadline.check("gbsa: sweeps")

    ctx.applyConstraints()
    before = in_md(ctx.getState(getEnergy=True).getPotentialEnergy())
    reporter = _Iterations()
    _sync(device)
    t0 = time.perf_counter()
    omm.LocalEnergyMinimizer.minimize(ctx, MINIMIZE_TOLERANCE,
                                      minimize_iterations, reporter)
    _sync(device)
    minimize_s = time.perf_counter() - t0
    after = in_md(ctx.getState(getEnergy=True).getPotentialEnergy())
    print("gbsa: minimize (%d iterations a stage): %d iterations, %d "
          "evaluations in %.2f s; energy %.3f -> %.3f kJ/mol" % (
              minimize_iterations, reporter.count, ctx.energy_evaluations,
              minimize_s, before, after))
    if not (math.isfinite(after) and after < before):
        raise RuntimeError("gbsa: minimization did not lower the energy: "
                           "%.3f -> %.3f" % (before, after))
    deadline.check("gbsa: minimization")

    ctx.setVelocitiesToTemperature(GBSA_TEMPERATURE, randomSeed=4)
    for done in range(0, steps, energy_every):
        integ.step(min(energy_every, steps - done))
        deadline.check("gbsa: steps")
    integ.setFriction(FRICTION)
    start = ctx._snapshot()
    graph = _production(device, ctx, integ.step,
                        in_md(ctx.getState(
                            getEnergy=True).getPotentialEnergy()),
                        replay, energy_every, deadline)
    temperature = ctx.temperature()
    constraint_err = _constraint_error(
        system, in_md(ctx.getState(getPositions=True).getPositions(
            asNumpy=True)))
    ctx._restore(start)
    eager = _production(device, ctx, ctx._step_eager, graph["energies"][0],
                        replay, energy_every, deadline)
    _same_bits("gbsa", (graph["positions"], graph["velocities"]),
               (eager["positions"], eager["velocities"]))
    if graph["energies"] != eager["energies"]:
        raise RuntimeError("gbsa: the step program's energies %s, the "
                           "eager loop's %s" % (graph["energies"],
                                                eager["energies"]))
    print("gbsa: %d steps at %.1f/ps, then %d at %.3f ps (friction %.1f/ps, "
          "%.1f K) through the step program, replayed through the eager "
          "loop from a snapshot: the same bits and energies %s kJ/mol; T "
          "%.2f K; largest relative constraint error %.3e (bar %.0e); "
          "%.2f ns/day, %.4f ms a step (graph) vs %.4f (eager)" % (
              steps, GBSA_RELAX_FRICTION, replay, DT_PS, FRICTION,
              GBSA_TEMPERATURE,
              " ".join("%.1f" % e for e in graph["energies"]), temperature,
              constraint_err, CONSTRAINT_ERR_BAR, graph["ns_day"],
              graph["wall_ms_per_step"], eager["wall_ms_per_step"]))
    if not all(math.isfinite(e) for e in graph["energies"]):
        raise RuntimeError("gbsa: a potential energy is not finite")
    if not 250.0 <= temperature <= 360.0:
        raise RuntimeError("gbsa: temperature %.2f K outside 250-360 K"
                           % temperature)
    if not constraint_err <= CONSTRAINT_ERR_BAR:
        raise RuntimeError("gbsa: constraint error %.3e" % constraint_err)
    deadline.check("gbsa")
    return {"atoms": n, "force_err": force_err, "energies": energies,
            "sweeps_ms": sweeps_ms, "minimized": (before, after),
            "temperature": temperature, "constraint_err": constraint_err,
            "ns_day": graph["ns_day"],
            "ms_per_step": graph["wall_ms_per_step"],
            "eager_ms_per_step": eager["wall_ms_per_step"]}


def _total_energy(ctx) -> float:
    st = ctx.getState(getEnergy=True)
    return in_md(st.getPotentialEnergy()) + in_md(st.getKineticEnergy())


def _integrator_run(device, label, system, integ, state, steps, every,
                    read, deadline, replay=INTEGRATOR_REPLAY,
                    temperature=None, before=None, after=None) -> dict:
    """`system` under `integ` on a Context of its own (the default
    platform on a GPU, "CPU" otherwise) from the positions of `state` and
    its velocities (or velocities at `temperature`): with the kernel
    counts set to 0, `steps` steps through the step program in calls of
    `every`, read(ctx) after each (before(ctx) before the first, after(ctx)
    after the last); then `replay` steps from a snapshot through the step
    program and again through the eager loop, which must give the same
    bits in the positions, the velocities, the Context's shared tensors
    (the integrator's state among them) and the clock. Returns the
    readings, what before and after gave, the run's launches of kernels
    1-3, its escalations, ns/day and ms a step of the replay through the
    step program (the run's first step captures the program), the
    constraint error and the Context."""
    platform = "CUDA" if device.type == "cuda" else "CPU"
    ctx = (omm.Context(system, integ) if platform == "CUDA"
           else omm.Context(system, integ, platform))
    ctx.setPositions(in_md(state.getPositions(asNumpy=True)))
    if temperature is None:
        ctx.setVelocities(in_md(state.getVelocities(asNumpy=True)))
    else:
        ctx.setVelocitiesToTemperature(temperature, randomSeed=VELOCITY_SEED)
    first = before(ctx) if before else None
    for kern in KERNELS:
        kern.launches = 0
    e0 = ctx.escalation_count
    run = _production(device, ctx, integ.step, read(ctx), steps, every,
                      deadline, read)
    launches = {k.name: k.launches for k in MAIN_PATH_KERNELS}
    escalations = ctx.escalation_count - e0
    last = after(ctx) if after else None
    constraint_err = _constraint_error(
        system, in_md(ctx.getState(getPositions=True).getPositions(
            asNumpy=True)))
    start = ctx._snapshot()
    graph = _production(device, ctx, integ.step, 0.0, replay, replay,
                        deadline)
    ctx._restore(start)
    eager = _production(device, ctx, ctx._step_eager, 0.0, replay, replay,
                        deadline)
    _same_bits(label, (graph["positions"], graph["velocities"]),
               (eager["positions"], eager["velocities"]))
    _same_state(label, graph, eager)
    if graph["energies"] != eager["energies"] \
            or graph["rebuilds"] != eager["rebuilds"]:
        raise RuntimeError("%s: the step program's energies %s and rebuilds "
                           "%s, the eager loop's %s and %s" % (
                               label, graph["energies"], graph["rebuilds"],
                               eager["energies"], eager["rebuilds"]))
    if not all(math.isfinite(e) for e in run["energies"]
               + graph["energies"]):
        raise RuntimeError("%s: a reading is not finite: %s"
                           % (label, run["energies"]))
    if not constraint_err <= CONSTRAINT_ERR_BAR:
        raise RuntimeError("%s: constraint error %.3e"
                           % (label, constraint_err))
    if device.type == "cuda" and min(launches.values()) <= 0:
        raise RuntimeError("%s: a kernel of its path never launched: %s"
                           % (label, launches))
    deadline.check(label)
    return {"readings": run["energies"], "launches": launches,
            "before": first, "after": last, "escalations": escalations,
            "ns_day": graph["ns_day"],
            "ms_per_step": graph["wall_ms_per_step"],
            "eager_ms_per_step": eager["wall_ms_per_step"],
            "constraint_err": constraint_err, "context": ctx}


def phase_integrators(device, main, deadline=None,
                      verlet_steps=VERLET_STEPS, drift_every=DRIFT_EVERY,
                      andersen_steps=ANDERSEN_STEPS,
                      andersen_every=ANDERSEN_EVERY,
                      langevin_steps=LANGEVIN_STEPS,
                      brownian_steps=BROWNIAN_STEPS,
                      replay=INTEGRATOR_REPLAY, drift_gate=DRIFT_GATE,
                      andersen_range=ANDERSEN_T_RANGE) -> dict:
    """The relaxed water box of phase_main_path (its final positions and
    velocities; PME at 0.9 nm, kernels 1-3) under Verlet (1 fs; the NVE
    drift in kT/dof/ns from a linear fit of the total energy, within
    `drift_gate`; the shifted and the unshifted kinetic energy), Verlet
    with an AndersenThermostat (300 K, 10/ps) from velocities at 250 K
    (the mean temperature of the run's last half within
    `andersen_range`; a rehearsal's few steps reach neither gate),
    leapfrog Langevin (300 K, 1/ps, 2 fs; the temperature within the
    main path's 200-450 K) and Brownian (300 K, 100/ps, 0.5 fs), each
    through _integrator_run (launches, the eager loop's bits, the
    constraint error). Raises on a miss."""
    deadline = deadline or Deadline(math.inf)
    state = main["context"].getState(getPositions=True, getVelocities=True)
    n_waters = in_md(state.getPositions(asNumpy=True)).shape[0] // 3

    def box(thermostat=False):
        system, _ = tip3p_water_box(n_waters)
        if thermostat:
            system.addForce(omm.AndersenThermostat(ANDERSEN_TEMPERATURE,
                                                   ANDERSEN_FREQUENCY))
        return system

    out = {}
    system = box()
    verlet = _integrator_run(device, "verlet", system,
                             omm.VerletIntegrator(VERLET_DT), state,
                             verlet_steps, drift_every, _total_energy,
                             deadline, replay)
    ctx = verlet["context"]
    n = system.getNumParticles()
    dof = 3 * n - system.getNumConstraints()
    kt = omm.BOLTZ * 300.0
    times_ns = np.arange(len(verlet["readings"])) * drift_every \
        * VERLET_DT / 1000.0
    slope = np.polyfit(times_ns, np.asarray(verlet["readings"]), 1)[0]
    drift = slope / (dof * kt)
    v = ctx._state["velocities"]
    unshifted = float(0.5 * torch.sum(ctx._masses[:, None] * v * v))
    print("verlet: %d atoms, %d steps of %.3f ps (%.1f ps): total energy "
          "%s kJ/mol (every %d steps); NVE drift %.4e kT/dof/ns (gate "
          "|drift| < %.1f; dof %d, kT at 300 K; T %.2f K at the end); "
          "kinetic energy %.3f kJ/mol "
          "shifted by half a step, %.3f unshifted; %.2f ns/day, %.4f ms a "
          "step; launches %s; %d steps replayed through the eager loop: "
          "the same bits" % (
              n, verlet_steps, VERLET_DT, verlet_steps * VERLET_DT,
              " ".join("%.1f" % e for e in verlet["readings"][::5]),
              drift_every, drift, drift_gate, dof, ctx.temperature(),
              ctx.kinetic_energy(), unshifted, verlet["ns_day"],
              verlet["ms_per_step"], json.dumps(verlet["launches"]),
              replay))
    if not abs(drift) < drift_gate:
        raise RuntimeError("verlet: NVE drift %.4e kT/dof/ns" % drift)
    out["verlet"] = dict(verlet, drift=drift, kinetic=(ctx.kinetic_energy(),
                                                       unshifted))
    del ctx, verlet["context"]

    andersen = _integrator_run(
        device, "andersen", box(thermostat=True),
        omm.VerletIntegrator(VERLET_DT), state, andersen_steps,
        andersen_every, lambda c: c.temperature(), deadline, replay,
        temperature=ANDERSEN_START)
    # the readings after the first half of the run
    late = andersen["readings"][len(andersen["readings"]) // 2 + 1:]
    mean_t = float(np.mean(late))
    print("andersen: Verlet at %.3f ps with AndersenThermostat(%.0f K, "
          "%.0f/ps) from %.0f K: T %s K (every %d steps), mean of the last "
          "%d readings %.2f K (gate %.0f-%.0f K); %.2f ns/day; launches %s; "
          "the eager loop's bits" % (
              VERLET_DT, ANDERSEN_TEMPERATURE, ANDERSEN_FREQUENCY,
              ANDERSEN_START, " ".join("%.1f" % t
                                       for t in andersen["readings"]),
              andersen_every, len(late), mean_t, *andersen_range,
              andersen["ns_day"], json.dumps(andersen["launches"])))
    if not andersen_range[0] <= mean_t <= andersen_range[1]:
        raise RuntimeError("andersen: mean temperature %.2f K" % mean_t)
    out["andersen"] = dict(andersen, mean_temperature=mean_t)
    del andersen["context"]

    langevin = _integrator_run(
        device, "langevin", box(), omm.LangevinIntegrator(
            300.0, FRICTION, DT_PS), state, langevin_steps,
        ENERGY_EVERY, lambda c: in_md(c.getState(
            getEnergy=True).getPotentialEnergy()), deadline, replay)
    t_langevin = langevin["context"].temperature()
    print("langevin: leapfrog Langevin (300 K, %.1f/ps, %.3f ps), %d "
          "steps: energies %s kJ/mol; T %.2f K; %.2f ns/day; launches %s; "
          "the eager loop's bits" % (
              FRICTION, DT_PS, langevin_steps,
              " ".join("%.1f" % e for e in langevin["readings"]),
              t_langevin, langevin["ns_day"],
              json.dumps(langevin["launches"])))
    if not 200.0 <= t_langevin <= 450.0:
        raise RuntimeError("langevin: temperature %.2f K outside 200-450 K"
                           % t_langevin)
    out["langevin"] = dict(langevin, temperature=t_langevin)
    del langevin["context"]

    brownian = _integrator_run(
        device, "brownian", box(), omm.BrownianIntegrator(
            300.0, BROWNIAN_FRICTION, BROWNIAN_DT), state, brownian_steps,
        brownian_steps // 2, lambda c: in_md(c.getState(
            getEnergy=True).getPotentialEnergy()), deadline, replay)
    print("brownian: 300 K, %.0f/ps, %.4f ps, %d steps: energies %s "
          "kJ/mol; largest relative constraint error %.3e (bar %.0e); %.2f "
          "ns/day; launches %s; the eager loop's bits" % (
              BROWNIAN_FRICTION, BROWNIAN_DT, brownian_steps,
              " ".join("%.1f" % e for e in brownian["readings"]),
              brownian["constraint_err"], CONSTRAINT_ERR_BAR,
              brownian["ns_day"], json.dumps(brownian["launches"])))
    out["brownian"] = brownian
    del brownian["context"]
    return out


def _drift(readings, every, dt, dof, temperature=300.0) -> float:
    """The slope of `readings` (kJ/mol, one every `every` steps of `dt`
    ps) in kT/dof/ns."""
    times_ns = np.arange(len(readings)) * every * dt / 1000.0
    slope = np.polyfit(times_ns, np.asarray(readings), 1)[0]
    return slope / (dof * omm.BOLTZ * temperature)


def _water_state(main):
    """(the relaxed water box's System, its final State, dof)."""
    state = main["context"].getState(getPositions=True, getVelocities=True)
    n_atoms = in_md(state.getPositions(asNumpy=True)).shape[0]
    system, _ = tip3p_water_box(n_atoms // 3)
    return system, state, 3 * system.getNumParticles() \
        - system.getNumConstraints()


def phase_custom(device, main, deadline=None, steps=CUSTOM_STEPS,
                 every=DRIFT_EVERY, replay=INTEGRATOR_REPLAY,
                 drift_gate=DRIFT_GATE, verlet_ms=None) -> dict:
    """The relaxed water box under custom_verlet() (profile_step.py)
    through
    _integrator_run: the total energy's drift within `drift_gate`
    kT/dof/ns; after the run the counter equals the steps, the last
    kinetic-energy sum (the run's last step fires it when `steps` is a
    multiple of CUSTOM_SUM_EVERY) equals Context.kinetic_energy() to 1e-9
    relative, and the while block made CUSTOM_LOOPS passes a step. The if
    and while blocks are conditional nodes of the step's graph. Raises on
    a miss."""
    deadline = deadline or Deadline(math.inf)
    system, state, dof = _water_state(main)
    integ = custom_verlet(VERLET_DT, CUSTOM_SUM_EVERY, CUSTOM_LOOPS)

    def after(ctx):
        return {name: integ.getGlobalVariableByName(name)
                for name in ("n", "ke", "passes")} | {
            "kinetic": ctx.kinetic_energy()}

    r = _integrator_run(device, "custom", system, integ, state, steps,
                        every, _total_energy, deadline, replay, after=after)
    drift = _drift(r["readings"], every, VERLET_DT, dof)
    got = r["after"]
    ke_err = abs(got["ke"] - got["kinetic"]) / got["kinetic"]
    print("custom: CustomIntegrator velocity Verlet at %.3f ps, %d steps, "
          "%d atoms: total energy %s kJ/mol (every %d steps); drift %.4e "
          "kT/dof/ns (gate |d| < %.1f); counter %d, ComputeSum ke %.6f vs "
          "kinetic_energy() %.6f kJ/mol (relative %.2e), while passes %d "
          "(%d a step); %.2f ns/day, %.4f ms a step (built-in Verlet %s); "
          "eager %.4f ms; launches %s; the eager loop's bits, variables "
          "and clock" % (
              VERLET_DT, steps, system.getNumParticles(), " ".join(
                  "%.1f" % e for e in r["readings"][::5]), every, drift,
              drift_gate, got["n"], got["ke"], got["kinetic"], ke_err,
              got["passes"], CUSTOM_LOOPS, r["ns_day"], r["ms_per_step"],
              "not run" if verlet_ms is None else "%.4f ms" % verlet_ms,
              r["eager_ms_per_step"], json.dumps(r["launches"])))
    if not abs(drift) < drift_gate:
        raise RuntimeError("custom: drift %.4e kT/dof/ns" % drift)
    if got["n"] != steps or got["passes"] != CUSTOM_LOOPS * steps:
        raise RuntimeError("custom: counter %s, passes %s after %d steps"
                           % (got["n"], got["passes"], steps))
    if not ke_err <= 1e-9:
        raise RuntimeError("custom: ComputeSum %.9f, kinetic energy %.9f"
                           % (got["ke"], got["kinetic"]))
    del r["context"]
    return dict(r, drift=drift, ke_err=ke_err)


def _nh_conserved(ctx, integ, dt) -> float:
    """Potential + kinetic + computeHeatBathEnergy, the kinetic energy
    shifted by half a step, 0.5 sum m (v + dt f / 2m)^2, as Verlet
    reports it."""
    st = ctx.getState(getEnergy=True, getForces=True)
    forces = torch.as_tensor(in_md(st.getForces(asNumpy=True)),
                             device=ctx._masses.device)
    v = ctx._state["velocities"] + (0.5 * dt) * forces \
        * ctx._inv_masses[:, None]
    kinetic = float(0.5 * torch.sum(ctx._masses[:, None] * v * v))
    return in_md(
        st.getPotentialEnergy()) + kinetic + integ.computeHeatBathEnergy()


def phase_nose_hoover(device, main, deadline=None, steps=NH_STEPS,
                      every=NH_EVERY, replay=INTEGRATOR_REPLAY,
                      drift_gate=DRIFT_GATE, t_range=NH_T_RANGE) -> dict:
    """The relaxed water box under NoseHooverIntegrator(NH_TEMPERATURE,
    NH_FREQUENCY, VERLET_DT) from velocities at NH_START K through
    _integrator_run, its conserved quantity (_nh_conserved) read every
    `every` steps; then NVE Verlet at VERLET_DT from the same positions
    and velocities, its total energy read at the same times. From
    velocities drawn afresh the energy of the step itself jumps over the
    first few hundred fs and drifts while the box relaxes, with no
    thermostat (Verlet as far as Nose-Hoover; nh_startup.py, PERF.md PR
    14), so the gate holds the chains to what they add: the slope of the
    conserved quantity less Verlet's energy, over the whole run, within
    `drift_gate` kT/dof/ns. The mean temperature of the readings after
    the first half lies within `t_range` (a rehearsal's few steps reach
    neither gate). The kinetic energy is shifted by half a step because
    the step kicks by a whole step before it drifts, as Verlet's does
    (the integrator reports the unshifted one, as the JAX package's
    does; ROADMAP, notes on the reference). Raises on a miss."""
    deadline = deadline or Deadline(math.inf)
    system, state, dof = _water_state(main)
    integ = omm.NoseHooverIntegrator(NH_TEMPERATURE, NH_FREQUENCY,
                                     VERLET_DT)
    temperatures = []

    def conserved(ctx):
        temperatures.append(ctx.temperature())
        return _nh_conserved(ctx, integ, VERLET_DT)

    r = _integrator_run(device, "nose-hoover", system, integ, state, steps,
                        every, conserved, deadline, replay,
                        temperature=NH_START)
    readings = r["readings"]
    temperatures = temperatures[:len(readings)]
    nve = omm.VerletIntegrator(VERLET_DT)
    ctx = (omm.Context(system, nve) if device.type == "cuda"
           else omm.Context(system, nve, "CPU"))
    ctx.setPositions(in_md(state.getPositions(asNumpy=True)))
    ctx.setVelocitiesToTemperature(NH_START, randomSeed=VELOCITY_SEED)
    verlet = [_total_energy(ctx)]
    for _ in range(len(readings) - 1):
        nve.step(every)
        verlet.append(_total_energy(ctx))
    del ctx
    deadline.check("nose-hoover: Verlet from the same start")
    settled = max(len(readings) // 4, 1)
    jumps = [float(np.mean(e[1:settled + 1]) - e[0])
             for e in (readings, verlet)]
    thermostat = _drift([h - e for h, e in zip(readings, verlet)], every,
                        VERLET_DT, dof)
    whole = _drift(readings, every, VERLET_DT, dof)
    after = _drift(readings[settled:], every, VERLET_DT, dof)
    whole_nve = _drift(verlet, every, VERLET_DT, dof)
    late = temperatures[len(temperatures) // 2 + 1:]
    mean_t = float(np.mean(late))
    print("nose-hoover: NoseHooverIntegrator(%.0f K, %.0f/ps, %.3f ps; chain "
          "3, MTS 3, YS 7) from %.0f K, %d steps: conserved %s kJ/mol "
          "(every %d steps), NVE Verlet from the same start %s; start-up "
          "jump (mean of the first %d steps less the start) %.1f kJ/mol, "
          "Verlet %.1f; drift %.4e kT/dof/ns (after step %d %.4e), Verlet "
          "%.4e; the chains' share (conserved less Verlet) %.4e kT/dof/ns "
          "(gate |d| < %.1f); T %s K, mean of the last %d readings %.2f K "
          "(gate %.0f-%.0f K); heat bath %.3f kJ/mol; %.2f ns/day, %.4f ms "
          "a step, eager %.4f ms; launches %s; the eager loop's bits, chains "
          "and clock" % (
              NH_TEMPERATURE, NH_FREQUENCY, VERLET_DT, NH_START, steps,
              " ".join("%.1f" % e for e in readings[::4]), every,
              " ".join("%.1f" % e for e in verlet[::4]), settled * every,
              jumps[0], jumps[1], whole, settled * every, after, whole_nve,
              thermostat, drift_gate,
              " ".join("%.1f" % t for t in temperatures[::4]), len(late),
              mean_t, *t_range, integ.computeHeatBathEnergy(), r["ns_day"],
              r["ms_per_step"], r["eager_ms_per_step"],
              json.dumps(r["launches"])))
    if not abs(thermostat) < drift_gate:
        raise RuntimeError("nose-hoover: the chains' drift %.4e kT/dof/ns"
                           % thermostat)
    if not t_range[0] <= mean_t <= t_range[1]:
        raise RuntimeError("nose-hoover: mean temperature %.2f K" % mean_t)
    del r["context"]
    return dict(r, drift=whole, thermostat=thermostat, jumps=jumps,
                verlet_drift=whole_nve, mean_temperature=mean_t)


def phase_variable(device, main, deadline=None, steps=VARIABLE_STEPS,
                   replay=INTEGRATOR_REPLAY,
                   energy_bar=VARIABLE_ENERGY_BAR) -> dict:
    """The relaxed water box under VariableLangevinIntegrator(300 K, 1/ps,
    VARIABLE_TOLERANCE) and VariableVerletIntegrator(VARIABLE_TOLERANCE),
    `steps` steps each, one a call, the step size read after each: every
    step size lies in (0, maximum], the clock equals the host's sum of
    them, Langevin's temperature lies within 200-450 K and Verlet's total
    energy changes by less than `energy_bar` relative. Raises on a
    miss."""
    deadline = deadline or Deadline(math.inf)
    system, state, _ = _water_state(main)
    out = {}
    for label, integ in (
            ("variable langevin", omm.VariableLangevinIntegrator(
                300.0, FRICTION, VARIABLE_TOLERANCE)),
            ("variable verlet", omm.VariableVerletIntegrator(
                VARIABLE_TOLERANCE))):
        r = _integrator_run(
            device, label, system, integ, state, steps, 1,
            lambda c: in_md(c.getIntegrator().getStepSize()), deadline, replay,
            before=_total_energy, after=lambda c: (
                in_md(c.getTime()), c.temperature(), _total_energy(c)))
        dts = r["readings"][1:]
        clock, temperature, energy = r["after"]
        total = 0.0
        for dt in dts:
            total = total + dt
        change = abs(energy / r["before"] - 1.0)
        print("%s: %d steps, error tolerance %.0e: step size mean %.6f ps, "
              "min %.6f, max %.6f (maximum %.1f); clock %.9f ps, sum of the "
              "step sizes %.9f; T %.2f K; total energy %.1f -> %.1f kJ/mol "
              "(%.3f %%); %.2f ns/day, %.4f ms a step, eager %.4f ms; "
              "launches %s; the eager loop's bits, step size and clock" % (
                  label, steps, VARIABLE_TOLERANCE, float(np.mean(dts)),
                  min(dts), max(dts), in_md(integ.getMaximumStepSize()), clock,
                  total, temperature, r["before"], energy, 100.0 * change,
                  r["ns_day"], r["ms_per_step"], r["eager_ms_per_step"],
                  json.dumps(r["launches"])))
        if not all(0.0 < dt <= in_md(
            integ.getMaximumStepSize()) for dt in dts):
            raise RuntimeError("%s: a step size outside (0, %.1f]: %s" % (
                label, in_md(integ.getMaximumStepSize()), dts))
        if clock != total:
            raise RuntimeError("%s: the clock reads %r, the step sizes sum "
                               "to %r" % (label, clock, total))
        if label.endswith("langevin") and not 200.0 <= temperature <= 450.0:
            raise RuntimeError("%s: temperature %.2f K" % (label,
                                                            temperature))
        if label.endswith("verlet") and not change < energy_bar:
            raise RuntimeError("%s: total energy changed by %.3f %%"
                               % (label, 100.0 * change))
        del r["context"]
        out[label] = dict(r, mean_dt=float(np.mean(dts)), clock=clock,
                          temperature=temperature, energy_change=change)
    return out


def _captures(ctx) -> int:
    return sum(p.graph is not None for p in ctx._programs.values())


def phase_compound(device, main, deadline=None, steps=COMPOUND_STEPS,
                   switches=COMPOUND_SWITCHES,
                   replay=INTEGRATOR_REPLAY) -> dict:
    """The relaxed water box under CompoundIntegrator(LangevinMiddle 300 K
    1/ps 2 fs, Verlet VERLET_DT): `steps` steps with member 0, then with
    member 1, switched `switches` times; the clock reads the host's sum of
    the members' step sizes, each member's program is captured once (no
    capture after the first switch back), kernels 1-3 launch; then
    `replay` steps across a switch from a snapshot through the step
    programs and the eager loop, with the same bits, shared tensors and
    clock. Raises on a miss."""
    deadline = deadline or Deadline(math.inf)
    system, state, _ = _water_state(main)
    integ = omm.CompoundIntegrator()
    integ.addIntegrator(omm.LangevinMiddleIntegrator(300.0, FRICTION, DT_PS))
    integ.addIntegrator(omm.VerletIntegrator(VERLET_DT))
    integ.setRandomNumberSeed(13)
    ctx = (omm.Context(system, integ) if device.type == "cuda"
           else omm.Context(system, integ, "CPU"))
    ctx.setPositions(in_md(state.getPositions(asNumpy=True)))
    ctx.setVelocities(in_md(state.getVelocities(asNumpy=True)))
    for kern in KERNELS:
        kern.launches = 0
    want, wall, captures, energies = 0.0, {0: 0.0, 1: 0.0}, [], []
    for segment in range(switches + 1):
        member = segment % 2
        integ.setCurrentIntegrator(member)
        run = _production(device, ctx, integ.step, 0.0, steps, steps,
                          deadline)
        energies += run["energies"][1:]
        wall[member] += run["wall_ms_per_step"] * steps
        for _ in range(steps):
            want = want + in_md(integ.getStepSize())
        captures.append(_captures(ctx))
    launches = {k.name: k.launches for k in MAIN_PATH_KERNELS}
    clock = in_md(ctx.getTime())
    temperature = ctx.temperature()
    constraint_err = _constraint_error(
        system, in_md(ctx.getState(getPositions=True).getPositions(
            asNumpy=True)))
    start = ctx._snapshot()
    runs = {}
    for path in ("graph", "eager"):
        ctx._restore(start)
        integ.setCurrentIntegrator(0)
        step = integ.step if path == "graph" else ctx._step_eager
        _production(device, ctx, step, 0.0, replay // 2, replay, deadline)
        integ.setCurrentIntegrator(1)
        runs[path] = _production(device, ctx, step, 0.0, replay - replay // 2,
                                 replay, deadline)
    _same_bits("compound", (runs["graph"]["positions"],
                            runs["graph"]["velocities"]),
               (runs["eager"]["positions"], runs["eager"]["velocities"]))
    _same_state("compound", runs["graph"], runs["eager"])
    ms = {m: wall[m] / (steps * ((switches + 2 - m) // 2)) for m in wall}
    print("compound: CompoundIntegrator(LangevinMiddle 300 K %.1f/ps %.3f "
          "ps, Verlet %.3f ps), %d steps a member, %d switches: clock "
          "%.9f ps (host sum %.9f); programs captured after each segment "
          "%s; energies %s kJ/mol; T %.2f K; largest relative constraint "
          "error %.3e; ms a step LangevinMiddle %.4f, Verlet %.4f; "
          "launches %s; %d steps across a switch replayed through the "
          "eager loop: the same bits, shared tensors and clock" % (
              FRICTION, DT_PS, VERLET_DT, steps, switches, clock, want,
              captures, " ".join("%.1f" % e for e in energies), temperature,
              constraint_err, ms[0], ms[1], json.dumps(launches), replay))
    if clock != want or abs(clock - steps * (DT_PS + VERLET_DT)
                            * (switches + 1) / 2) > 1e-9:
        raise RuntimeError("compound: the clock reads %r, the step sizes "
                           "sum to %r" % (clock, want))
    if device.type == "cuda" and (captures[1] != 2 or captures[-1] != 2):
        raise RuntimeError("compound: programs captured %s (one a member "
                           "wanted)" % captures)
    if device.type == "cuda" and min(launches.values()) <= 0:
        raise RuntimeError("compound: a kernel of its path never launched: "
                           "%s" % launches)
    if not 200.0 <= temperature <= 450.0:
        raise RuntimeError("compound: temperature %.2f K" % temperature)
    if not all(math.isfinite(e) for e in energies):
        raise RuntimeError("compound: an energy is not finite: %s"
                           % energies)
    if not constraint_err <= CONSTRAINT_ERR_BAR:
        raise RuntimeError("compound: constraint error %.3e"
                           % constraint_err)
    deadline.check("compound")
    return {"clock": clock, "captures": captures, "ms": ms,
            "launches": launches, "temperature": temperature}


def phase_mts_bilayer(device, bilayer, deadline=None, steps=MTS_STEPS,
                      replay=INTEGRATOR_REPLAY,
                      t_range=BILAYER_T_RANGE) -> dict:
    """The bilayer phase's system (from the bilayer Context's last state)
    with the NonbondedForce in group 0 and the bonded forces in group 1,
    under MTSLangevinIntegrator(BILAYER_TEMPERATURE, FRICTION, DT_PS,
    MTS_GROUPS) through _integrator_run, read by temperature (which
    evaluates no force): the final temperature within `t_range`, and
    kernel 1 launched once a step and once more for the first step's
    start (the slow group is not evaluated twice at one position). Raises
    on a miss."""
    deadline = deadline or Deadline(math.inf)
    system = bilayer["system"]
    state = bilayer["context"].getState(getPositions=True,
                                        getVelocities=True)
    groups = {f: f.getForceGroup() for f in system.getForces()}
    for f in system.getForces():
        if type(f).__name__ != "CMMotionRemover":
            f.setForceGroup(0 if type(f).__name__ == "NonbondedForce"
                            else 1)
    integ = omm.MTSLangevinIntegrator(BILAYER_TEMPERATURE, FRICTION, DT_PS,
                                      MTS_GROUPS)
    integ.setRandomNumberSeed(21)
    try:
        r = _integrator_run(device, "mts bilayer", system, integ, state,
                            steps, ENERGY_EVERY, lambda c: c.temperature(),
                            deadline, replay)
    finally:
        for f, g in groups.items():
            f.setForceGroup(g)
    temperature = r["readings"][-1]
    tiles = r["launches"][tile_pairs.TILES.name]
    want = steps + 1
    print("mts bilayer: MTSLangevinIntegrator(%.2f K, %.1f/ps, %.3f ps, %s; "
          "NonbondedForce group 0, bonded group 1), %d steps: T %s K; "
          "kernel 1 launched %d times (%d steps + the first step's start; "
          "%d escalations); %.2f ns/day, %.4f ms a step (LangevinMiddle "
          "%.4f ms in the bilayer phase), eager %.4f ms; launches %s; the "
          "eager loop's bits, variables and clock" % (
              BILAYER_TEMPERATURE, FRICTION, DT_PS, list(MTS_GROUPS), steps,
              " ".join("%.1f" % t for t in r["readings"]), tiles, steps,
              r["escalations"], r["ns_day"], r["ms_per_step"],
              bilayer["graph"]["wall_ms_per_step"], r["eager_ms_per_step"],
              json.dumps(r["launches"])))
    if not t_range[0] <= temperature <= t_range[1]:
        raise RuntimeError("mts bilayer: temperature %.2f K" % temperature)
    if device.type == "cuda" and not (
            tiles == want if r["escalations"] == 0
            else want <= tiles <= want + STEP_CHUNK * r["escalations"]):
        raise RuntimeError("mts bilayer: kernel 1 launched %d times in %d "
                           "steps" % (tiles, steps))
    del r["context"]
    return dict(r, temperature=temperature, tiles=tiles)


def phase_amd_bilayer(device, bilayer, deadline=None, steps=AMD_STEPS,
                      every=AMD_EVERY, replay=INTEGRATOR_REPLAY,
                      fraction=AMD_FRACTION,
                      t_range=BILAYER_T_RANGE) -> dict:
    """The bilayer phase's system (from the bilayer Context's last state)
    under AMDForceGroupIntegrator(AMD_DT, g, alpha, E) on the torsions'
    group g (BILAYER_GROUPS), E = V0 + `fraction` |V0| and alpha =
    `fraction` |V0| from the torsion energy V0 at the start, through
    _integrator_run, read by the torsion energy: the boost active at
    every reading (below E), getEffectiveEnergy above the plain energy at
    the end, the final temperature within `t_range`. Raises on a miss."""
    deadline = deadline or Deadline(math.inf)
    system = bilayer["system"]
    g = BILAYER_GROUPS["PeriodicTorsionForce"]
    ctx0 = bilayer["context"]
    state = ctx0.getState(getPositions=True, getVelocities=True)
    v0 = in_md(ctx0.getState(getEnergy=True, groups={g}).getPotentialEnergy())
    threshold = v0 + fraction * abs(v0)
    alpha = fraction * abs(v0)
    integ = omm.AMDForceGroupIntegrator(AMD_DT, g, alpha, threshold)

    def after(ctx):
        total = in_md(ctx.getState(getEnergy=True).getPotentialEnergy())
        group = in_md(ctx.getState(getEnergy=True,
                                   groups={g}).getPotentialEnergy())
        return {"total": total, "group": group,
                "effective": in_md(integ.getEffectiveEnergy(total, group)),
                "temperature": ctx.temperature()}

    r = _integrator_run(device, "amd bilayer", system, integ, state, steps,
                        every, lambda c: in_md(c.getState(
                            getEnergy=True, groups={g}).getPotentialEnergy()),
                        deadline, replay, after=after)
    got = r["after"]
    print("amd bilayer: AMDForceGroupIntegrator(%.3f ps, group %d, alpha "
          "%.2f, E %.2f kJ/mol; V0 %.2f), %d steps: torsion energy %s "
          "kJ/mol (every %d steps); at the end total %.2f, effective %.2f "
          "kJ/mol, T %.2f K; %.2f ns/day, %.4f ms a step, eager %.4f ms; "
          "launches %s; the eager loop's bits, variables and clock" % (
              AMD_DT, g, alpha, threshold, v0, steps, " ".join(
                  "%.1f" % e for e in r["readings"]), every, got["total"],
              got["effective"], got["temperature"], r["ns_day"],
              r["ms_per_step"], r["eager_ms_per_step"],
              json.dumps(r["launches"])))
    if not all(e < threshold for e in r["readings"]):
        raise RuntimeError("amd bilayer: a torsion energy at or above E %.2f:"
                           " %s" % (threshold, r["readings"]))
    if not got["effective"] > got["total"]:
        raise RuntimeError("amd bilayer: effective energy %.3f, plain %.3f"
                           % (got["effective"], got["total"]))
    if not t_range[0] <= got["temperature"] <= t_range[1]:
        raise RuntimeError("amd bilayer: temperature %.2f K"
                           % got["temperature"])
    del r["context"]
    return dict(r, threshold=threshold, alpha=alpha, v0=v0, **got)


def _ljpme_float64_check(inp) -> dict:
    """Kernel 1's MODE_LJPME (on the card, float32) against its plain
    version in float64 on the same inputs (positions, parameters and
    constants cast up): the median over atoms of the relative force
    error and the largest error against the largest force. The direct
    space's share 1 - e^-x (1 + x + x^2/2) cancels in float32 at small x
    (ops/pairs.py:dispersion_complement), which this check bounds."""
    pos4, par4, cand, count, words, consts = inp["tiles"]
    got = tile_pairs.nonbonded_tiles(pos4, par4, cand, count, words,
                                     consts, tile_pairs.MODE_LJPME, False)
    want = tile_pairs.nonbonded_tiles_plain(
        pos4.double(), par4.double(), cand, count, words, consts.double(),
        tile_pairs.MODE_LJPME, False)
    f, f64 = got[:, :3].double(), want[:, :3]
    norm = torch.linalg.norm(f64, dim=1)
    live = norm > 0
    rel = torch.linalg.norm(f - f64, dim=1)[live] / norm[live]
    return {"median": float(rel.median()),
            "max": float((f - f64).abs().max() / f64.abs().max())}


def phase_ljpme_bilayer(device, bilayer, deadline=None, steps=LJPME_STEPS,
                        replay=LJPME_REPLAY,
                        iterations=LJPME_MINIMIZE_ITERATIONS,
                        t_range=LJPME_T_RANGE) -> dict:
    """The bilayer phase's system at LJPME (0.9 nm, tolerance 5e-4), its
    reciprocal space in group LJPME_RECIP_GROUP, from the bilayer phase's
    minimized positions (phase_method): kernel 1 in MODE_LJPME and
    kernels 2-3 on the dispersion grid against their plain versions, and
    kernel 1 against its float64 plain version; each group's energy and
    the float32 forces against a float64 Context; one minimize call
    (kernels 1, 4 and 5); MD at BILAYER_TEMPERATURE through the step
    program replayed through the eager loop for the same bits; the
    kernels-line entries of the three. Restores the System's settings."""
    system = bilayer["system"]
    (nb,) = [f for f in system.getForces()
             if isinstance(f, omm.NonbondedForce)]
    try:
        nb.setNonbondedMethod(omm.NonbondedForce.LJPME)
        nb.setReciprocalSpaceForceGroup(LJPME_RECIP_GROUP)
        groups = sorted(set(BILAYER_GROUPS.values()) | {LJPME_RECIP_GROUP})
        out = phase_method(device, "ljpme bilayer", system,
                           bilayer["minimized_positions"],
                           BILAYER_TEMPERATURE, steps, replay,
                           t_range, deadline, groups=groups,
                           record="nonbonded_tiles_ljpme",
                           minimize_iterations=iterations,
                           kernel_names=LJPME_KERNELS)
    finally:
        nb.setNonbondedMethod(omm.NonbondedForce.PME)
        nb.setReciprocalSpaceForceGroup(-1)
    inp = out["inputs"]
    if device.type == "cuda":
        f64 = _ljpme_float64_check(inp)
        print("ljpme bilayer: kernel 1 MODE_LJPME against its float64 plain "
              "version: median relative force error %.3e (bar %.0e), "
              "largest error %.3e of the largest force (bar %.0e)" % (
                  f64["median"], LJPME_F64_MEDIAN_BAR, f64["max"],
                  LJPME_F64_MAX_BAR))
        if not (f64["median"] <= LJPME_F64_MEDIAN_BAR
                and f64["max"] <= LJPME_F64_MAX_BAR):
            raise RuntimeError("ljpme bilayer: kernel 1 MODE_LJPME misses "
                               "its float64 plain version: %s" % f64)
        out["float64"] = f64
        for kern in DISPERSION_KERNELS:
            if out["launches"].get(kern.name, 0) <= 0:
                raise RuntimeError("ljpme bilayer: %s never launched on "
                                   "its path: %s" % (kern.name,
                                                     out["launches"]))
        out["records"] = [out["record"]] + [
            _kernel_record(device, inp, kern.name,
                           out["launches"][kern.name],
                           out["kernel_errs"][kern.name], kern=kern)
            for kern in DISPERSION_KERNELS]
    del out["inputs"]
    return out


def _site_error(ctx) -> float:
    """Largest distance (nm) of a TIP4P-Ew M site from the weighted
    average of its water's O, H1 and H2."""
    w = in_md(ctx.getState(getPositions=True).getPositions(
        asNumpy=True)).reshape(-1, 4, 3)
    m = np.einsum("k,wkd->wd", builders.TIP4PEW_M_WEIGHTS, w[:, :3])
    return float(np.linalg.norm(w[:, 3] - m, axis=1).max())


def phase_tip4pew(device, deadline=None, n_waters=TIP4PEW_WATERS,
                  steps=TIP4PEW_STEPS, replay=TIP4PEW_REPLAY,
                  relax=TIP4PEW_RELAX) -> dict:
    """`n_waters` TIP4P-Ew waters (tip4pew_water_box: four particles a
    water, the M sites virtual; PME 0.9 nm, rigid) through phase_method:
    kernels 1-3 against their plain versions, the float32 forces against
    float64 at the lattice start, relaxed by `relax`, then LangevinMiddle
    300 K, 1/ps, 2 fs through the step program replayed through the eager
    loop for the same bits; every site within SITE_BAR nm of its weighted
    parents at the end."""
    system, positions = tip4pew_water_box(n_waters)
    sites = {}

    def check(ctx):
        sites["err"] = _site_error(ctx)
        sites["state"] = ctx.getState(getPositions=True, getVelocities=True)
        if not sites["err"] <= SITE_BAR:
            raise RuntimeError("tip4pew: a site lies %.3e nm from its "
                               "parents' average" % sites["err"])
        return sites["err"]

    out = phase_method(device, "tip4pew water", system, positions, 300.0,
                       steps, replay, (200.0, 450.0), deadline,
                       kernel_names=MAIN_PATH_NAMES, check=check,
                       relax=relax)
    del out["inputs"]
    print("tip4pew water: %d particles (%d sites); largest site error %.3e "
          "nm (bar %.0e)" % (system.getNumParticles(), n_waters,
                             sites["err"], SITE_BAR))
    out.update(system=system, site_err=sites["err"],
               final_state=sites["state"])
    return out


def phase_mts_tip4pew(device, tip4pew, deadline=None,
                      steps=MTS_TIP4PEW_STEPS, replay=INTEGRATOR_REPLAY,
                      t_range=MTS_T_RANGE) -> dict:
    """The TIP4P-Ew box from the end of phase_tip4pew under
    MTSLangevinIntegrator(300 K, 1/ps, MTS_TIP4PEW_DT, MTS_TIP4PEW_GROUPS)
    with the NonbondedForce's reciprocal space in group 1, the rest in
    group 0 (_integrator_run): the reciprocal space once an outer step
    (kernels 2 and 3 `steps` + 1 times: the first step's start too),
    the direct space twice (kernel 1 2 `steps` + 1 times), a chunk redone
    after an escalation counted apart; the final temperature within
    `t_range`; the eager loop's bits. Restores the reciprocal group."""
    deadline = deadline or Deadline(math.inf)
    system = tip4pew["system"]
    (nb,) = system.getForces()
    state = tip4pew["final_state"]
    integ = omm.MTSLangevinIntegrator(300.0, FRICTION, MTS_TIP4PEW_DT,
                                      MTS_TIP4PEW_GROUPS)
    integ.setRandomNumberSeed(23)
    nb.setReciprocalSpaceForceGroup(1)
    try:
        r = _integrator_run(device, "mts tip4pew", system, integ, state,
                            steps, ENERGY_EVERY, lambda c: c.temperature(),
                            deadline, replay, after=_site_error)
    finally:
        nb.setReciprocalSpaceForceGroup(-1)
    temperature = r["readings"][-1]
    want = {tile_pairs.TILES.name: 2 * steps + 1,
            pme_zslab.SPREAD.name: steps + 1,
            pme_zslab.GATHER.name: steps + 1}
    redone = {k: r["launches"][k] - w for k, w in want.items()}
    print("mts tip4pew: MTSLangevinIntegrator(300 K, %.1f/ps, %.3f ps, %s; "
          "reciprocal space group 1, the rest group 0), %d steps: T %s K; "
          "launches %s (wanted %s; redone after %d escalations %s); "
          "largest site error %.3e nm; %.2f ns/day, %.4f ms a step, eager "
          "%.4f ms; the eager loop's bits, variables and clock" % (
              FRICTION, MTS_TIP4PEW_DT, list(MTS_TIP4PEW_GROUPS), steps,
              " ".join("%.1f" % t for t in r["readings"]),
              json.dumps(r["launches"]), json.dumps(want), r["escalations"],
              json.dumps(redone), r["after"], r["ns_day"],
              r["ms_per_step"], r["eager_ms_per_step"]))
    if not t_range[0] <= temperature <= t_range[1]:
        raise RuntimeError("mts tip4pew: temperature %.2f K" % temperature)
    if not r["after"] <= SITE_BAR:
        raise RuntimeError("mts tip4pew: site error %.3e nm" % r["after"])
    if device.type == "cuda":
        limit = (2 * STEP_CHUNK + 1) * r["escalations"]
        for k, extra in redone.items():
            if not (extra == 0 if r["escalations"] == 0
                    else 0 <= extra <= limit):
                raise RuntimeError("mts tip4pew: %s launched %d times in "
                                   "%d steps (wanted %d)" % (
                                       k, r["launches"][k], steps, want[k]))
    del r["context"]
    return dict(r, temperature=temperature, want=want, redone=redone)


def _without_dispersion_correction(ctx, energy) -> float:
    """`energy` of `ctx` less its NonbondedForce's dispersion correction
    at its box: under offsets the correction takes the parameters at the
    global parameters' defaults (as OpenMM and the JAX package take it),
    a Context with the parameters built in takes them as they are."""
    box = in_md(ctx.getState().getPeriodicBoxVectors(asNumpy=True))
    return energy - float(ctx._nonbonded.disp_coeff) / float(
        np.linalg.det(np.asarray(box)))


def _decouple(nb, atoms):
    """Charges and epsilons of `atoms` to 0, each brought back by a
    particle offset of the global parameter "lambda" (default 1)."""
    nb.addGlobalParameter("lambda", 1.0)
    for i in atoms:
        q, sigma, eps = in_md(nb.getParticleParameters(i))
        nb.setParticleParameters(i, 0.0, sigma, 0.0)
        nb.addParticleParameterOffset("lambda", i, q, 0.0, eps)


def phase_offsets(device, main, deadline=None, waters=OFFSET_WATERS,
                  lambdas=OFFSET_LAMBDAS, chunk=OFFSET_CHUNK) -> dict:
    """The relaxed water box of phase_main_path (its final positions and
    velocities) with a global parameter "lambda" whose particle offsets
    take the first `waters` waters' charges and epsilons to 0 at lambda
    0: `chunk` steps at each of `lambdas` set by setParameter through one
    step program (no capture after the first), each main-path kernel
    launched at least once a step by those steps alone (the counts are
    zeroed before each step call and read after it); at each, the energy
    against a float64 Context and against a Context with those
    parameters built in; then updateParametersInContext on the next
    `waters` waters' charges (halved): the energy of a fresh Context and
    no new capture; the last chunk replayed through the eager loop for the
    same bits. The comparison with the parameters built in leaves out the
    dispersion correction (_without_dispersion_correction). Returns the
    Context (phase_checkpoint goes on with it)."""
    deadline = deadline or Deadline(math.inf)
    platform = "CUDA" if device.type == "cuda" else "CPU"
    st = main["context"].getState(getPositions=True, getVelocities=True)
    n_waters = in_md(st.getPositions(asNumpy=True)).shape[0] // 3
    system, _ = tip3p_water_box(n_waters)
    (nb,) = system.getForces()
    _decouple(nb, range(3 * waters))
    built, _ = tip3p_water_box(n_waters)
    (nb_built,) = built.getForces()
    integ = omm.LangevinMiddleIntegrator(300.0, FRICTION, DT_PS)
    integ.setRandomNumberSeed(29)
    ctx = (omm.Context(system, integ) if platform == "CUDA"
           else omm.Context(system, integ, platform))
    ctx.setPositions(in_md(st.getPositions(asNumpy=True)))
    ctx.setVelocities(in_md(st.getVelocities(asNumpy=True)))
    oracle = omm.Context(system, omm.LangevinMiddleIntegrator(
        300.0, FRICTION, DT_PS), platform, {"Precision": "double"})
    launches = dict.fromkeys(MAIN_PATH_NAMES, 0)
    rows, captures = [], []
    for lam in lambdas:
        ctx.setParameter("lambda", lam)
        for kern in _build.KERNELS:
            kern.launches = 0
        integ.step(chunk)
        for kern in MAIN_PATH_KERNELS:
            launches[kern.name] += kern.launches
        captures.append(_captures(ctx))
        pos = in_md(ctx.getState(getPositions=True).getPositions(asNumpy=True))
        e32 = in_md(ctx.getState(getEnergy=True).getPotentialEnergy())
        oracle.setPositions(pos)
        oracle.setParameter("lambda", lam)
        e64 = in_md(oracle.getState(getEnergy=True).getPotentialEnergy())
        for i in range(3 * waters):
            q, sigma, eps = in_md(nb_built.getParticleParameters(i))
            _, _, q1, _, e1 = nb.getParticleParameterOffset(i)
            nb_built.setParticleParameters(i, lam * q1, sigma, lam * e1)
        twin = (omm.Context(built, omm.LangevinMiddleIntegrator(
            300.0, FRICTION, DT_PS)) if platform == "CUDA"
            else omm.Context(built, omm.LangevinMiddleIntegrator(
                300.0, FRICTION, DT_PS), platform))
        twin.setPositions(pos)
        e_built = _without_dispersion_correction(
            twin, in_md(twin.getState(getEnergy=True).getPotentialEnergy()))
        del twin
        rows.append((lam, e32, e64, _without_dispersion_correction(ctx, e32),
                     e_built))
        deadline.check("offsets: lambda %.2f" % lam)
    for i in range(3 * waters, 6 * waters):
        q, sigma, eps = in_md(nb.getParticleParameters(i))
        nb.setParticleParameters(i, 0.5 * q, sigma, eps)
    nb.updateParametersInContext(ctx)
    start = ctx._snapshot()
    graph = _production(device, ctx, integ.step, 0.0, chunk, chunk,
                        deadline)
    after_update = _captures(ctx)
    ctx._restore(start)
    eager = _production(device, ctx, ctx._step_eager, 0.0, chunk, chunk,
                        deadline)
    _same_bits("offsets", (graph["positions"], graph["velocities"]),
               (eager["positions"], eager["velocities"]))
    _same_state("offsets", graph, eager)
    e_now = in_md(ctx.getState(getEnergy=True).getPotentialEnergy())
    fresh = (omm.Context(system, omm.LangevinMiddleIntegrator(
        300.0, FRICTION, DT_PS)) if platform == "CUDA"
        else omm.Context(system, omm.LangevinMiddleIntegrator(
            300.0, FRICTION, DT_PS), platform))
    fresh.setPositions(in_md(ctx.getState(getPositions=True).getPositions(
        asNumpy=True)))
    fresh.setParameter("lambda", lambdas[-1])
    e_fresh = in_md(fresh.getState(getEnergy=True).getPotentialEnergy())
    del fresh, oracle
    print("offsets: %d waters decoupled by lambda; %s; programs captured "
          "after each chunk %s, after updateParametersInContext on %d "
          "other waters %d; energy %.6f, a fresh Context's %.6f kJ/mol; %d "
          "steps replayed through the eager loop: the same bits; launches "
          "%s" % (waters, "; ".join(
              "lambda %.2f: %.6f (float64 %.6f; less the dispersion "
              "correction %.6f, with the parameters built in %.6f)" % r
              for r in rows), captures, waters, after_update, e_now,
              e_fresh, chunk, json.dumps(launches)))
    for lam, e32, e64, e_direct, e_built in rows:
        if not abs(e32 - e64) <= GROUP_ENERGY_BAR * abs(e64):
            raise RuntimeError("offsets: at lambda %.2f the energy %.6f, "
                               "float64 %.6f" % (lam, e32, e64))
        if not abs(e_direct - e_built) <= OFFSET_BUILT_IN_BAR * abs(
                e_built):
            raise RuntimeError("offsets: at lambda %.2f the energy less "
                               "its dispersion correction %.6f, built in "
                               "%.6f" % (lam, e_direct, e_built))
    if not abs(e_now - e_fresh) <= OFFSET_BUILT_IN_BAR * abs(e_fresh):
        raise RuntimeError("offsets: after the update %.6f, a fresh "
                           "Context %.6f" % (e_now, e_fresh))
    if abs(rows[0][1] - rows[-1][1]) <= 1.0:
        raise RuntimeError("offsets: lambda moved the energy by less than "
                           "1 kJ/mol")
    if device.type == "cuda":
        if len(set(captures + [after_update])) != 1 or captures[0] != 1:
            raise RuntimeError("offsets: programs captured %s, %d after "
                               "the update (one wanted)"
                               % (captures, after_update))
        steps = chunk * len(lambdas)
        if min(launches.values()) < steps:
            raise RuntimeError("offsets: in %d steps a kernel launched "
                               "fewer times than once a step: %s"
                               % (steps, launches))
    deadline.check("offsets")
    return {"rows": rows, "captures": captures, "context": ctx,
            "system": system, "update": (e_now, e_fresh),
            "ms_per_step": graph["wall_ms_per_step"],
            "ns_day": graph["ns_day"]}


def phase_checkpoint(device, offsets, deadline=None,
                     steps=CHECKPOINT_STEPS) -> dict:
    """On the Context phase_offsets leaves: createCheckpoint, `steps`
    steps, loadCheckpoint, the same steps again: the same bits
    (positions, velocities, clock, step count, the Context's shared
    tensors); the checkpoint in a second Context of the same System, the
    same steps: the same bits again; reinitialize(preserveState=True)
    keeps the state."""
    deadline = deadline or Deadline(math.inf)
    ctx, system = offsets["context"], offsets["system"]
    integ = ctx.getIntegrator()

    def bits(c):
        st = c.getState(getPositions=True, getVelocities=True,
                        getParameters=True)
        return {"positions": in_md(st.getPositions(asNumpy=True)),
                "velocities": in_md(st.getVelocities(
                    asNumpy=True)), "time": in_md(c.getTime()),
                "step": c.getStepCount(), "parameters": st.getParameters(),
                "shared": [t.cpu().clone() for t in c._step_tensors()]}

    def same(what, a, b):
        for key in ("positions", "velocities"):
            if not np.array_equal(a[key], b[key]):
                raise RuntimeError("checkpoint: %s: %s differ by up to "
                                   "%.3e" % (what, key,
                                             np.abs(a[key] - b[key]).max()))
        for key in ("time", "step", "parameters"):
            if a[key] != b[key]:
                raise RuntimeError("checkpoint: %s: %s %r against %r"
                                   % (what, key, a[key], b[key]))
        if not all(torch.equal(x, y) for x, y in zip(a["shared"],
                                                     b["shared"])):
            raise RuntimeError("checkpoint: %s: a shared tensor differs"
                               % what)

    t0 = time.perf_counter()
    checkpoint = ctx.createCheckpoint()
    create_s = time.perf_counter() - t0
    integ.step(steps)
    want = bits(ctx)
    t0 = time.perf_counter()
    ctx.loadCheckpoint(checkpoint)
    load_s = time.perf_counter() - t0
    integ.step(steps)
    same("reloaded", bits(ctx), want)
    deadline.check("checkpoint: reload")
    twin_integ = omm.LangevinMiddleIntegrator(300.0, FRICTION, DT_PS)
    twin = (omm.Context(system, twin_integ) if device.type == "cuda"
            else omm.Context(system, twin_integ, "CPU"))
    twin.loadCheckpoint(checkpoint)
    twin_integ.step(steps)
    same("a second Context", bits(twin), want)
    del twin
    deadline.check("checkpoint: second Context")
    before = bits(ctx)
    ctx.reinitialize(preserveState=True)
    same("reinitialize(preserveState=True)", bits(ctx), before)
    print("checkpoint: %.1f MB, created in %.3f s, loaded in %.3f s; %d "
          "steps after loading it, in the same Context and in a second "
          "one, give the uninterrupted run's bits (positions, velocities, "
          "clock, step count, shared tensors); reinitialize(preserveState"
          "=True) keeps the state" % (len(checkpoint) / 1e6, create_s,
                                      load_s, steps))
    deadline.check("checkpoint")
    return {"bytes": len(checkpoint), "create_s": create_s,
            "load_s": load_s}


# -- the custom forces ----------------------------------------------------
def _group_energies(ctx, groups) -> dict:
    return {g: in_md(ctx.getState(getEnergy=True,
                                  groups={g}).getPotentialEnergy())
            for g in groups}


def _close_energy(got, want, bar) -> bool:
    """|got - want| within `bar` of |want|, an energy of exactly 0 (a
    flat-bottom restraint inside its bottom) only by itself."""
    return abs(got - want) <= bar * abs(want)


def _central_difference(ctx, name, value, group, h=ALCHEMICAL_H) -> float:
    """(E(value + h) - E(value - h)) / 2h of force group `group` of the
    float64 Context `ctx`, its parameter left at `value`."""
    e = []
    for x in (value + h, value - h):
        ctx.setParameter(name, x)
        e.append(in_md(ctx.getState(getEnergy=True,
                              groups={group}).getPotentialEnergy()))
    ctx.setParameter(name, value)
    return (e[0] - e[1]) / (2.0 * h)


def _deriv_record(device, ctx, name, launches) -> dict:
    """The kernels line's entry of kernel 1's derivative instantiation on
    the Context's state (its candidate state, the effective parameters
    and their derivatives in `name`), held against its plain version:
    raises beyond TOLERANCE["nonbonded_tiles"] of its largest value or
    on other bits a second call; times, bound (the candidate state's and
    par4's bytes, the derivative's operations of the pairs inside the
    cutoff) and launches from the path's run."""
    nb = ctx._nonbonded
    tiles = ctx._current_tiles()
    pos, box = ctx._state["positions"], ctx._state["box"]
    boxd = box.to(nb.dtype)
    params = nb.particle_params()
    k = nb.gp_index[name]
    dq, dsig, deps = nb._offset_derivs(k, nb.p_off_param, nb.p_off_scale,
                                        nb.p_off).unbind(1)
    order = tiles["order"]
    args = (tile_pairs.sorted_positions(pos.to(nb.dtype), boxd, tiles),
            tile_pairs.tile_params(*params, order, c6=nb.ljpme),
            tile_pairs.tile_param_derivs(*params, dq, dsig, deps, order,
                                         c6=nb.ljpme),
            tiles["cand"], tiles["count"], tiles["words"],
            tile_pairs.tile_consts(boxd, nb.tile_scalars), nb.mode,
            nb.use_switch)
    saved = tile_pairs.TILES_DERIV.launches

    def kernel():
        return tile_pairs.nonbonded_tiles_deriv(*args)

    def plain():
        return tile_pairs.nonbonded_tiles_deriv_plain(*args)

    got, want = kernel(), plain()
    if device.type == "cuda":
        _check_repeatable("nonbonded_tiles_deriv", got, kernel())
    err, scale, rel = _compare(got, want)
    if not rel <= TOLERANCE["nonbonded_tiles"]:
        raise RuntimeError("kernel nonbonded_tiles_deriv: error %.3e of its "
                           "largest value %.3e" % (rel, scale))
    inputs = sum(t.numel() * t.element_size() for t in args[:7])
    counts = tile_pairs.count_tile_pairs(args[0], *args[3:7])
    bound = _bound(inputs + 4 * args[0].numel(),
                   DERIV_OPS_PER_PAIR * counts["inside"] / 2)
    cuda = device.type == "cuda"
    record = {"name": "nonbonded_tiles_deriv", "route": "cuda",
              "source": tile_pairs.TILES_DERIV.source,
              "replaces": tile_pairs.TILES_DERIV.replaces,
              "launches": launches, "max_abs_err": err,
              "ms": _time_ms(kernel, device) if cuda else None,
              "plain_ms": (_time_ms(plain, device, PLAIN_REPS, 1) if cuda
                           else None),
              "bound_ms": bound[0], "bound_by": bound[1],
              "library_ms": None}
    tile_pairs.TILES_DERIV.launches = saved
    return record


def phase_alchemical(device, main, deadline=None, solute=ALCHEMICAL_SOLUTE,
                     lambdas=ALCHEMICAL_LAMBDAS, chunk=ALCHEMICAL_CHUNK,
                     replay=ALCHEMICAL_REPLAY,
                     iterations=ALCHEMICAL_MINIMIZE_ITERATIONS,
                     t_range=ALCHEMICAL_T_RANGE) -> dict:
    """models.alchemical_water_box over the relaxed water box of
    phase_main_path (its final positions and velocities), its first
    `solute` waters the solute: the NonbondedForce's charges by offsets of
    lambda_electrostatics, the soft-core CustomNonbondedForce of
    lambda_sterics over (solute, solvent) with dE/dlambda_sterics
    requested, the solute's Lennard-Jones CustomBondForce, a flat-bottom
    CustomExternalForce and a CustomCentroidBondForce. One minimize call
    of `iterations` iterations through kernels 1, 4 and 5, in which the
    energy falls; then at each (lambda_sterics, lambda_electrostatics) of
    `lambdas` (setParameter, one step program: no capture after the
    first), `chunk` steps with kernels 1-3
    launched once a step (counts zeroed before each chunk), each custom
    force group's float32 energy against a float64 Context within
    GROUP_ENERGY_BAR, and dE/dlambda_sterics (float32 pairs) against a
    central difference of float64 energies within ALCHEMICAL_DERIV_BAR;
    dE/dlambda_electrostatics (the NonbondedForce's offsets: kernel 1's
    derivative instantiation, kernel 2 on the charges and on their
    derivatives) of the NonbondedForce's group against a central
    difference of float64 energies within ALCHEMICAL_DERIV_BAR, the
    derivative reading timed; kernel 1's derivative instantiation
    against its plain version, its launches in those readings
    (_deriv_record); updateParametersInContext on the soft-core's solute
    epsilons (no
    capture, the energies again); `replay` steps from a snapshot through
    the step program and the eager loop: the same bits; the temperature
    within `t_range`, the constraint error within CONSTRAINT_ERR_BAR.
    Raises on a miss."""
    deadline = deadline or Deadline(math.inf)
    cuda = device.type == "cuda"
    st = main["context"].getState(getPositions=True, getVelocities=True)
    n_waters = in_md(st.getPositions(asNumpy=True)).shape[0] // 3
    system, _ = alchemical_water_box(n_waters, solute)
    groups = sorted(ALCHEMICAL_GROUPS.values())
    soft = system.getForces()[1]
    integ = omm.LangevinMiddleIntegrator(300.0, FRICTION, DT_PS)
    integ.setRandomNumberSeed(31)
    ctx = (omm.Context(system, integ) if cuda
           else omm.Context(system, integ, "CPU"))
    ctx.setPositions(in_md(st.getPositions(asNumpy=True)))
    ctx.setVelocities(in_md(st.getVelocities(asNumpy=True)))
    oracle = omm.Context(system, omm.VerletIntegrator(0.001),
                         "CUDA" if cuda else "CPU", {"Precision": "double"})
    before = in_md(ctx.getState(getEnergy=True).getPotentialEnergy())
    for kern in KERNELS:
        kern.launches = 0
    omm.LocalEnergyMinimizer.minimize(ctx, MINIMIZE_TOLERANCE, iterations)
    minimizer = {k.name: k.launches for k in MINIMIZER_KERNELS}
    after = in_md(ctx.getState(getEnergy=True).getPotentialEnergy())
    deadline.check("alchemical: minimize")
    rows, captures, ms, read_ms = [], [], [], []
    launches = dict.fromkeys(MAIN_PATH_NAMES, 0)
    deriv_launches = 0
    escalations = ctx.escalation_count
    for lam, lam_elec in lambdas:
        ctx.setParameter("lambda_sterics", lam)
        ctx.setParameter("lambda_electrostatics", lam_elec)
        for kern in KERNELS:
            kern.launches = 0
        _sync(device)
        t0 = time.perf_counter()
        integ.step(chunk)
        _sync(device)
        ms.append((time.perf_counter() - t0) / chunk * 1e3)
        for kern in MAIN_PATH_KERNELS:
            launches[kern.name] += kern.launches
        captures.append(_captures(ctx))
        pos = in_md(ctx.getState(getPositions=True).getPositions(asNumpy=True))
        oracle.setPositions(pos)
        oracle.setParameter("lambda_sterics", lam)
        oracle.setParameter("lambda_electrostatics", lam_elec)
        e32 = _group_energies(ctx, groups)
        e64 = _group_energies(oracle, groups)
        d32 = ctx.getState(getParameterDerivatives=True).\
            getEnergyParameterDerivatives()["lambda_sterics"]
        d64 = oracle.getState(getParameterDerivatives=True).\
            getEnergyParameterDerivatives()["lambda_sterics"]
        fd = _central_difference(oracle, "lambda_sterics", lam,
                                 ALCHEMICAL_GROUPS["CustomNonbondedForce"])
        tile_pairs.TILES_DERIV.launches = 0
        _sync(device)
        t0 = time.perf_counter()
        d_elec = ctx.getState(getParameterDerivatives=True, groups={0}).\
            getEnergyParameterDerivatives()["lambda_electrostatics"]
        read_ms.append((time.perf_counter() - t0) * 1e3)
        deriv_launches += tile_pairs.TILES_DERIV.launches
        fd_elec = _central_difference(oracle, "lambda_electrostatics",
                                      lam_elec, 0)
        soft_group = ALCHEMICAL_GROUPS["CustomNonbondedForce"]
        rows.append({"lambda": lam, "lambda_elec": lam_elec, "e32": e32,
                     "e64": e64, "d32": d32, "d64": d64, "fd": fd,
                     "d_elec": d_elec, "fd_elec": fd_elec,
                     "displacement_errors": _displacement_errors(
                         ctx, oracle, e64[soft_group])})
        deadline.check("alchemical: lambda %.2f" % lam)
    for i in range(soft.getNumParticles()):
        if i < 3 * solute:
            sigma, eps = in_md(soft.getParticleParameters(i))
            soft.setParticleParameters(i, [sigma, 0.9 * eps])
    record = _deriv_record(device, ctx, "lambda_electrostatics",
                           deriv_launches)
    soft.updateParametersInContext(ctx)
    soft.updateParametersInContext(oracle)
    integ.step(chunk)
    after_update = _captures(ctx)
    pos = in_md(ctx.getState(getPositions=True).getPositions(asNumpy=True))
    oracle.setPositions(pos)
    update = (_group_energies(ctx, groups), _group_energies(oracle, groups))
    times = _custom_times(device, ctx)
    start = ctx._snapshot()
    graph = _production(device, ctx, integ.step, 0.0, replay, replay,
                        deadline)
    ctx._restore(start)
    eager = _production(device, ctx, ctx._step_eager, 0.0, replay, replay,
                        deadline)
    _same_bits("alchemical", (graph["positions"], graph["velocities"]),
               (eager["positions"], eager["velocities"]))
    _same_state("alchemical", graph, eager)
    temperature = ctx.temperature()
    constraint_err = _constraint_error(
        system, in_md(ctx.getState(getPositions=True).getPositions(
            asNumpy=True)))
    escalations = ctx.escalation_count - escalations
    del oracle
    print("alchemical: %d atoms, %d solute waters (soft-core over %d x %d "
          "pairs); minimize %d iterations: %.3f -> %.3f kJ/mol, launches %s;"
          " %s; captures %s, %d after updateParametersInContext; %.4f ms a "
          "step at each lambda %s; T %.2f K; constraint error %.3e; the "
          "eager loop's bits over %d steps; launches %s in %d steps (%d "
          "escalations); each custom force's ef alone, ms a call: %s" % (
              system.getNumParticles(), solute, 3 * solute,
              system.getNumParticles() - 3 * solute, iterations, before,
              after, json.dumps(minimizer), "; ".join(
                  "lambda %.2f (electrostatics %.1f): group energies "
                  "float32 %s float64 %s, dE/dlambda %.6f (float64 %.6f, "
                  "central difference %.6f), the soft-core energy's error "
                  "with float64 displacements %.3e (float32 ones: %.3e)" % (
                      r["lambda"], r["lambda_elec"], _fmt(r["e32"]),
                      _fmt(r["e64"]), r["d32"], r["d64"], r["fd"],
                      *r["displacement_errors"])
                  for r in rows),
              captures, after_update, ms[0], " ".join(
                  "%.4f" % m for m in ms), temperature, constraint_err,
              replay, json.dumps(launches), chunk * len(lambdas),
              escalations, ", ".join(
                  "%s %s" % (k, "not measured" if t is None else "%.4f" % t)
                  for k, t in times.items())))
    print("alchemical: dE/dlambda_electrostatics of the NonbondedForce's "
          "group (its offsets) %s against central differences of float64 "
          "energies; a derivative reading %s ms; kernel 1's derivative "
          "instantiation %d launches, %s ms a call (plain %s, bound %.5f "
          "ms, %s), largest error against its plain version %.3e" % (
              " ".join("%.6f (%.6f)" % (r["d_elec"], r["fd_elec"])
                       for r in rows),
              " ".join("%.3f" % m for m in read_ms), deriv_launches,
              record["ms"], record["plain_ms"], record["bound_ms"],
              record["bound_by"], record["max_abs_err"]))
    for r in rows + [{"lambda": "after update", "e32": update[0],
                      "e64": update[1]}]:
        for g in groups:
            if not _close_energy(r["e32"][g], r["e64"][g], GROUP_ENERGY_BAR):
                raise RuntimeError("alchemical: at lambda %s group %d "
                                   "float32 %.6f, float64 %.6f" % (
                                       r["lambda"], g, r["e32"][g],
                                       r["e64"][g]))
    for r in rows:
        if not abs(r["d32"] - r["fd"]) <= ALCHEMICAL_DERIV_BAR * abs(
                r["fd"]):
            raise RuntimeError("alchemical: at lambda %.2f dE/dlambda %.6f, "
                               "central difference %.6f" % (
                                   r["lambda"], r["d32"], r["fd"]))
        if not abs(r["d_elec"] - r["fd_elec"]) <= ALCHEMICAL_DERIV_BAR * abs(
                r["fd_elec"]):
            raise RuntimeError("alchemical: at lambda_electrostatics %.2f "
                               "dE/dlambda %.6f, central difference %.6f" % (
                                   r["lambda_elec"], r["d_elec"],
                                   r["fd_elec"]))
    if cuda and deriv_launches < len(lambdas):
        raise RuntimeError("alchemical: kernel 1's derivative instantiation "
                           "launched %d times in %d readings"
                           % (deriv_launches, len(lambdas)))
    if not (math.isfinite(after) and after < before):
        raise RuntimeError("alchemical: minimization %.3f -> %.3f"
                           % (before, after))
    if not t_range[0] <= temperature <= t_range[1]:
        raise RuntimeError("alchemical: temperature %.2f K" % temperature)
    if not constraint_err <= CONSTRAINT_ERR_BAR:
        raise RuntimeError("alchemical: constraint error %.3e"
                           % constraint_err)
    if cuda:
        steps = chunk * len(lambdas)
        if len(set(captures + [after_update])) != 1 or captures[0] != 1:
            raise RuntimeError("alchemical: programs captured %s, %d after "
                               "the update (one wanted)"
                               % (captures, after_update))
        if any(not (n == steps if escalations == 0
                    else steps <= n <= steps + STEP_CHUNK * escalations)
               for n in launches.values()):
            raise RuntimeError("alchemical: launches %s in %d steps (%d "
                               "escalations)" % (launches, steps,
                                                 escalations))
        if min(minimizer.values()) <= 0:
            raise RuntimeError("alchemical: the minimizer's kernels %s"
                               % minimizer)
    deadline.check("alchemical")
    return {"rows": rows, "ms_per_step": ms, "temperature": temperature,
            "times": times, "captures": captures,
            "minimized": (before, after),
            "launches": launches, "minimizer": minimizer,
            "deriv_record": record, "read_ms": read_ms,
            "eager_ms_per_step": eager["wall_ms_per_step"],
            "graph_ms_per_step": graph["wall_ms_per_step"]}


def _float32_sweep(ctx):
    """The soft-core sweep of the alchemical Context `ctx` at its state
    with float32 displacements (the port takes them in float64): a
    callable."""
    soft = ctx._custom[0]
    pos, box = ctx._state["positions"], ctx._state["box"]
    fn32 = soft._pair_fn(soft._fn, soft._globals(torch.float32))
    return lambda: soft.sweep(pos.float(), box.float(), fn32, soft.cutoff,
                              0, torch.float32)


def _displacement_errors(ctx, oracle, e64) -> tuple:
    """The soft-core energy's relative error against its float64 value
    e64 (the float64 Context `oracle`'s, set alike), with float64 and with
    float32 displacements."""
    pos, box = ctx._state["positions"], ctx._state["box"]
    got = (float(ctx._custom[0].ef(pos, box)[0]),
           float(_float32_sweep(ctx)()[0]))
    return tuple(abs(e - e64) / abs(e64) for e in got)


def _custom_times(device, ctx) -> dict:
    """Each custom force's ef alone at the Context's state, and the
    soft-core sweep with float32 displacements, ms a call (_time_ms); on
    the CPU None (not measured)."""
    pos, box = ctx._state["positions"], ctx._state["box"]

    def timed(fn):
        return _time_ms(fn, device) if device.type == "cuda" else None

    out = {m.name: timed(lambda m=m: m.ef(pos, box)) for m in ctx._custom}
    out["sweep, float32 displacements"] = timed(_float32_sweep(ctx))
    return out


def _fmt(energies) -> str:
    return "{%s}" % ", ".join("%d: %.6f" % kv for kv in energies.items())


def _twin_reading(device, forces, positions, box) -> dict:
    """{group: (energy, forces)} of a float64 Context (the default
    platform on a GPU, "CPU" otherwise) of a System that holds only
    `forces` and no constraints, at `positions` in `box`."""
    system = omm.System()
    for _ in range(positions.shape[0]):
        system.addParticle(1.0)
    system.setDefaultPeriodicBoxVectors(*box)
    for force in forces:
        system.addForce(force)
    ctx = omm.Context(system, omm.VerletIntegrator(0.001),
                      "CUDA" if device.type == "cuda" else "CPU",
                      {"Precision": "double"})
    ctx.setPositions(positions)
    out = {}
    for force in forces:
        g = force.getForceGroup()
        st = ctx.getState(getEnergy=True, getForces=True, groups={g})
        out[g] = (in_md(st.getPotentialEnergy()),
                  in_md(st.getForces(asNumpy=True)))
    return out


def _relative(got, want) -> tuple:
    """(energy relative error, largest force error over the largest
    force)."""
    return (abs(got[0] - want[0]) / abs(want[0]),
            float(np.abs(got[1] - want[1]).max() / np.abs(want[1]).max()))


def phase_custom_bilayer(device, bilayer, deadline=None, steps=TWIN_STEPS,
                         replay=TWIN_REPLAY,
                         t_range=BILAYER_T_RANGE) -> dict:
    """The bilayer phase's system with its bonds, angles and torsions as
    custom twins (models.builders.custom_twins): at the bilayer Context's
    last positions,
    each twin's float64 energy and forces against its standard force's
    within TWIN_BAR (relative; forces against the largest), the
    CustomCompoundBondForce's against the CustomTorsionForce's; then
    `steps` steps through the step program with the twins (the compound
    force read, not integrated), `replay` of them replayed through the
    eager loop for the same bits, the temperature within `t_range`. Raises
    on a miss."""
    deadline = deadline or Deadline(math.inf)
    system = bilayer["system"]
    state = bilayer["context"].getState(getPositions=True,
                                        getVelocities=True)
    twin, pairs = custom_twins(system)
    pos, box = in_md(state.getPositions(asNumpy=True)), in_md(
        state.getPeriodicBoxVectors(asNumpy=True))
    standard = [pairs[k][0] for k in ("CustomBondForce", "CustomAngleForce",
                                      "CustomTorsionForce")]
    groups = {f: f.getForceGroup() for f in standard}
    for k, f in zip(("CustomBondForce", "CustomAngleForce",
                     "CustomTorsionForce"), standard):
        f.setForceGroup(TWIN_GROUPS[k])
    try:
        want = _twin_reading(device, standard, pos, box)
    finally:
        for f, g in groups.items():
            f.setForceGroup(g)
    got = _twin_reading(device, [t for _, t in pairs.values()], pos, box)
    errors = {k: _relative(got[TWIN_GROUPS[k]], want[TWIN_GROUPS[k]])
              for k in ("CustomBondForce", "CustomAngleForce",
                        "CustomTorsionForce")}
    errors["CustomCompoundBondForce"] = _relative(
        got[TWIN_GROUPS["CustomCompoundBondForce"]],
        got[TWIN_GROUPS["CustomTorsionForce"]])
    deadline.check("custom bilayer: reading")
    integ = omm.LangevinMiddleIntegrator(BILAYER_TEMPERATURE, FRICTION,
                                         DT_PS)
    integ.setIntegrationForceGroups(TWIN_INTEGRATION_GROUPS)
    integ.setRandomNumberSeed(41)
    r = _integrator_run(device, "custom bilayer", twin, integ, state, steps,
                        steps, lambda c: c.temperature(), deadline, replay)
    temperature = r["readings"][-1]
    print("custom bilayer: %d atoms; twins against the standard forces "
          "(float64; energy, largest force error over the largest force): "
          "%s; %d steps through the step program: T %.2f K, %.2f ns/day, "
          "%.4f ms a step (eager %.4f; the bilayer phase %.4f), launches "
          "%s; the eager loop's bits over %d steps" % (
              twin.getNumParticles(), "; ".join(
                  "%s %.3e %.3e" % (k, *e) for k, e in errors.items()),
              steps, temperature, r["ns_day"], r["ms_per_step"],
              r["eager_ms_per_step"],
              bilayer["graph"]["wall_ms_per_step"],
              json.dumps(r["launches"]), replay))
    for k, e in errors.items():
        if not max(e) <= TWIN_BAR:
            raise RuntimeError("custom bilayer: %s differs by %.3e (energy) "
                               "and %.3e (forces)" % (k, *e))
    if not t_range[0] <= temperature <= t_range[1]:
        raise RuntimeError("custom bilayer: temperature %.2f K"
                           % temperature)
    del r["context"]
    return dict(r, errors=errors, temperature=temperature)


def phase_tables(device, positions, box, deadline=None) -> dict:
    """A CustomCompoundBondForce over synthetic dihedral pairs of the first
    atoms at `positions` (periodic Continuous2DFunction of
    dihedral(p1,p2,p3,p4) and dihedral(p2,p3,p4,p1)) plus Discrete1D, 2D
    and 3D tables read at per-bond indices, in float64 on `device` against
    the same port code on the CPU: energy and forces within TABLE_BAR.
    Raises on a miss."""
    deadline = deadline or Deadline(math.inf)
    rng = np.random.RandomState(17)
    grid = rng.randn(24, 24)
    grid[-1, :] = grid[0, :]
    grid[:, -1] = grid[:, 0]
    force = omm.CustomCompoundBondForce(
        4, "cmap(dihedral(p1,p2,p3,p4), dihedral(p2,p3,p4,p1))"
        " + d1(i) + d2(i, j) + d3(i, j, k)")
    force.addTabulatedFunction("cmap", omm.Continuous2DFunction(
        24, 24, list(grid.ravel(order="F")), -math.pi, math.pi, -math.pi,
        math.pi, True))
    force.addTabulatedFunction("d1", omm.Discrete1DFunction(
        list(rng.randn(6))))
    force.addTabulatedFunction("d2", omm.Discrete2DFunction(
        6, 5, list(rng.randn(30))))
    force.addTabulatedFunction("d3", omm.Discrete3DFunction(
        6, 5, 4, list(rng.randn(120))))
    for name in "ijk":
        force.addPerBondParameter(name)
    n = min(positions.shape[0], TABLE_ATOMS)
    for a in range(0, n - 3, 2):
        force.addBond([a, a + 1, a + 2, a + 3],
                      [a % 6, (a // 6) % 5, (a // 30) % 4])
    pos = positions[:n]
    got = _twin_reading(device, [force], pos, box)[0]
    want = _twin_reading(torch.device("cpu"), [force], pos, box)[0]
    err = _relative(got, want)
    print("tables: %d bonds of a periodic Continuous2DFunction of two "
          "dihedrals and Discrete1D/2D/3D tables on %s against the CPU: "
          "energy %.3e, forces %.3e (bar %.0e)" % (
              force.getNumBonds(), device.type, *err, TABLE_BAR))
    if not max(err) <= TABLE_BAR:
        raise RuntimeError("tables: the card's energy and forces differ by "
                           "%.3e and %.3e from the CPU's" % err)
    deadline.check("tables")
    return {"errors": err, "bonds": force.getNumBonds()}


def while_draws_program(dt=VERLET_DT, passes=WHILE_DRAW_PASSES):
    """Velocity Verlet whose while block of `passes` passes kicks the
    velocities by 1e-6 * gaussian and draws a global uniform each pass."""
    integ = omm.CustomIntegrator(dt)
    for name in ("i", "usum"):
        integ.addGlobalVariable(name, 0.0)
    integ.addPerDofVariable("x1", 0.0)
    integ.addUpdateContextState()
    integ.addComputePerDof("v", "v+0.5*dt*f/m")
    integ.addComputePerDof("x", "x+dt*v")
    integ.addComputePerDof("x1", "x")
    integ.addConstrainPositions()
    integ.addComputePerDof("v", "v+0.5*dt*f/m+(x-x1)/dt")
    integ.addComputeGlobal("i", "0")
    integ.beginWhileBlock("i < %d" % passes)
    integ.addComputePerDof("v", "v+1e-6*gaussian")
    integ.addComputeGlobal("usum", "usum+uniform")
    integ.addComputeGlobal("i", "i+1")
    integ.endBlock()
    integ.addConstrainVelocities()
    return integ


def phase_while_draws(device, main, deadline=None, steps=WHILE_DRAW_STEPS,
                      replay=WHILE_DRAW_STEPS) -> dict:
    """The relaxed water box under while_draws_program() through
    _integrator_run (the while block a WHILE node of the graph, its draws
    counter-hashed from a seed a step): the step program against the
    eager loop in bits; the uniforms' mean within 5 standard errors of
    1/2. Raises on a miss."""
    deadline = deadline or Deadline(math.inf)
    system, state, _ = _water_state(main)
    integ = while_draws_program()
    r = _integrator_run(device, "while draws", system, integ, state, steps,
                        steps, lambda c: c.temperature(), deadline, replay,
                        after=lambda c: integ.getGlobalVariableByName(
                            "usum"))
    draws = steps * WHILE_DRAW_PASSES
    mean = r["after"] / draws
    print("while draws: %d steps of %d passes drawing inside a while block: "
          "the uniforms' mean %.4f; T %.2f K; %.4f ms a step (eager %.4f); "
          "the eager loop's bits over %d steps" % (
              steps, WHILE_DRAW_PASSES, mean, r["readings"][-1],
              r["ms_per_step"], r["eager_ms_per_step"], replay))
    if not abs(mean - 0.5) <= 5.0 * math.sqrt(1.0 / 12.0 / draws):
        raise RuntimeError("while draws: the uniforms' mean %.4f" % mean)
    del r["context"]
    return dict(r, mean=mean)


def _platform_context(device, system, integ, precision=None):
    """A Context on the default platform on a GPU ("CPU" otherwise), in
    `precision` ("double") or the default one."""
    props = {"Precision": precision} if precision else None
    if device.type == "cuda":
        return omm.Context(system, integ, "CUDA", props)
    return omm.Context(system, integ, "CPU", props)


def phase_customgb(device, deadline=None, lipids=GBSA_LIPIDS,
                   model=GB_MODEL,
                   steps=GB_STEPS, replay=GB_REPLAY,
                   iterations=GB_MINIMIZE_ITERATIONS,
                   t_range=GB_T_RANGE) -> dict:
    """The Amber GB recipes (app/gbforces.py) on popc_obc_cluster's
    lipids. (1) The OBC2 recipe's CustomGBForce against the port's
    GBSAOBCForce on the cluster, float64: the GB group's energy and forces
    within RECIPE_BAR. (2) models.popc_gb_cluster(model): its float32
    forces against float64 (median relative error within FORCE_ERR_BAR)
    and each group's energy within GROUP_ENERGY_BAR; GB's three sweeps
    timed alone (its share of the step); one minimize call of `iterations`
    iterations (the energy falls); `steps` LangevinMiddle steps at 300 K,
    2 fs, 1/ps, with HBonds, through the step program (ms a step, the
    temperature within `t_range`, the constraint error); `replay` steps
    from a snapshot through the step program and the eager loop: the same
    bits and energies. Raises on a miss."""
    deadline = deadline or Deadline(math.inf)
    groups = {"NonbondedForce": 0, "CustomGBForce": 1, "GBSAOBCForce": 1,
              "HarmonicBondForce": 2, "HarmonicAngleForce": 2,
              "PeriodicTorsionForce": 2, "CMMotionRemover": 2}
    obc, positions = popc_obc_cluster(lipids)
    recipe, _ = builders.popc_gb_cluster("OBC2", lipids)
    readings = []
    for system in (obc, recipe):
        for force in system.getForces():
            force.setForceGroup(groups[type(force).__name__])
        c = _platform_context(device, system, omm.VerletIntegrator(0.001),
                              "double")
        c.setPositions(positions)
        st = c.getState(getEnergy=True, getForces=True, groups={1})
        readings.append((in_md(st.getPotentialEnergy()),
                         in_md(st.getForces(asNumpy=True))))
        del c
    (e_obc, f_obc), (e_rec, f_rec) = readings
    recipe_err = (abs(e_rec - e_obc) / abs(e_obc),
                  float(np.abs(f_rec - f_obc).max() / np.abs(f_obc).max()))
    deadline.check("customgb: OBC2 recipe")

    system, positions = builders.popc_gb_cluster(model, lipids)
    for force in system.getForces():
        force.setForceGroup(groups[type(force).__name__])
    n = system.getNumParticles()
    integ = omm.LangevinMiddleIntegrator(300.0, FRICTION, DT_PS)
    integ.setRandomNumberSeed(37)
    ctx = _platform_context(device, system, integ)
    oracle = _platform_context(device, system, omm.VerletIntegrator(0.001),
                               "double")
    for c in (ctx, oracle):
        c.setPositions(positions)
    force_err = _median_relative_error(
        in_md(ctx.getState(getForces=True).getForces(asNumpy=True)),
        in_md(oracle.getState(getForces=True).getForces(asNumpy=True)))
    energies = {g: (in_md(ctx.getState(getEnergy=True, groups={g})
                    .getPotentialEnergy()),
                    in_md(oracle.getState(getEnergy=True, groups={g})
                    .getPotentialEnergy())) for g in (0, 1, 2)}
    del oracle
    (gb,) = ctx._custom
    sweeps_ms = None
    if device.type == "cuda":
        pos, box = ctx._state["positions"], ctx._box
        sweeps_ms = _time_ms(lambda: gb.ef(pos, box), device, reps=5,
                             warmup=1)
    deadline.check("customgb: float64 oracle")
    ctx.applyConstraints()
    before = in_md(ctx.getState(getEnergy=True).getPotentialEnergy())
    omm.LocalEnergyMinimizer.minimize(ctx, MINIMIZE_TOLERANCE, iterations)
    after = in_md(ctx.getState(getEnergy=True).getPotentialEnergy())
    deadline.check("customgb: minimize")
    ctx.setVelocitiesToTemperature(300.0, randomSeed=6)
    run = _production(device, ctx, integ.step,
                      in_md(ctx.getState(getEnergy=True).getPotentialEnergy()),
                      steps, steps, deadline)
    temperature = ctx.temperature()
    constraint_err = _constraint_error(
        system, in_md(ctx.getState(getPositions=True).getPositions(
            asNumpy=True)))
    start = ctx._snapshot()
    graph = _production(device, ctx, integ.step, 0.0, replay, replay,
                        deadline)
    ctx._restore(start)
    eager = _production(device, ctx, ctx._step_eager, 0.0, replay, replay,
                        deadline)
    _same_bits("customgb", (graph["positions"], graph["velocities"]),
               (eager["positions"], eager["velocities"]))
    if graph["energies"] != eager["energies"]:
        raise RuntimeError("customgb: the step program's energies %s, the "
                           "eager loop's %s" % (graph["energies"],
                                                eager["energies"]))
    ms = run["wall_ms_per_step"]
    print("customgb: the OBC2 recipe against GBSAOBCForce (float64, %d "
          "atoms): energy %.6f vs %.6f kJ/mol, relative %.3e, forces %.3e of "
          "the largest (bar %.0e); %s on the cluster: %d atoms, median "
          "force error %.3e (bar %.0e), group energies (float32, float64) "
          "%s; minimize %.3f -> %.3f kJ/mol; %d steps through the step "
          "program %.4f ms a step (%.2f ns/day), GB's three sweeps %s ms a "
          "call (%s of the step); T %.2f K; constraint error %.3e; %d "
          "steps replayed through the eager loop (%.4f ms a step): the same "
          "bits" % (
              len(positions), e_rec, e_obc, *recipe_err, RECIPE_BAR, model,
              n, force_err, FORCE_ERR_BAR, "; ".join(
                  "%d: %.4f %.4f" % (g, *e) for g, e in energies.items()),
              before, after, steps, ms, run["ns_day"],
              "not measured" if sweeps_ms is None else "%.4f" % sweeps_ms,
              "not measured" if sweeps_ms is None
              else "%.1f%%" % (100.0 * sweeps_ms / ms), temperature,
              constraint_err, replay, eager["wall_ms_per_step"]))
    if not max(recipe_err) <= RECIPE_BAR:
        raise RuntimeError("customgb: the OBC2 recipe differs from "
                           "GBSAOBCForce by %.3e, %.3e" % recipe_err)
    if not force_err <= FORCE_ERR_BAR:
        raise RuntimeError("customgb: median force error %.3e" % force_err)
    for g, (e32, e64) in energies.items():
        if not _close_energy(e32, e64, GROUP_ENERGY_BAR):
            raise RuntimeError("customgb: group %d energy %.6f vs %.6f"
                               % (g, e32, e64))
    if not (math.isfinite(after) and after < before):
        raise RuntimeError("customgb: minimization %.3f -> %.3f"
                           % (before, after))
    if not all(math.isfinite(e) for e in run["energies"]):
        raise RuntimeError("customgb: a potential energy is not finite")
    if not t_range[0] <= temperature <= t_range[1]:
        raise RuntimeError("customgb: temperature %.2f K" % temperature)
    if not constraint_err <= CONSTRAINT_ERR_BAR:
        raise RuntimeError("customgb: constraint error %.3e"
                           % constraint_err)
    deadline.check("customgb")
    return {"atoms": n, "recipe_err": recipe_err, "force_err": force_err,
            "energies": energies, "minimized": (before, after),
            "ms_per_step": ms, "ns_day": run["ns_day"],
            "sweeps_ms": sweeps_ms, "temperature": temperature,
            "eager_ms_per_step": eager["wall_ms_per_step"]}


def _kabsch_rmsd(x, y) -> float:
    """The RMSD of x from y after the optimal rotation (numpy SVD)."""
    x = x - x.mean(axis=0)
    y = y - y.mean(axis=0)
    v, sv, wt = np.linalg.svd(x.T @ y)
    sv[-1] *= np.sign(np.linalg.det(v @ wt))
    return float(np.sqrt(max((np.sum(x * x) + np.sum(y * y)
                              - 2.0 * sv.sum()) / len(x), 0.0)))


def phase_rmsd_cv(device, bilayer, deadline=None, k=RMSD_K,
                  steer=RMSD_STEER, chunk=RMSD_CHUNK, chunks=RMSD_CHUNKS,
                  replay=RMSD_REPLAY, turn_steps=RMSD_TURN_STEPS,
                  t_range=BILAYER_T_RANGE) -> dict:
    """The bilayer of phase_bilayer with an RMSD restraint:
    CustomCVForce("0.5*k*(rmsd-r0)^2") over an RMSDForce of the lipids'
    heavy atoms (mass above 2 amu) whose reference is the minimized
    bilayer, r0 at half the RMSD of the bilayer's last positions, in a group of
    its own, on a Context of its own from phase_bilayer's last state (the
    force is taken out of the shared System once that Context is built).
    Checks: getCollectiveVariableValues against a host numpy Kabsch RMSD
    (RMSD_KABSCH_BAR); the CV's forces on three coordinates against a
    float64 central difference of the CV's energy (RMSD_FD_BAR of the
    largest force); `chunks` chunks of `chunk` steps with r0 raised by
    `steer` (setParameter) between them, through one step program (no
    capture after the first), each main-path kernel launched at least
    once a step by those steps alone (the counts zeroed before each chunk
    and read after it); `replay` steps from a snapshot through the
    step program and the eager loop: the same bits; the temperature and
    the constraint error; ms a step against the plain bilayer's Context in
    turns (plain, cv, cv, plain). Raises on a miss."""
    deadline = deadline or Deadline(math.inf)
    system = bilayer["system"]
    base_ctx = bilayer["context"]
    st = base_ctx.getState(getPositions=True, getVelocities=True)
    masses = np.asarray([in_md(system.getParticleMass(i))
                         for i in range(system.getNumParticles())])
    # the lipids: the molecules larger than a water
    heavy = sorted(i for mol in base_ctx.getMolecules() if len(mol) > 3
                   for i in mol if masses[i] > 2.0)
    reference = np.asarray(bilayer["minimized_positions"], np.float64)
    pos = in_md(st.getPositions(asNumpy=True))
    # r0 below the RMSD of the last positions, so that the restraint pulls
    r0 = 0.5 * _kabsch_rmsd(pos[heavy], reference[heavy])
    rmsd = omm.RMSDForce(reference, heavy)
    cv = omm.CustomCVForce("0.5*k*(rmsd-r0)^2")
    cv.addGlobalParameter("k", k)
    cv.addGlobalParameter("r0", r0)
    cv.addCollectiveVariable("rmsd", rmsd)
    cv.setForceGroup(6)
    system.addForce(cv)
    integ = omm.LangevinMiddleIntegrator(BILAYER_TEMPERATURE, FRICTION,
                                         DT_PS)
    integ.setRandomNumberSeed(41)
    try:
        ctx = _platform_context(device, system, integ)
    finally:
        # the other bilayer phases build their Contexts from this System
        system._forces.remove(cv)
    ctx.setPositions(pos)
    ctx.setVelocities(in_md(st.getVelocities(asNumpy=True)))
    values = cv.getCollectiveVariableValues(ctx)
    kabsch = _kabsch_rmsd(pos[heavy], reference[heavy])
    # the CV's forces against a float64 central difference of its energy
    (module,) = ctx._custom
    x = ctx._state["positions"].clone()
    box = ctx._box
    forces = module.ef(x, box)[1]
    fd_err = 0.0
    scale = float(forces.abs().max())
    for atom, axis in ((heavy[0], 0), (heavy[len(heavy) // 2], 1),
                       (heavy[-1], 2)):
        e = []
        for h in (RMSD_H, -RMSD_H):
            y = x.clone()
            y[atom, axis] += h
            e.append(float(module.ef(y, box)[0]))
        fd = -(e[0] - e[1]) / (2.0 * RMSD_H)
        fd_err = max(fd_err, abs(float(forces[atom, axis]) - fd) / scale)
    deadline.check("rmsd cv: checks")
    captures, readings = [], []
    launches = dict.fromkeys(MAIN_PATH_NAMES, 0)
    for c in range(chunks):
        ctx.setParameter("r0", r0 + c * steer)
        for kern in _build.KERNELS:
            kern.launches = 0
        integ.step(chunk)
        for kern in MAIN_PATH_KERNELS:
            launches[kern.name] += kern.launches
        captures.append(_captures(ctx))
        readings.append(cv.getCollectiveVariableValues(ctx)[0])
    deadline.check("rmsd cv: steps")
    start = ctx._snapshot()
    graph = _production(device, ctx, integ.step, 0.0, replay, replay,
                        deadline)
    ctx._restore(start)
    eager = _production(device, ctx, ctx._step_eager, 0.0, replay, replay,
                        deadline)
    _same_bits("rmsd cv", (graph["positions"], graph["velocities"]),
               (eager["positions"], eager["velocities"]))
    _same_state("rmsd cv", graph, eager)
    temperature = ctx.temperature()
    constraint_err = _constraint_error(
        system, in_md(ctx.getState(getPositions=True).getPositions(
            asNumpy=True)))
    turns = _in_turns(device, {"plain": (base_ctx, bilayer["step"]),
                               "cv": (ctx, integ.step)}, turn_steps,
                      ("plain", "cv", "cv", "plain"), deadline)
    ms = {key: statistics.mean(v[0]) for key, v in turns.items()}
    print("rmsd cv: CustomCVForce 0.5*k*(rmsd-r0)^2 (k %.0f) over an "
          "RMSDForce of %d lipid heavy atoms on the %d-atom bilayer: RMSD "
          "%.9f nm on the card, %.9f by numpy Kabsch; forces against a "
          "float64 central difference %.3e of the largest (bar %.0e); r0 "
          "steered %s nm, the RMSD read %s; captures %s; %d steps replayed "
          "through the eager loop: the same bits; T %.2f K; constraint "
          "error %.3e; in turns %.4f ms a step (plain bilayer %.4f); "
          "launches in the %d steered steps %s" % (
              k, len(heavy), system.getNumParticles(), values[0], kabsch,
              fd_err, RMSD_FD_BAR, " ".join(
                  "%.4f" % (r0 + c * steer) for c in range(chunks)),
              " ".join("%.4f" % r for r in readings), captures, replay,
              temperature, constraint_err, ms["cv"], ms["plain"],
              chunk * chunks, json.dumps(launches)))
    if not abs(values[0] - kabsch) <= RMSD_KABSCH_BAR * kabsch:
        raise RuntimeError("rmsd cv: RMSD %.9f, numpy Kabsch %.9f"
                           % (values[0], kabsch))
    if not fd_err <= RMSD_FD_BAR:
        raise RuntimeError("rmsd cv: forces off a central difference by "
                           "%.3e" % fd_err)
    if device.type == "cuda":
        if len(set(captures)) != 1:
            raise RuntimeError("rmsd cv: programs captured %s" % captures)
        if min(launches.values()) < chunk * chunks:
            raise RuntimeError("rmsd cv: in %d steps a kernel launched "
                               "fewer times than once a step: %s"
                               % (chunk * chunks, launches))
    if not t_range[0] <= temperature <= t_range[1]:
        raise RuntimeError("rmsd cv: temperature %.2f K" % temperature)
    if not constraint_err <= CONSTRAINT_ERR_BAR:
        raise RuntimeError("rmsd cv: constraint error %.3e" % constraint_err)
    deadline.check("rmsd cv")
    return {"atoms": len(heavy), "rmsd": values[0], "kabsch": kabsch,
            "fd_err": fd_err, "ms": ms, "temperature": temperature,
            "readings": readings, "launches": launches}


def _argon_cluster(n, seed=12):
    """(from_numpy dict, positions) of n argon atoms on a simple cubic
    lattice at 0.37 nm, each moved by up to 0.01 nm along each axis (drawn
    with `seed`), Lennard-Jones (NoCutoff) and, added by the caller,
    Axilrod-Teller."""
    side = int(math.ceil(n ** (1.0 / 3.0)))
    grid = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"),
                    axis=-1).reshape(-1, 3)[:n]
    rng = np.random.RandomState(seed)
    pos = 0.37 * grid + rng.uniform(-0.01, 0.01, (n, 3))
    params = _bare_params(n, 39.948)
    params["sigma"][:] = 0.34
    params["epsilon"][:] = 0.996
    return params, pos


def _bare_params(n, mass):
    """from_numpy keys of n particles of `mass` with a NoCutoff
    NonbondedForce of no charges and no Lennard-Jones."""
    return {"masses": np.full(n, float(mass)), "charges": np.zeros(n),
            "sigma": np.full(n, 0.3), "epsilon": np.zeros(n),
            "exception_pairs": np.zeros((0, 2), np.int64),
            "exception_params": np.zeros((0, 3)),
            "constraint_pairs": np.zeros((0, 2), np.int64),
            "constraint_distances": np.zeros(0),
            "box": np.diag([10.0] * 3), "cutoff": 1.0,
            "method": "NoCutoff", "ewald_tolerance": 5e-4,
            "dispersion_correction": False, "switch_distance": -1.0}


def more_custom_systems(hbond_waters=HBOND_WATERS, argon=ARGON_ATOMS,
                        ellipsoids=GAYBERNE_ELLIPSOIDS, water_positions=None,
                        argon_seed=12):
    """{label: (from_numpy dict, positions, temperature K, NVE steps)} of
    phase_more_custom's three systems, the custom force in group 1 of
    each: hydrogen bonds between
    `hydrogen_waters` rigid TIP3P waters (the first waters of
    `water_positions`, or of a fresh box; each hydrogen a donor, each
    oxygen an acceptor, one water's own pairs excluded; a Gaussian well of
    5 kJ/mol at 0.19 nm from donor to acceptor times the cosine squared of
    the donor angle; NoCutoff);
    Axilrod-Teller (C 1e-4 kJ/mol nm^9) on `argon` argon atoms (with their
    Lennard-Jones; NoCutoff; _argon_cluster with `argon_seed`), at 100 K; a Gay-Berne fluid of `ellipsoids` ellipsoids, each with an
    x and a y frame particle held by stiff harmonic bonds and an angle
    (NoCutoff)."""
    out = {}
    system, pos = tip3p_water_box(hbond_waters)
    params = omm.to_numpy(system)
    if water_positions is not None:
        pos = np.asarray(water_positions)
    n = 3 * hbond_waters
    hb = _bare_params(n, 1.0)
    hb["masses"] = params["masses"][:n]
    inside = (params["constraint_pairs"] < n).all(axis=1)
    hb["constraint_pairs"] = params["constraint_pairs"][inside]
    hb["constraint_distances"] = params["constraint_distances"][inside]
    pos = pos[:n]
    hb["custom_forces"] = [{
        "kind": "CustomHbondForce", "group": 1,
        "energy": "-e_hb*exp(-((distance(a1,d1)-r0)/w_hb)^2)"
                  "*cos(angle(a1,d1,d2))^2",
        "globals": [("e_hb", 5.0), ("w_hb", 0.05)], "derivatives": [],
        "functions": [],
        "periodic": False, "donor_parameters": [],
        "acceptor_parameters": ["r0"],
        "donors": [((3 * w + h, 3 * w, -1), []) for w in range(hbond_waters)
                   for h in (1, 2)],
        "acceptors": [((3 * w, 3 * w + 1, 3 * w + 2), [0.19])
                      for w in range(hbond_waters)],
        "exclusions": [(2 * w + h, w) for w in range(hbond_waters)
                       for h in (0, 1)],
        "method": 0, "cutoff": 1.0}]
    out["hbond"] = (hb, pos, 300.0, MORE_STEPS)
    ar, ar_pos = _argon_cluster(argon, argon_seed)
    ar["custom_forces"] = [{
        "kind": "CustomManyParticleForce", "group": 1,
        "energy": "C*(1+3*cos(t1)*cos(t2)*cos(t3))/(r12*r13*r23)^3;"
                  "t1=angle(p2,p1,p3); t2=angle(p1,p2,p3);"
                  "t3=angle(p1,p3,p2); r12=distance(p1,p2);"
                  "r13=distance(p1,p3); r23=distance(p2,p3)",
        "globals": [("C", 1e-4)], "derivatives": [], "functions": [],
        "periodic": False, "particles_per_set": 3, "parameters": [],
        "particles": [([], 0)] * argon, "type_filters": [],
        "permutation_mode": 0, "exclusions": [], "method": 0,
        "cutoff": 1.0}]
    out["axilrod-teller"] = (ar, ar_pos, 100.0, ARGON_STEPS)
    side = int(math.ceil(ellipsoids ** (1.0 / 3.0)))
    rng = np.random.RandomState(14)
    gpos, particles, bonds, angles = [], [], [], []
    for k in range(ellipsoids):
        centre = 0.9 * np.asarray([k % side, (k // side) % side,
                                   k // side // side], np.float64)
        centre = centre + rng.uniform(-0.05, 0.05, 3)
        i = len(gpos)
        gpos += [centre, centre + [0.1, 0.0, 0.0], centre + [0.0, 0.1, 0.0]]
        particles += [[0.35, 1.0, i + 1, i + 2, 0.7, 0.35, 0.35,
                       1.0, 1.0, 0.5],
                      [0.1, 0.0, -1, -1, 0.1, 0.1, 0.1, 1, 1, 1],
                      [0.1, 0.0, -1, -1, 0.1, 0.1, 0.1, 1, 1, 1]]
        bonds += [(i, i + 1), (i, i + 2)]
        angles.append((i + 1, i, i + 2))
    gbp = _bare_params(len(gpos), 20.0)
    gbp.update({"bond_pairs": np.asarray(bonds),
                "bond_params": np.tile([0.1, 50000.0], (len(bonds), 1)),
                "angle_triples": np.asarray(angles),
                "angle_params": np.tile([math.pi / 2, 500.0],
                                        (len(angles), 1))})
    gbp["custom_forces"] = [{
        "kind": "GayBerneForce", "group": 1, "particles": particles,
        "exceptions": [], "method": 0, "cutoff": 1.0,
        "switch_distance": -1.0}]
    out["gay-berne"] = (gbp, np.asarray(gpos), 300.0, MORE_STEPS)
    return out


def more_custom_references(labels=("axilrod-teller", "gay-berne")) -> dict:
    """{label: (energy, forces)} of phase_more_custom's CPU float64
    evaluations of the systems in `labels` (those whose positions do not
    come from the water box's run)."""
    out = {}
    for label, (params, pos, _, _) in more_custom_systems().items():
        if label not in labels:
            continue
        cpu = omm.Context(omm.from_numpy(params), omm.VerletIntegrator(
            MORE_DT), "CPU", {"Precision": "double"})
        cpu.setPositions(pos)
        (module,) = cpu._custom
        e, f = module.ef(cpu._state["positions"], cpu._box)
        out[label] = (float(e), f.clone())
    return out


def phase_more_custom(device, main=None, deadline=None, systems=None,
                      steps=None, every=MORE_EVERY, replay=MORE_REPLAY,
                      dt=MORE_DT, gate=DRIFT_GATE,
                      seed=VELOCITY_SEED, references=None) -> dict:
    """CustomHbondForce, CustomManyParticleForce and GayBerneForce on
    more_custom_systems (the hydrogen-bond waters at the relaxed water
    box's positions): each system's custom force's ef (float64) on the
    card against its float64 evaluation on the CPU (MORE_BAR, energy
    relative and forces of the largest) and timed alone; then the
    system's NVE steps (or `steps`) of `dt` of Verlet through the step
    program from velocities at the system's temperature drawn with `seed`
    (the total energy read every `every` steps: its drift within `gate`
    kT/dof/ns); `replay` steps from a snapshot through the step program
    and the eager loop: the same bits. `references`: CPU evaluations
    made beforehand (more_custom_references, in write_app_build's
    process). Raises on a miss."""
    deadline = deadline or Deadline(math.inf)
    if systems is None:
        water = (None if main is None else in_md(main["context"].getState(
            getPositions=True).getPositions(asNumpy=True)))
        systems = more_custom_systems(water_positions=water)
    out = {}
    for label, (params, pos, temperature, nve) in systems.items():
        nve = steps or nve
        system = omm.from_numpy(params)
        integ = omm.VerletIntegrator(dt)
        ctx = _platform_context(device, system, integ)
        ctx.setPositions(pos)
        (module,) = ctx._custom
        x = ctx._state["positions"]
        e_card, f_card = module.ef(x, ctx._box)
        if references and label in references:
            e_cpu, f_cpu = references[label]
        else:
            cpu = omm.Context(omm.from_numpy(params),
                              omm.VerletIntegrator(dt), "CPU",
                              {"Precision": "double"})
            cpu.setPositions(pos)
            (cpu_module,) = cpu._custom
            e_cpu, f_cpu = cpu_module.ef(cpu._state["positions"], cpu._box)
            del cpu
        f_card = f_card.cpu()
        err = (abs(float(e_card) - float(e_cpu)) / abs(float(e_cpu)),
               float((f_card - f_cpu).abs().max() / f_cpu.abs().max()))
        ef_ms = (_time_ms(lambda: module.ef(x, ctx._box), device, reps=5,
                          warmup=1) if device.type == "cuda" else None)
        deadline.check("more custom: %s ef" % label)
        ctx.applyConstraints()
        ctx.setVelocitiesToTemperature(temperature, randomSeed=seed)
        run = _production(device, ctx, integ.step, _total_energy(ctx),
                          nve, every, deadline, read=_total_energy)
        dof = 3 * system.getNumParticles() - system.getNumConstraints()
        drift = _drift(run["energies"], every, dt, dof, temperature)
        start = ctx._snapshot()
        graph = _production(device, ctx, integ.step, 0.0, replay, replay,
                            deadline)
        ctx._restore(start)
        eager = _production(device, ctx, ctx._step_eager, 0.0, replay,
                            replay, deadline)
        _same_bits("more custom: " + label,
                   (graph["positions"], graph["velocities"]),
                   (eager["positions"], eager["velocities"]))
        out[label] = {"particles": system.getNumParticles(),
                      "terms": module.m if hasattr(module, "m")
                      else module.pairs.shape[0], "err": err,
                      "ef_ms": ef_ms, "drift": drift,
                      "energies": run["energies"], "dof": dof,
                      "ms_per_step": run["wall_ms_per_step"],
                      "energy": float(e_cpu)}
        print("more custom: %s, %d particles, %d terms: ef on the card "
              "against the CPU's float64 %.3e (energy) %.3e (forces; bar "
              "%.0e), %s ms a call; NVE Verlet %d steps of %.4f ps %.4f ms "
              "a step, drift %.4e kT/dof/ns (gate %.1f); %d steps replayed "
              "through the eager loop: the same bits" % (
                  label, out[label]["particles"], out[label]["terms"],
                  *err, MORE_BAR, "not measured" if ef_ms is None
                  else "%.4f" % ef_ms, nve, dt,
                  run["wall_ms_per_step"], drift, gate, replay))
        if not max(err) <= MORE_BAR:
            raise RuntimeError("more custom: %s ef off the CPU's by %.3e, "
                               "%.3e" % (label, *err))
        if not all(math.isfinite(e) for e in run["energies"]):
            raise RuntimeError("more custom: %s energy not finite" % label)
        if not abs(drift) < gate:
            raise RuntimeError("more custom: %s drift %.4e kT/dof/ns"
                               % (label, drift))
        del ctx
        deadline.check("more custom: %s" % label)
    return out


# the AMOEBA phases (phase_amoeba_pme, phase_amoeba_gk, phase_hippo)
AMOEBA_FILES = ("amoeba2013.json",)
AMOEBA_GK_FILES = ("amoeba2013.json", "amoeba2013_gk.json")
AMOEBA_BUILD_FORCEFIELD = ("amber14-all.json", "amber14-tip3p.json")
AMOEBA_BOX = 6.5                # nm: ~24,000 atoms, DHFR's size
AMOEBA_CUTOFF = 0.7             # nm, the multipoles' real space
AMOEBA_VDW_CUTOFF = 0.9         # nm
AMOEBA_EPSILON = 1e-5
AMOEBA_TEMPERATURE = 300.0
AMOEBA_MTS = ((0, 2), (1, 1))
# the forces of the slow group, as OpenMM's benchmark.py sets them for
# amoebapme and amoebagk
AMOEBA_SLOW = ("AmoebaMultipoleForce", "AmoebaVdwForce",
               "AmoebaGeneralizedKirkwoodForce", "AmoebaWcaDispersionForce")
# the lattice start's relaxation: (step ps, friction 1/ps, steps) of
# LangevinMiddle with Extrapolated polarization, as the water box's RELAX
AMOEBA_RELAX = (0.001, 100.0, 40)
AMOEBA_MINIMIZE_ITERATIONS = 1
AMOEBA_STEPS = 2
AMOEBA_REPLAY = 1
AMOEBA_T_RANGE = (250.0, 360.0)
AMOEBA_ENERGY_BAR = 1e-5        # relative, each group's energy
SECOND_ORDER_TOL = 1e-5         # kernel 5's VJP against autograd's
GK_ALANINES = 247               # ~2,490 atoms, amoebagk's DHFR size
GK_STEPS = 1
HIPPO_WATERS = 512
HIPPO_DT = 0.0005
HIPPO_STEPS = 3


def _release(device) -> None:
    """Collect the Contexts of the phases that returned and free their
    captured graphs' memory (the AMOEBA steps keep autograd's tensors in
    the graph's pool: ~12 GB at 24,000 atoms, more for GK's dense
    tensors) before the next phase."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _amoeba_groups(system) -> None:
    for f in system.getForces():
        if type(f).__name__ in AMOEBA_SLOW:
            f.setForceGroup(1)


def _helix_modeller(n_ala, platform, box=None):
    """ACE-(ALA)n-NME from helix_pdb_text through PDBFile and Modeller:
    addHydrogens with AMOEBA_BUILD_FORCEFIELD, and with `box` addSolvent
    in a cube of that edge: (modeller, seconds)."""
    from openmm_tpu_torch import app
    from openmm_tpu_torch import unit as u
    t0 = time.perf_counter()
    ff = app.ForceField(*AMOEBA_BUILD_FORCEFIELD)
    pdb = app.PDBFile(io.StringIO(helix_pdb_text(n_ala)))
    modeller = app.Modeller(pdb.topology, pdb.positions)
    modeller.addHydrogens(ff, platform=platform)
    if box is not None:
        modeller.addSolvent(ff, boxSize=omm.Vec3(box, box, box)
                            * u.nanometer)
    return modeller, time.perf_counter() - t0


def _amoeba_pme_system(n_ala, box, platform):
    """(modeller, System with the AMOEBA forces in group 1, Modeller s,
    createSystem s) of phase_amoeba_pme's peptide in water."""
    from openmm_tpu_torch import app
    from openmm_tpu_torch import unit as u
    modeller, build_s = _helix_modeller(n_ala, platform, box)
    ff = app.ForceField(*AMOEBA_FILES)
    t0 = time.perf_counter()
    system = ff.createSystem(
        modeller.topology, nonbondedMethod=app.PME,
        nonbondedCutoff=AMOEBA_CUTOFF * u.nanometer,
        vdwCutoff=AMOEBA_VDW_CUTOFF, polarization="mutual",
        mutualInducedTargetEpsilon=AMOEBA_EPSILON, constraints=None)
    create_s = time.perf_counter() - t0
    _amoeba_groups(system)
    return modeller, system, build_s, create_s


def _amoeba_gk_system(n_ala, platform):
    """(modeller, System, Modeller s, createSystem s) of phase_amoeba_gk's
    peptide with generalized Kirkwood."""
    from openmm_tpu_torch import app
    modeller, build_s = _helix_modeller(n_ala, platform)
    ff = app.ForceField(*AMOEBA_GK_FILES)
    t0 = time.perf_counter()
    system = ff.createSystem(modeller.topology, nonbondedMethod=app.NoCutoff,
                             polarization="mutual", constraints=None)
    create_s = time.perf_counter() - t0
    _amoeba_groups(system)
    return modeller, system, build_s, create_s


def write_amoeba_gk(path) -> None:
    """phase_amoeba_gk on the card, its result pickled to `path`: a
    forked helper (fork_helper)."""
    t0 = since_start()
    set_fp32_matmul_exact()
    device = torch.device("cuda", 0)
    out = phase_amoeba_gk(device)
    with open(path, "wb") as f:
        pickle.dump(out, f)
    print("helper write_amoeba_gk: %.1f to %.1f s of the script's clock, "
          "peak device memory reserved %.1f GB" % (
              t0, since_start(),
              torch.cuda.max_memory_reserved(device) / 1e9))


def write_hippo(path) -> None:
    """phase_hippo on the card, its result pickled to `path`: a forked
    helper (fork_helper)."""
    t0 = since_start()
    set_fp32_matmul_exact()
    device = torch.device("cuda", 0)
    out = phase_hippo(device)
    with open(path, "wb") as f:
        pickle.dump(out, f)
    print("helper write_hippo: %.1f to %.1f s of the script's clock, peak "
          "device memory reserved %.1f GB" % (
              t0, since_start(),
              torch.cuda.max_memory_reserved(device) / 1e9))


def write_amoeba_pme(path) -> None:
    """phase_amoeba_pme on the card, from the peptide's build to its
    steps' replay, its result pickled to `path`: a forked helper
    (fork_helper). After the relaxation it waits for the file
    `path`.check, which the script writes once GK's helper has ended (the
    float64 check beside GK's capture ran the card out of memory), then
    collects at the interpreter's own thresholds (the start's window kept
    ~64 GB of the card); its float64 check and steps run beside the
    script's phases that need no main path (_main). Before its timed
    replay it waits for `path`.timing, which the script writes when those
    phases are done and it waits for this helper; the script times the
    kernels' records itself, alone on the card, at its end."""
    import os
    t0 = since_start()
    set_fp32_matmul_exact()
    device = torch.device("cuda", 0)

    def ready(stage, timeout=600.0):
        start = time.perf_counter()
        while not os.path.exists(path + "." + stage):
            if time.perf_counter() - start > timeout:
                raise RuntimeError("amoeba pme: no %s from the script "
                                   "after %.0f s" % (stage, timeout))
            time.sleep(0.02)
        if stage == "check":
            gc.set_threshold(*GC_THRESHOLDS)
            _release(device)

    out = phase_amoeba_pme(device, ready=ready)
    with open(path, "wb") as f:
        pickle.dump(out, f)
    print("helper write_amoeba_pme: %.1f to %.1f s of the script's clock, "
          "peak device memory reserved %.1f GB" % (
              t0, since_start(),
              torch.cuda.max_memory_reserved(device) / 1e9))


def since_start() -> float:
    """Seconds since the script started (main() sets CHIP_SMOKE_EPOCH; the
    helper processes inherit it), to place a helper's milestones on the
    script's clock."""
    import os
    epoch = os.environ.get("CHIP_SMOKE_EPOCH")
    return time.time() - float(epoch) if epoch else math.nan


def _await_build(timeout: float = 600.0) -> tuple:
    """_build.build in a forked child: waits for the kernel library that
    the script's own build renames into place, and never runs nvcc."""
    path = _build.library_path()
    t0 = time.perf_counter()
    while not path.is_file():
        if time.perf_counter() - t0 > timeout:
            raise RuntimeError("no kernel library at %s after %.0f s"
                               % (path, timeout))
        time.sleep(0.05)
    return path, 0.0, ""


def _run_forked(out, err, threads, nice, fn, args) -> None:
    """A forked child's body: its standard output and error into the
    files `out` and `err`, the kernel library awaited (_await_build), its
    intra-op threads and niceness set, then fn(*args)."""
    import os
    for name, fd in ((out, 1), (err, 2)):
        f = os.open(name, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
        os.dup2(f, fd)
        os.close(f)
    _build.build = _await_build
    if threads:
        torch.set_num_threads(threads)
    if nice:
        os.nice(nice)
    fn(*args)


class Forked:
    """fn(*args) in a child forked from this process, with the part of
    subprocess.Popen's interface the script uses (communicate, poll,
    returncode, kill, wait). The child inherits the imported modules (a
    fresh interpreter spent ~9 s importing them on the card's host beside
    the build), so it must be forked before this process touches the
    card; it loads the library of the script's build. Its standard output
    and error go to files in `directory`; `threads` intra-op threads
    (0: torch's default) and `nice` added to its niceness (the children
    off the critical path yield the host's cores to it)."""

    def __init__(self, directory, fn, *args, threads=0, nice=0):
        import multiprocessing
        import os
        self.out = os.path.join(directory, "stdout")
        self.err = os.path.join(directory, "stderr")
        sys.stdout.flush()
        sys.stderr.flush()
        self.proc = multiprocessing.get_context("fork").Process(
            target=_run_forked, args=(self.out, self.err, threads, nice, fn,
                                      args))
        self.proc.start()

    @property
    def returncode(self):
        return self.proc.exitcode

    def poll(self):
        return self.proc.exitcode

    def communicate(self, timeout=None):
        self.proc.join(timeout)
        if self.proc.exitcode is None:
            raise subprocess.TimeoutExpired("forked %s" % self.proc.name,
                                            timeout)
        texts = []
        for name in (self.out, self.err):
            with open(name) as f:
                texts.append(f.read())
        return tuple(texts)

    def kill(self):
        self.proc.kill()

    def wait(self):
        self.proc.join()


def fork_helper(fn, nice=0) -> list:
    """[process, pickle path, its directory]: fn(path) in a Forked child
    with one intra-op thread (it shares the card host's cores with the
    script and the examples) and `nice`: write_amoeba_gk,
    write_amoeba_pme, write_hippo and the Drude, RPMD and membrane
    paths, forked before the script touches the card and run beside the
    build, the kernel phases and the examples, which time no device
    work. Killed at exit if not joined."""
    import os
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip_smoke_%s_" % fn.__name__)
    path = os.path.join(tmp, "result.pickle")
    proc = Forked(tmp, fn, path, threads=1, nice=nice)
    atexit.register(_stop_helper, proc, tmp)
    return [proc, path, tmp]


def start_helper(name) -> list:
    """[process, pickle path, its directory]: chip_smoke.<name>(path) in a
    process of its own that sees no card, started after the script has
    touched the card (a forked child then could not use CUDA):
    write_app_build (host work: the app bilayer's build, more
    custom's CPU references) and write_serialization (the bilayer's XML
    round trip), beside the phases after the join, off the critical path
    (a thread slowed the phases by its share of the interpreter)."""
    import os
    import tempfile

    root = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_%s_" % name)
    path = os.path.join(tmp, "result.pickle")
    # one intra-op thread: the processes share the card host's cores with
    # the script and the examples
    code = ("import sys; sys.path.insert(0, %r); import torch; "
            "torch.set_num_threads(1); import chip_smoke; "
            "chip_smoke.%s(%r)" % (root, name, path))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=root, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    atexit.register(_stop_helper, proc, tmp)
    return [proc, path, tmp]


def _stop_helper(proc, tmp) -> None:
    """At exit: a helper not joined (the script failed first) is killed
    and its directory removed."""
    import shutil
    if proc.poll() is None:
        proc.kill()
        proc.wait()
    shutil.rmtree(tmp, ignore_errors=True)


def join_helper(started, label) -> tuple:
    """(what the helper of fork_helper or start_helper pickled, seconds
    waited): the process waited for, its output printed, its result
    read; raises, naming `label`, with its error output if it failed."""
    import shutil
    proc, path, tmp = started
    t0 = time.perf_counter()
    out, err = proc.communicate()
    wait_s = time.perf_counter() - t0
    if out:
        print(out, end="")
    if proc.returncode != 0:
        raise RuntimeError("%s failed (exit %d): %s" % (
            label, proc.returncode, err[-3000:]))
    with open(path, "rb") as f:
        result = pickle.load(f)
    shutil.rmtree(tmp, ignore_errors=True)
    return result, wait_s


def _force_check(label, ctx, system, platform, groups=(0, 1),
                 energy_bar=None) -> dict:
    """The Context's float32 forces and group energies against a float64
    Context (Precision "double": the plain versions) at its positions:
    the median relative force error and each group's relative energy
    error (the last group's the total less the others'), gated at
    FORCE_ERR_BAR and `energy_bar` (AMOEBA_ENERGY_BAR by default)."""
    energy_bar = AMOEBA_ENERGY_BAR if energy_bar is None else energy_bar
    st = ctx.getState(getForces=True, getPositions=True, getEnergy=True)
    props = {"Precision": "double"}
    oracle = (omm.Context(system, omm.VerletIntegrator(0.001),
                          omm.Platform.getPlatformByName(platform), props))
    oracle.setPositions(in_md(st.getPositions(asNumpy=True)))
    ref = oracle.getState(getForces=True, getEnergy=True)
    err = _median_relative_error(in_md(st.getForces(asNumpy=True)),
                                 in_md(ref.getForces(asNumpy=True)))
    # each Context evaluates the slow group once: its energy is the total
    # less the other groups'
    total = (in_md(st.getPotentialEnergy()), in_md(ref.getPotentialEnergy()))
    energies, rest = {}, [0.0, 0.0]
    for g in groups[:-1]:
        got = in_md(ctx.getState(getEnergy=True, groups={g})
                    .getPotentialEnergy())
        want = in_md(oracle.getState(getEnergy=True, groups={g})
                     .getPotentialEnergy())
        rest = [rest[0] + got, rest[1] + want]
        energies[g] = (got, want, abs(got - want) / max(abs(want), 1e-30))
    got, want = total[0] - rest[0], total[1] - rest[1]
    energies[groups[-1]] = (got, want,
                            abs(got - want) / max(abs(want), 1e-30))
    del oracle
    print("%s: median force error vs float64 %.3e (bar %.0e); group "
          "energies %s" % (label, err, FORCE_ERR_BAR, "; ".join(
              "%d: %.6f vs %.6f kJ/mol (rel %.2e)" % (g, *e)
              for g, e in energies.items())))
    if not err <= FORCE_ERR_BAR:
        raise RuntimeError("%s: median force error %.3e above %.0e"
                           % (label, err, FORCE_ERR_BAR))
    for g, e in energies.items():
        if not e[2] <= energy_bar:
            raise RuntimeError("%s: group %d energy %.6f vs float64 %.6f"
                               % (label, g, e[0], e[1]))
    return {"force_err": err, "energies": energies}


def _multipole_module(ctx):
    from openmm_tpu_torch.forces.amoeba import AmoebaMultipoleModule
    (module,) = [m for m in ctx._custom
                 if isinstance(m, AmoebaMultipoleModule)]
    return module


def amoeba_triple_inputs(ctx, seed=13) -> dict:
    """Kernels 4-5 at the shapes of the AMOEBA PME path of `ctx`: the
    SCF's reciprocal dipole field, one spread of 3N rows (mu's three
    fractional components on Wx, dWy, dWz planes) and the gather of the
    potential grid phi through (Wx, Wy, Wz), at the Context's positions;
    mu and phi seeded."""
    module = _multipole_module(ctx)
    pos = ctx._state["positions"].to(torch.float64)
    route, jac, green = module._recip_setup(pos, ctx._state["box"])
    planes = route.planes
    gen = torch.Generator(device=pos.device)
    gen.manual_seed(seed)
    n = pos.shape[0]
    (wx, dwx, _), (wy, dwy, _), (wz, dwz, _) = planes
    mu = 1e-3 * torch.randn((n, 3), generator=gen, dtype=torch.float64,
                            device=pos.device)
    muf = (mu[:, :, None] * jac[None]).sum(dim=1).float()
    rows_a = torch.cat([muf[:, 0:1] * dwx, muf[:, 1:2] * wx,
                        muf[:, 2:3] * wx]).contiguous()
    rows_y = torch.cat([wy, dwy, wy]).contiguous()
    rows_z = torch.cat([wz, wz, dwz]).contiguous()
    q = pallas_pme.spread_triple_plain(rows_a, rows_y, rows_z)
    phi = pme_mod.recip_potential(q, green, module.grid).contiguous()
    return {"grid": module.grid, "fwd": (rows_a, rows_y, rows_z),
            "bwd": (phi, wx.contiguous(), wy.contiguous(), wz.contiguous())}


def phase_amoeba_kernels(device, tri, deadline) -> dict:
    """Kernels 4 and 5 at the AMOEBA shapes (amoeba_triple_inputs) against
    their plain versions, and kernel 5's VJP (_SpreadTripleVJP's backward:
    kernel 4 on 3N rows and kernel 5 on 3N rows) against torch.autograd
    of the plain einsum VJP in float64, with seeded cotangents. Returns
    the largest absolute errors; raises on a miss."""
    errors = {}
    fwd, bwd = tri["fwd"], tri["bwd"]
    for name, got, want in (
            ("spread_triple_fwd", lambda: pallas_pme.spread_triple_fwd(*fwd),
             lambda: pallas_pme.spread_triple_plain(*fwd)),
            ("spread_triple_bwd", lambda: pallas_pme.spread_triple_bwd(*bwd),
             lambda: pallas_pme.spread_triple_vjp_plain(*bwd))):
        g, w = got(), want()
        _sync(device)
        err, scale, rel = _compare(g, w)
        print("amoeba kernel %-17s N = %d grid %s: max_abs_err %.3e rel "
              "%.3e (tolerance %.0e) %s" % (
                  name, fwd[0].shape[0] if name.endswith("fwd")
                  else bwd[1].shape[0], "x".join(map(str, tri["grid"])),
                  err, rel, TOLERANCE[name],
                  "ok" if rel <= TOLERANCE[name] else "MISS"))
        if not rel <= TOLERANCE[name]:
            raise RuntimeError("amoeba: kernel %s disagrees with its plain "
                               "version" % name)
        _check_repeatable(name, g, got())
        errors[name] = err
    gen = torch.Generator(device=device)
    gen.manual_seed(17)
    cot = [torch.randn(t.shape, generator=gen, device=device)
           for t in (bwd[1], bwd[2], bwd[3])]

    def second(inputs, vjp):
        leaves = [t.detach().clone().requires_grad_() for t in inputs]
        out = vjp(*leaves)
        loss = sum((o * c.to(o.dtype)).sum() for o, c in zip(out, cot))
        return torch.autograd.grad(loss, leaves)

    got = second(bwd, pallas_pme.spread_triple_vjp)
    want = second([t.double() for t in bwd], lambda *x: (
        torch.einsum("xyz,iy,iz->ix", x[0].reshape(tri["grid"]), x[2], x[3]),
        torch.einsum("xyz,ix,iz->iy", x[0].reshape(tri["grid"]), x[1], x[3]),
        torch.einsum("xyz,ix,iy->iz", x[0].reshape(tri["grid"]), x[1],
                     x[2])))
    _sync(device)
    err, scale, rel = _compare(got, tuple(w.float() for w in want))
    print("amoeba kernels 4-5 second order (kernel 5's VJP in dq, a, wy, "
          "wz) against autograd of the float64 einsum: max_abs_err %.3e "
          "rel %.3e (tolerance %.0e) %s" % (
              err, rel, SECOND_ORDER_TOL,
              "ok" if rel <= SECOND_ORDER_TOL else "MISS"))
    if not rel <= SECOND_ORDER_TOL:
        raise RuntimeError("amoeba: kernel 5's VJP disagrees with autograd "
                           "of the plain einsum")
    errors["second_order"] = err
    deadline.check("amoeba kernels")
    return errors


def amoeba_kernel_records(device, tri, launches, errors) -> list:
    """The kernels line's entries of kernels 4-5 at the AMOEBA shapes:
    launches from the AMOEBA PME run, times and bounds measured here, the
    einsum and its backward as the library calls."""
    fwd, bwd = tri["fwd"], tri["bwd"]
    nx, ny, nz = tri["grid"]
    g = nx * ny * nz
    f_ops = triple_ops(*fwd)[0]
    b_ops = triple_ops(*bwd[1:])[1]
    n3, n = fwd[0].shape[0], bwd[1].shape[0]
    leaves = [t.detach().clone().requires_grad_() for t in bwd[1:]]
    q_einsum = torch.einsum("ix,iy,iz->xyz", *leaves)
    dq3 = bwd[0].view(nx, ny, nz)
    rows = []
    for kern, call, plain, lib, nbytes, flops in (
            (pallas_pme.FWD, lambda: pallas_pme.spread_triple_fwd(*fwd),
             lambda: pallas_pme.spread_triple_plain(*fwd),
             lambda: torch.einsum("ix,iy,iz->xyz", *fwd),
             4 * (n3 * (nx + ny + nz) + g), f_ops),
            (pallas_pme.BWD, lambda: pallas_pme.spread_triple_bwd(*bwd),
             lambda: pallas_pme.spread_triple_vjp_plain(*bwd),
             lambda: torch.autograd.grad(q_einsum, leaves, dq3,
                                         retain_graph=True),
             4 * (g + 2 * n * (nx + ny + nz)), b_ops)):
        bound = _bound(nbytes, flops)
        cuda = device.type == "cuda"
        rows.append({
            "name": kern.name + "_amoeba", "route": "cuda",
            "source": kern.source, "replaces": kern.replaces,
            "launches": launches[kern.name], "max_abs_err": errors[kern.name],
            "ms": _time_ms(call, device) if cuda else None,
            "plain_ms": (_time_ms(plain, device, PLAIN_REPS, 1) if cuda
                         else None),
            "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": _time_ms(lib, device) if cuda else None})
    return rows


def _md_replay(device, label, ctx, step, replay, deadline) -> dict:
    """`replay` steps from a snapshot through the step program, then the
    same through the eager loop: the same bits in the positions, the
    velocities (so in the energies they give), the shared tensors and the
    clock. Returns the step program's run."""
    start = ctx._snapshot()

    def read(c):
        # the temperature: an energy reading is a whole AMOEBA evaluation
        return c.temperature()

    graph = _production(device, ctx, step, 0.0, replay, replay, deadline,
                        read)
    ctx._restore(start)
    eager = _production(device, ctx, ctx._step_eager, 0.0, replay, replay,
                        deadline, read)
    _same_bits(label, (graph["positions"], graph["velocities"]),
               (eager["positions"], eager["velocities"]))
    _same_state(label, graph, eager)
    return dict(graph, eager_ms=eager["wall_ms_per_step"])


def _amoeba_relax(system, positions, platform, relax=AMOEBA_RELAX):
    """(seconds, (positions, velocities, temperature)) after relax[2]
    LangevinMiddle
    steps of relax[0] ps at friction relax[1] from `positions` at
    AMOEBA_TEMPERATURE, the System's multipoles at Extrapolated
    polarization for them (three dipole fields a step where Mutual takes
    60; restored after): the relaxation of a lattice start, whose random
    water orientations release ~40 kJ/mol a water as they order."""
    from openmm_tpu_torch.forces.amoeba import AmoebaMultipoleForce
    (mp,) = [f for f in system.getForces()
             if isinstance(f, AmoebaMultipoleForce)]
    kind = mp.getPolarizationType()
    mp.setPolarizationType(AmoebaMultipoleForce.Extrapolated)
    t0 = time.perf_counter()
    try:
        integ = omm.LangevinMiddleIntegrator(AMOEBA_TEMPERATURE, relax[1],
                                             relax[0])
        integ.setRandomNumberSeed(29)
        ctx = (omm.Context(system, integ) if platform is None
               else omm.Context(system, integ, platform))
        ctx.setPositions(positions)
        ctx.setVelocitiesToTemperature(AMOEBA_TEMPERATURE,
                                       randomSeed=VELOCITY_SEED)
        integ.step(relax[2])
        st = ctx.getState(getPositions=True, getVelocities=True)
        out = (in_md(st.getPositions(asNumpy=True)),
               in_md(st.getVelocities(asNumpy=True)), ctx.temperature())
        del ctx
    finally:
        mp.setPolarizationType(kind)
    return time.perf_counter() - t0, out


def _amoeba_pme_prepare(device, modeller, system, minimize_iterations,
                        relax, deadline=None) -> dict:
    """phase_amoeba_pme's start on `device`: a Simulation under the MD's
    integrator, minimizeEnergy (the energy must fall; raises), then the
    lattice start relaxed (_amoeba_relax). Returns the energies before
    and after, the seconds, and the relaxed positions, velocities and
    temperature for the MD."""
    from openmm_tpu_torch import app
    deadline = deadline or Deadline(math.inf)
    platform = (None if device.type == "cuda"
                else omm.Platform.getPlatformByName("CPU"))
    integ = omm.MTSLangevinIntegrator(AMOEBA_TEMPERATURE, FRICTION, DT_PS,
                                      AMOEBA_MTS)
    sim = app.Simulation(modeller.topology, system, integ, platform)
    ctx = sim.context
    ctx.setPositions(modeller.positions)
    e0 = in_md(ctx.getState(getEnergy=True).getPotentialEnergy())
    t0 = time.perf_counter()
    sim.minimizeEnergy(maxIterations=minimize_iterations)
    _sync(device)
    minimize_s = time.perf_counter() - t0
    e1 = in_md(ctx.getState(getEnergy=True).getPotentialEnergy())
    print("amoeba pme: minimizeEnergy(maxIterations=%d) %.6f -> %.6f "
          "kJ/mol in %.2f s (to %.1f s of the script's clock)" % (
              minimize_iterations, e0, e1, minimize_s, since_start()))
    if not (math.isfinite(e1) and e1 < e0):
        raise RuntimeError("amoeba pme: the minimizer did not lower the "
                           "energy (%.6f -> %.6f)" % (e0, e1))
    deadline.check("amoeba pme: minimize")
    minimized = in_md(ctx.getState(getPositions=True).getPositions(
        asNumpy=True))
    # the minimizer's cached blocks freed before the relaxation's capture
    # (beside GK's capture in another process on the card)
    del sim, ctx
    _release(device)
    # the lattice start's ordering, thermalised, for the MD
    relax_s, relaxed = _amoeba_relax(system, minimized, platform, relax)
    print("amoeba pme: relaxed by %d LangevinMiddle steps of %.4f ps at "
          "%.0f/ps with Extrapolated polarization in %.2f s (to %.1f s of "
          "the script's clock); T %.1f K after" % (
              relax[2], relax[0], relax[1], relax_s, since_start(),
              relaxed[2]))
    deadline.check("amoeba pme: relaxation")
    return {"e0": e0, "e1": e1, "minimize_s": minimize_s,
            "relax_s": relax_s, "positions": relaxed[0],
            "velocities": relaxed[1], "temperature": relaxed[2]}


def phase_amoeba_pme(device, deadline=None, n_ala=HELIX_ALANINES,
                     box=AMOEBA_BOX, relax=AMOEBA_RELAX,
                     minimize_iterations=AMOEBA_MINIMIZE_ITERATIONS,
                     steps=AMOEBA_STEPS, replay=AMOEBA_REPLAY,
                     t_range=AMOEBA_T_RANGE, ready=None) -> dict:
    """The slice's path at full size: ACE-(ALA)n-NME (helix_pdb_text)
    through PDBFile and Modeller (addHydrogens, addSolvent in a cube of
    `box` nm with AMOEBA_BUILD_FORCEFIELD), the System from
    ForceField("amoeba2013.json").createSystem(PME, 0.7 nm, vdwCutoff 0.9
    nm, mutual polarization, mutualInducedTargetEpsilon 1e-5, no
    constraints; host seconds printed) with the AMOEBA forces in group 1,
    a Simulation under MTSLangevin (300 K, 1/ps, 2 fs, [(0, 2), (1, 1)])
    on the default platform: minimizeEnergy (the energy must fall), the
    lattice start relaxed (_amoeba_relax: positions and velocities for
    the MD; both _amoeba_pme_prepare), the float32 forces and group
    energies against float64 (_force_check), kernels 4-5 at this
    system's shapes and the second
    order (phase_amoeba_kernels), then `steps` steps through the step
    program with the kernel counts set to 0 (kernels 4 and 5 must
    launch), the temperature within `t_range`, and `replay` steps through
    the step program and the eager loop for the same bits. Prints ms a
    step, ns/day, launches a step, the SCF's residual and the peak device
    memory. `ready(stage)`: called with "check" between the preparation
    and the float64 check and with "timing" before the timed replay,
    which wait there for it (write_amoeba_pme's waits for the script).
    The result holds the kernels' inputs (on the host) and errors for
    their records (amoeba_kernel_records), which the caller times.
    Raises on a miss."""
    from openmm_tpu_torch import app
    deadline = deadline or Deadline(math.inf)
    cuda = device.type == "cuda"
    platform = None if cuda else omm.Platform.getPlatformByName("CPU")
    modeller, system, build_s, create_s = _amoeba_pme_system(
        n_ala, box, platform)
    prep = _amoeba_pme_prepare(device, modeller, system,
                               minimize_iterations, relax, deadline)
    t0 = time.perf_counter()
    if ready is not None:
        ready("check")
    wait_s = time.perf_counter() - t0
    n = system.getNumParticles()
    print("amoeba pme: %d atoms (ACE-(ALA)%d-NME in %d waters, %.1f nm "
          "box): Modeller %.2f s, createSystem %.2f s on the host (%.2f s "
          "waited after the relaxation); forces %s" % (
              n, n_ala, sum(r.name == "HOH"
                            for r in modeller.topology.residues()), box,
              build_s, create_s, wait_s, ", ".join(
                      "%s(%d)" % (type(f).__name__, f.getForceGroup())
                      for f in system.getForces())))
    deadline.check("amoeba pme: preparation")
    integ = omm.MTSLangevinIntegrator(AMOEBA_TEMPERATURE, FRICTION, DT_PS,
                                      AMOEBA_MTS)
    integ.setRandomNumberSeed(31)
    sim = app.Simulation(modeller.topology, system, integ, platform)
    ctx = sim.context
    ctx.setPositions(prep["positions"])
    ctx.setVelocities(prep["velocities"])
    marks = [time.perf_counter()]
    check = _force_check("amoeba pme", ctx, system,
                         "CUDA" if cuda else "CPU")
    deadline.check("amoeba pme: float64 check")
    marks.append(time.perf_counter())
    tri = amoeba_triple_inputs(ctx)
    errors = phase_amoeba_kernels(device, tri, deadline)
    marks.append(time.perf_counter())
    for kern in KERNELS:
        kern.launches = 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    run = _production(device, ctx, integ.step, ctx.temperature(), steps,
                      steps, deadline, read=lambda c: c.temperature())
    launches = {k.name: k.launches for k in (pallas_pme.FWD, pallas_pme.BWD)}
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    temperature = run["energies"][-1]
    print("amoeba pme: %d steps, T %s K; kernels 4-5 launches %s (%.1f and "
          "%.1f a step); peak device memory %.2f GB" % (
              steps, " ".join("%.1f" % t for t in run["energies"]),
              json.dumps(launches), launches[pallas_pme.FWD.name] / steps,
              launches[pallas_pme.BWD.name] / steps, peak / 1e9))
    if cuda and min(launches.values()) <= 0:
        raise RuntimeError("amoeba pme: kernels 4-5 never launched: %s"
                           % launches)
    if not t_range[0] <= temperature <= t_range[1]:
        raise RuntimeError("amoeba pme: temperature %.2f K outside %s"
                           % (temperature, t_range))
    if ready is not None:
        ready("timing")
    marks.append(time.perf_counter())
    graph = _md_replay(device, "amoeba pme", ctx, integ.step, replay,
                       deadline)
    marks.append(time.perf_counter())
    module = _multipole_module(ctx)
    state = ctx._module_state(module.pair_set, ctx._current_tiles())
    residual = module.scf_residual(ctx._state["positions"],
                                   ctx._state["box"], state)
    print("amoeba pme: %.4f ms a step (eager %.4f), %.3f ns/day on the "
          "step program; SCF residual |mu - alpha (E + T mu)| %.3e at the "
          "last step; the eager loop's bits" % (
              graph["wall_ms_per_step"], graph["eager_ms"], graph["ns_day"],
              residual))
    marks.append(time.perf_counter())
    print("amoeba pme: seconds for the float64 check %.1f, the kernel "
          "checks %.1f, the %d steps (the capture included) %.1f, the "
          "replays %.1f, the SCF residual %.1f" % (
              *np.diff(marks[:3]), steps, *np.diff(marks[2:])))
    deadline.check("amoeba pme")
    return {"atoms": n, "build_s": build_s, "create_s": create_s,
            "minimize": (prep["e0"], prep["e1"], prep["minimize_s"]),
            "check": check,
            "launches": launches, "temperature": temperature,
            "ms_per_step": graph["wall_ms_per_step"],
            "eager_ms": graph["eager_ms"], "ns_day": graph["ns_day"],
            "residual": residual, "peak_bytes": peak,
            "kernel_inputs": dict(tri, fwd=[t.cpu() for t in tri["fwd"]],
                                  bwd=[t.cpu() for t in tri["bwd"]]),
            "kernel_errors": errors,
            "steps": steps}


def phase_amoeba_gk(device, deadline=None, n_ala=GK_ALANINES,
                    steps=GK_STEPS) -> dict:
    """AMOEBA with generalized Kirkwood at amoebagk's size:
    ACE-(ALA)n-NME (Modeller.addHydrogens) with ForceField(
    "amoeba2013.json", "amoeba2013_gk.json"), NoCutoff, mutual
    polarization; the float32 Context's forces and group energies against
    float64 (_force_check), then `steps` steps under MTSLangevin with the
    AMOEBA forces in group 1 through the eager loop (Context._step_eager:
    the step program's capture of this dense step reserves most of the
    card's 80 GB, which the forked helpers beside it do not leave), a
    finite temperature after, the peak device memory printed. Raises on a
    miss."""
    from openmm_tpu_torch import app
    deadline = deadline or Deadline(math.inf)
    cuda = device.type == "cuda"
    platform = None if cuda else omm.Platform.getPlatformByName("CPU")
    modeller, system, build_s, create_s = _amoeba_gk_system(n_ala, platform)
    integ = omm.MTSLangevinIntegrator(AMOEBA_TEMPERATURE, FRICTION, DT_PS,
                                      AMOEBA_MTS)
    integ.setRandomNumberSeed(37)
    sim = app.Simulation(modeller.topology, system, integ, platform)
    ctx = sim.context
    ctx.setPositions(modeller.positions)
    deadline.check("amoeba gk: build")
    t0 = time.perf_counter()
    check = _force_check("amoeba gk", ctx, system, "CUDA" if cuda else "CPU")
    check_s = time.perf_counter() - t0
    ctx.setVelocitiesToTemperature(AMOEBA_TEMPERATURE,
                                   randomSeed=VELOCITY_SEED)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    # the temperature after the steps: an energy reading is a whole GK
    # evaluation, which the float64 check above has made
    run = _production(device, ctx, ctx._step_eager, 0.0, steps, steps,
                      deadline, lambda c: c.temperature())
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    n = system.getNumParticles()
    print("amoeba gk: %d atoms (ACE-(ALA)%d-NME), Modeller %.2f s, "
          "createSystem %.2f s, the float64 check %.2f s; %d steps through "
          "the eager loop, T %.2f K after, %.4f ms a step, peak device "
          "memory %.2f GB" % (
              n, n_ala, build_s, create_s, check_s, steps,
              run["energies"][-1], run["wall_ms_per_step"], peak / 1e9))
    if not math.isfinite(run["energies"][-1]):
        raise RuntimeError("amoeba gk: the temperature is not finite")
    deadline.check("amoeba gk")
    return {"atoms": n, "check": check,
            "ms_per_step": run["wall_ms_per_step"], "create_s": create_s,
            "peak_bytes": peak}


def phase_hippo(device, deadline=None, n_waters=HIPPO_WATERS,
                steps=HIPPO_STEPS) -> dict:
    """HippoNonbondedForce at NoCutoff on a cluster of `n_waters` flexible
    waters built through the API (models.hippo_water_cluster, the
    parameters of OpenMM's HIPPO water test): the float32 Context's forces
    against float64 (_force_check), then `steps` LangevinMiddle steps at
    HIPPO_DT, finite energies. Raises on a miss."""
    from openmm_tpu_torch.models import hippo_water_cluster
    deadline = deadline or Deadline(math.inf)
    cuda = device.type == "cuda"
    system, positions = hippo_water_cluster(n_waters)
    integ = omm.LangevinMiddleIntegrator(AMOEBA_TEMPERATURE, FRICTION,
                                         HIPPO_DT)
    integ.setRandomNumberSeed(41)
    ctx = (omm.Context(system, integ) if cuda else omm.Context(
        system, integ, omm.Platform.getPlatformByName("CPU")))
    ctx.setPositions(positions)
    check = _force_check("hippo", ctx, system, "CUDA" if cuda else "CPU",
                         groups=(0,))
    ctx.setVelocitiesToTemperature(AMOEBA_TEMPERATURE,
                                   randomSeed=VELOCITY_SEED)
    run = _production(device, ctx, integ.step, 0.0, steps, steps, deadline)
    print("hippo: %d waters, %d steps of %.4f ps, energies %s kJ/mol, %.4f "
          "ms a step (the first step's capture included)" % (
              system.getNumParticles() // 3, steps, HIPPO_DT,
              " ".join("%.2f" % e for e in run["energies"][1:]),
              run["wall_ms_per_step"]))
    if not all(math.isfinite(e) for e in run["energies"][1:]):
        raise RuntimeError("hippo: an energy is not finite")
    deadline.check("hippo")
    return {"atoms": system.getNumParticles(), "check": check,
            "ms_per_step": run["wall_ms_per_step"]}


# -- Drude and RPMD (the polarizable and the path-integral slice) ---------
DRUDE_FORCEFIELD = "swm4ndp.json"
DRUDE_BOX = 5.24                # nm cube: ~4,800 SWM4-NDP waters, ~24,000
DRUDE_CUTOFF = 0.9              # particles with their M sites and Drudes
DRUDE_TEMPERATURE = 300.0
DRUDE_FRICTION = 1.0
DRUDE_DRUDE_TEMPERATURE = 1.0
DRUDE_DRUDE_FRICTION = 20.0
DRUDE_DT = 0.001
DRUDE_MINIMIZE_ITERATIONS = 10
DRUDE_RELAX = 1000
DRUDE_RELAX_FRICTION = 100.0    # 1/ps: the lattice's strain taken out
DRUDE_STEPS = 100
DRUDE_REPLAY = 10
DRUDE_T_RANGE = (250.0, 360.0)  # the centres of mass and the other atoms
DRUDE_REL_T_RANGE = (0.0, 10.0)  # the Drudes' relative motion (CHANGES.md)
# the group energies' bar, relative: the NonbondedForce's group is the sum
# of a direct part and a reciprocal one each ~250x larger than it (the
# SWM4-NDP charges of 1.7 e, each Drude's pair correction ~1,600 kJ/mol),
# so float32 parts at ~1e-7 leave ~1e-5 of the sum (1.3e-5 in a CPU run
# of 343 waters)
DRUDE_ENERGY_BAR = 1e-4
DRUDE_SCF_STEPS = 4
DRUDE_NH_STEPS = 6
DRUDE_NH_FREQUENCY = 10.0
DRUDE_NH_DRUDE_FREQUENCY = 50.0
DRUDE_SIDE_REPLAY = 2
RPMD_FORCEFIELD = "amber14-tip3p.json"
RPMD_WATERS = 216
RPMD_CUTOFF = 0.9
RPMD_COPIES = 32
RPMD_CONTRACTED = 4             # copies of the reciprocal space (group 1)
RPMD_TEMPERATURE = 298.0
RPMD_FRICTION = 1.0
RPMD_DT = 0.00025
RPMD_MINIMIZE_ITERATIONS = 10  # the lattice's strain, before the copies
RPMD_RELAX = 30
RPMD_STEPS = 30
RPMD_REPLAY = 2
RPMD_T_RANGE = (200.0, 420.0)   # the centroid's temperature (CHANGES.md)
RPMD_NPT_FREQUENCY = 1
RPMD_NPT_STEPS = 10             # 10 attempts
RPMD_OFFSET_BAR = 1e-12         # nm: each copy's move against the centroid's
# the XML round trip (phase_serialization) and a periodic NonbondedForce as
# a collective variable (phase_cv_nonbonded), on the main path's water box
XML_STEPS = 100                 # each run; the State reported at half
XML_SEED = 7                    # the main path's integrator's seed
CV_STEPS = 200
CV_CHUNK = 50
CV_REPLAY = 10
CV_TURN_STEPS = 25
CV_SEED = 43
CV_ENERGY_BAR = 1e-9            # relative, s = 1 against the plain force
CV_FORCE_BAR = 1e-6             # the median relative force difference
CV_T_RANGE = (200.0, 450.0)


def drude_build(box=DRUDE_BOX, cutoff=DRUDE_CUTOFF) -> tuple:
    """The SWM4-NDP box as users build it: Modeller.addSolvent(
    ForceField(DRUDE_FORCEFIELD), model="tip3p", a `box` nm cube), then
    addExtraParticles (an M site and a Drude particle on each water),
    then createSystem(PME `cutoff` nm, rigid water), the DrudeForce in
    force group 1: (topology, positions, System, host seconds)."""
    from openmm_tpu_torch import app
    from openmm_tpu_torch import unit as u
    t0 = time.perf_counter()
    ff = app.ForceField(DRUDE_FORCEFIELD)
    modeller = app.Modeller(app.Topology(), [])
    modeller.addSolvent(ff, model="tip3p",
                        boxSize=omm.Vec3(box, box, box) * u.nanometer)
    modeller.addExtraParticles(ff)
    system = ff.createSystem(modeller.topology, nonbondedMethod=app.PME,
                             nonbondedCutoff=cutoff * u.nanometer,
                             rigidWater=True)
    for force in system.getForces():
        if isinstance(force, omm.DrudeForce):
            force.setForceGroup(1)
    return (modeller.topology, modeller.positions, system,
            time.perf_counter() - t0)


def rpmd_build(waters=RPMD_WATERS, cutoff=RPMD_CUTOFF) -> tuple:
    """`waters` flexible TIP3P waters at liquid density
    (models.tip3p_water_box's lattice) through ForceField(
    RPMD_FORCEFIELD).createSystem(PME `cutoff` nm, rigidWater=False, no
    constraints, no CMMotionRemover), the reciprocal space in force group
    1: (topology, positions, System, host seconds)."""
    from openmm_tpu_torch import app
    from openmm_tpu_torch import unit as u
    t0 = time.perf_counter()
    water, positions = tip3p_water_box(waters)
    top = water_topology(waters, in_md(water.getDefaultPeriodicBoxVectors()))
    system = app.ForceField(RPMD_FORCEFIELD).createSystem(
        top, nonbondedMethod=app.PME, nonbondedCutoff=cutoff * u.nanometer,
        constraints=None, rigidWater=False, removeCMMotion=False)
    for force in system.getForces():
        if isinstance(force, omm.NonbondedForce):
            force.setReciprocalSpaceForceGroup(1)
    return top, positions, system, time.perf_counter() - t0


def write_drude(path) -> None:
    """The Drude path on the card in a forked helper (fork_helper): the
    SWM4-NDP box built (drude_build), kernels 1-3 held against their plain
    versions at its shapes (every Drude particle on its oxygen), then
    phase_drude; its result pickled to `path`."""
    t0 = since_start()
    set_fp32_matmul_exact()
    device = torch.device("cuda", 0)
    built = drude_build()
    t1 = since_start()
    inp = kernel_inputs(device, None, system=built[2],
                        positions=in_md(built[1]), fine=True)
    errors = phase_kernels(device, inp, Deadline(math.inf), MAIN_PATH_NAMES,
                           " (drude box)")
    del inp
    out = dict(phase_drude(device, built=built), kernel_errors=errors)
    with open(path, "wb") as f:
        pickle.dump(out, f)
    print("helper write_drude: %.1f to %.1f s of the script's clock (the "
          "build to %.1f s), peak device memory reserved %.1f GB" % (
              t0, since_start(), t1,
              torch.cuda.max_memory_reserved(device) / 1e9))


def write_membrane(path) -> None:
    """modeller_membrane_build and phase_modeller_membrane on the card in
    a forked helper (fork_helper), the phase's result pickled to
    `path`."""
    t0 = since_start()
    set_fp32_matmul_exact()
    device = torch.device("cuda", 0)
    out = phase_modeller_membrane(device,
                                  built=modeller_membrane_build(device))
    with open(path, "wb") as f:
        pickle.dump(out, f)
    print("helper write_membrane: %.1f to %.1f s of the script's clock, "
          "peak device memory reserved %.1f GB" % (
              t0, since_start(),
              torch.cuda.max_memory_reserved(device) / 1e9))


def write_rpmd(path) -> None:
    """phase_rpmd on the card in a forked helper (fork_helper), its
    System built there (rpmd_build), its result pickled to `path`."""
    t0 = since_start()
    set_fp32_matmul_exact()
    device = torch.device("cuda", 0)
    out = phase_rpmd(device, built=rpmd_build())
    with open(path, "wb") as f:
        pickle.dump(out, f)
    print("helper write_rpmd: %.1f to %.1f s of the script's clock, peak "
          "device memory reserved %.1f GB" % (
              t0, since_start(),
              torch.cuda.max_memory_reserved(device) / 1e9))


def water_topology(n_waters, box=None):
    """A Topology of `n_waters` waters (O, H1, H2 each, bonded), with the
    periodic box `box` ((3, 3) nm) when given."""
    from openmm_tpu_torch import app
    from openmm_tpu_torch import unit as u
    top = app.Topology()
    chain = top.addChain()
    oxygen, hydrogen = (app.Element.getBySymbol(s) for s in ("O", "H"))
    for _ in range(n_waters):
        res = top.addResidue("HOH", chain)
        for name, el in (("O", oxygen), ("H1", hydrogen), ("H2", hydrogen)):
            top.addAtom(name, el, res)
    top.createStandardBonds()
    if box is not None:
        top.setPeriodicBoxVectors(u.Quantity(
            tuple(omm.Vec3(*row) for row in box), u.nanometer))
    return top


def _same_arrays(what, got, want, path="system") -> None:
    """Raise unless two from_numpy dicts (to_numpy) hold equal arrays and
    equal values, naming the first key that differs."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or sorted(got) != sorted(want):
            raise RuntimeError("%s: %s has keys %s, %s" % (
                what, path, sorted(got), sorted(want)))
        for key in want:
            _same_arrays(what, got[key], want[key], "%s[%r]" % (path, key))
    elif isinstance(want, np.ndarray):
        if not (isinstance(got, np.ndarray) and got.shape == want.shape
                and np.array_equal(got, want)):
            raise RuntimeError("%s: %s differs" % (what, path))
    elif isinstance(want, (list, tuple)):
        if len(got) != len(want):
            raise RuntimeError("%s: %s has %d entries, %d" % (
                what, path, len(got), len(want)))
        for k, (g, w) in enumerate(zip(got, want)):
            _same_arrays(what, g, w, "%s[%d]" % (path, k))
    elif got != want:
        raise RuntimeError("%s: %s is %r, %r" % (what, path, got, want))


def serialization_round_trip(build=popc_bilayer) -> dict:
    """The host part of phase_serialization: the System of build() (by
    default models.popc_bilayer()'s, 32,512 atoms) and a
    LangevinMiddleIntegrator written as XML and
    read back, each direction timed; raises unless every force's
    parameters are equal after the round trip (to_numpy's arrays, and
    the XML written again is the same text). {"system"|"integrator":
    {"bytes", "serialize_s", "deserialize_s"}}, "atoms", "forces"."""
    system, _ = build()
    integ = omm.LangevinMiddleIntegrator(BILAYER_TEMPERATURE, FRICTION,
                                         DT_PS)
    integ.setRandomNumberSeed(XML_SEED)
    out, again = {}, {}
    for label, obj in (("system", system), ("integrator", integ)):
        t0 = time.perf_counter()
        xml = omm.XmlSerializer.serialize(obj)
        t1 = time.perf_counter()
        again[label] = omm.XmlSerializer.deserialize(xml)
        t2 = time.perf_counter()
        if omm.XmlSerializer.serialize(again[label]) != xml:
            raise RuntimeError("bilayer xml: the %s read back writes "
                               "another XML" % label)
        out[label] = {"bytes": len(xml.encode()), "serialize_s": t1 - t0,
                      "deserialize_s": t2 - t1}
    got = [type(f).__name__ for f in again["system"].getForces()]
    if got != [type(f).__name__ for f in system.getForces()]:
        raise RuntimeError("bilayer xml: forces %s after the round trip"
                           % got)
    _same_arrays("bilayer xml", omm.to_numpy(again["system"]),
                 omm.to_numpy(system))
    out["atoms"] = system.getNumParticles()
    out["forces"] = got
    return out


def write_serialization(path) -> None:
    """serialization_round_trip in a helper process that sees no card
    (start_helper), its result pickled to `path`."""
    t0 = since_start()
    out = serialization_round_trip()
    with open(path, "wb") as f:
        pickle.dump(out, f)
    print("helper write_serialization: %.1f to %.1f s of the script's "
          "clock" % (t0, since_start()))


def _same_run(what, got, want) -> None:
    """Raise unless two Contexts hold the same positions, velocities,
    clock and step count, in bits."""
    for key in ("positions", "velocities"):
        g, w = got._state[key], want._state[key]
        if not torch.equal(g, w):
            raise RuntimeError("%s: %s differ by up to %.3e" % (
                what, key, float((g - w).abs().max())))
    if (float(got._time), got.getStepCount()) != (float(want._time),
                                                  want.getStepCount()):
        raise RuntimeError("%s: clock %r step %d, the original %r step %d"
                           % (what, float(got._time), got.getStepCount(),
                              float(want._time), want.getStepCount()))


def phase_serialization(device, main, deadline=None, host=None,
                        steps=XML_STEPS) -> dict:
    """The XML round trip of the main path's water box. `host`: what
    serialization_round_trip gave (the bilayer's round trip, run in a
    helper forked at the start). On the Context phase_main_path left: its
    integrator's random seed fixed (XML_SEED), its System and integrator
    written as XML and its State as Simulation.saveState writes it; a
    Simulation(topology, "system.xml", "integrator.xml",
    state="state.xml") on the card's platform with a
    CheckpointReporter(writeState=True) every steps/2 steps, and the
    original Context set to the same State with its generator at the
    seed's start (as the new Context's); steps/2 steps each, equal in
    bits (positions, velocities, clock, step count); then the new
    Simulation loads the State its reporter wrote and the original sets
    its own State (each drops its candidate state), steps/2 more each:
    equal in bits again. Kernels 1-3 must launch in the new Simulation's
    steps. Raises on a miss."""
    import os
    import shutil
    import tempfile
    from openmm_tpu_torch import app
    deadline = deadline or Deadline(math.inf)
    ctx = main["context"]
    integ, system = ctx.getIntegrator(), ctx.getSystem()
    integ.setRandomNumberSeed(XML_SEED)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_xml_")
    paths = {k: os.path.join(tmp, k + ".xml")
             for k in ("system", "integrator", "state", "reported")}
    seconds = {}
    try:
        t0 = time.perf_counter()
        xml = omm.XmlSerializer.serialize(system)
        seconds["serialize"] = time.perf_counter() - t0
        nbytes = len(xml.encode())
        with open(paths["system"], "w") as f:
            f.write(xml)
        del xml
        with open(paths["integrator"], "w") as f:
            f.write(omm.XmlSerializer.serialize(integ))
        # what Simulation.saveState writes (the reporter calls it below)
        t0 = time.perf_counter()
        state = ctx.getState(getPositions=True, getVelocities=True,
                             getParameters=True, getIntegratorParameters=True)
        with open(paths["state"], "w") as f:
            f.write(omm.XmlSerializer.serialize(state))
        seconds["save_state"] = time.perf_counter() - t0
        platform = omm.Platform.getPlatformByName(
            "CUDA" if device.type == "cuda" else "CPU")
        t0 = time.perf_counter()
        sim = app.Simulation(water_topology(system.getNumParticles() // 3),
                             paths["system"], paths["integrator"], platform,
                             state=paths["state"])
        seconds["simulation"] = time.perf_counter() - t0
        deadline.check("serialization: the Simulation from XML")
        half = steps // 2
        sim.reporters.append(app.CheckpointReporter(paths["reported"], half,
                                                    writeState=True))
        ctx.setState(state)
        fresh = torch.Generator(device=device)
        fresh.manual_seed(XML_SEED)
        ctx._generator.set_state(fresh.get_state())
        for kern in _build.KERNELS:
            kern.launches = 0
        sim.step(half)
        launches = {k.name: k.launches for k in MAIN_PATH_KERNELS}
        integ.step(half)
        _same_run("serialization: %d steps" % half, sim.context, ctx)
        deadline.check("serialization: steps")
        sim.reporters.clear()
        t0 = time.perf_counter()
        sim.loadState(paths["reported"])
        seconds["load_state"] = time.perf_counter() - t0
        reported = sim.context.getStepCount()
        ctx.setState(ctx.getState(getPositions=True, getVelocities=True,
                                  getParameters=True,
                                  getIntegratorParameters=True))
        for kern in _build.KERNELS:
            kern.launches = 0
        sim.step(steps - half)
        for kern in MAIN_PATH_KERNELS:
            launches[kern.name] += kern.launches
        integ.step(steps - half)
        _same_run("serialization: the reported State's %d steps"
                  % (steps - half), sim.context, ctx)
        captures = _captures(sim.context)
        del sim
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print("serialization: water box (%d atoms) as XML %d bytes, written in "
          "%.3f s; its State %.3f s, Simulation from system.xml, "
          "integrator.xml and state.xml %.3f s (the Context and its "
          "reading), loadState %.3f s; %d steps from the State, the "
          "reporter's State (step %d) loaded and %d more: the original "
          "Context's bits; captures %d; launches %s" % (
              system.getNumParticles(), nbytes, seconds["serialize"],
              seconds["save_state"], seconds["simulation"],
              seconds["load_state"], half, reported, steps - half, captures,
              json.dumps(launches)))
    if host is not None:
        print("serialization: the %d-atom host System (%d forces) as XML %d "
              "bytes, written in %.3f s, read in %.3f s; its integrator %d "
              "bytes; every force's parameters equal after the round "
              "trip" % (
                  host["atoms"], len(host["forces"]),
                  host["system"]["bytes"], host["system"]["serialize_s"],
                  host["system"]["deserialize_s"],
                  host["integrator"]["bytes"]))
    if device.type == "cuda":
        _require_launched("serialization", launches, MAIN_PATH_KERNELS)
    deadline.check("serialization")
    return {"bytes": nbytes, "seconds": seconds, "launches": launches,
            "host": host}


def phase_cv_nonbonded(device, main, deadline=None, steps=CV_STEPS,
                       chunk=CV_CHUNK, replay=CV_REPLAY,
                       turn_steps=CV_TURN_STEPS, t_range=CV_T_RANGE) -> dict:
    """The main path's water box with its NonbondedForce (PME) as the
    variable E of CustomCVForce("s*E"), a global parameter s: the
    variable's candidate state built under its Context's one gate
    (kernels 1-3). At s = 1 its energy and forces against the plain
    water Context at the same positions (CV_ENERGY_BAR relative,
    CV_FORCE_BAR median relative); at s = 0.5 (setParameter, no new
    capture) exactly half. Then `steps` LangevinMiddle steps at s = 1
    through the step program in calls of `chunk`, each main-path kernel
    launched at least once a step by those steps alone (the counts zeroed
    before each call and read after), the variable's state rebuilt at
    least once, the temperature in `t_range`; `replay` steps from a
    snapshot through the step program and the eager loop: the same bits;
    ms a step against the plain Context in turns (plain, cv, cv, plain).
    Raises on a miss."""
    deadline = deadline or Deadline(math.inf)
    base = main["context"]
    system = base.getSystem()
    (nb,) = [f for f in system.getForces()
             if isinstance(f, omm.NonbondedForce)]
    cv_system = omm.System()
    for i in range(system.getNumParticles()):
        cv_system.addParticle(system.getParticleMass(i))
    for i in range(system.getNumConstraints()):
        cv_system.addConstraint(*system.getConstraintParameters(i))
    cv_system.setDefaultPeriodicBoxVectors(
        *system.getDefaultPeriodicBoxVectors())
    cv = omm.CustomCVForce("s*E")
    cv.addGlobalParameter("s", 1.0)
    cv.addCollectiveVariable("E", nb)
    cv_system.addForce(cv)
    for force in system.getForces():
        if force is not nb:
            cv_system.addForce(force)
    integ = omm.LangevinMiddleIntegrator(300.0, FRICTION, DT_PS)
    integ.setRandomNumberSeed(CV_SEED)
    ctx = _platform_context(device, cv_system, integ)
    st = base.getState(getPositions=True, getVelocities=True)
    pos = in_md(st.getPositions(asNumpy=True))
    ctx.setPositions(pos)
    ctx.setVelocities(in_md(st.getVelocities(asNumpy=True)))
    # the plain Context's candidate state built at these positions too
    base.setPositions(pos)
    readings = {}
    for label, c, s in (("plain", base, None), ("cv", ctx, 1.0),
                        ("half", ctx, 0.5)):
        if s is not None:
            ctx.setParameter("s", s)
        r = c.getState(getEnergy=True, getForces=True)
        readings[label] = (in_md(r.getPotentialEnergy()),
                           in_md(r.getForces(asNumpy=True)))
    ctx.setParameter("s", 1.0)
    (e_plain, f_plain), (e_cv, f_cv), (e_half, f_half) = (
        readings[k] for k in ("plain", "cv", "half"))
    e_err = abs(e_cv - e_plain) / abs(e_plain)
    f_err = _median_relative_error(f_cv, f_plain)
    deadline.check("cv nonbonded: readings")
    r0 = ctx.rebuild_count
    launches = dict.fromkeys(MAIN_PATH_NAMES, 0)
    for done in range(0, steps, chunk):
        for kern in _build.KERNELS:
            kern.launches = 0
        integ.step(min(chunk, steps - done))
        for kern in MAIN_PATH_KERNELS:
            launches[kern.name] += kern.launches
        deadline.check("cv nonbonded: steps")
    rebuilds = ctx.rebuild_count - r0
    temperature = ctx.temperature()
    captures = _captures(ctx)
    start = ctx._snapshot()
    graph = _production(device, ctx, integ.step, 0.0, replay, replay,
                        deadline)
    ctx._restore(start)
    eager = _production(device, ctx, ctx._step_eager, 0.0, replay, replay,
                        deadline)
    _same_bits("cv nonbonded", (graph["positions"], graph["velocities"]),
               (eager["positions"], eager["velocities"]))
    _same_state("cv nonbonded", graph, eager)
    turns = _in_turns(device, {"plain": (base, base.getIntegrator().step),
                               "cv": (ctx, integ.step)}, turn_steps,
                      ("plain", "cv", "cv", "plain"), deadline,
                      label="cv nonbonded")
    ms = {key: statistics.mean(v[0]) for key, v in turns.items()}
    print("cv nonbonded: CustomCVForce s*E over the %d-atom box's PME "
          "NonbondedForce: at s = 1 energy %.6f (plain %.6f, %.3e "
          "relative, bar %.0e), median force difference %.3e (bar %.0e); "
          "at s = 0.5 %.6f; %d steps: %d rebuilds of the variable's "
          "candidate state, captures %d, T %.2f K, launches %s; %d steps "
          "replayed through the eager loop: the same bits; in turns %.4f "
          "ms a step (plain %.4f)" % (
              system.getNumParticles(), e_cv, e_plain, e_err, CV_ENERGY_BAR,
              f_err, CV_FORCE_BAR, e_half, steps, rebuilds, captures,
              temperature, json.dumps(launches), replay, ms["cv"],
              ms["plain"]))
    if not e_err <= CV_ENERGY_BAR:
        raise RuntimeError("cv nonbonded: energy %.9f against the plain "
                           "force's %.9f" % (e_cv, e_plain))
    if not f_err <= CV_FORCE_BAR:
        raise RuntimeError("cv nonbonded: median force difference %.3e"
                           % f_err)
    if e_half != 0.5 * e_cv or not np.array_equal(f_half, 0.5 * f_cv):
        raise RuntimeError("cv nonbonded: s = 0.5 gives %.9f, not half of "
                           "%.9f" % (e_half, e_cv))
    if rebuilds < 1:
        raise RuntimeError("cv nonbonded: the variable's candidate state "
                           "was never rebuilt in %d steps" % steps)
    if device.type == "cuda":
        if captures != 1:
            raise RuntimeError("cv nonbonded: %d programs captured"
                               % captures)
        if min(launches.values()) < steps:
            raise RuntimeError("cv nonbonded: in %d steps a kernel "
                               "launched fewer times than once a step: %s"
                               % (steps, launches))
    if not t_range[0] <= temperature <= t_range[1]:
        raise RuntimeError("cv nonbonded: temperature %.2f K" % temperature)
    deadline.check("cv nonbonded")
    return {"energy": e_cv, "plain_energy": e_plain, "e_err": e_err,
            "force_err": f_err, "half": e_half, "rebuilds": rebuilds,
            "temperature": temperature, "launches": launches, "ms": ms}


# the mesh phases (openmm_tpu_torch/parallel): kernel 1 on the row-brick
# ranges of D ranks, the water box on a one-rank NCCL mesh with the
# gather captured, and two gloo ranks sharing the card
MESH_SIZES = (2, 4, 8)
MESH_STEPS = 100
MESH_EAGER_STEPS = 25           # of them replayed through the eager loop
MESH_TURN_STEPS = 50
MESH_TURNS = ("plain", "mesh", "mesh", "plain")
MESH_SEED = 23
MESH_RANKS = 2
MESH_RANK_STEPS = 20
MESH_RF_DIELECTRIC = 78.3
MESH_LJ_ALPHA = 3.0             # 1/nm, kernel 1's LJPME constants


def _mesh_kernel_cases(inp, seed=31) -> dict:
    """{instantiation: fn(bricks)}: kernel 1 on the main path's inputs in
    each of its instantiations, the rows of `bricks` ((begin, end), or
    None for all): Ewald and the reaction field (its constants at the
    cutoff) in the energy-and-force kernel, LJPME (c6 in par4's fourth
    slot, MESH_LJ_ALPHA, a shift, 1/rc^6), the float32-pair input (a
    seeded low part) and the derivative instantiation (seeded dpar4)."""
    pos4, par4, cand, count, words, consts = inp["tiles"]
    sw = inp["module"].use_switch
    gen = torch.Generator(device=pos4.device)
    gen.manual_seed(seed)
    rc = float(consts[1]) ** 0.5
    eps = MESH_RF_DIELECTRIC
    rf = consts.clone()
    rf[2] = (eps - 1.0) / ((2.0 * eps + 1.0) * rc ** 3)
    rf[3] = 3.0 * eps / ((2.0 * eps + 1.0) * rc)
    lj_par = par4.clone()
    lj_par[:, 3] = par4[:, 2] * (2.0 * par4[:, 1]) ** 3
    lj = consts.clone()
    x = (MESH_LJ_ALPHA * rc) ** 2
    lj[2] = MESH_LJ_ALPHA ** 2
    lj[3] = -(1.0 - math.exp(-x) * (1.0 + x + 0.5 * x * x)) / rc ** 6
    lj[15] = 1.0 / rc ** 6
    lo = 1e-8 * torch.randn(pos4.shape, generator=gen, device=pos4.device)
    lo[:, 3] = 0.0
    dpar4 = torch.randn(par4.shape, generator=gen, device=pos4.device)
    tables = (cand, count, words)
    tiles = tile_pairs.nonbonded_tiles
    return {
        "ewald": lambda b: tiles(pos4, par4, *tables, consts,
                                 tile_pairs.MODE_EWALD, sw, None, b),
        "rf": lambda b: tiles(pos4, par4, *tables, rf, tile_pairs.MODE_RF,
                              sw, None, b),
        "ljpme": lambda b: tiles(pos4, lj_par, *tables, lj,
                                 tile_pairs.MODE_LJPME, False, None, b),
        "fine": lambda b: tiles(pos4, par4, *tables, consts,
                                tile_pairs.MODE_EWALD, sw, lo.contiguous(),
                                b),
        "deriv": lambda b: tile_pairs.nonbonded_tiles_deriv(
            pos4, par4, dpar4, *tables, consts, tile_pairs.MODE_EWALD, sw,
            b)}


def phase_mesh_kernels(device, inp, deadline, sizes=MESH_SIZES) -> dict:
    """Kernel 1 on the row-brick ranges of D ranks (D in `sizes`:
    parallel/mesh.py's split) on the main path's inputs, in each
    instantiation (_mesh_kernel_cases): every rank's rows put together
    (zero outside its range, added as integers, as Mesh.gather adds them)
    must be the whole launch's bits; then kernel 1 (Ewald) timed on each
    half of the bricks against the whole launch. Raises on a miss."""
    n_bricks = inp["tiles"][3].shape[0]
    cases = _mesh_kernel_cases(inp)
    for name, fn in cases.items():
        whole = fn(None)
        for d in sizes:
            total = torch.zeros_like(whole).view(torch.int32)
            for rank in range(d):
                total += fn(row_split(n_bricks, rank, d)).view(torch.int32)
            if not torch.equal(total.view(whole.dtype), whole):
                bad = int((total.view(whole.dtype) != whole).sum())
                raise RuntimeError("mesh kernels: kernel 1 (%s) on %d ranks' "
                                   "row ranges differs from the whole launch "
                                   "in %d values" % (name, d, bad))
        deadline.check("mesh kernels: %s" % name)
    halves = [row_split(n_bricks, r, 2) for r in range(2)]
    whole_ms, half_ms = None, [None, None]
    if device.type == "cuda":
        whole_ms = _time_ms(lambda: cases["ewald"](None), device)
        half_ms = [_time_ms(lambda b=b: cases["ewald"](b), device)
                   for b in halves]
    print("mesh kernels: kernel 1 on the row-brick ranges of %s ranks "
          "(%d bricks) in %s: the whole launch's bits; Ewald on the halves "
          "%s %s and %s ms a call, the whole %s ms" % (
              "/".join(map(str, sizes)), n_bricks, ", ".join(cases),
              halves, *("%.4f" % t if t is not None else "not timed"
                        for t in half_ms + [whole_ms])))
    deadline.check("mesh kernels")
    return {"sizes": list(sizes), "instantiations": list(cases),
            "same_bits": True, "bricks": n_bricks, "halves": halves,
            "half_ms": half_ms, "whole_ms": whole_ms}


def phase_mesh_nccl(device, main, deadline=None, steps=MESH_STEPS,
                    eager_steps=MESH_EAGER_STEPS, turn_steps=MESH_TURN_STEPS,
                    turns=MESH_TURNS, backend="nccl") -> dict:
    """The main path's water box on a one-rank NCCL mesh: a process group
    of world size 1 from a FileStore in a temporary directory,
    set_default_mesh(make_mesh()), a Context built after it and a plain
    one beside it (LangevinMiddle, the same seed), both from the main
    Context's positions and velocities. `steps` steps of each through the
    step program (the mesh Context's graph with the gather captured): the
    same bits; the first `eager_steps` of the mesh Context's steps
    replayed from its snapshot through the eager loop and through the
    step program: the same bits again; then ms a step of each in turns. The group is torn down after the phase. Raises on a
    miss. (backend "gloo": the CPU tests' rehearsal.)"""
    import os
    import shutil
    import tempfile

    import torch.distributed as dist
    deadline = deadline or Deadline(math.inf)
    base = main["context"]
    system = base.getSystem()
    st = base.getState(getPositions=True, getVelocities=True)
    pos = in_md(st.getPositions(asNumpy=True))
    vel = in_md(st.getVelocities(asNumpy=True))
    store = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    # one rank: the bootstrap stays on the loopback interface
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    t0 = time.perf_counter()
    dist.init_process_group(
        backend, store=dist.FileStore(os.path.join(store, "store"), 1),
        rank=0, world_size=1,
        device_id=device if backend == "nccl" else None)
    try:
        init_s = time.perf_counter() - t0
        mesh = make_mesh()
        contexts = {}
        for label in ("mesh", "plain"):
            set_default_mesh(mesh if label == "mesh" else None)
            try:
                integ = omm.LangevinMiddleIntegrator(300.0, FRICTION, DT_PS)
                integ.setRandomNumberSeed(MESH_SEED)
                ctx = _platform_context(device, system, integ)
            finally:
                set_default_mesh(None)
            ctx.setPositions(pos)
            ctx.setVelocities(vel)
            contexts[label] = (ctx, integ.step)
        ctx = contexts["mesh"][0]
        start = ctx._snapshot()
        for kern in KERNELS:
            kern.launches = 0
        graph = _production(device, ctx, contexts["mesh"][1], 0.0, steps,
                            steps, deadline)
        launches = _launches_since([0] * len(KERNELS))
        plain = _production(device, contexts["plain"][0],
                            contexts["plain"][1], 0.0, steps, steps,
                            deadline)
        _same_bits("mesh nccl: the mesh Context against the plain one",
                   (graph["positions"], graph["velocities"]),
                   (plain["positions"], plain["velocities"]))
        ctx._restore(start)
        eager = _production(device, ctx, ctx._step_eager, 0.0, eager_steps,
                            eager_steps, deadline)
        ctx._restore(start)
        again = _production(device, ctx, contexts["mesh"][1], 0.0,
                            eager_steps, eager_steps, deadline)
        _same_bits("mesh nccl", (again["positions"], again["velocities"]),
                   (eager["positions"], eager["velocities"]))
        _same_state("mesh nccl", again, eager)
        timed = _in_turns(device, contexts, turn_steps, turns, deadline,
                          label="mesh nccl")
        ms = {key: statistics.mean(v[0]) for key, v in timed.items()}
        captures = _captures(ctx)
        # dE/dlambda through the offsets on the mesh: kernel 1's derivative
        # instantiation, its rows gathered
        deriv = ranks.offsets_derivative(
            mesh, platform="CUDA" if device.type == "cuda" else "CPU",
            reference=True)
    finally:
        set_default_mesh(None)
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    print("mesh nccl: %d-atom water box on a one-rank %s mesh (init %.2f "
          "s): %d steps through the step program with the gather captured "
          "(%d captures), the plain Context's bits, the first %d the eager "
          "loop's; launches %s; in turns %.4f ms a step (plain %.4f)" % (
              system.getNumParticles(), backend, init_s, steps, captures,
              eager_steps,
              json.dumps(launches), ms["mesh"], ms["plain"]))
    if device.type == "cuda" and launches.get(tile_pairs.TILES.name, 0) \
            < steps:
        raise RuntimeError("mesh nccl: kernel 1 launched %s times in %d "
                           "steps" % (launches, steps))
    got, want = deriv["mesh"], deriv["single"]
    print("mesh nccl: the alchemical water box's NonbondedForce energy "
          "%.6f kJ/mol and dE/dlambda_electrostatics %.6f on the mesh "
          "(derivative launches %d), the plain Context's %.6f and %.6f" % (
              got["energy"], got["derivative"], got["launches"],
              want["energy"], want["derivative"]))
    if (got["energy"], got["derivative"]) != (want["energy"],
                                              want["derivative"]) \
            or not math.isfinite(got["derivative"]) \
            or (device.type == "cuda" and got["launches"] <= 0):
        raise RuntimeError("mesh nccl: dE/dlambda on the mesh %r, the "
                           "plain Context's %r" % (got, want))
    deadline.check("mesh nccl")
    return {"atoms": system.getNumParticles(), "steps": steps,
            "init_s": init_s, "ms": ms, "launches": launches,
            "captures": captures, "derivative": deriv}


class ForkedRanks:
    """The MESH_RANKS ranks of start_mesh_ranks, each ranks.rank_main on
    a spec of ranks.write_spec in a Forked child (one intra-op thread,
    niced by `nice`): forked before the script touches the card, they
    inherit its imports and await its build. join() returns each rank's
    results as ranks.Ranks.join does; a rank not joined is killed at
    exit."""

    def __init__(self, tasks, nice=NICE):
        import os
        import shutil
        import tempfile
        self.tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_ranks_")
        atexit.register(shutil.rmtree, self.tmp, True)
        spec = ranks.write_spec(self.tmp, MESH_RANKS, tasks)
        self.started = []
        for rank in range(MESH_RANKS):
            directory = os.path.join(self.tmp, "rank%d" % rank)
            os.mkdir(directory)
            proc = Forked(directory, ranks.rank_main, spec, rank, threads=1,
                          nice=nice)
            atexit.register(_stop_helper, proc, directory)
            self.started.append([proc, ranks.out_path(spec, rank),
                                 directory])

    def join(self, timeout=None) -> list:
        return [join_helper(started, "mesh rank %d" % rank)[0]
                for rank, started in enumerate(self.started)]


def start_mesh_ranks(n_waters=N_WATERS, steps=MESH_RANK_STEPS,
                     platform="CUDA", fork=True):
    """Two gloo ranks, each with a Context of the water box on this card:
    `steps` LangevinMiddle steps through the eager loop on the mesh (a
    graph capture first, which must raise), the first rank then the same
    run without a mesh (parallel/ranks.py's water_box task). Forked
    (ForkedRanks) at the script's start with the other helpers, they
    await the build and run beside the phases until phase_mesh_ranks
    joins them. fork=False starts them as fresh interpreters instead
    (ranks.Ranks), which import the port anew; platform "CPU" captures
    nothing (the CPU tests' rehearsal)."""
    tasks = [("water_box", dict(
        n_waters=n_waters, platform=platform, steps=steps, eager=True,
        seed=MESH_SEED, reference=True, refuse_capture=platform == "CUDA"),
        None)]
    if fork:
        return ForkedRanks(tasks)
    started = ranks.Ranks(MESH_RANKS, tasks)
    atexit.register(started.kill)
    return started


def phase_mesh_ranks(started, deadline, cuda=True) -> dict:
    """The two ranks of start_mesh_ranks joined: each rank's energy and
    forces, and its positions and energy after the steps, must be the
    single-process run's bits; each rank launched kernel 1 on its half of
    the row bricks; on a card (`cuda`) the graph capture raised naming
    gloo; no rank loaded JAX. Raises on a miss."""
    t0 = time.perf_counter()
    results = started.join(timeout=max(deadline.remaining(), 1.0))
    wait_s = time.perf_counter() - t0
    single = results[0][0]["single"]
    runs = [r[0]["mesh"] for r in results]
    for rank, run in enumerate(runs):
        differ = {key: float(np.abs(np.asarray(run[key])
                                    - np.asarray(single[key])).max())
                  for key in ("energy", "forces", "positions", "energy_after")
                  if not np.array_equal(run[key], single[key])}
        if differ:
            raise RuntimeError("mesh ranks: rank %d differs from the "
                               "single-process run by %s" % (rank, differ))
        n_bricks = tile_pairs.pad_to_block(
            single["forces"].shape[0], tile_pairs.BRICK) // tile_pairs.BRICK
        if (cuda and run["launches"] <= 0) or run["bricks"] != row_split(
                n_bricks, rank, MESH_RANKS):
            raise RuntimeError("mesh ranks: rank %d swept %s, %d launches"
                               % (rank, run["bricks"], run["launches"]))
        if cuda and "gloo" not in (run["capture"] or ""):
            raise RuntimeError("mesh ranks: rank %d's capture did not raise "
                               "(%r)" % (rank, run["capture"]))
        if not math.isfinite(run["energy_after"]):
            raise RuntimeError("mesh ranks: energy %r" % run["energy_after"])
    if any(r[-1]["modules"] for r in results):
        raise RuntimeError("mesh ranks: a rank loaded %s"
                           % results[0][-1]["modules"])
    print("mesh ranks: %d gloo ranks sharing the card, the %d-atom water box "
          "through the eager loop, %d steps: every rank the single-process "
          "run's bits (energy %.6f kJ/mol after); row bricks %s, kernel 1 "
          "launches %s; %.4f ms a step (single process %.4f); the capture "
          "refused; waited %.1f s" % (
              len(runs), single["forces"].shape[0], runs[0]["steps"],
              single["energy_after"], [r["bricks"] for r in runs],
              [r["launches"] for r in runs],
              statistics.mean(r["ms_per_step"] for r in runs),
              single["ms_per_step"], wait_s))
    deadline.check("mesh ranks")
    return {"ranks": len(runs), "bricks": [r["bricks"] for r in runs],
            "launches": [r["launches"] for r in runs],
            "ms_per_step": [r["ms_per_step"] for r in runs],
            "single_ms_per_step": single["ms_per_step"], "wait_s": wait_s}


def _launches_since(before) -> dict:
    return {k.name: k.launches - b for k, b in zip(KERNELS, before)
            if k.launches != b}


def _require_launched(label, launches, kernels) -> None:
    """Raise unless every kernel of `kernels` launched on the path."""
    missing = [k.name for k in kernels if launches.get(k.name, 0) <= 0]
    if missing:
        raise RuntimeError("%s: %s never launched (%s)"
                           % (label, missing, launches))


def drude_temperatures(ctx, pairs) -> tuple:
    """(the temperature of the centres of mass of the (Drude, parent)
    pairs with the other particles, the temperature of the pairs'
    relative motion), K, from the Context's velocities: 3 degrees of
    freedom a moving particle less the pairs' and the constraints for
    the first, 3 a pair for the second."""
    v = ctx._state["velocities"].cpu().numpy()
    m = ctx._masses.cpu().numpy()
    d, p = pairs[:, 0], pairs[:, 1]
    single = np.ones(len(m), bool)
    single[pairs.reshape(-1)] = False
    mt = (m[d] + m[p])[:, None]
    v_com = (m[d, None] * v[d] + m[p, None] * v[p]) / mt
    mu = (m[d] * m[p])[:, None] / mt
    v_rel = v[d] - v[p]
    ke_com = 0.5 * (np.sum(m[single, None] * v[single] ** 2)
                    + np.sum(mt * v_com ** 2))
    ke_rel = 0.5 * np.sum(mu * v_rel ** 2)
    dof_com = 3 * (int(np.count_nonzero(m)) - len(pairs)) \
        - ctx._system.getNumConstraints()
    return (2.0 * ke_com / (dof_com * omm.BOLTZ),
            2.0 * ke_rel / (3 * len(pairs) * omm.BOLTZ))


def phase_drude(device, deadline=None, built=None,
                minimize_iterations=DRUDE_MINIMIZE_ITERATIONS,
                relax=DRUDE_RELAX, steps=DRUDE_STEPS, replay=DRUDE_REPLAY,
                scf_steps=DRUDE_SCF_STEPS, nh_steps=DRUDE_NH_STEPS,
                side_replay=DRUDE_SIDE_REPLAY) -> dict:
    """The SWM4-NDP box (drude_build: the water of CHARMM Drude
    simulations at the main path's size) on the default platform:
    minimizeEnergy (kernels 1, 4, 5) from every Drude particle on its
    oxygen; the float32 forces and group energies (the DrudeForce in
    group 1) against float64 (_force_check); DrudeLangevinIntegrator
    (DRUDE_TEMPERATURE, DRUDE_FRICTION, DRUDE_DRUDE_TEMPERATURE,
    DRUDE_DRUDE_FRICTION, DRUDE_DT) through the step program, `relax`
    steps at DRUDE_RELAX_FRICTION (the lattice's strain, released as heat,
    taken out) and `steps` of production (kernels 1-3 once a step, counted from
    0), replayed from a snapshot through the eager loop for the same bits,
    with its ns/day; the centres of mass' temperature within
    DRUDE_T_RANGE and the Drudes' relative temperature within
    DRUDE_REL_T_RANGE; DrudeSCFIntegrator (DRUDE_DT, kernel 1 thirteen
    times a step) for `scf_steps`, the Drudes' largest residual force
    printed; DrudeNoseHooverIntegrator for `nh_steps`; the SCF's and
    Nose-Hoover's last `side_replay` steps through the eager loop for the
    same bits; every energy finite. Raises on a miss."""
    deadline = deadline or Deadline(math.inf)
    cuda = device.type == "cuda"
    platform = None if cuda else omm.Platform.getPlatformByName("CPU")
    top, positions, system, build_s = built or drude_build()
    drude = [f for f in system.getForces()
             if isinstance(f, omm.DrudeForce)][0]
    pairs = np.asarray(drude._drude_pairs(), np.int64)

    def context(integ):
        integ.setRandomNumberSeed(43)
        return (omm.Context(system, integ) if cuda
                else omm.Context(system, integ, platform))

    integ = omm.DrudeLangevinIntegrator(
        DRUDE_TEMPERATURE, DRUDE_FRICTION, DRUDE_DRUDE_TEMPERATURE,
        DRUDE_DRUDE_FRICTION, DRUDE_DT)
    ctx = context(integ)
    ctx.setPositions(positions)
    e0 = in_md(ctx.getState(getEnergy=True).getPotentialEnergy())
    before = [k.launches for k in KERNELS]
    t0 = time.perf_counter()
    omm.LocalEnergyMinimizer.minimize(ctx, MINIMIZE_TOLERANCE,
                                      minimize_iterations)
    minimize_s = time.perf_counter() - t0
    launches = {"minimize": _launches_since(before)}
    if cuda:
        _require_launched("drude minimize", launches["minimize"],
                          MINIMIZER_KERNELS)
    e1 = in_md(ctx.getState(getEnergy=True).getPotentialEnergy())
    if not (math.isfinite(e0) and math.isfinite(e1) and e1 < e0):
        raise RuntimeError("drude: minimization took %.3f to %.3f kJ/mol"
                           % (e0, e1))
    deadline.check("drude: minimize")
    check = _force_check("drude", ctx, system, "CUDA" if cuda else "CPU",
                         energy_bar=DRUDE_ENERGY_BAR)
    ctx.setVelocitiesToTemperature(DRUDE_TEMPERATURE,
                                   randomSeed=VELOCITY_SEED)
    integ.setFriction(DRUDE_RELAX_FRICTION)
    integ.step(relax)
    integ.setFriction(DRUDE_FRICTION)
    deadline.check("drude: relaxation")
    energy = in_md(ctx.getState(getEnergy=True).getPotentialEnergy())
    for kern in KERNELS:
        kern.launches = 0
    run = _production(device, ctx, integ.step, energy, steps, steps // 2,
                      deadline)
    launches["langevin"] = _launches_since([0] * len(KERNELS))
    if cuda:
        _require_launched("drude langevin", launches["langevin"],
                          MAIN_PATH_KERNELS)
    t_com, t_rel = drude_temperatures(ctx, pairs)
    same = _md_replay(device, "drude langevin", ctx, integ.step, replay,
                      deadline)
    energies = list(run["energies"])
    print("drude: %d particles (%d waters: M sites, Drudes), build %.2f s "
          "on the host, energy %.2f after minimizeEnergy(%d) (%.2f s, from "
          "%.2f); DrudeLangevin %.4f ms a step (eager %.4f), %.2f ns/day; "
          "T %.2f K (band %s), Drude T %.3f K (band %s); launches %s" % (
              system.getNumParticles(), len(pairs), build_s, e1,
              minimize_iterations, minimize_s, e0, run["wall_ms_per_step"],
              same["eager_ms"], run["ns_day"], t_com, DRUDE_T_RANGE, t_rel,
              DRUDE_REL_T_RANGE, json.dumps(launches)))
    if not DRUDE_T_RANGE[0] <= t_com <= DRUDE_T_RANGE[1]:
        raise RuntimeError("drude: temperature %.2f K outside %s"
                           % (t_com, DRUDE_T_RANGE))
    if not DRUDE_REL_T_RANGE[0] <= t_rel <= DRUDE_REL_T_RANGE[1]:
        raise RuntimeError("drude: Drude temperature %.3f K outside %s"
                           % (t_rel, DRUDE_REL_T_RANGE))
    state = ctx.getState(getPositions=True, getVelocities=True)
    del ctx, same
    _release(device)
    side = {}
    for label, make, n in (
            ("scf", lambda: omm.DrudeSCFIntegrator(DRUDE_DT), scf_steps),
            ("nose-hoover", lambda: omm.DrudeNoseHooverIntegrator(
                DRUDE_TEMPERATURE, DRUDE_NH_FREQUENCY,
                DRUDE_DRUDE_TEMPERATURE, DRUDE_NH_DRUDE_FREQUENCY,
                DRUDE_DT), nh_steps)):
        sctx = context(make())
        sctx.setPositions(in_md(state.getPositions(asNumpy=True)))
        sctx.setVelocities(in_md(state.getVelocities(asNumpy=True)))
        for kern in KERNELS:
            kern.launches = 0
        srun = _production(device, sctx, sctx.getIntegrator().step, 0.0,
                           n, n, deadline)
        launches[label] = _launches_since([0] * len(KERNELS))
        if cuda:
            _require_launched("drude " + label, launches[label],
                              MAIN_PATH_KERNELS)
        rep = _md_replay(device, "drude " + label, sctx,
                         sctx.getIntegrator().step, side_replay, deadline)
        st = sctx.getState(getEnergy=True, getForces=True)
        forces = in_md(st.getForces(asNumpy=True))
        residual = float(np.linalg.norm(forces[pairs[:, 0]], axis=1).max())
        side[label] = {"ms_per_step": srun["wall_ms_per_step"],
                       "eager_ms": rep["eager_ms"], "residual": residual,
                       "energy": in_md(st.getPotentialEnergy())}
        energies += srun["energies"][1:] + [side[label]["energy"]]
        print("drude %s: %d steps, %.4f ms a step (eager %.4f), energy "
              "%.2f kJ/mol, the Drudes' largest force %.4e kJ/mol/nm%s, "
              "launches %s" % (
                  label, n, srun["wall_ms_per_step"], rep["eager_ms"],
                  side[label]["energy"], residual,
                  " (the SCF's residual after %d iterations)"
                  % SCF_ITERATIONS if label == "scf" else "",
                  json.dumps(launches[label])))
        del sctx, rep
        _release(device)
        deadline.check("drude " + label)
    if not all(math.isfinite(e) for e in energies):
        raise RuntimeError("drude: an energy is not finite")
    return {"atoms": system.getNumParticles(), "waters": len(pairs),
            "check": check, "ms_per_step": run["wall_ms_per_step"],
            "ns_day": run["ns_day"], "t_com": t_com, "t_rel": t_rel,
            "launches": launches, "side": side, "build_s": build_s,
            "minimize_s": minimize_s}


def ring_polymer_spread(integ, atoms) -> float:
    """The radius of gyration of the ring polymers of `atoms`, nm: the
    root mean square distance of the copies from their centroid."""
    x = integ._rp[0][:, atoms].to(torch.float64)
    return float(((x - x.mean(dim=0)) ** 2).sum(dim=-1).mean().sqrt())


def centroid_temperature(integ, ctx) -> float:
    """The temperature of the copies' centroid velocities, K (3 degrees
    of freedom a moving particle: no constraints)."""
    v = integ._rp[1].mean(dim=0)
    m = ctx._masses
    return float((m[:, None] * v * v).sum()) / (
        3 * ctx._n_massive * omm.BOLTZ)


def phase_rpmd(device, deadline=None, built=None, copies=RPMD_COPIES,
               minimize_iterations=RPMD_MINIMIZE_ITERATIONS,
               relax=RPMD_RELAX, steps=RPMD_STEPS, replay=RPMD_REPLAY,
               npt_steps=RPMD_NPT_STEPS) -> dict:
    """216 flexible TIP3P waters (rpmd_build: the size and the bead count
    of the RPMD water studies of Habershon, Markland and Manolopoulos, J.
    Chem. Phys. 131, 024501 (2009); amber14's TIP3P stands in for their
    q-TIP4P/F) under RPMDIntegrator(`copies`, RPMD_TEMPERATURE,
    RPMD_FRICTION, RPMD_DT, the reciprocal space contracted to
    RPMD_CONTRACTED copies: Markland and Manolopoulos, 2008), from the
    lattice minimized (`minimize_iterations`, before the first step
    takes every copy from the Context's positions): `relax` steps, then
    `steps` through the step program (kernel 1 on every copy
    twice a step, kernels 2-3 on the contracted ones, counted from 0),
    replayed from a snapshot through the eager loop for the same bits,
    with ms a step and ns/day; gates: finite energies (every copy's,
    getTotalEnergy), the centroid's temperature within RPMD_T_RANGE, the
    hydrogens' ring-polymer radius of gyration above the oxygens'. Then
    RPMDMonteCarloBarostat (1 bar, every RPMD_NPT_FREQUENCY steps) for
    `npt_steps` from the copies' state: at least one move accepted, and
    one attempt made to accept moves every copy by its centroid's offset
    (against torch's own molecule centres, RPMD_OFFSET_BAR). Raises on a
    miss."""
    deadline = deadline or Deadline(math.inf)
    cuda = device.type == "cuda"
    platform = None if cuda else omm.Platform.getPlatformByName("CPU")
    top, positions, system, build_s = built or rpmd_build()

    def make(integ):
        integ.setRandomNumberSeed(47)
        return (omm.Context(system, integ) if cuda
                else omm.Context(system, integ, platform))

    integ = omm.RPMDIntegrator(copies, RPMD_TEMPERATURE, RPMD_FRICTION,
                               RPMD_DT, contractions={1: RPMD_CONTRACTED})
    ctx = make(integ)
    ctx.setPositions(positions)
    omm.LocalEnergyMinimizer.minimize(ctx, MINIMIZE_TOLERANCE,
                                      minimize_iterations)
    ctx.setVelocitiesToTemperature(RPMD_TEMPERATURE, randomSeed=VELOCITY_SEED)
    integ.step(relax)
    deadline.check("rpmd: relaxation")
    for kern in KERNELS:
        kern.launches = 0
    run = _production(device, ctx, integ.step, 0.0, steps, steps, deadline,
                      lambda c: c.temperature())
    launches = {"rpmd": _launches_since([0] * len(KERNELS))}
    if cuda:
        _require_launched("rpmd", launches["rpmd"], MAIN_PATH_KERNELS)
    tiles_per_step = launches["rpmd"].get(tile_pairs.TILES.name, 0) / steps
    t_c = centroid_temperature(integ, ctx)
    oxygens = [a.index for a in top.atoms() if a.element.symbol == "O"]
    hydrogens = [a.index for a in top.atoms() if a.element.symbol == "H"]
    rg_o, rg_h = (ring_polymer_spread(integ, oxygens),
                  ring_polymer_spread(integ, hydrogens))
    total = in_md(integ.getTotalEnergy())
    copy_energies = [in_md(integ.getState(c, getEnergy=True)
                           .getPotentialEnergy()) for c in (0, copies - 1)]
    same = _md_replay(device, "rpmd", ctx, integ.step, replay, deadline)
    print("rpmd: %d waters, %d copies (the reciprocal space on %d), %.4f "
          "ps; %.4f ms a step (eager %.4f), %.4f ns/day; kernel 1 %.1f "
          "launches a step; centroid T %.2f K (band %s); radius of gyration "
          "H %.5f nm, O %.5f nm; total energy %.2f kJ/mol, copies' "
          "potential energies %s; launches %s" % (
              len(oxygens), copies, RPMD_CONTRACTED, RPMD_DT,
              run["wall_ms_per_step"], same["eager_ms"], run["ns_day"],
              tiles_per_step, t_c, RPMD_T_RANGE, rg_h, rg_o, total,
              " ".join("%.2f" % e for e in copy_energies),
              json.dumps(launches["rpmd"])))
    if not all(math.isfinite(e) for e in [total] + copy_energies):
        raise RuntimeError("rpmd: an energy is not finite")
    if not RPMD_T_RANGE[0] <= t_c <= RPMD_T_RANGE[1]:
        raise RuntimeError("rpmd: centroid temperature %.2f K outside %s"
                           % (t_c, RPMD_T_RANGE))
    if not rg_h > rg_o > 0.0:
        raise RuntimeError("rpmd: the hydrogens' radius of gyration %.5f nm "
                           "is not above the oxygens' %.5f" % (rg_h, rg_o))
    deadline.check("rpmd")
    copies_pos = integ._rp[0].clone()
    copies_vel = integ._rp[1].clone()
    eager_ms = same["eager_ms"]
    del ctx, same
    _release(device)
    baro = omm.RPMDMonteCarloBarostat(1.0, RPMD_NPT_FREQUENCY)
    system.addForce(baro)
    try:
        npt = omm.RPMDIntegrator(copies, RPMD_TEMPERATURE, RPMD_FRICTION,
                                 RPMD_DT, contractions={1: RPMD_CONTRACTED})
        nctx = make(npt)
        for c in range(copies):
            npt.setPositions(c, copies_pos[c].cpu().numpy())
            npt.setVelocities(c, copies_vel[c].cpu().numpy())
        for kern in KERNELS:
            kern.launches = 0
        boxes = [float(nctx._box[0, 0])]
        t0 = time.perf_counter()
        for _ in range(npt_steps // RPMD_NPT_FREQUENCY):
            npt.step(RPMD_NPT_FREQUENCY)
            boxes.append(float(nctx._box[0, 0]))
        npt_ms = (time.perf_counter() - t0) / npt_steps * 1e3
        launches["rpmd_npt"] = _launches_since([0] * len(KERNELS))
        accepted = sum(a != b for a, b in zip(boxes, boxes[1:]))
        # one attempt made to accept (its Metropolis uniform 0): every copy
        # moves by its centroid's molecule offsets
        module = nctx._barostats[0]
        pos_all = npt._rp[0].clone()
        box = nctx._box.clone()
        out = module.attempt(pos_all, box, torch.tensor(
            [0.9, 0.0], dtype=torch.float64, device=pos_all.device),
            nctx._gp, nctx._trial_energy)
        scale = float(out["box"][0, 0] / box[0, 0])
        centroid = pos_all.mean(dim=0)
        mol = torch.as_tensor(nctx._molecule_id, device=pos_all.device)
        m = nctx._masses[:, None]
        com = torch.zeros((nctx._n_molecules, 3), dtype=torch.float64,
                          device=pos_all.device).index_add_(
            0, mol, m * centroid) / torch.zeros(
            (nctx._n_molecules, 1), dtype=torch.float64,
            device=pos_all.device).index_add_(0, mol, m)
        offset = (com * (scale - 1.0))[mol]
        offset_err = float((out["positions"] - pos_all - offset[None])
                           .abs().max())
        npt_energy = in_md(nctx.getState(getEnergy=True)
                           .getPotentialEnergy())
    finally:
        system.removeForce(system.getNumForces() - 1)
    print("rpmd npt: RPMDMonteCarloBarostat(1 bar, every %d steps), %d "
          "steps, %d attempts, %d accepted, box %.5f to %.5f nm, %.4f ms a "
          "step; an accepted attempt's copies against their centroid's "
          "offset %.3e nm (scale %.6f); launches %s" % (
              RPMD_NPT_FREQUENCY, npt_steps, npt_steps // RPMD_NPT_FREQUENCY,
              accepted, boxes[0], boxes[-1], npt_ms, offset_err, scale,
              json.dumps(launches["rpmd_npt"])))
    if cuda:
        _require_launched("rpmd npt", launches["rpmd_npt"],
                          MAIN_PATH_KERNELS)
    if accepted < 1 or not math.isfinite(npt_energy):
        raise RuntimeError("rpmd npt: %d moves accepted, energy %r"
                           % (accepted, npt_energy))
    if not (bool(out["accept"]) and offset_err <= RPMD_OFFSET_BAR
            and scale != 1.0):
        raise RuntimeError("rpmd npt: the copies moved %.3e nm from their "
                           "centroid's offset" % offset_err)
    deadline.check("rpmd npt")
    return {"waters": len(oxygens), "copies": copies,
            "ms_per_step": run["wall_ms_per_step"],
            "eager_ms": eager_ms, "ns_day": run["ns_day"],
            "tiles_per_step": tiles_per_step, "t_centroid": t_c,
            "rg": (rg_h, rg_o), "launches": launches,
            "accepted": accepted, "npt_ms": npt_ms, "build_s": build_s}


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


def _stages_ms(fn, device, reps=20) -> list:
    """[(kernel or memset name, device ms per call)] of what fn launches,
    from torch.profiler over `reps` calls, largest first."""
    fn()
    _sync(device)
    # the profiler under torch.profiler.profile, called directly: that
    # wrapper also imports torch._inductor, to read one setting
    with torch.autograd.profiler.profile(use_cpu=False, use_device="cuda",
                                         use_kineto=True) as prof:
        for _ in range(reps):
            fn()
        _sync(device)
    rows = [(e.key.replace("(anonymous namespace)::", "").split("(")[0]
             .strip(), e.self_device_time_total / reps / 1e3)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    return sorted(rows, key=lambda r: -r[1])


# float operations (an FMA counts 2) that each function needs, at least:
# kernel 1, per distinct pair inside the cutoff: staged triclinic image and
# r^2 (24), LJ (16), Ewald erfc and its force (29), the force applied to
# both atoms and the energy summed (11); in MODE_RF the reaction field and
# its force (qq, then 4 each: 9) in place of the Ewald terms
OPS_PER_PAIR = 80.0
OPS_PER_PAIR_RF = 60.0
# in MODE_LJPME, per pair besides OPS_PER_PAIR: x = alpha_LJ^2 r^2 (1),
# e^-x (4), the complement's polynomial (5), g and h (6), its coefficient,
# energy and force (8), the two shifts (9)
OPS_PER_PAIR_LJPME = OPS_PER_PAIR + 33.0
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


def triple_ops(a, wy, wz) -> tuple[float, float, float, float]:
    """(forward, backward) float operations that kernels 4 and 5 need on
    these inputs, counting only the nonzero weights of each row (5 per axis
    for order-5 splines), then the dense counts the kernels perform.
    Forward, per atom: the ny_i nz_i products wy wz, then one FMA per
    product with each nonzero a. Backward, per atom: the same wy wz
    products; dA, an FMA of each against every dQ row (nx); U = a . dQ at
    the entries dWy and dWz read (every y at a nonzero z and every z at a
    nonzero y), an FMA per nonzero a; dWy and dWz, an FMA per entry read."""
    nx, ny, nz = a.shape[1], wy.shape[1], wz.shape[1]
    na = (a != 0).sum(dim=1).double()
    my = (wy != 0).sum(dim=1).double()
    mz = (wz != 0).sum(dim=1).double()
    yz = my * mz
    fwd = float((yz + 2.0 * na * yz).sum())
    u_entries = ny * mz + nz * my - yz
    bwd = float((yz + 2.0 * nx * yz + 2.0 * na * u_entries
                 + 2.0 * (ny * mz + nz * my)).sum())
    dense = float(a.shape[0] * nx * ny * nz)
    return fwd, bwd, 2.0 * dense, 4.0 * dense


def _bound(nbytes, flops) -> tuple:
    """(bound ms, "bytes" or "operations"): the larger of `nbytes` over
    HBM bandwidth and `flops` over the float32 peak."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tile_bound(inp, tile_counts) -> tuple:
    """Kernel 1's bound on inp["tiles"]: its inputs read once and its
    output written once, and the operations of the distinct pairs inside
    the cutoff that these inputs have (each counted once, not from both
    atoms; from `tile_counts`, count_tile_pairs of the same inputs), for
    the mode of the inputs' module."""
    pos4, par4, cand, count, words, consts = inp["tiles"]
    per_pair = {tile_pairs.MODE_EWALD: OPS_PER_PAIR,
                tile_pairs.MODE_RF: OPS_PER_PAIR_RF,
                tile_pairs.MODE_LJPME: OPS_PER_PAIR_LJPME}[
                    inp["module"].mode]
    tiles_in = sum(t.numel() * t.element_size()
                   for t in (pos4, par4, cand, count, words, consts))
    tiles_out = 4 * pos4.numel()              # (n_pad, 4) float32: f, e
    return _bound(tiles_in + tiles_out,
                  per_pair * tile_counts["inside"] / 2)


def kernel_bounds(inp, tile_counts) -> dict:
    """{name: (bound ms, "bytes" or "operations")}: the larger of the bytes
    each function must move (each input read once, each output written
    once) over HBM bandwidth and the float operations it needs over the
    float32 peak. Kernel 1 as tile_bound; kernels 4 and 5 count the
    nonzero weights (triple_ops)."""
    n = inp["pos"].shape[0]
    nx, ny, nz = inp["grid"]
    g = nx * ny * nz
    t_ops = triple_ops(*inp["triple"])
    g_lj = math.prod(inp["disp"]["grid"]) if "disp" in inp else 0
    work = {
        # kernels 2-3 on the dispersion grid: as below, c6 for the charges
        "pme_spread_dispersion": (4 * (4 * n + 9 + g_lj),
                                  n * (3 * OPS_WEIGHTS + OPS_SPREAD)),
        "pme_gather_dispersion": (4 * (4 * n + 9 + g_lj + 3 * n),
                                  n * (3 * OPS_WEIGHTS_DW + OPS_GATHER)),
        # in: positions (3 n), charges (n), binv; out: the grid
        "pme_spread": (4 * (4 * n + 9 + g),
                       n * (3 * OPS_WEIGHTS + OPS_SPREAD)),
        # in: positions, charges, binv, the grid; out: forces (3 n) (the
        # visiting order is a hint the function does not need: not counted)
        "pme_gather": (4 * (4 * n + 9 + g + 3 * n),
                       n * (3 * OPS_WEIGHTS_DW + OPS_GATHER)),
        # in: a, wy, wz; out: Q
        "spread_triple_fwd": (4 * (n * (nx + ny + nz) + g), t_ops[0]),
        # in: dQ, a, wy, wz; out: dA, dWy, dWz
        "spread_triple_bwd": (4 * (g + 2 * n * (nx + ny + nz)), t_ops[1]),
    }
    out = ({} if tile_counts is None
           else {"nonbonded_tiles": tile_bound(inp, tile_counts)})
    for name, (nbytes, flops) in work.items():
        out[name] = _bound(nbytes, flops)
    return out


def tile_counts(inp) -> dict:
    pos4, _, cand, count, words, consts = inp["tiles"]
    return tile_pairs.count_tile_pairs(pos4, cand, count, words, consts)


def tile_sweep_line(inp, c) -> str:
    """Kernel 1's work on the main path's inputs (c = tile_counts(inp)):
    a sweep of every candidate slot, and the culled one."""
    return ("kernel nonbonded_tiles at %d atoms (full matrix): pair slots "
            "visited %d before the cull, %d after; pairs inside the cutoff "
            "%d; pair-term lane evaluations %d before, %d after" % (
                inp["pos"].shape[0], c["slots"], c["visited"], c["inside"],
                c["evaluated_before"], c["evaluated"]))


def phase_timing(device, inp, counts, launches, errors, deadline) -> list:
    calls = _kernel_calls(inp)
    bounds = kernel_bounds(inp, counts)
    flat, val = pme_zslab.spread_terms(inp["pos"], inp["charge"],
                                       inp["binv"], inp["grid"])
    nx, ny, nz = inp["grid"]
    q_flat = torch.zeros(nx * ny * nz, dtype=torch.float32, device=device)
    # one PyTorch call for each of kernels 4-5 (TF32 is off): the einsum,
    # and the backward of the einsum alone (its forward is run once here)
    leaves = [t.detach().clone().requires_grad_() for t in inp["triple"]]
    q_einsum = torch.einsum("ix,iy,iz->xyz", *leaves)
    dq3 = inp["dq"].view(nx, ny, nz)
    library = {
        "pme_spread": lambda: q_flat.zero_().index_add_(0, flat, val),
        "spread_triple_fwd": lambda: torch.einsum("ix,iy,iz->xyz",
                                                  *inp["triple"]),
        "spread_triple_bwd": lambda: torch.autograd.grad(
            q_einsum, leaves, dq3, retain_graph=True),
    }
    fwd_ops, bwd_ops, fwd_dense, bwd_dense = triple_ops(*inp["triple"])
    print("kernels 4-5 at N = %d: operations needed %.3e / %.3e, dense "
          "operations performed %.3e / %.3e (%.3f / %.3f ms at the float32 "
          "peak)" % (inp["triple"][0].shape[0], fwd_ops, bwd_ops, fwd_dense,
                     bwd_dense, fwd_dense / PEAK_FP32_FLOPS * 1e3,
                     bwd_dense / PEAK_FP32_FLOPS * 1e3))
    records = []
    for kern in KERNELS:
        kernel, plain = calls[kern.name]
        lib = library.get(kern.name)
        print("kernel %-17s device ms per call by stage: %s" % (
            kern.name, ", ".join("%s %.4f" % r
                                 for r in _stages_ms(kernel, device))))
        records.append({
            "name": kern.name, "route": "cuda", "source": kern.source,
            "replaces": kern.replaces, "launches": launches[kern.name],
            "max_abs_err": errors[kern.name],
            "ms": _time_ms(kernel, device),
            "plain_ms": _time_ms(plain, device, PLAIN_REPS, 1),
            "bound_ms": bounds[kern.name][0],
            "bound_by": bounds[kern.name][1],
            "library_ms": _time_ms(lib, device) if lib else None,
        })
        deadline.check("timing: %s" % kern.name)
    return records


def main() -> int:
    import os
    deadline = Deadline(BUDGET_S)
    os.environ["CHIP_SMOKE_EPOCH"] = repr(time.time())
    # the imports' objects out of every later collection, and fewer
    # collections until the children are joined (they inherit both)
    gc.collect()
    gc.freeze()
    gc.set_threshold(*GC_WINDOW_THRESHOLDS)
    # forked before anything here touches the card (the availability
    # check below initialises CUDA, which a forked child then cannot
    # use): the AMOEBA-PME phase, GK, HIPPO, the examples, the Drude,
    # RPMD and membrane paths and two gloo ranks of the water box, beside
    # the build and the kernel phases, which time no device work (the
    # AMOEBA phase past its relaxation while the script waits for it).
    # Without a card they fail, and are killed at exit.
    forked = (fork_helper(write_amoeba_pme),
              fork_helper(write_amoeba_gk, NICE),
              fork_helper(write_hippo, NICE), start_examples(),
              fork_helper(write_drude, NICE), fork_helper(write_rpmd, NICE),
              fork_helper(write_membrane, NICE), start_mesh_ranks())
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; none is "
                           "visible to torch")
    try:
        return _main(deadline, forked)
    except BaseException:
        print("seconds by phase before the failure: %s; %.1f s in all" % (
            ", ".join("%s %.1f" % lap for lap in deadline.laps),
            deadline.elapsed()))
        raise


def _main(deadline, forked) -> int:
    (amoeba, amoeba_gk, hippo, examples, drude, rpmd, membrane,
     mesh_ranks) = forked
    set_fp32_matmul_exact()
    device = torch.device("cuda", 0)
    info = phase_device(device)
    deadline.check("device")
    # the profiler's first session (phase_timing's stage breakdown) imports
    # torch._dynamo and what it pulls in, ~9 s of host work on the card's
    # machine: imported while nvcc and the kernel phases run, and done
    # before the first CUDA graph capture (the main path's), which another
    # thread's CUDA call could break
    warm = threading.Thread(target=importlib.import_module,
                            args=("torch._dynamo",))
    warm.start()
    phase_build(deadline)
    deadline.check("build")
    deadline.lap("device, build")
    inp = kernel_inputs(device, N_WATERS)
    errors = phase_kernels(device, inp, deadline)
    mesh_kernels = phase_mesh_kernels(device, inp, deadline)
    phase_gather_orders(device, inp, deadline)
    phase_triple_shapes(device, deadline)
    phase_triclinic(device, deadline=deadline)
    warm.join()
    deadline.lap("kernels, triclinic")
    print("script: %.1f s of its clock before the helpers' join, peak "
          "device memory reserved %.1f GB" % (
              since_start(), torch.cuda.max_memory_reserved(device) / 1e9))
    examples = phase_examples(device, deadline, examples)
    deadline.lap("examples")
    # host work while the AMOEBA helper prepares its peptide
    prebuild()
    deadline.lap("prebuild")
    amoeba_gk, gk_wait = join_helper(amoeba_gk, "amoeba gk")
    hippo, hippo_wait = join_helper(hippo, "hippo")
    # GK's memory is free: the AMOEBA helper goes on past its relaxation
    open(amoeba[1] + ".check", "w").close()
    # the collector's own thresholds for the phases that follow (their
    # Contexts' device memory is freed by collections), the objects alive
    # now (the helpers' results, the kernel inputs) out of them
    gc.set_threshold(*GC_THRESHOLDS)
    gc.collect()
    gc.freeze()
    deadline.lap("amoeba gk, hippo (%.1f s waited)" % (gk_wait
                                                        + hippo_wait))
    # beside the AMOEBA helper's float64 check and steps: the phases that
    # need no main path (their ms a step share the card with it)
    minimized = phase_minimize(device, deadline=deadline)
    if min(minimized["launches"].values()) <= 0:
        raise RuntimeError("a kernel of the minimizer path never launched: "
                           "%s" % minimized["launches"])
    deadline.lap("minimize")
    ewald = phase_ewald(device, deadline)
    deadline.lap("ewald")
    gbsa = phase_gbsa(device, deadline)
    deadline.lap("gbsa")
    customgb = phase_customgb(device, deadline)
    deadline.lap("customgb")
    tip4pew = phase_tip4pew(device, deadline)
    deadline.lap("tip4pew")
    mts_tip4pew = phase_mts_tip4pew(device, tip4pew, deadline)
    deadline.lap("mts tip4pew")
    del tip4pew["system"], tip4pew["final_state"]
    # the AMOEBA helper's timed replay with the card to itself
    open(amoeba[1] + ".timing", "w").close()
    amoeba, amoeba_wait = join_helper(amoeba, "amoeba pme")
    deadline.lap("amoeba pme (%.1f s waited)" % amoeba_wait)
    # host work beside the phases that follow (it uses no card): the app
    # bilayer's PDB, createSystem and gate, and more custom's CPU float64
    # references
    app_build = start_helper("write_app_build")
    xml_host = start_helper("write_serialization")
    for kern in KERNELS:
        kern.launches = 0
    result = phase_main_path(device, deadline=deadline)
    launches = {k.name: k.launches for k in MAIN_PATH_KERNELS}
    print("main path launches: %s" % json.dumps(launches))
    if min(launches.values()) <= 0:
        raise RuntimeError("a kernel of the main path never launched: %s"
                           % launches)
    for kern in (pallas_pme.FWD, pallas_pme.BWD):
        launches[kern.name] = minimized["launches"][kern.name]
    ns_day = result["ns_day"]
    deadline.lap("main path")
    phase_step_program(device, result, deadline)
    deadline.lap("step program")
    mesh_nccl = phase_mesh_nccl(device, result, deadline)
    deadline.lap("mesh nccl")
    npt_water = phase_npt_water(device, result, deadline)
    deadline.lap("npt water")
    rf_water = phase_rf_water(device, result, deadline)
    deadline.lap("rf water")
    droplets = phase_nonperiodic(device, result, deadline)
    deadline.lap("droplets")
    integrators = phase_integrators(device, result, deadline)
    deadline.lap("integrators")
    custom = phase_custom(device, result, deadline,
                          verlet_ms=integrators["verlet"]["ms_per_step"])
    deadline.lap("custom")
    nose_hoover = phase_nose_hoover(device, result, deadline)
    deadline.lap("nose-hoover")
    variable = phase_variable(device, result, deadline)
    deadline.lap("variable")
    compound = phase_compound(device, result, deadline)
    deadline.lap("compound")
    offsets = phase_offsets(device, result, deadline)
    deadline.lap("offsets")
    checkpoint = phase_checkpoint(device, offsets, deadline)
    deadline.lap("checkpoint")
    alchemical = phase_alchemical(device, result, deadline)
    deadline.lap("alchemical")
    while_draws = phase_while_draws(device, result, deadline)
    deadline.lap("while draws")
    (app_build, more_refs), app_wait = join_helper(
        app_build, "app bilayer: its build; more custom: its references")
    deadline.lap("host build (%.1f s waited)" % app_wait)
    more_custom = phase_more_custom(device, result, deadline,
                                    references=more_refs)
    deadline.lap("more custom")
    gromacs = phase_gromacs_water(device, result, deadline)
    deadline.lap("gromacs water")
    tempering = phase_tempering(device, gromacs, deadline)
    deadline.lap("tempering")
    del gromacs["simulation"]
    # the water box's Context stays for the last two phases, which follow
    # every host-bound phase: run before them, they slowed the minimizers
    # and eager loops after them by 10-20 % on an H100's host
    water = {"context": result["context"]}
    del result, offsets["context"]
    app_bilayer = phase_app_bilayer(device, deadline, built=app_build)
    deadline.lap("app bilayer")
    # the later bilayer phases take the ForceField's System, which the app
    # phase has shown equal to models.popc_bilayer()'s
    bilayer = phase_bilayer(device, deadline, bilayer=(
        app_bilayer["system"], app_bilayer["positions"]))
    bilayer_ns_day = bilayer["ns_day"]
    deadline.lap("bilayer")
    mts = phase_mts_bilayer(device, bilayer, deadline)
    deadline.lap("mts")
    amd = phase_amd_bilayer(device, bilayer, deadline)
    deadline.lap("amd")
    ljpme = phase_ljpme_bilayer(device, bilayer, deadline)
    deadline.lap("ljpme bilayer")
    custom_bilayer = phase_custom_bilayer(device, bilayer, deadline)
    deadline.lap("custom bilayer")
    rmsd_cv = phase_rmsd_cv(device, bilayer, deadline)
    deadline.lap("rmsd cv")
    last = bilayer["context"].getState(getPositions=True)
    tables = phase_tables(device, in_md(last.getPositions(asNumpy=True)),
                          in_md(last.getPeriodicBoxVectors(
                              asNumpy=True)), deadline)
    deadline.lap("tables")
    npt = phase_npt_bilayer(device, bilayer, deadline)
    deadline.lap("npt bilayer")
    rf_bilayer = phase_rf_bilayer(device, bilayer["minimized_positions"],
                                  deadline, bilayer=(
                                      app_bilayer.pop("reference"), None))
    deadline.lap("rf bilayer")
    bilayer_ms = bilayer["graph"]["wall_ms_per_step"]
    del bilayer, npt["context"], npt["step"]
    drude, drude_wait = join_helper(drude, "drude")
    rpmd, rpmd_wait = join_helper(rpmd, "rpmd")
    membrane, membrane_wait = join_helper(membrane, "modeller membrane")
    deadline.lap("drude, rpmd, modeller membrane (%.1f s waited)" % (
        drude_wait + rpmd_wait + membrane_wait))
    xml_host, xml_wait = join_helper(xml_host, "the bilayer's XML round trip")
    serialization = phase_serialization(device, water, deadline,
                                        host=xml_host)
    deadline.lap("serialization (%.1f s waited)" % xml_wait)
    cv_nonbonded = phase_cv_nonbonded(device, water, deadline)
    del water
    deadline.lap("cv nonbonded")
    mesh_ranks = phase_mesh_ranks(mesh_ranks, deadline)
    deadline.lap("mesh ranks (%.1f s waited)" % mesh_ranks["wait_s"])
    counts = tile_counts(inp)
    records = phase_timing(device, inp, counts, launches, errors, deadline)
    records.append(rf_water["record"])
    records += ljpme["records"]
    records.append(alchemical["deriv_record"])
    # kernels 4-5 at the AMOEBA shapes, timed here alone on the card
    tri = amoeba["kernel_inputs"]
    records += amoeba_kernel_records(
        device, dict(tri, fwd=[t.to(device) for t in tri["fwd"]],
                     bwd=[t.to(device) for t in tri["bwd"]]),
        amoeba["launches"], amoeba["kernel_errors"])
    # each kernel's launches on the Drude and RPMD paths, each path's counts
    # from 0 (the main path's stay in "launches")
    for record in records[:len(KERNELS)]:
        record["launches_new_paths"] = {
            "drude_" + path: counts.get(record["name"], 0)
            for path, counts in drude["launches"].items()}
        record["launches_new_paths"].update({
            path: counts.get(record["name"], 0)
            for path, counts in rpmd["launches"].items()})
        for path, done in (("xml_round_trip", serialization["launches"]),
                           ("cv_nonbonded", cv_nonbonded["launches"]),
                           ("mesh_nccl", mesh_nccl["launches"])):
            record["launches_new_paths"][path] = done.get(record["name"], 0)
    # kernel 1 on a mesh: its row ranges' bits, a half range's time
    # against the whole launch, each gloo rank's launches
    records[0]["mesh"] = dict(mesh_kernels,
                              launches_mesh_ranks=mesh_ranks["launches"])
    records[0]["launches_new_paths"]["mesh_ranks"] = sum(
        mesh_ranks["launches"])
    deadline.lap("timing")
    print("main path: %.2f ns/day on %s (%s), %d steps of %.3f ps, "
          "through the step program (gating %s)" % (
              ns_day, info["name"], info["smi"], PRODUCTION_STEPS, DT_PS,
              step_program.GATING))
    print("bilayer: %.2f ns/day on %s (%s), %d atoms, %d steps of %.3f ps "
          "through the step program" % (
              bilayer_ns_day, info["name"], info["smi"],
              rf_bilayer["atoms"], BILAYER_PRODUCTION, DT_PS))
    print("npt bilayer: %.2f ns/day (NVT %.2f); in turns %.4f ms a step "
          "(NVT %.4f) on %s (%s), %d attempts, %d accepted, volume x %.6f; "
          "npt water %.2f ns/day, aniso %.2f ns/day" % (
              npt["ns_day"], bilayer_ns_day, npt["turns"]["npt_ms"],
              npt["turns"]["nvt_ms"], info["name"], info["smi"],
              npt["attempts"], npt["accepted"], npt["volume"],
              npt_water[0]["ns_day"], npt_water[1]["ns_day"]))
    print("rf (CutoffPeriodic %.1f nm, reaction field): water %.2f ns/day "
          "(PME %.2f), bilayer %.2f ns/day (PME %.2f) on %s (%s); kernel 1 "
          "in MODE_RF at %d atoms %.4f ms a call (bound %.5f ms), MODE_EWALD "
          "at 0.9 nm %.4f ms" % (
              RF_CUTOFF, rf_water["ns_day"], ns_day, rf_bilayer["ns_day"],
              bilayer_ns_day, info["name"], info["smi"], rf_water["atoms"],
              rf_water["record"]["ms"], rf_water["record"]["bound_ms"],
              records[0]["ms"]))
    print("other methods on %s (%s): %s" % (
        info["name"], info["smi"], "; ".join(
            "%s %d atoms %.4f ms a step (eager %.4f), force error %.3e" % (
                r["label"], r["atoms"], r["ms_per_step"],
                r["eager"]["wall_ms_per_step"], r["force_err"])
            for r in droplets + [ewald])))
    print("gbsa (%d-atom POPC cluster, OBC at CutoffNonPeriodic 2.0 nm) on "
          "%s (%s): %.2f ns/day, %.4f ms a step (eager %.4f); GB's analytic "
          "sweeps %.4f ms a call; median force error %.3e" % (
              gbsa["atoms"], info["name"], info["smi"], gbsa["ns_day"],
              gbsa["ms_per_step"], gbsa["eager_ms_per_step"],
              gbsa["sweeps_ms"], gbsa["force_err"]))
    print("integrators on the %d-atom water box on %s (%s): %s; NVE drift "
          "%.4e kT/dof/ns; Andersen mean T %.2f K" % (
              3 * N_WATERS, info["name"], info["smi"], "; ".join(
                  "%s %.2f ns/day (%.4f ms a step, eager %.4f)" % (
                      k, r["ns_day"], r["ms_per_step"],
                      r["eager_ms_per_step"])
                  for k, r in integrators.items()),
              integrators["verlet"]["drift"],
              integrators["andersen"]["mean_temperature"]))
    print("custom and stateful integrators on the %d-atom water box on %s "
          "(%s): custom Verlet %.2f ns/day (%.4f ms a step, built-in Verlet "
          "%.4f), drift %.4e kT/dof/ns; Nose-Hoover %.2f ns/day (%.4f ms), "
          "drift %.4e (the chains' share %.4e), mean T %.2f K; variable "
          "Langevin %.2f ns/day (%.4f ms, mean dt %.6f ps), variable Verlet "
          "%.2f ns/day (%.4f ms, mean dt %.6f ps); compound %.4f and %.4f ms "
          "a step, captures %s" % (
              3 * N_WATERS, info["name"], info["smi"], custom["ns_day"],
              custom["ms_per_step"], integrators["verlet"]["ms_per_step"],
              custom["drift"], nose_hoover["ns_day"],
              nose_hoover["ms_per_step"], nose_hoover["drift"],
              nose_hoover["thermostat"],
              nose_hoover["mean_temperature"],
              variable["variable langevin"]["ns_day"],
              variable["variable langevin"]["ms_per_step"],
              variable["variable langevin"]["mean_dt"],
              variable["variable verlet"]["ns_day"],
              variable["variable verlet"]["ms_per_step"],
              variable["variable verlet"]["mean_dt"], compound["ms"][0],
              compound["ms"][1], compound["captures"]))
    print("bilayer MTS and aMD on %s (%s): MTSLangevin %.2f ns/day (%.4f ms "
          "a step, LangevinMiddle %.4f), kernel 1 %d launches in %d steps; "
          "AMDForceGroup %.2f ns/day (%.4f ms a step), effective %.2f vs "
          "%.2f kJ/mol" % (
              info["name"], info["smi"], mts["ns_day"], mts["ms_per_step"],
              bilayer_ms, mts["tiles"], MTS_STEPS, amd["ns_day"],
              amd["ms_per_step"], amd["effective"], amd["total"]))
    print("ljpme bilayer (LJPME 0.9 nm) on %s (%s): %.2f ns/day, %.4f ms "
          "a step (PME %.4f); median force error %.3e; kernel 1 MODE_LJPME "
          "%.4f ms a call (bound %.5f), dispersion spread %.4f, gather "
          "%.4f ms" % (
              info["name"], info["smi"], ljpme["ns_day"],
              ljpme["ms_per_step"], bilayer_ms, ljpme["force_err"],
              ljpme["records"][0]["ms"], ljpme["records"][0]["bound_ms"],
              ljpme["records"][1]["ms"], ljpme["records"][2]["ms"]))
    print("tip4pew water (%d particles, PME 0.9 nm) on %s (%s): %.2f "
          "ns/day, %.4f ms a step (eager %.4f); force error %.3e; site "
          "error %.3e nm; MTS (4 fs, reciprocal space slow) %.2f ns/day, "
          "%.4f ms a step, launches %s" % (
              4 * TIP4PEW_WATERS, info["name"], info["smi"],
              tip4pew["ns_day"], tip4pew["ms_per_step"],
              tip4pew["eager"]["wall_ms_per_step"], tip4pew["force_err"],
              tip4pew["site_err"], mts_tip4pew["ns_day"],
              mts_tip4pew["ms_per_step"],
              json.dumps(mts_tip4pew["launches"])))
    print("offsets and checkpoints on the water box: %s; update %.6f vs a "
          "fresh Context %.6f kJ/mol; %.2f ns/day with offsets (%.4f ms a "
          "step); checkpoint %.1f MB" % (
              "; ".join("lambda %.2f %.6f (float64 %.6f; less the "
                        "dispersion correction %.6f, built in %.6f)" % r
                        for r in offsets["rows"]), *offsets["update"],
              offsets["ns_day"], offsets["ms_per_step"],
              checkpoint["bytes"] / 1e6))
    print("custom forces on %s (%s): alchemical water box %.4f ms a step "
          "at (lambda_sterics, lambda_electrostatics) %s (offsets alone "
          "%.4f ms), dE/dlambda against "
          "central differences %s; custom-twin bilayer %.4f ms a step "
          "(standard forces %.4f ms), twins' errors %s; tables on the card "
          "against the CPU %.3e %.3e; while-block draws' mean %.4f" % (
              info["name"], info["smi"], alchemical["ms_per_step"][-1],
              list(ALCHEMICAL_LAMBDAS), offsets["ms_per_step"],
              " ".join("%.2e" % (abs(r["d32"] - r["fd"]) / abs(r["fd"]))
                       for r in alchemical["rows"]),
              custom_bilayer["ms_per_step"], bilayer_ms, " ".join(
                  "%s %.2e" % (k, max(e))
                  for k, e in custom_bilayer["errors"].items()),
              *tables["errors"], while_draws["mean"]))
    print("GB recipes, RMSD restraint, offsets' derivative, dense custom "
          "forces on %s (%s): GBn2 cluster (%d atoms) %.4f ms a step (%.2f "
          "ns/day), GB's sweeps %s ms; RMSD-restrained bilayer %.4f ms a "
          "step (plain %.4f in the same turns); dE/dlambda_electrostatics "
          "reading %s ms, kernel 1's derivative instantiation %.4f ms; %s" % (
              info["name"], info["smi"], customgb["atoms"],
              customgb["ms_per_step"], customgb["ns_day"],
              customgb["sweeps_ms"], rmsd_cv["ms"]["cv"],
              rmsd_cv["ms"]["plain"], " ".join(
                  "%.3f" % m for m in alchemical["read_ms"]),
              alchemical["deriv_record"]["ms"], "; ".join(
                  "%s %.4f ms a step (ef %s ms)" % (
                      k, r["ms_per_step"], r["ef_ms"])
                  for k, r in more_custom.items())))
    print("app bilayer (%d atoms: PDBFile, ForceField.createSystem, "
          "Simulation) on %s (%s): createSystem %.2f s on the host; %.4f ms "
          "a step through Simulation with its reporters, %.4f through the "
          "plain models.popc_bilayer() Context in the same turns" % (
              rf_bilayer["atoms"], info["name"], info["smi"],
              app_bilayer["create_s"], app_bilayer["ms"]["simulation"],
              app_bilayer["ms"]["plain"]))
    print("app layer remainder on %s (%s): helix in POPC through Modeller "
          "%d atoms (%d lipids, %d Na+, %d Cl-), addHydrogens %.2f s, "
          "addMembrane %.2f s (relaxation captures %d, rebuilds %d), "
          "createSystem %.2f s on the host; %.4f ms a step with a "
          "StateDataReporter and a PDBxReporter, Metadynamics %.2f ms a "
          "deposition; GROMACS water createSystem %.2f s, "
          "%.4f ms a step; tempering rungs %s, new captures %d; examples "
          "%.2f s" % (
              info["name"], info["smi"], membrane["atoms"],
              membrane["lipids"], *membrane["ions"], membrane["hydrogens_s"],
              membrane["membrane_s"], membrane["captures"],
              membrane["rebuilds"], membrane["create_s"],
              membrane["ms_per_step"], membrane["per_deposit_ms"],
              gromacs["create_s"], gromacs["ms_per_step"],
              tempering["visited"], tempering["captures"],
              examples["seconds"]))
    print("AMOEBA on %s (%s): PME peptide in water (%d atoms, "
          "amoeba2013.json, PME 0.7 nm, vdW 0.9 nm, mutual, MTSLangevin 2 "
          "fs [(0, 2), (1, 1)]) createSystem %.2f s on the host, %.4f ms a "
          "step (eager %.4f), %.3f ns/day, kernels 4-5 %.1f and %.1f "
          "launches a step, SCF residual %.3e, peak device memory %.2f GB, "
          "median force error %.3e; GK (%d atoms) %.4f ms a step through "
          "the eager loop, peak %.2f GB, force error %.3e; HIPPO (%d atoms) "
          "%.4f ms a step, force error %.3e" % (
              info["name"], info["smi"], amoeba["atoms"], amoeba["create_s"],
              amoeba["ms_per_step"], amoeba["eager_ms"], amoeba["ns_day"],
              amoeba["launches"][pallas_pme.FWD.name] / amoeba["steps"],
              amoeba["launches"][pallas_pme.BWD.name] / amoeba["steps"],
              amoeba["residual"], amoeba["peak_bytes"] / 1e9,
              amoeba["check"]["force_err"], amoeba_gk["atoms"],
              amoeba_gk["ms_per_step"], amoeba_gk["peak_bytes"] / 1e9,
              amoeba_gk["check"]["force_err"],
              hippo["atoms"], hippo["ms_per_step"],
              hippo["check"]["force_err"]))
    print("drude on %s (%s): SWM4-NDP box %d particles (%d waters), "
          "DrudeLangevin %.4f ms a step, %.3f ns/day, T %.2f K, Drude T "
          "%.3f K, median force error %.3e; SCF %.4f ms a step (the Drudes' "
          "largest force %.3e kJ/mol/nm), Nose-Hoover %.4f ms a step; rpmd "
          "%d waters x %d copies %.4f ms a step (eager %.4f), %.4f ns/day, "
          "kernel 1 %.1f launches a step, centroid T %.2f K, radius of "
          "gyration H %.5f O %.5f nm; NPT %.4f ms a step, %d accepted" % (
              info["name"], info["smi"], drude["atoms"], drude["waters"],
              drude["ms_per_step"], drude["ns_day"], drude["t_com"],
              drude["t_rel"], drude["check"]["force_err"],
              drude["side"]["scf"]["ms_per_step"],
              drude["side"]["scf"]["residual"],
              drude["side"]["nose-hoover"]["ms_per_step"], rpmd["waters"],
              rpmd["copies"], rpmd["ms_per_step"], rpmd["eager_ms"],
              rpmd["ns_day"], rpmd["tiles_per_step"], rpmd["t_centroid"],
              *rpmd["rg"], rpmd["npt_ms"], rpmd["accepted"]))
    print("serialization and a periodic CV on %s (%s): water box XML %d "
          "bytes written in %.3f s, Simulation from XML %.3f s, the "
          "original Context's bits; bilayer XML %d bytes, %.3f s written, "
          "%.3f s read; CustomCVForce over PME %.4f ms a step (plain "
          "%.4f), %d rebuilds in %d steps, energy %.3e and median force "
          "%.3e off the plain force" % (
              info["name"], info["smi"], serialization["bytes"],
              serialization["seconds"]["serialize"],
              serialization["seconds"]["simulation"],
              xml_host["system"]["bytes"], xml_host["system"]["serialize_s"],
              xml_host["system"]["deserialize_s"], cv_nonbonded["ms"]["cv"],
              cv_nonbonded["ms"]["plain"], cv_nonbonded["rebuilds"],
              CV_STEPS, cv_nonbonded["e_err"], cv_nonbonded["force_err"]))
    print("mesh on %s (%s): kernel 1's row ranges of %s ranks the whole "
          "launch's bits in %d instantiations, a half %.4f / %.4f ms against "
          "the whole %.4f ms; one-rank NCCL mesh %.4f ms a step (plain "
          "%.4f) with the gather captured; %d gloo ranks sharing the card "
          "%s ms a step through the eager loop (single process %.4f)" % (
              info["name"], info["smi"], mesh_kernels["sizes"],
              len(mesh_kernels["instantiations"]), *mesh_kernels["half_ms"],
              mesh_kernels["whole_ms"], mesh_nccl["ms"]["mesh"],
              mesh_nccl["ms"]["plain"], mesh_ranks["ranks"], " ".join(
                  "%.4f" % m for m in mesh_ranks["ms_per_step"]),
              mesh_ranks["single_ms_per_step"]))
    print("seconds by phase: %s" % ", ".join(
        "%s %.1f" % lap for lap in deadline.laps))
    print("total %.1f s of the %.0f s budget" % (deadline.elapsed(),
                                                 BUDGET_S))
    print(tile_sweep_line(inp, counts))
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["name"], "count": info["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
