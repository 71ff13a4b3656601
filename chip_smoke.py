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
  kernels are built with one nvcc a source, all at once, and one link.

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

import importlib
import io
import json
import math
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

import openmm_tpu_torch as omm
from openmm_tpu_torch import _build
from openmm_tpu_torch import step_program
from openmm_tpu_torch.context import MAX_ESCALATIONS, STEP_CHUNK
from openmm_tpu_torch.forces.nonbonded import NonbondedModule
from openmm_tpu_torch.models import (alchemical_water_box, builders,
                                     popc_bilayer, popc_obc_cluster,
                                     tip3p_water_box, tip4pew_water_box,
                                     water_droplet)
from openmm_tpu_torch.models.builders import (ALCHEMICAL_GROUPS,
                                              TWIN_GROUPS,
                                              TWIN_INTEGRATION_GROUPS,
                                              custom_twins)
from openmm_tpu_torch.ops import geometry as geom
from openmm_tpu_torch.ops import pallas_pme, pme_zslab, tile_pairs
from openmm_tpu_torch.ops import pme as pme_mod
from openmm_tpu_torch.platform import set_fp32_matmul_exact
from openmm_tpu_torch.profile_step import custom_verlet

BUDGET_S = 180.0
N_WATERS = 8000
# lattice-start relaxation: (step size ps, friction 1/ps, steps); bench.py
# uses 6,000 steps, which this smoke test cannot afford
RELAX = ((0.0005, 50.0, 300), (0.001, 20.0, 200))
DT_PS = 0.002
FRICTION = 1.0
PRODUCTION_STEPS = 200
ENERGY_EVERY = 50
# the step program against the eager loop: steps taken one a call (to
# find the steps that rebuild), steps from a capacity scale too small for
# the box (to force an escalation), and steps of a float64 Context
REBUILD_STEPS = 60
ESCALATION_SCALE = 0.5
ESCALATION_STEPS = 20
DOUBLE_WATERS = 512
DOUBLE_STEPS = 10
# float64 positions of the float64 Context after DOUBLE_STEPS steps, graph
# against eager: its plain PME spread adds in float64 atomics, whose order
# changes from run to run (each step's rounding, ~1e-16 relative, grown
# over the steps)
DOUBLE_POS_TOL = 1e-9
FORCE_ERR_BAR = 1e-5
# minimization: LocalEnergyMinimizer calls of MINIMIZE_ITERATIONS
# iterations each (per penalty stage), the deadline checked between calls
MINIMIZE_CALLS = 1
MINIMIZE_ITERATIONS = 10
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
BILAYER_MINIMIZE_ITERATIONS = 8
GROUP_ENERGY_BAR = 1e-5
CONSTRAINT_ERR_BAR = 1e-5
# the app layer's path: the POPC patch through PDBFile, ForceField and
# Simulation (phase_app_bilayer), with bench.py's settings
APP_FORCEFIELD = ("amber14-lipid.json", "amber14-tip3p.json")
APP_CUTOFF = 0.9                # nm
APP_TEMPERATURE = 300.0         # K
APP_T_BAND = 15.0               # K about APP_TEMPERATURE at the last report
APP_MINIMIZE_ITERATIONS = 5
APP_STEPS = 200
APP_REPORT_EVERY = 50
APP_ENERGY_BAR = 1e-6           # relative, the two Systems' energies
APP_FORCE_BAR = 1e-6            # the median relative force difference
APP_BOX_BAR = 5e-5              # nm, half the PDB's 0.001 A
APP_TURN_STEPS = 50
APP_TURNS = ("simulation", "plain", "plain", "simulation")
# constant pressure: the barostats' settings (bar, bar nm, K), steps and
# bars; the NPT phases read and print the box after every call of
# NPT_FREQUENCY steps, one attempt a call on the bilayer and the water box
NPT_PRESSURE = 1.0
NPT_TENSION = 0.0
NPT_FREQUENCY = 25
NPT_BILAYER_STEPS = 300
NPT_BILAYER_REPLAY = 25
NPT_WATER_STEPS = 200
NPT_WATER_REPLAY = 50
ANISO_FREQUENCY = 5
ANISO_STEPS = 100
NPT_VOLUME_BAR = 0.03       # |V / V0 - 1| after the run
# the bilayer's NVT and NPT step programs timed in turns, in one call each
# of NPT_TURN_STEPS steps (4 attempts), in the order NPT_TURNS, with the
# card's SM clock and power read before and after
NPT_TURN_STEPS = 50
NPT_TURNS = ("nvt", "npt", "npt", "nvt")
# the other NonbondedForce methods: the reference suite's rf settings
# (tools/bench_suite.py, dhfr_rf: CutoffPeriodic, 1.0 nm) on the relaxed
# water box and the minimized bilayer, steps in all and replayed through
# the eager loop; a droplet of the relaxed box (radius nm) at NoCutoff and
# CutoffNonPeriodic (cutoff nm; dhfr_gbsa's), and a small Ewald box
RF_CUTOFF = 1.0
RF_STEPS = 200
RF_REPLAY = 15
DROPLET_RADIUS = 2.5
DROPLET_CUTOFF = 2.0
DROPLET_STEPS = 40
DROPLET_REPLAY = 30
EWALD_WATERS = 512
EWALD_STEPS = 60
EWALD_REPLAY = 50
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
GBSA_MINIMIZE_ITERATIONS = 10
GBSA_STEPS = 100
GBSA_RELAX_FRICTION = 10.0
GBSA_REPLAY = 25
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
VERLET_STEPS = 1200
DRIFT_EVERY = 100
DRIFT_GATE = 0.2
ANDERSEN_TEMPERATURE = 300.0
ANDERSEN_FREQUENCY = 10.0
ANDERSEN_START = 250.0
ANDERSEN_STEPS = 500
ANDERSEN_EVERY = 25
ANDERSEN_T_RANGE = (270.0, 330.0)
LANGEVIN_STEPS = 200
BROWNIAN_DT = 0.0005
BROWNIAN_FRICTION = 100.0
BROWNIAN_STEPS = 100
INTEGRATOR_REPLAY = 15
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
VARIABLE_STEPS = 500
VARIABLE_ENERGY_BAR = 0.02      # |E1 / E0 - 1| under VariableVerlet
COMPOUND_STEPS = 100
COMPOUND_SWITCHES = 3
MTS_GROUPS = ((0, 1), (1, 2))
MTS_STEPS = 300
AMD_DT = 0.001
AMD_STEPS = 200
AMD_EVERY = 25
AMD_FRACTION = 0.2
BILAYER_T_RANGE = (250.0, 360.0)
# PR 15: the bilayer at LJPME (from the bilayer phase's minimized state;
# the NonbondedForce's reciprocal space in a group of its own for the
# energies by group), the TIP4P-Ew box relaxed from its lattice, then under
# MTS with the reciprocal space slow; parameter offsets and
# updateParametersInContext on the relaxed water box; checkpoints
LJPME_RECIP_GROUP = 5
LJPME_STEPS = 100
LJPME_REPLAY = 15
LJPME_MINIMIZE_ITERATIONS = 5
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
TIP4PEW_REPLAY = 25
SITE_BAR = 1e-6                 # nm: a site from its weighted parents
MTS_TIP4PEW_DT = 0.004
MTS_TIP4PEW_GROUPS = ((1, 1), (0, 2))
MTS_TIP4PEW_STEPS = 100
MTS_T_RANGE = (250.0, 360.0)
OFFSET_WATERS = 64
OFFSET_LAMBDAS = (1.0, 0.5, 0.0)
OFFSET_CHUNK = 50
OFFSET_BUILT_IN_BAR = 1e-6      # relative, against the parameters built in
CHECKPOINT_STEPS = 100
# the alchemical water box (models.alchemical_water_box), the custom twins
# of the bilayer's bonded forces, the tables, the draws inside a while block
ALCHEMICAL_SOLUTE = 64
# (lambda_sterics, lambda_electrostatics) in turn: the solute's charges
# are off wherever its sterics are softened (its oxygens would fuse with
# the solvent's hydrogens otherwise), as an alchemical protocol takes them
ALCHEMICAL_LAMBDAS = ((1.0, 1.0), (0.5, 0.0), (0.2, 0.0))
ALCHEMICAL_CHUNK = 30           # steps at each lambda
ALCHEMICAL_REPLAY = 20
ALCHEMICAL_MINIMIZE_ITERATIONS = 10
ALCHEMICAL_T_RANGE = (200.0, 450.0)
ALCHEMICAL_H = 1e-4             # the central difference's step in lambda
ALCHEMICAL_DERIV_BAR = 1e-4     # relative, dE/dlambda against it
TWIN_BAR = 1e-10                # float64 twins against the standard forces
TWIN_STEPS = 50
TWIN_REPLAY = 10
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
GB_REPLAY = 10
GB_MINIMIZE_ITERATIONS = 10
# the OBC2 recipe against GBSAOBCForce, float64, relative: the recipe's
# Coulomb constant 138.935485 against the port's 138.9354576 (2.0e-7)
RECIPE_BAR = 1e-6
GB_T_RANGE = (250.0, 360.0)
RMSD_K = 2000.0                 # kJ/mol/nm^2
RMSD_STEER = 0.01               # nm that r0 rises between chunks
RMSD_CHUNK = 50
RMSD_CHUNKS = 2
RMSD_REPLAY = 10
RMSD_TURN_STEPS = 50
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
ARGON_STEPS = 100               # its 2.76M triples cost 12 ms a step
MORE_EVERY = 25
MORE_REPLAY = 10
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


def water_box(n_waters, sheared=False):
    """(system, positions) of the TIP3P box, its box sheared by SHEAR into a
    reduced triclinic one when `sheared`."""
    system, pos = tip3p_water_box(n_waters)
    if sheared:
        box = np.asarray(system.getDefaultPeriodicBoxVectors())
        system.setDefaultPeriodicBoxVectors(
            *(box + box[0, 0] * np.asarray(SHEAR)))
    return system, pos


def kernel_inputs(device, n_waters, sheared=False, system=None,
                  positions=None) -> dict:
    """Inputs of the kernels at the shapes of their paths, from the water
    box's starting positions (its box sheared when `sheared`), or from
    `system` at `positions`: kernel 1 as the path calls it (in the mode of
    the System's NonbondedForce) and, for PME, kernels 2-3 as the main
    path calls them (kernel 3 visiting the atoms in the candidate state's
    order) and kernels 4-5 on the dense weight planes of those positions
    (N unpadded) with a seeded cotangent dQ. The capacity grows, as a
    Context grows it, until the candidate state holds every pair."""
    if system is None:
        system, positions = water_box(n_waters, sheared)
    pos = positions
    box = torch.as_tensor(system.getDefaultPeriodicBoxVectors(),
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
    inp = {
        "tiles": (tile_pairs.sorted_positions(posf, box, st), st["par4"],
                  st["cand"], st["count"], st["words"],
                  tile_pairs.tile_consts(box, module.tile_scalars)),
        "pos": posf.contiguous(), "charge": module.charge,
        "module": module, "box": box,
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
    calls = {"nonbonded_tiles": (
        lambda: tile_pairs.nonbonded_tiles(*t, m.mode, m.use_switch),
        lambda: tile_pairs.nonbonded_tiles_plain(*t, m.mode, m.use_switch))}
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
    force_err = _median_relative_error(st.getForces(), ref.getForces())
    print("triclinic box %s (capacity scale %.2f): median force error vs "
          "float64 plain path %.3e (bar %.0e); energy %.6f vs %.6f kJ/mol" % (
              np.array2string(np.asarray(system.getDefaultPeriodicBoxVectors()),
                              precision=4, separator=",").replace("\n", ""),
              scale, force_err, FORCE_ERR_BAR, st.getPotentialEnergy(),
              ref.getPotentialEnergy()))
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

    start = ctx._snapshot()
    run = _production(device, ctx, integ.step, st.getPotentialEnergy(),
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
    clock0 = ctx.getTime()
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
        simulated = ctx.getTime() - clock0
        energies.append(read(ctx) if read else
                        ctx.getState(getEnergy=True).getPotentialEnergy())
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
            "clock": ctx.getTime(),
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
        final[path] = ctx64.getState(getPositions=True).getPositions()
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
    cons = [system.getConstraintParameters(i)
            for i in range(system.getNumConstraints())]
    p1, p2, d = (np.asarray(c) for c in zip(*cons))
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
    before = ctx.getState(getEnergy=True).getPotentialEnergy()
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
    after, x = st.getPotentialEnergy(), st.getPositions()
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
    box = torch.as_tensor(system.getDefaultPeriodicBoxVectors(),
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
          % (n, np.array2string(np.diag(system.getDefaultPeriodicBoxVectors()),
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
    force_err = _median_relative_error(st.getForces(), ref.getForces())
    for g in groups:
        pair = [c.getState(getEnergy=True, groups={g}).getPotentialEnergy()
                for c in (ctx, oracle)]
        energies[g] = (*pair, abs(pair[0] - pair[1]) / max(abs(pair[1]),
                                                          1e-300))
    del oracle
    print("bilayer: median force error vs float64 plain path %.3e (bar "
          "%.0e); energy %.6f vs %.6f kJ/mol; by group (float32, float64, "
          "relative error; bar %.0e): %s" % (
              force_err, FORCE_ERR_BAR, st.getPotentialEnergy(),
              ref.getPotentialEnergy(), GROUP_ENERGY_BAR,
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
    before = ctx.getState(getEnergy=True).getPotentialEnergy()
    reporter = _Iterations()
    _sync(device)
    t0 = time.perf_counter()
    omm.LocalEnergyMinimizer.minimize(ctx, MINIMIZE_TOLERANCE,
                                      minimize_iterations, reporter)
    _sync(device)
    minimize_s = time.perf_counter() - t0
    st = ctx.getState(getEnergy=True, getPositions=True)
    after = st.getPotentialEnergy()
    minimized = st.getPositions()
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
                        ctx.getState(getEnergy=True).getPotentialEnergy(),
                        production, energy_every, deadline)
    temperature = ctx.temperature()
    x = ctx.getState(getPositions=True).getPositions()
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


def phase_app_bilayer(device, deadline=None, patch=None, reference=None,
                      steps=APP_STEPS, report_every=APP_REPORT_EVERY,
                      minimize_iterations=APP_MINIMIZE_ITERATIONS,
                      turn_steps=APP_TURN_STEPS, turns=APP_TURNS,
                      t_band=APP_T_BAND,
                      minimize_tolerance=MINIMIZE_TOLERANCE) -> dict:
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
    the reference System for the later bilayer phases."""
    import os
    import tempfile

    from openmm_tpu_torch import app
    from openmm_tpu_torch import unit as u
    from openmm_tpu_torch.app.modeller import _load_membrane_patch

    deadline = deadline or Deadline(math.inf)
    platform = (None if device.type == "cuda"
                else omm.Platform.getPlatformByName("CPU"))
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
        reordered = gate_same_system(system, ref_system)
        n = system.getNumParticles()
        print("app bilayer: %d atoms; PDBFile write and read %.2f s, "
              "ForceField(%s).createSystem %.2f s on the host; the System "
              "equals models.popc_bilayer()'s, the term lists %s in "
              "another order" % (n, pdb_s, ", ".join(APP_FORCEFIELD),
                                 create_s, reordered or "none"))
        deadline.check("app bilayer: createSystem")

        pdb_pos = np.asarray(pdb.getPositions(asNumpy=True).value_in_unit(
            u.nanometer), np.float64)
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
        e_rel = abs(got.getPotentialEnergy() - want.getPotentialEnergy()) \
            / abs(want.getPotentialEnergy())
        f_err = _median_relative_error(got.getForces(), want.getForces())
        print("app bilayer: at the PDB's positions energy %.6f vs %.6f "
              "kJ/mol (relative %.3e, bar %.0e), median relative force "
              "difference %.3e (bar %.0e)" % (
                  got.getPotentialEnergy(), want.getPotentialEnergy(),
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
        final = sim.context.getState(getPositions=True,
                                     enforcePeriodicBox=True).getPositions()
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
    box0 = ctx.getState().getPeriodicBoxVectors()
    for kern in KERNELS:
        kern.launches = 0
    energy = ctx.getState(getEnergy=True).getPotentialEnergy()
    lead = _production(device, ctx, integ.step, energy, steps - replay,
                       every, deadline) if steps > replay else None
    start = ctx._snapshot()
    graph = _production(device, ctx, integ.step,
                        lead["energies"][-1] if lead else energy, replay,
                        every, deadline)
    launches = {k.name: k.launches for k in MAIN_PATH_KERNELS}
    rebuilds, escalations = ctx.rebuild_count, ctx.escalation_count
    st = ctx.getState(getPositions=True, getForces=True)
    x, box = st.getPositions(), st.getPeriodicBoxVectors()
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
        st.getForces(), oracle.getState(getForces=True).getForces())
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
                  ctx._nonbonded.capacity_scale)
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
    n_waters = st.getPositions().shape[0] // 3
    runs = []
    for label, barostat, n, m in (
            ("npt water", omm.MonteCarloBarostat(NPT_PRESSURE, 300.0,
                                                 frequency), steps, replay),
            ("npt water aniso", omm.MonteCarloAnisotropicBarostat(
                (NPT_PRESSURE,) * 3, 300.0, True, True, True,
                aniso_frequency), aniso_steps, aniso_steps)):
        system, _ = tip3p_water_box(n_waters)
        runs.append(phase_npt(device, label, system, st.getPositions(),
                              barostat, 300.0, n, m, (200.0, 450.0),
                              deadline, velocities=st.getVelocities()))
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
    force_err = _median_relative_error(st.getForces(), ref.getForces())
    energies = {}
    for g in groups or ():
        pair = [c.getState(getEnergy=True, groups={g}).getPotentialEnergy()
                for c in (ctx, oracle)]
        energies[g] = (*pair, abs(pair[0] - pair[1]) / max(abs(pair[1]),
                                                          1e-300))
    del oracle
    print("%s: %d atoms, %s; median force error vs float64 %.3e (bar "
          "%.0e); energy %.6f vs %.6f kJ/mol%s" % (
              label, n, "kernel 1 on the candidate state" if out["tiled"]
              else "every pair (no candidate state)", force_err,
              FORCE_ERR_BAR, st.getPotentialEnergy(),
              ref.getPotentialEnergy(),
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
        before = ctx.getState(getEnergy=True).getPotentialEnergy()
        reporter = _Iterations()
        t0 = time.perf_counter()
        omm.LocalEnergyMinimizer.minimize(ctx, MINIMIZE_TOLERANCE,
                                          minimize_iterations, reporter)
        _sync(device)
        after = ctx.getState(getEnergy=True).getPotentialEnergy()
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
    energy = ctx.getState(getEnergy=True).getPotentialEnergy()
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
    x = ctx.getState(getPositions=True).getPositions()
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
        st.getPositions().shape[0] // 3,
        nonbonded_method=omm.NonbondedForce.CutoffPeriodic, cutoff=RF_CUTOFF)
    return phase_method(device, "rf water", system, st.getPositions(), 300.0,
                        steps, replay, (200.0, 450.0), deadline,
                        velocities=st.getVelocities(),
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
    box = main["context"].getSystem().getDefaultPeriodicBoxVectors()
    runs = []
    for label, method in (("nocutoff droplet", omm.NonbondedForce.NoCutoff),
                          ("cutoffnonperiodic droplet",
                           omm.NonbondedForce.CutoffNonPeriodic)):
        system, pos = water_droplet(st.getPositions(), box, radius, method,
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


def phase_gbsa(device, deadline=None, lipids=19, steps=GBSA_STEPS,
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
    force_err = _median_relative_error(st.getForces(), ref.getForces())
    energies = {}
    for g in sorted(set(GBSA_GROUPS.values()) - {GBSA_GROUPS[
            "CMMotionRemover"]}):
        pair = [c.getState(getEnergy=True, groups={g}).getPotentialEnergy()
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
              force_err, FORCE_ERR_BAR, st.getPotentialEnergy(),
              ref.getPotentialEnergy(), GROUP_ENERGY_BAR,
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
    before = ctx.getState(getEnergy=True).getPotentialEnergy()
    reporter = _Iterations()
    _sync(device)
    t0 = time.perf_counter()
    omm.LocalEnergyMinimizer.minimize(ctx, MINIMIZE_TOLERANCE,
                                      minimize_iterations, reporter)
    _sync(device)
    minimize_s = time.perf_counter() - t0
    after = ctx.getState(getEnergy=True).getPotentialEnergy()
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
                        ctx.getState(getEnergy=True).getPotentialEnergy(),
                        replay, energy_every, deadline)
    temperature = ctx.temperature()
    constraint_err = _constraint_error(
        system, ctx.getState(getPositions=True).getPositions())
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
    return st.getPotentialEnergy() + st.getKineticEnergy()


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
    ctx.setPositions(state.getPositions())
    if temperature is None:
        ctx.setVelocities(state.getVelocities())
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
        system, ctx.getState(getPositions=True).getPositions())
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
    n_waters = state.getPositions().shape[0] // 3

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
        ENERGY_EVERY, lambda c: c.getState(
            getEnergy=True).getPotentialEnergy(), deadline, replay)
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
        brownian_steps // 2, lambda c: c.getState(
            getEnergy=True).getPotentialEnergy(), deadline, replay)
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
    system, _ = tip3p_water_box(state.getPositions().shape[0] // 3)
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
    forces = torch.as_tensor(st.getForces(), device=ctx._masses.device)
    v = ctx._state["velocities"] + (0.5 * dt) * forces \
        * ctx._inv_masses[:, None]
    kinetic = float(0.5 * torch.sum(ctx._masses[:, None] * v * v))
    return st.getPotentialEnergy() + kinetic + integ.computeHeatBathEnergy()


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
    ctx.setPositions(state.getPositions())
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
            lambda c: c.getIntegrator().getStepSize(), deadline, replay,
            before=_total_energy, after=lambda c: (
                c.getTime(), c.temperature(), _total_energy(c)))
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
                  min(dts), max(dts), integ.getMaximumStepSize(), clock,
                  total, temperature, r["before"], energy, 100.0 * change,
                  r["ns_day"], r["ms_per_step"], r["eager_ms_per_step"],
                  json.dumps(r["launches"])))
        if not all(0.0 < dt <= integ.getMaximumStepSize() for dt in dts):
            raise RuntimeError("%s: a step size outside (0, %.1f]: %s" % (
                label, integ.getMaximumStepSize(), dts))
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
    ctx.setPositions(state.getPositions())
    ctx.setVelocities(state.getVelocities())
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
            want = want + integ.getStepSize()
        captures.append(_captures(ctx))
    launches = {k.name: k.launches for k in MAIN_PATH_KERNELS}
    clock = ctx.getTime()
    temperature = ctx.temperature()
    constraint_err = _constraint_error(
        system, ctx.getState(getPositions=True).getPositions())
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
    v0 = ctx0.getState(getEnergy=True, groups={g}).getPotentialEnergy()
    threshold = v0 + fraction * abs(v0)
    alpha = fraction * abs(v0)
    integ = omm.AMDForceGroupIntegrator(AMD_DT, g, alpha, threshold)

    def after(ctx):
        total = ctx.getState(getEnergy=True).getPotentialEnergy()
        group = ctx.getState(getEnergy=True, groups={g}).getPotentialEnergy()
        return {"total": total, "group": group,
                "effective": integ.getEffectiveEnergy(total, group),
                "temperature": ctx.temperature()}

    r = _integrator_run(device, "amd bilayer", system, integ, state, steps,
                        every, lambda c: c.getState(
                            getEnergy=True, groups={g}).getPotentialEnergy(),
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
    w = ctx.getState(getPositions=True).getPositions().reshape(-1, 4, 3)
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
    box = ctx.getState().getPeriodicBoxVectors()
    return energy - float(ctx._nonbonded.disp_coeff) / float(
        np.linalg.det(np.asarray(box)))


def _decouple(nb, atoms):
    """Charges and epsilons of `atoms` to 0, each brought back by a
    particle offset of the global parameter "lambda" (default 1)."""
    nb.addGlobalParameter("lambda", 1.0)
    for i in atoms:
        q, sigma, eps = nb.getParticleParameters(i)
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
    n_waters = st.getPositions().shape[0] // 3
    system, _ = tip3p_water_box(n_waters)
    (nb,) = system.getForces()
    _decouple(nb, range(3 * waters))
    built, _ = tip3p_water_box(n_waters)
    (nb_built,) = built.getForces()
    integ = omm.LangevinMiddleIntegrator(300.0, FRICTION, DT_PS)
    integ.setRandomNumberSeed(29)
    ctx = (omm.Context(system, integ) if platform == "CUDA"
           else omm.Context(system, integ, platform))
    ctx.setPositions(st.getPositions())
    ctx.setVelocities(st.getVelocities())
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
        pos = ctx.getState(getPositions=True).getPositions()
        e32 = ctx.getState(getEnergy=True).getPotentialEnergy()
        oracle.setPositions(pos)
        oracle.setParameter("lambda", lam)
        e64 = oracle.getState(getEnergy=True).getPotentialEnergy()
        for i in range(3 * waters):
            q, sigma, eps = nb_built.getParticleParameters(i)
            _, _, q1, _, e1 = nb.getParticleParameterOffset(i)
            nb_built.setParticleParameters(i, lam * q1, sigma, lam * e1)
        twin = (omm.Context(built, omm.LangevinMiddleIntegrator(
            300.0, FRICTION, DT_PS)) if platform == "CUDA"
            else omm.Context(built, omm.LangevinMiddleIntegrator(
                300.0, FRICTION, DT_PS), platform))
        twin.setPositions(pos)
        e_built = _without_dispersion_correction(
            twin, twin.getState(getEnergy=True).getPotentialEnergy())
        del twin
        rows.append((lam, e32, e64, _without_dispersion_correction(ctx, e32),
                     e_built))
        deadline.check("offsets: lambda %.2f" % lam)
    for i in range(3 * waters, 6 * waters):
        q, sigma, eps = nb.getParticleParameters(i)
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
    e_now = ctx.getState(getEnergy=True).getPotentialEnergy()
    fresh = (omm.Context(system, omm.LangevinMiddleIntegrator(
        300.0, FRICTION, DT_PS)) if platform == "CUDA"
        else omm.Context(system, omm.LangevinMiddleIntegrator(
            300.0, FRICTION, DT_PS), platform))
    fresh.setPositions(ctx.getState(getPositions=True).getPositions())
    fresh.setParameter("lambda", lambdas[-1])
    e_fresh = fresh.getState(getEnergy=True).getPotentialEnergy()
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
        return {"positions": st.getPositions(),
                "velocities": st.getVelocities(), "time": c.getTime(),
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
    return {g: ctx.getState(getEnergy=True, groups={g}).getPotentialEnergy()
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
        e.append(ctx.getState(getEnergy=True,
                              groups={group}).getPotentialEnergy())
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
    n_waters = st.getPositions().shape[0] // 3
    system, _ = alchemical_water_box(n_waters, solute)
    groups = sorted(ALCHEMICAL_GROUPS.values())
    soft = system.getForces()[1]
    integ = omm.LangevinMiddleIntegrator(300.0, FRICTION, DT_PS)
    integ.setRandomNumberSeed(31)
    ctx = (omm.Context(system, integ) if cuda
           else omm.Context(system, integ, "CPU"))
    ctx.setPositions(st.getPositions())
    ctx.setVelocities(st.getVelocities())
    oracle = omm.Context(system, omm.VerletIntegrator(0.001),
                         "CUDA" if cuda else "CPU", {"Precision": "double"})
    before = ctx.getState(getEnergy=True).getPotentialEnergy()
    for kern in KERNELS:
        kern.launches = 0
    omm.LocalEnergyMinimizer.minimize(ctx, MINIMIZE_TOLERANCE, iterations)
    minimizer = {k.name: k.launches for k in MINIMIZER_KERNELS}
    after = ctx.getState(getEnergy=True).getPotentialEnergy()
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
        pos = ctx.getState(getPositions=True).getPositions()
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
            sigma, eps = soft.getParticleParameters(i)
            soft.setParticleParameters(i, [sigma, 0.9 * eps])
    record = _deriv_record(device, ctx, "lambda_electrostatics",
                           deriv_launches)
    soft.updateParametersInContext(ctx)
    soft.updateParametersInContext(oracle)
    integ.step(chunk)
    after_update = _captures(ctx)
    pos = ctx.getState(getPositions=True).getPositions()
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
        system, ctx.getState(getPositions=True).getPositions())
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
        out[g] = (st.getPotentialEnergy(), st.getForces())
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
    pos, box = state.getPositions(), state.getPeriodicBoxVectors()
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


def phase_customgb(device, deadline=None, lipids=19, model=GB_MODEL,
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
        readings.append((st.getPotentialEnergy(), st.getForces()))
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
        ctx.getState(getForces=True).getForces(),
        oracle.getState(getForces=True).getForces())
    energies = {g: (ctx.getState(getEnergy=True, groups={g})
                    .getPotentialEnergy(),
                    oracle.getState(getEnergy=True, groups={g})
                    .getPotentialEnergy()) for g in (0, 1, 2)}
    del oracle
    (gb,) = ctx._custom
    sweeps_ms = None
    if device.type == "cuda":
        pos, box = ctx._state["positions"], ctx._box
        sweeps_ms = _time_ms(lambda: gb.ef(pos, box), device, reps=5,
                             warmup=1)
    deadline.check("customgb: float64 oracle")
    ctx.applyConstraints()
    before = ctx.getState(getEnergy=True).getPotentialEnergy()
    omm.LocalEnergyMinimizer.minimize(ctx, MINIMIZE_TOLERANCE, iterations)
    after = ctx.getState(getEnergy=True).getPotentialEnergy()
    deadline.check("customgb: minimize")
    ctx.setVelocitiesToTemperature(300.0, randomSeed=6)
    run = _production(device, ctx, integ.step,
                      ctx.getState(getEnergy=True).getPotentialEnergy(),
                      steps, steps, deadline)
    temperature = ctx.temperature()
    constraint_err = _constraint_error(
        system, ctx.getState(getPositions=True).getPositions())
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
    masses = np.asarray([system.getParticleMass(i)
                         for i in range(system.getNumParticles())])
    # the lipids: the molecules larger than a water
    heavy = sorted(i for mol in base_ctx.getMolecules() if len(mol) > 3
                   for i in mol if masses[i] > 2.0)
    reference = np.asarray(bilayer["minimized_positions"], np.float64)
    pos = st.getPositions()
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
    ctx.setVelocities(st.getVelocities())
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
        system, ctx.getState(getPositions=True).getPositions())
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


def phase_more_custom(device, main=None, deadline=None, systems=None,
                      steps=None, every=MORE_EVERY, replay=MORE_REPLAY,
                      dt=MORE_DT, gate=DRIFT_GATE,
                      seed=VELOCITY_SEED) -> dict:
    """CustomHbondForce, CustomManyParticleForce and GayBerneForce on
    more_custom_systems (the hydrogen-bond waters at the relaxed water
    box's positions): each system's custom force's ef (float64) on the
    card against its float64 evaluation on the CPU (MORE_BAR, energy
    relative and forces of the largest) and timed alone; then the
    system's NVE steps (or `steps`) of `dt` of Verlet through the step
    program from velocities at the system's temperature drawn with `seed`
    (the total energy read every `every` steps: its drift within `gate`
    kT/dof/ns); `replay` steps from a snapshot through the step program
    and the eager loop: the same bits. Raises on a miss."""
    deadline = deadline or Deadline(math.inf)
    if systems is None:
        water = (None if main is None else main["context"].getState(
            getPositions=True).getPositions())
        systems = more_custom_systems(water_positions=water)
    out = {}
    for label, (params, pos, temperature, nve) in systems.items():
        nve = steps or nve
        system = omm.from_numpy(params)
        integ = omm.VerletIntegrator(dt)
        ctx = _platform_context(device, system, integ)
        ctx.setPositions(pos)
        cpu = omm.Context(omm.from_numpy(params), omm.VerletIntegrator(dt),
                          "CPU", {"Precision": "double"})
        cpu.setPositions(pos)
        (module,) = ctx._custom
        (cpu_module,) = cpu._custom
        x = ctx._state["positions"]
        e_card, f_card = module.ef(x, ctx._box)
        e_cpu, f_cpu = cpu_module.ef(cpu._state["positions"], cpu._box)
        f_card = f_card.cpu()
        err = (abs(float(e_card) - float(e_cpu)) / abs(float(e_cpu)),
               float((f_card - f_cpu).abs().max() / f_cpu.abs().max()))
        del cpu
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
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; none is "
                           "visible to torch")
    deadline = Deadline(BUDGET_S)
    try:
        return _main(deadline)
    except BaseException:
        print("seconds by phase before the failure: %s; %.1f s in all" % (
            ", ".join("%s %.1f" % lap for lap in deadline.laps),
            deadline.elapsed()))
        raise


def _main(deadline) -> int:
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
    phase_gather_orders(device, inp, deadline)
    phase_triple_shapes(device, deadline)
    phase_triclinic(device, deadline=deadline)
    warm.join()
    deadline.lap("kernels, triclinic")
    for kern in KERNELS:
        kern.launches = 0
    result = phase_main_path(device, deadline=deadline)
    launches = {k.name: k.launches for k in MAIN_PATH_KERNELS}
    print("main path launches: %s" % json.dumps(launches))
    if min(launches.values()) <= 0:
        raise RuntimeError("a kernel of the main path never launched: %s"
                           % launches)
    ns_day = result["ns_day"]
    deadline.lap("main path")
    phase_step_program(device, result, deadline)
    deadline.lap("step program")
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
    more_custom = phase_more_custom(device, result, deadline)
    deadline.lap("more custom")
    del result, offsets["context"]
    minimized = phase_minimize(device, deadline=deadline)
    if min(minimized["launches"].values()) <= 0:
        raise RuntimeError("a kernel of the minimizer path never launched: "
                           "%s" % minimized["launches"])
    for kern in (pallas_pme.FWD, pallas_pme.BWD):
        launches[kern.name] = minimized["launches"][kern.name]
    deadline.lap("minimize")
    app_bilayer = phase_app_bilayer(device, deadline)
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
    tables = phase_tables(device, last.getPositions(),
                          last.getPeriodicBoxVectors(), deadline)
    deadline.lap("tables")
    npt = phase_npt_bilayer(device, bilayer, deadline)
    deadline.lap("npt bilayer")
    rf_bilayer = phase_rf_bilayer(device, bilayer["minimized_positions"],
                                  deadline, bilayer=(
                                      app_bilayer.pop("reference"), None))
    deadline.lap("rf bilayer")
    bilayer_ms = bilayer["graph"]["wall_ms_per_step"]
    del bilayer, npt["context"], npt["step"]
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
    counts = tile_counts(inp)
    records = phase_timing(device, inp, counts, launches, errors, deadline)
    records.append(rf_water["record"])
    records += ljpme["records"]
    records.append(alchemical["deriv_record"])
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
