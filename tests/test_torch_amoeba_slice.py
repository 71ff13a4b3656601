"""Rehearsals on the CPU of chip_smoke.py's AMOEBA phases at small sizes:
phase_amoeba_pme (ACE-ALA-NME in a 1.9 nm water box, ~630 atoms: the
Modeller build, amoeba2013.json's System, the minimizer, the relaxation,
float32 against float64, kernels 4-5 (their plain versions here) first
and second order, the step program against the eager loop), and
phase_amoeba_gk and phase_hippo. Their gates hold as on the card but the
temperature band: five relaxation steps cannot thermalise the lattice
start's release (the card's phase relaxes for 60)."""
import math

import torch

import chip_smoke

CPU = torch.device("cpu")


def test_amoeba_pme_phase_on_cpu():
    r = chip_smoke.phase_amoeba_pme(
        CPU, n_ala=1, box=1.9, relax=(0.001, 100.0, 5),
        minimize_iterations=1, steps=2, replay=1, t_range=(0.0, 1e4))
    assert r["atoms"] > 600 and math.isfinite(r["temperature"])
    assert r["check"]["force_err"] <= chip_smoke.FORCE_ERR_BAR
    assert r["residual"] < 1e-6
    records = chip_smoke.amoeba_kernel_records(
        CPU, r["kernel_inputs"], r["launches"], r["kernel_errors"])
    assert {k["name"] for k in records} == {
        "spread_triple_fwd_amoeba", "spread_triple_bwd_amoeba"}


def test_amoeba_gk_and_hippo_phases_on_cpu():
    gk = chip_smoke.phase_amoeba_gk(CPU, n_ala=2, steps=2)
    assert gk["check"]["force_err"] <= chip_smoke.FORCE_ERR_BAR
    hippo = chip_smoke.phase_hippo(CPU, n_waters=8, steps=2)
    assert hippo["atoms"] == 24
