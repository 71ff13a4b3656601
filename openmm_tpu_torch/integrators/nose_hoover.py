"""NoseHooverIntegrator: Nose-Hoover chains with Yoshida-Suzuki splitting.

Counterpart of openmm_tpu/integrators/nose_hoover.py (after OpenMM's
NoseHooverIntegrator.cpp and noseHooverChain.cc): a LangevinMiddle-style
splitting (kick, velocity constraints, half a drift, the thermostats,
half a drift, position constraints, velocities corrected by the
constraint correction alone) whose O step is the deterministic chain
propagation that rescales the velocities. Chain masses Q_1 = N_f kT tau^2,
Q_k = kT tau^2 with tau = 1/frequency. Thermostats: the default over all
particles; a subsystem of particles; connected pairs, whose centre-of-mass
motion is thermostated at the temperature and whose relative motion by a
chain of its own at the relative temperature (the Drude scheme).

Each chain's positions and velocities are float64 device tensors that the
step writes in place (the integrator's state: a snapshot and the warm-up
before a capture copy them back). propagate_chain runs on device scalars,
a few hundred small operations a step (3 beads, 3 multiple time steps, 7
Yoshida-Suzuki weights by default), as the JAX package runs them in
plain XLA. The degrees of freedom of the full-system chain are those of
the JAX package's _chain_dof: 3 per particle with mass less the
constraints, without the 3 a CMMotionRemover removes.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import unit as u
from ..constants import BOLTZ
from .base import Integrator, StepDeps

_K = u.kelvin
_PER_PS = u.picosecond ** -1

_YS_WEIGHTS = {
    1: [1.0],
    3: [0.828981543588751, -0.657963087177502, 0.828981543588751],
    5: [0.2967324292201065, 0.2967324292201065, -0.186929716880426,
        0.2967324292201065, 0.2967324292201065],
    7: [0.784513610477560, 0.235573213359357, -1.17767998417887,
        1.31518632068391, -1.17767998417887, 0.235573213359357,
        0.784513610477560],
}


def propagate_chain(ke2, chain_pos, chain_vel, kT, dof, dt, tau, n_mts,
                    ys_order):
    """Propagate one Nose-Hoover chain over a step dt: (scale of the
    particle velocities, new chain positions, new chain velocities), device
    scalars and (m,) tensors. ke2 is twice the kinetic energy of the
    thermostated degrees of freedom; the order of operations is the JAX
    package's."""
    m = chain_pos.shape[0]
    q = [kT * tau * tau for _ in range(m)]
    q[0] = q[0] * dof
    vel = list(chain_vel.unbind())
    pos = chain_pos
    scale = torch.ones_like(ke2)

    def cascade(beads, ke2, wdt):
        for bead in beads:
            if bead == 0:
                g = (ke2 - dof * kT) / q[0]
            else:
                g = (q[bead - 1] * vel[bead - 1] ** 2 - kT) / q[bead]
            if bead == m - 1:
                vel[bead] = vel[bead] + 0.25 * wdt * g
            else:
                ef = torch.exp(-0.125 * wdt * vel[bead + 1])
                vel[bead] = ef * (ef * vel[bead] + 0.25 * wdt * g)

    for _ in range(n_mts):
        for w in _YS_WEIGHTS[ys_order]:
            wdt = w * dt / n_mts
            cascade(range(m - 1, -1, -1), ke2, wdt)
            s = torch.exp(-0.5 * wdt * vel[0])
            scale = scale * s
            ke2 = ke2 * s * s
            pos = pos + 0.5 * wdt * torch.stack(vel)
            cascade(range(m), ke2, wdt)
    return scale, pos, torch.stack(vel)


class NoseHooverChain:
    """The public description of one chain (NoseHooverChain.h), handed out
    by NoseHooverIntegrator.getThermostat: its setters write through to
    the integrator's chain."""

    def __init__(self, temperature, relativeTemperature, collisionFrequency,
                 relativeCollisionFrequency, numDOFs, chainLength, numMTS,
                 numYoshidaSuzuki, chainID, thermostatedAtoms,
                 thermostatedPairs, _backing=None):
        if _backing is not None:
            self._d = _backing
        else:
            self._d = {
                "particles": [int(p) for p in thermostatedAtoms],
                "pairs": [(int(a), int(b)) for a, b in thermostatedPairs],
                "temperature": float(u.strip(temperature, _K)),
                "frequency": float(u.strip(collisionFrequency, _PER_PS)),
                "rel_temperature": float(u.strip(relativeTemperature, _K)),
                "rel_frequency": float(u.strip(relativeCollisionFrequency,
                                               _PER_PS)),
                "chain_length": int(chainLength),
                "n_mts": int(numMTS),
                "n_ys": int(numYoshidaSuzuki)}
        self._d.setdefault("num_dofs", int(numDOFs) if numDOFs else 0)
        self._d.setdefault("chain_id", int(chainID) if chainID else 0)

    def getTemperature(self) -> float:
        return self._d["temperature"]

    def setTemperature(self, temperature) -> None:
        self._d["temperature"] = float(u.strip(temperature, _K))

    def getRelativeTemperature(self) -> float:
        return self._d["rel_temperature"]

    def setRelativeTemperature(self, temperature) -> None:
        self._d["rel_temperature"] = float(u.strip(temperature, _K))

    def getCollisionFrequency(self) -> float:
        return self._d["frequency"]

    def setCollisionFrequency(self, frequency) -> None:
        self._d["frequency"] = float(u.strip(frequency, _PER_PS))

    def getRelativeCollisionFrequency(self) -> float:
        return self._d["rel_frequency"]

    def setRelativeCollisionFrequency(self, frequency) -> None:
        self._d["rel_frequency"] = float(u.strip(frequency, _PER_PS))

    def getNumDegreesOfFreedom(self) -> int:
        return self._d["num_dofs"]

    def setNumDegreesOfFreedom(self, numDOF) -> None:
        self._d["num_dofs"] = int(numDOF)

    def getChainLength(self) -> int:
        return self._d["chain_length"]

    def getNumMultiTimeSteps(self) -> int:
        return self._d["n_mts"]

    def getNumYoshidaSuzukiTimeSteps(self) -> int:
        return self._d["n_ys"]

    def getChainID(self) -> int:
        return self._d["chain_id"]

    def getThermostatedAtoms(self) -> list:
        return list(self._d["particles"])

    def setThermostatedAtoms(self, atomIDs) -> None:
        self._d["particles"] = [int(p) for p in atomIDs]

    def getThermostatedPairs(self) -> list:
        return list(self._d["pairs"])

    def setThermostatedPairs(self, pairIDs) -> None:
        self._d["pairs"] = [(int(a), int(b)) for a, b in pairIDs]

    def usesChainForAbsoluteMotion(self) -> bool:
        return True


class NoseHooverIntegrator(Integrator):
    def __init__(self, temperature=298.0, collisionFrequency=50.0,
                 stepSize=0.001, chainLength=3, numMTS=3, numYoshidaSuzuki=7):
        # NoseHooverIntegrator(stepSize, None): no default thermostat
        default = collisionFrequency is not None
        if not default:
            stepSize = temperature
        super().__init__(stepSize)
        self._thermostats = []
        # per thermostat {"": (positions, velocities)} and, with pairs,
        # "r": the relative chain's
        self._chains = []
        if default:
            self.addThermostat(temperature, collisionFrequency, chainLength,
                               numMTS, numYoshidaSuzuki)

    def addThermostat(self, temperature, collisionFrequency, chainLength=3,
                      numMTS=3, numYoshidaSuzuki=7) -> int:
        """A thermostat over all particles."""
        return self.addSubsystemThermostat(
            [], [], temperature, collisionFrequency, temperature,
            collisionFrequency, chainLength, numMTS, numYoshidaSuzuki)

    def addSubsystemThermostat(self, thermostatedParticles,
                               thermostatedPairs, temperature,
                               collisionFrequency, relativeTemperature,
                               relativeCollisionFrequency, chainLength=3,
                               numMTS=3, numYoshidaSuzuki=7) -> int:
        if int(numYoshidaSuzuki) not in _YS_WEIGHTS:
            raise ValueError("numYoshidaSuzuki must be 1, 3, 5, or 7")
        if self._context is not None:
            raise ValueError("Thermostats must be added before creating a "
                             "Context")
        self._thermostats.append({
            "particles": [int(p) for p in thermostatedParticles],
            "pairs": [(int(a), int(b)) for a, b in thermostatedPairs],
            "temperature": float(u.strip(temperature, _K)),
            "frequency": float(u.strip(collisionFrequency, _PER_PS)),
            "rel_temperature": float(u.strip(relativeTemperature, _K)),
            "rel_frequency": float(u.strip(relativeCollisionFrequency,
                                           _PER_PS)),
            "chain_length": int(chainLength),
            "n_mts": int(numMTS),
            "n_ys": int(numYoshidaSuzuki),
            "chain_id": len(self._thermostats)})
        return len(self._thermostats) - 1

    def getNumThermostats(self) -> int:
        return len(self._thermostats)

    def getThermostat(self, chainID=0) -> NoseHooverChain:
        d = self._thermostats[chainID]
        if self._context is not None:
            d["num_dofs"] = int(self._chain_dof(chainID))
        return NoseHooverChain(None, None, None, None, None, None, None,
                               None, None, [], [], _backing=d)

    def hasSubsystemThermostats(self) -> bool:
        return any(th["particles"] or th["pairs"]
                   for th in self._thermostats)

    def getTemperature(self, chainID=0) -> float:
        return self._thermostats[chainID]["temperature"]

    def setTemperature(self, temp, chainID=0) -> None:
        self._thermostats[chainID]["temperature"] = float(u.strip(temp, _K))

    def getRelativeTemperature(self, chainID=0) -> float:
        return self._thermostats[chainID]["rel_temperature"]

    def setRelativeTemperature(self, temp, chainID=0) -> None:
        self._thermostats[chainID]["rel_temperature"] = float(
            u.strip(temp, _K))

    def getCollisionFrequency(self, chainID=0) -> float:
        return self._thermostats[chainID]["frequency"]

    def setCollisionFrequency(self, freq, chainID=0) -> None:
        self._thermostats[chainID]["frequency"] = float(
            u.strip(freq, _PER_PS))

    def getRelativeCollisionFrequency(self, chainID=0) -> float:
        return self._thermostats[chainID]["rel_frequency"]

    def setRelativeCollisionFrequency(self, freq, chainID=0) -> None:
        self._thermostats[chainID]["rel_frequency"] = float(
            u.strip(freq, _PER_PS))

    def _chain_dof(self, i, relative=False) -> float:
        """The JAX package's _chain_dof: 3 a pair for a relative chain;
        3 a particle and a pair for a subsystem; 3 per particle with mass
        less the constraints for the full system."""
        th = self._thermostats[i]
        if relative:
            return 3.0 * len(th["pairs"])
        if th["particles"] or th["pairs"]:
            return 3.0 * (len(th["particles"]) + len(th["pairs"]))
        ctx = self._context
        return 3.0 * float(ctx._n_massive) \
            - ctx._system.getNumConstraints()

    def computeHeatBathEnergy(self) -> float:
        """The energy of the heat baths, for the conserved quantity."""
        if self._context is None:
            return 0.0
        e = 0.0
        for i, th in enumerate(self._thermostats):
            for tag, temp, freq in (("", th["temperature"], th["frequency"]),
                                    ("r", th["rel_temperature"],
                                     th["rel_frequency"])):
                if tag not in self._chains[i]:
                    continue
                cp, cv = (t.detach().cpu().numpy()
                          for t in self._chains[i][tag])
                kT = BOLTZ * temp
                tau = 1.0 / freq
                dof = self._chain_dof(i, relative=(tag == "r"))
                q = np.full(len(cp), kT * tau * tau)
                q[0] *= dof
                e += 0.5 * np.sum(q * cv * cv) + dof * kT * cp[0] \
                    + kT * np.sum(cp[1:])
        return float(e)

    def getChainState(self, chainID=0, relative=False) -> tuple:
        """(positions, velocities) of a chain, float64 numpy arrays."""
        cp, cv = self._chains[chainID]["r" if relative else ""]
        return cp.cpu().numpy().copy(), cv.cpu().numpy().copy()

    def _params(self) -> tuple:
        out = [self._step_size]
        for th in self._thermostats:
            out += [th["temperature"], th["frequency"],
                    th["rel_temperature"], th["rel_frequency"]]
        return tuple(out)

    def _kinetic_energy_shift(self) -> float:
        return 0.0

    def _init_state(self, deps: StepDeps) -> None:
        f64 = dict(dtype=torch.float64, device=deps.inv_masses.device)
        self._chains = []
        for th in self._thermostats:
            m = th["chain_length"]
            chains = {"": (torch.zeros(m, **f64), torch.zeros(m, **f64))}
            if th["pairs"]:
                chains["r"] = (torch.zeros(m, **f64), torch.zeros(m, **f64))
            self._chains.append(chains)

    def _state_tensors(self) -> list:
        return [t for chains in self._chains for pair in chains.values()
                for t in pair]

    def _make_step_fn(self, deps: StepDeps):
        inv_m = deps.inv_masses[:, None]
        moving = deps.moving
        masses = self._context._masses
        dev = masses.device
        params = deps.params
        thermostats = []
        for i, th in enumerate(self._thermostats):
            pairs = torch.as_tensor(np.asarray(th["pairs"], np.int64)
                                    .reshape(-1, 2), device=dev)
            single = torch.zeros(masses.shape[0], dtype=torch.bool,
                                 device=dev)
            single[th["particles"]] = True
            thermostats.append({
                "i": i, "full": not th["particles"] and not th["pairs"],
                "single": single[:, None], "pairs": pairs,
                "dof_abs": self._chain_dof(i),
                "dof_rel": self._chain_dof(i, relative=True),
                "n_mts": th["n_mts"], "n_ys": th["n_ys"],
                "chains": self._chains[i]})

        def chain(th, tag, ke2, kT, tau, dof, dt):
            cp, cv = th["chains"][tag]
            scale, new_p, new_v = propagate_chain(
                ke2, cp, cv, kT, dof, dt, tau, th["n_mts"], th["n_ys"])
            cp.copy_(new_p)
            cv.copy_(new_v)
            return scale

        def apply_thermostats(v, dt):
            for th in thermostats:
                base = 1 + 4 * th["i"]
                kT = BOLTZ * params[base]
                tau = 1.0 / params[base + 1]
                if th["full"]:
                    ke2 = torch.sum(masses[:, None] * v * v)
                    scale = chain(th, "", ke2, kT, tau, th["dof_abs"], dt)
                    v = torch.where(moving, v * scale, v)
                    continue
                # a subsystem: single particles and the pairs' centres of
                # mass on one chain, the pairs' relative motion on another
                single = th["single"]
                ke2 = torch.sum(torch.where(single, masses[:, None] * v * v,
                                            0.0))
                p = th["pairs"]
                if p.shape[0]:
                    m1 = masses[p[:, 0], None]
                    m2 = masses[p[:, 1], None]
                    mtot = m1 + m2
                    v1, v2 = v[p[:, 0]], v[p[:, 1]]
                    v_com = (m1 * v1 + m2 * v2) / mtot
                    v_rel = v1 - v2
                    ke2 = ke2 + torch.sum(mtot * v_com * v_com)
                scale = chain(th, "", ke2, kT, tau, th["dof_abs"], dt)
                v = torch.where(single, v * scale, v)
                if p.shape[0]:
                    rkT = BOLTZ * params[base + 2]
                    rtau = 1.0 / params[base + 3]
                    mu = m1 * m2 / mtot
                    ke2r = torch.sum(mu * v_rel * v_rel)
                    rscale = chain(th, "r", ke2r, rkT, rtau, th["dof_rel"],
                                   dt)
                    v_com = v_com * scale
                    v_rel = v_rel * rscale
                    v = v.index_copy(0, p[:, 0], v_com + (m2 / mtot) * v_rel)
                    v = v.index_copy(0, p[:, 1], v_com - (m1 / mtot) * v_rel)
            return v

        def step(pos, vel, box):
            dt = params[0]
            for hook in deps.update_hooks:
                pos, vel = hook(deps.step, pos, vel, box)
            _, forces = deps.force_fn(pos, box)
            v = vel + dt * forces.to(vel.dtype) * inv_m
            v = torch.where(moving, v, vel)
            v = deps.apply_velocity_constraints(pos, v)
            delta = 0.5 * dt * v
            v = apply_thermostats(v, dt)
            delta = delta + 0.5 * dt * v
            new_raw = pos + torch.where(moving, delta, 0.0)
            new_pos, corr = deps.apply_position_constraints_corr(pos, new_raw)
            new_pos = deps.compute_vsites(new_pos)
            if corr is not None:
                v = v + torch.where(moving, corr / dt, 0.0)
            deps.step.add_(1)
            return new_pos, v

        return step
