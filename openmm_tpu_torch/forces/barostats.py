"""Monte Carlo barostats: isotropic, anisotropic and membrane.

Counterpart of openmm_tpu/forces/barostats.py (after
MonteCarloBarostatImpl::updateContextState): every `frequency` steps (on
the steps where the steps completed before this one, `step`, satisfy
step % frequency == frequency - 1) an attempt proposes a volume move dV
~ U(-s, s), scales the molecules' centres of mass, and accepts with
probability exp(-w / kT), where w = dE + P dV (- gamma dA) - N_mol kT
ln(V_new / V); the proposal width s retunes every 10 attempts toward
25-75 % acceptance.

An attempt is a pure function of its inputs (`BarostatModule.attempt`):
the positions, the box, the uniforms it draws from and the energy. The
Context draws the uniforms from its generator every step, outside the
conditional that runs the attempt (so a captured step graph draws the
same count every replay), and evaluates the energy through a candidate
state built for the positions and box at hand. Accept and reject are
torch.where, not a branch. The quirks of the JAX attempt are kept: the
membrane barostat ignores `xymode` (its XY moves are isotropic), and
ConstantVolume adds ln(V_new / V) although its box keeps its volume.
Numbers are plain floats: bar, bar nm, K.
"""
from __future__ import annotations

import torch

from .. import unit as u
from ..constants import AVOGADRO, BOLTZ
from ..ops.accumulate import GroupSum
from ..vec3 import Vec3
from .base import Force

_NM = u.nanometer
_K = u.kelvin
_BAR = u.bar
_BAR_NM = _BAR * _NM

PRESSURE_UNIT_FACTOR = AVOGADRO * 1e-25     # bar -> kJ/mol/nm^3
F64 = torch.float64


def scale_molecules(pos, molecules: GroupSum, masses, molecule_mass, scale):
    """Positions with each molecule's centre of mass scaled by `scale` (3,)
    and its internal geometry kept (the scaleCoordinates kernel,
    monteCarloBarostat.cc). molecule_mass is molecules(masses[:, None])."""
    com = molecules(masses[:, None] * pos) / molecule_mass
    offset = com * (scale[None, :] - 1.0)
    return pos + offset[molecules.group_id]


class _BarostatBase(Force):
    def getFrequency(self) -> int:
        return self._frequency

    def setFrequency(self, freq) -> None:
        self._frequency = int(freq)

    def getDefaultTemperature(self):
        return u.Quantity(self._temperature, _K)

    def setDefaultTemperature(self, temp) -> None:
        self._temperature = float(u.strip(temp, _K))

    def getRandomNumberSeed(self) -> int:
        return self._seed

    def setRandomNumberSeed(self, seed) -> None:
        self._seed = int(seed)

    def usesPeriodicBoundaryConditions(self) -> bool:
        return True

    def _compile(self, context) -> "BarostatModule":
        return BarostatModule(self, context)


class MonteCarloBarostat(_BarostatBase):
    """Isotropic moves: the three box lengths scale by (V_new / V)^(1/3)."""
    SLOTS = 1

    @staticmethod
    def Pressure():
        return "MonteCarloPressure"

    @staticmethod
    def Temperature():
        return "MonteCarloTemperature"

    def __init__(self, defaultPressure, defaultTemperature, frequency=25):
        super().__init__()
        self._pressure = float(u.strip(defaultPressure, _BAR))
        self._temperature = float(u.strip(defaultTemperature, _K))
        self._frequency = int(frequency)
        self._seed = 0

    def getDefaultPressure(self):
        return u.Quantity(self._pressure, _BAR)

    def setDefaultPressure(self, pressure) -> None:
        self._pressure = float(u.strip(pressure, _BAR))

    def _global_defaults(self) -> dict:
        return {self.Pressure(): self._pressure,
                self.Temperature(): self._temperature}


class MonteCarloAnisotropicBarostat(_BarostatBase):
    """Moves along one enabled axis, picked at random each attempt, with
    a pressure and a proposal width of its own."""
    SLOTS = 3

    @staticmethod
    def PressureX():
        return "MonteCarloPressureX"

    @staticmethod
    def PressureY():
        return "MonteCarloPressureY"

    @staticmethod
    def PressureZ():
        return "MonteCarloPressureZ"

    @staticmethod
    def Temperature():
        return "MonteCarloTemperature"

    def __init__(self, defaultPressure, defaultTemperature, scaleX=True,
                 scaleY=True, scaleZ=True, frequency=25):
        super().__init__()
        self._pressure = [float(u.strip(p, _BAR)) for p in defaultPressure]
        self._temperature = float(u.strip(defaultTemperature, _K))
        self._scale = [bool(scaleX), bool(scaleY), bool(scaleZ)]
        self._frequency = int(frequency)
        self._seed = 0
        if not any(self._scale):
            raise ValueError("No axes are being scaled")

    def getDefaultPressure(self):
        return u.Quantity(Vec3(*self._pressure), _BAR)

    def setDefaultPressure(self, pressure) -> None:
        self._pressure = [float(u.strip(p, _BAR)) for p in pressure]

    def getScaleX(self) -> bool:
        return self._scale[0]

    def getScaleY(self) -> bool:
        return self._scale[1]

    def getScaleZ(self) -> bool:
        return self._scale[2]

    def _global_defaults(self) -> dict:
        names = (self.PressureX(), self.PressureY(), self.PressureZ())
        out = dict(zip(names, self._pressure))
        out[self.Temperature()] = self._temperature
        return out


class MonteCarloMembraneBarostat(_BarostatBase):
    """Moves of the membrane plane (slot 0: x and y together) or of its
    normal (slot 1: z), picked at random each attempt, under a pressure
    and a surface tension; the z mode frees z, fixes it, or keeps the
    volume."""
    SLOTS = 2
    # XYMode
    XYIsotropic = 0
    XYAnisotropic = 1
    # ZMode
    ZFree = 0
    ZFixed = 1
    ConstantVolume = 2

    @staticmethod
    def Pressure():
        return "MonteCarloPressure"

    @staticmethod
    def SurfaceTension():
        return "MonteCarloSurfaceTension"

    @staticmethod
    def Temperature():
        return "MonteCarloTemperature"

    def __init__(self, defaultPressure, defaultSurfaceTension,
                 defaultTemperature, xymode=0, zmode=0, frequency=25):
        super().__init__()
        self._pressure = float(u.strip(defaultPressure, _BAR))
        self._tension = float(u.strip(defaultSurfaceTension, _BAR_NM))
        self._temperature = float(u.strip(defaultTemperature, _K))
        self._xymode = int(xymode)
        self._zmode = int(zmode)
        self._frequency = int(frequency)
        self._seed = 0

    def getDefaultPressure(self):
        return u.Quantity(self._pressure, _BAR)

    def getDefaultSurfaceTension(self):
        return u.Quantity(self._tension, _BAR_NM)

    def getXYMode(self) -> int:
        return self._xymode

    def getZMode(self) -> int:
        return self._zmode

    def _global_defaults(self) -> dict:
        return {self.Pressure(): self._pressure,
                self.SurfaceTension(): self._tension,
                self.Temperature(): self._temperature}


class RPMDUpdater:
    """Marker of the forces whose update runs once a step over the whole
    ring polymer (the rpmd plugin's RPMDUpdater.h): RPMDIntegrator runs
    the hooks of these forces alone, on its (K, n, 3) copies."""

    def updateRPMDState(self, context) -> None:
        """A no-op: the update runs inside the step, as the JAX package's
        does."""


class RPMDMonteCarloBarostat(RPMDUpdater, _BarostatBase):
    """A Monte Carlo barostat for ring-polymer MD
    (RPMDMonteCarloBarostatImpl.cpp:51-156): a volume move scales the
    molecules of the copies' centroid, moves every copy by its centroid's
    offset, and accepts on the mean energy over the copies at the
    integrator's temperature. It needs an RPMDIntegrator."""
    SLOTS = 1

    @staticmethod
    def Pressure():
        return "RPMDMonteCarloPressure"

    def __init__(self, defaultPressure, frequency=25):
        super().__init__()
        self._pressure = float(u.strip(defaultPressure, _BAR))
        self._frequency = int(frequency)
        self._seed = 0

    def getDefaultPressure(self):
        return u.Quantity(self._pressure, _BAR)

    def setDefaultPressure(self, pressure) -> None:
        self._pressure = float(u.strip(pressure, _BAR))

    def _global_defaults(self) -> dict:
        return {self.Pressure(): self._pressure}

    def _compile(self, context) -> "RPMDBarostatModule":
        from ..integrators.rpmd import RPMDIntegrator
        if not isinstance(context._integrator, RPMDIntegrator):
            raise ValueError("RPMDMonteCarloBarostat must be used with an "
                             "RPMDIntegrator")
        return RPMDBarostatModule(self, context)


BAROSTATS = (MonteCarloBarostat, MonteCarloAnisotropicBarostat,
             MonteCarloMembraneBarostat, RPMDMonteCarloBarostat)


class BarostatModule:
    """One barostat compiled for a Context: its statistics as device
    tensors of one entry a slot (volumeScale, numAttempted, numAccepted,
    written in place, so every step program shares them), the molecules
    and the Context's global parameters it reads."""

    def __init__(self, force, context):
        dev = context._device
        self.kind = type(force)
        self.frequency = force.getFrequency()
        self.slots = force.SLOTS
        # the attempt's uniforms: the slot (not for the isotropic
        # barostat), the volume change, the Metropolis test
        self.n_uniforms = 2 if self.slots == 1 else 3
        box = context._system._box.copy()
        vol = float(box[0][0] * box[1][1] * box[2][2])
        self.volume_scale = torch.full((self.slots,), 0.01 * vol, dtype=F64,
                                       device=dev)
        self.num_attempted = torch.zeros(self.slots, dtype=torch.int64,
                                         device=dev)
        self.num_accepted = torch.zeros_like(self.num_attempted)
        self.n_molecules = context._n_molecules
        self.molecules = GroupSum(context._molecule_id, self.n_molecules,
                                  dev)
        self.masses = context._masses
        self.molecule_mass = self.molecules(self.masses[:, None])
        index = context._gp_index
        self._context = context
        self._temperature = (index[force.Temperature()]
                             if hasattr(force, "Temperature") else None)
        if self.kind is MonteCarloAnisotropicBarostat:
            names = (force.PressureX(), force.PressureY(), force.PressureZ())
            self._pressure = torch.as_tensor([index[p] for p in names],
                                             device=dev)
            axes = [i for i in range(3) if force._scale[i]]
            self._axes = torch.as_tensor(axes, device=dev)
            self._choices = len(axes)
        else:
            self._pressure = index[force.Pressure()]
            self._choices = self.slots
        if self.kind is MonteCarloMembraneBarostat:
            self._tension = index[force.SurfaceTension()]
            self._zmode = force.getZMode()
        self._slot_ids = torch.arange(self.slots, device=dev)

    def statistics(self) -> tuple:
        """(volumeScale, numAttempted, numAccepted): the tensors a step
        writes in place."""
        return self.volume_scale, self.num_attempted, self.num_accepted

    def fires(self, step: torch.Tensor) -> torch.Tensor:
        """Whether the step with `step` steps completed before it attempts
        (a device bool)."""
        return torch.remainder(step, self.frequency) == self.frequency - 1

    def fires_at(self, step: int) -> bool:
        return step % self.frequency == self.frequency - 1

    def attempts_in(self, first: int, steps: int) -> int:
        """Attempts among the steps first, ..., first + steps - 1 (the
        steps completed before each)."""
        f = self.frequency

        def upto(s):            # attempts among steps 0 .. s - 1
            return s // f
        return upto(first + steps) - upto(first)

    def draw(self, generator, device) -> torch.Tensor:
        return torch.rand(self.n_uniforms, generator=generator, dtype=F64,
                          device=device)

    def _move(self, box, vs, u):
        """(slot one-hot, dV, V, V_new, scale (3,)) of the move that the
        uniforms u pick: u[0] picks the slot among the enabled ones
        (the anisotropic barostat's axes, the membrane barostat's xy and
        z), the next uniform the volume change."""
        if self.slots == 1:
            slot = self._slot_ids == 0
            u_dv = u[0]
        else:
            pick = torch.clamp(
                torch.floor(u[0] * self._choices).to(torch.int64),
                max=self._choices - 1)
            if self.kind is MonteCarloAnisotropicBarostat:
                # index_select: indexing by a 0-d tensor reads it on the host
                pick = self._axes.index_select(0, pick.view(1)).view(())
            slot = self._slot_ids == pick
            u_dv = u[1]
        vol = box[0, 0] * box[1, 1] * box[2, 2]
        dv = (vs * slot).sum() * 2.0 * (u_dv - 0.5)
        new_vol = vol + dv
        ratio = new_vol / vol
        one = torch.ones_like(ratio)
        if self.slots == 1:
            ls = ratio ** (1.0 / 3.0)
            scale = torch.stack([ls, ls, ls])
        elif self.kind is MonteCarloAnisotropicBarostat:
            scale = torch.where(slot, ratio, one)
        else:
            sxy = torch.sqrt(ratio)
            constant = self._zmode == MonteCarloMembraneBarostat.ConstantVolume
            scale_xy = torch.stack([sxy, sxy, 1.0 / ratio if constant
                                    else one])
            # z moves only in ZFree (the other modes make none)
            scale_z = torch.stack([one, one, ratio
                                   if self._zmode
                                   == MonteCarloMembraneBarostat.ZFree
                                   else one])
            scale = torch.where(slot[0], scale_xy, scale_z)
        return slot, dv, vol, new_vol, scale

    def attempt(self, pos, box, u, gp, energy) -> dict:
        """One attempt at positions `pos` (n, 3) and box (3, 3), both
        float64, from the uniforms u (n_uniforms,) in [0, 1), the global
        parameters gp and energy(pos, box) -> (energy float64, overflow
        of its candidate state). Returns the positions and box after the
        Metropolis test, the new statistics, whether the move was
        accepted, w, the proposed box, and the trial states' overflow.
        Reads nothing on the host."""
        vs, n_att, n_acc = self.statistics()
        slot, dv, vol, new_vol, scale = self._move(box, vs, u)
        new_pos = self._scaled(pos, scale)
        if self.slots == 1:
            new_box = box * scale[0]
        else:
            new_box = box * scale[None, :]
        de, overflow = self._energy_change(pos, box, new_pos, new_box,
                                           energy)
        kT = BOLTZ * self._kelvin(gp)
        if self.slots == 1:
            work = gp[self._pressure] * PRESSURE_UNIT_FACTOR * dv
        elif self.kind is MonteCarloAnisotropicBarostat:
            p = (gp.index_select(0, self._pressure) * slot).sum()
            work = p * PRESSURE_UNIT_FACTOR * dv
        else:
            p_md = gp[self._pressure] * PRESSURE_UNIT_FACTOR
            gamma = gp[self._tension] * PRESSURE_UNIT_FACTOR
            d_area = new_box[0, 0] * new_box[1, 1] - box[0, 0] * box[1, 1]
            dv_eff = new_box[0, 0] * new_box[1, 1] * new_box[2, 2] - vol
            work = p_md * dv_eff - gamma * d_area
        w = de + work - self.n_molecules * kT * torch.log(new_vol / vol)
        accept = (w <= 0) | (u[-1] <= torch.exp(-w / kT))
        n_att = n_att + slot.to(n_att.dtype)
        n_acc = n_acc + (slot & accept).to(n_acc.dtype)
        att = (n_att * slot).sum()
        acc = (n_acc * slot).sum()
        # retune the slot's width every 10 attempts
        # (MonteCarloBarostatImpl.cpp:103)
        tune = att >= 10
        low = acc < 0.25 * att
        high = acc > 0.75 * att
        v = (vs * slot).sum()
        v = torch.where(tune & low, v / 1.1, v)
        v = torch.where(tune & high, torch.minimum(v * 1.1, vol * 0.3), v)
        reset = slot & tune & (low | high)
        return {"positions": torch.where(accept, new_pos, pos),
                "box": torch.where(accept, new_box, box),
                "volume_scale": torch.where(slot, v, vs),
                "num_attempted": torch.where(reset, 0, n_att),
                "num_accepted": torch.where(reset, 0, n_acc),
                "accept": accept, "w": w, "trial_box": new_box,
                "overflow": overflow}

    def _scaled(self, pos, scale):
        """The trial positions: each molecule's centre of mass scaled."""
        return scale_molecules(pos, self.molecules, self.masses,
                               self.molecule_mass, scale)

    def _energy_change(self, pos, box, new_pos, new_box, energy) -> tuple:
        """(E(trial) - E, the trial states' overflow)."""
        e0, ov0 = energy(pos, box)
        e1, ov1 = energy(new_pos, new_box)
        return e1 - e0, ov0 + ov1

    def _kelvin(self, gp):
        """The temperature of the Metropolis test, a device scalar."""
        return gp[self._temperature]

    def store(self, out: dict) -> None:
        """Write an attempt's statistics into the device tensors."""
        self.volume_scale.copy_(out["volume_scale"])
        self.num_attempted.copy_(out["num_attempted"])
        self.num_accepted.copy_(out["num_accepted"])


class RPMDBarostatModule(BarostatModule):
    """RPMDMonteCarloBarostat's attempt on the ring polymer's copies
    (K, n, 3): the centroid's molecules scaled, every copy shifted by the
    centroid's offset, the energy change averaged over the copies, the
    temperature the integrator's (its parameters on the device)."""

    def _scaled(self, pos, scale):
        centroid = pos.mean(dim=0)
        return pos + (super()._scaled(centroid, scale) - centroid)[None]

    def _energy_change(self, pos, box, new_pos, new_box, energy) -> tuple:
        de, overflow = None, None
        for old, new in zip(pos.unbind(0), new_pos.unbind(0)):
            d, ov = super()._energy_change(old, box, new, new_box, energy)
            de = d if de is None else de + d
            overflow = ov if overflow is None else overflow + ov
        return de / pos.shape[0], overflow

    def _kelvin(self, gp):
        return self._context._params[1]


__all__ = ["BAROSTATS", "BarostatModule", "MonteCarloAnisotropicBarostat",
           "MonteCarloBarostat", "MonteCarloMembraneBarostat",
           "PRESSURE_UNIT_FACTOR", "RPMDBarostatModule",
           "RPMDMonteCarloBarostat", "RPMDUpdater", "scale_molecules"]
