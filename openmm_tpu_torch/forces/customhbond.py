"""CustomHbondForce: an energy of every donor-acceptor pair over the
distances, angles and dihedrals of the donors' and acceptors' particles.

Counterpart of openmm_tpu/forces/customhbond.py (CustomHbondForce.h): a
donor is up to three particles d1, d2, d3 and an acceptor a1, a2, a3
(-1 for an unused slot, read as particle 0, as the JAX package reads
it), each with its own parameters; the expression reads distance(),
angle() and dihedral() of those six points, the donor's and the
acceptor's parameters by name and the global parameters. Every pair of a
donor and an acceptor but the excluded ones counts, within the cutoff
from d1 to a1 unless the method is NoCutoff (minimum images with
CutoffPeriodic). As the JAX package evaluates the pairs densely, the
pairs are the terms of forces/custom.py's points module, listed once
when the Context is built (the excluded ones left out), the cutoff a
mask a step; float64, the geometry's gradients by hand and the sums by a
gather table.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import unit as u
from ..ops import geometry as geom
from .base import Force
from .custom import _CustomMixin, _params, _PointsModule

POINTS = ("d1", "d2", "d3", "a1", "a2", "a3")


class CustomHbondForce(_CustomMixin, Force):
    NoCutoff = 0
    CutoffNonPeriodic = 1
    CutoffPeriodic = 2

    def __init__(self, energy):
        super().__init__()
        self._init_custom(energy)
        self._per_donor = []
        self._per_acceptor = []
        self._donors = []             # ((d1, d2, d3), params)
        self._acceptors = []          # ((a1, a2, a3), params)
        self._exclusions = []         # (donor, acceptor)
        self._method = CustomHbondForce.NoCutoff
        self._cutoff = 1.0

    def getNumPerDonorParameters(self) -> int:
        return len(self._per_donor)

    def addPerDonorParameter(self, name) -> int:
        self._per_donor.append(str(name))
        return len(self._per_donor) - 1

    def getPerDonorParameterName(self, index) -> str:
        return self._per_donor[index]

    def getNumPerAcceptorParameters(self) -> int:
        return len(self._per_acceptor)

    def addPerAcceptorParameter(self, name) -> int:
        self._per_acceptor.append(str(name))
        return len(self._per_acceptor) - 1

    def getPerAcceptorParameterName(self, index) -> str:
        return self._per_acceptor[index]

    def getNumDonors(self) -> int:
        return len(self._donors)

    def addDonor(self, d1, d2, d3, parameters=()) -> int:
        self._donors.append(((int(d1), int(d2), int(d3)),
                             [float(u.strip(p)) for p in parameters]))
        return len(self._donors) - 1

    def getDonorParameters(self, index):
        (d1, d2, d3), params = self._donors[index]
        return d1, d2, d3, list(params)

    def setDonorParameters(self, index, d1, d2, d3, parameters=()) -> None:
        self._donors[index] = ((int(d1), int(d2), int(d3)),
                               [float(u.strip(p)) for p in parameters])

    def getNumAcceptors(self) -> int:
        return len(self._acceptors)

    def addAcceptor(self, a1, a2, a3, parameters=()) -> int:
        self._acceptors.append(((int(a1), int(a2), int(a3)),
                                [float(u.strip(p)) for p in parameters]))
        return len(self._acceptors) - 1

    def getAcceptorParameters(self, index):
        (a1, a2, a3), params = self._acceptors[index]
        return a1, a2, a3, list(params)

    def setAcceptorParameters(self, index, a1, a2, a3,
                              parameters=()) -> None:
        self._acceptors[index] = ((int(a1), int(a2), int(a3)),
                                  [float(u.strip(p)) for p in parameters])

    def getNumExclusions(self) -> int:
        return len(self._exclusions)

    def addExclusion(self, donor, acceptor) -> int:
        self._exclusions.append((int(donor), int(acceptor)))
        return len(self._exclusions) - 1

    def getExclusionParticles(self, index):
        return self._exclusions[index]

    def setExclusionParticles(self, index, donor, acceptor) -> None:
        self._exclusions[index] = (int(donor), int(acceptor))

    def getNonbondedMethod(self) -> int:
        return self._method

    def setNonbondedMethod(self, method) -> None:
        self._method = int(method)

    def getCutoffDistance(self) -> float:
        return self._cutoff

    def setCutoffDistance(self, distance) -> None:
        self._cutoff = float(u.strip(distance, u.nanometer))

    def usesPeriodicBoundaryConditions(self) -> bool:
        return self._method == CustomHbondForce.CutoffPeriodic

    def _pairs(self) -> np.ndarray:
        """(pairs, 2) of (donor, acceptor), every pair but the excluded,
        donor-major."""
        nd, na = len(self._donors), len(self._acceptors)
        keep = np.ones((nd, na), bool)
        for d, a in self._exclusions:
            keep[d, a] = False
        return np.argwhere(keep).astype(np.int64).reshape(-1, 2)

    def _terms_arrays(self):
        """The pairs as terms: (pairs, 6) particles d1..a3 (an unused slot
        read as particle 0) and (pairs, donor + acceptor parameters)."""
        pairs = self._pairs()
        d_idx = np.asarray([d[0] for d in self._donors],
                           np.int64).reshape(-1, 3)
        a_idx = np.asarray([a[0] for a in self._acceptors],
                           np.int64).reshape(-1, 3)
        dp = _params([d[1] for d in self._donors], len(self._per_donor))
        ap = _params([a[1] for a in self._acceptors],
                     len(self._per_acceptor))
        idx = np.maximum(np.concatenate([d_idx[pairs[:, 0]],
                                         a_idx[pairs[:, 1]]], axis=1), 0)
        return idx, np.concatenate([dp[pairs[:, 0]], ap[pairs[:, 1]]],
                                   axis=1)

    def _compile(self, ctx):
        return _HbondModule(self, ctx)


class _HbondModule(_PointsModule):
    def __init__(self, force, ctx):
        idx, params = force._terms_arrays()
        super().__init__(force, ctx, idx, params, POINTS,
                         names=force._per_donor + force._per_acceptor,
                         scalar_coords=False)
        self.cutoff = (None if force.getNonbondedMethod()
                       == CustomHbondForce.NoCutoff
                       else force.getCutoffDistance())

    def _points(self, pos):
        return pos[self.idx]

    def _mask(self, pos, box):
        if self.cutoff is None:
            return None
        d = geom.delta(pos[self.idx[:, 0]], pos[self.idx[:, 3]],
                       box.to(torch.float64) if self.periodic else None)
        return (d * d).sum(dim=-1) < self.cutoff * self.cutoff
