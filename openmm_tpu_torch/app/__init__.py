"""The application layer of the port: units-aware structure files, force
fields, Simulation and its reporters, and the Amber GB recipes.

Ported so far from openmm_tpu/app/: Element, Topology (with Chain,
Residue and Atom), PDBFile, ForceField with its generators
(ffgenerators.py) and the method, constraint and GB-model singletons,
Simulation, StateDataReporter, DCDReporter with DCDFile, PDBReporter,
CheckpointReporter, gbforces and the membrane patch loader of modeller.py.
The rest (Modeller, the Amber, CHARMM, GROMACS, PDBx and DMS readers,
Metadynamics, SimulatedTempering) is ROADMAP item 9's remainder.
"""
from .checkpointreporter import CheckpointReporter
from .dcdreporter import DCDFile, DCDReporter
from .element import Element
from .forcefield import (AllBonds, CutoffNonPeriodic, CutoffPeriodic, Ewald,
                         ForceField, GBn, GBn2, HAngles, HBonds, HCT, LJPME,
                         NoCutoff, OBC1, OBC2, PME)
from .pdbfile import PDBFile
from .pdbreporter import PDBReporter
from .simulation import Simulation
from .statedatareporter import StateDataReporter
from .topology import Atom, Chain, Residue, Topology

__all__ = [
    "Element", "Topology", "Chain", "Residue", "Atom", "PDBFile",
    "ForceField", "Simulation", "StateDataReporter", "DCDReporter", "DCDFile",
    "PDBReporter", "CheckpointReporter",
    "HBonds", "AllBonds", "HAngles", "NoCutoff", "CutoffNonPeriodic",
    "CutoffPeriodic", "Ewald", "PME", "LJPME",
    "HCT", "OBC1", "OBC2", "GBn", "GBn2",
]
