"""The application layer of the port: units-aware structure files, force
fields, Simulation and its reporters, Modeller, the file readers and the
enhanced-sampling methods.

The port's copy of openmm_tpu/app/: Element, Topology (with Chain,
Residue and Atom), PDBFile, PDBxFile, ForceField with its generators
(ffgenerators.py) and the method, constraint and GB-model singletons,
Simulation, StateDataReporter, DCDReporter with DCDFile, PDBReporter,
PDBxReporter, CheckpointReporter, Modeller, the Amber (AmberPrmtopFile,
AmberInpcrdFile), CHARMM (CharmmPsfFile, CharmmParameterSet,
CharmmCrdFile), GROMACS (GromacsGroFile, GromacsTopFile) and Desmond
(DesmondDMSFile) readers, Metadynamics with BiasVariable,
SimulatedTempering, and gbforces.
"""
from .element import Element
from .topology import Topology, Chain, Residue, Atom
from .pdbfile import PDBFile
from .forcefield import (AllBonds, CutoffNonPeriodic, CutoffPeriodic, Ewald,
                         ForceField, GBn, GBn2, HAngles, HBonds, HCT, LJPME,
                         NoCutoff, OBC1, OBC2, PME)
from .simulation import Simulation
from .statedatareporter import StateDataReporter
from .dcdreporter import DCDReporter, DCDFile
from .pdbreporter import PDBReporter
from .checkpointreporter import CheckpointReporter
from .modeller import Modeller
from .metadynamics import Metadynamics, BiasVariable
from .simulatedtempering import SimulatedTempering
from .amberprmtopfile import AmberPrmtopFile
from .amberinpcrdfile import AmberInpcrdFile
from .charmmfiles import CharmmPsfFile, CharmmParameterSet, CharmmCrdFile
from .gromacsgrofile import GromacsGroFile
from .gromacstopfile import GromacsTopFile
from .pdbxfile import PDBxFile
from .pdbxreporter import PDBxReporter
from .desmonddmsfile import DesmondDMSFile

__all__ = [
    "Element", "Topology", "Chain", "Residue", "Atom", "PDBFile",
    "ForceField", "Simulation", "StateDataReporter", "DCDReporter", "DCDFile",
    "PDBReporter", "CheckpointReporter", "Modeller",
    "Metadynamics", "BiasVariable", "SimulatedTempering",
    "AmberPrmtopFile", "AmberInpcrdFile",
    "CharmmPsfFile", "CharmmParameterSet", "CharmmCrdFile", "GromacsGroFile",
    "GromacsTopFile", "PDBxFile", "PDBxReporter", "DesmondDMSFile",
    "HBonds", "AllBonds", "HAngles", "NoCutoff", "CutoffNonPeriodic",
    "CutoffPeriodic", "Ewald", "PME", "LJPME",
    "HCT", "OBC1", "OBC2", "GBn", "GBn2",
]
