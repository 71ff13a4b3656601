"""Periodic table (the port's copy of openmm_tpu/app/element.py, after
OpenMM's wrappers/python/openmm/app/element.py)."""
from __future__ import annotations

from .. import unit as u


class Element(object):
    _elements_by_symbol = {}
    _elements_by_number = {}

    def __init__(self, number, name, symbol, mass):
        self._number = number
        self._name = name
        self._symbol = symbol
        self._mass = float(mass)
        Element._elements_by_symbol[symbol.upper()] = self
        Element._elements_by_number[number] = self

    @property
    def atomic_number(self):
        return self._number

    @property
    def name(self):
        return self._name

    @property
    def symbol(self):
        return self._symbol

    @property
    def mass(self):
        return u.Quantity(self._mass, u.dalton)

    @staticmethod
    def getBySymbol(symbol):
        return Element._elements_by_symbol[symbol.strip().upper()]

    @staticmethod
    def getByAtomicNumber(number):
        return Element._elements_by_number[number]

    @staticmethod
    def getByMass(mass):
        mass = float(u.strip(mass, u.dalton))
        best, best_diff = None, 1e30
        for el in Element._elements_by_number.values():
            d = abs(el._mass - mass)
            if d < best_diff:
                best, best_diff = el, d
        return best

    def __repr__(self):
        return "<Element %s>" % self._name


# CODATA/IUPAC standard atomic weights
_DATA = [
    (1, "hydrogen", "H", 1.007947), (2, "helium", "He", 4.003),
    (3, "lithium", "Li", 6.9412), (4, "beryllium", "Be", 9.0121823),
    (5, "boron", "B", 10.8117), (6, "carbon", "C", 12.01078),
    (7, "nitrogen", "N", 14.00672), (8, "oxygen", "O", 15.99943),
    (9, "fluorine", "F", 18.99840325), (10, "neon", "Ne", 20.17976),
    (11, "sodium", "Na", 22.989769282), (12, "magnesium", "Mg", 24.30506),
    (13, "aluminum", "Al", 26.98153868), (14, "silicon", "Si", 28.08553),
    (15, "phosphorus", "P", 30.9737622), (16, "sulfur", "S", 32.0655),
    (17, "chlorine", "Cl", 35.4532), (18, "argon", "Ar", 39.9481),
    (19, "potassium", "K", 39.09831), (20, "calcium", "Ca", 40.0784),
    (21, "scandium", "Sc", 44.9559126), (22, "titanium", "Ti", 47.8671),
    (23, "vanadium", "V", 50.94151), (24, "chromium", "Cr", 51.99616),
    (25, "manganese", "Mn", 54.9380455), (26, "iron", "Fe", 55.8452),
    (27, "cobalt", "Co", 58.9331955), (28, "nickel", "Ni", 58.69342),
    (29, "copper", "Cu", 63.5463), (30, "zinc", "Zn", 65.4094),
    (31, "gallium", "Ga", 69.7231), (32, "germanium", "Ge", 72.641),
    (33, "arsenic", "As", 74.921602), (34, "selenium", "Se", 78.963),
    (35, "bromine", "Br", 79.9041), (36, "krypton", "Kr", 83.7982),
    (37, "rubidium", "Rb", 85.46783), (38, "strontium", "Sr", 87.621),
    (39, "yttrium", "Y", 88.905852), (40, "zirconium", "Zr", 91.2242),
    (41, "niobium", "Nb", 92.906382), (42, "molybdenum", "Mo", 95.942),
    (43, "technetium", "Tc", 98.0), (44, "ruthenium", "Ru", 101.072),
    (45, "rhodium", "Rh", 102.905502), (46, "palladium", "Pd", 106.421),
    (47, "silver", "Ag", 107.86822), (48, "cadmium", "Cd", 112.4118),
    (49, "indium", "In", 114.8183), (50, "tin", "Sn", 118.7107),
    (51, "antimony", "Sb", 121.7601), (52, "tellurium", "Te", 127.603),
    (53, "iodine", "I", 126.904473), (54, "xenon", "Xe", 131.2936),
    (55, "cesium", "Cs", 132.90545192), (56, "barium", "Ba", 137.3277),
    (57, "lanthanum", "La", 138.905477), (58, "cerium", "Ce", 140.1161),
    (59, "praseodymium", "Pr", 140.907652), (60, "neodymium", "Nd", 144.2423),
    (61, "promethium", "Pm", 145.0), (62, "samarium", "Sm", 150.362),
    (63, "europium", "Eu", 151.9641), (64, "gadolinium", "Gd", 157.253),
    (65, "terbium", "Tb", 158.925352), (66, "dysprosium", "Dy", 162.5001),
    (67, "holmium", "Ho", 164.930322), (68, "erbium", "Er", 167.2593),
    (69, "thulium", "Tm", 168.934212), (70, "ytterbium", "Yb", 173.043),
    (71, "lutetium", "Lu", 174.9671), (72, "hafnium", "Hf", 178.492),
    (73, "tantalum", "Ta", 180.947882), (74, "tungsten", "W", 183.841),
    (75, "rhenium", "Re", 186.2071), (76, "osmium", "Os", 190.233),
    (77, "iridium", "Ir", 192.2173), (78, "platinum", "Pt", 195.0849),
    (79, "gold", "Au", 196.9665694), (80, "mercury", "Hg", 200.592),
    (81, "thallium", "Tl", 204.38332), (82, "lead", "Pb", 207.21),
    (83, "bismuth", "Bi", 208.980401), (84, "polonium", "Po", 209.0),
    (85, "astatine", "At", 210.0), (86, "radon", "Rn", 222.018),
    (87, "francium", "Fr", 223.0), (88, "radium", "Ra", 226.0),
    (89, "actinium", "Ac", 227.0), (90, "thorium", "Th", 232.038062),
    (91, "protactinium", "Pa", 231.035882), (92, "uranium", "U", 238.028913),
    (93, "neptunium", "Np", 237.0), (94, "plutonium", "Pu", 244.0),
]
for _n, _name, _sym, _mass in _DATA:
    globals()[_name] = Element(_n, _name, _sym, _mass)

hydrogen = Element._elements_by_symbol["H"]
carbon = Element._elements_by_symbol["C"]
nitrogen = Element._elements_by_symbol["N"]
oxygen = Element._elements_by_symbol["O"]
sulfur = Element._elements_by_symbol["S"]
