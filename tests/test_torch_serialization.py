"""openmm_tpu_torch.serialization (XmlSerializer) against the JAX
package's openmm_tpu.serialization.

- Each of the 33 force types of the JAX package's registries and each of
  its 18 integrator types, built the same way in both packages (the
  builders of tests/test_torch_state_units.py, and here the AMOEBA and
  HIPPO forces): the two packages' XML parses to equal element trees;
  the port reads the JAX XML and writes it again unchanged, with the
  getter values of the JAX object; the JAX package reads the port's XML
  as it reads its own. Where the JAX reader refuses a type (the AMD,
  Compound, DrudeNoseHoover and MTS integrators), the port's refuses it
  too.
- The cases of tests/test_serialization.py, on the port.
- A System the JAX package writes (the TIP3P box with bonded and custom
  forces; the port's TIP4P-Ew box with its virtual sites, carried into
  the JAX package) reads in the port to the parameters of
  torch_port_helpers.system_params, and the water box's energy and forces
  on the port's float64 path agree with the JAX "Reference" platform by
  force group (1e-10 relative, 1e-10 of the largest force).
- A State round trip is exact in bits, both ways between the packages.
"""
import xml.etree.ElementTree as ET

import numpy as np
import pytest

import openmm_tpu as J
from openmm_tpu import unit as ju
from openmm_tpu.serialization import XmlSerializer as JX

import openmm_tpu_torch as T
from openmm_tpu_torch.exceptions import OpenMMException
from openmm_tpu_torch.serialization import XmlSerializer as TX
from openmm_tpu_torch.unit import plain
from test_torch_state_units import _build, _call, _same
from torch_port_helpers import (assert_same_params, jax_system,
                                system_params)

E_TOL = 1e-10
F_TOL = 1e-10

FORCES = (
    "HarmonicBondForce", "HarmonicAngleForce", "PeriodicTorsionForce",
    "RBTorsionForce", "CMAPTorsionForce", "NonbondedForce", "GBSAOBCForce",
    "CMMotionRemover", "AndersenThermostat", "MonteCarloBarostat",
    "RMSDForce", "CustomBondForce", "CustomExternalForce",
    "CustomNonbondedForce", "CustomAngleForce", "CustomTorsionForce",
    "CustomCompoundBondForce", "CustomCentroidBondForce", "CustomGBForce",
    "GayBerneForce", "DrudeForce", "CustomHbondForce",
    "CustomManyParticleForce", "CustomCVForce",
    "MonteCarloAnisotropicBarostat", "MonteCarloMembraneBarostat",
    "AmoebaVdwForce", "AmoebaMultipoleForce", "AmoebaTorsionTorsionForce",
    "AmoebaWcaDispersionForce", "AmoebaGeneralizedKirkwoodForce",
    "HippoNonbondedForce", "RPMDMonteCarloBarostat")
INTEGRATORS = (
    "VerletIntegrator", "LangevinIntegrator", "LangevinMiddleIntegrator",
    "BrownianIntegrator", "VariableVerletIntegrator",
    "VariableLangevinIntegrator", "NoseHooverIntegrator",
    "CustomIntegrator", "CompoundIntegrator", "MTSIntegrator",
    "MTSLangevinIntegrator", "AMDIntegrator", "AMDForceGroupIntegrator",
    "DualAMDIntegrator", "DrudeLangevinIntegrator", "DrudeSCFIntegrator",
    "DrudeNoseHooverIntegrator", "RPMDIntegrator")
# the types the JAX package writes and does not read
REFUSED = {"CompoundIntegrator", "MTSIntegrator", "MTSLangevinIntegrator",
           "AMDIntegrator", "AMDForceGroupIntegrator", "DualAMDIntegrator",
           "DrudeNoseHooverIntegrator"}


def _amoeba(pkg, name):
    """The AMOEBA and HIPPO forces of tests/test_serialization.py, built
    in package `pkg`."""
    if name == "AmoebaVdwForce":
        f = pkg.AmoebaVdwForce()
        f.addParticle(0, 0.35, 0.5, 1.0)
        f.addParticle(0, 0.28, 0.1, 0.91)
        f.setParticleExclusions(0, [1])
        f.setCutoffDistance(1.2)
        return f
    if name == "AmoebaMultipoleForce":
        f = pkg.AmoebaMultipoleForce()
        f.addMultipole(0.5, [0, 0, 0.01], [0.0] * 9,
                       pkg.AmoebaMultipoleForce.ZThenX, 1, -1, -1, 0.39, 0.3,
                       0.001)
        f.addMultipole(-0.5, [0, 0, 0], [0.0] * 9,
                       pkg.AmoebaMultipoleForce.NoAxisType, -1, -1, -1,
                       0.39, 0.3, 0.0008)
        f.setCovalentMap(0, pkg.AmoebaMultipoleForce.Covalent12, [1])
        f.setPolarizationType(pkg.AmoebaMultipoleForce.Extrapolated)
        return f
    if name == "AmoebaTorsionTorsionForce":
        f = pkg.AmoebaTorsionTorsionForce()
        f.addTorsionTorsion(0, 1, 2, 3, 4, 5, 0)
        xs = [-180.0, -60.0, 60.0, 180.0]
        f.setTorsionTorsionGrid(0, [[[a1, a2, 0.1 * a1 + 0.2 * a2, 0.1, 0.2,
                                      0.0] for a2 in xs] for a1 in xs])
        return f
    if name == "AmoebaWcaDispersionForce":
        f = pkg.AmoebaWcaDispersionForce()
        f.addParticle(0.2, 0.4)
        f.setDispoff(0.3)
        return f
    if name == "AmoebaGeneralizedKirkwoodForce":
        f = pkg.AmoebaGeneralizedKirkwoodForce()
        f.addParticle(-0.5, 0.15, 0.69)
        f.addParticle(0.25, 0.12, 0.8)
        return f
    f = pkg.HippoNonbondedForce()
    f.setExtrapolationCoefficients([0.042, 0.635, 0.414])
    f.addParticle(-0.38, [0.0, 0.0, 0.003], [0.01, 0, 0, 0, -0.02, 0, 0, 0,
                                              0.01], 6.0, 47.0, 5548.0,
                  400.0, 0.0384, 5.5, -2.42, 43.1, 0.0008,
                  pkg.HippoNonbondedForce.Bisector, 1, 2, -1)
    f.addParticle(0.19, [0.0, 0.0, -0.01], [0.001, 0, 0, 0, 0.002, 0, 0, 0,
                                             -0.003], 1.0, 47.9, 0.0, 35.6,
                  0.0093, 4.1, -0.81, 46.4, 0.0003,
                  pkg.HippoNonbondedForce.ZThenX, 0, 2, -1)
    f.addException(0, 1, 0.0, 0.0, 0.2, 0.0, 0.0, 0.0)
    return f


def _make(pkg, name):
    if name.startswith("Amoeba") or name == "HippoNonbondedForce":
        obj = _amoeba(pkg, name)
    else:
        obj = _build(pkg, name)
    if isinstance(obj, (J.Force, T.Force)):
        obj.setForceGroup(3)
        obj.setName("the " + name)
    return obj


def _tree(xml):
    def walk(el):
        return (el.tag, dict(el.attrib), (el.text or "").strip(),
                [walk(c) for c in el])
    return walk(ET.fromstring(xml))


def _same_getters(got, want, name):
    compared = 0
    for getter in sorted(m for m in dir(want) if m.startswith("get")):
        if not callable(getattr(want, getter)) or getter in (
                "getVelocitiesForTemperature", "getPerDofVariable",
                "getPerDofVariableByName"):
            continue
        w = _call(want, getter)
        if w is None or w[0] == "raised":
            continue
        g = _call(got, getter)
        assert g is not None and g[0] == "ok", (name, getter, g)
        # a grid set as nested lists reads back as the array it is stored
        # as once it came through XML, in either package
        _same(*(v.tolist() if isinstance(v, np.ndarray) else v
                for v in (g[1], w[1])), "%s.%s" % (name, getter))
        compared += 1
    assert compared > 0


@pytest.mark.parametrize("name", FORCES + INTEGRATORS)
def test_both_ways_to_equal_trees(name):
    jobj, tobj = _make(J, name), _make(T, name)
    jxml, txml = JX.serialize(jobj), TX.serialize(tobj)
    assert _tree(txml) == _tree(jxml)
    if name in REFUSED:
        for reader, xml in ((JX, txml), (TX, jxml)):
            with pytest.raises(Exception, match="cannot deserialize "
                               "integrator type %s" % name):
                reader.deserialize(xml)
        return
    # the port reads the JAX XML with no loss, to the JAX object's getters
    port = TX.deserialize(jxml)
    assert type(port).__name__ == name
    assert _tree(TX.serialize(port)) == _tree(jxml)
    _same_getters(port, jobj, name)
    # the JAX package reads the port's XML as its own
    assert _tree(JX.serialize(JX.deserialize(txml))) == _tree(
        JX.serialize(JX.deserialize(jxml)))


def test_refused_objects_raise_alike():
    for pkg, ser in ((J, JX), (T, TX)):
        with pytest.raises(Exception, match="cannot serialize"):
            ser.serialize(object())
        with pytest.raises(Exception, match="cannot deserialize <Foo>"):
            ser.deserialize("<Foo/>")
        with pytest.raises(Exception, match="force type NoSuchForce"):
            ser.deserialize('<Force type="NoSuchForce"/>')
    with pytest.raises(OpenMMException):
        TX.deserialize('<Integrator type="NoSuchIntegrator"/>')


# --- the cases of tests/test_serialization.py on the port -------------------
def _energy(system, positions):
    ctx = T.Context(system, T.VerletIntegrator(0.001), "CPU",
                    {"Precision": "double"})
    ctx.setPositions(positions)
    return plain(ctx.getState(getEnergy=True).getPotentialEnergy())


def test_system_roundtrip():
    from openmm_tpu_torch.models import tip3p_water_box
    system, positions = tip3p_water_box(8)
    hb = T.HarmonicBondForce()
    hb.addBond(0, 3, 0.5, 100.0)
    system.addForce(hb)
    system2 = TX.deserialize(TX.serialize(system))
    assert system2.getNumParticles() == system.getNumParticles()
    assert system2.getNumConstraints() == system.getNumConstraints()
    assert system2.getNumForces() == system.getNumForces()
    e1, e2 = _energy(system, positions), _energy(system2, positions)
    assert e1 == e2


def test_virtual_site_roundtrip():
    system = T.System()
    for _ in range(3):
        system.addParticle(1.0)
    system.addParticle(0.0)
    system.setVirtualSite(3, T.TwoParticleAverageSite(0, 1, 0.4, 0.6))
    system2 = TX.deserialize(TX.serialize(system))
    assert system2.isVirtualSite(3)
    vs = system2.getVirtualSite(3)
    assert vs.getParticle(0) == 0 and vs.getParticle(1) == 1
    assert vs.getWeight(0) == 0.4 and vs.getWeight(1) == 0.6


def test_custom_forces_roundtrip():
    system = T.System()
    system.addParticle(1.0)
    system.addParticle(1.0)
    cb = T.CustomBondForce("k*(r-r0)^2")
    cb.addGlobalParameter("k", 10.0)
    cb.addPerBondParameter("r0")
    cb.addBond(0, 1, [1.1])
    system.addForce(cb)
    cnb = T.CustomNonbondedForce("a1*a2/r")
    cnb.addPerParticleParameter("a")
    cnb.addParticle([1.0])
    cnb.addParticle([2.0])
    cnb.addExclusion(0, 1)
    system.addForce(cnb)
    system2 = TX.deserialize(TX.serialize(system))
    cb2, cnb2 = system2.getForces()
    assert cb2.getEnergyFunction() == "k*(r-r0)^2"
    assert cb2.getNumBonds() == 1
    assert cnb2.getNumExclusions() == 1


def test_integrator_roundtrip():
    integ = T.LangevinMiddleIntegrator(310.0, 2.0, 0.004)
    integ.setConstraintTolerance(1e-6)
    integ2 = TX.deserialize(TX.serialize(integ))
    assert type(integ2) is T.LangevinMiddleIntegrator
    assert plain(integ2.getTemperature()) == 310.0
    assert plain(integ2.getStepSize()) == 0.004
    assert integ2.getConstraintTolerance() == 1e-6


def test_state_roundtrip():
    system = T.System()
    system.addParticle(1.0)
    system.addParticle(2.0)
    nb = T.NonbondedForce()
    nb.addParticle(0.5, 0.3, 0.5)
    nb.addParticle(-0.5, 0.3, 0.5)
    system.addForce(nb)
    ctx = T.Context(system, T.VerletIntegrator(0.002), "CPU",
                    {"Precision": "double"})
    ctx.setPositions([T.Vec3(0, 0, 0), T.Vec3(1, 0, 0)])
    ctx.setVelocities([T.Vec3(0.1, 0, 0), T.Vec3(0, 0.2, 0)])
    ctx.setTime(3.5)
    st = ctx.getState(getPositions=True, getVelocities=True, getEnergy=True,
                      getParameters=True)
    st2 = TX.deserialize(TX.serialize(st))
    assert plain(st2.getTime()) == 3.5
    np.testing.assert_array_equal(plain(st2.getPositions(asNumpy=True)),
                                  plain(st.getPositions(asNumpy=True)))
    assert plain(st2.getPotentialEnergy()) == plain(st.getPotentialEnergy())
    ctx2 = T.Context(system, T.VerletIntegrator(0.002), "CPU")
    ctx2.setState(st2)
    assert plain(ctx2.getTime()) == 3.5


def test_simulation_save_state(tmp_path):
    from openmm_tpu_torch.app import Element, Simulation, Topology
    system = T.System()
    system.addParticle(1.0)
    nb = T.NonbondedForce()
    nb.addParticle(0.0, 0.3, 0.1)
    system.addForce(nb)
    top = Topology()
    res = top.addResidue("UNK", top.addChain())
    top.addAtom("X", Element.getBySymbol("C"), res)
    cpu = T.Platform.getPlatformByName("CPU")
    sim = Simulation(top, system, T.VerletIntegrator(0.001), cpu)
    sim.context.setPositions([T.Vec3(0.5, 0.5, 0.5)])
    sim.step(7)
    path = str(tmp_path / "state.xml")
    sim.saveState(path)
    sim2 = Simulation(top, system, T.VerletIntegrator(0.001), cpu)
    sim2.loadState(path)
    assert sim2.context.getStepCount() == 7 == sim2.currentStep


def test_extended_forces_roundtrip():
    hb = T.CustomHbondForce("k*(distance(d1,a1)-r0)^2")
    hb.addPerDonorParameter("k")
    hb.addPerAcceptorParameter("r0")
    hb.addDonor(0, 1, 2, [10.0])
    hb.addAcceptor(3, 4, -1, [0.2])
    hb.addExclusion(0, 0)
    hb.setNonbondedMethod(T.CustomHbondForce.CutoffNonPeriodic)
    hb.setCutoffDistance(0.7)
    mp = T.CustomManyParticleForce(3, "C*(1+3*cos(angle(p1,p2,p3)))")
    mp.addGlobalParameter("C", 2.5)
    for _ in range(4):
        mp.addParticle([], 0)
    mp.addExclusion(0, 1)
    cv = T.CustomCVForce("v1^2 + 2*v2")
    inner1 = T.CustomBondForce("r")
    inner1.addBond(0, 1, [])
    inner2 = T.RMSDForce([T.Vec3(0, 0, 0), T.Vec3(0.1, 0, 0)], [0, 1])
    cv.addCollectiveVariable("v1", inner1)
    cv.addCollectiveVariable("v2", inner2)
    aniso = T.MonteCarloAnisotropicBarostat([1.0, 1.5, 2.0], 300.0, True,
                                            False, True, 17)
    aniso.setRandomNumberSeed(42)
    mem = T.MonteCarloMembraneBarostat(
        1.0, 5.0, 310.0, T.MonteCarloMembraneBarostat.XYIsotropic,
        T.MonteCarloMembraneBarostat.ZFree, 31)
    for force in (hb, mp, cv, aniso, mem):
        xml = TX.serialize(force)
        assert TX.serialize(TX.deserialize(xml)) == xml
    hb2 = TX.deserialize(TX.serialize(hb))
    assert hb2.getNumDonors() == 1 and hb2.getNumAcceptors() == 1
    assert hb2.getDonorParameters(0) == (0, 1, 2, [10.0])
    aniso2 = TX.deserialize(TX.serialize(aniso))
    assert aniso2.getScaleY() is False
    assert aniso2.getRandomNumberSeed() == 42
    assert aniso2.getFrequency() == 17


def test_extended_integrators_roundtrip():
    nh = T.NoseHooverIntegrator(320.0, 40.0, 0.002, 4, 3, 5)
    dl = T.DrudeLangevinIntegrator(300.0, 5.0, 1.0, 20.0, 0.001)
    dl.setMaxDrudeDistance(0.02)
    scf = T.DrudeSCFIntegrator(0.0005)
    rp = T.RPMDIntegrator(8, 300.0, 1.0, 0.0005)
    ci = T.CustomIntegrator(0.001)
    ci.addGlobalVariable("a", 3.5)
    ci.addPerDofVariable("x1", 0.0)
    ci.addUpdateContextState()
    ci.addComputePerDof("v", "v+dt*f/m")
    ci.beginIfBlock("a > 2")
    ci.addComputeGlobal("a", "a-1")
    ci.endBlock()
    ci.addComputePerDof("x", "x+dt*v")
    ci.addConstrainPositions()
    for integ in (nh, dl, scf, rp, ci):
        xml = TX.serialize(integ)
        assert TX.serialize(TX.deserialize(xml)) == xml
    ci2 = TX.deserialize(TX.serialize(ci))
    assert ci2.getNumComputations() == ci.getNumComputations()
    assert ci2.getGlobalVariableByName("a") == 3.5
    nh2 = TX.deserialize(TX.serialize(nh))
    assert nh2.getThermostat(0).getChainLength() == 4
    assert nh2.getThermostat(0).getNumYoshidaSuzukiTimeSteps() == 5
    # a CustomIntegrator read back runs
    system = T.System()
    system.addParticle(1.0)
    ctx = T.Context(system, ci2, "CPU")
    ctx.setPositions([T.Vec3(0, 0, 0)])
    ci2.step(2)
    assert ctx.getStepCount() == 2


def test_amoeba_forces_roundtrip():
    for name in ("AmoebaVdwForce", "AmoebaMultipoleForce",
                 "AmoebaTorsionTorsionForce", "AmoebaWcaDispersionForce"):
        xml = TX.serialize(_amoeba(T, name))
        assert TX.serialize(TX.deserialize(xml)) == xml, name
    rb = T.RPMDMonteCarloBarostat(2.5, 10)
    xml = TX.serialize(rb)
    assert TX.serialize(TX.deserialize(xml)) == xml
    mp2 = TX.deserialize(TX.serialize(_amoeba(T, "AmoebaMultipoleForce")))
    assert mp2.getCovalentMap(0, T.AmoebaMultipoleForce.Covalent12) == [1]
    assert mp2.getMultipoleParameters(0)[0] == 0.5


def test_gk_and_hippo_roundtrip():
    system = T.System()
    for _ in range(2):
        system.addParticle(1.0)
    hippo = _amoeba(T, "HippoNonbondedForce")
    system.addForce(hippo)
    s2 = TX.deserialize(TX.serialize(system))
    (h2,) = s2.getForces()
    assert h2.getNumParticles() == 2 and h2.getNumExceptions() == 1
    assert h2.getParticleParameters(0)[:1] == hippo.getParticleParameters(
        0)[:1]
    gk_sys = T.System()
    gk_sys.addParticle(1.0)
    mp = T.AmoebaMultipoleForce()
    mp.addMultipole(-0.5, [0, 0, 0], [0.0] * 9, 5, -1, -1, -1, 0.39, 0.3,
                    0.0)
    gk = T.AmoebaGeneralizedKirkwoodForce()
    gk.addParticle(-0.5, 0.15, 0.69)
    gk_sys.addForce(mp)
    gk_sys.addForce(gk)
    (_, g2) = TX.deserialize(TX.serialize(gk_sys)).getForces()
    c, r, sf = g2.getParticleParameters(0)
    assert plain(r) == 0.15 and sf == 0.69


# --- Systems across the packages ----------------------------------------------
def _jax_water_system():
    """The JAX package's 27-water PME box with bonded and custom forces."""
    from openmm_tpu.models import tip3p_water_box
    system, pos = tip3p_water_box(27)
    bonds = J.HarmonicBondForce()
    angles = J.HarmonicAngleForce()
    torsions = J.PeriodicTorsionForce()
    for w in range(0, 24, 3):
        bonds.addBond(3 * w, 3 * w + 3, 0.31, 800.0)
        angles.addAngle(3 * w, 3 * w + 3, 3 * w + 6, 1.9, 50.0)
        torsions.addTorsion(3 * w, 3 * w + 3, 3 * w + 6, 3 * w + 9, 3, 0.4,
                            2.0)
    external = J.CustomExternalForce("k*(x-x0)^2")
    external.addPerParticleParameter("k")
    external.addPerParticleParameter("x0")
    for i in range(0, 81, 7):
        external.addParticle(i, [100.0 + i, 0.5])
    for group, force in enumerate((bonds, angles, torsions, external), 1):
        force.setForceGroup(group)
        system.addForce(force)
    return system, np.asarray(pos, np.float64)


def test_jax_system_reads_to_system_params_and_its_energy():
    jsys, pos = _jax_water_system()
    system = TX.deserialize(JX.serialize(jsys))
    assert_same_params(T.to_numpy(system), system_params(jsys))
    jctx = J.Context(jsys, J.VerletIntegrator(0.001),
                     J.Platform.getPlatformByName("Reference"))
    jctx.setPositions(pos)
    ctx = T.Context(system, T.VerletIntegrator(0.001), "CPU",
                    {"Precision": "double"})
    ctx.setPositions(pos)
    for groups in (-1, {0}, {1}, {2}, {3}, {4}):
        want = jctx.getState(getEnergy=True, getForces=True, groups=groups)
        got = ctx.getState(getEnergy=True, getForces=True, groups=groups)
        e_ref = float(ju.strip(want.getPotentialEnergy()))
        f_ref = np.asarray(ju.strip(want.getForces(asNumpy=True)))
        assert abs(plain(got.getPotentialEnergy()) - e_ref) <= E_TOL * abs(
            e_ref), groups
        assert np.abs(plain(got.getForces(asNumpy=True)) - f_ref).max() \
            <= F_TOL * np.abs(f_ref).max(), groups


def test_virtual_site_system_across_packages():
    """The port's TIP4P-Ew box (its M sites virtual) carried into the JAX
    package by from_numpy's dict: the same tree, and the JAX XML reads
    back to the port's parameters and energy."""
    from openmm_tpu_torch.models import tip4pew_water_box
    system, pos = tip4pew_water_box(27)
    jsys = jax_system(T.to_numpy(system))
    assert _tree(TX.serialize(system)) == _tree(JX.serialize(jsys))
    again = TX.deserialize(JX.serialize(jsys))
    assert_same_params(T.to_numpy(again), system_params(jsys))
    assert_same_params(T.to_numpy(again), T.to_numpy(system))
    assert _energy(again, pos) == _energy(system, pos)


def test_state_round_trip_is_exact_both_ways():
    jsys, pos = _jax_water_system()
    system = TX.deserialize(JX.serialize(jsys))
    integ = T.LangevinMiddleIntegrator(300.0, 1.0, 0.002)
    integ.setRandomNumberSeed(11)
    ctx = T.Context(system, integ, "CPU")
    ctx.setPositions(pos)
    ctx.setVelocitiesToTemperature(300.0, randomSeed=2)
    integ.step(5)
    flags = dict(getPositions=True, getVelocities=True, getForces=True,
                 getEnergy=True, getParameters=True,
                 getIntegratorParameters=True)
    st = ctx.getState(**flags)
    xml = TX.serialize(st)
    for again in (TX.deserialize(xml), TX.deserialize(JX.serialize(
            JX.deserialize(xml)))):
        assert again.getDataTypes() == st.getDataTypes()
        assert plain(again.getTime()) == plain(st.getTime())
        assert again.getStepCount() == st.getStepCount() == 5
        for getter in ("getPositions", "getVelocities", "getForces",
                       "getPeriodicBoxVectors"):
            np.testing.assert_array_equal(
                plain(getattr(again, getter)(asNumpy=True)),
                plain(getattr(st, getter)(asNumpy=True)))
        assert plain(again.getPotentialEnergy()) == plain(
            st.getPotentialEnergy())
        assert again.getIntegratorParameters() == \
            st.getIntegratorParameters()
        assert again.getParameters() == st.getParameters()
    # a Context set from the State reads it back in bits
    ctx2 = T.Context(system, T.LangevinMiddleIntegrator(300.0, 1.0, 0.002),
                     "CPU")
    ctx2.setState(TX.deserialize(xml))
    back = ctx2.getState(getPositions=True, getVelocities=True,
                         getIntegratorParameters=True)
    np.testing.assert_array_equal(plain(back.getPositions(asNumpy=True)),
                                  plain(st.getPositions(asNumpy=True)))
    np.testing.assert_array_equal(plain(back.getVelocities(asNumpy=True)),
                                  plain(st.getVelocities(asNumpy=True)))
    assert back.getIntegratorParameters() == st.getIntegratorParameters()
    assert ctx2.getStepCount() == 5
