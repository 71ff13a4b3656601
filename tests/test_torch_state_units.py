"""The port's getters return what the JAX package's return: a Quantity in
the same unit, or a plain value of the same kind.

Each shared class is built the same way in both packages, given one term
where it takes terms, and every public getter that needs no argument or
takes an index is called on both; the results are compared by type, unit
and value (1e-12).
"""
import math

import numpy as np
import pytest
import torch

import openmm_tpu as J
import openmm_tpu_torch as T
from openmm_tpu import unit as ju
from openmm_tpu_torch import unit as tu

import torch_port_helpers  # noqa: F401  (one torch thread)

# Getters that are not part of the comparison, each with its reason.
_SKIP = {
    # the JAX integrators' internal draw (deps, key, temperature)
    "getVelocitiesForTemperature",
    # the platform and plugin registry: compared in test_platform_getters
    "getPlatform", "getPlatformByName", "getDefaultPlatform",
}


def _build(pkg, name):
    """An instance of class `name` from package `pkg`, built the same way
    in both packages."""
    C = getattr(pkg, name)
    if name == "System":
        s = C()
        s.addParticle(12.0)
        s.addParticle(1.008)
        s.addConstraint(0, 1, 0.1)
        s.setDefaultPeriodicBoxVectors(pkg.Vec3(2, 0, 0), pkg.Vec3(0, 2, 0),
                                       pkg.Vec3(0, 0, 2))
        return s
    if name == "HarmonicBondForce":
        f = C()
        f.addBond(0, 1, 0.1, 1000.0)
        return f
    if name == "HarmonicAngleForce":
        f = C()
        f.addAngle(0, 1, 2, 1.9, 300.0)
        return f
    if name == "PeriodicTorsionForce":
        f = C()
        f.addTorsion(0, 1, 2, 3, 2, 0.5, 4.0)
        return f
    if name == "RBTorsionForce":
        f = C()
        f.addTorsion(0, 1, 2, 3, 1.0, 2.0, 3.0, 4.0, 5.0, 6.0)
        return f
    if name == "CMAPTorsionForce":
        f = C()
        f.addMap(4, list(np.linspace(0.0, 1.5, 16)))
        f.addTorsion(0, 0, 1, 2, 3, 1, 2, 3, 4)
        return f
    if name == "NonbondedForce":
        f = C()
        f.addParticle(0.5, 0.3, 0.6)
        f.addParticle(-0.5, 0.25, 0.4)
        f.addException(0, 1, 0.1, 0.28, 0.2)
        f.setNonbondedMethod(C.PME)
        f.setCutoffDistance(0.9)
        f.setSwitchingDistance(0.8)
        f.setPMEParameters(3.2, 20, 21, 22)
        f.addGlobalParameter("lam", 1.0)
        f.addParticleParameterOffset("lam", 0, 0.1, 0.0, 0.0)
        f.addExceptionParameterOffset("lam", 0, 0.05, 0.0, 0.0)
        return f
    if name == "CMMotionRemover":
        return C(7)
    if name == "AndersenThermostat":
        return C(300.0, 2.0)
    if name == "MonteCarloBarostat":
        return C(1.0, 300.0, 25)
    if name == "MonteCarloAnisotropicBarostat":
        return C(pkg.Vec3(1.0, 2.0, 3.0), 300.0, True, False, True, 10)
    if name == "MonteCarloMembraneBarostat":
        return C(1.0, 20.0, 310.0, 0, 0, 15)
    if name == "CustomExternalForce":
        f = C("k*x^2")
        f.addGlobalParameter("k", 2.0)
        f.addPerParticleParameter("x0")
        f.addParticle(0, [0.5])
        return f
    if name == "CustomBondForce":
        f = C("k*(r-r0)^2")
        f.addPerBondParameter("k")
        f.addPerBondParameter("r0")
        f.addBond(0, 1, [100.0, 0.1])
        return f
    if name == "CustomAngleForce":
        f = C("k*(theta-t0)^2")
        f.addPerAngleParameter("k")
        f.addPerAngleParameter("t0")
        f.addAngle(0, 1, 2, [100.0, 1.9])
        return f
    if name == "CustomTorsionForce":
        f = C("k*(1+cos(theta))")
        f.addPerTorsionParameter("k")
        f.addTorsion(0, 1, 2, 3, [3.0])
        return f
    if name == "CustomNonbondedForce":
        f = C("a*r")
        f.addPerParticleParameter("a")
        f.addParticle([1.0])
        f.addParticle([2.0])
        f.addExclusion(0, 1)
        f.setNonbondedMethod(C.CutoffPeriodic)
        f.setCutoffDistance(1.1)
        f.setUseSwitchingFunction(True)
        f.setSwitchingDistance(1.0)
        f.addInteractionGroup([0], [1])
        f.addTabulatedFunction("tab", pkg.Continuous1DFunction(
            [0.0, 1.0, 4.0, 9.0], 0.0, 3.0))
        return f
    if name == "CustomCompoundBondForce":
        f = C(2, "k*distance(p1,p2)")
        f.addPerBondParameter("k")
        f.addBond([0, 1], [3.0])
        return f
    if name == "CustomCentroidBondForce":
        f = C(2, "k*distance(g1,g2)")
        f.addPerBondParameter("k")
        f.addGroup([0, 1], [1.0, 2.0])
        f.addGroup([2, 3])
        f.addBond([0, 1], [3.0])
        return f
    if name == "CustomGBForce":
        f = C()
        f.addPerParticleParameter("q")
        f.addComputedValue("B", "r", C.ParticlePair)
        f.addEnergyTerm("q*B", C.SingleParticle)
        f.addParticle([0.5])
        f.setCutoffDistance(1.2)
        return f
    if name == "CustomHbondForce":
        f = C("k*distance(d1,a1)")
        f.addGlobalParameter("k", 1.0)
        f.addDonor(0, 1, -1, [])
        f.addAcceptor(2, -1, -1, [])
        f.setCutoffDistance(1.3)
        return f
    if name == "CustomCVForce":
        f = C("2*b")
        b = pkg.CustomBondForce("r")
        b.addBond(0, 1, [])
        f.addCollectiveVariable("b", b)
        return f
    if name == "GBSAOBCForce":
        f = C()
        f.addParticle(0.5, 0.15, 0.8)
        f.setCutoffDistance(1.4)
        return f
    if name == "RMSDForce":
        return C([pkg.Vec3(0, 0, 0), pkg.Vec3(0.1, 0, 0),
                  pkg.Vec3(0, 0.2, 0)], [0, 1, 2])
    if name == "GayBerneForce":
        f = C()
        f.addParticle(0.3, 0.5, 1, 2, 0.3, 0.2, 0.1, 1.0, 0.9, 0.8)
        f.addParticle(0.3, 0.5, -1, -1, 0.3, 0.3, 0.3, 1.0, 1.0, 1.0)
        f.addException(0, 1, 0.25, 0.4)
        f.setCutoffDistance(1.5)
        f.setSwitchingDistance(1.2)
        return f
    if name == "CustomManyParticleForce":
        f = C(3, "k*distance(p1,p2)")
        f.addGlobalParameter("k", 1.0)
        f.addParticle([], 0)
        f.setCutoffDistance(1.6)
        return f
    if name == "Continuous1DFunction":
        return C([0.0, 1.0, 4.0], 0.0, 2.0)
    if name == "Continuous2DFunction":
        return C(2, 2, [0.0, 1.0, 2.0, 3.0], 0.0, 1.0, 0.0, 1.0)
    if name == "Continuous3DFunction":
        return C(2, 2, 2, list(range(8)), 0.0, 1.0, 0.0, 1.0, 0.0, 1.0)
    if name == "Discrete1DFunction":
        return C([1.0, 2.0])
    if name == "Discrete2DFunction":
        return C(2, 1, [1.0, 2.0])
    if name == "Discrete3DFunction":
        return C(1, 1, 2, [1.0, 2.0])
    if name == "VerletIntegrator":
        return C(0.002)
    if name in ("LangevinIntegrator", "LangevinMiddleIntegrator",
                "BrownianIntegrator"):
        return C(310.0, 2.0, 0.002)
    if name == "VariableVerletIntegrator":
        i = C(0.001)
        i.setMaximumStepSize(0.004)
        return i
    if name == "VariableLangevinIntegrator":
        i = C(305.0, 1.5, 0.001)
        i.setMaximumStepSize(0.003)
        return i
    if name == "NoseHooverIntegrator":
        i = C(300.0, 10.0, 0.002)
        return i
    if name == "NoseHooverChain":
        return C(300.0, 310.0, 10.0, 20.0, 6, 3, 3, 7, 0, [0, 1], [])
    if name == "CustomIntegrator":
        i = C(0.002)
        i.addGlobalVariable("g", 1.5)
        i.addPerDofVariable("v2", 0.0)
        i.addComputePerDof("x", "x+dt*v")
        return i
    if name == "CompoundIntegrator":
        i = C()
        i.addIntegrator(pkg.VerletIntegrator(0.002))
        i.addIntegrator(pkg.LangevinIntegrator(300.0, 1.0, 0.001))
        return i
    if name == "MTSIntegrator":
        return C(0.004, [(0, 1), (1, 2)])
    if name == "MTSLangevinIntegrator":
        return C(300.0, 1.0, 0.004, [(0, 1), (1, 2)])
    if name == "AMDIntegrator":
        return C(0.002, 10.0, -100.0)
    if name == "AMDForceGroupIntegrator":
        return C(0.002, 1, 10.0, -100.0)
    if name == "DualAMDIntegrator":
        return C(0.002, 1, 10.0, -100.0, 5.0, -50.0)
    if name == "TwoParticleAverageSite":
        return C(0, 1, 0.3, 0.7)
    if name == "ThreeParticleAverageSite":
        return C(0, 1, 2, 0.2, 0.3, 0.5)
    if name == "OutOfPlaneSite":
        return C(0, 1, 2, 0.2, 0.3, 0.5)
    if name == "LocalCoordinatesSite":
        return C([0, 1, 2], [1.0, 0.0, 0.0], [-1.0, 1.0, 0.0],
                 [-1.0, 0.0, 1.0], pkg.Vec3(0.1, 0.05, 0.0))
    if name == "DrudeForce":
        f = C()
        f.addParticle(1, 0, 2, -1, -1, -1.1, 0.001, 1.2, 1.0)
        f.addParticle(4, 3, -1, -1, -1, -1.3, 0.0012, 1.0, 1.0)
        f.addScreenedPair(0, 1, 2.6)
        return f
    if name == "DrudeLangevinIntegrator":
        return C(300.0, 1.0, 1.0, 20.0, 0.001)
    if name == "DrudeSCFIntegrator":
        return C(0.0005)
    if name == "DrudeNoseHooverIntegrator":
        return C(300.0, 10.0, 1.0, 50.0, 0.001)
    if name == "RPMDIntegrator":
        return C(8, 300.0, 1.0, 0.0005, {1: 2})
    if name == "RPMDMonteCarloBarostat":
        return C(2.0, 10)
    raise KeyError(name)


CLASSES = [
    "System", "HarmonicBondForce", "HarmonicAngleForce",
    "PeriodicTorsionForce", "RBTorsionForce", "CMAPTorsionForce",
    "NonbondedForce", "CMMotionRemover", "AndersenThermostat",
    "MonteCarloBarostat", "MonteCarloAnisotropicBarostat",
    "MonteCarloMembraneBarostat", "CustomExternalForce", "CustomBondForce",
    "CustomAngleForce", "CustomTorsionForce", "CustomNonbondedForce",
    "CustomCompoundBondForce", "CustomCentroidBondForce", "CustomGBForce",
    "CustomHbondForce", "CustomCVForce", "GBSAOBCForce", "RMSDForce",
    "GayBerneForce", "CustomManyParticleForce", "Continuous1DFunction",
    "Continuous2DFunction", "Continuous3DFunction", "Discrete1DFunction",
    "Discrete2DFunction", "Discrete3DFunction", "VerletIntegrator",
    "LangevinIntegrator", "LangevinMiddleIntegrator", "BrownianIntegrator",
    "VariableVerletIntegrator", "VariableLangevinIntegrator",
    "NoseHooverIntegrator", "NoseHooverChain", "CustomIntegrator",
    "CompoundIntegrator",
    "MTSIntegrator", "MTSLangevinIntegrator", "AMDIntegrator",
    "AMDForceGroupIntegrator", "DualAMDIntegrator",
    "TwoParticleAverageSite", "ThreeParticleAverageSite", "OutOfPlaneSite",
    "LocalCoordinatesSite", "DrudeForce", "DrudeLangevinIntegrator",
    "DrudeSCFIntegrator", "DrudeNoseHooverIntegrator", "RPMDIntegrator",
    "RPMDMonteCarloBarostat",
]


def _call(obj, name):
    """The getter's result with no argument, else with index 0, else
    None when neither call applies (a getter of a name, a chain ID)."""
    method = getattr(obj, name)
    for args in ((), (0,)):
        try:
            return ("ok", method(*args))
        except TypeError:
            continue
        except Exception as exc:  # noqa: BLE001 - compared as outcomes
            return ("raised", type(exc).__name__)
    return None


def _same(got, want, where):
    """Raise unless `got` (port) is `want` (JAX) by type, unit and value."""
    if isinstance(want, ju.Quantity):
        assert isinstance(got, tu.Quantity), \
            "%s: %r is not a Quantity" % (where, got)
        assert str(got.unit) == str(want.unit), \
            "%s: unit %s, JAX %s" % (where, got.unit, want.unit)
        _same(got._value, want._value, where)
        return
    assert not isinstance(got, tu.Quantity), \
        "%s: %r is a Quantity, JAX gives %r" % (where, got, want)
    if isinstance(want, (J.Vec3, T.Vec3)) or type(want).__name__ == "Vec3":
        assert type(got).__name__ == "Vec3", where
        np.testing.assert_allclose(tuple(got), tuple(want), rtol=1e-12,
                                   atol=1e-12, err_msg=where)
        return
    if isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)), \
            "%s: %r is not a sequence" % (where, got)
        assert len(got) == len(want), where
        for k, (g, w) in enumerate(zip(got, want)):
            _same(g, w, "%s[%d]" % (where, k))
        return
    if isinstance(want, np.ndarray):
        np.testing.assert_allclose(np.asarray(got, np.float64),
                                   np.asarray(want, np.float64),
                                   rtol=1e-12, atol=1e-12, err_msg=where)
        return
    if isinstance(want, bool) or isinstance(got, bool):
        assert bool(got) == bool(want), where
        return
    if isinstance(want, (int, float, np.floating, np.integer)):
        assert isinstance(got, (int, float, np.floating, np.integer)), \
            "%s: %r against %r" % (where, got, want)
        if math.isinf(float(want)):
            assert float(got) == float(want), where
        else:
            assert abs(float(got) - float(want)) <= 1e-12 * max(
                1.0, abs(float(want))), "%s: %r against %r" % (where, got,
                                                               want)
        return
    if isinstance(want, str) or want is None:
        assert got == want, "%s: %r against %r" % (where, got, want)
        return
    # objects (a force of a CV, a tabulated function): the same class
    assert type(got).__name__ == type(want).__name__, \
        "%s: %s against %s" % (where, type(got).__name__,
                               type(want).__name__)


@pytest.mark.parametrize("name", CLASSES)
def test_getters_match(name):
    jobj, tobj = _build(J, name), _build(T, name)
    compared = 0
    for getter in sorted(m for m in dir(jobj) if m.startswith("get")):
        if getter in _SKIP or not callable(getattr(jobj, getter)):
            continue
        assert hasattr(tobj, getter), "%s.%s is missing" % (name, getter)
        want = _call(jobj, getter)
        if want is None or want[0] == "raised":
            continue
        got = _call(tobj, getter)
        assert got is not None and got[0] == "ok", \
            "%s.%s: %r" % (name, getter, got)
        _same(got[1], want[1], "%s.%s" % (name, getter))
        compared += 1
    assert compared > 0


def _water_pair(pkg, platform):
    system = pkg.System()
    for m in (15.999, 1.008, 1.008):
        system.addParticle(m)
    nb = pkg.NonbondedForce()
    for q in (-0.834, 0.417, 0.417):
        nb.addParticle(q, 0.3, 0.5)
    nb.addException(0, 1, 0.0, 0.1, 0.0)
    nb.addException(0, 2, 0.0, 0.1, 0.0)
    nb.addException(1, 2, 0.0, 0.1, 0.0)
    bonds = pkg.HarmonicBondForce()
    bonds.addBond(0, 1, 0.09572, 4.6e5)
    bonds.addBond(0, 2, 0.09572, 4.6e5)
    system.addForce(nb)
    system.addForce(bonds)
    integ = pkg.VerletIntegrator(0.001)
    ctx = pkg.Context(system, integ, pkg.Platform.getPlatformByName(platform))
    ctx.setPositions([pkg.Vec3(0, 0, 0), pkg.Vec3(0.1, 0, 0),
                      pkg.Vec3(-0.03, 0.09, 0.01)])
    ctx.setVelocities([pkg.Vec3(0.1, 0.2, 0.3), pkg.Vec3(-0.1, 0, 0),
                       pkg.Vec3(0, 0.4, -0.2)])
    integ.step(3)
    return ctx


def test_state_getters_match():
    jctx = _water_pair(J, "Reference")
    tctx = _water_pair(T, "CPU")
    flags = dict(getPositions=True, getVelocities=True, getForces=True,
                 getEnergy=True, getParameters=True)
    js, ts = jctx.getState(**flags), tctx.getState(**flags)
    for getter in ("getTime", "getStepCount", "getPeriodicBoxVectors",
                   "getPeriodicBoxVolume", "getKineticEnergy",
                   "getParameters", "getDataTypes"):
        want = getattr(js, getter)()
        got = getattr(ts, getter)()
        if getter in ("getKineticEnergy",):
            assert isinstance(got, tu.Quantity)
            assert str(got.unit) == str(want.unit)
            assert abs(got._value - want._value) <= 1e-9 * abs(want._value)
            continue
        _same(got, want, "State." + getter)
    got = ts.getPotentialEnergy()
    want = js.getPotentialEnergy()
    assert isinstance(got, tu.Quantity) and str(got.unit) == str(want.unit)
    assert abs(got._value - want._value) <= 1e-9 * abs(want._value)
    for getter, tol in (("getPositions", 1e-12), ("getVelocities", 1e-9),
                        ("getForces", 1e-7)):
        for as_numpy in (False, True):
            want = getattr(js, getter)(asNumpy=as_numpy)
            got = getattr(ts, getter)(asNumpy=as_numpy)
            assert isinstance(got, tu.Quantity)
            assert str(got.unit) == str(want.unit)
            assert type(got._value).__name__ == type(want._value).__name__
            if not as_numpy:
                assert type(got._value[0]).__name__ == "Vec3"
            np.testing.assert_allclose(
                np.asarray([tuple(v) for v in got._value]),
                np.asarray([tuple(v) for v in want._value]),
                rtol=tol, atol=tol * 10)
    for getter in ("getTime", "getStepCount", "getParameters"):
        _same(getattr(tctx, getter)(), getattr(jctx, getter)(),
              "Context." + getter)
    _same(tctx.getIntegrator().getStepSize(),
          jctx.getIntegrator().getStepSize(), "Integrator.getStepSize")


def test_platform_getters():
    for name in ("CPU",):
        jp = J.Platform.getPlatformByName(name)
        tp = T.Platform.getPlatformByName(name)
        assert tp.getName() == jp.getName()
        assert "Precision" in tp.getPropertyNames()
        assert tp.getPropertyDefaultValue("Precision") == \
            jp.getPropertyDefaultValue("Precision")
    assert T.Platform.getNumPlatforms() == 2
    assert [T.Platform.getPlatform(i).getName() for i in range(2)] == \
        ["CUDA", "CPU"]
    assert isinstance(T.Platform.getOpenMMVersion(), str)
    assert T.Platform.getPluginLoadFailures() == []


# -- API the port had not got (ROADMAP Queue C's C8) -----------------------
def _system_pair(pkg):
    system = _build(pkg, "System")
    system.addParticle(1.008)
    system.addConstraint(1, 2, 0.12)
    system.addForce(_build(pkg, "HarmonicBondForce"))
    system.addForce(_build(pkg, "HarmonicAngleForce"))
    return system


def test_system_removals_and_constraint_setter():
    """removeForce, removeConstraint and setConstraintParameters as in the
    JAX System; a Context built before a removal keeps what it took."""
    out = []
    for pkg in (J, T):
        system = _system_pair(pkg)
        system.setConstraintParameters(1, 2, 0, 0.15)
        system.removeConstraint(0)
        system.removeForce(0)
        out.append(system)
    jsys, tsys = out
    assert tsys.getNumConstraints() == jsys.getNumConstraints() == 1
    _same(tsys.getConstraintParameters(0), jsys.getConstraintParameters(0),
          "System.getConstraintParameters")
    assert [type(f).__name__ for f in tsys.getForces()] == \
        [type(f).__name__ for f in jsys.getForces()] == ["HarmonicAngleForce"]
    system = _system_pair(T)
    ctx = T.Context(system, T.VerletIntegrator(0.001), "CPU")
    ctx.setPositions(np.array([[0, 0, 0], [0.12, 0, 0], [0.1, 0.1, 0]]))
    before = tu.plain(ctx.getState(getEnergy=True).getPotentialEnergy())
    system.removeForce(0)
    system.removeConstraint(0)
    after = tu.plain(ctx.getState(getEnergy=True).getPotentialEnergy())
    assert after == before
    assert sum(ctx.constraint_split) == 2


def test_cmap_setters():
    """setMapParameters and setTorsionParameters as in the JAX force; a
    new map reaches a Context through updateParametersInContext."""
    forces = []
    for pkg in (J, T):
        f = _build(pkg, "CMAPTorsionForce")
        f.setMapParameters(0, 4, list(np.linspace(2.0, -1.0, 16)))
        f.setTorsionParameters(0, 0, 4, 1, 2, 3, 1, 2, 3, 0)
        forces.append(f)
    for getter in ("getMapParameters", "getTorsionParameters"):
        _same(getattr(forces[1], getter)(0), getattr(forces[0], getter)(0),
              "CMAPTorsionForce." + getter)
    with pytest.raises(ValueError):
        forces[1].setMapParameters(0, 3, [0.0])
    system = T.System()
    for _ in range(5):
        system.addParticle(12.0)
    f = _build(T, "CMAPTorsionForce")
    system.addForce(f)
    pos = np.array([[0, 0, 0], [0.15, 0, 0], [0.2, 0.14, 0],
                    [0.35, 0.15, 0.05], [0.4, 0.3, 0.1]])
    ctx = T.Context(system, T.VerletIntegrator(0.001), "CPU")
    ctx.setPositions(pos)
    e0 = tu.plain(ctx.getState(getEnergy=True).getPotentialEnergy())
    f.setMapParameters(0, 4, list(np.linspace(2.0, -1.0, 16)))
    f.updateParametersInContext(ctx)
    e1 = tu.plain(ctx.getState(getEnergy=True).getPotentialEnergy())
    fresh = T.Context(system, T.VerletIntegrator(0.001), "CPU")
    fresh.setPositions(pos)
    assert e1 != e0
    assert e1 == tu.plain(fresh.getState(getEnergy=True)
                          .getPotentialEnergy())


def test_platform_methods():
    """The five Platform methods of the JAX package."""
    for name in ("registerPlatform", "findPlatform",
                 "loadPluginsFromDirectory", "setPropertyDefaultValue",
                 "supportsDoublePrecision"):
        assert callable(getattr(J.Platform, name))
        assert callable(getattr(T.Platform, name))
    tp = T.Platform.getPlatformByName("CPU")
    jp = J.Platform.getPlatformByName("CPU")
    assert tp.supportsDoublePrecision() == jp.supportsDoublePrecision()
    assert T.Platform.loadPluginsFromDirectory("plugins") == \
        J.Platform.loadPluginsFromDirectory("plugins") == []
    old = tp.getPropertyDefaultValue("Precision")
    try:
        tp.setPropertyDefaultValue("Precision", "double")
        assert tp.getPropertyDefaultValue("Precision") == "double"
        assert tp.resolve()[1] == "double"
    finally:
        tp.setPropertyDefaultValue("Precision", old)
    with pytest.raises(ValueError):
        tp.setPropertyDefaultValue("NoSuchProperty", "1")
    found = T.Platform.findPlatform()
    assert found.getName() == ("CUDA" if torch.cuda.is_available()
                               else "CPU")
    from openmm_tpu_torch import platform as tplatform
    extra = tplatform.Platform("Extra", "cpu")
    T.Platform.registerPlatform(extra)
    try:
        assert T.Platform.getPlatformByName("Extra") is extra
        assert T.Platform.getNumPlatforms() == 3
    finally:
        del tplatform._REGISTRY["Extra"]


def test_exports():
    """OpenMMException and TabulatedFunction at the top level, the six
    tabulated functions in openmm_tpu_torch.forces, as the JAX package
    exports them; the Drude and RPMD classes in both."""
    import openmm_tpu.forces as jf
    import openmm_tpu.integrators as ji
    import openmm_tpu_torch.forces as tf
    import openmm_tpu_torch.integrators as ti
    assert issubclass(T.OpenMMException, Exception)
    for name in ("Continuous1DFunction", "Continuous2DFunction",
                 "Continuous3DFunction", "Discrete1DFunction",
                 "Discrete2DFunction", "Discrete3DFunction"):
        assert issubclass(getattr(T, name), T.TabulatedFunction)
        assert getattr(tf, name) is getattr(T, name)
        assert hasattr(jf, name)
    for name in ("DrudeForce", "RPMDMonteCarloBarostat", "RPMDUpdater",
                 "TabulatedFunction"):
        assert hasattr(jf, name) and hasattr(tf, name), name
    for name in ("DrudeLangevinIntegrator", "DrudeSCFIntegrator",
                 "DrudeNoseHooverIntegrator", "RPMDIntegrator"):
        assert hasattr(ji, name) and hasattr(ti, name), name
        assert getattr(T, name) is getattr(ti, name)
    for name in ("OpenMMException", "TabulatedFunction"):
        assert hasattr(J, name) and hasattr(T, name)


# -- integrator parameters in a State (ROADMAP Queue C's C10) ---------------
def _drude_pair(pkg):
    """An oxygen-like particle and its Drude particle on a spring."""
    system = pkg.System()
    system.addParticle(15.6)
    system.addParticle(0.4)
    drude = pkg.DrudeForce()
    drude.addParticle(1, 0, -1, -1, -1, -1.1, 0.001, 1.0, 1.0)
    system.addForce(drude)
    return system


_INTEGRATOR_CASES = {
    "LangevinMiddleIntegrator": lambda pkg: pkg.LangevinMiddleIntegrator(
        310.0, 2.0, 0.002),
    "VerletIntegrator": lambda pkg: pkg.VerletIntegrator(0.0015),
    "DrudeLangevinIntegrator": lambda pkg: pkg.DrudeLangevinIntegrator(
        300.0, 1.5, 1.0, 20.0, 0.001),
    "CustomIntegrator": lambda pkg: _build(pkg, "CustomIntegrator"),
}


@pytest.mark.parametrize("name", sorted(_INTEGRATOR_CASES))
def test_integrator_parameters_match(name):
    """getState(getIntegratorParameters=True) gives the JAX dict, and a
    setState of a modified dict is what the next getState reads, in both
    packages."""
    out = []
    for pkg, platform in ((J, "Reference"), (T, "CPU")):
        system = (_drude_pair(pkg) if name.startswith("Drude")
                  else _water_pair(pkg, platform).getSystem())
        ctx = pkg.Context(system, _INTEGRATOR_CASES[name](pkg),
                          pkg.Platform.getPlatformByName(platform))
        ctx.setPositions([pkg.Vec3(0.1 * i, 0.05 * i, 0.0)
                          for i in range(system.getNumParticles())])
        st = ctx.getState(getIntegratorParameters=True)
        assert st.getDataTypes() & pkg.State.IntegratorParameters
        first = st.getIntegratorParameters()
        changed = {k: 1.25 * v for k, v in first.items()}
        changed_state = pkg.State(**(
            {"integratorParams": changed, "boxVectors": st._box}
            if pkg is J else {"integrator_parameters": changed,
                              "box": st._box}))
        ctx.setState(changed_state)
        out.append((first, ctx.getState(
            getIntegratorParameters=True).getIntegratorParameters(),
            changed))
    (jfirst, jback, jchanged), (tfirst, tback, tchanged) = out
    assert set(tfirst) == set(jfirst)
    for key, value in jfirst.items():
        _same(tfirst[key], float(value), "%s %s" % (name, key))
    assert jback == jchanged and tback == tchanged
    with pytest.raises(ValueError, match="integrator parameters"):
        T.State().getIntegratorParameters()
