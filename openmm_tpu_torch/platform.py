"""Platforms: where a Context runs and in which precision.

Counterpart of openmm_tpu/platform.py. A Platform here names a torch device
class and the properties a Context reads from it:

- "CUDA" (the default): the H100. Forces run through the hand-written
  kernels in float32; positions and velocities are integrated in float64.
- "CPU": the same program on the host, with each kernel replaced by its
  plain PyTorch version. It exists for tests and must be asked for by name.

The "Precision" property is "mixed" (float32 forces, the default) or
"double" (float64 forces through the plain versions on the platform's
device: the accuracy oracle). There is no fallback: a CUDA platform without
a card raises.
"""
from __future__ import annotations

import torch

_PRECISIONS = ("mixed", "double")


class Platform:
    def __init__(self, name: str, device_type: str):
        self._name = name
        self._device_type = device_type
        self._defaults = {"Precision": "mixed", "DeviceIndex": "0"}

    def getName(self) -> str:
        return self._name

    def getSpeed(self) -> float:
        return 100.0 if self._device_type == "cuda" else 10.0

    def getPropertyNames(self) -> list:
        return list(self._defaults)

    def getPropertyDefaultValue(self, prop) -> str:
        if prop not in self._defaults:
            raise ValueError("unknown platform property: %s" % prop)
        return self._defaults[prop]

    def setPropertyDefaultValue(self, prop, value) -> None:
        """The value a Context built later takes when its properties do
        not name `prop`."""
        if prop not in self._defaults:
            raise ValueError("unknown platform property: %s" % prop)
        self._defaults[prop] = str(value)

    def supportsDoublePrecision(self) -> bool:
        return True

    def getPropertyValue(self, context, prop) -> str:
        return str((context._properties or {}).get(
            prop, self.getPropertyDefaultValue(prop)))

    def resolve(self, properties=None):
        """(device, precision) for a Context built with `properties`."""
        props = dict(self._defaults)
        for key, value in (properties or {}).items():
            if key not in props:
                raise ValueError("unknown platform property: %s" % key)
            props[key] = str(value)
        precision = props["Precision"]
        if precision not in _PRECISIONS:
            raise ValueError("Precision must be 'mixed' or 'double', not %r"
                             % precision)
        if self._device_type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "the CUDA platform needs an NVIDIA GPU and none is "
                    "visible to torch; ask for Platform 'CPU' by name to run "
                    "on the host")
            device = torch.device("cuda", int(props["DeviceIndex"]))
        else:
            device = torch.device("cpu")
        return device, precision

    @staticmethod
    def getPlatformByName(name: str) -> "Platform":
        if name not in _REGISTRY:
            raise ValueError('There is no registered Platform called "%s"'
                             % name)
        return _REGISTRY[name]

    @staticmethod
    def getDefaultPlatform() -> "Platform":
        return _REGISTRY["CUDA"]

    @staticmethod
    def getNumPlatforms() -> int:
        return len(_REGISTRY)

    @staticmethod
    def getPlatform(index_or_name) -> "Platform":
        if isinstance(index_or_name, int):
            return list(_REGISTRY.values())[index_or_name]
        return Platform.getPlatformByName(index_or_name)

    @staticmethod
    def registerPlatform(platform) -> None:
        _REGISTRY[platform.getName()] = platform

    @staticmethod
    def findPlatform(kernelNames=()) -> "Platform":
        """The fastest registered platform that can run here: CUDA where
        torch sees a card, else CPU."""
        usable = [p for p in _REGISTRY.values()
                  if p._device_type != "cuda" or torch.cuda.is_available()]
        if not usable:
            raise ValueError("No Platform registered")
        return max(usable, key=lambda p: p.getSpeed())

    @staticmethod
    def loadPluginsFromDirectory(directory) -> list:
        """The port has no plugins: nothing is loaded."""
        return []

    @staticmethod
    def getOpenMMVersion() -> str:
        from .version import short_version
        return short_version

    @staticmethod
    def getDefaultPluginsDirectory() -> str:
        return ""

    @staticmethod
    def getPluginLoadFailures() -> list:
        return []


_REGISTRY = {"CUDA": Platform("CUDA", "cuda"), "CPU": Platform("CPU", "cpu")}


def set_fp32_matmul_exact() -> None:
    """Keep every float32 product in full float32: TF32 keeps ~3 decimal
    digits, which is the H100 form of the bf16 truncation that put the
    TPU's Ewald k-sum 1.4 % off (the JAX package pins HIGHEST there)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
