"""OpenMMException: the error the app layer raises for a user's mistake
(the port's copy of openmm_tpu/exceptions.py, after OpenMM's
openmmapi/include/openmm/OpenMMException.h)."""


class OpenMMException(Exception):
    """Raised for user errors and unrecoverable runtime conditions."""
