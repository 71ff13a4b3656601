"""The multi-rank dry run on the CPU: python -m
openmm_tpu_torch.parallel.dryrun N.

Counterpart of __graft_entry__.py:dryrun_multichip (the JAX package's
sharded step on a virtual host mesh): N gloo ranks in processes of their
own (ranks.py) build the 512-water box (1,536 atoms, kernel 1's plain
version on the candidate state) on an N-way mesh, and the first rank
builds it single-rank too. The gates: JAX's (energy to 1e-5 relative,
forces to 1e-6 of the largest), then the port's own (every rank's energy
and forces equal to the single-rank ones in bits); then one
LangevinMiddle step, after which every rank's positions must equal the
single-rank step's in bits. Prints one JSON line and exits 0 when every
gate holds, 1 otherwise.
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np

from .ranks import Ranks

WATERS = 512


def dryrun(n_ranks: int, n_waters: int = WATERS, steps: int = 1) -> dict:
    """The dry run on `n_ranks` gloo ranks: its gates and figures."""
    t0 = time.perf_counter()
    results = Ranks(n_ranks, [("water_box", dict(
        n_waters=n_waters, steps=steps, eager=False, reference=True),
        None)]).join()
    runs = [r[0]["mesh"] for r in results]
    single = results[0][0]["single"]
    e1, f1 = single["energy"], single["forces"]
    scale = np.abs(f1).max()
    e_err = max(abs(r["energy"] - e1) for r in runs)
    f_err = max(np.abs(r["forces"] - f1).max() for r in runs)
    gates = {
        "energy": bool(e_err < 1e-5 * max(abs(e1), 1.0)),
        "forces": bool(f_err < 1e-6 * scale),
        "bits": all(np.array_equal(r["forces"], f1) and r["energy"] == e1
                    for r in runs),
        "step_bits": all(np.array_equal(r["positions"], single["positions"])
                         for r in runs),
        "no_jax": all(not r[-1]["modules"] for r in results)}
    return {"ranks": n_ranks, "atoms": int(f1.shape[0]), "energy": e1,
            "energy_err": float(e_err), "force_err": float(f_err),
            "bricks": [r["bricks"] for r in runs], "gates": gates,
            "ok": all(gates.values()),
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1 or not argv[0].isdigit() or int(argv[0]) < 1:
        print("usage: python -m openmm_tpu_torch.parallel.dryrun N",
              file=sys.stderr)
        return 2
    out = dryrun(int(argv[0]))
    print(json.dumps(out))
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
