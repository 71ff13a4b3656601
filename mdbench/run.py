"""The benchmark of openmm_tpu_torch: one run of one workload.

    python3 mdbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout on a machine with the cards the workload
asks for. Prints the numbers compared beside their limits as the last lines
of standard error, and one JSON object as the last line of standard output:
the end-to-end metrics with --trace 0, the per-layer metrics with
--trace 1. Exits with another code than 0, printing no result, without the
cards, when a module of JAX or of the JAX package is loaded after the
window, or when the program cannot be imported.
"""
import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# modules whose presence after the window makes a run void, compared by the
# whole top-level name (openmm_tpu_torch is not openmm_tpu)
FORBIDDEN = ("jax", "jaxlib", "flax", "openmm_tpu")


def forbidden_modules() -> list[str]:
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def _caches():
    """Every compiler cache at a fixed path inside the checkout."""
    build = ROOT / "build" / "mdbench"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(build / "inductor")
    os.environ.setdefault("USE_FLAX", "0")


def _power_limit() -> str:
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return proc.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.TimeoutExpired):
        return "not read"


def end_to_end(spec, name, result) -> dict:
    out = {}
    for m in spec["end_to_end"]:
        if "workloads" in m and name not in m["workloads"]:
            continue
        value = result[m["name"]]
        if value is None:
            raise RuntimeError("%s was not measured" % m["name"])
        out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def per_layer_names(spec, name) -> list[str]:
    return [m["name"] for m in spec["per_layer"]
            if "workloads" not in m or name in m["workloads"]]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    sys.path.insert(0, str(HERE))
    sys.path.insert(1, str(ROOT))
    import torch

    import harness
    spec = harness.benchmark()
    w = harness.workload(args.workload, spec)
    if not torch.cuda.is_available() or torch.cuda.device_count() < w[
            "chips"]:
        print("mdbench: the workload needs %d CUDA device(s); this machine "
              "has %s" % (w["chips"], torch.cuda.device_count()
                          if torch.cuda.is_available() else "none"),
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(device)
    print("mdbench: %s, %s; peaks %.3g FLOP/s float32, %.3g B/s; "
          "nvidia-smi: %s" % (args.workload, kind, 67e12, 3.35e12,
                              _power_limit()), file=sys.stderr)
    log = (lambda text: print("mdbench: " + text, file=sys.stderr))
    result = harness.execute(
        args.workload, args.seed, args.seconds, bool(args.trace), device,
        per_layer=per_layer_names(spec, args.workload) if args.trace else (),
        started=STARTED, log=log)
    found = forbidden_modules()
    if found:
        print("mdbench: modules of JAX or the JAX package were loaded: %s"
              % ", ".join(found), file=sys.stderr)
        return 3
    for label, value in sorted(result["window"].items()):
        if isinstance(value, (int, float)):
            log("window %s: %s" % (label, value))
    if args.trace:
        log("device idle by host span (s): %s" % json.dumps(
            result["gaps_by_span"]))
        metrics = {}
        for m in spec["per_layer"]:
            if m["name"] in result["per_layer"]:
                metrics[m["name"]] = {"value": result["per_layer"][m["name"]],
                                      "unit": m["unit"]}
    else:
        metrics = end_to_end(spec, args.workload, result)
    device_out = {"platform": "gpu", "kind": kind, "count": w["chips"],
                  "memory_peak_bytes": result["memory_peak_bytes"]}
    if args.trace:
        device_out["busy_s"] = result["busy_s"]
        device_out["window_s"] = result["traced_window_s"]
    checks = {name: {"value": v, "limit": lim}
              for name, (v, lim, _) in result["checks"].items()}
    line = {"correct": result["correct"], "attempted": result["attempted"],
            "failed": result["failed"], "metrics": metrics,
            "device": device_out}
    if args.trace:
        line["breakdown"] = result["breakdown"]
    line["checks"] = checks
    print("mdbench: attempted %d report intervals, failed %d, correct %s"
          % (result["attempted"], result["failed"], result["correct"]),
          file=sys.stderr)
    for name, (v, lim, ok) in result["checks"].items():
        print("check %s %r limit %r %s" % (name, v, lim,
                                           "ok" if ok else "FAILED"),
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
