"""Times the port's kernels on one GPU, to compare designs.

    python3 kernel_lab.py                      # this checkout's kernels
    python3 kernel_lab.py --trees A B B A      # checkouts A and B in turns
    python3 kernel_lab.py --variants [PREFIX]  # variants of kernels 1, 3, 5

With no option it times the five kernels of this checkout at the main
path's shapes (chip_smoke.kernel_inputs: 24,000 atoms, 56^3 grid) with
chip_smoke._time_ms and prints one JSON line; where the checkout's kernel 3
takes a visiting order, it is timed in the main path's order and, as
"pme_gather, user order", without one. --trees does the same for each
checkout given, in the order given, each in a process of its own that
imports that checkout's chip_smoke.py and package: give a parent checkout
and this one in turns (parent, this, this, parent) to compare two commits
on one card. --variants builds copies of kernels 1, 3 and 5 (those whose
name starts with PREFIX, e.g. "gather") with the source edits of VARIANTS
(one nvcc process for each distinct source, all started together) under
build/kernel_lab/, launches kernel 3's copies in the main path's order
unless the variant says otherwise, holds each against the plain version
and times it twice, in turns. It imports nothing of JAX or of openmm_tpu
and needs a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(REPO, "openmm_tpu_torch", "csrc")
OUT = os.path.join(REPO, "build", "kernel_lab")

_FLUSH = ("        add_pair(pr, qi, par[qj[lane]], qd[lane], &fx, &fy, &fz, "
          "&e);\n")
_BOUNDS = ("__global__ void __launch_bounds__(32 * kWarps)\n"
           "nonbonded_tiles_kernel")
_LOAD = "v[q][u] = live[u] && q0 + q < m ? col[o + 32 * u] : 0.0f;"
_BLOCK = "constexpr int kBlock = 32;"
# (source file, [(text, replacement)]) by name; each edit must match once.
# Kernel 3's variants named "..., user order" launch without a visiting
# order.
VARIANTS = {
    "tiles": ("nonbonded_tiles.cu", []),
    "tiles, no pair terms": ("nonbonded_tiles.cu", [
        (_FLUSH, "        fx += qd[lane].w;\n")]),
    "tiles, no sweep": ("nonbonded_tiles.cu", [
        ("    const int n_live = __popc(live);",
         "    const int n_live = 0;\n    fx += __popc(live);")]),
    "tiles, 5 blocks an SM": ("nonbonded_tiles.cu", [
        (_BOUNDS, _BOUNDS.replace("kWarps)", "kWarps, 5)"))]),
    "tiles, 16 warps a block": ("nonbonded_tiles.cu", [
        ("constexpr int kWarps = 8; ", "constexpr int kWarps = 16; ")]),
    "vjp": ("spread_triple.cu", []),
    "vjp, loads past L1": ("spread_triple.cu", [
        (_LOAD, _LOAD.replace("col[o + 32 * u]", "__ldcg(col + o + 32 * u)"))]),
    "vjp, kOut 1": ("spread_triple.cu", [
        ("constexpr int kOut = 2;", "constexpr int kOut = 1;")]),
    "vjp, kUnroll 8": ("spread_triple.cu", [
        ("constexpr int kUnroll = 16;", "constexpr int kUnroll = 8;")]),
    "vjp, kUnroll 32": ("spread_triple.cu", [
        ("constexpr int kUnroll = 16;", "constexpr int kUnroll = 32;")]),
    "gather": ("pme_gather.cu", []),
    "gather, user order": ("pme_gather.cu", []),
    "gather, 64 atoms a block": ("pme_gather.cu", [
        (_BLOCK, _BLOCK.replace("32;", "64;"))]),
    "gather, 128 atoms a block": ("pme_gather.cu", [
        (_BLOCK, _BLOCK.replace("32;", "128;"))]),
    "gather, 128 atoms a block, user order": ("pme_gather.cu", [
        (_BLOCK, _BLOCK.replace("32;", "128;"))]),
    "gather, empty kernel": ("pme_gather.cu", [
        ("  if (k >= n) return;", "  if (n > 0) return;")]),
}


def time_tree(tree: str) -> dict:
    """{kernel: ms} of the checkout at `tree` (imported in this process)."""
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as cs
    from openmm_tpu_torch.platform import set_fp32_matmul_exact
    set_fp32_matmul_exact()
    dev = torch.device("cuda", 0)
    cs.phase_build(cs.Deadline(600.0))
    inp = cs.kernel_inputs(dev, cs.N_WATERS)
    calls = cs._kernel_calls(inp)
    times = {name: cs._time_ms(kernel, dev)
             for name, (kernel, _) in calls.items()}
    if "order" in inp:
        from openmm_tpu_torch.ops import pme_zslab
        phi2 = cs.potential_grid(inp)
        times["pme_gather, user order"] = cs._time_ms(
            lambda: pme_zslab.pme_gather(inp["pos"], inp["charge"], phi2,
                                         inp["binv"], inp["grid"]), dev)
    return times


def _build_variants(nvcc_flags, find_nvcc, prefix="") -> dict:
    """{variant: path of its library} of the variants whose name starts
    with `prefix`; variants with the same source text share one build."""
    os.makedirs(OUT, exist_ok=True)
    libs, procs = {}, {}
    for name, (source, edits) in VARIANTS.items():
        if not name.startswith(prefix):
            continue
        with open(os.path.join(CSRC, source)) as f:
            text = f.read()
        for old, new in edits:
            if text.count(old) != 1:
                raise ValueError("variant %r: edit does not match once: %r"
                                 % (name, old))
            text = text.replace(old, new)
        if text not in procs:
            path = os.path.join(OUT, "v%d.cu" % len(procs))
            with open(path, "w") as f:
                f.write(text)
            procs[text] = (path[:-3] + ".so", name, subprocess.Popen(
                [find_nvcc(), *nvcc_flags, "-I", CSRC, "-o",
                 path[:-3] + ".so", path], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        libs[name] = procs[text][0]
    for so, name, proc in procs.values():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError("variant %r failed to build:\n%s" % (name, log))
    return libs


def run_variants(prefix="") -> list:
    import torch

    import chip_smoke as cs
    from openmm_tpu_torch import _build
    from openmm_tpu_torch.ops import pallas_pme, pme_zslab, tile_pairs
    from openmm_tpu_torch.platform import set_fp32_matmul_exact
    set_fp32_matmul_exact()
    dev = torch.device("cuda", 0)
    libs = {}
    for name, so in _build_variants(_build.NVCC_FLAGS, _build.find_nvcc,
                                    prefix).items():
        lib = ctypes.CDLL(so)
        for fn, argtypes in _build._SIGNATURES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
        libs[name] = lib
    inp = cs.kernel_inputs(dev, cs.N_WATERS)
    pos4, par4, cand, count, words, consts = inp["tiles"]
    switch = int(inp["module"].use_switch)
    a, wy, wz = inp["triple"]
    dq = inp["dq"]
    n, nx, ny, nz = a.shape[0], a.shape[1], wy.shape[1], wz.shape[1]
    stream = torch.cuda.current_stream(dev).cuda_stream
    pos, q, binv, order = inp["pos"], inp["charge"], inp["binv"], inp["order"]
    phi2 = cs.potential_grid(inp)
    gather = pme_zslab.pme_gather(pos, q, phi2, binv, inp["grid"], order)
    want = {"nonbonded_tiles.cu": tile_pairs.nonbonded_tiles_plain(
                *inp["tiles"], tile_pairs.MODE_EWALD, switch),
            "pme_gather.cu": pme_zslab.pme_gather_plain(pos, q, phi2, binv,
                                                        inp["grid"]),
            "spread_triple.cu": pallas_pme.spread_triple_vjp_plain(
                dq, a, wy, wz)}

    def call(name):
        lib = libs[name]
        if VARIANTS[name][0] == "pme_gather.cu":
            visit = None if name.endswith("user order") else order.data_ptr()
            out = torch.empty_like(pos)
            return (lambda: lib.omm_pme_gather(
                pos.data_ptr(), q.data_ptr(), phi2.data_ptr(),
                binv.data_ptr(), visit, pos.shape[0], nx, ny, nz,
                out.data_ptr(), stream)), lambda: out
        if VARIANTS[name][0] == "nonbonded_tiles.cu":
            out = torch.empty_like(pos4)
            bounds = torch.empty((count.shape[0], 2, 4), device=dev)
            return (lambda: lib.omm_nonbonded_tiles(
                pos4.data_ptr(), par4.data_ptr(), cand.data_ptr(),
                count.data_ptr(), words.data_ptr(), consts.data_ptr(),
                count.shape[0], cand.shape[1], words.shape[1],
                tile_pairs.MODE_EWALD, switch, bounds.data_ptr(),
                out.data_ptr(), stream)), lambda: out
        outs = tuple(torch.empty_like(t) for t in (a, wy, wz))
        entries = torch.empty((n, nx + ny + nz, 2), dtype=torch.int32,
                              device=dev)
        transposed = torch.empty((2, nx * ny * nz), device=dev)
        return (lambda: lib.omm_spread_triple_bwd(
            dq.data_ptr(), a.data_ptr(), wy.data_ptr(), wz.data_ptr(), n, nx,
            ny, nz, entries.data_ptr(), transposed.data_ptr(),
            *(o.data_ptr() for o in outs), stream)), lambda: outs

    rows = []
    for turn in range(2):
        for name in libs:
            run, result = call(name)
            code = run()
            torch.cuda.synchronize(dev)
            if code:
                raise RuntimeError("variant %r: CUDA error %d at launch"
                                   % (name, code))
            row = {"variant": name, "turn": turn,
                   "rel_err": cs._compare(result(),
                                          want[VARIANTS[name][0]])[2]}
            if VARIANTS[name][0] == "pme_gather.cu":
                # bits against kernel 3
                row["same_bits"] = torch.equal(result(), gather)
            row["ms"] = cs._time_ms(run, dev)
            rows.append(row)
            print(json.dumps(row))
    return rows


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--trees", nargs="*")
    parser.add_argument("--variants", nargs="?", const="", metavar="PREFIX",
                        help="time the variants (those whose name starts "
                        "with PREFIX)")
    parser.add_argument("--one-tree", help=argparse.SUPPRESS)
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("kernel_lab.py needs a CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    if args.one_tree:
        print(json.dumps({"tree": args.one_tree,
                          "ms": time_tree(args.one_tree)}))
    elif args.variants is not None:
        sys.path.insert(0, REPO)
        run_variants(args.variants)
    else:
        for tree in args.trees or [REPO]:
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--one-tree",
                 os.path.abspath(tree)], capture_output=True, text=True,
                cwd=os.path.abspath(tree))
            if proc.returncode:
                raise RuntimeError("timing %s failed:\n%s" % (tree,
                                                             proc.stderr))
            print(proc.stdout.strip().splitlines()[-1])
    return 0


if __name__ == "__main__":
    sys.exit(main())
