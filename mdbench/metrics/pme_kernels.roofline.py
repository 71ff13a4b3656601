"""pme_kernels.roofline: kernels 2 and 3 (csrc/pme_spread.cu,
csrc/pme_gather.cu) together against their roofline, in %: the least
time the charge spread and the force gather need on the chip
(roofline.spread_work and gather_work: the atoms, the grid) over their
device times a launch in the traced window."""
import roofline

SPREAD = ("pme_spread_kernel", "max_abs_charge_kernel")
GATHER = ("pme_gather_kernel",)


def read(data):
    trace, problem = data["trace"], data["problem"]
    if not trace or not problem:
        return None
    import timeline
    spread = timeline.kernel_time(trace, SPREAD, SPREAD[0])
    gather = timeline.kernel_time(trace, GATHER, GATHER[0])
    if spread is None or gather is None:
        return None
    n, grid = problem["n_atoms"], problem["grid"]
    least = (roofline.least_seconds(*roofline.spread_work(n, grid))[0]
             + roofline.least_seconds(*roofline.gather_work(n, grid))[0])
    return 100.0 * least / (spread[0] / spread[1] + gather[0] / gather[1])
