"""nonbonded_tiles.roofline: kernel 1 (csrc/nonbonded_tiles.cu) against
its roofline, in %: the least time the problem's direct space needs on
the chip (roofline.nonbonded_work: the pairs within the cutoff by the
benchmark's own cell list in the final state, the atoms' inputs and
outputs) over kernel 1's device time a launch in the traced window."""
import roofline

# the device functions of one launch of kernel 1, found by name
NAMES = ("nonbonded_tiles_kernel", "brick_bounds_kernel")
LAUNCH = "nonbonded_tiles_kernel"


def read(data):
    trace, problem = data["trace"], data["problem"]
    if not trace or not problem:
        return None
    import timeline
    found = timeline.kernel_time(trace, NAMES, LAUNCH)
    if found is None:
        return None
    seconds, launches = found
    least, _ = roofline.least_seconds(*roofline.nonbonded_work(
        problem["n_atoms"], problem["pairs"]))
    return 100.0 * least / (seconds / launches)
