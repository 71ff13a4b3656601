"""device_idle_share: the share (%) of the measured window in which the
device was not running the steps: 1 - (the device's time from the start
to the end of each interval's Simulation.step's integration, between a
pair of CUDA events around it, summed) / (the window's wall time). It is
read from the untraced window, so the profiler's own gaps do not enter;
the reports' state reads and files, and any wait for the host inside the
steps, are what it counts."""


def read(data):
    busy, wall = data.get("device_step_s"), data["window_s"]
    if not busy or wall <= 0:
        return None
    return 100.0 * (1.0 - busy / wall)
