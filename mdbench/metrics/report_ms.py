"""report_ms: host milliseconds a report (app/: Simulation._report, the
state read and the StateDataReporter's and DCDReporter's report calls),
the mean over the window's reports, from the benchmark's spans around
Simulation._report."""


def read(data):
    times = data["spans"].get("report")
    if not times:
        return None
    return sum(times) / len(times) * 1e3
