"""One run of one cell: set-up, warm-up, the measured window through
Simulation.step(report_interval) with a StateDataReporter and a
DCDReporter, an optional traced window after it, and the comparison of
what the window produced with the plain reference.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own that this module finds by name:
configs/<name>.json (which names its inputs module and its reference
module by file), traffic/<name>.json and metrics/<name>.py.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import math
import shutil
import statistics
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
KINDS = {"configs": ".json", "traffic": ".json", "metrics": ".py"}


def names(kind: str) -> list[str]:
    """The names of the configurations, traffic mixes or per-layer metrics
    that the benchmark holds: the files of KINDS[kind] in its folder."""
    suffix = KINDS[kind]
    return sorted(p.name[:-len(suffix)] for p in (HERE / kind).iterdir()
                  if p.name.endswith(suffix) and not p.name.startswith("_"))


def load(kind: str, name: str):
    """A configuration or traffic mix (a dict) or a metric (its module)."""
    path = HERE / kind / (name + KINDS[kind])
    if not path.is_file():
        raise KeyError("no %s named %r (%s)" % (kind, name, path))
    if kind == "metrics":
        return load_module(path)
    with open(path) as f:
        return json.load(f)


def load_module(path):
    """A module of the benchmark, by its path (relative ones to this
    folder)."""
    path = HERE / path
    spec = importlib.util.spec_from_file_location(
        "mdbench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def workload(name: str, spec: dict | None = None) -> dict:
    spec = spec or benchmark()
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError("no workload named %r in BENCHMARK.json" % name)


def sizes(config: dict, traffic: dict) -> dict:
    """The configuration with the traffic mix's overrides of its sizes."""
    out = dict(config)
    out.update(traffic.get("overrides", {}))
    return out


class Spans:
    """Host spans of the window: (name, seconds) while `active`, and the
    same spans in the profiler's timeline while `traced`."""

    def __init__(self):
        self.active = False
        self.traced = None
        self.times = {}

    def wrap(self, name, fn):
        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            if self.traced is not None:
                with self.traced(name):
                    result = fn(*args, **kwargs)
            else:
                result = fn(*args, **kwargs)
            if self.active:
                self.times.setdefault(name, []).append(
                    time.perf_counter() - t0)
            return result
        return wrapped


def _sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _seconds(q):
    from openmm_tpu_torch import unit as u
    return u.plain(q)


class Run:
    """A cell's program from set-up to the window's end; `fault` (tests
    only) breaks the timed path on purpose."""

    def __init__(self, name, config, traffic, seed, device, fault=None):
        import torch

        import openmm_tpu_torch as omm
        from openmm_tpu_torch import app

        import program
        self.torch = torch
        self.name, self.seed, self.device = name, int(seed), device
        self.config, self.traffic = config, traffic
        self.size = sizes(config, traffic)
        self.tables = load_module(config["inputs"]).build(self.size,
                                                         self.seed)
        self.barostat = (config["barostat"] if traffic["ensemble"] == "npt"
                         else None)
        seeds = program.seeds(self.seed)
        system, topology = program.build_system(self.tables, self.barostat)
        for force in system.getForces():
            if hasattr(force, "setRandomNumberSeed") and self.barostat:
                force.setRandomNumberSeed(seeds["barostat"])
        temperature = float(config["temperature_K"])
        integ = omm.LangevinMiddleIntegrator(
            temperature, config["friction_per_ps"],
            config["step_fs"] * 1e-3)
        integ.setRandomNumberSeed(seeds["integrator"])
        platform = (None if device.type == "cuda"
                    else omm.Platform.getPlatformByName("CPU"))
        self.sim = app.Simulation(topology, system, integ, platform)
        self.context, self.integrator = self.sim.context, integ
        self.context.setPositions(self.tables["positions"])
        self.context.applyConstraints()
        if config.get("minimize_iterations", 0):
            self.sim.minimizeEnergy(maxIterations=config[
                "minimize_iterations"])
        self.context.setVelocitiesToTemperature(temperature,
                                                seeds["velocities"])
        for dt_fs, friction, steps in config.get("relax", ()):
            integ.setStepSize(dt_fs * 1e-3)
            integ.setFriction(friction)
            integ.step(int(steps))
        integ.setStepSize(config["step_fs"] * 1e-3)
        integ.setFriction(config["friction_per_ps"])
        self.start_widths = np.diag(_seconds(
            self.context.getState().getPeriodicBoxVectors(asNumpy=True)))
        self.spans = Spans()
        self.tmp = Path(tempfile.mkdtemp(prefix="mdbench-"))
        self.interval = int(traffic["report_interval"])
        self.csv_file = open(self.tmp / "state.csv", "w")
        self.sim.reporters.append(app.StateDataReporter(
            self.csv_file, self.interval, step=True, time=True,
            potentialEnergy=True, kineticEnergy=True, temperature=True,
            volume=True))
        self.sim.reporters.append(app.DCDReporter(
            str(self.tmp / "frames.dcd"), self.interval))
        for rep in self.sim.reporters:
            rep.report = self.spans.wrap("report." + type(rep).__name__,
                                         rep.report)
        self.sim._report = self.spans.wrap("report", self.sim._report)
        self.context.getState = self.spans.wrap("getState",
                                                self.context.getState)
        integ.step = self.spans.wrap("integrator.step",
                                     self._timed_on_device(integ.step))
        self.sim.step = self.spans.wrap("interval", self.sim.step)
        if fault is not None:
            fault(self)
        self.reports_before = 0

    def _timed_on_device(self, fn):
        """fn with a pair of CUDA events around each call while the window
        is open: the device's span of the steps of each interval."""
        self.step_events = []
        if self.device.type != "cuda":
            return fn
        event = self.torch.cuda.Event

        def timed(*args, **kwargs):
            if not self.spans.active:
                return fn(*args, **kwargs)
            start, end = event(enable_timing=True), event(enable_timing=True)
            start.record()
            result = fn(*args, **kwargs)
            end.record()
            self.step_events.append((start, end))
            return result
        return timed

    def device_step_seconds(self):
        """The device's time from the start to the end of each interval's
        steps, summed over the window (None off a card)."""
        if not self.step_events:
            return None
        _sync(self.device)
        return sum(a.elapsed_time(b) for a, b in self.step_events) * 1e-3

    def step_interval(self):
        self.sim.step(self.interval)

    def warm_up(self, trace):
        """The traffic's warm-up intervals, and with `trace` one interval
        under the profiler, whose first use imports what it needs."""
        for _ in range(int(self.traffic["warmup_intervals"])):
            self.step_interval()
        if trace is not None:
            with trace.profiler():
                self.step_interval()
        _sync(self.device)
        self.reports_before = self.sim.currentStep // self.interval

    def window(self, seconds):
        """Intervals, closed loop, until `seconds` have passed: the wall
        time of each, the window's, and the counters' changes."""
        ctx = self.context
        clock0, step0 = float(_seconds(ctx.getTime())), self.sim.currentStep
        issue0, rebuild0 = ctx.issue_seconds, ctx.rebuild_count
        escalation0 = ctx.escalation_count
        times, ends, counts = [], [], []
        clocks = Clocks(self.device)
        self.spans.active = True
        t_start = time.perf_counter()
        clocks.start(t_start)
        try:
            while True:
                t0 = time.perf_counter()
                self.step_interval()
                t1 = time.perf_counter()
                times.append(t1 - t0)
                ends.append(t1 - t_start)
                counts.append((ctx.rebuild_count, ctx.escalation_count))
                if t1 - t_start >= seconds:
                    break
        finally:
            self.spans.active = False
            samples = clocks.stop()
        return {"interval_s": times, "window_s": t1 - t_start,
                "interval_end_s": ends, "clocks": samples,
                "interval_counts": [(rebuild0, escalation0)] + counts,
                "device_step_s": self.device_step_seconds(),
                "steps": self.sim.currentStep - step0,
                "simulated_ps": float(_seconds(ctx.getTime())) - clock0,
                "issue_s": ctx.issue_seconds - issue0,
                "rebuilds": ctx.rebuild_count - rebuild0,
                "escalations": ctx.escalation_count - escalation0}

    def traced(self, trace, intervals):
        """`intervals` more intervals under the profiler, in a window span,
        with the host spans in the profiler's timeline."""
        _sync(self.device)
        self.spans.traced = trace.span
        with trace.profiler() as prof:
            with trace.span(trace.WINDOW_SPAN):
                for _ in range(intervals):
                    self.step_interval()
                _sync(self.device)
        self.spans.traced = None
        return prof

    def step_pair(self, final):
        """The final state and the state one Simulation.step(1) later,
        through the same captured step: positions and velocities at both,
        the box, the step count at the first."""
        if self.barostat is not None:
            freq = int(self.barostat["frequency"])
            if final["step"] % freq == freq - 1:
                raise RuntimeError("the barostat would move the box in the "
                                   "step after the window; choose a report "
                                   "interval that is a multiple of its "
                                   "frequency")
        self.sim.step(1)
        st = self.context.getState(getPositions=True, getVelocities=True)
        widths = np.diag(np.asarray(_seconds(st.getPeriodicBoxVectors(
            asNumpy=True)), float))
        if not np.array_equal(widths, np.diag(final["box"])):
            raise RuntimeError("the box changed in the step after the "
                               "window")
        return {"x0": final["positions"], "v0": final["velocities"],
                "x1": np.asarray(_seconds(st.getPositions(asNumpy=True)),
                                 float),
                "v1": np.asarray(_seconds(st.getVelocities(asNumpy=True)),
                                 float),
                "widths": widths, "step": final["step"]}

    def final(self):
        """The final state, as the program hands it back."""
        st = self.context.getState(getPositions=True, getVelocities=True,
                                   getForces=True, getEnergy=True)
        return {"positions": np.asarray(_seconds(st.getPositions(
                    asNumpy=True)), float),
                "velocities": np.asarray(_seconds(st.getVelocities(
                    asNumpy=True)), float),
                "forces": np.asarray(_seconds(st.getForces(asNumpy=True)),
                                     float),
                "energy": float(_seconds(st.getPotentialEnergy())),
                "box": np.asarray(_seconds(st.getPeriodicBoxVectors(
                    asNumpy=True)), float),
                "step": self.sim.currentStep}

    def close(self):
        """Flush and close the reporters' files and free the program."""
        self.csv_file.close()
        for rep in self.sim.reporters:
            out = getattr(rep, "_out", None)
            if out is not None and not out.closed:
                out.close()
        del self.sim, self.context, self.integrator
        gc.collect()
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()


class Clocks:
    """The card's SM and memory clocks, power draw, temperature and active
    clock-limit reasons, sampled by one `nvidia-smi -lms` process while
    the window is open: [(seconds into the window, sm MHz, memory MHz,
    W, C, reasons)]. Off a card, or without nvidia-smi, nothing."""

    FIELDS = ("timestamp,clocks.sm,clocks.mem,power.draw,temperature.gpu,"
              "clocks_throttle_reasons.active")
    PERIOD_MS = 250

    def __init__(self, device):
        self.device = device
        self.proc = self.thread = None
        self.samples = []

    def start(self, t_start):
        if self.device.type != "cuda":
            return
        try:
            self.proc = subprocess.Popen(
                ["nvidia-smi", "--query-gpu=" + self.FIELDS,
                 "--format=csv,noheader,nounits",
                 "-lms", str(self.PERIOD_MS)],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
                bufsize=1)
        except OSError:
            return
        self.thread = threading.Thread(target=self._read, args=(t_start,),
                                       daemon=True)
        self.thread.start()

    def _read(self, t_start):
        for line in self.proc.stdout:
            parts = [p.strip() for p in line.split(",")]
            if len(parts) != 6:
                continue
            try:
                row = [float(v) for v in parts[1:5]]
            except ValueError:
                continue
            self.samples.append((time.perf_counter() - t_start, *row,
                                 parts[5]))

    def stop(self):
        if self.proc is None:
            return []
        self.proc.terminate()
        try:
            self.proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
        self.thread.join(timeout=10)
        return list(self.samples)


def outputs(run, final, step, seed, sample) -> dict:
    """What the timed path handed back, read from the reporters' files:
    the window's rows and frames (after the warm-up's), `sample` report
    intervals drawn from the seed (and always the last) with their frames,
    the final state and the step after it (Run.step_pair)."""
    import check
    rows = check.read_state_data(run.tmp / "state.csv")
    frames, boxes = check.read_dcd(run.tmp / "frames.dcd")
    if len(rows) != len(frames):
        raise RuntimeError("%d StateData rows but %d DCD frames"
                           % (len(rows), len(frames)))
    first = run.reports_before
    rows, frames, boxes = rows[first:], frames[first:], boxes[first:]
    rng = np.random.default_rng([seed & 0xFFFFFFFF,
                                (seed >> 32) & 0xFFFFFFFF, 11])
    picks = sorted(set(rng.choice(len(rows) - 1, size=min(
        sample, len(rows) - 1), replace=False).tolist()) | {len(rows) - 1}
        ) if len(rows) > 1 else [len(rows) - 1]
    if int(rows[-1]["Step"]) != final["step"]:
        raise RuntimeError("the last report is not at the final step")
    return {"device": run.device, "rows": rows, "frames": frames,
            "frame_boxes": boxes,
            "sampled": [(int(rows[k]["Step"]),
                         rows[k]["Potential Energy (kJ/mole)"],
                         frames[k].astype(float), boxes[k]) for k in picks],
            "last_kinetic": rows[-1]["Kinetic Energy (kJ/mole)"],
            "final": final, "step": step,
            "barostat": run.barostat is not None,
            "start_widths": run.start_widths}


def p90(values) -> float:
    """The 90th percentile (statistics.quantiles, exclusive method)."""
    return statistics.quantiles(values, n=10)[-1]


def metric_data(run, win, trace_reading, problem) -> dict:
    """What the per-layer metrics' readers read."""
    return {"steps": win["steps"], "intervals": len(win["interval_s"]),
            "window_s": win["window_s"],
            "counters": {k: win[k] for k in ("issue_s", "rebuilds",
                                             "escalations")},
            "device_step_s": win["device_step_s"],
            "spans": dict(run.spans.times), "trace": trace_reading,
            "traced_steps": (trace_reading or {}).get("steps"),
            "problem": problem}


def execute(name, seed, seconds, trace, device, *, config=None,
            traffic=None, per_layer=(), fault=None, started=None,
            control=False, log=print) -> dict:
    """One run of workload `name`. Returns the result's pieces: metrics,
    the numbers compared with their limits, device readings, breakdown."""
    import torch
    started = time.perf_counter() if started is None else started
    if config is None or traffic is None:
        w = workload(name)
        config = config or load("configs", w["config"])
        traffic = traffic or load("traffic", w["traffic"])
    tracer = None
    if trace:
        import timeline as tracer
    if device.type == "cuda":
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
    run = Run(name, config, traffic, seed, device, fault)
    run.warm_up(tracer)
    setup_s = time.perf_counter() - started
    win = run.window(seconds)
    ns_per_day = win["simulated_ps"] / win["window_s"] * 86.4
    for label, times in (("interval", win["interval_s"]),
                         ("integrator.step", run.spans.times.get(
                             "integrator.step", ())),
                         ("report", run.spans.times.get("report", ()))):
        log("%s ms: %s" % (label, " ".join("%.2f" % (t * 1e3)
                                             for t in times)))
    log("window: %d intervals, %d steps, %.6f s; %.6f ns/day; rebuilds %d, "
        "escalations %d" % (len(win["interval_s"]), win["steps"],
                            win["window_s"], ns_per_day, win["rebuilds"],
                            win["escalations"]))
    counts = win["interval_counts"]
    log("interval rebuilds (+escalations): %s" % " ".join(
        "%d%s" % (b[0] - a[0], "+%d" % (b[1] - a[1]) if b[1] > a[1] else "")
        for a, b in zip(counts, counts[1:])))
    if win["clocks"]:
        log("interval sm MHz, memory MHz, W: %s" % " ".join(
            "%s,%s,%s" % reading for reading in interval_clocks(win)))
        log("clock-limit reasons seen: %s" % " ".join(sorted(
            {c[5] for c in win["clocks"]})))
    reading = prof = None
    if trace:
        prof = run.traced(tracer, int(traffic["trace_intervals"]))
    _sync(device)
    final = run.final()
    step = run.step_pair(final)
    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else None)
    problem = None
    if trace:
        import roofline
        reading = tracer.read(prof, set(run.spans.times) | {
            "interval", "report", "getState", "integrator.step",
            "report.StateDataReporter", "report.DCDReporter"})
        reading["steps"] = int(traffic["trace_intervals"]) * run.interval
        del prof
        log("tracing overhead: %.6f ns/day in the traced window against "
            "%.6f untraced" % (reading["steps"] * config["step_fs"] * 1e-3
                               / reading["window_s"] * 86.4, ns_per_day))
        widths = np.diag(final["box"])
        problem = {"n_atoms": len(final["positions"]),
                   "pairs": roofline.count_pairs(
                       torch.as_tensor(final["positions"], device=device),
                       widths, config["cutoff_nm"]),
                   "grid": run_grid(config, run.start_widths)}
    out = outputs(run, final, step, seed, int(traffic["sample_reports"]))
    data = metric_data(run, win, reading, problem)
    run.close()
    tmp = run.tmp
    try:
        result = judge(run.tables, config, out, win, data, per_layer,
                       control, seed, log)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    result.update({"setup_s": setup_s, "ns_per_day": ns_per_day,
                   "interval_p90_ms": p90(win["interval_s"]) * 1e3
                   if len(win["interval_s"]) >= 2 else None,
                   "memory_peak_bytes": memory_peak, "window": win})
    if reading is not None:
        result["busy_s"] = reading["busy_s"]
        result["traced_window_s"] = reading["window_s"]
        result["breakdown"] = tracer.breakdown(reading)
        result["gaps_by_span"] = tracer.gaps_by_span(reading)
    return result


def interval_clocks(win):
    """(median SM clock, memory clock, power) of the samples inside each
    interval of the window, "-" where none fell inside."""
    out, start = [], 0.0
    for end in win["interval_end_s"]:
        inside = [c for c in win["clocks"] if start <= c[0] < end]
        out.append(tuple("%.0f" % statistics.median(c[k] for c in inside)
                         for k in (1, 2, 3)) if inside else ("-",) * 3)
        start = end
    return out


def run_grid(config, widths):
    reference = load_module(config["reference"])
    return reference.pme_parameters(config["cutoff_nm"],
                                    config["ewald_tolerance"], widths)[1]


def judge(tables, config, out, win, data, per_layer, control, seed,
          log) -> dict:
    """The numbers compared and their verdict, the attempts and failures
    (report intervals), the per-layer metrics, and with `control` the
    control's numbers too."""
    import check
    reference = load_module(config["reference"])
    got = check.numbers(tables, config, out, reference)
    limits = config["limits"]
    verdict = check.judge(got, limits)
    attempted = len(win["interval_s"])
    bad_rows = sum(1 for r in out["rows"][:attempted]
                   if not all(math.isfinite(v) for v in r.values()))
    bad_samples = sum(1 for e in out["sampled_errs"]
                      if not e <= limits["energy_err"])
    failed = min(attempted, bad_rows + bad_samples)
    correct = failed == 0 and attempted > 0 and all(
        ok for _, _, ok in verdict.values())
    metrics = {}
    for name in per_layer:
        value = load("metrics", name).read(data)
        if value is not None:
            metrics[name] = value
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "checks": verdict, "per_layer": metrics}
    if control:
        result["control"] = check.numbers(
            tables, config, check.control_outputs(tables, config, out,
                                                  reference, seed),
            reference)
    return result
