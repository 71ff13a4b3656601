"""kernels_per_step: device kernels (memory copies and sets left out) in
the traced window's timeline over its steps: the size of the captured
step (step_program.py) with what the reports launch."""


def read(data):
    trace = data["trace"]
    if not trace or not data["traced_steps"] or not trace["kernels"]:
        return None
    return trace["kernels"] / data["traced_steps"]
