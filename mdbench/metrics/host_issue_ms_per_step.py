"""host_issue_ms_per_step: the host's milliseconds a step spent issuing
work in the Context's step loop (context.py: Context.issue_seconds, its
change over the window, over the window's steps)."""


def read(data):
    if not data["steps"]:
        return None
    return data["counters"]["issue_s"] / data["steps"] * 1e3
