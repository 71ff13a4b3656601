"""rebuilds_per_1k_steps: rebuilds of the candidate state of the direct
space (ops/tile_pairs.py, counted by context.py: Context.rebuild_count)
over the window, per 1,000 steps."""


def read(data):
    if not data["steps"]:
        return None
    return data["counters"]["rebuilds"] / data["steps"] * 1e3
