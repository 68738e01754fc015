"""Live probe rows per engine submission over the window
(``ServeStats.probe_rows / calls``, deltas): how full the scheduler's merged
submissions are."""


def read(run: dict):
    c = run["counters"]
    return c["probe_rows"] / c["calls"] if c["calls"] else None
