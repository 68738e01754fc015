"""Share of the traced slice in which no kernel, copy or fill ran on the
card: 1 - (union of device intervals) / (slice length), from the
``torch.profiler`` trace of the run."""


def read(run: dict):
    tr = run["trace"]
    if tr is None or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
