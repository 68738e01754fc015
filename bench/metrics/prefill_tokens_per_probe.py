"""Prefilled tokens (padding and region fills included, cached prefixes
excluded) per live probe row over the window
(``ServeStats.prefill_tokens / probe_rows``, deltas)."""


def read(run: dict):
    c = run["counters"]
    return c["prefill_tokens"] / c["probe_rows"] if c["probe_rows"] else None
