"""Share of prefix-cache lookups that hit, over the window
(``ServeStats.prefix_hits / (prefix_hits + prefix_misses)``, deltas)."""


def read(run: dict):
    c = run["counters"]
    lookups = c["prefix_hits"] + c["prefix_misses"]
    return 100.0 * c["prefix_hits"] / lookups if lookups else None
