"""Host milliseconds a tick spends in the operator layer (the executor's
tick and each optimizer driver's tick, less the scheduler and engine calls
inside them), over every tick of the window: the benchmark's own spans."""


def read(run: dict):
    if not run["ticks"]:
        return None
    return 1e3 * run["operator_self_s"] / run["ticks"]
