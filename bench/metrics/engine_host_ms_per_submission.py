"""Host milliseconds the engine spends per probe submission, from the
program's own spans over the traced slice: the self time of every
``engine.*`` span but ``engine.readback`` (where the host waits for the
device), over the submissions (``engine.prefill`` and
``engine.prefill_cont`` spans)."""
from bench.harness.program_trace import self_ms, span_count, summary

SUBMISSIONS = ("engine.prefill", "engine.prefill_cont")


def read(run: dict):
    s = summary()
    n = sum(span_count(s, k) for k in SUBMISSIONS) if s else 0
    if not n:
        return None
    host = [k for k in s["spans"] if k.startswith("engine.") and k != "engine.readback"]
    return self_ms(s, host) / n
