"""Rates, percentiles and the FLOP count of ``mfu``."""
import statistics

import numpy as np

from bench.architectures import dense
from bench.harness.cell import p90


def test_p90_is_over_every_query_not_medians_of_chunks():
    rng = np.random.default_rng(3)
    lat = list(rng.lognormal(1.0, 0.8, size=137))
    want = float(np.percentile(lat, 90))          # linear, over all values
    assert abs(p90(lat) - want) < 1e-9
    chunks = [statistics.median(lat[i:i + 10]) for i in range(0, len(lat), 10)]
    assert abs(p90(lat) - float(np.percentile(chunks, 90))) > 0.1
    assert p90([4.0]) == 4.0


def test_probe_rate_counts_every_query_ledger():
    from bench.harness.loop import ClosedLoop

    class Ledger:
        def __init__(self, n):
            self.records = [None] * n

    class Q:
        def __init__(self, n):
            self.oracle = type("O", (), {"ledger": Ledger(n)})()

    loop = ClosedLoop.__new__(ClosedLoop)
    loop.billed_done, loop.live = 40, [Q(3), Q(5)]
    assert loop.billed() == 48


def test_flops_match_a_hand_count():
    m = {"n_layers": 24, "d_model": 2048, "n_heads": 32, "n_kv_heads": 32,
         "head_dim": 64, "d_ff": 5632, "vocab_size": 100352}
    per_layer = 2 * (2048 * 2048 * 4 + 3 * 2048 * 5632)   # q, k, v, o; SwiGLU
    assert dense.matmul_flops_per_token(m) == 24 * per_layer
    n = 100
    attn = 24 * 4 * 2048 * (n * (n + 1) // 2)            # q.k and p.v, causal
    head = 2 * 2048 * 100352
    assert dense.prompt_flops(m, n) == n * 24 * per_layer + attn + head
    gqa = dict(m, n_kv_heads=8)
    assert (dense.matmul_flops_per_token(m) - dense.matmul_flops_per_token(gqa)
            == 24 * 2 * 2 * 2048 * (32 - 8) * 64)

