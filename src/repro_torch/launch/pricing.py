"""Close the loop: derive the ORDER BY optimizer's PriceSheet from the port's
own serving roofline, instead of an external API's price list.

Counterpart of ``src/repro/launch/pricing.py``, the same math on the port's
dry-run records.  The paper bills oracle calls at an API's $/Mtoken.  When
the oracle is a model this framework serves, the honest price is

    $/token = (cards x $/card-hour / 3600) / (tokens/s at the roofline bound)

with prefill tokens priced off the prefill_32k cell and decode tokens off
decode_32k.  The reference defaults to a TPU v5e chip-hour price; the repo
holds no sourced H100 price, so ``chip_hour_usd`` is a required keyword and
a caller names the figure it assumes.
"""
from __future__ import annotations

import json

from ..core.oracles.base import PriceSheet
from ..models.config import SHAPES


def _bound(rec: dict) -> float:
    return rec["roofline"]["step_time_bound_s"]


def price_sheet_from_records(recs: list[dict], arch: str, *,
                             chip_hour_usd: float,
                             utilization: float = 0.6) -> PriceSheet:
    """PriceSheet for ``arch`` from its prefill/decode roofline bounds.

    ``utilization`` discounts ideal roofline throughput to a realistic
    serving duty cycle.
    """
    by = {(r["arch"], r["shape"]): r for r in recs
          if "roofline" in r and not r.get("multi_pod")}
    pre = by.get((arch, "prefill_32k"))
    dec = by.get((arch, "decode_32k"))
    if pre is None or dec is None:
        raise KeyError(f"no prefill/decode records for {arch}")
    chips = pre["chips"]
    pod_usd_per_s = chips * chip_hour_usd / 3600.0

    pre_tok_s = SHAPES["prefill_32k"].tokens_per_step / _bound(pre) * utilization
    dec_tok_s = SHAPES["decode_32k"].tokens_per_step / _bound(dec) * utilization
    return PriceSheet(
        input_per_mtok=pod_usd_per_s / pre_tok_s * 1e6,
        output_per_mtok=pod_usd_per_s / dec_tok_s * 1e6,
        name=f"{arch}@self-hosted",
    )


def price_sheet_from_file(path: str, arch: str, **kw) -> PriceSheet:
    with open(path) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    return price_sheet_from_records(recs, arch, **kw)
