"""Traffic: the paper's table families and the closed-loop query stream.

The family generators are a copy of ``src/repro_torch/core/datasets.py``
(commit 59c63ea40a24), kept here so that a change to the program cannot move
the benchmark's inputs.  Only the key-making arithmetic is copied; each
generator returns plain ``(uid, text, latent)`` rows and the criteria text,
without the simulated oracle's profile, which nothing here reads.

A mix file (``bench/mixes/<mix>.json``) names one family, its arguments,
the access path and its parameters, the LIMIT and the number of clients.
Client ``c``'s ``q``-th query reads a fresh table drawn from the run's seed,
``c`` and ``q``: the same seed gives every run the same tables, in the same
order per client.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Table:
    rows: list          # [(uid, text, latent)]
    criteria: str


def _mk_keys(rng: np.random.Generator, n: int, latents: np.ndarray,
             words_lo: int, words_hi: int, stem: str) -> list:
    keys = []
    for i in range(n):
        n_words = int(rng.integers(words_lo, words_hi + 1))
        words = rng.integers(0, 50_000, size=n_words)
        text = f"{stem}-{i} " + " ".join(f"w{w}" for w in words)
        keys.append((i, text, float(latents[i])))
    return keys


def nba_heights(n: int = 200, seed: int = 0) -> Table:
    rng = np.random.default_rng(seed)
    z = rng.standard_normal(n)
    return Table(_mk_keys(rng, n, z, 2, 4, "player"), "player height")


def world_population(n: int = 200, seed: int = 1) -> Table:
    rng = np.random.default_rng(seed)
    z = np.sort(rng.standard_normal(n) * 1.4)[::-1].copy()
    rng.shuffle(z)
    return Table(_mk_keys(rng, n, z, 1, 3, "region"), "population of the region")


def passages(n: int = 100, seed: int = 2, query: str = "define bmt medical") -> Table:
    rng = np.random.default_rng(seed)
    z = rng.gamma(shape=1.3, scale=0.8, size=n)
    return Table(_mk_keys(rng, n, z, 120, 400, "passage"),
                 f"relevance to query: {query}")


def tweets(n: int = 120, seed: int = 3, sentiment: str = "positivity") -> Table:
    rng = np.random.default_rng(seed)
    z = rng.standard_normal(n)
    return Table(_mk_keys(rng, n, z, 8, 40, "tweet"), f"intensity of {sentiment}")


def movie_reviews(n: int = 150, seed: int = 4) -> Table:
    rng = np.random.default_rng(seed)
    z = rng.standard_normal(n)
    return Table(_mk_keys(rng, n, z, 60, 180, "review"), "degree of positivity")


FAMILIES = {"nba_heights": nba_heights, "world_population": world_population,
            "passages": passages, "tweets": tweets,
            "movie_reviews": movie_reviews}


def table_seed(seed: int, client: int, query: int) -> int:
    """The table seed of client ``client``'s ``query``-th query."""
    return int(np.random.SeedSequence([int(seed), client, query])
               .generate_state(1, dtype=np.uint32)[0])


def _same_length_words(text: str, seed: int) -> str:
    """``text`` with each ``w<n>`` word replaced by another of as many
    digits, drawn from ``seed``: the same bytes long, other words."""
    rng = np.random.default_rng([int(seed), 13])
    out = []
    for tok in text.split(" "):
        if tok[:1] == "w" and tok[1:].isdigit():
            lo = 0 if len(tok) == 2 else 10 ** (len(tok) - 2)
            hi = min(10 ** (len(tok) - 1), 50_000)
            tok = f"w{int(rng.integers(lo, hi))}"
        out.append(tok)
    return " ".join(out)


def make_table(mix: dict, seed: int, client: int, query: int) -> Table:
    """The table of one query: the mix's family, its arguments (a string
    argument may name ``{client}`` and ``{query}``), and a seed drawn from
    the run's seed and the query's place in the stream.

    Where the model's answers set a query's work (a quicksort's rounds
    follow its verdicts), one seed's tables would carry more work than
    another's.  A mix with ``fixed_tables`` serves every seed the same
    tables, dealt to its clients in an order drawn from the seed (client
    ``c`` reads the stream of client ``perm[c]``).  A mix with
    ``fixed_sizes`` takes the table of the query's place alone and draws
    only its words from the run's seed, each as many bytes long: every seed
    serves prompts of the same lengths with other words."""
    family = FAMILIES[mix["family"]]
    if mix.get("fixed_tables") and client < mix["clients"]:
        perm = np.random.default_rng([int(seed), 17]).permutation(mix["clients"])
        client, seed = int(perm[client]), 0
    args = {k: (v.format(client=client, query=query) if isinstance(v, str) else v)
            for k, v in mix.get("family_args", {}).items()}
    if not mix.get("fixed_sizes"):
        return family(seed=table_seed(seed, client, query), **args)
    base = family(seed=table_seed(0, client, query), **args)
    words = table_seed(seed, client, query)
    return Table([(u, _same_length_words(t, words + u), z) for u, t, z in base.rows],
                 base.criteria)
