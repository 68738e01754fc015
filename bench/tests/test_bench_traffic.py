"""The benchmark's copy of the table generators reproduces the program's."""
import pytest

from bench.harness import traffic


@pytest.mark.parametrize("family", ["nba_heights", "world_population", "passages",
                                    "tweets", "movie_reviews"])
@pytest.mark.parametrize("seed", [0, 17, 2**31 + 5])
def test_generators_match_the_program(family, seed):
    from repro_torch.core import datasets
    theirs = getattr(datasets, family)(seed=seed)
    ours = traffic.FAMILIES[family](seed=seed)
    assert ours.criteria == theirs.criteria
    assert ours.rows == [(k.uid, k.text, k.latent) for k in theirs.keys]


def test_table_stream_is_fixed_by_the_seed():
    mix = {"family": "passages", "family_args": {"n": 5, "query": "query-{client}"}}
    a = traffic.make_table(mix, 2**31 + 9, 3, 4)
    assert a == traffic.make_table(mix, 2**31 + 9, 3, 4)
    assert a.criteria == "relevance to query: query-3"
    assert a.rows != traffic.make_table(mix, 2**31 + 9, 3, 5).rows
    assert a.rows != traffic.make_table(mix, 2**31 + 9, 2, 4).rows


def test_fixed_sizes_keep_the_lengths_across_seeds():
    mix = {"family": "passages", "family_args": {"n": 8}, "fixed_sizes": True}
    a = traffic.make_table(mix, 2**31 + 1, 1, 2)
    b = traffic.make_table(mix, 7, 1, 2)
    assert [len(t) for _u, t, _z in a.rows] == [len(t) for _u, t, _z in b.rows]
    assert [t for _u, t, _z in a.rows] != [t for _u, t, _z in b.rows]
    c = traffic.make_table(mix, 7, 1, 3)
    assert [len(t) for _u, t, _z in c.rows] != [len(t) for _u, t, _z in b.rows]


def test_fixed_tables_deal_the_same_tables_to_other_clients():
    mix = {"family": "nba_heights", "family_args": {"n": 6}, "clients": 4,
           "fixed_tables": True}
    a = [traffic.make_table(mix, 2**31 + 1, c, 1) for c in range(4)]
    b = [traffic.make_table(mix, 5, c, 1) for c in range(4)]
    assert a != b
    assert sorted(t.rows for t in a) == sorted(t.rows for t in b)
    assert a == [traffic.make_table(mix, 2**31 + 1, c, 1) for c in range(4)]
    # the balancing table (a client no stream has) follows the seed as before
    assert (traffic.make_table(mix, 5, 4, 0)
            == traffic.make_table(dict(mix, fixed_tables=False), 5, 4, 0))
