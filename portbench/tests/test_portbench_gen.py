"""The benchmark's generator: seeded, exact counts, distinct pairs, skewed
degrees, and the split's sizes."""

import torch

from portbench.gen import ratings as gen

SHAPE = dict(n_users=2000, n_items=700, n_ratings=60_000, true_rank=16,
             noise=0.3, test_fraction=0.05, power_law=1.0)


def make(seed):
    return gen.make_ratings(**SHAPE, seed=seed, device="cpu")


def test_same_seed_same_bits_other_seed_other_bits():
    a, b, c = make(2**31 + 17), make(2**31 + 17), make(5)
    for x, y in zip(a[:8], b[:8]):
        assert torch.equal(x, y)
    assert not torch.equal(a.train_u, c.train_u)


def test_exact_counts_and_split():
    d = make(3)
    n_test = int(SHAPE["n_ratings"] * SHAPE["test_fraction"])
    assert d.test_u.numel() == n_test
    assert d.train_u.numel() == SHAPE["n_ratings"] - n_test


def test_no_duplicate_pairs_and_ids_in_range():
    d = make(4)
    u = torch.cat([d.train_u, d.test_u])
    i = torch.cat([d.train_i, d.test_i])
    assert int(u.min()) >= 0 and int(u.max()) < SHAPE["n_users"]
    assert int(i.min()) >= 0 and int(i.max()) < SHAPE["n_items"]
    key = u * SHAPE["n_items"] + i
    assert torch.unique(key).numel() == SHAPE["n_ratings"]


def test_half_star_levels():
    d = make(6)
    r = torch.cat([d.train_r, d.test_r])
    assert torch.equal(r * 2, torch.round(r * 2))
    assert float(r.min()) >= 0.5 and float(r.max()) <= 5.0


def test_every_seed_has_the_same_degrees_in_another_order():
    a, b = make(1), make(2)
    for x, y, n in ((a.train_u, b.train_u, SHAPE["n_users"]),
                    (a.train_i, b.train_i, SHAPE["n_items"])):
        da = torch.bincount(x, minlength=n)
        db = torch.bincount(y, minlength=n)
        assert torch.equal(torch.sort(da).values, torch.sort(db).values)
        assert not torch.equal(da, db)


def test_degree_skew_on_both_sides():
    d = make(8)
    for ids, n in ((d.train_u, SHAPE["n_users"]),
                   (d.train_i, SHAPE["n_items"])):
        deg = torch.sort(torch.bincount(ids, minlength=n),
                         descending=True).values.double()
        top = deg[: n // 100].sum() / deg.sum()
        # uniform popularity would give the top 1% about 1% of ratings
        assert top > 0.05, float(top)


def test_factors_from_the_seed():
    a = gen.start_factors(50, 8, 0.1, 9, "cpu", 1)
    b = gen.start_factors(50, 8, 0.1, 9, "cpu", 1)
    c = gen.start_factors(50, 8, 0.1, 9, "cpu", 2)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.count_nonzero(a[-1]) == 0
    P = torch.randn(30, 4)
    F = gen.served_factors(P, 8, 0.0, 1, "cpu", 3)
    assert torch.equal(F[:30, :4], P) and torch.count_nonzero(F[:, 4:]) == 0
