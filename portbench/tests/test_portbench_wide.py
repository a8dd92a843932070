"""The wide reference (``reference/als_wr_wide.py``) at small sizes on the
CPU: a rank-256 ALS-WR epoch of the port's plain path against it, with
f32 and bf16 gathers, under the limits of
``test_portbench_reference.py::test_one_epoch_matches_the_port``; and its
smaller float64 blocks against ``als_wr.py``'s."""

import pytest

from portbench.tests import wide_epoch as we


@pytest.fixture(scope="module")
def data():
    return we.make_data()


@pytest.mark.parametrize("bf16,limit", we.GATHERS, ids=we.GATHER_IDS)
def test_one_epoch_matches_the_port_at_rank_256(data, bf16, limit):
    we.check_one_epoch(data, bf16, limit)


def test_wide_blocks_equal_als_wr_in_float64(data, monkeypatch):
    we.check_blocks_change_nothing(data, monkeypatch)


def test_wide_reference_blocks_fit_at_rank_256():
    """A block's float64 A at k 256 stays near 1 GB, its gathered rows
    near 2 GB, where ``mf.solve_side``'s defaults would take ~17 GB."""
    ref = we.wide()
    assert ref.MAX_BATCH * we.K * we.K * 8 <= 1.1e9
    assert ref.BUDGET * we.K * 8 <= 2.2e9
    assert (1 << 15) * we.K * we.K * 8 > 17e9
