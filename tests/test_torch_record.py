"""The port's top-c store against the JAX package's.

``code_robchar_tpu_torch.utils.record.TopControllers.offer_many`` drops the
offers that cannot change the store and replays the rest through
``offer``; the JAX package's ``TopControllers`` offers every pair one by
one.  After each batch both stores must hold the same keys (by ``repr``, so
``-0.0`` and ``0.0`` stay apart), the same controllers and the same
insertion order.  The counters ``offered`` / ``replayed`` say how often the
filter let an offer through.
"""

import numpy as np
import pytest

from code_robchar_tpu.utils import TopControllers as RefTop
from code_robchar_tpu_torch.utils.record import TopControllers

DIM = 8


def _state(top):
    items = [(repr(k), v) for k, v in top._store.items()]
    return items, top.controllers(), repr(top.best_fid())


def _offer_both(ref, port, fids, ctrls):
    ref.offer_many(fids, ctrls)
    port.offer_many(fids, ctrls)
    assert _state(port) == _state(ref)


def _pool(rng, size, dtype):
    """``size`` distinct-ish keys with ``-0.0`` and ``0.0`` among them."""
    vals = rng.uniform(-1, 1, size - 2).astype(dtype)
    return np.concatenate([vals, np.array([-0.0, 0.0], dtype)])


def _batch(rng, pool, size):
    fids = rng.choice(pool, size)
    ctrls = rng.standard_normal((size, DIM)).astype(pool.dtype)
    return fids, ctrls


def _run(rng, cap, kind):
    ref, port = RefTop(cap), TopControllers(cap)
    dtype = np.float32 if rng.random() < 0.5 else np.float64
    pool = _pool(rng, int(rng.integers(3, 201)), dtype)
    if kind == "partly_filled":
        # a store left partly filled by single offers, as SNOB's loop does
        for _ in range(int(rng.integers(0, cap + 1))):
            f, c = _batch(rng, pool, 1)
            ref.offer(float(f[0]), c[0].tolist())
            port.offer(float(f[0]), c[0].tolist())
    for _ in range(int(rng.integers(1, 5))):
        size = int(rng.integers(1, 3 * cap + 2000))
        fids, ctrls = _batch(rng, pool, size)
        if kind == "last_below_min":
            fids[-1] = pool.min() - 1
        elif kind == "nan":
            fids[int(rng.integers(size))] = np.nan
        elif kind == "close_float64":
            # keys one float64 step apart, which float32 cannot tell apart
            fids = 0.5 + np.asarray(rng.integers(0, 40, size)) * 2.0**-52
        _offer_both(ref, port, fids, ctrls)


@pytest.mark.parametrize("kind", ["collisions", "partly_filled",
                                  "last_below_min", "nan", "close_float64"])
@pytest.mark.parametrize("cap", [1, 2, 3, 100, 1000])
def test_offer_many_matches_one_by_one_reference(cap, kind):
    rng = np.random.default_rng([cap, len(kind), 2**33 + 17])
    runs = 12 if cap == 1000 else 40
    for _ in range(runs):
        _run(rng, cap, kind)


@pytest.mark.parametrize("cap", [2, 3, 100])
def test_rising_batch_keeps_every_offer(cap):
    """The filter's worst case: every key above the store's floor."""
    rng = np.random.default_rng(cap)
    ref, port = RefTop(cap), TopControllers(cap)
    fids = np.sort(rng.standard_normal(5000))
    ctrls = rng.standard_normal((5000, DIM))
    _offer_both(ref, port, fids, ctrls)
    assert port.replayed == port.offered == 5000


def test_capacity_one_replays_only_the_last_offer():
    """A store of one entry ends with the batch's last pair: every other
    pair lies below its floor (+inf)."""
    rng = np.random.default_rng(1)
    ref, port = RefTop(1), TopControllers(1)
    for _ in range(3):
        fids = np.sort(rng.standard_normal(5000))
        _offer_both(ref, port, fids, rng.standard_normal((5000, DIM)))
    assert (port.offered, port.replayed) == (15000, 3)


def test_epoch_of_iid_rewards_replays_under_five_percent():
    """PPO's shape: 1,024 agents x 500 steps of float32 rewards offered to
    a top-100 store in one batch, then a second epoch's."""
    rng = np.random.default_rng(2**31 + 5)
    ref, port = RefTop(100), TopControllers(100)
    n = 512_000
    for epoch in range(2):
        fids = rng.random(n, dtype=np.float32) + np.float32(0.01 * epoch)
        ctrls = rng.standard_normal((n, DIM), dtype=np.float32)
        before = port.replayed
        _offer_both(ref, port, fids, ctrls)
        assert port.replayed - before < 0.05 * n
        # a full store's floor is its second least key (the store keeps
        # its newest offer, however low): well under 1% get through
        assert port.replayed - before < 0.01 * n
    assert port.offered == 2 * n


def test_nan_batch_replays_every_offer():
    rng = np.random.default_rng(11)
    ref, port = RefTop(10), TopControllers(10)
    fids, ctrls = rng.random(3000), rng.standard_normal((3000, DIM))
    fids[1500] = np.nan
    _offer_both(ref, port, fids, ctrls)
    assert (port.offered, port.replayed) == (3000, 3000)
    # the last offer always enters: with a NaN in the store, the next
    # clean batch is replayed whole too
    fids[-1] = np.nan
    _offer_both(ref, port, fids, ctrls)
    assert any(k != k for k in port._store)
    fids2, ctrls2 = rng.random(3000), rng.standard_normal((3000, DIM))
    _offer_both(ref, port, fids2, ctrls2)
    assert (port.offered, port.replayed) == (9000, 9000)


@pytest.mark.parametrize("cap, distinct", [(100, 50), (1000, 900)])
def test_store_below_capacity_replays_every_offer(cap, distinct):
    """Keys from a pool too small to bring the store to ``capacity - 1``
    entries: every offer is replayed."""
    rng = np.random.default_rng(cap)
    pool = rng.standard_normal(distinct)
    ref, port = RefTop(cap), TopControllers(cap)
    fids = rng.choice(pool, 5000)
    _offer_both(ref, port, fids, rng.standard_normal((5000, DIM)))
    assert len(port) <= distinct < cap - 1
    assert (port.offered, port.replayed) == (5000, 5000)


def test_offer_many_takes_lists_and_the_shorter_length():
    """``zip``'s contract: lists of Python floats, and a batch cut at the
    shorter of the two sequences."""
    ref, port = RefTop(2), TopControllers(2)
    fids = [0.3, -0.0, 0.9, 0.0, 0.1]
    ctrls = [[1.0], [2.0], [3.0], [4.0]]
    _offer_both(ref, port, fids, ctrls)
    assert port.offered == 4
    _offer_both(ref, port, [], [])
