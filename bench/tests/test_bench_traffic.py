"""The traffic is a function of the seed, and every seed does the same
work in another order."""

import collections
import itertools
import time

import torch

from bench import traffic


def _order(seed, n):
    return list(itertools.islice(traffic.asset_order(32, seed), n))


def test_same_seed_same_asset_order():
    assert _order(2 ** 31 + 5, 500) == _order(2 ** 31 + 5, 500)
    assert _order(2 ** 31 + 5, 500) != _order(2 ** 31 + 6, 500)


def test_seeds_decode_each_asset_as_often():
    for seed in (1, 2):
        counts = collections.Counter(_order(seed, 32 * 7))
        assert counts == {a: 7 for a in range(32)}


class _Service:
    """Stands in for ``DecodeService``: records each decode's thread count."""

    def __init__(self):
        self.calls = []

    def decode(self, name, threads):
        self.calls.append(threads)
        time.sleep(0.001 * (threads == 16))
        return torch.zeros(1)


def test_clients_take_turns():
    svc = _Service()
    reqs = traffic.closed_decode(svc, [f"a{i}" for i in range(32)],
                                 {"threads": [16, 128, 128, 2176]}, 0.05, 7,
                                 False, traffic.Reservoir(2, 7))
    counts = collections.Counter(r.threads for r in reqs)
    # One request a client a turn; the last turn may end part-way.
    assert counts[16] > 4 and abs(counts[16] - counts[2176]) <= 1
    assert abs(counts[128] - 2 * counts[16]) <= 2
    assert all(r.status == "ok" and r.done >= r.due for r in reqs)
    assert svc.calls[:8] == [16, 128, 128, 2176] * 2


def test_reservoir_is_seeded():
    def pick(seed):
        r = traffic.Reservoir(3, seed)
        for i in range(100):
            r.offer(lambda i=i: i)
        return r.items
    assert pick(4) == pick(4) != pick(5)
