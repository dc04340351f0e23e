"""The pool's rule for a traffic mix that names how many of its batches
fit the program's tight bucket and how many do not."""

from types import SimpleNamespace

import numpy as np
import pytest

from gnnbench import pool as P

TIGHT = SimpleNamespace(total_node_cap=10, edge_caps=(20,))
LOOSE = SimpleNamespace(total_node_cap=30, edge_caps=(60,))


class FakeIter:
    """Hands out batches in order; those with ``outside[i]`` do not fit
    the tight bucket."""

    def __init__(self, outside):
        from salient_plusplus_tpu_torch.sampling.sampler import \
            SamplerStats
        self.outside, self.i = outside, 0
        self.stats = SamplerStats()
        self.recycled, self.closed = [], False

    def __next__(self):
        i, self.i = self.i, self.i + 1
        b = SimpleNamespace(no=i, spec=LOOSE,
                            bucket=None if self.outside[i] else TIGHT,
                            level_sizes=np.array([2, 5]),
                            edge_counts=np.array([7 + i]))
        self.stats.batches += 1
        self.stats.real_edges += 7 + i
        return b

    def recycle(self, b):
        self.recycled.append(b.no)

    def close(self):
        self.closed = True


class FakeSampler:
    def __init__(self, outside):
        self.it = FakeIter(outside)
        self.cfg = SimpleNamespace(max_batches_in_flight=0)

    def set_epoch(self, idx, epoch):
        self.idx = idx

    def __iter__(self):
        return self.it


def test_keep_takes_the_first_of_each_kind():
    outside = [0, 0, 1, 0, 0, 1, 0]
    s = FakeSampler(outside)
    p = P.fill(s, np.arange(70), 10, order_seed=3, keep=(3, 1))
    kept = sorted(b.no for b in p.batches)
    # batches 0, 1, 3 fit, 2 does not; batch 4 is never asked for
    assert kept == [0, 1, 2, 3]
    assert s.it.recycled == [] and s.it.closed
    assert s.cfg.max_batches_in_flight == 4
    assert p.outside == 1 and p.stats.tight_batches == 3
    # the pool's own account: real edges 7 + i, each against its bucket
    assert p.real_edges == 7 + 8 + 9 + 10
    assert p.stats.padded_edges == 3 * 20 + 60
    # the seeds follow their batches through the shuffle
    for b, seeds in zip(p.batches, p.seeds):
        assert list(seeds) == list(range(10 * b.no, 10 * b.no + 10))


def test_keep_hands_back_what_it_passes_over():
    s = FakeSampler([1, 1, 0, 1, 0])
    p = P.fill(s, np.arange(50), 10, order_seed=3, keep=(2, 1))
    assert sorted(b.no for b in p.batches) == [0, 2, 4]
    assert s.it.recycled == [1, 3]
    # every batch the sampler handed out counts for the fill's rate
    assert p.sampled == 5 and p.sampled_edges == sum(range(7, 12))


def test_a_split_without_the_pool_raises():
    with pytest.raises(ValueError, match="hold no pool"):
        P.fill(FakeSampler([0, 0, 0]), np.arange(30), 10, 3, keep=(1, 1))


def test_without_keep_the_pool_is_every_batch():
    p = P.fill(FakeSampler([0, 1, 0]), np.arange(35), 10, order_seed=1)
    assert sorted(b.no for b in p.batches) == [0, 1, 2]
    assert p.outside == 1
