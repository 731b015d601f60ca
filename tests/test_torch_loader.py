"""Port vs JAX: ThreadedLoader yields the same batches in the same order
(arrays equal, same dtypes, string fields included) with shuffle on and
off, drop_last on and off, 1 and 3 shards, and a start_batch; an exception
raised in a dataset's __getitem__ reaches the consumer; default_collate
agrees."""

import dataclasses

import numpy as np
import pytest

from ccvpe_tpu.data.loader import ThreadedLoader as JaxLoader
from ccvpe_tpu.data.loader import default_collate as jax_collate
from ccvpe_tpu_torch.data.loader import ThreadedLoader, default_collate


@dataclasses.dataclass
class Item:
    x: np.ndarray
    draw: np.float32
    city: str


class ToyDataset:
    """37 samples; each draws from the loader's per-sample rng."""

    def __init__(self, n=37, fail_at=None):
        self.n, self.fail_at = n, fail_at

    def __len__(self):
        return self.n

    def __getitem__(self, i, rng=None):
        if i == self.fail_at:
            raise KeyError(f"sample {i} is broken")
        return Item(x=np.full((2, 3), i, np.int32), draw=np.float32(rng.random()),
                    city=f"city{i % 3}")


# name -> (shuffle, drop_last, num_shards, start_batch)
CASES = {f"shuffle={s} drop_last={d} shards={n}": (s, d, n, 0)
         for s in (False, True) for d in (False, True) for n in (1, 3)}
CASES.update({"start_batch=2": (True, False, 1, 2),
              "start_batch=1 shards=3": (True, True, 3, 1)})


def run(loader_cls, shuffle, drop_last, num_shards, start_batch, shard_id):
    loader = loader_cls(ToyDataset(), 4, shuffle=shuffle, seed=11, num_workers=3,
                        drop_last=drop_last, shard_id=shard_id, num_shards=num_shards)
    loader.start_batch = start_batch
    batches = [b for _ in range(2) for b in loader]   # two epochs
    return len(loader), batches


@pytest.mark.parametrize("case", list(CASES))
def test_batches_match_jax(case):
    shuffle, drop_last, num_shards, start_batch = CASES[case]
    for shard_id in range(num_shards):
        n, got = run(ThreadedLoader, shuffle, drop_last, num_shards, start_batch, shard_id)
        n_ref, want = run(JaxLoader, shuffle, drop_last, num_shards, start_batch, shard_id)
        assert n == n_ref and len(got) == len(want) > 0
        for a, b in zip(got, want):
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("loader_cls", [ThreadedLoader, JaxLoader], ids=["port", "jax"])
def test_dataset_exception_reaches_consumer(loader_cls):
    loader = loader_cls(ToyDataset(fail_at=9), 4, shuffle=False, num_workers=3)
    seen = []
    with pytest.raises(KeyError, match="sample 9 is broken"):
        for b in loader:
            seen.append(b["x"][:, 0, 0].tolist())
    assert seen == [[0, 1, 2, 3], [4, 5, 6, 7]]


def test_default_collate_matches_jax():
    items = [ToyDataset().__getitem__(i, np.random.default_rng(i)) for i in range(3)]
    for samples in (items, [dataclasses.asdict(s) for s in items]):
        got, want = default_collate(samples), jax_collate(samples)
        assert got.keys() == want.keys()
        for k in got:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    assert default_collate(items)["city"].tolist() == ["city0", "city1", "city2"]
    with pytest.raises(TypeError):
        default_collate([1, 2])
