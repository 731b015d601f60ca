"""Shared pieces of the port's driver tests (tests/test_torch_eval_mode.py,
test_torch_trainer.py, test_torch_driver_parity.py, test_torch_scripts.py):
a seeded synthetic dataset at a config's geometry, as
tests/test_trainer_resume.py:10-36 has it, the port's loaders over it, and
a fixture that runs a module's tests on few torch threads."""

import numpy as np
import pytest
import torch

from ccvpe_tpu_torch.data.loader import ThreadedLoader

CITIES = ("NewYork", "Seattle", "SanFrancisco", "Chicago")


class SyntheticDataset:
    """Random (grd, sat) pairs with GT scalars, one numpy seed per index
    (offset by `seed`), so any loader order gives the same samples."""

    def __init__(self, cfg, n=16, seed=0):
        self.cfg, self.n, self.seed = cfg, n, seed

    def __len__(self):
        return self.n

    def __getitem__(self, i, rng=None):
        r = np.random.default_rng(self.seed + i)
        hg, wg = self.cfg.grd_size
        hs, ws = self.cfg.sat_size
        return {
            "grd": r.normal(size=(hg, wg, 3)).astype(np.float32),
            "sat": r.normal(size=(hs, ws, 3)).astype(np.float32),
            "row_offset": np.float32(r.uniform(-20, 20)),
            "col_offset": np.float32(r.uniform(-20, 20)),
            "angle_deg": np.float32(r.uniform(0, 360)),
        }


def train_loaders(dataset, batch, loader_cls=ThreadedLoader):
    """epoch -> a shuffled loader seeded by the epoch, as the scripts make."""
    return lambda epoch: loader_cls(dataset, batch, shuffle=True, seed=epoch, num_workers=2)


def val_loaders(dataset, batch, loader_cls=ThreadedLoader):
    """epoch -> an ordered loader that keeps the ragged tail."""
    return lambda epoch: loader_cls(dataset, batch, shuffle=False, num_workers=2,
                                    drop_last=False)


# The suite runs several pytest workers on the host's cores at once; torch's
# intra-op pool of one thread a core in each of them oversubscribes the
# cores, and training steps' many short parallel regions then slow down
# many times over. These modules train tiny() models for several steps.
DRIVER_TEST_THREADS = 2


@pytest.fixture(scope="module")
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, DRIVER_TEST_THREADS))
    yield
    torch.set_num_threads(before)
