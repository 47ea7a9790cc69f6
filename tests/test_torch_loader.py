"""The port's prefetch loader against the JAX package's: the same batches in
the same order at 1 and 4 threads (FIFO whatever thread finishes first),
per-epoch reshuffles and bucket batches; `device_prefetch` hands on a
worker's exception; and `PrefetchLoader -> device_prefetch -> CoFTrainer`
trains on the CPU (the counterpart of JAX's
`tests/test_loader.py::test_loader_feeds_trainer_end_to_end`)."""

import time

import numpy as np
import pytest
import torch

from _tiny_train import TCFG, tiny_models, triplet
from videocof_torch.data.buckets import AspectRatioBatchSampler
from videocof_torch.data.loader import PrefetchLoader, device_prefetch
from videocof_torch.training import CoFTrainer, TrainerConfig
from videocof_tpu.data import loader as jloader
from videocof_tpu.data.buckets import (AspectRatioBatchSampler as
                                       JAspectRatioBatchSampler)

torch.set_num_threads(1)


class JitteryDataset:
    """Items that finish out of order: later indices sleep less."""

    def __init__(self, n=16):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        time.sleep(0.002 * ((self.n - i) % 5))
        return {"idx": i, "data": np.full((2,), i, np.float32)}


def _order(batches):
    return [[s["idx"] for s in b] for b in batches]


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("kw", [
    dict(batch_size=4, seed=3, epochs=1),
    dict(batch_size=3, seed=0, epochs=2, drop_last=False),
    dict(batch_size=5, shuffle=False, epochs=1),
], ids=["shuffled", "two-epochs", "ordered"])
def test_order_matches_jax(threads, kw):
    ds = JitteryDataset()
    want = _order(jloader.PrefetchLoader(ds, num_threads=1, **kw))
    got = _order(PrefetchLoader(ds, num_threads=threads, **kw))
    assert got == want
    assert [s["idx"] for s in PrefetchLoader(
        ds, num_threads=threads, **kw).sample_iter()] == sum(want, [])


@pytest.mark.parametrize("threads", [1, 4])
def test_bucket_batches_match_jax(threads):
    shapes = [(512, 512)] * 6 + [(320, 768)] * 5 + [(480, 832)] * 3
    ds = JitteryDataset(len(shapes))
    want = _order(jloader.PrefetchLoader(
        ds, batch_sampler=JAspectRatioBatchSampler(shapes, 3, seed=1),
        epochs=1))
    got = _order(PrefetchLoader(
        ds, batch_sampler=AspectRatioBatchSampler(shapes, 3, seed=1),
        num_threads=threads, epochs=1))
    assert got == want
    assert all(len({shapes[i] for i in b}) == 1 for b in got)


def test_endless_loader_and_lookahead():
    """epochs=None keeps producing; at most prefetch_batches + 1 batches
    are submitted ahead of the consumer."""
    ds = JitteryDataset(8)
    seen = []
    real = ds.__getitem__
    ds.__getitem__ = lambda i: seen.append(i) or real(i)
    it = iter(PrefetchLoader(ds, batch_size=2, num_threads=4,
                             prefetch_batches=2, epochs=None))
    for taken in range(1, 8):
        assert len(next(it)) == 2
        time.sleep(0.02)
        assert len(seen) <= 2 * (taken + 3)


def test_device_prefetch_passes_on_a_workers_exception():
    def source():
        yield 1
        yield 2
        raise RuntimeError("decode failed")

    it = device_prefetch(source(), size=1)
    assert [next(it), next(it)] == [1, 2]
    with pytest.raises(RuntimeError, match="decode failed"):
        next(it)
    # the same for JAX's, on the same source
    it = jloader.device_prefetch(source(), size=1)
    assert [next(it), next(it)] == [1, 2]
    with pytest.raises(RuntimeError, match="decode failed"):
        next(it)


def test_device_prefetch_keeps_order_and_stops():
    items = list(range(20))
    assert list(device_prefetch(iter(items), size=3)) == items
    assert list(device_prefetch(iter([]), size=1)) == []


class TripletDataset:
    def __len__(self):
        return 4

    def __getitem__(self, i):
        return triplet(i, text=f"triplet {i}")


def test_loader_feeds_trainer_end_to_end():
    """PrefetchLoader -> device_prefetch -> CoFTrainer, batch 2: two steps
    take the loader's first four samples, in its order."""
    dit, vae, t5 = tiny_models()
    trainer = CoFTrainer(dit, vae, t5, None,
                         TrainerConfig(**dict(TCFG, batch_size=2),
                                       lora_rank=4), device="cpu")
    taken = []
    real = trainer.prepare_batch

    def prepare(samples):
        taken.extend(s["text"] for s in samples)
        return real(samples)

    trainer.prepare_batch = prepare
    loader = PrefetchLoader(TripletDataset(), batch_size=2, num_threads=2,
                            seed=4, epochs=None)
    state = trainer.train(device_prefetch(loader.sample_iter(), size=2),
                          total_steps=2)
    assert state.step == 2 and np.isfinite(trainer.losses).all()
    order = [s["text"] for s in
             jloader.PrefetchLoader(TripletDataset(), batch_size=2, seed=4,
                                    epochs=1).sample_iter()]
    assert taken == order and sorted(taken) == sorted(set(taken))
