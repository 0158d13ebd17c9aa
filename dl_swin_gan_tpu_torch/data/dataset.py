"""HDF5 per-patient dataset and a threaded, shuffling loader.

A copy of `data/dataset.py` in the JAX package (the reference's
`dl_cs/data/dataset.py:14-55` Hdf5Dataset and the loader it feeds): the
same shuffle (`random.Random(seed + epoch)`), `drop_last` and early-exit
release, so both packages see the same batches in the same order. The
loader yields stacked numpy dicts; the trainer moves them to the device.
`h5py` is imported only where a file is read. `InMemoryDataset` serves
files held in memory in place of an `Hdf5Dataset` (the card's machine has
no h5py).
"""

import glob
import os
import queue
import random
import threading
from typing import Callable, Iterator, List, Optional, Tuple

import numpy as np

from dl_swin_gan_tpu_torch.parallel.mesh import RankBatch


class Hdf5Dataset:
    """One .h5 per patient: kspace [slices,C,T,Y,X], maps [slices,E,C,1,Y,X],
    target [slices,E,T,Y,X]; flattened to (file, slice) examples."""

    def __init__(self, root_directory: str, transform: Callable,
                 sample_rate: float = 1.0):
        import h5py
        self.transform = transform
        self.examples: List[Tuple[str, int]] = []
        files = glob.glob(os.path.join(root_directory, "*.h5"))
        if sample_rate < 1.0:
            random.shuffle(files)
            files = files[:round(len(files) * sample_rate)]
        for filename in sorted(files):
            with h5py.File(filename, "r") as f:
                num_slices = f["kspace"].shape[0]
            self.examples += [(filename, s) for s in range(num_slices)]

    def __len__(self) -> int:
        return len(self.examples)

    def __getitem__(self, index: int) -> dict:
        import h5py
        filename, sl = self.examples[index]
        with h5py.File(filename, "r") as data:
            kspace = data["kspace"][sl]
            maps = data["maps"][sl]
            target = data["target"][sl]
        return self.transform(kspace, maps, target, filename)


class InMemoryDataset:
    """Files held in memory, flattened to (file, slice) examples as
    `Hdf5Dataset` flattens its files: `files` holds one (name, kspace, maps,
    target) per file, each array stacked over the file's slices (the records
    of `data/synthetic.synthetic_files`). The transform gets the file's name
    where `Hdf5Dataset` passes its path."""

    def __init__(self, files, transform: Callable):
        self.files = list(files)
        self.transform = transform
        self.examples = [(i, s) for i, f in enumerate(self.files)
                         for s in range(len(f[1]))]

    def __len__(self) -> int:
        return len(self.examples)

    def __getitem__(self, index: int) -> dict:
        i, sl = self.examples[index]
        name, kspace, maps, target = self.files[i]
        return self.transform(kspace[sl], maps[sl], target[sl], name)


class DataLoader:
    """Threaded shuffling loader producing batched numpy dicts.

    Takes any dataset with `__len__` and `__getitem__` (an Hdf5Dataset, or
    examples held in memory). Examples are stacked along a new batch axis;
    all examples of one batch must share shapes. One producer thread runs
    the (numpy/h5py, GIL-releasing) preprocess ahead of the consumer,
    `prefetch` batches deep. `num_workers` is kept for the JAX package's
    signature and config key; there is one producer.

    `shard` (index, count): a data-parallel rank's loader. The batches are
    the global ones, in the same order, and this rank collates its
    contiguous slice of each (a `RankBatch`); a transform with a
    `draw_seed` draws each example from its global position (the k of
    (draw_seed, k)), so the ranks' slices make up the one-rank batch bit
    for bit.
    """

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = True,
                 num_workers: int = 4, prefetch: int = 2,
                 seed: Optional[int] = None, drop_last: bool = True,
                 shard: Tuple[int, int] = (0, 1)):
        if batch_size % shard[1]:
            raise ValueError(f"batch {batch_size} does not split over "
                             f"{shard[1]} ranks")
        self.shard = shard
        self._drawn = 0     # examples of the batches yielded so far
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)
        self.seed = seed
        self.drop_last = drop_last
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batches(self) -> List[List[int]]:
        idx = list(range(len(self.dataset)))
        if self.shuffle:
            rng = random.Random(None if self.seed is None
                                else self.seed + self._epoch)
            rng.shuffle(idx)
        out = [idx[i:i + self.batch_size]
               for i in range(0, len(idx), self.batch_size)]
        if self.drop_last:
            out = [b for b in out if len(b) == self.batch_size]
        return out

    def _rank_slice(self, batch_idx: List[int]) -> List[int]:
        """This rank's part of a global batch; with a seeded transform, its
        draw counter moved to the slice's first global position."""
        first = self._drawn
        self._drawn += len(batch_idx)
        index, count = self.shard
        if count == 1:
            return batch_idx
        m = len(batch_idx) // count
        transform = getattr(self.dataset, "transform", None)
        if getattr(transform, "draw_seed", None) is not None:
            transform.draws = first + index * m
        return batch_idx[index * m:(index + 1) * m]

    def __iter__(self) -> Iterator[dict]:
        batches = self._batches()
        self._epoch += 1
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def collate(batch_idx):
            examples = [self.dataset[i] for i in self._rank_slice(batch_idx)]
            out = {k: np.stack([ex[k] for ex in examples])
                   for k in examples[0]}
            return RankBatch(out) if self.shard[1] > 1 else out

        error = []

        def put(item) -> bool:
            """Bounded put that wakes up when the consumer abandons the
            iterator: a plain q.put() would block forever on a full queue,
            leaking the thread and its prefetched batches every time a
            caller breaks out early."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for b in batches:
                    if stop.is_set():
                        return
                    if not put(collate(b)):
                        return
            except BaseException as e:  # propagate to the consumer
                error.append(e)
            finally:
                put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                yield item
            if error:
                raise error[0]
        finally:
            stop.set()
