"""Host-side paired noisy/clean dataset + prefetching loader (a copy of the
JAX package's ``train/dataloader.py``: the same batches for the same seed).

Replicates the reference DNS3Dataset semantics (dataloader.py:21-176):

- pairing by the ``fileid_`` token in filenames (noisy/clean dirs), or by
  identical basenames (the VCTK-DEMAND layout, ``pairing="basename"``)
- fixed-length crops of ``length_seconds * fs`` samples (optional random
  start inside the first 10 s)
- per-epoch random subsample of ``num_data_per_epoch`` files
- deterministic ordering (sorted file lists) with a seeded shuffle

The loader yields statically shaped numpy batches (zero-padded crops),
decoded on a background thread pool; the training step moves them to the
device.  ``transfer_dtype="int16"`` ships the raw 16-bit PCM and lets the
step dequantize on the device (half the host-to-device bytes, bit-exact).
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import os
import threading
from typing import Iterator

import numpy as np

from gtcrn_micro_tpu_torch.io.wav import extract_fileid, find_wavs, read_wav


def build_clean_index(clean_root: str, pairing: str = "fileid") -> dict[str, str]:
    """Map pairing key -> clean path (reference _build_clean_index :21-36)."""
    index: dict[str, str] = {}
    for path in find_wavs(clean_root):
        if pairing == "fileid":
            fid = extract_fileid(path)
            if fid is not None:
                index[fid] = path
        else:  # basename (VCTK-DEMAND)
            index[os.path.basename(path)] = path
    return index


@dataclasses.dataclass
class PairedWavDataset:
    """Noisy/clean pairs with fixed-length crops."""

    noisy_root: str
    clean_root: str | None = None
    fs: int = 16000
    length_seconds: float = 8.0
    total_train_data: int = 180000
    num_data_per_epoch: int = 40000
    random_start: bool = False
    train: bool = True
    pairing: str = "fileid"
    seed: int = 43
    # "float32" (reference-exact host conversion) or "int16": emit the raw
    # 16-bit PCM samples and let the training step dequantize on the device
    # (x / 32768, bit-exact -- io/wav.read_wav): half the host->device bytes
    transfer_dtype: str = "float32"

    def __post_init__(self):
        clean_root = self.clean_root or self.noisy_root.replace("noisy", "clean")
        self.clean_index = build_clean_index(clean_root, self.pairing)
        paired = []
        for p in find_wavs(self.noisy_root):
            key = (
                extract_fileid(p)
                if self.pairing == "fileid"
                else os.path.basename(p)
            )
            if key is not None and key in self.clean_index:
                paired.append((p, self.clean_index[key]))
        if not paired:
            raise RuntimeError(
                "No paired noisy/clean files found. Check directory structure.\n"
                f"noisy_root={self.noisy_root}\nclean_root={clean_root}"
            )
        if self.train:
            paired = paired[: self.total_train_data]
        self.pairs = paired
        self.epoch_pairs = paired
        self._rng = np.random.default_rng(self.seed)
        self._epoch = 0
        self.length_samples = int(self.length_seconds * self.fs)

    def sample_data_per_epoch(self) -> None:
        """Random subsample for this epoch (reference :108-111)."""
        self._epoch += 1
        if self.train and self.num_data_per_epoch < len(self.pairs):
            idx = self._rng.choice(
                len(self.pairs), size=self.num_data_per_epoch, replace=False
            )
            self.epoch_pairs = [self.pairs[i] for i in idx]
        else:
            self.epoch_pairs = self.pairs

    def __len__(self) -> int:
        if self.train:
            return min(self.num_data_per_epoch, len(self.pairs))
        return len(self.pairs)

    def _crop(self, index: int) -> tuple[int, int]:
        if self.random_start:
            # a FRESH per-item generator: load_item runs on prefetch worker
            # threads and numpy Generators are not thread-safe; deriving from
            # (seed, epoch, index) is both safe and reproducible
            rng = np.random.default_rng((self.seed, self._epoch, index))
            max_start_s = max(10 - self.length_seconds, 0)
            begin = int(rng.uniform(0, max_start_s)) * self.fs
        else:
            begin = 0
        return begin, begin + self.length_samples

    def load_item(self, index: int) -> tuple[np.ndarray, np.ndarray]:
        noisy_path, clean_path = self.epoch_pairs[index]
        start, stop = self._crop(index)
        dt = np.int16 if self.transfer_dtype == "int16" else np.float32
        noisy, _ = read_wav(noisy_path, start=start, stop=stop, dtype=dt)
        clean, _ = read_wav(clean_path, start=start, stop=stop, dtype=dt)
        if noisy.ndim > 1:
            noisy = noisy[:, 0]
        if clean.ndim > 1:
            clean = clean[:, 0]
        # static shapes: zero-pad short files to the crop length
        out_n = np.zeros(self.length_samples, dt)
        out_c = np.zeros(self.length_samples, dt)
        n = min(len(noisy), self.length_samples)
        out_n[:n] = noisy[:n]
        out_c[: min(len(clean), self.length_samples)] = clean[: self.length_samples]
        return out_n, out_c


class PrefetchLoader:
    """Threaded batcher: overlaps wav decode with device compute.

    Yields (noisy, clean) numpy arrays of shape (batch, length_samples).
    ``drop_last`` mirrors the reference's train loader config
    (cfg_train_DNS3.yaml:45-49).
    """

    def __init__(
        self,
        dataset: PairedWavDataset,
        batch_size: int,
        shuffle: bool = True,
        drop_last: bool = True,
        num_workers: int = 4,
        prefetch: int = 2,
        seed: int = 0,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.prefetch = prefetch
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(order)
        batches = [
            order[i : i + self.batch_size]
            for i in range(0, len(order), self.batch_size)
        ]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]

        # Two pools: batch-level tasks must not share workers with item-level
        # loads, else every worker can end up inside load_batch waiting on
        # item futures that have no worker left to run them (deadlock).
        with cf.ThreadPoolExecutor(
            max_workers=max(self.prefetch + 1, 1)
        ) as batch_pool, cf.ThreadPoolExecutor(
            max_workers=self.num_workers
        ) as item_pool:

            def load_batch(idxs):
                items = list(item_pool.map(self.dataset.load_item, idxs))
                noisy = np.stack([it[0] for it in items])
                clean = np.stack([it[1] for it in items])
                return noisy, clean

            # simple pipelined prefetch
            pending: list[cf.Future] = []
            it = iter(batches)
            sentinel = object()

            def submit_next():
                b = next(it, sentinel)
                if b is not sentinel:
                    pending.append(batch_pool.submit(load_batch, b))

            for _ in range(self.prefetch + 1):
                submit_next()
            while pending:
                fut = pending.pop(0)
                submit_next()
                yield fut.result()
