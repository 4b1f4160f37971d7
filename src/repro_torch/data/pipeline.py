"""Port of ``repro/data/pipeline.py`` (numpy and threads only; the draws are
the reference's bit for bit).

Data pipeline: deterministic, shardable token streams with host-side
prefetch (the H2D staging whose hoisting the paper optimizes).

Two sources:
  * :class:`SyntheticLMDataset` — seeded Zipf-ish token stream; infinite,
    reproducible, no files.  Used by smoke tests and the example drivers.
  * :class:`TokenFileDataset` — memory-mapped uint16/uint32 binary token
    file (the "real data" path), sequence-packed.

The :class:`Batcher` draws per-host shards deterministically from
(step, host_id) so restarts resume exactly (checkpointed `step` is the only
state), and keeps a one-batch prefetch buffer so host data prep overlaps the
device step — compute/transfer overlap at the pipeline level.
"""
from __future__ import annotations

import threading
import queue as _queue
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

__all__ = ["Batcher", "DataConfig", "SyntheticLMDataset", "TokenFileDataset",
           "make_dataset"]


@dataclass(frozen=True)
class DataConfig:
    seq_len: int = 512
    global_batch: int = 8
    vocab: int = 32_000
    seed: int = 1234
    pack_docs: bool = True
    path: Optional[str] = None    # set -> TokenFileDataset


class SyntheticLMDataset:
    """Deterministic synthetic LM stream: Zipf unigrams + short-range
    repetition structure (so loss curves actually bend)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        probs = 1.0 / ranks
        self.probs = probs / probs.sum()

    def batch(self, step: int, host_id: int = 0, n_hosts: int = 1) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, host_id]))
        b = cfg.global_batch // n_hosts
        toks = rng.choice(cfg.vocab, size=(b, cfg.seq_len + 1), p=self.probs)
        # inject copy structure: second half repeats the first with noise
        half = cfg.seq_len // 2
        noise = rng.random((b, half + 1)) < 0.1
        src = toks[:, :half + 1]
        toks[:, half:] = np.where(noise, toks[:, half:], src[:, : toks.shape[1] - half])
        toks = toks.astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class TokenFileDataset:
    """Memory-mapped binary token file -> packed (tokens, labels) batches."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        assert cfg.path, "TokenFileDataset needs cfg.path"
        raw = np.memmap(cfg.path, dtype=np.uint16, mode="r")
        self.tokens = raw
        self.n = len(raw)

    def batch(self, step: int, host_id: int = 0, n_hosts: int = 1) -> dict:
        cfg = self.cfg
        b = cfg.global_batch // n_hosts
        span = cfg.seq_len + 1
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, host_id]))
        starts = rng.integers(0, self.n - span, size=b)
        toks = np.stack([self.tokens[s:s + span] for s in starts]).astype(np.int32)
        toks = np.minimum(toks, cfg.vocab - 1)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def make_dataset(cfg: DataConfig):
    return TokenFileDataset(cfg) if cfg.path else SyntheticLMDataset(cfg)


class Batcher:
    """Prefetching iterator: host prep of batch t+1 overlaps device step t."""

    def __init__(self, dataset, start_step: int = 0, host_id: int = 0,
                 n_hosts: int = 1, prefetch: int = 2,
                 extras: Optional[dict] = None):
        self.dataset = dataset
        self.step = start_step
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.extras = extras or {}
        self._q: _queue.Queue = _queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        s = self.step
        while not self._stop.is_set():
            batch = self.dataset.batch(s, self.host_id, self.n_hosts)
            batch.update(self.extras)
            try:
                self._q.put((s, batch), timeout=0.5)
                s += 1
            except _queue.Full:
                continue

    def __iter__(self) -> Iterator[tuple[int, dict]]:
        return self

    def __next__(self) -> tuple[int, dict]:
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except _queue.Empty:
            pass
        self._thread.join(timeout=2.0)
