"""Token data pipeline, the port's own copy of ``repro.data.pipeline``
(numpy only, so its batches equal the reference's bit for bit).

Design goals (1000-node posture):
* **Deterministic & elastic**: batch ``i`` is a pure function of (seed, i),
  independent of worker count — restarts and re-shards never replay or skip
  data differently.
* **Checkpointable**: iterator state is a single integer (next step index) +
  the config hash; stored inside the train checkpoint.
* **Sharded loading**: each host materializes only its ``(host_batch, seq)``
  slice; device placement happens in the launcher.
* **Prefetch**: a background thread keeps ``prefetch`` batches ready.

Storage: memory-mapped ``.bin`` token files (np.uint16/uint32) or a synthetic
deterministic stream (used by tests/examples; same interface).
"""
from __future__ import annotations

import dataclasses
import hashlib
import queue
import threading
from pathlib import Path
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int = 512
    global_batch: int = 8
    vocab_size: int = 32000
    seed: int = 0
    # host sharding
    host_index: int = 0
    host_count: int = 1
    prefetch: int = 2

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.host_count == 0
        return self.global_batch // self.host_count

    def fingerprint(self) -> str:
        payload = f"{self.seq_len}|{self.global_batch}|{self.vocab_size}|{self.seed}"
        return hashlib.sha256(payload.encode()).hexdigest()[:16]


class TokenDataset:
    """A flat token stream; examples are seq_len+1 windows chosen by a
    deterministic pseudo-random permutation of window starts."""

    def __init__(self, tokens: np.ndarray, cfg: DataConfig):
        assert tokens.ndim == 1
        self.tokens = tokens
        self.cfg = cfg
        self.n_windows = (len(tokens) - 1) // (cfg.seq_len + 1)
        if self.n_windows <= 0:
            raise ValueError("dataset smaller than one window")

    @classmethod
    def from_bin(cls, path: str | Path, cfg: DataConfig, dtype=np.uint16):
        arr = np.memmap(path, dtype=dtype, mode="r")
        return cls(arr, cfg)

    def _window(self, idx: int) -> np.ndarray:
        w = idx % self.n_windows
        s = w * (self.cfg.seq_len + 1)
        return np.asarray(self.tokens[s:s + self.cfg.seq_len + 1], np.int32)

    def batch_at(self, step: int) -> np.ndarray:
        """The *host-local* slice of global batch ``step`` — deterministic in
        (seed, step) regardless of host_count."""
        cfg = self.cfg
        rng = np.random.Generator(np.random.Philox(key=cfg.seed, counter=step))
        idxs = rng.integers(0, self.n_windows, size=cfg.global_batch)
        lo = cfg.host_index * cfg.host_batch
        sel = idxs[lo:lo + cfg.host_batch]
        return np.stack([self._window(int(i)) for i in sel])


def synthetic_dataset(cfg: DataConfig, n_tokens: int = 1 << 20) -> TokenDataset:
    """Deterministic synthetic corpus (zipfian-ish unigram)."""
    rng = np.random.Generator(np.random.Philox(key=cfg.seed ^ 0xDA7A))
    ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
    probs = 1.0 / ranks
    probs /= probs.sum()
    toks = rng.choice(cfg.vocab_size, size=n_tokens, p=probs).astype(np.int32)
    return TokenDataset(toks, cfg)


def make_batches(ds: TokenDataset, start_step: int = 0,
                 stop_step: Optional[int] = None) -> Iterator[tuple[int, np.ndarray]]:
    """Prefetching iterator yielding (step, host_batch_tokens).

    Resume by passing the checkpointed ``start_step``; the stream is
    identical to an uninterrupted run (fault-tolerance requirement).
    """
    cfg = ds.cfg
    q: queue.Queue = queue.Queue(maxsize=cfg.prefetch)
    stop = threading.Event()

    def worker():
        step = start_step
        while not stop.is_set() and (stop_step is None or step < stop_step):
            q.put((step, ds.batch_at(step)))
            step += 1
        q.put(None)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is None:
                return
            yield item
    finally:
        stop.set()
