"""Deterministic synthetic LM data pipeline, a copy of
``src/repro/data/pipeline.py`` (numpy only, so the port keeps the same
code): every ``(seed, step, host_id)`` gives the reference's batch.

Production shape without external deps: a seeded, *stateless* token stream
(any (step, shard) pair maps to the same batch forever — restart-safe and
elastic-safe by construction), per-host sharding, sequence packing with EOS
boundaries, and a double-buffered prefetcher. The same interface would wrap
a real tokenized corpus; determinism-by-index is the property checkpoints
rely on (resume at step k ⇒ identical remaining stream, even on a different
host count).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0
    eos_id: int = 2
    # synthetic stream structure: zipf unigrams + short copy motifs so the
    # loss actually decreases (pure uniform noise has no learnable signal)
    zipf_a: float = 1.2
    motif_len: int = 16
    motif_prob: float = 0.5


class SyntheticLMDataset:
    """Stateless map-style dataset: batch(step) is a pure function."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        if cfg.global_batch % cfg.n_hosts:
            raise ValueError("global_batch must divide across hosts")
        self.host_batch = cfg.global_batch // cfg.n_hosts
        # fixed motif bank (shared across hosts; derived from seed only)
        rng = np.random.default_rng(cfg.seed)
        self._motifs = rng.integers(
            3, cfg.vocab, size=(256, cfg.motif_len)).astype(np.int32)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 4096 + cfg.host_id)
        b, s = self.host_batch, cfg.seq_len
        # zipf unigrams clipped to vocab
        toks = rng.zipf(cfg.zipf_a, size=(b, s)).astype(np.int64)
        toks = np.minimum(toks + 2, cfg.vocab - 1).astype(np.int32)
        # plant copyable motifs
        n_spots = max(1, s // (4 * cfg.motif_len))
        for i in range(b):
            if rng.random() < cfg.motif_prob:
                ids = rng.integers(0, len(self._motifs), size=n_spots)
                pos = rng.integers(0, max(1, s - cfg.motif_len), size=n_spots)
                for m, p in zip(ids, pos):
                    toks[i, p:p + cfg.motif_len] = self._motifs[m]
        # sequence packing boundaries
        doc_len = rng.integers(s // 4, s, size=b)
        for i in range(b):
            toks[i, :: max(1, int(doc_len[i]))] = cfg.eos_id
        return {"tokens": toks}


def make_host_loader(ds: SyntheticLMDataset, start_step: int = 0,
                     prefetch: int = 2) -> Iterator[Dict[str, np.ndarray]]:
    """Double-buffered background prefetcher over the stateless dataset."""
    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def worker():
        step = start_step
        while not stop.is_set():
            q.put(ds.batch(step))
            step += 1

    t = threading.Thread(target=worker, daemon=True)
    t.start()

    class _Iter:
        def __iter__(self):
            return self

        def __next__(self):
            return q.get()

        def close(self):
            stop.set()
            try:
                q.get_nowait()
            except queue.Empty:
                pass

    return _Iter()
