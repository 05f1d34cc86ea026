"""Deterministic synthetic LM data pipeline.

Port of ``repro/data/pipeline.py`` without jax: the batches are numpy arrays,
bit-identical to the reference's for the same ``(seed, index, host)``.

* **Stateless addressing** — batch ``i`` is a pure function of ``(seed, i)``,
  so restart-from-checkpoint resumes the stream exactly (no iterator state to
  persist) and elastic re-sharding is trivial: a host owns rows
  ``[host * rows_per_host, ...)`` of the global batch regardless of history.
* **Per-host sharding** — each host materialises only its slice.
* **Learnable signal** — tokens follow a seeded first-order Markov chain, so
  the e2e example's loss decreases measurably within a few hundred steps
  (pure-uniform tokens would hide optimizer bugs).
* **Double-buffered prefetch** — a background thread keeps ``prefetch``
  batches ready (overlapping host data work with device compute).
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np

from ..configs.base import ModelConfig, ShapeConfig


class SyntheticLMDataset:
    """Markov-chain token stream with stateless batch addressing."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig, seed: int = 0,
                 branching: int = 4):
        self.cfg = cfg
        self.shape = shape
        self.seed = seed
        rng = np.random.default_rng(seed)
        V = cfg.vocab_size
        # Sparse deterministic transition table: each token can be followed by
        # `branching` successors → H(next|cur) = log2(branching) bits.
        self.successors = rng.integers(0, V, size=(V, branching), dtype=np.int32)

    def batch(self, index: int, host: int = 0, num_hosts: int = 1) -> Dict[str, np.ndarray]:
        """Global batch ``index``, restricted to this host's row slice."""
        cfg, shp = self.cfg, self.shape
        B, T = shp.global_batch, shp.seq_len
        if B % num_hosts:
            raise ValueError(f"global batch {B} does not split over {num_hosts} hosts")
        rows = B // num_hosts
        rng = np.random.default_rng((self.seed, index, host))
        V = cfg.vocab_size
        stream = np.empty((rows, T + 1), np.int32)
        stream[:, 0] = rng.integers(0, V, size=rows)
        choices = rng.integers(0, self.successors.shape[1], size=(rows, T))
        for t in range(T):
            stream[:, t + 1] = self.successors[stream[:, t], choices[:, t]]
        batch: Dict[str, np.ndarray] = {}
        if cfg.frontend == "audio":
            batch["embeds"] = rng.standard_normal(
                (rows, T, cfg.d_model), dtype=np.float32
            ) * 0.02
            batch["labels"] = stream[:, :T]
        elif cfg.frontend == "vision":
            n_txt = T - cfg.frontend_tokens
            batch["embeds"] = rng.standard_normal(
                (rows, cfg.frontend_tokens, cfg.d_model), dtype=np.float32
            ) * 0.02
            batch["tokens"] = stream[:, :n_txt]
            batch["labels"] = stream[:, 1 : n_txt + 1]
        else:
            batch["tokens"] = stream[:, :T]
            batch["labels"] = stream[:, 1 : T + 1]
        return batch


def make_batch_iterator(
    dataset: SyntheticLMDataset,
    start_step: int = 0,
    host: int = 0,
    num_hosts: int = 1,
    prefetch: int = 2,
) -> Iterator[Dict[str, np.ndarray]]:
    """Background-thread prefetching iterator starting at ``start_step``;
    ``close()`` stops its thread."""
    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def producer():
        i = start_step
        while not stop.is_set():
            b = dataset.batch(i, host, num_hosts)
            while not stop.is_set():
                try:
                    q.put(b, timeout=0.1)
                    break
                except queue.Full:
                    continue
            i += 1

    t = threading.Thread(target=producer, daemon=True)
    t.start()

    class _Iter:
        def __iter__(self):
            return self

        def __next__(self):
            return q.get()

        def close(self):
            stop.set()
            t.join(timeout=5.0)

    return _Iter()
