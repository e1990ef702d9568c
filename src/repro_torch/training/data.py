"""Deterministic, resumable data pipeline (a copy of the reference's
``repro.training.data`` on the port's configs: batches are numpy, and the
caller moves them to the model's device).

Sources: synthetic token streams (seeded, shape-exact) or a memory-mapped
token file.  The iterator state is a single integer ``step`` — restoring
a checkpoint restores the exact batch sequence (required for elastic
restart: a resumed run consumes identical data regardless of mesh shape,
since sharding happens after host-level batch assembly).
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Iterator

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeCfg


@dataclasses.dataclass
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    path: str | None = None     # token .bin (uint32) for file-backed mode


class TokenDataset:
    """step -> {tokens, labels} batches; O(1) state = the step index."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self._mm = None
        if cfg.path and os.path.exists(cfg.path):
            self._mm = np.memmap(cfg.path, dtype=np.uint32, mode="r")

    def batch_at(self, step: int) -> dict:
        c = self.cfg
        if self._mm is not None:
            need = c.global_batch * (c.seq_len + 1)
            total = len(self._mm) - need
            rng = np.random.default_rng(c.seed + step)
            start = int(rng.integers(0, max(total, 1)))
            flat = np.asarray(self._mm[start : start + need], np.int32)
            arr = flat.reshape(c.global_batch, c.seq_len + 1) % c.vocab
        else:
            rng = np.random.default_rng(c.seed + step)
            arr = rng.integers(
                0, c.vocab, (c.global_batch, c.seq_len + 1), dtype=np.int32)
        return {"tokens": arr[:, :-1], "labels": arr[:, 1:]}

    def iterate(self, start_step: int = 0) -> Iterator[dict]:
        step = start_step
        while True:
            yield self.batch_at(step)
            step += 1


def make_batch(cfg: ModelConfig, shape: ShapeCfg, seed: int = 0) -> dict:
    """One concrete host batch matching ``input_specs`` (for smoke runs)."""
    ds = TokenDataset(DataConfig(cfg.vocab, shape.seq_len, shape.global_batch,
                                 seed))
    batch = ds.batch_at(0)
    rng = np.random.default_rng(seed + 1)
    if cfg.family == "vlm" and cfg.frontend_tokens:
        batch["frontend"] = rng.normal(
            0, 1, (shape.global_batch, cfg.frontend_tokens, cfg.d_model)
        ).astype(np.float32)
    if cfg.family in ("encdec", "audio"):
        batch["src_embeds"] = rng.normal(
            0, 1, (shape.global_batch, cfg.enc_seq_len or 128, cfg.d_model)
        ).astype(np.float32)
    return batch


def write_token_file(path: str, n_tokens: int, vocab: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    arr = rng.integers(0, vocab, n_tokens, dtype=np.uint32)
    arr.tofile(path)
    with open(path + ".json", "w") as f:
        json.dump({"n_tokens": n_tokens, "vocab": vocab}, f)
