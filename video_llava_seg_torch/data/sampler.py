"""Length-grouped / modality-grouped sampling (port of
`video_llava_seg_tpu/data/sampler.py`, pinned to it by
`tests/test_torch_data.py`; the reference's llava_trainer.py:81-173 with
`np.random.RandomState` draws in the same order).

Groups sample indices into world_size * batch_size megabatches sorted by
length, splits each megabatch into per-replica chunks of about equal
total length, and, in modality mode, keeps multimodal (length > 0) and
language-only (length < 0) samples in separate megabatches."""

from __future__ import annotations

from typing import List, Optional

import numpy as np


def split_to_even_chunks(indices: List[int], lengths, num_chunks: int):
    """Greedy equal-total-length split (llava_trainer.py:81-100)."""
    if len(indices) % num_chunks != 0:
        return [indices[i::num_chunks] for i in range(num_chunks)]
    per_chunk = len(indices) // num_chunks
    chunks = [[] for _ in range(num_chunks)]
    chunk_lengths = [0.0] * num_chunks
    for index in indices:
        shortest = chunk_lengths.index(min(chunk_lengths))
        chunks[shortest].append(index)
        chunk_lengths[shortest] += lengths[index]
        if len(chunks[shortest]) == per_chunk:
            chunk_lengths[shortest] = float("inf")
    return chunks


def get_length_grouped_indices(lengths, batch_size: int, world_size: int,
                               rng: Optional[np.random.RandomState] = None):
    """llava_trainer.py:132-140 parity."""
    rng = rng or np.random.RandomState()
    indices = rng.permutation(len(lengths)).tolist()
    mb = world_size * batch_size
    megabatches = [indices[i:i + mb] for i in range(0, len(lengths), mb)]
    megabatches = [sorted(m, key=lambda i: lengths[i], reverse=True)
                   for m in megabatches]
    megabatches = [split_to_even_chunks(m, lengths, world_size)
                   for m in megabatches]
    return [i for m in megabatches for chunk in m for i in chunk]


def get_modality_length_grouped_indices(
        lengths, batch_size: int, world_size: int,
        rng: Optional[np.random.RandomState] = None):
    """llava_trainer.py:103-129 parity. lengths: >0 multimodal, <0
    language-only."""
    rng = rng or np.random.RandomState()
    assert all(l != 0 for l in lengths), "Should not have zero length."
    if all(l > 0 for l in lengths) or all(l < 0 for l in lengths):
        return get_length_grouped_indices(lengths, batch_size, world_size,
                                          rng)
    mm = [(i, l) for i, l in enumerate(lengths) if l > 0]
    lang = [(i, -l) for i, l in enumerate(lengths) if l < 0]
    mm_indices, mm_lengths = zip(*mm)
    lang_indices, lang_lengths = zip(*lang)
    mm_shuffle = [mm_indices[i] for i in get_length_grouped_indices(
        mm_lengths, batch_size, world_size, rng)]
    lang_shuffle = [lang_indices[i] for i in get_length_grouped_indices(
        lang_lengths, batch_size, world_size, rng)]
    mb = world_size * batch_size
    mm_mb = [mm_shuffle[i:i + mb] for i in range(0, len(mm_shuffle), mb)]
    lang_mb = [lang_shuffle[i:i + mb]
               for i in range(0, len(lang_shuffle), mb)]
    additional = mm_mb[-1] + lang_mb[-1]
    megabatches = mm_mb[:-1] + lang_mb[:-1]
    order = rng.permutation(len(megabatches))
    megabatches = [megabatches[i] for i in order]
    if additional:
        megabatches.append(sorted(additional))
    return [i for m in megabatches for i in m]


class LengthGroupedSampler:
    """Iterable over grouped indices (llava_trainer.py:143-173 parity)."""

    def __init__(self, batch_size: int, world_size: int,
                 lengths: Optional[List[int]] = None, seed: int = 0,
                 group_by_modality: bool = False):
        if lengths is None:
            raise ValueError("Lengths must be provided.")
        self.batch_size = batch_size
        self.world_size = world_size
        self.lengths = lengths
        self.rng = np.random.RandomState(seed)
        self.group_by_modality = group_by_modality

    def __len__(self):
        return len(self.lengths)

    def __iter__(self):
        if self.group_by_modality:
            return iter(get_modality_length_grouped_indices(
                self.lengths, self.batch_size, self.world_size, self.rng))
        return iter(get_length_grouped_indices(
            self.lengths, self.batch_size, self.world_size, self.rng))
