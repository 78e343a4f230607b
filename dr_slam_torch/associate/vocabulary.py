"""Bag-of-words vocabulary: descriptor -> word assignment as one matmul, and
BoW scoring against every keyframe.

Counterpart of the JAX package's `associate/vocabulary.py` (the role of
DBoW2's ORBVocabulary and the KeyFrameDatabase's scoring): a flat binary
codebook of W words; a descriptor's word is the codeword at least Hamming
distance (+/-1 dot product argmax, first index on ties). The products are
integers bounded by 256, so float32 gives them exactly, as the reference's
bf16 codebook with f32 accumulation does. `bow_scores` is DBoW2's L1 score,
1 - 0.5 |v1 - v2|_1, against all keyframes at once.

The codebook for W words is the one registered with `set_vocabulary` (or
`load_vocabulary`) for W, else the seeded random codebook, as in the
reference. The `System` registers the shipped trained codebook at
construction (`data/vocab{W}.npz` or `data/vocab.npz`); a bare tracker uses
whatever is registered. `train_vocabulary` is the reference's binary
k-means, in numpy, bit for bit."""

from __future__ import annotations

import functools

import numpy as np
import torch

from dr_slam_torch.ops.orb import bits_to_signs, unpack_bits

def _random_codebook_signs(n_words: int, seed: int = 3) -> np.ndarray:
    rng = np.random.RandomState(seed)
    bits = rng.rand(n_words, 256) > 0.5
    return bits.astype(np.float32) * 2.0 - 1.0


def words_to_signs(packed_words: np.ndarray) -> np.ndarray:
    """(W, 8) uint32 packed 256-bit words -> (W, 256) float32 +/-1."""
    bits = np.unpackbits(
        packed_words.astype("<u4").view(np.uint8), bitorder="little"
    ).reshape(packed_words.shape[0], 256)
    return bits.astype(np.float32) * 2.0 - 1.0


# Registered trained codebooks by word count (set_vocabulary).
_trained_signs: dict = {}


def set_vocabulary(packed_words: np.ndarray) -> None:
    """Register a trained codebook: (W, 8) uint32 packed 256-bit words. It
    replaces whatever codebook W words had, cached copies included."""
    _trained_signs[packed_words.shape[0]] = words_to_signs(packed_words)
    get_codebook_signs.cache_clear()
    _codebook.cache_clear()


def load_vocabulary(path: str) -> None:
    """Load and register a codebook saved as an .npz with a "words" array."""
    with np.load(path) as data:
        set_vocabulary(data["words"])


@functools.lru_cache(maxsize=4)
def get_codebook_signs(n_words: int) -> np.ndarray:
    """(W, 256) +/-1 codebook for W words: the registered one, else the
    seeded random one."""
    if n_words in _trained_signs:
        return _trained_signs[n_words]
    return _random_codebook_signs(n_words)


def train_vocabulary(desc: np.ndarray, n_words: int = 4096,
                     n_iters: int = 8, seed: int = 5) -> np.ndarray:
    """Binary k-means over packed ORB descriptors -> (W, 8) uint32 words
    (the role of DBoW2's offline training): centres are per-bit majority
    votes, assignment is the Hamming argmin as a +/-1 matmul, an empty
    cluster reseeds on the descriptor farthest from its centre. Host numpy,
    the reference's expressions in its order, so the words are bit-equal."""
    desc = np.asarray(desc)
    bits = np.unpackbits(desc.astype("<u4").view(np.uint8),
                         bitorder="little").reshape(desc.shape[0], 256)
    signs = bits.astype(np.float32) * 2.0 - 1.0
    rng = np.random.RandomState(seed)
    n = signs.shape[0]
    centers = signs[rng.choice(n, size=min(n_words, n), replace=False)]
    if centers.shape[0] < n_words:   # fewer descriptors than words
        centers = np.concatenate(
            [centers, _random_codebook_signs(n_words)[centers.shape[0]:]], 0)
    for _ in range(n_iters):
        dot = signs @ centers.T                       # (N, W)
        assign = np.argmax(dot, -1)
        dist = 0.5 * (256.0 - dot[np.arange(n), assign])
        for w in range(n_words):
            m = assign == w
            if m.any():
                centers[w] = np.where(signs[m].mean(0) >= 0.0, 1.0, -1.0)
            else:
                centers[w] = signs[np.argmax(dist)]
                dist[np.argmax(dist)] = -1.0
    words_bits = (centers > 0).astype(np.uint8)
    packed = np.packbits(words_bits, axis=-1, bitorder="little")
    return packed.view("<u4").astype(np.uint32)


@functools.lru_cache(maxsize=8)
def _codebook(n_words: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(get_codebook_signs(n_words)).to(device)


def word_ids(desc: torch.Tensor, n_words: int = 4096) -> torch.Tensor:
    """(K, 8) packed descriptors -> (K,) int32 vocabulary word ids."""
    signs = bits_to_signs(unpack_bits(desc))
    dot = signs @ _codebook(n_words, desc.device).T
    return torch.argmax(dot, -1).to(torch.int32)


def compute_bow(desc: torch.Tensor, valid: torch.Tensor,
                n_words: int = 4096) -> torch.Tensor:
    """(K, 8) packed descriptors, (K,) validity -> (W,) L1-normalised term
    frequencies over the valid descriptors' words."""
    word = word_ids(desc, n_words).to(torch.int64)
    hist = torch.zeros(n_words, dtype=torch.float32, device=desc.device)
    hist.index_add_(0, word, valid.to(torch.float32))
    return hist / torch.clamp(torch.sum(hist), min=1e-6)


def bow_scores(bow: torch.Tensor, kf_bows: torch.Tensor,
               kf_valid: torch.Tensor) -> torch.Tensor:
    """DBoW2 L1 score of `bow` (W,) against all keyframes (NK, W) -> (NK,),
    -1 for dead slots."""
    s = 1.0 - 0.5 * torch.sum(torch.abs(bow[None] - kf_bows), -1)
    return torch.where(kf_valid, s, -1.0)
