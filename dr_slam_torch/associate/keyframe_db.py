"""Discriminative place-recognition candidate selection.

Counterpart of the JAX package's `associate/keyframe_db.py` (the role of the
reference's KeyFrameDatabase, src/KeyFrameDatabase.cc:76-199
DetectLoopCandidates and :201-280 DetectRelocalizationCandidates). Raw BoW
scores against every keyframe are noisy, so three filters sit on top:

1. the shared-word gate: only keyframes sharing more than 0.8 x the most
   shared words with the query survive (KeyFrameDatabase.cc:116-135);
2. a minimum score (the loop path only, LoopClosing.cc:135);
3. covisibility-group accumulation: each survivor's score is summed with
   those of its (up to 10) best covisible neighbours that also survived,
   and only groups above 0.75 x the best accumulated score are kept, each
   represented by its best member (KeyFrameDatabase.cc:140-199).

With a flat W-word codebook the keyframes' tf vectors are one (NK, W)
tensor, so the shared-word counts are one matrix-vector product on the
device; the group accumulation runs on the host over the small survivor
set, in numpy, as in the reference package."""

from __future__ import annotations

import numpy as np
import torch


def common_word_counts(bow: torch.Tensor, kf_bows: torch.Tensor,
                       kf_valid: torch.Tensor) -> torch.Tensor:
    """Number of vocabulary words present in both the query and each
    keyframe: (W,) x (NK, W) -> (NK,) int32. Presence is a nonzero tf; the
    counts are integers below 2^24, exact in float32."""
    q = (bow > 0).to(torch.float32)
    k = (kf_bows > 0).to(torch.float32)
    return torch.where(kf_valid, k @ q, 0.0).to(torch.int32)


def group_candidates(scores: np.ndarray, common: np.ndarray,
                     covis: np.ndarray, allowed: np.ndarray,
                     min_score: float = 0.0,
                     group_size: int = 10,
                     acc_ratio: float = 0.75) -> list[int]:
    """Accumulated covisibility-group candidate selection.

    scores:  (NK,) L1 BoW scores of the query against each keyframe.
    common:  (NK,) shared-word counts (common_word_counts).
    covis:   (NK, NK) covisibility counts (shared map points).
    allowed: (NK,) bool -- valid, non-excluded keyframes.

    Returns candidate keyframe ids, best-of-group representatives only,
    sorted by descending accumulated group score. Empty when nothing
    clears the shared-word + min-score gates."""
    scores = np.asarray(scores, dtype=np.float64)
    common = np.asarray(common)
    allowed = np.asarray(allowed, dtype=bool)
    if not allowed.any():
        return []
    max_common = int(common[allowed].max())
    if max_common == 0:
        return []
    # KeyFrameDatabase.cc:133: minCommonWords = 0.8f * maxCommonWords
    eligible = allowed & (common > 0.8 * max_common) & (scores >= min_score)
    idx = np.where(eligible)[0]
    if len(idx) == 0:
        return []
    covis = np.asarray(covis)
    acc = np.empty(len(idx))
    best_of_group = np.empty(len(idx), dtype=np.int64)
    elig_set = np.zeros(len(scores), dtype=bool)
    elig_set[idx] = True
    for n, i in enumerate(idx):
        # up to `group_size` best covisible neighbors of i that are ALSO
        # eligible candidates (GetBestCovisibilityKeyFrames(10) intersected
        # with lKFsSharingWords, KeyFrameDatabase.cc:152-168)
        row = np.where(elig_set, covis[i], -1)
        row[i] = -1
        nbr = np.argsort(-row)[:group_size]
        nbr = nbr[row[nbr] > 0]
        members = np.concatenate([[i], nbr])
        acc[n] = scores[members].sum()
        best_of_group[n] = members[np.argmax(scores[members])]
    keep = acc >= acc_ratio * acc.max()
    # one representative per group; dedupe keeping the highest acc score
    order = np.argsort(-acc[keep])
    reps: list[int] = []
    for n in np.where(keep)[0][order]:
        r = int(best_of_group[n])
        if r not in reps:
            reps.append(r)
    return reps
