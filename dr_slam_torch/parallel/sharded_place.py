"""Sharded place recognition: BoW scoring over keyframe rows split across
the devices of a mesh.

Counterpart of the JAX package's `parallel/sharded_place.py` (the role of
the reference's serial DBoW2 inverted-file scan,
KeyFrameDatabase::DetectLoopCandidates, src/KeyFrameDatabase.cc:76-199).
The (NK, W) keyframe tf matrix, the largest per-keyframe table, is split
into row blocks, one per mesh device; each device scores its block against
the query, and the per-keyframe results are gathered on the first device.
Each block is scored by `vocabulary.bow_scores` and
`keyframe_db.common_word_counts` themselves, whose reductions run row by
row, so the result equals the single-device scan exactly."""

from __future__ import annotations

import torch

from dr_slam_torch.associate.keyframe_db import common_word_counts
from dr_slam_torch.associate.vocabulary import bow_scores
from dr_slam_torch.parallel.sharded_ba import Mesh, _row_slices


def _scores_and_common(bow, kf_bows, kf_valid):
    """(W,), (NK, W), (NK,) -> L1 scores (NK,) f32, common words (NK,) i32:
    the single-device scan's own functions, on one block of rows."""
    return (bow_scores(bow, kf_bows, kf_valid),
            common_word_counts(bow, kf_bows, kf_valid))


def shard_keyframe_bows(kf_bows, kf_valid, mesh: Mesh, axis: str = "kf"):
    """The (NK, W) tf matrix and (NK,) validity as contiguous row blocks,
    one on each mesh device. -> (list of (bows, valid) blocks, NK); pass it
    to sharded_place_scores. Do this once per map update: the blocks then
    stay resident on their devices."""
    NK = kf_bows.shape[0]
    blocks = [(kf_bows[r].to(dev), kf_valid[r].to(dev))
              for dev, r in zip(mesh.devices,
                                _row_slices(NK, mesh.shape[axis]))]
    return blocks, NK


def sharded_place_scores(bow, sharded, mesh: Mesh):
    """Score one query tf vector (W,) against every keyframe block ->
    (scores (NK,), common (NK,)) on mesh.devices[0], as the single-device
    scan computes them, for keyframe_db.group_candidates."""
    blocks, NK = sharded
    bow = torch.as_tensor(bow, dtype=torch.float32)
    home = mesh.devices[0]
    parts = [_scores_and_common(bow.to(b.device), b, v) for b, v in blocks]
    scores = torch.cat([s.to(home) for s, _ in parts])
    common = torch.cat([c.to(home) for _, c in parts])
    return scores[:NK], common[:NK]
