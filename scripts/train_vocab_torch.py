#!/usr/bin/env python
"""Train a BoW vocabulary (binary k-means over ORB descriptors) with the
PyTorch port's front-end; the twin of scripts/train_vocab.py (the role of
DBoW2's offline vocabulary build; the reference loads a pre-trained
ORBvoc.txt, System.cc:51).

    python scripts/train_vocab_torch.py [--tum SEQUENCE_DIR] [--device cuda]
        [--words 4096] [--frames 40] [--iters 8] [--out output/vocab.npz]

Descriptors come from the first --frames frames of a TUM sequence directory
or, without --tum, from every second frame of five synthetic scene
families rendered on --device (scripts/train_vocab.py's: the corridor and
the loop in the default room, the loop among office clutter, a small room
with clutter and Kinect-like depth noise, and a hall with clutter). The
result is an .npz with a "words" array that
`dr_slam_torch.associate.vocabulary.load_vocabulary` (or the JAX package's)
registers."""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def synthetic_worlds(n_frames: int, K4, device) -> list:
    """scripts/train_vocab.py's five scene families as SyntheticSequences:
    the two the acceptance constants were first tuned on, the cluttered
    office, and two other worlds (other room geometry, so another texture
    layout, and Kinect-like depth noise), so the codebook is not fitted to
    one wall pattern."""
    from dr_slam_torch.io import synthetic

    room_small = synthetic.BoxRoom(xmax=2.6, ymax=2.2, zmax=3.4)
    room_hall = synthetic.BoxRoom(xmax=7.0, ymax=3.5, zmax=10.0)
    worlds = [
        # (poses, room, clutter boxes, quadratic depth noise)
        (synthetic.corridor_trajectory(n_frames), None, None, False),
        (synthetic.loop_trajectory(n_frames), None, None, False),
        (synthetic.loop_trajectory(n_frames), None,
         synthetic.office_clutter(n_boxes=6, seed=3), False),
        (synthetic.corridor_trajectory(n_frames, room=room_small,
                                       step=0.012), room_small,
         synthetic.office_clutter(room_small, n_boxes=4, seed=11), True),
        (synthetic.loop_trajectory(n_frames, room=room_hall), room_hall,
         synthetic.office_clutter(room_hall, n_boxes=8, seed=7), False),
    ]
    return [synthetic.SyntheticSequence(
        poses, K4=K4, boxes=boxes, depth_noise=qnoise,
        quadratic_noise=qnoise, device=device,
        **({} if room is None else {"room": room}))
        for poses, room, boxes, qnoise in worlds]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--words", type=int, default=4096)
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--tum", default=None, help="TUM sequence dir (optional)")
    ap.add_argument("--out", default="output/vocab.npz")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    from dr_slam_torch import resolve_device
    from dr_slam_torch.associate.vocabulary import train_vocabulary
    from dr_slam_torch.config import tum_freiburg3
    from dr_slam_torch.frontend.frame import extract_frame

    dev = resolve_device(args.device)
    cfg = tum_freiburg3()
    descs = []

    def harvest(gray, depth):
        f = extract_frame(gray, depth, cfg, dev)
        descs.append(f.kp.desc[f.kp.valid].cpu().numpy())

    if args.tum:
        from dr_slam_torch.io.tum import TUMDataset
        ds = TUMDataset(args.tum, depth_factor=cfg.camera.depth_factor)
        for i in range(min(len(ds), args.frames)):
            fr = ds[i]
            harvest(fr.gray, fr.depth)
    else:
        for seq in synthetic_worlds(args.frames, cfg.camera.K4, dev):
            for i in range(0, len(seq), 2):
                harvest(*seq.render(i))
    D = np.concatenate(descs, 0)
    print(f"training on {len(D)} descriptors -> {args.words} words")
    words = train_vocabulary(D, n_words=args.words, n_iters=args.iters)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    np.savez_compressed(args.out, words=words)
    print(f"saved {args.out}")
    return words


if __name__ == "__main__":
    main()
