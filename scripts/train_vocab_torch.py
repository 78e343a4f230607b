#!/usr/bin/env python
"""Train a BoW vocabulary (binary k-means over ORB descriptors) with the
PyTorch port's front-end; the twin of scripts/train_vocab.py (the role of
DBoW2's offline vocabulary build; the reference loads a pre-trained
ORBvoc.txt, System.cc:51).

    python scripts/train_vocab_torch.py --tum SEQUENCE_DIR [--device cuda]
        [--words 4096] [--frames 40] [--iters 8] [--out output/vocab.npz]

Descriptors come from the first --frames frames of a TUM sequence directory,
extracted on --device. The result is an .npz with a "words" array that
`dr_slam_torch.associate.vocabulary.load_vocabulary` (or the JAX package's)
registers. The synthetic scene families of scripts/train_vocab.py need the
synthetic renderer, which the port does not have yet."""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--words", type=int, default=4096)
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--tum", required=True, help="TUM sequence dir")
    ap.add_argument("--out", default="output/vocab.npz")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    from dr_slam_torch import resolve_device
    from dr_slam_torch.associate.vocabulary import train_vocabulary
    from dr_slam_torch.config import tum_freiburg3
    from dr_slam_torch.frontend.frame import extract_frame
    from dr_slam_torch.io.tum import TUMDataset

    dev = resolve_device(args.device)
    cfg = tum_freiburg3()
    ds = TUMDataset(args.tum, depth_factor=cfg.camera.depth_factor)
    descs = []
    for i in range(min(len(ds), args.frames)):
        fr = ds[i]
        f = extract_frame(fr.gray, fr.depth, cfg, dev)
        descs.append(f.kp.desc[f.kp.valid].cpu().numpy())
    D = np.concatenate(descs, 0)
    print(f"training on {len(D)} descriptors -> {args.words} words")
    words = train_vocabulary(D, n_words=args.words, n_iters=args.iters)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    np.savez_compressed(args.out, words=words)
    print(f"saved {args.out}")
    return words


if __name__ == "__main__":
    main()
