"""Offline bag-of-words vocabulary trainer (port of
scavislam_tpu.apps.create_dictionary).

The equivalent of the reference's create_dictionary executable
(create_dictionary.cpp): scan an image directory, detect and describe
keypoints per image with a fixed budget (create_dictionary.cpp:78-128
retries SURF thresholds to land in [500, 2000] keypoints; the per-cell
top-k detector hits its budget in one pass), stack all descriptors, and
cluster them into N visual words with batched Lloyd's k-means on the card
(models.placerec.train_vocabulary: one matmul per chunk and iteration)
instead of FLANN hierarchical k-means. Saves a .npz with key ``vocab`` (the
reference serialized float words as a PNG byte image,
create_dictionary.cpp:166-177).

Usage: python -m scavislam_tpu_torch.apps.create_dictionary <img_dir> [N]
[words] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from scavislam_tpu_torch import resolve_device
from scavislam_tpu_torch.io.filegrabber import (
    load_image,
    scan_dataset,
    to_gray_f32,
)
from scavislam_tpu_torch.models.placerec import train_vocabulary
from scavislam_tpu_torch.ops.descriptors import compute_descriptors
from scavislam_tpu_torch.ops.fast import detect_corners_grid
from scavislam_tpu_torch.ops.image import sobel_xy


def descriptors_for_image(img_f32, budget=1024, device=None) -> np.ndarray:
    """(n, 128) descriptors of the valid keypoints of one [0, 1] gray image
    (numpy, or a tensor that stays on its device); one download."""
    img = (img_f32 if isinstance(img_f32, torch.Tensor)
           else torch.as_tensor(np.array(img_f32, np.float32),
                                device=resolve_device(device)))
    uv, _score, valid = detect_corners_grid(
        img, threshold=6.0 / 255.0, cells_y=8, cells_x=8,
        per_cell=max(budget // 64, 1))
    dx, dy = sobel_xy(img)
    desc, ok = compute_descriptors(dx, dy, uv)
    return desc[valid & ok].cpu().numpy()


def synthetic_corpus_descriptors(verbose=True, n_scenes=8,
                                 frames_per_scene=16, recipe="v2",
                                 device=None):
    """The canonical training corpus behind the shipped vocabulary
    (scavislam_tpu/data/vocabulary.npz), rendered by the port's renderer on
    `device`.

    recipe="v1": ``n_scenes`` varied_box scenes (seeds 1..n_scenes) under
    mixed spin/orbit/forward trajectories, New College geometry (512x384,
    f=389.96).

    recipe="v2" (the shipped artifact): v1's scenes plus a spin-heavy
    closed-geometry block: varied_box spins at a full 360 degrees (seeds
    n_scenes+1..n_scenes+4) and cluttered_room scenes (seeds 101..102)
    under spin/orbit, because v1 under-covered enclosed-scene spin
    viewpoints.

    recipe="v3": v2's blocks widened for a 10k-word vocabulary (twice the
    spin and cluttered blocks, plus wander paths)."""
    from scavislam_tpu_torch.core.camera import StereoCamera
    from scavislam_tpu_torch.io.synthetic import (
        SyntheticSequence,
        cluttered_room,
        varied_box,
    )

    dev = resolve_device(device)
    cam = StereoCamera.create(389.96, (254.9, 201.9), (512, 384), 0.12)
    descs = []

    def add_scene(planes, kind, n, tag):
        step = 1.0 / (n - 1) if kind == "spin" else 0.04
        seq = SyntheticSequence(cam, n_frames=n, kind=kind, planes=planes,
                                step=step, device=dev)
        for fr in seq:
            descs.append(descriptors_for_image(fr["left"]))
        if verbose:
            print(f"scene {tag} kind={kind}: "
                  f"{sum(len(x) for x in descs)} descriptors total")

    kinds = ["spin", "orbit", "forward_arc", "out_and_back"]
    for seed in range(1, n_scenes + 1):
        add_scene(varied_box(seed), kinds[(seed - 1) % len(kinds)],
                  frames_per_scene, f"varied_box({seed})")
    if recipe == "v2":
        for seed in range(n_scenes + 1, n_scenes + 5):
            add_scene(varied_box(seed), "spin", frames_per_scene,
                      f"varied_box({seed})/spin")
        for i, seed in enumerate((101, 102)):
            add_scene(cluttered_room(seed), ["spin", "orbit"][i % 2],
                      frames_per_scene, f"cluttered_room({seed})")
    if recipe == "v3":
        for seed in range(n_scenes + 1, n_scenes + 9):
            add_scene(varied_box(seed), "spin", frames_per_scene,
                      f"varied_box({seed})/spin")
        for i, seed in enumerate((101, 102, 103, 104)):
            add_scene(cluttered_room(seed),
                      ["spin", "orbit", "wander", "out_and_back"][i % 4],
                      frames_per_scene, f"cluttered_room({seed})")
        for seed in range(201, 207):
            add_scene(varied_box(seed), "wander", frames_per_scene,
                      f"varied_box({seed})/wander")
    return np.concatenate(descs)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("img_dir", nargs="?",
                    help="image directory (omit with --synthetic)")
    ap.add_argument("max_images", nargs="?", type=int, default=100)
    ap.add_argument("num_words", nargs="?", type=int, default=1024)
    ap.add_argument("--pattern", default=r".*\.(png|pnm|pgm|jpg)$")
    ap.add_argument("--out", default="dictionary.npz")
    ap.add_argument("--synthetic", action="store_true",
                    help="train on the canonical synthetic corpus (the "
                         "recipe that produced the shipped vocabulary.npz)")
    ap.add_argument("--corpus-scenes", type=int, default=8,
                    help="with --synthetic: number of varied_box scenes "
                         "(default 8 = the shipped-artifact recipe)")
    ap.add_argument("--corpus-frames", type=int, default=16,
                    help="with --synthetic: frames per scene (default 16)")
    ap.add_argument("--recipe", default="v2", choices=("v1", "v2", "v3"),
                    help="with --synthetic: corpus recipe (v2 = shipped "
                         "4096-word artifact; v3 = reference-scale corpus "
                         "for 10k-word vocabularies)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "without one)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    if args.synthetic:
        if args.corpus_scenes < 1 or args.corpus_frames < 2:
            raise SystemExit("--corpus-scenes must be >= 1 and "
                             "--corpus-frames >= 2 (spin step = 1/(n-1))")
        desc = synthetic_corpus_descriptors(
            n_scenes=args.corpus_scenes,
            frames_per_scene=args.corpus_frames, recipe=args.recipe,
            device=device)
        args.num_words = max(args.num_words, 4096)
    else:
        if not args.img_dir:
            raise SystemExit("img_dir required unless --synthetic")
        files = scan_dataset(args.img_dir, args.pattern)[: args.max_images]
        if not files:
            raise SystemExit(
                f"no images matching {args.pattern} in {args.img_dir}")
        all_desc = []
        for f in files:
            d = descriptors_for_image(to_gray_f32(load_image(f)),
                                      device=device)
            all_desc.append(d)
            print(f"{f}: {len(d)} descriptors")
        desc = np.concatenate(all_desc)
    print(f"clustering {len(desc)} descriptors into {args.num_words} words...")
    vocab = train_vocabulary(desc, k=args.num_words, iters=25, device=device)
    np.savez_compressed(args.out, vocab=vocab)
    print(f"saved {args.out}")


if __name__ == "__main__":
    main()
