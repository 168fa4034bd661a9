"""Train the packaged ORB vocabulary from synthetic imagery (counterpart of
``scripts/train_vocab.py``).

The reference ships a pretrained ``Vocabulary/ORBvoc.txt`` and loads it at
startup (``src/System.cc:86-96``). This one is trained on the synthetic
texture family the benchmarks exercise: random-rectangle textures and
thresholded speckle, 40 images drawn from ``default_rng(7)``. The port's
``extract_orb`` (500 features, 4 levels) runs on the card, or on the CPU
with ``--cpu``; :func:`~gsorb_slam_tpu_torch.frontend.vocab.build_vocabulary`
(k 9, L 3, seed 0, 6 iterations) trains on the host. Writes the DBoW2 text
format and loads it back.

Usage:
    python -m gsorb_slam_tpu_torch.scripts.train_vocab [--out PATH] [--cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

DEFAULT_OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "assets", "ORBvoc_synth.txt")
N_IMAGES = 40


def textured(rng, h=240, w=320, n=160):
    img = np.zeros((h, w), np.float32)
    for _ in range(n):
        y, x = rng.integers(5, h - 25), rng.integers(5, w - 25)
        img[y : y + rng.integers(4, 16), x : x + rng.integers(4, 16)] = rng.uniform(0.25, 1.0)
    return img


def speckle(rng, h=240, w=320):
    from scipy.ndimage import gaussian_filter

    img = rng.uniform(0, 1, (h, w)).astype(np.float32)
    img = gaussian_filter(img, rng.uniform(1.0, 2.5))
    img = (img - img.min()) / (np.ptp(img) + 1e-9)
    return (img > rng.uniform(0.4, 0.6)).astype(np.float32) * rng.uniform(0.5, 1.0)


def training_images(n: int = N_IMAGES, seed: int = 7) -> list[np.ndarray]:
    """The first ``n`` training images: even ones textured, odd ones speckle."""
    rng = np.random.default_rng(seed)
    return [textured(rng) if i % 2 == 0 else speckle(rng) for i in range(n)]


def train(images, device="cuda", k: int = 9, L: int = 3, seed: int = 0, iters: int = 6,
          verbose: bool = True):
    """ORB descriptors of ``images`` on ``device`` (``uint32 [N, 8]``) and
    the vocabulary trained on them."""
    import torch

    from gsorb_slam_tpu_torch import _build
    from gsorb_slam_tpu_torch.core.config import ORBConfig
    from gsorb_slam_tpu_torch.frontend.orb import descriptors_to_numpy, extract_orb
    from gsorb_slam_tpu_torch.frontend.vocab import build_vocabulary

    device = torch.device(device)
    if device.type == "cuda":
        _build.pin_full_f32()  # a TF32 keypoint angle moves BRIEF's steered offsets
    cfg = ORBConfig(n_features=500, n_levels=4)
    descs = []
    for i, img in enumerate(images):
        f = extract_orb(torch.as_tensor(img, device=device), cfg)
        v = f.valid.cpu().numpy()
        descs.append(descriptors_to_numpy(f.descriptors)[v])
        if verbose:
            print(f"image {i}: {v.sum()} descriptors", flush=True)
    D = np.concatenate(descs)
    if verbose:
        print(f"training on {len(D)} descriptors", flush=True)
    return D, build_vocabulary(D, k=k, L=L, seed=seed, iters=iters)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--cpu", action="store_true", help="extract on the CPU (plain versions)")
    args = ap.parse_args(argv)

    from gsorb_slam_tpu_torch.frontend.vocab import load_orbvoc_text, save_orbvoc_text

    _D, voc = train(training_images(N_IMAGES), "cpu" if args.cpu else "cuda")
    print(f"vocabulary: {voc.n_words} words", flush=True)
    save_orbvoc_text(voc, args.out)
    voc2 = load_orbvoc_text(args.out)  # round trip
    if voc2.n_words != voc.n_words:
        raise RuntimeError(f"{args.out} loads {voc2.n_words} words, not {voc.n_words}")
    print(f"wrote {args.out} ({os.path.getsize(args.out)} bytes)", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
