"""Offline place-recognition vocabulary training.

The reference loads a pre-trained 1M-word ORBvoc binary at startup
(/root/reference/src/System.cc:186-191, k=10 L=6). This tool trains the
shipped equivalent for this engine: hierarchical k-medians over ORB
descriptors extracted from many rendered synthetic scenes (no real datasets
exist in this environment — see SURVEY.md §A.5), default k=10 L=5 (~10^5
words, the scale step toward the reference ORBvoc k=10 L=6), persisted
to ygz_tpu/data/orb_vocab.npz (packed bits, ~3 MB).

Usage:
    JAX_PLATFORMS=cpu python tools/train_vocab.py \
        [--out ygz_tpu/data/orb_vocab.npz] [--branching 10] [--depth 4] \
        [--scenes 12] [--views 8]
"""
import argparse
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"   # hard pin: vocabulary training is
#                                        matmul-chunked numpy/CPU-jax work
#                                        that needs no accelerator
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import numpy as np  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(
        ROOT, "ygz_tpu", "data", "orb_vocab.npz"))
    ap.add_argument("--branching", type=int, default=10)
    ap.add_argument("--depth", type=int, default=5)
    ap.add_argument("--scenes", type=int, default=48)
    ap.add_argument("--views", type=int, default=12)
    ap.add_argument("--desc-cache", default="/tmp/ygz_vocab_corpus.npz",
                    help="descriptor-corpus cache (collection is ~30 min; "
                         "training retries reuse it)")
    args = ap.parse_args()

    import jax
    # persistent compile cache: scene-texture/render/extractor programs are
    # shared with the test suite; a cold XLA:CPU compile of the texture
    # blur alone measures ~200 s on this host
    from ygz_tpu.utils.compile_cache import enable
    enable()
    from synthetic import PlaneScene, SmoothScene, StepScene
    from ygz_tpu.frontend.extractor import OrbExtractor
    from ygz_tpu.ops.image import build_pyramid
    from ygz_tpu.geometry import lie
    import jax.numpy as jnp
    from ygz_tpu.backend.bow import train_vocabulary, save_vocabulary

    extractor = OrbExtractor(n_features=1024, n_levels=4, scale_factor=2.0,
                             fast_th=20.0, fast_th_min=7.0, mode="grid")

    cache_key = (args.scenes, args.views)
    if args.desc_cache and os.path.exists(args.desc_cache):
        z = np.load(args.desc_cache)
        if tuple(z["key"]) == cache_key:
            print(f"descriptor corpus from cache: {len(z['desc'])}",
                  flush=True)
            desc = np.unpackbits(z["desc"], axis=1)
            _train(args, desc, z["doc_ids"])
            return

    descs, docs = [], []
    doc = 0
    kinds = [SmoothScene, StepScene, PlaneScene]
    for s in range(args.scenes):
        scene = kinds[s % len(kinds)](seed=100 + s, tex_size=1600)
        rng = np.random.default_rng(s)
        for v in range(args.views):
            w = rng.normal(0, 0.05, 3).astype(np.float32)
            R = np.asarray(lie.so3_exp(jnp.asarray(w)))
            c = np.array([rng.uniform(-1, 1), rng.uniform(-0.7, 0.7),
                          rng.uniform(-0.5, 0.5)], np.float32)
            t = (-R @ c).astype(np.float32)
            img = scene.render(R, t)
            pyr = build_pyramid(jnp.asarray(img, jnp.float32), 4, 2.0)
            feats = extractor(pyr)
            valid = np.asarray(feats.valid)
            d = np.asarray(feats.desc)[valid]
            descs.append(d)
            docs.append(np.full(len(d), doc, np.int64))
            doc += 1
        print(f"scene {s + 1}/{args.scenes}: "
              f"{sum(len(d) for d in descs)} descriptors", flush=True)

    desc = np.concatenate(descs)
    doc_ids = np.concatenate(docs)
    if args.desc_cache:
        np.savez_compressed(args.desc_cache, key=np.array(cache_key),
                            desc=np.packbits(desc, axis=1),
                            doc_ids=doc_ids)
    _train(args, desc, doc_ids)


def _train(args, desc, doc_ids):
    import time
    from ygz_tpu.backend.bow import train_vocabulary, save_vocabulary

    t0 = time.time()
    print(f"training k={args.branching} L={args.depth} on {len(desc)} "
          f"descriptors ...", flush=True)
    vocab = train_vocabulary(desc, branching=args.branching,
                             depth=args.depth, doc_ids=doc_ids)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    save_vocabulary(vocab, args.out)
    print(f"saved {vocab.n_words} words -> {args.out} "
          f"({os.path.getsize(args.out) / 1e6:.2f} MB) "
          f"in {time.time() - t0:.0f}s")


if __name__ == "__main__":
    main()
