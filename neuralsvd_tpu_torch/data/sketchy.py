"""Sketchy Extended data pipeline on precomputed VGG features.

Port of ``neuralsvd_tpu/data/sketchy.py:21-140`` (numpy, kept as the
port's own copy): ``load_sketchy_features`` reads the per-split npz files
(features/classes/paths); ``SketchyVGGDataLoader`` serves class-balanced
random (sketch, photo) pairs, one sketch and one photo of the same class,
cycling over a shuffled class list; ``ArrayPairLoader`` serves aligned
in-memory arrays with the same interface.  ``write_feature_files`` writes
arrays in the loader's file layout, so a run can start from made-up
features where the real ones are absent.

Not ported yet (ROADMAP queue 1, item 7): the native C++ pair sampler
(``data/native.py``, ``csrc/pair_sampler.cpp``; pairs are drawn by the
Python path here, which is the JAX package's fallback and draws from a
different random stream than the native sampler), the class splits and the
offline VGG feature extraction.
"""
from __future__ import annotations

import os
import random
from collections import defaultdict

import numpy as np


def feature_path(root_path: str, split, train_or_test: str, data_type: str):
    return os.path.join(root_path, "data", "SketchyVGG", f"split{split}",
                        f"{train_or_test}_{data_type}.npz")


def load_sketchy_features(root_path: str, split, train_or_test: str,
                          data_type: str):
    if train_or_test not in ("train", "test", "valid"):
        raise ValueError(train_or_test)
    if data_type not in ("sketch", "photo"):
        raise ValueError(data_type)
    loaded = np.load(feature_path(root_path, split, train_or_test, data_type),
                     allow_pickle=True)
    features = loaded["features"]
    paths = loaded["paths"]
    classes = loaded["classes"]
    idx_per_class = defaultdict(list)
    for i, p in enumerate(paths.tolist()):
        idx_per_class[p.split("/")[-2]].append(i)
    return features, classes, paths, idx_per_class


def write_feature_files(root_path: str, split, train_or_test: str,
                        data_type: str, features, classes) -> str:
    """Write (features, classes) as one npz file of the loader's layout;
    the paths are ``<class>/<index>`` (the loader groups by the class
    directory)."""
    classes = np.asarray(classes).astype(str)
    paths = np.asarray([f"{c}/{i}" for i, c in enumerate(classes)])
    path = feature_path(root_path, split, train_or_test, data_type)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez(path, features=np.asarray(features, np.float32), classes=classes,
             paths=paths)
    return path


class SketchyVGGDataLoader:
    """Iterator over class-balanced (sketch, photo, class) batches."""

    def __init__(self, batch_size: int, root_path: str = "..", split=1,
                 train_or_test: str = "train", seed: int = 0):
        self.batch_size = batch_size
        self.root_path = root_path
        self.split = split
        self.train_or_test = train_or_test
        self._rng = random.Random(seed)

        (self.sketch_features, self.sketch_classes, self.sketch_paths,
         self.sketch_idx_per_class) = load_sketchy_features(
            root_path, split, train_or_test, "sketch")
        (self.photo_features, self.photo_classes, self.photo_paths,
         self.photo_idx_per_class) = load_sketchy_features(
            root_path, split, train_or_test, "photo")

        if set(self.sketch_classes.tolist()) != set(self.photo_classes.tolist()):
            raise ValueError("sketch and photo files hold different classes")
        self.classes = sorted(set(self.sketch_classes.tolist()))
        self.cls_to_num = {c: i for i, c in enumerate(self.classes)}
        self.max_steps = int(np.ceil(self.sketch_features.shape[0]
                                     / batch_size))

    def __len__(self):
        return self.sketch_features.shape[0]

    def __iter__(self):
        self._step = 0
        return self

    def __next__(self):
        if self._step >= self.max_steps:
            raise StopIteration
        self._step += 1
        si, pi, cls = self._pick_random_pairs()
        return (self.sketch_features[si].astype(np.float32),
                self.photo_features[pi].astype(np.float32),
                cls)

    def _pick_random_pairs(self):
        classes = list(self.classes)
        self._rng.shuffle(classes)
        sketch_idx, photo_idx, cls_nums = [], [], []
        i = 0
        while len(sketch_idx) < self.batch_size:
            cls = classes[i % len(classes)]
            i += 1
            sketch_idx.append(self._rng.choice(self.sketch_idx_per_class[cls]))
            photo_idx.append(self._rng.choice(self.photo_idx_per_class[cls]))
            cls_nums.append(self.cls_to_num[cls])
        return (np.asarray(sketch_idx), np.asarray(photo_idx),
                np.asarray(cls_nums))


class ArrayPairLoader:
    """In-memory paired loader with the same interface (tests, synthetic
    CDK problems): yields (x, y, cls) batches from aligned arrays."""

    def __init__(self, x, y, cls, batch_size: int, seed: int = 0,
                 shuffle: bool = True):
        self.x = np.asarray(x, np.float32)
        self.y = np.asarray(y, np.float32)
        self.cls = np.asarray(cls)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self._rng = np.random.default_rng(seed)
        self.max_steps = int(np.ceil(len(self.x) / batch_size))
        # retrieval-eval compatibility
        self.sketch_features = self.x
        self.photo_features = self.y
        self.sketch_classes = self.cls
        self.photo_classes = self.cls

    def __len__(self):
        return len(self.x)

    def __iter__(self):
        order = (self._rng.permutation(len(self.x)) if self.shuffle
                 else np.arange(len(self.x)))
        for i in range(self.max_steps):
            idx = order[i * self.batch_size:(i + 1) * self.batch_size]
            yield self.x[idx], self.y[idx], self.cls[idx]
