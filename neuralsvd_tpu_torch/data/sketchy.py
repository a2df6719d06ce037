"""Sketchy Extended data pipeline on precomputed VGG features.

Port of ``neuralsvd_tpu/data/sketchy.py`` (numpy, kept as the port's own
copy): ``load_sketchy_features`` reads the per-split npz files
(features/classes/paths); ``SketchyVGGDataLoader`` serves class-balanced
random (sketch, photo) pairs, one sketch and one photo of the same class,
cycling over a shuffled class list; ``ArrayPairLoader`` serves aligned
in-memory arrays with the same interface.  ``write_feature_files`` writes
arrays in the loader's file layout, so a run can start from made-up
features where the real ones are absent.

The loader draws its pairs by default with the native C++ sampler
(``data/native.py``), as the JAX loader does, on the same stream: batch
``n`` of a loader (counted from 1, across epochs) is the sampler's draw at
counter ``n``.  The JAX loader falls back to its Python loop when the
build fails; this one raises, and runs the Python loop (a different
stream) only under ``use_native=False``.

The offline step that makes the feature files: ``split_classes`` (the
zero-shot class splits), ``make_vgg_feature_extractor`` (VGG16 in plain
``nn`` layers under torchvision's module names, so a reference checkpoint
loads without torchvision), ``extract_split_features`` and
``extract_features_main`` (the raw-image datasets need torchvision; tests
and made-up data inject ``dataset_factory``).
"""
from __future__ import annotations

import os
import random
from collections import defaultdict
from typing import Optional

import numpy as np
import torch
from torch import nn

from neuralsvd_tpu_torch.data.native import NativePairSampler
from neuralsvd_tpu_torch.device import resolve_device


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
    """Iterator over class-balanced (sketch, photo, class) batches, pairs
    drawn by the native sampler (``use_native=False``: the Python loop).
    Building the native sampler raises where it cannot be compiled."""

    def __init__(self, batch_size: int, root_path: str = "..", split=1,
                 train_or_test: str = "train", seed: int = 0,
                 use_native: bool = True):
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
        self._native = None
        self._counter = 0
        if use_native:
            self._native = NativePairSampler(
                self.sketch_idx_per_class, self.photo_idx_per_class,
                self.classes, seed=seed)
            self._sketch_f32 = np.ascontiguousarray(self.sketch_features, np.float32)
            self._photo_f32 = np.ascontiguousarray(self.photo_features, np.float32)

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
        if self._native is not None:
            return (self._native.gather(self._sketch_f32, si),
                    self._native.gather(self._photo_f32, pi), cls)
        return (self.sketch_features[si].astype(np.float32),
                self.photo_features[pi].astype(np.float32),
                cls)

    def _pick_random_pairs(self):
        if self._native is not None:
            self._counter += 1
            return self._native.sample(self.batch_size, self._counter)
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


def split_classes(classes, split: str, eccv_test_classes=None):
    """Zero-shot class split -> {"train", "test", "valid"} class arrays.

    ``split`` is "1" / "1_<seed>" (a random 80/20 split, seeded with 0) or
    "2" / "2_<seed>" (the fixed ECCV-2018 test classes, passed in as
    ``eccv_test_classes``).  "_<seed>" carves a 10% validation subset out
    of the training classes with ``RandomState(<seed>)``; without it the
    valid split is empty.
    """
    classes = sorted(classes)
    if split.startswith("1"):
        rng = np.random.RandomState(0)
        train = rng.choice(classes, int(0.8 * len(classes)), replace=False)
        test = np.setdiff1d(classes, train)
    elif split.startswith("2"):
        if eccv_test_classes is None:
            raise ValueError("split 2 needs the ECCV-2018 test-class list "
                             "(test_split_eccv2018.txt)")
        test = np.asarray(sorted(eccv_test_classes))
        train = np.setdiff1d(classes, test)
    else:
        raise NotImplementedError(split)
    valid = np.asarray([], dtype=train.dtype)
    if "_" in split:
        rng = np.random.RandomState(int(split.split("_")[-1]))
        valid = rng.choice(train, int(0.1 * len(train)), replace=False)
        train = np.setdiff1d(train, valid)
    return {"train": train, "test": test, "valid": valid}


# VGG16, configuration D: conv widths, "M" a 2x2 max-pool
VGG16_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
             512, 512, 512, "M", 512, 512, 512, "M")
VGG_EMBED_DIM = 512


class VGGFeatureExtractor(nn.Module):
    """VGG16's convolutional trunk and classifier with a 512-d last layer,
    under torchvision's module names (``features.<i>``, ``classifier.{0,3,6}``).

    ``forward`` flattens the trunk's output straight into the classifier,
    as the JAX package's wrapper does (no adaptive average pool), so it
    takes 224 x 224 inputs only.
    """

    def __init__(self, embed_dim: int = VGG_EMBED_DIM):
        super().__init__()
        layers, cin = [], 3
        for v in VGG16_CFG:
            if v == "M":
                layers.append(nn.MaxPool2d(kernel_size=2, stride=2))
            else:
                layers += [nn.Conv2d(cin, v, kernel_size=3, padding=1),
                           nn.ReLU(inplace=True)]
                cin = v
        self.features = nn.Sequential(*layers)
        self.classifier = nn.Sequential(
            nn.Linear(512 * 7 * 7, 4096), nn.ReLU(inplace=True), nn.Dropout(),
            nn.Linear(4096, 4096), nn.ReLU(inplace=True), nn.Dropout(),
            nn.Linear(4096, embed_dim))

    def reset_parameters(self, generator: torch.Generator):
        """torchvision's VGG init: Kaiming-normal (fan out) convolutions,
        N(0, 0.01) linear weights, zero biases."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Conv2d):
                    std = (2.0 / (m.out_channels * m.kernel_size[0] * m.kernel_size[1])) ** 0.5
                    m.weight.normal_(0.0, std, generator=generator)
                    m.bias.zero_()
                elif isinstance(m, nn.Linear):
                    m.weight.normal_(0.0, 0.01, generator=generator)
                    m.bias.zero_()

    def forward(self, x):
        h = self.features(x)
        return self.classifier(h.reshape(h.size(0), -1))


def make_vgg_feature_extractor(checkpoint_path=None, state_dict_key=None,
                               device=None, generator: Optional[torch.Generator] = None):
    """VGG16 trunk and 512-d head in eval mode on ``device`` (default: the
    GPU); random weights from ``generator`` (default: seeded 0), or the
    reference-format checkpoint (the tower's state dict under
    ``state_dict_key``) where one is given."""
    dev = resolve_device(device)
    net = VGGFeatureExtractor()
    net.reset_parameters(generator or torch.Generator().manual_seed(0))
    if checkpoint_path is not None:
        ckpt = torch.load(checkpoint_path, map_location="cpu")
        net.load_state_dict(ckpt[state_dict_key] if state_dict_key else ckpt)
    return net.to(dev).eval()


def extract_split_features(model, dataset, class_subset, batch_size: int = 64,
                           device=None):
    """Run ``model`` on ``device`` (default: the GPU) over the images of
    ``dataset`` whose class is in ``class_subset``; returns (features,
    classes, paths) numpy arrays.

    ``dataset`` follows the torchvision ImageFolder protocol: ``.classes``,
    ``.samples`` (path, class_idx) and indexing -> (tensor, class_idx).
    """
    dev = resolve_device(device)
    subset = set(np.asarray(class_subset).tolist())
    keep = [i for i, (_, ci) in enumerate(dataset.samples)
            if dataset.classes[ci] in subset]
    feats, classes, paths = [], [], []
    model = model.to(dev)
    with torch.no_grad():
        for s in range(0, len(keep), batch_size):
            idx = keep[s:s + batch_size]
            batch = torch.stack([dataset[i][0] for i in idx]).to(dev)
            feats.append(model(batch).cpu().numpy())
            classes.extend(dataset.classes[dataset.samples[i][1]] for i in idx)
            paths.extend(dataset.samples[i][0] for i in idx)
    features = (np.concatenate(feats, axis=0) if feats
                else np.zeros((0, VGG_EMBED_DIM), np.float32))
    return features, np.asarray(classes), np.asarray(paths)


def invert_image(x):
    """Sketch-domain transform: white-on-black -> black-on-white."""
    return 1 - x


def _image_folders(path_sketchy: str, image_size: int):
    """The raw Sketchy image folders through torchvision's ImageFolder
    (imported here: only this path needs torchvision)."""
    from torchvision import transforms
    from torchvision.datasets import ImageFolder

    t_sketch = transforms.Compose([transforms.Resize((image_size, image_size)),
                                   transforms.ToTensor(), invert_image])
    t_photo = transforms.Compose([transforms.Resize((image_size, image_size)),
                                  transforms.ToTensor()])
    return {"sketch": ImageFolder(os.path.join(path_sketchy, "sketch", "tx_000000000000"),
                                  t_sketch),
            "photo": ImageFolder(os.path.join(path_sketchy, "extended_photo"), t_photo)}


def extract_features_main(root: str, split: str = "1", image_size: int = 224,
                          batch_size: int = 64, device=None,
                          model_factory=make_vgg_feature_extractor,
                          dataset_factory=None):
    """Offline feature extraction: both VGG towers over the Sketchy image
    folders -> ``{root}/data/SketchyVGG/split{split}/{phase}_{type}.npz``,
    the files ``SketchyVGGDataLoader`` reads.  Returns the output directory.

    Expects the reference layout under ``root/data/Sketchy``: image folders
    ``sketch/tx_000000000000`` and ``extended_photo``, pretrained tower
    checkpoints under ``pretrained/``, and ``test_split_eccv2018.txt`` for
    split 2.  ``dataset_factory() -> (datasets, models)``, each a dict by
    "sketch"/"photo", replaces the folders and checkpoints (tests, made-up
    data).  The towers run on ``device`` (default: the GPU).
    """
    path_sketchy = os.path.join(root, "data", "Sketchy")
    if dataset_factory is None:
        datasets = _image_folders(path_sketchy, image_size)
        models = {
            "sketch": model_factory(
                os.path.join(path_sketchy, "pretrained", "vgg16_sketch.pth"),
                "state_dict_sketch", device=device),
            "photo": model_factory(
                os.path.join(path_sketchy, "pretrained", "vgg16_photo.pth"),
                "state_dict_image", device=device),
        }
    else:
        datasets, models = dataset_factory()

    if set(datasets["sketch"].classes) != set(datasets["photo"].classes):
        raise ValueError("the sketch and photo folders hold different classes")
    eccv = None
    if split.startswith("2"):
        with open(os.path.join(path_sketchy, "test_split_eccv2018.txt")) as fp:
            eccv = fp.read().splitlines()
    subsets = split_classes(datasets["sketch"].classes, split, eccv)

    out_dir = os.path.join(root, "data", "SketchyVGG", f"split{split}")
    os.makedirs(out_dir, exist_ok=True)
    for data_type in ("sketch", "photo"):
        for phase in ("train", "test", "valid"):
            features, classes, paths = extract_split_features(
                models[data_type], datasets[data_type], subsets[phase],
                batch_size=batch_size, device=device)
            np.savez_compressed(
                os.path.join(out_dir, f"{phase}_{data_type}.npz"),
                features=features, classes=classes, paths=paths)
    return out_dir
