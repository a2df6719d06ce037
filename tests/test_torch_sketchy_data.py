"""The Sketchy data slice against the JAX package: class splits, offline
feature extraction (injected datasets and towers, as
tests/test_cdk_retrieval.py:136-180 injects them), the VGG16's layout, the
empty valid split of split "1" in both CLIs, and the port's CLI on files
its own extraction wrote.
"""
import functools
import os
import shlex
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from neuralsvd_tpu.cli import sketchy as jax_cli
from neuralsvd_tpu.data.sketchy import SketchyVGGDataLoader as JaxSketchyLoader
from neuralsvd_tpu.data.sketchy import extract_features_main as jax_extract_features_main
from neuralsvd_tpu.data.sketchy import split_classes as jax_split_classes
from neuralsvd_tpu_torch.cli import sketchy as cli
from neuralsvd_tpu_torch.data.sketchy import (
    SketchyVGGDataLoader,
    extract_features_main,
    invert_image,
    make_vgg_feature_extractor,
    split_classes,
)

CLASSES = [f"cls{i:03d}" for i in range(125)]
ECCV = [f"cls{i:03d}" for i in range(0, 125, 7)]


@pytest.mark.parametrize("split,eccv", [("1", None), ("1_7", None), ("1_0", None),
                                        ("2", ECCV), ("2_3", ECCV)])
def test_split_classes_match_jax(split, eccv):
    got = split_classes(list(reversed(CLASSES)), split, eccv)
    want = jax_split_classes(list(reversed(CLASSES)), split, eccv)
    assert set(got) == {"train", "test", "valid"}
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == want[k].dtype
    assert len(got["valid"]) == (0 if "_" not in split else int(0.1 * (len(got["train"])
                                                                        + len(got["valid"]))))


def test_split_classes_refuse_like_jax():
    for fn in (split_classes, jax_split_classes):
        with pytest.raises(ValueError, match="ECCV"):
            fn(CLASSES, "2")
        with pytest.raises(NotImplementedError):
            fn(CLASSES, "3")


def test_sketchy_extended_split_sizes():
    """125 classes, split 1_0: 90 train, 10 valid, 25 test."""
    s = split_classes(CLASSES, "1_0")
    assert [len(s[k]) for k in ("train", "valid", "test")] == [90, 10, 25]


class FakeDataset:
    """ImageFolder protocol: .classes, .samples (path, class index),
    indexing -> (tensor, class index)."""

    def __init__(self, kind, classes, per_class=6, dim=8):
        self.classes = classes
        self.samples = [(f"/{kind}/{c}/img{j}.png", ci)
                        for ci, c in enumerate(classes) for j in range(per_class)]
        g = torch.Generator().manual_seed({"sketch": 1, "photo": 2}[kind])
        self.data = torch.randn(len(self.samples), dim, generator=g)

    def __getitem__(self, i):
        return self.data[i], self.samples[i][1]


def _factory(classes):
    tower = torch.nn.Linear(8, 16)
    with torch.no_grad():
        g = torch.Generator().manual_seed(0)
        tower.weight.copy_(torch.randn(16, 8, generator=g))
        tower.bias.copy_(torch.randn(16, generator=g))

    def dataset_factory():
        return ({"sketch": FakeDataset("sketch", classes),
                 "photo": FakeDataset("photo", classes)},
                {"sketch": tower, "photo": tower})

    return dataset_factory


@pytest.mark.parametrize("split", ["1_7", "1"])
def test_extract_features_main_matches_jax(tmp_path, split):
    classes = [f"cls{i:02d}" for i in range(20)]
    want_dir = jax_extract_features_main(str(tmp_path / "jax"), split=split, batch_size=16,
                                         dataset_factory=_factory(classes))
    got_dir = extract_features_main(str(tmp_path / "port"), split=split, batch_size=16,
                                    device="cpu", dataset_factory=_factory(classes))
    assert sorted(os.listdir(got_dir)) == sorted(os.listdir(want_dir))
    assert len(os.listdir(got_dir)) == 6
    for name in os.listdir(want_dir):
        got, want = np.load(os.path.join(got_dir, name)), np.load(os.path.join(want_dir, name))
        assert set(got.files) == set(want.files) == {"features", "classes", "paths"}
        for k in want.files:
            assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, (name, k)
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{name}:{k}")
    # the files load back through the port's loader (native draws)
    loader = SketchyVGGDataLoader(4, root_path=str(tmp_path / "port"), split=split)
    x, y, cls = next(iter(loader))
    assert x.shape == y.shape == (4, 16)
    assert set(loader.classes) == set(split_classes(classes, split)["train"].tolist())


# torchvision's vgg16 state dict, the last layer a 512-wide Linear
VGG16_LAYOUT = {
    "features.0": (64, 3), "features.2": (64, 64), "features.5": (128, 64),
    "features.7": (128, 128), "features.10": (256, 128), "features.12": (256, 256),
    "features.14": (256, 256), "features.17": (512, 256), "features.19": (512, 512),
    "features.21": (512, 512), "features.24": (512, 512), "features.26": (512, 512),
    "features.28": (512, 512),
}
VGG16_CLASSIFIER = {"classifier.0": (4096, 25088), "classifier.3": (4096, 4096),
                    "classifier.6": (512, 4096)}


def test_vgg16_has_torchvisions_layout():
    net = make_vgg_feature_extractor(device="cpu")
    want = {}
    for name, (o, i) in VGG16_LAYOUT.items():
        want[f"{name}.weight"], want[f"{name}.bias"] = (o, i, 3, 3), (o,)
    for name, (o, i) in VGG16_CLASSIFIER.items():
        want[f"{name}.weight"], want[f"{name}.bias"] = (o, i), (o,)
    got = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    assert got == want
    assert not net.training
    sd = {k: v.clone() for k, v in net.state_dict().items()}
    net2 = make_vgg_feature_extractor(device="cpu", generator=torch.Generator().manual_seed(1))
    assert not torch.equal(net2.features[0].weight, sd["features.0.weight"])
    net2.load_state_dict(sd)  # a reference checkpoint's state dict loads as it is
    with torch.no_grad():
        x = torch.rand(1, 3, 224, 224, generator=torch.Generator().manual_seed(2))
        out = net2(x)
        assert out.shape == (1, 512) and torch.isfinite(out).all()
        torch.testing.assert_close(out, net(x), rtol=0, atol=0)
        with pytest.raises(RuntimeError):  # no adaptive pool: 224 x 224 only
            net(torch.rand(1, 3, 192, 192))
    assert torch.equal(invert_image(torch.zeros(2)), torch.ones(2))


def _split1_files(root):
    return jax_extract_features_main(str(root), split="1", batch_size=16,
                                     dataset_factory=_factory([f"cls{i:02d}" for i in range(10)]))


CLI_ARGV = ["--num_epochs", "1", "--batch_size", "16", "--network_dims", "16,4",
            "--neigs", "4", "--n_retrievals", "5", "--optimizer", "adam",
            "--base_lr", "1e-3"]


def test_empty_valid_split_fails_in_the_jax_cli(tmp_path, monkeypatch):
    """Split "1" files (no _<seed>) have an empty valid split: the JAX CLI
    trains its first epoch and fails at the valid eval (its Python pairing
    path here; the native one fails alike)."""
    _split1_files(tmp_path / "root")
    monkeypatch.setattr(jax_cli, "SketchyVGGDataLoader",
                        functools.partial(JaxSketchyLoader, use_native=False))
    args = jax_cli.get_args(CLI_ARGV + ["--root_dir", str(tmp_path / "root"),
                                        "--log_dir", str(tmp_path / "log")])
    with pytest.raises(ValueError, match="need at least one array to concatenate"):
        jax_cli.main(args)


def test_empty_valid_split_raises_early_in_the_port(tmp_path, monkeypatch):
    """The port's main raises before training, naming the empty valid split
    and the 1_<seed> form; past that check (run_training on the same
    loaders) it would fail at the valid eval as the JAX CLI does."""
    _split1_files(tmp_path / "root")
    args = cli.get_args(CLI_ARGV + ["--root_dir", str(tmp_path / "root"),
                                    "--log_dir", str(tmp_path / "log"), "--device", "cpu"])
    loaders = [SketchyVGGDataLoader(16, root_path=str(tmp_path / "root"), split="1",
                                    train_or_test=phase) for phase in ("train", "test", "valid")]
    with pytest.raises(ValueError, match="need at least one array to concatenate"):
        cli.run_training(args, *loaders, input_dim=16)

    def no_training(*a, **k):
        raise AssertionError("run_training reached")

    monkeypatch.setattr(cli, "run_training", no_training)
    with pytest.raises(ValueError, match=r"valid split of --sketchy_split 1 .*1_<seed>"):
        cli.main(args)


def test_cli_trains_on_its_own_extraction(tmp_path):
    """extract_features_main (split 1_7) -> cli.sketchy.main through the
    native loader: a CSV row with finite loss, the checkpoints."""
    classes = [f"cls{i:02d}" for i in range(20)]
    extract_features_main(str(tmp_path / "root"), split="1_7", batch_size=16, device="cpu",
                          dataset_factory=_factory(classes))
    args = cli.get_args(CLI_ARGV + ["--root_dir", str(tmp_path / "root"), "--sketchy_split",
                                    "1_7", "--log_dir", str(tmp_path / "log"),
                                    "--device", "cpu", "--num_epochs", "2"])
    params, _ = cli.main(args)
    assert params["x.layers.0.w"].shape == (16, 16)
    logs = [f for f in os.listdir(tmp_path / "log") if f.endswith(".csv")]
    with open(tmp_path / "log" / logs[0]) as fh:
        rows = fh.read().splitlines()
    assert len(rows) == 3 and "nan" not in rows[-1]
    assert {"best", "ckpt"} <= set(os.listdir(tmp_path / "log"))


def _sketchy_script_argv():
    """scripts/exps/sketchy.sh's ``args=( ... )`` list, its shell
    variables left as written."""
    text = (Path(__file__).resolve().parent.parent / "scripts" / "exps" / "sketchy.sh").read_text()
    block = text.split("args=(", 1)[1].split("\n)", 1)[0]
    return [tok for line in block.splitlines() for tok in shlex.split(line.split("#", 1)[0])]


def test_smoke_runs_the_sketchy_script_with_two_cuts():
    """chip_smoke's SKETCHY_ARGV is the script's list without --root_dir and
    --sketchy_split (the smoke's own), --neuralsvd.sequential false dropped
    (the flag takes no value in either CLI) and --num_epochs cut to 2."""
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke

    script = _sketchy_script_argv()
    for flag, n in (("--root_dir", 2), ("--sketchy_split", 2), ("--neuralsvd.sequential", 2)):
        i = script.index(flag)
        assert flag != "--neuralsvd.sequential" or script[i + 1] == "false"
        del script[i:i + n]
    script[script.index("--num_epochs") + 1] = str(chip_smoke.SKETCHY_EPOCHS)
    assert chip_smoke.SKETCHY_ARGV == script
    args = cli.get_args(chip_smoke.SKETCHY_ARGV)
    assert (args.network_dims, args.neigs, args.batch_size, args.compute_dtype) == \
        ("8192,512", 512, 4096, "bf16")
    assert tuple(args.trunc_dims) == chip_smoke.SKETCHY_TRUNC and len(args.trunc_dims) == 28
    assert not args.nsvd_sequential and chip_smoke.SKETCHY_EPOCHS == 2
