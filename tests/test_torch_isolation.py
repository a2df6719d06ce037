"""The port stands alone: no JAX, no JAX package, no silent CPU fallback."""
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "neuralsvd_tpu_torch"
BLOCKED = ("jax", "jaxlib", "optax", "flax", "orbax")
# the card's machine has no matplotlib: no module of the port may need it
ABSENT = BLOCKED + ("matplotlib",)


def _port_sources():
    # the data-parallel tests' ranks import only torch and the port too
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                         ROOT / "profile_torch_e4.py",
                                         ROOT / "tests" / "torch_dp_workers.py"]


def _module_names():
    return sorted(".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
                  for p in PORT.rglob("*.py"))


def test_port_imports_with_jax_blocked():
    """Every port module (the CDK trainer and parallel/ included),
    chip_smoke, profile_torch_e4 and the data-parallel tests' ranks import
    in a process where the JAX stack and matplotlib cannot be imported at
    all."""
    code = "\n".join([
        "import importlib, importlib.util, sys",
        f"for m in {ABSENT!r}:",
        "    sys.modules[m] = None",
        f"for name in {_module_names()!r}:",
        "    importlib.import_module(name)",
        f"sys.path.insert(0, {str(ROOT)!r})",
        "importlib.import_module('chip_smoke')",
        "importlib.import_module('profile_torch_e4')",
        f"sys.path.insert(0, {str(ROOT / 'tests')!r})",
        "importlib.import_module('torch_dp_workers')",
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{ABSENT + ('neuralsvd_tpu',)!r} and sys.modules[m] is not None)",
        "assert not bad, bad",
        "print('ok')",
    ])
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_the_scans_cover_parallel():
    """parallel/ is among the modules both scans walk."""
    assert {"neuralsvd_tpu_torch.parallel", "neuralsvd_tpu_torch.parallel.collectives",
            "neuralsvd_tpu_torch.parallel.mesh", "neuralsvd_tpu_torch.parallel.sharding"
            } <= set(_module_names())
    assert {PORT / "parallel" / name for name in ("sharding.py", "collectives.py", "mesh.py")
            } <= set(_port_sources())


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: p.name)
def test_sources_name_no_jax(path):
    text = path.read_text()
    assert "neuralsvd_tpu." not in text
    assert not re.search(
        r"^\s*(import|from)\s+(jax|jaxlib|optax|flax|orbax|neuralsvd_tpu)\b",
        text, re.M)


def test_entry_points_raise_without_cuda():
    """With no GPU, the default device (CUDA) raises instead of falling
    back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    from neuralsvd_tpu_torch.data.samplers import get_sampler
    from neuralsvd_tpu_torch.device import resolve_device
    from neuralsvd_tpu_torch.methods.spectrum import compute_spectrum_evd
    from neuralsvd_tpu_torch.models.wavefunctions import make_wavefunctions

    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_wavefunctions(2, 3, [4], parallel=True, apply_boundary=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        get_sampler("gaussian", 8, 1, 2, 1.0)
    with pytest.raises(RuntimeError, match="CUDA"):
        compute_spectrum_evd(lambda x: x, [], None)
    from neuralsvd_tpu_torch.parallel.mesh import rank_device

    with pytest.raises(RuntimeError, match="CUDA"):
        rank_device(None)  # a rank's default device, --mesh's too


def test_cdk_entry_points_raise_without_cuda():
    """The CDK trainer, retrieval and spectrum default to the GPU too."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    import numpy as np

    from neuralsvd_tpu_torch.cli.sketchy import get_args, make_trainer
    from neuralsvd_tpu_torch.data.sketchy import ArrayPairLoader
    from neuralsvd_tpu_torch.eval.retrieval import Retrieval, top_k_retrievals
    from neuralsvd_tpu_torch.methods.spectrum import compute_spectrum_svd

    z = np.zeros((4, 2), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_trainer(get_args(["--network_dims", "4,2", "--neigs", "2"]), 3, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        Retrieval(ArrayPairLoader(z, z, np.arange(4), batch_size=2))
    with pytest.raises(RuntimeError, match="CUDA"):
        top_k_retrievals(z, z, K=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        compute_spectrum_svd(lambda x, y: (x, y), [])


def test_zoo_entry_points_raise_without_cuda():
    """The VGG extractor, the feature extraction, kNN and the ResNet
    factories default to the GPU too."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    import numpy as np

    from neuralsvd_tpu_torch.data.sketchy import (
        extract_split_features,
        make_vgg_feature_extractor,
    )
    from neuralsvd_tpu_torch.eval.knn import knn_monitor, knn_predict
    from neuralsvd_tpu_torch.models import resnet

    z = np.zeros((4, 2), np.float32)
    for call in (lambda: make_vgg_feature_extractor(),
                 lambda: extract_split_features(torch.nn.Identity(), None, []),
                 lambda: knn_predict(z, z, np.arange(4), 4, k=2),
                 lambda: knn_monitor(lambda v: v, z, np.arange(4), z, np.arange(4), 4, k=2),
                 lambda: resnet.make_resnet(width=2),
                 lambda: resnet.make_cifar_resnet(8),
                 lambda: resnet.make_wide_resnet(10, 1),
                 lambda: resnet.make_linear_probe(3, 2)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    from neuralsvd_tpu_torch.ops import cuda_build

    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(cuda_build, "DEFAULT_NVCC", tmp_path / "nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.build(tmp_path / "build")
    assert not (tmp_path / "build").exists() or not any((tmp_path / "build").iterdir())


def test_library_name_follows_sources(tmp_path):
    from neuralsvd_tpu_torch.ops import cuda_build

    name = cuda_build.library_path(tmp_path)
    assert name.parent == tmp_path
    assert re.fullmatch(r"libgram_kernels_[0-9a-f]{16}\.so", name.name)
    assert cuda_build.library_path(tmp_path) == name
