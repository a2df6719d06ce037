"""The ResNet family against the JAX package (``models/resnet.py``):
ResNet-18 at width 8 with both stems, CIFAR ResNet-20 and WRN-16-2, on
odd and even input sizes, in train mode (the output and the running
statistics after one step) and eval mode, at rtol 1e-4 and atol 1e-5 of
the largest entry; the "SAME" pads; the linear probe."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralsvd_tpu.models import resnet as jax_resnet
from neuralsvd_tpu_torch.convert import resnet_state_from_jax
from neuralsvd_tpu_torch.models import resnet

RTOL, ATOL = 1e-4, 1e-5  # atol in units of the largest entry

MODELS = {
    "resnet18_imagenet_stem": (lambda: jax_resnet.make_resnet((2, 2, 2, 2), width=8,
                                                             num_outputs=10),
                               lambda: resnet.make_resnet((2, 2, 2, 2), width=8,
                                                          num_outputs=10, device="cpu")),
    "resnet18_cifar_stem": (lambda: jax_resnet.make_resnet((2, 2, 2, 2), width=8,
                                                          cifar_stem=True),
                            lambda: resnet.make_resnet((2, 2, 2, 2), width=8, cifar_stem=True,
                                                       device="cpu")),
    "cifar_resnet20": (lambda: jax_resnet.make_cifar_resnet(20, num_outputs=10),
                       lambda: resnet.make_cifar_resnet(20, num_outputs=10, device="cpu")),
    "wrn_16_2": (lambda: jax_resnet.make_wide_resnet(16, 2, num_outputs=10),
                 lambda: resnet.make_wide_resnet(16, 2, num_outputs=10, device="cpu")),
}


def _close(got, want, msg):
    got, want = got.detach().numpy(), np.asarray(want)
    assert got.shape == want.shape, msg
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL * np.abs(want).max(),
                               err_msg=msg)


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _named(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], np.asarray(tree)


@pytest.mark.parametrize("size", [16, 17])
@pytest.mark.parametrize("name", list(MODELS))
def test_resnet_matches_jax(name, size):
    jmake, pmake = MODELS[name]
    init, apply = jmake()
    apply = jax.jit(apply, static_argnames="train")
    jparams, jstate = init(jax.random.key(0))
    port = pmake()
    sd = resnet_state_from_jax(jax.tree.map(np.asarray, jparams),
                               jax.tree.map(np.asarray, jstate))
    assert set(sd) == set(port.state_dict())
    port.load_state_dict(sd)
    x = np.random.default_rng(size).normal(size=(8, size, size, 3)).astype(np.float32)
    xt = torch.as_tensor(x.transpose(0, 3, 1, 2).copy())

    want, new_state = apply(jparams, jstate, jnp.asarray(x), train=True)
    port.train()
    _close(port(xt), want, f"{name} {size} train")
    buffers = dict(port.named_buffers())
    for key, leaf in _named(new_state):
        _close(buffers[key], leaf, f"{name} {size} {key} after a step")

    want, _ = apply(jparams, new_state, jnp.asarray(x), train=False)
    port.eval()
    _close(port(xt), want, f"{name} {size} eval")

    # the train-mode gradient of the parameters (conv weights in OIHW) in
    # float64: through BatchNorm's batch statistics two float32 orders of
    # summation differ by more than the gradient tolerance
    with jax.enable_x64(True):
        p64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jparams)
        s64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jstate)
        x64 = jnp.asarray(x, jnp.float64)
        jg = resnet_state_from_jax(jax.tree.map(np.asarray, jax.grad(
            lambda p: jnp.sum(apply(p, s64, x64, train=True)[0] ** 2))(p64)), {},
            dtype=torch.float64)
    port = pmake().double()
    port.load_state_dict(sd)
    port.train()
    (port(xt.double()) ** 2).sum().backward()
    for key, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jg[key].numpy(), rtol=1e-4,
                                   atol=1e-6 * jg[key].abs().max().item(),
                                   err_msg=f"{name} {size} grad {key}")


@pytest.mark.parametrize("size,k,stride,want", [
    (224, 7, 2, (2, 3)), (112, 3, 2, (0, 1)), (17, 3, 2, (1, 1)), (16, 1, 2, (0, 0)),
    (16, 3, 1, (1, 1)), (9, 7, 2, (3, 3))])
def test_same_pads_put_the_odd_pixel_after(size, k, stride, want):
    assert resnet.same_pads(size, k, stride) == want
    # against XLA's own "SAME" on the CPU
    w = jnp.ones((k, k, 1, 1))
    x = jnp.zeros((1, size, size, 1)).at[0, 0, 0, 0].set(1.0)
    out = jax.lax.conv_general_dilated(x, w, (stride, stride), "SAME",
                                       dimension_numbers=("NHWC", "HWIO", "NHWC"))
    conv = resnet.Conv(k, 1, 1, stride)
    with torch.no_grad():
        conv.w.fill_(1.0)
        got = conv(torch.as_tensor(np.asarray(x).transpose(0, 3, 1, 2).copy()))
    np.testing.assert_array_equal(got.numpy().transpose(0, 2, 3, 1), np.asarray(out))


def test_batchnorm_keeps_the_biased_variance():
    bn = resnet.BatchNorm(2)
    x = torch.arange(16.0).reshape(2, 2, 2, 2)
    bn.train()
    bn(x)
    var = x.transpose(0, 1).reshape(2, -1).var(dim=1, correction=0)
    torch.testing.assert_close(bn.var, 0.9 + 0.1 * var)


def test_linear_probe_matches_jax_and_detaches():
    init, apply = jax_resnet.make_linear_probe(6, 3)
    jparams = init(jax.random.key(0))
    port = resnet.make_linear_probe(6, 3, device="cpu")
    port.load_state_dict(resnet_state_from_jax(jax.tree.map(np.asarray, jparams), {}))
    feats = np.random.default_rng(0).normal(size=(5, 6)).astype(np.float32)
    ft = torch.as_tensor(feats).requires_grad_()
    out = port(ft)
    _close(out, apply(jparams, jnp.asarray(feats)), "probe")
    out.sum().backward()
    assert ft.grad is None and port.w.grad is not None
