"""The port's ConvPolicy, GRUPolicy and the policies' compute_dtype
against the JAX package on the same inputs, on the CPU.

Parameters are JAX ``init`` vectors plus numpy-seeded noise (the flat
layouts are the same), at ES's sigma 0.1 for the conv policy's logits
(f32 errors grow with the logits: 1.9e-6 at |logit| 2.7 there, 5.8e-5
at 35 with noise 1.0); observations come from numpy. Tolerances: f32
logits and GRU carries within 1e-5 (products of two libraries summed in
another order); bf16 logits within 2e-2 of JAX's bf16 logits (one bf16
rounding of a logit near 1 is 4e-3, and the products, bias adds and
tanh each round).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fiber_tpu.models import ConvPolicy as JaxConvPolicy
from fiber_tpu.models import GRUPolicy as JaxGRUPolicy
from fiber_tpu.models import MLPPolicy as JaxMLPPolicy

from fiber_tpu_torch.models import policies
from fiber_tpu_torch.models.convert import policy_params_from_jax
from fiber_tpu_torch.models.policies import ConvPolicy, GRUPolicy, MLPPolicy


def _np(x):
    return np.asarray(jax.device_get(x))


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _thetas(jpol, n, seed, scale=0.3):
    base = _np(jpol.init(jax.random.PRNGKey(seed)))
    noise = np.random.default_rng(seed).standard_normal((n, jpol.dim))
    return (base + scale * noise).astype(np.float32)


def _images(n, shape, seed):
    return np.random.default_rng(seed).uniform(
        -1.0, 1.0, (n, *shape)).astype(np.float32)


# (obs shape, channels, hidden): the pixel chase's policy; an odd image
# whose SAME padding is 1 before and 1 after at 7 and 9, then 0 and 1
CONV_CASES = [((24, 24, 1), (16, 32), 128), ((7, 9, 2), (4, 8), 16)]


@pytest.mark.parametrize("shape,channels,hidden", CONV_CASES,
                         ids=["24x24x1", "7x9x2"])
def test_conv_policy_matches_jax(shape, channels, hidden):
    jpol = JaxConvPolicy(shape, 5, channels=channels, hidden=hidden)
    pol = ConvPolicy(shape, 5, channels=channels, hidden=hidden)
    assert pol.dim == jpol.dim and pol._specs == jpol._specs
    thetas = _thetas(jpol, 6, 1, scale=0.1)
    obs = _images(6, shape, 2)
    want = _np(jax.vmap(jpol.apply)(jnp.asarray(thetas), jnp.asarray(obs)))
    got = pol.apply(_t(thetas), _t(obs))
    assert got.dtype == torch.float32 and got.shape == (6, 5)
    assert np.abs(got.numpy() - want).max() < 1e-5
    assert pol.act(_t(thetas), _t(obs)).tolist() == _np(
        jax.vmap(jpol.act)(jnp.asarray(thetas), jnp.asarray(obs))).tolist()


def test_same_padding_is_xla_s():
    assert policies._same_pad(24) == (0, 1)
    assert policies._same_pad(12) == (0, 1)
    assert policies._same_pad(7) == (1, 1)
    assert policies._same_pad(9) == (1, 1)
    assert policies._same_pad(4) == (0, 1)


def _conv_features_then_dense(pol, thetas, obs, nchw):
    """The conv policy's logits with its features flattened NHWC (h, w,
    c), or NCHW (c, h, w) when ``nchw``."""
    x, offset = obs, 0
    for kind, shape in pol._specs:
        w, offset = policies._take(thetas, offset, shape)
        b, offset = policies._take(thetas, offset, (shape[-1],))
        if kind == "conv":
            x = pol._conv(x, w, b)
            continue
        if x.dim() == 4:
            x = (x.permute(0, 3, 1, 2) if nchw else x).reshape(x.shape[0], -1)
        x = policies._dense(x, w, b)
        if shape[-1] != pol.act_dim:
            x = torch.tanh(x)
    return x


def test_conv_policy_parity_catches_padding_and_flatten_order(monkeypatch):
    """What the parity test holds: symmetric padding (``conv2d``'s
    ``padding=1``, which shifts the stride-2 grid at 24 -> 12) or an
    NCHW flatten gives other logits than JAX's SAME/NHWC/HWIO."""
    shape = (24, 24, 1)
    jpol = JaxConvPolicy(shape, 5, channels=(4, 8), hidden=16)
    pol = ConvPolicy(shape, 5, channels=(4, 8), hidden=16)
    thetas, obs = _thetas(jpol, 4, 3, scale=1.0), _images(4, shape, 4)
    want = _np(jax.vmap(jpol.apply)(jnp.asarray(thetas), jnp.asarray(obs)))

    def err(logits):
        return np.abs(logits.numpy() - want).max()

    assert err(_conv_features_then_dense(pol, _t(thetas), _t(obs),
                                         nchw=False)) < 1e-5
    assert err(_conv_features_then_dense(pol, _t(thetas), _t(obs),
                                         nchw=True)) > 1e-2
    monkeypatch.setattr(policies, "_same_pad", lambda n: (1, 1))
    assert err(pol.apply(_t(thetas), _t(obs))) > 1e-2


def test_gru_step_and_init_match_jax():
    jpol = JaxGRUPolicy(4, 2, hidden=8)
    pol = GRUPolicy(4, 2, hidden=8)
    assert pol.dim == jpol.dim
    thetas = _thetas(jpol, 16, 5, scale=1.0)
    rng = np.random.default_rng(6)
    carry = rng.uniform(-1.0, 1.0, (16, 8)).astype(np.float32)
    obs = rng.standard_normal((16, 4)).astype(np.float32)
    want_c, want_l = jax.vmap(jpol.step)(jnp.asarray(thetas),
                                         jnp.asarray(carry), jnp.asarray(obs))
    got_c, got_l = pol.step(_t(thetas), _t(carry), _t(obs))
    assert np.abs(got_c.numpy() - _np(want_c)).max() < 1e-5
    assert np.abs(got_l.numpy() - _np(want_l)).max() < 1e-5
    # act_step, from the zero carry as a rollout starts
    zero = pol.init_carry(16, device="cpu")
    assert zero.shape == (16, 8) and not zero.any()
    want_c, want_a = jax.vmap(jpol.act_step, in_axes=(0, None, 0))(
        jnp.asarray(thetas), jpol.init_carry(), jnp.asarray(obs))
    got_c, got_a = pol.act_step(_t(thetas), zero, _t(obs))
    assert np.abs(got_c.numpy() - _np(want_c)).max() < 1e-5
    assert got_a.tolist() == _np(want_a).tolist()
    # init: the JAX order of parts, zero biases
    flat = pol.init(torch.Generator().manual_seed(0), device="cpu")
    parts = pol._unpack(flat[None])
    assert flat.shape == (pol.dim,)
    assert [tuple(p.shape[1:]) for p in parts] == [
        tuple(p.shape) for p in jpol._unpack(jpol.init(jax.random.PRNGKey(0)))]
    assert not any(parts[i].any() for i in (2, 5, 8, 10))


def _bf16_cases():
    mlp = (JaxMLPPolicy(4, 3, hidden=(16, 16)),
           MLPPolicy(4, 3, hidden=(16, 16)),
           lambda n, seed: np.random.default_rng(seed).standard_normal(
               (n, 4)).astype(np.float32))
    conv = (JaxConvPolicy((8, 8, 1), 5, channels=(4, 8), hidden=16),
            ConvPolicy((8, 8, 1), 5, channels=(4, 8), hidden=16),
            lambda n, seed: _images(n, (8, 8, 1), seed))
    return {"mlp": mlp, "conv": conv}


@pytest.mark.parametrize("via", ["kwarg", "env"])
@pytest.mark.parametrize("kind", ["mlp", "conv"])
def test_compute_dtype_bf16_matches_jax(kind, via, monkeypatch):
    """bf16 products through the kwarg or FIBER_POLICY_DTYPE (read at
    apply time in the port, at trace time in JAX): f32 logits within
    2e-2 of JAX's bf16 logits, and measurably off the f32 ones."""
    jpol32, pol32, make_obs = _bf16_cases()[kind]
    thetas = _thetas(jpol32, 16, 7, scale=1.0)
    obs = make_obs(16, 8)
    monkeypatch.delenv("FIBER_POLICY_DTYPE", raising=False)
    f32 = pol32.apply(_t(thetas), _t(obs))
    if via == "kwarg":
        jpol, pol = (type(p)(*_ctor(p), compute_dtype="bfloat16")
                     for p in (jpol32, pol32))
    else:
        monkeypatch.setenv("FIBER_POLICY_DTYPE", "bfloat16")
        jpol, pol = jpol32, pol32
    want = _np(jax.vmap(jpol.apply)(jnp.asarray(thetas), jnp.asarray(obs)))
    got = pol.apply(_t(thetas), _t(obs))
    assert want.dtype == np.float32 and got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() < 2e-2
    assert (got - f32).abs().max() > 1e-4
    monkeypatch.delenv("FIBER_POLICY_DTYPE", raising=False)
    assert torch.equal(pol32.apply(_t(thetas), _t(obs)), f32)


def _ctor(p):
    """The positional constructor arguments of a policy."""
    if hasattr(p, "channels"):
        return p.obs_shape, p.act_dim, p.channels, p.hidden
    return p.obs_dim, p.act_dim, p.sizes[1:-1]


def test_policy_params_from_jax_carries_conv_and_gru_vectors():
    for jpol in (JaxConvPolicy((24, 24, 1), 5), JaxGRUPolicy(4, 2, 8)):
        vec = _np(jpol.init(jax.random.PRNGKey(1)))
        got = policy_params_from_jax(vec, device="cpu")
        assert got.dtype == torch.float32 and got.numpy().tolist() == \
            vec.tolist()
