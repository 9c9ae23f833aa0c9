"""The port's model stacks and their reparametrization sampler on the CPU, against the JAX
package in float64: the same two exact GPs (built by ``convert.model_stack_from_numpy``
from the JAX members' numbers) predict, predict jointly, predict observations, update and
sample alike at rtol 1e-9. The JAX stack samples each member from its own split of a key;
the port's members draw in order from one ``torch.Generator``, so the tests feed them the
JAX draws, member by member.
"""
from __future__ import annotations

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trieste_tpu.data import Dataset as JDataset
from trieste_tpu.models import interfaces as jint
from trieste_tpu.models.gp.gpr import GaussianProcessRegression as JGPR
from trieste_tpu.models.gp.posterior import GPRParams as JParams
from trieste_tpu.models.stacks import StackReparametrizationSampler as JStackSampler
from trieste_tpu.ops.kernels import stationary as jstationary
from trieste_tpu_torch import Dataset, convert
from trieste_tpu_torch.models import (
    HasReparamSamplerModelStack,
    ModelStack,
    PredictJointModelStack,
    PredictYModelStack,
    StackReparametrizationSampler,
    TrainableModelStack,
    TrainablePredictJointModelStack,
)
from trieste_tpu_torch.models.gp import posterior as tpost
from trieste_tpu_torch.models.gp import sampler as tsampler
from trieste_tpu_torch.models.gp.sampler import BatchReparametrizationSampler

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def quick_jax_compiles():
    """XLA's optimizations off while this module runs: the JAX side compiles each of its
    many small programs once, and compiling dominates its time (the results agree to the
    same tolerances)."""
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", False)

F64 = torch.float64
TOL = dict(rtol=1e-9, atol=1e-12)
MEMBERS = (("matern52", 1.1, [0.6, 0.8], 1e-2, 0.2), ("rbf", 0.7, [0.5, 0.9], 1e-3, -0.1))


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a))


def _xy(n=9, seed=0):
    X = np.random.default_rng(seed).uniform(-1.0, 1.0, size=(n, 2))
    Y = np.concatenate([np.sin(3.0 * X[:, :1]) + X[:, 1:] ** 2, np.cos(2.0 * X[:, 1:]) * X[:, :1]],
                       axis=-1)
    return X, Y


def member_numbers(jmodel):
    """The arguments of ``convert.model_stack_from_numpy`` for one JAX exact GP."""
    p, data = jmodel.params, jmodel.get_internal_data()
    params = dict(kind=p.kernel.kind, variance=np.asarray(p.kernel.variance),
                  lengthscales=np.asarray(p.kernel.lengthscales),
                  noise_variance=np.asarray(p.noise_variance),
                  mean_constant=np.asarray(p.mean_constant))
    dataset = dict(query_points=np.asarray(data.query_points),
                   observations=np.asarray(data.observations), num_points=len(data))
    return params, dataset


def stack_pair(jstack_type=jint.TrainableModelStack, tstack_type=TrainableModelStack, n=9, seed=0):
    """The same two-member stack in both packages, float64, on the CPU."""
    X, Y = _xy(n, seed)
    jmembers = [
        (JGPR(JParams(jstationary(kind, var, ls, dtype=jnp.float64), jnp.asarray(noise),
                      jnp.asarray(mean)),
              JDataset.from_arrays(jnp.asarray(X), jnp.asarray(Y[:, i:i + 1]))), 1)
        for i, (kind, var, ls, noise, mean) in enumerate(MEMBERS)
    ]
    tstack = convert.model_stack_from_numpy(
        [(*member_numbers(m), size) for m, size in jmembers], stack_type=tstack_type,
        device="cpu", dtype=F64)
    return jstack_type(*jmembers), tstack


def _close(got, want, tol=TOL):
    assert tuple(got.shape) == tuple(np.shape(want))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


QUERIES = np.random.default_rng(1).uniform(-1.0, 1.0, size=(3, 4, 2))


@pytest.mark.parametrize("method", ["predict", "predict_joint", "predict_y"])
def test_stack_predictions_match_jax(method):
    stack_types = {"predict": (jint.ModelStack, ModelStack),
                   "predict_joint": (jint.PredictJointModelStack, PredictJointModelStack),
                   "predict_y": (jint.PredictYModelStack, PredictYModelStack)}[method]
    jstack, tstack = stack_pair(*stack_types)
    assert type(tstack) is stack_types[1] and tstack.event_sizes == [1, 1]
    got, want = getattr(tstack, method)(_t(QUERIES)), getattr(jstack, method)(jnp.asarray(QUERIES))
    for g, w in zip(got, want):
        _close(g, w)
    if method == "predict_joint":
        assert got[1].shape == (3, 2, 4, 4)  # the members' covariances on axis -3


def test_stack_update_splits_the_observations_like_jax():
    jstack, tstack = stack_pair()
    X, Y = _xy(13, seed=2)
    jstack.update(JDataset.from_arrays(jnp.asarray(X), jnp.asarray(Y)))
    tstack.update(Dataset.from_arrays(_t(X), _t(Y)))
    for jm, tm in zip(jstack.models, tstack.models):
        assert tm.dataset.capacity == jm.get_internal_data().capacity == 16
        _close(tm.dataset.trimmed_observations, jm.get_internal_data().trimmed_observations)
    for g, w in zip(tstack.predict(_t(QUERIES)), jstack.predict(jnp.asarray(QUERIES))):
        _close(g, w)


def test_stack_optimize_trains_each_member_on_its_slice(monkeypatch):
    """Each member trains on its own column, in order; the JAX stack does the same."""
    _, tstack = stack_pair()
    seen = []
    for i, m in enumerate(tstack.models):
        monkeypatch.setattr(m, "optimize", lambda data, i=i: seen.append((i, data)))
    X, Y = _xy(11, seed=3)
    assert tstack.optimize(Dataset.from_arrays(_t(X), _t(Y))) is None
    assert [i for i, _ in seen] == [0, 1]
    for i, data in seen:
        _close(data.trimmed_observations, Y[:, i:i + 1])
        assert data.capacity == 16


def test_event_sizes_split_wider_members():
    stack = ModelStack((object(), 2), (object(), 1))
    parts = stack._split_observations(torch.arange(12.0).reshape(4, 3))
    assert [tuple(p.shape) for p in parts] == [(4, 2), (4, 1)]
    assert torch.equal(parts[1][:, 0], torch.tensor([2.0, 5.0, 8.0, 11.0]))


def test_trainable_joint_stack_has_both_capabilities():
    _, tstack = stack_pair(jint.TrainablePredictJointModelStack, TrainablePredictJointModelStack)
    assert isinstance(tstack, TrainableModelStack) and isinstance(tstack, PredictJointModelStack)
    mean, cov = tstack.predict_joint(_t(QUERIES[0]))
    assert mean.shape == (4, 2) and cov.shape == (2, 4, 4)


def _jax_member_eps(key, num_members, batch, samples):
    """The base draws of each member of a JAX stack sampler keyed ``key``."""
    return [_t(jax.random.normal(k, (1, batch, samples), dtype=jnp.float64))
            for k in jax.random.split(key, num_members)]


def test_stack_sampler_matches_jax_given_its_draws(monkeypatch):
    jstack, tstack = stack_pair(jint.HasReparamSamplerModelStack, HasReparamSamplerModelStack)
    key, S = jax.random.PRNGKey(4), 5
    want = JStackSampler(S, jstack).sample(jnp.asarray(QUERIES), key=key)  # [3, S, 4, 2]
    draws = _jax_member_eps(key, 2, 4, S)
    monkeypatch.setattr(tsampler, "standard_normal", lambda generator, shape, like: draws.pop(0))
    sampler = tstack.reparam_sampler(S)
    assert isinstance(sampler, StackReparametrizationSampler)
    assert all(isinstance(s, BatchReparametrizationSampler) for s in sampler._samplers)
    got = sampler.sample(_t(QUERIES), jitter=1e-6)  # the JAX sampler's default jitter
    _close(got, want)
    assert not draws
    again = sampler.sample(_t(QUERIES), jitter=1e-6)  # frozen: no new draw
    _close(again, want)


def test_stack_sampler_draws_in_order_from_one_generator_and_resets_every_member():
    _, tstack = stack_pair(jint.HasReparamSamplerModelStack, HasReparamSamplerModelStack)
    sampler = tstack.reparam_sampler(6)
    first = sampler.sample(_t(QUERIES[0]), generator=torch.Generator().manual_seed(7))
    gen = torch.Generator().manual_seed(7)
    eps = [torch.randn((1, 4, 6), generator=gen, dtype=F64) for _ in range(2)]
    for s, e in zip(sampler._samplers, eps):
        torch.testing.assert_close(s._eps, e, rtol=0, atol=0)
    sampler.reset_sampler()
    assert all(s._eps is None for s in sampler._samplers)
    second = sampler.sample(_t(QUERIES[0]), generator=torch.Generator().manual_seed(8))
    assert not torch.allclose(first, second)
    clone = copy.deepcopy(sampler)  # a record keeps its own copy
    torch.testing.assert_close(clone.sample(_t(QUERIES[0])), second, rtol=0, atol=0)


def test_stack_joint_samples_match_jax_given_its_draws(monkeypatch):
    """``ModelStack.sample``: the JAX stack splits its key per member; each member draws
    ``[1, S, B]`` normals (posterior.py)."""
    jstack, tstack = stack_pair()
    key, S = jax.random.PRNGKey(5), 4
    want = jax.jit(lambda k, x: jstack.sample(k, x, S))(key, jnp.asarray(QUERIES[0]))  # [S, 4, 2]
    jkeys = jax.random.split(key, 2)
    draws = [_t(jax.random.normal(k, (1, S, 4), dtype=jnp.float64)) for k in jkeys]
    seen = []

    def replay(generator, cov_shape, num_samples, like):
        seen.append(generator)
        return draws.pop(0)

    monkeypatch.setattr(tpost, "_draw_joint_eps", replay)
    got = tstack.sample(torch.Generator().manual_seed(0), _t(QUERIES[0]), S)
    assert got.shape == (S, 4, 2) and not draws and seen[0] is seen[1]
    _close(got, want)
