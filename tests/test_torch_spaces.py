"""The port's search spaces and the optimizers over them, on the CPU against the JAX
package: the discrete, categorical, tagged product and multi spaces (membership, bounds,
products, the one-hot encoders, sampling and ``discretize`` given the JAX package's draws),
``Box * DiscreteSearchSpace``, ``optimize_discrete``, the relaxed L-BFGS that freezes the
discrete dimensions run by run, and the continuous and random-search optimizers over a
multi space. Float64 throughout; rtol 1e-9 unless a case says otherwise.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.tree_util import Partial

from trieste_tpu import space as jsp
from trieste_tpu.acquisition import optimizer as jopt
from trieste_tpu_torch import space as tsp
from trieste_tpu_torch.acquisition import optimizer as topt

torch.set_num_threads(1)

F64 = torch.float64
TOL = dict(rtol=1e-9, atol=1e-12)


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a), dtype=F64)


def _np(x) -> np.ndarray:
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.array(x)


def _j(fn, *args):
    """``fn(*args)`` of the JAX package as one compiled program: op by op, JAX compiles
    every primitive at every new shape, which takes most of these tests' time."""
    return jax.jit(fn)(*args)


def _bounds(jspace):
    return _j(lambda: (jspace.lower, jspace.upper))


def _pair(kind: str):
    """The same space in both packages (JAX, port), on the CPU in float64."""
    grid = np.linspace(0.0, 1.0, 5)[:, None]
    if kind == "box":
        return jsp.Box([0.0, -1.0], [1.0, 2.0]), tsp.Box([0.0, -1.0], [1.0, 2.0], dtype=F64, device="cpu")
    if kind == "discrete":
        pts = np.array([[0.0, 1.0], [0.5, -1.0], [1.0, 0.25], [0.5, 0.5]])
        return jsp.DiscreteSearchSpace(jnp.asarray(pts)), tsp.DiscreteSearchSpace(_t(pts))
    if kind == "categorical":
        cats = [["a", "b", "c"], ["x", "y"]]
        return jsp.CategoricalSearchSpace(cats), tsp.CategoricalSearchSpace(cats, F64, device="cpu")
    if kind == "product":
        jb, tb = _pair("box")
        return (jsp.TaggedProductSearchSpace([jb, jsp.DiscreteSearchSpace(jnp.asarray(grid))], ["c", "d"]),
                tsp.TaggedProductSearchSpace([tb, tsp.DiscreteSearchSpace(_t(grid))], ["c", "d"]))
    if kind == "mixed_categorical":
        jc, tc = _pair("categorical")
        return (jsp.TaggedProductSearchSpace([jsp.Box([0.0], [1.0]), jc], ["x", "cat"]),
                tsp.TaggedProductSearchSpace([tsp.Box([0.0], [1.0], dtype=F64, device="cpu"), tc],
                                             ["x", "cat"]))
    if kind == "multi":
        jregions = [jsp.Box([0.0, 0.0], [0.5, 1.0]), jsp.Box([0.25, 0.5], [1.0, 0.75]),
                    jsp.Box([0.0, 0.0], [0.0, 1.0])]
        tregions = [tsp.Box(np.asarray(b.lower), np.asarray(b.upper), dtype=F64, device="cpu")
                    for b in jregions]
        return jsp.TaggedMultiSearchSpace(jregions), tsp.TaggedMultiSearchSpace(tregions)
    raise ValueError(kind)


def _probe(dimension: int, lead=(7,), seed=0) -> np.ndarray:
    """Points on and off the spaces' members: grid values, their midpoints, beyond."""
    rng = np.random.default_rng(seed)
    values = np.array([-1.0, 0.0, 0.25, 0.5, 0.75, 1.0, 2.0])
    return values[rng.integers(0, len(values), size=lead + (dimension,))]


KINDS = ["box", "discrete", "categorical", "product", "mixed_categorical"]


@pytest.mark.parametrize("kind", KINDS + ["multi"])
def test_bounds_dimension_and_membership_match_jax(kind):
    jspace, tspace = _pair(kind)
    assert tspace.dimension == jspace.dimension
    lead = (4, 3) if kind == "multi" else (8,)
    probe = jnp.asarray(_probe(jspace.dimension, lead))

    def jax_side(key):  # the probe, and members of the space unless it is a multi space
        x = probe if kind == "multi" else jnp.concatenate([probe, jspace.sample(key, 4)])
        return jspace.lower, jspace.upper, x, jspace.contains(x)

    jlower, jupper, x, want = map(_np, _j(jax_side, jax.random.PRNGKey(3)))
    np.testing.assert_allclose(_np(tspace.lower), jlower, **TOL)
    np.testing.assert_allclose(_np(tspace.upper), jupper, **TOL)
    np.testing.assert_array_equal(_np(tspace.contains(_t(x))), want)
    assert want.any() or kind == "multi"
    with pytest.raises(ValueError):
        tspace.contains(_t(np.zeros(lead[:-1] + (jspace.dimension + 1,))))


def _jax_draws(jspace, key, n):
    """The base draws of ``jspace.sample(key, n)``, rebuilt from the key with the splits
    the JAX package makes (one key per subspace of a collection)."""
    if isinstance(jspace, jsp.CollectionSearchSpace):
        keys = jax.random.split(key, len(jspace.subspace_tags))
        return [d for t, k in zip(jspace.subspace_tags, keys)
                for d in _jax_draws(jspace.get_subspace(t), k, n)]
    if isinstance(jspace, jsp.GeneralDiscreteSearchSpace):
        return [jax.random.randint(key, (n,), 0, jspace.points.shape[0])]
    return [jax.random.uniform(key, (n, jspace.dimension), dtype=jnp.float64)]


@pytest.mark.parametrize("kind", ["box", "product", "mixed_categorical", "multi"])
def test_sampling_given_the_jax_draws_matches_jax(kind, monkeypatch):
    """Each subspace draws in turn (the JAX package splits its key per subspace); fed
    those draws, the port's pure half gives the JAX package's samples."""
    jspace, tspace = _pair(kind)
    key, n = jax.random.PRNGKey(11), 6
    want, draws = _j(lambda k: (jspace.sample(k, n), _jax_draws(jspace, k, n)), key)
    draws = [_np(d) for d in draws]

    def box_sample(self, generator, m):
        u = draws.pop(0)
        assert u.shape == (m, self.dimension)
        return self._scale(_t(u))

    def discrete_sample(self, generator, m):
        idx = draws.pop(0)
        assert idx.shape == (m,) and idx.dtype.kind == "i"
        return self.points[torch.as_tensor(idx)]

    monkeypatch.setattr(tsp.Box, "sample", box_sample)
    monkeypatch.setattr(tsp.GeneralDiscreteSearchSpace, "sample", discrete_sample)
    got = tspace.sample(torch.Generator().manual_seed(0), n)
    assert not draws
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("kind", KINDS + ["multi"])
def test_sampling_from_a_generator(kind):
    _, tspace = _pair(kind)
    gen = torch.Generator().manual_seed(0)
    x = tspace.sample(gen, 16)
    want_shape = (16, tspace.num_subspaces, tspace.dimension) if kind == "multi" else (16, tspace.dimension)
    assert tuple(x.shape) == want_shape and x.dtype == F64
    assert bool(tspace.contains(x).all())
    again = tspace.sample(torch.Generator().manual_seed(0), 16)
    assert torch.equal(x, again)


def test_discretize_given_the_draws_matches_jax(monkeypatch):
    jbox, tbox = _pair("box")
    key = jax.random.PRNGKey(4)
    want = jbox.discretize(key, 5)
    u = _t(jax.random.uniform(key, (5, 2), dtype=jnp.float64))
    monkeypatch.setattr(tsp.Box, "sample", lambda self, generator, n: self._scale(u))
    got = tbox.discretize(None, 5)
    assert isinstance(got, tsp.DiscreteSearchSpace)
    np.testing.assert_allclose(_np(got.points), _np(want.points), **TOL)


@pytest.mark.parametrize("left, right", [
    ("box", "discrete"), ("discrete", "box"), ("discrete", "discrete"),
    ("categorical", "categorical"), ("product", "box"),
])
def test_products_match_jax(left, right):
    """``Box * DiscreteSearchSpace`` is a tagged product (the port's box used to refuse a
    non-box operand); discrete by discrete enumerates the pairs; categories merge."""
    (jl, tl), (jr, tr) = _pair(left), _pair(right)
    jprod, tprod = jl * jr, tl * tr
    assert type(tprod).__name__ == type(jprod).__name__
    assert tprod.dimension == jprod.dimension
    if isinstance(jprod, jsp.GeneralDiscreteSearchSpace):
        np.testing.assert_allclose(_np(tprod.points), _np(jprod.points), **TOL)
    if isinstance(jprod, jsp.CategoricalSearchSpace):
        assert list(tprod.tags) == list(jprod.tags)
    if isinstance(jprod, jsp.TaggedProductSearchSpace):
        assert tprod.subspace_tags == jprod.subspace_tags
        for tag in jprod.subspace_tags:
            assert tprod.subspace_dimension_range(tag) == jprod.subspace_dimension_range(tag)
    probe = jnp.asarray(_probe(jprod.dimension, (8,)))

    def jax_side(key):
        x = jnp.concatenate([probe, jprod.sample(key, 4)])
        return jprod.lower, jprod.upper, x, jprod.contains(x)

    jlower, jupper, x, want = map(_np, _j(jax_side, jax.random.PRNGKey(1)))
    np.testing.assert_allclose(_np(tprod.lower), jlower, **TOL)
    np.testing.assert_allclose(_np(tprod.upper), jupper, **TOL)
    np.testing.assert_array_equal(_np(tprod.contains(_t(x))), want)


def test_box_times_discrete_is_a_tagged_product_against_jax():
    jbox, tbox = _pair("box")
    grid = np.array([[0.0], [0.5], [1.0]])
    jprod = jbox * jsp.DiscreteSearchSpace(jnp.asarray(grid))
    tprod = tbox * tsp.DiscreteSearchSpace(_t(grid))
    assert isinstance(tprod, tsp.TaggedProductSearchSpace) and tprod.dimension == 3
    assert tprod.subspace_tags == jprod.subspace_tags == ("0", "1")
    assert isinstance(tprod.get_subspace("1"), tsp.DiscreteSearchSpace)
    x = np.array([[0.5, 0.0, 0.5], [0.5, 0.0, 0.25], [1.5, 0.0, 1.0], [1.0, 2.0, 0.0]])
    np.testing.assert_array_equal(_np(tprod.contains(_t(x))), _np(_j(jprod.contains, jnp.asarray(x))))
    np.testing.assert_allclose(_np(tprod.get_subspace_component("1", _t(x))),
                               _np(_j(lambda v: jprod.get_subspace_component("1", v), jnp.asarray(x))), **TOL)
    assert (tbox ** 2).dimension == 4 and isinstance(tbox ** 2, tsp.Box)


@pytest.mark.parametrize("categories", [3, ["a", "b", "c", "d"], [2, 3], [["r", "g", "b"], ["yes", "no"], ["1"]]])
def test_categorical_spaces_match_jax(categories):
    jspace = jsp.CategoricalSearchSpace(categories)
    tspace = tsp.CategoricalSearchSpace(categories, F64, device="cpu")
    assert list(tspace.tags) == list(jspace.tags)
    np.testing.assert_allclose(_np(tspace.points), _np(jspace.points), **TOL)
    assert tspace.to_tags(tspace.points[:4]) == jspace.to_tags(jspace.points[:4])
    pts = np.asarray(jspace.points)
    encoded = tspace.one_hot_encoder()(_t(pts)[None])  # batch shape kept
    np.testing.assert_allclose(_np(encoded)[0], _np(_j(jspace.one_hot_encoder(), jnp.asarray(pts))), **TOL)
    np.testing.assert_allclose(_np(tsp.one_hot_encoded_space(tspace).points),
                               _np(jsp.one_hot_encoded_space(jspace).points), **TOL)
    with pytest.raises(ValueError, match="integral"):
        tspace.to_tags(_t([[0.5] * tspace.dimension]))


@pytest.mark.parametrize("bad", [[], [0], [["a"], []], [-1, 2]])
def test_categorical_spaces_refuse_what_jax_refuses(bad):
    with pytest.raises(ValueError):
        jsp.CategoricalSearchSpace(bad)
    with pytest.raises(ValueError):
        tsp.CategoricalSearchSpace(bad, device="cpu")


def test_equality_follows_jax():
    (_, td), (_, tc) = _pair("discrete"), _pair("categorical")
    assert td == tsp.DiscreteSearchSpace(td.points.clone())
    assert td != tsp.DiscreteSearchSpace(td.points[:2])
    assert tc == tsp.CategoricalSearchSpace([["a", "b", "c"], ["x", "y"]], F64, device="cpu")
    assert tc != tsp.CategoricalSearchSpace([["a", "b", "z"], ["x", "y"]], F64, device="cpu")
    assert td != tsp.DiscreteSearchSpace(tc.points)


def test_tagged_products_match_jax():
    jspace, tspace = _pair("mixed_categorical")
    x = _np(_j(lambda k: jspace.sample(k, 6), jax.random.PRNGKey(2)))
    np.testing.assert_allclose(_np(tspace.one_hot_encoder()(_t(x))),
                               _np(_j(jspace.one_hot_encoder(), jnp.asarray(x))), **TOL)
    jenc, tenc = jsp.one_hot_encoded_space(jspace), tsp.one_hot_encoded_space(tspace)
    assert tenc.dimension == jenc.dimension == 5
    np.testing.assert_allclose(_np(tenc.get_subspace("cat").points),
                               _np(jenc.get_subspace("cat").points), **TOL)
    cast = tsp.cast_encoder(tspace.one_hot_encoder(), torch.float32)(_t(x))
    assert cast.dtype == torch.float32
    # a product of no categorical part has no encoder: the free function is the identity
    jprod, tprod = _pair("product")
    assert tprod.one_hot_encoder() is None and jprod.one_hot_encoder() is None
    assert tsp.one_hot_encoder(tprod)(_t(x)) is not None
    encoded = tsp.one_hot_encoded_space(tprod)
    assert isinstance(encoded, tsp.TaggedProductSearchSpace) and encoded.dimension == 3
    _, tbox = _pair("box")
    assert tsp.one_hot_encoded_space(tbox) is tbox
    fixed_j, fixed_t = jprod.fix_subspace("d", [0.5]), tprod.fix_subspace("d", _t([0.5]))
    jlower, jupper = _bounds(fixed_j)
    np.testing.assert_allclose(_np(fixed_t.lower), _np(jlower), **TOL)
    np.testing.assert_allclose(_np(fixed_t.upper), _np(jupper), **TOL)
    assert bool((fixed_t.sample(torch.Generator().manual_seed(0), 5)[:, 2] == 0.5).all())
    nested_j, nested_t = jsp.TaggedProductSearchSpace([jprod, jsp.Box([0.0], [1.0])]), \
        tsp.TaggedProductSearchSpace([tprod, tsp.Box([0.0], [1.0], dtype=F64, device="cpu")])
    assert nested_t.dimension == nested_j.dimension == 4
    assert nested_t.subspace_dimension_range("1") == nested_j.subspace_dimension_range("1")


def test_collections_refuse_what_jax_refuses():
    _, tb = _pair("box")
    one = tsp.Box([0.0], [1.0], dtype=F64, device="cpu")
    for make in (lambda: tsp.TaggedProductSearchSpace([tb, one], ["a", "a"]),
                 lambda: tsp.TaggedProductSearchSpace([tb, one], ["a"]),
                 lambda: tsp.TaggedMultiSearchSpace([]),
                 lambda: tsp.TaggedMultiSearchSpace([tb, one]),
                 lambda: tsp.TaggedProductSearchSpace([tb, one]).get_subspace("x")):
        with pytest.raises(ValueError):
            make()
    with pytest.raises(NotImplementedError):
        tsp.TaggedMultiSearchSpace([tb]) * tb
    # every subspace on one device, which the collection reports
    elsewhere = tsp.Box([0.0], [1.0], dtype=F64, device="meta")
    with pytest.raises(ValueError, match="different devices"):
        tsp.TaggedProductSearchSpace([tb, elsewhere])
    assert tsp.TaggedProductSearchSpace([tb, one]).device == torch.device("cpu")
    assert tsp.TaggedMultiSearchSpace([tb, tb]).num_subspaces == 2


def test_discrete_points_stay_where_they_are_given():
    space = tsp.DiscreteSearchSpace(_t([[0.0], [1.0]]))
    assert space.device == torch.device("cpu") and space.dtype == F64
    assert tsp.DiscreteSearchSpace(np.zeros((2, 1)), device="cpu").dtype == torch.get_default_dtype()
    with pytest.raises(ValueError, match="rank 2"):
        tsp.DiscreteSearchSpace(_t([0.0, 1.0]))


# -- the optimizers over these spaces ---------------------------------------------------


def _quadratic_slices(x, centres):
    """A vectorized function ``[..., V, D] -> [..., V]``: slice v peaks at ``centres[v]``."""
    return -((x - centres) ** 2).sum(-1)


@pytest.mark.parametrize("vectorized", [False, True])
def test_optimize_discrete_matches_jax(vectorized):
    jspace, tspace = _pair("discrete")
    centres = np.array([[0.5, 0.4], [1.0, 0.0]])
    if vectorized:
        jf = (lambda x: _quadratic_slices(x, jnp.asarray(centres)), 2)
        tf = (lambda x: _quadratic_slices(x, _t(centres)), 2)
    else:
        jf = lambda x: _quadratic_slices(x, jnp.asarray(centres[:1]))  # noqa: E731
        tf = lambda x: _quadratic_slices(x, _t(centres[:1]))  # noqa: E731
    want = _j(lambda: jopt.optimize_discrete(jspace, jf))
    got = topt.optimize_discrete(tspace, tf)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    np.testing.assert_allclose(_np(topt.automatic_optimizer_selector(tspace, tf)), _np(want), **TOL)


@pytest.mark.parametrize("kind", ["box", "discrete", "product", "mixed_categorical"])
def test_bounds_and_discrete_mask_match_jax(kind):
    jspace, tspace = _pair(kind)
    jlo, jhi, jmask = _j(lambda: jopt._space_bounds_and_discrete_mask(jspace))
    tlo, thi, tmask = topt._space_bounds_and_discrete_mask(tspace)
    np.testing.assert_allclose(_np(tlo), _np(jlo), **TOL)
    np.testing.assert_allclose(_np(thi), _np(jhi), **TOL)
    np.testing.assert_array_equal(_np(tmask), _np(jmask))


def _mixed_acquisition(x):
    """Smooth in the continuous columns, peaked in the discrete one."""
    return -((x[..., 0] - 0.3) ** 2 + (x[..., 1] - 0.7) ** 2 + 0.5 * (x[..., 2] - 0.6) ** 2)


def test_frozen_dimensions_lbfgs_matches_jax():
    """The relaxation over a box by a grid: every run keeps its start's discrete column
    (its bounds collapse to it, run by run, as ``[R, n]`` bounds) and the runs' iterates,
    values and winner equal the JAX package's in float64."""
    jspace, tspace = _pair("product")
    seeds = _np(_j(lambda k: jspace.sample(k, 64), jax.random.PRNGKey(8)))[:, None, :]  # [N, 1, D]
    jlo, jhi, jmask = _j(lambda: jopt._space_bounds_and_discrete_mask(jspace))
    R = 5
    jpts, jv, jimp = jopt._optimize_continuous_core(
        Partial(jopt._vec_wrap, Partial(_mixed_acquisition)), jnp.asarray(seeds),
        jnp.broadcast_to(jlo, (1, 3)), jnp.broadcast_to(jhi, (1, 3)), jmask, R, 60,
    )
    tlo, thi, tmask = topt._space_bounds_and_discrete_mask(tspace)
    pts, v, imp = topt._optimize_continuous_core(
        _mixed_acquisition, _t(seeds), tlo.expand(1, 3), thi.expand(1, 3), R, 60, tmask
    )
    np.testing.assert_allclose(_np(pts), _np(jpts), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(_np(v), _np(jv), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(_np(imp), _np(jimp), rtol=1e-9, atol=1e-12)
    assert float(_np(pts)[0, 2]) in np.linspace(0.0, 1.0, 5)  # still a grid point

    # the runs themselves: each keeps its start's grid value, and no run leaves its bounds
    from trieste_tpu_torch.ops.lbfgs import minimize_lbfgs
    starts = _t(seeds[:R, 0])
    lo = torch.where(tmask, starts, tlo)
    hi = torch.where(tmask, starts, thi)
    res = minimize_lbfgs(lambda x: -_mixed_acquisition(x), starts, lower=lo, upper=hi, max_iters=60)
    torch.testing.assert_close(res.x[:, 2], starts[:, 2], rtol=0, atol=0)
    assert bool(((res.x >= lo) & (res.x <= hi)).all())


def test_continuous_optimizer_over_a_product_space_keeps_grid_values():
    _, tspace = _pair("product")
    opt = topt.generate_continuous_optimizer(num_initial_samples=128, num_optimization_runs=4)
    point = opt(tspace, _mixed_acquisition, generator=torch.Generator().manual_seed(0))
    assert tuple(point.shape) == (1, 3) and bool(tspace.contains(point).all())
    np.testing.assert_allclose(_np(point)[0], [0.3, 0.7, 0.5], atol=1e-5)


def test_continuous_optimizer_over_a_multi_space_searches_each_region():
    """Twice as many slices as regions: the bounds and seeds are tiled, and slice ``v``
    finds the best point of its function in region ``v % 3`` (its peak where the region
    holds it, else the nearest point of the region's box). The JAX package's optimizer
    over a multi space is held against this one by the Ask/Tell slice of
    ``tests/test_torch_trust_region.py``."""
    _, tspace = _pair("multi")
    centres = np.array([[0.4, 0.9], [0.9, 0.6], [0.0, 0.3], [0.9, 0.9], [0.5, 0.6], [0.5, 0.5]])
    opt = topt.generate_continuous_optimizer(128, 3)
    gen = torch.Generator().manual_seed(0)
    got = opt(tspace, (lambda x: _quadratic_slices(x, _t(centres)), 6), generator=gen)
    lower, upper = _np(tspace.lower), _np(tspace.upper)
    want = np.clip(centres, np.tile(lower, (2, 1)), np.tile(upper, (2, 1)))
    assert tuple(got.shape) == (6, 2)
    np.testing.assert_allclose(_np(got), want, atol=1e-3)
    with pytest.raises(ValueError, match="multiple of the number of subspaces"):
        opt(tspace, (lambda x: x.sum(-1), 4), generator=gen)


def test_the_default_optimizer_by_space(monkeypatch):
    """A discrete space is searched exhaustively; a multi space, a product and a box go to
    the continuous optimizer."""
    monkeypatch.setattr(topt, "generate_continuous_optimizer",
                        lambda: lambda s, f, generator=None: "continuous")
    for kind in ("multi", "product", "box"):
        assert topt.automatic_optimizer_selector(_pair(kind)[1], lambda x: x.sum(-1)) == "continuous"
    point = topt.automatic_optimizer_selector(_pair("discrete")[1], lambda x: x.sum(-1))
    np.testing.assert_allclose(_np(point), [[1.0, 0.25]])


def test_random_search_over_a_multi_space_matches_jax(monkeypatch):
    jspace, tspace = _pair("multi")
    centres = np.array([[0.4, 0.9], [0.9, 0.6], [0.0, 0.3]])
    key = jax.random.PRNGKey(5)
    want = _j(lambda k: jopt.generate_random_search_optimizer(64)(
        jspace, (lambda x: _quadratic_slices(x, jnp.asarray(centres)), 3), key=k), key)
    seeds = _t(_j(lambda k: jspace.sample(k, 64), key))
    monkeypatch.setattr(tsp.TaggedMultiSearchSpace, "sample", lambda self, generator, n: seeds)
    got = topt.generate_random_search_optimizer(64)(
        tspace, (lambda x: _quadratic_slices(x, _t(centres)), 3))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
