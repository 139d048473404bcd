"""The host pool: ``PoolHandler`` of the port and of the JAX package on the
JAX package's three cases (and the prior's), and ``Aspire.enable_pool``
over a two-worker ``spawn`` pool: an SMC run whose likelihood maps a
module-level numpy function over row chunks on the workers, bit for bit
the run without the pool.

The JAX package's class is imported inside the tests, so the pool's
workers, which import this module to find the mapped function, stay
light."""

import multiprocessing

import numpy as np
import pytest
import torch

from aspire_tpu_torch import Aspire, PoolHandler, Samples
from aspire_tpu_torch.models import GaussianProblem

torch.set_num_threads(1)

PROBLEM = GaussianProblem(dims=2)


def rows_log_likelihood(x: np.ndarray) -> np.ndarray:
    """``GaussianProblem``'s N(2, 1) log likelihood of each row."""
    return np.sum(-0.5 * (x - PROBLEM.mu) ** 2
                  - 0.5 * np.log(2 * np.pi * PROBLEM.sigma**2), axis=-1)


def pooled_log_likelihood(samples, map_fn=map):
    """The likelihood as a user of ``enable_pool`` writes it: the rows to
    the host, ``rows_log_likelihood`` mapped over 8 chunks of them."""
    x = samples.x.detach().cpu().numpy()
    return np.concatenate(list(map_fn(rows_log_likelihood,
                                      np.array_split(x, 8))))


def _handler(package: str):
    if package == "jax":
        from aspire_tpu.utils import PoolHandler as JPoolHandler

        return JPoolHandler
    return PoolHandler


class _FakePool:
    """Stand-in for ``multiprocessing.Pool``."""

    def __init__(self):
        self.closed = False
        self.used = False

    def map(self, fn, items):
        self.used = True
        return [fn(i) for i in items]

    def close(self):
        self.closed = True

    def join(self):
        pass


class _Rows:
    x = np.ones((4, 2))


def _aspire_like():
    class A:
        def log_likelihood(self, samples, map_fn=map):
            return np.asarray(list(map_fn(
                lambda row: -0.5 * np.sum(row**2), samples.x)))

        def log_prior(self, samples, map_fn=map):
            return np.asarray(list(map_fn(lambda row: 0.0, samples.x)))

    a = A()
    a.log_likelihood = a.log_likelihood
    a.log_prior = a.log_prior
    return a


PACKAGES = ["jax", "torch"]


@pytest.mark.parametrize("package", PACKAGES)
def test_swaps_map_fn(package):
    a, pool = _aspire_like(), _FakePool()
    with _handler(package)(a, pool):
        out = a.log_likelihood(_Rows())
    assert pool.used and pool.closed
    np.testing.assert_allclose(out, -1.0)


@pytest.mark.parametrize("package", PACKAGES)
def test_requires_map_fn_kwarg(package):
    class A:
        pass

    a = A()
    a.log_likelihood = lambda samples: 0
    a.log_prior = lambda samples: 0
    with pytest.raises(ValueError, match="map_fn") as err:
        _handler(package)(a, _FakePool()).__enter__()
    assert str(err.value) == ("log_likelihood must accept a `map_fn` keyword "
                              "argument to be used with PoolHandler")


@pytest.mark.parametrize("package", PACKAGES)
def test_restores_original(package):
    a = _aspire_like()
    original = a.log_likelihood
    with _handler(package)(a, _FakePool()):
        assert a.log_likelihood is not original
    assert a.log_likelihood is original


@pytest.mark.parametrize("package", PACKAGES)
def test_parallelize_prior_and_keep_the_pool_open(package):
    a, pool = _aspire_like(), _FakePool()
    prior = a.log_prior
    with _handler(package)(a, pool, parallelize_prior=True,
                           close_pool=False):
        assert a.log_prior is not prior
        np.testing.assert_array_equal(a.log_prior(_Rows()), 0.0)
    assert a.log_prior is prior and pool.used and not pool.closed


def test_spawn_pool_smc_equals_the_run_without_it():
    """``enable_pool`` over two ``spawn`` workers: the host ladder (a
    likelihood that returns numpy cannot be captured), the same log Z bit
    for bit as ``map_fn=map``, the pool closed and the likelihood restored
    on exit."""
    asp = Aspire(log_likelihood=pooled_log_likelihood,
                 log_prior=PROBLEM.log_prior, dims=2,
                 prior_bounds=PROBLEM.prior_bounds, seed=4, device="cpu",
                 flow_backend="nsf", n_layers=2, n_hidden=(8, 8))
    asp.fit(Samples(np.random.default_rng(0).normal(2.0, 1.0, (512, 2))),
            n_epochs=2, batch_size=128)
    run = dict(sampler="smc", n_samples=256, store_sample_history=False,
               sampler_kwargs=dict(n_steps=4))
    plain = asp.sample_posterior(**run)
    pool = multiprocessing.get_context("spawn").Pool(2)
    with asp.enable_pool(pool) as handler:
        assert isinstance(handler, PoolHandler)
        assert asp.log_likelihood is not pooled_log_likelihood
        pooled = asp.sample_posterior(**run)
        assert asp.sampler.ladder is None
        assert not asp.sampler.target_is_capturable()
    assert asp.log_likelihood is pooled_log_likelihood
    with pytest.raises(ValueError, match="Pool not running"):
        pool.map(rows_log_likelihood, [np.zeros((1, 2))])
    assert pooled.log_evidence == plain.log_evidence
    assert pooled.log_evidence_error == plain.log_evidence_error
    assert torch.equal(pooled.x, plain.x)


def test_chip_smoke_pooled_likelihood_on_the_cpu():
    """``chip_smoke.py``'s pooled host likelihood (its four ``spawn``
    workers mapping the module-level numpy mixture) on the CPU at n =
    1024: its own checks (the host ladder and split route for both runs,
    the same log Z bit for bit, the pool closed, the likelihood restored,
    the numpy mixture against the port's ``GaussianMixtureProblem``) and
    its anchor gate."""
    import chip_smoke

    out = chip_smoke.pooled_likelihood(torch.device("cpu"), 1024)
    assert out["log_z_bit_identical"] and out["pool_closed"]
    assert out["pool"]["routes"] == ["split"]
