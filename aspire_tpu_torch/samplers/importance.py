"""Importance sampling with the flow as proposal (counterpart of
``aspire_tpu/samplers/importance.py``)."""

from __future__ import annotations

from ..samples import Samples
from ..utils import track_calls
from .base import Sampler


class ImportanceSampler(Sampler):
    @track_calls
    def sample(self, n_samples: int) -> Samples:
        x, log_q = self.prior_flow.sample_and_log_prob(
            n_samples, generator=self.generator)
        samples = Samples(x=x, log_q=log_q, dtype=self.dtype,
                          parameters=self.parameters, device=self.device)
        samples.log_prior = self.evaluate_log_prior(samples.x)
        samples.log_likelihood = self.evaluate_log_likelihood(samples.x)
        samples.compute_weights()
        return samples
