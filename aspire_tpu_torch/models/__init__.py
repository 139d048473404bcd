from .targets import (  # noqa: F401
    GaussianMixtureProblem,
    GaussianProblem,
    Problem,
    target_densities,
)
