from .targets import (  # noqa: F401
    GaussianMixtureProblem,
    GaussianProblem,
    HierarchicalProblem,
    Problem,
    target_densities,
)
