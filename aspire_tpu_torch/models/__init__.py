from .targets import (  # noqa: F401
    FunnelProblem,
    GaussianMixtureProblem,
    GaussianProblem,
    HierarchicalProblem,
    Problem,
    RosenbrockProblem,
    get_problem,
    target_densities,
)
