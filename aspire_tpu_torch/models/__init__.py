from .targets import (  # noqa: F401
    FunnelProblem,
    GaussianMixtureProblem,
    GaussianProblem,
    HierarchicalProblem,
    KernelSource,
    Problem,
    RosenbrockProblem,
    get_problem,
    kernel_constants,
    target_densities,
)
