"""aspire_tpu_torch: the PyTorch + CUDA port of ``aspire_tpu``.

The main path of the JAX package - fit a flow proposal (a masked
autoregressive flow by default, or a coupling flow) to existing
posterior samples, then run adaptive-tempered SMC with tpCN mutations
and read off the evidence - on an explicit torch device. On an NVIDIA
H100 the coupling-flow passes, the whole mutation chain and the MAF-RQS
density pass run as hand-written CUDA kernels (``csrc/``, built with
nvcc at first use); on a CPU tensor every kernel wrapper runs its plain
torch version. The package
imports torch and numpy, never JAX.
"""

import logging

__version__ = "0.1.0"

from .samples import (  # noqa: E402,F401
    BaseSamples,
    MCMCSamples,
    PTMCMCSamples,
    Samples,
    SMCSamples,
)
from .aspire import Aspire  # noqa: E402,F401
from .samplers import ParallelTemperedSampler  # noqa: E402,F401
from .utils import PoolHandler, configure_logger  # noqa: E402,F401

logging.getLogger("aspire_tpu_torch").addHandler(logging.NullHandler())

__all__ = ["Aspire", "BaseSamples", "MCMCSamples", "ParallelTemperedSampler",
           "PoolHandler", "PTMCMCSamples", "Samples", "SMCSamples",
           "__version__", "configure_logger"]
