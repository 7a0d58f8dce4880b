"""arrowspace-tpu: a λτ spectral vector-search engine in JAX.

A ground-up JAX/XLA re-design of the capabilities of
tuned-org-uk/arrowspace-rs: spectral
vector search that indexes a dense N×F matrix with one bounded scalar per
item — the λτ ("taumode") synthetic index — derived from a Rayleigh
quotient against a graph Laplacian plus an edgewise-dispersion term, and
blends cosine similarity with λ proximity at query time.

Architecture (accelerator-first, not a port):
- graphs are small dense device matrices; SpMV = matmul;
- the λτ batch is a fixed set of (N×n)(n×n) matmuls over all items;
- search is a batched normalised matmul + lax.top_k, scanned in row
  chunks past a bounded score plane;
- scaling is jax.sharding over a device mesh (see arrowspace_tpu.parallel);
- order-dependent clustering stays host-side with a C++ native kernel.
"""

from .utils.log import init  # noqa: F401
from .taumode import TauMode, TAU_FLOOR, TAUDEFAULT  # noqa: F401
from .core import ArrowItem, ArrowSpace  # noqa: F401
from .graph import GraphFactory, GraphLaplacian, GraphParams  # noqa: F401
from .builder import ArrowSpaceBuilder, ConfigValue  # noqa: F401
from .sampling import SamplerType  # noqa: F401
from .reduction import ImplicitProjection, compute_jl_dimension  # noqa: F401
from . import eigenmaps  # noqa: F401  (attaches the staged API)
from .index import ArrowIndex  # noqa: F401
from .live import LiveSearchSession, LiveEnergySearchSession  # noqa: F401

__version__ = "0.1.0"
