"""autobzcore_torch: the PyTorch/CUDA port of autobzcore_tpu.

Same module layout and public names as the JAX package, for the parts ported
so far: the PTR leg of the flagship DOS workload (Fourier series on a
symmetry-reduced PTR grid, the broadened DOS trace, ``SweepSolver`` under
``hchebinterp``). Everything computes in float64/complex128 on the device
the caller names. Two hand-written CUDA kernels carry the device work:
Fourier evaluation at points (``ops.fourier_eval.fourier_points``) and the
fused DOS-trace k-sum (``models.observables.dos_trace_weighted_sum``).
This package never imports JAX.
"""
from .brillouin import (
    FBZ,
    AbstractSymRep,
    CubicSymIBZ,
    InversionSymIBZ,
    LatticeRep,
    PTR,
    SymmetricBZ,
    TrivialRep,
    UnknownRep,
    canonical_reciprocal_basis,
    load_bz,
    nsyms,
    sym_rep,
    symmetrize,
)
from .domains import Basis, HyperCube
from .fourier import FourierIntegrand, FourierSeries, FourierValue
from .interfaces import (
    IntegralCache,
    IntegralProblem,
    IntegralSolution,
    IntegralSolver,
    init,
    solve,
    solve_,
)
from .limits import CubicLimits, TetrahedralLimits
from .algorithms.ptr import MonkhorstPack
from .parameters import MixedParameters, NullParameters, ParameterIntegrand
from .wrappers import BatchIntegrand, InplaceIntegrand

__version__ = "0.1.0"

__all__ = [
    "AbstractSymRep", "Basis", "BatchIntegrand", "CubicLimits", "CubicSymIBZ", "FBZ",
    "FourierIntegrand", "FourierSeries", "FourierValue", "HyperCube", "InplaceIntegrand",
    "IntegralCache", "IntegralProblem", "IntegralSolution", "IntegralSolver",
    "InversionSymIBZ", "LatticeRep", "MixedParameters", "MonkhorstPack", "NullParameters",
    "PTR", "ParameterIntegrand", "SymmetricBZ", "TetrahedralLimits", "TrivialRep",
    "UnknownRep", "canonical_reciprocal_basis", "init", "load_bz", "nsyms", "solve",
    "solve_", "sym_rep", "symmetrize",
]
