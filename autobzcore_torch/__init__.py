"""autobzcore_torch: the PyTorch/CUDA port of autobzcore_tpu.

Same module layout and public names as the JAX package, for the parts ported
so far: the four legs of the flagship DOS workload, PTR, IAI (cold, warm and
in omega blocks), the full-grid ladder and the linear tetrahedron method
(Fourier series on a symmetry-reduced PTR grid, under nested adaptive
Gauss-Kronrod or on full npt^3 grids, the broadened DOS trace,
``SweepSolver`` under ``hchebinterp``, ``DOSProblem``). Everything computes
in float64/complex128, on the card unless the caller names the CPU.
Hand-written CUDA kernels carry the device work: Fourier evaluation at
points (K1, ``ops.fourier_eval.fourier_points``), the fused DOS-trace k-sum
(K2, ``models.observables.dos_trace_weighted_sum``), the lane-batched series
contraction (K3, ``ops.fourier_eval.fourier_contract``), the fused leaf DOS
rule (K4, ``models.observables.gk_leaf_dos``, also over omega blocks),
the interval-pool step (K5, ``ops.adaptive``), pool coarsening (K6), for the
full-grid DOS ladder (``dos.LorentzianFullGrid``) the fused eigenvalue and
Lorentzian tail (K7, ``ops.grid_sweep.fullgrid_tail``), the Lorentzian sum
(K8, ``ops.grid_sweep.lorentzian_sum``) and closed-form small eigenvalues
(K9, ``ops.eigh3.eigvalsh_small``), and the tetrahedron DOS and N(E) (K10,
``dos.tetrahedron.tetra_dos``, under ``dos.LTM``). This package never
imports JAX.
"""
from .algorithms.gk import AuxQuadGKJL, QuadGKJL
from .algorithms.nested import NestedQuad
from .brillouin import (
    FBZ,
    IAI,
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
from .dos.interfaces import DOSProblem, DOSSolution

__version__ = "0.1.0"

__all__ = [
    "AbstractSymRep", "AuxQuadGKJL", "Basis", "BatchIntegrand", "CubicLimits", "CubicSymIBZ",
    "DOSProblem", "DOSSolution", "FBZ", "FourierIntegrand", "FourierSeries", "FourierValue",
    "HyperCube", "IAI",
    "InplaceIntegrand", "IntegralCache", "IntegralProblem", "IntegralSolution", "IntegralSolver",
    "InversionSymIBZ", "LatticeRep", "MixedParameters", "MonkhorstPack", "NestedQuad",
    "NullParameters", "PTR", "ParameterIntegrand", "QuadGKJL", "SymmetricBZ",
    "TetrahedralLimits", "TrivialRep",
    "UnknownRep", "canonical_reciprocal_basis", "init", "load_bz", "nsyms", "solve",
    "solve_", "sym_rep", "symmetrize",
]
