"""autobzcore_torch: the PyTorch/CUDA port of autobzcore_tpu.

Same module layout and public names as the JAX package, for the parts ported
so far: the four legs of the flagship DOS workload, PTR, IAI (cold, warm and
in omega blocks, with fixed levels), TAI and ``HCubatureJL``,
``QuadratureFunction``, ``EvalCounter``, ``AbsoluteEstimate``,
``PTR_IAI``, ``AutoPTR`` and ``AutoPTR_IAI``, the full-grid ladder and the linear tetrahedron method
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
``dos.tetrahedron.tetra_dos``, under ``dos.LTM``), and for the spectral-grid
DOS (``GGR``, ``dos.AdaptiveGaussianBroadening``) the series Jacobian at
points (K11, ``ops.fourier_eval.fourier_points_derivs``, behind
``JacobianSeries``), the band velocities (K12, ``dos.ggr.band_velocity``)
and the box and Gaussian energy sums (K13, ``dos.ggr.ggr_box_sum`` and
``dos.ggr.gaussian_sum``), and for Genz-Malik cubature (``HCubatureJL``,
``TAI``) the box rule (K14, ``ops.genz_malik.gm_rule_reduce``), the box rule
fused with the DOS trace (K15, ``models.observables.gm_leaf_dos``) and the
box-pool step (K16, ``ops.genz_malik.gm_pool_step``, one launch a trip
after ``gm_pool_begin``), and for fixed rules (``QuadratureFunction``, fixed nest
levels) the rule's reduction (K17, ``ops.adaptive.fixed_rule_reduce``), and
for the transport family (``TransportSolver``, ``KineticCoefficientSolver``,
``ElectronCountSolver``) the band-pair velocity pack (K18,
``models.observables.velocity_pairs``), the Lorentzian-pair transport
contraction (K19, ``models.observables.transport_gamma``) and the Fermi count
(K20, ``models.transport.fermi_count``), and for the Berry family
(``models.berry``: ``BerryCurvatureSolver``, ``lattice_chern``, Wilson loops)
the band-pair terms (K21, ``band_pair_terms``), the plaquette flux (K22,
``plaquette_flux``), the Wilson loops (K23, ``wilson_loops``) and the
weighted zone average (K24, ``zone_average``), for the Lindhard and matrix
self-energy families the bubbles (K25, K26) and the inverse sums (K27,
K28, ``models.selfenergy``), whose K27 also sums the matrix spectral
function under the PTR rule (``models.observables.spectral_weighted_sum``),
and for the k-path (``models.kpath``) the spectral map (K29,
``spectral_map``) and band expectations (K30, ``band_expect``), and the
transport distribution at points (K31,
``models.observables.transport_points``). This package never imports JAX.
"""
from .algorithms.gk import AuxQuadGKJL, QuadGKJL
from .algorithms.hcubature import HCubatureJL
from .algorithms.meta import AbsoluteEstimate, EvalCounter
from .algorithms.nested import NestedQuad
from .algorithms.quadrature import QuadratureFunction
from .brillouin import (
    FBZ,
    IAI,
    AutoPTR,
    AutoPTR_IAI,
    TAI,
    AbstractSymRep,
    CubicSymIBZ,
    InversionSymIBZ,
    LatticeRep,
    PTR,
    PTR_IAI,
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
from .fourier import FourierIntegrand, FourierSeries, FourierValue, JacobianSeries
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
from .algorithms.ptr import AutoSymPTRJL, MonkhorstPack
from .parameters import MixedParameters, NullParameters, ParameterIntegrand
from .wrappers import BatchIntegrand, InplaceIntegrand
from .dos.interfaces import DOSProblem, DOSSolution
from .dos.ggr import GGR
from .models.observables import SpectralPack, TransportSolver, spectral_velocity_pack
from .models.transport import ElectronCountSolver, KineticCoefficientSolver, optical_conductivity
from .ops.quad_rules import gausslegendre, trapz

__version__ = "0.1.0"

__all__ = [
    "AbsoluteEstimate", "AbstractSymRep", "AutoPTR", "AutoPTR_IAI", "AutoSymPTRJL", "AuxQuadGKJL", "Basis", "BatchIntegrand", "CubicLimits",
    "CubicSymIBZ", "DOSProblem", "DOSSolution", "ElectronCountSolver", "EvalCounter", "FBZ",
    "FourierIntegrand", "FourierSeries", "FourierValue", "GGR", "HCubatureJL", "HyperCube", "IAI",
    "InplaceIntegrand", "IntegralCache", "IntegralProblem", "IntegralSolution", "IntegralSolver",
    "InversionSymIBZ", "JacobianSeries", "KineticCoefficientSolver", "LatticeRep", "MixedParameters",
    "MonkhorstPack", "NestedQuad", "NullParameters", "PTR", "PTR_IAI", "ParameterIntegrand", "QuadGKJL",
    "QuadratureFunction", "SpectralPack", "SymmetricBZ", "TAI", "TetrahedralLimits", "TransportSolver",
    "TrivialRep", "UnknownRep", "canonical_reciprocal_basis", "gausslegendre", "init", "load_bz",
    "nsyms", "optical_conductivity", "solve", "solve_", "spectral_velocity_pack", "sym_rep",
    "symmetrize", "trapz",
]
