"""Model builders, observables, the transport family, the Berry family, the
Lindhard family, the matrix self-energy family and the k-path."""
from .berry import (BerryCurvatureSolver, BerryPack, berry_flux_integrand, berry_pack, certified_berry,
                    lattice_chern, wilson_loop_spectrum, z2_invariant)
from .kpath import KPath, band_structure, expectation_path, kpath, spectral_path
from .lindhard import LindhardSolver, certified_chi0, cooper_bubble
from .observables import (
    CertifiedSweep,
    SpectralPack,
    TransportSolver,
    certified_ladder,
    certified_transport_sweep,
    dos_integrand,
    dos_trace,
    dos_trace_weighted_sum,
    gathered_grid,
    greens_function_trace,
    reduced_grid,
    spectral_function,
    spectral_velocity_pack,
    transport_distribution,
    transport_integrand,
    transport_sweep,
)
from .selfenergy import (SigmaCallable, SigmaDOSSolver, SigmaInterpolant, SigmaKineticCoefficientSolver,
                         SigmaTransportSolver, certified_sigma_dos, dos_integrand_sigma, dos_trace_sigma,
                         greens_trace_sigma, transport_distribution_sigma)
from .tight_binding import (flagship_series, integer_lattice, synthetic_wannier, tb_graphene, tb_haldane,
                            tb_integer, tb_kane_mele, tb_kane_mele_sz, tb_weyl)
from .transport import (
    ElectronCountSolver,
    KineticCoefficientSolver,
    fermi,
    fermi_window,
    fermi_window_limits,
    optical_conductivity,
)

__all__ = [
    "BerryCurvatureSolver", "BerryPack", "berry_flux_integrand", "berry_pack", "certified_berry", "lattice_chern",
    "tb_kane_mele", "tb_kane_mele_sz", "tb_weyl", "wilson_loop_spectrum", "z2_invariant",
    "CertifiedSweep", "ElectronCountSolver", "KineticCoefficientSolver", "SpectralPack", "TransportSolver",
    "certified_ladder", "certified_transport_sweep", "dos_integrand", "dos_trace", "dos_trace_weighted_sum",
    "fermi", "fermi_window", "fermi_window_limits", "flagship_series", "gathered_grid",
    "greens_function_trace", "integer_lattice", "optical_conductivity", "reduced_grid",
    "spectral_velocity_pack", "synthetic_wannier", "tb_graphene", "tb_haldane", "tb_integer",
    "transport_distribution", "transport_integrand", "transport_sweep",
    "LindhardSolver", "certified_chi0", "cooper_bubble",
    "SigmaCallable", "SigmaDOSSolver", "SigmaInterpolant", "SigmaKineticCoefficientSolver", "SigmaTransportSolver",
    "certified_sigma_dos", "dos_integrand_sigma", "dos_trace_sigma", "greens_trace_sigma",
    "transport_distribution_sigma",
    "KPath", "band_structure", "expectation_path", "kpath", "spectral_path", "spectral_function",
]
