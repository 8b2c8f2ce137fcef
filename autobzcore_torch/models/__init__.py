"""Model builders, observables and the transport family."""
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
    spectral_velocity_pack,
    transport_distribution,
    transport_integrand,
    transport_sweep,
)
from .tight_binding import (flagship_series, integer_lattice, synthetic_wannier, tb_graphene, tb_haldane,
                            tb_integer)
from .transport import (
    ElectronCountSolver,
    KineticCoefficientSolver,
    fermi,
    fermi_window,
    fermi_window_limits,
    optical_conductivity,
)

__all__ = [
    "CertifiedSweep", "ElectronCountSolver", "KineticCoefficientSolver", "SpectralPack", "TransportSolver",
    "certified_ladder", "certified_transport_sweep", "dos_integrand", "dos_trace", "dos_trace_weighted_sum",
    "fermi", "fermi_window", "fermi_window_limits", "flagship_series", "gathered_grid",
    "greens_function_trace", "integer_lattice", "optical_conductivity", "reduced_grid",
    "spectral_velocity_pack", "synthetic_wannier", "tb_graphene", "tb_haldane", "tb_integer",
    "transport_distribution", "transport_integrand", "transport_sweep",
]
