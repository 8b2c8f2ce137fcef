"""Model builders and observables."""
from .observables import (
    dos_integrand,
    dos_trace,
    dos_trace_weighted_sum,
    greens_function_trace,
)
from .tight_binding import flagship_series, integer_lattice, synthetic_wannier, tb_graphene, tb_integer

__all__ = [
    "dos_integrand", "dos_trace", "dos_trace_weighted_sum", "flagship_series",
    "greens_function_trace", "integer_lattice", "synthetic_wannier", "tb_graphene", "tb_integer",
]
