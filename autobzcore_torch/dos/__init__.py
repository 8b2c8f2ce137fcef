"""Density-of-states algorithms (reference ``autobzcore_tpu/dos``): the
problem family, the generalized Gilat-Raubenheimer method and adaptive
Gaussian broadening on GGR's spectral grid, the full-grid Lorentzian ladder
and the linear tetrahedron method."""
from .interfaces import DOSAlgorithm, DOSCache, DOSProblem, DOSSolution, init, solve, solve_
from .fullgrid import LorentzianFullGrid
from .ggr import GGR
from .tetrahedron import LTM, AdaptiveGaussianBroadening

__all__ = ["DOSProblem", "DOSSolution", "DOSCache", "DOSAlgorithm", "GGR", "LorentzianFullGrid", "LTM",
           "AdaptiveGaussianBroadening", "init", "solve", "solve_"]
