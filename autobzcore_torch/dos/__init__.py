"""Density-of-states algorithms (reference ``autobzcore_tpu/dos``): the
problem family, the full-grid Lorentzian ladder and the linear tetrahedron
method. GGR and AdaptiveGaussianBroadening come with a later slice (ROADMAP
A6, B8's GGR half)."""
from .interfaces import DOSAlgorithm, DOSCache, DOSProblem, DOSSolution, init, solve, solve_
from .fullgrid import LorentzianFullGrid
from .tetrahedron import LTM

__all__ = ["DOSProblem", "DOSSolution", "DOSCache", "DOSAlgorithm", "LorentzianFullGrid", "LTM",
           "init", "solve", "solve_"]
