"""Density-of-states algorithms (reference ``autobzcore_tpu/dos``): the
problem family and the full-grid Lorentzian ladder. GGR, LTM and
AdaptiveGaussianBroadening come with a later slice (ROADMAP A6, B8)."""
from .interfaces import DOSAlgorithm, DOSCache, DOSProblem, DOSSolution, init, solve, solve_
from .fullgrid import LorentzianFullGrid

__all__ = ["DOSProblem", "DOSSolution", "DOSCache", "DOSAlgorithm", "LorentzianFullGrid",
           "init", "solve", "solve_"]
