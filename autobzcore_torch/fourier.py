"""Fourier/Wannier series and the Fourier integrand (reference
``autobzcore_tpu/fourier.py``).

- :class:`FourierSeries`: dense coefficient tensor on a device, with periods
  and offsets; evaluation at points goes through kernel K1
  (:func:`autobzcore_torch.ops.fourier_eval.fourier_points`).
- :class:`JacobianSeries`: evaluates to ``(H(x), dH/dz(x))`` with
  z = x/period, from the closed-form derivative coefficients
  ``(2 pi i f) c_f`` (not autodiff), through kernel K11
  (:func:`autobzcore_torch.ops.fourier_eval.fourier_points_derivs`).
- :class:`FourierValue`: the ``(x, s)`` pair handed to user kernels.
- :class:`FourierIntegrand`: a user kernel bundled with a series, whose
  series values a PTR rule computes once at its points and reuses across
  solves, and which a nested solver contracts one variable at a time.
- :class:`FourierCarrier`: the per-level series state of the nested solver,
  one coefficient tensor per lane, contracted by kernel K3
  (:func:`autobzcore_torch.ops.fourier_eval.fourier_contract`). A
  JacobianSeries rides through it as one series whose value carries d + 1
  channels (H and its d derivative series), unpacked for the user kernel.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.func import vmap

from ._device import COMPLEX, REAL, as_device
from .ops.fourier_eval import (
    contract,
    derivative_coefficients,
    evaluate_points,
    evaluate_points_jacobian,
    fourier_contract,
    jacobian_orders,
)
from .parameters import NullParameters, ParameterIntegrand, merge_parameters


def _tuple_d(v, d, cast):
    if np.ndim(v) == 0:
        return (cast(v),) * d
    t = tuple(cast(x) for x in v)
    if len(t) != d:
        raise ValueError("per-dimension data must have length d")
    return t


class FourierSeries:
    """d-dimensional trigonometric interpolant of (possibly matrix-valued)
    coefficients: ``s(x) = sum_n c[n] exp(2 pi i (n + offset) . x / period)``.

    ``c`` has shape ``(n_1, ..., n_d, *valshape)``; pass ``ndim=d`` when the
    values are arrays (e.g. ``(n1, n2, n3, m, m)`` Wannier Hamiltonians).
    ``offset[j]`` is the frequency of ``c[0, ..., 0]`` along dim j (default:
    centered, ``-(n_j - 1) // 2``). The coefficients live on ``device``.
    """

    def __init__(self, c, period=1.0, offset=None, ndim=None, dtype=COMPLEX, device="cuda"):
        if dtype != COMPLEX:
            raise ValueError("the port evaluates series in complex128 only")
        if not isinstance(c, torch.Tensor):
            c = np.asarray(c)
        self.c = torch.as_tensor(c, dtype=dtype, device=as_device(device)).contiguous()
        d = ndim if ndim is not None else self.c.ndim
        self.sndim = int(d)
        self.period = _tuple_d(period, d, float)
        if offset is None:
            offset = tuple(-((self.c.shape[j] - 1) // 2) for j in range(d))
        self.offset = _tuple_d(offset, d, int)
        self.dtype = dtype

    @property
    def ndim(self):
        return self.sndim

    @property
    def device(self):
        return self.c.device

    @property
    def valshape(self):
        return tuple(self.c.shape[self.sndim:])

    def eval_points(self, X):
        """Values at the points ``X`` (K, d) -> (K, *valshape)."""
        return evaluate_points(self.c, self.sndim, X, self.offset, self.period, None, self.dtype)

    def __call__(self, x):
        x = torch.atleast_1d(torch.as_tensor(x, dtype=REAL, device=self.device))
        return self.eval_points(x[None, :])[0]

    def contract(self, x):
        """Fix the last variable at scalar ``x``: the (d-1)-dim series."""
        obj = object.__new__(FourierSeries)
        obj.c = contract(self.c, self.sndim, x, self.offset, self.period)
        obj.sndim = self.sndim - 1
        obj.period = self.period[:-1]
        obj.offset = self.offset[:-1]
        obj.dtype = self.dtype
        return obj


class JacobianSeries:
    """Evaluates to the pair ``(H(x), V(x))`` with ``V[j] = dH/dz_j``
    (z = x/period), via closed-form derivative coefficients."""

    def __init__(self, s: FourierSeries):
        self.s = s

    @property
    def ndim(self):
        return self.s.sndim

    @property
    def sndim(self):
        # the BZ layer's series/zone dimension guard reads sndim
        return self.s.sndim

    @property
    def period(self):
        return self.s.period

    @property
    def device(self):
        return self.s.device

    def eval_points(self, X):
        """``(h (K, *valshape), v (K, d, *valshape))`` at the points X (K, d),
        in one K11 launch."""
        s = self.s
        return evaluate_points_jacobian(s.c, s.sndim, X, s.offset, s.period, s.dtype)

    def __call__(self, x):
        x = torch.atleast_1d(torch.as_tensor(x, dtype=REAL, device=self.device))
        h, v = self.eval_points(x[None, :])
        return h[0], v[0]


class FourierValue:
    """Point ``x`` and evaluated series ``s`` handed to user kernels."""

    def __init__(self, x, s):
        self.x = x
        self.s = s

    def __repr__(self):
        return f"FourierValue(x={self.x!r}, s={self.s!r})"


class StoredSeriesValues:
    """Series values kept as (re, im) real pairs (the reference's jit-boundary
    form, kept for API parity: the port stores complex tensors directly).
    ``join()`` gives the complex tensors: the (H, V) pair when ``jacobian``."""

    def __init__(self, parts, jacobian):
        self.parts = parts
        self.jacobian = jacobian

    def join(self):
        if self.jacobian:
            (hr, hi), (vr, vi) = self.parts
            return torch.complex(hr, hi), torch.complex(vr, vi)
        re, im = self.parts
        return torch.complex(re, im)


class FourierIntegrand:
    """``FourierIntegrand(f, s, *args, **kwargs)``: integrand evaluating
    ``f(FourierValue(x, s(x)), *args, **kwargs)``; ``rep=`` declares the
    symmetry representation of its value. ``batched=True`` declares that
    ``f`` takes a whole batch of points at once (x (N, d), series values
    with a leading point axis, a parameter that is one value or one per
    point), so that the PTR rule, the nested solver's leaf and the box
    pool call it once per batch instead of mapping it over the points (a
    kernel launch cannot run under ``vmap``)."""

    def __init__(self, f, s, *args, **kwargs):
        self.rep = kwargs.pop("rep", None)
        self.batched = bool(kwargs.pop("batched", False))
        self.pf = f if isinstance(f, ParameterIntegrand) else ParameterIntegrand(f, *args, **kwargs)
        if not isinstance(s, (FourierSeries, JacobianSeries)):
            raise TypeError("FourierIntegrand requires a FourierSeries/JacobianSeries")
        self.s = s

    @property
    def p(self):
        return self.pf.p

    @property
    def f(self):
        return self.pf

    def with_parameters(self, p):
        bare = FourierIntegrand(ParameterIntegrand(self.pf.f), self.s, batched=self.batched)
        bare.rep = self.rep
        return bare, merge_parameters(self.p, p)

    def __call__(self, x, p=NullParameters()):
        x = torch.atleast_1d(torch.as_tensor(x, dtype=REAL, device=self.s.device))
        return self.pf(FourierValue(x, self.s(x)), p)

    # --- PTR rule support --------------------------------------------------
    def series_values_on_grid(self, npt, frac=None):
        """Series values at the PTR rule's points, through kernel K1 (K11 for
        a JacobianSeries): the whole ``npt^d`` fractional grid when ``frac``
        is None (the full zone), else the fractional points ``frac`` (K, d),
        e.g. the symmetry representatives of an irreducible zone. Returns
        (K, *valshape) on the series' device, for a JacobianSeries the pair
        (H (K, *valshape), V (K, d, *valshape))."""
        d = self.s.sndim
        if frac is None:
            from .algorithms.ptr import frac_nodes

            frac = frac_nodes(npt, d, self.s.device)
        period = torch.as_tensor(self.s.period, dtype=REAL, device=frac.device)
        return self.s.eval_points((frac * period).contiguous())

    def nest_carrier(self, split=False, downcast=False):
        """The nested solver's carrier. ``split`` (the reference's split-f64
        tier) maps onto the same complex128 carrier; the guided tier's
        complex64 search carrier (``downcast``) is not ported (ROADMAP A5,
        "Not to port")."""
        if downcast:
            raise NotImplementedError(
                "the guided tier's complex64 carrier is not ported: IAI(precision='guided') "
                "runs the plain complex128 tier (ROADMAP A5)")
        if isinstance(self.s, JacobianSeries):
            # H and its d derivative series as d + 1 value channels: every
            # contraction carries them alike, and the user kernel gets the
            # (H, V) pair back from the channels
            base = self.s.s
            c_aug = derivative_coefficients(base.c, base.sndim, base.offset,
                                            jacobian_orders(base.sndim))
            aug = FourierSeries(c_aug, period=base.period, offset=base.offset, ndim=base.sndim,
                                device=base.device)
            pf = self.pf
            nval = len(base.valshape)

            def unpack(v, p):  # channel 0 of the value is H, channels 1..d dH/dz_j
                ax = v.s.ndim - nval - 1  # 0, or 1 under a batch of points
                return pf(FourierValue(v.x, (v.s.select(ax, 0), v.s.narrow(ax, 1, v.s.shape[ax] - 1))), p)

            return FourierCarrier.from_series(unpack, aug, batched=self.batched)
        return FourierCarrier.from_series(self.pf, self.s, batched=self.batched)

    def user_batch_fn(self):
        """``g(xs (K, d), svals (K, ...), p)``: the user kernel vmapped over
        the points and their series values (for a JacobianSeries the (H, V)
        pair, both batched); a ``batched`` kernel takes them as they are."""
        pf = self.pf
        if self.batched:
            return lambda xs, s, q: pf(FourierValue(xs, s), q)

        def one(x, s, q):
            return pf(FourierValue(x, s), q)

        return vmap(one, in_dims=(0, 0, None))


class FourierCarrier:
    """Per-level series state of the nested solver, batched over lanes.

    ``c`` (Lc, n_1..n_k, V) holds coefficient tensors with their value axes
    flattened into V, and ``cmap`` (L,) names each lane's tensor: at the
    outermost level every lane (one per solve) reads the series itself.
    :meth:`fix` contracts the last variable at per-lane nodes with kernel
    K3, giving one (k-1)-dim tensor per (lane, node) pair; :meth:`eval_batch`
    evaluates the 1-D series at per-lane points (K3 again) and calls the user
    kernel on them. Reference: ``FourierCarrier`` of
    ``autobzcore_tpu/fourier.py``, there one lane per vmapped solve."""

    def __init__(self, pf, c, cmap, offset, period, valshape, contract=fourier_contract, batched=False):
        self.pf = pf
        self.batched = batched  # pf takes the leaf's points as one batch
        self.c = c
        self.cmap = cmap
        self.offset = tuple(offset)
        self.period = tuple(period)
        self.valshape = tuple(valshape)
        self.contract = contract  # K3's wrapper, or its plain version

    @classmethod
    def from_series(cls, pf, s, nlanes=1, batched=False):
        c = s.c.reshape((1,) + tuple(s.c.shape[:s.sndim]) + (-1,)).contiguous()
        cmap = torch.zeros(nlanes, dtype=torch.int64, device=s.device)
        return cls(pf, c, cmap, s.offset, s.period, s.valshape, batched=batched)

    @property
    def sndim(self):
        return self.c.ndim - 2

    @property
    def nlanes(self):
        return self.cmap.shape[0]

    def lanes(self, nlanes):
        """The same series on ``nlanes`` lanes that share its tensors."""
        if self.c.shape[0] != 1:
            raise ValueError("only a carrier of one coefficient tensor spreads over lanes")
        return FourierCarrier(self.pf, self.c, self.cmap.new_zeros(nlanes), self.offset,
                              self.period, self.valshape, self.contract, self.batched)

    def take(self, idx):
        """The carrier of the lanes ``idx``."""
        return FourierCarrier(self.pf, self.c, self.cmap[idx], self.offset, self.period,
                              self.valshape, self.contract, self.batched)

    def fix(self, x):
        """Contract the last variable at the nodes ``x`` (L, J): the carrier
        of the L*J (lane, node) pairs, lane-major."""
        c2 = self.contract(self.c, self.cmap, x.contiguous(), self.offset[-1], self.period[-1])
        c2 = c2.reshape((-1,) + tuple(c2.shape[2:]))
        cmap = torch.arange(c2.shape[0], dtype=torch.int64, device=c2.device)
        return FourierCarrier(self.pf, c2, cmap, self.offset[:-1], self.period[:-1], self.valshape,
                              self.contract, self.batched)

    def series_values(self, x):
        """Values of the 1-D series at the points ``x`` (L, J): (L, J, *valshape)."""
        if self.sndim != 1:
            raise ValueError("series values need a 1-D carrier")
        sv = self.contract(self.c, self.cmap, x.contiguous(), self.offset[0], self.period[0])
        return sv.reshape(tuple(x.shape) + self.valshape)

    def eval_batch(self, x, coords, params):
        """The user kernel at the points ``x`` (L, J) of the innermost
        variable, with ``coords`` the fixed outer coordinates per lane
        (outermost first) and ``params`` the lanes' parameters."""
        from .algorithms.nested import assemble_points

        L, J = x.shape
        sv = self.series_values(x).reshape((L * J,) + self.valshape)
        pts = assemble_points(x, coords).reshape(L * J, -1)
        pf = self.pf

        def one(pt, s, q):
            return pf(FourierValue(pt, s), q)

        lanes = lanes_per_point(L, J, x.device)
        if self.batched:
            out = one(pts, sv, params.batch_params(lanes))
        else:
            out = params.map_points(one, (pts, sv), lanes)
        return out.reshape((L, J) + tuple(out.shape[1:]))


def lanes_per_point(L, J, device):
    """Lane index of each of the L*J lane-major points."""
    return torch.arange(L, device=device).repeat_interleave(J)
