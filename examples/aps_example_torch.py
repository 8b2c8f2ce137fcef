"""Wannier DOS, PTR and IAI legs, on the PyTorch port (``autobzcore_torch``).

The legs of ``examples/aps_example.py``: the Lorentzian-broadened DOS
``-Im Tr (w + i eta - H(k))^-1 / pi`` interpolated over w by ``hchebinterp``
(atol 1e-2).

- PTR leg: a fixed PTR rule, evaluated by ``SweepSolver`` chunks of 264
  frequencies. On a CUDA device the series goes through kernel K1 at the
  rule points and every chunk through kernel K2.
- IAI leg (``--with-iai``): nested adaptive Gauss-Kronrod over the zone's
  limits, ``IAI(inner_cap=64, inner_nbisect=4, warm_width=8)`` under
  ``SweepSolver(scan=True, warm=True)`` in chunks of 33 frequencies, each
  frequency certified to ``--abstol`` on its own: the frequencies run in
  sorted order, each solve seeded from the previous one's outer partition
  and a carried inner partition. ``--cold-iai`` solves every frequency
  cold instead, 33 at a time as lanes (the A/B switch). On a CUDA device it
  runs kernels K3 (series contraction), K4 (fused leaf DOS rule), K5
  (interval pool, with the warm seed's chunk write) and K6 (coarsening of
  the carried pool).

Two models:
- ``--hr svo_hr.dat --wout svo.wout``: a Wannier90 model on the CubicSymIBZ,
  over w in [10, 15] eV (SrVO3's t2g window);
- ``--flagship``: the synthetic 3-band series on the full zone (it has no
  point symmetry), over w in [-6, 7] eV, which holds its bands.

The computation runs on the CUDA card unless ``--device cpu`` is given.

Usage:
    python examples/aps_example_torch.py --flagship --npt 100
    python examples/aps_example_torch.py --flagship --with-iai --eta 0.05
    python examples/aps_example_torch.py --hr svo_hr.dat --wout svo.wout
"""
import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda", help="torch device (default cuda; cpu on request)")
    p.add_argument("--flagship", action="store_true",
                   help="the synthetic 3-band series on the full zone instead of --hr/--wout")
    p.add_argument("--hr", default="svo_hr.dat")
    p.add_argument("--wout", default="svo.wout")
    p.add_argument("--eta", type=float, default=1e-2)
    p.add_argument("--npt", type=int, default=100)
    p.add_argument("--atol-interp", type=float, default=1e-2)
    p.add_argument("--abstol", type=float, default=1e-3, help="IAI absolute tolerance")
    p.add_argument("--skip-ptr", action="store_true", help="run the IAI leg only")
    p.add_argument("--with-iai", action="store_true", help="also run the IAI leg")
    p.add_argument("--cold-iai", action="store_true",
                   help="disable the cross-omega warm start (A/B comparisons)")
    p.add_argument("--iai-chunk", type=int, default=33,
                   help="omega chunk size for the IAI scan (dispatch amortization vs mid-seed "
                        "harvest freshness)")
    p.add_argument("--iai-block", type=int, default=1,
                   help="omegas solved per adaptive nest; only 1 is ported (ROADMAP A5, omega blocks)")
    p.add_argument("--iai-warm-width", type=int, default=8,
                   help="outer warm-seed consumption width (intervals of the carried pool "
                        "re-evaluated per device iteration): seed evals have no sequential "
                        "dependency, so width trades live memory for the seeding phase's trips")
    p.add_argument("--iai-inner-seed-width", type=int, default=None,
                   help="mid-seed consumption width (intervals re-evaluated per device iteration "
                        "when a warm inner pool seeds from the carried partition): trades live "
                        "memory for seeding depth")
    p.add_argument("--iai-inner-cap", type=int, default=64, help="inner-level pool capacity")
    p.add_argument("--iai-inner-nbisect", type=int, default=4, help="inner-level bisection width")
    p.add_argument("--iai-order", type=int, default=None,
                   help="Gauss-Kronrod order of every IAI level (default 7, 15 points)")
    p.add_argument("--out", default=None, help="write omega and the DOS to this .npz")
    args = p.parse_args(argv)
    if args.iai_block != 1:
        raise NotImplementedError("omega-block IAI sweeps (--iai-block > 1) are not ported yet "
                                  "(ROADMAP A5, omega blocks)")

    import torch

    from autobzcore_torch import FBZ, IAI, PTR, AuxQuadGKJL, CubicSymIBZ, IntegralProblem, load_bz
    from autobzcore_torch.models.observables import dos_integrand
    from autobzcore_torch.parallel.sweep import SweepSolver
    from autobzcore_torch.utils.chebinterp import hchebinterp

    device = torch.device(args.device)
    if args.flagship:
        from autobzcore_torch.models.tight_binding import flagship_series

        h = flagship_series(device=device)
        bz = load_bz(FBZ(), np.eye(3))
        window = (-6.0, 7.0)
        label = "synthetic 3-band flagship series"
    else:
        if not (os.path.exists(args.hr) and os.path.exists(args.wout)):
            p.error(f"{args.hr} / {args.wout} not found; pass --flagship for the synthetic model")
        from autobzcore_torch.io.wannier90 import hamiltonian_fourier_series, read_w90_hrdat

        hr = read_w90_hrdat(args.hr)
        h = hamiltonian_fourier_series(hr, device=device)
        bz = load_bz(CubicSymIBZ(), args.wout)
        window = (10.0, 15.0)
        label = f"{hr['num_wann']}-band Wannier model"
    print(f"loaded {label}, {bz}, on {device}", file=sys.stderr)

    prob = IntegralProblem(dos_integrand(h, args.eta), bz)
    ws = np.linspace(*window, 1001)
    mid = 0.5 * (window[0] + window[1])
    out = {"omega": ws}
    dos = None
    if not args.skip_ptr:
        t0 = time.perf_counter()
        sweep = SweepSolver(prob, PTR(npt=args.npt, device=device), chunk=264)
        dos = hchebinterp(sweep, *window, atol=args.atol_interp)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t_ptr = time.perf_counter() - t0
        print(f"PTR(npt={args.npt}) interpolant: {dos.numevals} omegas, {len(dos.panels)} panels, "
              f"{sweep.numevals} integrand evals, {t_ptr:.3f} s", file=sys.stderr)
        out.update(dos_ptr=dos(ws), t_ptr=t_ptr)
    if args.with_iai:
        algs = AuxQuadGKJL(order=args.iai_order, nbisect=1, device=device) if args.iai_order else None
        alg = IAI(algs=algs, inner_cap=args.iai_inner_cap, inner_nbisect=args.iai_inner_nbisect,
                  warm_width=args.iai_warm_width, inner_seed_width=args.iai_inner_seed_width,
                  device=device)
        t0 = time.perf_counter()
        isweep = SweepSolver(prob, alg, abstol=args.abstol, chunk=args.iai_chunk, scan=True,
                             warm=not args.cold_iai)
        dos_iai = hchebinterp(isweep, *window, atol=args.atol_interp)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t_iai = time.perf_counter() - t0
        ne = isweep.numevals
        tier = "cold" if args.cold_iai else "warm"
        print(f"IAI interpolant ({tier}, complex128): {t_iai:.2f} s, {ne:.3g} integrand evals over "
              f"{dos_iai.numevals} omegas ({ne / max(dos_iai.numevals, 1):.3g}/omega), "
              f"retcode {isweep.retcode}", file=sys.stderr)
        if isweep.chunk_evals:
            # per-chunk evaluations and [first, last] omega with the seed's distance
            print("IAI chunk evals: " + " ".join(f"{v:.3g}" for v in isweep.chunk_evals),
                  file=sys.stderr)
            print("IAI chunk seeds: " + " ".join(f"[{a:.4g},{b:.4g}]d={d:.2g}"
                                                 for a, b, d in isweep.chunk_meta), file=sys.stderr)
        out.update(dos_iai=dos_iai(ws), t_iai=t_iai)
    if args.out:
        np.savez(args.out, **out)
    if dos is not None:
        print(f"PTR DOS({mid:g} eV) = {float(dos(mid)):.6f}")
    if args.with_iai:
        print(f"IAI DOS({mid:g} eV) = {float(dos_iai(mid)):.6f}")
    return dos

if __name__ == "__main__":
    main()
