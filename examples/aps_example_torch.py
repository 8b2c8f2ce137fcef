"""Wannier DOS, PTR leg, on the PyTorch port (``autobzcore_torch``).

The PTR leg of ``examples/aps_example.py``: the Lorentzian-broadened DOS
``-Im Tr (w + i eta - H(k))^-1 / pi`` integrated with a fixed PTR rule and
interpolated over w by ``hchebinterp`` (atol 1e-2), evaluated by
``SweepSolver`` chunks of 264 frequencies. On a CUDA device the series goes
through kernel K1 at the rule points and every chunk through kernel K2.

Two models:
- ``--hr svo_hr.dat --wout svo.wout``: a Wannier90 model on the CubicSymIBZ,
  over w in [10, 15] eV (SrVO3's t2g window);
- ``--flagship``: the synthetic 3-band series on the full zone (it has no
  point symmetry), over w in [-6, 7] eV, which holds its bands.

Usage:
    python examples/aps_example_torch.py --flagship --device cuda --npt 100
    python examples/aps_example_torch.py --hr svo_hr.dat --wout svo.wout --device cuda
"""
import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", required=True, help="torch device, e.g. cuda or cpu")
    p.add_argument("--flagship", action="store_true",
                   help="the synthetic 3-band series on the full zone instead of --hr/--wout")
    p.add_argument("--hr", default="svo_hr.dat")
    p.add_argument("--wout", default="svo.wout")
    p.add_argument("--eta", type=float, default=1e-2)
    p.add_argument("--npt", type=int, default=100)
    p.add_argument("--atol-interp", type=float, default=1e-2)
    p.add_argument("--out", default=None, help="write omega and the DOS to this .npz")
    args = p.parse_args(argv)

    import torch

    from autobzcore_torch import FBZ, PTR, CubicSymIBZ, IntegralProblem, load_bz
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
    t0 = time.perf_counter()
    sweep = SweepSolver(prob, PTR(npt=args.npt), chunk=264)
    dos = hchebinterp(sweep, *window, atol=args.atol_interp)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t_ptr = time.perf_counter() - t0
    print(f"PTR(npt={args.npt}) interpolant: {dos.numevals} omegas, {len(dos.panels)} panels, "
          f"{sweep.numevals} integrand evals, {t_ptr:.3f} s", file=sys.stderr)
    ws = np.linspace(*window, 1001)
    mid = 0.5 * (window[0] + window[1])
    if args.out:
        np.savez(args.out, omega=ws, dos_ptr=dos(ws), t_ptr=t_ptr)
    print(f"PTR DOS({mid:g} eV) = {float(dos(mid)):.6f}")
    return dos


if __name__ == "__main__":
    main()
