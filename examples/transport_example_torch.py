"""Optical conductivity at fixed filling on the PyTorch port (``autobzcore_torch``).

The flow of ``examples/transport_example.py``, the kinetic coefficients of
the application paper the reference cites (SciPost Phys. 15, 062 (2023)):

1. the model: a Wannier90 t2g Hamiltonian (``--hr svo_hr.dat --wout
   svo.wout``, on the full zone), or ``--flagship``, the synthetic 3-band
   series of the SrVO3 footprint on the full zone;
2. the (H, dH) spectral velocity pack on the npt^3 grid, built once (kernels
   K11 and K18 in chunks, with ``eigh``);
3. the chemical potential at ``--filling`` electrons per cell by
   ``ElectronCountSolver.find_mu``, bisection on the pack's eigenvalues
   (kernel K20, one launch a step);
4. the optical conductivity kernel sigma_ab(Omega) at ``--nomega``
   frequencies in [0, ``--omega-max``] eV by the adaptive Fermi-window
   frequency integral (``alpha=0``, chunks of 8 frequencies, every GK trip
   one launch of kernel K19), then the alpha=1 thermoelectric numerator at
   Omega = 0.

The computation runs on the CUDA card unless ``--device cpu`` is given.

Usage:
    python examples/transport_example_torch.py --flagship [--npt 60] [--beta 40]
        [--eta 5e-3] [--nomega 32]
    python examples/transport_example_torch.py --hr svo_hr.dat --wout svo.wout
"""
import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", help="torch device (default cuda; cpu on request)")
    p.add_argument("--flagship", action="store_true",
                   help="the synthetic 3-band series on the full zone instead of --hr/--wout")
    p.add_argument("--hr", default="svo_hr.dat")
    p.add_argument("--wout", default="svo.wout")
    p.add_argument("--npt", type=int, default=60)
    p.add_argument("--eta", type=float, default=5e-3)
    p.add_argument("--beta", type=float, default=40.0, help="1/kT in 1/eV")
    p.add_argument("--filling", type=float, default=1.0, help="electrons/cell")
    p.add_argument("--nomega", type=int, default=32)
    p.add_argument("--omega-max", type=float, default=2.0, help="eV")
    p.add_argument("--abstol", type=float, default=1e-5)
    p.add_argument("--out", default=None, help="write omega, sigma, mu and A1 to this .npz")
    args = p.parse_args(argv)

    import torch

    from autobzcore_torch import FBZ, load_bz
    from autobzcore_torch.models.observables import spectral_velocity_pack
    from autobzcore_torch.models.transport import ElectronCountSolver, KineticCoefficientSolver

    device = torch.device(args.device)
    if args.flagship:
        from autobzcore_torch.models.tight_binding import flagship_series

        h = flagship_series(device=device)
        bz = load_bz(FBZ(), np.eye(3))
        label = "synthetic 3-band flagship series"
    else:
        if not (os.path.exists(args.hr) and os.path.exists(args.wout)):
            p.error(f"{args.hr} / {args.wout} not found; pass --flagship for the synthetic model")
        from autobzcore_torch.io.wannier90 import hamiltonian_fourier_series, read_w90_hrdat

        hr = read_w90_hrdat(args.hr)
        h = hamiltonian_fourier_series(hr, device=device)
        bz = load_bz(FBZ(), args.wout)
        label = f"{hr['num_wann']}-band Wannier model"
    print(f"loaded {label}, {bz}, on {device}", file=sys.stderr)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t0 = time.perf_counter()
    pack = spectral_velocity_pack(h, bz, args.npt)  # built once, shared below
    ec = ElectronCountSolver(h, bz, args.npt, pack=pack)
    mu = ec.find_mu(args.filling, args.beta)
    sync()
    t_mu = time.perf_counter() - t0
    print(f"mu(n={args.filling}, beta={args.beta}) = {mu!r} eV [{t_mu:.3f} s incl. spectral build]; "
          f"n(mu) = {ec(mu, args.beta)!r}")

    t0 = time.perf_counter()
    kc = KineticCoefficientSolver(h, bz, args.npt, eta=args.eta, beta=args.beta, alpha=0, mu=mu, pack=pack)
    omegas = np.linspace(0.0, args.omega_max, args.nomega)
    sigma = kc.sweep(omegas, abstol=args.abstol)
    sync()
    t_sig = time.perf_counter() - t0
    print(f"sigma(Omega) sweep: {args.nomega} frequencies in {t_sig:.3f} s ({kc.numevals} GK integrand "
          f"evals, chunks of 8, certified={kc.retcode})")
    print(f"  sigma_xx(0)   = {float(sigma[0, 0, 0])!r}")
    print(f"  sigma_xx(max) = {float(sigma[-1, 0, 0])!r}")

    kc1 = KineticCoefficientSolver(h, bz, args.npt, eta=args.eta, beta=args.beta, alpha=1, mu=mu, pack=pack)
    a1 = kc1(np.array([0.0]), abstol=args.abstol)[0]
    print(f"  alpha=1 numerator A1_xx(0) = {float(a1[0, 0])!r} (thermopower ~ A1/A0; {kc1.numevals} evals, "
          f"certified={kc1.retcode})")

    if args.out:
        np.savez(args.out, omegas=omegas, sigma=sigma, mu=mu, a1=a1, beta=args.beta, eta=args.eta,
                 npt=args.npt)
        print(f"wrote {args.out}")
    return {"mu": mu, "omegas": omegas, "sigma": sigma, "a1": a1, "numevals": kc.numevals,
            "retcode": kc.retcode}


if __name__ == "__main__":
    main()
