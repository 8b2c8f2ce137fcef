"""Topological observables end to end on the PyTorch port (``autobzcore_torch``).

The modes of ``examples/topology_example.py``: the Haldane phase diagram,
a full Berry and magnetization characterization at one point, the
Kane-Mele quantum spin Hall response, the Z2 invariant from Wilson loops,
and a Weyl slice-Chern scan. Each model's (H, dH) grid is built once
(``models.berry``: kernel K21 in row slabs), and every observable is a
zone average (kernel K24); the lattice Chern numbers run kernel K22 and the
Wilson loops kernel K23.

The computation runs on the CUDA card unless ``--device cpu`` is given.

Usage:
  python examples/topology_example_torch.py phase      [--n 13] [--npt 24]
  python examples/topology_example_torch.py point      [--npt 96] [--t2 0.1]
  python examples/topology_example_torch.py spin-hall  [--npt 72]
  python examples/topology_example_torch.py z2         [--npt 48]
  python examples/topology_example_torch.py weyl       [--npt 24] [--nkz 21]
"""
import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("mode", choices=("phase", "point", "spin-hall", "weyl", "z2"), nargs="?", default="phase")
    p.add_argument("--device", default="cuda", help="torch device (default cuda; cpu on request)")
    p.add_argument("--n", type=int, default=13, help="phase-diagram grid per axis")
    p.add_argument("--npt", type=int, default=24)
    p.add_argument("--t2", type=float, default=0.1)
    p.add_argument("--nkz", type=int, default=21)
    p.add_argument("--out", default="topology.npz")
    args = p.parse_args(argv)

    import torch

    from autobzcore_torch import FBZ, load_bz
    from autobzcore_torch.models.berry import BerryCurvatureSolver, lattice_chern
    from autobzcore_torch.models.tight_binding import tb_haldane, tb_kane_mele_sz, tb_weyl

    device = torch.device(args.device)
    bz2 = load_bz(FBZ(), np.eye(2))
    t0 = time.time()
    result = {}

    if args.mode == "phase":
        # Chern number of the lower Haldane band over the (phi, M/t2) plane;
        # the exact boundary is |M| = 3 sqrt(3) t2 |sin phi|
        phis = np.linspace(-np.pi, np.pi, args.n)
        Ms = np.linspace(-6 * args.t2, 6 * args.t2, args.n)
        C = np.zeros((args.n, args.n))
        for i, phi in enumerate(phis):
            for j, M in enumerate(Ms):
                h = tb_haldane(t2=args.t2, phi=float(phi), M=float(M), device=device)
                C[i, j] = round(lattice_chern(h, bz2, args.npt, bands=[0]))
        print(f"phase diagram {args.n}x{args.n} at npt={args.npt}: {time.time() - t0:.1f}s")
        print("C(phi, M) rows phi=-pi..pi, cols M=-6t2..6t2:")
        for row in C.astype(int):
            print("".join({-1: "-", 0: ".", 1: "+"}[v] for v in row))
        np.savez(args.out, phis=phis, Ms=Ms, C=C)
        result = {"phis": phis, "Ms": Ms, "C": C}

    elif args.mode == "point":
        h = tb_haldane(t2=args.t2, phi=np.pi / 2, M=0.0, device=device)
        slv = BerryCurvatureSolver(h, bz2, npt=args.npt)
        C = slv.chern()
        I = slv.ahc(mu=0.0)
        e = slv.pack.e.cpu().numpy()
        lo, hi = e[:, 0].max(), e[:, 1].min()
        M1 = float(slv.orbital_magnetization(mu=lo + 0.1)[0, 1])
        M2 = float(slv.orbital_magnetization(mu=lo + 0.3)[0, 1])
        lc = lattice_chern(h, bz2, 12)
        D = slv.berry_curvature_dipole(mu=hi + 0.3, beta=40.0)
        g = slv.quantum_metric().cpu().numpy()
        Om = slv.pack.Om[:, :, 0, 1].cpu().numpy()
        detg = g[..., 0, 0] * g[..., 1, 1] - g[..., 0, 1] ** 2
        bound = float((detg - (Om / 2) ** 2).min())
        print(f"Haldane t2={args.t2}: C = {C.round(6)}, gap = [{lo:.4f}, {hi:.4f}]")
        print(f"  I_xy = {float(I[0, 1])!r}  (C/2pi = {float(C[0] / 2 / np.pi)!r})")
        print(f"  dM/dmu in gap = {(M2 - M1) / 0.2!r}  (Streda: {float(C[0] / 2 / np.pi)!r})")
        print(f"  Wilson-loop C (npt=12): {lc:.1f}")
        print(f"  BCD max|D| (metallic mu): {np.abs(D).max():.3e}  (inversion-symmetric at M=0 -> ~0)")
        print(f"  metric-curvature bound: min(det g - (Om/2)^2) = {bound:.2e} (>= 0)")
        print(f"{time.time() - t0:.1f}s")
        result = {"C": C, "I": I, "slope": (M2 - M1) / 0.2, "lattice_chern": lc, "D": D, "bound": bound}

    elif args.mode == "spin-hall":
        h = tb_kane_mele_sz(lam_so=args.t2, M=0.0, device=device)
        slv = BerryCurvatureSolver(h, bz2, npt=args.npt)
        Sz = np.diag([0.5, 0.5, -0.5, -0.5])
        I_c = float(slv.ahc(mu=0.0)[0, 1])
        I_s = float(slv.operator_hall(Sz, mu=0.0)[0, 1])
        print(f"Kane-Mele lam_so={args.t2}: charge I_xy = {I_c:.2e} (TRS -> 0), "
              f"spin I^sz_xy = {I_s!r} (C_s/2pi = {-1 / 2 / np.pi!r})")
        print(f"{time.time() - t0:.1f}s")
        result = {"I_c": I_c, "I_s": I_s}

    elif args.mode == "z2":
        from autobzcore_torch.models.berry import wilson_loop_spectrum, z2_invariant
        from autobzcore_torch.models.tight_binding import tb_kane_mele

        z2s = []
        for lam_r, M, label in ((0.0, 0.0, "Sz-conserving, topological"), (0.05, 0.0, "Rashba, topological"),
                                (0.05, 0.8, "Rashba, trivial")):
            h = tb_kane_mele(lam_so=0.06, lam_r=lam_r, M=M, device=device)
            z2s.append(z2_invariant(h, args.npt if args.npt > 24 else 48))
            print(f"Kane-Mele lam_r={lam_r}, M={M} ({label}): Z2 = {z2s[-1]}")
        th = wilson_loop_spectrum(tb_kane_mele(lam_so=0.06, lam_r=0.05, device=device), 48)
        np.savez(args.out, centers=th)
        print(f"Wannier-center flow (48 rows) -> {args.out}; {time.time() - t0:.1f}s")
        result = {"z2": z2s, "centers": th}

    else:  # weyl
        h = tb_weyl(m=2.0, device=device)
        kzs = np.linspace(0.0, 0.5, args.nkz)
        Cs = [lattice_chern(h.contract(float(kz)), bz2, args.npt, bands=[0]) for kz in kzs]
        print("Weyl slice Chern C(kz) (nodes at kz = +-1/4):")
        for kz, c in zip(kzs, Cs):
            print(f"  kz={kz:+.3f}: {c:+.1f}")
        np.savez(args.out, kzs=kzs, C=np.asarray(Cs))
        print(f"{time.time() - t0:.1f}s")
        result = {"kzs": kzs, "C": np.asarray(Cs)}
    return result


if __name__ == "__main__":
    main()
