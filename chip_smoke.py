#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``autobzcore_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, one or a few lines of output each (a failing phase ends the run
non-zero):

1. device: the card's name and power limit (nvidia-smi) and torch's name;
2. build: every CUDA kernel from ``autobzcore_torch/csrc`` with nvcc (one
   compiler per source, in parallel), timed, with the DMMA (FP64
   tensor-core) instructions that ``cuobjdump --dump-sass`` finds in K1's
   and K11's entries and in K19's and K27's m = 3 sums (every K19 entry and
   both K27 sums must hold some);
3. kernels K1, K2: first, every entry of K1 and K11 must hold DMMA
   instructions; then each against its plain PyTorch version on the card,
   in FP64, at stated tolerances; K1 and K2 run twice must be
   bit-identical; kernel and plain times at the flagship shapes (K = 1e6
   points, W = 264), K1's and K2's shares of their bounds, K1's library
   time (``torch.matmul`` of the precomputed phases); K2's every 33rd lane
   alone bit-equal to the 264-lane launch's, and K2 at a late AutoPTR
   rung's shape (8 lanes on the npt=400 grid's 6.4e7 points from K1,
   checked against the plain version on its first 2^20 points, 1e-10),
   its time, share of its bytes bound and per-pair time against W = 264;
4. PTR main path: the flagship PTR leg at full width through the public
   entry points (synthetic 3-band series on the full zone, PTR(npt=100),
   eta = 0.05, SweepSolver(chunk=264) under hchebinterp over [-6, 7] eV,
   atol 1e-2), with K1/K2's launch counts, a sum-rule check of the
   interpolant and a check of D at 5 frequencies against the plain path;
5. cubic IBZ: tb_integer(3) on CubicSymIBZ against the full zone (PTR);
6. kernels K3, K4, K5: each against its plain version at the shapes of the
   IAI main path (33 frequencies: 990 mid and 29,700 leaf lanes), with
   kernel, plain and (K3) ``torch.matmul`` times; K5's start at the leaf
   pools' 29,700 x 64 and its step at the mid level's 990 x 64 (nbisect
   1), the outermost level's 33 x 2048 and at nbisect 4, identical pools
   and picks, by events with the host's us, device time, and beside the
   step ``torch.matmul`` by [wk, wk - wg] and ``torch.topk``, each with its
   bound; K3 also at the outer
   level's shape (33 lanes on one coefficient set), both shapes
   bit-identical on repeat, with the device time of K3, K4 and of
   ``torch.matmul`` from torch.profiler beside the time of a call (which
   the host's enqueue sets at these sizes) and K3's share of its bound;
   then the fused leaf solve (``gk_leaf_dos_solve``) against the trip
   route (K5's start for the first picks, then K4 and K5's step) on the
   same 29,700 started leaf
   pools: pools, totals, counts, active and every lane's trips identical;
   and against its plain version (the trip route on the plain kernels):
   lanes on the same path with totals within 1e-12 of their l1, at most
   1 % of the lanes on another path (within the two error estimates);
   the solve's device time (torch.profiler) and host time a call beside
   the trip route's wall, device time, launches and host tests;
7. IAI main path: the flagship cold IAI leg at full width,
   IAI(inner_cap=64, inner_nbisect=4) under SweepSolver(abstol=1e-3,
   chunk=33, scan=True) at 33 frequencies in [-6, 7] eV, eta = 0.05, with
   K3/K4's, K5's by entry (one step a mid or outer trip, at most 3,900 in
   all) and the fused solve's launch counts, the leaf's launches,
   trips, host syncs, the device's busy share (nvidia-smi's utilization)
   and peak memory; checks: the retcode, the trip route's 7,280,048,325
   evals, 1 frequency against the same solve on the plain versions (within
   abstol) and all 33 against PTR(npt=400) (within 1e-2 max|D|);
8. cubic IBZ through IAI: tb_integer(3) on CubicSymIBZ against the full
   zone at 4 frequencies, eta = 0.1, abstol 1e-3 (within 2 abstol);
9. kernels K6 (coarsening) and K5's seed entry against their plain versions
   on the card: pools from phase 10's first call (the carried outer pool,
   cap 2048, and the harvest's mid pool, cap 64) and random dyadic pools;
   identical pools required; kernel and plain times. It runs between phase
   10's two calls, whose launch counts exclude it;
10. warm IAI main path: the flagship IAI leg as the reference runs it by
   default, IAI(inner_cap=64, inner_nbisect=4, warm_width=8) under
   SweepSolver(abstol=1e-3, chunk=33, scan=True, warm=True): call 1 at the
   33 frequencies of phase 7, call 2 at their 32 midpoints (the next
   interpolation frontier), seeded from the pools call 1 left; wall, evals
   against phase 7's cold chunk, trips, syncs, launches of K3-K6 and the
   fused solve, leaf launches, busy share (nvidia-smi); checks:
   retcodes, evals (``IAI_WARM_NUMEVALS``), values within 2 abstol of
   phase 7's, both calls against
   PTR(npt=400), and a 2-frequency warm chain on the plain versions against
   the kernels (identical counts and carried pools, values within abstol);
11. kernels K7 (fused eigenvalue + Lorentzian tail of a full-grid slab), K8
   (Lorentzian sum) and K9 (closed-form small eigenvalues), each against its
   plain version at the main path's shapes: K7 on one slab of the npt=400
   rung of phase 12 at 1024 omegas (bit-identical on repeat), K9 on the
   flagship's 1e6 matrices of the 100^3 grid (and numpy on a subsample), K8
   on their eigenvalues at 1000 omegas; kernel, plain and (K9) library times;
12. full-grid main path: the flagship's full-grid ladder at full width,
   LorentzianFullGrid(0.05, nmin=400, nmax=2000) over 1000 omegas in
   [-6, 7] eV, abstol 1e-3, through DOSProblem/init/dos_sweep; wall, rungs
   (npt, seconds, delta), evals, K7 launches, the stage products' time and
   peak memory; checks: the retcode, the npt=400 rung at phase 7's 33
   omegas against phase 7's PTR(npt=400) (within 1e-10 max|D|), a second
   sweep at the 999 midpoints replaying the certifying pair, and an npt=64
   rung through the plain tail against the kernel (1e-12);
13. bench lane: H(k) of the flagship on the 100^3 grid (``evaluate_grid``)
   and its eigenvalues by K9, k-points/s over 20 chained repetitions, then
   the 1000-omega Lorentzian sweep over [10, 15] eV at eta 0.01 by K8;
14. kernel K10 (the tetrahedron DOS and N(E)) against its plain version: the
   flagship's eigenvalue grid at npt=100, 1001 energies over [-6, 7] eV
   (the plain N(E) on a 64-energy subset), and d = 1, 2 at small shapes;
   max relative error <= 1e-12, bit-identical on repeat; kernel, plain and
   bound times;
15. LTM main path: the flagship LTM(npt=100) on the full zone through
   DOSProblem/init/dos_sweep at 1001 energies, nos_sweep, fermi_level(1.5);
   init and sweep walls, K10 launches, peak memory; checks: the band count
   of the DOS's integral (2e-2), N(7 eV) = 3 (1e-12), N monotone, dN/dE
   against D away from the band edges (5e-2), tb_integer(3) on CubicSymIBZ
   against the full zone (npt 60, E 0.8, 1e-12), 5 energies against the
   plain path (1e-12); then a Fermi-level step's one-energy N(E) call (K10
   and its column sum) by events and by device time;
16. K4 over an omega block (W = 2, 4) and K5 at V = W (the blocked leaf
   start and mid step at nbisect 4) against their plain versions at the
   IAI main path's lane shapes: 1e-12 of l1, identical pools; kernel (by events and device time) and plain times; the fused
   leaf solve over the block against the trip route and its plain
   version as in phase 6;
17. omega-block IAI main path: phase 7's 33 frequencies, cold, under
   SweepSolver(abstol=1e-3, chunk=36, scan=True, block=W) at W = 2 and 4,
   three walls each beside phase 7's; evals per omega, trips, syncs, K4
   block and fused solve launches, leaf launches, busy share (nvidia-smi,
   first wall), peak memory; checks: retcodes, evals
   (``BLOCK_NUMEVALS``), values within 2 abstol of phase 7's, all 33 within 1e-2 max|D| of PTR(npt=400), and a
   2-frequency warm block chain on the plain versions against the kernels
   (identical counts and block certificates, values within abstol);
18. the repairs: the PTR leg of synthetic_wannier(4) at npt=60 over 264
   omegas through eigvalsh + K8 against the plain path (1e-10 relative),
   the route timed by events (cuSOLVER's share, K8's, the plain trace
   path's) beside its bound, and K2 with its grid capped at 7 block rows against the uncapped launch
   at 1e6 k-points, bit for bit;
19. kernels K11 (the series Jacobian at points), K12 (band velocities) and
   K13 (GGR's box sum and the Gaussian sum) against their plain versions at
   the main path's shapes: K11 on the flagship's 1e6 points of the 100^3 grid
   (at order zero bit-equal to K1, bit-identical on repeat, its share of
   its bound; library time ``torch.matmul`` of the precomputed derivative
   phases) and on one bands30 init chunk, K12 on
   eigh's vectors of one init chunk at m = 3 and m = 30 (library time one
   ``torch.einsum``), K13 in both modes on the flagship's spectral grid at
   1001 energies over [-6, 7] eV and in box mode at the bands30 shape; max
   relative error <= 1e-12, bit-identical on repeat; kernel, plain and bound
   times; K12's fused entry (the eigensolve in registers) at the flagship's
   1e6 points and on hard matrices at m = 1, 2, 3 (exactly degenerate pairs,
   gaps of 1e-9 of the scale, scalar and zero H): energies against its
   mirror ``eigh3_jacobi`` (1e-13 of the energy scale) and cuSOLVER's
   (1e-12), velocities against the mirror's eigenvectors' (1e-13 of
   max|v|) and cuSOLVER's by each band's gap g (1e-13 / g of max|v| for g
   >= 1e-6, a cluster's sum to 1e-12 below), bit-identical repeats; its time
   three ways at 1e6 points and a 4,096-point chunk, plain, library (eigh,
   then ``torch.einsum``) and bound;
20. GGR main path: the flagship GGR(npt=100) on the full zone through
   DOSProblem/init/dos_sweep at phase 15's 1001 energies, then
   AdaptiveGaussianBroadening(npt=100); init and sweep walls, K11-K13
   launches (each init one K11 and one fused K12 launch, and no cuSOLVER
   eigh call, or the phase fails), the init by event time beside the time
   cuSOLVER's eigh would take over its chunks, peak memory,
   eigh's time and one call's memory in calls of EIGH_CHUNK and of 16,384;
   checks: both DOS integrate to 3 bands (2e-2), GGR against phase 15's LTM
   DOS 0.3 eV from the band edges (3e-2 of max|D|), tb_integer(3) GGR(npt=60)
   on CubicSymIBZ against the full zone (E 0.8, 1e-12), tb_graphene
   GGR(npt=200) against the exact curve at the reference's energies (1e-2),
   5 energies against the plain path (1e-12);
21. BASELINE config 5: synthetic_wannier(30, nr=5), GGR(npt=60) on the
   inversion wedge (29,791 points x 30 bands), 1000 energies over [-8, 8];
   init and sweep walls, cuSOLVER's share, eigh's chunk trade-off as in 20;
   checks: finite, non-negative,
   integral 30 within 5 %, 5 energies against the plain path (1e-12);
22. kernels K14 (the Genz-Malik box rule), K15 (the box rule fused with the
   DOS trace), K16 (the box-pool select and update) and K17 (the fixed
   rule's reduction) against their plain versions at the main path's
   shapes: K14/K15 on one TAI trip (33 lanes x 8 boxes x 33 nodes of the
   flagship, dead boxes with a NaN integrand at their nodes), K16 on 33
   lanes x cap 4096 x d = 3 with planted ties, K17 at phase 24's fixed
   level (33 x 201 nodes); K14 bit-equal to its plain version (val, err
   and splitdim), K15 1e-12 of the value scale, identical splitdim and
   pools, bit-identical repeats; kernel, plain, bound and library times
   (``torch.matmul`` by [wk, we] for K14, ``torch.einsum`` for K17); K14's
   device time (torch.profiler) and the host time of its call, of the bare
   ctypes launch and of ``torch.matmul``;
23. TAI main path: the flagship's DOS by TAI() (HCubatureJL, cap 4096,
   nbisect 4) under SweepSolver(abstol=1e-3, chunk=33, scan=True) at phase
   7's 33 frequencies, three walls; trips, host syncs, launches of K1, K15
   and K16, per-lane numevals and retcodes, peak memory; checks: kernels
   against plain_kernels=True on every lane (identical numevals, retcodes
   and pools, values within 1e-12), unconverged lanes count 33 + 1023 x 8 x
   33 = 270,105 evals, two frequencies alone equal their lanes, the
   reference's 2-D case (synthetic_wannier(2, nr=3, ndim=2, seed=3), eta
   0.8, omega 0.3, abstol 1e-5) certifies within 5e-5 of PTR, TAI's unit
   measure on the full zone and the inversion wedge (1e-6; K14's path);
   the converged lanes against PTR(npt=400) as a reading;
24. fixed rules: the flagship's DOS by IAI with trapz(npt=201) on the
   outermost coordinate and AuxQuadGKJL on the other two (inner_cap 64,
   inner_nbisect 4) under SweepSolver(abstol=1e-3, chunk=33, scan=True),
   cold, at the 33 frequencies: wall, evals, trips, syncs, K17 launches,
   peak memory, D against PTR(npt=400) as a reading (the fixed rule
   certifies nothing); one frequency against the plain versions (identical
   counts, 1e-12); QuadratureFunction alone on the reference's interface
   cases, EvalCounter's counts, AbsoluteEstimate's 25 evals and a fixed
   leaf under an adaptive level;
25. kernels K18 (the band-pair velocity pack), K19 (the Lorentzian-pair
   transport contraction) and K20 (the Fermi count) against their plain
   versions at the transport main path's shapes: K18 on the flagship's
   npt=60 grid (216,000 points), K19 on its pack at 64 equal frequencies, at
   a 960-node trip with Omega != 0, at a scalar self-energy and at the
   B11d shape (256 equal lanes on the npt=100 pack, 1e6 points), K20 at
   five (mu, beta), beta = inf twice; 1e-12 relative, bit-identical
   repeats; kernel (by events and, for K19, device time by torch.profiler),
   plain, bound and library times (the reference's two ``torch.einsum``
   for K18, ``torch.matmul`` of the materialized pair rows by Wmat for K19,
   at 64 and at 960 rows);
26. transport main path: ``examples/transport_example.py``'s flow at full
   width: the flagship on the full zone, spectral_velocity_pack(npt=60),
   ElectronCountSolver.find_mu at filling 1 and beta 40,
   KineticCoefficientSolver(eta=5e-3, alpha=0).sweep over 32 Omegas in
   [0, 2] eV (abstol 1e-5, chunk 8), then alpha=1 at Omega=0; walls, peak
   memory, find_mu's steps, numevals, retcodes, GK trips, host syncs and the
   launches of K11, K18, K19 and K20; checks: the pack (1e-12) and mu (1e-9,
   also from the cheap K1 + K9 build) against the plain routes, one Omega by
   the kernel and the plain route (identical numevals and retcode, 1e-10),
   K19 at (w, w) over the window against TransportSolver (1e-10),
   tb_integer(3) on the CubicSymIBZ against the full zone (1e-10), n(7 eV,
   beta = inf) = 3 exactly, and both phases within 60 s;
27. kernels K21 (the band-pair terms), K22 (the FHS plaquette flux), K23
   (the Wilson loops) and K24 (the weighted zone average) against their
   plain versions at the topology main path's shapes: K21 on the Haldane
   grid at npt 1024 (1,048,576 points, m = 2, d = 2, in one launch and in
   the build's first 2^18-point row slab, whose times the entry reports),
   one slab of the Weyl build (d = 3) and one of the Kane-Mele build (m =
   4) in all three modes (1e-12 of each field's scale); K22 and K23 on the Haldane
   frames at npt 24 and 1024 (1e-12); K24 on the Weyl pack at npt 192 in
   every weight mode (1e-13 of the terms' scale); bit-identical repeats;
   kernel, plain, bound and library times (the reference's two
   ``torch.einsum`` for K21, ``torch.einsum`` of precomputed weights for
   K24, both also by torch.profiler's device time);
28. topology main path: ``examples/topology_example.py``'s modes at full
   width: point (Haldane at npt 1024: build wall, peak memory, K21
   launches; Chern = -+1 to 1e-8, AHC = C/2pi to 1e-8, Streda slope to
   1e-9, the BCD, the metric bound at -1e-12, lattice Chern at npt 12 and 1024 integer
   to 1e-12), weyl (tb_weyl(2) at npt 192, 7,077,888 points: build and
   query walls, peak memory; I_xy = -1/4pi within 1e-4, I_xz, I_yz below
   1e-12, the 21-slice Chern scan at npt 24), spin-hall (Kane-Mele at npt
   1024, m = 4: |I_c| < 1e-12, I^sz_xy = -1/2pi to 1e-8, a repeat
   bit-equal), phase (the 13 x 13 diagram at npt 24 against the exact
   boundary), flux (``berry_flux_integrand`` under PTR(48), IAI, TAI and an
   IAI sweep over mu against the same solves on the CPU: 1e-10, equal
   counts), z2 (1, 1, 0), and the plain route (the Haldane pack at npt
   128 and a certified Chern ladder on both routes: 1e-12, the same
   rungs); launches of K21-K24, and both phases within 60 s;
29. kernels K25 (the Lindhard bubble), K26 (the Cooper bubble), K27 (the
   self-energy DOS trace: trace and diagonal sums, pointwise) and K28 (the
   self-energy transport distribution: sums at equal and unequal
   frequencies, pointwise) against their plain versions at the main path's
   shapes: K25 and K26 on the flagship's 64^3 grid (100 omegas, and K25
   at every 12th of them, 9 omegas, bit-equal to the 100-omega launch's;
   q = 0 and (1/4, 0, 0) for K26), K27 on the 100^3 grid at 1000 omegas with the
   tabulated Fermi-liquid Sigma and at 64 lanes of Sigma = -1e-3 i, half on
   an eigenvalue of some H_k (each lane also alone, bit-equal), at the
   PTR(48) points (one Z, one per point, on poles) and at the largest leaf
   trip of phase 30's IAI solve, each timed by events, by the profiler's
   device time and on the host, K28 on the 100^3
   grid at 256 equal frequencies, 32 unequal pairs and a kinetic trip's 960
   unequal pairs (whose first 32 rows must be the 32-pair launch's bits)
   and at the PTR(24) points; then both above three bands (Gauss-Jordan in place of the
   closed forms) on a 4-band synthetic_wannier model on the 64^3 grid, K27
   at 64 frequencies in both modes and K28 at 32 equal and 32 unequal
   pairs; 1e-12 of the value scale, bit-identical repeats; kernel, plain
   and bound times;
30. the Lindhard and matrix self-energy main paths at the reference
   record's sizes (BASELINE.md:369-392), the flagship on the full zone:
   LindhardSolver(npt=64, beta 40, phase 26's mu, eta 0.01) and its map of
   33 q = (j/64, 0, 0) by 100 omegas in [0, 4] eV (build wall and peak
   memory, map wall, max Im chi0 over omega > 0 at 1e-12), cooper_bubble at
   beta 40 and 80, certified_chi0 at q = (1/4, 0, 0) (rungs multiples of
   4) with K25 timed alone at each rung's grid and 9 omegas;
   SigmaDOSSolver(npt=100) at 1000 omegas in [-6, 7] eV with a
   tabulated causal Fermi-liquid Sigma on 2001 frequencies, then
   project=True (its sweep's wall alone; rows sum to the total, 1e-12),
   Sigma = -0.05i against the
   PTR DOS (K2, 1e-10), the DOS integrand under PTR(48) and under IAI on
   tb_integer(3) on the cubic wedge against the CPU (1e-10, equal counts);
   SigmaTransportSolver(npt=100) at 256 omegas (wall, peak memory,
   symmetry, positive diagonal), Sigma = -0.005i at npt 60 against
   TransportSolver (1e-9), the transport integrand under PTR(24) against
   the CPU (1e-10); SigmaKineticCoefficientSolver at npt 100, beta 40, 8
   Omegas in [0, 2] eV, alpha 0 then 1 (the step's wall split into the
   solvers' grid builds, K28's device time summed over its launches by
   CUDA events, and the rest; pairs per launch, GK trips, numevals and
   retcodes, which must be SE_KIN_NUMEVALS and SE_KIN_RETCODES), Sigma =
   -0.05i against KineticCoefficientSolver (1e-9, equal numevals and
   retcodes); launches of K25-K28, and both phases within 60 s;
31. K29 (the k-path spectral map) on the flagship path Gamma-X-M-Gamma-R-X
   at npts 1000 (3,787 points) x 4,001 omegas and on config 5's 30 bands,
   K30 (band expectations) fused with eigh2 on Haldane, with the three
   orbital projectors on the flagship and on Kane-Mele with Rashba coupling,
   K31 (the transport distribution at points) at the largest leaf trip of
   phase 32's Kane-Mele IAI solve (m = 4, the only shape the path sends its
   first entry), its fused entry (the eigensolve in registers) at that of
   the graphene solve and on hard matrices at m = 1, 2, 3 against the plain
   route (eigh, then K31's plain version; 1e-12), timed three ways beside
   the integrand's call and eigh_chunked, K27's matrix mode on the flagship's 1e6
   points x 264 lanes z = w + i eta (its trace against K2; 64 lanes at eta
   1e-3, half on poles, each also alone; the general route, a Z matrix a
   lane, on 32) and its pointwise entry at the PTR(48) points (one z, one
   per point, Z matrices, poles) and at the largest leaf trip of phase 32's
   graphene IAI solve of spectral_function, each against its plain version
   (1e-12, bit-identical repeats) with kernel, plain, library and bound
   times, K27's by events, by the profiler's device time and on the host;
32. the slice's paths at full width on the flagship over the full zone: the
   1000-omega DOS by sweep_solve's batched AutoPTR ladder (a=0.1, nmin 100,
   nmax 500, abstol 1e-3; wall, rungs with their active lanes, retcodes,
   peak memory; every lane against PTR at its last rung at 1e-12, five
   lanes through one scalar IntegralSolver with identical counts and flags,
   certified lanes against phase 12's certified ladder: within 2e-3 where
   they stopped at npt 400 or later; earlier lanes beyond 2e-3 at most 1 %
   of them, each with its rung table and PTR at npt 500 within 2e-3) and
   AutoPTR_IAI at one omega with both counts; the transport integrand under
   PTR(100) at 256 omegas against TransportSolver (1e-12) and under AutoPTR
   up to npt 300 at 32 omegas, tb_integer(3) on the cubic wedge against the
   full zone (1e-8) and under IAI card against CPU (1e-10, equal counts,
   walls): graphene and a 3-band model (synthetic_wannier(3, nr=3, ndim=2,
   seed=3), abstol 1e-3) with one fused K31 launch a trip and no cuSOLVER
   eigh call, and Kane-Mele (m = 4) on eigh and K31; spectral_function under PTR(100) at 264 omegas (its trace
   against the PTR DOS, 1e-12; Hermitian, 1e-14) and batched under IAI on
   graphene card against CPU; the k-path's band structure, spectral map
   (its sum rule on a wide grid) and projector expectations (summing to
   1, 1e-12) on the flagship and config 5 (against numpy's eigvalsh); the
   launches of K27's matrix mode and K29-K31, and both phases within 60 s.

With ``--profile``, the PTR, IAI, warm IAI, full-grid, LTM, block IAI,
GGR, TAI, transport and topology main paths, the Lindhard map, the
self-energy DOS sweep, the AutoPTR ladder and the k-path spectral map each
run once more under ``torch.profiler`` (after their checks),
which prints their device busy time, its share of the wall and the device
time of the leading kernels, or "not captured" where the profiler recorded
no device time (late in a long ``--profile`` run it has recorded none).
``--phases-fourier`` runs phases 1-4, 6a (K3), phase 19's K11 and phase
32's AutoPTR DOS ladder alone, the PTR leg once more under torch.profiler
for K2's device time and the ladder for K1's and K2's device time per rung
and their shares, and prints a JSON object of their numbers
(``"fourier"``) before the last line: about 3 minutes with the build, the
quick before/after run for the Fourier-evaluation kernels and K2
(``tools/kernel_ab.py --phases fourier`` runs the same phases on another
checkout's package). ``--phases-29-30`` runs phases 1-2 and 29-30 alone (phase 26's chemical
potential is found again first), so that with ``--profile`` the last two
profiles are the process's first; ``--phases-31-32`` runs phases 1-2 and
31-32 alone (without phase 12, so the AutoPTR lanes are not held against
its ladder), profiling the AutoPTR ladder and the k-path spectral map.
``--phases-22-26`` runs phases 1-2, 22 (at phase 7's 33 frequencies) and
25-26 alone and prints their numbers (``"rule_transport"``: K14's call,
K19's four cases, the sweep's wall and counts) as a JSON object before the
last line (``tools/kernel_ab.py --phases rule_transport`` runs the same
phases on another checkout's package).

The second-to-last line is a JSON object with each kernel's numbers, the
last line ``{"ok": true, "device": {...}}``. Without CUDA, or without the
package beside it, the script exits non-zero and prints no result.
``tools/kernel_ab.py --phases iai`` runs phases 6-10, 16-17 and phase 27's
K24 on another checkout's package (one block wall each).
"""
import json
import math
import os
import subprocess
import sys
import time

ETA = 0.05
NPT = 100
W_FLAGSHIP = 264
WINDOW = (-6.0, 7.0)
IAI_OMEGAS = 33  # one SweepSolver chunk of the IAI leg
IAI_ABSTOL = 1e-3
IAI_NUMEVALS = 7_280_048_325  # phase 7's cold chunk, as the trip route counts it
# phase 10's two warm calls, and phase 17's block chunks by width. The first
# warm call's count moves with K4's last bits: before K4's node arithmetic
# became the function it shares with the fused solve it counted
# 5,666,197,230 (the same inputs, values within 1.2e-14)
IAI_WARM_NUMEVALS = (5_692_670_790, 5_629_264_980)
BLOCK_NUMEVALS = {2: 8_492_924_835, 4: 10_453_783_125}
K5_COLD_MAX = 3900  # K5's launches in phase 7's cold chunk: one start a pool, one step a trip
# the least time the card could take: NVIDIA's data sheet for the H100 SXM
# at 700 W, FP64 outside the tensor cores, and FP64 on the tensor cores
# (DMMA) for the functions that are matrix products (K1, K11: the phase
# matrix by the coefficients; K12: dH_j by the eigenvectors; K19: the pair
# products by Wmat), which a library product runs there; K1, K11 and K19
# run theirs there too
PEAK_FP64 = 34e12
PEAK_FP64_MMA = 67e12
PEAK_BYTES = 3.35e12
# FP64 operations (an FMA counts 2) of Im Tr (z - H)^-1 by the closed forms
# of csrc/small_trace.cuh, per matrix: m = 1, 2, 3
TRACE_FLOPS = {1: 9, 2: 27, 3: 120}
# K2's form at m = 3 (csrc/dos_trace.cu), the cheapest exact form it uses:
# per (lane, k) pair the shifts d_i 6, A = d0 d1 - p01 8, d0 + d1 2, A - q
# 2, S 8, det (six complex products in one chain) 24, Im(S conj det) 3,
# |det|^2 3, the reciprocal 8, the quotient and the weighted sum 3: 67; per
# k its invariants (three products p_ij 18, the cyclic term 26, q 2): 46.
# The first count, TRACE_FLOPS[3] + 2 = 122 a pair, stays beside it.
DOS3_PAIR_FLOPS, DOS3_K_FLOPS = 67, 46
# phase 3's K2 at a late AutoPTR rung's shape: 8 lanes on the npt = 400
# grid (6.4e7 points), checked against the plain version on its first 2^20
DOS_RUNG_NPT, DOS_RUNG_LANES, DOS_RUNG_SLICE = 400, 8, 1 << 20
# names of K2's kernels in a profile (its pairs and its second pass; the
# parent design's names too, for tools/kernel_ab.py) and of K1's
K2_KERNELS = ("dos_pairs_kernel", "dos_partials_kernel", "lane_sum_kernel<double>", "column_sum_kernel<double>")
K1_KERNELS = ("fourier_points",)
# FP64 operations of one Lorentzian term eta / ((w - e)^2 + eta^2) summed
# with its weight (csrc/lorentzian.cuh): a subtraction (1), an FMA (2), the
# reciprocal, counted as the four DFMAs of its Newton sequence (8), and the
# FMA into the sum (2)
LORENTZ_FLOPS = 13
# FP64 operations of one closed-form 3x3 eigenvalue solve
# (csrc/small_eigen.cuh): ~60 multiplies and adds, a square root and three
# divisions at 8 each, and arccos and two cosines at ~40 each
EIG3_FLOPS = 210
# FP64 operations (an FMA counts 2) of the register eigensolver
# (csrc/small_eigen.cuh eigh_rn), a division or square root counted 8: the
# Hermitian part 4 an off-diagonal; m = 2 (eigh2) 67; m = 3 ||H||_F^2 19, a
# rotation 154 (|h_pq|^2 3, two square roots and three divisions, the
# tangent's and the phase's products 16, and four pairs of the (x, y) update,
# 20 each) or 4 where it is skipped, the sort 3. The rotations that fire
# depend on the data: the count takes all 15 of the five sweeps, the most
# they can need, and is an upper bound.
EIGH_ROTATION_FLOPS = 154


def eigh_rn_flops(m):
    from autobzcore_torch.ops.eigh3 import JACOBI_SWEEPS

    load = 4 * m * (m - 1) // 2
    return load + {1: 0, 2: 67, 3: 19 + 3 * JACOBI_SWEEPS * EIGH_ROTATION_FLOPS + 3}[m]


def k12_eigh_flops(m, d):
    """K12's fused entry a point: the eigensolve, then d m quadratic forms,
    5 a diagonal term and 12 an upper pair (w, the two sums, two FMAs)."""
    return eigh_rn_flops(m) + d * m * (5 * m + 12 * m * (m - 1) // 2)


def k31_eigh_flops(m, d):
    """K31's fused entry a point: the eigensolve; per direction the
    Hermitian part, T = S U (2 + 8 (m - 1) an entry) and the upper triangle of
    U^H T (8 m an entry); m Lorentzians; the d (d + 1) / 2 sums (4 a band, 6
    an upper pair)."""
    per_a = 4 * m * (m - 1) // 2 + m * m * (2 + 8 * (m - 1)) + m * (m + 1) // 2 * 8 * m
    return eigh_rn_flops(m) + d * per_a + m * LORENTZ_RECIP_FLOPS + d * (d + 1) // 2 * (4 * m + 6 * m * (m - 1) // 2)
FULLGRID_OMEGAS = 1000
FULLGRID_ABSTOL = 1e-3
FULLGRID_NMIN, FULLGRID_NMAX = 400, 2000  # the ladder; phase 7's PTR runs at FULLGRID_NMIN
FULLGRID_PLAIN_NPT = 64  # the rung held against the plain tail
LTM_ENERGIES = 1001
# FP64 operations of K10's work (csrc/tetra_dos.cu): the support test, two
# compares once for each (simplex, band) term (outside its support a term
# is a constant), and ~30 for each (energy, term) pair inside the support
# (the piece's compares, a dozen multiply-adds and a division counted as 8)
TETRA_TEST_FLOPS, TETRA_SUPPORT_FLOPS = 2, 30
# FP64 operations of K13's work (csrc/ggr_dos.cu), an FMA counted as 2: in
# box mode two compares per (k, band) term for its support and ~30 per
# (energy, term) pair inside the support (the branch compares, a dozen
# multiplies and adds, a division counted as 8); in Gaussian mode 28 per
# pair whose exp does not underflow, in the form the kernel runs: x = (E -
# e) * (1 / sigma) (2), its square and the test against 1500 (2), -x^2 / 2
# (1), exp_neg (20: an FMA and a subtraction for n, two FMAs for r, six for
# the polynomial, the table's factor), the norm and the weight (2), the add
# into the sum (1). The first count, 40 a pair (a division, 8; libdevice's
# exp, ~25; the scaling and the sum), stays beside it.
GGR_TEST_FLOPS, GGR_SUPPORT_FLOPS, GAUSS_PAIR_FLOPS, GAUSS_PAIR_FLOPS_FIRST = 2, 30, 28, 40
GAUSS_UNDERFLOW = 1500.0  # t^2 above which K13 drops exp(-t^2 / 2) as 0.0
# K13's times before its redesign (the former tile loop, PERF.md's kernel
# table; NVIDIA H100 80GB HBM3, 700 W), printed beside phase 19's
K13_PARENT_MS = {"box": 2.9444, "gauss": 10.9326, "box30": 0.7536}
# names of K13's kernels in a profile (its passes, and the former design's
# for tools/kernel_ab.py): a call's device time without the wrapper's sort
K13_KERNELS = ("ggr_partials_kernel", "ggr_few_kernel", "lane_sum_kernel", "energy_partials_kernel",
               "column_sum_kernel")
# BASELINE config 5: synthetic_wannier(30, nr=5), GGR(npt=60) on the
# inversion wedge, 1000 energies over [-8, 8]
BANDS30, BANDS30_NPT, BANDS30_ENERGIES, BANDS30_WINDOW = 30, 60, 1000, (-8.0, 8.0)
EIGH_CAP = 16384  # the most matrices cuSOLVER's batched eigh took a call on an H100
BLOCKS = (2, 4)  # omega-block widths of phases 16-17
BLOCK_CHUNK = 36  # phase 17's SweepSolver chunk: 33 frequencies and their pads
BLOCK_WALL_RUNS = 3
TAI_RUNS = 3  # phase 23's walls
TAI_TRIPS = 1023  # phase 23's trips: an unconverged lane fills its cap-4096 pool
UNCONVERGED_EVALS = 33 + TAI_TRIPS * 8 * 33  # the evals of such a lane
FIXED_NPT = 201  # phase 24's trapezoid rule on the outermost coordinate
FIXED_OMEGAS = IAI_OMEGAS
# phases 25-26, examples/transport_example.py's defaults: the flagship on the
# full zone, npt 60, eta 5e-3, beta 40, filling 1, 32 Omegas in [0, 2] eV,
# abstol 1e-5
TR_NPT, TR_ETA, TR_BETA, TR_OMEGAS, TR_OMEGA_MAX, TR_ABSTOL = 60, 5e-3, 40.0, 32, 2.0, 1e-5
# FP64 operations of one Lorentzian g / ((y - e)^2 + g^2) / pi as K19's
# function needs it (csrc/transport_gamma.cu): a subtraction, an FMA (2),
# one reciprocal counted as the four DFMAs of its Newton sequence (8) and a
# multiply by the width, 1/pi folded into scale (K19 itself forms 1 / (x^2 +
# g^2) by rcp.approx and two Newton steps, 9 operations and an SFU op, and
# applies (g1 / pi)(g2 / pi) once per pair and chunk)
LORENTZ_RECIP_FLOPS = 12
# FP64 operations of one K20 term at finite beta: the subtraction and the
# multiply, exp (~25), the add and the division (8), the weight's multiply
# and the sum
FERMI_TERM_FLOPS = 38
# phases 27-28, examples/topology_example.py's workloads at the sizes the
# reference's record ran them (BASELINE.md:352-366): the Haldane build and
# Chern number at npt 1024 (1,048,576 points) and the Weyl 3-D AHC at npt
# 192 (7,077,888 points, slab-streamed)
BERRY_NPT = 1024
WEYL_NPT = 192
# phases 29-30, the sizes of the reference record's Lindhard and matrix
# self-energy runs (BASELINE.md:369-392) on the flagship over the full zone:
# a 33-q x 100-omega chi0 map on the 64^3 grid, 1000-omega SigmaDOSSolver
# and 256-omega SigmaTransportSolver sweeps on the 100^3 grid, with a
# tabulated Fermi-liquid Sigma on 2001 frequencies in [-8, 8] eV
LH_NPT, LH_BETA, LH_ETA, LH_NQ, LH_OMEGAS, LH_OMEGA_MAX = 64, 40.0, 0.01, 33, 100, 4.0
SE_NPT, SE_OMEGAS, SE_TR_OMEGAS, SE_SIGMA_POINTS = 100, 1000, 256, 2001
# the kinetic step on the other legs' npt-100 grid, 8 Omegas
SE_KIN_NPT, SE_KIN_OMEGAS = 100, 8
# the pairs of a full kinetic GK trip: 8 Omegas x 8 new intervals x 15 nodes
SE_TRIP_PAIRS = 960
# the kinetic step's evaluations at alpha 0 and 1, and their retcodes (alpha 1
# fills its interval cap at this abstol), as K28's parent design counted them
SE_KIN_NUMEVALS, SE_KIN_RETCODES = [38_400, 58_800], [True, False]
# phase 29's step above three bands: a 4-band synthetic_wannier model on
# the 64^3 grid, 64 frequencies for K27 and 32 pairs for K28
M4_BANDS, M4_NPT, M4_OMEGAS, M4_PAIRS = 4, 64, 64, 32
# FP64 operations (an FMA counts 2, a complex product 6, a complex sum 2, a
# real division or reciprocal 8) of K25's term (csrc/lindhard_chi0.cu: x =
# w + de, x^2 + eta^2, a / den, two sums) and of a point's overlaps (8 m^3)
# with |O|^2, df and de (6 m^2)
CHI0_TERM_FLOPS = 14
# K26 per (k, n): two subtractions, the sum, the test, 1 - f1 - f2, the division, the sum
COOPER_FLOPS = 16
# What the self-energy functions need for a general 3x3 M = Z - H, counted
# from their cheapest forms (the kernels do more):
# - Im Tr M^-1 = Im(S / det), S the sum of the principal 2x2 minors: M 18,
#   det by cofactors 64 (its first cofactor is one of the minors), the two
#   other minors 28, S 4, the imaginary part of the quotient 15 (|det|^2 3,
#   reciprocal 8, Im(S conj(det)) 3, product 1), the weighted sum 2: 131;
# - Im [M^-1]_ii, i < 3: M 18, det 64, the two other minors 28, |det|^2 and
#   its reciprocal 11, Im(C_ii conj(det)) / |det|^2 three times 12, the
#   weighted sums 6: 139;
# - the complex Tr M^-1 of the pointwise entry: M 18, det 64, minors 28, S
#   4, the complex quotient 19 (reciprocal 13, product 6): 133;
# - the Hermitian A' = i (G - G^H): M 18, det 64, the six adjugate entries
#   det does not hold 84, the reciprocal of det 13, the six off-diagonal G
#   entries 36 and the three Im G_jj 9, the three independent off-diagonal
#   entries of A' 6: 230.
GEN_TRACE_FLOPS, GEN_DIAG_FLOPS, GEN_POINT_FLOPS, SPECTRAL3_FLOPS = 131, 139, 133, 230
# K27's forms at m = 3 since its redesign (csrc/sigma_trace.cu), H Hermitian:
# - the trace sum per (w, k): on the FP64 tensor cores det M's real and
#   imaginary rows over the record's 20 rows (80) and e2 M's over 12 (48):
#   128; on the CUDA cores |det|^2 3, the guard's interval test 2, the
#   reciprocal 8, the weight's product 1, Im(e2 conj det) 3, the sum 2: 19;
#   per k its record (H's and adj H's reals, det H, e2 H, two norms): 130
#   (the pairs the guard redoes take M formed directly, not counted);
# - the diagonal sum per (w, k): det M 80 and three minors over 4 rows each
#   (3 x 16) on the tensor cores: 128; on the CUDA cores 14 as above and per
#   minor its constants adj Z_ii and adj H_ii 3, Im(minor conj det) 3, the
#   sum 2: 38; per k its record 130;
# - the pointwise trace: M 15, five cofactors 70, det 22, e2 4, the complex
#   quotient 19 (|det|^2 3, reciprocal 8, e2 conj det 6, two products 2): 130;
# - the matrix mode on z per (w, k): the shifts 3, det in shifts 17, c = w /
#   det 14 (|det|^2 3, reciprocal 8, three products), S0 2, S1 and S2 (six
#   diagonal complex-by-real products and twelve off-diagonal real FMAs each,
#   4 flops a product) 72: 108; per k its record: 90;
# - the matrix points on z: M 3, nine cofactors 126, det 22, its reciprocal
#   13, G 54, the nine entries of A' / (2 pi) 36: 254; at m = 2 (graphene):
#   M 2, det 14, its reciprocal 13, G 24, A' 16: 69.
K27_TRACE_MMA_FLOPS, K27_TRACE_FLOPS, K27_DIAG_MMA_FLOPS, K27_DIAG_FLOPS, K27_SUM_K_FLOPS = 128, 19, 128, 38, 130
K27_POINT_FLOPS = 130
K27_SPECTRAL_Z_FLOPS, K27_SPECTRAL_K_FLOPS, K27_SPECTRAL_POINT_FLOPS, K27_SPECTRAL_POINT2_FLOPS = 108, 90, 254, 69
# K27 at eta = 1e-3 (phases 29 and 31): constant Sigma = -1e-3 i on 64 lanes,
# half of them on an eigenvalue of some H_k, where the trace's guard redoes
# its pairs from M formed directly
K27_POLE_ETA, K27_POLE_LANES = 1e-3, 64
# phases 31-32: the k-path Gamma-X-M-Gamma-R-X at npts 1000 (3,787 points)
# with 4,001 omegas in [-6, 7] eV; the reference's north-star workload, the
# 1000-omega DOS by a batched AutoPTR ladder (BASELINE.md:35,104-116), on
# the flagship at eta 0.05 and abstol 1e-3, rungs 100-500; the transport
# integrand under PTR(100) at 256 omegas and under AutoPTR up to npt 300 at
# 32; the matrix spectral function under PTR(100) at 264 omegas
KPATH_VERTICES = ((0, 0, 0), (0.5, 0, 0), (0.5, 0.5, 0), (0, 0, 0), (0.5, 0.5, 0.5), (0.5, 0, 0))
KPATH_NPTS, KPATH_OMEGAS, KPATH_POINTS = 1000, 4001, 3787
AUTOPTR_KW, AUTOPTR_OMEGAS, AUTOPTR_ABSTOL, AUTOPTR_SCALAR_LANES = dict(a=0.1, nmin=100, nmax=500), 1000, 1e-3, 5
TR_AUTOPTR_KW, TR_AUTOPTR_OMEGAS, TR_PTR_OMEGAS = dict(a=0.1, nmin=100, nmax=300), 32, 256
# the certified AutoPTR lanes against phase 12's ladder: within twice the
# abstol where a lane stopped at npt AUTOPTR_HELD_NPT or later; lanes that
# stopped earlier may lie beyond it (the certificate is the change between
# two rungs), at most AUTOPTR_EARLY_SHARE of the certified lanes
AUTOPTR_HELD_NPT, AUTOPTR_EARLY_SHARE = 400, 0.01
# FP64 operations of K30 per (point, band): O u (m^2 complex multiply-adds,
# 8 each) and the real part of u^H (O u) (2 m); of K27's matrix mode per
# (frequency, point) at m = 3: the Hermitian A' (SPECTRAL3_FLOPS) and the
# weighted sums of its m^2 real parameters (2 each); of K31 per point: the
# band basis U^H dH_a U (d m^2 sums of 2 m complex multiply-adds), m
# Lorentzians and the d (d + 1) / 2 weighted sums of m^2 real products (4
# each, with the two weights)
def expect_flops(m):
    return 8 * m * m + 2 * m


def transport_point_flops(m, d):
    return d * m * m * 16 * m + m * LORENTZ_RECIP_FLOPS + d * (d + 1) // 2 * 6 * m * m


def general_flops(m, what):
    """FP64 operations per (frequency, point) above three bands, from an LU
    factorization (m^3 / 3 complex multiply-adds, 8 operations each) of M =
    Z - H (2 m^2): for "trace" and "diag" the inverse's diagonal (another
    m^3 / 3 multiply-adds) and the weighted sums; for "spectral" the whole
    inverse (2 m^3 / 3 more) and the m (m - 1) / 2 independent off-diagonal
    entries of A'."""
    lu = 2 * m * m + 8 * m**3 / 3
    if what == "trace":
        return lu + 8 * m**3 / 3 + m + 2
    if what == "diag":
        return lu + 8 * m**3 / 3 + 2 * m
    return lu + 16 * m**3 / 3 + m * (m - 1)


def product_flops(m):
    """FP64 operations of v_c A for Hermitian v_c and A, whose diagonals are
    real: m^2 entries of m products (m^3 - 2 m^2 + m complex by complex, 6
    each; 2 (m^2 - m) complex by real, 2 each; m real by real, 1 each) and
    m - 1 complex sums (2 each)."""
    return 6 * (m**3 - 2 * m * m + m) + 4 * (m * m - m) + m + 2 * m * m * (m - 1)


def pair_flops(m, d, same, spectral=SPECTRAL3_FLOPS):
    """FP64 operations of K28's function per (pair, point): the spectral
    functions and the products v_c A (one of each at equal frequencies, v_a
    A1 and v_c A2 at unequal ones), then the traces Re Tr[(v_a A1)(v_c
    A2)], m^2 real parts of products with their sums (4 each) and the
    weighted sum (2) each: for the d (d + 1) / 2 pairs a <= c at equal
    frequencies, where the trace is symmetric in (a, c), and for all d^2 at
    unequal ones."""
    n, pairs = (1, d * (d + 1) // 2) if same else (2, d * d)
    return n * (spectral + d * product_flops(m)) + pairs * (4 * m * m + 2)


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def cuda_ms(fn, reps):
    """Mean milliseconds of ``fn()`` over ``reps`` runs, by CUDA events,
    after one warm-up run."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def host_us(fn, reps):
    """Mean host microseconds that one ``fn()`` takes to return (its enqueue,
    with no synchronization in the timed loop), over ``reps`` runs after one
    warm-up run: the time a call costs where the device is the faster."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * t / reps


def device_ms(fn, reps, name=None):
    """Mean device milliseconds of the kernels ``fn()`` launches (those whose
    name holds ``name``, or one of a tuple of names, where given), over
    ``reps`` runs under torch.profiler (the sum of their kernel times,
    without the gaps between launches that the host's enqueue leaves), after
    one warm-up run; None where the profiler recorded no device time, or
    fewer kernels for the ``reps`` runs than ``reps`` times those of one
    run (late in a long process it has been seen to drop records)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    names = (name,) if isinstance(name, str) else name

    def run(n):
        with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages() if getattr(e, "device_type", None) == DeviceType.CUDA
                and (names is None or any(k in e.key for k in names))]
        return sum(e.self_device_time_total for e in rows), sum(e.count for e in rows)

    fn()
    torch.cuda.synchronize()
    _, one = run(1)
    total, count = run(reps)
    return total / reps / 1e3 if total > 0 and one > 0 and count == one * reps else None


class SmiBusy:
    """The device's busy share while the block runs, from nvidia-smi's
    ``utilization.gpu`` (the share of each sample period in which a kernel
    ran) sampled every 200 ms: ``share`` after the block, None where
    nvidia-smi gave no sample. It costs the run nothing, unlike the
    profiler, whose processing of a leg's millions of launch events takes
    longer than the leg."""

    def __enter__(self):
        self.share, self.samples = None, 0
        try:
            self.proc = subprocess.Popen(["nvidia-smi", "--query-gpu=utilization.gpu", "--format=csv,noheader,nounits",
                                          "-lms", "200"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        except OSError:
            self.proc = None
        return self

    def __exit__(self, *exc):
        if self.proc is None:
            return False
        self.proc.terminate()
        try:
            out, _ = self.proc.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            out, _ = self.proc.communicate()
        vals = [float(v) for v in out.split() if v.replace(".", "", 1).isdigit()]
        if vals:
            self.share, self.samples = sum(vals) / len(vals) / 100, len(vals)
        return False

    def text(self):
        return "not sampled" if self.share is None else f"{100 * self.share:.1f} % ({self.samples} samples)"


def leaf_solve_launches(reset=False):
    """The fused leaf solve's launch count (zeroed with ``reset``)."""
    from autobzcore_torch.models import observables as obs

    if reset:
        obs.gk_leaf_dos_solve.launches = 0
    return obs.gk_leaf_dos_solve.launches


def k5_launches(reset=False):
    """K5's launches by entry (``gk_pool_start``, ``gk_pool_step``,
    ``gk_pool_seed``), zeroed with ``reset``."""
    from autobzcore_torch.ops import adaptive as tad

    if reset:
        for key in tad.gk_pool_launches:
            tad.gk_pool_launches[key] = 0
    return {f"gk_pool_{k}": v for k, v in tad.gk_pool_launches.items()}


def k5_random_pool(np, torch, dev, rng, L, cap, nb, V=()):
    """Pools of L lanes at cap with planted error ties, lanes with n <
    nbisect, stopped lanes and lanes without room, their totals by the plain
    version."""
    from autobzcore_torch.ops import adaptive as tad

    n = torch.as_tensor(rng.integers(1, cap - nb + 3, L), device=dev)
    if nb > 1:
        n[: L // 20] = torch.as_tensor(rng.integers(1, nb, L // 20), device=dev)
    live = torch.arange(cap, device=dev)[None, :] < n[:, None]
    zero = torch.zeros((), dtype=torch.float64, device=dev)
    a0 = torch.where(live, torch.as_tensor(rng.random((L, cap)), device=dev), zero)
    b0 = torch.where(live, a0 + torch.as_tensor(rng.random((L, cap)), device=dev), zero)
    err = torch.where(live, torch.as_tensor(rng.integers(0, 6, (L, cap)) * 0.125, device=dev), zero)
    val = torch.where(live.reshape((L, cap) + (1,) * len(V)),
                      torch.as_tensor(rng.normal(size=(L, cap) + V), device=dev), zero)
    pool = tad.GKPool(a=a0, b=b0, err=err, l1=2 * err, val=val.contiguous(), n=n,
                      evals=torch.as_tensor(rng.integers(0, 2000, L).astype(np.float64), device=dev),
                      atol=torch.as_tensor(rng.random(L) * 4, device=dev), rtol=1e-3, max_evals=1500.0,
                      active=torch.as_tensor(rng.random(L) > 0.05, device=dev))
    tad.gk_pool_totals_plain(pool)
    return pool


def k5_tree_sum(torch, x):
    """Each lane's sum of x (L, cap) in the pool kernels' order: entry v of
    256 sums slots v, v + 256, ... in order, then a halving tree."""
    L, cap = x.shape
    n = -(-cap // 256) * 256
    e = torch.zeros((L, n), dtype=x.dtype, device=x.device)
    e[:, :cap] = x
    e = e.reshape(L, n // 256, 256)
    s = e[:, 0]
    for k in range(1, n // 256):
        s = s + e[:, k]
    w = 128
    while w:
        s = s[:, :w] + s[:, w:2 * w]
        w //= 2
    return s[:, 0]


def k5_same(got, want, picks):
    """(identical, totals rel, max abs d) of a kernel's pool ``got`` and the
    plain version's ``want``: identical pools, n, evals and live flags (and
    picks), got's totals bit for bit the sums in the kernels' tree order;
    rel: the totals' and tolerance's largest difference from the plain
    version's (another order) relative to each lane's sum of magnitudes."""
    import torch

    keys = ("a", "b", "err", "l1", "val", "n", "evals", "active") + (("idx", "ca", "cb") if picks else ())
    same = all(torch.equal(getattr(got, k), getattr(want, k)) for k in keys)
    L, cap = got.a.shape
    val = got.real_val().reshape(L, cap, -1)
    real = lambda t: (torch.view_as_real(t) if t.is_complex() else t).reshape(L, -1)  # noqa: E731
    tv, rv = real(got.tot_val), real(want.tot_val)
    same = (same and torch.equal(got.tot_err, k5_tree_sum(torch, got.err))
            and all(torch.equal(tv[:, f], k5_tree_sum(torch, val[:, :, f].contiguous())) for f in range(val.shape[2])))
    mag_e, mag_v = got.err.sum(1).clamp_min(1e-300), val.abs().sum(1).clamp_min(1e-300)
    d_e, d_v, d_t = (got.tot_err - want.tot_err).abs(), (tv - rv).abs(), (got.tol - want.tol).abs()
    rel = max(float((d_e / mag_e).max()), float((d_v / mag_v).max()),
              float((d_t / (got.atol + got.rtol * mag_v.norm(dim=1)).clamp_min(1e-300)).max()))
    return same, rel, max(float(d_e.max()), float(d_v.max()), float(d_t.max()))


def k5_shape(np, torch, dev, rng, label, L, cap, nb, V=(), entry="step", reps=30):
    """K5 at one of the path's shapes against its plain version, then timed:
    ``entry`` "start", a cold start of L pools from one reduced child a lane
    (the leaf pools' start: K4's outputs on one segment, no picks), or
    "step", a pool started as it stands (with picks) and a trip's step from
    the live lanes' node values with per-node counts (the mid and outer
    levels' form), the plain version taking them reduced by the reduction
    alone (the step's bits). Identical pools, n, evals, live flags and
    picks, the totals in the kernels' order and within 1e-14 of the plain
    version's (relative to each lane's sum of magnitudes); times by events
    with the host's us a call,
    device time, the plain version, and beside the step `torch.matmul` of
    its node values by [wk, wk - wg] (the reduction) and `torch.topk` of the
    pool's errors (the select); the bound by bytes."""
    from autobzcore_torch.ops import adaptive as tad

    xk, wk, wg = tad.gk_rule(7, dev)
    P = xk.shape[0]
    f64 = dict(dtype=torch.float64, device=dev)
    base = k5_random_pool(np, torch, dev, rng, L, cap, nb, V)
    if entry == "start":
        a0 = torch.as_tensor(rng.random((L, 1)) * 0.5, **f64)
        b0 = a0 + 0.5
        kids = tad.ReducedChildren(torch.as_tensor(rng.normal(size=(L, 1) + V), **f64),
                                   torch.as_tensor(rng.random((L, 1)), **f64), torch.as_tensor(rng.random((L, 1)), **f64),
                                   torch.full((L,), 2.0 * P, **f64))
        got = tad._empty_pool(L, cap, V, torch.float64, dev, base.atol, 1e-3, None)
        want = tad._empty_pool(L, cap, V, torch.float64, dev, base.atol, 1e-3, None)
        tad.gk_pool_start(got, nb, a0, b0, kids, select=False)
        tad.gk_pool_start_plain(want, nb, a0, b0, kids, select=False)
        same, rel, err = k5_same(got, want, picks=False)
        again = tad._empty_pool(L, cap, V, torch.float64, dev, base.atol, 1e-3, None)
        tad.gk_pool_start(again, nb, a0, b0, kids, select=False)
        rep_same, rep_rel, _ = k5_same(got, again, picks=False)
        same = same and rep_same and rep_rel == 0.0
        run = lambda: tad.gk_pool_start(got, nb, a0, b0, kids, select=False)  # noqa: E731
        run_p = lambda: tad.gk_pool_start_plain(want, nb, a0, b0, kids, select=False)  # noqa: E731
        t = {"ms": cuda_ms(run, reps), "device_ms": device_ms(run, reps, "gk_pool_start"),
             "host_us": host_us(run, reps), "plain_ms": cuda_ms(run_p, 5), "library_ms": None}
        b = bound(0, nbytes(a0, b0, *kids[:4]) + nbytes(got.a, got.b, got.err, got.l1, got.val)
                  + L * (8 * (3 + max(1, math.prod(V))) + 1))
    else:
        got, want = base.clone(), base.clone()
        tad.gk_pool_start(got, nb)
        tad.gk_pool_start_plain(want, nb)
        same0, rel0, _ = k5_same(got, want, picks=True)
        live = want.active.nonzero().squeeze(1)
        _, half = tad.gk_nodes(want.ca[live], want.cb[live], xk)
        fx = torch.as_tensor(rng.normal(size=(live.numel(), 2 * nb, P) + V), **f64)
        cnt = torch.as_tensor(rng.integers(100, 5000, (live.numel(), 2 * nb, P)).astype(np.float64), **f64)
        kids = tad.NodeChildren(fx, cnt, half.contiguous(), live, wk, wg)
        reduced = tad.ReducedChildren(*tad.gk_rule_reduce(fx, cnt, kids.half, wk, wg), live)
        plain_red = tad.gk_rule_reduce_plain(fx, cnt, kids.half, wk, wg)
        e_red = max(float((g - w).abs().max()) for g, w in zip(reduced[:3], plain_red[:3]))
        tad.gk_pool_step(got, nb, kids)
        tad.gk_pool_step_plain(want, nb, reduced)
        same, rel, err = k5_same(got, want, picks=True)
        same = same and same0 and e_red <= 1e-12 * float(plain_red[2].max())
        rel = max(rel, rel0)
        err = max(err, e_red)

        reps = min(reps, (cap - 2) // nb - 2)

        def timing_pool(begin=tad.gk_pool_start):
            # room for every timed step of one timing in every live lane (n
            # at most 2), no budget, a tolerance of 0: repeated steps keep
            # the same lanes live
            out = base.clone()
            out.n.clamp_(max=2)
            out.max_evals = 1e300
            out.atol.zero_()
            out.active[live] = True
            begin(out, nb)
            return out

        def stepper(pool, step=tad.gk_pool_step, children=kids):
            return lambda: step(pool, nb, children)

        W5 = torch.stack([wk, wk - wg], dim=1)
        fxp = fx.movedim(2, -1)  # the nodes last
        t = {"ms": cuda_ms(stepper(timing_pool()), reps),
             "device_ms": device_ms(stepper(timing_pool()), reps, "gk_pool_step"),
             "host_us": host_us(stepper(timing_pool()), reps),
             "plain_ms": cuda_ms(stepper(timing_pool(tad.gk_pool_start_plain), tad.gk_pool_step_plain, reduced),
                                 min(reps, 5)),
             "library_ms": cuda_ms(lambda: torch.matmul(fxp, W5), reps),
             "library_device_ms": device_ms(lambda: torch.matmul(fxp, W5), reps),
             "topk_ms": cuda_ms(lambda: torch.topk(base.err, nb, dim=1), reps)}
        # the live lanes' bytes only (the step reads no other lane): their
        # children's node values and counts; each pool's err and val (the
        # totals and the next picks); the picks and children read and the
        # next written; the picked parents' a and b; the children written to
        # the pool; n, evals and active read and written, atol read, the
        # totals and tol written
        La, Vd = live.numel(), max(1, math.prod(V))
        b = bound(La * 2 * nb * P * Vd * 6,
                  nbytes(fx, cnt, kids.half, live) + La * cap * (1 + Vd) * 8 + 2 * La * (8 * nb + 16 * 2 * nb)
                  + La * nb * 16 + La * 2 * nb * (4 + Vd) * 8 + La * (8 * (7 + Vd) + 2))
    if not (same and rel <= 1e-14):
        fail(f"K5 {entry} at {label} ({L} lanes x cap {cap}, nbisect {nb}, V {V}) vs its plain version: "
             f"identical {same}, totals rel {rel:.3e}")
    t.update(L=L, cap=cap, nb=nb, V=V, rel=rel, err=err, bound=b)
    print(f"K5 {entry} at {label} ({L} lanes x cap {cap}, nbisect {nb}, V {V}): identical pools, n, evals, live "
          f"flags{' and picks' if entry == 'step' else ''} to the plain version, totals in the tree order, rel "
          f"{rel:.3e} of their magnitudes (<= 1e-14); "
          f"{t['ms']:.4f} ms a call by events (device {ms_text(t['device_ms'])}, host {t['host_us']:.1f} us; plain "
          f"{t['plain_ms']:.4f}; bound {b[0]:.5f} ms by {b[1]})"
          + ("" if entry == "start" else
             f"; torch.matmul by [wk, wk - wg] {t['library_ms']:.4f} ms (device {ms_text(t['library_device_ms'])}), "
             f"torch.topk {t['topk_ms']:.4f}"), flush=True)
    return t


def leaf_launches(launches, stats):
    """The IAI leaf level's launches: K4 (the pools' starts, and on the trip
    route every trip) and the fused solve's where it ran; on the trip route
    a leaf trip adds K5's step to K4."""
    k4 = launches.get("gk_leaf_dos", launches.get("gk_leaf_dos_block", 0))
    solve = launches["gk_leaf_dos_solve"]
    pool = 0 if solve else stats.trips.get(1, 0)
    return {"K4": k4, "solve": solve, "K5": pool, "total": k4 + solve + pool}


def warm_iai_sweep(prob, chunk, plain=False):
    """Phase 10's warm IAI sweep of ``prob`` (``plain`` on the plain
    versions of every kernel)."""
    from autobzcore_torch import IAI
    from autobzcore_torch.parallel.sweep import SweepSolver

    return SweepSolver(prob, IAI(inner_cap=64, inner_nbisect=4, warm_width=8, plain_kernels=plain),
                       abstol=IAI_ABSTOL, chunk=chunk, scan=True, warm=True)


def ms_text(v):
    """A device time from :func:`device_ms` for a printed line."""
    return "not captured" if v is None else f"{v:.4f} ms"


def profile(label, fn, events=False):
    """Run ``fn()`` under torch.profiler and print the device busy time (the
    sum of kernel and copy times on the one stream), its share of the wall
    and the leading kernels by device time; "not captured" where the
    profiler recorded no device time. Returns the wall, the busy time and
    the kernels' (name, count, device microseconds), or None; with
    ``events`` also each device event's (name, start, microseconds) in
    start order (``"events"``, None where the profiler gave none)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    avgs = prof.key_averages()
    # device-side events only: an aten op's own row repeats its kernels' time
    dev_rows = [e for e in avgs if getattr(e, "device_type", None) == DeviceType.CUDA]
    rows = [(e.key, e.count, e.self_device_time_total)
            for e in (dev_rows or [e for e in avgs if not e.key.startswith("aten::")])
            if e.self_device_time_total > 0]
    busy = sum(r[2] for r in rows) / 1e6
    if not dev_rows or busy <= 0.0:
        print(f"profile {label}: wall {wall:.3f} s (profiled), device busy not captured (the profiler recorded "
              f"{len(dev_rows)} device-side rows and no device time)", flush=True)
        return None
    top = sorted(rows, key=lambda r: -r[2])[:8]
    kernels = sum(n for k, n, _ in rows if not k.startswith(("Memcpy", "Memset")))
    print(f"profile {label}: wall {wall:.3f} s (profiled), device busy {busy:.4f} s "
          f"({100 * busy / wall:.2f} %), {kernels} kernel launches; top: " + "; ".join(
              f"{k[:48]} x{n} {t / 1e3:.3f} ms" for k, n, t in top), flush=True)
    out = {"wall": wall, "busy": busy, "rows": rows, "kernel_launches": kernels}
    if events:
        try:
            evs = sorted(((e.name, e.time_range.start, e.time_range.elapsed_us()) for e in prof.events()
                          if getattr(e, "device_type", None) == DeviceType.CUDA), key=lambda e: e[1])
        except (AttributeError, RuntimeError):
            evs = []
        out["events"] = evs or None
    return out


def device_sum_ms(prof, names):
    """Device milliseconds of the kernels whose name holds one of ``names``
    in a :func:`profile` result (None where it is None)."""
    if prof is None:
        return None
    return sum(t for k, _, t in prof["rows"] if any(n in k for n in names)) / 1e3


def ladder_split(events):
    """Per rung of a profiled AutoPTR DOS ladder, K1's and K2's device
    milliseconds: from the device events in start order, each launch of
    K2's pair kernel opens a rung; K1's launches before it and K2's second
    pass after it belong to that rung. None without events."""
    if not events:
        return None
    rungs, k1 = [], 0.0
    for name, _, us in events:
        if any(n in name for n in K2_KERNELS[:2]):
            rungs.append({"k1_ms": k1 / 1e3, "k2_ms": us / 1e3})
            k1 = 0.0
        elif any(n in name for n in K2_KERNELS[2:]) and rungs:
            rungs[-1]["k2_ms"] += us / 1e3
        elif any(n in name for n in K1_KERNELS):
            k1 += us
    return rungs or None


def ptxas_report(log):
    """From nvcc's ``-Xptxas -v`` report (one ``<source>:`` block per
    source): per source its entry functions, their most registers and
    their spill stores in bytes; and for K27-K31 (sigma_*.cu,
    spectral_path.cu, band_expect.cu, transport_points.cu) each entry
    function's registers, stack frame and spill stores, named with its
    template arguments."""
    import re

    per_source, sigma = [], []
    for block in re.split(r"\n(?=\S+\.cu:\n)", log):
        head, _, body = block.partition(":\n")
        if not head.endswith(".cu"):
            continue
        entries = re.findall(r"Compiling entry function '(\S+)'.*?\n.*?\n\s*(\d+) bytes stack frame, (\d+) bytes "
                             r"spill stores.*?\n.*?Used (\d+) registers", body)
        if not entries:
            continue
        per_source.append(f"{head} {len(entries)}, {max(int(e[3]) for e in entries)}, "
                          f"{sum(int(e[2]) for e in entries)} B")
        if head.startswith(("sigma_", "spectral_path", "band_expect", "transport_points")):
            for name, stack, spill, used in entries:
                m = re.search(r"_cu_[0-9a-f]{8}(\d+)", name)
                short = name
                if m:
                    n0 = m.end()
                    short = name[n0:n0 + int(m.group(1))]
                    rest = name[n0 + int(m.group(1)):]
                    if rest.startswith("I"):
                        args = re.findall(r"L[ib](\d+)E", rest[:rest.find("EE") + 2] if "EE" in rest else rest)
                        short += "<" + ",".join(args) + ">"
                sigma.append(f"{short} {used}, {stack} B, {spill} B")
    return per_source, sigma


def dmma_split(counts):
    """DMMA instructions of K1's entries (``fourier_points_kernel<TN, false>``)
    and of K11's (``<TN, true>``): (entries, instructions) each."""
    k1 = [n for name, n in counts.items() if "Lb0E" in name]
    k11 = [n for name, n in counts.items() if "Lb1E" in name]
    return (len(k1), sum(k1)), (len(k11), sum(k11))


def dmma_text(counts):
    (e1, n1), (e11, n11) = dmma_split(counts)
    return (f"K1 {e1} entries, {n1} DMMA instructions; K11 {e11} entries, {n11}; the fewest in an entry "
            f"{min(counts.values(), default=0)}")


def check_dmma(counts):
    """Phase 3's first check: K1 and K11 run their products on the FP64
    tensor cores, so every one of their entries holds DMMA instructions."""
    (e1, _), (e11, _) = dmma_split(counts)
    if not (e1 and e11 and all(counts.values())):
        fail(f"fourier_points.cu: an entry without DMMA instructions ({dmma_text(counts)})")


def bound(flops, nbytes, peak=PEAK_FP64, mma_flops=0):
    """(bound_ms, bound_by): the largest of FP64 operations over the peak
    rate ``peak``, ``mma_flops`` over the tensor cores' FP64 rate (the CUDA
    cores and the tensor cores can work at the same time) and bytes over the
    memory rate."""
    t_ops = max(flops / peak, mma_flops / PEAK_FP64_MMA) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def random_hermitian(rng, K, m):
    a = rng.normal(size=(K, m, m)) + 1j * rng.normal(size=(K, m, m))
    return (a + a.conj().transpose(0, 2, 1)) / 2


def hard_hermitian(np, rng, K, m, scale):
    """K Hermitian m x m matrices at ``scale``, then (m > 1) as many exactly
    degenerate pairs and pairs 1e-9 of the scale apart (rotated by random
    unitaries), K scalar matrices and K / 10 zeros."""
    parts = [random_hermitian(rng, K, m)]
    if m > 1:
        Q, _ = np.linalg.qr(rng.normal(size=(K, m, m)) + 1j * rng.normal(size=(K, m, m)))
        for gap in (0.0, 1e-9):
            e = np.sort(rng.uniform(-1, 1, size=(K, m)), axis=1)
            e[:, 1] = e[:, 0] + gap
            parts.append(np.einsum("kij,kj,klj->kil", Q, e, Q.conj()))
    parts.append(np.eye(m)[None] * rng.normal(size=(K, 1, 1)) + 0j)
    parts.append(np.zeros((K // 10, m, m), complex))
    return np.concatenate(parts) * scale


def velocity_errors(np, e, v, pv, scale, vmax):
    """Per-band velocities v against pv (numpy, (K, d, m); e (K, m) the plain
    route's ascending energies): the largest |v - pv| over its tolerance 1e-13
    / min(g, 1) max|v| among bands whose gap g to their nearest neighbour
    (over the energy scale) is at least 1e-6, and the largest error of a cluster's sum
    (bands closer than that) over max|v|; each must be at most 1 and 1e-12."""
    K, m = e.shape
    g = np.full((K, m), np.inf)
    de = np.diff(e, axis=1) / scale
    if m > 1:
        g[:, 1:] = de
        g[:, :-1] = np.minimum(g[:, :-1], de)
    sep = g >= 1e-6
    ratio = np.abs(v - pv) / (1e-13 / np.minimum(np.where(sep, g, 1.0), 1.0) * vmax)[:, None, :]
    worst = float(np.max(np.where(sep[:, None, :], ratio, 0.0), initial=0.0))
    label = np.concatenate([np.zeros((K, 1), int), np.cumsum(de >= 1e-6, axis=1)], axis=1)
    cl = max(float(np.abs(((v - pv) * (label == c)[:, None, :]).sum(-1)).max()) for c in range(m)) / vmax
    return worst, cl


def chebinterp_integral(interp):
    """Integral of a piecewise Chebyshev interpolant (Clenshaw-Curtis on
    each panel's coefficients)."""
    import numpy as np

    total = 0.0
    for p in interp.panels:
        n = np.arange(len(p.coef))
        even = n % 2 == 0
        total += (p.b - p.a) / 2 * float(np.sum(p.coef[even] * 2.0 / (1.0 - n[even] ** 2)))
    return total


def main():
    try:
        import numpy as np
        import torch
    except ImportError as e:
        fail(f"needs numpy and torch: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs an NVIDIA GPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from autobzcore_torch import FBZ, PTR, CubicSymIBZ, IntegralProblem, load_bz, solve
        from autobzcore_torch.models.observables import dos_integrand
        from autobzcore_torch.models.tight_binding import flagship_series, tb_integer
        from autobzcore_torch.ops import cuda_lib
    except ImportError as e:
        fail(f"the autobzcore_torch package must sit beside this script: {e}")
    if "jax" in sys.modules:
        fail("the port imported jax")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device -------------------------------------------------------------
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired) as e:
        fail(f"nvidia-smi: {e}")
    if not smi:
        fail("nvidia-smi printed nothing")
    print(smi[0], flush=True)
    kind = torch.cuda.get_device_name(0)
    print(f"device: torch sees {kind!r}, {torch.cuda.device_count()} card(s); "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    # 2. build --------------------------------------------------------------
    try:
        seconds, log = cuda_lib.build_kernels()  # always from the sources
        cuda_lib.load_kernels()
    except (RuntimeError, OSError, subprocess.TimeoutExpired) as e:
        fail(f"kernel build: {e}")
    (cuda_lib.LIBRARY.parent / "ptxas.log").write_text(log)
    per_source, sigma = ptxas_report(log)
    print(f"build: {len(cuda_lib.SOURCES)} sources -> {cuda_lib.LIBRARY.name} in "
          f"{seconds:.1f} s (sm_90a); ptxas per source (entries, most registers, spill stores; the whole report in "
          f"build/autobzcore_torch/ptxas.log): {'; '.join(per_source)}", flush=True)
    print(f"ptxas K27-K31 (registers, stack frame, spill stores): {'; '.join(sigma)}", flush=True)
    try:
        dmma = cuda_lib.sass_counts(cuda_lib.LIBRARY, "DMMA", "fourier_points_kernel")
    except (OSError, subprocess.SubprocessError) as e:
        fail(f"cuobjdump --dump-sass of {cuda_lib.LIBRARY.name}: {e}")
    print(f"SASS of fourier_points.cu's entries (cuobjdump): {dmma_text(dmma)}", flush=True)
    try:
        dmma19 = cuda_lib.sass_counts(cuda_lib.LIBRARY, "DMMA", "transport_gamma_partial")
    except (OSError, subprocess.SubprocessError) as e:
        fail(f"cuobjdump --dump-sass of {cuda_lib.LIBRARY.name}: {e}")
    print(f"SASS of transport_gamma.cu's K19 entries (cuobjdump): {len(dmma19)} entries, "
          f"{sum(dmma19.values())} DMMA instructions, the fewest in an entry {min(dmma19.values(), default=0)}",
          flush=True)
    if not (dmma19 and all(dmma19.values())):
        fail(f"transport_gamma.cu: a K19 entry without DMMA instructions ({dmma19})")
    try:
        dmma27 = cuda_lib.sass_counts(cuda_lib.LIBRARY, "DMMA", "sigma_trace_dmma")
    except (OSError, subprocess.SubprocessError) as e:
        fail(f"cuobjdump --dump-sass of {cuda_lib.LIBRARY.name}: {e}")
    print(f"SASS of sigma_trace.cu's K27 sums at m = 3 (cuobjdump): {len(dmma27)} entries, "
          f"{sum(dmma27.values())} DMMA instructions, the fewest in an entry {min(dmma27.values(), default=0)}",
          flush=True)
    if not (len(dmma27) == 2 and all(dmma27.values())):
        fail(f"sigma_trace.cu: a K27 sum without DMMA instructions ({dmma27})")
    if "--phases-22-26" in sys.argv[1:]:
        # phases 22 and 25-26 alone, in a process of their own
        h = flagship_series(device=dev)
        print(json.dumps({"rule_transport": rule_transport_phases(np, torch, dev, h)}, default=str), flush=True)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                                 "count": torch.cuda.device_count()}}), flush=True)
        return
    if "--phases-fourier" in sys.argv[1:]:
        # phases 3-4, 6a, 19 and phase 32's AutoPTR DOS ladder alone, in a process of their own
        h = flagship_series(device=dev)
        check_dmma(dmma)
        print(json.dumps({"fourier": fourier_phases(np, torch, dev, h)}), flush=True)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                                 "count": torch.cuda.device_count()}}), flush=True)
        return
    if "--phases-31-32" in sys.argv[1:]:
        # phases 31-32 alone, in a process of their own (phase 12's ladder does not run)
        h = flagship_series(device=dev)
        print(json.dumps({"kernels": slice12_phases(np, torch, dev, h, None)[0]}), flush=True)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                                 "count": torch.cuda.device_count()}}), flush=True)
        return
    if "--phases-29-30" in sys.argv[1:]:
        # phases 29-30 alone, at phase 26's chemical potential, in a process of their own
        from autobzcore_torch.models import observables as obs
        from autobzcore_torch.models import transport as tr

        h = flagship_series(device=dev)
        bz = load_bz(FBZ(), np.eye(3))
        mu = tr.ElectronCountSolver(h, bz, TR_NPT, pack=obs.spectral_velocity_pack(h, bz, TR_NPT)).find_mu(1.0, TR_BETA)
        print(json.dumps({"kernels": lindhard_sigma_phases(np, torch, dev, h, mu)[0]}), flush=True)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                                 "count": torch.cuda.device_count()}}), flush=True)
        return

    # 3. kernels against their plain versions -------------------------------
    h = flagship_series(device=dev)
    check_dmma(dmma)
    kernels, _ = ptr_phases(np, torch, dev, h)

    # 5. cubic IBZ against the full zone -------------------------------------
    h1 = tb_integer(3, device=dev)
    om8 = torch.linspace(-5.0, 5.0, 8, dtype=torch.float64, device=dev)
    t0 = time.perf_counter()
    sol_ibz = solve(IntegralProblem(dos_integrand(h1, ETA), load_bz(CubicSymIBZ(), np.eye(3)), om8),
                    PTR(npt=NPT))
    sol_fbz = solve(IntegralProblem(dos_integrand(h1, ETA), load_bz(FBZ(), np.eye(3)), om8),
                    PTR(npt=NPT))
    u_ibz, u_fbz = sol_ibz.u.cpu().numpy(), sol_fbz.u.cpu().numpy()
    rel8 = float(np.max(np.abs(u_ibz - u_fbz) / np.abs(u_fbz)))
    print(f"cubic IBZ: tb_integer(3), npt={NPT}, 8 omegas: {sol_ibz.numevals} representatives "
          f"vs {sol_fbz.numevals} points, max rel diff {rel8:.3e} (<= 1e-10), "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    if not rel8 <= 1e-10:
        fail(f"CubicSymIBZ and FBZ differ by {rel8:.3e}")

    cold, k_iai = iai_phases(np, torch, dev, h)
    kernels += k_iai
    k_warm, warm = warm_phases(np, torch, dev, h, cold)
    kernels += k_warm
    counts = (warm["call1"]["numevals"], warm["call2"]["numevals"])
    if counts != IAI_WARM_NUMEVALS:
        fail(f"warm IAI calls: numevals {counts}, expected {IAI_WARM_NUMEVALS}")
    k_fg, ladder = fullgrid_phases(np, torch, dev, h, cold)
    kernels += k_fg
    k_ltm, ltm = ltm_phases(np, torch, dev, h)
    kernels += k_ltm
    k_block, block = block_phases(np, torch, dev, h, cold)
    kernels += k_block
    counts = {W: block[W]["numevals"] for W in BLOCKS}
    if counts != BLOCK_NUMEVALS:
        fail(f"block IAI main path: numevals {counts}, expected {BLOCK_NUMEVALS}")
    kernels += repair_phases(np, torch, dev)
    kernels += ggr_phases(np, torch, dev, h, ltm["dos"])[0]
    kernels += cubature_phases(np, torch, dev, h, cold)[0]
    k_tr, mu_filling, _ = transport_phases(np, torch, dev, h)
    kernels += k_tr
    kernels += berry_phases(np, torch, dev)
    kernels += lindhard_sigma_phases(np, torch, dev, h, mu_filling)[0]
    kernels += slice12_phases(np, torch, dev, h, ladder)[0]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


def ptr_phases(np, torch, dev, h):
    """Phases 3-4: K1 and K2 against their plain versions (K1 bit-identical on
    repeat, its share of its bound and the library call's time), then the
    flagship PTR leg. Returns the kernels' JSON entries and the leg's numbers."""
    from autobzcore_torch import FBZ, PTR, IntegralProblem, load_bz
    from autobzcore_torch.algorithms.ptr import frac_nodes
    from autobzcore_torch.models.observables import (
        dos_integrand, dos_trace_weighted_sum, dos_trace_weighted_sum_plain)
    from autobzcore_torch.ops.fourier_eval import fourier_points, fourier_points_plain, phase_matrix
    from autobzcore_torch.parallel.sweep import SweepSolver
    from autobzcore_torch.utils.chebinterp import hchebinterp

    # 3. kernels against their plain versions -------------------------------
    rng = np.random.default_rng(0)
    args = (h.offset, h.period)
    X = torch.as_tensor(rng.random((100_000, 3)), device=dev)
    k1 = fourier_points(h.c, X, *args)
    p1 = fourier_points_plain(h.c, X, *args)
    torch.cuda.synchronize()
    err1 = float((k1 - p1).abs().max() / p1.abs().max())
    if not err1 <= 1e-12:
        fail(f"K1 fourier_points vs plain: max|dH|/max|H| = {err1:.3e} > 1e-12")
    if not torch.equal(k1, fourier_points(h.c, X, *args)):
        fail("K1 fourier_points: two runs on the same inputs differ")
    errs2 = []
    for m in (1, 2, 3):
        H = torch.as_tensor(random_hermitian(rng, 100_000, m), device=dev)
        w = torch.as_tensor(rng.random(100_000) + 0.5, device=dev)
        om = torch.linspace(-3.0 * math.sqrt(m), 3.0 * math.sqrt(m), W_FLAGSHIP,
                            dtype=torch.float64, device=dev)
        eta = torch.full_like(om, ETA)
        d1 = dos_trace_weighted_sum(H, w, om, eta, 1e-5)
        d2 = dos_trace_weighted_sum(H, w, om, eta, 1e-5)
        dp = dos_trace_weighted_sum_plain(H, w, om, eta, 1e-5)
        torch.cuda.synchronize()
        e = float((d1 - dp).abs().max() / dp.abs().max())
        if not e <= 1e-10:
            fail(f"K2 dos_trace_weighted_sum vs plain at m={m}: max rel err {e:.3e} > 1e-10")
        if not torch.equal(d1, d2):
            fail(f"K2 at m={m}: two runs on the same inputs differ")
        errs2.append(e)
    print(f"kernels: K1 max|dH|/max|H| = {err1:.3e} (<= 1e-12); K2 max rel err "
          f"m=1,2,3: {errs2[0]:.3e}, {errs2[1]:.3e}, {errs2[2]:.3e} (<= 1e-10); "
          "K1 and K2 repeats bit-identical", flush=True)

    # flagship shapes: the full npt=100 grid, W = 264
    Xg = (frac_nodes(NPT, 3, dev) * torch.as_tensor(h.period, device=dev)).contiguous()
    Hg = fourier_points(h.c, Xg, *args)
    Hp = fourier_points_plain(h.c, Xg, *args)
    k1_abs = float((Hg - Hp).abs().max())
    if not torch.equal(Hg, fourier_points(h.c, Xg, *args)):
        fail("K1 fourier_points at the flagship grid: two runs on the same inputs differ")
    Hg = Hg.reshape(-1, 3, 3)
    wg = torch.ones(Hg.shape[0], dtype=torch.float64, device=dev)
    omg = torch.linspace(*WINDOW, W_FLAGSHIP, dtype=torch.float64, device=dev)
    etag = torch.full_like(omg, ETA)
    sc = (2 * math.pi) ** 3 / NPT**3
    k2_abs = float((dos_trace_weighted_sum(Hg, wg, omg, etag, sc)
                    - dos_trace_weighted_sum_plain(Hg, wg, omg, etag, sc)).abs().max())
    t = {
        "k1": cuda_ms(lambda: fourier_points(h.c, Xg, *args), 10),
        "k1_plain": cuda_ms(lambda: fourier_points_plain(h.c, Xg, *args), 3),
        "k2": cuda_ms(lambda: dos_trace_weighted_sum(Hg, wg, omg, etag, sc), 10),
        "k2_plain": cuda_ms(lambda: dos_trace_weighted_sum_plain(Hg, wg, omg, etag, sc), 2),
    }
    # K1's library call: one complex matmul of the precomputed (K, 125) phase
    # matrix by the (125, 9) coefficients, the phases made outside the timed call
    ph = [phase_matrix(Xg[:, j].contiguous(), h.c.shape[j], h.offset[j], h.period[j]) for j in range(3)]
    Pm = (ph[0][:, :, None, None] * ph[1][:, None, :, None] * ph[2][:, None, None, :]).reshape(Xg.shape[0], -1)
    del ph
    cm = h.c.reshape(Pm.shape[1], -1)
    k1_lib_abs = float((torch.matmul(Pm, cm).reshape(Hg.shape) - Hp).abs().max())
    t["k1_library"] = cuda_ms(lambda: torch.matmul(Pm, cm), 10)
    del Pm
    b1 = bound(Hg.shape[0] * (125 * (8 * 9 + 6)),
               nbytes(h.c, Xg) + Hg.numel() * Hg.element_size(), PEAK_FP64_MMA)
    K = Hg.shape[0]
    b2 = bound(K * (W_FLAGSHIP * DOS3_PAIR_FLOPS + DOS3_K_FLOPS), nbytes(Hg, wg, omg, etag) + 8 * W_FLAGSHIP)
    b2_first = bound(K * W_FLAGSHIP * (TRACE_FLOPS[3] + 2), nbytes(Hg, wg, omg, etag) + 8 * W_FLAGSHIP)
    # a lane's value does not depend on the other lanes of its launch: every
    # 33rd lane alone is the launch of 264's bits
    d264 = dos_trace_weighted_sum(Hg, wg, omg, etag, sc)
    step = W_FLAGSHIP // DOS_RUNG_LANES
    if not torch.equal(dos_trace_weighted_sum(Hg, wg, omg[::step].contiguous(), etag[::step].contiguous(), sc),
                       d264[::step]):
        fail(f"K2: the {DOS_RUNG_LANES} lanes alone differ from the same lanes in the launch of {W_FLAGSHIP}")
    print(f"kernels at K={K}, W={W_FLAGSHIP}: K1 {t['k1']:.4f} ms, {100 * b1[0] / t['k1']:.1f} % of its "
          f"bound {b1[0]:.4f} ms by {b1[1]} (plain {t['k1_plain']:.3f} ms, max|dH| {k1_abs:.3e}, repeat "
          f"bit-identical; torch.matmul of the phases {t['k1_library']:.4f} ms, max|dH| {k1_lib_abs:.3e}); K2 "
          f"{t['k2']:.4f} ms, {100 * b2[0] / t['k2']:.1f} % of its bound {b2[0]:.4f} ms by {b2[1]} (first count "
          f"{b2_first[0]:.4f} ms; plain {t['k2_plain']:.3f} ms, max|dD| {k2_abs:.3e}; {1e12 * t['k2'] / 1e3 / (K * W_FLAGSHIP):.3f} "
          f"ps a pair; its {DOS_RUNG_LANES} lanes every {step}th alone bit-equal to the launch's)", flush=True)
    del Hp

    # K2 at a late AutoPTR rung's shape: 8 lanes on the npt = 400 grid
    # (6.4e7 points, H from K1), held against the plain version on a slice
    Xl = (frac_nodes(DOS_RUNG_NPT, 3, dev) * torch.as_tensor(h.period, device=dev)).contiguous()
    Hl = fourier_points(h.c, Xl, *args).reshape(-1, 3, 3)
    del Xl
    Kl = Hl.shape[0]
    wl = torch.ones(Kl, dtype=torch.float64, device=dev)
    om8, eta8 = omg[::step].contiguous(), etag[::step].contiguous()
    scl = (2 * math.pi) ** 3 / DOS_RUNG_NPT**3
    Hs, ws8 = Hl[:DOS_RUNG_SLICE], wl[:DOS_RUNG_SLICE]
    want8 = dos_trace_weighted_sum_plain(Hs, ws8, om8, eta8, scl)
    k2_rung_rel = float((dos_trace_weighted_sum(Hs, ws8, om8, eta8, scl) - want8).abs().max() / want8.abs().max())
    if not k2_rung_rel <= 1e-10:
        fail(f"K2 at {DOS_RUNG_LANES} lanes on the first {DOS_RUNG_SLICE} points of the npt={DOS_RUNG_NPT} grid: max "
             f"rel err {k2_rung_rel:.3e} > 1e-10")
    d8 = dos_trace_weighted_sum(Hl, wl, om8, eta8, scl)
    if not (torch.equal(d8, dos_trace_weighted_sum(Hl, wl, om8, eta8, scl)) and bool(torch.isfinite(d8).all())):
        fail(f"K2 at {DOS_RUNG_LANES} lanes on {Kl} points: not finite, or two runs differ")
    t["k2_rung"] = cuda_ms(lambda: dos_trace_weighted_sum(Hl, wl, om8, eta8, scl), 5)
    b2_rung = bound(Kl * (DOS_RUNG_LANES * DOS3_PAIR_FLOPS + DOS3_K_FLOPS),
                    nbytes(Hl, wl, om8, eta8) + 8 * DOS_RUNG_LANES)
    per_pair = (t["k2"] / (K * W_FLAGSHIP), t["k2_rung"] / (Kl * DOS_RUNG_LANES))
    print(f"K2 at a late AutoPTR rung's shape: {DOS_RUNG_LANES} lanes on the npt={DOS_RUNG_NPT} grid ({Kl} points): "
          f"{t['k2_rung']:.4f} ms, {100 * b2_rung[0] / t['k2_rung']:.1f} % of its bound {b2_rung[0]:.4f} ms by "
          f"{b2_rung[1]}; {1e9 * per_pair[1]:.3f} ps a pair, {per_pair[1] / per_pair[0]:.3f}x the per-pair time at "
          f"W={W_FLAGSHIP}; on its first {DOS_RUNG_SLICE} points max rel err vs plain {k2_rung_rel:.3e} (<= 1e-10); "
          "repeat bit-identical", flush=True)
    del Hl, wl, Hs, ws8
    torch.cuda.empty_cache()

    # 4. PTR main path at full width ----------------------------------------
    bz = load_bz(FBZ(), np.eye(3))
    prob = IntegralProblem(dos_integrand(h, ETA), bz)
    fourier_points.launches = 0
    dos_trace_weighted_sum.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sweep = SweepSolver(prob, PTR(npt=NPT), chunk=W_FLAGSHIP)
    interp = hchebinterp(sweep, *WINDOW, atol=1e-2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"fourier_points": fourier_points.launches,
                "dos_trace_weighted_sum": dos_trace_weighted_sum.launches}
    print(f"main path: flagship PTR(npt={NPT}) leg: {interp.numevals} omegas, "
          f"{len(interp.panels)} panels, numevals {sweep.numevals}, retcode {sweep.retcode}, "
          f"wall {wall:.3f} s; launches {launches}", flush=True)
    if min(launches.values()) <= 0:
        fail(f"the main path did not go through every kernel: {launches}")
    if not sweep.retcode or sweep.numevals != interp.numevals * NPT**3:
        fail(f"sweep certificate: retcode {sweep.retcode}, numevals {sweep.numevals}")

    # sum rule: the integral of the interpolant over the window against the
    # closed-form integral of the Lorentzians at the eigenvalues
    # on the host: cuSOLVER's batched eigensolver refuses these batches
    # (CUSOLVER_STATUS_INVALID_VALUE at 1e6 and at 65536 3x3 matrices)
    e = torch.linalg.eigvalsh(Hg.cpu())
    lo, hi = WINDOW
    exact = float(((torch.atan((hi - e) / ETA) - torch.atan((lo - e) / ETA)) / math.pi).sum()) * sc
    got = chebinterp_integral(interp)
    rel = abs(got - exact) / abs(exact)
    ws = np.array([-4.0, -1.0, 0.5, 2.0, 5.5])
    d_main = sweep(ws)
    omw = torch.as_tensor(ws, device=dev)
    d_plain = dos_trace_weighted_sum_plain(
        fourier_points_plain(h.c, Xg, *args).reshape(-1, 3, 3), wg, omw,
        torch.full_like(omw, ETA), sc).cpu().numpy()
    rel5 = float(np.max(np.abs(d_main - d_plain) / np.abs(d_plain)))
    vals = interp(np.linspace(*WINDOW, 1001))
    print(f"main path check: integral {got:.10g} vs sum rule {exact:.10g} (rel {rel:.3e}, "
          f"<= 1e-3); D at 5 omegas vs plain path: max rel {rel5:.3e} (<= 1e-10); "
          f"D finite: {bool(np.all(np.isfinite(vals)))}", flush=True)
    if not rel <= 1e-3:
        fail(f"sum rule off by {rel:.3e}")
    if not rel5 <= 1e-10 or d_main.shape != (5,):
        fail(f"D at 5 omegas differs from the plain path by {rel5:.3e}")
    if not np.all(np.isfinite(vals)):
        fail("the interpolant is not finite")
    if "--profile" in sys.argv[1:]:
        profile("PTR main path", lambda: hchebinterp(SweepSolver(prob, PTR(npt=NPT), chunk=W_FLAGSHIP),
                                                      *WINDOW, atol=1e-2))

    src = "autobzcore_torch/csrc/"
    kernels = [
        {"name": "fourier_points", "route": "cuda", "source": src + "fourier_points.cu",
         "replaces": "autobzcore_tpu/ops/fourier_eval.py:78",
         "launches": launches["fourier_points"], "max_abs_err": k1_abs,
         "ms": t["k1"], "plain_ms": t["k1_plain"], "bound_ms": b1[0], "bound_by": b1[1],
         "library_ms": t["k1_library"]},
        {"name": "dos_trace_weighted_sum", "route": "cuda", "source": src + "dos_trace.cu",
         "replaces": "autobzcore_tpu/models/observables.py:149",
         "launches": launches["dos_trace_weighted_sum"], "max_abs_err": k2_abs,
         "ms": t["k2"], "plain_ms": t["k2_plain"], "bound_ms": b2[0], "bound_by": b2[1],
         "library_ms": None},
    ]
    del Hg, Xg, wg
    torch.cuda.empty_cache()
    info = {"k1_ms": t["k1"], "k1_library_ms": t["k1_library"], "k1_bound_ms": b1[0], "ptr_wall": wall,
            "omegas": interp.numevals, "panels": len(interp.panels), "numevals": sweep.numevals,
            "k2_ms": t["k2"], "k2_bound_ms": b2[0], "k2_first_bound_ms": b2_first[0], "k2_rung_ms": t["k2_rung"],
            "k2_rung_bound_ms": b2_rung[0], "k2_rung_rel": k2_rung_rel, "k2_max_abs_err": k2_abs,
            "ptr_launches": launches}
    return kernels, info


def k3_phase(np, torch, dev, h, rng):
    """Phase 6a: K3 against its plain version at the outer level's shape (33
    solves x 2 x 15 nodes on one coefficient set) and the mid level's (990
    lanes of the results x 2 x 15 nodes), each bit-identical on repeat, with
    kernel, plain, ``torch.matmul`` and bound times at both. Returns them."""
    from autobzcore_torch.ops import adaptive as tad
    from autobzcore_torch.ops.fourier_eval import fourier_contract, fourier_contract_plain, phase_matrix

    P = tad.gk_rule(7, dev)[0].shape[0]
    L_mid = IAI_OMEGAS * 2 * P
    # the outer level's contraction at 2 x 15 nodes of each of the 33
    # solves, then the mid level's at 2 x 15 nodes of each of the 990 results
    c0 = h.c.reshape((1, 5, 5, 5, 9)).contiguous()
    x_out = torch.as_tensor(rng.random((IAI_OMEGAS, 2 * P)), device=dev)
    cm_out = torch.zeros(IAI_OMEGAS, dtype=torch.int64, device=dev)
    args_out = (c0, cm_out, x_out, h.offset[2], h.period[2])
    k3a = fourier_contract(*args_out)
    e3a = float((k3a - fourier_contract_plain(*args_out)).abs().max())
    c_mid = k3a.reshape(L_mid, 5, 5, 9)
    cm_mid = torch.arange(L_mid, device=dev)
    x_mid = torch.as_tensor(rng.random((L_mid, 2 * P)), device=dev)
    args3 = (c_mid, cm_mid, x_mid, h.offset[1], h.period[1])
    k3 = fourier_contract(*args3)
    p3 = fourier_contract_plain(*args3)
    e3 = float((k3 - p3).abs().max())
    cmax = max(float(c0.abs().max()), float(c_mid.abs().max()))
    if not max(e3a, e3) <= 1e-12 * cmax:
        fail(f"K3 fourier_contract vs plain: max|d| {max(e3a, e3):.3e} > 1e-12 max|c| ({cmax:.3e})")
    if not (torch.equal(k3a, fourier_contract(*args_out)) and torch.equal(k3, fourier_contract(*args3))):
        fail("K3 fourier_contract: two runs on the same inputs differ")
    # the library call: one batched matmul of the (L, J, n) phases against (L, n, rest)
    ph = phase_matrix(x_mid, 5, h.offset[1], h.period[1])
    cl = c_mid.permute(0, 2, 1, 3).reshape(L_mid, 5, 45).contiguous()
    e3m = float((torch.matmul(ph, cl).reshape(p3.shape) - p3).abs().max())
    # and at the outer level: the (33, 30, 5) phases against the one (5, 225) slab
    ph_out = phase_matrix(x_out, 5, h.offset[2], h.period[2])
    cl_out = c0.reshape(25, 5, 9).permute(1, 0, 2).reshape(5, 225).contiguous()
    t3 = {"ms": cuda_ms(lambda: fourier_contract(*args3), 50),
          "plain_ms": cuda_ms(lambda: fourier_contract_plain(*args3), 10),
          "library_ms": cuda_ms(lambda: torch.matmul(ph, cl), 50),
          "outer_ms": cuda_ms(lambda: fourier_contract(*args_out), 50),
          "outer_library_ms": cuda_ms(lambda: torch.matmul(ph_out, cl_out), 50),
          "err": max(e3a, e3),
          "bound": bound(k3.numel() * 8 * 5, nbytes(c_mid, cm_mid, x_mid, k3)),
          "outer_bound": bound(k3a.numel() * 8 * 5, nbytes(c0, cm_out, x_out, k3a))}
    # the device's own time: a call of this size takes less on the card than
    # the host takes to enqueue it
    for key, fn in (("mid", lambda: fourier_contract(*args3)), ("mid_library", lambda: torch.matmul(ph, cl)),
                    ("outer", lambda: fourier_contract(*args_out)),
                    ("outer_library", lambda: torch.matmul(ph_out, cl_out))):
        t3[key + "_device_ms"] = device_ms(fn, 50)
    # what a call costs the host at the mid shape: the wrapper, the bare
    # ctypes launch it ends in (the same arguments, no checks, no allocation)
    # and torch.matmul
    from autobzcore_torch.ops import cuda_lib

    lib = cuda_lib.load_kernels()
    o3 = torch.empty_like(k3)
    bare = (c_mid.data_ptr(), cm_mid.data_ptr(), x_mid.data_ptr(), o3.data_ptr(), L_mid, x_mid.shape[1], 5, 5, 9,
            L_mid, int(h.offset[1]), float(h.period[1]), torch.cuda.current_stream(dev).cuda_stream)
    t3["host_us"] = host_us(lambda: fourier_contract(*args3), 500)
    t3["bare_host_us"] = host_us(lambda: lib.fourier_contract_launch(*bare), 500)
    t3["library_host_us"] = host_us(lambda: torch.matmul(ph, cl), 500)
    if not torch.equal(o3, k3):
        fail("K3 fourier_contract: the bare launch differs from the wrapper's")
    b3, b3o = t3["bound"], t3["outer_bound"]

    def dev_text(key):
        v = t3[key + "_device_ms"]
        return "not captured" if v is None else f"{v:.4f} ms"

    def share(b, key):
        v = t3[key + "_device_ms"]
        return "" if v is None else f", {100 * b[0] / v:.1f} % of it on the device"

    print(f"K3 fourier_contract: outer {tuple(x_out.shape)} max|d| {e3a:.3e}, mid "
          f"{tuple(x_mid.shape)} max|d| {e3:.3e} (<= 1e-12 max|c| = {1e-12 * cmax:.3e}), repeats bit-identical; "
          f"a call (host clock of 50 calls by events) mid {t3['ms']:.4f} ms (plain {t3['plain_ms']:.4f}, "
          f"torch.matmul {t3['library_ms']:.4f} max|d| {e3m:.3e}), outer {t3['outer_ms']:.4f} ms (torch.matmul "
          f"{t3['outer_library_ms']:.4f}); device time (profiler) mid {dev_text('mid')} (torch.matmul "
          f"{dev_text('mid_library')}), outer {dev_text('outer')} (torch.matmul {dev_text('outer_library')}); "
          f"bounds mid {b3[0]:.4f} ms by {b3[1]}{share(b3, 'mid')}, outer {b3o[0]:.4f} ms by {b3o[1]}"
          f"{share(b3o, 'outer')}; host time a call at the mid shape (500 calls, no sync) {t3['host_us']:.1f} us "
          f"(its bare ctypes launch {t3['bare_host_us']:.1f} us; torch.matmul {t3['library_host_us']:.1f} us)",
          flush=True)
    return t3


def fourier_phases(np, torch, dev, h):
    """``--phases-fourier``: phases 3-4, 6a, phase 19's K11 and phase 32's
    AutoPTR DOS ladder; the PTR leg once more under torch.profiler for K2's
    device time, and the ladder for K1's and K2's device time per rung and
    their shares of its device time. Returns their numbers."""
    from autobzcore_torch import FBZ, PTR, AutoPTR, IntegralProblem, MixedParameters, load_bz
    from autobzcore_torch.models.observables import dos_integrand
    from autobzcore_torch.parallel.sweep import SweepSolver, sweep_solve
    from autobzcore_torch.utils.chebinterp import hchebinterp

    _, ptr = ptr_phases(np, torch, dev, h)
    prob = IntegralProblem(dos_integrand(h, ETA), load_bz(FBZ(), np.eye(3)))
    prof = profile("PTR main path", lambda: hchebinterp(SweepSolver(prob, PTR(npt=NPT), chunk=W_FLAGSHIP),
                                                         *WINDOW, atol=1e-2))
    ptr.update(ptr_k2_device_ms=device_sum_ms(prof, K2_KERNELS), ptr_k1_device_ms=device_sum_ms(prof, K1_KERNELS),
               ptr_busy_ms=None if prof is None else 1e3 * prof["busy"])
    if prof is not None:
        print(f"PTR leg: K2 {ptr['ptr_k2_device_ms']:.3f} ms and K1 {ptr['ptr_k1_device_ms']:.3f} ms of "
              f"{ptr['ptr_busy_ms']:.3f} ms device time (wall {ptr['ptr_wall']:.4f} s unprofiled)", flush=True)
    t3 = k3_phase(np, torch, dev, h, np.random.default_rng(1))
    k11 = k11_phase(np, torch, dev, h)
    t11 = k11["t"]
    del k11
    torch.cuda.empty_cache()
    lad = autoptr_dos_ladder(np, torch, dev, h, load_bz(FBZ(), np.eye(3)))
    prof = profile(f"AutoPTR ladder ({AUTOPTR_OMEGAS} omegas)", lambda: sweep_solve(
        lad["prob"], AutoPTR(device=dev, **AUTOPTR_KW), MixedParameters(torch.as_tensor(lad["ws"], device=dev)),
        abstol=AUTOPTR_ABSTOL), events=True)
    k1_dev = None if prof is None else device_sum_ms(prof, K1_KERNELS) / 1e3
    k2_dev = None if prof is None else device_sum_ms(prof, K2_KERNELS) / 1e3
    split = None if prof is None else ladder_split(prof["events"])
    if prof is not None:
        busy = prof["busy"]
        print(f"AutoPTR ladder: K1 {1e3 * k1_dev:.3f} ms ({100 * k1_dev / busy:.2f} %) and K2 {1e3 * k2_dev:.3f} ms "
              f"({100 * k2_dev / busy:.2f} %) of {1e3 * busy:.3f} ms device time; per rung (npt, active lanes, K1 ms, "
              f"K2 ms): " + ("not split (no device events)" if split is None else "; ".join(
                  f"({n}, {a}, {r['k1_ms']:.3f}, {r['k2_ms']:.3f})"
                  for n, a, r in zip(lad["rungs"], lad["active"], split))), flush=True)
    return dict(ptr, k3_ms=t3["ms"], k3_library_ms=t3["library_ms"], k3_bound_ms=t3["bound"][0],
                k3_outer_ms=t3["outer_ms"], k3_outer_library_ms=t3["outer_library_ms"],
                k3_outer_bound_ms=t3["outer_bound"][0],
                **{f"k3_{k}_device_ms": t3[f"{k}_device_ms"] for k in ("mid", "mid_library", "outer", "outer_library")},
                **{f"k3_{k}": t3[k] for k in ("host_us", "bare_host_us", "library_host_us")},
                k11_ms=t11["ms"], k11_library_ms=t11["library_ms"],
                k11_bands30_ms=t11["bands30_ms"],
                **{f"k11_chunk_{k}": t11[f"chunk_{k}"] for k in ("ms", "device_ms", "host_us", "library_ms",
                                                                  "library_device_ms", "bound_ms")},
                ladder_wall=lad["wall"], ladder_active=lad["active"], ladder_rungs=list(lad["rungs"]),
                ladder_certified=int(lad["conv"].sum()), ladder_launches=list(lad["launches"]),
                ladder_numevals=int(lad["nev"].sum()), ladder_k1_device_s=k1_dev, ladder_k2_device_s=k2_dev,
                ladder_split=split, ladder_busy_s=None if prof is None else prof["busy"])


def leaf_solve_phase(np, torch, dev, args, label):
    """The fused leaf solve (``gk_leaf_dos_solve``) against the trip route
    (K5's start for the first picks, then K4 and K5's step, the host's test
    every trip) and against its plain version (the trip route on the plain
    start, K4 and step)
    on the same started pools: K4's cold start of the leaf lanes ``args``
    (phase 6b's or 16's inputs) on [0, 1], cap 64, nbisect 4, atol
    IAI_ABSTOL. Against the trip route, pools, totals, n, evals, active and
    every lane's trips must be torch.equal. Against the plain version, a
    lane whose a, b, n, evals, active and trips are equal to the plain
    lane's (the same bisections) must hold its totals to 1e-12 of its l1;
    a lane that K4's rounding (~1e-14 of the plain K4's) sent another way
    must agree within the two error estimates, and at most 1 % of the lanes
    may do so. ``err`` is the largest |d tot_val| and |d tot_err| against
    the plain version over all lanes. Times: the solve's device time
    (torch.profiler), a call by events and its host time (back to back, no
    sync), the trip route's wall (host clock), device time, launches and
    host tests, and the plain version once. Returns its numbers."""
    from autobzcore_torch.models import observables as obs
    from autobzcore_torch.ops import adaptive as tad

    c1, cmap, off, period = args[:4]
    om, eta = args[6:8]
    xk, wk, wg = args[9:12]
    L, nb, cap = c1.shape[0], 4, 64
    W = om.shape[1] if om.ndim == 2 else 1
    segs = torch.tensor([0.0, 1.0], dtype=torch.float64, device=dev).expand(L, 2).contiguous()
    atol = torch.full((L,), IAI_ABSTOL, dtype=torch.float64, device=dev)
    rule = obs.leaf_dos_rule(c1, cmap, off, period, om, eta, xk, wk, wg, obs.gk_leaf_dos)
    held = []
    tad.gk_adaptive_lanes(rule, segs, atol, cap=cap, nbisect=nb, solve=lambda pool, _: held.append(pool))
    start = held[0]

    clone = start.clone
    sargs = (c1, cmap, off, period, om, eta, xk, wk, wg, nb)
    fields = ("a", "b", "err", "l1", "val", "n", "evals", "tot_val", "tot_err", "tol", "active")
    ref = clone()
    k50 = sum(k5_launches().values())
    k40 = obs.gk_leaf_dos.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = obs.gk_leaf_dos_solve_plain(ref, *sargs, kernels=True)
    torch.cuda.synchronize()
    trip_wall = time.perf_counter() - t0
    trip_launches = sum(k5_launches().values()) - k50 + obs.gk_leaf_dos.launches - k40
    got = clone()
    trips = obs.gk_leaf_dos_solve(got, *sargs)
    same = [k for k in fields if not torch.equal(getattr(got, k), getattr(ref, k))]
    if same or not torch.equal(trips, want):
        fail(f"gk_leaf_dos_solve vs the trip route ({label}): fields that differ {same}, trips equal "
             f"{torch.equal(trips, want)}")
    # the plain version on the same started pool
    plain = clone()
    plain_trips, plain_ms = timed_once(lambda: obs.gk_leaf_dos_solve_plain(plain, *sargs))
    path = ((got.a == plain.a).all(1) & (got.b == plain.b).all(1) & (got.n == plain.n)
            & (got.evals == plain.evals) & (got.active == plain.active) & (trips == plain_trips))
    d_val = (got.tot_val - plain.tot_val).abs().reshape(L, -1).amax(1)
    d_err = (got.tot_err - plain.tot_err).abs()
    live = torch.arange(cap, device=dev)[None, :] < plain.n[:, None]
    scale = torch.where(live, plain.l1, 0.0).sum(1).clamp_min(1e-300)
    rel_same = float(torch.where(path, torch.maximum(d_val, d_err) / scale, 0.0).max())
    other = int((~path).sum())
    slack = float(torch.where(path, 0.0, d_val - (got.tot_err + plain.tot_err + 1e-12 * scale)).max())
    err = max(float(d_val.max()), float(d_err.max()))
    if not (rel_same <= 1e-12 and slack <= 0.0 and other <= L // 100):
        fail(f"gk_leaf_dos_solve vs its plain version ({label}): same-path lanes' totals rel {rel_same:.3e} "
             f"(<= 1e-12), {other} lanes on another path (<= {L // 100}), their |d tot_val| past the two "
             f"error estimates by {slack:.3e}")
    nodes = float((got.evals - start.evals).sum())  # evaluated nodes: 2 nbisect x 15 a lane's trip
    reps = 10
    pools = [clone() for _ in range(3 * reps + 4)]  # cuda_ms, device_ms and host_us each run reps + 1 or 2
    it = iter(pools)
    t = {"ms": cuda_ms(lambda: obs.gk_leaf_dos_solve(next(it), *sargs), reps),
         "device_ms": device_ms(lambda: obs.gk_leaf_dos_solve(next(it), *sargs), reps, "gk_leaf_dos_solve"),
         "host_us": host_us(lambda: obs.gk_leaf_dos_solve(next(it), *sargs), reps)}
    del pools
    t["trip_device_ms"] = device_ms(lambda: obs.gk_leaf_dos_solve_plain(clone(), *sargs, kernels=True), 3,
                                    ("gk_pool", "gk_leaf_dos"))
    t.update(plain_ms=plain_ms, err=err, rel_same=rel_same, other_path=other, trip_wall_ms=1e3 * trip_wall,
             trip_launches=trip_launches, trip_syncs=int(want.max()) + 1, trips_max=int(want.max()),
             trips_mean=float(want.float().mean()), nodes=nodes, L=L, W=W)
    flops = nodes * (5 * (8 * 9 + 6) + W * (TRACE_FLOPS[3] + 9))
    t["bound"] = bound(flops, 2 * nbytes(start.a, start.b, start.err, start.l1, start.val)
                       + nbytes(c1, cmap, om, eta) + 2 * L * (5 + W) * 8)
    dev_ms = t["device_ms"]
    print(f"gk_leaf_dos_solve vs the trip route ({label}): {L} lanes x cap {cap}, nbisect {nb}, W = {W}: pools, "
          f"totals, counts, active and trips identical (trips per lane max {t['trips_max']}, mean "
          f"{t['trips_mean']:.2f}; {nodes:.4g} nodes); vs its plain version: {L - other} lanes on the same "
          f"path, their totals rel {rel_same:.3e} (<= 1e-12 of l1), {other} on another path (<= {L // 100}, "
          f"within the two error estimates), max |d tot_val|, |d tot_err| {err:.3e}; the solve: device "
          f"{ms_text(dev_ms)} (profiler), a call {t['ms']:.4f} ms by events, host {t['host_us']:.1f} us; bound "
          f"{t['bound'][0]:.4f} ms by {t['bound'][1]}"
          + ("" if dev_ms is None else f" ({100 * t['bound'][0] / dev_ms:.1f} % of the device time)")
          + f"; the trip route: wall {t['trip_wall_ms']:.3f} ms, device {ms_text(t['trip_device_ms'])}, "
          f"{trip_launches} launches, {t['trip_syncs']} host tests; plain version {plain_ms:.1f} ms", flush=True)
    return t


def iai_phases(np, torch, dev, h):
    """Phases 6-8: K3-K5 against their plain versions, the IAI main path and
    the cubic-IBZ check through IAI. Returns the kernels' JSON entries."""
    from autobzcore_torch import FBZ, IAI, PTR, CubicSymIBZ, IntegralProblem, load_bz, solve
    from autobzcore_torch.models.observables import dos_integrand, gk_leaf_dos, gk_leaf_dos_plain
    from autobzcore_torch.models.tight_binding import tb_integer
    from autobzcore_torch.ops import adaptive as tad
    from autobzcore_torch.ops.fourier_eval import fourier_contract, fourier_contract_plain
    from autobzcore_torch.parallel.sweep import SweepSolver

    src = "autobzcore_torch/csrc/"
    rng = np.random.default_rng(1)
    xk, wk, wg = tad.gk_rule(7, dev)
    P = xk.shape[0]
    L_mid, L_leaf = IAI_OMEGAS * 2 * P, IAI_OMEGAS * (2 * P) ** 2

    # 6a. K3 at the outer and mid levels' shapes
    c0 = h.c.reshape((1, 5, 5, 5, 9)).contiguous()
    t3 = k3_phase(np, torch, dev, h, rng)

    # 6b. K4: leaf lanes with 1-D coefficients of the flagship contracted at
    # random (x3, x2), 2 intervals per lane; m = 1, 2 from random 1-D series
    def leaf_inputs(L, m):
        if m == 3:
            x3 = torch.as_tensor(rng.random((1, L)), device=dev)
            c2 = fourier_contract_plain(c0, torch.zeros(1, dtype=torch.int64, device=dev), x3,
                                        h.offset[2], 1.0).reshape(L, 5, 5, 9)
            x2 = torch.as_tensor(rng.random((L, 1)), device=dev)
            c1 = fourier_contract_plain(c2, torch.arange(L, device=dev), x2, h.offset[1], 1.0)
            c1 = c1.reshape(L, 5, 9).contiguous()
        else:
            a = rng.normal(size=(L, 5, m, m)) + 1j * rng.normal(size=(L, 5, m, m))
            a = a + np.conj(a[:, ::-1].transpose(0, 1, 3, 2))  # a Hermitian series
            c1 = torch.as_tensor(a.reshape(L, 5, m * m), device=dev).contiguous()
        a0 = torch.as_tensor(rng.random((L, 2)) * 0.5, device=dev)
        b0 = (a0 + torch.as_tensor(rng.random((L, 2)) * 0.5, device=dev)).contiguous()
        om = torch.as_tensor(rng.uniform(-6, 7, L), device=dev)
        return (c1, torch.arange(L, device=dev), -2, 1.0, a0.contiguous(), b0, om,
                torch.full_like(om, ETA), torch.ones(L, dtype=torch.bool, device=dev), xk, wk, wg)

    errs4 = []
    for m in (1, 2, 3):
        a4 = leaf_inputs(900, m)
        got, want = gk_leaf_dos(*a4), gk_leaf_dos_plain(*a4)
        l1 = want[2]
        e = max(float(((got[0] - want[0]).abs() / l1).max()), float(((got[1] - want[1]).abs() / l1).max()))
        if not (e <= 1e-12 and torch.equal(got[3], want[3])):
            fail(f"K4 gk_leaf_dos vs plain at m={m}: max |d val|, |d err| / l1 = {e:.3e} > 1e-12")
        errs4.append(e)
    a4 = leaf_inputs(L_leaf, 3)
    got, want = gk_leaf_dos(*a4), gk_leaf_dos_plain(*a4)
    e4 = float(max((got[0] - want[0]).abs().max(), (got[1] - want[1]).abs().max()))
    t4 = {"ms": cuda_ms(lambda: gk_leaf_dos(*a4), 50), "plain_ms": cuda_ms(lambda: gk_leaf_dos_plain(*a4), 5),
          "device_ms": device_ms(lambda: gk_leaf_dos(*a4), 50, "gk_leaf_dos"),
          "host_us": host_us(lambda: gk_leaf_dos(*a4), 200)}
    b4 = bound(L_leaf * 2 * P * (5 * (8 * 9 + 6) + TRACE_FLOPS[3] + 9),
               nbytes(*a4[:2], *a4[4:9]) + 4 * L_leaf * 2 * 8)
    print(f"K4 gk_leaf_dos: 900 lanes x 2 intervals, max |d val|, |d err| / l1 at m=1,2,3: "
          f"{errs4[0]:.3e}, {errs4[1]:.3e}, {errs4[2]:.3e} (<= 1e-12); {L_leaf} lanes m=3: "
          f"{t4['ms']:.4f} ms a call by events (device {ms_text(t4['device_ms'])}, host {t4['host_us']:.1f} us; "
          f"plain {t4['plain_ms']:.4f}; bound {b4[0]:.4f} ms by {b4[1]}), max|d| {e4:.3e}", flush=True)
    ts = leaf_solve_phase(np, torch, dev, a4, f"phase 6's {L_leaf} leaf lanes, m = 3")

    # 6c. K5 at the path's shapes against its plain version: the leaf pools'
    # start (K4's reduced children, no picks), the mid level's step (nbisect
    # 1, node values with the inner solves' counts), the outermost level's
    # (cap 2048) and a step at nbisect 4
    t5 = {"leaf_start": k5_shape(np, torch, dev, rng, "the leaf pools' start", L_leaf, 64, 1, entry="start"),
          "mid_step": k5_shape(np, torch, dev, rng, "the mid level's trip", L_mid, 64, 1),
          "outer_step": k5_shape(np, torch, dev, rng, "the outermost level's trip", IAI_OMEGAS, 2048, 1),
          "nb4_step": k5_shape(np, torch, dev, rng, "nbisect 4", 900, 64, 4)}
    del a4, got, want

    # 7. IAI main path at full width ------------------------------------------
    bz = load_bz(FBZ(), np.eye(3))
    prob = IntegralProblem(dos_integrand(h, ETA), bz)
    oms = np.linspace(*WINDOW, IAI_OMEGAS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fourier_contract.launches = 0
    gk_leaf_dos.launches = 0
    k5_launches(reset=True)
    leaf_solve_launches(reset=True)
    with SmiBusy() as busy:
        t0 = time.perf_counter()
        sweep = SweepSolver(prob, IAI(inner_cap=64, inner_nbisect=4), abstol=IAI_ABSTOL,
                            chunk=IAI_OMEGAS, scan=True)
        d_iai = sweep(oms)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {"fourier_contract": fourier_contract.launches, "gk_leaf_dos": gk_leaf_dos.launches,
                **{k: v for k, v in k5_launches().items() if k != "gk_pool_seed"},
                "gk_leaf_dos_solve": leaf_solve_launches()}
    peak = torch.cuda.max_memory_allocated() / 2**20
    ne = sweep.lane_numevals
    st = sweep.stats
    leaf = leaf_launches(launches, st)
    print(f"IAI main path: flagship FBZ, eta {ETA}, {IAI_OMEGAS} omegas, abstol {IAI_ABSTOL}: wall "
          f"{wall:.3f} s ({wall / IAI_OMEGAS:.4f} s/omega); numevals {sweep.numevals} (per omega "
          f"min {ne.min()} max {ne.max()} mean {ne.mean():.4g}); retcode {sweep.retcode}; trips "
          f"(level 3 outer, 2 mid, 1 leaf) {dict(sorted(st.trips.items(), reverse=True))}; host "
          f"syncs {st.syncs} ({st.syncs / IAI_OMEGAS:.1f} per omega); launches {launches}; leaf launches {leaf}; "
          f"device busy {busy.text()} (nvidia-smi); peak device memory {peak:.1f} MiB", flush=True)
    if min(launches.values()) <= 0:
        fail(f"the IAI main path did not go through every kernel: {launches}")
    k5 = sum(v for k, v in launches.items() if k.startswith(("gk_pool", "gk_rule")))
    mid_outer = st.trips.get(2, 0) + st.trips.get(3, 0)
    print(f"IAI main path: K5 launches by entry {({k: v for k, v in launches.items() if k.startswith('gk_pool')})}, "
          f"{k5} in all; mid and outer trips {mid_outer}", flush=True)
    if launches["gk_pool_step"] != mid_outer or k5 > K5_COLD_MAX:
        fail(f"K5 on the IAI main path: {launches['gk_pool_step']} steps for {mid_outer} mid and outer trips (one "
             f"each), {k5} launches in all (<= {K5_COLD_MAX})")
    if not sweep.retcode or d_iai.shape != (IAI_OMEGAS,) or not np.all(np.isfinite(d_iai)):
        fail(f"IAI sweep: retcode {sweep.retcode}, shape {d_iai.shape}")
    if sweep.numevals != IAI_NUMEVALS:
        fail(f"IAI sweep: numevals {sweep.numevals}, the trip route's {IAI_NUMEVALS}")
    if "--profile" in sys.argv[1:]:
        profile("IAI main path", lambda: SweepSolver(prob, IAI(inner_cap=64, inner_nbisect=4),
                                                     abstol=IAI_ABSTOL, chunk=IAI_OMEGAS,
                                                     scan=True)(oms))

    # the same solve through the plain versions, at one frequency (phase 10
    # holds the warm chain against them too, within the time limit)
    pick = [IAI_OMEGAS // 4]
    t0 = time.perf_counter()
    psweep = SweepSolver(prob, IAI(inner_cap=64, inner_nbisect=4, plain_kernels=True),
                         abstol=IAI_ABSTOL, chunk=IAI_OMEGAS, scan=True)
    d_plain = psweep(oms[pick])
    t_plain = time.perf_counter() - t0
    dev3 = float(np.max(np.abs(d_plain - d_iai[pick])))
    print(f"IAI vs plain path at omegas {oms[pick].round(4).tolist()}: D {d_iai[pick].tolist()} vs "
          f"{d_plain.tolist()}, max|d| {dev3:.3e} (<= abstol {IAI_ABSTOL}); numevals "
          f"{ne[pick].tolist()} vs {psweep.lane_numevals.tolist()}; plain path {t_plain:.3f} s, "
          f"retcode {psweep.retcode}", flush=True)
    if not (dev3 <= IAI_ABSTOL and psweep.retcode):
        fail(f"IAI kernels vs plain path: max|d| {dev3:.3e}")

    # a gross-error catch against the fixed rule at npt = 400
    t0 = time.perf_counter()
    d_ptr = solve(IntegralProblem(dos_integrand(h, ETA), bz, torch.as_tensor(oms, device=dev)),
                  PTR(npt=400)).u.cpu().numpy()
    torch.cuda.synchronize()
    dptr = float(np.max(np.abs(d_iai - d_ptr)))
    print(f"IAI vs PTR(npt=400) at {IAI_OMEGAS} omegas: max|d| {dptr:.4e} (<= 1e-2 max|D| = "
          f"{1e-2 * np.max(np.abs(d_ptr)):.4e}); PTR {time.perf_counter() - t0:.3f} s", flush=True)
    if not dptr <= 1e-2 * np.max(np.abs(d_ptr)):
        fail(f"IAI and PTR(npt=400) differ by {dptr:.3e}")
    torch.cuda.empty_cache()

    # 8. cubic IBZ through IAI ------------------------------------------------
    h1 = tb_integer(3, device=dev)
    om4 = np.array([-4.1, -1.3, 0.7, 2.9])
    t0 = time.perf_counter()
    outs = {}
    for name, kind in (("IBZ", CubicSymIBZ()), ("FBZ", FBZ())):
        sw = SweepSolver(IntegralProblem(dos_integrand(h1, 0.1), load_bz(kind, np.eye(3))),
                         IAI(inner_cap=64, inner_nbisect=4), abstol=IAI_ABSTOL, chunk=4, scan=True)
        outs[name] = (sw(om4), sw.numevals, sw.retcode)
    d4 = float(np.max(np.abs(outs["IBZ"][0] - outs["FBZ"][0])))
    print(f"cubic IBZ through IAI: tb_integer(3), eta 0.1, 4 omegas: max|d| {d4:.3e} (<= "
          f"{2 * IAI_ABSTOL}); numevals IBZ {outs['IBZ'][1]} vs FBZ {outs['FBZ'][1]}; retcodes "
          f"{outs['IBZ'][2]} {outs['FBZ'][2]}; {time.perf_counter() - t0:.3f} s", flush=True)
    if not (d4 <= 2 * IAI_ABSTOL and outs["IBZ"][2] and outs["FBZ"][2]):
        fail(f"CubicSymIBZ and FBZ differ through IAI by {d4:.3e}")

    rep = "autobzcore_tpu/ops/adaptive.py:"
    cold = {"oms": oms, "d": d_iai, "ne": ne, "numevals": sweep.numevals, "wall": wall,
            "d_ptr": d_ptr, "bz": bz, "trips": dict(st.trips), "syncs": st.syncs, "busy": busy.share,
            "launches": launches, "leaf_launches": leaf,
            "k3": {k: v for k, v in t3.items() if k.endswith(("ms", "us"))},
            "k4": {k: v for k, v in t4.items() if k.endswith(("ms", "us"))}, "solve": ts,
            "k5": {k: {q: v for q, v in t.items() if q != "V"} for k, t in t5.items()}}
    entries = [
        {"name": "gk_leaf_dos_solve", "route": "cuda", "source": src + "gk_leaf_dos.cu",
         "replaces": "autobzcore_tpu/ops/adaptive.py:236", "launches": launches["gk_leaf_dos_solve"],
         "max_abs_err": ts["err"], "ms": ts["device_ms"] if ts["device_ms"] is not None else ts["ms"],
         "plain_ms": ts["plain_ms"], "bound_ms": ts["bound"][0], "bound_by": ts["bound"][1], "library_ms": None}]
    return cold, entries + [
        {"name": "fourier_contract", "route": "cuda", "source": src + "fourier_contract.cu",
         "replaces": "autobzcore_tpu/ops/fourier_eval.py:104", "launches": launches["fourier_contract"],
         "max_abs_err": t3["err"], "ms": t3["ms"], "plain_ms": t3["plain_ms"],
         "bound_ms": t3["bound"][0], "bound_by": t3["bound"][1], "library_ms": t3["library_ms"]},
        {"name": "gk_leaf_dos", "route": "cuda", "source": src + "gk_leaf_dos.cu",
         "replaces": "autobzcore_tpu/fourier.py:394", "launches": launches["gk_leaf_dos"],
         "max_abs_err": e4, "ms": t4["ms"], "plain_ms": t4["plain_ms"],
         "bound_ms": b4[0], "bound_by": b4[1], "library_ms": None},
        {"name": "gk_pool_start", "route": "cuda", "source": src + "gk_pool.cu",
         "replaces": rep + "378", "launches": launches["gk_pool_start"], "max_abs_err": t5["leaf_start"]["err"],
         "ms": t5["leaf_start"]["ms"], "plain_ms": t5["leaf_start"]["plain_ms"],
         "bound_ms": t5["leaf_start"]["bound"][0], "bound_by": t5["leaf_start"]["bound"][1], "library_ms": None},
        {"name": "gk_pool_step", "route": "cuda", "source": src + "gk_pool.cu",
         "replaces": rep + "422", "launches": launches["gk_pool_step"],
         "max_abs_err": max(t5[k]["err"] for k in ("mid_step", "outer_step", "nb4_step")),
         "ms": t5["mid_step"]["ms"], "plain_ms": t5["mid_step"]["plain_ms"], "bound_ms": t5["mid_step"]["bound"][0],
         "bound_by": t5["mid_step"]["bound"][1], "library_ms": t5["mid_step"]["library_ms"]},
    ]


def warm_phases(np, torch, dev, h, cold):
    """Phases 9-10: the warm IAI main path (two calls) with K6 and K5's seed
    entry checked against their plain versions between them. Returns the
    two kernels' JSON entries and each call's numbers (wall, numevals,
    trips, syncs, launches, busy share) by ``"call1"``, ``"call2"``."""
    import copy

    from autobzcore_torch import PTR, IntegralProblem, solve
    from autobzcore_torch.algorithms.nested import _mid_seed_pool
    from autobzcore_torch.interop import pool_to_arrays
    from autobzcore_torch.models.observables import dos_integrand, gk_leaf_dos
    from autobzcore_torch.ops import adaptive as tad
    from autobzcore_torch.ops.fourier_eval import fourier_contract

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    from torch_parity import dyadic_pools

    src = "autobzcore_torch/csrc/"
    bz, oms = cold["bz"], cold["oms"]
    prob = IntegralProblem(dos_integrand(h, ETA), bz)

    def warm_sweep(chunk, plain=False):
        return warm_iai_sweep(prob, chunk, plain)

    def reset():
        fourier_contract.launches = gk_leaf_dos.launches = 0
        tad.coarsen_pool.launches = 0
        k5_launches(reset=True)
        leaf_solve_launches(reset=True)

    def launches():
        return {"fourier_contract": fourier_contract.launches, "gk_leaf_dos": gk_leaf_dos.launches,
                **k5_launches(), "coarsen_pool": tad.coarsen_pool.launches,
                "gk_leaf_dos_solve": leaf_solve_launches()}

    def run(sweep, xs):
        before = copy.deepcopy(sweep.stats)
        ne0, nchunks = sweep.numevals, len(sweep.chunk_evals)
        reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with SmiBusy() as busy:
            t0 = time.perf_counter()
            d = sweep(xs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        st = sweep.stats
        delta = lambda new, old: {k: v - old.get(k, 0) for k, v in sorted(new.items(), reverse=True)}  # noqa: E731
        ne = sweep.numevals - ne0
        out = {"d": d, "wall": wall, "launches": launches(), "numevals": ne,
               "harvest": ne - sum(sweep.chunk_evals[nchunks:]), "trips": delta(st.trips, before.trips),
               "seed_trips": delta(st.seed_trips, before.seed_trips), "syncs": st.syncs - before.syncs,
               "peak": torch.cuda.max_memory_allocated() / 2**20, "busy": busy.share, "retcode": sweep.retcode}
        out["leaf_launches"] = out["launches"]["gk_leaf_dos"] + out["launches"]["gk_leaf_dos_solve"]
        pool = pool_to_arrays(sweep._pool)
        print(f"warm IAI call ({len(xs)} omegas in [{xs.min():.4g}, {xs.max():.4g}]): wall {wall:.3f} s "
              f"({wall / len(xs):.4f} s/omega); numevals {ne} (harvests {out['harvest']:.0f}); retcode "
              f"{sweep.retcode}; trips (level 3 outer, 2 mid, 1 leaf) {out['trips']}, seed trips "
              f"{out['seed_trips']}; host syncs {out['syncs']} ({out['syncs'] / len(xs):.1f} per omega); "
              f"launches {out['launches']}; leaf launches {out['leaf_launches']}; device busy {busy.text()} "
              f"(nvidia-smi); carried pool: outer n {pool[3]}, mid tn {pool[4][3]}; "
              f"chunk evals {sweep.chunk_evals[nchunks:]}; peak device memory {out['peak']:.1f} MiB",
              flush=True)
        if not sweep.retcode or d.shape != xs.shape or not np.all(np.isfinite(d)):
            fail(f"warm IAI sweep: retcode {sweep.retcode}, shape {d.shape}")
        return out

    # 10, call 1: the 33 frequencies of phase 7's cold chunk ----------------------
    sweep = warm_sweep(IAI_OMEGAS)
    c1 = run(sweep, oms)
    ratio = c1["numevals"] / cold["numevals"]
    dcold = float(np.max(np.abs(c1["d"] - cold["d"])))
    dptr = float(np.max(np.abs(c1["d"] - cold["d_ptr"])))
    print(f"warm call 1 vs phase 7's cold chunk on the same omegas: evals {c1['numevals']} vs "
          f"{cold['numevals']} (warm/cold {ratio:.4f}); wall {c1['wall']:.3f} s vs {cold['wall']:.3f} s; "
          f"max|d D| {dcold:.3e} (<= 2 abstol); vs PTR(npt=400) max|d| {dptr:.4e} (<= "
          f"{1e-2 * np.max(np.abs(cold['d_ptr'])):.4e})", flush=True)
    if not dcold <= 2 * IAI_ABSTOL:
        fail(f"warm and cold IAI values differ by {dcold:.3e}")
    if not dptr <= 1e-2 * np.max(np.abs(cold["d_ptr"])):
        fail(f"warm IAI and PTR(npt=400) differ by {dptr:.3e}")

    # 9. K6 and K5's seed entry against their plain versions ----------------------
    pool = sweep._pool
    scale = abs(float(np.linalg.det(bz.B))) * bz.nsyms
    tol = torch.full((1,), IAI_ABSTOL / scale, dtype=torch.float64, device=dev)
    segs = torch.tensor([[0.0, 1.0]], dtype=torch.float64, device=dev)
    outer = (pool.a[None].contiguous(), pool.b[None].contiguous(), pool.e[None].contiguous(),
             pool.n.clone(), segs, tol)
    # the harvest's pool before its coarsening: the carried mid seed on the
    # mid level's domain, [0, 1] on the full zone at every outer node
    (ma, mb, me, mn), _ = _mid_seed_pool(pool.mid, segs)
    mid = (ma, mb, me, mn, segs, tol)
    rng = np.random.default_rng(9)
    cases = [("outer pool", outer), ("harvest pool", mid)]
    for cap, sg in ((64, [0.0, 0.3, 1.0]), (2048, [0.0, 0.125, 0.5])):
        a, b, e, n = dyadic_pools(rng, 40, cap, sg, dev)
        cases.append((f"40 random pools, cap {cap}",
                      (a, b, e, n, torch.tensor(sg, dtype=torch.float64, device=dev).expand(40, -1).contiguous(),
                       torch.as_tensor(10 ** rng.uniform(-7, -2, 40), device=dev))))
    merged, e6 = [], 0.0
    for name, args in cases:
        got, want = tad.coarsen_pool(*args), tad.coarsen_pool_plain(*args)
        if not all(torch.equal(g, wv) for g, wv in zip(got, want)):
            fail(f"K6 coarsen_pool vs plain on the {name}: pools differ")
        e6 = max([e6] + [float((g - wv).abs().max()) for g, wv in zip(got, want)])
        merged.append(f"{name}: n {args[3].tolist()[:3]} -> {want[2].tolist()[:3]}")
    t6 = {"ms": cuda_ms(lambda: tad.coarsen_pool(*outer), 200),
          "plain_ms": cuda_ms(lambda: tad.coarsen_pool_plain(*outer), 20)}
    cap_o = pool.a.shape[0]
    b6 = bound(cap_o * 24, nbytes(*outer) + 2 * cap_o * 8 + 8)
    # the seed entry: the coarsened outer pool seeded chunk by chunk (C = 8)
    # from random node values with counts, the first chunk starting the pool
    # from the partition and the last making the first picks; then the mid
    # shape of an outer seed trip (120 lanes = 8 intervals x 15 nodes, cap
    # 64, C = 2), some lanes idle. The plain version takes the node values
    # reduced by the reduction alone (the entry's bits).
    a_c, b_c, n0 = tad.coarsen_pool(*outer)
    xk, wk, wg = tad.gk_rule(7, dev)
    P = xk.shape[0]

    def chunk_kids(g, a_s, b_s, start, C, seeding, kernel):
        live = seeding.nonzero().squeeze(1)
        _, half = tad.gk_nodes(a_s[live, start:start + C], b_s[live, start:start + C], xk)
        fx = torch.as_tensor(g.normal(size=(live.numel(), C, P)), device=dev)
        cnt = torch.as_tensor(g.integers(15, 5000, (live.numel(), C, P)).astype(np.float64), device=dev)
        kids = tad.NodeChildren(fx, cnt, half.contiguous(), live, wk, wg)
        return kids if kernel else tad.ReducedChildren(*tad.gk_rule_reduce(fx, cnt, kids.half, wk, wg), live)

    def seeded(kernel, L, cap, C, a_s, b_s, n_s, trips, seeding):
        g = np.random.default_rng(10)
        pl = tad._empty_pool(L, cap, (), torch.float64, dev, torch.full((L,), 1e-6, dtype=torch.float64, device=dev),
                             0.0, None)
        seed_fn = tad.gk_pool_seed if kernel else tad.gk_pool_seed_plain
        for k in range(trips):
            start = min(k * C, cap - C)
            seed_fn(pl, start, chunk_kids(g, a_s, b_s, start, C, seeding, kernel), n_s, seeding, 1,
                    partition=(a_s, b_s) if k == 0 else None, select=k == trips - 1)
        return pl

    e5d = 0.0
    n0h = int(n0[0])
    shapes = [(1, cap_o, 8, a_c, b_c, n0, -(-n0h // 8), torch.ones(1, dtype=torch.bool, device=dev))]
    ra, rb, _, rn = dyadic_pools(rng, 120, 64, [0.0, 1.0], dev)
    shapes.append((120, 64, 2, ra, rb, rn, 16, torch.as_tensor(rng.random(120) > 0.1, device=dev)))
    for L, cap, C, a_s, b_s, n_s, trips, seeding in shapes:
        got = seeded(True, L, cap, C, a_s, b_s, n_s, trips, seeding)
        want = seeded(False, L, cap, C, a_s, b_s, n_s, trips, seeding)
        same, rel, err = k5_same(got, want, picks=True)
        if not (same and rel <= 1e-14):
            fail(f"K5 seed entry vs plain at {L} lanes x cap {cap}: pools and picks identical {same}, "
                 f"totals and tol rel {rel:.3e}")
        e5d = max(e5d, err)
    L, cap, C = 120, 64, 2
    seeding = shapes[1][7]
    sp, spp = seeded(True, L, cap, C, ra, rb, rn, 1, seeding), seeded(False, L, cap, C, ra, rb, rn, 1, seeding)
    g = np.random.default_rng(11)
    kids = chunk_kids(g, ra, rb, 4, C, seeding, True)
    red = tad.ReducedChildren(*tad.gk_rule_reduce(kids.fx, kids.counts, kids.half, wk, wg), kids.live)
    seed_run = lambda: tad.gk_pool_seed(sp, 4, kids, rn, seeding, 1)  # noqa: E731
    t5d = {"ms": cuda_ms(seed_run, 200), "device_ms": device_ms(seed_run, 50, "gk_pool_seed"),
           "host_us": host_us(seed_run, 200),
           "plain_ms": cuda_ms(lambda: tad.gk_pool_seed_plain(spp, 4, red, rn, seeding, 1), 50)}
    # the seeding lanes write err, l1 and val at C slots; every lane's totals
    # read its pool's err and val
    b5d = bound(kids.fx.numel() * 6, nbytes(kids.fx, kids.counts, kids.half, rn, seeding)
                + 3 * kids.fx.shape[0] * C * 8 + nbytes(sp.err, sp.val) + L * 6 * 8)
    print(f"K6 coarsen_pool vs plain: identical a2, b2, n2 (max|d| {e6:.3e}) on {'; '.join(merged)}; "
          f"at 1 lane x cap "
          f"{cap_o}: {t6['ms']:.4f} ms (plain {t6['plain_ms']:.4f}; bound {b6[0]:.6f} ms by {b6[1]}). "
          f"K5 seed vs plain: identical seeded pools and first picks, max|d| over totals and tol {e5d:.3e} "
          f"(outer: {-(-n0h // 8)} chunks of 8 into cap {cap_o}; mid: 120 lanes x cap 64, C = 2); at 120 x 64: "
          f"{t5d['ms']:.4f} ms by events (device {ms_text(t5d['device_ms'])}, host {t5d['host_us']:.1f} us; "
          f"plain {t5d['plain_ms']:.4f}; bound {b5d[0]:.6f} ms by {b5d[1]})", flush=True)

    # 10, call 2: the midpoints, as the next interpolation frontier -----------------
    mids = (oms[:-1] + oms[1:]) / 2
    c2 = run(sweep, mids)
    d_ptr2 = solve(IntegralProblem(dos_integrand(h, ETA), bz, torch.as_tensor(mids, device=dev)),
                   PTR(npt=400)).u.cpu().numpy()
    dptr2 = float(np.max(np.abs(c2["d"] - d_ptr2)))
    print(f"warm call 2 vs PTR(npt=400) at the midpoints: max|d| {dptr2:.4e} (<= "
          f"{1e-2 * np.max(np.abs(d_ptr2)):.4e}); both calls: {c1['wall'] + c2['wall']:.3f} s for "
          f"{len(oms) + len(mids)} omegas", flush=True)
    if not dptr2 <= 1e-2 * np.max(np.abs(d_ptr2)):
        fail(f"warm IAI and PTR(npt=400) differ by {dptr2:.3e} at the midpoints")
    total = {k: c1["launches"][k] + c2["launches"][k] for k in c1["launches"]}
    if min(total.values()) <= 0:
        fail(f"the warm IAI main path did not go through every kernel: {total}")
    if "--profile" in sys.argv[1:]:
        profile("warm IAI chunk", lambda: warm_sweep(IAI_OMEGAS)(oms))

    # the warm chain on the plain versions, at the two cheapest neighbours
    i = int(np.argmin(cold["ne"]))
    j = i + 1 if i + 1 < len(oms) and (i == 0 or cold["ne"][i + 1] <= cold["ne"][i - 1]) else i - 1
    pair = np.sort(oms[[i, j]])
    res = []
    for plain in (False, True):
        t0 = time.perf_counter()
        sw = warm_sweep(2, plain)
        res.append((sw(pair), sw.numevals, pool_to_arrays(sw._pool), sw.retcode, time.perf_counter() - t0))
    (dk, nk, pk, rk, tk), (dp, npl, pp, rp, tp) = res
    same_pool = (pk[3] == pp[3] and pk[4][3] == pp[4][3] and np.array_equal(pk[0], pp[0])
                 and np.array_equal(pk[1], pp[1]) and np.array_equal(pk[4][0], pp[4][0]))
    dpair = float(np.max(np.abs(dk - dp)))
    print(f"warm chain on the plain versions at omegas {pair.round(4).tolist()}: numevals {npl} vs {nk} "
          f"(kernels), carried pools identical {same_pool}, max|d D| {dpair:.3e} (<= abstol); "
          f"plain {tp:.3f} s, kernels {tk:.3f} s", flush=True)
    if not (npl == nk and same_pool and dpair <= IAI_ABSTOL and rk and rp):
        fail(f"warm IAI kernels vs plain path: numevals {nk} vs {npl}, pools {same_pool}, max|d| {dpair:.3e}")

    numbers = {f"call{i}": {k: v for k, v in c.items() if k != "d"} for i, c in ((1, c1), (2, c2))}
    return [
        {"name": "coarsen_pool", "route": "cuda", "source": src + "gk_coarsen.cu",
         "replaces": "autobzcore_tpu/ops/adaptive.py:143", "launches": total["coarsen_pool"],
         "max_abs_err": e6, "ms": t6["ms"], "plain_ms": t6["plain_ms"], "bound_ms": b6[0],
         "bound_by": b6[1], "library_ms": None},
        {"name": "gk_pool_seed", "route": "cuda", "source": src + "gk_pool.cu",
         "replaces": "autobzcore_tpu/ops/adaptive.py:344", "launches": total["gk_pool_seed"],
         "max_abs_err": e5d, "ms": t5d["ms"], "plain_ms": t5d["plain_ms"], "bound_ms": b5d[0],
         "bound_by": b5d[1], "library_ms": None}], numbers


def fullgrid_phases(np, torch, dev, h, cold):
    """Phases 11-13: K7, K8 and K9 against their plain versions, the
    full-grid ladder main path and the bench lane. Returns the three
    kernels' JSON entries and the ladder's certified DOS at its 1000
    omegas."""
    from autobzcore_torch import FBZ, DOSProblem, load_bz
    from autobzcore_torch.dos import LorentzianFullGrid
    from autobzcore_torch.dos import init as dos_init
    from autobzcore_torch.ops import eigh3
    from autobzcore_torch.ops import grid_sweep as gs
    from autobzcore_torch.ops.fourier_eval import evaluate_grid

    src = "autobzcore_torch/csrc/"
    eta = ETA
    ws = np.linspace(*WINDOW, FULLGRID_OMEGAS)
    bz = load_bz(FBZ(), np.eye(3))
    det_b = abs(float(np.linalg.det(bz.B)))
    u100 = [np.arange(NPT) / NPT] * 3

    # 11. K9, K8, K7 against their plain versions ----------------------------------
    Hg = evaluate_grid(h.c, 3, u100, h.offset, h.period).reshape(-1, 3, 3).contiguous()
    K = Hg.shape[0]
    e9 = eigh3.eigvalsh_small(Hg)
    p9 = eigh3.eigvalsh_small_plain(Hg)
    torch.cuda.synchronize()
    scale9 = float(p9.abs().max())
    err9 = float((e9 - p9).abs().max())
    sub = torch.arange(0, K, max(1, K // 4096), device=dev)[:4096]
    err9np = float(np.abs(e9[sub].cpu().numpy() - np.linalg.eigvalsh(Hg[sub].cpu().numpy())).max())
    if not (err9 <= 1e-12 * scale9 and err9np <= 1e-12 * scale9):
        fail(f"K9 eigvalsh_small: max|d| vs plain {err9:.3e}, vs numpy {err9np:.3e} > 1e-12 x {scale9:.3e}")
    t9 = {"ms": cuda_ms(lambda: eigh3.eigvalsh_small(Hg), 20),
          "plain_ms": cuda_ms(lambda: eigh3.eigvalsh_small_plain(Hg), 5)}
    # the library: torch.linalg.eigvalsh, whose batched cuSOLVER path refuses
    # large batches; the largest batch it takes, then all K in such batches
    refused, lib_batch = [], None
    for B in (K, 1 << 18, 1 << 16, 1 << 15, 1 << 14, 1 << 13, 1 << 12):
        try:
            torch.linalg.eigvalsh(Hg[:B])
            torch.cuda.synchronize()
            lib_batch = B
            break
        except RuntimeError as ex:
            refused.append(f"{B}: {str(ex).splitlines()[0][:60]}")
    if lib_batch is None:
        fail(f"torch.linalg.eigvalsh refused every batch tried: {refused}")
    lib_one = cuda_ms(lambda: torch.linalg.eigvalsh(Hg[:lib_batch]), 5)
    elib = float((eigh3.eigvalsh_chunked(Hg, lib_batch) - p9).abs().max())
    t9["library_ms"] = cuda_ms(lambda: eigh3.eigvalsh_chunked(Hg, lib_batch), 2)
    b9 = bound(K * EIG3_FLOPS, nbytes(Hg, e9))
    print(f"K9 eigvalsh_small: {K} flagship 3x3 matrices (100^3 grid): max|d| vs plain {err9:.3e}, vs numpy "
          f"on 4096 {err9np:.3e} (<= 1e-12 x {scale9:.4f}); {t9['ms']:.4f} ms (plain {t9['plain_ms']:.4f}; "
          f"bound {b9[0]:.4f} ms by {b9[1]}); torch.linalg.eigvalsh refused {refused or 'nothing'}, took "
          f"{lib_batch} in {lib_one:.4f} ms, all {K} in batches of {lib_batch}: {t9['library_ms']:.4f} ms "
          f"(max|d| {elib:.3e})", flush=True)

    om = torch.as_tensor(ws, device=dev)
    k8 = gs.lorentzian_sum(e9, None, om, eta, 1 / (math.pi * K))
    k8b = gs.lorentzian_sum(e9, None, om, eta, 1 / (math.pi * K))
    p8 = gs.lorentzian_sum_plain(e9, None, om, eta, 1 / (math.pi * K))
    torch.cuda.synchronize()
    err8 = float((k8 - p8).abs().max())
    if not (err8 <= 1e-12 * float(p8.abs().max()) and torch.equal(k8, k8b)):
        fail(f"K8 lorentzian_sum vs plain: max|d| {err8:.3e}, repeat identical {torch.equal(k8, k8b)}")
    t8 = {"ms": cuda_ms(lambda: gs.lorentzian_sum(e9, None, om, eta), 10),
          "plain_ms": cuda_ms(lambda: gs.lorentzian_sum_plain(e9, None, om, eta), 2)}
    b8 = bound(e9.numel() * FULLGRID_OMEGAS * LORENTZ_FLOPS, nbytes(e9, om) + 8 * FULLGRID_OMEGAS)
    print(f"K8 lorentzian_sum: ({K}, 3) eigenvalues x {FULLGRID_OMEGAS} omegas: max|d| vs plain {err8:.3e} "
          f"(<= 1e-12 max|D|), repeat bit-identical; {t8['ms']:.4f} ms (plain {t8['plain_ms']:.4f}; bound "
          f"{b8[0]:.4f} ms by {b8[1]})", flush=True)
    del p9

    # K7: one slab of the npt = 400 rung at the ladder's padded width
    fg = LorentzianFullGrid(eta, nmin=FULLGRID_NMIN, nmax=FULLGRID_NMAX)
    cache = dos_init(DOSProblem(h, ws, bz), fg, abstol=FULLGRID_ABSTOL)
    eng = fg._engine(cache.cacheval, ws)
    W = eng.omegas.size
    prep = eng._prepare(FULLGRID_NMIN)
    planes, wrow = eng.slab_planes(prep, prep["nslab"] // 2)

    def tail(fn):
        return fn(planes, 3, wrow, FULLGRID_NMIN, eng._om, eta, torch.zeros(W, dtype=torch.float64, device=dev))

    k7, k7b, p7 = tail(gs.fullgrid_tail), tail(gs.fullgrid_tail), tail(gs.fullgrid_tail_plain)
    torch.cuda.synchronize()
    err7 = float((k7 - p7).abs().max())
    rel7 = err7 / float(p7.abs().max())
    if not (rel7 <= 1e-12 and torch.equal(k7, k7b)):
        fail(f"K7 fullgrid_tail vs plain: max rel {rel7:.3e}, repeat identical {torch.equal(k7, k7b)}")
    t7 = {"ms": cuda_ms(lambda: tail(gs.fullgrid_tail), 10), "plain_ms": cuda_ms(lambda: tail(gs.fullgrid_tail_plain), 1)}
    npts7 = planes.shape[1]
    b7 = bound(npts7 * (3 * W * LORENTZ_FLOPS + EIG3_FLOPS), nbytes(planes, wrow, eng._om) + 2 * 8 * W)
    print(f"K7 fullgrid_tail: one npt={FULLGRID_NMIN} slab ({npts7} points, {eng.slab} rows) x {W} omegas: max rel vs plain "
          f"{rel7:.3e} (<= 1e-12), repeat bit-identical; {t7['ms']:.4f} ms (plain {t7['plain_ms']:.4f}; bound "
          f"{b7[0]:.4f} ms by {b7[1]})", flush=True)
    del planes, prep, Hg, e9
    torch.cuda.empty_cache()

    # 12. the full-grid ladder main path -------------------------------------------
    # the stage products' own time over the npt = 400 rung's slabs
    prep = eng._prepare(FULLGRID_NMIN)
    t_stages = cuda_ms(lambda: [eng.slab_planes(prep, i) for i in range(prep["nslab"])], 2)
    # their bound: the complex products' operations (8 per multiply-add) and
    # bytes (I3 and the phase tables read, every slab's planes written once)
    S, n1, n2, ne, npt0 = eng.slab, eng.n1, eng.n2, eng.ne, FULLGRID_NMIN
    nslab = prep["nslab"]
    b_st = bound(nslab * 8 * (S * n1 * n2 * ne * npt0 + ne * npt0 * n2 * S * npt0),
                 nbytes(prep["I3"], prep["P1"], prep["P2"]) + nslab * ne * npt0 * S * npt0 * 16)
    # the whole rung: every point's eigenvalues and Lorentzian terms, and the
    # stage products; it reads the coefficients and writes W values
    b_rung = bound(npt0**3 * (3 * W * LORENTZ_FLOPS + EIG3_FLOPS) + b_st[0] * PEAK_FP64 / 1e3,
                   nbytes(eng.c6) + 2 * 8 * W)
    del prep
    fg = LorentzianFullGrid(eta, nmin=FULLGRID_NMIN, nmax=FULLGRID_NMAX)
    cache = dos_init(DOSProblem(h, ws, bz), fg, abstol=FULLGRID_ABSTOL)
    gs.fullgrid_tail.launches = gs.lorentzian_sum.launches = eigh3.eigvalsh_small.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    D, ok = fg.dos_sweep(cache.cacheval, ws, abstol=FULLGRID_ABSTOL, with_status=True)
    D = D * det_b
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches12 = gs.fullgrid_tail.launches
    peak = torch.cuda.max_memory_allocated() / 2**20
    log = list(cache.cacheval["rung_log"])
    nev = sum(r["npt"] ** 3 for r in log)
    i125 = int(np.argmin(np.abs(ws - 0.5)))
    rung_txt = "; ".join(f"npt {r['npt']}: {r['seconds']:.3f} s, delta "
                         + ("-" if r["delta"] is None else f"{r['delta']:.3e}") for r in log)
    print(f"full-grid main path: flagship FBZ, eta {eta}, {FULLGRID_OMEGAS} omegas in {list(WINDOW)}, abstol "
          f"{FULLGRID_ABSTOL}: wall {wall:.3f} s; rungs [{rung_txt}]; retcode {ok}; numevals {nev}; K7 "
          f"launches {launches12}; stage products of the npt={FULLGRID_NMIN} rung {t_stages:.3f} ms (bound "
          f"{b_st[0]:.3f} ms by {b_st[1]}); rung bound {b_rung[0]:.3f} ms by {b_rung[1]}; peak device memory "
          f"{peak:.1f} MiB; hint {cache.cacheval.get('ladder_hint')}; DOS({ws[i125]:.4f}) = {D[i125]:.6f}",
          flush=True)
    if launches12 <= 0:
        fail("the full-grid main path did not go through K7")
    if not ok or D.shape != (FULLGRID_OMEGAS,) or not np.all(np.isfinite(D)):
        fail(f"full-grid ladder: retcode {ok}, shape {D.shape}")
    if "--profile" in sys.argv[1:]:
        def ladder():
            f2 = LorentzianFullGrid(eta, nmin=FULLGRID_NMIN, nmax=FULLGRID_NMAX)
            c2 = dos_init(DOSProblem(h, ws, bz), f2, abstol=FULLGRID_ABSTOL)
            f2.dos_sweep(c2.cacheval, ws, abstol=FULLGRID_ABSTOL)

        profile("full-grid main path", ladder)

    # the npt = 400 rung at phase 7's 33 omegas against PTR(npt=400): the same
    # nodes arange(npt)/npt, reached through K1 + K2's adjugate trace
    e33 = gs.FullGridSpectralSweep(h, cold["oms"], eta)
    d33 = det_b * e33.rung(FULLGRID_NMIN) / FULLGRID_NMIN**3
    dmax = float(np.max(np.abs(cold["d_ptr"])))
    dptr = float(np.max(np.abs(d33 - cold["d_ptr"])))
    print(f"full-grid npt={FULLGRID_NMIN} rung vs PTR(npt={FULLGRID_NMIN}) at {len(cold['oms'])} omegas: max|d| {dptr:.3e} (<= 1e-10 "
          f"max|D| = {1e-10 * dmax:.3e})", flush=True)
    if not dptr <= 1e-10 * dmax:
        fail(f"the full-grid rung and PTR(npt={FULLGRID_NMIN}) differ by {dptr:.3e}")

    # a second sweep at the midpoints replays the certifying pair
    hint = cache.cacheval["ladder_hint"]
    mids = (ws[:-1] + ws[1:]) / 2
    t0 = time.perf_counter()
    sol = fg.dos_solve(h, mids, bz, cache.cacheval, abstol=FULLGRID_ABSTOL)
    t_mid = time.perf_counter() - t0
    want = hint[0] ** 3 + hint[1] ** 3
    print(f"full-grid sweep at the {mids.size} midpoints: numevals {sol.numevals} (the pair {hint[:2]}: "
          f"{want}), retcode {sol.retcode}, {t_mid:.3f} s", flush=True)
    if not (sol.retcode and sol.numevals == want and np.all(np.isfinite(sol.u))):
        fail(f"the midpoint sweep did not replay the certifying pair: numevals {sol.numevals} vs {want}")

    # an npt = 64 rung through the plain tail against the kernel's
    wpad = eng.omegas
    t64 = []
    for plain in (False, True):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t64.append(gs.FullGridSpectralSweep(h, wpad, eta, plain_kernels=plain).rung(FULLGRID_PLAIN_NPT))
        t64.append(time.perf_counter() - t0)
    r_k, tk64, r_p, tp64 = t64
    rel64 = float(np.max(np.abs(r_k - r_p)) / np.max(np.abs(r_p)))
    print(f"full-grid npt={FULLGRID_PLAIN_NPT} rung, kernel vs plain tail at {wpad.size} omegas: max rel {rel64:.3e} "
          f"(<= 1e-12); kernel tail {tk64 * 1e3:.2f} ms, plain tail {tp64 * 1e3:.2f} ms", flush=True)
    if not rel64 <= 1e-12:
        fail(f"the npt={FULLGRID_PLAIN_NPT} rung's kernel and plain tails differ by {rel64:.3e}")
    torch.cuda.empty_cache()

    # 13. the bench lane: H(k) + eigenvalues, then the 1000-omega sweep -------------
    gs.fullgrid_tail.launches = gs.lorentzian_sum.launches = eigh3.eigvalsh_small.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    e = eigh3.eigvalsh_small(evaluate_grid(h.c, 3, u100, h.offset, h.period).reshape(-1, 3, 3))
    torch.cuda.synchronize()
    t_one = time.perf_counter() - t0
    reps = 20
    t0 = time.perf_counter()
    chk = torch.zeros((), dtype=torch.float64, device=dev)
    for _ in range(reps):
        chk = chk + eigh3.eigvalsh_small(evaluate_grid(h.c, 3, u100, h.offset, h.period).reshape(-1, 3, 3)).sum()
    float(chk)
    t_amort = (time.perf_counter() - t0) / reps
    omb = torch.linspace(10.0, 15.0, 1000, dtype=torch.float64, device=dev)
    d = gs.lorentzian_sum(e, None, omb, 0.01, 1 / (math.pi * e.shape[0]))
    float(d.sum())
    t0 = time.perf_counter()
    d = gs.lorentzian_sum(e, None, omb, 0.01, 1 / (math.pi * e.shape[0]))
    float(d.sum())
    t_sweep = (time.perf_counter() - t0) * 1e3
    launches13 = {"eigvalsh_small": eigh3.eigvalsh_small.launches, "lorentzian_sum": gs.lorentzian_sum.launches}
    print(f"bench lane: flagship H(k) + K9 eigenvalues on the {NPT}^3 grid: one pass {t_one * 1e3:.3f} ms, "
          f"{NPT**3 / t_amort:.4g} k-points/s over {reps} chained passes; 1000-omega sweep [10, 15] eV, eta "
          f"0.01, by K8: {t_sweep:.3f} ms (max D {float(d.max()):.4e}, finite {bool(torch.isfinite(d).all())}); "
          f"launches {launches13}", flush=True)
    if min(launches13.values()) <= 0 or not bool(torch.isfinite(d).all()):
        fail(f"the bench lane did not go through K8 and K9: {launches13}")

    return [
        {"name": "fullgrid_tail", "route": "cuda", "source": src + "fullgrid_tail.cu",
         "replaces": "autobzcore_tpu/ops/grid_sweep.py:259", "launches": launches12, "max_abs_err": err7,
         "ms": t7["ms"], "plain_ms": t7["plain_ms"], "bound_ms": b7[0], "bound_by": b7[1],
         "library_ms": None},
        {"name": "lorentzian_sum", "route": "cuda", "source": src + "lorentzian_sum.cu",
         "replaces": "autobzcore_tpu/ops/grid_sweep.py:289", "launches": launches13["lorentzian_sum"],
         "max_abs_err": err8, "ms": t8["ms"], "plain_ms": t8["plain_ms"], "bound_ms": b8[0],
         "bound_by": b8[1], "library_ms": None},
        {"name": "eigvalsh_small", "route": "cuda", "source": src + "eigh_small.cu",
         "replaces": "autobzcore_tpu/ops/eigh3.py:161", "launches": launches13["eigvalsh_small"],
         "max_abs_err": err9, "ms": t9["ms"], "plain_ms": t9["plain_ms"], "bound_ms": b9[0],
         "bound_by": b9[1], "library_ms": t9["library_ms"]},
    ], D


def once_ms(fn):
    """Milliseconds of one run of ``fn()`` by CUDA events, no warm-up (for
    plain versions that take seconds)."""
    import torch

    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop)


def timed_once(fn):
    """(value, milliseconds) of one run of ``fn()`` by CUDA events, no
    warm-up (for plain versions that take seconds)."""
    import torch

    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    value = fn()
    stop.record()
    torch.cuda.synchronize()
    return value, start.elapsed_time(stop)


def band_grid(np, rng, m, npt, d):
    """A band-major grid (m, npt^d) of smooth periodic bands: a cosine band
    (with exact ties) and m - 1 random ones."""
    x = np.meshgrid(*[np.arange(npt) / npt] * d, indexing="ij")
    bands = [sum(np.cos(2 * np.pi * xi) for xi in x)]
    for _ in range(m - 1):
        ph = rng.random(d)
        bands.append(sum(rng.normal() * np.cos(2 * np.pi * (xi + q)) for xi, q in zip(x, ph)) + rng.normal())
    return np.stack([b.reshape(-1) for b in bands])


def ltm_phases(np, torch, dev, h):
    """Phases 14-15: K10 against its plain version, then the LTM main path.
    Returns K10's JSON entry and the leg's numbers: the LTM DOS at the 1001
    energies (``dos``), K10's times (``k10``) and the path's walls
    (``ltm``)."""
    from autobzcore_torch import FBZ, CubicSymIBZ, DOSProblem, load_bz
    from autobzcore_torch.dos import LTM
    from autobzcore_torch.dos import init as dos_init
    from autobzcore_torch.dos import solve_ as dos_solve_
    from autobzcore_torch.dos import tetrahedron as tet
    from autobzcore_torch.models.tight_binding import tb_integer
    from autobzcore_torch.ops import eigh3
    from autobzcore_torch.ops.fourier_eval import evaluate_grid

    src = "autobzcore_torch/csrc/"
    bz = load_bz(FBZ(), np.eye(3))
    ws = np.linspace(*WINDOW, LTM_ENERGIES)
    E = torch.as_tensor(ws, device=dev)

    # 14. K10 against its plain version ------------------------------------------
    cv = LTM(npt=NPT).init_cacheval(h, 0.0, bz)
    eg, tol, vol = cv["eg"], cv["tol"], cv["vol"]
    got = {nos: [tet.tetra_dos(eg, 3, E, tol, vol, nos) for _ in range(2)] for nos in (False, True)}
    sub = np.round(np.linspace(0, LTM_ENERGIES - 1, 64)).astype(np.int64)
    p_dos = tet.tetra_dos_plain(eg, 3, E, tol, vol)
    p_nos = tet.tetra_dos_plain(eg, 3, E[sub], tol, vol, nos=True)
    torch.cuda.synchronize()
    err10 = float((got[False][0] - p_dos).abs().max())
    scale10 = {False: float(p_dos.abs().max()), True: float(p_nos.abs().max())}
    rel = {"dos": err10 / scale10[False],
           "nos": float((got[True][0][sub] - p_nos).abs().max() / p_nos.abs().max())}
    same = all(torch.equal(a, b) for a, b in got.values())
    if not (max(rel.values()) <= 1e-12 and same):
        fail(f"K10 tetra_dos vs plain at the flagship: max rel {rel}, repeat identical {same}")
    small = []
    rng = np.random.default_rng(14)
    for d, npt, m in ((1, 4096, 3), (2, 256, 2)):
        g = torch.as_tensor(band_grid(np, rng, m, npt, d), device=dev).contiguous()
        lo, hi = float(g.min()), float(g.max())
        Es = torch.linspace(lo - 0.5, hi + 0.5, LTM_ENERGIES, dtype=torch.float64, device=dev)
        t_, v_ = 1e-9 * (hi - lo), 1.0 / (len(tet._SIMPLICES[d]) * npt**d)
        for nos in (False, True):
            k = tet.tetra_dos(g, d, Es, t_, v_, nos)
            pl = tet.tetra_dos_plain(g, d, Es, t_, v_, nos)
            r = float((k - pl).abs().max() / pl.abs().max())
            if not (r <= 1e-12 and torch.equal(k, tet.tetra_dos(g, d, Es, t_, v_, nos))):
                fail(f"K10 at d={d}, npt={npt}, m={m}, nos={nos}: max rel {r:.3e} or repeat differs")
            small.append(r)
    t10 = {"ms": cuda_ms(lambda: tet.tetra_dos(eg, 3, E, tol, vol), 5),
           "nos_ms": cuda_ms(lambda: tet.tetra_dos(eg, 3, E, tol, vol, True), 5),
           "plain_ms": once_ms(lambda: tet.tetra_dos_plain(eg, 3, E, tol, vol))}
    # the bound counts one support test per term and the closed form of the
    # (energy, term) pairs this energy grid puts inside the support; the
    # second reading repeats the test for every energy, as the kernel's
    # per-thread range test does at worst
    ec = tet.sorted_corners(eg, 3)
    n_terms = ec[0].numel()
    n_support = int((torch.searchsorted(E, ec[3].reshape(-1)) - torch.searchsorted(E, ec[0].reshape(-1))).sum())
    del ec
    b10 = bound(n_terms * TETRA_TEST_FLOPS + n_support * TETRA_SUPPORT_FLOPS, nbytes(eg, E) + 8 * LTM_ENERGIES)
    b10_each = bound(LTM_ENERGIES * n_terms * TETRA_TEST_FLOPS + n_support * TETRA_SUPPORT_FLOPS,
                     nbytes(eg, E) + 8 * LTM_ENERGIES)
    print(f"K10 tetra_dos: flagship eigenvalue grid (3, {NPT}^3), {n_terms} (simplex, band) terms x "
          f"{LTM_ENERGIES} energies ({n_support} inside their support): max rel vs plain DOS {rel['dos']:.3e}, "
          f"N(E) on 64 energies {rel['nos']:.3e} (<= 1e-12), d=1,2 small grids {max(small):.3e}; repeat "
          f"bit-identical; DOS {t10['ms']:.4f} ms, N(E) {t10['nos_ms']:.4f} ms (plain DOS {t10['plain_ms']:.1f} ms; "
          f"bound {b10[0]:.4f} ms by {b10[1]}: {TETRA_TEST_FLOPS} operations per term and {TETRA_SUPPORT_FLOPS} per "
          f"pair in the support; {b10_each[0]:.4f} ms with the test repeated for every energy)", flush=True)
    del got, p_dos, p_nos, cv
    torch.cuda.empty_cache()

    # 15. the LTM main path ----------------------------------------------------------
    def ltm_path():
        ltm = LTM(npt=NPT)
        cache = dos_init(DOSProblem(h, 0.5, bz), ltm)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        D = ltm.dos_sweep(cache.cacheval, ws)
        t2 = time.perf_counter()
        N = ltm.nos_sweep(cache.cacheval, ws)
        t3 = time.perf_counter()
        ef = ltm.fermi_level(cache.cacheval, 1.5)
        return ltm, cache, D, N, ef, (t1, t2, t3, time.perf_counter())

    tet.tetra_dos.launches = eigh3.eigvalsh_small.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ltm, cache, D, N, ef, (t1, t2, t3, t4) = ltm_path()
    launches = {"tetra_dos": tet.tetra_dos.launches, "eigvalsh_small": eigh3.eigvalsh_small.launches}
    peak = torch.cuda.max_memory_allocated() / 2**20
    u = [np.arange(NPT) / NPT] * 3
    t_grid = cuda_ms(lambda: evaluate_grid(h.c, 3, u, h.offset, h.period), 3)
    hk = evaluate_grid(h.c, 3, u, h.offset, h.period).reshape(-1, 3, 3)
    t_eig = cuda_ms(lambda: eigh3.eigvalsh_small(hk), 5)
    del hk
    integral = float(np.trapezoid(D, ws))
    eg = cache.cacheval["eg"]
    edges = np.concatenate([eg.min(1).values.cpu().numpy(), eg.max(1).values.cpu().numpy()])
    away = np.min(np.abs(ws[:, None] - edges[None]), axis=1) > 0.3
    dnd = float(np.max(np.abs(np.gradient(N, ws) - D)[away]))
    mono = float(np.min(np.diff(N)))
    print(f"LTM main path: flagship LTM(npt={NPT}), FBZ, {LTM_ENERGIES} energies in {list(WINDOW)}: init "
          f"{t1 - t0:.3f} s (grid products {t_grid:.3f} ms, K9 eigenvalues {t_eig:.3f} ms by event time; no "
          f"scatter on the full zone), dos_sweep {t2 - t1:.4f} s, nos_sweep {t3 - t2:.4f} s, fermi_level(1.5) "
          f"= {ef:.10f} in {t4 - t3:.4f} s; launches {launches}; peak device memory {peak:.1f} MiB; bands "
          f"{np.round(edges, 4).tolist()}", flush=True)
    if min(launches.values()) <= 0:
        fail(f"the LTM main path did not go through every kernel: {launches}")
    h1 = tb_integer(3, device=dev)
    vals = []
    for kind in (CubicSymIBZ(), FBZ()):
        vals.append(float(dos_solve_(dos_init(DOSProblem(h1, 0.8, load_bz(kind, np.eye(3))), LTM(npt=60))).u))
    rel_ibz = abs(vals[0] - vals[1]) / abs(vals[1])
    ws5 = np.array([-4.0, -1.0, 0.5, 2.0, 5.5])
    d5 = ltm.dos_sweep(cache.cacheval, ws5)
    p5 = tet.tetra_dos_plain(eg, 3, torch.as_tensor(ws5, device=dev), cache.cacheval["tol"],
                             cache.cacheval["vol"]).cpu().numpy()
    rel5 = float(np.max(np.abs(d5 - p5) / np.abs(p5)))
    print(f"LTM main path check: integral of D {integral:.10f} (3 within 2e-2); N(7 eV) {N[-1]:.15f} (3 within "
          f"1e-12); min step of N {mono:.3e} (monotone); max|dN/dE - D| {dnd:.3e} at {int(away.sum())} energies "
          f"0.3 eV from the band edges (<= 5e-2); tb_integer(3) npt=60 E=0.8: CubicSymIBZ {vals[0]:.15f} vs FBZ "
          f"{vals[1]:.15f} (rel {rel_ibz:.3e} <= 1e-12); 5 energies vs plain path: max rel {rel5:.3e} (<= 1e-12)",
          flush=True)
    if not (abs(integral - 3) <= 2e-2 and abs(N[-1] - 3) <= 1e-12 and mono >= -1e-12 and dnd <= 5e-2):
        fail(f"LTM checks: integral {integral}, N(7) {N[-1]}, monotone {mono}, dN/dE {dnd}")
    if not (rel_ibz <= 1e-12 and rel5 <= 1e-12 and np.all(np.isfinite(D)) and D.shape == ws.shape):
        fail(f"LTM checks: IBZ rel {rel_ibz:.3e}, 5 energies rel {rel5:.3e}")
    # the few-energy kernel (W <= 4, every Fermi step's launch) against the
    # plain version: at ef, below and above every band, at a grid eigenvalue,
    # unsorted and repeated; DOS and N(E) to 1e-12 of phase 14's value scale,
    # the DOS exactly 0 outside the bands, N(E) exactly 0 below them
    tol1, vol1 = cache.cacheval["tol"], cache.cacheval["vol"]
    lo, hi, eig = float(eg.min()), float(eg.max()), float(eg.reshape(-1)[12345])
    few_sets = ([ef], [lo - 1.0], [hi + 1.0], [ef, lo - 1.0], [hi + 1.0, ef, eig], [ef, lo - 1.0, hi + 1.0, ef])
    err_few = {False: 0.0, True: 0.0}
    for es in few_sets:
        Ef = torch.as_tensor(es, dtype=torch.float64, device=dev)
        out_ = (Ef < lo) | (Ef > hi)
        for nos in (False, True):
            k = tet.tetra_dos(eg, 3, Ef, tol1, vol1, nos)
            pl = tet.tetra_dos_plain(eg, 3, Ef, tol1, vol1, nos)
            err_few[nos] = max(err_few[nos], float((k - pl).abs().max()))
            zero = bool(torch.all(k[Ef < lo] == 0.0)) and (nos or bool(torch.all(k[out_] == 0.0)))
            if not (err_few[nos] <= 1e-12 * scale10[nos] and zero
                    and torch.equal(k, tet.tetra_dos(eg, 3, Ef, tol1, vol1, nos))):
                fail(f"K10 at {len(es)} energies {es} (nos={nos}): max|d| vs plain {err_few[nos]:.3e} (scale "
                     f"{scale10[nos]:.3e}), zero outside the bands {zero}, or a repeat differs")
    err10 = max(err10, err_few[False])
    print(f"K10 at 1-4 energies (the Fermi steps' kernel): {len(few_sets)} sets at ef = {ef:.10f}, below and above "
          f"the bands, a grid eigenvalue, unsorted and repeated: max|d| vs plain DOS {err_few[False]:.3e} "
          f"({err_few[False] / scale10[False]:.3e} of max|D|), N(E) {err_few[True]:.3e} "
          f"({err_few[True] / scale10[True]:.3e} of max|N|; <= 1e-12); DOS 0 outside the bands, N 0 below them; "
          f"repeats bit-identical", flush=True)
    # a Fermi-level step's call: N(E) at one energy (K10 and its column sum)
    E1 = torch.as_tensor([ef], dtype=torch.float64, device=dev)
    t_w1 = {"ms": cuda_ms(lambda: tet.tetra_dos(eg, 3, E1, tol1, vol1, True), 20),
            "device_ms": device_ms(lambda: tet.tetra_dos(eg, 3, E1, tol1, vol1, True), 20)}
    b_w1 = bound(n_terms * TETRA_TEST_FLOPS, nbytes(eg, E1) + 8)
    print(f"LTM Fermi step: N(E) at one energy {t_w1['ms']:.4f} ms a call by events, device "
          f"{ms_text(t_w1['device_ms'])} (torch.profiler; bound {b_w1[0]:.4f} ms by {b_w1[1]}); fermi_level(1.5) "
          f"{launches['tetra_dos'] - 2} steps, "
          f"{1e3 * (t4 - t3) / max(launches['tetra_dos'] - 2, 1):.4f} ms a step (host clock, with its host read)",
          flush=True)
    numbers = {"dos": D,
               "k10": dict(t10, w1_ms=t_w1["ms"], w1_device_ms=t_w1["device_ms"], bound_ms=b10[0],
                           w1_bound_ms=b_w1[0], few_err=[err_few[False], err_few[True]]),
               "ltm": {"init_s": t1 - t0, "dos_sweep_s": t2 - t1, "nos_sweep_s": t3 - t2, "fermi_s": t4 - t3,
                       "fermi_steps": launches["tetra_dos"] - 2, "launches": launches, "ef": ef}}
    if "--profile" in sys.argv[1:]:
        profile("LTM main path", ltm_path)
    del cache, eg
    torch.cuda.empty_cache()
    return [{"name": "tetra_dos", "route": "cuda", "source": src + "tetra_dos.cu",
             "replaces": "autobzcore_tpu/dos/tetrahedron.py:68", "launches": launches["tetra_dos"],
             "max_abs_err": err10, "ms": t10["ms"], "plain_ms": t10["plain_ms"], "bound_ms": b10[0],
             "bound_by": b10[1], "library_ms": None}], numbers


def block_phases(np, torch, dev, h, cold, wall_runs=BLOCK_WALL_RUNS):
    """Phases 16-17: K4's block entry, the fused leaf solve over a block and
    K5 at V = W against their plain versions (the solve against the trip
    route), then the omega-block IAI main path, ``wall_runs`` walls each.
    Returns the JSON entries of the block entry and the block solve, and
    each width's numbers (walls, numevals, trips, syncs, launches, busy
    share, K4's and the solve's times) by W."""
    import copy

    from autobzcore_torch import IAI, IntegralProblem
    from autobzcore_torch.models.observables import dos_integrand, gk_leaf_dos, gk_leaf_dos_plain
    from autobzcore_torch.ops import adaptive as tad
    from autobzcore_torch.ops.fourier_eval import fourier_contract, fourier_contract_plain
    from autobzcore_torch.parallel.sweep import SweepSolver

    src = "autobzcore_torch/csrc/"
    rng = np.random.default_rng(16)
    xk, wk, wg = tad.gk_rule(7, dev)
    P = xk.shape[0]
    c0 = h.c.reshape((1, 5, 5, 5, 9)).contiguous()
    step = (WINDOW[1] - WINDOW[0]) / (IAI_OMEGAS - 1)

    # 16. K4's block entry and K5 at V = W ---------------------------------------------
    def leaf_inputs(L, W):
        """Flagship 1-D coefficients at random (x3, x2), 2 intervals per lane,
        W adjacent frequencies of phase 7's spacing per lane."""
        x3 = torch.as_tensor(rng.random((1, L)), device=dev)
        c2 = fourier_contract_plain(c0, torch.zeros(1, dtype=torch.int64, device=dev), x3,
                                    h.offset[2], 1.0).reshape(L, 5, 5, 9)
        x2 = torch.as_tensor(rng.random((L, 1)), device=dev)
        c1 = fourier_contract_plain(c2, torch.arange(L, device=dev), x2, h.offset[1], 1.0)
        a0 = torch.as_tensor(rng.random((L, 2)) * 0.5, device=dev)
        b0 = (a0 + torch.as_tensor(rng.random((L, 2)) * 0.5, device=dev)).contiguous()
        om = torch.as_tensor(rng.uniform(WINDOW[0], WINDOW[1] - W * step, (L, 1)) + step * np.arange(W),
                             device=dev).contiguous()
        return (c1.reshape(L, 5, 9).contiguous(), torch.arange(L, device=dev), h.offset[0], 1.0,
                a0.contiguous(), b0, om, torch.full_like(om, ETA), torch.ones(L, dtype=torch.bool, device=dev),
                xk, wk, wg)

    t16, e16 = {}, 0.0
    for W in BLOCKS:
        L = -(-IAI_OMEGAS // W) * (2 * P) ** 2  # leaf lanes of a full trip of the blocked chunk
        a = leaf_inputs(L, W)
        got, want = gk_leaf_dos(*a), gk_leaf_dos_plain(*a)
        l1 = want[2]
        e = max(float(((got[0] - want[0]).abs() / l1[..., None]).max()),
                float(((got[1] - want[1]).abs() / l1).max()))
        if not (e <= 1e-12 and torch.equal(got[3], want[3])
                and torch.allclose(got[2], l1, rtol=1e-12, atol=0)):
            fail(f"K4 block entry vs plain at W={W}: max |d val|, |d err| / l1 = {e:.3e} > 1e-12")
        e16 = max(e16, float((got[0] - want[0]).abs().max()), float((got[1] - want[1]).abs().max()))
        t16[W] = {"L": L, "rel": e, "ms": cuda_ms(lambda: gk_leaf_dos(*a), 50),
                  "plain_ms": cuda_ms(lambda: gk_leaf_dos_plain(*a), 5),
                  "device_ms": device_ms(lambda: gk_leaf_dos(*a), 50, "gk_leaf_dos"),
                  "host_us": host_us(lambda: gk_leaf_dos(*a), 200),
                  "bound": bound(L * 2 * P * (5 * (8 * 9 + 6) + W * (TRACE_FLOPS[3] + 9)),
                                 nbytes(*a[:2], *a[4:9]) + L * 2 * (W + 2) * 8 + L * 8)}
        t16[W]["solve"] = leaf_solve_phase(np, torch, dev, a, f"phase 16, W = {W}: {L} leaf lanes")
        del a, got, want

    # K5 at V = W: the leaf pools' start and the mid level's step (nbisect
    # 4) of the blocked chunk
    t5 = {W: {"start": k5_shape(np, torch, dev, rng, f"the blocked leaf start, V = {W}", t16[W]["L"], 64, 1,
                                V=(W,), entry="start", reps=10),
              "step": k5_shape(np, torch, dev, rng, f"the blocked mid trip, V = {W}",
                               -(-IAI_OMEGAS // W) * 2 * P, 64, 4, V=(W,), reps=10)} for W in BLOCKS}
    print("K4 block entry vs plain: " + "; ".join(
        f"W={W}: {t16[W]['L']} lanes x 2 intervals, max |d|/l1 {t16[W]['rel']:.3e} (<= 1e-12), "
        f"{t16[W]['ms']:.4f} ms a call by events (device {ms_text(t16[W]['device_ms'])}, host "
        f"{t16[W]['host_us']:.1f} us; plain {t16[W]['plain_ms']:.4f}; bound {t16[W]['bound'][0]:.4f} ms by "
        f"{t16[W]['bound'][1]})" for W in BLOCKS), flush=True)
    torch.cuda.empty_cache()

    # 17. the omega-block IAI main path --------------------------------------------
    bz, oms = cold["bz"], cold["oms"]
    prob = IntegralProblem(dos_integrand(h, ETA), bz)
    dmax = float(np.max(np.abs(cold["d_ptr"])))

    def reset():
        fourier_contract.launches = gk_leaf_dos.launches = 0
        k5_launches(reset=True)
        leaf_solve_launches(reset=True)

    def blocked(W, plain=False, warm=False, chunk=BLOCK_CHUNK):
        return SweepSolver(prob, IAI(inner_cap=64, inner_nbisect=4, plain_kernels=plain,
                                     warm_width=8 if warm else None, device=dev),
                           abstol=IAI_ABSTOL, chunk=chunk, scan=True, block=W, warm=warm)

    total_block_launches, total_solve_launches, res = 0, 0, {}
    for W in BLOCKS:
        walls = []
        for r in range(wall_runs):
            reset()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with SmiBusy() as busy:
                t0 = time.perf_counter()
                sw = blocked(W)
                d = sw(oms)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            if r == 0:
                launches = {"fourier_contract": fourier_contract.launches,
                            "gk_leaf_dos_block": gk_leaf_dos.launches,
                            **{k: v for k, v in k5_launches().items() if k != "gk_pool_seed"},
                            "gk_leaf_dos_solve": leaf_solve_launches()}
                peak = torch.cuda.max_memory_allocated() / 2**20
                first = (d, sw.numevals, sw.retcode, copy.deepcopy(sw.stats), sw.block_certificates, busy.share)
        d, ne, ok, st, bc, share = first
        total_block_launches += launches["gk_leaf_dos_block"]
        total_solve_launches += launches["gk_leaf_dos_solve"]
        dcold = float(np.max(np.abs(d - cold["d"])))
        dptr = float(np.max(np.abs(d - cold["d_ptr"])))
        leaf = leaf_launches(launches, st)
        res[W] = {"walls": walls, "numevals": ne, "retcode": ok, "trips": dict(st.trips), "syncs": st.syncs,
                  "launches": launches, "leaf_launches": leaf, "busy": share}
        print(f"block IAI main path, block={W}: {IAI_OMEGAS} omegas (chunk {BLOCK_CHUNK}, {len(bc[0])} real blocks), "
              f"walls {', '.join(f'{w:.3f}' for w in walls)} s (phase 7, block 1: {cold['wall']:.3f} s); numevals "
              f"{ne} ({ne / IAI_OMEGAS:.4g} per omega; phase 7 {cold['numevals'] / IAI_OMEGAS:.4g}); retcode {ok}; "
              f"trips (level 3 outer, 2 mid, 1 leaf) {dict(sorted(st.trips.items(), reverse=True))}; host syncs "
              f"{st.syncs}; launches {launches}; leaf launches {leaf}; device busy (first wall) "
              f"{'not sampled' if share is None else f'{100 * share:.1f} %'} (nvidia-smi); peak device memory "
              f"{peak:.1f} MiB; vs phase 7 max|d| {dcold:.3e} (<= 2 abstol); vs PTR(npt=400) max|d| {dptr:.4e} "
              f"(<= {1e-2 * dmax:.4e})", flush=True)
        if min(launches.values()) <= 0:
            fail(f"the block IAI main path did not go through every kernel: {launches}")
        if not (ok and d.shape == (IAI_OMEGAS,) and dcold <= 2 * IAI_ABSTOL and dptr <= 1e-2 * dmax):
            fail(f"block={W} IAI: retcode {ok}, vs phase 7 {dcold:.3e}, vs PTR {dptr:.3e}")
    if "--profile" in sys.argv[1:]:
        profile("block IAI main path (block=2)", lambda: blocked(2)(oms))

    # the warm block chain on the plain versions, at the two cheapest neighbours
    i = int(np.argmin(cold["ne"]))
    j = i + 1 if i + 1 < len(oms) and (i == 0 or cold["ne"][i + 1] <= cold["ne"][i - 1]) else i - 1
    pair = np.sort(oms[[i, j]])
    out = []
    for plain in (False, True):
        t0 = time.perf_counter()
        sw = blocked(2, plain=plain, warm=True, chunk=2)
        out.append((sw(pair), sw.numevals, sw.block_certificates, sw.retcode, time.perf_counter() - t0))
    (dk, nk, bk, rk, tk), (dp, npl, bp, rp, tp) = out
    same_bc = all(np.array_equal(a, b) for a, b in zip(bk, bp))
    dpair = float(np.max(np.abs(dk - dp)))
    print(f"warm block chain (block 2) on the plain versions at omegas {pair.round(4).tolist()}: numevals {npl} vs "
          f"{nk} (kernels), block certificates identical {same_bc} ({bk[1].tolist()}), max|d D| {dpair:.3e} (<= "
          f"abstol); plain {tp:.3f} s, kernels {tk:.3f} s", flush=True)
    if not (npl == nk and same_bc and dpair <= IAI_ABSTOL and rk and rp):
        fail(f"warm block chain kernels vs plain: numevals {nk} vs {npl}, certificates {same_bc}, max|d| {dpair:.3e}")
    W0 = BLOCKS[0]
    solve_entry = [
        {"name": "gk_leaf_dos_solve_block", "route": "cuda", "source": src + "gk_leaf_dos.cu",
         "replaces": "autobzcore_tpu/ops/adaptive.py:236", "launches": total_solve_launches,
         "max_abs_err": max(t16[W]["solve"]["err"] for W in BLOCKS),
         "ms": t16[W0]["solve"]["device_ms"] if t16[W0]["solve"]["device_ms"] is not None else t16[W0]["solve"]["ms"],
         "plain_ms": t16[W0]["solve"]["plain_ms"], "bound_ms": t16[W0]["solve"]["bound"][0],
         "bound_by": t16[W0]["solve"]["bound"][1], "library_ms": None}]
    numbers = {W: dict(res[W], k4={k: v for k, v in t16[W].items() if k.endswith(("ms", "us"))},
                       solve=t16[W]["solve"],
                       k5={e: {q: v for q, v in t.items() if q != "V"} for e, t in t5[W].items()})
               for W in BLOCKS}
    return [{"name": "gk_leaf_dos_block", "route": "cuda", "source": src + "gk_leaf_dos.cu",
             "replaces": "autobzcore_tpu/models/observables.py:138", "launches": total_block_launches,
             "max_abs_err": e16, "ms": t16[W0]["ms"], "plain_ms": t16[W0]["plain_ms"],
             "bound_ms": t16[W0]["bound"][0], "bound_by": t16[W0]["bound"][1], "library_ms": None}
            ] + solve_entry, numbers


def repair_phases(np, torch, dev):
    """Phase 18: the PTR sum above three bands through eigvalsh + K8, and
    K2's grid-stride loop against the uncapped launch. Returns the entry of
    the m > 3 route (K8 after batched eigvalsh)."""
    from autobzcore_torch import FBZ, PTR, IntegralProblem, init, load_bz, solve_
    from autobzcore_torch.models import observables as obs
    from autobzcore_torch.models.tight_binding import synthetic_wannier
    from autobzcore_torch.ops import eigh3
    from autobzcore_torch.ops import grid_sweep as gs

    npt, m = 60, 4
    om = torch.linspace(-4.0, 4.0, W_FLAGSHIP, dtype=torch.float64, device=dev)
    prob = IntegralProblem(obs.dos_integrand(synthetic_wannier(m, device=dev), ETA), load_bz(FBZ(), np.eye(3)), om)
    gs.lorentzian_sum.launches = obs.dos_trace_weighted_sum.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache = init(prob, PTR(npt=npt, device=dev))
    u = solve_(cache).u
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"lorentzian_sum": gs.lorentzian_sum.launches, "dos_trace_weighted_sum": obs.dos_trace_weighted_sum.launches}
    w, H = cache.cacheval["inner"]["consts"]
    eta = torch.full_like(om, ETA)
    sc = (2 * math.pi) ** 3 / npt**3
    plain = obs.dos_trace_weighted_sum_plain(H, w, om, eta, sc)
    err18 = float((u - plain).abs().max())
    rel = err18 / float(plain.abs().max())
    # the route by event time, split into cuSOLVER's eigenvalues and K8
    e = eigh3.eigvalsh_chunked(H)
    t18 = {"ms": cuda_ms(lambda: obs.dos_eig_weighted_sum(H, w, om, eta, sc), 5),
           "eig_ms": cuda_ms(lambda: eigh3.eigvalsh_chunked(H), 5),
           "k8_ms": cuda_ms(lambda: gs.lorentzian_sum(e, w, om, ETA, sc / math.pi), 10),
           "k8_plain_ms": cuda_ms(lambda: gs.lorentzian_sum_plain(e, w, om, ETA, sc / math.pi), 3),
           "plain_ms": cuda_ms(lambda: obs.dos_trace_weighted_sum_plain(H, w, om, eta, sc), 2)}
    # the eigenvalues counted as the (16/3) m^3 real operations of the
    # Householder reduction of a Hermitian matrix (the QL iteration left out)
    K = H.shape[0]
    b18 = bound(K * 16 * m**3 / 3 + K * m * W_FLAGSHIP * LORENTZ_FLOPS, nbytes(H, w, om, eta) + 8 * W_FLAGSHIP)
    del e
    rng = np.random.default_rng(18)
    K2 = 1_000_000
    H3 = torch.as_tensor(random_hermitian(rng, K2, 3), device=dev)
    w3 = torch.as_tensor(rng.random(K2), device=dev)
    full = obs._dos_trace_launch(H3, w3, om, eta, 1.0, obs.DOS_GRID_CAP)
    capped = obs._dos_trace_launch(H3, w3, om, eta, 1.0, 7)
    torch.cuda.synchronize()
    print(f"repairs: PTR(npt={npt}) of synthetic_wannier({m}) at {W_FLAGSHIP} omegas through eigvalsh + K8 in "
          f"{wall:.3f} s, launches {launches}, max rel vs the plain trace path {rel:.3e} (<= 1e-10); the route "
          f"on its {K} k-points by event time {t18['ms']:.4f} ms (cuSOLVER eigvalsh {t18['eig_ms']:.4f} ms, K8 "
          f"{t18['k8_ms']:.4f} ms, K8's plain version {t18['k8_plain_ms']:.4f} ms), the plain trace path "
          f"{t18['plain_ms']:.4f} ms, bound {b18[0]:.4f} ms by {b18[1]}; K2 at {K2} k-points with 7 block rows "
          f"looping over {-(-K2 // 4096)} chunks vs the uncapped launch: bit-identical {torch.equal(full, capped)}",
          flush=True)
    if not (rel <= 1e-10 and launches["lorentzian_sum"] > 0 and launches["dos_trace_weighted_sum"] == 0):
        fail(f"the m > 3 PTR sum: rel {rel:.3e}, launches {launches}")
    if not torch.equal(full, capped):
        fail("K2 with a capped grid differs from the uncapped launch")
    return [{"name": "dos_eig_weighted_sum", "route": "cuda", "source": "autobzcore_torch/csrc/lorentzian_sum.cu",
             "replaces": "autobzcore_tpu/models/observables.py:145", "launches": launches["lorentzian_sum"],
             "max_abs_err": err18, "ms": t18["ms"], "plain_ms": t18["plain_ms"], "bound_ms": b18[0],
             "bound_by": b18[1], "library_ms": None}]


def dos_graphene_exact(E, t=1.0):
    """Graphene's exact DOS per unit cell and spin (the reference's anchor,
    tests/test_dos.py), by scipy's complete elliptic integral."""
    from scipy.special import ellipk

    E = abs(E)
    x = abs(E / t)
    f = (1 + x) ** 2 - (x**2 - 1) ** 2 / 4
    if x <= 1:
        return 2 * E / ((math.pi * t) ** 2 * math.sqrt(f)) * ellipk(4 * x / f)
    if x < 3:
        return 2 * E / ((math.pi * t) ** 2 * math.sqrt(4 * x)) * ellipk(f / (4 * x))
    return 0.0


def eigh_chunk_cost(torch, H, sizes):
    """For each chunk size n of ``sizes``: (milliseconds by CUDA events to
    eigendecompose all of H with batched ``torch.linalg.eigh`` calls of n
    matrices, device memory that one call of n matrices takes at its peak
    above what was allocated before it, in MiB)."""
    out = {}
    for n in sizes:
        parts = [H[s:s + n] for s in range(0, H.shape[0], n)]
        ms = cuda_ms(lambda: [torch.linalg.eigh(x) for x in parts], 2)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        torch.linalg.eigh(parts[0])
        torch.cuda.synchronize()
        out[n] = (ms, (torch.cuda.max_memory_allocated() - base) / 2**20)
    return out


def eigh_cost_text(cost):
    return "; ".join(f"in calls of {n}: {ms:.3f} ms, one call {mib:.1f} MiB" for n, (ms, mib) in cost.items())


def ggr_support(torch, e, v, E, b, vtol):
    """(terms, (energy, term) pairs inside the box support): a term of
    energy e and velocities v (d,) reaches |E - e| <= b sum_j |v_j|, and
    none where max |v_j| <= vtol."""
    av = v.abs()
    half = b * av.sum(1)
    half = torch.where(av.max(1).values > vtol, half, torch.full_like(half, -1.0))
    lo, hi = (e - half).reshape(-1), (e + half).reshape(-1)
    live = half.reshape(-1) >= 0
    n = torch.searchsorted(E, hi, right=True) - torch.searchsorted(E, lo)
    return e.numel(), int(n[live].sum())


def gauss_support(torch, e, sigma, E):
    """(energy, term) pairs whose Gaussian does not underflow in K13."""
    half = math.sqrt(GAUSS_UNDERFLOW) * sigma
    n = torch.searchsorted(E, (e + half).reshape(-1), right=True) - torch.searchsorted(E, (e - half).reshape(-1))
    return int(n.sum())


def k11_phase(np, torch, dev, h):
    """Phase 19's K11: the flagship's Jacobian (R = 4, V = 9) at the 1e6
    points of the 100^3 grid and one bands30 init chunk (V = 900) against
    their plain versions, bit-identical on repeat, the zero order against
    K1's bits, with kernel, plain, ``torch.matmul`` and bound times. Returns
    them with the outputs, which K12's checks take up."""
    from autobzcore_torch import InversionSymIBZ, load_bz
    from autobzcore_torch.algorithms.ptr import frac_nodes
    from autobzcore_torch.models.tight_binding import synthetic_wannier
    from autobzcore_torch.ops import fourier_eval as fe
    from autobzcore_torch.ops.eigh3 import EIGH_CHUNK as C
    from autobzcore_torch.ops.symptr import symptr_rule

    bzi = load_bz(InversionSymIBZ(), np.eye(3))
    orders = fe.jacobian_orders(3)

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    # K11: the flagship's Jacobian at the 1e6 points of the 100^3 grid
    Xg = (frac_nodes(NPT, 3, dev) * torch.as_tensor(h.period, device=dev)).contiguous()
    J = fe.fourier_points_derivs(h.c, Xg, h.offset, h.period, orders)
    Jp = fe.fourier_points_derivs_plain(h.c, Xg, h.offset, h.period, orders)
    zero = fe.fourier_points_derivs(h.c, Xg, h.offset, h.period, ((0, 0, 0),))[:, 0]
    k1_same = torch.equal(zero, fe.fourier_points(h.c, Xg, h.offset, h.period))
    del zero
    err11 = float((J - Jp).abs().max())
    rel11 = err11 / float(Jp.abs().max())
    if not (rel11 <= 1e-12 and k1_same):
        fail(f"K11 fourier_points_derivs at the flagship: max rel {rel11:.3e}, zero order equals K1 {k1_same}")
    if not torch.equal(J, fe.fourier_points_derivs(h.c, Xg, h.offset, h.period, orders)):
        fail("K11 fourier_points_derivs at the flagship: two runs on the same inputs differ")
    t11 = {"ms": cuda_ms(lambda: fe.fourier_points_derivs(h.c, Xg, h.offset, h.period, orders), 5),
           "plain_ms": cuda_ms(lambda: fe.fourier_points_derivs_plain(h.c, Xg, h.offset, h.period, orders), 2),
           "k1_ms": cuda_ms(lambda: fe.fourier_points(h.c, Xg, h.offset, h.period), 5)}
    # the library call: one complex matmul of the precomputed (K, 125) phases by
    # the (125, 4 x 9) derivative coefficients
    ph = [fe.phase_matrix(Xg[:, j].contiguous(), h.c.shape[j], h.offset[j], h.period[j]) for j in range(3)]
    Pm = (ph[0][:, :, None, None] * ph[1][:, None, :, None] * ph[2][:, None, None, :]).reshape(Xg.shape[0], -1)
    del ph
    ca = fe.derivative_coefficients(h.c, 3, h.offset, orders).reshape(Pm.shape[1], -1)
    lib11 = rel(torch.matmul(Pm, ca).reshape(J.shape), Jp)
    t11["library_ms"] = cuda_ms(lambda: torch.matmul(Pm, ca), 5)
    # the shape of every GGR init and transport pack chunk: the first
    # EIGH_CHUNK points of the grid, R = 4, V = 9
    Xc = Xg[:C].contiguous()
    Pc, Jpc = Pm[:C].contiguous(), Jp[:C]
    del Pm, Jp
    Jc = fe.fourier_points_derivs(h.c, Xc, h.offset, h.period, orders)
    rel11_c = rel(Jc, Jpc)
    same_c = torch.equal(Jc, fe.fourier_points_derivs(h.c, Xc, h.offset, h.period, orders))
    if not (rel11_c <= 1e-12 and same_c and torch.equal(Jc, J[:C])):
        fail(f"K11 at a chunk of {C} points: max rel {rel11_c:.3e}, repeat bit-identical {same_c}, equal to the "
             f"same points of the whole grid's launch {torch.equal(Jc, J[:C])}")

    def chunk():
        return fe.fourier_points_derivs(h.c, Xc, h.offset, h.period, orders)

    t11_c = {"ms": cuda_ms(chunk, 200), "device_ms": device_ms(chunk, 200), "host_us": host_us(chunk, 200),
             "plain_ms": cuda_ms(lambda: fe.fourier_points_derivs_plain(h.c, Xc, h.offset, h.period, orders), 20),
             "library_ms": cuda_ms(lambda: torch.matmul(Pc, ca), 200),
             "library_device_ms": device_ms(lambda: torch.matmul(Pc, ca), 200),
             "bound": bound(C * 125 * 4 * 9 * 8, nbytes(h.c, Xc) + Jc.numel() * Jc.element_size(), PEAK_FP64_MMA)}
    del Pc, Jpc, Jc
    b11 = bound(Xg.shape[0] * 125 * 4 * 9 * 8, nbytes(h.c, Xg) + J.numel() * J.element_size(), PEAK_FP64_MMA)
    # and at the bands30 shape: one init chunk of the inversion wedge's points
    s30 = synthetic_wannier(BANDS30, nr=5, device=dev)
    reps30, _ = symptr_rule(BANDS30_NPT, 3, bzi.syms)
    X30 = (torch.as_tensor(reps30[:C], device=dev).to(torch.float64) / BANDS30_NPT).contiguous()
    J30 = fe.fourier_points_derivs(s30.c, X30, s30.offset, s30.period, orders)
    rel11_30 = rel(J30, fe.fourier_points_derivs_plain(s30.c, X30, s30.offset, s30.period, orders))
    t11_30 = {"ms": cuda_ms(lambda: fe.fourier_points_derivs(s30.c, X30, s30.offset, s30.period, orders), 3),
              "plain_ms": cuda_ms(lambda: fe.fourier_points_derivs_plain(s30.c, X30, s30.offset, s30.period,
                                                                           orders), 1)}
    b11_30 = bound(X30.shape[0] * 125 * 4 * 900 * 8, nbytes(s30.c, X30) + J30.numel() * J30.element_size(),
                   PEAK_FP64_MMA)
    same30 = torch.equal(J30, fe.fourier_points_derivs(s30.c, X30, s30.offset, s30.period, orders))
    print(f"K11 fourier_points_derivs: the flagship's Jacobian (R = 4) at {Xg.shape[0]} points: max rel vs plain "
          f"{rel11:.3e} (<= 1e-12), zero order bit-equal to K1 {k1_same}, repeat bit-identical; {t11['ms']:.4f} ms, "
          f"{100 * b11[0] / t11['ms']:.1f} % of its bound {b11[0]:.4f} ms by {b11[1]} (K1 {t11['k1_ms']:.4f} ms; plain "
          f"{t11['plain_ms']:.3f} ms; torch.matmul of the phases {t11['library_ms']:.4f} ms, rel {lib11:.3e}); "
          f"bands30 chunk ({X30.shape[0]} points, V = 900): rel {rel11_30:.3e}, repeat bit-identical {same30}, "
          f"{t11_30['ms']:.4f} ms, {100 * b11_30[0] / t11_30['ms']:.1f} % of its bound {b11_30[0]:.4f} ms by "
          f"{b11_30[1]} (plain {t11_30['plain_ms']:.3f} ms)", flush=True)
    bc, dc, dlc = t11_c["bound"], t11_c["device_ms"], t11_c["library_device_ms"]
    print(f"K11 at a GGR init / transport pack chunk ({C} points, R = 4, V = 9): rel {rel11_c:.3e}, repeat "
          f"bit-identical, equal to the whole grid's launch; a call (events, 200 calls) {t11_c['ms']:.4f} ms, host "
          f"enqueue {t11_c['host_us']:.1f} us; device time (profiler) "
          f"{'not captured' if dc is None else f'{dc:.4f} ms, {100 * bc[0] / dc:.1f} % of'} its bound "
          f"{bc[0]:.5f} ms by {bc[1]} (plain {t11_c['plain_ms']:.4f} ms; torch.matmul of the phases "
          f"{t11_c['library_ms']:.4f} ms, device {'not captured' if dlc is None else f'{dlc:.4f} ms'})", flush=True)
    if not (rel11_30 <= 1e-12 and same30):
        fail(f"K11 at the bands30 shape: max rel {rel11_30:.3e}, repeat bit-identical {same30}")

    return {"t": dict(t11, bands30_ms=t11_30["ms"], bands30_bound_ms=b11_30[0],
                      **{"chunk_" + k: v for k, v in t11_c.items() if k != "bound"}, chunk_bound_ms=t11_c["bound"][0]),
            "err": err11, "bound": b11,
            "Xg": Xg, "J": J, "J30": J30, "s30": s30, "X30": X30, "reps30": reps30}


def k12_fused_phase(np, torch, dev, J):
    """Phase 19's K12 fused entry (``dos.ggr.band_velocity_eigh``): at the
    path's shape, K11's output J at the flagship's 1e6 points (one GGR init
    chunk), and on hard H (``hard_hermitian``) with random dH at m = 1, 2, 3:
    the energies against the register solver's mirror (``eigh3_jacobi``,
    1e-13 of the energy scale, and whether bit-equal) and against the plain
    route's (cuSOLVER's eigh, 1e-12), the velocities against the mirror's
    eigenvectors' (1e-13 of max|v|) and the plain route's by each band's gap
    (``velocity_errors``), bit-identical repeats. Then K12's fused entry three ways at the path's 1e6 points and at
    a 4,096-point chunk, with the plain route (eigh_chunked, then the
    einsum) and the library route (``torch.linalg.eigh`` in the chunks it
    takes, then ``torch.einsum``) and the bound. Returns the numbers."""
    from autobzcore_torch.dos import ggr as G
    from autobzcore_torch.ops.eigh3 import EIGH_CHUNK, eigh3_jacobi

    def check(tag, Jm):
        e, v = G.band_velocity_eigh(Jm)
        e2, v2 = G.band_velocity_eigh(Jm)
        if not (torch.equal(e, e2) and torch.equal(v, v2)):
            fail(f"K12 band_velocity_eigh ({tag}): two runs on the same inputs differ")
        me, mU = eigh3_jacobi(Jm[:, 0])
        mv = G.band_velocity_plain(mU, Jm[:, 1:])
        del mU
        pe, pv = G.band_velocity_eigh_plain(Jm)
        scale = float(pe.abs().max()) or 1.0
        vmax = float(mv.abs().max()) or 1.0
        r = {"points": Jm.shape[0], "e_bits": bool(torch.equal(e, me)),
             "e_mirror": float((e - me).abs().max()) / scale, "v_mirror": float((v - mv).abs().max()) / vmax,
             "e_plain": float((e - pe).abs().max()) / scale}
        r["v_gap"], r["v_cluster"] = velocity_errors(np, pe.cpu().numpy(), v.cpu().numpy(), pv.cpu().numpy(), scale,
                                                     vmax)
        r["err"] = float((v - pv).abs().max())
        if not (r["e_mirror"] <= 1e-13 and r["v_mirror"] <= 1e-13 and r["e_plain"] <= 1e-12 and r["v_gap"] <= 1.0
                and r["v_cluster"] <= 1e-12):
            fail(f"K12 band_velocity_eigh ({tag}): {r}")
        return r

    out = {"path": check(f"the flagship's {J.shape[0]} points", J)}
    rng = np.random.default_rng(1219)
    scale = float(J[:, 0].abs().max())
    for m in (1, 2, 3):
        H = hard_hermitian(np, rng, 4096, m, scale)
        K = H.shape[0]
        Jm = torch.as_tensor(np.stack([H] + [random_hermitian(rng, K, m) for _ in range(3)], axis=1), device=dev)
        out[f"hard{m}"] = check(f"hard matrices, m = {m}", Jm)
    print("K12 band_velocity_eigh against the mirror and the plain route (e / v as fractions of the energy scale "
          "and max|v|; v_gap the worst |dv| over its 1e-13 / min(g, 1) max|v| tolerance, v_cluster a cluster's sum): "
          + "; ".join(f"{tag}: {v}" for tag, v in out.items()), flush=True)

    C = EIGH_CHUNK
    Jc = J[:C].contiguous()
    K = J.shape[0]

    def library():
        parts = [torch.linalg.eigh(J[s:s + C, 0]) for s in range(0, K, C)]
        U = torch.cat([p[1] for p in parts])
        return torch.cat([p[0] for p in parts]), torch.einsum("kim,kdij,kjm->kdm", U.conj(), J[:, 1:], U).real

    t = three_ways(lambda: G.band_velocity_eigh(J), 10)
    t.update(plain_ms=once_ms(lambda: G.band_velocity_eigh_plain(J)), library_ms=cuda_ms(library, 2),
             chunk=three_ways(lambda: G.band_velocity_eigh(Jc), 50))
    b = bound(K * k12_eigh_flops(3, 3), nbytes(J) + 8 * K * 3 * 4)
    bc = bound(C * k12_eigh_flops(3, 3), nbytes(Jc) + 8 * C * 3 * 4)
    t.update(bound=b, chunk_bound_ms=bc[0], err=out["path"]["err"])
    print(f"K12 band_velocity_eigh at the GGR init's {K} points (m = 3, d = 3): {three_text(t)}, "
          f"{100 * b[0] / t['ms']:.1f} % of its bound {b[0]:.4f} ms by {b[1]} (operations at most "
          f"{K * k12_eigh_flops(3, 3) / PEAK_FP64 * 1e3:.4f} ms); plain route {t['plain_ms']:.3f} ms, the library "
          f"route (torch.linalg.eigh in {-(-K // C)} calls, torch.einsum) {t['library_ms']:.3f} ms; at a {C}-point "
          f"chunk {three_text(t['chunk'])}, bound {bc[0]:.5f} ms", flush=True)
    return t


def ggr_phases(np, torch, dev, h, ltm_dos):
    """Phases 19-21: K11-K13 against their plain versions, the GGR and AGB
    main path at the flagship, and BASELINE config 5. Returns the kernels'
    JSON entries."""
    from autobzcore_torch import FBZ, GGR, CubicSymIBZ, DOSProblem, InversionSymIBZ, load_bz
    from autobzcore_torch.dos import AdaptiveGaussianBroadening
    from autobzcore_torch.dos import ggr as G
    from autobzcore_torch.dos import init as dos_init
    from autobzcore_torch.dos import solve_ as dos_solve_
    from autobzcore_torch.models.tight_binding import tb_graphene, tb_integer
    from autobzcore_torch.ops import fourier_eval as fe
    from autobzcore_torch.ops.eigh3 import EIGH_CHUNK

    src = "autobzcore_torch/csrc/"
    bz = load_bz(FBZ(), np.eye(3))
    bzi = load_bz(InversionSymIBZ(), np.eye(3))
    ws = np.linspace(*WINDOW, LTM_ENERGIES)
    E = torch.as_tensor(ws, device=dev)
    orders = fe.jacobian_orders(3)
    C = EIGH_CHUNK

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    # 19. K11-K13 against their plain versions -----------------------------------------
    # K11 at the flagship's 1e6 points and at one bands30 init chunk
    k11 = k11_phase(np, torch, dev, h)
    t11, err11, b11 = k11["t"], k11["err"], k11["bound"]
    Xg, J, J30, s30, X30, reps30 = (k11[k] for k in ("Xg", "J", "J30", "s30", "X30", "reps30"))

    # K12 on the eigenvectors of one init chunk: the flagship's and bands30's
    t12 = {}
    for tag, Jc, m in (("flagship", J[:C], 3), ("bands30", J30, BANDS30)):
        Jc = Jc.reshape(-1, 4, m, m)
        U = torch.linalg.eigh(Jc[:, 0])[1].contiguous()
        dH = Jc[:, 1:]
        v = G.band_velocity(U, dH)
        vp = G.band_velocity_plain(U, dH)
        same = torch.equal(v, G.band_velocity(U, dH))
        r = rel(v, vp)
        if not (r <= 1e-12 and same):
            fail(f"K12 band_velocity at the {tag} shape (m = {m}): max rel {r:.3e}, repeat identical {same}")
        K = U.shape[0]
        t12[tag] = {"err": float((v - vp).abs().max()), "rel": r,
                    "ms": cuda_ms(lambda: G.band_velocity(U, dH), 10),
                    "plain_ms": cuda_ms(lambda: G.band_velocity_plain(U, dH), 5),
                    "library_ms": cuda_ms(lambda: torch.einsum("kim,kdij,kjm->kdm", U.conj(), dH, U), 5),
                    "bound": bound(K * 3 * m * (8 * m * m + 4 * m), nbytes(U) + 16 * dH.numel() + nbytes(v),
                                   PEAK_FP64_MMA),
                    "K": K}
    del J30
    t12f = k12_fused_phase(np, torch, dev, J.reshape(-1, 4, 3, 3))
    print("K12 band_velocity on eigh's vectors of one init chunk: " + "; ".join(
        f"{tag} ({t['K']} points, m = {m}): max rel vs plain {t['rel']:.3e} (<= 1e-12), repeat bit-identical, "
        f"{t['ms']:.4f} ms (plain {t['plain_ms']:.4f} ms, torch.einsum {t['library_ms']:.4f} ms, bound "
        f"{t['bound'][0]:.4f} ms by {t['bound'][1]})" for (tag, t), m in zip(t12.items(), (3, BANDS30))), flush=True)

    # K13 on the flagship's spectral grid at 1001 energies, box and Gaussian
    cv = GGR(npt=NPT).init_cacheval(h, 0.0, bz)
    ca_ = AdaptiveGaussianBroadening(npt=NPT).init_cacheval(h, 0.0, bz)
    cv30 = GGR(npt=BANDS30_NPT).init_cacheval(s30, 0.0, bzi)
    E30 = torch.as_tensor(np.linspace(*BANDS30_WINDOW, BANDS30_ENERGIES), device=dev)

    def box(c, En):
        return lambda: G.ggr_box_sum(c["energies"], c["velocities"], c["weights"], En, c["b"], c["vtol"])

    def box_plain(c, En):
        return lambda: G.ggr_box_sum_plain(c["energies"], c["velocities"], c["weights"], En, c["b"], c["vtol"])

    def gauss(c, En):
        return lambda: G.gaussian_sum(c["energies"], c["sigma"], c["norm"], c["weights"], En, c["inv_total"])

    def gauss_plain(c, En):
        return lambda: G.gaussian_sum_plain(c["energies"], c["sigma"], c["norm"], c["weights"], En, c["inv_total"])

    t13 = {}
    perm = torch.as_tensor(np.random.default_rng(19).permutation(LTM_ENERGIES), device=dev)
    for tag, fn, plain, c, En in (("box", box, box_plain, cv, E), ("gauss", gauss, gauss_plain, ca_, E),
                                  ("box30", box, box_plain, cv30, E30)):
        k, k2, p_ = fn(c, En)(), fn(c, En)(), plain(c, En)()
        torch.cuda.synchronize()
        r, same = rel(k, p_), torch.equal(k, k2)
        if not (r <= 1e-12 and same):
            fail(f"K13 {tag} at {En.shape[0]} energies: max rel vs plain {r:.3e}, repeat identical {same}")
        if En is E:
            # the same energies shuffled: the values follow them
            ks = fn(c, E[perm])()
            r_perm, same_perm = rel(ks, p_[perm]), bool(torch.equal(ks, k[perm]))
            print(f"K13 {tag} on the {LTM_ENERGIES} energies shuffled: max rel vs plain {r_perm:.3e} (<= 1e-12), "
                  f"bit-equal to the sorted call's values in the same order {same_perm}", flush=True)
            if not r_perm <= 1e-12:
                fail(f"K13 {tag} on shuffled energies: max rel vs plain {r_perm:.3e}")
        if tag == "gauss":
            pairs = gauss_support(torch, c["energies"], c["sigma"], En)
            gbytes = nbytes(c["energies"], c["sigma"], c["norm"], c["weights"], En) + 8 * En.shape[0]
            b13 = bound(pairs * GAUSS_PAIR_FLOPS, gbytes)
            first = bound(pairs * GAUSS_PAIR_FLOPS_FIRST, gbytes)
            terms = c["energies"].numel()
        else:
            terms, pairs = ggr_support(torch, c["energies"], c["velocities"], En, c["b"], c["vtol"])
            b13 = bound(terms * GGR_TEST_FLOPS + pairs * GGR_SUPPORT_FLOPS,
                        nbytes(c["energies"], c["velocities"], c["weights"], En) + 8 * En.shape[0])
            first = None
        t13[tag] = {"err": float((k - p_).abs().max()), "rel": r, "ms": cuda_ms(fn(c, En), 5),
                    "device_ms": device_ms(fn(c, En), 5, K13_KERNELS),
                    "plain_ms": once_ms(plain(c, En)), "bound": b13, "bound_first": first, "terms": terms,
                    "pairs": pairs}
    print("K13 ggr_box_sum / gaussian_sum: " + "; ".join(
        f"{tag} ({t['terms']} terms x {E30.shape[0] if tag == 'box30' else LTM_ENERGIES} energies, {t['pairs']} "
        f"pairs in the support): max rel vs plain {t['rel']:.3e} (<= 1e-12), repeat bit-identical, {t['ms']:.4f} ms "
        f"a call by events (its kernels' device time {ms_text(t['device_ms'])}), "
        f"{100 * t['bound'][0] / t['ms']:.1f} % of its bound {t['bound'][0]:.4f} ms by {t['bound'][1]} "
        + (f"(first count {t['bound_first'][0]:.4f} ms) " if t["bound_first"] else "")
        + f"(the former tile loop {K13_PARENT_MS[tag]} ms; plain {t['plain_ms']:.1f} ms)"
        for tag, t in t13.items()), flush=True)
    del J, cv, ca_, cv30
    torch.cuda.empty_cache()

    # 20. the GGR and AGB main path at the flagship ------------------------------------
    def ggr_path():
        ggr = GGR(npt=NPT)
        t0 = time.perf_counter()
        cache = dos_init(DOSProblem(h, 0.5, bz), ggr)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        D = ggr.dos_sweep(cache.cacheval, ws)
        t2 = time.perf_counter()
        agb = AdaptiveGaussianBroadening(npt=NPT)
        cache_a = dos_init(DOSProblem(h, 0.5, bz), agb)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        Da = agb.dos_sweep(cache_a.cacheval, ws)
        return ggr, cache, D, agb, cache_a, Da, (t0, t1, t2, t3, time.perf_counter())

    def counts():
        return {"fourier_points_derivs": fe.fourier_points_derivs.launches,
                "band_velocity": G.band_velocity.launches, "band_velocity_eigh": G.band_velocity_eigh.launches,
                "ggr_box_sum": G.ggr_box_sum.launches, "gaussian_sum": G.gaussian_sum.launches}

    def zero_counts():
        fe.fourier_points_derivs.launches = G.band_velocity.launches = G.band_velocity_eigh.launches = 0
        G.ggr_box_sum.launches = G.gaussian_sum.launches = 0

    zero_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with EighCount() as n_eigh:
        ggr, cache, D, agb, cache_a, Da, (t0, t1, t2, t3, t4) = ggr_path()
    launches = counts()
    peak = (torch.cuda.max_memory_allocated() - base) / 2**20
    # at m = 3 each init is one K11 and one fused K12 launch (the grid is one chunk), with no cuSOLVER call
    inits = 2 * -(-NPT**3 // G.FUSED_CHUNK)
    if not (launches["fourier_points_derivs"] == launches["band_velocity_eigh"] == inits
            and launches["band_velocity"] == 0 and launches["ggr_box_sum"] > 0 and launches["gaussian_sum"] > 0
            and n_eigh.calls == 0):
        fail(f"the GGR main path: launches {launches} (K11 and fused K12 {inits} each), eigh calls {n_eigh.calls} "
             "(0 at m = 3)")
    # the init by event time, and cuSOLVER's eigh in it over the same chunks
    t_init = cuda_ms(lambda: G.spectral_grid(h, bz, NPT), 2)
    Hs = [fe.fourier_points_derivs(h.c, Xg[s:s + C], h.offset, h.period, orders)[:, 0].reshape(-1, 3, 3)
          for s in range(0, Xg.shape[0], C)]
    t_eigh = cuda_ms(lambda: [torch.linalg.eigh(x) for x in Hs], 2)
    # the chunk's trade-off: eigh time and one call's memory at the chunk and at the cap
    eigh_cost = eigh_chunk_cost(torch, torch.cat(Hs)[:EIGH_CAP], (C, EIGH_CAP))
    n_chunks = len(Hs)
    del Hs
    e = cache.cacheval["energies"]
    edges = np.concatenate([e.min(0).values.cpu().numpy(), e.max(0).values.cpu().numpy()])
    print(f"GGR main path: flagship GGR(npt={NPT}) then AdaptiveGaussianBroadening(npt={NPT}), FBZ, "
          f"{LTM_ENERGIES} energies in {list(WINDOW)}: GGR init {t1 - t0:.4f} s, dos_sweep {t2 - t1:.4f} s; AGB init "
          f"{t3 - t2:.4f} s, dos_sweep {t4 - t3:.4f} s; GGR init by event time {t_init:.3f} ms (cuSOLVER eigh of its "
          f"{n_chunks} {C}-point chunks alone {t_eigh:.3f} ms, not on its route at m = 3); launches {launches}, "
          f"cuSOLVER eigh calls {n_eigh.calls}; peak device memory "
          f"{peak:.1f} MiB above what earlier phases hold; eigh of {EIGH_CAP} of its matrices {eigh_cost_text(eigh_cost)}; "
          f"bands {np.round(edges, 4).tolist()}", flush=True)
    integral, integral_a = float(np.trapezoid(D, ws)), float(np.trapezoid(Da, ws))
    away = np.min(np.abs(ws[:, None] - edges[None]), axis=1) > 0.3
    d_ltm = float(np.max(np.abs(D - ltm_dos)[away]))
    scale_ltm = float(np.max(np.abs(ltm_dos)))
    h1 = tb_integer(3, device=dev)
    vals = [float(dos_solve_(dos_init(DOSProblem(h1, 0.8, load_bz(k, np.eye(3))), GGR(npt=60))).u)
            for k in (CubicSymIBZ(), FBZ())]
    rel_ibz = abs(vals[0] - vals[1]) / abs(vals[1])
    gcache = dos_init(DOSProblem(tb_graphene(device=dev), 0.0, load_bz(FBZ(), np.eye(2))), GGR(npt=200))
    ge = np.array([-5.0, -3.2, -2.4, -0.8, 0.4, 1.2, 2.0, 2.8, 3.6, 6.0])  # the reference's energies
    g_err = float(np.max(np.abs(GGR(npt=200).dos_sweep(gcache.cacheval, ge)
                                - np.array([dos_graphene_exact(x) for x in ge]))))
    ws5 = np.array([-4.0, -1.0, 0.5, 2.0, 5.5])
    d5 = ggr.dos_sweep(cache.cacheval, ws5)
    pe, pv, pw = G.spectral_grid(h, bz, NPT, points=fe.fourier_points_derivs_plain, velocities=G.band_velocity_plain)
    p5 = G.ggr_box_sum_plain(pe, pv, pw, torch.as_tensor(ws5, device=dev), cache.cacheval["b"],
                             cache.cacheval["vtol"]).cpu().numpy()
    del pe, pv, pw
    rel5 = float(np.max(np.abs(d5 - p5)) / np.max(np.abs(p5)))
    print(f"GGR main path check: integral of D {integral:.10f}, of AGB's {integral_a:.10f} (3 within 2e-2); "
          f"max|D_GGR - D_LTM| {d_ltm:.4e} at {int(away.sum())} energies 0.3 eV from the band edges (<= 3e-2 "
          f"max|D_LTM| = {3e-2 * scale_ltm:.4e}); tb_integer(3) npt=60 E=0.8: CubicSymIBZ {vals[0]:.15f} vs FBZ "
          f"{vals[1]:.15f} (rel {rel_ibz:.3e} <= 1e-12); tb_graphene GGR(npt=200) vs the exact curve at 10 "
          f"energies: max|d| {g_err:.3e} (<= 1e-2); 5 energies vs the plain path: max|d| / max|D| {rel5:.3e} (<= 1e-12)",
          flush=True)
    if not (abs(integral - 3) <= 2e-2 and abs(integral_a - 3) <= 2e-2 and d_ltm <= 3e-2 * scale_ltm):
        fail(f"GGR checks: integrals {integral}, {integral_a}; vs LTM {d_ltm}")
    if not (rel_ibz <= 1e-12 and g_err <= 1e-2 and rel5 <= 1e-12 and np.all(np.isfinite(D))
            and np.all(np.isfinite(Da)) and D.shape == Da.shape == ws.shape):
        fail(f"GGR checks: IBZ rel {rel_ibz:.3e}, graphene {g_err:.3e}, 5 energies rel {rel5:.3e}")
    if "--profile" in sys.argv[1:]:
        profile("GGR main path", ggr_path)
    del cache, cache_a
    torch.cuda.empty_cache()

    # 21. BASELINE config 5 --------------------------------------------------------------
    w30 = np.linspace(*BANDS30_WINDOW, BANDS30_ENERGIES)
    zero_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0_30 = time.perf_counter()
    g30 = GGR(npt=BANDS30_NPT)
    c30 = dos_init(DOSProblem(s30, 0.0, bzi), g30)
    torch.cuda.synchronize()
    t1_30 = time.perf_counter()
    D30 = g30.dos_sweep(c30.cacheval, w30)
    t2_30 = time.perf_counter()
    launches30 = counts()
    peak30 = (torch.cuda.max_memory_allocated() - base) / 2**20
    if min(launches30["fourier_points_derivs"], launches30["band_velocity"], launches30["ggr_box_sum"]) <= 0:
        fail(f"config 5 did not go through K11-K13: {launches30}")
    t_init30 = cuda_ms(lambda: G.spectral_grid(s30, bzi, BANDS30_NPT), 2)
    X30 = (torch.as_tensor(reps30, device=dev).to(torch.float64) / BANDS30_NPT).contiguous()
    Hs = [fe.fourier_points_derivs(s30.c, X30[s:s + C], s30.offset, s30.period, orders)[:, 0]
          .reshape(-1, BANDS30, BANDS30) for s in range(0, X30.shape[0], C)]
    t_eigh30 = cuda_ms(lambda: [torch.linalg.eigh(x) for x in Hs], 2)
    eigh_cost30 = eigh_chunk_cost(torch, torch.cat(Hs)[:EIGH_CAP], (C, EIGH_CAP))
    del Hs
    integral30 = float(np.trapezoid(D30, w30))
    e30 = c30.cacheval["energies"]
    lo30, hi30 = float(e30.min()), float(e30.max())
    ws5 = lo30 + (hi30 - lo30) * np.array([0.1, 0.3, 0.5, 0.7, 0.9])
    d5 = g30.dos_sweep(c30.cacheval, ws5)
    pe, pv, pw = G.spectral_grid(s30, bzi, BANDS30_NPT, points=fe.fourier_points_derivs_plain,
                                 velocities=G.band_velocity_plain)
    p5 = G.ggr_box_sum_plain(pe, pv, pw, torch.as_tensor(ws5, device=dev), c30.cacheval["b"],
                             c30.cacheval["vtol"]).cpu().numpy()
    del pe, pv, pw
    rel30 = float(np.max(np.abs(d5 - p5)) / np.max(np.abs(p5)))
    print(f"config 5: synthetic_wannier({BANDS30}, nr=5), GGR(npt={BANDS30_NPT}), InversionSymIBZ "
          f"({c30.cacheval['numevals']} points x {BANDS30} bands), {BANDS30_ENERGIES} energies in "
          f"{list(BANDS30_WINDOW)}: init {t1_30 - t0_30:.4f} s (by event time {t_init30:.3f} ms, cuSOLVER eigh "
          f"{t_eigh30:.3f} ms, {100 * t_eigh30 / t_init30:.1f} %), dos_sweep {t2_30 - t1_30:.4f} s; launches {launches30}; "
          f"peak device memory {peak30:.1f} MiB above the earlier phases'; eigh of {EIGH_CAP} of its matrices "
          f"{eigh_cost_text(eigh_cost30)}; spectrum [{lo30:.4f}, {hi30:.4f}]; integral "
          f"{integral30:.6f} (30 within 5 %); min D {float(D30.min()):.3e}; 5 energies in the spectrum vs the plain "
          f"path: max|d| / max|D| "
          f"{rel30:.3e} (<= 1e-12)", flush=True)
    if not (np.all(np.isfinite(D30)) and np.all(D30 >= 0) and abs(integral30 - 30) <= 0.05 * 30
            and rel30 <= 1e-12 and D30.shape == w30.shape):
        fail(f"config 5 checks: integral {integral30}, min {D30.min()}, 5 energies rel {rel30:.3e}")
    del c30
    torch.cuda.empty_cache()

    def entry(name, source, replaces, t, b, library_ms, counted=None):
        return {"name": name, "route": "cuda", "source": src + source, "replaces": replaces,
                "launches": (launches if counted is None else counted)[name], "max_abs_err": t["err"], "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": b[0], "bound_by": b[1], "library_ms": library_ms}

    numbers = {"k13": {tag: {k: v for k, v in t.items() if k != "bound"} for tag, t in t13.items()},
               "ggr_init_s": t1 - t0, "ggr_sweep_s": t2 - t1, "agb_init_s": t3 - t2, "agb_sweep_s": t4 - t3,
               "bands30_init_s": t1_30 - t0_30, "bands30_sweep_s": t2_30 - t1_30,
               "k12_eigh": {k: v for k, v in t12f.items() if k != "bound"}, "ggr_eigh_calls": n_eigh.calls}
    # K12's first entry is on the main path above three bands (config 5); its fused entry at m <= 3
    return [entry("fourier_points_derivs", "fourier_points.cu", "autobzcore_tpu/ops/fourier_eval.py:115",
                  dict(t11, err=err11), b11, t11["library_ms"]),
            entry("band_velocity", "band_velocity.cu", "autobzcore_tpu/dos/ggr.py:278", t12["bands30"],
                  t12["bands30"]["bound"], t12["bands30"]["library_ms"], launches30),
            entry("band_velocity_eigh", "band_velocity.cu", "autobzcore_tpu/dos/ggr.py:276", t12f, t12f["bound"],
                  t12f["library_ms"]),
            entry("ggr_box_sum", "ggr_dos.cu", "autobzcore_tpu/dos/ggr.py:30", t13["box"], t13["box"]["bound"], None),
            entry("gaussian_sum", "ggr_dos.cu", "autobzcore_tpu/dos/tetrahedron.py:325", t13["gauss"],
                  t13["gauss"]["bound"], None)], numbers


def kane_mele_transport(device):
    """Phase 32's Kane-Mele model with Rashba coupling (m = 4), whose
    transport trips take eigh and K31's first entry."""
    from autobzcore_torch.models.tight_binding import tb_kane_mele

    return tb_kane_mele(lam_so=0.08, lam_r=0.08, device=device)


def iai_transport_trip(np, torch, dev, build=None):
    """The largest leaf trip of one of phase 32's IAI transport solves (eta
    0.3, omega 0.5, abstol 1e-2) on the card, of the model ``build(device=)``
    (tb_graphene where None): its H (N, m, m) and dH (N, 2, m, m), views of
    one K11 output as the solve hands them over, and its om, recorded from
    one solve."""
    from autobzcore_torch import IAI, FBZ, FourierIntegrand, IntegralProblem, JacobianSeries, MixedParameters, load_bz
    from autobzcore_torch import solve
    from autobzcore_torch.models import observables as obs
    from autobzcore_torch.models.tight_binding import tb_graphene

    build = build or tb_graphene
    trip = {}

    def recording(hv, om, eta=None):
        H, V = hv.s
        if H.shape[0] > trip.get("n", 0):
            J = torch.cat([H[:, None], V], dim=1)  # one (N, 1 + d, m, m) tensor, as K11 writes it
            trip.update(n=H.shape[0], H=J[:, 0], V=J[:, 1:], om=om)
        return obs.transport_distribution_points(hv, om, eta=eta)

    solve(IntegralProblem(FourierIntegrand(recording, JacobianSeries(build(device=dev)), eta=0.3, batched=True),
                          load_bz(FBZ(), np.eye(2)), MixedParameters(0.5)), IAI(device=dev), abstol=1e-2)
    return trip


class EighCount:
    """Counts ``torch.linalg.eigh`` calls (cuSOLVER's batched eigh on the
    card) while the block runs: ``calls`` after it."""

    def __enter__(self):
        import torch

        self.torch, self.real, self.calls = torch, torch.linalg.eigh, 0

        def counted(*args, **kw):
            self.calls += 1
            return self.real(*args, **kw)

        torch.linalg.eigh = counted
        return self

    def __exit__(self, *exc):
        self.torch.linalg.eigh = self.real
        return False


def eigh_route_phase(np, torch, dev, h, walls=3):
    """The route around K12 and K31, on a checkout with or without their
    fused entries (``dos.ggr.band_velocity_eigh``,
    ``models.observables.transport_points_eigh``; ``tools/kernel_ab.py
    --phases eigh``): at one GGR init chunk (the first EIGH_CHUNK points of
    the flagship's npt=100 grid) cuSOLVER's eigh, the ``.contiguous()`` copy
    of its U and K12, each three ways (by events, device time, host us); the
    GGR and AGB init walls (``walls`` runs each after a warm-up) with
    their eigh calls and, where there are some, cuSOLVER's share of the
    init by events; at the largest leaf trip of phase 32's graphene IAI
    transport solve, eigh_chunked, K31 and the integrand's call three ways;
    then that solve's wall (``walls`` runs), its K31 launches (one a trip),
    eigh calls and, from one more solve under torch.profiler, its device
    activities (kernels and copies). Where the fused entries exist, each three ways at the same
    shapes and K12's at the 1e6 points of the grid with its bound. Returns
    the numbers."""
    from types import SimpleNamespace

    from autobzcore_torch import FBZ, GGR, IAI, DOSProblem, IntegralProblem, MixedParameters, load_bz, solve
    from autobzcore_torch.algorithms.ptr import frac_nodes
    from autobzcore_torch.dos import AdaptiveGaussianBroadening
    from autobzcore_torch.dos import ggr as G
    from autobzcore_torch.dos import init as dos_init
    from autobzcore_torch.models import observables as obs
    from autobzcore_torch.models.tight_binding import tb_graphene
    from autobzcore_torch.ops import fourier_eval as fe
    from autobzcore_torch.ops.eigh3 import EIGH_CHUNK as C
    from autobzcore_torch.ops.eigh3 import eigh_chunked

    fused12 = getattr(G, "band_velocity_eigh", None)
    fused31 = getattr(obs, "transport_points_eigh", None)
    out = {"fused": fused12 is not None and fused31 is not None}
    bz = load_bz(FBZ(), np.eye(3))
    orders = fe.jacobian_orders(3)
    Xg = (frac_nodes(NPT, 3, dev) * torch.as_tensor(h.period, device=dev)).contiguous()
    Jc = fe.fourier_points_derivs(h.c, Xg[:C].contiguous(), h.offset, h.period, orders).reshape(-1, 4, 3, 3)
    Hc, dH = Jc[:, 0], Jc[:, 1:]
    Unc = torch.linalg.eigh(Hc)[1]
    U = Unc.contiguous()
    out["chunk"] = {"eigh": three_ways(lambda: torch.linalg.eigh(Hc), 50),
                    "contiguous": three_ways(lambda: Unc.contiguous(), 50),
                    "k12": three_ways(lambda: G.band_velocity(U, dH), 50)}
    if fused12 is not None:
        out["chunk"]["k12_fused"] = three_ways(lambda: fused12(Jc), 50)
        Jg = fe.fourier_points_derivs(h.c, Xg, h.offset, h.period, orders).reshape(-1, 4, 3, 3)
        t = three_ways(lambda: fused12(Jg), 10)
        K = Jg.shape[0]
        b = bound(K * k12_eigh_flops(3, 3), nbytes(Jg) + 8 * K * 3 * 4)
        out["k12_fused_grid"] = dict(t, points=K, bound_ms=b[0], bound_by=b[1])
        del Jg
    print(f"route at a GGR init chunk ({C} points, m = 3): " + "; ".join(
        f"{k} {three_text(v)}" for k, v in out["chunk"].items()), flush=True)
    if "k12_fused_grid" in out:
        t = out["k12_fused_grid"]
        print(f"K12's fused entry at the grid's {t['points']} points: {three_text(t)}; bound {t['bound_ms']:.4f} ms "
              f"by {t['bound_by']}, {100 * t['bound_ms'] / t['ms']:.1f} % of it by events", flush=True)
    del Jc, Hc, dH, Unc, U
    torch.cuda.empty_cache()

    # the GGR and AGB init walls and their eigh calls
    for tag, alg in (("ggr", GGR), ("agb", AdaptiveGaussianBroadening)):
        dos_init(DOSProblem(h, 0.5, bz), alg(npt=NPT))
        ws_ = []
        with EighCount() as n_eigh:
            for _ in range(walls):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                dos_init(DOSProblem(h, 0.5, bz), alg(npt=NPT))
                torch.cuda.synchronize()
                ws_.append(time.perf_counter() - t0)
        out[f"{tag}_init_s"], out[f"{tag}_eigh_calls"] = ws_, n_eigh.calls // walls
    t_init = cuda_ms(lambda: G.spectral_grid(h, bz, NPT), 2)
    Hs = [fe.fourier_points_derivs(h.c, Xg[s:s + C], h.offset, h.period, orders)[:, 0].reshape(-1, 3, 3)
          for s in range(0, Xg.shape[0], C)]
    t_eigh = cuda_ms(lambda: [torch.linalg.eigh(x) for x in Hs], 2)
    del Hs, Xg
    torch.cuda.empty_cache()
    out.update(init_event_ms=t_init, eigh_all_chunks_ms=t_eigh)
    print(f"GGR init walls {[round(w, 4) for w in out['ggr_init_s']]} s ({out['ggr_eigh_calls']} eigh calls a "
          f"init), AGB init walls {[round(w, 4) for w in out['agb_init_s']]} s ({out['agb_eigh_calls']} eigh calls); "
          f"spectral_grid by events {t_init:.3f} ms; eigh of all {-(-NPT**3 // C)} chunks alone {t_eigh:.3f} ms "
          f"({100 * t_eigh / t_init:.1f} % of the init{'' if out['ggr_eigh_calls'] else ', not on its route'})",
          flush=True)

    # graphene's largest IAI leaf trip: eigh_chunked, K31 and the integrand's call
    trip = iai_transport_trip(np, torch, dev)
    H, V, om = trip["H"], trip["V"], trip["om"]
    n = H.shape[0]
    e, Ut = eigh_chunked(H)
    Ut = Ut.contiguous()
    om_l = torch.broadcast_to(torch.as_tensor(om, dtype=torch.float64, device=dev), (n,)).contiguous()
    eta_l = torch.full_like(om_l, 0.3)
    hv = SimpleNamespace(s=(H, V))
    out["trip"] = {"points": n, "eigh_chunked": three_ways(lambda: eigh_chunked(H), 50),
                   "k31": three_ways(lambda: obs.transport_points(e, Ut, V, om_l, eta_l), 50),
                   "integrand": three_ways(lambda: obs.transport_distribution_points(hv, om, eta=0.3), 50)}
    if fused31 is not None:
        out["trip"]["k31_fused"] = three_ways(lambda: fused31(H, V, om, 0.3), 50)
    print(f"graphene's largest IAI leaf trip ({n} points, m = 2, d = 2): " + "; ".join(
        f"{k} {three_text(v)}" for k, v in out["trip"].items() if k != "points"), flush=True)

    # the graphene IAI transport solve: wall, trips (K31 launches), eigh calls, device activities
    bz2 = load_bz(FBZ(), np.eye(2))
    k31s = [f for f in (obs.transport_points, fused31) if f is not None]

    def gsolve():
        return solve(IntegralProblem(obs.transport_integrand(tb_graphene(device=dev), eta=0.3), bz2,
                                     MixedParameters(0.5)), IAI(device=dev), abstol=1e-2)

    gsolve()
    ws_ = []
    for f in k31s:
        f.launches = 0
    with EighCount() as n_eigh:
        for _ in range(walls):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sol = gsolve()
            torch.cuda.synchronize()
            ws_.append(time.perf_counter() - t0)
    out["graphene_iai"] = {"wall_s": ws_, "numevals": int(sol.numevals),
                           "k31_launches": sum(f.launches for f in k31s) // walls,
                           "eigh_calls": n_eigh.calls // walls, "device_activities": kernel_launches(torch, gsolve)}
    g = out["graphene_iai"]
    print(f"graphene IAI transport solve (eta 0.3, omega 0.5, abstol 1e-2): walls {[round(w, 4) for w in ws_]} s, "
          f"numevals {g['numevals']}, trips (K31 launches) {g['k31_launches']}, eigh calls {g['eigh_calls']}, "
          f"device activities (profiled) {g['device_activities']}", flush=True)
    return out


def kernel_launches(torch, fn):
    """The device activities (kernels and copies) of ``fn()``, counted by
    torch.profiler (None where it recorded none)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n = sum(e.count for e in prof.key_averages() if getattr(e, "device_type", None) == DeviceType.CUDA)
    return n or None


def rule_phase(np, torch, dev, h, oms):
    """Phase 22: K14-K17 against their plain versions at the TAI leg's
    shapes (the frequencies ``oms``), with K14's device time and the host
    cost of its call. Returns each kernel's numbers and bound."""
    from autobzcore_torch import FourierValue, QuadratureFunction, trapz
    from autobzcore_torch.models.observables import dos_trace, gm_leaf_dos, gm_leaf_dos_plain
    from autobzcore_torch.ops import adaptive as tad
    from autobzcore_torch.ops import cuda_lib
    from autobzcore_torch.ops import genz_malik as tgm
    from autobzcore_torch.ops.fourier_eval import fourier_points

    rng = np.random.default_rng(22)
    pts, wk, we, di = tgm.gm_rule_tensors(3, dev)
    P, nb = pts.shape[0], 4
    L, K = IAI_OMEGAS, 2 * nb
    B = L * K

    # 22. K14-K17 against their plain versions ------------------------------------------
    # one trip of the TAI leg: 33 lanes x 8 boxes x 33 nodes of the flagship, a
    # tenth of the boxes dead (centre 0, half 0)
    dead = torch.as_tensor(rng.random(B) < 0.1, device=dev)
    cen = torch.where(dead[:, None], 0.0, torch.as_tensor(rng.random((B, 3)), device=dev))
    half = torch.where(dead[:, None], 0.0, torch.as_tensor(rng.random((B, 3)) * 0.05, device=dev))
    nodes, vol = tgm.gm_box_nodes(cen, half, pts)
    vol = vol.contiguous()
    H = fourier_points(h.c, nodes.reshape(-1, 3).contiguous(), h.offset, h.period).reshape(B, P, 3, 3)
    om_b = torch.as_tensor(np.repeat(oms, K), device=dev)
    eta_b = torch.full_like(om_b, ETA)
    a15 = (H, om_b, eta_b, vol, wk, we, di)
    k15, k15r, p15 = gm_leaf_dos(*a15), gm_leaf_dos(*a15), gm_leaf_dos_plain(*a15)
    D = dos_trace(FourierValue(None, H), om_b[:, None], eta=eta_b[:, None])
    # the integrand NaN at the dead boxes' nodes (at the origin) checks the masking
    fx = torch.where(dead[:, None], float("nan"), D).contiguous()
    a14 = (fx, vol, wk, we, di)
    k14, k14r, p14 = tgm.gm_rule_reduce(*a14), tgm.gm_rule_reduce(*a14), tgm.gm_rule_reduce_plain(*a14)
    via14 = tgm.gm_rule_reduce(D.contiguous(), vol, wk, we, di)
    torch.cuda.synchronize()

    def rule_err(got, want):
        scale = float(want[0].abs().max())
        return max(float((got[0] - want[0]).abs().max()), float((got[1] - want[1]).abs().max())) / scale

    e14, e15 = rule_err(k14, p14), max(rule_err(k15, p15), rule_err(k15, via14))
    bits14, bits15 = all(map(torch.equal, k14, p14)), all(map(torch.equal, k15, p15))
    ok14 = (bits14 and all(map(torch.equal, k14, k14r))
            and bool((k14[0][dead] == 0).all() and (k14[1][dead] == 0).all())
            and bool(torch.isfinite(k14[0]).all()))
    ok15 = (e15 <= 1e-12 and torch.equal(k15[2], p15[2]) and torch.equal(k15[2], via14[2])
            and all(map(torch.equal, k15, k15r)))
    if not ok14:
        fail(f"K14 gm_rule_reduce vs plain: rel {e14:.3e}, bit-equal {[bool(torch.equal(a, b)) for a, b in zip(k14, p14)]}")
    if not ok15:
        fail(f"K15 gm_leaf_dos vs plain and K1 + trace + K14: rel {e15:.3e}")
    W2 = torch.stack([wk, we], dim=1)
    t14 = {"ms": cuda_ms(lambda: tgm.gm_rule_reduce(*a14), 200),
           "plain_ms": cuda_ms(lambda: tgm.gm_rule_reduce_plain(*a14), 50),
           "library_ms": cuda_ms(lambda: torch.matmul(D, W2), 200),
           "err": max(float((k14[0] - p14[0]).abs().max()), float((k14[1] - p14[1]).abs().max()))}
    # what a K14 call costs: its device time (torch.profiler) beside
    # torch.matmul's, and the host time of the wrapper, of the bare ctypes
    # launch it ends in (the same arguments, no checks, no allocation) and
    # of torch.matmul; and the wrapper's three output allocations against
    # one allocation cut into views
    lib = cuda_lib.load_kernels()
    o14 = tuple(torch.empty_like(t) for t in k14)
    bare14 = (fx.data_ptr(), vol.data_ptr(), wk.data_ptr(), we.data_ptr(), di.data_ptr(), o14[0].data_ptr(),
              o14[1].data_ptr(), o14[2].data_ptr(), B, P, 1, 0, di.shape[0], tgm.RATIO,
              torch.cuda.current_stream(dev).cuda_stream)
    cuda_lib.check_launch(lib.gm_rule_reduce_launch(*bare14), "gm_rule_reduce (bare)")
    torch.cuda.synchronize()
    if not all(map(torch.equal, o14, k14)):
        fail("K14 gm_rule_reduce: the bare launch differs from the wrapper's")

    def alloc3():
        return (torch.empty(B, dtype=torch.float64, device=dev), torch.empty(B, dtype=torch.float64, device=dev),
                torch.empty(B, dtype=torch.int32, device=dev))

    def alloc1():
        buf = torch.empty(3 * B, dtype=torch.float64, device=dev)
        return buf[:B], buf[B:2 * B], buf[2 * B:].view(torch.int32)[:B]

    t14.update(device_ms=device_ms(lambda: tgm.gm_rule_reduce(*a14), 50),
               library_device_ms=device_ms(lambda: torch.matmul(D, W2), 50),
               host_us=host_us(lambda: tgm.gm_rule_reduce(*a14), 500),
               bare_host_us=host_us(lambda: lib.gm_rule_reduce_launch(*bare14), 500),
               library_host_us=host_us(lambda: torch.matmul(D, W2), 500),
               alloc3_host_us=host_us(alloc3, 500), alloc1_host_us=host_us(alloc1, 500))
    t15 = {"ms": cuda_ms(lambda: gm_leaf_dos(*a15), 200),
           "plain_ms": cuda_ms(lambda: gm_leaf_dos_plain(*a15), 20),
           "err": max(float((k15[0] - p15[0]).abs().max()), float((k15[1] - p15[1]).abs().max()))}
    # operations: per box 4 P (the two weighted sums) and 10 d (fourth
    # differences); K15 adds the trace and the division at every node
    b14 = bound(B * (4 * P + 30), nbytes(fx, vol, wk, we, di) + B * (8 + 8 + 4))
    b15 = bound(B * P * (TRACE_FLOPS[3] + 8) + B * (4 * P + 30),
                nbytes(H, om_b, eta_b, vol, wk, we, di) + B * (8 + 8 + 4))
    print(f"K14 gm_rule_reduce: {B} boxes x {P} nodes ({int(dead.sum())} dead, NaN at their nodes): "
          f"val, err and splitdim bit-equal to the plain version ({bits14}; max |d| / max|val| {e14:.3e}), "
          f"dead boxes 0, repeat bit-identical; a call by events {t14['ms']:.4f} ms (plain {t14['plain_ms']:.4f}, "
          f"torch.matmul by [wk, we] {t14['library_ms']:.4f}; bound {b14[0]:.5f} ms by {b14[1]}); device time "
          f"(profiler) {ms_text(t14['device_ms'])} (torch.matmul {ms_text(t14['library_device_ms'])}); host time a call "
          f"(500 calls, no sync) {t14['host_us']:.1f} us (its bare ctypes launch {t14['bare_host_us']:.1f} us, "
          f"torch.matmul {t14['library_host_us']:.1f} us; the outputs' three torch.empty {t14['alloc3_host_us']:.1f} "
          f"us, one torch.empty and views {t14['alloc1_host_us']:.1f} us); K15 gm_leaf_dos: vs plain and K1 + "
          f"trace + K14 {e15:.3e} (<= 1e-12; bit-equal to plain {bits15}), splitdim identical, repeat bit-identical; {t15['ms']:.4f} ms "
          f"(plain {t15['plain_ms']:.4f}; bound {b15[0]:.5f} ms by {b15[1]})", flush=True)

    # K16 at 33 lanes x cap 4096 x d = 3: random live slots (dead ones among
    # them, a tenth of the lanes below nbisect), errors from four values, so
    # that ties are everywhere
    cap = 4096

    def random_pool():
        n = rng.integers(1, cap - nb + 1, L)
        n[: L // 10] = rng.integers(1, nb, L // 10)
        live = (np.arange(cap)[None, :] < n[:, None]) & (rng.random((L, cap)) > 0.05)
        put = lambda a, dt=torch.float64: torch.as_tensor(a, dtype=dt, device=dev)  # noqa: E731
        pool = tgm.GMPool(
            c=put(np.where(live[..., None], rng.random((L, cap, 3)), 0.0)),
            h=put(np.where(live[..., None], rng.random((L, cap, 3)) * 0.1, 0.0)),
            err=put(np.where(live, rng.integers(0, 4, (L, cap)) * 0.25, 0.0)),
            sd=put(np.where(live, rng.integers(0, 3, (L, cap)), 0), torch.int32),
            val=put(np.where(live, rng.normal(size=(L, cap)), 0.0)), n=put(n, torch.int64),
            evals=put(rng.integers(0, 300000, L).astype(float)), atol=put(rng.random(L) * 4),
            rtol=1e-3, max_evals=250000.0, npts=P, active=put(rng.random(L) > 0.05, torch.bool))
        tgm.gm_pool_totals_plain(pool, nb)
        return pool

    if not hasattr(tgm, "gm_pool_step"):
        fail("K16 has no step entry: a TAI trip must be the rule and one gm_pool_step after gm_pool_begin")
    # the start (totals, select) and a trip's step (update, totals, the next
    # trip's select) against the plain route (update, then select)
    sel_in = random_pool()
    cval = torch.as_tensor(rng.normal(size=(L, K)), device=dev)
    cerr = torch.as_tensor(rng.random((L, K)), device=dev)
    csd = torch.as_tensor(rng.integers(0, 3, (L, K)).astype(np.int32), device=dev)
    begun, begun_p = sel_in.clone(), sel_in.clone()
    tgm.gm_pool_begin(begun, nb)
    tgm.gm_pool_begin_plain(begun_p, nb)
    stepped, stepped_p = begun.clone(), begun_p.clone()
    tgm.gm_pool_step(stepped, nb, cval, cerr, csd)
    tgm.gm_pool_step_plain(stepped_p, nb, cval, cerr, csd)
    again = begun.clone()
    tgm.gm_pool_step(again, nb, cval, cerr, csd)
    keys = ("c", "h", "err", "sd", "val", "n", "evals", "active", "idx", "cc", "hh")
    same = (all(torch.equal(getattr(begun, k), getattr(begun_p, k)) for k in keys)
            and all(torch.equal(getattr(stepped, k), getattr(stepped_p, k)) for k in keys)
            and all(torch.equal(getattr(stepped, k), getattr(again, k)) for k in keys + ("tot_val", "tot_err")))
    rel_step = max(float(((getattr(a, k) - getattr(b, k)).abs() / getattr(b, k).abs().clamp_min(1e-300)).max())
                   for a, b in ((begun, begun_p), (stepped, stepped_p)) for k in ("tot_val", "tot_err", "tol"))
    if not (same and rel_step <= 1e-14):
        fail(f"K16 start and step vs the plain route: identical {same}, totals rel {rel_step:.3e}")

    def timing_pool(begin):
        """``sel_in`` started by ``begin``, with room in every lane for the
        timed steps (n at most 3,000 of 4,096; no budget), so that repeated
        steps keep the same lanes live and need no copy of the pool between
        calls."""
        out = sel_in.clone()
        out.n.clamp_(max=3000)
        out.max_evals = 1e300
        begin(out, nb)
        return out

    step_k, step_p = timing_pool(tgm.gm_pool_begin), timing_pool(tgm.gm_pool_begin_plain)
    t16 = {"ms": cuda_ms(lambda: tgm.gm_pool_step(step_k, nb, cval, cerr, csd), 100),
           "plain_ms": cuda_ms(lambda: tgm.gm_pool_step_plain(step_p, nb, cval, cerr, csd), 20),
           "device_ms": device_ms(lambda: tgm.gm_pool_step(step_k, nb, cval, cerr, csd), 50, "gm_pool"),
           "begin_device_ms": device_ms(lambda: tgm.gm_pool_begin(sel_in.clone(), nb), 50, "gm_pool"),
           "library_device_ms": device_ms(lambda: torch.topk(sel_in.err, nb, dim=1), 50),
           "err": max(float((getattr(stepped, k) - getattr(stepped_p, k)).abs().max()) for k in ("tot_val", "tot_err")),
           "library_ms": None}
    idx, cc, hh = begun.idx, begun.cc, begun.hh
    b16 = bound(L * cap * 2, nbytes(idx, cc, hh, cval, cerr, csd) + L * K * (8 * 8 + 4)
                + nbytes(sel_in.err, sel_in.val, sel_in.n, sel_in.evals, sel_in.atol, sel_in.active)
                + L * (5 * 8 + 1) + nbytes(idx, cc, hh))
    print(f"K16 gm_pool at {L} lanes x cap {cap} x d 3, ties planted: the start (totals, select) and a step (a "
          f"trip's one launch: update, totals, the next trip's select) give picks, children and pools identical to "
          f"the plain route (update then select), totals rel {rel_step:.3e} (<= 1e-14), repeat bit-identical; the "
          f"step {t16['ms']:.4f} ms by events, device {ms_text(t16['device_ms'])} (plain {t16['plain_ms']:.4f}; "
          f"bound {b16[0]:.5f} by {b16[1]}); the start, device {ms_text(t16['begin_device_ms'])} (its one pass "
          f"over the pool makes the totals and the picks) against torch.topk of the errors alone, device "
          f"{ms_text(t16['library_device_ms'])}", flush=True)

    # K17 at phase 24's fixed level: 33 lanes x 1 segment x 201 trapezoid nodes
    x201, w201 = QuadratureFunction(trapz, npt=FIXED_NPT).rule(dev)
    fx17 = torch.as_tensor(rng.normal(size=(FIXED_OMEGAS, 1, FIXED_NPT, 1)), device=dev)
    half17 = torch.full((FIXED_OMEGAS, 1), 0.5, dtype=torch.float64, device=dev)
    k17, k17r = tad.fixed_rule_reduce(fx17, w201, half17), tad.fixed_rule_reduce(fx17, w201, half17)
    p17 = tad.fixed_rule_reduce_plain(fx17, w201, half17)
    e17 = float((k17 - p17).abs().max())
    if not (e17 <= 1e-12 * float(p17.abs().max()) and torch.equal(k17, k17r)):
        fail(f"K17 fixed_rule_reduce vs plain: max|d| {e17:.3e}")
    t17 = {"ms": cuda_ms(lambda: tad.fixed_rule_reduce(fx17, w201, half17), 200),
           "plain_ms": cuda_ms(lambda: tad.fixed_rule_reduce_plain(fx17, w201, half17), 100),
           "library_ms": cuda_ms(lambda: torch.einsum("lspc,p,ls->lc", fx17, w201, half17), 200),
           "err": e17}
    b17 = bound(fx17.numel() * 2 + FIXED_OMEGAS * 2, nbytes(fx17, w201, half17) + FIXED_OMEGAS * 8)
    print(f"K17 fixed_rule_reduce {tuple(fx17.shape)}: max|d| {e17:.3e} (<= 1e-12 max|v|), repeat "
          f"bit-identical; {t17['ms']:.4f} ms (plain {t17['plain_ms']:.4f}, torch.einsum "
          f"{t17['library_ms']:.4f}; bound {b17[0]:.6f} by {b17[1]})", flush=True)
    del H, D, fx, a14, a15, sel_in, begun, begun_p, stepped, stepped_p, again, step_k, step_p
    torch.cuda.empty_cache()
    return {"t14": t14, "t15": t15, "t16": t16, "t17": t17, "b14": b14, "b15": b15, "b16": b16, "b17": b17}


def k16_chunk_entries(trips):
    """K16's launches by entry (``genz_malik.gm_pool_launches``) in a TAI
    chunk of ``trips`` trips: one start, then one step a trip."""
    return {"begin": 1, "step": trips}


def cubature_phases(np, torch, dev, h, cold):
    """Phases 22-24: K14-K17 against their plain versions, the TAI leg and
    the fixed-rule nest. Returns the kernels' JSON entries and the TAI leg's
    numbers (phase 22's under "rule")."""
    from autobzcore_torch import (FBZ, IAI, PTR, TAI, AbsoluteEstimate, AuxQuadGKJL, CubicLimits,
                                  EvalCounter, InversionSymIBZ, IntegralProblem, NestedQuad, QuadGKJL,
                                  QuadratureFunction, init, load_bz, solve, trapz)
    from autobzcore_torch.models.observables import dos_integrand, gm_leaf_dos
    from autobzcore_torch.models.tight_binding import synthetic_wannier
    from autobzcore_torch.ops import adaptive as tad
    from autobzcore_torch.ops import genz_malik as tgm
    from autobzcore_torch.ops.fourier_eval import fourier_points
    from autobzcore_torch.parallel.sweep import SweepSolver
    from autobzcore_torch.parameters import LaneParams

    src = "autobzcore_torch/csrc/"
    oms = cold["oms"]
    rule = rule_phase(np, torch, dev, h, oms)
    t14, t15, t16, t17 = (rule[k] for k in ("t14", "t15", "t16", "t17"))
    b14, b15, b16, b17 = (rule[k] for k in ("b14", "b15", "b16", "b17"))

    # 23. the TAI leg at full width ---------------------------------------------------------
    bz = cold["bz"]
    prob = IntegralProblem(dos_integrand(h, ETA), bz)
    fourier_points.launches = 0
    gm_leaf_dos.launches = 0
    for key in tgm.gm_pool_launches:
        tgm.gm_pool_launches[key] = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls, d_tai = [], None
    for run in range(TAI_RUNS):
        t0 = time.perf_counter()
        sweep = SweepSolver(prob, TAI(), abstol=IAI_ABSTOL, chunk=IAI_OMEGAS, scan=True)
        d_run = sweep(oms)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if run == 0:
            # K16 by entry: a chunk's start and its trips' steps
            entries16 = dict(tgm.gm_pool_launches)
            launches = {"fourier_points": fourier_points.launches, "gm_leaf_dos": gm_leaf_dos.launches,
                        "gm_pool_step": sum(entries16.values())}
            d_tai, ne, st, rc = d_run, sweep.lane_numevals, sweep.stats, sweep.retcode
            peak = torch.cuda.max_memory_allocated() / 2**20
        elif not np.array_equal(d_run, d_tai):
            fail("TAI: a rerun of the chunk gave other values")
    if min(launches.values()) <= 0:
        fail(f"the TAI main path did not go through every kernel: {launches}")
    trips = st.trips.get(1, 0)
    tai = {"tai_walls": walls, "tai_numevals": int(np.sum(ne)), "tai_trips": trips, "tai_syncs": st.syncs,
           "tai_retcodes": [str(r) for r in np.atleast_1d(rc)]}
    print(f"TAI main path: flagship FBZ, eta {ETA}, {IAI_OMEGAS} omegas, abstol {IAI_ABSTOL}, cap 4096, "
          f"nbisect 4: walls {', '.join(f'{w:.3f}' for w in walls)} s; numevals {int(np.sum(ne))} (per omega "
          f"min {ne.min()} max {ne.max()}); retcode {rc}; trips {trips}; host syncs {st.syncs}; launches "
          f"{launches}, K16's by entry {entries16}; peak device memory {peak:.1f} MiB", flush=True)
    if not (d_tai.shape == (IAI_OMEGAS,) and np.all(np.isfinite(d_tai))):
        fail(f"TAI sweep: shape {d_tai.shape}, finite {np.all(np.isfinite(d_tai))}")
    if trips != TAI_TRIPS:
        fail(f"TAI: {trips} trips, expected {TAI_TRIPS}")
    if entries16 != k16_chunk_entries(trips):
        fail(f"TAI: K16 ran {entries16} for {trips} trips, expected {k16_chunk_entries(trips)}")
    # one more chunk under torch.profiler: K16's device time a trip beside K15's and K1's
    prof = profile("TAI main path", lambda: SweepSolver(prob, TAI(), abstol=IAI_ABSTOL, chunk=IAI_OMEGAS,
                                                        scan=True)(oms))
    k16_dev = device_sum_ms(prof, ("gm_pool",))
    n16 = None if prof is None else sum(n for k, n, _ in prof["rows"] if "gm_pool" in k)
    tai.update(tai_k16_device_ms=k16_dev, tai_k16_kernels=n16, tai_busy=None if prof is None else prof["busy"],
               tai_profiled_wall=None if prof is None else prof["wall"],
               tai_k15_device_ms=device_sum_ms(prof, ("gm_leaf_dos",)),
               tai_k1_device_ms=device_sum_ms(prof, ("fourier_points",)))
    print(f"TAI profiled chunk: K16 {ms_text(k16_dev)} of device time over {n16} kernels "
          f"({ms_text(None if k16_dev is None else k16_dev / trips)} a trip; the former select and update 0.0225 a "
          f"trip: 14.907 ms over 1,023 and 8.117 over 1,024), K15 {ms_text(tai['tai_k15_device_ms'])}, K1 "
          f"{ms_text(tai['tai_k1_device_ms'])}", flush=True)

    # the kernels against the plain versions: the same lanes with their final pools
    jac = abs(np.linalg.det(bz.B))  # the BZ layer's scale, (2 pi)^3

    def lanes(plain):
        cache = init(prob, TAI(plain_kernels=plain))
        cv = cache.cacheval
        atol = IAI_ABSTOL / jac
        params = LaneParams(cache.p, torch.as_tensor(oms, device=dev), True)
        return cv["alg"].solve_lanes(cv["inner"], params, atol, 0.0, return_state=True)

    t0 = time.perf_counter()
    kv, ke, kn, kc, kpool = lanes(False)
    pv, pe, pn, pc, ppool = lanes(True)
    torch.cuda.synchronize()
    t_pair = time.perf_counter() - t0
    scale = (2 * math.pi) ** 3
    rel_v = float((kv - pv).abs().max() / pv.abs().max())
    same_counts = torch.equal(kn, pn) and torch.equal(kc, pc)
    lane_same = [all(torch.equal(getattr(kpool, k)[j], getattr(ppool, k)[j]) for k in ("c", "h", "sd", "n"))
                 for j in range(IAI_OMEGAS)]
    same_pools = same_counts and all(lane_same)
    pool_rel = max(float((kpool.val - ppool.val).abs().max()), float((kpool.err - ppool.err).abs().max())) \
        / float(ppool.val.abs().max())
    conv = kc.cpu().numpy()
    ne_k = kn.cpu().numpy()
    unconv = ne_k[~conv]
    d_lanes = kv.cpu().numpy() * jac
    print(f"TAI kernels vs plain_kernels=True on the {IAI_OMEGAS} lanes ({t_pair:.2f} s for both): numevals, "
          f"retcodes identical {same_counts}, centres, halves, splitdim and n identical in "
          f"{sum(lane_same)} of {IAI_OMEGAS} lanes; values rel {rel_v:.3e}, pool "
          f"values and errors rel {pool_rel:.3e} (<= 1e-12); per-lane numevals {ne_k.astype(int).tolist()}; "
          f"retcodes {conv.astype(int).tolist()}; the sweep's values equal the lanes' "
          f"{bool(np.array_equal(d_lanes, d_tai))}", flush=True)
    if not (same_pools and rel_v <= 1e-12 and pool_rel <= 1e-12):
        fail("TAI kernels and plain versions disagree")
    if not (np.all(unconv == UNCONVERGED_EVALS) and np.array_equal(ne_k.astype(np.int64), ne)):
        fail(f"TAI: unconverged lanes must count {UNCONVERGED_EVALS} evals, got {unconv.tolist()}")
    if not np.array_equal(d_lanes, d_tai):
        fail("TAI: the sweep's values differ from the lanes'")
    d_ptr = cold["d_ptr"]
    dconv = float(np.max(np.abs(d_tai[conv] - d_ptr[conv]))) if conv.any() else float("nan")
    pick = [int(np.argmax(~conv)), int(np.argmax(conv))] if conv.any() and (~conv).any() else [0, IAI_OMEGAS // 2]
    alone = [solve(IntegralProblem(dos_integrand(h, ETA), bz, float(oms[j])), TAI(), abstol=IAI_ABSTOL)
             for j in pick]
    same_alone = all(float(s.u) == d_tai[j] and s.numevals == ne[j] for s, j in zip(alone, pick))
    print(f"TAI: {int(conv.sum())} of {IAI_OMEGAS} lanes converge; unconverged lanes count "
          f"{sorted(set(unconv.astype(int).tolist()))} evals (= 33 + 1023 x 8 x 33 = {UNCONVERGED_EVALS}); "
          f"max|D - D_PTR(400)| over the converged lanes {dconv:.4e} (a reading: a lane may certify on "
          f"its first box, as the reference's does); omegas {[round(float(oms[j]), 4) for j in pick]} "
          f"alone equal their lanes {same_alone}", flush=True)
    if not same_alone:
        fail("TAI: a frequency solved alone differs from its lane in the chunk")

    # the reference's 2-D case, and TAI's unit measure (a plain integrand: K14)
    h2 = synthetic_wannier(2, nr=3, ndim=2, seed=3, device=dev)
    bz2 = load_bz(FBZ(), np.eye(2))
    s2 = solve(IntegralProblem(dos_integrand(h2, 0.8), bz2, 0.3), TAI(), abstol=1e-5)
    p2 = float(solve(IntegralProblem(dos_integrand(h2, 0.8), bz2, 0.3), PTR()).u)
    tgm.gm_rule_reduce.launches = 0
    units = [float(solve(IntegralProblem(lambda x, p: torch.ones((), dtype=torch.float64, device=x.device),
                                         load_bz(kind, np.eye(3))), TAI()).u)
             for kind in (FBZ(), InversionSymIBZ())]
    launches["gm_rule_reduce"] = tgm.gm_rule_reduce.launches
    print(f"TAI 2-D case (synthetic_wannier(2, nr=3, ndim=2, seed=3), eta 0.8, omega 0.3, abstol 1e-5): "
          f"{float(s2.u):.10f}, retcode {s2.retcode}, numevals {s2.numevals}; PTR {p2:.10f}, |d| "
          f"{abs(float(s2.u) - p2):.3e} (<= 5e-5); unit measure FBZ {units[0]:.10f}, InversionSymIBZ "
          f"{units[1]:.10f} ((2 pi)^3 = {scale:.10f}, 1e-6); K14 launches {launches['gm_rule_reduce']}",
          flush=True)
    if not (s2.retcode and abs(float(s2.u) - p2) <= 5e-5):
        fail("TAI's 2-D case does not certify within 5e-5 of PTR")
    if not all(abs(u - scale) <= 1e-6 * scale for u in units) or launches["gm_rule_reduce"] <= 0:
        fail(f"TAI unit measure {units}, K14 launches {launches['gm_rule_reduce']}")
    torch.cuda.empty_cache()

    # 24. fixed rules at full width -------------------------------------------------------------
    algs = (AuxQuadGKJL(), AuxQuadGKJL(), QuadratureFunction(trapz, npt=FIXED_NPT))
    oms24 = oms[:FIXED_OMEGAS]
    tad.fixed_rule_reduce.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sweep = SweepSolver(prob, IAI(algs, inner_cap=64, inner_nbisect=4), abstol=IAI_ABSTOL,
                        chunk=IAI_OMEGAS, scan=True)
    d_fix = sweep(oms24)
    torch.cuda.synchronize()
    wall24 = time.perf_counter() - t0
    launches["fixed_rule_reduce"] = tad.fixed_rule_reduce.launches
    peak24 = torch.cuda.max_memory_allocated() / 2**20
    st = sweep.stats
    ne24 = sweep.lane_numevals
    rel_ptr = float(np.max(np.abs(d_fix - d_ptr[:FIXED_OMEGAS])) / np.max(np.abs(d_ptr[:FIXED_OMEGAS])))
    print(f"fixed-outer IAI: flagship FBZ, trapz(npt={FIXED_NPT}) outermost, AuxQuadGKJL below "
          f"(inner_cap 64, inner_nbisect 4), {FIXED_OMEGAS} omegas, abstol {IAI_ABSTOL}: wall {wall24:.3f} s; "
          f"numevals {sweep.numevals} (per omega min {ne24.min()} max {ne24.max()}); retcode {sweep.retcode}; "
          f"trips (2 mid, 1 leaf) {dict(sorted(st.trips.items(), reverse=True))}; host syncs {st.syncs}; K17 "
          f"launches {launches['fixed_rule_reduce']}; peak device memory {peak24:.1f} MiB; D vs PTR(npt=400): "
          f"max|dD| / max|D| {rel_ptr:.4e} (a reading: the fixed rule certifies nothing)", flush=True)
    if launches["fixed_rule_reduce"] <= 0 or not (np.all(np.isfinite(d_fix)) and sweep.retcode):
        fail(f"fixed-outer IAI: K17 launches {launches['fixed_rule_reduce']}, retcode {sweep.retcode}")
    pick = [FIXED_OMEGAS // 3]
    psweep = SweepSolver(prob, IAI(algs, inner_cap=64, inner_nbisect=4, plain_kernels=True),
                         abstol=IAI_ABSTOL, chunk=IAI_OMEGAS, scan=True)
    d_pf = psweep(oms24[pick])
    relp = float(np.max(np.abs(d_pf - d_fix[pick]) / np.abs(d_fix[pick])))
    print(f"fixed-outer IAI vs plain path at omega {oms24[pick].round(4).tolist()}: rel {relp:.3e} "
          f"(<= 1e-12); numevals {ne24[pick].tolist()} vs {psweep.lane_numevals.tolist()}", flush=True)
    if not (relp <= 1e-12 and np.array_equal(psweep.lane_numevals, ne24[pick])):
        fail("fixed-outer IAI: kernels and plain versions disagree")
    # QuadratureFunction alone and the reference's interface cases, on the card
    A, Bq, Pq = 0.0, 2 * math.pi, 3.0
    cases = [(lambda x, p: p * torch.sin(x), 0.0), (lambda x, p: p * torch.ones_like(x), Pq * (Bq - A)),
             (lambda x, p: 1.0 / (p - torch.cos(x)), (Bq - A) / math.sqrt(Pq**2 - 1))]
    errs = [abs(float(solve(IntegralProblem(f, A, Bq, Pq), QuadratureFunction(npt=200)).u) - ref)
            for f, ref in cases]
    ones = IntegralProblem(lambda x, p: torch.ones_like(x), 0.0, 1.0)
    counts = [solve(ones, EvalCounter(alg)).numevals
              for alg in (QuadratureFunction(npt=10), QuadGKJL(order=7), QuadGKJL(order=9))]
    ae = solve(IntegralProblem(lambda x, p: torch.sin(p * x), 0.0, 1.0, 0.7),
               AbsoluteEstimate(QuadratureFunction(npt=10), QuadGKJL(), abstol=1e-3), abstol=1e-9)
    nq = solve(IntegralProblem(lambda x, p: 1.0 + torch.sum(torch.cos(x)),
                               CubicLimits(np.zeros(2), 2 * math.pi * np.ones(2))),
               NestedQuad((QuadratureFunction(npt=64), AuxQuadGKJL())), abstol=1e-6)
    print(f"QuadratureFunction(npt=200) on the reference's three 1-D cases: |error| {max(errs):.3e} (<= 1e-4); "
          f"EvalCounter counts {counts} ([10, 15, 19]); AbsoluteEstimate {ae.numevals} evals (25); "
          f"NestedQuad((QuadratureFunction(64), AuxQuadGKJL())) |d| {abs(float(nq.u) - (2 * math.pi) ** 2):.3e} "
          f"(<= 1e-4)", flush=True)
    if not (max(errs) <= 1e-4 and counts == [10, 15, 19] and ae.numevals == 25
            and abs(float(nq.u) - (2 * math.pi) ** 2) <= 1e-4):
        fail("QuadratureFunction's interface cases on the card")
    torch.cuda.empty_cache()

    def entry(name, source, replaces, t, b, library_ms):
        return {"name": name, "route": "cuda", "source": src + source, "replaces": replaces,
                "launches": launches[name], "max_abs_err": t["err"], "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": b[0], "bound_by": b[1], "library_ms": library_ms}

    gm = "autobzcore_tpu/ops/genz_malik.py:"
    return [entry("gm_rule_reduce", "gm_rule.cu", gm + "93", t14, b14, t14["library_ms"]),
            entry("gm_leaf_dos", "gm_rule.cu", "autobzcore_tpu/models/observables.py:149", t15, b15, None),
            entry("gm_pool_step", "gm_pool.cu", gm + "196", t16, b16, None),
            entry("fixed_rule_reduce", "fixed_rule.cu", "autobzcore_tpu/ops/adaptive.py:644", t17, b17,
                  t17["library_ms"])], dict(tai, rule=rule)


def rule_transport_phases(np, torch, dev, h):
    """``--phases-22-26``: phase 22 (K14-K17, K14's call) at the TAI leg's
    frequencies and phases 25-26 (K18-K20, the transport main path).
    Returns K14's and K19's numbers and the sweep's."""
    rule = rule_phase(np, torch, dev, h, np.linspace(*WINDOW, IAI_OMEGAS))
    _, _, tr = transport_phases(np, torch, dev, h)
    return dict(tr, k14=dict(rule["t14"], bound_ms=rule["b14"][0]))


def transport_phases(np, torch, dev, h):
    """Phases 25-26: K18-K20 against their plain versions at the main path's
    shapes, then the transport main path (``examples/transport_example.py``'s
    flow) at full width. Returns the kernels' JSON entries, the chemical
    potential at filling 1 and the numbers of K19 and the sweep."""
    from autobzcore_torch import FBZ, CubicSymIBZ, load_bz
    from autobzcore_torch.ops.eigh3 import EIGH_CHUNK
    from autobzcore_torch.models import observables as obs
    from autobzcore_torch.models import transport as tr
    from autobzcore_torch.models.tight_binding import tb_integer
    from autobzcore_torch.ops import fourier_eval as fe

    src = "autobzcore_torch/csrc/"
    t_phases = time.perf_counter()
    bz = load_bz(FBZ(), np.eye(3))
    m, d = 3, 3
    rng = np.random.default_rng(25)

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    # 25. K18-K20 against their plain versions -------------------------------------------
    # K18 on the flagship's npt=60 grid: K11 and eigh in the pack's chunks, then all points at once
    X = obs.grid_points(3, [np.arange(TR_NPT) / TR_NPT * t for t in h.period], None, dev)
    orders = fe.jacobian_orders(3)
    Js, Us = [], []
    for s in range(0, X.shape[0], EIGH_CHUNK):
        J = fe.fourier_points_derivs(h.c, X[s:s + EIGH_CHUNK], h.offset, h.period, orders).reshape(-1, 4, m, m)
        Js.append(J)
        Us.append(torch.linalg.eigh(J[:, 0])[1])
    J, U = torch.cat(Js), torch.cat(Us).contiguous()
    del Js, Us
    dH = J[:, 1:]
    K = U.shape[0]
    w1 = torch.ones(K, dtype=torch.float64, device=dev)
    k18, p18 = obs.velocity_pairs(U, dH, w1), obs.velocity_pairs_plain(U, dH, w1)
    same18 = torch.equal(k18, obs.velocity_pairs(U, dH, w1))
    rel18 = rel(k18, p18)
    if not (rel18 <= 1e-12 and same18):
        fail(f"K18 velocity_pairs at {K} points: max rel vs plain {rel18:.3e}, repeat identical {same18}")
    Uh = U.conj().transpose(1, 2)

    def library18():
        v = torch.einsum("kmi,kdij,kjn->kdmn", Uh, dH, U)
        return torch.einsum("kanm,kbmn->kabnm", v, v)

    t18 = {"err": float((k18 - p18).abs().max()), "ms": cuda_ms(lambda: obs.velocity_pairs(U, dH, w1), 10),
           "plain_ms": cuda_ms(lambda: obs.velocity_pairs_plain(U, dH, w1), 3), "library_ms": cuda_ms(library18, 3)}
    b18 = bound(K * (d * m * m * (8 * m * m + 8 * m) + m * m * d * d * 4),
                nbytes(U, w1, k18) + 16 * dH.numel())
    print(f"K18 velocity_pairs on the flagship's npt={TR_NPT} grid ({K} points, m = {m}, d = {d}): max rel vs plain "
          f"{rel18:.3e} (<= 1e-12), repeat bit-identical; {t18['ms']:.4f} ms (plain {t18['plain_ms']:.4f} ms, the "
          f"reference's two torch.einsum {t18['library_ms']:.4f} ms, bound {b18[0]:.4f} ms by {b18[1]})", flush=True)
    del J, U, Uh, dH, k18, p18
    pack = obs.spectral_velocity_pack(h, bz, TR_NPT)
    e, Wm, sc = pack.e, pack.Wmat, pack.scale
    lo, hi = -2.0 - 0.6, 0.6  # a window like the main path's: [mu - max Omega - t, mu + t]

    def k19_bound(B, same, e, Wm):
        # per (pair, point): m Lorentzians at equal frequencies, else 2m, and
        # the m^2 pair products at the FP64 rate; the 2 m^2 d^2 operations of
        # the contraction by Wmat, a real FP64 matrix product, on the tensor
        # cores, which work beside the CUDA cores: the longer of the two counts
        K = e.shape[0]
        lorentz = (1 if same else 2) * m * LORENTZ_RECIP_FLOPS + m * m
        return bound(B * K * lorentz, nbytes(e, Wm) + 8 * B * ((2 if same else 4) + d * d),
                     mma_flops=B * K * 2 * m * m * d * d)

    # the three cases: 64 equal frequencies; a 960-node trip (8 lanes x 8 intervals x 15
    # nodes) at Omega != 0; the same nodes under a scalar self-energy
    om64 = torch.linspace(lo, hi, 64, dtype=torch.float64, device=dev)
    eta64 = torch.full_like(om64, TR_ETA)
    w960 = torch.as_tensor(rng.uniform(lo, hi, 960), device=dev)
    Om960 = torch.as_tensor(np.repeat(np.linspace(0.25, 2.0, 8), 120), device=dev)
    x2 = (w960 + Om960).contiguous()
    eta960 = torch.full_like(w960, TR_ETA)

    def sigma(x):
        return 0.05 * x - 1j * (TR_ETA + 0.2 * x * x)

    s1, s2 = sigma(w960), sigma(x2)
    cases = {"equal64": (om64, eta64, om64, eta64), "trip960": (w960, eta960, x2, eta960),
             "selfenergy960": ((w960 - s1.real).contiguous(), (-s1.imag).contiguous(), (x2 - s2.real).contiguous(),
                               (-s2.imag).contiguous())}
    t19 = {}
    for tag, (y1, g1, y2, g2) in cases.items():
        k, k2 = obs.transport_gamma(e, Wm, y1, g1, y2, g2, sc), obs.transport_gamma(e, Wm, y1, g1, y2, g2, sc)
        p_ = obs.transport_gamma_plain(e, Wm, y1, g1, y2, g2, sc)
        r, same = rel(k, p_), torch.equal(k, k2)
        if not (r <= 1e-12 and same):
            fail(f"K19 transport_gamma {tag}: max rel vs plain {r:.3e}, repeat identical {same}")
        B = y1.shape[0]
        t19[tag] = {"err": float((k - p_).abs().max()), "rel": r, "B": B, "plain": p_,
                    "ms": cuda_ms(lambda: obs.transport_gamma(e, Wm, y1, g1, y2, g2, sc), 5),
                    "device_ms": device_ms(lambda: obs.transport_gamma(e, Wm, y1, g1, y2, g2, sc), 5),
                    "plain_ms": cuda_ms(lambda: obs.transport_gamma_plain(e, Wm, y1, g1, y2, g2, sc), 2),
                    "bound": k19_bound(B, y2 is y1 and g2 is g1, e, Wm)}
    # the library call: torch.matmul of the materialized pair rows by Wmat, at
    # 64 equal frequencies and at the trip (960 rows, 14.9 GB, built 64 rows at a time)
    for tag in ("equal64", "trip960"):
        y1, g1, y2, g2 = cases[tag]
        pairs = torch.empty((y1.shape[0], Wm.shape[0]), dtype=torch.float64, device=dev)
        for s0 in range(0, y1.shape[0], 64):
            A1 = obs.spectral_weights(y1[s0:s0 + 64], g1[s0:s0 + 64], e)
            A2 = obs.spectral_weights(y2[s0:s0 + 64], g2[s0:s0 + 64], e)
            pairs[s0:s0 + 64] = (A1[..., :, None] * A2[..., None, :]).reshape(A1.shape[0], -1)
        del A1, A2
        t19[tag]["library_rel"] = rel(sc * torch.matmul(pairs, Wm), t19[tag].pop("plain"))
        t19[tag]["library_ms"] = cuda_ms(lambda: torch.matmul(pairs, Wm), 3)
        del pairs
    t19["selfenergy960"].pop("plain")
    torch.cuda.empty_cache()
    # the B11d shape: the transport integrand under PTR(100), 256 equal lanes on the
    # flagship's 1e6-point pack (phase 32's sweep)
    p100 = obs.spectral_velocity_pack(h, bz, NPT)
    e1, W1, sc1 = p100.e, p100.Wmat, p100.scale
    om256 = torch.as_tensor(np.linspace(*WINDOW, TR_PTR_OMEGAS), device=dev)
    eta256 = torch.full_like(om256, ETA)
    k, k2 = obs.transport_gamma(e1, W1, om256, eta256, om256, eta256, sc1), \
        obs.transport_gamma(e1, W1, om256, eta256, om256, eta256, sc1)
    p_ = obs.transport_gamma_plain(e1, W1, om256, eta256, om256, eta256, sc1)
    r, same = rel(k, p_), torch.equal(k, k2)
    if not (r <= 1e-12 and same):
        fail(f"K19 transport_gamma at the B11d shape: max rel vs plain {r:.3e}, repeat identical {same}")
    t19["ptr256"] = {"err": float((k - p_).abs().max()), "rel": r, "B": TR_PTR_OMEGAS, "K": e1.shape[0],
                     "ms": cuda_ms(lambda: obs.transport_gamma(e1, W1, om256, eta256, om256, eta256, sc1), 3),
                     "device_ms": device_ms(lambda: obs.transport_gamma(e1, W1, om256, eta256, om256, eta256, sc1), 3),
                     "plain_ms": cuda_ms(lambda: obs.transport_gamma_plain(e1, W1, om256, eta256, om256, eta256, sc1),
                                         1),
                     "bound": k19_bound(TR_PTR_OMEGAS, True, e1, W1)}
    del p100, e1, W1, k, k2, p_
    torch.cuda.empty_cache()
    print(f"K19 transport_gamma on the flagship's npt={TR_NPT} pack ({K} points) and, for ptr256, its npt={NPT} "
          f"pack: " + "; ".join(
              f"{tag} (B = {t['B']}): max rel vs plain {t['rel']:.3e} (<= 1e-12), repeat bit-identical, {t['ms']:.4f} "
              f"ms by events, device {ms_text(t['device_ms'])} (plain {t['plain_ms']:.4f} ms, bound {t['bound'][0]:.4f} "
              f"ms by {t['bound'][1]})" for tag, t in t19.items()) +
          "; torch.matmul of the materialized pair rows by Wmat: " + ", ".join(
              f"{tag} {t19[tag]['library_ms']:.4f} ms (rel {t19[tag]['library_rel']:.3e})"
              for tag in ("equal64", "trip960")), flush=True)
    # K20 at several (mu, beta), beta = inf among them
    wk = torch.as_tensor(np.asarray(pack.weights), dtype=torch.float64, device=dev)
    errs20 = []
    for mu_, beta_ in ((0.0086, TR_BETA), (0.5, 4.0), (-1.0, 1e3), (7.0, math.inf), (0.0, math.inf)):
        k, k2, p_ = tr.fermi_count(e, wk, mu_, beta_), tr.fermi_count(e, wk, mu_, beta_), \
            tr.fermi_count_plain(e, wk, mu_, beta_)
        r = abs(float(k) - float(p_)) / max(abs(float(p_)), 1.0)
        if not (r <= 1e-12 and torch.equal(k, k2)):
            fail(f"K20 fermi_count at mu {mu_}, beta {beta_}: rel {r:.3e}, repeat identical {torch.equal(k, k2)}")
        errs20.append(abs(float(k) - float(p_)))
    t20 = {"err": max(errs20), "ms": cuda_ms(lambda: tr.fermi_count(e, wk, 0.0086, TR_BETA), 20),
           "plain_ms": cuda_ms(lambda: tr.fermi_count_plain(e, wk, 0.0086, TR_BETA), 5)}
    b20 = bound(e.numel() * FERMI_TERM_FLOPS, nbytes(e, wk) + 8)
    print(f"K20 fermi_count on the pack's {e.numel()} energies at 5 (mu, beta), beta = inf twice: max |d| vs plain "
          f"{max(errs20):.3e} (<= 1e-12 relative), repeats bit-identical; {t20['ms']:.4f} ms (plain "
          f"{t20['plain_ms']:.4f} ms, bound {b20[0]:.5f} ms by {b20[1]})", flush=True)
    del pack, e, Wm
    torch.cuda.empty_cache()

    # 26. the transport main path at full width ----------------------------------------
    def counts():
        return {"fourier_points_derivs": fe.fourier_points_derivs.launches,
                "velocity_pairs": obs.velocity_pairs.launches,
                "transport_gamma": obs.transport_gamma.launches, "fermi_count": tr.fermi_count.launches}

    fe.fourier_points_derivs.launches = obs.velocity_pairs.launches = 0
    obs.transport_gamma.launches = tr.fermi_count.launches = 0
    omegas = np.linspace(0.0, TR_OMEGA_MAX, TR_OMEGAS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    pack = obs.spectral_velocity_pack(h, bz, TR_NPT)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    peak_pack = (torch.cuda.max_memory_allocated() - base) / 2**20
    ec = tr.ElectronCountSolver(h, bz, TR_NPT, pack=pack)
    mu = ec.find_mu(1.0, TR_BETA)
    t2 = time.perf_counter()
    steps = tr.fermi_count.launches
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    kc = tr.KineticCoefficientSolver(h, bz, TR_NPT, eta=TR_ETA, beta=TR_BETA, alpha=0, mu=mu, pack=pack)
    sig = kc.sweep(omegas, abstol=TR_ABSTOL)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    kc1 = tr.KineticCoefficientSolver(h, bz, TR_NPT, eta=TR_ETA, beta=TR_BETA, alpha=1, mu=mu, pack=pack)
    a1 = kc1(np.array([0.0]), abstol=TR_ABSTOL)[0]
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    peak_sweep = (torch.cuda.max_memory_allocated() - base) / 2**20
    launches = counts()
    print(f"transport main path: flagship, FBZ, npt={TR_NPT} ({pack.e.shape[0]} points), eta {TR_ETA}, beta "
          f"{TR_BETA}, filling 1, {TR_OMEGAS} Omegas in [0, {TR_OMEGA_MAX}] eV, abstol {TR_ABSTOL}, chunk 8: pack "
          f"{t1 - t0:.4f} s (peak {peak_pack:.1f} MiB); find_mu {t2 - t1:.4f} s, {steps} steps (K20 launches "
          f"{launches['fermi_count']}), mu = {mu!r} eV; sweep {t3 - t2:.4f} s, numevals {kc.numevals}, retcode "
          f"{kc.retcode}, GK trips {kc.stats.trips.get(1, 0)}, host syncs {kc.stats.syncs}, peak {peak_sweep:.1f} MiB "
          f"(with alpha=1); alpha=1 at Omega=0 {t4 - t3:.4f} s, numevals {kc1.numevals}, retcode {kc1.retcode}, "
          f"A1_xx(0) = {float(a1[0, 0])!r}; sigma_xx(0) = {float(sig[0, 0, 0])!r}, sigma_xx({TR_OMEGA_MAX} eV) = "
          f"{float(sig[-1, 0, 0])!r}; "
          f"launches {launches}", flush=True)
    if min(launches.values()) <= 0:
        fail(f"the transport main path did not go through every kernel: {launches}")
    if not (sig.shape == (TR_OMEGAS, 3, 3) and np.all(np.isfinite(sig)) and np.all(np.isfinite(a1))
            and kc.numevals > 0 and kc1.numevals > 0 and kc.retcode is not None):
        fail(f"transport main path output: shape {sig.shape}, finite {np.all(np.isfinite(sig))}")
    # checks: the pack and mu against the plain routes
    pp = obs.spectral_velocity_pack(h, bz, TR_NPT, points=fe.fourier_points_derivs_plain,
                                    pairs=obs.velocity_pairs_plain)
    rel_e, rel_w = rel(pack.e, pp.e), rel(pack.Wmat, pp.Wmat)
    del pp
    mu_plain = tr.ElectronCountSolver(h, bz, TR_NPT, pack=pack, count=tr.fermi_count_plain).find_mu(1.0, TR_BETA)
    mu_cheap = tr.ElectronCountSolver(h, bz, TR_NPT).find_mu(1.0, TR_BETA)  # K1 + K9, no pack
    n_full = ec(7.0, math.inf)
    # one full-width Omega by the kernel route and by the plain route
    i = TR_OMEGAS // 3
    solos = {}
    for plain in (False, True):
        k = tr.KineticCoefficientSolver(h, bz, TR_NPT, eta=TR_ETA, beta=TR_BETA, mu=mu, pack=pack,
                                        gamma=obs.transport_gamma_plain if plain else obs.transport_gamma)
        ts = time.perf_counter()
        v = k(omegas[i:i + 1], abstol=TR_ABSTOL)[0]
        torch.cuda.synchronize()
        solos[plain] = (v, k.numevals, k.retcode, time.perf_counter() - ts)
    (vk, nk, rk, tk), (vp, npl, rp, tp) = solos[False], solos[True]
    rel_route = float(np.max(np.abs(vk - vp)) / np.max(np.abs(vp)))
    # the reference's identity: K19 at (w, w) over the window is TransportSolver's Gamma(w)
    ws = torch.linspace(mu - 0.3, mu + 0.3, 16, dtype=torch.float64, device=dev)
    G_kc = kc._integrand(ws, 0.0) / tr.fermi_window(ws, 0.0, TR_BETA, mu)[:, None, None]
    G_ts = obs.TransportSolver(None, None, None, TR_ETA, pack=pack)(ws.cpu().numpy())
    rel_id = float(np.max(np.abs(G_kc.cpu().numpy() - G_ts)) / np.max(np.abs(G_ts)))
    # tb_integer(3): the cubic wedge against the full zone
    h3 = tb_integer(3, device=dev)
    ibz = []
    for kind in (CubicSymIBZ(), FBZ()):
        k = tr.KineticCoefficientSolver(h3, load_bz(kind, np.eye(3)), 20, eta=0.1, beta=10.0, mu=0.3)
        ibz.append((k(np.array([0.7]), abstol=1e-6)[0], k.numevals,
                    obs.TransportSolver(None, None, None, 0.1, pack=k.pack)(np.array([0.2, 1.1]))))
    rel_ibz = max(float(np.max(np.abs(ibz[0][0] - ibz[1][0])) / np.max(np.abs(ibz[1][0]))),
                  float(np.max(np.abs(ibz[0][2] - ibz[1][2])) / np.max(np.abs(ibz[1][2]))))
    wall = time.perf_counter() - t_phases
    print(f"transport main path checks: pack vs plain route e {rel_e:.3e}, Wmat {rel_w:.3e} (<= 1e-12); mu vs plain "
          f"K20 {abs(mu - mu_plain):.3e}, vs the cheap build (K1 + K9) {abs(mu - mu_cheap):.3e} (<= 1e-9); n(7 eV, "
          f"beta = inf) = {n_full!r} (3 exactly); Omega = {omegas[i]:.6f} alone: kernel route {tk:.3f} s, plain "
          f"{tp:.3f} s, numevals {nk} vs {npl}, retcode {rk} vs {rp}, rel {rel_route:.3e} (<= 1e-10); K19(w, w) / window vs TransportSolver at 16 w: rel {rel_id:.3e} (<= 1e-10); "
          f"tb_integer(3) npt 20 CubicSymIBZ vs FBZ: rel {rel_ibz:.3e} (<= 1e-10), numevals {ibz[0][1]} vs "
          f"{ibz[1][1]}; phases 25-26 {wall:.3f} s (<= 60)", flush=True)
    if not (rel_e <= 1e-12 and rel_w <= 1e-12 and abs(mu - mu_plain) <= 1e-9 and abs(mu - mu_cheap) <= 1e-9
            and n_full == 3.0):
        fail("transport checks: the pack, mu or the band count")
    if not (nk == npl and rk == rp and rel_route <= 1e-10):
        fail("transport checks: the kernel and plain routes disagree on one Omega")
    if not (rel_id <= 1e-10 and rel_ibz <= 1e-10 and ibz[0][1] == ibz[1][1]):
        fail("transport checks: the TransportSolver identity or the cubic wedge")
    if wall > 60.0:
        fail(f"phases 25-26 took {wall:.1f} s (> 60)")
    if "--profile" in sys.argv[1:]:
        profile("transport main path (the 32-Omega sweep)", lambda: tr.KineticCoefficientSolver(
            h, bz, TR_NPT, eta=TR_ETA, beta=TR_BETA, alpha=0, mu=mu, pack=pack).sweep(omegas, abstol=TR_ABSTOL))
    trips26, syncs26, nev1 = kc.stats.trips.get(1, 0), kc.stats.syncs, kc1.numevals
    numevals26, retcode26 = kc.numevals, kc.retcode
    del pack, kc, kc1, ec
    torch.cuda.empty_cache()

    def entry(name, source, replaces, t, b, library_ms):
        return {"name": name, "route": "cuda", "source": src + source, "replaces": replaces,
                "launches": launches[name], "max_abs_err": t["err"], "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": b[0], "bound_by": b[1], "library_ms": library_ms}

    return [entry("velocity_pairs", "velocity_pairs.cu", "autobzcore_tpu/models/observables.py:326", t18, b18,
                  t18["library_ms"]),
            entry("transport_gamma", "transport_gamma.cu", "autobzcore_tpu/models/observables.py:379",
                  t19["trip960"], t19["trip960"]["bound"], t19["trip960"]["library_ms"]),
            entry("fermi_count", "fermi_count.cu", "autobzcore_tpu/models/transport.py:302", t20, b20, None)], mu, {
        "k19": {tag: {"ms": t["ms"], "device_ms": t["device_ms"], "plain_ms": t["plain_ms"], "rel": t["rel"],
                      "bound_ms": t["bound"][0], "library_ms": t.get("library_ms")} for tag, t in t19.items()},
        "sweep_s": t3 - t2, "numevals": int(numevals26), "retcode": str(retcode26), "gk_trips": trips26,
        "host_syncs": syncs26, "alpha1_s": t4 - t3, "alpha1_numevals": int(nev1), "launches": launches,
        "mu": mu, "phases_s": wall}


def k24_phase(np, torch, dev, hw, bz3, reps=20):
    """Phase 27's K24: the Weyl pack at npt 192 (7,077,888 points, m = 2,
    d = 3) in every weight mode against the plain version (1e-13 of the
    terms' scale, bit-identical repeats), then the AHC's step mode by events
    (``reps`` calls) and by torch.profiler's device time, beside
    ``torch.einsum`` of precomputed weights and the bound. Returns
    (times, bound)."""
    from autobzcore_torch.models import berry as br

    pw = br.berry_pack(hw, bz3, WEYL_NPT)
    e, Om, vd = pw.e, pw.Om, pw.vd
    t24 = {}
    for tag, mode, beta in (("step", "step", None), ("fermi", "fermi", 40.0), ("entropy", "entropy", 40.0),
                            ("dipole", "dipole", 40.0), ("grand", "grand", 40.0), ("grand T=0", "grand", None),
                            ("band", "band", None)):
        got, again = br.zone_average(e, Om, mode, 0.1, beta, vd=vd), br.zone_average(e, Om, mode, 0.1, beta, vd=vd)
        want = br.zone_average_plain(e, Om, mode, 0.1, beta, vd=vd)
        scale = float(br.zone_average_plain(e, Om.abs(), mode, 0.1, beta, vd=vd.abs()).abs().max())
        r = float((got - want).abs().max()) / scale
        if not (r <= 1e-13 and torch.equal(got, again)):
            fail(f"K24 zone_average {tag}: |d| vs plain {r:.3e} of the terms' scale (> 1e-13), repeat identical "
                 f"{torch.equal(got, again)}")
        t24[tag] = r
    w_step = br.zone_weights(e, "step", 0.0)
    t24k = {"err": max(t24.values()), "ms": cuda_ms(lambda: br.zone_average(e, Om, "step", 0.0), reps),
            "plain_ms": cuda_ms(lambda: br.zone_average_plain(e, Om, "step", 0.0), 3),
            "library_ms": cuda_ms(lambda: torch.einsum("km,kmab->ab", w_step, Om), reps),
            "device_ms": device_ms(lambda: br.zone_average(e, Om, "step", 0.0), reps, "zone_average"),
            "library_device_ms": device_ms(lambda: torch.einsum("km,kmab->ab", w_step, Om), reps),
            "fermi_ms": cuda_ms(lambda: br.zone_average(e, Om, "fermi", 0.0, 40.0), reps)}
    b24 = bound(Om.numel() * 2 + e.numel() * 2, nbytes(e, Om) + 8 * 9)
    share = "" if t24k["device_ms"] is None else f", {100 * b24[0] / t24k['device_ms']:.1f} % of it on the device"
    print(f"K24 zone_average on the Weyl pack (npt {WEYL_NPT}, {e.shape[0]} points, m = 2, d = 3), |d| vs plain of the "
          "terms' scale: " + ", ".join(f"{k} {v:.3e}" for k, v in t24.items()) + " (<= 1e-13), repeats bit-identical; "
          f"the AHC (step) {t24k['ms']:.4f} ms by events, device {ms_text(t24k['device_ms'])} (profiler; plain "
          f"{t24k['plain_ms']:.4f} ms; torch.einsum of precomputed weights {t24k['library_ms']:.4f} ms by events, "
          f"device {ms_text(t24k['library_device_ms'])}; bound {b24[0]:.4f} ms by {b24[1]}{share}); Fermi weights "
          f"{t24k['fermi_ms']:.4f} ms", flush=True)
    del pw, e, Om, vd, w_step
    torch.cuda.empty_cache()
    return t24k, b24


def berry_phases(np, torch, dev):
    """Phases 27-28: K21-K24 against their plain versions at the main path's
    shapes, then the topology main path (``examples/topology_example.py``'s
    modes) at full width. Returns the kernels' JSON entries."""
    from autobzcore_torch import FBZ, IAI, PTR, TAI, EvalCounter, IntegralProblem, load_bz, solve
    from autobzcore_torch.models import berry as br
    from autobzcore_torch.models.tight_binding import tb_haldane, tb_kane_mele, tb_kane_mele_sz, tb_weyl
    from autobzcore_torch.ops.cuda_lib import load_kernels
    from autobzcore_torch.ops.eigh3 import eigh2, eigh_small
    from autobzcore_torch.parallel.sweep import SweepSolver
    from autobzcore_torch.parameters import MixedParameters

    src = "autobzcore_torch/csrc/"
    t_phases = time.perf_counter()
    bz2, bz3 = load_bz(FBZ(), np.eye(2)), load_bz(FBZ(), np.eye(3))
    lib = load_kernels()
    sz = np.diag([0.5, 0.5, -0.5, -0.5])

    def field_err(a, b):
        return float((a - b).abs().max() / b.abs().max())

    def pair_check(tag, got, want):
        got, want = (got,) if torch.is_tensor(got) else got, (want,) if torch.is_tensor(want) else want
        errs = [field_err(a, b) for a, b in zip(got, want)]
        if not max(errs) <= 1e-12:
            fail(f"K21 band_pair_terms {tag}: field errors vs plain {errs} (> 1e-12 of the field's scale)")
        return max(float((a - b).abs().max()) for a, b in zip(got, want))

    # 27. K21-K24 against their plain versions --------------------------------------------
    # K21 at the point mode's shape: Haldane, all 1,048,576 points of npt = 1024, m = 2, d = 2
    hh = tb_haldane(t2=0.1, phi=math.pi / 2, M=0.0, device=dev)
    u_all = np.arange(BERRY_NPT) / BERRY_NPT
    H, dH = br._eval_slab(hh, 2, u_all, [u_all])
    K = H.shape[0]
    k21 = br.band_pair_terms(H, dH, 1e-8)
    err21 = pair_check("Haldane npt 1024", k21, br.band_pair_terms_plain(H, dH, 1e-8))
    if not all(torch.equal(a, b) for a, b in zip(k21, br.band_pair_terms(H, dH, 1e-8))):
        fail("K21 band_pair_terms: two runs on the same inputs differ")
    ms21_all = cuda_ms(lambda: br.band_pair_terms(H, dH, 1e-8), 20)
    del k21, H, dH
    # the entry's numbers at the shape the build launches: one row slab of 2^18 points
    u1h, innerh = br._slab_rows(hh, BERRY_NPT, 2)
    Hs, dHs = br._eval_slab(hh, 2, u1h[0], innerh)
    Ks = Hs.shape[0]
    k21 = br.band_pair_terms(Hs, dHs, 1e-8)
    err21 = max(err21, pair_check(f"Haldane slab ({Ks} points)", k21, br.band_pair_terms_plain(Hs, dHs, 1e-8)))
    e2, U2 = eigh2(Hs)
    Ud2 = U2.conj().transpose(1, 2)

    def library21():
        v = torch.einsum("kmi,kdij,kjn->kdmn", Ud2, dHs, U2)
        return torch.einsum("kanm,kbmn->kabnm", v, v)

    t21 = {"err": err21, "ms": cuda_ms(lambda: br.band_pair_terms(Hs, dHs, 1e-8), 20),
           "plain_ms": cuda_ms(lambda: br.band_pair_terms_plain(Hs, dHs, 1e-8), 3), "library_ms": cuda_ms(library21, 3)}
    m, d = 2, 2
    # bytes: H and dH read, e, Om, Mm and vd written; operations: the closed
    # form (~40), U^H dH U (d m^2 (8 m^2 + 8 m)) and the pair sums (2 m d^2 terms
    # of m pairs, ~24 each with the two reciprocals counted as 8)
    b21 = bound(Ks * (40 + d * m * m * (8 * m * m + 8 * m) + 2 * m * d * d * m * 24),
                nbytes(Hs, dHs) + sum(nbytes(t) for t in k21))
    del k21, e2, U2, Ud2, Hs, dHs
    # one slab of the Weyl build (d = 3) and one of the spin-Hall build (m = 4) in all three modes
    hw = tb_weyl(2.0, device=dev)
    u1w, innerw = br._slab_rows(hw, WEYL_NPT, 3)
    Hw, dHw = br._eval_slab(hw, 3, u1w[0], innerw)
    errw = pair_check(f"Weyl slab ({Hw.shape[0]} points, d = 3)", br.band_pair_terms(Hw, dHw, 1e-8),
                      br.band_pair_terms_plain(Hw, dHw, 1e-8))
    msw = cuda_ms(lambda: br.band_pair_terms(Hw, dHw, 1e-8), 10)
    del Hw, dHw
    hk = tb_kane_mele_sz(lam_so=0.1, M=0.0, device=dev)
    u1k, innerk = br._slab_rows(hk, BERRY_NPT, 2)
    Hk, dHk = br._eval_slab(hk, 2, u1k[0], innerk)
    Ok = torch.as_tensor(sz.astype(np.complex128), device=dev)
    eig = tuple(t.contiguous() for t in eigh_small(Hk))
    km = {}
    for mode in ("curvature", "metric", "operator"):
        O = Ok if mode == "operator" else None
        got = br.band_pair_terms(Hk, dHk, 1e-8, mode, O)
        km[mode] = {"err": pair_check(f"Kane-Mele slab, {mode}", got, br.band_pair_terms_plain(Hk, dHk, 1e-8, mode, O)),
                    "ms": cuda_ms(lambda: br.launch_pairs(lib, Hk, dHk, eig, O, 1e-8, mode), 10)}
    ms_eigh = cuda_ms(lambda: eigh_small(Hk), 3)
    nk = Hk.shape[0]
    del Hk, dHk, eig
    print(f"K21 band_pair_terms: Haldane npt {BERRY_NPT} ({K} points, m = 2, d = 2, one launch {ms21_all:.4f} ms) and "
          f"its first row slab max|d| vs plain {err21:.3e} (<= 1e-12 of each field's scale), repeat bit-identical; the "
          f"slab of {Ks} points, as the build launches it, {t21['ms']:.4f} ms (plain {t21['plain_ms']:.4f} ms, the "
          f"reference's two torch.einsum {t21['library_ms']:.4f} ms, bound {b21[0]:.4f} ms by {b21[1]}); Weyl "
          f"slab of {u1w.shape[1] * WEYL_NPT ** 2} points (d = 3) {errw:.3e}, {msw:.4f} ms; Kane-Mele slab of {nk} "
          f"points (m = 4) after eigh_small ({ms_eigh:.4f} ms, {-(-nk // 4096)} chunks): " + ", ".join(
              f"{mode} {v['err']:.3e}, {v['ms']:.4f} ms" for mode, v in km.items()), flush=True)

    # K22 and K23 on the Haldane frames at npt 24 and 1024
    t22, t23 = {}, {}
    for npt in (24, BERRY_NPT):
        V = br._frames(hh, [np.arange(npt) / npt] * 2, None)
        F, F2, Fp = br.plaquette_flux(V), br.plaquette_flux(V), br.plaquette_flux_plain(V)
        W, W2, Wp = br.wilson_loops(V), br.wilson_loops(V), br.wilson_loops_plain(V)
        e22, e23 = abs(float(F) - float(Fp)), float((W - Wp).abs().max())
        if not (e22 <= 1e-12 and torch.equal(F, F2) and e23 <= 1e-12 and torch.equal(W, W2)):
            fail(f"K22/K23 at npt {npt}: |F - plain| {e22:.3e}, max|W - plain| {e23:.3e} (<= 1e-12), repeats "
                 f"identical {torch.equal(F, F2)}, {torch.equal(W, W2)}")
        t22[npt] = {"err": e22, "ms": cuda_ms(lambda: br.plaquette_flux(V), 20),
                    "plain_ms": cuda_ms(lambda: br.plaquette_flux_plain(V), 3),
                    "bound": bound(npt * npt * 230, nbytes(V) + 8), "C": float(F) / (2 * math.pi)}
        t23[npt] = {"err": e23, "ms": cuda_ms(lambda: br.wilson_loops(V), 5),
                    "plain_ms": cuda_ms(lambda: br.wilson_loops_plain(V), 1), "bound": bound(npt * npt * 24, nbytes(V, W))}
    del V
    print("K22 plaquette_flux / K23 wilson_loops on the Haldane frames (m = 2, nb = 1): " + "; ".join(
        f"npt {n}: C = {t22[n]['C']!r}, |d| vs plain {t22[n]['err']:.3e} and {t23[n]['err']:.3e} (<= 1e-12), repeats "
        f"bit-identical, K22 {t22[n]['ms']:.4f} ms (plain {t22[n]['plain_ms']:.4f}, bound {t22[n]['bound'][0]:.5f} ms by "
        f"{t22[n]['bound'][1]}), K23 {t23[n]['ms']:.4f} ms (plain {t23[n]['plain_ms']:.4f}, bound "
        f"{t23[n]['bound'][0]:.5f} ms by {t23[n]['bound'][1]})" for n in t22), flush=True)

    # K24 on the Weyl pack at npt 192 in every weight mode
    t24k, b24 = k24_phase(np, torch, dev, hw, bz3)
    t27 = time.perf_counter() - t_phases

    # 28. the topology main path at full width ----------------------------------------------
    kernels = (br.band_pair_terms, br.plaquette_flux, br.wilson_loops, br.zone_average)
    for k in kernels:
        k.launches = 0

    def sync_wall(t0):
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def build(h, bz, npt):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        slv = br.BerryCurvatureSolver(h, bz, npt)
        return slv, sync_wall(t0), (torch.cuda.max_memory_allocated() - base) / 2**20

    # point: the Haldane model at npt 1024
    launches0 = br.band_pair_terms.launches
    slv, w_point, peak_point = build(hh, bz2, BERRY_NPT)
    builds_point = br.band_pair_terms.launches - launches0
    t0 = time.perf_counter()
    C = slv.chern()
    I = slv.ahc(mu=0.0)
    w_q = time.perf_counter() - t0
    eg = slv.pack.e.cpu().numpy()
    lo, hi = float(eg[:, 0].max()), float(eg[:, 1].min())
    mus = lo + np.array([0.2, 0.8]) * (hi - lo)
    Ms = [float(slv.orbital_magnetization(mu=float(x))[0, 1]) for x in mus]
    slope = float((Ms[1] - Ms[0]) / (mus[1] - mus[0]))
    D = slv.berry_curvature_dipole(mu=hi + 0.3, beta=40.0)
    t0 = time.perf_counter()
    g = slv.quantum_metric()
    w_metric = sync_wall(t0)
    Omxy = slv.pack.Om[:, :, 0, 1]
    detg = g[..., 0, 0] * g[..., 1, 1] - g[..., 0, 1] * g[..., 1, 0]
    gap_bound = float((detg - (Omxy / 2) ** 2).min())
    lc = [br.lattice_chern(hh, bz2, n) for n in (12, BERRY_NPT)]
    cw = float(C[0]) / (2 * math.pi)
    print(f"topology main path, point: Haldane (t2 0.1, phi pi/2, M 0) at npt {BERRY_NPT} ({K} points): build "
          f"{w_point:.4f} s ({builds_point} K21 launches, peak {peak_point:.1f} MiB); chern + ahc {w_q:.4f} s; C = "
          f"{C.tolist()!r}; I_xy = {float(I[0, 1])!r} (C/2pi {cw!r}); Streda slope {slope!r}; BCD max|D| at mu = gap top "
          f"+ 0.3, beta 40: {float(np.abs(D).max()):.3e}; metric {w_metric:.4f} s, min(det g - (Om/2)^2) = {gap_bound:.3e} "
          f"(>= -1e-12); "
          f"lattice_chern npt 12, {BERRY_NPT}: {lc[0]!r}, {lc[1]!r}", flush=True)
    if not (abs(abs(C[0]) - 1) <= 1e-8 and abs(C[0] + C[1]) <= 1e-8 and abs(float(I[0, 1]) - cw) <= 1e-8
            and abs(slope - cw) <= 1e-9 and gap_bound >= -1e-12
            and all(abs(c - round(c)) <= 1e-12 and round(c) == round(C[0]) for c in lc)):
        fail("topology point checks: Chern, AHC, Streda slope, metric bound or lattice Chern")
    del slv, g, detg, Omxy
    torch.cuda.empty_cache()

    # weyl: the 3-D AHC at npt 192 (7,077,888 points), then the 21-slice Chern scan
    slw, w_weyl, peak_weyl = build(hw, bz3, WEYL_NPT)
    t0 = time.perf_counter()
    Iw = slw.ahc(mu=0.0)
    w_wq = sync_wall(t0)
    kzs = np.linspace(0.0, 0.5, 21)
    t0 = time.perf_counter()
    Cs = [br.lattice_chern(hw.contract(float(kz)), bz2, 24, bands=[0]) for kz in kzs]
    w_scan = time.perf_counter() - t0
    off = [abs(kz - 0.25) > 1e-9 for kz in kzs]  # kz = 1/4 is the nodes' slice: gapless, no Chern number
    want = [-1.0 if kz < 0.25 else 0.0 for kz in kzs]
    print(f"topology main path, weyl: tb_weyl(2) at npt {WEYL_NPT} ({slw.pack.e.shape[0]} points): build {w_weyl:.4f} s "
          f"(peak {peak_weyl:.1f} MiB), ahc {w_wq:.4f} s: I_xy = {float(Iw[0, 1])!r} (-1/4pi = {-1 / (4 * math.pi)!r}), "
          f"I_xz = {float(Iw[0, 2]):.3e}, I_yz = {float(Iw[1, 2]):.3e}; 21-slice scan at npt 24 {w_scan:.4f} s: "
          + " ".join(f"{c:+.0f}" if o else f"[node {c:+.3f}]" for c, o in zip(Cs, off)), flush=True)
    if not (abs(float(Iw[0, 1]) + 1 / (4 * math.pi)) <= 1e-4 and abs(float(Iw[0, 2])) < 1e-12
            and abs(float(Iw[1, 2])) < 1e-12
            and all(abs(c - w) < 1e-12 for c, w, o in zip(Cs, want, off) if o)):
        fail("topology weyl checks: the node-separation AHC or the slice Chern scan")
    del slw
    torch.cuda.empty_cache()

    # spin-hall: Kane-Mele (S_z conserved) at npt 1024, m = 4: eigh in chunks of 4,096
    slk, w_km, peak_km = build(hk, bz2, BERRY_NPT)
    I_c = float(slk.ahc(mu=0.0)[0, 1])
    t0 = time.perf_counter()
    I_s = float(slk.operator_hall(sz, mu=0.0)[0, 1])
    w_op = sync_wall(t0)
    I_s2 = float(slk.operator_hall(sz, mu=0.0)[0, 1])
    print(f"topology main path, spin-hall: Kane-Mele lam_so 0.1 at npt {BERRY_NPT}: build {w_km:.4f} s (peak "
          f"{peak_km:.1f} MiB), operator grid + query {w_op:.4f} s; I_c = {I_c:.3e} (< 1e-12), I^sz_xy = {I_s!r} "
          f"(-1/2pi = {-1 / (2 * math.pi)!r}), repeat bit-equal {I_s2 == I_s}", flush=True)
    if not (abs(I_c) < 1e-12 and abs(I_s + 1 / (2 * math.pi)) <= 1e-8 and I_s2 == I_s):
        fail("topology spin-hall checks")
    del slk
    torch.cuda.empty_cache()

    # phase: the example's 13 x 13 Haldane diagram at npt 24
    t2 = 0.1
    phis, Ms_ = np.linspace(-math.pi, math.pi, 13), np.linspace(-6 * t2, 6 * t2, 13)
    t0 = time.perf_counter()
    Cd = np.array([[round(br.lattice_chern(tb_haldane(t2=t2, phi=float(p), M=float(M_), device=dev), bz2, 24,
                                           bands=[0])) for M_ in Ms_] for p in phis])
    w_phase = time.perf_counter() - t0
    crit = 3 * math.sqrt(3) * t2 * np.abs(np.sin(phis))[:, None]
    far = np.abs(np.abs(Ms_)[None, :] - crit) >= 0.05 * t2
    exact = np.where(np.abs(Ms_)[None, :] < crit, -np.sign(np.sin(phis))[:, None], 0.0)
    print(f"topology main path, phase: 13 x 13 Haldane diagram at npt 24 in {w_phase:.4f} s "
          f"({1e3 * w_phase / 169:.3f} ms a model); {int(far.sum())} points at least 0.05 t2 from |M| = 3 sqrt(3) t2 "
          f"|sin phi|, {int((Cd[far] == exact[far]).sum())} of them exact", flush=True)
    if not np.all(Cd[far] == exact[far]):
        fail("topology phase diagram disagrees with the exact boundary")

    # flux: the occupied-band flux integrand (K21 on every batch) under PTR, IAI and TAI, and an IAI sweep
    # over mu (one mu per point at the leaf), held against the same solves on the CPU
    def flux_solves(dev_):
        fi = br.berry_flux_integrand(tb_haldane(t2=0.1, phi=math.pi / 2, M=0.0, device=dev_))
        sols = [solve(IntegralProblem(fi, bz2, MixedParameters(mu=0.0)), EvalCounter(alg), **kw)
                for alg, kw in ((PTR(npt=48, device=dev_), {}), (IAI(inner_cap=128, device=dev_), {"abstol": 1e-5}),
                                (TAI(device=dev_), {"abstol": 1e-4}))]
        sw = SweepSolver(IntegralProblem(fi, bz2), IAI(inner_cap=64, device=dev_), abstol=1e-3, chunk=2, scan=True)
        u = np.array([float(x.u) for x in sols] + [float(x) for x in sw(np.array([0.0, 0.3]))])
        return u, [int(x.numevals) for x in sols] + [int(x) for x in sw.lane_numevals]

    t0 = time.perf_counter()
    u_f, n_f = flux_solves(dev)
    w_flux = sync_wall(t0)
    u_fc, n_fc = flux_solves("cpu")
    rel_f = float(np.max(np.abs(u_f - u_fc) / np.abs(u_fc)))
    C_f = u_f / ((2 * math.pi) ** 2 * 2 * math.pi)  # u = |det B| 2 pi C_occ
    print(f"topology main path, flux: berry_flux_integrand(Haldane) under PTR(48), IAI (abstol 1e-5), TAI (abstol "
          f"1e-4) and an IAI sweep over mu = 0, 0.3 in {w_flux:.4f} s: C_occ {C_f.tolist()!r}, evaluations {n_f}, "
          f"card vs CPU {rel_f:.3e} (<= 1e-10), counts equal {n_f == n_fc}", flush=True)
    if not (rel_f <= 1e-10 and n_f == n_fc and np.all(np.abs(C_f + 1) < 1e-3)):
        fail("topology flux checks: the flux integrand on the card against the CPU")

    # z2: the example's three Kane-Mele cases
    t0 = time.perf_counter()
    z2 = [br.z2_invariant(tb_kane_mele(lam_so=0.06, lam_r=lr, M=M_, device=dev), 48)
          for lr, M_ in ((0.0, 0.0), (0.05, 0.0), (0.05, 0.8))]
    w_z2 = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels}
    print(f"topology main path, z2: Kane-Mele (lam_r, M) = (0, 0), (0.05, 0), (0.05, 0.8): Z2 = {z2} (1, 1, 0) in "
          f"{w_z2:.4f} s; launches {launches}", flush=True)
    if z2 != [1, 1, 0]:
        fail(f"topology z2 checks: {z2}")
    if min(launches.values()) <= 0:
        fail(f"the topology main path did not go through every kernel: {launches}")

    # the plain route: the Haldane pack at npt 128 and one certified Chern ladder on both routes
    h128 = tb_haldane(t2=0.1, phi=math.pi / 2, M=0.2, device=dev)
    sk_ = br.BerryCurvatureSolver(h128, bz2, 128)
    sp_ = br.BerryCurvatureSolver(h128, bz2, 128, pairs=br.band_pair_terms_plain, average=br.zone_average_plain)
    rel_pack = max(field_err(getattr(sk_.pack, f), getattr(sp_.pack, f)) for f in ("e", "Om", "Mm", "vd"))
    q = [(s.chern(), s.ahc(0.3, 20.0), s.orbital_magnetization(0.0), s.berry_curvature_dipole(0.8, 40.0))
         for s in (sk_, sp_)]
    rel_q = max(float(np.max(np.abs(a - b)) / np.max(np.abs(b))) for a, b in zip(*q))
    t0 = time.perf_counter()
    ck = br.certified_berry(hh, bz2, what="chern", abstol=1e-4, nmin=18, nmax=240)
    w_ck = time.perf_counter() - t0
    cp = br.certified_berry(hh, bz2, what="chern", abstol=1e-4, nmin=18, nmax=240, pairs=br.band_pair_terms_plain,
                            average=br.zone_average_plain)
    rel_c = float(np.max(np.abs(np.asarray(ck.u) - np.asarray(cp.u))))
    wall = time.perf_counter() - t_phases
    print(f"topology plain route: Haldane (M 0.2) pack at npt 128 kernels vs plain {rel_pack:.3e} (<= 1e-12 of each "
          f"field's scale), queries {rel_q:.3e} (<= 1e-12); certified_berry(chern, abstol 1e-4) rungs {ck.npts} vs "
          f"{cp.npts}, retcodes {ck.retcode} vs {cp.retcode}, |dC| {rel_c:.3e} (<= 1e-12), kernel ladder {w_ck:.4f} s; "
          f"phase 27 {t27:.3f} s, phases 27-28 {wall:.3f} s (<= 60)", flush=True)
    if not (rel_pack <= 1e-12 and rel_q <= 1e-12 and ck.npts == cp.npts and ck.retcode == cp.retcode
            and ck.retcode and rel_c <= 1e-12):
        fail("topology plain route: kernels and plain versions disagree")
    if wall > 60.0:
        fail(f"phases 27-28 took {wall:.1f} s (> 60)")
    if "--profile" in sys.argv[1:]:
        profile("topology main path (the Weyl build and its AHC)",
                lambda: br.BerryCurvatureSolver(hw, bz3, WEYL_NPT).ahc(mu=0.0))
    torch.cuda.empty_cache()

    def entry(name, source, replaces, t, b, library_ms):
        return {"name": name, "route": "cuda", "source": src + source, "replaces": replaces,
                "launches": launches[name], "max_abs_err": t["err"], "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": b[0], "bound_by": b[1], "library_ms": library_ms}

    n = BERRY_NPT
    return [entry("band_pair_terms", "berry_pairs.cu", "autobzcore_tpu/models/berry.py:101", t21, b21,
                  t21["library_ms"]),
            entry("plaquette_flux", "berry_links.cu", "autobzcore_tpu/models/berry.py:298", t22[n], t22[n]["bound"], None),
            entry("wilson_loops", "berry_links.cu", "autobzcore_tpu/models/berry.py:368", t23[n], t23[n]["bound"], None),
            entry("zone_average", "zone_average.cu", "autobzcore_tpu/models/berry.py:462", t24k, b24,
                  t24k["library_ms"])]


def fermi_liquid_sigma(np, ws, m=3):
    """The tabulated causal, orbital-resolved Fermi-liquid self-energy of
    phase 30 at frequencies ws: Sigma(w) = R - i Gamma(w), R real symmetric
    (diagonal 0.10, -0.05, 0 eV, off-diagonal 0.05 eV), Gamma real symmetric
    positive definite (diagonal eta_i + a_i w^2 with eta = 0.05, 0.08, 0.11
    eV and a = 0.02, 0.03, 0.04 / eV, off-diagonal 0.02 eV). (W, 3, 3); for
    m = 4 (phase 29's step above three bands) a fourth orbital with R 0.05
    eV, eta 0.14 eV and a 0.05 / eV."""
    R = np.full((m, m), 0.05)
    np.fill_diagonal(R, [0.10, -0.05, 0.0, 0.05][:m])
    Gam = np.full((len(ws), m, m), 0.02)
    idx = np.arange(m)
    Gam[:, idx, idx] = np.array([0.05, 0.08, 0.11, 0.14][:m]) + np.array([0.02, 0.03, 0.04, 0.05][:m]) * ws[:, None] ** 2
    return R - 1j * Gam


def three_ways(fn, reps):
    """A call's time three ways: by events over ``reps`` calls (``ms``), the
    profiler's device time of all the kernels it launches (``device_ms``,
    None where not captured) and its host time (``host_us``, the enqueue)."""
    return {"ms": cuda_ms(fn, reps), "device_ms": device_ms(fn, reps), "host_us": host_us(fn, max(reps, 20))}


def three_text(t):
    return (f"{t['ms']:.4f} ms a call by events, device {ms_text(t['device_ms'])}, host {t['host_us']:.1f} us")


def k27_pole_lanes(np, torch, rng, H, W, eta, scalar=False):
    """W lanes at a constant Sigma = -eta i: z = om + i eta with half the om
    at random in the window and half on an eigenvalue of some H_k, as (W,
    m, m) matrices z I, or (W,) z with ``scalar``."""
    Hn = H[torch.as_tensor(rng.integers(0, H.shape[0], W // 2), device=H.device)].cpu().numpy()
    ev = np.linalg.eigvalsh(Hn)[np.arange(W // 2), rng.integers(0, H.shape[-1], W // 2)]
    z = torch.as_tensor(np.concatenate([rng.uniform(*WINDOW, W - W // 2), ev]) + 1j * eta, device=H.device)
    if scalar:
        return z
    return (z[:, None, None] * torch.eye(H.shape[-1], dtype=torch.complex128, device=H.device)).contiguous()


def k27_leaf_trip(np, torch, dev, se, ws):
    """(H, Z) of the largest IAI leaf trip of phase 30's self-energy DOS
    integrand on the card (tb_integer(3), CubicSymIBZ, a scalar Fermi-liquid
    Sigma, omega 0.7, abstol 1e-3): the points K27's pointwise entry takes
    there, recorded from one solve."""
    from autobzcore_torch import IAI, CubicSymIBZ, IntegralProblem, load_bz, solve
    from autobzcore_torch.models.tight_binding import tb_integer

    trip = {}
    entry = se.sigma_trace_points

    def recording(H, Z):
        if H.shape[0] > trip.get("n", 0):
            trip.update(n=H.shape[0], H=H.clone(), Z=Z.clone())
        return entry(H, Z)

    recording.launches = 0  # the entry counts its launches on the module's name, here this function
    se.sigma_trace_points = recording
    try:
        sig = se.SigmaInterpolant(ws, 0.1 - 1j * (0.1 + 0.02 * ws**2), device=dev)
        solve(IntegralProblem(se.dos_integrand_sigma(tb_integer(3, device=dev), sig), load_bz(CubicSymIBZ(), np.eye(3)),
                              0.7), IAI(inner_cap=64, device=dev), abstol=1e-3)
    finally:
        se.sigma_trace_points = entry
    return trip["H"], trip["Z"]


def kinetic_step(np, torch, se, h, bz, sigma, mu):
    """Phase 30's kinetic step: SigmaKineticCoefficientSolver at npt
    SE_KIN_NPT, beta LH_BETA, SE_KIN_OMEGAS Omegas in [0, 2] eV, alpha 0
    then 1, at abstol TR_ABSTOL, with its split: the wall (the solvers'
    builds and solves, ending in a synchronize), the builds (``_grid``), the
    device time of the integrand summed over the step's GK trips (CUDA
    events around each trip's integrand call: its one K28 launch with the
    column sum, and the few small kernels around it that build the Z
    matrices, the group average and the Fermi window), the pairs each K28
    launch takes (the trip's nodes) and the GK trips of each alpha. Returns
    the solvers, their values and the split."""
    spans, pairs = [], []

    class Timed(se.SigmaKineticCoefficientSolver):
        def _integrand(self, w, Omega):
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = super()._integrand(w, Omega)
            stop.record()
            spans.append((start, stop))
            pairs.append(torch.as_tensor(w).numel())
            return out

    Om_k = np.linspace(0.0, 2.0, SE_KIN_OMEGAS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    kin = [Timed(h, bz, SE_KIN_NPT, sigma, LH_BETA, alpha=a, mu=mu) for a in (0, 1)]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    A = [k(Om_k, abstol=TR_ABSTOL) for k in kin]
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    k28 = sum(a.elapsed_time(b) for a, b in spans)
    split = {"wall_s": t2 - t0, "build_s": t1 - t0, "solve_s": t2 - t1, "integrand_ms": k28,
             "integrand_share": k28 / (1e3 * (t2 - t0)), "launches": len(pairs),
             "pairs": [min(pairs), float(np.mean(pairs)), max(pairs)] if pairs else [0, 0.0, 0],
             "trips": [k.stats.trips.get(1, 0) for k in kin], "numevals": [int(k.numevals) for k in kin],
             "retcodes": [bool(k.retcode) for k in kin]}
    return kin, A, split


def lindhard_sigma_phases(np, torch, dev, h, mu):
    """Phases 29-30: K25-K28 against their plain versions at the main path's
    shapes, then the Lindhard map and the matrix self-energy legs at the
    reference record's sizes, with phase 26's chemical potential ``mu``.
    Returns the kernels' JSON entries and the legs' numbers: K28's times and
    bounds (``k28``, with its m = 4 times in ``k28_m4``), the self-energy
    sweeps' walls and the kinetic step's split (``kinetic``)."""
    from autobzcore_torch import (FBZ, IAI, PTR, CubicSymIBZ, FourierIntegrand, IntegralProblem, JacobianSeries,
                                  load_bz, solve)
    from autobzcore_torch.models import lindhard as li
    from autobzcore_torch.models import observables as obs
    from autobzcore_torch.models import selfenergy as se
    from autobzcore_torch.models import transport as tr
    from autobzcore_torch.models.tight_binding import flagship_series, synthetic_wannier, tb_integer

    src = "autobzcore_torch/csrc/"
    t_phases = time.perf_counter()
    bz = load_bz(FBZ(), np.eye(3))
    m, d = 3, 3
    rng = np.random.default_rng(29)
    ws = np.linspace(-8.0, 8.0, SE_SIGMA_POINTS)
    vals = fermi_liquid_sigma(np, ws)
    sigma = se.SigmaInterpolant(ws, vals, device=dev)

    def check(tag, got, want, tol, scale=None):
        """max|got - want| (fails above tol times the scale, max|want| by
        default) and a repeat bit-identical to got."""
        err = float((got - want).abs().max())
        sc = float(want.abs().max()) if scale is None else scale
        if not err <= tol * sc:
            fail(f"{tag}: max|d| vs plain {err:.3e} > {tol:g} x {sc:.3e}")
        return err, err / sc

    # 29. K25-K28 against their plain versions -------------------------------------------
    # K25 and K26 on the map's grid: the flagship at npt 64, beta 40, phase 26's mu
    slv = li.LindhardSolver(h, bz, LH_NPT, LH_BETA, mu=mu, eta=LH_ETA)
    e, f, U = slv._e, slv._f, slv._U
    K = e.numel() // m
    om_map = torch.linspace(0.0, LH_OMEGA_MAX, LH_OMEGAS, dtype=torch.float64, device=dev)
    sc = slv._vol / LH_NPT**3
    shift = (8, 0, 0)  # q = (1/8, 0, 0), one q of the map
    k25 = li.chi0(e, f, U, shift, om_map, LH_ETA, sc)
    p25 = li.chi0_plain(e, f, U, shift, om_map, LH_ETA, sc)
    err25, rel25 = check("K25 chi0", k25, p25, 1e-12)
    if not torch.equal(k25, li.chi0(e, f, U, shift, om_map, LH_ETA, sc)):
        fail("K25 chi0: two runs on the same inputs differ")
    t25 = {"err": err25, "ms": cuda_ms(lambda: li.chi0(e, f, U, shift, om_map, LH_ETA, sc), 20),
           "plain_ms": cuda_ms(lambda: li.chi0_plain(e, f, U, shift, om_map, LH_ETA, sc), 2)}
    b25 = bound(K * m * m * LH_OMEGAS * CHI0_TERM_FLOPS + K * (8 * m**3 + 6 * m * m),
                nbytes(e, f, U, om_map) + 16 * LH_OMEGAS)
    # certified_chi0's width (9 omegas): every 12th of the map's, which alone
    # must give the 100-omega launch's bits for them
    om9 = om_map[::12].contiguous()
    k25_9 = li.chi0(e, f, U, shift, om9, LH_ETA, sc)
    err25_9 = check("K25 chi0 at 9 omegas", k25_9, li.chi0_plain(e, f, U, shift, om9, LH_ETA, sc), 1e-12)[0]
    if not torch.equal(k25_9, k25[::12]):
        fail("K25 chi0: 9 omegas alone differ from the same omegas in the launch of 100")
    t25_9 = {"ms": cuda_ms(lambda: li.chi0(e, f, U, shift, om9, LH_ETA, sc), 20),
             "bound": bound(K * m * m * om9.shape[0] * CHI0_TERM_FLOPS + K * (8 * m**3 + 6 * m * m),
                            nbytes(e, f, U, om9) + 16 * om9.shape[0])}
    errs26 = []
    for sh in ((0, 0, 0), (LH_NPT // 4, 0, 0)):
        k26 = li.cooper_mean(e, f, sh, mu, LH_BETA)
        errs26.append(check(f"K26 cooper_mean at shift {sh}", k26, li.cooper_mean_plain(e, f, sh, mu, LH_BETA), 1e-12)[0])
        if not torch.equal(k26, li.cooper_mean(e, f, sh, mu, LH_BETA)):
            fail("K26 cooper_mean: two runs on the same inputs differ")
    t26 = {"err": max(errs26), "ms": cuda_ms(lambda: li.cooper_mean(e, f, (0, 0, 0), mu, LH_BETA), 20),
           "plain_ms": cuda_ms(lambda: li.cooper_mean_plain(e, f, (0, 0, 0), mu, LH_BETA), 5)}
    b26 = bound(K * m * COOPER_FLOPS, nbytes(e, f) + 8)
    print(f"K25 chi0 on the flagship's npt={LH_NPT} grid ({K} points, m = {m}, {LH_OMEGAS} omegas, q = (1/8, 0, 0)): "
          f"max|d| vs plain {err25:.3e} ({rel25:.3e} of max|chi0|, <= 1e-12), repeat bit-identical; {t25['ms']:.4f} ms "
          f"(plain {t25['plain_ms']:.4f} ms, bound {b25[0]:.4f} ms by {b25[1]}, {100 * b25[0] / t25['ms']:.1f} %); at 9 omegas "
          f"(every 12th: the launch of 100's bits) max|d| {err25_9:.3e}, {t25_9['ms']:.4f} ms (bound "
          f"{t25_9['bound'][0]:.4f} ms by {t25_9['bound'][1]}); K26 cooper_mean at q = 0 and (1/4, 0, 0): "
          f"max|d| {t26['err']:.3e} (<= 1e-12 relative), repeats bit-identical; {t26['ms']:.4f} ms (plain "
          f"{t26['plain_ms']:.4f} ms, bound {b26[0]:.5f} ms by {b26[1]})", flush=True)
    del slv, e, f, U, k25, p25

    # K27 on the DOS leg's grid (npt 100, 1e6 points) at its 1000 frequencies, both modes; each
    # time by events, by the profiler's device time (K27 and its column sum) and on the host
    dslv = se.SigmaDOSSolver(h, bz, SE_NPT, sigma)
    H, w, scd = dslv._H, dslv._w, dslv._scale
    K = H.shape[0]
    om_dos = torch.linspace(*WINDOW, SE_OMEGAS, dtype=torch.float64, device=dev)
    Z = se._zmat(om_dos, sigma, m).contiguous()
    # eta = 1e-3: constant Sigma = -1e-3 i, half the lanes on an eigenvalue of some H_k
    Zpole = k27_pole_lanes(np, torch, rng, H, K27_POLE_LANES, K27_POLE_ETA)
    t27 = {}
    for diag in (False, True):
        k27 = se.sigma_trace_sum(H, w, Z, scd, diag)
        p27, pms = timed_once(lambda: se.sigma_trace_sum_plain(H, w, Z, scd, diag))
        err, r = check(f"K27 sigma_trace_sum (diagonal {diag})", k27, p27, 1e-12)
        if not torch.equal(k27, se.sigma_trace_sum(H, w, Z, scd, diag)):
            fail(f"K27 sigma_trace_sum (diagonal {diag}): two runs on the same inputs differ")
        kp = se.sigma_trace_sum(H, w, Zpole, scd, diag)
        errp, rp = check(f"K27 sigma_trace_sum at eta {K27_POLE_ETA:g}, lanes on poles (diagonal {diag})", kp,
                         se.sigma_trace_sum_plain(H, w, Zpole, scd, diag), 1e-12)
        if not (torch.equal(kp, se.sigma_trace_sum(H, w, Zpole, scd, diag))
                and torch.equal(kp[-1:], se.sigma_trace_sum(H, w, Zpole[-1:].contiguous(), scd, diag))):
            fail(f"K27 sigma_trace_sum at eta {K27_POLE_ETA:g} (diagonal {diag}): a repeat, or a lane alone, differs")
        flops = K * (SE_OMEGAS * (K27_DIAG_FLOPS if diag else K27_TRACE_FLOPS) + K27_SUM_K_FLOPS)
        mma = K * SE_OMEGAS * (K27_DIAG_MMA_FLOPS if diag else K27_TRACE_MMA_FLOPS)
        t27[diag] = dict(three_ways(lambda: se.sigma_trace_sum(H, w, Z, scd, diag), 5), err=err, rel=r, pole_rel=rp,
                         plain_ms=pms, bound=bound(flops, nbytes(H, w, Z, k27), mma_flops=mma),
                         first_bound=bound(K * SE_OMEGAS * (GEN_DIAG_FLOPS if diag else GEN_TRACE_FLOPS),
                                           nbytes(H, w, Z, k27))[0])
    del k27, p27, kp
    # the pointwise entry at the PTR(48) rule's points, one Z (the rule's) and one per point, and
    # on poles at eta 1e-3
    Hp = obs.gathered_grid(h, 3, [np.arange(48) / 48] * 3, None).reshape(-1, m, m).contiguous()
    Z1 = se._zmat(0.7, sigma, m, device=dev).contiguous()
    Zn = se._zmat(torch.as_tensor(rng.uniform(*WINDOW, Hp.shape[0]), device=dev), sigma, m).contiguous()
    Zq = k27_pole_lanes(np, torch, rng, Hp, Hp.shape[0], K27_POLE_ETA)
    errs = [check(f"K27 sigma_trace_points ({tag})", se.sigma_trace_points(Hp, Zs),
                  se.sigma_trace_points_plain(Hp, Zs), 1e-12)[0]
            for tag, Zs in (("one Z", Z1), ("Z per point", Zn), (f"eta {K27_POLE_ETA:g} on poles", Zq))]
    if not torch.equal(se.sigma_trace_points(Hp, Zn), se.sigma_trace_points(Hp, Zn)):
        fail("K27 sigma_trace_points: two runs on the same inputs differ")
    t27p = dict(three_ways(lambda: se.sigma_trace_points(Hp, Z1), 20), err=max(errs),
                plain_ms=cuda_ms(lambda: se.sigma_trace_points_plain(Hp, Z1), 5))
    b27p = bound(Hp.shape[0] * K27_POINT_FLOPS, nbytes(Hp, Z1) + 16 * Hp.shape[0])
    # and at the largest leaf trip of phase 30's IAI solve of the integrand (tb_integer(3), m = 1)
    leaf = k27_leaf_trip(np, torch, dev, se, ws)
    Hl, Zl = leaf
    el = check("K27 sigma_trace_points (the IAI leaf trip)", se.sigma_trace_points(Hl, Zl),
               se.sigma_trace_points_plain(Hl, Zl), 1e-12)[0]
    t27l = dict(three_ways(lambda: se.sigma_trace_points(Hl, Zl), 50), err=el, n=Hl.shape[0],
                bound=bound(Hl.shape[0] * K27_POINT_FLOPS, nbytes(Hl, Zl) + 16 * Hl.shape[0]))
    print(f"K27 sigma_trace_sum on the flagship's npt={SE_NPT} grid ({K} points, {SE_OMEGAS} omegas, the tabulated "
          f"Fermi-liquid Sigma): " + "; ".join(
              f"{'diagonal' if dg else 'trace'} mode max|d| vs plain {t['err']:.3e} ({t['rel']:.3e} of the value scale, "
              f"<= 1e-12; at eta {K27_POLE_ETA:g} with {K27_POLE_LANES // 2} of {K27_POLE_LANES} lanes on poles "
              f"{t['pole_rel']:.3e}), repeats and a lane alone bit-identical, {three_text(t)} (plain "
              f"{t['plain_ms']:.1f} ms, bound {t['bound'][0]:.4f} ms by {t['bound'][1]} [first count "
              f"{t['first_bound']:.4f}], {100 * t['bound'][0] / t['ms']:.1f} % of it by events)"
              for dg, t in t27.items())
          + f"; pointwise at the PTR(48) points ({Hp.shape[0]}), one Z, one per point and at eta {K27_POLE_ETA:g} "
          f"on poles: max|d| {t27p['err']:.3e} (<= 1e-12 of the scale), {three_text(t27p)} (plain "
          f"{t27p['plain_ms']:.4f} ms, bound {b27p[0]:.5f} ms by {b27p[1]}); at the largest IAI leaf trip of phase "
          f"30 ({t27l['n']} points, m = 1) max|d| {el:.3e}, {three_text(t27l)} (bound {t27l['bound'][0]:.5f} ms by "
          f"{t27l['bound'][1]})", flush=True)
    del dslv, H, w, Z, Zn, Zq, Zpole, Hl, Zl
    torch.cuda.empty_cache()

    # K28 on the transport leg's grid (npt 100: H and V, 576 MB) at its 256 frequencies
    tslv = se.SigmaTransportSolver(h, bz, SE_NPT, sigma)
    H, V, w, sct = tslv._H, tslv._V, tslv._w, tslv._scale
    om_tr = torch.linspace(*WINDOW, SE_TR_OMEGAS, dtype=torch.float64, device=dev)
    Zt = se._zmat(om_tr, sigma, m).contiguous()
    k28 = se.sigma_pairs_sum(H, V, w, Zt, Zt, sct)
    p28, pms28 = timed_once(lambda: se.sigma_pairs_sum_plain(H, V, w, Zt, Zt, sct))
    err28, rel28 = check("K28 sigma_pairs_sum (equal frequencies)", k28, p28, 1e-12)
    if not torch.equal(k28, se.sigma_pairs_sum(H, V, w, Zt, Zt, sct)):
        fail("K28 sigma_pairs_sum: two runs on the same inputs differ")
    t28 = {"err": err28, "ms": cuda_ms(lambda: se.sigma_pairs_sum(H, V, w, Zt, Zt, sct), 3), "plain_ms": pms28}
    b28 = bound(SE_TR_OMEGAS * K * pair_flops(m, d, True), nbytes(H, V, w, Zt, k28))
    # unequal frequencies: 32 pairs (w, w + 0.5 eV), as a kinetic trip hands them over
    Za, Zb = Zt[:32].contiguous(), se._zmat(om_tr[:32] + 0.5, sigma, m).contiguous()
    ku = se.sigma_pairs_sum(H, V, w, Za, Zb, sct)
    pu, pmsu = timed_once(lambda: se.sigma_pairs_sum_plain(H, V, w, Za, Zb, sct))
    erru, relu = check("K28 sigma_pairs_sum (unequal frequencies)", ku, pu, 1e-12)
    if not torch.equal(ku, se.sigma_pairs_sum(H, V, w, Za, Zb, sct)):
        fail("K28 sigma_pairs_sum (unequal): two runs on the same inputs differ")
    msu = cuda_ms(lambda: se.sigma_pairs_sum(H, V, w, Za, Zb, sct), 3)
    bu = bound(32 * K * pair_flops(m, d, False), nbytes(H, V, w, Za, Zb, ku))
    # a kinetic trip's shape: 960 unequal pairs (w, w + 0.5 eV) over the window;
    # the first 32 are the 32-pair launch's, whose rows must come back bit for bit
    om_t = torch.cat([om_tr[:32], torch.linspace(*WINDOW, SE_TRIP_PAIRS - 32, dtype=torch.float64, device=dev)])
    Zta, Ztb = se._zmat(om_t, sigma, m).contiguous(), se._zmat(om_t + 0.5, sigma, m).contiguous()
    kt = se.sigma_pairs_sum(H, V, w, Zta, Ztb, sct)
    if not (torch.equal(kt[:32], ku) and torch.equal(kt, se.sigma_pairs_sum(H, V, w, Zta, Ztb, sct))):
        fail(f"K28 sigma_pairs_sum at {SE_TRIP_PAIRS} unequal pairs: the first 32 rows differ from the 32-pair "
             "launch's, or a repeat differs")
    mst = cuda_ms(lambda: se.sigma_pairs_sum(H, V, w, Zta, Ztb, sct), 2)
    bt = bound(SE_TRIP_PAIRS * K * pair_flops(m, d, False), nbytes(H, V, w, Zta, Ztb, kt))
    numbers = {"k28": {"equal_256_ms": t28["ms"], "unequal_32_ms": msu, f"unequal_{SE_TRIP_PAIRS}_ms": mst,
                       "bound_ms": [b28[0], bu[0], bt[0]], "rel": [rel28, relu]},
               "k27": {"trace": dict(t27[False], bound=t27[False]["bound"][0]),
                       "diagonal": dict(t27[True], bound=t27[True]["bound"][0]),
                       "points_ptr48": dict(t27p, bound=b27p[0]), "points_leaf": dict(t27l, bound=t27l["bound"][0])}}
    del tslv, H, V, w, Zt, k28, p28, ku, pu, kt, Zta, Ztb
    torch.cuda.empty_cache()
    # the pointwise entry at the PTR(24) rule's points of the Jacobian series
    Hj, Vj = obs.gathered_grid(h, 3, [np.arange(24) / 24] * 3, None, jacobian=True)
    Hj, Vj = Hj.contiguous(), Vj.contiguous()
    k28p = se.sigma_pairs_points(Hj, Vj, Z1)
    err28p = check("K28 sigma_pairs_points", k28p, se.sigma_pairs_points_plain(Hj, Vj, Z1), 1e-12)[0]
    if not torch.equal(k28p, se.sigma_pairs_points(Hj, Vj, Z1)):
        fail("K28 sigma_pairs_points: two runs on the same inputs differ")
    t28p = {"err": err28p, "ms": cuda_ms(lambda: se.sigma_pairs_points(Hj, Vj, Z1), 20),
            "plain_ms": cuda_ms(lambda: se.sigma_pairs_points_plain(Hj, Vj, Z1), 5)}
    b28p = bound(Hj.shape[0] * pair_flops(m, d, True), nbytes(Hj, Vj, Z1, k28p))
    print(f"K28 sigma_pairs_sum on the flagship's npt={SE_NPT} grid ({K} points, d = m = 3): {SE_TR_OMEGAS} equal "
          f"frequencies max|d| vs plain {err28:.3e} ({rel28:.3e} relative, <= 1e-12), repeat bit-identical, "
          f"{t28['ms']:.4f} ms (plain {t28['plain_ms']:.1f} ms, bound {b28[0]:.4f} ms by {b28[1]}); 32 unequal pairs "
          f"{relu:.3e}, {msu:.4f} ms (plain {pmsu:.1f} ms, bound {bu[0]:.4f} ms by {bu[1]}); {SE_TRIP_PAIRS} unequal "
          f"pairs (a kinetic trip; the first 32 rows the 32-pair launch's bits) {mst:.4f} ms (bound {bt[0]:.4f} ms by "
          f"{bt[1]}, {100 * bt[0] / mst:.1f} %); pointwise at the PTR(24) "
          f"points ({Hj.shape[0]}) {err28p:.3e}, {t28p['ms']:.4f} ms (plain {t28p['plain_ms']:.4f} ms, bound "
          f"{b28p[0]:.5f} ms by {b28p[1]})", flush=True)
    del Hj, Vj, k28p, Hp
    torch.cuda.empty_cache()

    # K27 and K28 above three bands (the Gauss-Jordan inverse): a 4-band model on the 64^3 grid
    m4 = M4_BANDS
    h4 = synthetic_wannier(m4, nr=3, ndim=3, seed=1, device=dev)
    s4 = se.SigmaInterpolant(ws, fermi_liquid_sigma(np, ws, m4), device=dev)
    (H4, V4), w4, sc4, _ = se._grid(h4, bz, M4_NPT, jacobian=True)
    K4 = H4.shape[0]
    Z4 = se._zmat(torch.linspace(*WINDOW, M4_OMEGAS, dtype=torch.float64, device=dev), s4, m4).contiguous()
    t4 = {}
    for diag in (False, True):
        k4 = se.sigma_trace_sum(H4, w4, Z4, sc4, diag)
        p4, pms = timed_once(lambda: se.sigma_trace_sum_plain(H4, w4, Z4, sc4, diag))
        err, r = check(f"K27 sigma_trace_sum at m = {m4} (diagonal {diag})", k4, p4, 1e-12)
        if not torch.equal(k4, se.sigma_trace_sum(H4, w4, Z4, sc4, diag)):
            fail(f"K27 at m = {m4} (diagonal {diag}): two runs on the same inputs differ")
        t4[diag] = (r, cuda_ms(lambda: se.sigma_trace_sum(H4, w4, Z4, sc4, diag), 3), pms,
                    bound(K4 * M4_OMEGAS * general_flops(m4, "diag" if diag else "trace"), nbytes(H4, w4, Z4, k4)))
    Za4 = Z4[:M4_PAIRS].contiguous()
    Zb4 = se._zmat(torch.linspace(*WINDOW, M4_PAIRS, dtype=torch.float64, device=dev) + 0.5, s4, m4).contiguous()
    t4p = {}
    for same, Zb in ((True, Za4), (False, Zb4)):
        k4 = se.sigma_pairs_sum(H4, V4, w4, Za4, Zb, sc4)
        p4, pms = timed_once(lambda: se.sigma_pairs_sum_plain(H4, V4, w4, Za4, Zb, sc4))
        err, r = check(f"K28 sigma_pairs_sum at m = {m4} ({'equal' if same else 'unequal'} frequencies)", k4, p4,
                       1e-12)
        if not torch.equal(k4, se.sigma_pairs_sum(H4, V4, w4, Za4, Zb, sc4)):
            fail(f"K28 at m = {m4}: two runs on the same inputs differ")
        t4p[same] = (r, cuda_ms(lambda: se.sigma_pairs_sum(H4, V4, w4, Za4, Zb, sc4), 3), pms,
                     bound(M4_PAIRS * K4 * pair_flops(m4, d, same, general_flops(m4, "spectral")),
                           nbytes(H4, V4, w4, Za4, Zb, k4)))
    print(f"K27 and K28 above three bands: synthetic_wannier({m4}), FBZ, npt={M4_NPT} ({K4} points), the Fermi-liquid "
          f"Sigma on {m4} orbitals: " + "; ".join(
              f"K27 {'diagonal' if dg else 'trace'} mode at {M4_OMEGAS} omegas {r:.3e} of the value scale (<= 1e-12), "
              f"{ms:.4f} ms (plain {pms:.1f} ms, bound {b[0]:.4f} ms by {b[1]})" for dg, (r, ms, pms, b) in t4.items())
          + "; " + "; ".join(
              f"K28 {M4_PAIRS} {'equal' if sm else 'unequal'} pairs {r:.3e} relative (<= 1e-12), {ms:.4f} ms (plain "
              f"{pms:.1f} ms, bound {b[0]:.4f} ms by {b[1]})" for sm, (r, ms, pms, b) in t4p.items())
          + f"; repeats bit-identical; phase 29 {time.perf_counter() - t_phases:.3f} s", flush=True)
    numbers["k28_m4"] = {"equal_ms": t4p[True][1], "unequal_ms": t4p[False][1],
                         "bound_ms": [t4p[True][3][0], t4p[False][3][0]]}
    del h4, s4, H4, V4, w4, Z4, Za4, Zb4, k4, p4
    torch.cuda.empty_cache()

    # 30. the Lindhard map and the self-energy legs at full width -------------------------------
    kernels = (li.chi0, li.cooper_mean, se.sigma_trace_sum, se.sigma_trace_points, se.sigma_pairs_sum,
               se.sigma_pairs_points)
    for k in kernels:
        k.launches = 0
    # the Lindhard map: 33 q = (j/64, 0, 0) by 100 omegas in [0, 4] eV
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    slv = li.LindhardSolver(h, bz, LH_NPT, LH_BETA, mu=mu, eta=LH_ETA)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    peak_build = (torch.cuda.max_memory_allocated() - base) / 2**20
    qs = [(j / LH_NPT, 0.0, 0.0) for j in range(LH_NQ)]
    oms = np.linspace(0.0, LH_OMEGA_MAX, LH_OMEGAS)
    chi_map = np.stack([slv(q, oms) for q in qs])  # each query ends in a host read
    t2 = time.perf_counter()
    cb40 = li.cooper_bubble(slv)
    cb80 = li.cooper_bubble(li.LindhardSolver(h, bz, LH_NPT, 2 * LH_BETA, mu=mu, eta=LH_ETA))
    t3 = time.perf_counter()
    cert = li.certified_chi0(h, bz, [0.25, 0.0, 0.0], np.linspace(0.0, LH_OMEGA_MAX, 9), LH_BETA, mu=mu, eta=LH_ETA,
                             abstol=1e-2, nmin=16, nmax=64)
    t4 = time.perf_counter()
    # K25 alone at each certified rung's grid and 9 omegas (by events)
    om_c = torch.linspace(0.0, LH_OMEGA_MAX, 9, dtype=torch.float64, device=dev)
    rung_ms, lh_walls, n25 = [], (t1 - t0, t2 - t1), li.chi0.launches
    for n in cert.npts:
        rs = li.LindhardSolver(h, bz, n, LH_BETA, mu=mu, eta=LH_ETA)
        sh = li._grid_shift_of([0.25, 0.0, 0.0], 3, n)
        rung_ms.append(cuda_ms(lambda: li.chi0(rs._e, rs._f, rs._U, sh, om_c, LH_ETA, 1.0), 20))
        del rs
    li.chi0.launches = n25  # the timing's launches are not the main path's
    im_max = float(chi_map[:, oms > 0].imag.max())
    print(f"Lindhard main path: flagship, FBZ, npt={LH_NPT} ({LH_NPT**3} points), beta {LH_BETA}, mu = {mu!r} eV, eta "
          f"{LH_ETA}: build {t1 - t0:.4f} s (peak {peak_build:.1f} MiB); the {LH_NQ}-q x {LH_OMEGAS}-omega map "
          f"{t2 - t1:.4f} s ({1e3 * (t2 - t1) / LH_NQ:.3f} ms per q); chi0(0.5 q_max, 1 eV) = "
          f"{complex(chi_map[LH_NQ // 2, 25])!r}; max Im chi0 over omega > 0 {im_max:.3e} (<= 1e-12); cooper_bubble(q = "
          f"0) beta 40 {cb40!r}, beta 80 {cb80!r} (both with the beta-80 build {t3 - t2:.4f} s); certified_chi0(q = "
          f"(1/4, 0, 0), 9 omegas, abstol 1e-2, nmin 16, nmax 64): rungs {cert.npts}, resid {cert.resid:.3e}, retcode "
          f"{cert.retcode}, {t4 - t3:.4f} s; K25 at each rung (by events): "
          + ", ".join(f"npt {n} {ms:.4f} ms" for n, ms in zip(cert.npts, rung_ms)), flush=True)
    if not (chi_map.shape == (LH_NQ, LH_OMEGAS) and np.all(np.isfinite(chi_map)) and im_max <= 1e-12):
        fail(f"Lindhard map: shape {chi_map.shape}, finite {np.all(np.isfinite(chi_map))}, max Im {im_max:.3e}")
    if not (math.isfinite(cb40) and math.isfinite(cb80) and all(n % 4 == 0 for n in cert.npts)
            and np.all(np.isfinite(cert.u)) and cert.npts[-1] <= 64 + 4):
        fail(f"Lindhard checks: cooper {cb40}, {cb80}, rungs {cert.npts}")

    # the self-energy DOS: 1000 omegas in [-6, 7] eV, then the orbital projection
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    dos = se.SigmaDOSSolver(h, bz, SE_NPT, sigma)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    om_d = np.linspace(*WINDOW, SE_OMEGAS)
    D = dos(om_d)
    t2 = time.perf_counter()
    t_dos_sweep = t2 - t1
    pslv = se.SigmaDOSSolver(h, bz, SE_NPT, sigma, project=True)
    torch.cuda.synchronize()
    t2p = time.perf_counter()
    P = pslv(om_d)
    t3 = time.perf_counter()
    t_proj_sweep = t3 - t2p
    del pslv
    peak_dos = (torch.cuda.max_memory_allocated() - base) / 2**20
    row_err = float(np.max(np.abs(P.sum(axis=1) - D)) / np.max(np.abs(D)))
    # Sigma = -0.05i I against the PTR DOS (K2) at the same grid and frequencies
    Dc = se.SigmaDOSSolver(h, bz, SE_NPT, lambda om: -1j * ETA)(om_d)
    Dk2 = solve(IntegralProblem(obs.dos_integrand(h, ETA), bz, torch.as_tensor(om_d, device=dev)),
                PTR(npt=SE_NPT)).u.cpu().numpy()
    const_err = float(np.max(np.abs(Dc - Dk2)) / np.max(np.abs(Dk2)))
    # the pointwise entry under PTR(48) (the flagship) and IAI (tb_integer(3), cubic wedge) against the CPU
    h_cpu = flagship_series(device="cpu")
    sigma_cpu = se.SigmaInterpolant(ws, vals, device="cpu")
    sp = [solve(IntegralProblem(se.dos_integrand_sigma(hh, s), bz, 0.7), PTR(npt=48, device=dv))
          for hh, s, dv in ((h, sigma, dev), (h_cpu, sigma_cpu, "cpu"))]
    vals1 = 0.1 - 1j * (0.1 + 0.02 * ws**2)  # a scalar Fermi-liquid Sigma for the one-band model
    bzc = load_bz(CubicSymIBZ(), np.eye(3))
    si = [solve(IntegralProblem(se.dos_integrand_sigma(tb_integer(3, device=dv), se.SigmaInterpolant(ws, vals1,
                                                                                                       device=dv)),
                                bzc, 0.7), IAI(inner_cap=64, device=dv), abstol=1e-3) for dv in (dev, "cpu")]
    rel_pw = [abs(float(a.u) - float(b.u)) / abs(float(b.u)) for a, b in (sp, si)]
    t4 = time.perf_counter()
    print(f"self-energy DOS main path: flagship, FBZ, npt={SE_NPT} ({SE_NPT**3} points), the tabulated Fermi-liquid "
          f"Sigma on {SE_SIGMA_POINTS} frequencies, {SE_OMEGAS} omegas in {list(WINDOW)} eV: build {t1 - t0:.4f} s, "
          f"sweep {t2 - t1:.4f} s, projected build {t2p - t2:.4f} s and sweep {t_proj_sweep:.4f} s, peak "
          f"{peak_dos:.1f} MiB; D(0) = "
          f"{float(np.interp(0.0, om_d, D))!r}; projected rows vs the total {row_err:.3e} (<= 1e-12); Sigma = -{ETA}i "
          f"vs the PTR DOS (K2) {const_err:.3e} (<= 1e-10 of max|D|); the integrand under PTR(48) card vs CPU "
          f"{rel_pw[0]:.3e}, numevals {sp[0].numevals} vs {sp[1].numevals}; IAI on tb_integer(3), CubicSymIBZ, abstol "
          f"1e-3: {rel_pw[1]:.3e} (<= 1e-10), numevals {si[0].numevals} vs {si[1].numevals}, retcodes "
          f"{si[0].retcode}, {si[1].retcode}; checks {t4 - t3:.4f} s", flush=True)
    if not (D.shape == (SE_OMEGAS,) and P.shape == (SE_OMEGAS, 3) and np.all(np.isfinite(D)) and D.min() > 0
            and row_err <= 1e-12 and const_err <= 1e-10):
        fail("self-energy DOS checks: shape, finiteness, positivity, the projection or the constant Sigma")
    if not (max(rel_pw) <= 1e-10 and sp[0].numevals == sp[1].numevals and si[0].numevals == si[1].numevals
            and si[0].retcode and si[1].retcode):
        fail("self-energy DOS checks: the pointwise integrand on the card disagrees with the CPU")

    # the self-energy transport: 256 omegas in [-6, 7] eV
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    tslv = se.SigmaTransportSolver(h, bz, SE_NPT, sigma)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    G = tslv(np.linspace(*WINDOW, SE_TR_OMEGAS))
    t2 = time.perf_counter()
    t_tr_sweep = t2 - t1
    peak_tr = (torch.cuda.max_memory_allocated() - base) / 2**20
    del tslv
    torch.cuda.empty_cache()
    gmax = float(np.max(np.abs(G)))
    asym = float(np.max(np.abs(G - G.transpose(0, 2, 1)))) / gmax
    dmin = float(np.min(G[:, range(3), range(3)])) / gmax
    # constant Sigma = -i 5e-3 on phase 26's npt-60 grid against its TransportSolver (K19)
    om_c = np.linspace(mu - 0.5, mu + 0.5, 64)
    Gs = se.SigmaTransportSolver(h, bz, TR_NPT, lambda om: -1j * TR_ETA)(om_c)
    Gt = obs.TransportSolver(h, bz, TR_NPT, TR_ETA)(om_c)
    tr_err = float(np.max(np.abs(Gs - Gt)) / np.max(np.abs(Gt)))
    # the pointwise entry under PTR(24) against the CPU
    up = [solve(IntegralProblem(FourierIntegrand(se.transport_distribution_sigma, JacobianSeries(hh), Sigma=s,
                                                 batched=True), bz, 0.7), PTR(npt=24, device=dv)).u.cpu().numpy()
          for hh, s, dv in ((h, sigma, dev), (h_cpu, sigma_cpu, "cpu"))]
    pw_err = float(np.max(np.abs(up[0] - up[1])) / np.max(np.abs(up[1])))
    t3 = time.perf_counter()
    print(f"self-energy transport main path: flagship, FBZ, npt={SE_NPT}, {SE_TR_OMEGAS} omegas in {list(WINDOW)} eV: "
          f"build {t1 - t0:.4f} s, sweep {t2 - t1:.4f} s, peak {peak_tr:.1f} MiB; Gamma_xx(0) = "
          f"{float(G[SE_TR_OMEGAS * 6 // 13, 0, 0])!r}; asymmetry {asym:.3e} (<= 1e-10), min diagonal {dmin:.3e} of max "
          f"(>= -1e-12); Sigma = -{TR_ETA}i at npt {TR_NPT} vs TransportSolver at 64 omegas {tr_err:.3e} (<= 1e-9); "
          f"transport_distribution_sigma under PTR(24) card vs CPU {pw_err:.3e} (<= 1e-10); checks {t3 - t2:.4f} s",
          flush=True)
    if not (G.shape == (SE_TR_OMEGAS, 3, 3) and np.all(np.isfinite(G)) and asym <= 1e-10 and dmin >= -1e-12
            and tr_err <= 1e-9 and pw_err <= 1e-10):
        fail("self-energy transport checks")

    # the self-energy kinetic coefficients: beta 40, phase 26's mu, 8 Omegas in [0, 2] eV, alpha 0 then 1
    before_kin = se.sigma_pairs_sum.launches
    kin, A, split = kinetic_step(np, torch, se, h, bz, sigma, mu)
    t1 = time.perf_counter()
    kin_launches = se.sigma_pairs_sum.launches - before_kin
    # constant Sigma = -0.05i against the KineticCoefficientSolver (K19) at the same settings
    Om_c = np.linspace(0.0, 2.0, SE_KIN_OMEGAS)[:4]
    ks = se.SigmaKineticCoefficientSolver(h, bz, SE_KIN_NPT, lambda om: -1j * ETA, LH_BETA, mu=mu)
    kr = tr.KineticCoefficientSolver(h, bz, SE_KIN_NPT, eta=ETA, beta=LH_BETA, mu=mu)
    a_s, a_r = ks(Om_c, abstol=TR_ABSTOL), kr(Om_c, abstol=TR_ABSTOL)
    kin_err = float(np.max(np.abs(a_s - a_r)) / np.max(np.abs(a_r)))
    t2 = time.perf_counter()
    launches = {k.__name__: k.launches for k in kernels}
    wall = time.perf_counter() - t_phases
    print(f"self-energy kinetic main path: flagship, FBZ, npt={SE_KIN_NPT} ({SE_KIN_NPT**3} points), beta {LH_BETA}, "
          f"{SE_KIN_OMEGAS} Omegas in [0, 2] eV, abstol {TR_ABSTOL}: alpha 0 and 1 {split['wall_s']:.4f} s (builds "
          f"{split['build_s']:.4f} s, the integrand's device time (K28 and its small neighbours) "
          f"{split['integrand_ms']:.1f} ms = {100 * split['integrand_share']:.1f} % of the wall by CUDA events, the "
          f"rest "
          f"{split['wall_s'] - split['build_s'] - 1e-3 * split['integrand_ms']:.4f} s), numevals "
          f"{split['numevals']}, retcodes {split['retcodes']}, GK trips {split['trips']}, K28 launches {kin_launches}, "
          f"pairs per launch min {split['pairs'][0]}, mean {split['pairs'][1]:.1f}, max {split['pairs'][2]}; sigma_xx(0) "
          f"= {float(A[0][0, 0, 0])!r}, A1_xx(0) = {float(A[1][0, 0, 0])!r}; "
          f"Sigma = -{ETA}i vs KineticCoefficientSolver at 4 Omegas {kin_err:.3e} (<= 1e-9), numevals {ks.numevals} vs "
          f"{kr.numevals}, retcodes {ks.retcode} vs {kr.retcode}, {t2 - t1:.4f} s; launches {launches}; phases 29-30 "
          f"{wall:.3f} s (<= 60)", flush=True)
    if not (all(a.shape == (SE_KIN_OMEGAS, 3, 3) and np.all(np.isfinite(a)) for a in A)
            and all(k.retcode is not None and k.numevals > 0 for k in kin)):
        fail("self-energy kinetic output")
    if not (kin_err <= 1e-9 and ks.numevals == kr.numevals and ks.retcode == kr.retcode):
        fail("self-energy kinetic checks: the constant Sigma disagrees with KineticCoefficientSolver")
    if not (split["numevals"] == SE_KIN_NUMEVALS and split["retcodes"] == SE_KIN_RETCODES):
        fail(f"self-energy kinetic step: numevals {split['numevals']}, retcodes {split['retcodes']}, expected "
             f"{SE_KIN_NUMEVALS}, {SE_KIN_RETCODES}")
    if min(launches.values()) <= 0:
        fail(f"the Lindhard and self-energy main paths did not go through every kernel: {launches}")
    if wall > 60.0:
        fail(f"phases 29-30 took {wall:.1f} s (> 60)")
    numbers.update(kinetic=split, sigma_dos_sweep_s=t_dos_sweep, sigma_projected_sweep_s=t_proj_sweep,
                   sigma_transport_sweep_s=t_tr_sweep,
                   kinetic_check=[kin_err, ks.numevals, kr.numevals],
                   k25={"ms": t25["ms"], "bound_ms": b25[0], "ms_9": t25_9["ms"], "bound_ms_9": t25_9["bound"][0],
                        "err": err25, "err_9": err25_9, "certified_rungs": list(cert.npts),
                        "certified_rung_ms": rung_ms},
                   lindhard_build_s=lh_walls[0], lindhard_map_s=lh_walls[1], lindhard_launches=launches["chi0"],
                   certified_resid=cert.resid, certified_retcode=bool(cert.retcode))
    if "--profile" in sys.argv[1:]:
        profile(f"Lindhard map ({LH_NQ} q x {LH_OMEGAS} omegas)", lambda: [slv(q, oms) for q in qs])
        profile(f"self-energy DOS sweep ({SE_OMEGAS} omegas)", lambda: dos(om_d))
    del slv, dos
    torch.cuda.empty_cache()

    def entry(name, source, replaces, t, b):
        return {"name": name, "route": "cuda", "source": src + source, "replaces": replaces,
                "launches": launches[name], "max_abs_err": t["err"], "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": b[0], "bound_by": b[1], "library_ms": None}

    return [entry("chi0", "lindhard_chi0.cu", "autobzcore_tpu/models/lindhard.py:78", t25, b25),
            entry("cooper_mean", "lindhard_chi0.cu", "autobzcore_tpu/models/lindhard.py:134", t26, b26),
            entry("sigma_trace_sum", "sigma_trace.cu", "autobzcore_tpu/models/selfenergy.py:214", t27[False],
                  t27[False]["bound"]),
            entry("sigma_trace_points", "sigma_trace.cu", "autobzcore_tpu/models/selfenergy.py:122", t27p, b27p),
            entry("sigma_pairs_sum", "sigma_pairs.cu", "autobzcore_tpu/models/selfenergy.py:279", t28, b28),
            entry("sigma_pairs_points", "sigma_pairs.cu", "autobzcore_tpu/models/selfenergy.py:138", t28p,
                  b28p)], numbers


def autoptr_dos_ladder(np, torch, dev, h, bz):
    """Phase 32's AutoPTR DOS ladder: the 1000-omega DOS of the flagship by
    sweep_solve's batched AutoPTR ladder, with its wall, rungs, active lanes,
    K1 and K2 launches and peak memory. Returns them with the inputs."""
    from autobzcore_torch import AutoPTR, IntegralProblem, MixedParameters
    from autobzcore_torch.models import observables as obs
    from autobzcore_torch.ops.fourier_eval import fourier_points
    from autobzcore_torch.parallel.sweep import sweep_solve

    fourier_points.launches = obs.dos_trace_weighted_sum.launches = 0
    ws = np.linspace(*WINDOW, AUTOPTR_OMEGAS)
    prob = IntegralProblem(obs.dos_integrand(h, ETA), bz)
    alg = AutoPTR(device=dev, **AUTOPTR_KW)
    rungs = alg.bz_to_standard(bz)[2].npt_ladder()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    us, res, conv, nev = sweep_solve(prob, alg, MixedParameters(torch.as_tensor(ws, device=dev)),
                                     abstol=AUTOPTR_ABSTOL)
    D = us.cpu().numpy()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**20
    cum = np.cumsum([n**3 for n in rungs])
    last = np.array([rungs[int(np.searchsorted(cum, c))] for c in nev])  # each lane's last rung
    active = [int(np.sum(nev >= c)) for c in cum]
    launches = (fourier_points.launches, obs.dos_trace_weighted_sum.launches)
    print(f"AutoPTR main path: flagship, FBZ, dos_integrand(eta {ETA}), {AUTOPTR_OMEGAS} omegas in {list(WINDOW)} eV, "
          f"AutoPTR({', '.join(f'{k}={v}' for k, v in AUTOPTR_KW.items())}), abstol {AUTOPTR_ABSTOL}: "
          f"wall {wall:.4f} s; "
          f"rungs {rungs} with active lanes {active}; certified {int(conv.sum())} of {AUTOPTR_OMEGAS} (uncertified "
          f"at npt {rungs[-1]}: {int((~conv).sum())}); lanes by last rung "
          f"{ {int(n): int(np.sum(last == n)) for n in rungs} }; numevals {int(nev.sum())}; K1 launches "
          f"{launches[0]}, K2 {launches[1]}; peak device memory {peak:.1f} MiB; D(0) = {float(np.interp(0.0, ws, D))!r}", flush=True)
    if not (D.shape == (AUTOPTR_OMEGAS,) and np.all(np.isfinite(D)) and D.min() > 0 and nev.min() > 0):
        fail("the AutoPTR sweep: shape, finiteness, positivity or counts")
    return {"ws": ws, "prob": prob, "rungs": rungs, "res": res, "conv": conv, "nev": nev, "D": D, "wall": wall,
            "peak": peak, "last": last, "active": active, "launches": launches}


def k31_fused_phase(np, torch, dev, trip):
    """Phase 31's K31 fused entry (``models.observables.transport_points_eigh``):
    at graphene's largest IAI leaf trip (``trip``: H and dH views of one K11
    output, m = 2, d = 2, one om) and on hard H (``hard_hermitian``) with
    random dH at m = 1, 2, 3 (d = 3, om one a point, eta one value), against
    the plain route (eigh_chunked, then K31's plain version; 1e-12 relative),
    symmetric, bit-identical repeats; then three ways at the trip beside the
    integrand's call, eigh_chunked alone and the library route (eigh, the
    reference's two einsums), with the bound. Returns (numbers, bound)."""
    from types import SimpleNamespace

    from autobzcore_torch.models import observables as obs
    from autobzcore_torch.ops.eigh3 import eigh_chunked

    def check(tag, H, V, om, eta):
        G = obs.transport_points_eigh(H, V, om, eta)
        if not (torch.equal(G, obs.transport_points_eigh(H, V, om, eta)) and torch.equal(G, G.transpose(1, 2))):
            fail(f"K31 transport_points_eigh ({tag}): repeats differ or G is not symmetric")
        P = obs.transport_points_eigh_plain(H, V, om, eta)
        err = float((G - P).abs().max())
        if not err <= 1e-12 * float(P.abs().max()):
            fail(f"K31 transport_points_eigh ({tag}): max|d| vs the plain route {err:.3e} > 1e-12 x "
                 f"{float(P.abs().max()):.3e}")
        return err, err / float(P.abs().max())

    H, V, om = trip["H"], trip["V"], trip["om"]
    errs = {"trip": check("graphene's leaf trip", H, V, om, 0.3)}
    rng = np.random.default_rng(1231)
    for m in (1, 2, 3):
        Hh = hard_hermitian(np, rng, 900, m, 3.0)
        K = Hh.shape[0]
        J = torch.as_tensor(np.stack([Hh] + [random_hermitian(rng, K, m) for _ in range(3)], axis=1), device=dev)
        w = torch.as_tensor(rng.uniform(-3, 3, K), device=dev)
        errs[f"hard{m}"] = check(f"hard matrices, m = {m}", J[:, 0], J[:, 1:], w, 0.3)
    n, m, d = H.shape[0], H.shape[1], V.shape[1]
    hv = SimpleNamespace(s=(H, V))
    e, U = eigh_chunked(H)
    om_l = torch.broadcast_to(torch.as_tensor(om, dtype=torch.float64, device=dev), (n,))
    eta_l = torch.full((n,), 0.3, dtype=torch.float64, device=dev)

    def library():
        ee, UU = torch.linalg.eigh(H)
        v = torch.einsum("kim,kdij,kjn->kdmn", UU.conj(), V, UU)
        a = (eta_l[:, None] / ((om_l[:, None] - ee) ** 2 + eta_l[:, None] ** 2) / math.pi).to(v.dtype)
        return torch.einsum("kanm,kbnm,kn,km->kab", v, v.conj(), a, a).real

    t = three_ways(lambda: obs.transport_points_eigh(H, V, om, 0.3), 50)
    t.update(err=errs["trip"][0], errors={k: v[1] for k, v in errs.items()},
             integrand=three_ways(lambda: obs.transport_distribution_points(hv, om, eta=0.3), 50),
             eigh_chunked=three_ways(lambda: eigh_chunked(H), 50),
             plain_ms=cuda_ms(lambda: obs.transport_points_eigh_plain(H, V, om, 0.3), 20),
             library_ms=cuda_ms(library, 20))
    b = bound(n * k31_eigh_flops(m, d), nbytes(H, V) + 8 * n * d * d)
    print(f"K31 transport_points_eigh against the plain route (max|d| over max|G|): "
          f"{'; '.join(f'{k} {v[1]:.3e}' for k, v in errs.items())} (<= 1e-12), repeats bit-identical, symmetric; at "
          f"graphene's leaf trip ({n} points, m = {m}, d = {d}) {three_text(t)}; the integrand's call "
          f"{three_text(t['integrand'])}; eigh_chunked alone {three_text(t['eigh_chunked'])}; plain route "
          f"{t['plain_ms']:.4f} ms, library route (eigh, two einsums) {t['library_ms']:.4f} ms; bound {b[0]:.6f} ms "
          f"by {b[1]}", flush=True)
    return t, b


def slice12_phases(np, torch, dev, h, ladder):
    """Phases 31-32: K29-K31 and K27's matrix mode against their plain
    versions at the main path's shapes, then the AutoPTR family, the PTR
    transport integrand, the matrix spectral function and the k-path at full
    width. ``ladder`` is phase 12's certified full-grid DOS at its 1000
    omegas (None where phase 12 did not run). Returns the kernels' JSON
    entries and K27's numbers (its matrix mode and points three ways, the
    spectral_function PTR wall)."""
    import sys as _sys

    import autobzcore_torch.models.kpath  # noqa: F401  (models.kpath is the function of that name)
    from autobzcore_torch import (FBZ, IAI, PTR, AutoPTR, AutoPTR_IAI, CubicSymIBZ, FourierIntegrand,
                                  IntegralProblem, IntegralSolver, JacobianSeries, MixedParameters, load_bz, solve)
    from autobzcore_torch.models import observables as obs
    from autobzcore_torch.models.tight_binding import (flagship_series, synthetic_wannier, tb_graphene,
                                                        tb_haldane, tb_integer, tb_kane_mele)
    from autobzcore_torch.ops.eigh3 import eigh_chunked
    from autobzcore_torch.ops.fourier_eval import evaluate_grid
    from autobzcore_torch.parallel.sweep import sweep_solve

    kp = _sys.modules["autobzcore_torch.models.kpath"]
    src = "autobzcore_torch/csrc/"
    t_phases = time.perf_counter()
    bz = load_bz(FBZ(), np.eye(3))
    bz2 = load_bz(FBZ(), np.eye(2))
    det_b = abs(float(np.linalg.det(bz.B)))
    path = kp.kpath(KPATH_VERTICES, npts=KPATH_NPTS)
    if len(path.X) != KPATH_POINTS:
        fail(f"the flagship path has {len(path.X)} points, expected {KPATH_POINTS}")
    om_path = torch.linspace(*WINDOW, KPATH_OMEGAS, dtype=torch.float64, device=dev)

    def check(tag, got, want, tol, scale=None):
        """max|got - want| (fails above tol times the scale, max|want| by
        default) and a repeat that must be bit-identical (``again``)."""
        err = float((got - want).abs().max())
        sc = float(want.abs().max()) if scale is None else scale
        if not err <= tol * sc:
            fail(f"{tag}: max|d| vs plain {err:.3e} > {tol:g} x {sc:.3e}")
        return err

    def same(tag, a, b):
        if not torch.equal(a, b):
            fail(f"{tag}: two runs on the same inputs differ")

    # 31. K29-K31 and K27's matrix mode against their plain versions ---------------------------
    # K29 on the flagship path (m = 3) and on config 5's 30-band model
    h30 = synthetic_wannier(BANDS30, nr=5, device=dev)
    e3 = kp.band_structure(h, path)
    e30 = kp.band_structure(h30, path)
    t29 = {}
    for tag, e in (("flagship", e3), ("bands30", e30)):
        k29 = kp.spectral_map(e, om_path, ETA)
        err = check(f"K29 spectral_map ({tag})", k29, kp.spectral_map_plain(e, om_path, ETA), 1e-12)
        same(f"K29 spectral_map ({tag})", k29, kp.spectral_map(e, om_path, ETA))
        K, m = e.shape
        t29[tag] = {"err": err, "ms": cuda_ms(lambda: kp.spectral_map(e, om_path, ETA), 20),
                    "plain_ms": cuda_ms(lambda: kp.spectral_map_plain(e, om_path, ETA), 3),
                    "bound": bound(K * KPATH_OMEGAS * (m * LORENTZ_FLOPS + 1), nbytes(e, om_path, k29))}
    del k29
    print(f"K29 spectral_map on the flagship path ({KPATH_POINTS} points x {KPATH_OMEGAS} omegas): " + "; ".join(
        f"{tag} (m = {e.shape[1]}) max|d| vs plain {t['err']:.3e} (<= 1e-12 relative), repeat bit-identical, "
        f"{t['ms']:.4f} ms (plain {t['plain_ms']:.3f} ms, bound {t['bound'][0]:.4f} ms by {t['bound'][1]}, "
        f"{100 * t['bound'][0] / t['ms']:.1f} % of it)" for (tag, t), e in zip(t29.items(), (e3, e30))), flush=True)

    # K30: fused with eigh2 on Haldane (m = 2), on the flagship with the three
    # orbital projectors (m = 3), on Kane-Mele with Rashba coupling (m = 4),
    # kernel and plain version on the same eigh output
    path2 = kp.kpath(((0, 0), (0.5, 0), (1 / 3, 1 / 3), (0, 0)), npts=KPATH_NPTS)
    cases30 = []
    H2 = kp.path_hamiltonians(tb_haldane(t2=0.1, M=0.3, device=dev), path2).contiguous()
    cases30.append(("Haldane m = 2, fused eigh2", H2, torch.diag(torch.tensor([1.0, -1.0], dtype=torch.complex128,
                                                                              device=dev)), True))
    U3 = eigh_chunked(kp.path_hamiltonians(h, path))[1].contiguous()
    for i in range(3):
        P = torch.zeros((3, 3), dtype=torch.complex128, device=dev)
        P[i, i] = 1.0
        cases30.append((f"flagship m = 3, projector {i}", U3, P, False))
    U4 = eigh_chunked(kp.path_hamiltonians(tb_kane_mele(lam_so=0.08, lam_r=0.08, device=dev), path2))[1].contiguous()
    sz = torch.diag(torch.tensor([0.5, 0.5, -0.5, -0.5], dtype=torch.complex128, device=dev))
    cases30.append(("Kane-Mele m = 4, Sz", U4, sz, False))
    errs30 = []
    for tag, V, O, fused in cases30:
        k30 = kp.band_expect(V, O, fused)
        errs30.append(check(f"K30 band_expect ({tag})", k30, kp.band_expect_plain(V, O, fused), 1e-12,
                            float(O.abs().max())))
        same(f"K30 band_expect ({tag})", k30, kp.band_expect(V, O, fused))
    O3 = cases30[1][2]
    t30 = {"err": max(errs30), "ms": cuda_ms(lambda: kp.band_expect(U3, O3), 50),
           "plain_ms": cuda_ms(lambda: kp.band_expect_plain(U3, O3), 10),
           "library_ms": cuda_ms(lambda: torch.einsum("kin,ij,kjn->kn", U3.conj(), O3, U3).real, 10)}
    b30 = bound(U3.shape[0] * 3 * expect_flops(3), nbytes(U3, O3) + 8 * U3.shape[0] * 3)
    print(f"K30 band_expect on the paths ({', '.join(c[0] for c in cases30)}): max|d| vs plain {t30['err']:.3e} (<= "
          f"1e-12 of the operator's scale), repeats bit-identical; flagship m = 3 at {U3.shape[0]} points "
          f"{t30['ms']:.4f} ms (plain {t30['plain_ms']:.4f} ms, one einsum {t30['library_ms']:.4f} ms, bound "
          f"{b30[0]:.5f} ms by {b30[1]}, {100 * b30[0] / t30['ms']:.2f} % of it)", flush=True)
    del H2, U4

    # K31's first entry at the largest leaf trip of phase 32's Kane-Mele IAI transport solve (m = 4): the
    # main path sends it no other shape, since m <= 3 takes its fused entry
    trip = iai_transport_trip(np, torch, dev, kane_mele_transport)
    e31, U31 = eigh_chunked(trip["H"])
    om31 = torch.broadcast_to(torch.as_tensor(trip["om"], dtype=torch.float64, device=dev),
                              (e31.shape[0],)).contiguous()
    a31 = (e31, U31.contiguous(), trip["V"], om31, torch.full_like(om31, 0.3))
    k31 = obs.transport_points(*a31)
    err31 = check("K31 transport_points (Kane-Mele IAI leaf trip)", k31, obs.transport_points_plain(*a31), 1e-12)
    same("K31 transport_points", k31, obs.transport_points(*a31))
    e31, U31, dH31, om31, eta31 = a31

    def library31():
        v = torch.einsum("kim,kdij,kjn->kdmn", U31.conj(), dH31, U31)
        a = (eta31[:, None] / ((om31[:, None] - e31) ** 2 + eta31[:, None] ** 2) / math.pi).to(v.dtype)
        return torch.einsum("kanm,kbnm,kn,km->kab", v, v.conj(), a, a).real

    N31, m31, d31 = e31.shape[0], e31.shape[1], dH31.shape[1]
    t31 = {"err": err31, "ms": cuda_ms(lambda: obs.transport_points(*a31), 50),
           "plain_ms": cuda_ms(lambda: obs.transport_points_plain(*a31), 10), "library_ms": cuda_ms(library31, 10)}
    b31 = bound(N31 * transport_point_flops(m31, d31), nbytes(*a31) + 8 * N31 * d31 * d31)
    print(f"K31 transport_points at the largest leaf trip of Kane-Mele's IAI transport solve ({N31} points, m = {m31}, "
          f"d = {d31}): max|d| vs plain {err31:.3e} (<= 1e-12 relative), repeat bit-identical, {t31['ms']:.4f} ms "
          f"(plain {t31['plain_ms']:.4f} ms, the reference's two einsums {t31['library_ms']:.4f} ms, bound "
          f"{b31[0]:.6f} ms by {b31[1]}, {100 * b31[0] / t31['ms']:.2f} % of it)", flush=True)
    t31f, b31f = k31_fused_phase(np, torch, dev, iai_transport_trip(np, torch, dev))

    # K27's matrix mode on the flagship's npt=100 grid at 264 lanes z = w + i eta (Z = z I), each time
    # by events, by the profiler's device time (K27 and its column sum) and on the host
    H = evaluate_grid(h.c, 3, [np.arange(NPT) / NPT] * 3, h.offset, h.period).reshape(-1, 3, 3).contiguous()
    K = H.shape[0]
    w = torch.ones(K, dtype=torch.float64, device=dev)
    om_s = torch.linspace(*WINDOW, W_FLAGSHIP, dtype=torch.float64, device=dev)
    eta_s = torch.full_like(om_s, ETA)
    z = (om_s + 1j * ETA).to(torch.complex128)
    sc = 1.0 / K
    k27 = obs.spectral_weighted_sum(H, w, z, sc)
    p27, pms27 = timed_once(lambda: obs.spectral_weighted_sum_plain(H, w, z, sc))
    err27 = check("K27 spectral_weighted_sum", k27, p27, 1e-12)
    same("K27 spectral_weighted_sum", k27, obs.spectral_weighted_sum(H, w, z, sc))
    herm27 = torch.equal(k27, k27.conj().transpose(1, 2))
    k2 = obs.dos_trace_weighted_sum(H, w, om_s, eta_s, sc)
    tr_err = float((torch.diagonal(k27, dim1=1, dim2=2).sum(-1).real - k2).abs().max()) / float(k2.abs().max())
    if not (herm27 and tr_err <= 1e-12):
        fail(f"K27 spectral_weighted_sum: Hermitian {herm27}, trace vs K2 {tr_err:.3e} (<= 1e-12)")
    # at eta 1e-3 with half the lanes on poles; the general route (a Z matrix a lane, on no path) on 32 lanes
    rng = np.random.default_rng(31)
    zq = k27_pole_lanes(np, torch, rng, H, K27_POLE_LANES, K27_POLE_ETA, scalar=True)
    kq = obs.spectral_weighted_sum(H, w, zq, sc)
    errq = check(f"K27 spectral_weighted_sum at eta {K27_POLE_ETA:g}, lanes on poles", kq,
                 obs.spectral_weighted_sum_plain(H, w, zq, sc), 1e-12)
    same(f"K27 spectral_weighted_sum at eta {K27_POLE_ETA:g}", kq, obs.spectral_weighted_sum(H, w, zq, sc))
    same(f"K27 spectral_weighted_sum at eta {K27_POLE_ETA:g}, a lane alone", kq[-1:],
         obs.spectral_weighted_sum(H, w, zq[-1:].contiguous(), sc))
    Zg = (z[:32, None, None] * torch.eye(3, dtype=torch.complex128, device=dev)).contiguous()
    errg = check("K27 spectral_weighted_sum (the general route, a Z matrix a lane)", obs.spectral_weighted_sum(H, w, Zg, sc),
                 p27[:32], 1e-12, scale=float(p27.abs().max()))
    t27 = dict(three_ways(lambda: obs.spectral_weighted_sum(H, w, z, sc), 5), err=err27, plain_ms=pms27)
    b27 = bound(K * W_FLAGSHIP * K27_SPECTRAL_Z_FLOPS + K * K27_SPECTRAL_K_FLOPS, nbytes(H, w, z, k27))
    b27_first = bound(K * W_FLAGSHIP * (SPECTRAL3_FLOPS + 2 * 9), nbytes(H, w, k27) + 16 * 9 * W_FLAGSHIP)[0]
    del p27, kq, Zg
    # the pointwise entry at the PTR(48) points: one z, one per point, a Z matrix per point, poles
    Hp = obs.gathered_grid(h, 3, [np.arange(48) / 48] * 3, None).reshape(-1, 3, 3).contiguous()
    zn = (torch.as_tensor(rng.uniform(*WINDOW, Hp.shape[0]), device=dev) + 1j * ETA).to(torch.complex128)
    Zn = (zn[:, None, None] * torch.eye(3, dtype=torch.complex128, device=dev)).contiguous()
    z1 = z[W_FLAGSHIP // 2].contiguous()
    zp = k27_pole_lanes(np, torch, rng, Hp, Hp.shape[0], K27_POLE_ETA, scalar=True)
    errs = [check(f"K27 spectral_points ({tag})", obs.spectral_points(Hp, Zs), obs.spectral_points_plain(Hp, Zs),
                  1e-12) for tag, Zs in (("one z", z1), ("z per point", zn), ("Z per point", Zn),
                                         (f"eta {K27_POLE_ETA:g} on poles", zp))]
    same("K27 spectral_points", obs.spectral_points(Hp, zn), obs.spectral_points(Hp, zn))
    t27p = dict(three_ways(lambda: obs.spectral_points(Hp, z1), 20), err=max(errs),
                plain_ms=cuda_ms(lambda: obs.spectral_points_plain(Hp, z1), 5))
    b27p = bound(Hp.shape[0] * K27_SPECTRAL_POINT_FLOPS, nbytes(Hp, z1) + 16 * 9 * Hp.shape[0])
    # and at the largest leaf trip of phase 32's graphene IAI solve of spectral_function (m = 2)
    gtrip = {}
    entry = obs.spectral_points

    def recording(H_, Z_):
        if H_.shape[0] > gtrip.get("n", 0):
            gtrip.update(n=H_.shape[0], H=H_.clone(), Z=Z_.clone())
        return entry(H_, Z_)

    recording.launches = 0  # the entry counts its launches on the module's name, here this function
    obs.spectral_points = recording
    try:
        solve(IntegralProblem(FourierIntegrand(obs.spectral_function, tb_graphene(device=dev), eta=0.2, batched=True),
                              bz2, 0.5),
              IAI(device=dev), abstol=1e-4)
    finally:
        obs.spectral_points = entry
    Hg, zg = gtrip["H"], gtrip["Z"]
    eg = check("K27 spectral_points (graphene's IAI leaf trip)", obs.spectral_points(Hg, zg),
               obs.spectral_points_plain(Hg, zg), 1e-12)
    t27g = dict(three_ways(lambda: obs.spectral_points(Hg, zg), 50), err=eg, n=Hg.shape[0],
                bound=bound(Hg.shape[0] * K27_SPECTRAL_POINT2_FLOPS, nbytes(Hg, zg) + Hg.shape[0] * 4 * 16))
    print(f"K27 matrix mode on the flagship's npt={NPT} grid ({K} points, {W_FLAGSHIP} lanes z = w + {ETA}i): "
          f"max|d| vs plain {err27:.3e} ({err27 / float(k27.abs().max()):.3e} of the value scale, <= 1e-12; at eta "
          f"{K27_POLE_ETA:g} with {K27_POLE_LANES // 2} of {K27_POLE_LANES} lanes on poles {errq:.3e}; the general "
          f"route on 32 lanes {errg:.3e}), repeats and a lane alone bit-identical, exactly Hermitian, trace vs K2 "
          f"{tr_err:.3e} (<= 1e-12); {three_text(t27)} (plain {pms27:.1f} ms, bound {b27[0]:.4f} ms by {b27[1]} "
          f"[first count {b27_first:.4f}], {100 * b27[0] / t27['ms']:.1f} % of it by events); pointwise at the "
          f"PTR(48) points ({Hp.shape[0]}), one z, one per point, a Z matrix per point and on poles: max|d| "
          f"{t27p['err']:.3e} (<= 1e-12 of the scale), {three_text(t27p)} (plain {t27p['plain_ms']:.4f} ms, bound "
          f"{b27p[0]:.5f} ms by {b27p[1]}); at graphene's largest IAI leaf trip ({t27g['n']} points, m = 2, one z) "
          f"max|d| {eg:.3e}, {three_text(t27g)} (bound {t27g['bound'][0]:.5f} ms by {t27g['bound'][1]}); phase 31 "
          f"{time.perf_counter() - t_phases:.3f} s", flush=True)
    k27_numbers = {"sum": dict(t27, bound=b27[0], first_bound=b27_first), "points_ptr48": dict(t27p, bound=b27p[0]),
                   "points_graphene": dict(t27g, bound=t27g["bound"][0])}
    k27_numbers["k31_eigh"] = {k: v for k, v in t31f.items() if k != "bound"}
    del H, w, z, k27, k2, Hp, Zn, zn, zp, Hg, zg, U3, a31, e31, U31, dH31, trip
    torch.cuda.empty_cache()

    # 32. the slice's paths at full width ------------------------------------------------------
    kernels = (kp.spectral_map, kp.band_expect, obs.transport_points, obs.transport_points_eigh,
               obs.spectral_weighted_sum, obs.spectral_points)
    for k in kernels + (obs.dos_trace_weighted_sum, obs.velocity_pairs, obs.transport_gamma):
        k.launches = 0
    t_main = time.perf_counter()

    # AutoPTR, the north-star algorithm: the 1000-omega DOS by the batched ladder
    lad = autoptr_dos_ladder(np, torch, dev, h, bz)
    ws, prob, rungs, res, conv, nev, D, last = (lad[k] for k in ("ws", "prob", "rungs", "res", "conv", "nev", "D",
                                                                 "last"))
    # each lane against PTR at its last rung
    worst = 0.0
    for n in sorted(set(last.tolist())):
        sel = np.nonzero(last == n)[0]
        ref, *_ = sweep_solve(prob, PTR(npt=int(n), device=dev), MixedParameters(torch.as_tensor(ws[sel],
                                                                                                   device=dev)))
        worst = max(worst, float(np.max(np.abs(D[sel] - ref.cpu().numpy()) / np.abs(ref.cpu().numpy()))))
        del ref
        torch.cuda.empty_cache()
    # five lanes through one scalar solver, sharing its rule cache
    # spread over the window, and the lane that needed the most rungs
    spread = np.linspace(0, AUTOPTR_OMEGAS - 1, AUTOPTR_SCALAR_LANES - 1).astype(int)
    deepest = [i for i in np.argsort(-nev, kind="stable") if i not in spread][0]
    pick = np.sort(np.append(spread, deepest))
    solver = IntegralSolver(prob, AutoPTR(device=dev, **AUTOPTR_KW), abstol=AUTOPTR_ABSTOL)
    t0 = time.perf_counter()
    scal = [solver.solve_p(MixedParameters(float(ws[i]))) for i in pick]
    t_scal = time.perf_counter() - t0
    cached = sorted(solver.cache.cacheval["inner"]["rules"])
    held = sum(n**3 * (16 * 9 + 8) for n in cached) / 2**30  # each rung's H and weights
    peak_s = torch.cuda.max_memory_allocated() / 2**30
    del solver
    torch.cuda.empty_cache()
    same_counts = all(s.numevals == int(nev[i]) and bool(s.retcode) == bool(conv[i]) for s, i in zip(scal, pick))
    rel_scal = max(abs(float(s.u) - D[i]) / abs(D[i]) for s, i in zip(scal, pick))
    # the certified lanes against phase 12's ladder (certified at npt 566 by a
    # sup-norm change of 1.2e-6). An early lane beyond twice the abstol is
    # certified by a small change between two rungs whose errors are alike:
    # its rung table (PTR at every rung at its omega, against the ladder)
    # shows the gap closing, and PTR at nmax must come within the limit
    lim = 2 * AUTOPTR_ABSTOL
    if ladder is None:
        lad_txt = "not checked (phase 12 did not run in this process)"
        lad_ok = True
    else:
        dev_l = np.abs(D - ladder)
        late = conv & (last >= AUTOPTR_HELD_NPT)
        lad_err = float(np.max(dev_l[late], initial=0.0))
        beyond = np.nonzero(conv & (last < AUTOPTR_HELD_NPT) & (dev_l > lim))[0]
        by_rung = {int(n): float(f"{dev_l[conv & (last == n)].max():.3e}") for n in rungs
                   if np.any(conv & (last == n))}
        table = np.zeros((len(rungs), beyond.size))
        for r, n in enumerate(rungs if beyond.size else ()):
            ref, *_ = sweep_solve(prob, PTR(npt=int(n), device=dev),
                                  MixedParameters(torch.as_tensor(ws[beyond], device=dev)))
            table[r] = np.abs(ref.cpu().numpy() - ladder[beyond])
            del ref
            torch.cuda.empty_cache()
        top_err = float(np.max(table[-1], initial=0.0))
        lad_ok = (lad_err <= lim and beyond.size <= AUTOPTR_EARLY_SHARE * int(conv.sum()) and top_err <= lim)
        rows = "; ".join(f"omega {ws[i]:.4f} (last rung {int(last[i])}, resid {res[i]:.3e} of tol "
                         f"{AUTOPTR_ABSTOL:g}): " + ", ".join(f"{int(n)}: {table[r, j]:.3e}" for r, n in enumerate(rungs))
                         for j, i in enumerate(beyond))
        lad_txt = (f"max {lad_err:.3e} over the {int(late.sum())} lanes certified at npt >= {AUTOPTR_HELD_NPT} "
                   f"(<= {lim:g}); max by last rung {by_rung}; {beyond.size} earlier lanes beyond {lim:g} (<= "
                   f"{AUTOPTR_EARLY_SHARE:.0%} of {int(conv.sum())}), |PTR(npt) - ladder| by rung: [{rows}]; PTR at "
                   f"npt {rungs[-1]} there max {top_err:.3e} (<= {lim:g})")
    print(f"AutoPTR checks: every lane vs PTR at its last rung max rel {worst:.3e} (<= 1e-12); lanes {pick.tolist()} "
          f"through one scalar IntegralSolver (one rule cache: rungs {cached}, their H and weights {held:.2f} GiB, "
          f"peak {peak_s:.2f} GiB): counts and flags {'identical' if same_counts else 'DIFFER'} "
          f"({[s.numevals for s in scal]}, {[bool(s.retcode) for s in scal]}), values max rel {rel_scal:.3e}, "
          f"{t_scal:.3f} s; certified lanes vs phase 12's certified ladder {lad_txt}", flush=True)
    if not (worst <= 1e-12 and same_counts and rel_scal <= 1e-12 and lad_ok):
        fail("AutoPTR checks")
    # AutoPTR_IAI at one omega: the estimate (AutoPTR at reltol 1) sets the
    # IAI's abstol to reltol |estimate|; the estimate's count, then the IAI's
    w1, rt1 = 0.5, 1e-2
    t0 = time.perf_counter()
    est = solve(IntegralProblem(obs.dos_integrand(h, ETA), bz, w1), AutoPTR(device=dev, **AUTOPTR_KW), reltol=1.0)
    both = solve(IntegralProblem(obs.dos_integrand(h, ETA), bz, w1),
                 AutoPTR_IAI(ptr=AutoPTR(device=dev, **AUTOPTR_KW), iai=IAI(inner_cap=64, inner_nbisect=4,
                                                                                device=dev)), reltol=rt1)
    t_ai = time.perf_counter() - t0
    print(f"AutoPTR_IAI at omega {w1} (the estimate at reltol 1, the IAI at reltol {rt1}): D = {float(both.u)!r} "
          f"(the estimate {float(est.u)!r}), numevals {both.numevals} = AutoPTR {est.numevals} + IAI "
          f"{both.numevals - est.numevals}, retcode {both.retcode}, {t_ai:.3f} s", flush=True)
    if not (math.isfinite(float(both.u)) and both.numevals > est.numevals > 0
            and abs(float(both.u) - float(est.u)) <= abs(float(est.u))):
        fail("AutoPTR_IAI")
    del est, both
    torch.cuda.empty_cache()

    # the transport integrand (B11d) under PTR(100): one pack, one K19 launch, against TransportSolver
    om_t = np.linspace(*WINDOW, TR_PTR_OMEGAS)
    ti = obs.transport_integrand(h, eta=ETA)
    t0 = time.perf_counter()
    G, _, convt, net = sweep_solve(IntegralProblem(ti, bz), PTR(npt=NPT, device=dev),
                                   MixedParameters(torch.as_tensor(om_t, device=dev)))
    G = G.cpu().numpy()
    t_ptr = time.perf_counter() - t0
    Gt = obs.TransportSolver(h, bz, NPT, ETA)(om_t)
    tr_rel = float(np.max(np.abs(G - Gt)) / np.max(np.abs(Gt)))
    # under AutoPTR up to npt 300 at 32 omegas, reltol 1e-3
    om32 = np.linspace(*WINDOW, TR_AUTOPTR_OMEGAS)
    tr_rungs = AutoPTR(device=dev, **TR_AUTOPTR_KW).bz_to_standard(bz)[2].npt_ladder()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    Ga, _, conva, neva = sweep_solve(IntegralProblem(ti, bz), AutoPTR(device=dev, **TR_AUTOPTR_KW),
                                     MixedParameters(torch.as_tensor(om32, device=dev)), reltol=1e-3)
    t_auto = time.perf_counter() - t0
    peak_t = torch.cuda.max_memory_allocated() / 2**30
    cum_t = np.cumsum([n**3 for n in tr_rungs])
    active_t = [int(np.sum(neva >= c)) for c in cum_t]
    del Ga
    torch.cuda.empty_cache()
    # tb_integer(3) at eta 0.5 on the cubic wedge against the full zone (the in-loop symmetrization)
    h1 = tb_integer(3, device=dev)
    wedge = [solve(IntegralProblem(obs.transport_integrand(h1, eta=0.5), load_bz(kind, np.eye(3)),
                                   MixedParameters(0.4)), AutoPTR(nmin=20, nmax=200, device=dev), abstol=1e-8)
             for kind in (CubicSymIBZ(), FBZ())]
    wedge_err = float((wedge[0].u - wedge[1].u).abs().max())
    # under IAI at one omega, the card against the CPU: graphene (m = 2) and a
    # 3-band model, K31's fused entry at every leaf trip with no cuSOLVER call,
    # then Kane-Mele (m = 4) on eigh_chunked and K31's first entry
    iai_tr = {}
    for tag, build, tol in (("graphene", tb_graphene, 1e-2),
                            ("bands3", lambda device: synthetic_wannier(3, nr=3, ndim=2, seed=3, device=device), 1e-3),
                            ("kane_mele", kane_mele_transport, 1e-2)):
        n31 = (obs.transport_points.launches, obs.transport_points_eigh.launches)
        with EighCount() as n_eigh:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            gc = solve(IntegralProblem(obs.transport_integrand(build(device=dev), eta=0.3), bz2, MixedParameters(0.5)),
                       IAI(device=dev), abstol=tol)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        n31 = (obs.transport_points.launches - n31[0], obs.transport_points_eigh.launches - n31[1])
        gp = solve(IntegralProblem(obs.transport_integrand(build(device="cpu"), eta=0.3), bz2, MixedParameters(0.5)),
                   IAI(device="cpu"), abstol=tol)
        rel = float((gc.u.cpu() - gp.u).abs().max() / gp.u.abs().max())
        iai_tr[tag] = {"wall_s": wall, "rel": rel, "numevals": [int(gc.numevals), int(gp.numevals)],
                       "k31": n31[0], "k31_eigh": n31[1], "eigh_calls": n_eigh.calls, "abstol": tol}
        fused = tag != "kane_mele"
        if not (rel <= 1e-10 and gc.numevals == gp.numevals and (n31[1] > 0 and n31[0] == 0 and n_eigh.calls == 0
                                                                 if fused else n31[0] > 0 and n31[1] == 0)):
            fail(f"the transport integrand under IAI ({tag}): {iai_tr[tag]}")
    gi_rel = iai_tr["graphene"]["rel"]
    print(f"transport integrand (B11d): PTR(npt={NPT}) at {TR_PTR_OMEGAS} omegas {t_ptr:.4f} s vs TransportSolver "
          f"max rel {tr_rel:.3e} (<= 1e-12), numevals {int(net[0])} a lane; AutoPTR({TR_AUTOPTR_KW}) at "
          f"{TR_AUTOPTR_OMEGAS} omegas, reltol 1e-3: {t_auto:.3f} s, rungs {tr_rungs} with active lanes {active_t}, "
          f"flags {conva.astype(int).tolist()}, peak {peak_t:.2f} GiB; tb_integer(3), eta 0.5, AutoPTR(nmin=20, "
          f"nmax=200), abstol 1e-8: CubicSymIBZ vs FBZ {wedge_err:.3e} (<= 1e-8), numevals {wedge[0].numevals} vs "
          f"{wedge[1].numevals}, retcodes {wedge[0].retcode}, {wedge[1].retcode}; under IAI at eta 0.3, omega 0.5 "
          f"card vs CPU (<= 1e-10, equal numevals; K31's fused entry a trip and no eigh call at m <= 3): "
          + "; ".join(f"{tag} (abstol {v['abstol']:g}) {v['rel']:.3e}, numevals {v['numevals']}, wall "
                      f"{v['wall_s']:.4f} s, fused K31 launches {v['k31_eigh']}, K31 {v['k31']}, eigh calls "
                      f"{v['eigh_calls']}" for tag, v in iai_tr.items())
          + f"; K18 launches {obs.velocity_pairs.launches}, K19 {obs.transport_gamma.launches}", flush=True)
    if not (tr_rel <= 1e-12 and convt.all() and conva.any() and np.all(neva > 0) and wedge_err <= 1e-8
            and wedge[0].retcode and wedge[1].retcode and gi_rel <= 1e-10):
        fail("transport integrand checks")
    k27_numbers["transport_iai"] = iai_tr

    # the matrix spectral function under PTR(100) at 264 omegas, against the PTR DOS (K2)
    t0 = time.perf_counter()
    A, *_ = sweep_solve(IntegralProblem(FourierIntegrand(obs.spectral_function, h, eta=ETA), bz),
                        PTR(npt=NPT, device=dev), MixedParameters(om_s))
    torch.cuda.synchronize()
    t_spec = time.perf_counter() - t0
    Dd, *_ = sweep_solve(IntegralProblem(obs.dos_integrand(h, ETA), bz), PTR(npt=NPT, device=dev),
                         MixedParameters(om_s))
    sp_err = float((torch.diagonal(A, dim1=1, dim2=2).sum(-1).real - Dd).abs().max() / Dd.abs().max())
    sp_herm = float((A - A.conj().transpose(1, 2)).abs().max() / A.abs().max())
    # and at points: the batched form under IAI on graphene, card against CPU
    si = [solve(IntegralProblem(FourierIntegrand(obs.spectral_function, tb_graphene(device=dv), eta=0.2, batched=True),
                                bz2, 0.5), IAI(device=dv), abstol=1e-4) for dv in (dev, "cpu")]
    si_rel = float((si[0].u.cpu() - si[1].u).abs().max() / si[1].u.abs().max())
    print(f"spectral_function: PTR(npt={NPT}) at {W_FLAGSHIP} omegas {t_spec:.4f} s; trace vs the PTR DOS (K2) "
          f"{sp_err:.3e} of max|D| (<= 1e-12), Hermitian to {sp_herm:.3e} (<= 1e-14); batched under IAI on graphene "
          f"(eta 0.2, abstol 1e-4) card vs CPU {si_rel:.3e} (<= 1e-10), numevals {si[0].numevals} vs "
          f"{si[1].numevals}", flush=True)
    if not (sp_err <= 1e-12 and sp_herm <= 1e-14 and si_rel <= 1e-10 and si[0].numevals == si[1].numevals):
        fail("spectral_function checks")
    k27_numbers.update(spectral_ptr_s=t_spec, graphene_iai_numevals=[int(si[0].numevals), int(si[1].numevals)])
    del A, Dd

    # the k-path: the flagship and config 5
    walls = {}
    for tag, hh in (("flagship", h), ("bands30", h30)):
        m = hh.valshape[0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e = kp.band_structure(hh, path)
        Amap = kp.spectral_path(hh, path, om_path, ETA)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        projs = [np.diag(np.eye(m)[i]) for i in range(m)]
        ex = sum(kp.expectation_path(hh, path, P) for P in projs)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        wide = np.linspace(-60.0, 60.0, 8001)
        rule = np.trapezoid(kp.spectral_path(hh, path, wide, ETA).cpu().numpy(), wide, axis=1)
        walls[tag] = (t1 - t0, t2 - t1, float(np.max(np.abs(rule - m))), float((ex - 1).abs().max()))
        if tag == "bands30":
            sub = np.arange(0, KPATH_POINTS, 97)
            ref = np.stack([np.linalg.eigvalsh(hh(np.asarray(path.X[i])).cpu().numpy()) for i in sub])
            walls[tag] += (float(np.max(np.abs(e.cpu().numpy()[sub] - ref))),)
        if not (Amap.shape == (KPATH_POINTS, KPATH_OMEGAS) and bool(torch.isfinite(Amap).all())
                and walls[tag][2] <= 1e-2 * max(1.0, m / 3) and walls[tag][3] <= 1e-12):
            fail(f"k-path checks ({tag}): shape {tuple(Amap.shape)}, sum rule {walls[tag][2]:.3e}, projectors "
                 f"{walls[tag][3]:.3e}")
    if not walls["bands30"][4] <= 1e-10:
        fail(f"config 5's band structure vs numpy: {walls['bands30'][4]:.3e}")
    launches = {k.__name__: k.launches for k in kernels}
    wall32 = time.perf_counter() - t_main
    wall = time.perf_counter() - t_phases
    print(f"k-path main path (Gamma-X-M-Gamma-R-X, npts {KPATH_NPTS}, {KPATH_POINTS} points, {KPATH_OMEGAS} omegas): "
          + "; ".join(
        f"{tag} band_structure + spectral_path {v[0]:.4f} s, expectation_path x {3 if tag == 'flagship' else BANDS30} "
        f"projectors {v[1]:.4f} s, sum rule on [-60, 60] eV max|int A - m| {v[2]:.3e} (<= 1e-2 per 3 bands), "
        f"projectors sum to "
        f"1 within {v[3]:.3e}" + (f", vs numpy eigvalsh at 40 points {v[4]:.3e}" if len(v) > 4 else "")
        for tag, v in walls.items()) + f"; launches {launches}; phase 32 {wall32:.3f} s; phases 31-32 {wall:.3f} s "
        f"(<= 60)", flush=True)
    if min(launches.values()) <= 0:
        fail(f"the slice's main paths did not go through every kernel: {launches}")
    if wall > 60.0:
        fail(f"phases 31-32 took {wall:.1f} s (> 60)")
    if "--profile" in sys.argv[1:]:
        profile(f"AutoPTR ladder ({AUTOPTR_OMEGAS} omegas)", lambda: sweep_solve(
            prob, AutoPTR(device=dev, **AUTOPTR_KW), MixedParameters(torch.as_tensor(ws, device=dev)),
            abstol=AUTOPTR_ABSTOL))
        profile(f"k-path spectral map ({KPATH_POINTS} x {KPATH_OMEGAS})",
                lambda: kp.spectral_path(h, path, om_path, ETA))
    torch.cuda.empty_cache()

    def entry(name, source, replaces, t, b, library_ms=None):
        return {"name": name, "route": "cuda", "source": src + source, "replaces": replaces,
                "launches": launches[name], "max_abs_err": t["err"], "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": b[0], "bound_by": b[1], "library_ms": library_ms}

    return [entry("spectral_map", "spectral_path.cu", "autobzcore_tpu/models/kpath.py:123", t29["flagship"],
                  t29["flagship"]["bound"]),
            entry("band_expect", "band_expect.cu", "autobzcore_tpu/models/kpath.py:86", t30, b30, t30["library_ms"]),
            entry("transport_points", "transport_points.cu", "autobzcore_tpu/models/observables.py:175", t31, b31,
                  t31["library_ms"]),
            entry("transport_points_eigh", "transport_points.cu", "autobzcore_tpu/models/observables.py:184", t31f,
                  b31f, t31f["library_ms"]),
            entry("spectral_weighted_sum", "sigma_trace.cu", "autobzcore_tpu/models/observables.py:160", t27, b27),
            entry("spectral_points", "sigma_trace.cu", "autobzcore_tpu/models/observables.py:160", t27p, b27p)], \
        k27_numbers


if __name__ == "__main__":
    main()
