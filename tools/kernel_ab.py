#!/usr/bin/env python3
"""Time a group of kernels and the paths that run them, for the
``autobzcore_torch`` package of any checkout, on one NVIDIA GPU.

    python3 tools/kernel_ab.py TREE LABEL
        --phases fourier|rule_transport|iai|k24|warm_plain|selfenergy|spectral|ltm|ggr|tai|pools|eigh [--iai]
        [--out DIR]

It imports ``autobzcore_torch`` from the checkout at TREE (its kernels
build there at first use) and runs this repository's ``chip_smoke.py``
phase functions on it:

- ``--phases fourier``: the Fourier-evaluation kernels (K1, K11, K3) and
  the PTR DOS sum (K2): phases 3-4 (K1; K2 at the PTR shape, 1e6 k x 264
  lanes, and at a late AutoPTR rung's, 8 lanes on the npt=400 grid's 6.4e7
  points; the flagship PTR leg, once more under torch.profiler for K2's
  device time), 6a (K3 at the outer and mid shapes, with its host cost a
  call), phase 19's K11 (at the flagship's 1e6 points, a GGR init chunk of
  4,096 points and the bands30 chunk) and phase 32's AutoPTR DOS ladder
  (its rungs, active lanes and certified lanes, and from torch.profiler K1's
  and K2's device time per rung and their shares of its device time), then
  the GGR init of phase 20 and phase 32's AutoPTR transport ladder;
- ``--phases rule_transport``: the Genz-Malik box rule (K14) and the
  transport contraction (K19): phase 22 (K14-K17 at the TAI leg's shapes,
  with K14's device time and the host cost of its call) and phases 25-26
  (K18-K20, K19's device time in its four cases, the transport main path's
  sweep with its numevals, retcode, GK trips and K19 launches);
- ``--phases iai``: the IAI leaf (K4 and the fused leaf solve) and the zone
  average (K24): phases 6-10 (K3-K6, the fused solve against the trip
  route, the cold chunk, the cubic wedge, the two
  warm calls) and 16-17 (the block entries, one wall of each block width),
  each leg's wall, evals, retcode, trips, host syncs, leaf launches and
  device busy share (nvidia-smi), then phase 27's K24 at the Weyl AHC by
  events and by device time beside ``torch.einsum``;
- ``--phases k24``: phase 27's K24 alone, first in its process (where the
  profiler's device times are whole);
- ``--phases selfenergy``: the Lindhard and matrix self-energy kernels and
  paths: phases 29-30 at phase 26's chemical potential (K25-K28 against
  their plain versions, K25 at the map's 100 omegas and certified_chi0's 9
  and at each certified rung, K28 at 256 equal frequencies, 32 unequal pairs
  and a kinetic trip's 960, and at m = 4; the Lindhard map's build and
  wall, the self-energy DOS
  and transport sweeps, and the kinetic step with its split: builds, the
  integrand's device time summed over its trips (K28 with its small
  neighbours), pairs per launch, trips, numevals, retcodes); K27's trace
  and diagonal sums and pointwise entry (at the PTR(48) points and the
  largest IAI leaf trip) each by events, by the profiler's device time and
  on the host, and the self-energy DOS and projected sweeps' walls;
- ``--phases spectral``: phases 31-32 (K29-K31; K27's matrix mode on the
  lanes' z and its pointwise entry at the PTR(48) points and at graphene's
  largest IAI leaf trip, each three ways; the AutoPTR, transport,
  spectral_function and k-path paths); on a checkout whose matrix mode
  takes no z, ``k27_z_shim`` hands it Z = z I;
- ``--phases ltm``: the tetrahedron DOS (K10): phases 14-15 (K10 against
  its plain version at 1001 energies, DOS and N(E), then the LTM main
  path's init, sweep and fermi_level walls and a Fermi step's one-energy
  call);
- ``--phases ggr``: the spectral-grid DOS (K11-K13): phases 19-21 (K13 in
  box and Gaussian mode at the flagship's 3e6 terms x 1001 energies, on
  them shuffled, and at the bands30 shape; the GGR and AGB main path's init
  and sweep walls, checked against an LTM sweep at npt 100; config 5); it
  and ``spectral`` need a checkout with K12's and K31's fused entries
  (``band_velocity_eigh``, ``transport_points_eigh``): on an older one take
  ``eigh`` for that route;
- ``--phases tai``: the Genz-Malik box pool (K14-K17): phases 22-24 (K16's
  entries and its step against the plain route, by events and by device
  time beside ``torch.topk``; the TAI chunk's three walls, its counts, K16's
  launches by entry and, from a profiled chunk, its device time a trip;
  the fixed-outer nest), over the PTR(npt=400) values of phase 7;
- ``--phases pools``: the interval pools on the IAI path (K5, K6): the cold
  chunk of phase 7 and the two warm calls of phase 10 under torch.profiler
  (device activity only), each kernel's launches and device time by name,
  K5's by entry and nest level (each launch through the checkout's library
  tagged in order and paired with the profiler's kernels of its name), and
  all kernel launches of each leg;
- ``--phases eigh``: the route around K12 and K31 (``eigh_route_phase``):
  at a GGR init chunk cuSOLVER's eigh, the copy of its U and K12, at the
  largest leaf trip of phase 32's graphene IAI transport solve eigh, K31
  and the integrand's call, each three ways (events, device time, host us),
  and the fused entries where the checkout has them (K12's also at the 1e6
  points of the flagship grid); the GGR and AGB init walls and the graphene
  IAI solve's wall with their eigh calls and launches;
- ``--phases warm_plain``: phase 10's first warm call (the 33 frequencies
  of phase 7's cold chunk) on the kernels and then on the plain versions of
  every kernel (``plain_kernels=True``), each with its wall, numevals,
  retcode and trips, and the largest difference of their values.

``--iai`` adds phases 6-8 (K3's call in phase 6a; the cold IAI chunk's
wall, evals, trips and syncs), and to ``rule_transport`` phases 22-24 for
the TAI leg's three walls and counts: the paths whose wrappers share the
host helpers of ``ops/cuda_lib.py`` and ``_device.py``. So two checkouts,
for example a commit and its parent unpacked with ``git archive``, compare
on one card in one call: run each in a process of its own, in turns
(parent, change, change, parent). The IAI phases (``iai``, ``pools``,
``warm_plain``, ``--iai``) need the fused leaf solve (``gk_leaf_dos_solve``),
which the smoke's phases 6-10 and 16-17 run: a checkout without it is
refused. The last line is a JSON object of the
numbers; with ``--out DIR`` a copy goes to ``DIR/ab_PHASES_LABEL.json`` (a
later run of the same phases and label replaces it).
"""
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def fourier(cs, np, torch, dev, h):
    from autobzcore_torch import FBZ, GGR, AutoPTR, DOSProblem, IntegralProblem, MixedParameters, load_bz
    from autobzcore_torch.dos import init as dos_init
    from autobzcore_torch.models import observables as obs
    from autobzcore_torch.parallel.sweep import sweep_solve

    out = cs.fourier_phases(np, torch, dev, h)
    bz = load_bz(FBZ(), np.eye(3))
    # phase 20's GGR init at the flagship, npt 100
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dos_init(DOSProblem(h, 0.5, bz), GGR(npt=cs.NPT))
    torch.cuda.synchronize()
    out["ggr_init_s"] = time.perf_counter() - t0
    # phase 32's transport ladder: AutoPTR up to npt 300 at 32 omegas, reltol 1e-3
    om32 = torch.as_tensor(np.linspace(*cs.WINDOW, cs.TR_AUTOPTR_OMEGAS), device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, conv, nev = sweep_solve(IntegralProblem(obs.transport_integrand(h, eta=cs.ETA), bz),
                                  AutoPTR(device=dev, **cs.TR_AUTOPTR_KW), MixedParameters(om32), reltol=1e-3)
    torch.cuda.synchronize()
    out["transport_ladder_s"] = time.perf_counter() - t0
    out["transport_ladder_numevals"] = int(nev.sum())
    torch.cuda.empty_cache()
    print(f"GGR init {out['ggr_init_s']:.4f} s; transport ladder {out['transport_ladder_s']:.3f} s, "
          f"numevals {out['transport_ladder_numevals']}, certified {int(conv.sum())}", flush=True)
    return out


def rule_transport(cs, np, torch, dev, h):
    k16_step_shim(cs, torch)
    return cs.rule_transport_phases(np, torch, dev, h)


def k24(cs, np, torch, dev, h):
    from autobzcore_torch import FBZ, load_bz
    from autobzcore_torch.models.tight_binding import tb_weyl

    t, b = cs.k24_phase(np, torch, dev, tb_weyl(2.0, device=dev), load_bz(FBZ(), np.eye(3)))
    return {"k24": dict(t, bound_ms=b[0])}


def iai(cs, np, torch, dev, h):
    cold, _ = cs.iai_phases(np, torch, dev, h)
    _, warm = cs.warm_phases(np, torch, dev, h, cold)
    _, block = cs.block_phases(np, torch, dev, h, cold, wall_runs=1)
    keys = ("wall", "trips", "syncs", "busy", "launches", "leaf_launches", "k3", "k4", "solve", "k5")
    return dict(k24(cs, np, torch, dev, h),
                cold=dict({k: cold.get(k) for k in keys}, numevals=int(cold["numevals"]),
                          lane_numevals=[int(n) for n in cold["ne"]]),
                warm=warm, block=block)


def selfenergy(cs, np, torch, dev, h):
    from autobzcore_torch import FBZ, load_bz
    from autobzcore_torch.models import observables as obs
    from autobzcore_torch.models import transport as tr

    bz = load_bz(FBZ(), np.eye(3))
    mu = tr.ElectronCountSolver(h, bz, cs.TR_NPT, pack=obs.spectral_velocity_pack(h, bz, cs.TR_NPT)).find_mu(
        1.0, cs.TR_BETA)
    return {"selfenergy": cs.lindhard_sigma_phases(np, torch, dev, h, mu)[1]}


def spectral(cs, np, torch, dev, h):
    k27_z_shim(cs, torch)
    return {"spectral": cs.slice12_phases(np, torch, dev, h, None)[1]}


def ltm(cs, np, torch, dev, h):
    _, numbers = cs.ltm_phases(np, torch, dev, h)
    numbers.pop("dos")
    return {"ltm": numbers}


def warm_plain(cs, np, torch, dev, h):
    from autobzcore_torch import FBZ, IntegralProblem, load_bz
    from autobzcore_torch.models.observables import dos_integrand

    prob = IntegralProblem(dos_integrand(h, cs.ETA), load_bz(FBZ(), np.eye(3)))
    oms = np.linspace(*cs.WINDOW, cs.IAI_OMEGAS)
    out, values = {}, {}
    for route, plain in (("kernels", False), ("plain", True)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sweep = cs.warm_iai_sweep(prob, cs.IAI_OMEGAS, plain)
        values[route] = sweep(oms)
        torch.cuda.synchronize()
        out[route] = {"wall": time.perf_counter() - t0, "numevals": int(sweep.numevals),
                      "retcode": bool(sweep.retcode), "trips": dict(sweep.stats.trips)}
        print(f"warm call 1 ({cs.IAI_OMEGAS} omegas) on the {route}: {out[route]}", flush=True)
    out["max_abs_d"] = float(np.max(np.abs(values["kernels"] - values["plain"])))
    print(f"warm call 1, kernels vs plain versions: numevals {out['kernels']['numevals']} vs "
          f"{out['plain']['numevals']}, max|d D| {out['max_abs_d']:.3e}", flush=True)
    return {"warm_plain": out}


def ggr(cs, np, torch, dev, h):
    from autobzcore_torch import FBZ, DOSProblem, load_bz
    from autobzcore_torch.dos import LTM
    from autobzcore_torch.dos import init as dos_init

    # the LTM sweep that phase 20 checks GGR against (phase 15's at npt 100)
    ltm = LTM(npt=cs.NPT)
    ws = np.linspace(*cs.WINDOW, cs.LTM_ENERGIES)
    ltm_dos = ltm.dos_sweep(dos_init(DOSProblem(h, 0.5, load_bz(FBZ(), np.eye(3))), ltm).cacheval, ws)
    torch.cuda.empty_cache()
    entries, numbers = cs.ggr_phases(np, torch, dev, h, ltm_dos)
    return {"ggr": numbers, "kernels": entries}


def eigh(cs, np, torch, dev, h):
    return {"eigh": cs.eigh_route_phase(np, torch, dev, h)}


def phase7_frequencies(cs, np, torch, dev, h):
    """Phase 7's frequencies, zone and PTR(npt=400) values, which phases
    22-24 read from the cold chunk's record."""
    from autobzcore_torch import FBZ, PTR, IntegralProblem, load_bz, solve
    from autobzcore_torch.models.observables import dos_integrand

    bz = load_bz(FBZ(), np.eye(3))
    oms = np.linspace(*cs.WINDOW, cs.IAI_OMEGAS)
    d_ptr = solve(IntegralProblem(dos_integrand(h, cs.ETA), bz, torch.as_tensor(oms, device=dev)),
                  PTR(npt=400)).u.cpu().numpy()
    torch.cuda.empty_cache()
    return {"oms": oms, "bz": bz, "d_ptr": d_ptr}


def k16_step_shim(cs, torch):
    """Phases 22-23 drive K16 through its start and step entries
    (``gm_pool_begin``, ``gm_pool_step``). A checkout from before them runs
    a trip as a select launch and an update launch: give its module the two
    entries made of those, and their plain route, a ``GMPool.clone`` that
    keeps the picks, and tell phase 23 that checkout's launches by entry."""
    import copy

    from autobzcore_torch.ops import genz_malik as tgm

    if hasattr(tgm, "gm_pool_step"):
        return

    def begin(totals, select):
        def run(pool, nb):
            totals(pool, nb)
            pool.idx, pool.cc, pool.hh = select(pool, nb)
        return run

    def step(update, select):
        def run(pool, nb, cval, cerr, csd):
            update(pool, nb, pool.idx, pool.cc, pool.hh, cval, cerr, csd)
            pool.idx, pool.cc, pool.hh = select(pool, nb)
        return run

    def clone(pool):
        out = copy.copy(pool)
        for k, v in vars(pool).items():
            if isinstance(v, torch.Tensor):
                setattr(out, k, v.clone())
        return out

    tgm.gm_pool_begin = begin(tgm.gm_pool_totals, tgm.gm_pool_select)
    tgm.gm_pool_begin_plain = begin(tgm.gm_pool_totals_plain, tgm.gm_pool_select_plain)
    tgm.gm_pool_step = step(tgm.gm_pool_update, tgm.gm_pool_select)
    tgm.gm_pool_step_plain = step(tgm.gm_pool_update_plain, tgm.gm_pool_select_plain)
    tgm.GMPool.clone = clone
    cs.k16_chunk_entries = lambda trips: {"select": trips, "update": trips, "totals": 1}
    print("K16 has no step entry in this checkout: phases 22-23 run its select and update as the start and "
          "the step", flush=True)


def k5_step_shim(cs, torch):
    """Phases 6c, 7, 9 and 16 drive K5 through its start, step and seed
    entries (``gk_pool_start``, ``gk_pool_step``, ``gk_pool_seed``, with the
    children as ``NodeChildren`` or ``ReducedChildren``). A checkout from
    before them runs a trip as a select, a rule reduction and an update
    launch: give its module the three entries made of those, with their
    plain route (its own seed entries, which take its calls as before, made
    to take the phases' too), the children's types, ``_empty_pool`` and a
    ``GKPool.clone`` that keeps the picks (a stopped lane's zeroed, one
    more launch a pick); count its totals as starts, its
    updates as steps and its selects and reductions beside them; and lift
    phase 7's bound on K5's launches a cold chunk, which that checkout's
    three launches a trip exceed."""
    import copy
    from typing import NamedTuple

    from autobzcore_torch.ops import adaptive as tad

    if hasattr(tad, "gk_pool_step"):
        return

    class NodeChildren(NamedTuple):
        fx: torch.Tensor
        counts: torch.Tensor
        half: torch.Tensor
        live: torch.Tensor
        wk: torch.Tensor
        wg: torch.Tensor

    class ReducedChildren(NamedTuple):
        val: torch.Tensor
        err: torch.Tensor
        l1: torch.Tensor
        count: torch.Tensor
        live: torch.Tensor = None

    def reduced(ch, L, reduce):
        if isinstance(ch, NodeChildren):
            out, live = reduce(ch.fx, ch.counts, ch.half, ch.wk, ch.wg), ch.live
        else:
            out, live = tuple(ch[:4]), ch.live
        return [o.contiguous() for o in (out if live is None else tad.scatter_lanes(L, live, *out))]

    def entries(select, update, totals, seed, reduce):
        def pick(pool, nb):
            # a stopped lane's picks are zero, as the start and step entries
            # leave them (this checkout's select leaves them unwritten)
            picks = select(pool, nb)  # the loop test first: it updates pool.active
            live = pool.active[:, None]
            pool.idx, pool.ca, pool.cb = (torch.where(live, t, torch.zeros((), dtype=t.dtype, device=t.device))
                                          for t in picks)

        def start(pool, nb, a0=None, b0=None, children=None, select=True):
            if children is not None:
                K = a0.shape[1]
                val, err, l1, count = reduced(children, pool.nlanes, reduce)
                for arr, v in ((pool.a, a0), (pool.b, b0), (pool.err, err), (pool.l1, l1), (pool.val, val)):
                    arr.zero_()
                    arr[:, :K] = v
                pool.n.fill_(K)
                pool.evals.copy_(count)
                pool.active.fill_(True)
            totals(pool)
            if select:
                pick(pool, nb)

        def step(pool, nb, children):
            update(pool, nb, pool.idx, pool.ca, pool.cb, *reduced(children, pool.nlanes, reduce))
            pick(pool, nb)

        def seed_chunk(pool, start, children, *args, partition=None, select=False):
            if not isinstance(children, (NodeChildren, ReducedChildren)):  # the checkout's own call
                return seed(pool, start, children, *args)
            n0, seeding, nb = args
            if partition is not None:
                pool.a.copy_(partition[0])
                pool.b.copy_(partition[1])
                for t in (pool.err, pool.l1, pool.val, pool.n, pool.evals):
                    t.zero_()
                pool.active.fill_(True)
            val, err, l1, count = reduced(children, pool.nlanes, reduce)
            C = err.shape[1]
            seed(pool, start, pool.a[:, start:start + C].contiguous(), pool.b[:, start:start + C].contiguous(),
                 val, err, l1, count, n0, seeding)
            if select:
                pick(pool, nb)

        return start, step, seed_chunk

    def empty_pool(L, cap, vshape, dtype, dev, atol, rtol, maxiters):
        e = lambda *shape, dt=torch.float64: torch.empty(shape, dtype=dt, device=dev)  # noqa: E731
        return tad.GKPool(a=e(L, cap), b=e(L, cap), err=e(L, cap), l1=e(L, cap), val=e(L, cap, *vshape, dt=dtype),
                          n=e(L, dt=torch.int64), evals=e(L), atol=atol.contiguous(), rtol=float(rtol),
                          max_evals=tad._as_eval_budget(maxiters), active=e(L, dt=torch.bool))

    def clone(pool):
        out = copy.copy(pool)
        for k, v in vars(pool).items():
            if isinstance(v, torch.Tensor):
                setattr(out, k, v.clone())
        return out

    def launches(reset=False):
        c = tad.gk_pool_launches
        if reset:
            for key in c:
                c[key] = 0
            tad.gk_rule_reduce.launches = 0
        return {"gk_pool_start": c["totals"], "gk_pool_step": c["update"], "gk_pool_seed": c["seed"],
                "gk_pool_select": c["select"], "gk_rule_reduce": tad.gk_rule_reduce.launches}

    tad.NodeChildren, tad.ReducedChildren = NodeChildren, ReducedChildren
    tad.gk_pool_start, tad.gk_pool_step, tad.gk_pool_seed = entries(
        tad.gk_pool_select, tad.gk_pool_update, tad.gk_pool_totals, tad.gk_pool_seed, tad.gk_rule_reduce)
    tad.gk_pool_start_plain, tad.gk_pool_step_plain, tad.gk_pool_seed_plain = entries(
        tad.gk_pool_select_plain, tad.gk_pool_update_plain, tad.gk_pool_totals_plain, tad.gk_pool_seed_plain,
        tad.gk_rule_reduce_plain)
    tad._empty_pool = empty_pool
    tad.GKPool.clone = clone
    cs.k5_launches = launches
    cs.K5_COLD_MAX = float("inf")
    print("K5 has no start and step entries in this checkout: phases 6c, 9 and 16 run its select, reduction "
          "and update as the start, step and seed; phase 7 counts its totals as starts and its updates as steps",
          flush=True)


def k27_z_shim(cs, torch):
    """Phases 31-32 hand K27's matrix mode and matrix points the lanes' z
    of Z = z I (``spectral_weighted_sum(H, w, z, scale)``,
    ``spectral_points(H, z)`` with z (W,), (N,) or ()). A checkout from
    before that form takes only Z matrices: give its four functions (and
    their plain versions) z as z I, keeping their launch counts."""
    from autobzcore_torch.models import observables as obs

    try:
        obs.spectral_points(torch.zeros((1, 1, 1), dtype=torch.complex128), torch.zeros((), dtype=torch.complex128))
        return
    except ValueError:
        pass

    class ZForm:
        def __init__(self, fn, zarg):
            self.fn, self.zarg, self.__name__ = fn, zarg, fn.__name__

        def __call__(self, *args, **kw):
            args = list(args)
            H, Z = args[0], args[self.zarg]
            if Z.ndim <= 1:
                eye = torch.eye(H.shape[-1], dtype=Z.dtype, device=Z.device)
                args[self.zarg] = (Z[..., None, None] * eye).contiguous()
            return self.fn(*args, **kw)

        launches = property(lambda self: self.fn.launches, lambda self, v: setattr(self.fn, "launches", v))

    for name, zarg in (("spectral_points", 1), ("spectral_points_plain", 1), ("spectral_weighted_sum", 2),
                       ("spectral_weighted_sum_plain", 2)):
        setattr(obs, name, ZForm(getattr(obs, name), zarg))
    print("K27's matrix mode takes no z in this checkout: phases 31-32 hand it Z = z I", flush=True)


def tai(cs, np, torch, dev, h):
    k16_step_shim(cs, torch)
    entries, numbers = cs.cubature_phases(np, torch, dev, h, phase7_frequencies(cs, np, torch, dev, h))
    return {"tai": numbers, "kernels": entries}


def device_rows(torch, fn):
    """``fn()`` under torch.profiler with device activity only: its wall and,
    per kernel name, (launches, device milliseconds)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = {e.key: (e.count, e.self_device_time_total / 1e3) for e in prof.key_averages()
            if getattr(e, "device_type", None) == DeviceType.CUDA and e.self_device_time_total > 0}
    return wall, rows


POOL_KERNELS = ("gk_pool_select", "gk_pool_update", "gk_rule_reduce", "gk_pool_seed", "gk_pool_start",
                "gk_pool_step", "gk_coarsen")


def k5_entry(name, args):
    """The entry of one call of a K5 launcher of either checkout: the launch
    function's name and its arguments (``args[-2]`` is the update flag of
    the old update launcher, the select flag of a start or seed, the form of
    the children of a step), or None for another function."""
    flag = args[-2] if len(args) > 1 else 0
    return {"gk_pool_select_launch": lambda: "select",
            "gk_pool_update_launch": lambda: "update" if flag else "totals",
            "gk_rule_reduce_launch": lambda: "reduce",
            "gk_pool_seed_launch": lambda: "seed+select" if flag and "start" in _LAUNCHERS else "seed",
            "gk_pool_start_launch": lambda: "start+select" if flag else "start",
            "gk_pool_step_launch": lambda: {0: "step(reduced)", 1: "step(nodes)"}.get(flag, "step")}.get(
                name, lambda: None)()


_LAUNCHERS = set()


class K5Tags:
    """Every K5 launch of a leg in launch order, each with its entry and the
    nest level whose pool it serves (3 outermost, 1 the leaf), so the
    profiler's kernels of one name split by entry and level in order."""

    def __init__(self):
        from autobzcore_torch.algorithms import nested
        from autobzcore_torch.ops import cuda_lib

        self.tags, self.levels = [], []
        lib = cuda_lib.load_kernels()
        for name in ("gk_pool_select_launch", "gk_pool_update_launch", "gk_rule_reduce_launch",
                     "gk_pool_seed_launch", "gk_pool_start_launch", "gk_pool_step_launch"):
            try:
                fn = getattr(lib, name)
            except AttributeError:
                continue
            _LAUNCHERS.add(name.split("_")[2])
            setattr(lib, name, self._wrap(name, fn))
        lanes = nested.gk_adaptive_lanes

        def tagged(*args, **kw):
            self.levels.append(kw.get("level", 0))
            try:
                return lanes(*args, **kw)
            finally:
                self.levels.pop()

        nested.gk_adaptive_lanes = tagged

    def _wrap(self, name, fn):
        stem = name[:-len("_launch")]

        def call(*args):
            self.tags.append((stem, k5_entry(name, args), self.levels[-1] if self.levels else 0))
            return fn(*args)

        return call

    def split(self, events):
        """Launches and device ms by (entry, level) from the leg's device
        events (name, start, us) in start order; None for a kernel name whose
        events do not pair one to one with the calls."""
        out, unmatched = {}, []
        for stem in sorted({t[0] for t in self.tags}):
            calls = [t for t in self.tags if t[0] == stem]
            evs = [e for e in events if stem in e[0]]
            if len(evs) != len(calls):
                unmatched.append(f"{stem}: {len(calls)} calls, {len(evs)} kernels")
                continue
            for (_, entry, level), (_, _, us) in zip(calls, evs):
                row = out.setdefault(f"{entry}@L{level}", [0, 0.0])
                row[0] += 1
                row[1] += us / 1e3
        self.tags.clear()
        return {k: {"launches": n, "device_ms": ms, "ms_a_launch": ms / n} for k, (n, ms) in sorted(out.items())}, \
            unmatched


def pools(cs, np, torch, dev, h):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    from autobzcore_torch import FBZ, IAI, IntegralProblem, load_bz
    from autobzcore_torch.models.observables import dos_integrand
    from autobzcore_torch.parallel.sweep import SweepSolver

    prob = IntegralProblem(dos_integrand(h, cs.ETA), load_bz(FBZ(), np.eye(3)))
    oms = np.linspace(*cs.WINDOW, cs.IAI_OMEGAS)
    warm = cs.warm_iai_sweep(prob, cs.IAI_OMEGAS)
    tags = K5Tags()
    runs = {"cold": lambda: SweepSolver(prob, IAI(inner_cap=64, inner_nbisect=4), abstol=cs.IAI_ABSTOL,
                                        chunk=cs.IAI_OMEGAS, scan=True)(oms),
            "warm1": lambda: warm(oms), "warm2": lambda: warm((oms[1:] + oms[:-1]) / 2)}
    out = {}
    for name, fn in runs.items():
        tags.tags.clear()
        torch.cuda.synchronize()
        with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rows = {e.key: (e.count, e.self_device_time_total / 1e3) for e in prof.key_averages()
                if getattr(e, "device_type", None) == DeviceType.CUDA and e.self_device_time_total > 0}
        events = sorted(((e.name, e.time_range.start, e.time_range.elapsed_us()) for e in prof.events()
                         if getattr(e, "device_type", None) == DeviceType.CUDA), key=lambda e: e[1])
        busy = sum(ms for _, ms in rows.values())
        kernels = {k: v for k, v in rows.items() if not k.startswith(("Memcpy", "Memset"))}
        per = {}
        for key in POOL_KERNELS:
            hits = [(n, ms) for k, (n, ms) in rows.items() if key in k]
            n, ms = sum(x[0] for x in hits), sum(x[1] for x in hits)
            if n:
                per[key] = {"launches": n, "device_ms": ms, "ms_a_launch": ms / n}
        by_entry, unmatched = tags.split(events)
        out[name] = {"wall": wall, "device_ms": busy, "kernels": per, "k5_by_entry": by_entry,
                     "k5_unmatched": unmatched, "all_kernel_launches": sum(n for n, _ in kernels.values()),
                     "copies": sum(n for k, (n, _) in rows.items() if k not in kernels)}
        print(f"{name} IAI under the profiler: wall {wall:.3f} s, device {busy:.1f} ms, "
              f"{out[name]['all_kernel_launches']} kernel launches ({out[name]['copies']} copies); " + "; ".join(
                  f"{k} x{v['launches']} {v['device_ms']:.3f} ms ({v['ms_a_launch']:.5f} a launch)"
                  for k, v in per.items()), flush=True)
        print(f"{name} K5 by entry and level: " + "; ".join(
            f"{k} x{v['launches']} {v['device_ms']:.3f} ms ({v['ms_a_launch']:.5f})" for k, v in by_entry.items())
            + (f"; unmatched {unmatched}" if unmatched else ""), flush=True)
        torch.cuda.empty_cache()
    return {"pools": out}


PHASES = {"fourier": fourier, "rule_transport": rule_transport, "iai": iai, "k24": k24, "warm_plain": warm_plain,
          "selfenergy": selfenergy, "spectral": spectral, "ltm": ltm, "ggr": ggr, "tai": tai, "pools": pools,
          "eigh": eigh}


def compare(tree, label, phases, iai):
    sys.path.insert(0, str(Path(tree).resolve()))
    import numpy as np
    import torch

    from autobzcore_torch.models import observables as obs
    from autobzcore_torch.models.tight_binding import flagship_series
    from autobzcore_torch.ops import cuda_lib

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    if not str(Path(cuda_lib.__file__).resolve()).startswith(str(Path(tree).resolve())):
        sys.exit(f"imported {cuda_lib.__file__}, not the package of {tree}")
    cs = load_smoke()
    if (phases in ("iai", "pools", "warm_plain") or iai) and not hasattr(obs, "gk_leaf_dos_solve"):
        sys.exit(f"{tree} has no fused leaf solve (gk_leaf_dos_solve), which phases 6-10 and 16-17 run")
    k5_step_shim(cs, torch)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    cuda_lib.load_kernels()
    print(f"{label}: kernels ready in {time.perf_counter() - t0:.1f} s ({cuda_lib.LIBRARY})", flush=True)
    dev = torch.device("cuda", 0)
    h = flagship_series(device=dev)
    out = {"label": label, "tree": str(tree), "phases": phases, "card": smi}
    out.update(PHASES[phases](cs, np, torch, dev, h))
    if iai and phases != "iai":
        cold, _ = cs.iai_phases(np, torch, dev, h)
        out.update(iai_wall=cold["wall"], iai_numevals=int(cold["numevals"]),
                   iai_lane_numevals=[int(n) for n in cold["ne"]], iai_trips=cold["trips"],
                   iai_syncs=cold["syncs"], k3=cold.get("k3"))
        if phases == "rule_transport":
            _, tai = cs.cubature_phases(np, torch, dev, h, cold)
            tai.pop("rule")
            out.update(tai)
    return out


def main():
    argv = sys.argv[1:]
    out_dir, phases = None, None
    for flag in ("--out", "--phases"):
        if flag in argv:
            i = argv.index(flag)
            if i + 1 >= len(argv):
                sys.exit(__doc__)
            if flag == "--out":
                out_dir = Path(argv[i + 1])
            else:
                phases = argv[i + 1]
            del argv[i:i + 2]
    args = [a for a in argv if not a.startswith("--")]
    if len(args) != 2 or phases not in PHASES:
        sys.exit(__doc__)
    out = compare(args[0], args[1], phases, "--iai" in argv)
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        (out_dir / f"ab_{phases}_{args[1]}.json").write_text(json.dumps(out, indent=1, default=str))
    print(json.dumps(out, default=str), flush=True)


if __name__ == "__main__":
    main()
