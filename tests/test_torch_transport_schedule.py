"""K19's schedule (``csrc/transport_gamma.cu``) emulated in numpy on the
CPU, against the port's plain version and the JAX package.

The emulation makes the sums in the kernel's order: a chunk of 512 points
a partial row; inside it the term axis (k, n, q) in steps of 8, where the
quad thread t holds depth columns t and t + 4 and its columns are the
terms of its own points t + 4 r of each run of 4 R points (R = 2 for odd m
<= 3, the terms walked across point boundaries; above three bands one
point a run, its m^2 terms padded to an even count); 16 pairs a tile (the
product's rows) by Wmat's first 8 columns, zero-padded; at d = 3 the
ninth column summed per quad thread, then over the quad as (t0 + t1) +
(t2 + t3); per (pair, point, band) only 1 / (x^2 + g^2), the factor (g1 /
pi)(g2 / pi) applied to each pair's partial row; the partial rows summed
in chunk order, then scaled. The products of one step are a numpy matmul,
not the tensor cores' order, so the agreement is 1e-12 relative to the
largest value, the kernel's own tolerance against its plain version."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import autobzcore_tpu as J
from autobzcore_torch.models import observables as tobs
from autobzcore_tpu.models import observables as jobs
from autobzcore_tpu.models import transport as jtr

CHUNK, STAGE = 512, 16


def k19_schedule(e, Wmat, y1, g1, y2, g2, scale):
    """G (B, d^2) by K19's schedule from numpy arrays."""
    K, m = e.shape
    DD = Wmat.shape[1]
    CW = min(DD, 8)
    mm = m * m
    R = 2 if (m <= 3 and m % 2) else 1
    TP = mm if m <= 3 else mm + (mm & 1)  # a point's depth columns in a thread's run
    PTS, S = 4 * R, R * TP // 2
    B = y1.shape[0]
    Bp = -(-B // 16) * 16
    pad = lambda a, v: np.concatenate([a, np.full(Bp - B, v)])  # noqa: E731
    y1p, g1p, y2p, g2p = pad(y1, 0.0), pad(g1, 1.0), pad(y2, 0.0), pad(g2, 1.0)
    factor = (g1p / np.pi) * (g2p / np.pi)

    def inv(y, g, en):
        x = y - en
        return 1.0 / (x * x + g * g)

    W4 = Wmat.reshape(K, m, m, DD)
    nchunks = -(-K // CHUNK)
    partials = np.zeros((nchunks, Bp, DD))
    for ch in range(nchunks):
        kc = ch * CHUNK
        end = min(kc + CHUNK, K)
        stop = kc + -(-(end - kc) // STAGE) * STAGE if m <= 3 else end
        acc, s8 = np.zeros((Bp, 8)), np.zeros((4, Bp))
        for run0 in range(kc, stop, PTS):
            for s in range(S):
                A, Bm, w8 = np.zeros((Bp, 8)), np.zeros((8, 8)), np.zeros(8)
                for t in range(4):
                    for j in range(2):
                        r, v = divmod(2 * s + j, TP)
                        k = run0 + t + 4 * r
                        if v >= mm or k >= K:
                            continue
                        n, q = divmod(v, m)
                        A[:, t + 4 * j] = inv(y1p, g1p, e[k, n]) * inv(y2p, g2p, e[k, q])
                        Bm[t + 4 * j, :CW] = W4[k, n, q, :CW]
                        if DD == 9:
                            w8[t + 4 * j] = W4[k, n, q, 8]
                acc += A @ Bm
                for t in range(4):
                    s8[t] = (s8[t] + A[:, t] * w8[t]) + A[:, t + 4] * w8[t + 4]
        partials[ch, :, :CW] = acc[:, :CW] * factor[:, None]
        if DD == 9:
            partials[ch, :, 8] = ((s8[0] + s8[1]) + (s8[2] + s8[3])) * factor
    out = partials[0].copy() if nchunks else np.zeros((Bp, DD))
    for ch in range(1, nchunks):
        out = out + partials[ch]
    return (scale * out)[:B]


def rel(got, want):
    return float(np.max(np.abs(np.asarray(got) - np.asarray(want))) / np.max(np.abs(np.asarray(want))))


def random_pack(rng, K, m, d):
    e = np.sort(rng.normal(size=(K, m)), axis=1)
    Wmat = rng.normal(size=(K * m * m, d * d))
    return e, Wmat


@pytest.mark.parametrize("m", [1, 2, 3, 5])
@pytest.mark.parametrize("d", [1, 2, 3])
def test_k19_schedule_matches_plain_and_jax(m, d):
    """Equal frequencies (TransportSolver's chunk), unequal node pairs and a
    scalar self-energy (the kinetic integrand), at ragged pair and point
    counts: two chunks, the second ending inside a stage; 13 and 9 pairs,
    part of one 16-pair tile."""
    rng = np.random.default_rng(140 + 10 * m + d)
    K, scale, eta, beta, mu = 601, 0.37, 0.2, 4.0, 0.1
    e, Wmat = random_pack(rng, K, m, d)
    et, Wt = torch.as_tensor(e), torch.as_tensor(Wmat)
    jpack = jobs.SpectralPack(jnp.asarray(e), jnp.asarray(Wmat), scale, None, np.ones(K), d, 1)

    # equal frequencies: 13 omegas (part of a 16-pair tile)
    om = np.linspace(-1.5, 1.5, 13)
    g = np.full_like(om, eta)
    got = k19_schedule(e, Wmat, om, g, om, g, scale)
    omt, gt = torch.as_tensor(om), torch.as_tensor(g)
    assert rel(got, tobs.transport_gamma_plain(et, Wt, omt, gt, omt, gt, scale).numpy()) <= 1e-12
    ts = np.asarray(jobs.TransportSolver(None, None, None, eta, pack=jpack)(om)).reshape(-1, d * d)
    assert rel(got, ts) <= 1e-12

    # node pairs (w, w + Omega) of the kinetic integrand, without and with a self-energy
    w = rng.uniform(-0.8, 0.8, 9)
    Om = rng.uniform(0.0, 1.0, 9)
    bz = J.load_bz(J.FBZ(), np.eye(d))

    def sigma(x):
        return 0.05 * x - 1j * (eta + 0.2 * x * x)

    for self_energy in (None, sigma):
        kc = jtr.KineticCoefficientSolver(None, bz, None, eta, beta, mu=mu, self_energy=self_energy, pack=jpack)
        want = np.stack([np.asarray(kc._integrand(jnp.asarray(wi), jnp.asarray(Oi))).reshape(d * d)
                         / float(jtr.fermi_window(wi, Oi, beta, mu)) for wi, Oi in zip(w, Om)])
        x2 = w + Om
        if self_energy is None:
            y1, g1, y2, g2 = w, np.full_like(w, eta), x2, np.full_like(w, eta)
        else:
            s1, s2 = sigma(w), sigma(x2)
            y1, g1, y2, g2 = w - s1.real, -s1.imag, x2 - s2.real, -s2.imag
        got = k19_schedule(e, Wmat, y1, g1, y2, g2, scale)
        plain = tobs.transport_gamma_plain(et, Wt, *(torch.as_tensor(a) for a in (y1, g1, y2, g2)), scale)
        assert rel(got, plain.numpy()) <= 1e-12
        assert rel(got, want) <= 1e-12


@pytest.mark.parametrize("B", [1, 9, 17])
def test_k19_schedule_pairs_do_not_depend_on_their_launch(B):
    """A pair's value by the schedule is the same bits alone, in any row of
    a larger launch's tiles and in any order of the launch."""
    rng = np.random.default_rng(150 + B)
    e, Wmat = random_pack(rng, 40, 3, 3)
    y1, y2 = rng.uniform(-1, 1, B), rng.uniform(-1, 1, B)
    g1, g2 = rng.uniform(0.05, 0.3, B), rng.uniform(0.05, 0.3, B)
    full = k19_schedule(e, Wmat, y1, g1, y2, g2, 1.0)
    perm = rng.permutation(B)
    assert np.array_equal(k19_schedule(e, Wmat, y1[perm], g1[perm], y2[perm], g2[perm], 1.0), full[perm])
    i = B - 1
    assert np.array_equal(k19_schedule(e, Wmat, y1[i:], g1[i:], y2[i:], g2[i:], 1.0), full[i:])
