"""How the softmax probe kernel's sum order moves its agreement with the
plain version, emulated on the CPU in numpy.

``chip_smoke.py`` holds the kernel's bf16 output equal to the plain
version's at a share of at least ``PROBE_MATCH_MIN`` of the entries, and
apart from it where the plain f32 and bf16 outputs differ.  Both depend on
the order of the kernel's f32 sums, which the Hopper design changed: 128-key
tiles, the ragged last tile first, each thread summing l over its 32 columns
of a tile.  This emulates the order of the mma.sync design it replaced
(64-key tiles in order, 16 columns a thread) and of the new one on the
probe's ``[48, 6, 1568, 64]`` inputs (a few (batch, head) slices), each
product's 16-term k-steps summed exactly and rounded to f32, then added in
f32 in the kernel's order, against the plain version modelled as exact sums
rounded to f32 once; and asserts that the new order keeps both shares above
the limit.  ``SHARES`` records the readings for PERF.md.
"""

from __future__ import annotations

import numpy as np
import pytest

PROBE_MATCH_MIN = 0.99  # chip_smoke.PROBE_MATCH_MIN
N, D, SLICES = 1568, 64, 3

f32 = np.float32


def bf16(x):
    """Round f32 to bf16 (to nearest, ties to even), kept as f32."""
    u = np.asarray(x, f32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(f32)


def chunked(a, b, order):
    """a [r, K] @ b [K, c] as the tensor cores sum it: each 16-term k-step
    exactly (f64), rounded to f32, the k-steps added in f32 in ``order``."""
    acc = np.zeros((a.shape[0], b.shape[1]), f32)
    for k0 in order:
        acc = (acc + (a[:, k0:k0 + 16].astype(np.float64)
                      @ b[k0:k0 + 16].astype(np.float64)).astype(f32)).astype(f32)
    return acc


def key_steps(tile, reverse):
    """The k-step starts over N keys: tiles of ``tile`` keys, in order or the
    last (ragged) tile first, 16 keys a step within each."""
    tiles = list(range(0, N, tile))
    if reverse:
        tiles = tiles[::-1]
    return [t + k for t in tiles for k in range(0, tile, 16) if t + k < N]


def thread_sums(p, tile, reverse):
    """l as the kernel sums it: thread t of a row's four takes columns
    8 j + 2 t (+ 1) of each tile in register order, one f32 add each, tiles
    in the kernel's order; then the quad's shuffles ((l0 + l1) + (l2 + l3))."""
    rows = p.shape[0]
    part = np.zeros((rows, 4), f32)
    starts = list(range(0, N, tile))
    for t0 in (starts[::-1] if reverse else starts):
        for j in range(tile // 8):
            for e in range(2):
                cols = t0 + 8 * j + 2 * np.arange(4) + e
                ok = cols < N
                vals = np.where(ok, p[:, np.minimum(cols, N - 1)], f32(0))
                part = (part + vals).astype(f32)
    return ((part[:, 0] + part[:, 1]).astype(f32) + (part[:, 2] + part[:, 3])).astype(f32)


def forward(q, k, v, bf16_scores, design):
    """The probe's O for one (batch, head): ``design`` "plain" (exact sums
    rounded once), "mma_sync" (64-key tiles in order) or "hopper" (128-key
    tiles, the last first)."""
    if design == "plain":
        s = (q.astype(np.float64) @ k.T.astype(np.float64)).astype(f32)
    else:
        s = chunked(q, k.T, range(0, D, 16))
    if bf16_scores:
        s = bf16(s)
    m = s.max(axis=1, keepdims=True)
    if bf16_scores:
        p = bf16(np.exp(bf16(s - m).astype(np.float64)).astype(f32))
    else:
        p = np.exp((s - m).astype(np.float64)).astype(f32)
    pb = bf16(p)
    if design == "plain":
        l = p.astype(np.float64).sum(axis=1).astype(f32)
        acc = (pb.astype(np.float64) @ v.astype(np.float64)).astype(f32)
    else:
        tile, reverse = (64, False) if design == "mma_sync" else (128, True)
        l = thread_sums(p, tile, reverse)
        acc = chunked(pb, v, key_steps(tile, reverse))
    return bf16((acc / l[:, None]).astype(f32))


def shares(design):
    """(equal share f32, equal share bf16, apart where plain apart) of
    ``design`` against the plain version over SLICES (batch, head) slices of
    the probe's inputs (q ~ N(0, 1) x 0.125, k, v ~ N(0, 1), bf16)."""
    rng = np.random.default_rng(0)
    eq = {False: [], True: []}
    apart, plain_apart = [], []
    for _ in range(SLICES):
        q, k, v = (bf16(rng.standard_normal((N, D), dtype=f32) * sc) for sc in (0.125, 1, 1))
        outs = {sd: forward(q, k, v, sd, design) for sd in (False, True)}
        refs = {sd: forward(q, k, v, sd, "plain") for sd in (False, True)}
        for sd in (False, True):
            eq[sd].append(outs[sd] == refs[sd])
        diff = refs[False] != refs[True]
        plain_apart.append(diff)
        apart.append((outs[False] != outs[True]) & diff)
    eq_f32, eq_bf16 = (float(np.mean(np.concatenate(eq[sd]))) for sd in (False, True))
    follows = np.concatenate(apart).sum() / np.concatenate(plain_apart).sum()
    return eq_f32, eq_bf16, float(follows)


# readings of this emulation (3 slices of [1568, 64]): (f32, bf16, apart)
SHARES = {"mma_sync": (0.99872, 0.99964, 0.99975), "hopper": (0.99867, 0.99963, 0.99975)}


@pytest.mark.parametrize("design", ["mma_sync", "hopper"])
def test_probe_sum_order_keeps_the_match_share(design):
    got = shares(design)
    print(f"{design}: equal share f32 {got[0]:.5f}, bf16 {got[1]:.5f}; "
          f"apart where plain apart {got[2]:.5f}")
    assert got == pytest.approx(SHARES[design], abs=1e-5)
    assert min(got) >= PROBE_MATCH_MIN
