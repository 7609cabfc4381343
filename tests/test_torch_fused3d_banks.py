"""A model of the shared-memory banks of B3's and B4's tensor-core H/W
kernels (csrc/fused3d.cu: TcPlane, fused3d_hw_forward_tc,
fused3d_hw_inverse_tc) at the splits they are built for.

The model repeats the kernels' address arithmetic: the plane's column
permutation c ^ ((c >> 2) & 4) ^ 4 rot(r), rot(r) = (r / HB + r % HB) % 4,
the Nyquist row of tc_nyquist_offset, and each step's vectors as the
kernels number them; bf16_mma.cuh's dft_tile gives lane (g, t) vectors
g and g + 8 of a tile and elements / outputs t + 4 e + 8 ks. An 8-byte
access is served a half-warp at a time, 16 lanes over 16 bank pairs, so a
step is free of conflicts when in every half-warp of every load and store
no two lanes hit one bank pair at two addresses. It also holds the two
steps that run in place to their tiles: each tile writes only cells that
it read (or spare rows no other tile reads). The card tests and
chip_smoke.py hold the kernels themselves to their plain versions.
"""

import pytest

# the splits (HA, HB) the tensor-core H/W kernels are built for
SPLITS = [(8, 8), (8, 6), (13, 6), (7, 12)]


def rot(r, hb):
    return (r // hb + r % hb) & 3


def at(r, c, hb):
    return r * 64 + (c ^ ((c >> 2) & 4) ^ (rot(r, hb) << 2))


def nyquist_offset(ha, hb):
    target = ha // 2 % 4 if ha % 2 == 0 else ((ha - 1) // 2 + hb // 2) % 4
    i = (target - ha) % 4
    return 4 if i == 0 else i


def step_size(r):
    return 8 if r <= 8 else 16


def accesses(size, r, nvec, ld, st):
    """Each warp instruction of a DFT step of step size ``size`` on nvec
    vectors: a list of 32 addresses (None for a lane that does not
    access), for every cell that ld(m, j) / st(m, k) name."""
    for m0 in range(0, nvec, 16):
        for ks in range(size // 8):
            for e in range(2):
                for half in range(2):
                    lanes = [ld(m0 + (ln >> 2) + 8 * half, ks * 8 + (ln & 3) + 4 * e)
                             if ks * 8 + (ln & 3) + 4 * e < r else [] for ln in range(32)]
                    for q in range(max(len(a) for a in lanes)):
                        yield [a[q] if q < len(a) else None for a in lanes]
        for nt in range(size // 4):
            for half in range(2):
                lanes = [st(m0 + (ln >> 2) + 8 * half, nt * 4 + (ln & 3))
                         if nt * 4 + (ln & 3) < r else [] for ln in range(32)]
                for q in range(max(len(a) for a in lanes)):
                    yield [a[q] if q < len(a) else None for a in lanes]


def worst_conflict(addrs):
    worst = 1
    for h in range(2):
        slots = {}
        for a in addrs[16 * h:16 * h + 16]:
            if a is not None:
                slots.setdefault(a % 16, set()).add(a)
        worst = max([worst] + [len(v) for v in slots.values()])
    return worst


def forward_steps(ha, hb):
    h, nbh = ha * hb, ha * hb // 2 + 1

    def brow(k):
        return (k % ha) * hb + k // ha

    def w1(m):
        k, s, j2 = m >> 4, (m >> 3) & 1, m & 7
        ra, rb = brow(k), brow(0 if k == 0 else h - k)
        dst = ra if s == 0 else h if k == 0 else h + 1 if 2 * k == h else rb
        return ra, rb, dst, j2

    return {
        "h1": (step_size(ha), ha, hb * 64,
               lambda m, j1: [at(j1 * hb + (m >> 6), m & 63, hb)],
               lambda m, m1: [at(m1 * hb + (m >> 6), m & 63, hb)]),
        "h2": (step_size(hb), hb, ha * 64,
               lambda m, j2: [at((m >> 6) * hb + j2, m & 63, hb)],
               lambda m, m2: [at((m >> 6) * hb + m2, m & 63, hb)]),
        "w1": (8, 8, nbh * 16,
               lambda m, j1: [at(w1(m)[0], 8 * j1 + w1(m)[3], hb),
                              at(w1(m)[1], 8 * j1 + w1(m)[3], hb)],
               lambda m, m1: [at(w1(m)[2], 8 * m1 + w1(m)[3], hb)]),
        "w2": (8, 8, 2 * nbh * 8, lambda m, j2: [at(m >> 3, 8 * (m & 7) + j2, hb)],
               lambda m, m2: []),
    }, w1


def inverse_steps(ha, hb):
    h, nbh = ha * hb, ha * hb // 2 + 1
    nyq = h + nyquist_offset(ha, hb)

    def vrow(v):
        return nyq if v == h + 1 else v

    def partner(j):
        return h if j == 0 else nyq if 2 * j == h else h - j

    def h1(m):
        q, col = m >> 7, ((m >> 4) & 7) * 8 + (m & 7)
        return (q if m & 8 == 0 else hb // 2 if q == 0 else hb - q), col

    return {
        "w1": (8, 8, 2 * nbh * 8, lambda m, j1: [at(vrow(m >> 3), 8 * j1 + (m & 7), hb)],
               lambda m, m1: [at(vrow(m >> 3), 8 * m1 + (m & 7), hb)]),
        "w2": (8, 8, 2 * nbh * 8, lambda m, j2: [at(vrow(m >> 3), 8 * (m & 7) + j2, hb)],
               lambda m, m2: [at(vrow(m >> 3), (m & 7) + 8 * m2, hb)]),
        "h1": (step_size(ha), ha, hb * 64,
               lambda m, j1: [at(j1 * hb + h1(m)[0], h1(m)[1], hb),
                              at(partner(j1 * hb + h1(m)[0]), h1(m)[1], hb)],
               lambda m, m1: [at(m1 * hb + h1(m)[0], h1(m)[1], hb)]),
        "h2": (step_size(hb), hb, ha * 64,
               lambda m, j2: [at((m >> 6) * hb + j2, m & 63, hb)], lambda m, m2: []),
    }, h1, partner


@pytest.mark.parametrize("direction", ["forward", "inverse"])
@pytest.mark.parametrize("ha,hb", SPLITS)
def test_tc_hw_steps_free_of_bank_conflicts(ha, hb, direction):
    """Every load and store of every step of the tensor-core H/W kernels
    at a built split meets no bank conflict."""
    steps = (forward_steps if direction == "forward" else inverse_steps)(ha, hb)[0]
    for name, (size, r, nvec, ld, st) in steps.items():
        worst = max(worst_conflict(a) for a in accesses(size, r, nvec, ld, st))
        assert worst == 1, f"{direction} {name} at ({ha}, {hb}): {worst}-way conflict"


@pytest.mark.parametrize("ha,hb", SPLITS)
def test_tc_hw_in_place_steps_write_what_they_read(ha, hb):
    """The forward's first W step and the inverse's first H step run in
    place: each tile writes only cells it read (the forward also the spare
    rows Hw, Hw + 1 of the second slab's k = 0 and Hw / 2), and together
    they write every one-sided row (forward) or every V index (inverse)
    once."""
    h, nbh = ha * hb, ha * hb // 2 + 1
    _, w1 = forward_steps(ha, hb)
    dests = set()
    for tile in range(nbh):
        reads, writes = set(), set()
        for v in range(16):
            ra, rb, dst, j2 = w1(tile * 16 + v)
            for j in range(8):
                reads |= {(ra, 8 * j + j2), (rb, 8 * j + j2)}
                writes.add((dst, 8 * j + j2))
            dests.add(dst)
        assert all(r >= h for r, _ in writes - reads)
    assert len(dests) == 2 * nbh
    _, h1, partner = inverse_steps(ha, hb)
    written = set()
    for tile in range(hb * 4):
        reads, writes = set(), set()
        for v in range(16):
            j2, col = h1(tile * 16 + v)
            for j1 in range(ha):
                j = j1 * hb + j2
                reads |= {(j, col), (partner(j), col)}
                writes.add((j, col))
        assert writes <= reads
        assert not writes & written
        written |= writes
    assert len(written) == h * 64
