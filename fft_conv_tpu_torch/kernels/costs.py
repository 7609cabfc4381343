"""The kernels' own cost counts, and the record a ``cost_analysis`` reads.

The counts of the work each fused function must do and of the work each
kernel does (B1 ``csrc/fused1d.cu``, B2 and B5 ``csrc/fused2d.cu``, B3, B4
and B6 ``csrc/fused3d.cu``), with the bound they give on the H100's
data-sheet rates. They are the port's counterparts of the
``pl.CostEstimate`` of each Pallas call in the JAX package
(``fft_conv_tpu/kernels/fused1d.py:458``, ``fused2d.py:541``,
``fused3d.py:1170``, ``:1221``, ``:1404``), kept beside the kernels as JAX
keeps them beside its calls. ``chip_smoke.py`` prints them as ``bound_ms``,
``dense_bound_ms`` and ``kernel_flops``.

``record`` is what the wrappers enter where they choose between a kernel
and its plain version (``fused{1,2,3}d.py``: ``_fused_forward``,
``_fused2d_forward``, ``_fused3d_forward``), so that a call records the same
cost on the CPU as on the card. They enter it only while ``active()``, that
is while a ``bench.profiling.cost_analysis`` is tallying, and ``IDLE``
otherwise, so an uncounted call computes no count.

A 2D kernel size ``k`` is an int or (K1, K2), a 3D one an int or (KD, KH,
KW); an int stands for a square or cubic kernel.
"""

import contextlib
import functools
from typing import Dict, Iterator, List

# NVIDIA's data sheet for the H100 SXM: HBM rate and FP32 rate outside the
# tensor cores (the kernels use FP32 FMAs only)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12


class Tally:
    """What one ``cost_analysis`` has counted so far: ``flops`` and
    ``bytes`` in all, per kernel ``kernels[name]`` = {"calls", "flops",
    "bytes"}, and ``paused`` > 0 while a kernel or its plain version runs
    (its aten ops are not counted then)."""

    def __init__(self) -> None:
        self.flops = 0
        self.bytes = 0
        self.paused = 0
        self.kernels: Dict[str, Dict[str, int]] = {}


# the tallies of the cost analyses that are running, innermost last
_tallies: List[Tally] = []

# what a wrapper enters in place of ``record`` when nothing is tallying
IDLE = contextlib.nullcontext()


def active() -> bool:
    """Whether a ``cost_analysis`` is tallying, so that ``record`` counts."""
    return bool(_tallies)


@contextlib.contextmanager
def tallying() -> Iterator[Tally]:
    """A new Tally that ``record`` adds to until the block ends."""
    tally = Tally()
    _tallies.append(tally)
    try:
        yield tally
    finally:
        _tallies.remove(tally)


@contextlib.contextmanager
def record(kernel: str, flops: int, nbytes: int) -> Iterator[None]:
    """Records one call of ``kernel`` (B1 ... B6) in the innermost running
    tally around the block that runs it or its plain version, and pauses
    the counting of aten ops in the block. ``flops``: the kernel's own count
    (``*_kernel_flops``); ``nbytes``: the inputs read once and the outputs
    written once, as the ``*_work`` functions count them. A call that the
    wrapper splits into several launches is one call here: the launch
    counts are the wrappers' own counters (``fused1d.launches`` ...).
    Enter it only while ``active()``."""
    tally = _tallies[-1]
    entry = tally.kernels.setdefault(kernel, {"calls": 0, "flops": 0, "bytes": 0})
    entry["calls"] += 1
    entry["flops"] += int(flops)
    entry["bytes"] += int(nbytes)
    tally.flops += int(flops)
    tally.bytes += int(nbytes)
    tally.paused += 1
    try:
        yield
    finally:
        tally.paused -= 1


def _ks(k, n):
    """A kernel size as an n-tuple: an int stands for all n axes."""
    return (k,) * n if isinstance(k, int) else tuple(k)


def _free_root(k, n):
    """A product by the root exp(-2 pi i k / n) needs no flops when the root
    is 1, -1, i or -i: at most a swap and a sign, which fold into the add."""
    return 4 * k % n == 0


@functools.lru_cache(maxsize=None)
def _short_dft_flops(n, live, need, kernel, first=0):
    """Flops of one n-point DFT as csrc/fused2d.cu's short_dft runs it (and
    csrc/fused3d.cu's, for n = 8), an FMA as two: radix-2 butterflies on the
    bit-reversed input for a power of two, the dense product for another n.
    Inputs j >= live are zero and only the outputs first <= m < need are
    used. kernel: the kernel's own arithmetic (every product by a root other
    than root[0] = 1 costs 6, every add 2); else only what the outputs need:
    no product by 1, -1 or +-i, no add with a zero, nothing that reaches no
    used output."""
    free = (lambda k: k == 0) if kernel else (lambda k: _free_root(k, n))
    if n & (n - 1):  # per used output, a product per live term, an add past the first
        terms = min(live, n)
        return (need - first) * 2 * max(terms - 1, 0) + sum(
            6 for m in range(first, need) for j in range(terms) if not free(m * j % n))
    bits = n.bit_length() - 1
    masks = [[int(format(i, f"0{bits}b")[::-1], 2) < live for i in range(n)]]
    for s in range(1, bits):  # masks[s]: the inputs of stage s that may be nonzero
        prev, half = masks[-1], 1 << (s - 1)
        masks.append([prev[i] or prev[i ^ half] for i in range(n)])
    flops, used = 0, [first <= m < need for m in range(n)]
    for s in reversed(range(len(masks))):
        half, lv, below = 1 << s, masks[s], [False] * n
        for p in (i for i in range(n) if not i & half):
            q, j = p + half, p % half
            if not (used[p] or used[q]):
                continue
            below[p], below[q] = lv[p], lv[q]
            if lv[q] and not free(j * n // (2 * half)):
                flops += 6
            if lv[p] and lv[q]:
                flops += 2 * (used[p] + used[q])
        used = below
    return flops


def _split(t):
    """The four-step split (A, B) of a DFT length t as the kernels factor it
    (B2's fused2d._SPLITS, B3's and B4's W split fused3d._W_SPLIT), else the
    most-square power-of-two split for another power of two, else None (no
    split: the length is counted as a dense product)."""
    from . import fourstep, fused2d, fused3d

    if t in fused2d._SPLITS:
        return fused2d._SPLITS[t]
    if t == fused3d._TW:
        return fused3d._W_SPLIT
    return fourstep.split_factors(t) if t >= 4 and not t & (t - 1) else None


@functools.lru_cache(maxsize=None)
def _four_step_flops(t, live, need, kernel=False, first=0):
    """Flops of one complex length-t DFT through its four-step split
    (_split): B A-point DFTs over j1 of x[j1 B + j2], the twiddle tw[m1, j2],
    A B-point DFTs onto the bins m1 + A m2. Inputs j >= live are zero, only
    the bins first <= m < need are used; kernel as _short_dft_flops (the
    kernel multiplies by the twiddle wherever m1 > 0)."""
    a, b = _split(t)
    want = [[first <= m1 + a * m2 < need for m2 in range(b)] for m1 in range(a)]
    rows = sum(map(any, want))  # the A-point DFTs' outputs m1 that step 2 uses
    flops, live2 = 0, 0
    for j2 in range(b):
        lv = sum(j1 * b + j2 < live for j1 in range(a))  # inputs j1 < lv are live
        if lv == 0:
            continue
        live2 = j2 + 1
        flops += _short_dft_flops(a, lv, rows, kernel)
        flops += sum(6 for m1 in range(rows)
                     if (m1 > 0 if kernel else not _free_root(m1 * j2, t)))
    for m1 in range(rows):
        used = [m2 for m2 in range(b) if want[m1][m2]]
        if used:
            flops += _short_dft_flops(b, live2, used[-1] + 1, kernel, used[0])
    return flops


def _blocks_1d(l, k, n):
    """(V1, valid output length, [(samples inside the signal, outputs
    stored)] per overlap-save block) of the fused 1D function at FFT size n."""
    v1 = (n - k + 1) // 128
    l_out = l - k + 1
    hop = v1 * 128
    return v1, l_out, [(min(n, l - s), min(hop, l_out - s)) for s in range(0, l_out, hop)]


def fused1d_work(b, cin, cout, l, k, n, groups=1):
    """(bytes, flops) the fused 1D function must move and do for one call,
    with every DFT factored as kernel B1 factors it.

    Bytes: the signal and the one-sided spectra (Cout, N1/2+1, Cin/g, 128)
    read once, the output written once. Flops, with an FMA as two, counted
    for only what the call needs (_short_dft_flops, _four_step_flops: no
    product by 1, -1 or +-i, none over the zeros past the signal's edge,
    none for outputs that are not stored). Per block, with s_in samples
    inside the signal and s_out outputs stored: per input channel, the
    N1-point DFT of each column pair (columns c and c + 64 as one complex
    column, zero past s_in; all N1 bins, which the split needs), the split
    of bins k and -k into the two columns' one-sided spectra (4 adds per
    pair and row 0 < k1 < N1/2, the 1/2 folded into the twiddle), the
    twiddle on the N1/2+1 rows (6 per complex product, 2 on the real row
    N1/2) and the 128-point DFT of each row; per output channel, the MAC
    over the group's channels (8, Cin/g x (N1/2+1) x 128), the inverse
    128-point DFT of each row onto the stored columns, the conjugate
    twiddle, the Hermitian extension of each stored column pair (2 per bin
    0 < k < N1, k != N1/2) and its N1-point inverse onto the stored rows."""
    n1 = n // 128
    h, nh = n1 // 2 + 1, n1 // 2
    v1, l_out, blocks = _blocks_1d(l, k, n)
    cpg = cin // groups
    tw = sum(0 if _free_root(k1 * j2, n) else (2 if k1 == nh else 6)
             for k1 in range(1, h) for j2 in range(128))
    itw = sum(0 if _free_root(k1 * j2, n) else 6 for k1 in range(1, h) for j2 in range(128))
    flops = 0
    for s_in, s_out in blocks:
        live = [max(0, min(n1, -(-(s_in - c) // 128))) for c in range(64)]
        fwd = sum(_short_dft_flops(n1, lv, n1, False) for lv in live if lv)
        fwd += 64 * 4 * (h - 2) + tw + h * _four_step_flops(128, 128, 128)
        pairs = [min(v1, -(-(s_out - c) // 128)) for c in range(min(64, s_out))]
        inv = 8 * cpg * h * 128 + h * _four_step_flops(128, 128, min(128, s_out)) + itw
        inv += sum(2 * (n1 - 2) + _short_dft_flops(n1, n1, rows, False) for rows in pairs)
        flops += cin * fwd + cout * inv
    nbytes = 4 * b * cin * l + 8 * cout * h * cpg * 128 + 4 * b * cout * l_out
    return nbytes, b * flops


def fused1d_kernel_flops(b, cin, cout, l, k, n, groups=1):
    """The flops csrc/fused1d.cu's B1 does for one call, over whole blocks
    with the kernel's own arithmetic (_four_step_flops(kernel=True)): per
    input channel the N1-point DFT of the 64 column pairs, the split (8 per
    pair and row), the twiddle (6 per bin) and the 128-point DFT of each
    row; per output channel the MAC, the inverse row DFTs, the conjugate
    twiddle, the Hermitian extension (2 per pair and bin), the column
    pairs' inverse N1-point DFT (its second step only on the rows
    m1 < min(V1, A)) and the output scale (1 per sample of the V1 rows)."""
    n1 = n // 128
    h = n1 // 2 + 1
    v1, _, blocks = _blocks_1d(l, k, n)
    a, bb = _split(n1)
    row = _four_step_flops(128, 128, 128, True)
    col = _four_step_flops(n1, n1, n1, True)
    col1 = bb * (_short_dft_flops(a, a, a, True) + 6 * (a - 1))  # the inverse's step 1
    col2 = min(v1, a) * _short_dft_flops(bb, bb, bb, True)
    fwd = 64 * col + 8 * 64 * h + 6 * h * 128 + h * row
    inv = (8 * (cin // groups) * h * 128 + h * row + 6 * h * 128 + 2 * 64 * n1
           + 64 * (col1 + col2) + v1 * 128)
    return b * len(blocks) * (cin * fwd + cout * inv)


def fused1d_dense_work(b, cin, cout, l, k, n, groups=1):
    """(bytes, flops) of the fused 1D function with every DFT a dense
    product, the count B1's first, dense design was bounded with, kept as
    its `dense_bound_ms`.

    Bytes as fused1d_work. Flops, counted from the dense pipeline with an
    FMA as two and only the N1/2+1 rows that the one-sided pipeline needs:
    per block and input channel, stage 1 (real x complex, 4 per term),
    twiddle (6), stage 2 (complex, 8); per block and output channel, the MAC
    over the group's channels (8), inverse stage 1 (8), conjugate twiddle (6)
    and inverse stage 2 on the V1 valid rows (real part, 4)."""
    n1, n2 = n // 128, 128
    h = n1 // 2 + 1
    v1, l_out, blocks = _blocks_1d(l, k, n)
    cpg = cin // groups
    fwd = h * n1 * n2 * 4 + h * n2 * 6 + h * n2 * n2 * 8
    inv = h * n2 * cpg * 8 + h * n2 * n2 * 8 + h * n2 * 6 + v1 * n2 * h * 4
    flops = len(blocks) * b * (cin * fwd + cout * inv)
    nbytes = 4 * b * cin * l + 8 * cout * h * cpg * n2 + 4 * b * cout * l_out
    return nbytes, flops


def fused2d_work(b, cin, cout, h, w, k, plan, groups=1):
    """(bytes, flops) the fused 2D function must move and do for one call,
    with every DFT factored as kernel B2 factors it.

    Bytes: the signal and the spectra (Cout, Cin/g, NB1, T2) read once, the
    output written once. Flops, with an FMA as two, counted by
    _four_step_flops for only what the call needs: no product by 1, -1 or
    +-i, none over the zeros past the signal's edge and none for outputs
    that are not stored. Per tile, with rows_in x cols_in samples inside the
    signal and rows_out x cols_out outputs stored: per input channel the W
    DFT of the row pairs inside the signal (two real rows as one complex
    row, zero past cols_in) and the H DFT of T2/2 complex columns (the real
    columns 0 and T2/2 as one, zero past rows_in); per output channel the
    MAC over the group's channels (8, Cin/g x NB1 x T2), the inverse W DFT
    of the NB1 one-sided rows onto the columns of the stored column pairs
    and the H irfft of those pairs (two real columns as one complex
    transform) onto the rows_out stored rows."""
    t1, v1, nb1, t2, v2 = plan
    k1, k2 = _ks(k, 2)
    oh, ow = h - k1 + 1, w - k2 + 1
    cpg = cin // groups
    flops = 0
    for h0 in range(0, oh, v1):
        rows_in, rows_out = min(t1, h - h0), min(v1, oh - h0)
        for w0 in range(0, ow, v2):
            cols_in, pairs = min(t2, w - w0), -(-min(v2, ow - w0) // 2)
            flops += cin * (-(-rows_in // 2) * _four_step_flops(t2, cols_in, t2)
                            + t2 // 2 * _four_step_flops(t1, rows_in, t1))
            flops += cout * (8 * cpg * nb1 * t2 + nb1 * _four_step_flops(t2, t2, 2 * pairs)
                             + pairs * _four_step_flops(t1, t1, rows_out))
    nbytes = 4 * b * cin * h * w + 8 * cout * cpg * nb1 * t2 + 4 * b * cout * oh * ow
    return nbytes, b * flops


def fused2d_kernel_flops(b, cin, cout, h, w, k, plan, groups=1):
    """The flops csrc/fused2d.cu's B2 does for one call, over whole T1 x T2
    tiles with the kernel's own arithmetic (_four_step_flops(kernel=True)):
    per input channel the W DFT of the T1/2 row pairs and the H DFT of T2/2
    columns, per output channel the MAC, the inverse W DFT of the NB1 rows
    and the H irfft of T2/2 column pairs; plus the arithmetic of the
    real-data packing: splitting the W bins k and -k of two packed rows (4
    per H input), the DC/Nyquist column split (8 per bin), the Hermitian
    extension of the inverse's column pairs (2 per H input) and the output
    scale (1 per sample of the V1 rows)."""
    t1, v1, nb1, t2, v2 = plan
    k1, k2 = _ks(k, 2)
    tiles = -(-(h - k1 + 1) // v1) * -(-(w - k2 + 1) // v2)
    f1, f2 = _four_step_flops(t1, t1, t1, True), _four_step_flops(t2, t2, t2, True)
    fwd = t1 // 2 * f2 + t2 // 2 * f1 + 4 * t1 * t2 // 2 + 8 * nb1
    inv = 8 * (cin // groups) * nb1 * t2 + nb1 * f2 + t2 // 2 * f1 + 2 * t1 * t2 // 2 + v1 * t2
    return b * tiles * (cin * fwd + cout * inv)


def fused2d_dense_work(b, cin, cout, h, w, k, plan, groups=1):
    """(bytes, flops) of the fused 2D function with every DFT a dense
    product, the count B2 was first bounded with, kept as B2's and B5's
    `dense_bound_ms`.

    Bytes as fused2d_work. Flops: the dense DFT products of the tiled
    algorithm with an FMA as two, restricted to what the call needs: no
    product over the zeros past the signal's edge and none for outputs that
    are not stored. Per tile, with rows_in x cols_in samples inside the
    signal and rows_out x cols_out outputs stored: per input channel, the
    one-sided H DFT (real x complex, 4 per term, NB1 x rows_in x cols_in)
    and the W DFT (complex, 8, NB1 x cols_in x T2); per output channel, the
    MAC over the group's channels (8, Cin/g x NB1 x T2), the inverse W DFT
    (8, NB1 x T2 x cols_out) and the H irfft (4, rows_out x NB1 x cols_out)."""
    t1, v1, nb1, t2, v2 = plan
    k1, k2 = _ks(k, 2)
    oh, ow = h - k1 + 1, w - k2 + 1
    cpg = cin // groups
    flops = 0
    for h0 in range(0, oh, v1):
        rows_in, rows_out = min(t1, h - h0), min(v1, oh - h0)
        for w0 in range(0, ow, v2):
            cols_in, cols_out = min(t2, w - w0), min(v2, ow - w0)
            flops += cin * (4 * nb1 * rows_in * cols_in + 8 * nb1 * cols_in * t2)
            flops += cout * (8 * cpg * nb1 * t2 + 8 * nb1 * t2 * cols_out
                             + 4 * rows_out * nb1 * cols_out)
    nbytes = 4 * b * cin * h * w + 8 * cout * cpg * nb1 * t2 + 4 * b * cout * oh * ow
    return nbytes, b * flops


def fused2d_v3_kernel_flops(b, cin, cout, h, w, k, plan, groups=1):
    """The flops kernel B5 (csrc/fused2d.cu, the v3 schedule) does for one
    call, over whole T1 x T2 tiles with the kernel's own arithmetic
    (_four_step_flops(kernel=True)): per input channel the H DFT of T2/2
    packed column pairs, the split of their bins k and -k (8 per pair and
    row 0 < k < T1/2) and the W DFT of the NB1 rows; per output channel the
    MAC, the folded H inverse (T2/2 T1-point transforms; assembling S costs
    8 per column pair at k = 0 and T1/2 and 2 per bin for the shared pair of
    columns 0 and T2/2), the W c2r of ceil(V1/2) row pairs (T2-point
    transforms, 2 per bin for the Hermitian extension) and the output scale
    (1 per stored sample of a tile)."""
    t1, v1, nb1, t2, v2 = plan
    k1, k2 = _ks(k, 2)
    tiles = -(-(h - k1 + 1) // v1) * -(-(w - k2 + 1) // v2)
    f1, f2 = _four_step_flops(t1, t1, t1, True), _four_step_flops(t2, t2, t2, True)
    n1, n2 = t1 // 2, t2 // 2
    fwd = n2 * f1 + 8 * (n1 - 1) * n2 + nb1 * f2
    inv = (8 * (cin // groups) * nb1 * t2 + n2 * f1 + 8 * (n2 - 1) + 2 * (t1 - 2)
           + -(-v1 // 2) * (f2 + 2 * t2) + v1 * v2)
    return b * tiles * (cin * fwd + cout * inv)


def _hw_slab_flops(h, oh, nbh, cols_in, lo, hi, dense=False):
    """(per input d-slab, per output d-slab) flops of the H/W transforms of
    one W block with cols_in of its 64 columns inside the signal and the
    block columns [lo, hi) stored, an FMA as two.

    dense: the dense count, every transform a dense product: the one-sided H
    DFT (real x complex, 4 per term, NBH x H x cols_in), the W DFT (8, NBH x
    cols_in x 64), the inverse W DFT onto the stored columns (8, NBH x 64 x
    stored) and the H irfft on the valid rows (4, OH x NBH x stored). Else
    the least work the call needs, by _four_step_flops: the W DFT-64 of the
    NBH rows over the live columns and its inverse onto the stored ones,
    factored 8 x 8 as B3 and B4 run them; the H DFT and irfft factored where
    H has a split (_split), two real columns as one complex transform as
    fused2d_work counts B2's, and dense as above where it has none."""
    stored = hi - lo
    if dense:
        return (4 * nbh * h * cols_in + 8 * nbh * cols_in * 64,
                8 * nbh * 64 * stored + 4 * oh * nbh * stored)
    fwd = nbh * _four_step_flops(64, cols_in, 64)
    inv = nbh * _four_step_flops(64, 64, hi, first=lo)
    if _split(h):
        fwd += -(-cols_in // 2) * _four_step_flops(h, h, h)
        inv += -(-stored // 2) * _four_step_flops(h, h, oh)
    else:
        fwd += 4 * nbh * h * cols_in
        inv += 4 * oh * nbh * stored
    return fwd, inv


def _hw_kernel_flops(h, oh, nbh, d, od, sb):
    """(per input channel, per output channel) flops that B3's and B4's H/W
    kernels do for one item, with the kernels' own arithmetic
    (_short_dft_flops and _four_step_flops with kernel=True): the factored W
    DFT-64 of the d slabs' NBH rows; the inverse W DFT of the od slabs' rows
    with its 1/64 (2 per value). For an H the kernels factor
    (fused3d._H_SPLITS), per slab pair (ceil(d / 2) of them, the last one
    padded with a zero slab; ceil(od / 2) in the inverse): the H-point DFT
    of the 64 packed columns, the split of bins k and H - k (8 per value of
    the 8 columns a W step 1 task reads, 16 for the two real rows of k = 0
    and H / 2, whose 8-point DFTs the kernel splits after running them on
    the packed row), and in the inverse the Hermitian extension (4 per bin
    pair), W step 2 of both slabs (of the rows 0 and H / 2 too), the
    conjugated H-point DFT of the 64 columns and the 1/H of the stored rows
    (1 per value, over all 64 columns). For every other H the dense H DFT
    over whole groups of SB slabs and all 64 columns, and the dense H irfft
    likewise."""
    from . import fused3d

    fw = _four_step_flops(64, 64, 64, True)
    if h not in fused3d._H_SPLITS:
        return (-(-d // sb) * sb * 4 * nbh * h * 64 + d * nbh * fw,
                od * nbh * (fw + 2 * 64) + -(-od // sb) * sb * 4 * oh * nbh * 64)
    d8, fh = _short_dft_flops(8, 8, 8, True), _four_step_flops(h, h, h, True)
    twiddle = 7 * 6  # W step 1's twiddles on a row, per j2
    fwd_pair = (64 * fh + 8 * (h * d8 + 2 * nbh * twiddle + 64 * (h // 2 - 1) + 128)
                + 2 * nbh * 8 * d8)
    inv_pair = 8 * ((h // 2 - 1) * (2 * d8 + 64) + 4 * d8 + 32) + 64 * fh + 2 * oh * 64
    return (-(-d // 2) * fwd_pair,
            od * nbh * 8 * (d8 + twiddle) + -(-od // 2) * inv_pair)


def fused3d_work(b, cin, cout, d, h, w, k, groups=1, dense=False):
    """(bytes, flops) the fused 3D function must move and do for one call.

    Bytes: the signal and the spectra (Cout, Cin/g, 16, NBH, 64) read once,
    the output written once. Flops, with an FMA as two, restricted to what
    the call needs. Per W block, with cols_in of its 64 columns inside the
    signal and cols_out outputs stored: per input channel and d-slab, the H
    and W transforms (_hw_slab_flops); per input channel and bin, the DFT-16
    of each block as two 8-slab partial DFTs, each 8-slab chunk's once, and
    their sum (2 per value, where the second chunk reaches inside D); per
    output channel and bin, the MAC over the group's channels at the 16
    D-bins of each block (8) and the inverse DFT-16 onto the block's valid d
    below OD; per output channel and valid d, the inverse W DFT and the H
    irfft (_hw_slab_flops). The DFT-16s are counted by _four_step_flops (16
    = 4 x 4, over the chunk's slabs inside D, onto the valid d only). dense:
    every transform a dense product, the partial DFTs 8 per term over the
    slabs inside D and the inverse 8 per term onto the OD valid d, the count
    of `dense_bound_ms`."""
    from . import fused3d

    kd, kh, kw = _ks(k, 3)
    plan, nwb, hop = fused3d.plan_3d_blocked(cin, cout, d, h, w, kd, kh, kw, groups)
    nbh, nbd = plan[1], plan[4]
    od, oh, ow = d - kd + 1, h - kh + 1, w - kw + 1
    cpg, npos = cin // groups, nbh * 64
    live = [min(8, d - 8 * m) for m in range(nbd + 1)]  # each chunk's slabs inside D
    valid = [min(8, od - 8 * j) for j in range(nbd)]    # each block's valid d
    if dense:
        d_fwd, d_inv = 8 * 16 * d + 2 * 16 * nbd, 8 * 16 * od
    else:
        d_fwd = sum(_four_step_flops(16, lv, 16) for lv in live if lv > 0)
        d_fwd += 2 * 16 * sum(lv > 0 for lv in live[1:])
        d_inv = sum(_four_step_flops(16, 16, v) for v in valid)
    flops = 0
    for start, lo, hi in fused3d._w_blocks(w, ow, nwb, hop):
        fwd, inv = _hw_slab_flops(h, oh, nbh, min(64, w - start), lo, hi, dense)
        flops += cin * d * fwd + cout * od * inv
        flops += cin * npos * d_fwd
        flops += cout * npos * (8 * cpg * 16 * nbd + d_inv)
    nbytes = (4 * b * cin * d * h * w + 8 * cout * cpg * 16 * nbh * 64
              + 4 * b * cout * od * oh * ow)
    return nbytes, b * flops


def fused3d_kernel_flops(b, cin, cout, d, h, w, k, groups=1):
    """The flops csrc/fused3d.cu does for one call: the H/W kernels as
    _hw_kernel_flops counts them, the inverse DFT-16 onto all 8 d of a
    block."""
    from . import fused3d

    kd, kh, kw = _ks(k, 3)
    plan, nwb, hop = fused3d.plan_3d_blocked(cin, cout, d, h, w, kd, kh, kw, groups)
    nbh, nbd = plan[1], plan[4]
    od, oh = d - kd + 1, h - kh + 1
    npos = nbh * 64
    fwd, inv = _hw_kernel_flops(h, oh, nbh, d, od, fused3d._slabs_per_block(nbh))
    item = cin * fwd + cout * inv
    item += cin * npos * (8 * 16 * d + 2 * 16 * nbd)
    item += cout * npos * nbd * (8 * (cin // groups) * 16 + 8 * 8 * 16)
    return b * nwb * item


def fused3d_tap_work(b, cin, cout, d, h, w, k, groups=1, dense=False):
    """(bytes, flops) the fused 3D function must move and do for one call of
    a 'tap' plan (kernel B4), counted as in fused3d_work: the H/W transforms
    per input channel and d-slab, the tap MAC per output channel, valid d
    and bin over the group's channels and the KD taps (8 per term), the
    inverse W DFT onto the stored columns and the H irfft on the valid rows
    per output channel and valid d. Bytes: the signal and the spectra
    (Cout, Cin/g, KD, NBH, 64) read once, the output written once."""
    from . import fused3d

    kd, kh, kw = _ks(k, 3)
    plan, nwb, hop = fused3d.plan_3d_blocked(cin, cout, d, h, w, kd, kh, kw, groups)
    nbh = plan[1]
    od, oh, ow = d - kd + 1, h - kh + 1, w - kw + 1
    cpg, npos = cin // groups, nbh * 64
    flops = 0
    for start, lo, hi in fused3d._w_blocks(w, ow, nwb, hop):
        fwd, inv = _hw_slab_flops(h, oh, nbh, min(64, w - start), lo, hi, dense)
        flops += cin * d * fwd + cout * od * inv
        flops += cout * npos * od * 8 * cpg * kd
    nbytes = (4 * b * cin * d * h * w + 8 * cout * cpg * kd * nbh * 64
              + 4 * b * cout * od * oh * ow)
    return nbytes, b * flops


def fused3d_tap_kernel_flops(b, cin, cout, d, h, w, k, groups=1):
    """The flops csrc/fused3d.cu's tap chain does for one call: the H/W
    kernels as _hw_kernel_flops counts them, the tap MAC onto all 8 d of
    each chunk."""
    from . import fused3d

    kd, kh, kw = _ks(k, 3)
    plan, nwb, hop = fused3d.plan_3d_blocked(cin, cout, d, h, w, kd, kh, kw, groups)
    nbh = plan[1]
    od, oh = d - kd + 1, h - kh + 1
    npos = nbh * 64
    fwd, inv = _hw_kernel_flops(h, oh, nbh, d, od, fused3d._slabs_per_block(nbh))
    item = cin * fwd + cout * inv
    item += cout * npos * -(-od // 8) * 8 * 8 * (cin // groups) * kd
    return b * nwb * item


def bound(nbytes, flops):
    """(bound_ms, bound_by): the larger of the bytes and the operations
    bound on the card's data-sheet rates."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / FP32_FLOPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms > ops_ms else "operations"


def pack3d_bytes(b, cin, d, h, w, pp, nwb):
    """Bytes kernel B6 must move for one call: the signal (B, Cin, D, H, W)
    read once and xp (B * nwb, H, Cin * PP, 128) written once. It does no
    arithmetic, so bytes bound it."""
    return 4 * b * cin * d * h * w + 4 * b * nwb * h * cin * pp * 128


