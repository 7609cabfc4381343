"""The kernels' own cost counts, and the record a ``cost_analysis`` reads.

The counts of the work each fused function must do and of the work each
kernel does (B1 ``csrc/fused1d.cu``, B2 and B5 ``csrc/fused2d.cu``, B3, B4,
B6 and B7 ``csrc/fused3d.cu``), with the bound they give on the H100's
data-sheet rates. They are the port's counterparts of the
``pl.CostEstimate`` of each Pallas call in the JAX package
(``fft_conv_tpu/kernels/fused1d.py:458``, ``fused2d.py:541``,
``fused3d.py:1170``, ``:1221``, ``:1404``; B7's is the inline term of
``fused3d.py:1161``), kept beside the kernels as JAX
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

# NVIDIA's data sheet for the H100 SXM: HBM rate, FP32 rate outside the
# tensor cores, and the dense bf16 tensor-core rate (B1's and B2's "bf16x3"
# and "bf16" modes; every other kernel uses FP32 FMAs only)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12


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
    """Records one call of ``kernel`` (B1 ... B7) in the innermost running
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


def _sym_dft_flops(n, live, need, kernel, first):
    """Flops of csrc/fused3d.cu's dft_emit for an n that is not a power of
    two, the real-symmetric form: s_j, d_j = v_j +- v_(n-j) (4 per
    pair 0 < j < n/2), X[0] the sum of v_0, v_(n/2) and the s_j, and per
    pair of bins m, n - m the sums P = v_0 [+- v_(n/2)] + sum_j s_j cos and
    Q = sum_j d_j sin (4 per complex-by-real FMA, 2 per term whose cos or
    sin is +-1, none where it is 0), then X[m], X[n-m] = P -+ i Q (2 each).
    kernel: every term and bin counted; else only the live inputs (j <
    live), the used bins (first <= m < need) and no add into a zero."""
    half = (n - 1) // 2
    if kernel:
        live, need, first = n, n, 0
    lv = [j < live for j in range(n)]
    used = [first <= m < need for m in range(n)]
    mid = n % 2 == 0 and lv[n // 2]
    flops = sum(4 if kernel or (lv[j] and lv[n - j]) else 0 for j in range(1, half + 1))
    nz = [False] + [lv[j] or lv[n - j] for j in range(1, half + 1)]

    def adds(terms):  # complex adds of a sum of `terms` nonzero terms
        return 2 * max(terms - 1, 0)

    if used[0]:
        flops += adds(lv[0] + mid + sum(nz[1:]))
    for m in range(1, n // 2 + 1):
        bins = [m] if 2 * m == n else [m, n - m]
        if not any(used[b] for b in bins):
            continue
        p_add = q_add = fma = 0
        for j in range(1, half + 1):
            if not nz[j]:
                continue
            e = m * j % n
            if 4 * e % n:
                fma += 1
            elif e == 0 or 2 * e == n:
                p_add += 1
            else:
                q_add += 1
        if kernel:  # P starts at v_0, Q at 0
            flops += 8 * fma + 2 * (mid + p_add) + 2 * q_add + 4 * (len(bins) == 2)
            continue
        p_terms = lv[0] + mid + p_add
        flops += 8 * fma + adds(p_terms) + adds(q_add)
        if fma:  # the first product into an empty P or Q is a multiply
            flops -= 2 * (p_terms == 0) + 2 * (q_add == 0)
        if len(bins) == 2:
            flops += 2 * sum(used[b] for b in bins)
    return flops


@functools.lru_cache(maxsize=None)
def _short_dft_flops(n, live, need, kernel, first=0, fold=False):
    """Flops of one n-point DFT as csrc/fused2d.cu's short_dft runs it (and
    csrc/fused3d.cu's), an FMA as two: radix-2 butterflies on the
    bit-reversed input for a power of two, the real-symmetric form of
    csrc/fused3d.cu's dft_emit for another n up to 16 and for an odd n
    (_sym_dft_flops), the dense product for another even one (B2's 24).
    Inputs j >= live are zero and
    only the outputs first <= m < need are used. kernel: the kernel's own
    arithmetic (every product by a root other than root[0] = 1 costs 6, and
    with fold, as the 3D H steps run them, none by root[n/4] = -i either;
    every add 2); else only what the outputs need: no product by 1, -1 or
    +-i, no add with a zero, nothing that reaches no used output."""
    if kernel:
        free = (lambda k: k == 0 or (fold and 4 * k == n))
    else:
        free = (lambda k: _free_root(k, n))
    if n & (n - 1) and (n <= 16 or n % 2):
        return _sym_dft_flops(n, live, need, kernel, first)
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
    most-square power-of-two split for another power of two, else the
    mixed-radix split of B3's and B4's H transforms (fourstep.mixed_split:
    both factors at most 16, B even) where t has one; else, for the least
    work of an even H that has none (82 = 41 * 2, which the kernels pad to
    84), the most-square split with B even and any A; else None (no split:
    the length is counted as a dense product)."""
    from . import fourstep, fused2d, fused3d

    if t in fused2d._SPLITS:
        return fused2d._SPLITS[t]
    if t == fused3d._TW:
        return fused3d._W_SPLIT
    if t >= 4 and not t & (t - 1):
        return fourstep.split_factors(t)
    return fourstep.mixed_split(t) or fourstep.mixed_split(t, max(t // 2, 2))


@functools.lru_cache(maxsize=None)
def _four_step_flops(t, live, need, kernel=False, first=0, fold=False, tc=False):
    """Flops of one complex length-t DFT through its four-step split
    (_split): B A-point DFTs over j1 of x[j1 B + j2], the twiddle tw[m1, j2],
    A B-point DFTs onto the bins m1 + A m2. Inputs j >= live are zero, only
    the bins first <= m < need are used; kernel and fold as
    _short_dft_flops (the kernel multiplies by the twiddle wherever
    m1 > 0). tc: (product flops, FP32 flops), each short DFT a dense product
    on the tensor cores over its live inputs onto its used outputs (8 per
    term), the twiddles FP32."""
    a, b = _split(t)
    want = [[first <= m1 + a * m2 < need for m2 in range(b)] for m1 in range(a)]
    rows = sum(map(any, want))  # the A-point DFTs' outputs m1 that step 2 uses
    flops, products, live2 = 0, 0, 0
    for j2 in range(b):
        lv = sum(j1 * b + j2 < live for j1 in range(a))  # inputs j1 < lv are live
        if lv == 0:
            continue
        live2 = j2 + 1
        if tc:
            products += 8 * lv * rows
        else:
            flops += _short_dft_flops(a, lv, rows, kernel, 0, fold)
        flops += sum(6 for m1 in range(rows)
                     if (m1 > 0 if kernel else not _free_root(m1 * j2, t)))
    for m1 in range(rows):
        used = [m2 for m2 in range(b) if want[m1][m2]]
        if not used:
            continue
        if tc:
            products += 8 * live2 * (used[-1] + 1 - used[0])
        else:
            flops += _short_dft_flops(b, live2, used[-1] + 1, kernel, used[0], fold)
    return (products, flops) if tc else flops


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


def fused1d_tc_work(b, cin, cout, l, k, n, mode, groups=1):
    """(bytes, product flops, FP32 flops) of B1's tensor-core route under
    ``mode`` ("bf16x3" or "bf16") for one call, over whole blocks, as the
    kernels run it (csrc/fused1d.cu: fused1d_spectra_tc, fused1d_mac_tc,
    fused1d_inverse_tc).

    Bytes: fused1d_work's, plus the two scratch arrays through which the
    route hands the MAC apart from the transforms: D (blocks, B, Cin,
    N1/2+1, 128) complex64, written once by phase 1 and read by the MAC
    stage once for each output-channel block of its group (ceil((Cout/g) /
    ocb), ocb = min(Cout/g, fused1d._TC_OCB): one read of a D row serves
    every output channel of a MAC block), and the MAC stage's Y (blocks, B,
    Cout, N1/2+1, 128), written once and read once by the inverse stage, as
    fused2d_tc_work counts B2's Y. Product flops (an FMA as two, a complex
    R-point step as the real 2R x 2R product), times 3 under "bf16x3": per
    block and input channel the N1-point DFT of the 64 column pairs (dense
    at N1 = 16 and 32, two 8-point steps at N1 = 64:
    fused1d._TC_COL_SPLITS) and the row DFTs of the N1/2+1 rows as 16 · 8;
    per block and output channel the inverse row DFTs and the c2r's
    N1-point DFT of the 64 pairs onto all N1 rows. FP32
    flops: the split (8 per pair and row), the four-step twiddle (6 per
    bin), the row and column splits' twiddles (6 per product by a root
    other than 1), the MAC, the conjugate twiddle and Hermitian extension
    of the c2r (14 per pair and bin) and the output scale."""
    n1 = n // 128
    h = n1 // 2 + 1
    v1, _, blocks = _blocks_1d(l, k, n)
    passes = 3 if mode == "bf16x3" else 1
    rows = h * (8 * 2 * 32 * 32 + 16 * 2 * 16 * 16)  # 8 vectors of 16, 16 of 8, a row
    row_tw = 6 * h * 8 * 15  # step 1's outputs m1 > 0
    if n1 == 64:  # 8 vectors of 8 points, then 8 more, a pair
        col = 64 * 2 * 8 * 2 * 16 * 16
        col_tw = 6 * 64 * 8 * 7
    else:
        col = 64 * 2 * (2 * n1) ** 2
        col_tw = 0
    fwd = 8 * 64 * h + 6 * h * 128 + row_tw + col_tw
    inv = 8 * (cin // groups) * h * 128 + row_tw + col_tw + 14 * 64 * n1 + v1 * 128
    calls = b * len(blocks)
    from .fused1d import _TC_OCB  # fused1d imports this module

    og = cout // groups
    reads = -(-og // min(og, _TC_OCB))  # of each D row, one a MAC block
    plane = 8 * calls * h * 128  # bytes of one channel's planes over the call
    nbytes = (fused1d_work(b, cin, cout, l, k, n, groups)[0]
              + plane * (cin * (1 + reads) + 2 * cout))
    return (nbytes, calls * passes * (cin + cout) * (col + rows),
            calls * (cin * fwd + cout * inv))


def fused1d_record(b, cin, cout, l, k, n, groups, mode):
    """The ``record`` of one B1 call under precision ``mode``: "B1" with the
    FP32 pair's count under "highest", "B1_bf16x3" or "B1_bf16" with the
    tensor-core route's (product and FP32 flops together) otherwise."""
    if mode == "highest":
        return record("B1", fused1d_kernel_flops(b, cin, cout, l, k, n, groups),
                      fused1d_work(b, cin, cout, l, k, n, groups)[0])
    nbytes, products, rest = fused1d_tc_work(b, cin, cout, l, k, n, mode, groups)
    return record(f"B1_{mode}", products + rest, nbytes)


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


def fused2d_tc_work(b, cin, cout, h, w, k, plan, mode, groups=1, v3=False):
    """(bytes, product flops, FP32 flops) of B2's tensor-core route under
    ``mode`` ("bf16x3" or "bf16") for one call, over whole T1 x T2 tiles, as
    the kernels run it (csrc/fused2d.cu: fused2d_spectra_tc, fused2d_mac_tc,
    fused2d_inverse_tc), or with ``v3`` of B5's (fused2d_v3_spectra_tc, the
    MAC stage, fused2d_v3_inverse_tc).

    Bytes: fused2d_work's, plus the MAC stage's Y (tiles, B, Cout, NB1, T2)
    complex64, written once by the MAC stage and read once by the inverse
    stage, the traffic the route adds to hand the MAC apart from the H
    irfft. Product flops (an FMA as two, a complex R-point
    step as the real 2R x 2R product on each vector, 8 R^2), times 3 under
    "bf16x3", each T-point DFT factored A · B (fused2d._SPLITS) as B vectors
    of A points and A of B: per tile and input channel the W DFT of the T1/2
    packed rows and the H DFT of T2/2 columns; per tile and output channel
    the inverse W DFT of the NB1 rows and the H irfft of T2/2 column pairs
    onto all T1 rows. FP32 flops: the twiddles (6 per product by a root
    other than 1), the split of the W bins of two packed rows (4 per H
    input), the DC/Nyquist column split (8 per bin), the MAC, the Hermitian
    extension (2 per H input) and the output scale (1 per sample of the V1
    rows).

    B5's route, the same bytes: per tile and input channel the H DFT of the
    T2/2 packed columns and the W DFT of the T1/2 rows (rows 0 and T1/2
    packed as one), per tile and output channel the folded H inverse of T2/2
    column pairs onto all T1 rows and the W c2r of the ceil(V1/2) row pairs;
    FP32: the twiddles, the split of the bins k and -k of a packed column (4
    per one-sided value of rows 1 to T1/2 - 1), the split of the packed
    row's bins into D's rows 0 and T1/2 (8 per bin), the MAC, the means at
    bins 0 and T1/2 (4 per column pair), the Hermitian extension of the row
    pairs (2 per W input) and the output scale."""
    t1, v1, nb1, t2, v2 = plan
    k1, k2 = _ks(k, 2)
    tiles = -(-(h - k1 + 1) // v1) * -(-(w - k2 + 1) // v2)
    passes = 3 if mode == "bf16x3" else 1

    def products(t):
        a, bb = _split(t)
        return 8 * (bb * a * a + a * bb * bb)

    def twiddles(t):
        a, bb = _split(t)
        return 6 * (a - 1) * bb

    n1, n2 = t1 // 2, t2 // 2
    mac = 8 * (cin // groups) * nb1 * t2
    if v3:
        pairs = -(-v1 // 2)
        fwd = n2 * products(t1) + n1 * products(t2)
        inv = n2 * products(t1) + pairs * products(t2)
        fwd32 = n2 * twiddles(t1) + n1 * twiddles(t2) + 4 * (n1 - 1) * t2 + 8 * t2
        inv32 = (mac + n2 * twiddles(t1) + pairs * twiddles(t2) + 8 * n2 + 2 * pairs * t2
                 + v1 * t2)
    else:
        fwd = n1 * products(t2) + n2 * products(t1)
        inv = nb1 * products(t2) + n2 * products(t1)
        fwd32 = n1 * twiddles(t2) + n2 * twiddles(t1) + 4 * t1 * n2 + 8 * nb1
        inv32 = mac + nb1 * twiddles(t2) + n2 * twiddles(t1) + 2 * t1 * n2 + v1 * t2
    calls = b * tiles
    y_bytes = 8 * calls * cout * nb1 * t2
    nbytes = fused2d_work(b, cin, cout, h, w, k, plan, groups)[0] + 2 * y_bytes
    return (nbytes, calls * passes * (cin * fwd + cout * inv),
            calls * (cin * fwd32 + cout * inv32))


def fused2d_record(b, cin, cout, h, w, k, plan, groups, mode, v3=False):
    """The ``record`` of one 2D fused call under precision ``mode``: "B2"
    (or "B5" under "v3") with the FP32 pair's count under "highest",
    "B2_bf16x3" or "B2_bf16" ("B5_bf16x3", "B5_bf16") with the tensor-core
    route's (product and FP32 flops together, Y's bytes counted) otherwise."""
    shape = (b, cin, cout, h, w, k, plan, groups)
    name = "B5" if v3 else "B2"
    if mode == "highest":
        flops = fused2d_v3_kernel_flops if v3 else fused2d_kernel_flops
        return record(name, flops(*shape), fused2d_work(*shape)[0])
    nbytes, products, rest = fused2d_tc_work(b, cin, cout, h, w, k, plan, mode, groups, v3)
    return record(f"{name}_{mode}", products + rest, nbytes)


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


def _hw_slab_flops(h, oh, nbh, cols_in, lo, hi, dense=False, tc=False):
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
    fused2d_work counts B2's, and dense as above where it has none. tc: the
    least work with every short DFT on the tensor cores (_four_step_flops
    with tc=True, a dense H product too), each of the two then a pair
    (product flops, FP32 flops)."""
    stored = hi - lo
    if dense:
        return (4 * nbh * h * cols_in + 8 * nbh * cols_in * 64,
                8 * nbh * 64 * stored + 4 * oh * nbh * stored)

    def dft(n, *args):  # n transforms, as (products, FP32) under tc
        f = _four_step_flops(*args, tc=tc)
        return (n * f[0], n * f[1]) if tc else n * f

    def add(u, v):
        return (u[0] + v[0], u[1] + v[1]) if tc else u + v

    fwd = dft(nbh, 64, cols_in, 64)
    inv = dft(nbh, 64, 64, hi, False, lo)
    if _split(h):
        fwd = add(fwd, dft(-(-cols_in // 2), h, h, h))
        inv = add(inv, dft(-(-stored // 2), h, h, oh))
    else:  # a dense product, on the tensor cores under tc
        fwd = add(fwd, (4 * nbh * h * cols_in, 0) if tc else 4 * nbh * h * cols_in)
        inv = add(inv, (4 * oh * nbh * stored, 0) if tc else 4 * oh * nbh * stored)
    return fwd, inv


def _hw_kernel_flops(h, oh, d, od):
    """(per input channel, per output channel) flops that B3's and B4's H/W
    kernels do for one item, with the kernels' own arithmetic
    (_short_dft_flops and _four_step_flops with kernel=True), at the working
    length Hw and its NBH = Hw/2+1 bins (fused3d._h_work): the factored W
    DFT-64 of the d slabs' NBH rows; the inverse W DFT of the od slabs' rows
    with its 1/64 (2 per value). For an H the kernels factor, per slab pair
    (ceil(d / 2) of them, the last one padded with a zero slab; ceil(od / 2)
    in the inverse): the Hw-point DFT of the 64 packed columns (its radix-2
    DFTs with root[n/4] = -i folded, fold=True), the split of bins k and
    Hw - k (8 per value of the 8 columns a W step 1 task reads, 16 for the
    two real rows of k = 0 and Hw / 2, whose 8-point DFTs the kernel splits
    after running them on the packed row), and in the inverse the Hermitian
    extension (4 per bin pair), W step 2 of both slabs (of the rows 0 and
    Hw / 2 too), the conjugated Hw-point DFT of the 64 columns and the 1/Hw
    of the stored rows (1 per value, over all 64 columns). For every other H
    (Hw = H) the dense H DFT over whole groups of SB slabs and all 64
    columns, and the dense H irfft likewise."""
    from . import fused3d

    fw = _four_step_flops(64, 64, 64, True)
    hw, split = fused3d._h_work(h)
    nbh = hw // 2 + 1
    if split is None:
        sb = fused3d._slabs_per_block(nbh)
        return (-(-d // sb) * sb * 4 * nbh * h * 64 + d * nbh * fw,
                od * nbh * (fw + 2 * 64) + -(-od // sb) * sb * 4 * oh * nbh * 64)
    d8, fh = _short_dft_flops(8, 8, 8, True), _four_step_flops(hw, hw, hw, True, 0, True)
    twiddle = 7 * 6  # W step 1's twiddles on a row, per j2
    fwd_pair = (64 * fh + 8 * (hw * d8 + 2 * nbh * twiddle + 64 * (hw // 2 - 1) + 128)
                + 2 * nbh * 8 * d8)
    inv_pair = 8 * ((hw // 2 - 1) * (2 * d8 + 64) + 4 * d8 + 32) + 64 * fh + 2 * oh * 64
    return (-(-d // 2) * fwd_pair,
            od * nbh * 8 * (d8 + twiddle) + -(-od // 2) * inv_pair)


def _hw_stage_flops(cin, cout, d, h, w, kd, kh, kw, groups, dense, tc=False):
    """Flops of the H/W transforms of one batch element of a call, least
    work at the signal's own H (no credit for a working length's padding):
    per W block, with cols_in of its 64 columns inside the signal and the
    block columns [lo, hi) stored, per input channel and d-slab and per
    output channel and valid d (_hw_slab_flops; tc: (product flops, FP32
    flops))."""
    from . import fused3d

    plan, nwb, hop = fused3d.plan_3d_blocked(cin, cout, d, h, w, kd, kh, kw, groups)
    od, oh, ow = d - kd + 1, h - kh + 1, w - kw + 1
    flops = [0, 0]
    for start, lo, hi in fused3d._w_blocks(w, ow, nwb, hop):
        fwd, inv = _hw_slab_flops(h, oh, plan[1], min(64, w - start), lo, hi, dense, tc)
        for i, (f, v) in enumerate(zip(fwd, inv) if tc else [(fwd, inv)]):
            flops[i] += cin * d * f + cout * od * v
    return tuple(flops) if tc else flops[0]


def fused3d_hw_work(b, cin, cout, d, h, w, k, groups=1):
    """(bytes, flops) the H/W stage of B3 and B4 (hw_forward and hw_inverse,
    the pair of kernels between the signal and T and between Z and the
    output) must move and do for one call, least work at the signal's own
    H: the signal read and T (items, Cin, D, NBH, 64) written, Z (items,
    Cout, OD, NBH, 64) read and the output written, once each, complex64
    and float32; flops as _hw_stage_flops."""
    from . import fused3d

    kd, kh, kw = _ks(k, 3)
    plan, nwb, _ = fused3d.plan_3d_blocked(cin, cout, d, h, w, kd, kh, kw, groups)
    od, oh, ow = d - kd + 1, h - kh + 1, w - kw + 1
    nbytes = (4 * b * cin * d * h * w + 8 * b * nwb * (cin * d + cout * od) * plan[1] * 64
              + 4 * b * cout * od * oh * ow)
    return nbytes, b * _hw_stage_flops(cin, cout, d, h, w, kd, kh, kw, groups, False)


def fused3d_work(b, cin, cout, d, h, w, k, groups=1, dense=False, tc=False):
    """(bytes, flops) the fused 3D function must move and do for one call,
    least work at the signal's own H (the kernels' working length pads H
    where it does not split, fused3d._h_work; the bound does not credit
    that padding).

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
    of `dense_bound_ms`. tc: (bytes, FP32 flops, product flops), the least
    work of the tensor-core route, every short DFT a product
    (_hw_stage_flops and fused3d_d_work with tc=True), one pass."""
    from . import fused3d

    kd, kh, kw = _ks(k, 3)
    plan, _, _ = fused3d.plan_3d_blocked(cin, cout, d, h, w, kd, kh, kw, groups)
    nbh = plan[1]
    od, oh, ow = d - kd + 1, h - kh + 1, w - kw + 1
    cpg = cin // groups
    flops = _hw_stage_flops(cin, cout, d, h, w, kd, kh, kw, groups, dense, tc)
    nbytes = (4 * b * cin * d * h * w + 8 * cout * cpg * 16 * nbh * 64
              + 4 * b * cout * od * oh * ow)
    d_work = fused3d_d_work(b, cin, cout, d, h, w, k, groups, dense, tc)
    if tc:
        return nbytes, b * flops[1] + d_work[1], b * flops[0] + d_work[2]
    return nbytes, b * flops + d_work[1]


def _d_stage(b, cin, cout, d, h, w, kd, kh, kw, groups, taps):
    """(items, NBH·64 bins, OD, bytes) of the D stage of one call whose
    spectra hold ``taps`` D entries (16 D-bins, or the KD taps): T (items,
    Cin, D, bins) and the spectra read once, Z (items, Cout, OD, bins)
    written once, complex64."""
    from . import fused3d

    plan, nwb, _ = fused3d.plan_3d_blocked(cin, cout, d, h, w, kd, kh, kw, groups)
    items, npos, od = b * nwb, plan[1] * 64, d - kd + 1
    nbytes = 8 * npos * (items * (cin * d + cout * od) + cout * (cin // groups) * taps)
    return items, npos, od, nbytes


def fused3d_d_work(b, cin, cout, d, h, w, k, groups=1, dense=False, tc=False):
    """(bytes, flops) B3's D stage (between the H/W spectra T and the MAC's
    output Z) must move and do for one call, the bound of its kernel
    (fused3d_d_mac). Bytes: _d_stage. Flops, with an FMA as two: per input
    channel and bin, the DFT-16 of each block as two 8-slab partial DFTs,
    each 8-slab chunk's once, and their sum (2 per value, where the second
    chunk reaches inside D); per output channel and bin, the MAC over the
    group's channels at the 16 D-bins of each block (8) and the inverse
    DFT-16 onto the block's valid d below OD. The DFT-16s are counted by
    _four_step_flops (16 = 4 x 4, over the chunk's slabs inside D, onto the
    valid d only). dense: the partial DFTs 8 per term over the slabs inside
    D and the inverse 8 per term onto the OD valid d. tc: (bytes, FP32
    flops, product flops), the DFT-16s' short DFTs as products
    (_four_step_flops with tc=True)."""
    kd, kh, kw = _ks(k, 3)
    items, npos, od, nbytes = _d_stage(b, cin, cout, d, h, w, kd, kh, kw, groups, 16)
    nbd = -(-od // 8)
    live = [min(8, d - 8 * m) for m in range(nbd + 1)]  # each chunk's slabs inside D
    valid = [min(8, od - 8 * j) for j in range(nbd)]    # each block's valid d
    mac, sums = 8 * (cin // groups) * 16 * nbd, 2 * 16 * sum(lv > 0 for lv in live[1:])
    if tc:
        fwd = [_four_step_flops(16, lv, 16, tc=True) for lv in live if lv > 0]
        inv = [_four_step_flops(16, 16, v, tc=True) for v in valid]
        products = cin * sum(p for p, _ in fwd) + cout * sum(p for p, _ in inv)
        fp32 = cin * (sum(f for _, f in fwd) + sums) + cout * (mac + sum(f for _, f in inv))
        return nbytes, items * npos * fp32, items * npos * products
    if dense:
        d_fwd, d_inv = 8 * 16 * d + 2 * 16 * nbd, 8 * 16 * od
    else:
        d_fwd = sum(_four_step_flops(16, lv, 16) for lv in live if lv > 0) + sums
        d_inv = sum(_four_step_flops(16, 16, v) for v in valid)
    per_item = cin * d_fwd + cout * (mac + d_inv)
    return nbytes, items * npos * per_item


def fused3d_kernel_flops(b, cin, cout, d, h, w, k, groups=1):
    """The flops csrc/fused3d.cu does for one call of B3: the H/W kernels
    as _hw_kernel_flops counts them and fused3d_d_mac's own arithmetic over
    the Hw/2+1 bins of the working length (fused3d._h_work), 4 lanes a
    (bin, D block), every slab of a block counted (zeros past D
    too). Per lane, per input channel and block of OPB output channels
    (fused3d._opb; the block recomputes the channel's DFT-16): step 1 of the
    DFT-16 at one output m1 (16 a j2: two real FMA pairs and a complex FMA),
    three twiddles and the 4-point DFT of step 2. The MAC per output and
    input channel at the 16 D-bins. Per lane and output channel: the
    conjugated 4-point DFT, three twiddles, four rotations onto m2 = 1, the
    six complex adds of the two shuffle rounds and the 1/16 of the two d it
    stores."""
    from . import fused3d

    kd, kh, kw = _ks(k, 3)
    plan, nwb, hop = fused3d.plan_3d_blocked(cin, cout, d, h, w, kd, kh, kw, groups)
    nbd = plan[4]
    od, oh = d - kd + 1, h - kh + 1
    npos, cpg = fused3d._nbh_work(h) * 64, cin // groups
    fwd, inv = _hw_kernel_flops(h, oh, d, od)
    dft4 = _short_dft_flops(4, 4, 4, True)
    d_fwd = 4 * (4 * 16 + 3 * 6 + dft4)
    d_inv = 4 * (dft4 + 3 * 6 + 4 * 6 + 6 * 2 + 2 * 2)
    opb = fused3d._opb(cout // groups, fused3d._D_OPB)
    item = cin * fwd + cout * inv
    item += npos * nbd * ((cout // opb) * cpg * d_fwd + cout * (cpg * 16 * 8 + d_inv))
    return b * nwb * item


def fused3d_tap_work(b, cin, cout, d, h, w, k, groups=1, dense=False, tc=False):
    """(bytes, flops) the fused 3D function must move and do for one call of
    a 'tap' plan (kernel B4), counted as in fused3d_work: the H/W transforms
    per input channel and d-slab, the tap MAC per output channel, valid d
    and bin over the group's channels and the KD taps (8 per term), the
    inverse W DFT onto the stored columns and the H irfft on the valid rows
    per output channel and valid d. Bytes: the signal and the spectra
    (Cout, Cin/g, KD, NBH, 64) read once, the output written once. tc:
    (bytes, FP32 flops, product flops) as fused3d_work's, the tap MAC FP32."""
    from . import fused3d

    kd, kh, kw = _ks(k, 3)
    plan, _, _ = fused3d.plan_3d_blocked(cin, cout, d, h, w, kd, kh, kw, groups)
    nbh = plan[1]
    od, oh, ow = d - kd + 1, h - kh + 1, w - kw + 1
    cpg = cin // groups
    flops = _hw_stage_flops(cin, cout, d, h, w, kd, kh, kw, groups, dense, tc)
    nbytes = (4 * b * cin * d * h * w + 8 * cout * cpg * kd * nbh * 64
              + 4 * b * cout * od * oh * ow)
    mac = fused3d_tap_mac_work(b, cin, cout, d, h, w, k, groups)[1]
    if tc:
        return nbytes, b * flops[1] + mac, b * flops[0]
    return nbytes, b * flops + mac


def fused3d_tap_mac_work(b, cin, cout, d, h, w, k, groups=1):
    """(bytes, flops) B4's tap MAC must move and do for one call, the bound
    of its kernel (fused3d_tap_mac): bytes as _d_stage with the KD taps;
    per output channel, valid d and bin, the MAC over the group's channels
    and the KD taps (8 per term)."""
    kd, kh, kw = _ks(k, 3)
    items, npos, od, nbytes = _d_stage(b, cin, cout, d, h, w, kd, kh, kw, groups, kd)
    return nbytes, items * cout * npos * od * 8 * (cin // groups) * kd


def fused3d_tap_kernel_flops(b, cin, cout, d, h, w, k, groups=1):
    """The flops csrc/fused3d.cu's tap chain does for one call: the H/W
    kernels as _hw_kernel_flops counts them, the tap MAC over the Hw/2+1
    bins of the working length onto all fused3d._TAP_DC d of each chunk a
    thread takes."""
    from . import fused3d

    kd, kh, kw = _ks(k, 3)
    _, nwb, _ = fused3d.plan_3d_blocked(cin, cout, d, h, w, kd, kh, kw, groups)
    od, oh = d - kd + 1, h - kh + 1
    npos, dc = fused3d._nbh_work(h) * 64, fused3d._TAP_DC
    fwd, inv = _hw_kernel_flops(h, oh, d, od)
    item = cin * fwd + cout * inv
    item += cout * npos * -(-od // dc) * dc * 8 * (cin // groups) * kd
    return b * nwb * item


def _hw_tc_flops(h, d, od, oh):
    """((product, FP32) flops per input channel, the same per output
    channel) of B3's and B4's tensor-core H/W kernels for one item
    (csrc/fused3d.cu: fused3d_hw_forward_tc, fused3d_hw_inverse_tc), an FMA
    as two. Products: a complex step of R points on a vector is the real 2R
    x 2R product, 8 R^2, with R the step size of its radix
    (fused3d._tc_radix); per slab pair (ceil(d / 2), ceil(od / 2) in the
    inverse) the HA-point step on HB·64 vectors and the HB-point step on
    HA·64 (none for HB = 1, H < 16), per slab both W steps (8-point) on its
    NBH·8 vectors. FP32: the twiddles (6 each, none at m1 = 0), the split of
    bins k and Hw - k (4 per one-sided value), the Hermitian extension (2
    per value of the pair's column), the inverse's 1/64 (2 per value) and
    1/Hw (1 per row below OH of all 64 columns)."""
    from . import fused3d

    ha, hb = fused3d._h_steps(h)
    hw, nbh = ha * hb, ha * hb // 2 + 1
    ra, rb = fused3d._tc_radix(ha), fused3d._tc_radix(hb)
    h_prod = 64 * (hb * 8 * ra * ra + (ha * 8 * rb * rb if hb > 1 else 0))
    h_tw = 6 * 64 * (ha - 1) * hb if hb > 1 else 0
    w_prod, w_tw = 2 * nbh * 8 * 8 * 64, nbh * 6 * 7 * 8
    fwd = (-(-d // 2) * h_prod + d * w_prod, -(-d // 2) * (h_tw + 4 * 2 * nbh * 64) + d * w_tw)
    pairs = -(-od // 2)
    inv = (pairs * h_prod + od * w_prod,
           pairs * (h_tw + 2 * hw * 64 + 2 * oh * 64) + od * (w_tw + 2 * nbh * 64))
    return fwd, inv


def fused3d_tc_work(b, cin, cout, d, h, w, k, mode, groups=1, least=False):
    """(bytes, product flops, FP32 flops) of B3's tensor-core chain under
    ``mode`` ("bf16x3" or "bf16") for one call, as the kernels run it
    (csrc/fused3d.cu: fused3d_hw_forward_tc, fused3d_d_mac_tc,
    fused3d_hw_inverse_tc). Bytes as fused3d_work. Products (times 3 under
    "bf16x3"): the H/W steps (_hw_tc_flops) and, per item, D block and bin,
    the dense 16-point DFT of each (channel, block of OPB output channels)
    pair of its group (8·16², OPB = fused3d._opb at most 4) and the inverse
    onto the 8 valid d of each output channel (8·16·8). FP32: the H/W
    kernels' (_hw_tc_flops), the MAC at the 16 D-bins (8 per term) and the
    1/16 of each stored value (2). least: the least work of that route
    instead, for its bound (fused3d_work with tc=True)."""
    from . import fused3d

    passes = 3 if mode == "bf16x3" else 1
    if least:
        nbytes, fp32, products = fused3d_work(b, cin, cout, d, h, w, k, groups, tc=True)
        return nbytes, passes * products, fp32
    kd, kh, kw = _ks(k, 3)
    plan, nwb, _ = fused3d.plan_3d_blocked(cin, cout, d, h, w, kd, kh, kw, groups)
    nbd, od, oh = plan[4], d - kd + 1, h - kh + 1
    npos, cpg = fused3d._nbh_work(h) * 64, cin // groups
    opb = fused3d._opb(cout // groups, fused3d._D_OPB_TC)
    (fp, f32), (ip, i32) = _hw_tc_flops(h, d, od, oh)
    products = cin * fp + cout * ip + npos * nbd * ((cout // opb) * cpg * 8 * 256
                                                    + cout * 8 * 16 * 8)
    rest = cin * f32 + cout * i32 + npos * (nbd * cout * cpg * 16 * 8 + cout * od * 2)
    items = b * nwb
    return (fused3d_work(b, cin, cout, d, h, w, k, groups)[0], items * passes * products,
            items * rest)


def fused3d_tap_tc_work(b, cin, cout, d, h, w, k, mode, groups=1, least=False):
    """(bytes, product flops, FP32 flops) of B4's tensor-core chain under
    ``mode`` for one call: the tensor-core H/W kernels as fused3d_tc_work
    counts them and the FP32 tap MAC as fused3d_tap_kernel_flops does. Bytes
    as fused3d_tap_work. least: the least work of that route instead, for
    its bound (fused3d_tap_work with tc=True: the tap MAC onto the OD valid
    d, the H/W transforms at the signal's own H and W columns, each short
    DFT a product over its live inputs onto its used outputs)."""
    from . import fused3d

    passes = 3 if mode == "bf16x3" else 1
    if least:
        nbytes, fp32, products = fused3d_tap_work(b, cin, cout, d, h, w, k, groups, tc=True)
        return nbytes, passes * products, fp32
    kd, kh, kw = _ks(k, 3)
    _, nwb, _ = fused3d.plan_3d_blocked(cin, cout, d, h, w, kd, kh, kw, groups)
    od, oh = d - kd + 1, h - kh + 1
    npos, dc = fused3d._nbh_work(h) * 64, fused3d._TAP_DC
    (fp, f32), (ip, i32) = _hw_tc_flops(h, d, od, oh)
    rest = cin * f32 + cout * i32 + cout * npos * -(-od // dc) * dc * 8 * (cin // groups) * kd
    items = b * nwb
    return (fused3d_tap_work(b, cin, cout, d, h, w, k, groups)[0],
            items * passes * (cin * fp + cout * ip), items * rest)


def fused3d_record(b, cin, cout, d, h, w, k, groups, mode, tap):
    """The ``record`` of one 3D fused call under precision ``mode``: "B3"
    (or "B4" for a 'tap' plan) with the FP32 chain's count under "highest",
    "B3_<mode>" or "B4_<mode>" with the tensor-core chain's (product and FP32
    flops together) otherwise."""
    shape = (b, cin, cout, d, h, w, k, groups)
    name = "B4" if tap else "B3"
    if mode == "highest":
        flops = fused3d_tap_kernel_flops if tap else fused3d_kernel_flops
        work = fused3d_tap_work if tap else fused3d_work
        return record(name, flops(*shape), work(*shape)[0])
    work = fused3d_tap_tc_work if tap else fused3d_tc_work
    nbytes, products, rest = work(b, cin, cout, d, h, w, k, mode, groups)
    return record(f"{name}_{mode}", products + rest, nbytes)


def fused3d_spectra_work(cin, cout, h, k, groups=1):
    """(bytes, flops) kernel B7 must move and do for one call: the (Cout,
    Cin/g, KD, KH, KW) float32 taps read once and the conjugated spectra
    (Cout, Cin/g, 16, Hw/2+1, 64) complex64 written once, at the working
    length Hw = fused3d._h_work(h), the length B3 reads them at. Flops, with
    an FMA as two, per (out, in) channel pair, the separable transforms on
    the taps: the W DFT-64 of each (d, h) row of KW real taps (4 per tap and
    bin), the one-sided H DFT of the KH rows at each D tap and W bin (8 per
    term) and the DFT-16 of the KD taps at each (H, W) bin (8 per term)."""
    from . import fused3d

    kd, kh, kw = _ks(k, 3)
    nbh, pairs = fused3d._nbh_work(h), cout * (cin // groups)
    nbytes = pairs * (4 * kd * kh * kw + 8 * 16 * nbh * 64)
    flops = 4 * kd * kh * kw * 64 + 8 * kd * nbh * 64 * kh + 8 * 16 * nbh * 64 * kd
    return nbytes, pairs * flops


def fused3d_spectra_kernel_flops(cin, cout, h, k, groups=1):
    """The flops csrc/fused3d.cu's fused3d_spectra_v4 does for one call: per
    (out, in) channel pair and block of fused3d._SPEC_NB one-sided H bins
    (the last block's bins past Hw/2+1 too), the W DFT-64 of every row of
    taps again and the H DFT onto all the block's bins; the DFT-16 onto the
    Hw/2+1 bins alone."""
    from . import fused3d

    kd, kh, kw = _ks(k, 3)
    nbh, nb = fused3d._nbh_work(h), fused3d._SPEC_NB
    blocks = -(-nbh // nb)
    per_pair = blocks * (4 * kd * kh * kw * 64 + 8 * kd * nb * 64 * kh)
    per_pair += 8 * 16 * nbh * 64 * kd
    return cout * (cin // groups) * per_pair


def bound(nbytes, flops, bf16_flops=0):
    """(bound_ms, bound_by): the larger of the bytes and the operations
    bound on the card's data-sheet rates, the operations' time being the
    FP32 ``flops`` at the FP32 rate plus the tensor-core ``bf16_flops`` at
    the bf16 rate (the steps of one block run one after the other)."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = (flops / FP32_FLOPS_PER_S + bf16_flops / BF16_FLOPS_PER_S) * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms > ops_ms else "operations"


def mode_bound(fp32_work, tc_work):
    """(bound_ms, bound_by, (bytes, FP32 flops, product flops)) of a call
    under a bf16 precision mode: the lesser of two routes' bounds, the FP32
    one's least work ``fp32_work`` (bytes, flops) and the tensor-core one's
    ``tc_work`` (bytes, product flops, FP32 flops; the products of all its
    passes), with the counts of the route that sets it. An FP32 result
    meets either mode's accuracy, so the card's least time for the call is
    the lesser of the two: a bf16 mode's bound is never above the FP32
    one's. A tie keeps the FP32 route."""
    fp32 = (fp32_work[0], fp32_work[1], 0)
    tc = (tc_work[0], tc_work[2], tc_work[1])
    return min((*bound(*fp32), fp32), (*bound(*tc), tc), key=lambda r: r[0])


def pack3d_bytes(b, cin, d, h, w, pp, nwb):
    """Bytes kernel B6 must move for one call: the signal (B, Cin, D, H, W)
    read once and xp (B * nwb, H, Cin * PP, 128) written once. It does no
    arithmetic, so bytes bound it."""
    return 4 * b * cin * d * h * w + 4 * b * nwb * h * cin * pp * 128


