"""The CUDA kernels' partitions of work, mirrored in plain PyTorch on the CPU.

`quant_matmul` splits each output tile's K over the CTAs of a cluster,
whose int32 partial sums one CTA adds before the one float conversion.
`lowrank_qmm` splits phase 1 of a row block over the CTAs of a cluster
(each its own slice of R), combines the row absmax across them, lets each
requantize its slice, and sums phase 2 over R groups. `paged_attention`
cuts each row's keys into splits whose float64 partials (m, l, acc) are
combined in split order. Each mirror below follows the kernel's partition
(taken from the wrappers' own choosers) and is held to the reference: the
split-K product bit for bit to `repro.kernels.ref.quant_matmul_ref`, the
cascade bit for bit to `repro.kernels.ref.lowrank_qmm_ref`, the split
softmax to `span_attend_gather` within one fp32 rounding.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.core.quant import pack_int4, symmetric_scale, unpack_int4
from repro_torch.kernels import lowrank_qmm as tlr
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import quant_matmul as tqm
from repro_torch.kernels.ref import int_matmul

# One intra-op thread: the suite runs in several processes at once, and
# full OpenMP teams there wait on each other (the port's tests in 6
# processes: 689 s with 8 threads each, 151 s with 1).
torch.set_num_threads(1)


def _split_k_qmm(xq, sx, wq, sw, packed, tiles):
    """quant_matmul.cu's arithmetic over its partition: for each bm x bn
    tile, CTA r of its cluster multiplies K rows [r * kslice, (r + 1) *
    kslice) (the last slice short, none empty) into int32 partial sums, the
    owner adds the cluster's partials in int32 (exact: every sum is below
    K * 127 * 127 < 2**31) and converts once, ((float)acc * sx) * sw. A
    packed weight is unpacked first, as the kernel does in shared memory."""
    w = unpack_int4(wq) if packed else wq
    m, k = xq.shape
    n = w.shape[1]
    y = torch.empty((m, n))
    for m0 in range(0, m, tiles.bm):
        rows = slice(m0, min(m, m0 + tiles.bm))
        for n0 in range(0, n, tiles.bn):
            cols = slice(n0, min(n, n0 + tiles.bn))
            acc = torch.zeros((rows.stop - m0, cols.stop - n0),
                              dtype=torch.int32)
            for rank in range(tiles.cluster):
                ks = slice(rank * tiles.kslice,
                           min(k, (rank + 1) * tiles.kslice))
                acc += (xq[rows, ks].long() @ w[ks, cols].long()).to(
                    torch.int32)
            y[rows, cols] = acc.float() * sx[rows] * sw[:, cols]
    return y


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("m,k,n", [(8, 512, 512), (8, 2048, 544),
                                   (37, 96, 36), (300, 512, 2080),
                                   (8, 528, 512)])
def test_split_k_quant_matmul_equals_reference(packed, m, k, n):
    """Split-K clusters (8 CTAs at M 8), ragged N against every tile
    width (544, 36, 2080) and K slices that end past K (K 528: a cluster
    of 4, since 8 would leave a CTA no rows)."""
    rng = np.random.default_rng(m + k + n + packed)
    qm = 7 if packed else 127
    xq = rng.integers(-127, 128, (m, k)).astype(np.int8)
    sx = rng.uniform(0.01, 1, (m, 1)).astype(np.float32)
    w = rng.integers(-qm, qm + 1, (k, n)).astype(np.int8)
    sw = rng.uniform(0.001, 0.01, (1, n)).astype(np.float32)
    # shared memory only caps bk, which the arithmetic ignores; N is
    # launched padded to 32, as `ops.qmm` pads it
    tiles = tqm.choose_tiles(m, k, -(-n // 32) * 32, packed, 132,
                             lambda *tiles: 0)
    wq = pack_int4(torch.from_numpy(w)) if packed else torch.from_numpy(w)
    y = _split_k_qmm(torch.from_numpy(xq), torch.from_numpy(sx), wq,
                     torch.from_numpy(sw), packed, tiles)
    ref = jax.jit(jref.quant_matmul_ref)(*(jnp.asarray(a)
                                           for a in (xq, sx, w, sw)))
    np.testing.assert_array_equal(y.numpy(), np.asarray(ref))
    if (m, k, n) == (8, 512, 512):
        assert tiles.cluster == 8
    if k == 528:
        assert tiles.cluster == 4


@functools.partial(jax.jit, static_argnums=6)
def _jax_cascade(xq, sx, w1, s1, w2, s2, qm):
    return jref.lowrank_qmm_ref(xq, sx, w1, s1, w2, s2, qm)


def _cluster_cascade(xq, sx, w1, s1, w2, s2, qm, tiles):
    """lowrank_qmm.cu's arithmetic over its partition: for each cluster's
    row block, CTA c owns R columns [c*rs, (c+1)*rs) (zero codes past R,
    which add 0 to T and to the max), the row absmax is the max of the
    CTAs' partial maxima, each CTA requantizes its own slice, and phase 2
    sums the partial products of the cluster's R groups."""
    m, r = xq.shape[0], w1.shape[1]
    c, rs, cn = tiles.cluster, tiles.rs, tiles.cn
    rp = c * rs
    w1p = torch.zeros((w1.shape[0], rp), dtype=torch.int8)
    w1p[:, :r] = w1
    w2p = torch.zeros((rp, w2.shape[1]), dtype=torch.int8)
    w2p[:r] = w2
    scale = torch.ones(rp)
    scale[:r] = s1.reshape(-1)
    sc2 = torch.ones(rp)
    sc2[:r] = s2.reshape(-1)
    y = torch.empty((m, w2.shape[1]))
    for m0 in range(0, m, tiles.bm):
        rows = slice(m0, min(m, m0 + tiles.bm))
        ts, amax = [], []
        for rank in range(c):                      # phase 1, one slice each
            cols = slice(rank * rs, (rank + 1) * rs)
            t = int_matmul(xq[rows], w1p[:, cols]) * sx[rows] * \
                scale[cols] * sc2[cols]
            ts.append(t)
            amax.append(t.abs().amax(dim=1, keepdim=True))
        st = symmetric_scale(torch.stack(amax).amax(dim=0), qm)
        tq = [torch.clamp(torch.round(t / st), -qm, qm).to(torch.int8)
              for t in ts]                         # each CTA its own slice
        acc = torch.zeros((rows.stop - m0, w2.shape[1]), dtype=torch.float64)
        for ir in range(c // cn):                  # phase 2 over R groups
            grp = torch.cat(tq[ir * cn:(ir + 1) * cn], dim=1)
            acc += torch.matmul(grp.double(),
                                w2p[ir * cn * rs:(ir + 1) * cn * rs].double())
        y[rows] = acc.float() * st
    return y


@pytest.mark.parametrize("act_wl", [8, 4])
@pytest.mark.parametrize("m,k,r,n", [(8, 512, 256, 512), (8, 64, 288, 544),
                                     (70, 32, 12, 64), (8, 48, 1000, 96)])
def test_cluster_cascade_equals_reference(act_wl, m, k, r, n):
    """Rank slices that do not divide R (288, 12 and 1000 against 8 x 32
    columns a cluster's slices span) pad with zero codes, which change
    neither the absmax nor Y."""
    rng = np.random.default_rng(m + k + r + n + act_wl)
    qm = 2 ** (act_wl - 1) - 1
    xq = rng.integers(-qm, qm + 1, (m, k)).astype(np.int8)
    sx = rng.uniform(0.01, 1, (m, 1)).astype(np.float32)
    w1 = rng.integers(-7, 8, (k, r)).astype(np.int8)
    w2 = rng.integers(-7, 8, (r, n)).astype(np.int8)
    s1 = rng.uniform(0.01, 0.1, (1, r)).astype(np.float32)
    s2 = rng.uniform(0.01, 0.1, (r, 1)).astype(np.float32)
    # shared memory only caps bm, which the per-row arithmetic ignores
    tiles = tlr.choose_tiles(m, -(-r // 32) * 32, -(-n // 32) * 32, 132,
                             lambda *tiles: 0)
    assert tiles.cluster * tiles.rs >= r
    y = _cluster_cascade(*(torch.from_numpy(a) for a in
                           (xq, sx, w1, s1, w2, s2)), qm, tiles)
    ref = _jax_cascade(*(jnp.asarray(a) for a in (xq, sx, w1, s1, w2, s2)),
                       qm)
    np.testing.assert_array_equal(y.numpy(), np.asarray(ref))


def _split_attention(q, k, v, ctx, kps, scale):
    """One kv head, G = 1: each query row's visible keys [0, ctx + i] cut
    into splits of kps keys; each split's float64 (m, l, acc), then the
    combine in split order, rounded once to fp32."""
    w, dh = q.shape
    out = torch.zeros((w, dh))
    for i in range(w):
        qpos = ctx + i
        parts = []
        for lo in range(0, qpos + 1, kps):
            hi = min(lo + kps, qpos + 1)
            s = (k[lo:hi].double() @ q[i].double()) * scale
            mx = s.max()
            p = torch.exp(s - mx)
            parts.append((mx, p.sum(), p @ v[lo:hi].double()))
        big = max(mj for mj, _, _ in parts)
        den = sum(lj * torch.exp(mj - big) for mj, lj, _ in parts)
        num = sum(aj * torch.exp(mj - big) for mj, _, aj in parts)
        out[i] = (num / den).float()
    return out


@pytest.mark.parametrize("ctx,w,kps", [(40, 1, 40), (511, 1, 128),
                                       (17, 37, 40), (0, 5, 16)])
def test_split_softmax_equals_gather(ctx, w, kps):
    """Splits of 40 keys end mid-block (blocks of 16); the combined result
    is the one-pass softmax of the plain version up to one fp32 rounding
    of the float64 value (the two sum in different orders)."""
    rng = np.random.default_rng(ctx + w + kps)
    bs, dh = 16, 64
    nb = -(-(ctx + w) // bs)
    k = rng.standard_normal((nb, bs, 1, dh)).astype(np.float32)
    v = rng.standard_normal((nb, bs, 1, dh)).astype(np.float32)
    q = rng.standard_normal((1, w, 1, dh)).astype(np.float32)
    pool = {"k": torch.from_numpy(k), "v": torch.from_numpy(v)}
    table = torch.arange(nb, dtype=torch.int32)[None]
    ref = tpa.span_attend_gather(torch.from_numpy(q), pool, table,
                                 torch.tensor([ctx], dtype=torch.int32))
    out = _split_attention(torch.from_numpy(q[0, :, 0]),
                           torch.from_numpy(k.reshape(-1, dh)),
                           torch.from_numpy(v.reshape(-1, dh)), ctx, kps,
                           dh ** -0.5)
    r = ref[0, :, 0].numpy()
    assert (np.abs(out.numpy() - r) <= np.spacing(np.abs(r))).all()
