"""Mamba blocks (port of `repro.models.mamba`): the Mamba1 selective scan
(falcon-mamba) and the multi-head Mamba2-style block (zamba2). Each has

  * mambaN_apply   -- the whole-sequence form, with the reference's two
    scan engines: "sequential" (one step a position) and "chunked" (an
    associative scan inside fixed-size chunks, the state carried across
    them);
  * mambaN_prefill -- the same, also returning the decode cache;
  * mambaN_step    -- one-token decode against the cache {"h": the SSM
    state (float32), "conv": the causal conv's last d_conv - 1 inputs}.

The reference computes all of this in jnp outside any kernel, so it is
plain PyTorch here; every projection goes through `layers.apply_linear`,
so a compressed weight launches `quant_matmul` or `lowrank_qmm`.

Rounding follows the reference's compiled step on the CPU (C8), so that
the port gives its bits where the operations are exact, and the card
and the CPU give each other's:
  * XLA's CPU code contracts a float32 `a * b + c` into one fused
    multiply-add (`fma`): the causal conv's sum (its first two products
    as fma(x0, w0, x1 * w1)), the recurrence h = fma(dA, h, dBx), and
    y = fma(D, x, ys);
  * in a bfloat16 model the conv rounds each product and each partial
    sum to bfloat16, and SiLU each of its steps (`_silu_wide`); the scan
    reads the conv's SiLU as `.astype(float32)` of it, which in XLA's
    compiled step reads the last product before its rounding (the
    linears read it rounded);
  * exp, log1p and softplus are taken in float64 and rounded to float32
    where the reference rounds, as the port's other transcendentals;
  * the state's contraction with C (an einsum over d_state) is taken in
    float64 and rounded once, so its order of summation does not matter.
The chunked engine mirrors `jax.lax.associative_scan`'s combine order,
but is held to the reference within a tolerance, not bit for bit. When
gradients are recorded each chunk runs under activation checkpointing,
as the reference's `jax.checkpoint` chunk step.
"""
from __future__ import annotations

import functools

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.models.layers import _bf, _exp_f32, apply_linear


def fma(a, b, c) -> torch.Tensor:
    """a * b + c of float32 tensors as one fused multiply-add: the product
    is exact in float64 and the sum is rounded there, then to float32.
    That double rounding differs from the fused result's single one in
    about one result in 2^28 (`runtime.prng._fma` is exact, and ten times
    slower on the CPU); the card and the CPU give the same bits."""
    return (a.to(torch.float64) * b.to(torch.float64)
            + c.to(torch.float64)).to(torch.float32)


def _silu_wide(x: torch.Tensor) -> torch.Tensor:
    """SiLU of x as XLA runs `jax.nn.silu` on x's dtype, x * (1 / (1 +
    exp(-x))), each step rounded to x's dtype (exp from float64), and
    the last product returned in float32 before its rounding."""
    r = _bf if x.dtype == torch.bfloat16 else (lambda t: t)
    xf = x.to(torch.float32)
    sig = r(1.0 / r(1.0 + r(_exp_f32(-xf))))
    return xf * sig


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus of float32 x, logaddexp(x, 0) = max(x, 0) +
    log1p(exp(-|x|)), each transcendental from float64 rounded to
    float32. max(x, 0) is (x + |x|) / 2, the same bits, so that the
    gradient at the tie x = 0 is logaddexp's 0.5 (`clamp_min` gives 1)."""
    e = _exp_f32(-x.abs())
    return (x + x.abs()) * 0.5 + torch.log1p(e.to(torch.float64)).to(
        torch.float32)


def _emit(h: torch.Tensor, c: torch.Tensor, spec: str) -> torch.Tensor:
    """The state contracted with C over d_state, in float64, rounded once
    to float32."""
    return torch.einsum(spec, h.to(torch.float64),
                        c.to(torch.float64)).to(torch.float32)


# ----------------------------------------------------------------- common --
def _causal_conv(x: torch.Tensor, w: torch.Tensor, tail=None):
    """Depthwise causal conv. x (B, S, C), w (C, K), tail (B, K - 1, C):
    the K - 1 inputs before x (zeros when None). Returns (y, new tail):
    y[t] = sum_j w[:, j] * xp[t + j] over xp = [tail, x], in x's dtype."""
    k = w.shape[1]
    b, s, c = x.shape
    if tail is None:
        tail = torch.zeros((b, k - 1, c), dtype=x.dtype, device=x.device)
    xp = torch.cat([tail, x], dim=1)
    w = w.to(x.dtype)
    views = [xp[:, j:j + s] for j in range(k)]
    if x.dtype == torch.bfloat16:
        y = views[0] * w[:, 0]
        for j in range(1, k):
            y = y + views[j] * w[:, j]
    elif k == 1:
        y = views[0] * w[:, 0]
    else:
        y = fma(views[0], w[:, 0], views[1] * w[:, 1])
        for j in range(2, k):
            y = fma(views[j], w[:, j], y)
    return y, (xp[:, -(k - 1):] if k > 1 else tail)


def _interleave(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a and b interleaved along dim 1 (a first; a has len(b) or one more
    elements)."""
    out = torch.empty((a.shape[0], a.shape[1] + b.shape[1], *a.shape[2:]),
                      dtype=a.dtype, device=a.device)
    out[:, 0::2] = a
    out[:, 1::2] = b
    return out


def _combine(left, right):
    """The scan's combine of (a, b) pairs: (al * ar, bl * ar + br), the
    sum as one fused multiply-add."""
    (al, bl), (ar, br) = left, right
    return al * ar, fma(bl, ar, br)


def _associative_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of (a, b) pairs along dim 1 under `_combine`, in
    `jax.lax.associative_scan`'s order: adjacent pairs combined, the
    halves scanned recursively, then the even elements filled in."""
    n = a.shape[1]
    if n < 2:
        return a, b
    ra, rb = _combine((a[:, 0:n - 1:2], b[:, 0:n - 1:2]),
                      (a[:, 1::2], b[:, 1::2]))
    oa, ob = _associative_scan(ra, rb)
    if n % 2 == 0:
        ea, eb = _combine((oa[:, :-1], ob[:, :-1]), (a[:, 2::2], b[:, 2::2]))
    else:
        ea, eb = _combine((oa, ob), (a[:, 2::2], b[:, 2::2]))
    ea = torch.cat([a[:, :1], ea], dim=1)
    eb = torch.cat([b[:, :1], eb], dim=1)
    return _interleave(ea, oa), _interleave(eb, ob)


def _ssm_scan(make_ab, emit, xs: dict, h0: torch.Tensor, engine: str,
              chunk: int, seq_len: int):
    """h_t = dA_t * h_{t-1} + dBx_t along time (dim 1 of every xs leaf).

    `make_ab(slice of xs) -> (dA, dBx)` builds the transition terms of
    one step (sequential) or one chunk (chunked) at a time, and
    `emit(h, slice of xs) -> y` contracts the state with C, so the
    (B, S, ..., d_state) states never exist whole. Returns (ys (B, S,
    ...), hT)."""
    if engine == "sequential":
        h, ys = h0, []
        for t in range(seq_len):
            x_t = {k: v[:, t] for k, v in xs.items()}
            a, b = make_ab(x_t)
            h = fma(a, h, b)
            ys.append(emit(h, x_t))
        return torch.stack(ys, dim=1), h
    if engine != "chunked":
        raise ValueError(f"ssm engine must be sequential|chunked, got "
                         f"{engine!r}")
    q = min(chunk, seq_len)
    while seq_len % q:
        q -= 1
    step = functools.partial(_chunk_step, make_ab, emit)
    if torch.is_grad_enabled():
        # the reference's @jax.checkpoint chunk_step: the backward pass
        # recomputes a chunk's associative scan instead of keeping its
        # (B, Q, ..., d_state) internals
        step = functools.partial(ckpt.checkpoint, step, use_reentrant=False)
    h, ys = h0, []
    for i in range(0, seq_len, q):
        h, y = step(h, {k: v[:, i:i + q] for k, v in xs.items()})
        ys.append(y)
    return torch.cat(ys, dim=1), h


def _chunk_step(make_ab, emit, h, x_c):
    """One chunk of the chunked engine: (the state after it, its ys)."""
    a_c, b_c = make_ab(x_c)                           # (B, Q, ...)
    cum_a, hin = _associative_scan(a_c, b_c)
    h_all = fma(cum_a, h[:, None], hin)
    return h_all[:, -1], emit(h_all, x_c)


# ----------------------------------------------------------------- mamba1 --
def mamba1_init(cfg, normal, const):
    """One Mamba1 block's parameters with the reference's shapes and
    scales: `normal(*shape, std=...)` draws in the model's dtype, and
    `const(t)` places a float32 tensor t (the reference keeps dt_bias,
    A_log and D in float32). A_log is log(1..d_state) in every row."""
    d, c = cfg.d_model, cfg.ssm
    di = d * c.expand
    dtr = c.dt_rank or d // 16
    a = torch.arange(1, c.d_state + 1, dtype=torch.float32)
    return {"in_proj": normal(d, 2 * di, std=d ** -0.5),
            "conv_w": normal(di, c.d_conv, std=0.2),
            "dt_in": normal(di, dtr, std=di ** -0.5),
            "bc_proj": normal(di, 2 * c.d_state, std=di ** -0.5),
            "dt_proj": normal(dtr, di, std=dtr ** -0.5),
            "dt_bias": const(torch.zeros(di)),
            "A_log": const(torch.log(a).expand(di, c.d_state)),
            "D": const(torch.ones(di)),
            "out_proj": normal(di, d, std=di ** -0.5)}


def _mamba1_core(p, x, xf, z, cfg, h0, engine):
    """x (B, S, Di) post-conv in the model's dtype (what the linears
    read), xf the same in float32 (what the scan reads), z the gate in
    float32. Returns (y (B, S, D), hT)."""
    c = cfg.ssm
    dt = apply_linear(x, p["dt_in"], out_dtype=torch.float32)
    bc = apply_linear(x, p["bc_proj"], out_dtype=torch.float32)
    bmat, cmat = torch.chunk(bc, 2, dim=-1)
    dt = _softplus(apply_linear(dt, p["dt_proj"], out_dtype=torch.float32)
                   + p["dt_bias"])                              # (B,S,Di)
    a = -_exp_f32(p["A_log"])                                   # (Di, N)

    def make_ab(xs):
        dA = _exp_f32(xs["dt"][..., None] * a)                  # (...,Di,N)
        dBx = (xs["dt"] * xs["x"])[..., None] * xs["b"][..., None, :]
        return dA, dBx

    def emit(h, xs):
        return _emit(h, xs["c"], "...dn,...n->...d")

    ys, hT = _ssm_scan(make_ab, emit,
                       {"dt": dt, "x": xf, "b": bmat, "c": cmat},
                       h0, engine, c.chunk, x.shape[1])
    y = fma(p["D"], xf, ys)
    y = (y * _silu_wide(z)).to(x.dtype)
    return apply_linear(y, p["out_proj"]), hT


def _mamba1_in(p, xin, tail):
    """in_proj, the conv and its SiLU: (x in the model's dtype, x in
    float32, z in float32, the conv's new tail)."""
    xz = apply_linear(xin, p["in_proj"])
    x, z = torch.chunk(xz, 2, dim=-1)
    x, tail = _causal_conv(x, p["conv_w"], tail)
    xf = _silu_wide(x)
    return xf.to(xin.dtype), xf, z.to(torch.float32), tail


def mamba1_apply(p, xin, cfg, *, engine="sequential"):
    return mamba1_prefill(p, xin, cfg, engine=engine)[0]


def mamba1_prefill(p, xin, cfg, *, engine="sequential"):
    """The whole sequence xin (B, S, D); returns (y, its decode cache)."""
    x, xf, z, tail = _mamba1_in(p, xin, None)
    di = cfg.d_model * cfg.ssm.expand
    h0 = torch.zeros((xin.shape[0], di, cfg.ssm.d_state),
                     dtype=torch.float32, device=xin.device)
    y, hT = _mamba1_core(p, x, xf, z, cfg, h0, engine)
    return y, {"h": hT, "conv": tail}


def mamba1_init_cache(cfg, batch, dtype, device="cpu"):
    di = cfg.d_model * cfg.ssm.expand
    return {"h": torch.zeros((batch, di, cfg.ssm.d_state),
                             dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.ssm.d_conv - 1, di), dtype=dtype,
                                device=device)}


def mamba1_step(p, x1, cache, cfg):
    """One-token decode. x1 (B, 1, D). Returns (y, the new cache)."""
    x, xf, z, tail = _mamba1_in(p, x1, cache["conv"])
    y, hT = _mamba1_core(p, x, xf, z, cfg, cache["h"], "sequential")
    return y, {"h": hT, "conv": tail}


# ----------------------------------------------------------------- mamba2 --
def mamba2_init(cfg, normal, const):
    """One Mamba2 block's parameters (see `mamba1_init`); A_log starts at
    zeros (a = -1)."""
    d, c = cfg.d_model, cfg.ssm
    di = d * c.expand
    nh = di // c.head_dim
    return {"zx_proj": normal(d, 2 * di, std=d ** -0.5),
            "bc_in": normal(d, 2 * c.d_state, std=d ** -0.5),
            "dt_lin": normal(d, nh, std=d ** -0.5),
            "conv_w": normal(di, c.d_conv, std=0.2),
            "dt_bias": const(torch.zeros(nh)),
            "A_log": const(torch.zeros(nh)),
            "D": const(torch.ones(nh)),
            "out_proj": normal(di, d, std=di ** -0.5)}


def _m2_split(p, xin, cfg):
    """The input projections: (z, x, B, C, dt, heads), x in the model's
    dtype for the conv, the others widened to float32."""
    c = cfg.ssm
    nh = cfg.d_model * c.expand // c.head_dim
    z, x = torch.chunk(apply_linear(xin, p["zx_proj"]), 2, dim=-1)
    bc = apply_linear(xin, p["bc_in"]).to(torch.float32)
    bmat, cmat = torch.chunk(bc, 2, dim=-1)
    dt = apply_linear(xin, p["dt_lin"], out_dtype=torch.float32)
    return z.to(torch.float32), x, bmat, cmat, dt, nh


def _m2_core(p, xf, z, bmat, cmat, dt, cfg, h0, engine, nh, dtype):
    """xf (B, S, Di) post-conv in float32; returns (y (B, S, D) from
    out_proj, hT (B, H, hd, N))."""
    c = cfg.ssm
    b, s = xf.shape[:2]
    hd = c.head_dim
    dt = _softplus(dt + p["dt_bias"])                           # (B,S,H)
    a = -_exp_f32(p["A_log"])                                   # (H,)
    xh = xf.reshape(b, s, nh, hd)

    def make_ab(xs):
        dA = _exp_f32(xs["dt"] * a)[..., None, None]            # (...,H,1,1)
        dBx = (xs["dt"][..., None] * xs["x"])[..., None] * \
            xs["b"][..., None, None, :]                         # (...,H,hd,N)
        return dA, dBx

    def emit(h, xs):
        return _emit(h, xs["c"], "...hdn,...n->...hd")

    ys, hT = _ssm_scan(make_ab, emit,
                       {"dt": dt, "x": xh, "b": bmat, "c": cmat},
                       h0, engine, c.chunk, s)
    y = fma(p["D"][..., None], xh, ys).reshape(b, s, nh * hd)
    y = (y * _silu_wide(z)).to(dtype)
    return apply_linear(y, p["out_proj"]), hT


def mamba2_apply(p, xin, cfg, *, engine="sequential"):
    return mamba2_prefill(p, xin, cfg, engine=engine)[0]


def mamba2_prefill(p, xin, cfg, *, engine="sequential"):
    """The whole sequence xin (B, S, D); returns (y, its decode cache)."""
    c = cfg.ssm
    z, x, bmat, cmat, dt, nh = _m2_split(p, xin, cfg)
    x, tail = _causal_conv(x, p["conv_w"])
    h0 = torch.zeros((xin.shape[0], nh, c.head_dim, c.d_state),
                     dtype=torch.float32, device=xin.device)
    y, hT = _m2_core(p, _silu_wide(x), z, bmat, cmat, dt, cfg, h0, engine,
                     nh, xin.dtype)
    return y, {"h": hT, "conv": tail}


def mamba2_init_cache(cfg, batch, dtype, device="cpu"):
    c = cfg.ssm
    di = cfg.d_model * c.expand
    nh = di // c.head_dim
    return {"h": torch.zeros((batch, nh, c.head_dim, c.d_state),
                             dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, c.d_conv - 1, di), dtype=dtype,
                                device=device)}


def mamba2_step(p, x1, cache, cfg):
    """One-token decode. x1 (B, 1, D). Returns (y, the new cache)."""
    z, x, bmat, cmat, dt, nh = _m2_split(p, x1, cfg)
    x, tail = _causal_conv(x, p["conv_w"], cache["conv"])
    y, hT = _m2_core(p, _silu_wide(x), z, bmat, cmat, dt, cfg, cache["h"],
                     "sequential", nh, x1.dtype)
    return y, {"h": hT, "conv": tail}
