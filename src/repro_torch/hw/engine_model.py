"""The paper's analytical engine models (§VI, eqs 12-19) with ZCU111
constants: a copy of `repro.hw.engine_model` (pure math, identical in
every output), kept so `hw.dse` reproduces Fig. 10/11 as published beside
the deployed card's model (`hw.h100_model`).

Conventions follow the paper: a MatMul engine computes Y[M,N] = X[M,K] @
W[K,N] on an Mt x Nt output-stationary PE array, each PE a Kf-parallel
vector-dot. Rates in words/cycle, workloads in words, latency in cycles.
"""
from __future__ import annotations

import dataclasses
import math

# ---------------------------------------------------------------- platform --
ZCU111 = {
    "dsp": 4272,
    "bram18k": 1080,
    "clock_hz": 200e6,
    # off-chip bandwidth in bits/cycle at 200 MHz (DDR4 ~19.2 GB/s)
    "offchip_bits_per_cycle": 19.2e9 * 8 / 200e6,
}


def f_packing(weight_wl: int) -> int:
    """Multiplications packed per DSP48 (paper cites M4BRAM [2])."""
    return {4: 2, 6: 2, 8: 1}.get(weight_wl, 1)


@dataclasses.dataclass(frozen=True)
class TileConfig:
    mt: int
    nt: int
    kf: int


# ------------------------------------------------------------- eq 12-15 ----
def pe_rates(k: int, n: int, kf: int):
    cyc = math.ceil(k / kf)
    return {
        "r_lhs": k / (cyc * n),
        "r_rhs": kf,
        "r_o": 1.0 / cyc,
    }


def tile_rates(k: int, n: int, t: TileConfig):
    pe = pe_rates(k, n, t.kf)
    return {
        "r_lhs": t.mt * pe["r_lhs"],
        "r_rhs": t.nt * t.kf,
        "r_o": t.mt * t.nt * pe["r_o"],
    }


def tile_workloads(m: int, k: int, n: int, t: TileConfig):
    return {
        "w_lhs": m * k,
        "w_rhs": (m / t.mt) * k * n,
        "w_o": m * n,
    }


def tile_latency(m: int, k: int, n: int, t: TileConfig) -> float:
    """Eq. 15: slowest port wins (cycles)."""
    r = tile_rates(k, n, t)
    w = tile_workloads(m, k, n, t)
    return max(w["w_lhs"] / r["r_lhs"], w["w_rhs"] / r["r_rhs"],
               w["w_o"] / r["r_o"])


# ------------------------------------------------------------- eq 16-18 ----
def dsp_tile(t: TileConfig, weight_wl: int) -> int:
    return t.mt * t.nt * math.ceil(t.kf / f_packing(weight_wl))


def bram18(depth: int, bitwidth: int) -> int:
    """BRAM18K units for a FIFO of `depth` x `bitwidth` bits."""
    return max(1, math.ceil(depth * bitwidth / 18432))


def bram_tile(k: int, t: TileConfig, weight_wl: int, act_wl: int) -> int:
    depth = math.ceil(k / t.kf)
    per_pe = math.ceil(t.kf / f_packing(weight_wl))
    b_lhs = t.mt * per_pe * bram18(depth, act_wl)
    b_rhs = t.nt * per_pe * bram18(depth, weight_wl)
    return b_lhs + b_rhs


# ---------------------------------------------------------------- eq 19 ----
def bandwidth_bits_per_cycle(m, k, n, t: TileConfig, weight_wl, act_wl):
    w = tile_workloads(m, k, n, t)
    lat = tile_latency(m, k, n, t)
    bits = w["w_lhs"] * act_wl + w["w_rhs"] * weight_wl + w["w_o"] * act_wl
    return bits / lat


# ------------------------------------------------------- engine schedules --
@dataclasses.dataclass
class EnginePoint:
    kind: str                 # baseline | single | cascade
    latency_cycles: float
    dsp: int
    bram: int
    bandwidth: float          # bits/cycle required for full throughput
    config: dict


def baseline_engine(m, k, n, t: TileConfig, weight_wl=4, act_wl=8):
    return EnginePoint(
        "baseline", tile_latency(m, k, n, t), dsp_tile(t, weight_wl),
        bram_tile(k, t, weight_wl, act_wl),
        bandwidth_bits_per_cycle(m, k, n, t, weight_wl, act_wl),
        {"tile": dataclasses.asdict(t)},
    )


def single_engine(m, k, n, r, t: TileConfig, weight_wl=4, act_wl=8):
    """One array reused temporally: XW1 (M,K,R) then (XW1)W2 (M,R,N).
    The Nt factor tiles both R and N (paper §V-B); the Mt x R intermediate
    stays on-chip (no off-chip traffic for it)."""
    lat = tile_latency(m, k, r, t) + tile_latency(m, r, n, t)
    w_bits = (m * k * act_wl                 # X in
              + (m / t.mt) * k * r * weight_wl     # W1 streams
              + (m / t.mt) * r * n * weight_wl     # W2 streams
              + m * n * act_wl)              # Y out
    return EnginePoint(
        "single", lat, dsp_tile(t, weight_wl),
        bram_tile(k, t, weight_wl, act_wl) + _interm_bram(t.mt, r, act_wl),
        w_bits / lat, {"tile": dataclasses.asdict(t), "rank": r},
    )


def cascade_engine(m, k, n, r, t1: TileConfig, t2: TileConfig,
                   weight_wl=4, act_wl=8):
    """Two spatially pipelined arrays (same Mt); latency = slower stage."""
    assert t1.mt == t2.mt
    l1 = tile_latency(m, k, r, t1)
    l2 = tile_latency(m, r, n, t2)
    lat = max(l1, l2)
    w_bits = (m * k * act_wl
              + (m / t1.mt) * k * r * weight_wl
              + (m / t2.mt) * r * n * weight_wl
              + m * n * act_wl)
    return EnginePoint(
        "cascade", lat,
        dsp_tile(t1, weight_wl) + dsp_tile(t2, weight_wl),
        bram_tile(k, t1, weight_wl, act_wl)
        + bram_tile(r, t2, weight_wl, act_wl)
        + _interm_bram(t1.mt, r, act_wl),
        w_bits / lat,
        {"tile1": dataclasses.asdict(t1), "tile2": dataclasses.asdict(t2),
         "rank": r},
    )


def _interm_bram(mt, r, act_wl):
    return mt * bram18(r, act_wl)


# ----------------------------------------------------------------- search --
def _tile_space(max_mt=64, max_nt=64, max_kf=64):
    two = [1, 2, 4, 8, 16, 32, 64]
    for mt in two:
        for nt in two:
            for kf in two:
                if mt <= max_mt and nt <= max_nt and kf <= max_kf:
                    yield TileConfig(mt, nt, kf)


def pareto_front(points, x="bandwidth", y="latency_cycles"):
    pts = sorted(points, key=lambda p: (getattr(p, x), getattr(p, y)))
    front, best = [], float("inf")
    for p in pts:
        if getattr(p, y) < best:
            front.append(p)
            best = getattr(p, y)
    return front


def explore(m, k, n, r=None, *, weight_wl=4, act_wl=8, platform=ZCU111):
    """All feasible engine points under the platform constraints."""
    out = []
    for t in _tile_space():
        bp = baseline_engine(m, k, n, t, weight_wl, act_wl)
        if bp.dsp <= platform["dsp"] and bp.bram <= platform["bram18k"]:
            out.append(bp)
        if r is None:
            continue
        sp = single_engine(m, k, n, r, t, weight_wl, act_wl)
        if sp.dsp <= platform["dsp"] and sp.bram <= platform["bram18k"]:
            out.append(sp)
        for t2 in _tile_space(max_mt=t.mt):
            if t2.mt != t.mt:
                continue
            cp = cascade_engine(m, k, n, r, t, t2, weight_wl, act_wl)
            if cp.dsp <= platform["dsp"] and cp.bram <= platform["bram18k"]:
                out.append(cp)
    return out
