"""The work a step needs, counted from the equations, and the card's peaks.

One count serves the kernels' roofline shares and the steps' ``mfu``.  It
counts the work of the *active* Gaussians and of the neighbour pairs the
state has, never the padded capacity, and it is a floor: work that no
implementation of the equations avoids.  A kernel that skips masked slots
therefore gains share, and no correct kernel reads above 100 %.

Mixture, per (sample, active Gaussian) pair, d = 2, ``K`` packed field
components up to the order (1, 3, 6, 10 for orders 0-3), ``c`` channels:

* geometry: ``d = x - mu`` (2), ``P = C d`` (6), the exponent ``-d.P / 2``
  with the half folded into ``C`` per Gaussian (3): 11 FLOP and one exp;
  a periodic wrap adds ``d - L round(d / L)`` per axis (8).
* weights: the Hermite-like factors of ``d^k g / dx^k`` from ``P`` and
  ``C``: none up to order 1 (``-P``), ``P_a P_b - C_ab`` at order 2 (6),
  and at order 3 four components from the order-2 ones (2 + 3 + 3 + 2 =
  10): cumulative (0, 0, 6, 16).
* forward: one multiply-add per output component and channel: ``2 K c``.
* backward, Gaussian side: the geometry and weights again (the forward's
  exponentials are not kept), one multiply-add per cotangent component and
  channel (``2 K c``) and one into each of the ``5 + c`` gradient
  accumulators (means 2, packed conic 3, values c): ``2 (5 + c)``.

Bytes: every input read once and every output written once, float32.

Network, per active Gaussian: ``2 in out`` for each dense layer applied to
every Gaussian (the global transform nets act once and are left out), the
canonical transforms' small products, and per head ``mapped = W_t f``
(``2 L^2``).  Aggregation, per neighbour pair and head: the logit (``2 K``),
the masked softmax (3 FLOP, one exp), the displacement's 2 F d angles at
two octaves (``2 + 2 F d`` FLOP, ``4 F d`` sin and cos), the gate ``W_d
emb`` (``2 L 2E``) and ``alpha mapped gate`` (``3 L``); per step, the
neighbour test over the active pairs (7 FLOP each).  The backward of a
dense layer forms the weights' gradient (``2 in out``) and, past the first
layer of a chain, the inputs' (``2 in out``); the aggregation's backward
per pair forms ``W_d``'s gradient (``2 L 2E``), the gate's and mapped's
cotangents (``4 L``), alpha's (``2 L``) and the logit's into q and k
(``4 K``).  The means the network reads carry no gradient.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

# An H100 SXM's peaks (NVIDIA's data sheet, at 700 W): float32 outside the
# tensor cores, special-function results (exp, sin, cos: 132 SMs x 16 a
# clock x 1.98 GHz) and HBM3 bytes, per second.
PEAK_FLOP_S = 67e12
PEAK_SFU_S = 4.18e12
PEAK_BYTES_S = 3.35e12

GEOMETRY_FLOP = 11
WRAP_FLOP = 8
WEIGHT_FLOP = (0, 0, 6, 16)


def components(order: int) -> int:
    """Packed field components up to ``order``: 1, 3, 6, 10."""
    return (order + 1) * (order + 2) // 2


def mixture_pair_flop(kind: str, order: int, c: int, periodic: bool) -> int:
    """FLOP per (sample, active Gaussian) pair of the forward (``fwd``)
    or the Gaussian-side backward (``bwd``)."""
    k = components(order)
    geom = GEOMETRY_FLOP + (WRAP_FLOP if periodic else 0) + WEIGHT_FLOP[order]
    if kind == "fwd":
        return geom + 2 * k * c
    if kind == "bwd":
        return geom + 2 * k * c + 2 * (5 + c)
    raise ValueError(f"unknown mixture pass {kind!r}")


def mixture_work(kind: str, m: int, n: int, order: int, c: int,
                 periodic: bool) -> Tuple[float, float, float]:
    """``(flop, sfu, bytes)`` of one pass over ``m`` samples and ``n``
    active Gaussians."""
    pairs = float(m) * float(n)
    k = components(order)
    nbytes = 2 * m + (5 + c) * n + k * c * m
    if kind == "bwd":
        nbytes += k * c * m + (5 + c) * n
    return (pairs * mixture_pair_flop(kind, order, c, periodic), pairs,
            4.0 * nbytes)


def bound_s(flop: float, sfu: float, nbytes: float) -> Tuple[float, str]:
    """The least time the card could take, and what sets it."""
    times = {"FLOP": flop / PEAK_FLOP_S, "SFU": sfu / PEAK_SFU_S,
             "bytes": nbytes / PEAK_BYTES_S}
    by = max(times, key=times.get)
    return times[by], by


# ---------------------------------------------------------------- network --

def dense_chains(shapes: Dict[str, Tuple[int, ...]]) -> Dict[str, list]:
    """The per-Gaussian dense chains of the network from its parameters'
    flax names and shapes: ``{chain: [(in, out), ...]}``, the global
    transform nets left out."""
    chains: Dict[str, list] = {}
    for name, shape in shapes.items():
        if not name.endswith("/kernel") or "/transform_" in name:
            continue
        chain, layer = name[:-len("/kernel")].rsplit("/Dense_", 1)
        chains.setdefault(chain, []).append((int(layer), tuple(shape)))
    return {k: [s for _, s in sorted(v)] for k, v in chains.items()}


def network_per_gaussian_flop(shapes: Dict[str, Tuple[int, ...]], c: int,
                              pde_size: int, heads: int, latent: int,
                              backward: bool = False) -> float:
    """FLOP per active Gaussian of the network's dense layers (forward, or
    the backward's), the canonical transforms and ``W_t f``."""
    total = 0.0
    for layers in dense_chains(shapes).values():
        for i, (fan_in, fan_out) in enumerate(layers):
            f = 2.0 * fan_in * fan_out
            total += (f + (f if i > 0 else 0.0)) if backward else f
    per_head = 2.0 * latent * latent
    transforms = 2.0 * (8 + 2 * c * c + 2 * (2 * c) ** 2 + pde_size ** 2)
    if backward:
        return total + heads * 2 * per_head + 2 * transforms
    return total + heads * per_head + transforms


def aggregation_pair_flop(latent: int, key: int, freqs: int, d: int = 2,
                          backward: bool = False) -> Tuple[float, float]:
    """``(flop, sfu)`` per neighbour pair and head."""
    e2 = 2 * (1 + 2 * freqs * d)
    if backward:
        return 2.0 * latent * e2 + 6.0 * latent + 4.0 * key, 0.0
    flop = 2 * key + 3 + 2 + 2 * freqs * d + 2 * latent * e2 + 3 * latent
    return float(flop), 1.0 + 4.0 * freqs * d


def network_step_flop(shapes, c: int, pde_size: int, heads: int, latent: int,
                      freqs: int, active: float, pairs: float,
                      backward: bool) -> float:
    """FLOP of one network call at ``active`` Gaussians and ``pairs``
    neighbour pairs (both heads share the neighbourhood), with the
    backward's when ``backward``."""
    f = active * network_per_gaussian_flop(shapes, c, pde_size, heads, latent)
    f += heads * pairs * aggregation_pair_flop(latent, latent, freqs)[0]
    f += 7.0 * active * active
    if backward:
        f += active * network_per_gaussian_flop(shapes, c, pde_size, heads,
                                                latent, backward=True)
        f += heads * pairs * aggregation_pair_flop(
            latent, latent, freqs, backward=True)[0]
    return f


def total(items: Iterable[Tuple[float, float, float]]):
    flop = sfu = nbytes = 0.0
    for a, b, c in items:
        flop, sfu, nbytes = flop + a, sfu + b, nbytes + c
    return flop, sfu, nbytes
