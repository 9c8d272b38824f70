"""The one generator of the benchmark's inputs, read from a traffic file.

A traffic file (``portbench/traffic/<name>.json``) names its driver
(``train`` or ``rollout``) and the parameters of the mix; a configuration
file names the initial conditions its model is trained and served on
(``ic``).  Everything drawn comes from ``--seed``.

Two kinds of initial condition:

* ``randomized_grid``: the training distribution of the Burgers model, an
  ``n x n`` grid of Gaussian bumps with noise on means, values, scalings and
  transforms, laid out over ``edge_max^2`` interior slots behind the fixed
  boundary Gaussians.  :func:`epoch_inputs` repeats, draw for draw from the
  same ``torch.Generator``, what a training epoch draws (the reference
  follows the program's epochs with it); :func:`rollout_ics` draws the
  rollout requests' conditions on the device, every grid edge of the range
  in every block of 25 requests, in an order drawn from the seed.
* ``stored_state``: a trajectory's stored curl-fit state of the dataset
  (``ns_data``), padded to capacity; the trajectories of the training set
  or of all of them, in an order drawn from the seed.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

State = Dict[str, torch.Tensor]


def boundary_gaussians(count: int, dtype, device):
    """``count`` fixed Gaussians, a quarter on each side of [-1, 1]^2:
    ``(means, scaling, transforms, u)`` with value 0, variance 1/count."""
    kw = dict(dtype=dtype, device=device)
    q = count // 4
    ones = torch.ones(q, **kw)
    rng = torch.linspace(-1, 1, q, **kw)
    means = torch.cat([torch.stack([-ones, rng], -1),
                       torch.stack([ones, rng], -1),
                       torch.stack([rng, -ones], -1),
                       torch.stack([rng, ones], -1)])
    return (means, torch.ones((count, 2), **kw) / count,
            torch.zeros((count, 1), **kw), torch.zeros((count, 1), **kw))


def grid_state(ic: dict, capacity: int, n: int, dtype, device) -> State:
    """The noise-free ``n x n`` grid of bumps ``exp(-|x|^2 / 0.2) / 3`` in
    the first ``n^2`` of ``edge_max^2`` interior slots (the others inactive),
    after ``ic["boundary"]`` boundary Gaussians."""
    kw = dict(dtype=dtype, device=device)
    n_max = ic["edge_max"]
    bm, bs, bt, bu = boundary_gaussians(ic["boundary"], dtype, device)
    nb = bm.shape[0]
    slots = n_max * n_max
    s = torch.arange(slots, device=device)
    gi = torch.clamp(torch.div(s, n, rounding_mode="floor"), max=n - 1)
    gj = torch.clamp(s % n, max=n - 1)
    step = 2.0 / max(n - 1.0, 1.0)
    means = torch.stack([-1.0 + gi.to(dtype) * step,
                         -1.0 + gj.to(dtype) * step], -1)
    scaling = torch.exp(torch.full((slots, 2), -4.0, **kw)) * (
        1.0 / (n / 20.0))
    u = (torch.exp(-0.5 * (means * means).sum(-1) / 0.1) / 3.0)[:, None]
    pad = capacity - nb - slots
    active = torch.cat([torch.ones(nb, dtype=torch.bool, device=device),
                        s < n * n, torch.zeros(pad, dtype=torch.bool,
                                               device=device)])

    def assemble(b, x, fill=0.0):
        return torch.cat([b, x, torch.full((pad,) + tuple(x.shape[1:]), fill,
                                           **kw)])
    return {"means": assemble(bm, means),
            "scaling": torch.where(active[:, None], assemble(bs, scaling, 1.0),
                                   torch.ones((capacity, 2), **kw)),
            "transforms": assemble(bt, torch.zeros((slots, 1), **kw)),
            "u": assemble(bu, u), "active": active,
            "boundary": torch.arange(capacity, device=device) < nb}


def add_ic_noise(state: State, draws, noise: dict) -> State:
    """Noise on the interior slots from four standard-normal draws shaped
    like ``(means, u, scaling, transforms)``."""
    inner = (state["active"] & ~state["boundary"])[:, None]
    gate = inner.to(state["means"].dtype)
    d_m, d_u, d_s, d_t = draws
    means = state["means"] + d_m * noise["means"] * gate
    means = torch.where(inner, torch.tanh(means) * noise["means_squash"],
                        means)
    return dict(state, means=means, u=state["u"] + d_u * noise["u"] * gate,
                scaling=torch.where(inner, state["scaling"] * torch.exp(
                    d_s * noise["scaling"]), state["scaling"]),
                transforms=torch.where(inner, torch.tanh(
                    d_t * noise["transforms"]), state["transforms"]))


def stored_state(data: dict, index: int, capacity: int, dtype,
                 device) -> State:
    """Trajectory ``index``'s stored Gaussians, padded: free slots have
    value 0 and variance 1."""
    parts = [torch.as_tensor(np.asarray(data[k][index])).to(device, dtype)
             for k in ("means", "scaling", "transforms", "u")]
    n = parts[0].shape[0]
    pad = capacity - n

    def padded(x, fill):
        return torch.cat([x, x.new_full((pad,) + tuple(x.shape[1:]), fill)])
    idx = torch.arange(capacity, device=device)
    return {"means": padded(parts[0], 0.0), "scaling": padded(parts[1], 1.0),
            "transforms": padded(parts[2], 0.0), "u": padded(parts[3], 0.0),
            "active": idx < n,
            "boundary": torch.zeros(capacity, dtype=torch.bool, device=device)}


def trajectories(config: dict, which: str) -> List[int]:
    """The dataset's trajectories a mix draws from: ``all``, or ``train``
    (every one but the held-out one)."""
    ic = config["ic"]
    every = list(range(ic["trajectories"]))
    if which == "all":
        return every
    if which == "train":
        return [i for i in every if i != ic["held_out"]]
    raise ValueError(f"unknown trajectory set {which!r}")


def epoch_inputs(config: dict, generator: torch.Generator, n_samples: int,
                 dtype, device, data: Optional[dict] = None,
                 train_set: Optional[List[int]] = None) -> dict:
    """What one training epoch draws from ``generator``, in the order it
    draws it: the collocation points in [-1, 1]^2, their times in [0, 1),
    the boundary band points (x or y in +-[1, 1.5]), then the initial
    condition: a trajectory of ``train_set`` (``stored_state``) or a grid
    edge in [edge_min, edge_max_draw) and the noise (``randomized_grid``).
    The draws are made on the generator's device in ``dtype`` and then
    moved; the returned state is built in ``dtype`` on ``device``."""
    def rand(*shape):
        return torch.rand(shape, generator=generator, dtype=torch.float32,
                          device=generator.device)
    m = n_samples
    samples = rand(m, 2) * 2.0 - 1.0
    times = rand(m)
    q = m // 4
    r1, r2, r3 = rand(q), rand(q), rand(m)
    ones = torch.ones(q)
    bands = torch.cat([-ones - r1 * 0.5, ones + r2 * 0.5])
    tang = (r3 * 2.0 - 1.0) * 1.5
    bc = torch.cat([torch.stack([bands, tang[:m // 2]], -1),
                    torch.stack([tang[m // 2:], bands], -1)])
    ic = config["ic"]
    out = {"samples": samples.to(device, dtype),
           "times": times.to(device, dtype),
           "bc_samples": bc.to(device, dtype)}
    if ic["kind"] == "stored_state":
        k = int(torch.randint(0, len(train_set), (), generator=generator,
                              device=generator.device))
        out["trajectory"] = train_set[k]
        out["state"] = stored_state(data, train_set[k], config["capacity"],
                                    dtype, device)
        return out
    n = min(int(torch.randint(ic["edge_min"], ic["edge_max_draw"], (),
                              generator=generator, device=generator.device)),
            ic["edge_max"])
    state = grid_state(ic, config["capacity"], n, torch.float32, "cpu")
    draws = [torch.randn(state[k].shape, generator=generator,
                         dtype=torch.float32, device=generator.device)
             for k in ("means", "u", "scaling", "transforms")]
    state = {k: v.to(device) for k, v in state.items()}
    state = {k: (v.to(dtype) if v.is_floating_point() else v)
             for k, v in state.items()}
    out["edge"] = n
    out["state"] = add_ic_noise(state, [d.to(device, dtype) for d in draws],
                                ic["noise"])
    return out


def recon_targets(data: dict, trajectory: int, samples: torch.Tensor,
                  n_steps: int) -> torch.Tensor:
    """Step i's target: the dataset's vorticity frame i + 1 (the last one
    past the end) at the pixel that holds each sample."""
    frames = torch.as_tensor(np.asarray(data["frames"][trajectory]))
    res = frames.shape[0]
    pix = torch.clamp(((samples.cpu().float() + 1.0) / 2.0 * res).to(
        torch.int32), 0, res - 1).long()
    out = [frames[pix[:, 1], pix[:, 0], min(i + 1, frames.shape[-1] - 1)]
           for i in range(n_steps)]
    return torch.stack(out).to(samples.device, samples.dtype)


def blocks(values: List[int], count: int, gen: torch.Generator,
           device) -> torch.Tensor:
    """``count`` requests in blocks of ``len(values)``, each block every
    value once in an order drawn from ``gen``: any stretch of requests
    holds every value nearly equally often, whatever the seed."""
    reps = math.ceil(count / len(values))
    vals = torch.tensor(values, device=device)
    order = [vals[torch.randperm(len(values), generator=gen, device=device)]
             for _ in range(reps)]
    return torch.cat(order)[:count]


def rollout_ics(config: dict, traffic: dict, seed: int, count: int,
                device, data: Optional[dict] = None) -> dict:
    """``count`` initial conditions for the rollout requests, drawn on
    ``device`` from ``seed`` in a few batched calls.  ``randomized_grid``:
    every grid edge of [edge_min, edge_max_draw) the same number of times,
    in an order drawn from the seed, each with its own noise; returned as a
    dict of ``(count, capacity, ...)`` float32 tensors.  ``stored_state``:
    the mix's trajectories, each equally often, in a drawn order; returned
    as ``{"trajectory": (count,)}``.  Both come in :func:`blocks`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    ic = config["ic"]
    if ic["kind"] == "stored_state":
        pool = trajectories(config, traffic["trajectories"])
        return {"trajectory": blocks(pool, count, gen, device).cpu()}
    edges = list(range(ic["edge_min"], ic["edge_max_draw"]))
    n = torch.clamp(blocks(edges, count, gen, device), max=ic["edge_max"])
    cap, nb, n_max = config["capacity"], ic["boundary"], ic["edge_max"]
    slots = n_max * n_max
    kw = dict(dtype=torch.float32, device=device)
    s = torch.arange(slots, device=device)[None, :]
    nn = n[:, None]
    gi = torch.minimum(torch.div(s, nn, rounding_mode="floor"), nn - 1)
    gj = torch.minimum(s % nn, nn - 1)
    step = 2.0 / torch.clamp(nn.to(torch.float32) - 1.0, min=1.0)
    gx, gy = -1.0 + gi * step, -1.0 + gj * step
    means = torch.stack([gx, gy], -1)
    var = torch.exp(torch.tensor(-4.0, **kw)) / (nn.to(torch.float32) / 20.0)
    scaling = var[..., None].expand(count, slots, 2)
    u = (torch.exp(-0.5 * (means * means).sum(-1) / 0.1) / 3.0)[..., None]
    inner = s < nn * nn
    bm, bs, bt, bu = boundary_gaussians(nb, torch.float32, device)
    pad = cap - nb - slots

    def batch(b, x, fill):
        b = b[None].expand(count, *b.shape)
        return torch.cat([b, x, torch.full((count, pad) + tuple(x.shape[2:]),
                                           fill, **kw)], 1)
    active = torch.cat([torch.ones((count, nb), dtype=torch.bool,
                                   device=device), inner,
                        torch.zeros((count, pad), dtype=torch.bool,
                                    device=device)], 1)
    boundary = (torch.arange(cap, device=device) < nb)[None].expand(count, cap)
    state = {"means": batch(bm, means, 0.0),
             "scaling": torch.where(active[..., None],
                                    batch(bs, scaling, 1.0),
                                    torch.ones((count, cap, 2), **kw)),
             "transforms": batch(bt, torch.zeros((count, slots, 1), **kw),
                                 0.0),
             "u": batch(bu, u, 0.0), "active": active,
             "boundary": boundary.clone()}
    noise = [torch.randn(state[k].shape, generator=gen, **kw)
             for k in ("means", "u", "scaling", "transforms")]
    inner_all = (active & ~boundary)[..., None]
    gate = inner_all.to(torch.float32)
    nz = ic["noise"]
    m2 = state["means"] + noise[0] * nz["means"] * gate
    state["means"] = torch.where(inner_all,
                                 torch.tanh(m2) * nz["means_squash"], m2)
    state["u"] = state["u"] + noise[1] * nz["u"] * gate
    state["scaling"] = torch.where(inner_all, state["scaling"] * torch.exp(
        noise[2] * nz["scaling"]), state["scaling"])
    state["transforms"] = torch.where(inner_all, torch.tanh(
        noise[3] * nz["transforms"]), state["transforms"])
    state["edge"] = n.cpu()
    return state
