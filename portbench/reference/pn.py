"""Plain PyTorch reference of the PN model: the mixture field and its
derivatives, the dynamics network, the timestep, the physics losses, the
adaptive split, Adam, and the two rollouts.

Written from the model's equations, in dense tensor operations that run in
any float dtype on any device, with nothing cached, batched or fused.  It
imports nothing of the program under test: the parameters come from the
fixture's arrays under their flax names (``params/delta_net/Dense_0/kernel``,
a kernel ``(in, out)``: ``y = x @ kernel + bias``), a state is a dict of
``means (N, 2)``, ``scaling (N, 2)`` (variances), ``transforms (N, 1)``,
``u (N, c)``, ``active (N,)`` and ``boundary (N,)``.

The neighbour aggregation is the dense form (the displacement embedding of
every pair formed explicitly), not the angle-addition factorisation the
network runs.  Where the equations leave a choice open (the split's slot
order, the eigenvector's sign) the choice changes no loss, gradient or
frame: the network is equivariant to a permutation of the Gaussians.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

Params = Dict[str, torch.Tensor]

B1, B2, EPS = 0.9, 0.999, 1e-8
SIGMA_CUT = 3.0
RECON_WEIGHT = 5.0
# Loss weights of every problem but TEST (pde, bc, conservation, initial;
# du, dmean, dtransform, dscale inside the conservation term).
W_PDE, W_BC, W_CONS = 1.0, 1.0, 0.1
W_DU, W_DMEAN, W_DTRANSFORM, W_DSCALE = 1.0, 2.0, 2.0, 2.0


class Model:
    """What the equations need of a configuration: ``problem`` ("burgers"
    or "ns"), channels, the PDE feature width, the period, viscosity and
    the split criteria."""

    def __init__(self, problem: str, capacity: int):
        if problem not in ("burgers", "ns"):
            raise ValueError(f"reference has no problem {problem!r}")
        self.problem = problem
        self.ns = problem == "ns"
        self.capacity = capacity
        self.c = 2 if self.ns else 1
        self.pde_size = 1 if self.ns else self.c
        self.period = 2.0 if self.ns else None
        self.nu = 1e-3 if self.ns else 1.0 / (10.0 * math.pi)
        self.order = 3 if self.ns else 2
        self.criteria = "vorticity" if self.ns else "value"


# ---------------------------------------------------------------- mixture --

def covariances(scaling, transforms):
    """``(cov, conic)``, each ``(N, 2, 2)``: the off-diagonal is
    ``tanh(t) sqrt(s_x s_y)``."""
    off = torch.tanh(transforms[:, 0]) * torch.sqrt(scaling[:, 0]
                                                     * scaling[:, 1])
    a, c = scaling[:, 0], scaling[:, 1]
    cov = torch.stack([torch.stack([a, off], -1), torch.stack([off, c], -1)],
                      -2)
    det = a * c - off * off
    conic = torch.stack([torch.stack([c / det, -off / det], -1),
                         torch.stack([-off / det, a / det], -1)], -2)
    return cov, conic


def wrap(x, period):
    return x if period is None else x - period * torch.round(x / period)


def mixture(means, conics, values, samples, order, mask=None, period=None,
            chunk=512):
    """``u (m, c)``, ``ux (m, 2, c)``, ``uxx (m, 2, 2, c)``, ``uxxx (m, 2,
    2, 2, c)`` up to ``order`` of ``sum_i v_i exp(-d^T C_i d / 2)``,
    ``d = x - mu_i``, over the Gaussians where ``mask`` holds; blocks of
    ``chunk`` samples."""
    out = {"u": [], "ux": [], "uxx": [], "uxxx": []}
    w = values if mask is None else values * mask.to(values.dtype)[:, None]
    for x in torch.split(samples, chunk):
        d = wrap(x[:, None, :] - means[None, :, :], period)       # (b, n, 2)
        p = torch.einsum("nab,mnb->mna", conics, d)
        g = torch.exp(-0.5 * (d * p).sum(-1))
        gv = g[:, :, None] * w[None]                               # (b, n, c)
        out["u"].append(gv.sum(1))
        if order >= 1:
            out["ux"].append(-torch.einsum("mna,mnc->mac", p, gv))
        if order >= 2:
            h = p[..., :, None] * p[..., None, :] - conics[None]
            out["uxx"].append(torch.einsum("mnab,mnc->mabc", h, gv))
        if order >= 3:
            t = (conics[None, :, :, :, None] * p[:, :, None, None, :]
                 + conics[None, :, :, None, :] * p[:, :, None, :, None]
                 + conics[None, :, None, :, :] * p[:, :, :, None, None]
                 - p[:, :, :, None, None] * p[:, :, None, :, None]
                 * p[:, :, None, None, :])
            out["uxxx"].append(torch.einsum("mnabe,mnc->mabec", t, gv))
    return {k: torch.cat(v) for k, v in out.items() if v}


# ---------------------------------------------------------------- network --

def _layers(params: Params, prefix: str):
    n = 0
    while f"{prefix}/Dense_{n}/kernel" in params:
        n += 1
    return [(params[f"{prefix}/Dense_{i}/kernel"],
             params[f"{prefix}/Dense_{i}/bias"]) for i in range(n)]


def mlp(params, prefix, x, tanh_last=False):
    layers = _layers(params, prefix)
    for i, (k, b) in enumerate(layers):
        x = x @ k + b
        if tanh_last or i < len(layers) - 1:
            x = torch.tanh(x)
    return x


def _near_identity(params, name, latent, k):
    a = mlp(params, f"params/InputTransform_0/{name}/MLP_0", latent)
    return torch.eye(k, dtype=latent.dtype, device=latent.device) + \
        a.reshape(k, k)


def neighbour_mask(means, cov, active, period):
    """Pairs (i, j), i != j, both active, with ``|mu_j - mu_i| <= 3 (r_i +
    r_j)``, ``r = sqrt(max diag cov)``."""
    rel = wrap(means[None, :, :] - means[:, None, :], period)
    dist = torch.sqrt((rel * rel).sum(-1))
    r = torch.sqrt(torch.diagonal(cov, dim1=-2, dim2=-1).amax(-1))
    mask = dist <= SIGMA_CUT * (r[:, None] + r[None, :])
    n = means.shape[0]
    mask &= ~torch.eye(n, dtype=torch.bool, device=means.device)
    return mask & active[None, :] & active[:, None]


def _embedding(rel, freqs):
    """``[1, sin(f_k r_a), cos(f_k r_a)]``, flat index ``k * 2 + a``."""
    ph = (rel[..., None, :] * freqs[:, None]).flatten(-2)
    one = torch.ones(rel.shape[:-1] + (1,), dtype=rel.dtype,
                     device=rel.device)
    return torch.cat([one, torch.sin(ph), torch.cos(ph)], -1)


def aggregate(features, transform, q, k, freqs, dist_tf, means, mask, period,
              rows=256):
    """``out_i = sum_j alpha_ij (W_t f_j) * (W_d emb(mu_j - mu_i))`` with
    ``alpha`` the masked softmax of ``q_i . k_j / sqrt(K)`` (0 without a
    neighbour), in blocks of ``rows``."""
    mapped = features @ transform.T
    scale = 1.0 / math.sqrt(q.shape[-1])
    outs = []
    for lo in range(0, features.shape[0], rows):
        hi = min(lo + rows, features.shape[0])
        m = mask[lo:hi]
        logits = (q[lo:hi] @ k.T) * scale
        logits = torch.where(m, logits, torch.full_like(logits, -1e300
                             if logits.dtype == torch.float64 else -3e38))
        top = logits.amax(-1, keepdim=True).detach()
        e = torch.exp(logits - top) * m
        alpha = e / torch.clamp(e.sum(-1, keepdim=True), min=1e-30)
        rel = wrap(means[None, :, :] - means[lo:hi, None, :], period)
        emb = torch.cat([_embedding(rel, freqs), _embedding(2.0 * rel, freqs)],
                        -1)
        gate = torch.einsum("ije,le->ijl", emb, dist_tf)
        outs.append(torch.einsum("ij,jl,ijl->il", alpha, mapped, gate))
    return torch.cat(outs)


def network(params: Params, freqs, means, cov, u, boundary, su, sux, suxx,
            spde, active, nbr, period):
    """The deltas ``(dmeans, dscaling, dtransforms, du)`` and the two
    heads' ``mean(agg^2)``."""
    n = means.shape[0]
    dt = means.dtype
    c = u.shape[1]
    b = boundary.to(dt)[:, None]
    x = torch.cat([means, cov.reshape(n, 4), u, b, su, sux, suxx, spde], -1)
    per = mlp(params, "params/InputTransform_0/latent_net", x, tanh_last=True)
    wa = active.to(dt)[:, None]
    latent = (per * wa).sum(0) / torch.clamp(wa.sum(), min=1.0)
    t = _near_identity(params, "transform_net", latent, 2)
    t_u = _near_identity(params, "transform_u_net", latent, c)
    t_ux = _near_identity(params, "transform_ux_net", latent, 2 * c)
    t_uxx = _near_identity(params, "transform_uxx_net", latent, 2 * c)
    t_pde = _near_identity(params, "transform_pde_net", latent, spde.shape[1])
    tp = torch.cat([torch.einsum("ab,nbc->nac", t, cov).reshape(n, -1),
                    u @ t_u.T, b, su @ t_u.T, sux @ t_ux.T, suxx @ t_uxx.T,
                    spde @ t_pde.T], -1)
    feats = mlp(params, "params/input_projection", tp)
    parts, mags = [feats], []
    h = 0
    while f"params/transform_{h}" in params:
        agg = aggregate(feats, params[f"params/transform_{h}"] - 1.0,
                        mlp(params, f"params/query_{h}", feats),
                        mlp(params, f"params/key_{h}", feats), freqs,
                        params[f"params/distance_transform_{h}"] - 1.0,
                        means, nbr, period)
        mags.append(torch.mean(agg ** 2))
        parts.append(agg)
        h += 1
    out = mlp(params, "params/delta_net", torch.cat(parts, -1)) * wa
    return (out[:, 0:2], out[:, 2:4], out[:, 4:5], out[:, 5:5 + c],
            torch.stack(mags))


# ---------------------------------------------------------------- physics --

def _ns_vorticity(f):
    """``w, wx, wxx`` from fields of order 3 (``u`` = velocity)."""
    return (f["ux"][:, 0, 1] - f["ux"][:, 1, 0],
            f["uxx"][..., 0, 1] - f["uxx"][..., 1, 0],
            f["uxxx"][..., 0, 1] - f["uxxx"][..., 1, 0])


def pde_rhs(model: Model, u, ux, uxx, wx=None, wxx=None):
    if model.ns:
        return model.nu * (wxx[:, 0, 0] + wxx[:, 1, 1]) - (
            u[:, 0] * wx[:, 0] + u[:, 1] * wx[:, 1])
    return model.nu * (uxx[:, 0, 0] + uxx[:, 1, 1]) - u * ux[:, 0]


def interior(state):
    return state["active"] & ~state["boundary"]


def forward_step(model: Model, params, freqs, state, with_grad=True):
    """One timestep: the network reads the mixture at the means (no
    gradient through the read) and moves the interior Gaussians."""
    cov, conic = covariances(state["scaling"], state["transforms"])
    n = state["means"].shape[0]
    with torch.no_grad():
        f = mixture(state["means"], conic, state["u"], state["means"],
                    model.order, state["active"], model.period)
        if model.ns:
            _, wx, wxx = _ns_vorticity(f)
            spde = pde_rhs(model, f["u"], f["ux"], f["uxx"], wx, wxx)
        else:
            spde = pde_rhs(model, f["u"], f["ux"], f["uxx"])
        spde = spde.reshape(n, -1)
        sux = f["ux"].reshape(n, -1)
        suxx = torch.stack([f["uxx"][:, a, a, :] for a in range(2)],
                           1).reshape(n, -1)
        nbr = neighbour_mask(state["means"], cov, state["active"],
                             model.period)
    with torch.set_grad_enabled(with_grad):
        dm, ds, dtf, du, mags = network(
            params, freqs, state["means"], cov, state["u"], state["boundary"],
            f["u"], sux, suxx, spde, state["active"], nbr, model.period)
        gate = interior(state).to(dm.dtype)[:, None]
        means = state["means"] + dm * gate
        if model.period is not None:
            means = torch.where(interior(state)[:, None],
                                wrap(means, model.period), means)
        new = dict(state, means=means,
                   scaling=state["scaling"] * torch.exp(ds * gate),
                   transforms=state["transforms"] + dtf * gate,
                   u=state["u"] + du * gate)
    return new, (dm, ds, dtf, du, mags)


def sample_fields(model: Model, state, samples, bc_samples):
    _, conic = covariances(state["scaling"], state["transforms"])
    mask = interior(state)
    f = mixture(state["means"], conic, state["u"], samples, model.order, mask,
                model.period)
    f["bc_u"] = mixture(state["means"], conic, state["u"], bc_samples, 0,
                        mask, model.period)["u"]
    if model.ns:
        f["w"], f["wx"], f["wxx"] = _ns_vorticity(f)
    return f


def _masked_mean(x, mask):
    w = mask.to(x.dtype)
    while w.dim() < x.dim():
        w = w[..., None]
    w = torch.broadcast_to(w, x.shape)
    return (x * w).sum() / torch.clamp(w.sum(), min=1.0)


def losses(model: Model, state, deltas, prev, curr, time_samples, dt):
    """``(pde, bc, conservation, initial, magnitude)``, weighted; the
    optimised total is the sum of the first four."""
    ts = time_samples

    def mix(a, b):
        s = ts.reshape((-1,) + (1,) * (a.dim() - 1))
        return s * b + (1.0 - s) * a
    u, ux, uxx = (mix(prev[k], curr[k]) for k in ("u", "ux", "uxx"))
    if model.ns:
        wx, wxx = mix(prev["wx"], curr["wx"]), mix(prev["wxx"], curr["wxx"])
        rhs = dt * pde_rhs(model, u, ux, uxx, wx, wxx)
        pde = torch.mean((ux[:, 0, 0] + ux[:, 1, 1]) ** 2) + torch.mean(
            (curr["w"] - prev["w"] - rhs) ** 2)
        bc = torch.zeros((), dtype=u.dtype, device=u.device)
    else:
        rhs = dt * pde_rhs(model, u, ux, uxx)
        pde = torch.mean((curr["u"] - prev["u"] - rhs) ** 2)
        bc = torch.mean(curr["bc_u"] ** 2)
    dm, ds, dtf, du, mags = deltas
    inner = interior(state)
    cons = (W_DMEAN * _masked_mean(dm ** 2, inner)
            + W_DU * _masked_mean(du ** 2, inner)
            + W_DSCALE * _masked_mean(ds ** 2, inner)
            + W_DTRANSFORM * _masked_mean(dtf ** 2, inner))
    zero = torch.zeros((), dtype=u.dtype, device=u.device)
    return (W_PDE * pde, W_BC * bc, W_CONS * cons, zero,
            torch.mean((mags - 1.0) ** 2))


# ------------------------------------------------------------------ split --

def _density_rank(model, state, conic):
    ones = torch.ones_like(state["u"][:, :1])
    dens = mixture(state["means"], conic, ones, state["means"], 0,
                   state["active"], model.period)["u"]
    act = state["active"][:, None]
    lo = torch.where(act, dens, torch.inf).min()
    hi = torch.where(act, dens, -torch.inf).max()
    return 1.0 - (dens - lo) / torch.clamp(hi, min=1e-30)


def _principal_axis(cov):
    """``|lambda_max| v_max`` of ``(N, 2, 2)`` covariances."""
    a, b, c = cov[:, 0, 0], cov[:, 0, 1], cov[:, 1, 1]
    disc = torch.sqrt((0.5 * (a - c)) ** 2 + b * b)
    lam1, lam2 = 0.5 * (a + c) + disc, 0.5 * (a + c) - disc
    va = torch.stack([b, lam1 - a], -1)
    vb = torch.stack([lam1 - c, b], -1)
    v = torch.where((va.norm(dim=-1) >= vb.norm(dim=-1))[:, None], va, vb)
    iso = (disc == 0)[:, None]
    v = torch.where(iso, torch.tensor([1.0, 0.0], dtype=v.dtype,
                                      device=v.device), v)
    v = v / torch.clamp(v.norm(dim=-1, keepdim=True), min=1e-30)
    big = torch.where(lam1.abs() >= lam2.abs(), lam1, lam2)
    # The eigenvector of lam2 is v rotated by 90 degrees.
    v = torch.where((lam1.abs() >= lam2.abs())[:, None], v,
                    torch.stack([-v[:, 1], v[:, 0]], -1))
    return big.abs()[:, None] * v


@torch.no_grad()
def adaptive_split(model: Model, state, prev, quantile=0.98):
    """Prune the weak interior Gaussians, then split those whose field
    changed most since ``prev`` (above the 98th percentile of the
    density-weighted change), each into two halves displaced along the
    principal axis, the second into the next free slot."""
    s = dict(state)
    _, conic0 = covariances(s["scaling"], s["transforms"])
    if model.criteria == "vorticity":
        cx, cy = s["u"][:, 1], -s["u"][:, 0]
        quad = (conic0[:, 0, 0] * cx * cx + 2.0 * conic0[:, 0, 1] * cx * cy
                + conic0[:, 1, 1] * cy * cy)
        peak = math.exp(-0.5) * torch.sqrt(torch.clamp(quad, min=0.0))
        keep = peak > 0.01 * torch.where(s["active"], peak, -torch.inf).max()
    else:
        keep = s["u"].abs().norm(dim=-1) > 0.01
    s["active"] = s["active"] & (keep | s["boundary"])
    cov, conic = covariances(s["scaling"], s["transforms"])
    _, pconic = covariances(prev["scaling"], prev["transforms"])
    dens = _density_rank(model, s, conic)
    if model.criteria == "vorticity":
        now = mixture(s["means"], conic, s["u"], s["means"], 1, s["active"],
                      model.period)["ux"]
        old = mixture(prev["means"], pconic, prev["u"], s["means"], 1,
                      prev["active"], model.period)["ux"]
        metric = (((now[:, 0, 1] - now[:, 1, 0])
                   - (old[:, 0, 1] - old[:, 1, 0])) ** 2)[:, None] * dens
    else:
        now = mixture(s["means"], conic, s["u"], s["means"], 0, s["active"],
                      model.period)["u"]
        old = mixture(prev["means"], pconic, prev["u"], s["means"], 0,
                      prev["active"], model.period)["u"]
        metric = (now - old) ** 2 * dens
    inner = interior(s)
    q = torch.quantile(metric[inner].flatten(), quantile)
    want = (metric > q).any(-1) & inner
    axis = _principal_axis(cov)
    free = torch.nonzero(~s["active"]).flatten()
    flagged = torch.nonzero(want).flatten()
    moved = flagged[:free.numel()]
    dest = free[:moved.numel()]
    means, u = s["means"].clone(), s["u"].clone()
    scaling, transforms = s["scaling"].clone(), s["transforms"].clone()
    active = s["active"].clone()
    means[flagged] = s["means"][flagged] - axis[flagged]
    u[flagged] = s["u"][flagged] * 0.5
    means[dest] = s["means"][moved] + axis[moved]
    u[dest] = s["u"][moved] * 0.5
    scaling[dest] = s["scaling"][moved]
    transforms[dest] = s["transforms"][moved]
    active[dest] = True
    return dict(s, means=means, u=u, scaling=scaling, transforms=transforms,
                active=active)


# ---------------------------------------------------------------- training --

def adam(params: Params, names, grads, mu, nu, count, lr, clip_norm):
    """optax's ``clip_by_global_norm`` then Adam; a step with a non-finite
    gradient changes nothing.  Returns ``(params, mu, nu, count, clipped
    gradients)``."""
    if not all(bool(torch.isfinite(g).all()) for g in grads):
        return params, mu, nu, count, grads
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    if clip_norm is not None and not bool(norm < clip_norm):
        grads = [g / norm * clip_norm for g in grads]
    count = count + 1
    mu = [B1 * m + (1 - B1) * g for m, g in zip(mu, grads)]
    nu = [B2 * v + (1 - B2) * g * g for v, g in zip(nu, grads)]
    c1, c2 = 1 - B1 ** count, 1 - B2 ** count
    new = dict(params)
    for k, m, v in zip(names, mu, nu):
        new[k] = params[k] - lr * (m / c1) / (torch.sqrt(v / c2) + EPS)
    return new, mu, nu, count, grads


def epoch(model: Model, params, opt, freqs, names, state, samples,
          time_samples, bc_samples, n_steps, recipe, epoch_index,
          recon_targets=None):
    """``n_steps`` timesteps of one training epoch from ``state``: each a
    forward step, the losses against the previous step's fields, one
    gradient and one Adam update at ``base_lr * loss_weight``, then, past
    the split epoch, the adaptive split.  ``opt = (mu, nu, count)``.
    Returns ``(params, opt, per-step totals [pde, bc, cons, init, mag],
    per-step clipped gradients)``."""
    mu, nu, count = opt
    with torch.no_grad():
        prev = sample_fields(model, state, samples, bc_samples)
    lw = 1.0
    totals, step_grads = [], []
    for i in range(n_steps):
        leaves = [params[k].detach().requires_grad_(True) for k in names]
        p = dict(zip(names, leaves))
        new, deltas = forward_step(model, p, freqs, state)
        curr = sample_fields(model, new, samples, bc_samples)
        terms = losses(model, new, deltas, prev, curr, time_samples,
                       recipe["dt"])
        terms = [torch.where(torch.isfinite(t), t, torch.zeros_like(t))
                 for t in terms]
        total = terms[0] + terms[1] + terms[2] + terms[3]
        if recon_targets is not None:
            rec = RECON_WEIGHT * torch.mean(
                (curr["w"] - recon_targets[i]) ** 2)
            total = total + torch.where(torch.isfinite(rec), rec,
                                        torch.zeros_like(rec))
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip(leaves, grads)]
        lr = recipe["base_lr"] * lw
        params, mu, nu, count, clipped = adam(
            {k: v.detach() for k, v in p.items()}, names, grads, mu, nu,
            count, lr, recipe["clip_norm"])
        step_grads.append(clipped)
        totals.append([float(t.detach()) for t in terms])
        decay = math.exp(-recipe["epsilon"] * float(total.detach()))
        lw = max(lw * decay, recipe["loss_weight_floor"])
        new = {k: (v.detach() if torch.is_tensor(v) else v)
               for k, v in new.items()}
        with torch.no_grad():
            if epoch_index > recipe["split_epoch"]:
                new = adaptive_split(model, new, state)
            prev = sample_fields(model, new, samples, bc_samples)
        state = new
    return params, (mu, nu, count), totals, step_grads


# ---------------------------------------------------------------- rollout --

def image_samples(res, dtype, device):
    """Image layout: row r at y = 1 - 2 r / (res - 1), x the fast axis."""
    t = torch.linspace(-1.0, 1.0, res, dtype=dtype, device=device)
    gx, gy = torch.meshgrid(t, torch.flip(t, (0,)), indexing="xy")
    return torch.stack([gx, gy], -1).reshape(-1, 2)


def vorticity_samples(res, dtype, device):
    """Pixel centres, x the slow axis."""
    t = (torch.arange(res, dtype=dtype, device=device) + 0.5) / res * 2 - 1
    gx, gy = torch.meshgrid(t, t, indexing="ij")
    return torch.stack([gx, gy], -1).reshape(-1, 2)


@torch.no_grad()
def rollout(model: Model, params, freqs, state, n_steps, res):
    """Burgers: ``n_steps`` of render (order 0, interior) then step,
    frames ``(n_steps, c, res, res)``.  NS: the vorticity (order 1, every
    active Gaussian) rendered before the first step and after each,
    ``(n_steps + 1, res, res)``."""
    dev, dt = state["means"].device, state["means"].dtype
    frames = []
    if model.ns:
        smp = vorticity_samples(res, dt, dev)

        def render(s):
            _, conic = covariances(s["scaling"], s["transforms"])
            ux = mixture(s["means"], conic, s["u"], smp, 1, s["active"],
                         model.period)["ux"]
            return (ux[:, 0, 1] - ux[:, 1, 0]).reshape(res, res).T
        frames.append(render(state))
        for _ in range(n_steps):
            state, _ = forward_step(model, params, freqs, state,
                                    with_grad=False)
            frames.append(render(state))
        return torch.stack(frames)
    smp = image_samples(res, dt, dev)
    for _ in range(n_steps):
        _, conic = covariances(state["scaling"], state["transforms"])
        u = mixture(state["means"], conic, state["u"], smp, 0,
                    interior(state), model.period)["u"]
        frames.append(u.T.reshape(-1, res, res))
        state, _ = forward_step(model, params, freqs, state, with_grad=False)
    return torch.stack(frames)
