"""The ``solve`` driver: dynamics timesteps of the no-MLP direct solve, one
client, closed loop.

A request is one dynamics timestep ``k``, drawn uniformly from the
traffic's ``timesteps`` range by the seed.  It starts from the
configuration's stored state ``k - 1`` (the raw parameters and active mask
the published solve reached), which is also the frozen previous mixture,
and runs through the program's block entry
(``pigs_tpu_torch.train.no_mlp.timestep_blocks``) under the recipe's rule:
blocks of ``block_iters`` Adam iterations until the mean of the last five
block means is at most ``tol``, or ``max_iters`` iterations.  Every draw
(the requests, the samples and times of every block) comes from the seed:
the requests from a host generator, the draws from one device generator.

Set-up loads the stored states onto the device and runs, through the same
entry, the check blocks (``traffic["check_iters"]``: a block of 1 and one
of 2 iterations, each from a drawn stored state on the seed's draws) and a
warm-up block at the window's size.  The window sends blocks of the
requests one after another and closes at the first block boundary past
``seconds``; ``train_step_ms`` is the time to the end of the last block
finished in it over those blocks' iterations; in a cell that reports
``train_device_ms`` an untraced run records the device's activity (and
nothing of the host's) all through the window, and reads the union of the
device operations' intervals over every iteration it ran.

After the window (and, traced, after the stretch) the window's request
runs one more block, its state copied to the host before and after: the
window check.  The plain reference (float64) then follows

* the check blocks from the stored state and the same draws: ``loss_gap``
  (each block's mean loss, relative), ``grad_gap`` (the first gradient as
  Adam received it, worked out from the program's first moment after one
  iteration; the worst leaf) and ``update_gap`` (the parameters' change
  over the 2-iteration block; the median leaf);
* the window check's block from the program's copied state and the same
  draws: ``window_update_gap`` (the size of the change over the block,
  the median leaf: :func:`compare_window` says why its size),
  ``window_loss_gap`` (the block's mean loss, which the rule reads) and
  ``window_count_gap`` (the Adam steps applied, exactly).

A leaf's gap in the check blocks is ``||got - want|| / max(||want||, the
median leaf's ||want||)``: the difference of the whole vectors, so a
change of direction shows as well as one of size.
"""

from __future__ import annotations

import gc
import json
import statistics
import sys
import time

import numpy as np
import torch

from portbench import common

LEAVES = ("raw_means", "values", "raw_scaling", "transforms")


def recipe_config(config: dict):
    """The program's ``NoMLPConfig`` for the configuration's recipe."""
    from pigs_tpu_torch.pde import Problem
    from pigs_tpu_torch.train.no_mlp import NoMLPConfig
    r = config["recipe"]
    return NoMLPConfig(
        problem=Problem[config["problem"].upper()], d=config["d"],
        scale=r["scale"], n_init=r["n_init"], capacity=config["capacity"],
        n_samples=r["n_samples"], dt=r["dt"], nu=r["nu"], lr=r["lr"],
        block_iters=r["block_iters"], max_iters=r["max_iters"],
        tol=r["tol"], init_raw_scaling=r["init_raw_scaling"],
        dtype=getattr(torch, config["dtype"]),
        warm_up_blocks=r["warm_up_blocks"], min_keep=r["min_keep"],
        active_sampling=r["active_sampling"], lr_min=r["lr_min"])


class Program:
    """The stored states on the device and the program's block entry."""

    def __init__(self, cell, device):
        from pigs_tpu_torch.train.no_mlp import RawParams
        config = cell.config
        self.cfg = recipe_config(config)
        if self.cfg.c != config["channels"]:
            raise ValueError(f"the program's {self.cfg.c} channels are not "
                             f"the benchmark's {config['channels']}")
        self.densify_every = config["recipe"]["densify_every"] or None
        data = common.load_arrays(cell.path(config["fixture"]["states"]))
        if data["raw_means"].shape[1] != config["capacity"]:
            raise ValueError("the stored states' capacity is not the "
                             "configuration's")
        self.states = [
            (RawParams(*(torch.as_tensor(data[k][i]).to(device,
                                                        self.cfg.dtype)
                         for k in LEAVES)),
             torch.as_tensor(data["active"][i]).to(device))
            for i in range(data["active"].shape[0])]

    def timestep(self, k: int, generator, cfg=None):
        """Timestep ``k``'s blocks (a generator of ``BlockState``) from
        stored state ``k - 1``."""
        from pigs_tpu_torch.train import no_mlp
        cfg = cfg or self.cfg
        params, active = self.states[k - 1]
        with torch.no_grad():
            means, conics, values = no_mlp.concrete(cfg, params)
        return no_mlp.timestep_blocks(cfg, params, active,
                                      (means, conics, values, active),
                                      generator, first_step=False,
                                      densify_every=self.densify_every)


def request_timesteps(traffic: dict, seed: int, count: int) -> list:
    """``count`` timesteps, each uniform over the traffic's ``timesteps``
    range (both ends included), drawn from ``seed``."""
    lo, hi = traffic["timesteps"]
    g = torch.Generator().manual_seed(seed)
    return torch.randint(lo, hi + 1, (count,), generator=g).tolist()


def block_inputs(generator, iters: int, n: int, d: int = 2) -> dict:
    """A block's draws as the recipe makes them, ``iters`` iterations of
    ``n`` samples: uniform ``[0, 1)`` positions ``(iters, n, d)``, then
    uniform times ``(iters, n)``, float32 on the generator's device;
    ``generator`` advances past them."""
    kw = dict(generator=generator, dtype=torch.float32,
              device=generator.device)
    base = torch.rand((iters, n, d), **kw)
    return {"base": base, "times": torch.rand((iters, n), **kw)}


def host_copy(params, opt_state, active, iters: int) -> dict:
    """A block boundary's state in float64 on the host: the parameters,
    Adam's moments and count, the mask and the pre-step count."""
    def f64(x):
        return x.detach().double().cpu().clone()
    return {"raw": {k: f64(v) for k, v in zip(LEAVES, params)},
            "mu": {k: f64(v) for k, v in zip(LEAVES, opt_state.mu)},
            "nu": {k: f64(v) for k, v in zip(LEAVES, opt_state.nu)},
            "count": int(opt_state.count), "active": active.cpu().clone(),
            "iters": iters}


def fresh_start(prog: Program, k: int) -> dict:
    """Stored state ``k - 1`` with a fresh Adam state."""
    from pigs_tpu_torch.train.optim import adam_init
    params, active = prog.states[k - 1]
    return host_copy(params, adam_init(list(params)), active, 0)


class Stream:
    """The window's requests, one after another, a block at a time."""

    def __init__(self, prog: Program, timesteps: list, generator):
        self.prog = prog
        self.timesteps = timesteps
        self.generator = generator
        self.i = 0
        self.k = None
        self.blocks = None
        self.last = None

    def start(self):
        """The next request, before its first block."""
        self.k = self.timesteps[self.i % len(self.timesteps)]
        self.i += 1
        self.blocks = self.prog.timestep(self.k, self.generator)
        self.last = None

    def between_requests(self) -> bool:
        return self.blocks is None or (self.last is not None
                                       and self.last.done)

    def next_block(self):
        if self.between_requests():
            self.start()
        self.last = next(self.blocks)
        return self.last

    def boundary(self) -> dict:
        """The state the next block starts from, copied to the host."""
        if self.between_requests():
            self.start()
        if self.last is None:
            return fresh_start(self.prog, self.k)
        s = self.last
        return host_copy(s.params, s.opt_state, s.active, s.iters)


def check_blocks(prog: Program, cell, seed: int, generator) -> dict:
    """The check blocks through the window's own entry: each block's mean
    loss, the first gradient as Adam received it and the change over the
    last block, float64 on the host, with each block's timestep and draws'
    generator state."""
    traffic = cell.traffic
    b1 = common.reference(cell).B1
    step = request_timesteps(traffic, seed + 1, 1)[0]
    out = {"k": step, "losses": [], "gen_states": [], "iters": []}
    for n in traffic["check_iters"]:
        out["gen_states"].append(generator.get_state())
        out["iters"].append(n)
        start = fresh_start(prog, step)
        state = next(prog.timestep(step, generator,
                                   prog.cfg._replace(block_iters=n)))
        end = host_copy(state.params, state.opt_state, state.active,
                        state.iters)
        out["losses"].append(state.loss)
        if "grad1" not in out:
            out["grad1"] = {k: end["mu"][k] / (1 - b1) for k in LEAVES}
        out["change"] = {k: end["raw"][k] - start["raw"][k] for k in LEAVES}
    return out


def run(cell, seed: int, seconds: float, tracer=None, device=None,
        overrides=None, log=print, control=False) -> dict:
    """One run of a solve cell; returns the driver's result (metrics,
    counts, checks and, traced, the profile, records and spanned pass).
    ``control``: the reference in float32 with TF32 matmuls takes the
    program's place in the checks.  ``overrides`` is accepted for the
    harness's common signature; the stored states fix the sizes."""
    device = device or torch.device("cuda")
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    traffic = cell.traffic
    prog = Program(cell, device)
    generator = torch.Generator(device=device).manual_seed(seed)
    check = check_blocks(prog, cell, seed, generator)
    warm = prog.timestep(request_timesteps(traffic, seed + 2, 1)[0],
                         generator)
    next(warm)                                               # warm-up
    warm.close()
    sync()
    setup_s = common.process_age_s()

    stream = Stream(prog, request_timesteps(traffic, seed, traffic["pool"]),
                    generator)
    # The window is timed with the collector off.  A cell that reports
    # ``train_device_ms`` records the device's activity all through an
    # untraced run's window (nothing of the host's).
    device_window = tracer is None and any(
        m["name"] == "train_device_ms" for m in cell.end_to_end)
    iters = blocks = failed = 0
    t0 = t_last = 0.0

    def window() -> int:
        """Blocks until ``seconds`` have passed; returns every iteration
        run, those of the block that ended past the close too."""
        nonlocal iters, blocks, failed, t0, t_last
        t0 = t_last = time.perf_counter()
        while True:
            state = stream.next_block()
            now = time.perf_counter()
            if now - t0 > seconds:
                return iters + prog.cfg.block_iters
            t_last = now
            iters += prog.cfg.block_iters
            blocks += 1
            if not np.isfinite(state.loss):
                failed += prog.cfg.block_iters

    gc.collect()
    gc.disable()
    if device_window:
        from portbench import trace
        window_profile = trace.profile(window, host=False)
    else:
        window()
    window_s = t_last - t0
    gc.enable()
    gc.collect()
    out = {"setup_s": setup_s, "attempted": iters, "failed": failed,
           "blocks": blocks, "requests": stream.i, "window_s": window_s,
           "metrics": {"train_step_ms": 1e3 * window_s / max(iters, 1)},
           "shapes": {}}
    log(f"[portbench] window: {blocks} blocks of {stream.i} requests "
        f"(timesteps {stream.timesteps[:stream.i]})", file=sys.stderr)
    if device_window and window_profile.device_ops:
        busy_s = window_profile.busy_s()
        out["metrics"]["train_device_ms"] = 1e3 * busy_s / max(
            window_profile.steps, 1)
        log(f"[portbench] window: device busy {busy_s:.4f} s over "
            f"{window_profile.steps} iterations, "
            f"{len(window_profile.device_ops)} device operations",
            file=sys.stderr)
    if tracer is not None:
        out.update(traced_stretch(prog, traffic, seed, generator, tracer))
    start = stream.boundary()
    gen_state = generator.get_state()
    state = stream.next_block()
    end = host_copy(state.params, state.opt_state, state.active,
                    state.iters)
    checked = {"k": stream.k, "start": start, "gen_state": gen_state,
               "loss": state.loss, "count": end["count"] - start["count"],
               "change": {k: end["raw"][k] - start["raw"][k]
                          for k in LEAVES}}
    if cuda:
        out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device)
    del stream, state
    t_ref = time.perf_counter()
    want = reference_checks(cell, prog, check, generator, device)
    want_checked = reference_window(cell, prog, checked, generator, device)
    if control:
        with common.tf32(True):
            low = reference_checks(cell, prog, check, generator, device,
                                   torch.float32)
            check = dict(check, losses=low["losses"], grad1=low["grad1"],
                         change=low["change"])
            low = reference_window(cell, prog, checked, generator, device,
                                   torch.float32)
        checked = dict(checked, loss=low["mean_loss"], count=low["count"],
                       change=low["change"])
    lim = cell.config["limits"]["solve"]
    out["checks"] = compare(check, want, lim)
    out["checks"].update(compare_window(checked, want_checked, lim))
    log(f"[portbench] checks: timestep {check['k']}, window check timestep "
        f"{checked['k']} from iteration {checked['start']['iters']}; "
        f"reference {sum(traffic['check_iters']) + prog.cfg.block_iters} "
        f"iterations in {time.perf_counter() - t_ref:.2f} s", file=sys.stderr)
    return out


def traced_stretch(prog: Program, traffic: dict, seed: int, generator,
                   tracer) -> dict:
    """``profile_blocks`` blocks of a fresh request, run recorded,
    profiled and timed from one start (``trace.stretch``), then once more
    inside the program's ``tracing()`` under the profiler
    (``spans.spanned_profile``)."""
    from portbench import spans, trace
    k = request_timesteps(traffic, seed + 3, 1)[0]
    n = traffic["profile_blocks"]

    def fn() -> int:
        blocks = prog.timestep(k, generator)
        ran = 0
        for _ in range(n):
            ran += prog.cfg.block_iters
            if next(blocks).done:
                break
        blocks.close()
        return ran
    g0 = generator.get_state()
    out = trace.stretch(fn, tracer, generator=generator)
    generator.set_state(g0)
    spanned = out["spanned_profile"] = spans.spanned_profile(fn)
    print("[portbench] spans: " + json.dumps(span_summary(spanned)),
          file=sys.stderr)
    return out


def span_summary(spanned) -> dict:
    """Where a spanned pass's time went: host and device ms an iteration
    by span (children included), kernel launches and counters an
    iteration by the innermost span, idle seconds by span, and the share
    of the pass's host time inside its outermost spans."""
    names = sorted({s.name for s in spanned.spans})
    outer = [s for s in spanned.spans if s.parent not in spanned.by_id]
    wall = spanned.t1_ns - spanned.t0_ns
    return {"iterations": spanned.steps,
            "host_ms": {n: spanned.host_ms(n) for n in names},
            "device_ms": {n: spanned.device_ms(n) for n in names},
            "launches": spanned.launches_by_span(),
            "idle_s": spanned.idle_gaps_by_span(10),
            "coverage": {"outer_spans": sum(s.end_ns - s.start_ns
                                            for s in outer) / max(wall, 1),
                         **spanned.coverage()}}


# -------------------------------------------------------------- reference --

def reference_checks(cell, prog: Program, check: dict, generator, device,
                     dtype=torch.float64) -> dict:
    """The reference's check blocks from the stored state on the same
    draws: each block's mean loss, the first gradient and the change over
    the last block."""
    ref = common.reference(cell)
    recipe = ref.Recipe(cell.config["recipe"])
    start = fresh_start(prog, check["k"])
    prev = start
    out = {"losses": []}
    for n, g_state in zip(check["iters"], check["gen_states"]):
        res = reference_block(ref, recipe, start, prev, g_state, n,
                              prog.cfg.n_samples, generator, device, dtype)
        out["losses"].append(res["mean_loss"])
        if "grad1" not in out:
            out["grad1"] = {k: res["grads"][0][k].double().cpu()
                            for k in LEAVES}
        out["change"] = {k: res["raw"][k].double().cpu() - start["raw"][k]
                         for k in LEAVES}
    return out


def reference_window(cell, prog: Program, checked: dict, generator, device,
                     dtype=torch.float64) -> dict:
    """The reference's window-check block from the program's copied state
    on the same draws."""
    ref = common.reference(cell)
    recipe = ref.Recipe(cell.config["recipe"])
    start = checked["start"]
    prev = fresh_start(prog, checked["k"])
    res = reference_block(ref, recipe, start, prev, checked["gen_state"],
                          prog.cfg.block_iters, prog.cfg.n_samples,
                          generator, device, dtype)
    return {"mean_loss": res["mean_loss"],
            "count": res["opt"]["count"] - start["count"],
            "change": {k: res["raw"][k].double().cpu() - start["raw"][k]
                       for k in LEAVES}}


def reference_block(ref, recipe, start: dict, prev: dict, gen_state,
                    iters: int, n_samples: int, generator, device,
                    dtype) -> dict:
    """One reference block of ``iters`` iterations of ``n_samples`` from
    ``start`` (a :func:`host_copy`), the previous mixture ``prev``'s
    parameters, on the draws ``generator`` made from ``gen_state``."""
    g = torch.Generator(device=generator.device)
    g.set_state(gen_state)
    draws = block_inputs(g, iters, n_samples)

    def dev(tree):
        return {k: v.to(device, dtype) for k, v in tree.items()}
    opt = {"mu": dev(start["mu"]), "nu": dev(start["nu"]),
           "count": start["count"]}
    return ref.block(recipe, dev(start["raw"]), start["active"].to(device),
                     dev(prev["raw"]), prev["active"].to(device), opt,
                     start["iters"], draws["base"].to(device, dtype),
                     draws["times"].to(device, dtype))


# ------------------------------------------------------------ comparisons --

def _norm(t) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def leaf_gaps(got: dict, want: dict) -> dict:
    """Each leaf's ``||got - want|| / max(||want||, median leaf's
    ||want||)``; infinite where ``got`` is not finite."""
    norms = {k: _norm(want[k]) for k in LEAVES}
    floor = max(statistics.median(norms.values()), 1e-300)
    out = {}
    for k in LEAVES:
        g = got[k].double()
        out[k] = (float("inf") if not torch.isfinite(g).all() else
                  _norm(g - want[k].double()) / max(norms[k], floor))
    return out


def compare(check: dict, want: dict, lim: dict) -> dict:
    """The check blocks' three numbers, each with its limit."""
    loss = max(common.relative_gap(p, r)
               for p, r in zip(check["losses"], want["losses"]))
    grads = leaf_gaps(check["grad1"], want["grad1"])
    g_leaf = max(grads, key=grads.get)
    change = leaf_gaps(check["change"], want["change"])
    c_leaf = max(change, key=change.get)
    return {"loss_gap": {"value": loss, "limit": lim["loss_gap"]},
            "grad_gap": {"value": grads[g_leaf], "limit": lim["grad_gap"],
                         "leaf": g_leaf},
            "update_gap": {"value": statistics.median(change.values()),
                           "limit": lim["update_gap"],
                           "worst": change[c_leaf], "leaf": c_leaf}}


def compare_window(checked: dict, want: dict, lim: dict) -> dict:
    """The window check's three numbers, each with its limit.  Over a
    whole block float32 and float64 part: early in a timestep, where the
    learning rate is near its top, round-off turns the direction of the
    smallest entries' steps and the two runs' changes come to differ by
    20-50 % as vectors (printed as ``vector``), while each leaf's size of
    change and the block's mean loss stay close.  So the change is
    compared leaf by leaf by its norm, as ``drivers/train.py`` compares
    it: ``| ||got|| - ||want|| | / max(||want||, the median leaf's)``."""
    got = {k: _norm(v) for k, v in checked["change"].items()}
    ref = {k: _norm(v) for k, v in want["change"].items()}
    change = common.leaf_gaps(got, ref, LEAVES)
    c_leaf = max(change, key=change.get)
    vector = leaf_gaps(checked["change"], want["change"])
    return {"window_update_gap": {
                "value": statistics.median(change.values()),
                "limit": lim["window_update_gap"], "worst": change[c_leaf],
                "leaf": c_leaf,
                "vector": statistics.median(vector.values())},
            "window_loss_gap": {
                "value": common.relative_gap(checked["loss"],
                                             want["mean_loss"]),
                "limit": lim["window_loss_gap"]},
            "window_count_gap": {
                "value": float(abs(checked["count"] - want["count"])),
                "limit": 0.0, "applied": checked["count"]}}
