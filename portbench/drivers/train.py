"""The ``train`` driver: resumed PN training epochs in a closed loop.

Set-up loads the configuration's training checkpoint into the program
(network, Adam state, EMA), then drives that same object through the
check epochs, ``traffic["check_steps"]`` (1 and 2 steps: three steps, the
split between the second and third), through the window's own call,
``train_epoch``, on the seed's draws; then one warm-up epoch at the
window's length.  The window runs epochs, each followed by the program's
EMA update, until ``seconds`` have passed; in a cell that reports
``train_device_ms`` an untraced run records the device's activity (and
nothing of the host's) all through it, and reads the union of the device
operations' intervals over every step it ran.  Every window epoch has the
curriculum's saturated length, ``train_timesteps``, as an uninterrupted
run at the checkpoint's epoch trains: the work of an epoch depends on
neither the seed nor the speed of the program.

After the window (and, traced, after the profiled stretch) the same
object runs one more epoch of the window's length on the run's own
generator, its state copied to the host before and after: the window
check.  On a configuration with ``ic["stable_edge_max"]`` the epochs
whose initial grid is wider are passed over (their draws consumed, not
trained on): past about 15 steps a float32 epoch on them departs from the
float64 one, an independent float32 implementation as much as the
program.  The plain reference (float64) then follows

* the three check steps from the fixture and the seed's draws:
  ``loss_gap`` (each check epoch's summed loss, relative), ``grad_gap``
  (the first gradient as Adam received it, worked out from the program's
  first moment after one step; the worst leaf's norm) and ``update_gap``
  (the parameters' change over the three steps; the median leaf's norm);
* the window check's epoch from the program's copied state and the same
  draws: ``window_update_gap`` (the change over the epoch, the median
  leaf) and ``window_count_gap`` (the updates Adam applied, exactly).

Leaves whose reference gradient is under a thousandth of the median
leaf's in every step are left out of a change: they move under Adam by
round-off alone.
"""

from __future__ import annotations

import gc
import math
import statistics
import sys
import time

import numpy as np
import torch

from portbench import common, traffic as gen


def recipe_config(config: dict):
    from pigs_tpu_torch.train.pn import TrainConfig
    r = config["recipe"]
    return TrainConfig(
        n_epochs=r["n_epochs"], n_samples=r["n_samples"], lr=r["lr"],
        lr_min=r["lr_min"], dt=r["dt"], epsilon=r["epsilon"],
        train_timesteps=r["train_timesteps"],
        initial_timesteps=r["initial_timesteps"],
        bootstrap_rate=r["bootstrap_rate"], split_epoch=r["split_epoch"],
        loss_weight_floor=r["loss_weight_floor"], clip_norm=r["clip_norm"],
        ema_decay=r["ema_decay"],
        skip_nonfinite_updates=r["skip_nonfinite_updates"])


def check_program_config(cfg, config):
    got = (cfg.capacity, cfg.channels, cfg.split_criteria, cfg.period,
           str(cfg.dtype))
    want = (config["capacity"], config["channels"], config["split_criteria"],
            config["period"], f"torch.{config['dtype']}")
    if got != want:
        raise ValueError(f"the program's configuration {got} is not the "
                         f"benchmark's {want}")


class Program:
    """The program's training object and what the driver needs with it."""

    def __init__(self, cell, device, overrides=None):
        from pigs_tpu_torch.convert import load_train_fixture
        from pigs_tpu_torch.train.pn import NSDataset
        config = cell.config
        self.cfg, self.network, self.opt, self.ema, _ = load_train_fixture(
            cell.path(config["fixture"]["train"]), device=device)
        if overrides:
            self.cfg = self.cfg._replace(**overrides)
        check_program_config(self.cfg, config)
        self.tcfg = recipe_config(config)
        self.ns_data = None
        self.train_set = None
        if config["ic"]["kind"] == "stored_state":
            self.train_set = gen.trajectories(config,
                                              cell.traffic["trajectories"])
            full = NSDataset.load(cell.path(config["fixture"]["ns_data"]),
                                  device=device)
            idx = torch.tensor(self.train_set, device=device)
            self.ns_data = NSDataset(*(x[idx] for x in full))
        self.names = [common.flax_name(k) for k, _ in
                      self.network.named_parameters()]
        self.params = list(self.network.parameters())
        self.device = device

    def epoch(self, generator, epoch, current):
        from pigs_tpu_torch.train.pn import _ema_update, train_epoch
        self.opt, totals, current, n_steps = train_epoch(
            self.cfg, self.tcfg, self.network, self.opt, generator, epoch,
            current, self.device, ns_data=self.ns_data)
        _ema_update(self.ema, self.params, self.tcfg.ema_decay)
        return totals, current, n_steps

    def snapshot(self):
        """Device copies of everything an epoch changes."""
        with torch.no_grad():
            return ([p.detach().clone() for p in self.params], self.opt,
                    [e.clone() for e in self.ema])

    def restore(self, snap):
        params, opt, ema = snap
        with torch.no_grad():
            for p, s in zip(self.params, params):
                p.copy_(s)
            for e, s in zip(self.ema, ema):
                e.copy_(s)
        self.opt = opt

    def host_state(self) -> dict:
        """Parameters and Adam moments in float64 on the host under their
        flax names and layout (a kernel ``(in, out)``), and Adam's count."""
        def flax(k, t):
            t = t.detach().double().cpu()
            return t.T.contiguous() if k.endswith("/kernel") else t
        return {"params": {k: flax(k, p)
                           for k, p in zip(self.names, self.params)},
                "mu": {k: flax(k, m) for k, m in zip(self.names,
                                                     self.opt.mu)},
                "nu": {k: flax(k, v) for k, v in zip(self.names,
                                                     self.opt.nu)},
                "count": int(self.opt.count)}


def first_epoch(cell) -> int:
    """The epoch the check epochs start at: the traffic's, or the
    checkpoint's."""
    first = cell.traffic["first_epoch"]
    return cell.config["recipe"]["resume_epoch"] if first is None else first


def check_epochs(prog: Program, cell, generator, e0: int) -> dict:
    """The check epochs through the window's own call: each epoch's summed
    losses, the first gradient as Adam received it (from its first moment
    after one step) and the parameters' change over them, in float64 on
    the host, in the program's parameter order."""
    p0 = [p.detach().double().cpu().clone() for p in prog.params]
    mu0 = [m.detach().double().cpu().clone() for m in prog.opt.mu]
    b1 = common.reference(cell).B1
    check = {"totals": []}
    for i, steps in enumerate(cell.traffic["check_steps"]):
        totals, _, _ = prog.epoch(generator, e0 + i, steps)
        check["totals"].append(np.asarray(totals, dtype=np.float64))
        if i == 0:
            check["grad1"] = [(m.detach().double().cpu() - b1 * b) / (1 - b1)
                              for m, b in zip(prog.opt.mu, mu0)]
    check["change"] = [p.detach().double().cpu() - a
                       for p, a in zip(prog.params, p0)]
    return check


def pass_unstable(cell, generator, n_samples: int) -> int:
    """Consume the draws of every epoch whose initial grid is wider than
    the configuration's ``stable_edge_max`` (none without one), leaving
    ``generator`` at the next epoch's; returns how many were passed."""
    edge_max = cell.config["ic"].get("stable_edge_max")
    passed = 0
    while edge_max is not None:
        probe = torch.Generator(device=generator.device)
        probe.set_state(generator.get_state())
        draw = gen.epoch_inputs(cell.config, probe, n_samples, torch.float32,
                                "cpu")
        if draw["edge"] <= edge_max:
            break
        generator.set_state(probe.get_state())
        passed += 1
    return passed


def window_check(prog: Program, cell, generator, epoch: int,
                 length: int) -> dict:
    """One epoch of the window's length on the window's object and
    generator, with the state it started from and the change it made."""
    passed = pass_unstable(cell, generator, prog.tcfg.n_samples)
    gen_state = generator.get_state()
    start = prog.host_state()
    totals, _, n = prog.epoch(generator, epoch, length)
    end = prog.host_state()
    return {"start": start, "gen_state": gen_state, "epoch": epoch,
            "steps": n, "passed": passed,
            "totals": np.asarray(totals, dtype=np.float64),
            "count": end["count"] - start["count"],
            "change": {k: v - start["params"][k]
                       for k, v in end["params"].items()}}


def run(cell, seed: int, seconds: float, tracer=None, device=None,
        overrides=None, log=print, control=False) -> dict:
    """One run of a training cell; returns the driver's result (metrics,
    counts, checks and, traced, the profile and records).  ``control``:
    the reference in float32 with TF32 matmuls takes the program's place
    in the checks."""
    device = device or torch.device("cuda")
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    prog = Program(cell, device, overrides)
    e0 = first_epoch(cell)
    length = prog.tcfg.train_timesteps
    generator = torch.Generator().manual_seed(seed)
    check = check_epochs(prog, cell, generator, e0)
    epoch = e0 + len(cell.traffic["check_steps"])
    prog.epoch(generator, epoch, length)                     # warm-up
    epoch += 1
    sync()
    setup_s = common.process_age_s()

    # The window is timed with the collector off; it runs at both ends.
    # A cell that reports ``train_device_ms`` records the device's activity
    # all through an untraced run's window (nothing of the host's).
    device_window = tracer is None and any(
        m["name"] == "train_device_ms" for m in cell.end_to_end)
    steps = failed = epochs = 0
    per_step = []
    t0 = t_last = 0.0

    def window() -> int:
        """Epochs until ``seconds`` have passed; returns every step run,
        those of the epoch that ended past the close too."""
        nonlocal epoch, steps, failed, epochs, t0, t_last
        ran = 0
        t0 = t_last = time.perf_counter()
        while True:
            totals, _, n = prog.epoch(generator, epoch, length)
            epoch += 1
            ran += n
            now = time.perf_counter()
            if now - t0 > seconds:
                return ran
            per_step.append(1e3 * (now - t_last) / max(n, 1))
            t_last = now
            steps += n
            epochs += 1
            if np.all(np.asarray(totals) == 0.0):
                failed += n

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
    if per_step:
        q = np.percentile(per_step, [0, 50, 100])
        log("[portbench] epochs' ms a step min/p50/max "
            + " ".join(f"{x:.2f}" for x in q), file=sys.stderr)
    out = {"setup_s": setup_s, "attempted": steps, "failed": failed,
           "epochs": epochs, "window_s": window_s,
           "metrics": {"train_step_ms": 1e3 * window_s / max(steps, 1)}}
    if device_window and window_profile.device_ops:
        busy_s = window_profile.busy_s()
        out["metrics"]["train_device_ms"] = 1e3 * busy_s / max(
            window_profile.steps, 1)
        log(f"[portbench] window: device busy {busy_s:.4f} s over "
            f"{window_profile.steps} steps, "
            f"{len(window_profile.device_ops)} device operations",
            file=sys.stderr)
    if tracer is not None:
        from portbench import trace
        first = epoch

        def stretch():
            n_total = 0
            for i in range(cell.traffic["profile_epochs"]):
                n_total += prog.epoch(generator, first + i, length)[2]
            return n_total
        out.update(trace.stretch(stretch, tracer, prog.snapshot,
                                 prog.restore, generator))
        epoch += cell.traffic["profile_epochs"]
    checked = window_check(prog, cell, generator, epoch, length)
    if cuda:
        out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device)
    names = prog.names
    shapes = {k: tuple(p.shape[::-1]) if k.endswith("/kernel")
              else tuple(p.shape) for k, p in zip(names, prog.params)}
    out["shapes"] = shapes
    del prog
    if cuda:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    ref_start = fixture_start(cell, device)
    want = reference_epochs(cell, ref_start, torch.Generator().manual_seed(
        seed), e0, cell.traffic["check_steps"], device)
    want_checked = reference_epochs(
        cell, checked_start(checked, device), checked_generator(checked),
        checked["epoch"], [checked["steps"]], device)
    if control:
        check, checked = control_readings(cell, seed, e0, checked, names,
                                          device)
    lim = limits(cell)
    out["checks"] = compare(check, want, names, lim)
    out["checks"].update(compare_window(checked, want_checked, lim))
    log(f"[portbench] epochs {epochs}, window check: {checked['steps']} steps "
        f"after {checked['passed']} epochs passed over; reference: "
        f"{sum(cell.traffic['check_steps']) + checked['steps']} steps in "
        f"{time.perf_counter() - t_ref:.2f} s", file=sys.stderr)
    return out


def checked_generator(checked: dict) -> torch.Generator:
    g = torch.Generator()
    g.set_state(checked["gen_state"])
    return g


def checked_start(checked: dict, device, dtype=torch.float64) -> dict:
    """The reference's start for the window check: the program's copied
    state."""
    s = checked["start"]
    names = sorted(s["params"])

    def tensor(x):
        return x.to(device, dtype)
    return {"params": {k: tensor(v) for k, v in s["params"].items()},
            "mu": [tensor(s["mu"][k]) for k in names],
            "nu": [tensor(s["nu"][k]) for k in names],
            "count": s["count"]}


def fixture_start(cell, device, dtype=torch.float64) -> dict:
    """The reference's start for the check epochs: the checkpoint's arrays
    as the fixture file holds them."""
    data = common.load_arrays(cell.path(cell.config["fixture"]["train"]))

    def tensor(x):
        return torch.as_tensor(np.asarray(x)).to(device, dtype)
    params = {k: tensor(v) for k, v in common.subtree(data, "params").items()}
    names = sorted(params)
    return {"params": params,
            "mu": [tensor(common.subtree(data, "adam_mu")[k]) for k in names],
            "nu": [tensor(common.subtree(data, "adam_nu")[k]) for k in names],
            "count": int(data["adam_count"])}


def reference_epochs(cell, start: dict, generator, e0: int, lengths,
                     device, dtype=torch.float64) -> dict:
    """The reference's epochs ``e0, e0 + 1, ...`` of ``lengths`` steps from
    ``start`` and ``generator``'s draws: per epoch the summed loss terms,
    the clipped gradient of every step, and the parameters' change."""
    config, traffic = cell.config, cell.traffic
    ref = common.reference(cell)
    data = common.load_arrays(cell.path(config["fixture"]["train"]))
    model = ref.Model(config["problem"], config["capacity"])
    params = {k: v.to(device, dtype) for k, v in start["params"].items()}
    names = sorted(params)
    opt = ([m.to(device, dtype) for m in start["mu"]],
           [v.to(device, dtype) for v in start["nu"]], start["count"])
    freqs = torch.as_tensor(data["frequencies"]).to(device, dtype)
    ns_data = train_set = None
    if config["ic"]["kind"] == "stored_state":
        ns_data = common.load_arrays(cell.path(config["fixture"]["ns_data"]))
        train_set = gen.trajectories(config, traffic["trajectories"])
    recipe = dict(config["recipe"])
    p0 = dict(params)
    totals, grads = [], []
    for i, steps in enumerate(lengths):
        ep = e0 + i
        recipe["base_lr"] = base_lr(config["recipe"], ep)
        n = min(min(ep // recipe["bootstrap_rate"] + 1, steps),
                recipe["train_timesteps"])
        inp = gen.epoch_inputs(config, generator, recipe["n_samples"],
                               dtype, device, ns_data, train_set)
        targets = None
        if ns_data is not None:
            targets = gen.recon_targets(ns_data, inp["trajectory"],
                                        inp["samples"], n)
        params, opt, t, g = ref.epoch(
            model, params, opt, freqs, names, inp["state"], inp["samples"],
            inp["times"], inp["bc_samples"], n, recipe, ep, targets)
        totals.append(np.asarray(t, dtype=np.float64).sum(axis=0))
        grads += g
    return {"names": names, "totals": totals, "grads": grads,
            "count": opt[2] - start["count"],
            "change": {k: (params[k] - p0[k]) for k in names}}


def control_readings(cell, seed, e0, checked, names, device):
    """The checks' inputs with the reference in float32 and TF32 matmuls
    in the program's place (its leaves in the program's order ``names``):
    the check epochs from the fixture, the window check from the
    program's copied state."""
    with common.tf32(True):
        low = reference_epochs(cell, fixture_start(cell, device,
                                                   torch.float32),
                               torch.Generator().manual_seed(seed), e0,
                               cell.traffic["check_steps"], device,
                               torch.float32)
        low_checked = reference_epochs(
            cell, checked_start(checked, device, torch.float32),
            checked_generator(checked), checked["epoch"], [checked["steps"]],
            device, torch.float32)
    first = dict(zip(low["names"], low["grads"][0]))
    check = {"totals": low["totals"],
             "grad1": [first[k].double().cpu() for k in names],
             "change": [low["change"][k].double().cpu() for k in names]}
    return check, dict(checked, totals=low_checked["totals"][0],
                       count=low_checked["count"], change={
                           k: v.double().cpu()
                           for k, v in low_checked["change"].items()})


def base_lr(r: dict, epoch: int) -> float:
    """The cosine decay of the learning rate to ``lr_min`` over
    ``n_epochs``."""
    frac = min(max(epoch / max(r["n_epochs"] - 1, 1), 0.0), 1.0)
    return r["lr_min"] + 0.5 * (r["lr"] - r["lr_min"]) * (
        1.0 + math.cos(math.pi * frac))


def limits(cell) -> dict:
    """The configuration's limits of the training checks."""
    return cell.config["limits"]["train"]


def _norm(t) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def moving_leaves(ref_out) -> list:
    """The leaves whose reference gradient reaches a thousandth of the
    median leaf's in some step (a key's bias under softmax never does)."""
    rnames = ref_out["names"]
    top = {k: max(_norm(s[j]) for s in ref_out["grads"])
           for j, k in enumerate(rnames)}
    med = float(np.median(list(top.values())))
    return [k for k in rnames if top[k] >= 1e-3 * med]


def change_gap(got: dict, ref_out) -> dict:
    """The parameters' change, each leaf's norm against the reference's:
    the median over the moving leaves, and the worst with its name.
    Stored in float32, a parameter of size ~1 resolves a change of ~1e-5
    to ~1e-2 an element, so the worst leaf's change swings with its
    round-off from seed to seed; the median leaf's is steady."""
    keep = moving_leaves(ref_out)
    c_ref = {k: _norm(ref_out["change"][k]) for k in ref_out["names"]}
    gaps = common.leaf_gaps({k: _norm(v) for k, v in got.items()}, c_ref,
                            keep)
    worst = max(gaps, key=gaps.get)
    return {"value": statistics.median(gaps.values()), "worst": gaps[worst],
            "leaf": worst, "leaves": len(keep)}


def summed_loss_gap(got, want) -> float:
    """The relative gap of the physics terms (pde, bc, conservation,
    initial) summed over an epoch."""
    return common.relative_gap(float(np.sum(got[:4])), float(np.sum(want[:4])))


def compare(check, ref_out, names, lim) -> dict:
    """The check epochs' three numbers, each with its limit."""
    loss = max(summed_loss_gap(p, r)
               for p, r in zip(check["totals"], ref_out["totals"]))
    g_ref = {k: _norm(g) for k, g in zip(ref_out["names"],
                                         ref_out["grads"][0])}
    g_prog = {k: _norm(g) for k, g in zip(names, check["grad1"])}
    grad, grad_leaf = common.worst_leaf_gap(g_prog, g_ref)
    change = change_gap(dict(zip(names, check["change"])), ref_out)
    return {"loss_gap": {"value": loss, "limit": lim["loss_gap"]},
            "grad_gap": {"value": grad, "limit": lim["grad_gap"],
                         "leaf": grad_leaf},
            "update_gap": dict(change, limit=lim["update_gap"])}


def compare_window(checked, ref_out, lim) -> dict:
    """The window check's numbers, each with its limit: the change (median
    leaf) and how many updates Adam applied, exactly.  The epoch's summed
    loss is printed beside them and not compared: past a split or
    neighbour decision that round-off turned, a sound epoch reads as far
    from the reference as a faulty one."""
    change = change_gap(checked["change"], ref_out)
    return {"window_update_gap": dict(change,
                                      limit=lim["window_update_gap"],
                                      loss_gap=summed_loss_gap(
                                          checked["totals"],
                                          ref_out["totals"][0])),
            "window_count_gap": {
                "value": float(abs(checked["count"] - ref_out["count"])),
                "limit": 0.0, "applied": checked["count"]}}
