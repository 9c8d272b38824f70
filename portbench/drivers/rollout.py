"""The ``rollout`` driver: one client, closed loop, one rollout a request.

Set-up loads the configuration's serving checkpoint (the EMA weights) into
the program, draws the requests' initial conditions from the seed
(``traffic.rollout_ics``) and runs one rollout to warm up.  The window
sends requests one after another: each is timed from the call to its
frames on the host.  The configuration's ``rollout.kind`` picks the
program's entry: ``frames`` (``rollout_frames``: render, then step) or
``vorticity`` (``rollout_vorticity``).

After the window, ``traffic["check_rollouts"]`` of the finished rollouts,
drawn from the seed, are rolled out again by the plain reference in
float64 from the same initial condition and the fixture's weights, and
compared by ``frames_gap``: the widest per-frame relative L2 gap over the
first ``rollout.check_frames`` frames, every frame finite.  The later
frames are compared by ``late_frames_gap``, with a limit of its own, on
the picks whose initial grid is no wider than ``ic["stable_edge_max"]``
(every pick where the configuration has none): past about 15 steps a
float32 rollout from a wider grid departs from the float64 one, an
independent float32 implementation as much as the program, and on any
grid a neighbour or split decision that round-off turns parts the two
rollouts by a few 1e-3.  The first pick is drawn among the stable ones.
"""

from __future__ import annotations

import gc
import sys
import time

import numpy as np
import torch

from portbench import common, traffic as gen
from portbench.drivers.train import check_program_config


class Program:
    def __init__(self, cell, device, overrides=None):
        from pigs_tpu_torch.convert import load_fixture
        config = cell.config
        self.cfg, self.network, _ = load_fixture(
            cell.path(config["fixture"]["serve"]), device=device)
        if overrides:
            self.cfg = self.cfg._replace(**overrides)
        check_program_config(self.cfg, config)
        self.kind = config["rollout"]["kind"]
        self.steps = config["rollout"]["steps"]
        self.res = config["rollout"]["res"]
        self.dt = config["rollout"]["dt"]

    def __call__(self, state):
        from pigs_tpu_torch.train.pn import rollout_frames, rollout_vorticity
        if self.kind == "frames":
            return rollout_frames(self.cfg, self.network, state, self.steps,
                                  self.res, self.dt)
        return rollout_vorticity(self.cfg, self.network, state, self.steps,
                                 self.res)


class Requests:
    """The requests' initial conditions as the program's states, and as
    plain dicts for the reference."""

    def __init__(self, cell, seed, device):
        config = cell.config
        self.config = config
        self.data = None
        if config["ic"]["kind"] == "stored_state":
            self.data = common.load_arrays(cell.path(
                config["fixture"]["ns_data"]))
        self.ics = gen.rollout_ics(config, cell.traffic, seed,
                                   cell.traffic["pool"], device, self.data)
        self.device = device
        self.stored = {}
        if "trajectory" in self.ics:
            for t in set(self.ics["trajectory"].tolist()):
                self.plain_stored(t)

    def plain_stored(self, t: int) -> dict:
        if t not in self.stored:
            self.stored[t] = gen.stored_state(
                self.data, t, self.config["capacity"], torch.float32,
                self.device)
        return self.stored[t]

    def plain(self, i: int) -> dict:
        if "trajectory" in self.ics:
            return self.plain_stored(int(self.ics["trajectory"][i]))
        return {k: self.ics[k][i] for k in ("means", "scaling", "transforms",
                                            "u", "active", "boundary")}

    def state(self, i: int):
        from pigs_tpu_torch.models.state import MixtureState
        s = self.plain(i % len(self))
        return MixtureState(means=s["means"], scaling=s["scaling"],
                            transforms=s["transforms"], u=s["u"],
                            active=s["active"], boundary=s["boundary"])

    def __len__(self):
        ics = self.ics
        return len(ics["trajectory"] if "trajectory" in ics else ics["means"])


def run(cell, seed: int, seconds: float, tracer=None, device=None,
        overrides=None, log=print, control=False) -> dict:
    """One run of a rollout cell.  ``control``: the reference in float32
    with TF32 matmuls takes the program's place in the check."""
    device = device or torch.device("cuda")
    cuda = device.type == "cuda"
    prog = Program(cell, device, overrides)
    requests = Requests(cell, seed, device)
    prog(requests.state(0)).cpu()          # warm-up
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = common.process_age_s()

    # The window is timed with the collector off; it runs at both ends.
    gc.collect()
    gc.disable()
    frames, latency = [], []
    i = 0
    t0 = time.perf_counter()
    t_last = t0
    while True:
        start = time.perf_counter()
        out = prog(requests.state(i)).cpu().numpy()
        now = time.perf_counter()
        if now - t0 > seconds:
            break
        frames.append(out)
        latency.append(now - start)
        i += 1
        t_last = now
    window_s = t_last - t0
    gc.enable()
    gc.collect()
    n = len(frames)
    failed = sum(1 for f in frames if not np.isfinite(f).all())
    metrics = {"rollout_ms": 1e3 * window_s / max(n, 1)}
    if n >= 10:
        metrics["rollout_p90_ms"] = 1e3 * common.percentile(latency, 90)
    out = {"setup_s": setup_s, "attempted": n, "failed": failed,
           "window_s": window_s, "metrics": metrics,
           "steps_per_rollout": prog.steps}
    if tracer is not None:
        from portbench import trace

        def stretch():
            for j in range(cell.traffic["profile_rollouts"]):
                prog(requests.state(i + 1 + j)).cpu()
            return cell.traffic["profile_rollouts"] * prog.steps
        out.update(trace.stretch(stretch, tracer))
    if cuda:
        out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device)
    out["shapes"] = {common.flax_name(k): tuple(p.shape[::-1])
                     if k.endswith("weight") else tuple(p.shape)
                     for k, p in prog.network.named_parameters()}
    del prog
    if cuda:
        torch.cuda.empty_cache()

    if latency:
        q = np.percentile(np.asarray(latency) * 1e3, [0, 50, 80, 90, 100])
        log("[portbench] latency ms min/p50/p80/p90/max "
            + " ".join(f"{x:.2f}" for x in q), file=sys.stderr)
    picks = pick(cell, requests, seed, n)
    if control:
        low = reference_frames(cell, requests, picks, device, torch.float32,
                               tf32=True)
        frames = dict(zip(picks, low))
    t_ref = time.perf_counter()
    out["checks"] = reference_checks(cell, requests, picks, frames, device)
    log(f"[portbench] reference: {len(picks)} rollouts in "
        f"{time.perf_counter() - t_ref:.2f} s", file=sys.stderr)
    if n == 0:
        out["checks"]["rollouts_done"] = {"value": 1.0, "limit": 0.0}
    return out


def limits(cell) -> dict:
    """The configuration's limits of the rollout checks."""
    return cell.config["limits"]["rollout"]


def stable(cell, requests, i: int) -> bool:
    """Whether request ``i``'s rollout is compared over all its frames:
    its initial grid is no wider than ``ic["stable_edge_max"]``, or the
    configuration has none."""
    edge_max = cell.config["ic"].get("stable_edge_max")
    return edge_max is None or \
        int(requests.ics["edge"][i % len(requests)]) <= edge_max


def pick(cell, requests, seed: int, n: int) -> list:
    """``traffic["check_rollouts"]`` of the ``n`` finished rollouts, drawn
    from the seed: the first among those compared over all their frames
    (where there is one), the others among the rest."""
    k = cell.traffic["check_rollouts"]
    g = torch.Generator().manual_seed(seed + 1)
    order = torch.randperm(n, generator=g).tolist()
    first = [i for i in order if stable(cell, requests, i)][:1]
    rest = [i for i in order if i not in first][:k - len(first)]
    return sorted(first + rest)


def reference_frames(cell, requests, picks, device, dtype=torch.float64,
                     tf32=False):
    """The reference's rollouts of requests ``picks`` in ``dtype`` (with
    TF32 matmuls where ``tf32``), from the fixture's weights, as numpy
    frames."""
    config = cell.config
    ref = common.reference(cell)
    data = common.load_arrays(cell.path(config["fixture"]["serve"]))
    params = {k: torch.as_tensor(v).to(device, dtype)
              for k, v in common.subtree(data, "params").items()}
    freqs = torch.as_tensor(data["frequencies"]).to(device, dtype)
    model = ref.Model(config["problem"], config["capacity"])
    out = []
    with common.tf32(tf32):
        for i in picks:
            s = requests.plain(i % len(requests))
            state = {k: (v.to(dtype) if v.is_floating_point() else v)
                     for k, v in s.items()}
            out.append(ref.rollout(model, params, freqs, state,
                                   config["rollout"]["steps"],
                                   config["rollout"]["res"]).cpu().numpy())
    return out


def reference_checks(cell, requests, picks, frames, device) -> dict:
    """``frames_gap`` and, where a rollout has frames past
    ``rollout.check_frames``, ``late_frames_gap``: the widest gaps of
    rollouts ``picks`` (``frames[i]``) against the float64 reference, each
    with its limit and the pick that reads it."""
    wants = dict(zip(picks, reference_frames(cell, requests, picks, device)))
    early = cell.config["rollout"]["check_frames"]
    lim = limits(cell)

    def widest(gaps, name):
        where = max(gaps, key=gaps.get) if gaps else None
        return {"value": gaps[where] if gaps else 0.0, "limit": lim[name],
                "pick": where}
    out = {"frames_gap": widest({i: common.frames_gap(frames[i], wants[i],
                                                      early)
                                 for i in picks}, "frames_gap")}
    if "late_frames_gap" in lim:
        out["late_frames_gap"] = widest(
            {i: common.frames_gap(frames[i], wants[i], None, early)
             for i in picks if stable(cell, requests, i)}, "late_frames_gap")
    return out
