"""What a traced run hands its per-layer metric readers.

A reader (``portbench/metrics/<name>.py``) defines ``read(run) ->
Optional[float]`` over a :class:`TracedRun`; it returns None where it finds
nothing to read, and the metric is then left out of the result line.
"""

from __future__ import annotations

from typing import Optional

from portbench import trace, workcount


class TracedRun:
    """A ``--trace 1`` run of one cell: its driver (``train`` or
    ``rollout``), the stretch's records, its profile and its untraced wall
    time, and the model's sizes."""

    def __init__(self, driver: str, result: dict, config: dict):
        self.driver = driver
        self.result = result
        self.config = config
        self.profile: trace.Profile = result["profile"]
        self.shapes = result["shapes"]

    # ---------------------------------------------------------- counting --
    def _mixture(self, kind: str, rows) -> tuple:
        items = []
        for m, n, order, c, periodic in rows:
            items.append(workcount.mixture_work(
                "fwd" if kind == "k1" else "bwd", n if m is None else m, n,
                order, c, periodic))
        return workcount.total(items)

    def _network_flop(self, rows) -> float:
        cfg = self.config
        c = cfg["channels"]
        pde = 1 if cfg["problem"] == "ns" else c
        return sum(workcount.network_step_flop(
            self.shapes, c, pde, cfg["attention_heads"], cfg["latent_size"],
            cfg["frequencies_per_axis"], active, pairs, grad)
            for active, pairs, grad in rows)

    def flop(self, records: dict) -> float:
        return (self._mixture("k1", records["k1"])[0]
                + self._mixture("k2", records["k2"])[0]
                + self._network_flop(records["net"]))

    # ----------------------------------------------------------- metrics --
    def mfu(self) -> Optional[float]:
        """The recorded stretch's model FLOP over the float32 peak times
        the same work's wall time, untraced, in percent."""
        records = self.result["stretch_records"]
        if not records["k1"] or not self.result["stretch_s"]:
            return None
        return 100.0 * self.flop(records) / (
            workcount.PEAK_FLOP_S * self.result["stretch_s"])

    def mfu_device(self) -> Optional[float]:
        """The recorded stretch's model FLOP over the float32 peak times
        the device's busy time in the profiled pass of the same work, in
        percent."""
        records = self.result["stretch_records"]
        busy = self.profile.busy_s() if self.profile.device_ops else 0.0
        if not records["k1"] or busy <= 0:
            return None
        return 100.0 * self.flop(records) / (workcount.PEAK_FLOP_S * busy)

    def roofline(self, fam: str) -> Optional[float]:
        """The family's bound over its device time in the profiled
        stretch, per launch, in percent."""
        rows = self.result["stretch_records"][fam]
        device_s, main = self.profile.family(fam)
        if not trace.records_match(rows, main) or device_s <= 0:
            return None
        bound = 0.0
        for m, n, order, c, periodic in rows:
            w = workcount.mixture_work("fwd" if fam == "k1" else "bwd",
                                       n if m is None else m, n, order, c,
                                       periodic)
            bound += workcount.bound_s(*w)[0]
        return 100.0 * (bound / len(rows)) / (device_s / main)

    def idle_share(self) -> Optional[float]:
        p = self.profile
        if not p.device_ops or p.wall_s <= 0:
            return None
        return 100.0 * (1.0 - p.busy_s() / p.wall_s)

    def device_ops_per_step(self) -> Optional[float]:
        p = self.profile
        if not p.device_ops or not p.steps:
            return None
        return len(p.device_ops) / p.steps
