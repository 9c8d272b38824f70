"""``loop_host_ms.solve``: host milliseconds per Adam iteration outside the
program's ``step`` spans (the draws, the block loss's read, the rule and
what starts a request), from the spanned pass of the traced stretch of a
``solve`` cell (``spans.spanned_profile``); None where the program records
no spans."""


def read(run):
    spanned = run.result.get("spanned_profile")
    if run.driver != "solve" or spanned is None or not spanned.steps:
        return None
    if not any(s.name == "step" for s in spanned.spans):
        return None
    wall_ms = 1e-6 * (spanned.t1_ns - spanned.t0_ns) / spanned.steps
    return wall_ms - spanned.host_ms("step")
