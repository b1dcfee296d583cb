"""update_galerkin_ms.<suffix>: the wall ms of the last lazy update's
Galerkin products, the union of the ``galerkin`` intervals that the update
leaves in ``SetupInfo.phase_spans`` (a counter of the program). The last
update is the last traced request's. None off the card, as the program's
other counters, and where the program keeps no such interval."""
from amgbench.spantrace import phase_wall_s

PHASE = "galerkin"


def read(run):
    if run.device.type != "cuda":
        return None
    spans = getattr(run.amg.info, "phase_spans", None) or ()
    if not any(s[0] == PHASE for s in spans):
        return None
    return 1e3 * phase_wall_s(spans, PHASE)
