"""update_devicify_ms.<suffix>: the wall ms of the last lazy update's
device rebuild, the union of the ``devicify`` intervals that the update
leaves in ``SetupInfo.phase_spans`` (a counter of the program; the phase
covers the whole rebuild, whose own phases lie inside it). The last update
is the last traced request's. None off the card, as the program's other
counters, and where the program keeps no such interval."""
from amgbench.spantrace import phase_wall_s

PHASE = "devicify"


def read(run):
    if run.device.type != "cuda":
        return None
    spans = getattr(run.amg.info, "phase_spans", None) or ()
    if not any(s[0] == PHASE for s in spans):
        return None
    return 1e3 * phase_wall_s(spans, PHASE)
