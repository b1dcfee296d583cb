"""set_matrix_rap_s: the wall seconds of set_matrix's Galerkin products,
the union over all threads of the ``rap`` intervals of
``SetupInfo.phase_spans`` (a counter of the program). None off the card,
and where the program keeps no intervals."""
from amgbench.spantrace import phase_wall_s


def read(run):
    if run.device.type != "cuda":
        return None
    spans = getattr(run.amg.info, "phase_spans", None)
    return phase_wall_s(spans, "rap") if spans else None
