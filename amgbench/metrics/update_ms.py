"""update_ms.<suffix>: the median over the window's requests of the host
ms of their lazy update (``Record.phases["update"]``: the AMG's update
call alone, without the assembly before it and the solve after it), from
the untraced window. None where no request updated."""
import statistics


def read(run):
    t = [r.phases["update"] for r in run.records if not r.error and "update" in r.phases]
    return 1e3 * statistics.median(t) if t else None
