"""update_rebuilt_levels.<suffix>: the levels that the last lazy update
built from scratch, the "rebuilt" entries of ``SetupInfo.reuse`` (a counter
of the program); the others kept the old level whole, or its eig estimate,
plans and transfers. None off the card, as the program's other counters,
and where the program keeps no such record."""


def read(run):
    if run.device.type != "cuda":
        return None
    reuse = getattr(run.amg.info, "reuse", None)
    return None if reuse is None else sum(1 for how in reuse if how == "rebuilt")
