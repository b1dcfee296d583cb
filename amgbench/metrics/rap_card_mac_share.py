"""rap_card_mac_share: the percentage of set_matrix's Galerkin
multiply-adds that ran on the card, from the products ``SetupInfo.products``
records (each with its engine, "card" or "host", and its multiply-adds; a
counter of the program). None off the card, and where the program keeps no
such record or recorded no product."""


def read(run):
    if run.device.type != "cuda":
        return None
    products = getattr(run.amg.info, "products", None)
    if not products:
        return None
    total = sum(p.macs for p in products)
    if not total:
        return None
    return 100.0 * sum(p.macs for p in products if p.engine == "card") / total
